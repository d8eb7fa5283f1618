"""The linear conjugate-gradient engine (paper Alg. 1 + Secs. 4.2/4.3).

Port of ``repro.core.cg``.  Solves ``B x = b`` for theta-sized values (a
flat ``dict[str, Tensor]``, or one flat tensor) with a matrix-free ``Bv``
operator, with the reference's features:

  1. **Candidate-update selection** — iterates are evaluated on the CG
     batch (``eval_fn``) and the argmin is returned; with
     ``eval_every > 1`` the FINAL iterate is still always evaluated.
  2. **Preconditioning** — ``precond`` is an M⁻¹-apply callable, or a
     per-leaf count tree meaning M = diag(c) (Sec. 4.3).
  3. **Negative-curvature guard** — if vᵀBv ≤ 0 the iteration freezes
     and the best candidate so far is kept.
  4. **Fused vector work** (``fused=True``) — the vectors live in ONE
     flat buffer in the reference's ``ravel_pytree`` leaf order, and each
     iteration's ``x += αv; r -= αBv; rr = <r, r>`` is one
     ``kernels.cg_fused.cg_fused_update`` call (one kernel on the card).
  5. **Adaptive budget** (``tol > 0``) — stop once the quadratic model's
     relative per-iteration gain drops below ``tol``; ``iters`` is the
     ceiling.
  6. **The per-leaf fused path** (``fused=True`` with ``constrain``, a
     ``tree_math.Layout``: a mesh's state layout) — the vectors stay
     dicts, each leaf in its layout, and each iteration's vector work is
     ``kernels.cg_fused.cg_fused_update_tree`` (one kernel a leaf on the
     card; a leaf split across ranks sums its ⟨r, r⟩ partial over its
     group).

The reference runs the iterations inside ``lax.scan``/``while_loop`` and
decides ``lax.cond(do_eval & ~bad, ...)`` and the ``tol`` stop on the
device.  Here those are host decisions, and each costs a device sync:
at most ONE per iteration (reading ``bad``, and ``converged`` with it in
the ``tol`` loop); on the fixed budget only the iterations due for
evaluation read it, and none without ``eval_fn``.
``CGResult.host_syncs`` counts them.  Everything else (alpha, beta, the
best-candidate selection, the fallbacks) stays on the device.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core import tree_math as tm
from repro_torch.kernels.cg_fused import (cg_fused_update,
                                         cg_fused_update_tree)


class CGResult(NamedTuple):
    x: dict                    # best candidate Δθ
    best_loss: torch.Tensor    # its CG-batch loss (inf if eval_fn is None)
    best_iter: torch.Tensor    # which iteration produced it
    quad: torch.Tensor         # (M,) quadratic-model value per iteration
    resid: torch.Tensor        # (M,) preconditioned residual norm
    curv: torch.Tensor         # (M,) vᵀBv per iteration
    losses: torch.Tensor       # (M,) candidate losses (inf where not eval'd)
    iters_used: torch.Tensor   # iterations actually executed
    host_syncs: int = 0        # device->host reads the control flow made


def _flatten(b, bv_fn, eval_fn, x0, precond):
    """The fused path's flat view: b, x0 and a count tree become flat
    buffers; bv_fn / eval_fn / a callable precond see dicts again."""
    flat_b, unravel = tm.ravel(b)
    tree_bv = bv_fn

    def bv_flat(vf):
        return tm.ravel(tree_bv(unravel(vf)))[0]

    if eval_fn is not None:
        tree_eval = eval_fn

        def eval_fn(xf):                        # noqa: F811
            return tree_eval(unravel(xf))
    if x0 is not None:
        x0 = tm.ravel(x0)[0]
    if precond is not None:
        if callable(precond):
            tree_minv = precond

            def precond(rf):                    # noqa: F811
                return tm.ravel(tree_minv(unravel(rf)))[0]
        else:
            # a per-leaf count (scalar or theta-shaped) -> a flat buffer
            precond = tm.ravel({k: torch.as_tensor(
                precond[k], dtype=b[k].dtype,
                device=b[k].device).expand(b[k].shape) for k in b})[0]
    return flat_b, unravel, bv_flat, eval_fn, x0, precond


def cg_solve(bv_fn: Callable, b, *, iters: int, precond=None,
             eval_fn: Optional[Callable] = None, damping: float = 0.0,
             eval_every: int = 1, x0=None, tol: float = 0.0,
             min_iters: int = 1, fused: bool = False,
             constrain: Optional[tm.Layout] = None) -> CGResult:
    """Run up to ``iters`` CG iterations on B x = b.

    bv_fn:   v -> B v (theta-sized in/out).
    b:       right-hand side (e.g. -∇L, or the NG direction for NGHF).
    precond: None (identity), a callable r -> M⁻¹ r, or a per-leaf count
             tree c meaning M = diag(c).
    eval_fn: Δθ -> 0-d CG-batch loss for candidate selection.
    damping: Tikhonov η (B + ηI).
    x0:      warm-start iterate (one extra B product for the residual).
    tol:     adaptive budget (0.0 keeps the fixed ``iters``).
    fused:   one flat buffer and ``cg_fused_update`` per iteration; with
             ``constrain``, ``cg_fused_update_tree`` over the dicts.
    constrain: the state's layout under a mesh (``tree_math.Layout``);
             x0 and the warm-start residual are checked against it.
    """
    tree_fused = fused and constrain is not None
    if constrain is None:
        def constrain(t):                       # noqa: F811
            return t
    unravel = None
    if fused and not tree_fused:
        b, unravel, bv_fn, eval_fn, x0, precond = _flatten(
            b, bv_fn, eval_fn, x0, precond)

    identity_precond = precond is None
    if precond is None:
        def Minv(t):
            return t
    elif callable(precond):
        Minv = precond
    else:
        counts = precond

        def Minv(t):
            return tm.div(t, counts)

    def B(v):
        out = bv_fn(v)
        return tm.axpy(damping, v, out) if damping else out

    warm = x0 is not None
    if not warm:
        x0 = tm.zeros_like(b)
        r0 = b
    else:
        x0 = constrain(x0)
        r0 = constrain(tm.sub(b, B(x0)))
    z0 = Minv(r0)
    v0 = z0
    rz0 = tm.vdot(r0, z0)
    dev = rz0.device

    def iterate(x, r, v, rz, dead):
        """One CG iteration's linear algebra (both budget paths)."""
        bv = B(v)
        vbv = tm.vdot(v, bv)
        bad = (vbv <= 0.0) | dead
        alpha = torch.where(bad, 0.0, rz / vbv.clamp(min=1e-30))
        if fused:
            if tree_fused:
                x_new, r_new, rr = cg_fused_update_tree(
                    alpha, x, v, r, bv, groups=constrain.groups)
            else:
                x_new, r_new, rr = cg_fused_update(alpha, x, v, r, bv)
            if identity_precond:
                # with M = I the kernel's blockwise <r, r> IS <r, z>
                z_new, rz_new = r_new, rr
            else:
                z_new = Minv(r_new)
                rz_new = tm.vdot(r_new, z_new)
        else:
            x_new = tm.axpy(alpha, v, x)
            r_new = tm.axpy(-alpha, bv, r)
            z_new = Minv(r_new)
            rz_new = tm.vdot(r_new, z_new)
        beta = torch.where(bad, 0.0, rz_new / rz.clamp(min=1e-30))
        v_new = tm.axpy(beta, v, z_new)
        # g(x) = 0.5 xᵀBx - xᵀb = -0.5 (xᵀb + xᵀr), since Bx = b - r
        quad = -0.5 * (tm.vdot(x_new, r_new) + tm.vdot(x_new, b))
        return x_new, r_new, v_new, rz_new, bad, vbv, quad

    inf = torch.full((), float("inf"), dtype=torch.float32, device=dev)
    nan = torch.full((), float("nan"), dtype=torch.float32, device=dev)
    best_x, best_loss = x0, inf
    best_iter = torch.full((), -1, dtype=torch.int32, device=dev)
    syncs = 0

    def select(x_new, loss, m):
        nonlocal best_x, best_loss, best_iter
        better = loss < best_loss
        best_x = tm.where(better, x_new, best_x)
        best_loss = torch.where(better, loss, best_loss)
        best_iter = torch.where(better, torch.full_like(best_iter, m),
                                best_iter)

    x, r, v, rz = x0, r0, v0, rz0
    dead = torch.zeros((), dtype=torch.bool, device=dev)
    hist = {"quad": [], "resid": [], "curv": [], "losses": []}
    evaled = False
    if tol <= 0.0:
        for m in range(iters):
            x, r, v, rz, dead, vbv, quad = iterate(x, r, v, rz, dead)
            loss = inf
            if eval_fn is not None and (m % eval_every == 0
                                        or m == iters - 1):
                syncs += 1
                if not bool(dead):
                    loss = eval_fn(x).to(torch.float32)
                    select(x, loss, m)
            hist["quad"].append(quad)
            hist["resid"].append(torch.sqrt(rz.clamp(min=0.0)))
            hist["curv"].append(vbv)
            hist["losses"].append(loss)
        iters_used = torch.full((), iters, dtype=torch.int32, device=dev)
        last_iter = torch.full((), iters - 1, dtype=torch.int32, device=dev)
    else:
        q_prev = -0.5 * (tm.vdot(x0, r0) + tm.vdot(x0, b))
        m, bad_h = 0, False
        while m < iters:
            x, r, v, rz, dead, vbv, quad = iterate(x, r, v, rz, dead)
            gain = q_prev - quad
            converged = (gain <= tol * quad.abs().clamp(min=1e-12))
            syncs += 1
            # the loop decides on the host by design: one sync an iteration
            bad_h, conv_h = torch.stack([dead, converged]).tolist()  # reprolint: disable=RL002
            evaled = eval_fn is not None and m % eval_every == 0 \
                and not bad_h
            loss = inf
            if evaled:
                loss = eval_fn(x).to(torch.float32)
                select(x, loss, m)
            hist["quad"].append(quad)
            hist["resid"].append(torch.sqrt(rz.clamp(min=0.0)))
            hist["curv"].append(vbv)
            hist["losses"].append(loss)
            q_prev = quad
            m += 1
            if bad_h or (m >= min_iters and conv_h):
                break
        iters_used = torch.full((), m, dtype=torch.int32, device=dev)
        last_iter = torch.full((), max(m - 1, 0), dtype=torch.int32,
                               device=dev)
        if eval_fn is not None and not evaled and not bad_h:
            # the deepest candidate must never be silently excluded
            loss = eval_fn(x).to(torch.float32)
            select(x, loss, max(m - 1, 0))
            hist["losses"][-1] = loss
        for key, fill in (("quad", nan), ("resid", nan), ("curv", nan),
                          ("losses", inf)):
            hist[key] += [fill] * (iters - len(hist[key]))

    quad, resid, curv, losses = (torch.stack(hist[k]) for k in
                                 ("quad", "resid", "curv", "losses"))
    # a warm-started solve frozen at iteration 0 never left x0 — the
    # PREVIOUS system's solution; the fallbacks below return Δθ=0 then
    last = tm.where(curv[0] <= 0.0, tm.zeros_like(x), x) if warm else x
    if eval_fn is None:
        best_x, best_iter = last, last_iter
    else:
        none_found = ~torch.isfinite(best_loss)
        best_x = tm.where(none_found, last, best_x)
        best_iter = torch.where(none_found, last_iter, best_iter)
    if unravel is not None:
        best_x = unravel(best_x)
    return CGResult(x=best_x, best_loss=best_loss, best_iter=best_iter,
                    quad=quad, resid=resid, curv=curv, losses=losses,
                    iters_used=iters_used, host_syncs=syncs)
