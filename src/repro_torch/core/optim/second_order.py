"""The two-stage second-order optimisers (paper Secs. 4-6) on the
unified stateful protocol.

Port of ``repro.core.optim.second_order``.  One update = gradient stage
(large gradient batch) + CG stage (small CG batch):

  NG   (Sec. 5):  solve   λ F Δθ = -∇L          with CG on Fisher products
  HF   (Sec. 3):  solve     G Δθ = -∇L          with CG on GN products
  NGHF (Sec. 6):  solve     G Δθ = -F⁻¹∇L       — the outer CG's RHS is
                  the NG direction from an inner Fisher CG (Eqn. 22).

State slots (documented API): "step" int32; "lam" f32 live λ under
``adapt_lam`` (Levenberg–Marquardt from the reduction ratio ρ on the CG
batch); "delta" the previous best Δθ under ``warm_start`` (the outer CG
starts from it); "precond" the preconditioner's state.

The update runs eagerly: the CG loop's control decisions are host
decisions (``core.cg``), ``metrics["cg_host_syncs"]`` counts them.
``timer`` (a ``core.timing.StageTimer``) optionally splits the update
into the gradient stage, the curvature products and the candidate
evaluations; the rest of the CG stage is its vector work.

Under a mesh (``state_sharding``, the paper's synchronous master/worker
accumulation): ``step`` takes the GLOBAL batches, the gradient stage,
each curvature product and each candidate evaluation run this rank's
share of them and are summed over the data group
(``core.curvature``), and the curvature sample is rounded up to a
multiple of the data extent.  Every θ-sized vector the CG solves see is
then the same on every rank, so each host decision (the curvature
guard, the ``cg_tol`` stop, the best candidate, acceptance, adaptive λ)
is taken on the same values everywhere and the ranks never fork.  With
``cg_fused`` the vector work runs per leaf (``cg_fused_update_tree``) in
the state's layout.  Under FSDP storage each rank holds its share of
every split leaf, of the parameters and of every θ-sized vector alike,
and each ``vdot``/``norm`` sums over the leaf's ranks
(``tree_math.reducing``).
"""
from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass

import torch

from repro_torch.core import tree_math as tm
from repro_torch.core.cg import cg_solve
from repro_torch.core.curvature import grad_and_loss, make_curvature_ops
from repro_torch.core.optim.base import Optimizer, register_optimizer
from repro_torch.core.optim.preconditioners import get_preconditioner

STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class SecondOrderConfig:
    method: str = "nghf"          # ng | hf | nghf
    cg_iters: int = 8             # outer CG iterations (ceiling under cg_tol)
    ng_iters: int = 4             # inner Fisher-CG iterations for NGHF
    cg_tol: float = 0.0           # adaptive CG budget (0 = fixed budget)
    cg_min_iters: int = 1         # floor before cg_tol may fire
    cg_fused: bool = False        # fused CG vector work: one flat buffer,
                                  # per leaf under a mesh
    curvature_sample: float = 1.0  # fraction of the CG batch for products
    lam: float = 1.0              # λ, KL trust multiplier on F (Eqn. 17)
    damping: float = 0.0          # Tikhonov η (baseline)
    ng_damping: float = 1.0       # inner-Fisher-solve damping for NGHF
    stabilize: bool = True        # Sec. 4.2 ‖θ‖/‖v‖ rescaling
    precondition: bool = True     # master switch; False forces "identity"
    preconditioner: str = "share_counts"
    fisher_decay: float = 0.95
    fisher_eps: float = 1e-4
    fisher_power: float = 0.75
    eval_candidates: bool = True  # Alg. 1 candidate selection
    reject_worse: bool = True     # keep θ when no candidate beats Δθ=0
    eval_every: int = 1           # candidate-eval stride
    eval_accumulators: str = "loss_only"
    warm_start: bool = False      # start the outer CG from the previous Δθ
    adapt_lam: bool = False       # LM-style λ adaptation
    lam_inc: float = 1.5
    lam_dec: float = 2.0 / 3.0
    lam_min: float = 1e-3
    lam_max: float = 1e3
    step_scale: float = 1.0
    curvature_mode: str = "rematvp"   # rematvp | linearize
    grad_microbatches: int = 1
    state_dtype: str = "float32"      # CG vector storage: float32 | bfloat16

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


class _NoTimer:
    def section(self, name):
        return contextlib.nullcontext()

    def wrap(self, name, fn):
        return fn


class SecondOrderOptimizer(Optimizer):
    """NG / HF / NGHF as a thin stateful orchestration over
    ``grad_and_loss`` + ``make_curvature_ops`` + ``cg_solve``."""

    uses_cg_batch = True

    def __init__(self, cfg: SecondOrderConfig, forward_fn, loss_spec, *,
                 share_counts=None, state_sharding=None):
        if cfg.method not in ("ng", "hf", "nghf"):
            raise ValueError(cfg.method)
        if cfg.adapt_lam and not cfg.eval_candidates:
            raise ValueError("adapt_lam requires eval_candidates=True "
                             "(ρ is measured on the CG-batch losses)")
        if cfg.state_dtype not in STATE_DTYPES:
            raise ValueError(f"state_dtype {cfg.state_dtype!r} not in "
                             f"{sorted(STATE_DTYPES)}")
        self.cfg = cfg
        self.name = cfg.method
        self.forward_fn = forward_fn
        self.loss_spec = loss_spec
        self.timer = None
        self.bind_mesh(state_sharding)
        pname = cfg.preconditioner if cfg.precondition else "identity"
        self.precond = get_preconditioner(
            pname, share_counts=share_counts, fisher_decay=cfg.fisher_decay,
            fisher_eps=cfg.fisher_eps, fisher_power=cfg.fisher_power)

    def _state_dtype(self, leaf):
        return STATE_DTYPES[self.cfg.state_dtype] \
            if self.cfg.state_dtype != "float32" else leaf.dtype

    def state_template(self, theta, scalar):
        st = {"step": scalar(torch.int32, 0),
              "lam": scalar(torch.float32, self.cfg.lam),
              "precond": self.precond.state_template(theta, scalar)}
        if self.cfg.warm_start:
            st["delta"] = theta(cast=self._state_dtype)
        return st

    def update(self, params, state, grad_batch, cg_batch=None):
        cfg = self.cfg
        if cg_batch is None:
            raise ValueError(f"{self.name} needs an explicit CG batch "
                             "(paper Sec. 4.1)")
        timer = self.timer or _NoTimer()
        mesh = self.mesh
        # the state's layout under a mesh: each leaf's shape on this rank
        constrain = self.layout(params)

        # --- stage 1: gradient accumulation (Fig. 1, left) -----------------
        with timer.section("gradient"):
            loss, metrics, grads = grad_and_loss(
                self.forward_fn, self.loss_spec, params, grad_batch,
                microbatches=cfg.grad_microbatches, mesh=mesh,
                data_split=self.data_split)
        pstate = self.precond.update(state["precond"], grads,
                                     constrain=constrain)
        st_dtype = STATE_DTYPES[cfg.state_dtype]

        def _st(t):
            """CG state storage dtype (reductions stay f32)."""
            return t if cfg.state_dtype == "float32" else tm.astype(
                t, st_dtype)

        b = _st(tm.scale(grads, -1.0))

        # --- stage 2: CG (Fig. 1, right) ------------------------------------
        theta_norm = tm.norm(params)
        ops = make_curvature_ops(self.forward_fn, self.loss_spec, params,
                                 cg_batch, stabilize=cfg.stabilize,
                                 theta_norm=theta_norm,
                                 mode=cfg.curvature_mode,
                                 eval_accumulators=cfg.eval_accumulators,
                                 curvature_sample=cfg.curvature_sample,
                                 mesh=mesh, data_split=self.data_split)
        precond = self.precond.apply_fn(pstate)
        lam = state["lam"] if cfg.adapt_lam else cfg.lam
        solve_kw = dict(tol=cfg.cg_tol, min_iters=cfg.cg_min_iters,
                        fused=cfg.cg_fused, constrain=constrain)
        ops_fvp = timer.wrap("curvature", ops.fvp)
        ops_gnvp = timer.wrap("curvature", ops.gnvp)
        eval_loss = timer.wrap("candidates", ops.eval_loss)

        def fvp(v):
            return _st(tm.scale(ops_fvp(v), lam))

        if cfg.method == "hf" and cfg.adapt_lam:
            # adaptive λ acts as LM Tikhonov damping (G + λI) for plain HF
            def gnvp(v):
                return _st(tm.axpy(lam, v, ops_gnvp(v)))
        else:
            def gnvp(v):
                return _st(ops_gnvp(v))
        x0 = state["delta"] if cfg.warm_start else None
        eval_fn = eval_loss if cfg.eval_candidates else None

        diag = {}
        syncs = 0
        if cfg.method in ("ng", "hf"):
            res = cg_solve(fvp if cfg.method == "ng" else gnvp, b,
                           iters=cfg.cg_iters, precond=precond,
                           eval_fn=eval_fn, damping=cfg.damping,
                           eval_every=cfg.eval_every, x0=x0, **solve_kw)
        else:
            # inner solve: (λF + ηI) d = -∇L, no candidate evaluation
            inner = cg_solve(fvp, b, iters=cfg.ng_iters, precond=precond,
                             eval_fn=None,
                             damping=max(cfg.damping, cfg.ng_damping),
                             **solve_kw)
            syncs += inner.host_syncs
            diag["ng_quad"] = inner.quad
            diag["ng_iters_used"] = inner.iters_used
            # outer solve: G Δθ = NG direction (Sec. 6.2)
            res = cg_solve(gnvp, inner.x, iters=cfg.cg_iters,
                           precond=precond, eval_fn=eval_fn,
                           damping=cfg.damping, eval_every=cfg.eval_every,
                           x0=x0, **solve_kw)
        syncs += res.host_syncs

        delta = tm.scale(res.x, cfg.step_scale)
        accepted = torch.ones((), dtype=torch.bool,
                              device=theta_norm.device)
        base = None
        if cfg.eval_candidates and (cfg.reject_worse or cfg.adapt_lam):
            base = eval_loss(tm.zeros_like(res.x))
        if cfg.eval_candidates and cfg.reject_worse:
            # Alg. 1's best candidate, rejected unless it beats Δθ=0
            accepted = res.best_loss < base
            delta = tm.where(accepted, delta, tm.zeros_like(delta))
        new_params = tm.add(params, tm.cast_like(delta, params))

        new_state = dict(state, step=state["step"] + 1, precond=pstate)
        if cfg.adapt_lam:
            # LM reduction ratio against the LOSS quadratic model
            # q(Δ) = -bᵀΔ + ½ΔᵀBΔ, b = -∇L; the nghf outer solve's own
            # quadratic has the NG direction as RHS, so form the model with
            # one extra curvature product at the selected candidate
            if cfg.method == "nghf":
                pred = (tm.vdot(res.x, b)
                        - 0.5 * tm.vdot(res.x, gnvp(res.x)))
            else:
                pred = -res.quad[res.best_iter.clamp(min=0).long()]
            actual = base - res.best_loss
            rho = actual / pred.clamp(min=1e-30)
            valid = torch.isfinite(rho) & (pred > 1e-30) \
                & (res.best_iter >= 0)
            adj = (torch.where(rho > 0.75, cfg.lam_dec, 1.0)
                   * torch.where(rho < 0.25, cfg.lam_inc, 1.0))
            new_state["lam"] = torch.where(valid, state["lam"] * adj,
                                           state["lam"]).clamp(cfg.lam_min,
                                                               cfg.lam_max)
            diag["cg_rho"] = rho
            diag["lam"] = lam
        if cfg.warm_start:
            # stored even when rejected (the same system roughly recurs)
            new_state["delta"] = _st(res.x)

        metrics = dict(metrics)
        metrics.update(
            loss=loss, grad_norm=tm.norm(grads), update_norm=tm.norm(delta),
            cg_best_iter=res.best_iter, cg_best_loss=res.best_loss,
            cg_quad=res.quad, cg_resid=res.resid, cg_curv=res.curv,
            cg_losses=res.losses, cg_accepted=accepted,
            cg_evaluated=torch.isfinite(res.losses).sum(),
            cg_negative_curvature=(res.curv <= 0.0).sum(),
            cg_iters_used=res.iters_used, opt_step=new_state["step"],
            cg_host_syncs=syncs, **diag)
        if base is not None:
            metrics["cg_base_loss"] = base      # the Δθ=0 candidate
        return new_params, new_state, metrics


for _m in ("ng", "hf", "nghf"):
    register_optimizer(_m, SecondOrderConfig, SecondOrderOptimizer,
                       method=_m)
