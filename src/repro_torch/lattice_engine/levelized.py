"""Level-parallel backend: loop over topological *levels*, not arcs.

Port of ``repro.lattice_engine.levelized`` — plain PyTorch, so it runs
on any device and is the CPU oracle of the whole engine.  Arcs within a
level have no data dependencies, so each step updates a whole frontier
with dense batched gathers + masked logsumexp/softmax reductions:
O(levels) sequential steps instead of O(arcs).

Per-arc tensors are re-ordered once into level-major layout (position
``l*W + w`` holds arc ``level_arcs[l, w]``) and predecessor/successor
ids are remapped to level-major positions up front, with one extra
"dump" slot at ``L*W`` absorbing padded ids (-1) and masked arcs
(``losses.lattice.lattice_frontiers``).  Each step writes its level
slice out of place (``slice_scatter``), so autograd (reverse and forward
mode) differentiates the whole recursion: this backend is the port's
independent gradient oracle for the kernels' occupancy identities.
Writing in place gave the same values but no gradient (autograd refuses
a gather input that a later level overwrote); the values are bitwise
those of the in-place loop.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import gather_sausage_ref
from repro_torch.lattice_engine.common import (NEG, FBStats, LossStats,
                                               arc_scores,
                                               check_accumulators, finalize,
                                               finalize_loss_only,
                                               from_level_major,
                                               masked_logsumexp,
                                               masked_softmax)
from repro_torch.losses.lattice import Lattice, lattice_frontiers


def _put_level(buf, values, lv: int, W: int):
    """``buf`` with level ``lv``'s slice replaced (out of place)."""
    return torch.slice_scatter(buf, values, dim=1, start=lv * W,
                               end=(lv + 1) * W)


def _forward_levels(own, corr, fr, W):
    """Levelized forward recursion, batched.  own/corr: (B, L, W)
    level-major.  Returns the (B, L*W+1) alpha / c_alpha buffers."""
    B, L = fr.ok.shape[:2]
    P = fr.pidx.shape[-1]
    LW = L * W
    alpha = torch.full((B, LW + 1), NEG, dtype=torch.float32,
                       device=own.device)
    c_alpha = torch.zeros((B, LW + 1), dtype=torch.float32,
                          device=own.device)
    for lv in range(L):
        idx = fr.pidx[:, lv].reshape(B, W * P).long()
        pa = alpha.gather(1, idx).reshape(B, W, P)
        pc = c_alpha.gather(1, idx).reshape(B, W, P)
        in_log = masked_logsumexp(pa, dim=-1)                  # (B, W)
        w = masked_softmax(pa, dim=-1)
        c_in = (w * pc).sum(dim=-1)
        own_l, corr_l = own[:, lv], corr[:, lv]
        start_l, ok_l = fr.start[:, lv], fr.ok[:, lv]
        a_val = torch.where(start_l, own_l, own_l + in_log)
        c_val = corr_l + torch.where(start_l, torch.zeros_like(c_in), c_in)
        alpha = _put_level(alpha, torch.where(
            ok_l, a_val, torch.full_like(a_val, NEG)), lv, W)
        c_alpha = _put_level(c_alpha, torch.where(
            ok_l, c_val, torch.zeros_like(c_val)), lv, W)
    return alpha, c_alpha


def _backward_levels(own_pad, corr_pad, fr, W):
    """Levelized backward recursion (reversed levels), batched.
    own_pad/corr_pad: (B, L*W+1) level-major with the dump slot."""
    B, L = fr.ok.shape[:2]
    S = fr.sidx.shape[-1]
    LW = L * W
    beta = torch.full((B, LW + 1), NEG, dtype=torch.float32,
                      device=own_pad.device)
    c_beta = torch.zeros((B, LW + 1), dtype=torch.float32,
                         device=own_pad.device)
    for lv in range(L - 1, -1, -1):
        idx = fr.sidx[:, lv].reshape(B, W * S).long()
        s_out = torch.where(idx < LW,
                            beta.gather(1, idx) + own_pad.gather(1, idx),
                            torch.full(idx.shape, NEG, device=idx.device))
        sc = c_beta.gather(1, idx) + corr_pad.gather(1, idx)
        s_out, sc = s_out.reshape(B, W, S), sc.reshape(B, W, S)
        out_log = masked_logsumexp(s_out, dim=-1)
        w = masked_softmax(s_out, dim=-1)
        c_out = (w * sc).sum(dim=-1)
        fin_l, ok_l = fr.final[:, lv], fr.ok[:, lv]
        b_val = torch.where(fin_l, torch.zeros_like(out_log), out_log)
        c_val = torch.where(fin_l, torch.zeros_like(c_out), c_out)
        beta = _put_level(beta, torch.where(
            ok_l, b_val, torch.full_like(b_val, NEG)), lv, W)
        c_beta = _put_level(c_beta, torch.where(
            ok_l, c_val, torch.zeros_like(c_val)), lv, W)
    return beta, c_beta


def _check(lat: Lattice) -> None:
    if lat.level_arcs is None:
        raise ValueError(
            "levelized backend needs Lattice.level_arcs; build batches with "
            "repro_torch.losses.lattice.batch_lattices (levelizes "
            "automatically)")


def _forward_arcs(lat: Lattice, log_probs, kappa: float):
    """Forward levels -> arc-layout (alpha, c_alpha), plus what the
    backward levels need: (alpha, c_alpha, own_lv, corr_lv, fr)."""
    _check(lat)
    B, L, W = lat.level_arcs.shape
    A, LW = lat.num_arcs, L * W
    fr = lattice_frontiers(lat)
    am = arc_scores(lat, log_probs, kappa) + lat.lm            # (B, A)
    own_lv = gather_sausage_ref(am, lat.level_arcs, NEG)
    corr_lv = gather_sausage_ref(lat.corr.to(torch.float32), lat.level_arcs,
                                 0.0)
    a_buf, ca_buf = _forward_levels(own_lv, corr_lv, fr, W)
    # arcs outside every level (mask padding) read the dump slot: NEG/0
    alpha = torch.where(lat.arc_mask,
                        from_level_major(a_buf[:, :LW], fr.arc_pos, A, NEG),
                        torch.full_like(am, NEG))
    c_alpha = torch.where(lat.arc_mask,
                          from_level_major(ca_buf[:, :LW], fr.arc_pos, A,
                                           0.0), torch.zeros_like(am))
    return alpha, c_alpha, own_lv, corr_lv, fr


def forward_alpha_levelized(lat: Lattice, log_probs: torch.Tensor,
                            kappa: float):
    """Forward levels only: arc-layout (alpha, c_alpha), bitwise the
    fields of the full statistics."""
    alpha, c_alpha, _, _, _ = _forward_arcs(lat, log_probs, kappa)
    return alpha, c_alpha


def forward_backward_levelized(lat: Lattice, log_probs: torch.Tensor,
                               kappa: float, accumulators: str = "full"
                               ) -> FBStats | LossStats:
    """Lattice statistics via the level-parallel loop, batched over B.

    ``accumulators="loss_only"`` runs only the forward levels (no
    beta/c_beta recursion) and returns ``LossStats(logZ, c_avg)``.
    """
    check_accumulators(accumulators)
    alpha, c_alpha, own_lv, corr_lv, fr = _forward_arcs(lat, log_probs,
                                                        kappa)
    if accumulators == "loss_only":
        return finalize_loss_only(lat, alpha, c_alpha)
    B, L, W = lat.level_arcs.shape
    A, LW = lat.num_arcs, L * W
    dump_neg = torch.full((B, 1), NEG, device=alpha.device)
    dump_zero = torch.zeros((B, 1), device=alpha.device)
    own_pad = torch.cat([own_lv.reshape(B, -1), dump_neg], dim=1)
    corr_pad = torch.cat([corr_lv.reshape(B, -1), dump_zero], dim=1)
    b_buf, cb_buf = _backward_levels(own_pad, corr_pad, fr, W)
    beta = torch.where(lat.arc_mask,
                       from_level_major(b_buf[:, :LW], fr.arc_pos, A, NEG),
                       torch.full_like(alpha, NEG))
    c_beta = torch.where(lat.arc_mask,
                         from_level_major(cb_buf[:, :LW], fr.arc_pos, A,
                                          0.0), torch.zeros_like(alpha))
    return finalize(lat, alpha, beta, c_alpha, c_beta)
