"""CUDA backend: differentiable lattice statistics on the hand-written
kernels.

Twin of ``repro.lattice_engine.pallas_backend``.  Topology dispatch
happens here, as in the reference's eager path: a lattice that is a
sausage (``lattice_is_sausage``: every level fully connected to the one
before, finals exactly on the last level) runs the sausage kernels over
its (S, W) segment layout; every other topology runs the general-DAG
kernels over the levelized frontier tensors (``losses.lattice.
lattice_frontiers``).  ``topology="dag"`` sends sausages to the DAG
kernels too; the rescoring service asks for it, because the jitted JAX
service sees traced lattices and always runs the DAG kernels, and a
request's bits must not depend on its batch mates' topology.

Why the port's ``"auto"`` lands here where the JAX trainer's does not:
the JAX trainer jits the whole update, its lattices are traced, and
``"auto"`` resolves to ``levelized``; the port runs eagerly, so a CUDA
lattice is concrete and ``"auto"`` resolves to ``"cuda"``, which runs
the sausage kernels on the synthetic training lattices.  The results
agree within float tolerance; the difference is by design.

  * ``accumulators="full"``: ONE forward and ONE backward kernel launch
    (sausage or DAG pair).  ``logZ``/``c_avg`` carry derivatives through
    :class:`FullStats`; the per-arc statistics are constants scattered
    back to arc layout.  (The JAX backend calls the forward kernel twice
    and relies on XLA's dead-code elimination; PyTorch runs eagerly.)
  * ``accumulators="loss_only"``: ONE fused loss-only launch from the raw
    (B, T, K) log-probs and arc-layout fields (:class:`LossOnly`); only
    (logZ, c_avg) come back.  Its derivative rules rebuild the scores and
    run the kernel pair, as the reference's ``custom_jvp`` rules do;
    candidate evaluation never differentiates it.

Both Functions are written in the ``setup_context`` style with a
``backward`` and a ``jvp``, so ``torch.autograd.grad`` and
``torch.func.grad``/``vjp``/``jvp`` all work.  Both rules come from one
helper, :class:`Occupancy`, which owns the closed-form identities

    d logZ / d s_a  = gamma_a
    d c_avg / d s_a = gamma_a (c_arc_a - c_avg)
    d c_avg / d corr_a = gamma_a.

``kappa`` is a Python float with no tangent (the reference's fused rule
also differentiates a traced kappa; no caller of the port needs it).

The kernel wrappers choose by device: CUDA tensors launch the kernels,
CPU tensors run their plain versions (``kernels.ref``), so this backend
also runs, unchanged, in the CPU tests.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.lattice_fb import (dag_backward, dag_forward,
                                            dag_loss_only, sausage_backward,
                                            sausage_forward,
                                            sausage_loss_only)
from repro_torch.kernels.ref import (gather_sausage_ref,
                                     sausage_arc_scores_ref,
                                     sausage_arc_scores_vjp)
from repro_torch.lattice_engine.common import (NEG, FBStats, LossStats,
                                               arc_scores,
                                               check_accumulators,
                                               from_level_major,
                                               lattice_is_sausage)
from repro_torch.losses.lattice import Lattice, lattice_frontiers

TOPOLOGIES = ("auto", "dag")


class Occupancy(NamedTuple):
    """Per-slot occupancies of one statistics pass — (B, ...) gamma,
    c_alpha, c_beta and the (B,) c_avg — and the two linear maps they
    define: ``jvp`` (slot tangents -> (dlogZ, dc_avg)) and its transpose
    ``vjp``."""

    gamma: torch.Tensor
    c_alpha: torch.Tensor
    c_beta: torch.Tensor
    c_avg: torch.Tensor

    def _b(self, x):
        return x.reshape((-1,) + (1,) * (self.gamma.dim() - 1))

    def _centred(self):
        return self.c_alpha + self.c_beta - self._b(self.c_avg)

    def jvp(self, ds, dc):
        dims = tuple(range(1, self.gamma.dim()))
        dlogz = torch.zeros_like(self.c_avg)
        dcavg = torch.zeros_like(self.c_avg)
        if ds is not None:
            dlogz = (self.gamma * ds).sum(dims)
            dcavg = (self.gamma * self._centred() * ds).sum(dims)
        if dc is not None:
            dcavg = dcavg + (self.gamma * dc).sum(dims)
        return dlogz, dcavg

    def vjp(self, g_logz, g_cavg):
        ds = self.gamma * (self._b(g_logz) + self._b(g_cavg) * self._centred())
        dc = self.gamma * self._b(g_cavg)
        return ds, dc


def _full_stats(own, corr, flags):
    """ONE forward + ONE backward launch.  ``flags`` is ``(mask,)`` for
    the sausage pair or ``(start, ok, final, pidx, sidx)`` for the DAG
    pair.  Returns (logZ, c_avg, alpha, c_alpha, beta, c_beta, gamma) in
    the kernels' slot layout."""
    if len(flags) == 1:
        (ok,) = flags
        alpha, c_alpha, logz, cavg = sausage_forward(own, corr, ok)
        beta, c_beta = sausage_backward(own, corr, ok)
    else:
        start, ok, final, pidx, sidx = flags
        alpha, c_alpha, logz, cavg = dag_forward(own, corr, start, ok, final,
                                                 pidx)
        beta, c_beta = dag_backward(own, corr, final, ok, sidx)
    gamma = torch.where(ok > 0.5,
                        torch.exp(alpha + beta - logz[:, None, None]),
                        torch.zeros_like(alpha))
    return logz, cavg, alpha, c_alpha, beta, c_beta, gamma


class FullStats(torch.autograd.Function):
    """(logZ, c_avg, alpha, c_alpha, beta, c_beta, gamma) from slot
    scores ``own`` and correctness ``corr`` (both (B, L, W) f32) and the
    constant ``flags`` of :func:`_full_stats`.  Only logZ and c_avg carry
    derivatives (w.r.t. own and corr)."""

    @staticmethod
    def forward(own, corr, flags):
        return _full_stats(own, corr, flags)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, cavg, alpha, c_alpha, beta, c_beta, gamma = output
        ctx.mark_non_differentiable(alpha, c_alpha, beta, c_beta, gamma)
        ctx.save_for_backward(gamma, c_alpha, c_beta, cavg)
        ctx.save_for_forward(gamma, c_alpha, c_beta, cavg)

    @staticmethod
    def backward(ctx, g_logz, g_cavg, *_):
        ds, dc = Occupancy(*ctx.saved_tensors).vjp(g_logz, g_cavg)
        return ds, dc, None

    @staticmethod
    def jvp(ctx, ds, dc, _):
        dlogz, dcavg = Occupancy(*ctx.saved_tensors).jvp(ds, dc)
        return (dlogz, dcavg) + (None,) * 5


def _slot_tensors(lat: Lattice, score_arc, corr_arc, fr):
    """Arc-layout scores/correctness -> the kernels' slot layout and the
    constant flags: the (S, W) sausage layout when ``fr`` is None, the
    DAG frontier layout otherwise."""
    la = lat.level_arcs
    own = gather_sausage_ref(score_arc, la, NEG)
    corr = gather_sausage_ref(corr_arc.to(torch.float32), la, 0.0)
    if fr is None:
        return own, corr, (gather_sausage_ref(
            lat.arc_mask.to(torch.float32), la, 0.0),)
    return own, corr, (fr.start.to(torch.float32), fr.ok.to(torch.float32),
                       fr.final.to(torch.float32), fr.pidx, fr.sidx)


def _slots_to_arcs(values, level_arcs, num_arcs: int):
    """Transpose of ``gather_sausage_ref``: (B, L, W) slot values summed
    into (B, A) arc layout (each arc sits in at most one slot)."""
    B = values.shape[0]
    la = level_arcs.reshape(B, -1).long()
    pos = torch.where((la >= 0) & (la < num_arcs), la,
                      torch.full_like(la, num_arcs))
    out = torch.zeros((B, num_arcs + 1), dtype=values.dtype,
                      device=values.device)
    return out.scatter_add_(1, pos, values.reshape(B, -1))[:, :num_arcs]


class LossOnly(torch.autograd.Function):
    """Fused (logZ, c_avg) from (B, T, K) f32 log-probs and the arc-layout
    ``lm``/``corr`` (the differentiable inputs) of lattice ``lat``: the
    sausage loss-only kernel when ``fr`` is None, the DAG one over the
    frontiers' predecessor rows ``fr.pidx`` otherwise.  On the card either
    is one launch that sums each arc's span straight from the log-probs
    (no cumsum grid) and returns only (logZ, c_avg); the derivative rules
    rebuild the scores by the reference's centred cumsum
    (``sausage_arc_scores_ref``) and run the full-statistics pair, so a
    value and its derivative agree within f32 rounding, not bitwise."""

    @staticmethod
    def forward(log_probs, lm, corr, lat, fr, kappa):
        la = lat.level_arcs.contiguous()
        if fr is None:
            return sausage_loss_only(log_probs, lat.start_t, lat.end_t,
                                     lat.label, lm, corr, lat.arc_mask, la,
                                     kappa=kappa)
        return dag_loss_only(log_probs, lat.start_t, lat.end_t, lat.label,
                             lm, corr, lat.arc_mask, lat.is_start,
                             lat.is_final, la, fr.pidx, kappa=kappa)

    @staticmethod
    def setup_context(ctx, inputs, output):
        log_probs, lm, corr, lat, fr, kappa = inputs
        ctx.save_for_backward(log_probs, lm, corr)
        ctx.save_for_forward(log_probs, lm, corr)
        ctx.lat, ctx.fr, ctx.kappa = lat, fr, kappa

    @staticmethod
    def _occupancy(ctx, log_probs, lm, corr) -> Occupancy:
        lat = ctx.lat
        score_arc = sausage_arc_scores_ref(log_probs, lat.start_t, lat.end_t,
                                           lat.label, ctx.kappa) \
            + lm.to(torch.float32)
        own, co, flags = _slot_tensors(lat, score_arc, corr, ctx.fr)
        _, cavg, _, c_alpha, _, c_beta, gamma = _full_stats(own, co, flags)
        return Occupancy(gamma, c_alpha, c_beta, cavg)

    @staticmethod
    def backward(ctx, g_logz, g_cavg):
        log_probs, lm, corr = ctx.saved_tensors
        lat = ctx.lat
        ds, dc = LossOnly._occupancy(ctx, log_probs, lm, corr).vjp(
            g_logz, g_cavg)
        A = lat.num_arcs
        ds_arc = _slots_to_arcs(ds, lat.level_arcs, A)
        dc_arc = _slots_to_arcs(dc, lat.level_arcs, A)
        _, T, K = log_probs.shape
        d_lp = sausage_arc_scores_vjp(ds_arc, lat.start_t, lat.end_t,
                                      lat.label, T, K, ctx.kappa)
        return (d_lp, ds_arc.to(lm.dtype), dc_arc.to(corr.dtype), None,
                None, None)

    @staticmethod
    def jvp(ctx, d_lp, d_lm, d_corr, *_):
        log_probs, lm, corr = ctx.saved_tensors
        lat = ctx.lat
        ds_arc = None
        if d_lp is not None:
            ds_arc = sausage_arc_scores_ref(d_lp, lat.start_t, lat.end_t,
                                            lat.label, ctx.kappa)
        if d_lm is not None:
            d_lm = d_lm.to(torch.float32)
            ds_arc = d_lm if ds_arc is None else ds_arc + d_lm
        la = lat.level_arcs
        ds = None if ds_arc is None else gather_sausage_ref(ds_arc, la, 0.0)
        dc = None if d_corr is None else gather_sausage_ref(
            d_corr.to(torch.float32), la, 0.0)
        return LossOnly._occupancy(ctx, log_probs, lm, corr).jvp(ds, dc)


def _from_slots(values, level_arcs, num_arcs: int, fill):
    """(B, S, W) sausage-layout values -> (B, A) arc layout; arcs in no
    slot get ``fill``."""
    B = values.shape[0]
    la = level_arcs.reshape(B, -1).long()
    pos = torch.where(la >= 0, la, torch.full_like(la, num_arcs))
    out = torch.full((B, num_arcs + 1), fill, dtype=values.dtype,
                     device=values.device)
    return out.scatter_(1, pos, values.reshape(B, -1))[:, :num_arcs]


def dag_level_tensors(lat: Lattice, am, fr):
    """Gather arc-layout scores + frontier flags into the DAG kernels'
    level-major f32 layout.  ``am``: (B, A) acoustic+lm arc scores."""
    own, corr, (start, ok, final, _, _) = _slot_tensors(lat, am, lat.corr,
                                                         fr)
    return own, corr, start, ok, final


def _check(lat: Lattice, accumulators: str, topology: str) -> None:
    check_accumulators(accumulators)
    if topology not in TOPOLOGIES:
        raise ValueError(f"unknown topology {topology!r}; expected one of "
                         f"{TOPOLOGIES}")
    if lat.level_arcs is None:
        raise ValueError(
            "cuda backend needs Lattice.level_arcs; build batches with "
            "repro_torch.losses.lattice.batch_lattices (levelizes "
            "automatically)")


def forward_backward_cuda(lat: Lattice, log_probs: torch.Tensor,
                          kappa: float, accumulators: str = "full",
                          topology: str = "auto") -> FBStats | LossStats:
    """Differentiable lattice statistics via the kernels — any topology
    (module docstring)."""
    _check(lat, accumulators, topology)
    sausage = topology == "auto" and lattice_is_sausage(lat)
    fr = None if sausage else lattice_frontiers(lat)
    lp = log_probs.to(torch.float32)
    if accumulators == "loss_only":
        logZ, c_avg = LossOnly.apply(lp, lat.lm, lat.corr, lat, fr, kappa)
        return LossStats(logZ=logZ, c_avg=c_avg)
    am = arc_scores(lat, lp, kappa) + lat.lm                   # (B, A)
    own, corr, flags = _slot_tensors(lat, am, lat.corr, fr)
    logZ, c_avg, *slots = FullStats.apply(own, corr, flags)
    A = lat.num_arcs
    if sausage:
        def to_arcs(v, fill):
            return _from_slots(v, lat.level_arcs, A, fill)
    else:
        def to_arcs(v, fill):
            return from_level_major(v, fr.arc_pos, A, fill)
    alpha, c_alpha, beta, c_beta, gamma = (
        to_arcs(v, fill) for v, fill in zip(slots, (NEG, 0.0, NEG, 0.0,
                                                    0.0)))
    return FBStats(alpha=alpha, beta=beta, logZ=logZ, gamma=gamma,
                   c_alpha=c_alpha, c_beta=c_beta, c_avg=c_avg,
                   c_arc=c_alpha + c_beta)


def forward_alpha_cuda(lat: Lattice, log_probs: torch.Tensor, kappa: float):
    """Forward recursion only, ONE ``dag_forward`` launch: arc-layout
    (alpha, c_alpha), value-only.  The streaming session's dispatch."""
    _check(lat, "full", "dag")
    fr = lattice_frontiers(lat)
    am = arc_scores(lat, log_probs, kappa) + lat.lm
    own, corr, start, ok, final = dag_level_tensors(lat, am, fr)
    alpha_lv, c_alpha_lv, _, _ = dag_forward(own, corr, start, ok, final,
                                             fr.pidx)
    A = lat.num_arcs
    return (from_level_major(alpha_lv, fr.arc_pos, A, NEG),
            from_level_major(c_alpha_lv, fr.arc_pos, A, 0.0))
