"""CUDA backend: lattice statistics on the hand-written DAG kernels.

Twin of the general-DAG half of ``repro.lattice_engine.pallas_backend``.
Every topology, sausages included, runs the DAG kernels over the
levelized frontier tensors (``losses.lattice.lattice_frontiers``), as
the JAX package's jitted serving path does.

  * ``accumulators="full"``: ONE ``dag_forward`` and ONE ``dag_backward``
    launch; per-arc statistics are scattered back to arc layout and
    ``logZ``/``c_avg`` come from the forward kernel's final-arc
    reduction.  (The JAX backend calls the forward kernel twice and
    relies on XLA's dead-code elimination; PyTorch runs eagerly.)
  * ``accumulators="loss_only"``: ONE fused ``dag_loss_only`` launch from
    the raw (B, T, K) log-probs and arc-layout fields; only (logZ, c_avg)
    come back.

The kernel wrappers choose by device: CUDA tensors launch the kernels,
CPU tensors run their plain versions (``kernels.ref``), so this backend
also runs, unchanged, in the CPU tests.  Value-only: an input that
requires grad raises (the occupancy-identity ``autograd.Function`` comes
with the training slice).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.lattice_fb import (dag_backward, dag_forward,
                                            dag_loss_only)
from repro_torch.kernels.ref import gather_sausage_ref
from repro_torch.lattice_engine.common import (NEG, FBStats, LossStats,
                                               arc_scores,
                                               check_accumulators,
                                               from_level_major)
from repro_torch.losses.lattice import Lattice, lattice_frontiers


def dag_level_tensors(lat: Lattice, am, fr):
    """Gather arc-layout scores + frontier flags into the kernels'
    level-major f32 layout.  ``am``: (B, A) acoustic+lm arc scores."""
    own = gather_sausage_ref(am, lat.level_arcs, NEG)
    corr = gather_sausage_ref(lat.corr.to(torch.float32), lat.level_arcs,
                              0.0)
    return (own, corr, fr.start.to(torch.float32),
            fr.ok.to(torch.float32), fr.final.to(torch.float32))


def _no_grad_inputs(*tensors) -> None:
    if any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "the 'cuda' lattice backend is value-only in this slice; "
            "gradients through the DAG kernels (the occupancy-identity "
            "autograd.Function) come with the training slice.  Use "
            "backend='levelized' or detach the inputs.")


def forward_backward_cuda(lat: Lattice, log_probs: torch.Tensor,
                          kappa: float, accumulators: str = "full"
                          ) -> FBStats | LossStats:
    """Lattice statistics via the DAG kernels — any topology."""
    check_accumulators(accumulators)
    if lat.level_arcs is None:
        raise ValueError(
            "cuda backend needs Lattice.level_arcs; build batches with "
            "repro_torch.losses.lattice.batch_lattices (levelizes "
            "automatically)")
    _no_grad_inputs(log_probs, lat.lm, lat.corr)
    fr = lattice_frontiers(lat)
    if accumulators == "loss_only":
        logZ, c_avg = dag_loss_only(
            log_probs.to(torch.float32), lat.start_t, lat.end_t, lat.label,
            lat.lm, lat.corr, lat.arc_mask, lat.is_start, lat.is_final,
            lat.level_arcs.contiguous(), fr.pidx, kappa=kappa)
        return LossStats(logZ=logZ, c_avg=c_avg)
    am = arc_scores(lat, log_probs, kappa) + lat.lm            # (B, A)
    own, corr, start, ok, final = dag_level_tensors(lat, am, fr)
    alpha_lv, c_alpha_lv, logZ, c_avg = dag_forward(own, corr, start, ok,
                                                    final, fr.pidx)
    beta_lv, c_beta_lv = dag_backward(own, corr, final, ok, fr.sidx)
    gamma_lv = torch.where(ok > 0.5,
                           torch.exp(alpha_lv + beta_lv
                                     - logZ[:, None, None]),
                           torch.zeros_like(alpha_lv))
    A = lat.num_arcs
    alpha = from_level_major(alpha_lv, fr.arc_pos, A, NEG)
    beta = from_level_major(beta_lv, fr.arc_pos, A, NEG)
    c_alpha = from_level_major(c_alpha_lv, fr.arc_pos, A, 0.0)
    c_beta = from_level_major(c_beta_lv, fr.arc_pos, A, 0.0)
    gamma = from_level_major(gamma_lv, fr.arc_pos, A, 0.0)
    return FBStats(alpha=alpha, beta=beta, logZ=logZ, gamma=gamma,
                   c_alpha=c_alpha, c_beta=c_beta, c_avg=c_avg,
                   c_arc=c_alpha + c_beta)
