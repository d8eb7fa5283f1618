"""The one lattice-statistics entry point: ``lattice_stats``.

    stats = lattice_stats(lat, log_probs, kappa, backend="auto")

Port of ``repro.lattice_engine.api``.  ``accumulators`` selects how much
of the statistics set is computed:

  * ``"full"``      — the complete arc-layout ``FBStats``;
  * ``"loss_only"`` — just ``LossStats(logZ, c_avg)``: no backward
                      recursion, and on the CUDA backend the fused
                      forward-only kernel.

Backends (both produce the same arc-layout statistics):

  * ``"levelized"`` — plain PyTorch loop over ``Lattice.level_arcs``
                      frontiers (any device; the CPU oracle);
  * ``"cuda"``      — the hand-written DAG kernels for any topology
                      (their plain versions for CPU tensors);
  * ``"auto"``      — the device decides: ``"cuda"`` for a lattice on a
                      CUDA device, ``"levelized"`` on the CPU.
"""
from __future__ import annotations

from repro_torch.lattice_engine.common import (FBStats, LossStats,
                                               check_accumulators)
from repro_torch.lattice_engine.cuda_backend import forward_backward_cuda
from repro_torch.lattice_engine.levelized import forward_backward_levelized
from repro_torch.losses.lattice import Lattice

BACKENDS = ("levelized", "cuda")

_DISPATCH = {
    "levelized": forward_backward_levelized,
    "cuda": forward_backward_cuda,
}


def resolve_backend(backend: str, lat: Lattice) -> str:
    """Turn 'auto' into a concrete backend name (see module docstring)."""
    if backend == "auto":
        return "cuda" if lat.device.type == "cuda" else "levelized"
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown lattice backend {backend!r}; expected one of "
            f"{BACKENDS + ('auto',)}")
    return backend


def lattice_stats(lat: Lattice, log_probs, kappa: float,
                  backend: str = "auto",
                  accumulators: str = "full") -> FBStats | LossStats:
    """Lattice forward-backward statistics over one API.

    Args:
      lat: batched ``losses.lattice.Lattice`` (any DAG topology, ragged
        padding via ``arc_mask``), with ``level_arcs``.
      log_probs: (B, T, K) frame log-probabilities on the lattice's
        device.
      kappa: acoustic scale.
      backend: ``"levelized" | "cuda" | "auto"`` (module docstring).
      accumulators: ``"full"`` -> ``FBStats``; ``"loss_only"`` ->
        ``LossStats(logZ, c_avg)``.
    """
    check_accumulators(accumulators)
    return _DISPATCH[resolve_backend(backend, lat)](
        lat, log_probs, kappa, accumulators=accumulators)
