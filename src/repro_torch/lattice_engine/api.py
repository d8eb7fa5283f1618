"""The lattice-statistics entry points: ``lattice_stats`` and the
forward-only ``lattice_forward``.

    stats = lattice_stats(lat, log_probs, kappa, backend="auto")

Port of ``repro.lattice_engine.api``.  ``accumulators`` selects how much
of the statistics set is computed:

  * ``"full"``      — the complete arc-layout ``FBStats``;
  * ``"loss_only"`` — just ``LossStats(logZ, c_avg)``: no backward
                      recursion, and on the CUDA backend one fused
                      forward-only kernel.

``logZ`` and ``c_avg`` are differentiable w.r.t. the log-probs and the
lattice's ``lm``/``corr`` on both backends (``torch.autograd.grad`` and
``torch.func`` transforms); the per-arc statistics are constants.

Backends (both produce the same arc-layout statistics):

  * ``"levelized"`` — plain PyTorch loop over ``Lattice.level_arcs``
                      frontiers (any device; the CPU oracle, differentiated
                      by autograd);
  * ``"cuda"``      — the hand-written kernels: sausage kernels for a
                      sausage lattice, DAG kernels otherwise (their plain
                      versions for CPU tensors), differentiated through
                      the occupancy identities;
  * ``"auto"``      — the device decides: ``"cuda"`` for a lattice on a
                      CUDA device, ``"levelized"`` on the CPU.  The jitted
                      JAX trainer resolves ``"auto"`` to ``levelized``
                      (its lattices are traced); see ``cuda_backend``.

``topology="dag"`` keeps the CUDA backend on the DAG kernels for every
lattice (the rescoring service's choice; ``"auto"`` dispatches by
``lattice_is_sausage``).  The levelized backend ignores it.
"""
from __future__ import annotations

from repro_torch.lattice_engine.common import (FBStats, LossStats,
                                               check_accumulators)
from repro_torch.lattice_engine.cuda_backend import (forward_alpha_cuda,
                                                     forward_backward_cuda)
from repro_torch.lattice_engine.levelized import (forward_alpha_levelized,
                                                  forward_backward_levelized)
from repro_torch.losses.lattice import Lattice

BACKENDS = ("levelized", "cuda")


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
                  backend: str = "auto", accumulators: str = "full",
                  topology: str = "auto") -> FBStats | LossStats:
    """Lattice forward-backward statistics over one API.

    Args:
      lat: batched ``losses.lattice.Lattice`` (any DAG topology, ragged
        padding via ``arc_mask``), with ``level_arcs``.
      log_probs: (B, T, K) frame log-probabilities on the lattice's
        device.
      kappa: acoustic scale (a Python float).
      backend: ``"levelized" | "cuda" | "auto"`` (module docstring).
      accumulators: ``"full"`` -> ``FBStats``; ``"loss_only"`` ->
        ``LossStats(logZ, c_avg)``.
      topology: ``"auto"`` (sausage kernels for sausages) or ``"dag"``.
    """
    check_accumulators(accumulators)
    if resolve_backend(backend, lat) == "cuda":
        return forward_backward_cuda(lat, log_probs, kappa,
                                     accumulators=accumulators,
                                     topology=topology)
    return forward_backward_levelized(lat, log_probs, kappa,
                                      accumulators=accumulators)


def lattice_forward(lat: Lattice, log_probs, kappa: float,
                    backend: str = "auto"):
    """The forward recursion alone: arc-layout (alpha, c_alpha) (B, A),
    value-only — one ``dag_forward`` on ``"cuda"``, the forward levels on
    ``"levelized"``.  Equal, bit for bit, to the alpha/c_alpha fields of
    ``lattice_stats(..., accumulators="full")`` on the same backend's DAG
    path; what the streaming session needs, without the backward
    recursion, gamma and the other scatters."""
    if resolve_backend(backend, lat) == "cuda":
        return forward_alpha_cuda(lat, log_probs, kappa)
    return forward_alpha_levelized(lat, log_probs, kappa)
