"""Lattice engine: one forward-backward API (``lattice_stats``) over the
plain levelized backend and the CUDA kernel backend, and the forward-only
``lattice_forward``.  Port of ``repro.lattice_engine``; see ``api.py``
for dispatch semantics."""
from repro_torch.lattice_engine.api import (BACKENDS, lattice_forward,
                                            lattice_stats, resolve_backend)
from repro_torch.lattice_engine.common import (ACCUMULATORS, FBStats,
                                               LossStats, arc_scores,
                                               finalize, finalize_loss_only,
                                               lattice_is_sausage)

__all__ = [
    "ACCUMULATORS",
    "BACKENDS",
    "FBStats",
    "LossStats",
    "arc_scores",
    "finalize",
    "finalize_loss_only",
    "lattice_forward",
    "lattice_is_sausage",
    "lattice_stats",
    "resolve_backend",
]
