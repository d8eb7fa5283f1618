"""Lattice-rescoring service (port of ``repro.serving``).

Layers (request -> pack -> kernel -> unpack):

  * ``packing``   — ragged request lattices padded into fixed bucket
                    shapes; one input shape per bucket.
  * ``service``   — queue, admission control, slot assignment,
                    deadlines, batched dispatch (``--smoke`` CLI).
  * ``streaming`` — alpha-frontier checkpoints + virtual-start resume
                    for growing partial lattices, bit-exact vs
                    from-scratch.
  * ``metrics``   — latency percentiles.
"""
from repro_torch.serving.packing import (BucketSpec, LatticeDims,
                                         choose_bucket, derive_buckets,
                                         lattice_dims, pack_requests, unpack)
from repro_torch.serving.streaming import (StreamSession,
                                           resume_lattice_dict,
                                           session_bucket, truncate_levels)

_SERVICE_EXPORTS = ("RescoreRequest", "RescoringService",
                    "synthetic_workload")


def __getattr__(name):
    # service is loaded lazily so `python -m repro_torch.serving.service`
    # does not import the module twice (runpy's sys.modules warning)
    if name in _SERVICE_EXPORTS:
        from repro_torch.serving import service
        return getattr(service, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "BucketSpec", "LatticeDims", "choose_bucket", "derive_buckets",
    "lattice_dims", "pack_requests", "unpack", "RescoreRequest",
    "RescoringService", "synthetic_workload", "StreamSession",
    "resume_lattice_dict", "session_bucket", "truncate_levels",
]
