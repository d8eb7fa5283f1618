"""Ragged frontier packing: many small request lattices -> one bucket.

Port of ``repro.serving.packing``.  Requests arrive with heterogeneous
lattices (arc, frame, level, width and fan counts vary).  A small fixed
menu of *bucket shapes* pads every lattice dimension up to the bucket;
empty batch slots are fully-masked lattices, and padded ``level_arcs``
rows map to the kernels' dump slot exactly like masked arcs.  Every
dispatch of a bucket then has one input shape, and — because the
kernels run one thread block per utterance that never exchanges data —
a request's results are bit-identical whichever other requests share
its dispatch.

Everything here is host-side numpy batch construction; tensors (on the
service's device) are made by ``batch_lattices`` at the very end.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.device import DEFAULT_DEVICE
from repro_torch.losses.lattice import batch_lattices, levelize_arcs


class BucketSpec(NamedTuple):
    """Static shape of one packed dispatch."""

    batch: int         # B: request slots per dispatch
    num_arcs: int      # A: padded arc count
    num_frames: int    # T: padded frame count
    num_levels: int    # L: padded topological depth
    level_width: int   # W: padded level width
    fan: int           # P: padded pred/succ fan-in width

    @property
    def cost(self) -> int:
        """Relative padded launch cost (frontier slots per dispatch)."""
        return self.batch * self.num_levels * self.level_width


class LatticeDims(NamedTuple):
    """Shape envelope of one request lattice dict."""

    num_arcs: int
    num_frames: int
    num_levels: int
    level_width: int
    fan: int


def lattice_dims(d: dict) -> LatticeDims:
    """Measure the shape envelope of one (unbatched) lattice dict."""
    la = d.get("level_arcs")
    if la is None:
        la = levelize_arcs(d["preds"], d["is_start"], d["arc_mask"])
    return LatticeDims(
        num_arcs=int(d["arc_mask"].shape[0]),
        num_frames=int(d["ref_states"].shape[0]),
        num_levels=int(la.shape[0]),
        level_width=int(la.shape[1]),
        fan=int(max(d["preds"].shape[1], d["succs"].shape[1])),
    )


def fits(dims: LatticeDims, spec: BucketSpec) -> bool:
    return (dims.num_arcs <= spec.num_arcs
            and dims.num_frames <= spec.num_frames
            and dims.num_levels <= spec.num_levels
            and dims.level_width <= spec.level_width
            and dims.fan <= spec.fan)


def choose_bucket(dims: LatticeDims, buckets) -> BucketSpec:
    """Smallest-cost bucket that fits; clear error when none does."""
    fitting = [b for b in buckets if fits(dims, b)]
    if not fitting:
        raise ValueError(
            f"no bucket fits lattice dims {tuple(dims)}; largest of the "
            f"{len(list(buckets))} configured buckets is "
            f"{tuple(max(buckets, key=lambda b: b.cost))} "
            f"(fields: {BucketSpec._fields})")
    return min(fitting, key=lambda b: b.cost)


def derive_buckets(dicts, *, batch: int, tiers: int = 2):
    """Build a bucket menu from a sample workload: sort by arc count,
    split into ``tiers`` contiguous chunks, take the elementwise max
    envelope of each chunk.  Every sampled lattice fits some tier."""
    dims = sorted((lattice_dims(d) for d in dicts),
                  key=lambda x: x.num_arcs)
    tiers = max(1, min(tiers, len(dims)))
    size = (len(dims) + tiers - 1) // tiers
    out = []
    for i in range(0, len(dims), size):
        chunk = dims[i:i + size]
        out.append(BucketSpec(batch,
                              *[max(getattr(c, f) for c in chunk)
                                for f in LatticeDims._fields]))
    # dedupe identical tiers (tiny workloads collapse)
    return tuple(dict.fromkeys(out))


def empty_lattice_dict(spec: BucketSpec) -> dict:  # reprolint: host: numpy packing
    """A fully-masked lattice filling one idle bucket slot: every frontier
    position is the dump slot and every masked reduction is over the
    empty set (the ``zero_arc`` corpus case)."""
    A, T, P = spec.num_arcs, spec.num_frames, spec.fan
    return dict(
        start_t=np.zeros(A, np.int32),
        end_t=np.zeros(A, np.int32),
        label=np.zeros(A, np.int32),
        lm=np.zeros(A, np.float32),
        corr=np.zeros(A, np.float32),
        preds=-np.ones((A, P), np.int32),
        succs=-np.ones((A, P), np.int32),
        is_start=np.zeros(A, bool),
        is_final=np.zeros(A, bool),
        arc_mask=np.zeros(A, bool),
        ref_states=np.zeros(T, np.int32),
        num_ref_units=np.float32(1.0),
        level_arcs=-np.ones((spec.num_levels, spec.level_width), np.int32),
    )


def pad_to_bucket(d: dict, spec: BucketSpec) -> dict:  # reprolint: host: numpy packing
    """Pad one lattice dict up to the bucket envelope.  Padded arcs are
    masked; padded ``level_arcs``/``preds``/``succs`` slots are -1;
    padded frames extend ``ref_states`` edge-style (no arc spans them)."""
    dims = lattice_dims(d)
    if not fits(dims, spec):
        raise ValueError(f"lattice dims {tuple(dims)} exceed bucket "
                         f"{tuple(spec)}")
    out = dict(d)
    if "level_arcs" not in out:
        out["level_arcs"] = levelize_arcs(out["preds"], out["is_start"],
                                          out["arc_mask"])
    pad_a = spec.num_arcs - dims.num_arcs
    for k in ("start_t", "end_t", "label", "lm", "corr",
              "is_start", "is_final", "arc_mask"):
        out[k] = np.pad(out[k], (0, pad_a))
    for k in ("preds", "succs"):
        v = out[k]
        out[k] = np.pad(v, ((0, pad_a), (0, spec.fan - v.shape[1])),
                        constant_values=-1)
    out["ref_states"] = np.pad(out["ref_states"],
                               (0, spec.num_frames - dims.num_frames),
                               mode="edge")
    la = out["level_arcs"]
    out["level_arcs"] = np.pad(
        la, ((0, spec.num_levels - la.shape[0]),
             (0, spec.level_width - la.shape[1])), constant_values=-1)
    return out


def pack_requests(dicts, spec: BucketSpec, device=DEFAULT_DEVICE) -> tuple:
    """Pack up to ``spec.batch`` request lattices into ONE bucket-shaped
    ``Lattice`` on ``device``.  Free slots are filled with
    ``empty_lattice_dict``.  Returns ``(lat, n_live)``; request
    ``i < n_live`` sits in batch row ``i``."""
    n_live = len(dicts)
    if n_live == 0 or n_live > spec.batch:
        raise ValueError(f"pack_requests: got {n_live} lattices for a "
                         f"batch={spec.batch} bucket")
    rows = [pad_to_bucket(d, spec) for d in dicts]
    rows += [empty_lattice_dict(spec)] * (spec.batch - n_live)
    return batch_lattices(rows, device=device), n_live


def pack_log_probs(lps, spec: BucketSpec) -> np.ndarray:  # reprolint: host: numpy packing
    """Stack per-request (T_i, K) log-probs to (B, T, K) numpy, zero-
    padding frames and idle slots.  Arc scores are padding-invariant: the
    mean-centred cumsum's ``mu`` term cancels exactly over every arc span,
    and no arc endpoint indexes past its request's real frames."""
    K = int(lps[0].shape[-1])
    out = np.zeros((spec.batch, spec.num_frames, K), np.float32)
    for i, lp in enumerate(lps):
        t = lp.shape[0]
        if t > spec.num_frames:
            raise ValueError(f"log_probs frames {t} exceed bucket "
                             f"num_frames={spec.num_frames}")
        out[i, :t] = np.asarray(lp, np.float32)
    return out


def unpack(values, n_live: int) -> np.ndarray:  # reprolint: host: results to the host
    """Per-request rows of a batched statistic (a tensor on any device):
    drop the idle slots, as numpy."""
    return values.detach().cpu().numpy()[:n_live]


def pack_efficiency(lats_dims, spec: BucketSpec, n_live: int) -> dict:
    """Fill metrics of one dispatch: live-slot fraction and real-arc
    fraction of the padded launch."""
    real_arcs = sum(d.num_arcs for d in lats_dims)
    return {
        "slot_fill": n_live / spec.batch,
        "arc_fill": real_arcs / float(spec.batch * spec.num_arcs),
    }
