"""Adversarial lattice corpus — edge cases the DAG kernels must survive.

Port of ``repro.analysis.corpus``.  Each case is a *batched* ``Lattice``
built to sit on an edge the production generators rarely hit:

  * ``zero_arc``      — a batch whose single utterance has every arc
                        masked: every frontier position is the dump slot,
                        every masked reduction is over an empty set.
  * ``single_level``  — a one-level DAG (every arc both start AND final):
                        the predecessor gather never reads a real slot,
                        and the final-arc reduction spans level 0.
  * ``max_fanin``     — W parallel arcs converging on one sink arc: the
                        predecessor tensor is as wide as a level (P == W).
  * ``padded_row``    — a real sausage utterance batched with a fully
                        masked row: batch-level padding on every (L, W)
                        tensor.
  * ``packed_bucket`` — a serving bucket dispatch: two heterogeneous
                        requests plus an idle slot, every dimension
                        padded up.

The dict builders draw from the generator in the reference's order, so
one seed gives identical arrays in both packages.  ``SPILL_CASES``
holds one case of the port's own: a bucket whose kernel state passes the
shared memory a block has, so the global-state branches run.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from repro_torch.device import DEFAULT_DEVICE
from repro_torch.losses.lattice import (Lattice, batch_lattices,
                                        levelize_arcs, make_sausage_lattice)

# (lat, num_frames, num_states) — log-probs of shape (B, T, K) drive it
Case = Tuple[Lattice, int, int]

_T, _K = 8, 6


def _zero_arc_dict(rng, *, num_frames: int = _T, num_states: int = _K,
                   n_alt: int = 2) -> dict:
    """A sausage lattice with every arc masked out."""
    d = make_sausage_lattice(rng, num_frames=num_frames,
                             num_states=num_states, seg_len=4, n_alt=n_alt)
    d["arc_mask"] = np.zeros_like(d["arc_mask"])
    d["level_arcs"] = levelize_arcs(d["preds"], d["is_start"],
                                    d["arc_mask"])
    return d


def _single_level_dict(rng, *, num_frames: int = _T,
                       num_states: int = _K, n_arcs: int = 3) -> dict:
    """One topological level: every arc spans the whole utterance and is
    both a start and a final arc (no predecessors, no successors)."""
    label = rng.choice(num_states, size=n_arcs, replace=False).astype(np.int32)
    ref = np.full(num_frames, label[0], np.int32)
    corr = np.array([float(np.sum(ref == lab)) / num_frames
                     for lab in label], np.float32)
    d = dict(
        start_t=np.zeros(n_arcs, np.int32),
        end_t=np.full(n_arcs, num_frames, np.int32),
        label=label,
        lm=rng.normal(0.0, 0.3, size=n_arcs).astype(np.float32),
        corr=corr,
        preds=-np.ones((n_arcs, 1), np.int32),
        succs=-np.ones((n_arcs, 1), np.int32),
        is_start=np.ones(n_arcs, bool),
        is_final=np.ones(n_arcs, bool),
        arc_mask=np.ones(n_arcs, bool),
        ref_states=ref,
        num_ref_units=np.float32(1.0),
    )
    d["level_arcs"] = levelize_arcs(d["preds"], d["is_start"], d["arc_mask"])
    return d


def _max_fanin_dict(rng, *, num_frames: int = _T, num_states: int = _K,
                    fanin: int = 6) -> dict:
    """``fanin`` parallel arcs over the first half of the utterance all
    feeding ONE sink arc over the second half (P == W == fanin)."""
    mid = num_frames // 2
    A = fanin + 1
    label = np.concatenate([
        rng.choice(num_states, size=min(fanin, num_states),
                   replace=False),
        rng.integers(0, num_states, size=max(fanin - num_states, 0) + 1),
    ]).astype(np.int32)[:A]
    ref = np.concatenate([np.full(mid, label[0]),
                          np.full(num_frames - mid, label[fanin])])
    ref = ref.astype(np.int32)
    start_t = np.concatenate([np.zeros(fanin), [mid]]).astype(np.int32)
    end_t = np.concatenate([np.full(fanin, mid), [num_frames]]).astype(
        np.int32)
    corr = np.array([float(np.sum(ref[s:e] == lab)) / max(e - s, 1)
                     for s, e, lab in zip(start_t, end_t, label)],
                    np.float32)
    preds = -np.ones((A, fanin), np.int32)
    succs = -np.ones((A, fanin), np.int32)
    preds[fanin] = np.arange(fanin)          # the sink sees every arc
    succs[:fanin, 0] = fanin
    d = dict(
        start_t=start_t, end_t=end_t, label=label,
        lm=rng.normal(0.0, 0.3, size=A).astype(np.float32), corr=corr,
        preds=preds, succs=succs,
        is_start=np.concatenate([np.ones(fanin, bool), [False]]),
        is_final=np.concatenate([np.zeros(fanin, bool), [True]]),
        arc_mask=np.ones(A, bool), ref_states=ref,
        num_ref_units=np.float32(2.0),
    )
    d["level_arcs"] = levelize_arcs(d["preds"], d["is_start"], d["arc_mask"])
    return d


def zero_arc_case(seed: int = 0, device=DEFAULT_DEVICE) -> Case:
    rng = np.random.default_rng(seed)
    return batch_lattices([_zero_arc_dict(rng)], device=device), _T, _K


def single_level_case(seed: int = 0, device=DEFAULT_DEVICE) -> Case:
    rng = np.random.default_rng(seed)
    return batch_lattices([_single_level_dict(rng, n_arcs=3),
                           _single_level_dict(rng, n_arcs=3)],
                          device=device), _T, _K


def max_fanin_case(seed: int = 0, device=DEFAULT_DEVICE) -> Case:
    rng = np.random.default_rng(seed)
    return batch_lattices([_max_fanin_dict(rng)], device=device), _T, _K


def padded_row_case(seed: int = 0, device=DEFAULT_DEVICE) -> Case:
    """A real sausage utterance + a fully-masked row (same arc count)."""
    rng = np.random.default_rng(seed)
    real = make_sausage_lattice(rng, num_frames=_T, num_states=_K,
                                seg_len=4, n_alt=4)          # A = 8
    empty = _zero_arc_dict(rng, n_alt=4)                     # A = 8
    return batch_lattices([real, empty], device=device), _T, _K


def packed_bucket_case(seed: int = 0, device=DEFAULT_DEVICE) -> Case:
    """Two heterogeneous request lattices packed into one bucket-shaped
    batch with an idle slot: -1 level rows, masked pad arcs AND a fully
    empty lane in the same launch (``serving.packing``)."""
    from repro_torch.serving import packing

    rng = np.random.default_rng(seed)
    small = make_sausage_lattice(rng, num_frames=_T, num_states=_K,
                                 seg_len=4, n_alt=2)
    big = make_sausage_lattice(rng, num_frames=_T, num_states=_K,
                               seg_len=2, n_alt=3)
    spec = packing.derive_buckets([small, big], batch=3, tiers=1)[0]
    lat, _ = packing.pack_requests([small, big], spec, device=device)
    return lat, _T, _K


def spilled_state_case(seed: int = 0, device=DEFAULT_DEVICE) -> Case:
    """One long, wide sausage utterance (400 levels of 40 arcs, every arc
    valid) whose kernel state passes ``lattice_fb.SMEM_MAX``: the DAG
    kernels keep their compact state in global scratch (``gstride`` > 0)
    and ``sausage_loss_only`` spills its slots to its global scratch, as
    a long streaming session's bucket does.  Not a reference case."""
    rng = np.random.default_rng(seed)
    T, K = 400, 48
    d = make_sausage_lattice(rng, num_frames=T, num_states=K, seg_len=1,
                             n_alt=40)
    return batch_lattices([d], device=device), T, K


ADVERSARIAL_CASES: Dict[str, object] = {
    "zero_arc": zero_arc_case,
    "single_level": single_level_case,
    "max_fanin": max_fanin_case,
    "padded_row": padded_row_case,
    "packed_bucket": packed_bucket_case,
}
# the cases past the kernels' shared memory, beside the reference's five
SPILL_CASES: Dict[str, object] = {"spilled_state": spilled_state_case}
