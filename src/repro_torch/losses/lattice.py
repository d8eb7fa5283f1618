"""Packed word/phone lattices for discriminative sequence training.

Port of ``repro.losses.lattice``.  A lattice is a DAG of arcs; each arc
spans frames [start_t, end_t) and carries one HMM-state / DNN-output
label, a language/transition score, and a correctness count against the
reference (for MBR/MPE).  All per-utterance tensors are padded to a
static number of arcs ``A`` with ``arc_mask`` so batches stack.

Batch construction also *levelizes* the DAG: ``level_arcs`` is a (L, W)
frontier index tensor grouping arcs by topological depth (level l holds
every arc whose longest predecessor chain has length l, -1 padded to the
widest level).  Arcs within a level have no data dependencies, so the
forward-backward recursion runs as O(levels) dense steps.

The builders are host-side numpy and draw from a ``np.random.Generator``
in exactly the reference's order, so one seed gives identical arrays in
both packages; ``batch_lattices`` is where tensors (on ``device``) are
made.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import DEFAULT_DEVICE, resolve_device


class Lattice(NamedTuple):
    """Batched packed lattice.  Leading dim B on every field."""

    start_t: torch.Tensor      # (B, A) int32, arc start frame
    end_t: torch.Tensor        # (B, A) int32, arc end frame (exclusive)
    label: torch.Tensor        # (B, A) int32, DNN output unit of the arc
    lm: torch.Tensor           # (B, A) f32, language/transition log score
    corr: torch.Tensor         # (B, A) f32, raw correctness count of the arc
    preds: torch.Tensor        # (B, A, P) int32, predecessor arc ids (-1 pad)
    succs: torch.Tensor        # (B, A, S) int32, successor arc ids (-1 pad)
    is_start: torch.Tensor     # (B, A) bool
    is_final: torch.Tensor     # (B, A) bool
    arc_mask: torch.Tensor     # (B, A) bool, valid arcs
    ref_states: torch.Tensor   # (B, T) int32, reference state alignment
    num_ref_units: torch.Tensor  # (B,) f32, #reference phones (normaliser)
    level_arcs: torch.Tensor = None  # (B, L, W) int32, arcs by topo level

    @property
    def num_arcs(self):
        return self.start_t.shape[-1]

    @property
    def num_frames(self):
        return self.ref_states.shape[-1]

    @property
    def num_levels(self):
        return self.level_arcs.shape[-2]

    @property
    def device(self) -> torch.device:
        return self.start_t.device


def lattice_frame_counts(lat: Lattice) -> torch.Tensor:
    """(B,) f32: REAL frames per utterance — the largest arc end time over
    valid arcs (``ref_states`` may be edge-padded past the last arc)."""
    end = torch.where(lat.arc_mask, lat.end_t, torch.zeros_like(lat.end_t))
    return end.max(dim=-1).values.to(torch.float32)


def lattice_frame_mask(lat: Lattice) -> torch.Tensor:
    """(B, T) f32 mask: 1 on real frames, 0 on ``ref_states`` padding."""
    t = torch.arange(lat.num_frames, device=lat.device)
    counts = lattice_frame_counts(lat)
    return (t[None, :] < counts[:, None]).to(torch.float32)


class Frontiers(NamedTuple):
    """Levelized frontier tensors in KERNEL layout — what the DAG kernels
    (``kernels.lattice_fb.dag_forward``/``dag_backward``/
    ``dag_loss_only``) consume.  Positions are *level-major*: the arc at
    slot ``(l, w)`` of ``level_arcs`` lives at flat position ``l*W + w``;
    one extra "dump" slot at position ``L*W`` absorbs -1 pads and masked
    arcs so every gather is a fixed-shape dense op."""

    arc_pos: torch.Tensor   # (B, A+1) int32: arc id -> flat position
    pidx: torch.Tensor      # (B, L, W, P) int32: predecessor positions
    sidx: torch.Tensor      # (B, L, W, S) int32: successor positions
    ok: torch.Tensor        # (B, L, W) bool: slot holds a valid arc
    start: torch.Tensor     # (B, L, W) bool: slot holds a start arc
    final: torch.Tensor     # (B, L, W) bool: slot holds a final arc


def _neighbour_positions(ids, slot_arc, arc_pos, dump):
    """(B, A, N) neighbour arc ids -> (B, L*W, N) level-major positions of
    the neighbours of the arc in each slot (``dump`` for -1 pads)."""
    B, LW = slot_arc.shape
    N = ids.shape[-1]
    nb = ids.gather(1, slot_arc[:, :, None].expand(B, LW, N)).long()
    pos = arc_pos.gather(1, nb.clamp(min=0).reshape(B, LW * N))
    return torch.where(nb >= 0, pos.reshape(B, LW, N),
                       torch.full_like(nb, dump)).to(torch.int32)


def lattice_frontiers(lat: Lattice, *, max_levels: int | None = None,
                      max_width: int | None = None) -> Frontiers:
    """Build the levelized frontier tensors of a batched lattice in the
    kernels' level-major layout (integer/boolean tensor ops, on the
    lattice's device).

    ``max_levels``/``max_width`` pad ``level_arcs`` with -1 up to a fixed
    (L, W) first; padded slots map to the dump slot exactly like masked
    arcs, so results are bit-identical to the unpadded path.
    """
    if lat.level_arcs is None:
        raise ValueError(
            "lattice_frontiers needs Lattice.level_arcs, which this "
            "Lattice was built without.  Build batched lattices with "
            "repro_torch.losses.lattice.batch_lattices (it levelizes each "
            "lattice via levelize_arcs).")
    level_arcs = lat.level_arcs
    L, W = level_arcs.shape[-2:]
    tgt_l = L if max_levels is None else max_levels
    tgt_w = W if max_width is None else max_width
    if tgt_l < L or tgt_w < W:
        raise ValueError(
            f"lattice_frontiers: cannot shrink level_arcs {(L, W)} to "
            f"(max_levels={tgt_l}, max_width={tgt_w}); padding only")
    if (tgt_l, tgt_w) != (L, W):
        level_arcs = F.pad(level_arcs, (0, tgt_w - W, 0, tgt_l - L),
                           value=-1)
        L, W = tgt_l, tgt_w
    B, A, LW = level_arcs.shape[0], lat.num_arcs, L * W
    dev = level_arcs.device
    flat = level_arcs.reshape(B, LW).long()
    real = flat >= 0
    arc_pos = torch.full((B, A + 1), LW, dtype=torch.long, device=dev)
    slots = torch.arange(LW, device=dev).expand(B, LW)
    arc_pos.scatter_(1, torch.where(real, flat, A),
                     torch.where(real, slots, LW))
    slot_arc = flat.clamp(min=0)
    ok = real & lat.arc_mask.gather(1, slot_arc)
    start = ok & lat.is_start.gather(1, slot_arc)
    final = ok & lat.is_final.gather(1, slot_arc)
    pidx = _neighbour_positions(lat.preds, slot_arc, arc_pos, LW)
    sidx = _neighbour_positions(lat.succs, slot_arc, arc_pos, LW)
    return Frontiers(arc_pos=arc_pos.to(torch.int32),
                     pidx=pidx.reshape(B, L, W, -1),
                     sidx=sidx.reshape(B, L, W, -1),
                     ok=ok.reshape(B, L, W), start=start.reshape(B, L, W),
                     final=final.reshape(B, L, W))


def levelize_arcs(preds: np.ndarray, is_start: np.ndarray,  # reprolint: host: numpy builder
                  arc_mask: np.ndarray) -> np.ndarray:
    """Topological levelization of one lattice's arc DAG (numpy, unbatched).

    level(a) = 0 for start arcs, else 1 + max(level(pred)).  Requires arcs
    to be topologically sorted by id (predecessors before successors).
    Masked arcs are excluded.  Returns (L, W) int32 with -1 padding.
    """
    A = preds.shape[0]
    level = np.full(A, -1, np.int64)
    for a in range(A):
        if not arc_mask[a]:
            continue
        ps = preds[a]
        ps = ps[ps >= 0]
        ps = ps[arc_mask[ps]] if ps.size else ps
        if is_start[a] or ps.size == 0:
            level[a] = 0
        else:
            lp = level[ps]
            if (lp < 0).any():
                raise ValueError(
                    "levelize_arcs: arcs are not topologically sorted "
                    f"(arc {a} has an unlevelled predecessor)")
            level[a] = lp.max() + 1
    n_levels = int(level.max()) + 1 if (level >= 0).any() else 0
    groups = [np.where(level == lv)[0] for lv in range(n_levels)]
    width = max((len(g) for g in groups), default=0)
    out = -np.ones((max(n_levels, 1), max(width, 1)), np.int32)
    for lv, g in enumerate(groups):
        out[lv, :len(g)] = g
    return out


def make_sausage_lattice(rng: np.random.Generator, *,  # reprolint: host: numpy builder
                         num_frames: int, num_states: int, seg_len: int = 4,
                         n_alt: int = 3, max_arcs: int | None = None) -> dict:
    """Generate one synthetic sausage lattice as numpy arrays (unbatched):
    ``num_frames // seg_len`` segments of ``n_alt`` competing arcs (the
    first carries the reference label), consecutive segments fully
    connected."""
    n_seg = num_frames // seg_len
    ref = rng.integers(0, num_states, size=n_seg)
    A = n_seg * n_alt
    start_t = np.zeros(A, np.int32)
    end_t = np.zeros(A, np.int32)
    label = np.zeros(A, np.int32)
    lm = rng.normal(0.0, 0.3, size=A).astype(np.float32)
    corr = np.zeros(A, np.float32)
    P = n_alt
    preds = -np.ones((A, P), np.int32)
    succs = -np.ones((A, P), np.int32)
    is_start = np.zeros(A, bool)
    is_final = np.zeros(A, bool)
    for s in range(n_seg):
        for j in range(n_alt):
            a = s * n_alt + j
            start_t[a] = s * seg_len
            end_t[a] = (s + 1) * seg_len
            if j == 0:
                label[a] = ref[s]
            else:
                label[a] = rng.integers(0, num_states)
            corr[a] = 1.0 if label[a] == ref[s] else 0.0
            if s == 0:
                is_start[a] = True
            else:
                preds[a] = np.arange((s - 1) * n_alt, s * n_alt)
            if s == n_seg - 1:
                is_final[a] = True
            else:
                succs[a] = np.arange((s + 1) * n_alt, (s + 2) * n_alt)
    ref_states = np.repeat(ref, seg_len).astype(np.int32)
    if len(ref_states) < num_frames:
        ref_states = np.pad(ref_states, (0, num_frames - len(ref_states)),
                            mode="edge")
    out = dict(start_t=start_t, end_t=end_t, label=label, lm=lm, corr=corr,
               preds=preds, succs=succs, is_start=is_start, is_final=is_final,
               arc_mask=np.ones(A, bool), ref_states=ref_states,
               num_ref_units=np.float32(n_seg))
    if max_arcs is not None and max_arcs > A:
        pad = max_arcs - A
        for k in ("start_t", "end_t", "label", "lm", "corr",
                  "is_start", "is_final", "arc_mask"):
            out[k] = np.pad(out[k], (0, pad))
        for k in ("preds", "succs"):
            out[k] = np.pad(out[k], ((0, pad), (0, 0)), constant_values=-1)
    out["level_arcs"] = levelize_arcs(out["preds"], out["is_start"],
                                      out["arc_mask"])
    return out


def make_random_dag_lattice(rng: np.random.Generator, *,  # reprolint: host: numpy builder
                            num_frames: int, num_states: int,
                            skip_prob: float = 0.4,
                            max_alt: int = 3,
                            max_arcs: int | None = None) -> dict:
    """Generate one random general-DAG lattice as numpy arrays (unbatched).

    Nodes sit at random frame boundaries; consecutive nodes are always
    connected (every arc lies on a start->final path) and arcs over 2-3
    boundaries are added with ``skip_prob``, each boundary pair carrying
    1..max_alt parallel arcs with distinct labels.
    """
    n_inner = int(rng.integers(2, max(3, num_frames // 4)))
    inner = rng.choice(np.arange(1, num_frames), size=min(n_inner,
                                                          num_frames - 1),
                       replace=False)
    times = np.array(sorted({0, num_frames} | set(int(t) for t in inner)))
    N = len(times)
    ref = rng.integers(0, num_states, size=num_frames).astype(np.int32)

    raw = []                            # (start_node, end_node, label)
    for i in range(N - 1):
        targets = [i + 1]               # connectivity: consecutive nodes
        for j in range(i + 2, min(i + 4, N)):
            if rng.random() < skip_prob:
                targets.append(j)       # skip arc over 1-2 boundaries
        for j in targets:
            for lab in rng.choice(num_states, size=int(rng.integers(
                    1, max_alt + 1)), replace=False):
                raw.append((i, j, int(lab)))
    raw.sort()                          # (start, end) order => topological
    A = len(raw)

    start_t = np.array([times[i] for i, _, _ in raw], np.int32)
    end_t = np.array([times[j] for _, j, _ in raw], np.int32)
    label = np.array([lab for _, _, lab in raw], np.int32)
    lm = rng.normal(0.0, 0.3, size=A).astype(np.float32)
    corr = np.array([float(np.sum(ref[s:e] == lab)) / max(e - s, 1)
                     for (s, e, lab) in zip(start_t, end_t, label)],
                    np.float32)
    by_end = {}                         # node -> arc ids ending there
    by_start = {}                       # node -> arc ids starting there
    for a, (i, j, _) in enumerate(raw):
        by_end.setdefault(j, []).append(a)
        by_start.setdefault(i, []).append(a)
    P = max(max((len(v) for v in by_end.values()), default=1),
            max((len(v) for v in by_start.values()), default=1))
    preds = -np.ones((A, P), np.int32)
    succs = -np.ones((A, P), np.int32)
    for a, (i, j, _) in enumerate(raw):
        for k, p in enumerate(by_end.get(i, [])):
            preds[a, k] = p
        for k, s in enumerate(by_start.get(j, [])):
            succs[a, k] = s
    is_start = np.array([i == 0 for i, _, _ in raw])
    is_final = np.array([j == N - 1 for _, j, _ in raw])

    out = dict(start_t=start_t, end_t=end_t, label=label, lm=lm, corr=corr,
               preds=preds, succs=succs, is_start=is_start, is_final=is_final,
               arc_mask=np.ones(A, bool), ref_states=ref,
               num_ref_units=np.float32(N - 1))
    if max_arcs is not None:
        if max_arcs < A:
            raise ValueError(f"max_arcs={max_arcs} < generated arcs {A}")
        pad = max_arcs - A
        for k in ("start_t", "end_t", "label", "lm", "corr",
                  "is_start", "is_final", "arc_mask"):
            out[k] = np.pad(out[k], (0, pad))
        for k in ("preds", "succs"):
            out[k] = np.pad(out[k], ((0, pad), (0, 0)), constant_values=-1)
    out["level_arcs"] = levelize_arcs(out["preds"], out["is_start"],
                                      out["arc_mask"])
    return out


def as_tensor(x, device: torch.device) -> torch.Tensor:  # reprolint: host: numpy to the device
    """array -> tensor (a copy) with the reference's dtypes: int32 for
    integers, f32 for floats, bool for flags."""
    x = np.asarray(x)
    if x.dtype == np.bool_:
        dtype = np.bool_
    elif np.issubdtype(x.dtype, np.integer):
        dtype = np.int32
    else:
        dtype = np.float32
    return torch.from_numpy(np.array(x, dtype=dtype)).to(device)


def batch_lattices(lats: list[dict], device=DEFAULT_DEVICE) -> Lattice:  # reprolint: host: numpy
    """Stack per-utterance lattice dicts into one ``Lattice`` on
    ``device``, levelizing any dict that lacks ``level_arcs`` and padding
    the ragged pred/succ fan and level shapes with -1 (ragged *arc*
    counts are the caller's job via the builders' ``max_arcs``)."""
    dev = resolve_device(device)
    lats = [dict(d) for d in lats]
    for d in lats:
        if "level_arcs" not in d:
            d["level_arcs"] = levelize_arcs(d["preds"], d["is_start"],
                                            d["arc_mask"])
    for k in ("preds", "succs"):
        cols = max(d[k].shape[1] for d in lats)
        for d in lats:
            d[k] = np.pad(d[k], ((0, 0), (0, cols - d[k].shape[1])),
                          constant_values=-1)
    rows = max(d["level_arcs"].shape[0] for d in lats)
    cols = max(d["level_arcs"].shape[1] for d in lats)
    for d in lats:
        la = d["level_arcs"]
        d["level_arcs"] = np.pad(la, ((0, rows - la.shape[0]),
                                      (0, cols - la.shape[1])),
                                 constant_values=-1)
    return Lattice(**{k: as_tensor(np.stack([d[k] for d in lats]), dev)
                      for k in Lattice._fields})


def make_lattice_batch(seed: int, *, batch: int,  # reprolint: host: numpy builder
                       num_frames: int, num_states: int, seg_len: int = 4,
                       n_alt: int = 3, device=DEFAULT_DEVICE) -> Lattice:
    rng = np.random.default_rng(seed)
    return batch_lattices([
        make_sausage_lattice(rng, num_frames=num_frames,
                             num_states=num_states, seg_len=seg_len,
                             n_alt=n_alt)
        for _ in range(batch)], device=device)
