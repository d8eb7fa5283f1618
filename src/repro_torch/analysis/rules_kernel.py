"""Kernel-sanitizer rules: pure checks over captured CUDA launches.

Port of ``repro.analysis.rules_kernel``.  Everything here takes a
``kernels.instrument.KernelCall`` record (the launcher, its library, the
route, the launch configuration the host chose and the named tensor
operands) or plain tensors, and returns a list of failure strings, so
every rule is testable on hand-built records without a card.
``sanitize_kernels`` runs the real wrappers over the adversarial corpus
and applies these rules.

Rule ids (the reference's, checked against what a CUDA launch needs):

  KS001  launch structure: threads a multiple of 32 in [32, 1024] (at
         most ``lattice_fb.MAX_THREADS`` for the DAG kernels); dynamic
         shared bytes within 232,448 less the kernel's static shared
         memory (ptxas ``-v``, ``parse_ptxas``); ``gstride`` a multiple
         of 16, and nonzero only when the plan's worst-case state passes
         ``SMEM_MAX``; grid dimensions within CUDA's limits; the
         attention kernels' tile geometry as ``swa_geometry`` /
         ``swa_bwd_geometry`` and the library's shared bytes give it.
         The record's plan is built by the same functions
         (``dag_forward_plan`` ..., ``swa_geometry``) that KS001
         recomputes it with, so the plan-equality check only guards the
         plumbing from the plan to the record and the launch; the bounds
         checks above are what can fail on a real plan
  KS002  frontier invariants: ``arc_pos``/``pidx``/``sidx`` inside the
         (L*W+1,) buffer (dump slot included), masked arcs on the dump
         slot, ``level_arcs`` entries unique valid arc ids
  KS003  gather bounds: every index operand a kernel gathers with lies
         inside the buffer it indexes.  ``csrc/lattice_dag.cu`` reads an
         out-of-range position as NEG / 0, so an off-by-one frontier
         gives a plausible wrong logZ with no fault: only a check of the
         captured index operands sees it
  KS004  oracle agreement and finiteness: outputs match the plain
         version (``kernels/ref.py``) and hold no NaN/+inf (the -1e30
         masked sentinel is legal)
  KS005  precision flow: under bf16 inputs the lse sums (logZ, c_avg,
         alpha ...) and the CG's <r, r> stay f32 while the CG's x and r
         stay bf16 (checked by running the wrappers on small real
         tensors: the wrappers refuse the meta device)
"""
from __future__ import annotations

import re
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import cg_fused as CG
from repro_torch.kernels import lattice_fb as LF
from repro_torch.kernels import swa_attention as SWA

NEG = -1e30
SMEM_PER_BLOCK = 232_448          # the H100's shared memory a block can use
GRID_LIMITS = (2 ** 31 - 1, 65_535, 65_535)

# launcher -> substrings of its kernels' mangled names in ptxas's report
KERNELS_OF: Dict[str, Tuple[str, ...]] = {
    "dag_forward_launch": ("dag_forward_kernel",),
    "dag_backward_launch": ("dag_backward_kernel",),
    "dag_loss_only_launch": ("dag_loss_only_kernel",),
    "sausage_forward_launch": ("sausage_forward_kernel",),
    "sausage_backward_launch": ("sausage_backward_kernel",),
    "sausage_loss_only_launch": ("sausage_loss_only_kernel",),
    "cg_fused_update_launch": ("cg_update_kernel", "sum_partials_kernel"),
    "swa_attention_launch": ("swa_fwd_kernel",),
    "swa_attention_sm90_launch": ("swa_sm90_kernel",),
    "swa_attention_dq_launch": ("swa_dq_kernel",),
    "swa_attention_dkdv_launch": ("swa_dkdv_kernel",),
    "swa_attention_jvp_launch": ("swa_jvp_kernel",),
    "swa_attention_dq_sm90_launch": ("swa_dq_sm90_kernel",),
    "swa_attention_dkdv_sm90_launch": ("swa_dkdv_sm90_kernel",),
    "swa_attention_jvp_sm90_launch": ("swa_jvp_sm90_kernel",),
}
# launcher -> the library (``csrc/<stem>.cu``) that holds it, as the
# wrappers' own tables name them
STEM_OF: Dict[str, str] = {**LF.LAUNCHERS, **CG.LAUNCHERS, **SWA.LAUNCHERS}
_DAG_PLANS = {"dag_forward_launch": ("pidx", LF.dag_forward_plan),
              "dag_loss_only_launch": ("pidx", LF.dag_forward_plan),
              "dag_backward_launch": ("sidx", LF.dag_backward_plan)}


# ---------------------------------------------------------------------------
# KS001: launch structure
# ---------------------------------------------------------------------------

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_USED = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")
_SPILL = re.compile(r"(\d+) bytes spill stores")


def parse_ptxas(log: str) -> Dict[str, dict]:
    """ptxas ``-v`` output -> {mangled kernel name: {"registers",
    "smem" (static shared bytes), "spill" (bytes of spill stores)}}."""
    out: Dict[str, dict] = {}
    name = None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            name = m.group(1)
            out[name] = {"registers": 0, "smem": 0, "spill": 0}
            continue
        if name is None:
            continue
        m = _SPILL.search(line)
        if m:
            out[name]["spill"] = int(m.group(1))
        m = _USED.search(line)
        if m:
            out[name]["registers"] = int(m.group(1))
            out[name]["smem"] = int(m.group(2) or 0)
    return out


def static_smem(ptxas: Dict[str, dict], launcher: str) -> int:
    """The largest static shared memory of ``launcher``'s kernels (every
    template instance) in a ``parse_ptxas`` report; 0 if none is listed."""
    subs = KERNELS_OF[launcher]
    return max([v["smem"] for k, v in ptxas.items()
                if any(s in k for s in subs)], default=0)


def _check_threads(name: str, threads: int, most: int) -> List[str]:
    if threads % 32 or not 32 <= threads <= most:
        return [f"KS001: {name}: {threads} threads, expected a multiple of "
                f"32 in [32, {most}]"]
    return []


def _check_grid(name: str, grid) -> List[str]:
    if len(grid) > 3 or any(not 1 <= g <= lim
                            for g, lim in zip(grid, GRID_LIMITS)):
        return [f"KS001: {name}: grid {tuple(grid)} outside CUDA's limits "
                f"[1, {GRID_LIMITS}]"]
    return []


def _check_dag(call) -> List[str]:
    name, cfg, shp = call.name, call.config, call.shapes
    idx, plan_of = _DAG_PLANS[name]
    if name == "dag_loss_only_launch":
        L, W = shp["level_arcs"][1:3]
    else:
        L, W = shp["own"][1:3]
    R = shp[idx][-1]
    out = _check_threads(name, cfg["threads"], LF.MAX_THREADS)
    plan = plan_of(L, W, R)
    got = (cfg["threads"], cfg["smem"], cfg["gstride"])
    if got != plan:
        out.append(f"KS001: {name}: (threads, smem, gstride) {got} is not "
                   f"the plan {plan} for (L, W, {idx[0].upper()}) = "
                   f"({L}, {W}, {R})")
    worst = LF._STATE_BYTES[name[:-len("_launch")]](L * W, L, R)
    gstride = cfg["gstride"]
    if gstride % 16:
        out.append(f"KS001: {name}: gstride {gstride} is not a multiple "
                   f"of 16")
    if bool(gstride) != (worst > LF.SMEM_MAX) or 0 < gstride < worst:
        out.append(f"KS001: {name}: gstride {gstride} for a worst-case "
                   f"state of {worst} bytes (SMEM_MAX {LF.SMEM_MAX})")
    return out


def _check_sausage_loss_only(call) -> List[str]:
    cfg = call.config
    S, W = call.shapes["level_arcs"][1:3]
    plan = LF.sausage_loss_only_plan(S, W)
    got = (cfg["threads"], cfg["smem"], cfg["scratch"])
    out = _check_threads(call.name, cfg["threads"], 1024)
    if got != plan:
        out.append(f"KS001: {call.name}: (threads, smem, scratch) {got} is "
                   f"not the plan {plan} for (S, W) = ({S}, {W})")
    return out


def _check_swa(call) -> List[str]:
    name, cfg = call.name, call.config
    B, T, H, hd = call.shapes["q"]
    K = call.shapes["k"][2]
    out = []
    if hd > SWA.MAX_HEAD_DIM or K == 0 or H % K:
        out.append(f"KS001: {name}: q {(B, T, H, hd)} with {K} kv heads")
    if not 0 <= cfg["window"] <= T:
        out.append(f"KS001: {name}: window {cfg['window']} not in [0, {T}]")
    geo = cfg.get("geometry")
    if geo is None:
        # the CUDA-core kernels' grid: (query tiles, heads or kv heads, B)
        out += _check_grid(name, (1, K if "dkdv" in name else H, B))
        return out
    if name == "swa_attention_dkdv_sm90_launch":
        want = SWA.swa_bwd_geometry(B, T, H, K, hd, cfg["window"])
    else:
        want = SWA.swa_geometry(B, T, H, K, hd, cfg["window"])
    if tuple(geo) != tuple(want):
        out.append(f"KS001: {name}: geometry {geo} is not {want}")
    if geo.hd_pad not in (64, 128, 256) or geo.hd_pad < hd \
            or geo.queries * geo.heads > geo.rows \
            or geo.heads * geo.head_tiles < geo.group:
        out.append(f"KS001: {name}: tiles {geo} do not cover (query, head) "
                   f"rows of hd {hd}")
    return out + _check_grid(name, geo.grid)


def check_call_structure(call, *, static: Dict[str, int] = None,
                         dynamic_smem: Dict[tuple, int] = None) -> List[str]:
    """KS001 over one captured launch.  ``static``: {launcher: static
    shared bytes} from ptxas (``static_smem``); ``dynamic_smem``:
    {(tensor-core launcher, hd_pad): dynamic shared bytes} from the
    library (``swa_attention.sm90_smem_bytes``).  Both are facts of a
    build on the card; without them the shared-memory sums are not
    checked."""
    static = static or {}
    name, cfg = call.name, call.config
    if name in _DAG_PLANS:
        out = _check_dag(call)
    elif name == "sausage_loss_only_launch":
        out = _check_sausage_loss_only(call)
    elif name.startswith("swa_attention"):
        out = _check_swa(call)
    else:
        out = []
    if "grid" in cfg and cfg["grid"][0] > 0:
        out += _check_grid(name, cfg["grid"])
    smem = cfg.get("smem")
    if "geometry" in cfg:
        smem = (dynamic_smem or {}).get((name, cfg["geometry"].hd_pad))
    if smem is not None and name in static:
        room = SMEM_PER_BLOCK - static[name]
        if not 0 <= smem <= room:
            out.append(f"KS001: {name}: {smem} dynamic shared bytes beside "
                       f"{static[name]} static, more than the {room} a "
                       f"block has left of {SMEM_PER_BLOCK}")
    return out


# ---------------------------------------------------------------------------
# KS002: frontier-tensor invariants (losses.lattice.lattice_frontiers)
# ---------------------------------------------------------------------------

def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def check_frontier_invariants(lat, fr) -> List[str]:
    """KS002 over one batched lattice and its ``Frontiers``: every position
    tensor stays inside the (L*W+1,) level-major buffer (dump slot L*W
    included), masked arcs land on the dump slot, and every valid
    ``level_arcs`` entry is a unique in-range arc id."""
    out: List[str] = []
    la = _np(lat.level_arcs)
    B, L, W = la.shape
    A = int(_np(lat.arc_mask).shape[1])
    dump = L * W
    for name, t in (("arc_pos", fr.arc_pos), ("pidx", fr.pidx),
                    ("sidx", fr.sidx)):
        t = _np(t)
        lo, hi = int(t.min()), int(t.max())
        if lo < 0 or hi > dump:
            out.append(f"KS002: {name} range [{lo}, {hi}] outside the "
                       f"(L*W+1,) buffer [0, {dump}] (dump slot {dump})")
    if la.min() < -1 or la.max() >= A:
        out.append(f"KS002: level_arcs range [{la.min()}, {la.max()}] "
                   f"outside [-1, {A})")
    arc_pos = _np(fr.arc_pos)
    mask = _np(lat.arc_mask)
    for b in range(B):
        valid = la[b][la[b] >= 0]
        if len(valid) != len(np.unique(valid)):
            out.append(f"KS002: batch row {b}: duplicate arc ids in "
                       f"level_arcs")
        # masked arcs never appear in level_arcs, so their position is the
        # dump slot: a gather through a stale position would read live
        # alpha values for dead arcs
        dead = ~mask[b]
        if dead.any() and (arc_pos[b, :A][dead] != dump).any():
            bad = np.where(dead & (arc_pos[b, :A] != dump))[0][:3]
            out.append(f"KS002: batch row {b}: masked arcs {bad.tolist()} "
                       f"map to live frontier slots, expected dump {dump}")
    return out


# ---------------------------------------------------------------------------
# KS003: gather bounds of captured index operands
# ---------------------------------------------------------------------------

def _positions(key: str) -> Callable:
    """Bounds of a frontier position tensor into the (L*W+1,) buffer of
    the (B, L, W) operand ``key``: the dump slot L*W is legal."""
    return lambda shp: (0, shp[key][1] * shp[key][2] + 1)


def _valid_arcs(ops):
    """The arcs whose fields a loss-only kernel reads: those set in
    ``arc_mask`` (bool, or f32 above 0.5); a masked arc's span and label
    are never read, and may be anything."""
    m = ops["arc_mask"]
    return m if m.dtype == torch.bool else m > 0.5


_SPANS = [
    ("start", lambda shp: (0, shp["log_probs"][1] + 1), _valid_arcs),
    ("end", lambda shp: (0, shp["log_probs"][1] + 1), _valid_arcs),
    ("label", lambda shp: (0, shp["log_probs"][2]), _valid_arcs),  # [0, K)
    ("level_arcs", lambda shp: (-1, shp["start"][1]), None),       # [-1, A)
]

# launcher -> [(operand, bounds fn, elements read)]: the bounds fn maps
# the record's operand shapes to the half-open range (lo, hi) every
# element the kernel reads of that index operand must lie in (all of it
# when the third entry is None).  -1 pads level_arcs (an empty slot); the
# frontier positions use the dump slot L*W as their largest legal value;
# frames span [0, T].  The reference's ``idx`` into the cumsum grid has no
# counterpart: the port's loss-only kernels sum spans of the raw
# log-probs.
GATHER_SPECS: Dict[str, List[Tuple[str, Callable, Callable]]] = {
    "dag_forward_launch": [("pidx", _positions("own"), None)],
    "dag_backward_launch": [("sidx", _positions("own"), None)],
    "dag_loss_only_launch": _SPANS + [("pidx", _positions("level_arcs"),
                                       None)],
    "sausage_loss_only_launch": list(_SPANS),
}


def check_gather_bounds(call) -> List[str]:
    """KS003 over one captured launch: every registered index operand is
    inside the bounds of the buffer it gathers from."""
    specs = GATHER_SPECS.get(call.name)
    if not specs or not call.operands:
        return []
    out: List[str] = []
    shapes = call.shapes
    for name, bounds, read in specs:
        t = call.operands[name]
        if read is not None:
            t = t[read(call.operands)]
        if t.numel() == 0:
            continue
        lo, hi = bounds(shapes)
        amin, amax = int(t.min()), int(t.max())
        if amin < lo or amax >= hi:
            out.append(
                f"KS003: {call.name} ({call.route}) operand {name}: values "
                f"in [{amin}, {amax}] escape the legal gather range [{lo}, "
                f"{hi}); the kernel reads such a position as an empty slot, "
                f"a plausible wrong result with no fault")
    return out


# ---------------------------------------------------------------------------
# KS004: oracle agreement + finiteness
# ---------------------------------------------------------------------------

def _f64(t) -> np.ndarray:
    # host-side comparison precision, never on the device path
    if isinstance(t, torch.Tensor):
        t = t.detach().to("cpu", torch.float32).numpy()
    return np.asarray(t, dtype=np.float64)  # reprolint: disable=RL007


def check_finite(name: str, outputs: Sequence, labels=None) -> List[str]:
    """KS004a: no NaN and no +inf anywhere (the -1e30 masked sentinel and
    large negative values are legal)."""
    out: List[str] = []
    labels = labels or [f"out{i}" for i in range(len(outputs))]
    for lbl, t in zip(labels, outputs):
        a = _f64(t)
        if np.isnan(a).any():
            out.append(f"KS004: {name} {lbl}: NaN at "
                       f"{np.argwhere(np.isnan(a))[:3].tolist()}")
        if np.isposinf(a).any():
            out.append(f"KS004: {name} {lbl}: +inf at "
                       f"{np.argwhere(np.isposinf(a))[:3].tolist()}")
    return out


def diff_outputs(name: str, got: Sequence, want: Sequence, *,
                 atol: float = 1e-4, rtol: float = 1e-4,
                 labels=None) -> List[str]:
    """KS004b: kernel outputs against the plain version's.  Masked
    sentinel slots (<= NEG/2 on both sides) compare equal whatever their
    magnitude."""
    out: List[str] = []
    labels = labels or [f"out{i}" for i in range(len(got))]
    for lbl, g, w in zip(labels, got, want):
        g, w = _f64(g), _f64(w)
        if g.shape != w.shape:
            out.append(f"KS004: {name} {lbl}: shape {g.shape} != oracle "
                       f"{w.shape}")
            continue
        both_masked = (g <= NEG / 2) & (w <= NEG / 2)
        err = np.abs(g - w) - (atol + rtol * np.abs(w))
        bad = (err > 0) & ~both_masked & ~(np.isnan(g) & np.isnan(w))
        if bad.any():
            i = tuple(np.argwhere(bad)[0])
            out.append(f"KS004: {name} {lbl}: differs from oracle at "
                       f"{list(i)}: kernel {g[i]:.6g} vs ref {w[i]:.6g} "
                       f"({int(bad.sum())} mismatched elements)")
    return out


# ---------------------------------------------------------------------------
# KS005: precision flow under bf16 inputs
# ---------------------------------------------------------------------------

def check_output_dtypes(name: str, fn, args, expected) -> List[str]:
    """KS005: run ``fn(*args)`` on small real tensors and compare the
    flattened output dtypes against ``expected`` (a list of (label,
    dtype)).  An lse sum or <r, r> kept in bf16 loses about 8 bits at a
    time, and the paper's few trusted CG iterations with it."""
    try:
        res = fn(*args)
    except Exception as e:   # a refusal is a finding, not a crash
        return [f"KS005: {name}: the call raised {e!r}"]
    leaves = list(res) if isinstance(res, (tuple, list)) else [res]
    if len(leaves) != len(expected):
        return [f"KS005: {name}: {len(leaves)} outputs, expected "
                f"{len(expected)}"]
    out: List[str] = []
    for leaf, (lbl, dt) in zip(leaves, expected):
        if leaf.dtype != dt:
            out.append(f"KS005: {name} {lbl}: accumulates/returns "
                       f"{leaf.dtype}, expected {dt}: bf16 inputs must not "
                       f"degrade the accumulator")
    return out
