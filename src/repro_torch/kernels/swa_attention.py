"""Wrappers of the hand-written Hopper sliding-window attention kernels,
forward and derivatives.

Port of ``repro.kernels.swa_attention.swa_attention``: the forward of
sliding-window causal attention, query t over the keys t - window ... t
(window + 1 keys, clipped at 0), scores scaled by 1/sqrt(hd), softmax
and P.V in f32, output in q's dtype.  q is (B, T, H, hd) and k/v are
(B, T, K, hd) with H a multiple of K: the kernels read kv head
h // (H // K), so MQA/GQA K/V are never repeated (the Pallas kernel
takes them repeated).  Any T, any window >= 0 and hd <= 256 are taken;
the kernels mask the ragged edge themselves.

Routing of the forward, by device and dtype only (never by failure):

* CPU tensors: the plain version ``kernels.ref.swa_attention_ref``,
  differentiated by autograd and ``torch.func``;
* CUDA bf16 tensors with hd % 8 == 0: the tensor-core kernel
  ``csrc/swa_attention_sm90.cu`` (wgmma + TMA, P.V at f32 accuracy by a
  split P), launched with the geometry of ``swa_geometry``;
* CUDA f32 tensors: the CUDA-core kernel ``csrc/swa_attention.cu``, the
  exact f32 path (the tensor cores would round f32 inputs); and CUDA bf16
  tensors whose hd is not a multiple of 8, which TMA's 16-byte strides
  cannot describe (no arch in the repo has such an hd).

Every CUDA call runs through ``_SwaAttention``, an ``autograd.Function``
whose derivatives are hand-written kernels too: its backward launches
``swa_attention_vjp``'s dq kernel and then its dk/dv kernel, its jvp
``swa_attention_jvp``'s kernel.  The derivatives route as the forward
does, by dtype and hd only: bf16 with hd % 8 == 0 takes the tensor-core
kernels of ``csrc/swa_attention_bwd_sm90.cu`` (wgmma + TMA; P, dS and the
jvp's X split for f32 accuracy; the dq and jvp kernels run the forward's
tiles, the dk/dv kernel walks those of ``swa_bwd_geometry``), f32 and any
other hd the CUDA-core kernels of ``csrc/swa_attention_bwd.cu``, the
exact f32 path.  Plain autograd,
``torch.func.jvp``, ``vjp``, ``grad`` and ``linearize`` (NGHF's curvature
products) run them; under ``torch.no_grad`` (prefill) the Function
launches the forward kernel alone, the same bits as before it existed.
The forward and jvp launches are ``torch.library`` custom ops with fake
implementations, so ``torch.func.linearize``'s trace records them instead
of baking their output into the graph as a constant.  The derivatives are
first-order only: a jvp or vjp of them raises.

A CUDA launch that fails to build or launch raises.  ``q_offset != 0``
(queries past the keys' start; no caller in the repo) is taken by the
plain version only.

Launch counts: ``swa_attention.launches`` (the tensor-core kernel, the
bf16 main path), ``swa_attention.cuda_core_launches`` (the CUDA-core
kernel), ``swa_attention_vjp.dq_launches`` and ``.dkdv_launches`` (the
tensor-core backward), ``.cuda_core_dq_launches`` and
``.cuda_core_dkdv_launches`` (the CUDA-core backward),
``swa_attention_jvp.launches`` (the tensor-core jvp) and
``.cuda_core_launches`` (the CUDA-core jvp); the plain versions count
nothing.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from repro_torch.core.functorch_levels import (first_order_only,
                                               outside_transforms, rewrap,
                                               unwrap_one_level)
from repro_torch.kernels import build, instrument, ref
from repro_torch.kernels.lattice_fb import _check_kernel_input, _on_cuda

MAX_HEAD_DIM = 256
ROWS = 128          # (query, head) rows of a tensor-core tile
KEY_TILE = 64       # keys per K/V tile of the tensor-core kernel
_STORAGE = {torch.float32: 0, torch.bfloat16: 1}

_PTR, _INT, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# batch seq heads kv_heads hd window | scale | storage | stream: the
# shape arguments of every launcher but the tensor-core one's
_SHAPE = [_INT] * 6 + [_F32, _INT, _PTR]
# q k v o | shape
_CORE_SIGNATURES = {"swa_attention_launch": [_PTR] * 4 + _SHAPE}
# q k v o | batch seq heads kv_heads hd window | queries heads head_tiles
# hd_pad grid_x grid_y | scale | stream
_SM90_SIGNATURES = {"swa_attention_sm90_launch": [_PTR] * 4 + [_INT] * 12
                    + [_F32, _PTR],
                    "swa_attention_sm90_smem_bytes": [_INT]}
# q k v g dq lse dd | q k v g lse dd dk dv | q k v tq tk tv tout, then
# the shape
_BWD_SIGNATURES = {"swa_attention_dq_launch": [_PTR] * 7 + _SHAPE,
                   "swa_attention_dkdv_launch": [_PTR] * 8 + _SHAPE,
                   "swa_attention_jvp_launch": [_PTR] * 7 + _SHAPE}
# q k v g dq lse dd | batch seq heads kv_heads hd window | queries heads
# head_tiles hd_pad grid_x grid_y | scale | stream; q k v g lse dd dk dv |
# batch seq heads kv_heads hd window | walk queries heads head_tiles mag
# hd_pad grid_x | scale | stream; q k v tq tk tv tout | as dq's
_SM90_BWD_SIGNATURES = {
    "swa_attention_dq_sm90_launch": [_PTR] * 7 + [_INT] * 12 + [_F32, _PTR],
    "swa_attention_dkdv_sm90_launch": [_PTR] * 8 + [_INT] * 12
    + [_F32, _PTR],
    "swa_attention_jvp_sm90_launch": [_PTR] * 7 + [_INT] * 12
    + [_F32, _PTR],
    "swa_attention_bwd_sm90_smem_bytes": [_INT, _INT]}


class SwaGeometry(NamedTuple):
    """Launch geometry of the tensor-core kernel.

    Block (x, y, z) owns ``rows`` (query, head) rows: queries
    ``x * queries`` + 0 .. queries - 1 of batch row z, times the
    ``heads`` query heads ``(y // head_tiles) * G + (y % head_tiles) *
    heads`` + 0 .. heads - 1, which all read kv head ``y // head_tiles``
    (G = H // K).  Row r is query ``r // heads`` and head ``r % heads`` of
    the tile; rows past a query or head range are masked.  The block walks
    the keys ``key_span(x)``."""
    rows: int
    queries: int         # queries per tile
    heads: int           # query heads per tile, all of one kv head
    head_tiles: int      # tiles across the G heads of one kv head
    hd_pad: int          # hd padded to 64, 128 or 256 (TMA zero-fills)
    grid: tuple          # (query tiles, K * head_tiles, B)
    seq: int
    group: int           # G = H // K
    window: int          # min(window, T), as the kernel takes it

    def key_span(self, x: int) -> tuple:
        """(first key, key tiles of KEY_TILE) of query tile x: the keys
        max(0, t0 - window) .. min(t0 + queries, T) - 1."""
        t0 = x * self.queries
        first = max(0, t0 - self.window)
        last = min(t0 + self.queries, self.seq)
        return first, -(-(last - first) // KEY_TILE)

    def tile_rows(self, x: int, y: int):
        """(query (rows,), head (rows,), valid (rows,)) of block (x, y, .),
        the kernel's row mapping."""
        r = torch.arange(self.rows)
        tq, gi = r // self.heads, r % self.heads
        ht = y % self.head_tiles
        t = x * self.queries + tq
        head = (y // self.head_tiles) * self.group + ht * self.heads + gi
        valid = ((tq < self.queries) & (t < self.seq)
                 & (ht * self.heads + gi < self.group))
        return t, head, valid


def swa_geometry(B: int, T: int, H: int, K: int, hd: int,
                 window: int) -> SwaGeometry:
    """The tensor-core kernel's tiles for q (B, T, H, hd) and k/v
    (B, T, K, hd): 128 rows of (query, head) pairs, 128 // G queries x the
    G heads of one kv head (G = H // K), so a K/V tile serves all G heads;
    G > 128 takes one query x 128 heads a tile."""
    group = H // K
    heads = min(group, ROWS)
    queries = ROWS // heads
    head_tiles = -(-group // heads)
    hd_pad = 64 if hd <= 64 else 128 if hd <= 128 else 256
    grid = (-(-T // queries), K * head_tiles, B)
    return SwaGeometry(ROWS, queries, heads, head_tiles, hd_pad, grid, T,
                       group, min(window, T))


class SwaBwdGeometry(NamedTuple):
    """The walk of the tensor-core dk/dv kernel.

    Block (x, y, z) owns keys ``x * KEY_TILE`` + 0 .. KEY_TILE - 1 of kv
    head y in batch row z and walks tiles of ``rows`` (query, head) rows:
    ``queries`` queries x ``heads`` query heads of the kv group (all G when
    G <= 64, else ``head_tiles`` tiles of 64), row r being query r //
    heads and head r % heads of the tile.  Its query tiles start at the
    key tile's first key and step by ``queries`` up to the last query that
    sees one of its keys (``query_span``); each query tile is walked for
    every head tile in turn.  The kernel forms r // heads as (r * mag) >>
    16.  The dq kernel writes each row's log-sum-exp and D to a (B, K, T,
    G) f32 side output, so a walked tile's valid rows are one run of it
    (``walk``'s side offsets)."""
    rows: int            # (query, head) rows of a walked tile
    queries: int         # queries per walked tile
    heads: int           # query heads per walked tile
    head_tiles: int      # walked tiles across the G heads of one kv head
    mag: int             # ceil(2^16 / heads)
    hd_pad: int
    grid: tuple          # (key tiles, K, B)
    seq: int
    group: int
    window: int          # min(window, T), as the kernel takes it

    def query_span(self, x: int) -> tuple:
        """(first query, query tiles) of key tile x: the queries s .. min(s
        + KEY_TILE - 1 + window, T - 1), s = x * KEY_TILE."""
        s = x * KEY_TILE
        last = min(s + KEY_TILE - 1 + self.window, self.seq - 1)
        return s, (last - s) // self.queries + 1

    def walked_tiles(self, x: int) -> int:
        return self.query_span(x)[1] * self.head_tiles

    def walk(self, x: int, y: int):
        """(query, head, valid, side-output offset within batch row 0),
        each (walked tiles, rows), of every walked tile of block (x, y, .)
        in the kernel's order: its row mapping."""
        s, _ = self.query_span(x)
        i = torch.arange(self.walked_tiles(x))[:, None]
        t0 = s + (i // self.head_tiles) * self.queries
        hb = (i % self.head_tiles) * self.heads
        r = torch.arange(self.rows)[None, :]
        t = t0 + ((r * self.mag) >> 16)
        head = y * self.group + hb + r % self.heads
        if self.head_tiles == 1:
            n_valid = torch.clamp((self.seq - t0) * self.group,
                                  max=self.queries * self.heads)
        else:
            n_valid = torch.clamp(self.group - hb, max=self.heads)
        side = (y * self.seq + t0) * self.group + hb + r
        return t, head, r < n_valid, side


def swa_bwd_geometry(B: int, T: int, H: int, K: int, hd: int,
                     window: int) -> SwaBwdGeometry:
    """The tensor-core dk/dv kernel's walk for q (B, T, H, hd) and k/v (B,
    T, K, hd): one block per (64-key tile, kv head, batch row), walked
    tiles of 64 rows, 64 // G queries x the G heads of one kv head (G > 64:
    one query x 64 heads a tile)."""
    group = H // K
    heads = min(group, KEY_TILE)
    return SwaBwdGeometry(
        KEY_TILE, KEY_TILE // heads, heads, -(-group // heads),
        -(-65536 // heads), swa_geometry(B, T, H, K, hd, window).hd_pad,
        (-(-T // KEY_TILE), K, B), T, group, min(window, T))


# kind -> ((stem, launcher) of the CUDA-core kernel, of the tensor-core one)
_LAUNCHERS = {
    "forward": (("swa_attention", "swa_attention_launch"),
                ("swa_attention_sm90", "swa_attention_sm90_launch")),
    "dq": (("swa_attention_bwd", "swa_attention_dq_launch"),
           ("swa_attention_bwd_sm90", "swa_attention_dq_sm90_launch")),
    "dkdv": (("swa_attention_bwd", "swa_attention_dkdv_launch"),
             ("swa_attention_bwd_sm90", "swa_attention_dkdv_sm90_launch")),
    "jvp": (("swa_attention_bwd", "swa_attention_jvp_launch"),
            ("swa_attention_bwd_sm90", "swa_attention_jvp_sm90_launch")),
}
# launcher -> the library (``csrc/<stem>.cu``) that holds it
LAUNCHERS = {fn: stem for pair in _LAUNCHERS.values() for stem, fn in pair}


def _record(kind: str, tc: bool, route: str, config: dict,
            **operands) -> tuple:
    """Record the ``kind`` launch of the tensor-core (``tc``) or CUDA-core
    kernel (``instrument.record``); returns its (stem, launcher)."""
    stem, launcher = _LAUNCHERS[kind][tc]
    instrument.record(stem, launcher, route, config, **operands)
    return stem, launcher


def _record_plain(kinds: tuple, window: int, core: bool, **operands) -> None:
    """The plain route's capture records: for each of ``kinds`` the
    launcher the card would run on ``operands`` (q, k, ...), with its
    configuration."""
    if not instrument.capturing():
        return
    B, T, H, hd = operands["q"].shape
    K = operands["k"].shape[2]
    tc = not core and _tensor_core(operands["q"])
    for kind in kinds:
        config = {"window": min(window, T)}
        if tc:
            geo = (swa_bwd_geometry if kind == "dkdv" else swa_geometry)(
                B, T, H, K, hd, window)
            config["geometry"] = geo
        _record(kind, tc, "plain", config, **operands)


def _launch_sm90(q, k, v, out, window: int) -> None:
    B, T, H, hd = q.shape
    K = k.shape[2]
    geo = swa_geometry(B, T, H, K, hd, window)
    stem, fn = _record("forward", True, "cuda",
                       {"window": geo.window, "geometry": geo}, q=q, k=k,
                       v=v)
    build.launch(stem, _SM90_SIGNATURES, fn, q.device, q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), out.data_ptr(), B, T, H, K, hd,
                 geo.window, geo.queries, geo.heads, geo.head_tiles,
                 geo.hd_pad, geo.grid[0], geo.grid[1], 1.0 / math.sqrt(hd))
    swa_attention.launches += 1


def sm90_smem_bytes(hd_pad: int) -> int:
    """Dynamic shared memory (bytes) of a tensor-core launch at padded head
    dim ``hd_pad``; builds the library if it is missing."""
    lib = build.library("swa_attention_sm90", _SM90_SIGNATURES)
    return lib.swa_attention_sm90_smem_bytes(hd_pad)


def _shape_args(q, k, window: int) -> tuple:
    """The launchers' shape arguments (``_SHAPE``); the kernels take the
    window clipped to T."""
    B, T, H, hd = q.shape
    return (B, T, H, k.shape[2], hd, min(window, T), 1.0 / math.sqrt(hd),
            _STORAGE[q.dtype])


def sm90_bwd_smem_bytes(kernel: str, hd_pad: int) -> int:
    """Dynamic shared memory (bytes) of a tensor-core derivative launch
    (``kernel`` "dq", "dkdv" or "jvp") at padded head dim ``hd_pad``;
    builds the library if it is missing."""
    lib = build.library("swa_attention_bwd_sm90", _SM90_BWD_SIGNATURES)
    return lib.swa_attention_bwd_sm90_smem_bytes(
        {"dq": 0, "dkdv": 1, "jvp": 2}[kernel], hd_pad)


def _tensor_core(q) -> bool:
    """The tensor-core kernels take bf16 with hd % 8 == 0 (TMA's 16-byte
    strides); everything else goes to the CUDA-core kernels."""
    return q.dtype == torch.bfloat16 and q.shape[3] % 8 == 0


def _check_aligned(name: str, ts: dict) -> None:
    for arg, t in ts.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} is not 16-byte aligned, as the "
                             f"tensor-core kernel's TMA loads need")


def _forward(q, k, v, window: int, core: bool):
    """The forward kernels' routing on validated CUDA inputs (``core``
    forces the CUDA-core kernel), or the plain version on CPU inputs."""
    if not q.is_cuda:
        _record_plain(("forward",), window, core, q=q, k=k, v=v)
        return ref.swa_attention_ref(q, k, v, window)
    out = torch.empty_like(q)
    if core or not _tensor_core(q):
        stem, fn = _record("forward", False, "cuda",
                           {"window": min(window, q.shape[1])}, q=q, k=k,
                           v=v)
        build.launch(stem, _CORE_SIGNATURES, fn, q.device, q.data_ptr(),
                     k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     *_shape_args(q, k, window))
        swa_attention.cuda_core_launches += 1
        return out
    _check_aligned("swa_attention", {"q": q, "k": k, "v": v})
    _launch_sm90(q, k, v, out, window)
    return out


def _check_like(name: str, ts: dict, q) -> None:
    for arg, t in ts.items():
        _check_kernel_input(name, arg, t, q.dtype)


def launch_dq(q, k, v, g, window: int, core: bool = False) -> tuple:
    """The backward's first kernel on checked CUDA inputs: (dq, lse, dd),
    lse and dd each row's log-sum-exp and D = sum_j P dP in f32.  bf16 with
    hd % 8 == 0 (unless ``core``) launches the tensor-core kernel, lse and
    dd then (B, K, T, G), and counts ``swa_attention_vjp.dq_launches``;
    otherwise the CUDA-core kernel, lse and dd (B, H, T), counting
    ``.cuda_core_dq_launches``."""
    B, T, H, hd = q.shape
    K = k.shape[2]
    dq = torch.empty_like(q)
    if core or not _tensor_core(q):
        lse = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
        dd = torch.empty_like(lse)
        stem, fn = _record("dq", False, "cuda", {"window": min(window, T)},
                           q=q, k=k, v=v, g=g)
        build.launch(stem, _BWD_SIGNATURES, fn, q.device, q.data_ptr(),
                     k.data_ptr(), v.data_ptr(), g.data_ptr(), dq.data_ptr(),
                     lse.data_ptr(), dd.data_ptr(),
                     *_shape_args(q, k, window))
        swa_attention_vjp.cuda_core_dq_launches += 1
        return dq, lse, dd
    _check_aligned("swa_attention_vjp", {"q": q, "k": k, "v": v, "g": g})
    geo = swa_geometry(B, T, H, K, hd, window)
    lse = torch.empty(B, K, T, H // K, dtype=torch.float32, device=q.device)
    dd = torch.empty_like(lse)
    stem, fn = _record("dq", True, "cuda",
                       {"window": geo.window, "geometry": geo}, q=q, k=k,
                       v=v, g=g)
    build.launch(stem, _SM90_BWD_SIGNATURES, fn, q.device, q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), g.data_ptr(), dq.data_ptr(),
                 lse.data_ptr(), dd.data_ptr(), B, T, H, K, hd, geo.window,
                 geo.queries, geo.heads, geo.head_tiles, geo.hd_pad,
                 geo.grid[0], geo.grid[1], 1.0 / math.sqrt(hd))
    swa_attention_vjp.dq_launches += 1
    return dq, lse, dd


def launch_dkdv(q, k, v, g, lse, dd, window: int,
                core: bool = False) -> tuple:
    """The backward's second kernel on checked CUDA inputs and
    ``launch_dq``'s lse and dd (of the same ``core``): (dk, dv).  Routes
    and counts as ``launch_dq``: ``swa_attention_vjp.dkdv_launches`` (the
    tensor-core kernel) or ``.cuda_core_dkdv_launches``."""
    B, T, H, hd = q.shape
    K = k.shape[2]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if core or not _tensor_core(q):
        stem, fn = _record("dkdv", False, "cuda",
                           {"window": min(window, T)}, q=q, k=k, v=v, g=g,
                           lse=lse, dd=dd)
        build.launch(stem, _BWD_SIGNATURES, fn, q.device, q.data_ptr(),
                     k.data_ptr(), v.data_ptr(), g.data_ptr(),
                     lse.data_ptr(), dd.data_ptr(), dk.data_ptr(),
                     dv.data_ptr(), *_shape_args(q, k, window))
        swa_attention_vjp.cuda_core_dkdv_launches += 1
        return dk, dv
    _check_aligned("swa_attention_vjp", {"q": q, "k": k, "v": v, "g": g})
    if lse.shape != (B, K, T, H // K) or dd.shape != lse.shape:
        raise ValueError(f"swa_attention_vjp: lse {tuple(lse.shape)} and dd "
                         f"{tuple(dd.shape)} are not the tensor-core dq "
                         f"kernel's (B, K, T, G) side outputs")
    geo = swa_bwd_geometry(B, T, H, K, hd, window)
    stem, fn = _record("dkdv", True, "cuda",
                       {"window": geo.window, "geometry": geo}, q=q, k=k,
                       v=v, g=g, lse=lse, dd=dd)
    build.launch(stem, _SM90_BWD_SIGNATURES, fn, q.device, q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
                 dd.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, T, H, K, hd,
                 geo.window, geo.queries, geo.heads, geo.head_tiles, geo.mag,
                 geo.hd_pad, geo.grid[0], 1.0 / math.sqrt(hd))
    swa_attention_vjp.dkdv_launches += 1
    return dk, dv


def swa_attention_vjp(q, k, v, g, window: int, *, core: bool = False):
    """The backward of ``swa_attention`` (q_offset 0): (dq, dk, dv) for
    the output's cotangent ``g`` (B, T, H, hd).  CUDA tensors (contiguous,
    all of q's dtype) launch the dq kernel (``launch_dq``) and then the
    dk/dv kernel (``launch_dkdv``): bf16 with hd % 8 == 0 those of
    ``csrc/swa_attention_bwd_sm90.cu``, f32, other hd and ``core`` those of
    ``csrc/swa_attention_bwd.cu``.  CPU tensors take
    ``ref.swa_attention_vjp_ref``."""
    name = "swa_attention_vjp"
    if not _on_cuda(name, q, k, v, g):
        _record_plain(("dq", "dkdv"), window, core, q=q, k=k, v=v, g=g)
        return ref.swa_attention_vjp_ref(q, k, v, g, window)
    _check_like(name, {"q": q, "k": k, "v": v, "g": g}, q)
    dq, lse, dd = launch_dq(q, k, v, g, window, core)
    return (dq,) + launch_dkdv(q, k, v, g, lse, dd, window, core)


def swa_attention_jvp(q, k, v, tq, tk, tv, window: int, *,
                      core: bool = False):
    """The forward-mode derivative of ``swa_attention`` (q_offset 0): the
    output's tangent for tangents (tq, tk, tv) of (q, k, v).  CUDA tensors
    (contiguous, all of q's dtype): bf16 with hd % 8 == 0 (unless
    ``core``) launch the tensor-core kernel of
    ``csrc/swa_attention_bwd_sm90.cu`` on the forward's tiles
    (``swa_geometry``), counting ``launches``; f32, other hd and ``core``
    the CUDA-core kernel of ``csrc/swa_attention_bwd.cu``, counting
    ``cuda_core_launches``.  CPU tensors take
    ``ref.swa_attention_jvp_ref``."""
    name = "swa_attention_jvp"
    if not _on_cuda(name, q, k, v, tq, tk, tv):
        _record_plain(("jvp",), window, core, q=q, k=k, v=v, tq=tq,
                      tk=tk, tv=tv)
        return ref.swa_attention_jvp_ref(q, k, v, tq, tk, tv, window)
    ts = {"q": q, "k": k, "v": v, "tq": tq, "tk": tk, "tv": tv}
    _check_like(name, ts, q)
    out = torch.empty_like(q)
    if core or not _tensor_core(q):
        stem, fn = _record("jvp", False, "cuda",
                           {"window": min(window, q.shape[1])}, **ts)
        build.launch(stem, _BWD_SIGNATURES, fn, q.device, q.data_ptr(),
                     k.data_ptr(), v.data_ptr(), tq.data_ptr(),
                     tk.data_ptr(), tv.data_ptr(), out.data_ptr(),
                     *_shape_args(q, k, window))
        swa_attention_jvp.cuda_core_launches += 1
        return out
    _check_aligned(name, ts)
    B, T, H, hd = q.shape
    geo = swa_geometry(B, T, H, k.shape[2], hd, window)
    stem, fn = _record("jvp", True, "cuda",
                       {"window": geo.window, "geometry": geo}, **ts)
    build.launch(stem, _SM90_BWD_SIGNATURES, fn, q.device,
                 *(t.data_ptr() for t in ts.values()), out.data_ptr(), B, T,
                 H, k.shape[2], hd, geo.window, geo.queries, geo.heads,
                 geo.head_tiles, geo.hd_pad, geo.grid[0], geo.grid[1],
                 1.0 / math.sqrt(hd))
    swa_attention_jvp.launches += 1
    return out


# The forward and jvp launches are custom ops, so that
# ``torch.func.linearize``'s trace (``make_fx``) records them as operations
# of its graph: a ctypes launch inside the trace would be invisible to it,
# and the graph would replay the output the trace saw for every later
# tangent.  Nothing traces a backward, which launches directly (autograd
# does not run inside a custom op, and the CPU path's plain backward is
# autograd's).
@torch.library.custom_op("repro_torch::swa_attention_fwd", mutates_args=())
def _fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int,
            core: bool) -> torch.Tensor:
    return _forward(q, k, v, window, core)


@_fwd_op.register_fake
def _(q, k, v, window, core):
    return torch.empty_like(q)


@torch.library.custom_op("repro_torch::swa_attention_jvp", mutates_args=())
def _jvp_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            tq: torch.Tensor, tk: torch.Tensor, tv: torch.Tensor,
            window: int) -> torch.Tensor:
    return swa_attention_jvp(q, k, v, tq, tk, tv, window)


@_jvp_op.register_fake
def _(q, k, v, tq, tk, tv, window):
    return torch.empty_like(q)


class _SwaAttention(torch.autograd.Function):
    """``swa_attention`` on validated inputs (q_offset 0, as many keys as
    queries) with kernel derivatives.  ``core`` forces the CUDA-core
    forward kernel.  It saves q, k and v; the backward and jvp remove
    ``torch.func``'s wrapper (``unwrap_one_level``), launch outside the
    transforms and rewrap.  First order only (``first_order_only``)."""

    @staticmethod
    def forward(q, k, v, window: int, core: bool):
        return _fwd_op(q, k, v, window, core)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, window, _ = inputs
        ctx.window = window
        ctx.save_for_backward(q, k, v)
        ctx.save_for_forward(q, k, v)

    @staticmethod
    def backward(ctx, g):
        (q, k, v, g), level = unwrap_one_level(ctx.saved_tensors + (g,))
        first_order_only((q, k, v, g), 0, "windowed attention")
        with outside_transforms():
            grads = swa_attention_vjp(q, k, v, g.contiguous(), ctx.window)
        return tuple(rewrap(t, level) for t in grads) + (None, None)

    @staticmethod
    def jvp(ctx, tq, tk, tv, *_):
        (q, k, v, tq, tk, tv), level = unwrap_one_level(
            ctx.saved_tensors + (tq, tk, tv))
        first_order_only((q, k, v, tq, tk, tv), 0, "windowed attention")
        with outside_transforms():
            tangents = [torch.zeros_like(x) if t is None else t.contiguous()
                        for x, t in ((q, tq), (k, tk), (v, tv))]
            out = _jvp_op(q, k, v, *tangents, ctx.window)
        return rewrap(out, level)


def _validate(name: str, q, k, v) -> None:
    if q.dtype not in _STORAGE:
        raise TypeError(f"{name}: q is {q.dtype}, the kernel takes float32 "
                        f"or bfloat16")
    if q.shape[3] > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {q.shape[3]} > {MAX_HEAD_DIM}")
    for arg, t in (("q", q), ("k", k), ("v", v)):
        _check_kernel_input(name, arg, t, q.dtype)


def cuda_core_swa_attention(q, k, v, window: int):
    """``swa_attention`` through the CUDA-core forward kernel
    (``csrc/swa_attention.cu``) on CUDA q (B, T, H, hd), k/v (B, T, K,
    hd), f32 or bf16, whatever the dtype; ``swa_attention`` sends it f32
    inputs and bf16 inputs with hd % 8 != 0.  Counts
    ``swa_attention.cuda_core_launches``; differentiable as
    ``swa_attention``."""
    _validate("cuda_core_swa_attention", q, k, v)
    return _SwaAttention.apply(q, k, v, window, True)


def swa_attention(q, k, v, window: int, *, q_chunk: int = 512,
                  q_offset: int = 0):
    """q: (B, T, H, hd); k/v: (B, S, K, hd) -> (B, T, H, hd) in q's dtype.

    ``q_chunk`` is the plain version's query chunk (CPU only)."""
    name = "swa_attention"
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}; expected (B, T, H, hd) and "
                         f"two equal (B, S, K, hd)")
    B, T, H, hd = q.shape
    _, S, K, _ = k.shape
    if k.shape[0] != B or k.shape[3] != hd or K == 0 or H % K:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not pair: same B and hd, "
                         f"H a multiple of K")
    if window < 0:
        raise ValueError(f"{name}: window {window} < 0")
    if not _on_cuda(name, q, k, v):
        if q_offset == 0 and S == T:
            _record_plain(("forward",), window, False, q=q, k=k, v=v)
        return ref.swa_attention_ref(q, k, v, window, q_chunk=q_chunk,
                                     q_offset=q_offset)
    if q_offset != 0 or S != T:
        raise NotImplementedError(
            f"{name}: the kernel takes q_offset 0 and as many keys as "
            f"queries (got q_offset {q_offset}, T {T}, S {S})")
    _validate(name, q, k, v)
    return _SwaAttention.apply(q, k, v, window, False)


swa_attention.launches = 0
swa_attention.cuda_core_launches = 0
swa_attention_vjp.dq_launches = 0
swa_attention_vjp.dkdv_launches = 0
swa_attention_vjp.cuda_core_dq_launches = 0
swa_attention_vjp.cuda_core_dkdv_launches = 0
swa_attention_jvp.launches = 0
swa_attention_jvp.cuda_core_launches = 0

KERNELS = (swa_attention, swa_attention_jvp)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
    swa_attention.cuda_core_launches = 0
    swa_attention_vjp.dq_launches = 0
    swa_attention_vjp.dkdv_launches = 0
    swa_attention_vjp.cuda_core_dq_launches = 0
    swa_attention_vjp.cuda_core_dkdv_launches = 0
    swa_attention_jvp.cuda_core_launches = 0
