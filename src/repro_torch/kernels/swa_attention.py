"""Wrappers of the hand-written Hopper sliding-window attention kernels.

Port of ``repro.kernels.swa_attention.swa_attention``: the forward of
sliding-window causal attention, query t over the keys t - window ... t
(window + 1 keys, clipped at 0), scores scaled by 1/sqrt(hd), softmax
and P.V in f32, output in q's dtype.  q is (B, T, H, hd) and k/v are
(B, T, K, hd) with H a multiple of K: the kernels read kv head
h // (H // K), so MQA/GQA K/V are never repeated (the Pallas kernel
takes them repeated).  Any T, any window >= 0 and hd <= 256 are taken;
the kernels mask the ragged edge themselves.

Routing, by device and dtype only (never by failure):

* CPU tensors: the plain version ``kernels.ref.swa_attention_ref``;
* CUDA bf16 tensors with hd % 8 == 0: the tensor-core kernel
  ``csrc/swa_attention_sm90.cu`` (wgmma + TMA, P.V at f32 accuracy by a
  split P), launched with the geometry of ``swa_geometry``;
* CUDA f32 tensors: the CUDA-core kernel ``csrc/swa_attention.cu``, the
  exact f32 path (the tensor cores would round f32 inputs); and CUDA bf16
  tensors whose hd is not a multiple of 8, which TMA's 16-byte strides
  cannot describe (no arch in the repo has such an hd).

A CUDA launch that fails to build or launch raises.  The kernels have no
backward: on CUDA tensors both raise when autograd would record the call
(``needs_backward``) instead of returning a result with no gradient; the
plain version on the CPU stays differentiable.  ``q_offset != 0``
(queries past the keys' start; no caller in the repo) is taken by the
plain version only.

``swa_attention.launches`` counts launches of the tensor-core kernel (the
bf16 main path) and ``swa_attention.cuda_core_launches`` those of the
CUDA-core kernel; the plain version counts nothing.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.lattice_fb import _check_kernel_input, _on_cuda

MAX_HEAD_DIM = 256
ROWS = 128          # (query, head) rows of a tensor-core tile
KEY_TILE = 64       # keys per K/V tile of the tensor-core kernel
_STORAGE = {torch.float32: 0, torch.bfloat16: 1}

_PTR, _INT, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# q k v o | batch seq heads kv_heads hd window | scale | storage | stream
_CORE_SIGNATURES = {"swa_attention_launch": [_PTR] * 4 + [_INT] * 6
                    + [_F32, _INT, _PTR]}
# q k v o | batch seq heads kv_heads hd window | queries heads head_tiles
# hd_pad grid_x grid_y | scale | stream
_SM90_SIGNATURES = {"swa_attention_sm90_launch": [_PTR] * 4 + [_INT] * 12
                    + [_F32, _PTR],
                    "swa_attention_sm90_smem_bytes": [_INT]}


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


def _launch_sm90(q, k, v, out, window: int) -> None:
    B, T, H, hd = q.shape
    K = k.shape[2]
    geo = swa_geometry(B, T, H, K, hd, window)
    build.launch("swa_attention_sm90", _SM90_SIGNATURES,
                 "swa_attention_sm90_launch", q.device, q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), out.data_ptr(), B, T, H, K, hd,
                 geo.window, geo.queries, geo.heads, geo.head_tiles,
                 geo.hd_pad, geo.grid[0], geo.grid[1], 1.0 / math.sqrt(hd))
    swa_attention.launches += 1


def sm90_smem_bytes(hd_pad: int) -> int:
    """Dynamic shared memory (bytes) of a tensor-core launch at padded head
    dim ``hd_pad``; builds the library if it is missing."""
    lib = build.library("swa_attention_sm90", _SM90_SIGNATURES)
    return lib.swa_attention_sm90_smem_bytes(hd_pad)


def needs_backward(*tensors) -> bool:
    """True when autograd is on and an input requires grad: the kernels'
    result would carry no gradient to it, so their wrappers refuse."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _refuse_autograd(name: str, q, k, v) -> None:
    if needs_backward(q, k, v):
        raise NotImplementedError(
            f"{name}: the CUDA kernels have no backward, and q/k/v require "
            f"grad with autograd on; run under torch.no_grad() (the "
            f"attention backward is ROADMAP item 1.3)")


def cuda_core_swa_attention(q, k, v, window: int):
    """The CUDA-core kernel (``csrc/swa_attention.cu``) on CUDA q (B, T,
    H, hd), k/v (B, T, K, hd), f32 or bf16; the wrapper sends it f32
    inputs and bf16 inputs with hd % 8 != 0.  Counts
    ``swa_attention.cuda_core_launches``; raises where ``needs_backward``."""
    _refuse_autograd("cuda_core_swa_attention", q, k, v)
    B, T, H, hd = q.shape
    out = torch.empty_like(q)
    build.launch("swa_attention", _CORE_SIGNATURES, "swa_attention_launch",
                 q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), B, T, H, k.shape[2], hd, min(window, T),
                 1.0 / math.sqrt(hd), _STORAGE[q.dtype])
    swa_attention.cuda_core_launches += 1
    return out


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
        return ref.swa_attention_ref(q, k, v, window, q_chunk=q_chunk,
                                     q_offset=q_offset)
    _refuse_autograd(name, q, k, v)
    if q_offset != 0 or S != T:
        raise NotImplementedError(
            f"{name}: the kernel takes q_offset 0 and as many keys as "
            f"queries (got q_offset {q_offset}, T {T}, S {S})")
    if q.dtype not in _STORAGE:
        raise TypeError(f"{name}: q is {q.dtype}, the kernel takes float32 "
                        f"or bfloat16")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {hd} > {MAX_HEAD_DIM}")
    for arg, t in (("q", q), ("k", k), ("v", v)):
        _check_kernel_input(name, arg, t, q.dtype)
    if q.dtype != torch.bfloat16 or hd % 8:
        return cuda_core_swa_attention(q, k, v, window)
    for arg, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} is not 16-byte aligned, as "
                             f"the tensor-core kernel's TMA loads need")
    out = torch.empty_like(q)
    _launch_sm90(q, k, v, out, window)
    return out


swa_attention.launches = 0
swa_attention.cuda_core_launches = 0

KERNELS = (swa_attention,)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
    swa_attention.cuda_core_launches = 0
