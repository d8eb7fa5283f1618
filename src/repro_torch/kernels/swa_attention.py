"""Wrapper of the hand-written Hopper sliding-window attention kernel
(``csrc/swa_attention.cu``).

Port of ``repro.kernels.swa_attention.swa_attention``: the forward of
sliding-window causal attention, query t over the keys t - window ... t
(window + 1 keys, clipped at 0), scores scaled by 1/sqrt(hd), softmax
and P.V in f32, output in q's dtype.  q is (B, T, H, hd) and k/v are
(B, T, K, hd) with H a multiple of K: the kernel reads kv head
h // (H // K), so MQA/GQA K/V are never repeated (the Pallas kernel
takes them repeated).  Any T, any window >= 0 and hd <= 256 are taken;
the kernel masks the ragged edge itself.

For tensors on the CPU the wrapper returns the plain version
``kernels.ref.swa_attention_ref``; for CUDA tensors it checks dtype,
shape and contiguity, allocates the output and launches the kernel on
the current stream, or raises.  ``q_offset != 0`` (queries past the
keys' start; no caller in the repo) is taken by the plain version only.

``swa_attention.launches`` counts kernel launches (one per call on the
card) and nothing else.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.lattice_fb import _check_kernel_input, _on_cuda

MAX_HEAD_DIM = 256
_STORAGE = {torch.float32: 0, torch.bfloat16: 1}

_PTR, _INT, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# q k v o | batch seq heads kv_heads hd window | scale | storage | stream
_SIGNATURES = {"swa_attention_launch": [_PTR] * 4 + [_INT] * 6
               + [_F32, _INT, _PTR]}


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
    out = torch.empty_like(q)
    build.launch("swa_attention", _SIGNATURES, "swa_attention_launch",
                 q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), B, T, H, K, hd, min(window, T),
                 1.0 / math.sqrt(hd), _STORAGE[q.dtype])
    swa_attention.launches += 1
    return out


swa_attention.launches = 0

KERNELS = (swa_attention,)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
