"""Wrapper of the hand-written Hopper fused CG update (``csrc/cg_fused.cu``).

Port of ``repro.kernels.cg_fused.cg_fused_update`` and
``repro.kernels.ops.cg_fused_update``: one CG iteration's vector work,

    x <- x + alpha v,   r <- r - alpha Bv,   rr = <r, r>,

in one pass over flat (N,) buffers (f32 arithmetic, x and r stored in
the buffers' dtype, float32 or bfloat16; rr in f32 from the unrounded
residual).  For tensors on the CPU the wrapper returns the plain version
``kernels.ref.cg_fused_update_ref``; for CUDA tensors it checks dtype
and contiguity, allocates the outputs and the per-tile partials, and
launches the kernel (a tile pass and a fixed-order fold of the tile
partials in double) on the current stream, or raises.  ``alpha`` may be a Python
float or a 0-d f32 tensor on the buffers' device; the kernel reads it
from device memory, so the host never waits for it.

``cg_fused_update.launches`` counts kernel launches (one per call on the
card) and nothing else.
"""
from __future__ import annotations

import ctypes

import torch
import torch.distributed

from repro_torch.kernels import build, instrument, ref
from repro_torch.kernels.lattice_fb import (_check_kernel_input,
                                            _check_shape, _on_cuda)

TILE = 65536                         # elements per thread block
_STORAGE = {torch.float32: 0, torch.bfloat16: 1}

_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# alpha x v r bv x_out r_out partial rr | n storage
_SIGNATURES = {"cg_fused_update_launch": [_PTR] * 9 + [_LL, _INT, _PTR]}
# launcher -> the library (``csrc/<stem>.cu``) that holds it
LAUNCHERS = {"cg_fused_update_launch": "cg_fused"}
(_LAUNCHER, _STEM), = LAUNCHERS.items()


def cg_fused_update(alpha, x, v, r, bv):
    """Flat (N,) buffers -> (x_new, r_new, rr 0-d f32).  x, v, r, bv share
    one dtype (float32 or bfloat16) and one device."""
    name = "cg_fused_update"
    (N,) = x.shape
    for arg, t in (("v", v), ("r", r), ("bv", bv)):
        _check_shape(name, arg, t, (N,))
    config = {"grid": (-(-N // TILE),)}
    if not _on_cuda(name, x, v, r, bv):
        instrument.record(_STEM, _LAUNCHER, "plain", config, x=x, v=v,
                          r=r, bv=bv)
        return ref.cg_fused_update_ref(alpha, x, v, r, bv)
    if x.dtype not in _STORAGE:
        raise TypeError(f"{name}: x is {x.dtype}, the kernel stores "
                        f"float32 or bfloat16")
    for arg, t in (("x", x), ("v", v), ("r", r), ("bv", bv)):
        _check_kernel_input(name, arg, t, x.dtype)
    dev = x.device
    if isinstance(alpha, torch.Tensor):
        if alpha.numel() != 1 or alpha.device != dev:
            raise ValueError(f"{name}: alpha must be one value on {dev}")
        alpha_t = alpha.reshape(1).to(torch.float32).contiguous()
    else:
        alpha_t = torch.full((1,), float(alpha), dtype=torch.float32,
                             device=dev)
    x_out = torch.empty_like(x)
    r_out = torch.empty_like(r)
    partial = torch.empty((max(1, -(-N // TILE)),), dtype=torch.float32,
                          device=dev)
    rr = torch.empty((), dtype=torch.float32, device=dev)
    instrument.record(_STEM, _LAUNCHER, "cuda", config, x=x, v=v, r=r,
                      bv=bv)
    build.launch(_STEM, _SIGNATURES, _LAUNCHER, dev,
                 alpha_t.data_ptr(), x.data_ptr(), v.data_ptr(),
                 r.data_ptr(), bv.data_ptr(), x_out.data_ptr(),
                 r_out.data_ptr(), partial.data_ptr(), rr.data_ptr(), N,
                 _STORAGE[x.dtype])
    cg_fused_update.launches += 1
    return x_out, r_out, rr


cg_fused_update.launches = 0


def cg_fused_update_tree(alpha, x, v, r, bv, groups=None):
    """The fused CG update over theta-sized dicts, one leaf at a time:
    ``cg_fused_update`` on each leaf's flat view (one kernel launch a leaf
    on the card), then rr = the per-leaf partials summed in double in
    ``ref.tree_order`` and rounded to f32.

    Port of ``repro.kernels.ops.cg_fused_update_tree``, the fused path of
    a sharded state: each leaf stays in its own layout, which under a
    mesh is this rank's share of it.  ``groups``: {key: process group}
    for the leaves split across ranks; each such leaf's partial is summed
    over its group by one ``all_reduce`` before the fold, so rr is the
    whole vector's.  Replicated leaves (every leaf of the acoustic
    models) need no collective.  Returns (x_new, r_new, rr 0-d f32)."""
    groups = groups or {}
    x_new, r_new, rr = {}, {}, None
    for k in ref.tree_order(x):
        xk, rk, part = cg_fused_update(alpha, x[k].reshape(-1),
                                       v[k].reshape(-1), r[k].reshape(-1),
                                       bv[k].reshape(-1))
        x_new[k], r_new[k] = xk.view(x[k].shape), rk.view(r[k].shape)
        # one scalar a leaf, folded in double as the kernel folds its tiles
        part = part.to(torch.float64)  # reprolint: disable=RL007
        if groups.get(k) is not None:
            torch.distributed.all_reduce(part, group=groups[k])
        rr = part if rr is None else rr + part
    return ({k: x_new[k] for k in x}, {k: r_new[k] for k in x},
            rr.to(torch.float32))

KERNELS = (cg_fused_update,)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
