"""The collectives of the port's explicit SPMD, over one process group.

The reference's jitted update gets its cross-device sums from GSPMD.
Here each rank runs its own share of the batch, and the few sums an
update needs are written out: the gradient stage's (gradient, loss,
metrics), each curvature product's θ-sized result, each candidate's
loss, and each batch's normalisers.  Each of these is ONE
``all_reduce(SUM)``: the tensors are packed into one flat buffer per
dtype (one buffer for the f32 acoustic models), reduced, and unpacked.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _pack(tree: dict):
    """{dtype: (keys, flat buffer)} of a dict of tensors."""
    by_dtype: dict = {}
    for k, t in tree.items():
        by_dtype.setdefault(t.dtype, []).append(k)
    return {dt: (keys, torch.cat([tree[k].reshape(-1) for k in keys]))
            for dt, keys in by_dtype.items()}


def _unpack(tree: dict, packed: dict) -> dict:
    out = {}
    for keys, flat in packed.values():
        sizes = [tree[k].numel() for k in keys]
        for k, part in zip(keys, torch.split(flat, sizes)):
            out[k] = part.view(tree[k].shape)
    return {k: out[k] for k in tree}


def all_reduce_sum(tree: dict, group) -> dict:
    """The sum over ``group``'s ranks of a dict of tensors (0-d ones
    included), as a new dict; one ``all_reduce`` per dtype present."""
    packed = _pack(tree)
    for _, flat in packed.values():
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    return _unpack(tree, packed)


def broadcast_tree(tree: dict, src: int = 0) -> dict:
    """Rank ``src``'s values of a dict of tensors on every rank of the
    run (one ``broadcast`` per dtype): replicated state starts equal."""
    packed = _pack(tree)
    for _, flat in packed.values():
        dist.broadcast(flat, src=src)
    return _unpack(tree, packed)
