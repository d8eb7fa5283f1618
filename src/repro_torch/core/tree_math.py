"""Vector-space helpers over theta-sized values, used by the CG/NGHF
machinery.

Port of ``repro.core.tree_math``.  A theta-sized value is either a flat
``dict[str, Tensor]`` mirroring the parameter dict (``"rec0.w"`` ...) or
a single tensor (the flat buffer of the fused CG path); every helper
takes either.  Reductions are f32: ``vdot`` takes one f32 sum per leaf,
then sums the leaves in key order.  ``Layout`` is the layout of
theta-sized dicts under a mesh (``core.cg.cg_solve``'s ``constrain``).

Under a mesh a leaf may be split across ranks, each holding its share.
Inside ``reducing(layout)`` (an optimiser's update) ``vdot`` and ``norm``
of theta-sized dicts are then the whole vectors': each split leaf's
partial sum is divided by the number of ranks that hold the same piece,
the split leaves' partials are summed over the world by one
``all_reduce``, and the replicated leaves' sums are added on each rank
(they are the same everywhere), so every rank reads the same bits.  A
leaf split over "model" and one split over data axes each count once:
the pieces are summed over the world and divided by the ranks holding
each piece.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.distributed as dist

_REDUCING: contextvars.ContextVar = contextvars.ContextVar(
    "tree_math_reducing", default=None)


def tmap(f, *trees):
    """Apply ``f`` leafwise; a tensor is a one-leaf tree."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: f(*(t[k] for t in trees)) for k in first}
    return f(*trees)


def leaves(tree) -> list:
    return list(tree.values()) if isinstance(tree, dict) else [tree]


def scalar_like(s, x: torch.Tensor):
    """``s`` (Python number or 0-d tensor) in ``x``'s dtype, as
    ``jnp.asarray(s, x.dtype)``: a tensor stays on its device (no host
    sync), a number is rounded to ``x``'s dtype on the host."""
    if isinstance(s, torch.Tensor):
        return s.to(dtype=x.dtype)
    return torch.tensor(s, dtype=x.dtype).item()  # reprolint: disable=RL002 (a CPU tensor)


def add(a, b):
    return tmap(lambda x, y: x + y, a, b)


def sub(a, b):
    return tmap(lambda x, y: x - y, a, b)


def scale(a, s):
    """s * a, preserving each leaf's dtype."""
    return tmap(lambda x: scalar_like(s, x) * x, a)


def axpy(alpha, x, y):
    """alpha * x + y, result in y's dtype."""
    return tmap(lambda xi, yi: (scalar_like(alpha, xi) * xi
                                + yi.to(xi.dtype)).to(yi.dtype), x, y)


def _dot(x, y) -> torch.Tensor:
    return (x.to(torch.float32) * y.to(torch.float32)).sum()


def vdot(a, b) -> torch.Tensor:
    layout = _REDUCING.get()
    if layout is None or not layout.replicas or not isinstance(a, dict):
        out = None
        for x, y in zip(leaves(a), leaves(b)):
            s = _dot(x, y)
            out = s if out is None else out + s
        return out
    whole, split = None, None
    for k in a:
        s = _dot(a[k], b[k])
        if k in layout.replicas:
            s = s / layout.replicas[k]
            split = s if split is None else split + s
        else:
            whole = s if whole is None else whole + s
    if split is None:
        return whole
    dist.all_reduce(split)
    return split if whole is None else whole + split


def norm(a) -> torch.Tensor:
    return torch.sqrt(vdot(a, a))


def zeros_like(a):
    return tmap(torch.zeros_like, a)


def div(a, b):
    return tmap(lambda x, y: x / scalar_like(y, x), a, b)


def where(pred, a, b):
    return tmap(lambda x, y: torch.where(pred, x, y), a, b)


def cast_like(a, ref):
    return tmap(lambda x, r: x.to(r.dtype), a, ref)


def astype(a, dtype):
    return tmap(lambda x: x.to(dtype), a)


def flat_keys(tree: dict) -> list:
    """``tree``'s keys in JAX's ``ravel_pytree`` leaf order: sorted by
    the dotted path (``"out.b"`` before ``"out.w"``, ``"rec1.*"`` before
    ``"rec10.*"``)."""
    return sorted(tree, key=lambda k: tuple(k.split(".")))


def ravel(tree: dict):
    """(flat (N,) tensor, unravel) in ``ravel_pytree``'s leaf order, so
    fixed-size blocks of the flat buffer cover the same elements as in
    the reference.  ``unravel(flat)`` returns a dict of views, keyed in
    ``tree``'s own order (``torch.func`` matches dicts by key order)."""
    keys = flat_keys(tree)
    shapes = [tree[k].shape for k in keys]
    sizes = [tree[k].numel() for k in keys]
    flat = torch.cat([tree[k].reshape(-1) for k in keys])
    order = list(tree)

    def unravel(f):
        parts = dict(zip(keys, torch.split(f, sizes)))
        return {k: parts[k].view(shapes[keys.index(k)]) for k in order}

    return flat, unravel


class Layout:
    """The layout of theta-sized dicts under a mesh: ``shapes`` holds each
    leaf's local shape (this rank's share), ``groups`` the process group
    of each leaf split across ranks (absent for a replicated leaf), and
    ``replicas`` how many ranks hold each piece of such a leaf (the
    world divided by its pieces).

    Calling it checks a theta-sized dict against the layout and returns
    it.  Under explicit SPMD each rank already holds its share, so there
    is nothing to move where the reference's ``with_sharding_constraint``
    pins GSPMD's placement; a leaf of another shape is a fault and
    raises."""

    def __init__(self, shapes: dict, groups: dict, replicas=None):
        self.shapes = shapes
        self.groups = groups
        self.replicas = replicas or {}

    def __call__(self, tree: dict) -> dict:
        for k, t in tree.items():
            if tuple(t.shape) != self.shapes[k]:
                raise ValueError(f"{k}: shape {tuple(t.shape)}, its layout "
                                 f"holds {self.shapes[k]} on this rank")
        return tree


@contextlib.contextmanager
def reducing(layout):
    """Within the block ``vdot`` and ``norm`` of theta-sized dicts
    reduce over ``layout``'s split leaves (a ``Layout``; None: none)."""
    token = _REDUCING.set(layout)
    try:
        yield
    finally:
        _REDUCING.reset(token)
