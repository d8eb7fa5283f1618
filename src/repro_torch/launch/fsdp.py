"""FSDP gathers at the point of use, under explicit SPMD.

Port of ``repro.launch.fsdp``.  Under a mesh each rank stores its share
of every parameter (and θ-sized state) leaf, cut by ``launch.sharding.
param_shardings``: a 2d arch's ``wq`` is ``P(None, "data", "model")``
when stacked, the vocab table ``P("model", None)``, MoE experts split
over "model" when E divides.  The reference lets GSPMD all-gather a
2d-stored leaf to its 1d compute spec where the model uses it; here the
model calls ``gather_for_compute`` on each layer's leaves just before
the layer runs, and every split dim is all-gathered whole over its
axis's group (tensor-parallel compute over "model" is ROADMAP 1.4 part
2, step 3: until then "model" is a storage axis only).  A float matrix
(ndim >= 2) is cast to the compute dtype before the gather under 2d
storage, as the reference does, so the gather moves bf16; vectors stay
f32.  A stacked leaf is gathered one period at a time (``leaf[i]``).

The gather is an ``autograd.Function`` (``_Gather``) with a jvp, so
``torch.autograd``, ``torch.func.vjp``, ``jvp`` and ``linearize`` (the
curvature products) all run through it:

  * forward and jvp: ``all_gather_into_tensor`` along the dim, over the
    axis's group; the launch is a ``torch.library`` custom op, so
    ``linearize``'s trace records it;
  * backward over the data axes, when the running forward's batch rows
    are split over the data group (``batch_rows``): ``reduce_scatter``
    (sum) along the dim, the FSDP gradient sum.  Such a leaf is then
    left out of the gradient's data-group ``all_reduce``
    (``core.curvature``);
  * backward over the data axes of a batch kept whole on every rank (it
    does not divide the data extent), and over "model": this rank's
    slice.  Every rank computed the same whole cotangent from the same
    rows, so a sum would count it once per rank.

``step_context(cfg, mesh, shardings)`` registers the stored shardings
for one step (``launch.steps.build_step``); with no mesh, and outside
it, every call here is the identity, so one-device numbers do not move.

The reference's ``constrain_activations``, ``unshard_seq`` and
``constrain_vocab_matrix`` are GSPMD placement hints for a sequence- and
vocab-split layout; with each rank holding whole activations they have
nothing to do, and are not ported (ROADMAP 1.4, "Not to port").
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.core.functorch_levels import (first_order_only,
                                               outside_transforms, rewrap,
                                               unwrap_one_level)
from repro_torch.launch.mesh import DATA_AXES

# the names of newer PyTorch releases, where the old ones are deprecated
_all_gather = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
_reduce_scatter = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)


class _Registry(NamedTuple):
    mesh: object
    specs: dict          # {parameter path: stored spec}
    cast: bool           # cast matrices to the compute dtype first (2d)


_REGISTRY: contextvars.ContextVar[Optional[_Registry]] = \
    contextvars.ContextVar("fsdp_registry", default=None)
# the data group over which the running forward's batch rows are split,
# or None (one device, or a batch kept whole on every rank)
_BATCH: contextvars.ContextVar = contextvars.ContextVar("fsdp_batch_rows",
                                                        default=None)

# process groups by small integer id: a custom op takes no group object
_GROUPS: list = []


def _group_id(group) -> int:
    for i, g in enumerate(_GROUPS):
        if g is group:
            return i
    _GROUPS.append(group)
    return len(_GROUPS) - 1


@contextlib.contextmanager
def compute_specs(mesh, specs: dict, cast: bool):
    """Register ``specs`` ({path: stored spec}) on ``mesh``; ``cast``:
    cast float matrices to the compute dtype before gathering."""
    token = _REGISTRY.set(_Registry(mesh, specs, cast))
    try:
        yield
    finally:
        _REGISTRY.reset(token)


def step_context(cfg, mesh, shardings: Optional[dict]):
    """The gather context of one step: ``shardings`` ({path:
    ``NamedSharding``}, the stored layout) registered, with the cast
    before the gather under ``cfg.param_sharding == "2d"`` (the
    reference's 1d archs run without it).  With ``mesh=None`` it is an
    empty stack (identity)."""
    stack = contextlib.ExitStack()
    if mesh is not None:
        stack.enter_context(compute_specs(
            mesh, {k: s.spec for k, s in shardings.items()},
            cast=cfg.param_sharding == "2d"))
    return stack


@contextlib.contextmanager
def batch_rows(group):
    """Within the block, the forward runs this rank's share of a batch
    split over ``group`` (the data group), or the whole batch (None)."""
    token = _BATCH.set(group)
    try:
        yield
    finally:
        _BATCH.reset(token)


def batch_group():
    """The data group the running forward's batch rows are split over,
    or None."""
    return _BATCH.get()


# ---------------------------------------------------------------------------
# the collectives, as custom ops (``linearize``'s trace records them)
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::fsdp_all_gather", mutates_args=())
def _gather_op(x: torch.Tensor, dim: int, gid: int) -> torch.Tensor:
    group = _GROUPS[gid]
    n = dist.get_world_size(group)
    xm = x.movedim(dim, 0).contiguous()
    out = xm.new_empty((n * xm.shape[0], *xm.shape[1:]))
    _all_gather(out, xm, group=group)
    return out.movedim(0, dim).contiguous()


@_gather_op.register_fake
def _(x, dim, gid):
    shape = list(x.shape)
    shape[dim] *= dist.get_world_size(_GROUPS[gid])
    return x.new_empty(shape)


@torch.library.custom_op("repro_torch::fsdp_all_reduce", mutates_args=())
def _all_reduce_op(x: torch.Tensor, gid: int) -> torch.Tensor:
    out = x.clone()
    dist.all_reduce(out, group=_GROUPS[gid])
    return out


@_all_reduce_op.register_fake
def _(x, gid):
    return torch.empty_like(x)


def _slice(g, dim: int, group):
    """This rank's piece of the whole ``g`` along ``dim``."""
    n = g.shape[dim] // dist.get_world_size(group)
    return g.narrow(dim, dist.get_rank(group) * n, n).contiguous()


def _scatter_sum(g, dim: int, group):
    """This rank's piece of the sum over ``group`` of the whole ``g``."""
    gm = g.movedim(dim, 0).contiguous()
    out = gm.new_empty((gm.shape[0] // dist.get_world_size(group),
                        *gm.shape[1:]))
    _reduce_scatter(out, gm, group=group)
    return out.movedim(0, dim).contiguous()


class _Gather(torch.autograd.Function):
    """One split dim of a leaf gathered whole over ``_GROUPS[gid]``;
    ``data``: the dim is split over data axes.  Saves no tensor."""

    @staticmethod
    def forward(x, dim: int, gid: int, data: bool):
        return _gather_op(x, dim, gid)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, dim, gid, data = inputs
        ctx.dim, ctx.gid = dim, gid
        # the FSDP sum only where this forward's rows are split
        ctx.sum = data and _BATCH.get() is not None

    @staticmethod
    def backward(ctx, g):
        (g,), level = unwrap_one_level((g,))
        first_order_only((g,), 0, "FSDP gather")
        with outside_transforms():
            group = _GROUPS[ctx.gid]
            out = (_scatter_sum if ctx.sum else _slice)(g, ctx.dim, group)
        return rewrap(out, level), None, None, None

    @staticmethod
    def jvp(ctx, t, *_):
        (t,), level = unwrap_one_level((t,))
        first_order_only((t,), 0, "FSDP gather")
        with outside_transforms():
            out = _gather_op(t, ctx.dim, ctx.gid)
        return rewrap(out, level)


def _entries(spec, ndim: int) -> list:
    """The spec's entries for a leaf of ``ndim`` dims: a period slice of
    a stacked leaf drops the leading (None) entry; a short spec is
    padded with None."""
    entries = list(spec)
    lead = len(entries) - ndim
    if lead > 0:
        if any(e is not None for e in entries[:lead]):
            raise ValueError(f"spec {spec}: a slice of {ndim} dims drops a "
                             f"split entry")
        entries = entries[lead:]
    return entries + [None] * (ndim - len(entries))


def _split_dims(mesh, spec, ndim: int):
    """(dim, group, over data axes) of each entry that cuts the leaf."""
    for d, e in enumerate(_entries(spec, ndim)):
        if e is None or mesh.extent(e) == 1:
            continue
        axes = (e,) if isinstance(e, str) else tuple(e)
        data = all(a in DATA_AXES for a in axes)
        if not data and any(a in DATA_AXES for a in axes):
            raise NotImplementedError(
                f"a dim split over data and model axes together ({e}): "
                f"no sharding rule gives one")
        yield d, mesh.group(e), data


def gather_for_compute(tree, compute_dtype=None, prefix: str = ""):
    """Every registered split leaf of ``tree`` (a layer's nested dict;
    ``prefix`` + its dotted path is the leaf's parameter path) gathered
    to its whole shape; a float matrix is cast to ``compute_dtype``
    first under 2d storage.  The identity with nothing registered."""
    reg = _REGISTRY.get()
    if reg is None:
        return tree

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}{k}.") for k, v in node.items()}
        x = node
        if (reg.cast and compute_dtype is not None and x.dim() >= 2
                and x.is_floating_point()):
            x = x.to(compute_dtype)
        spec = reg.specs.get(path[:-1])
        if spec is None:
            return x
        for d, group, data in _split_dims(reg.mesh, spec, x.dim()):
            x = _Gather.apply(x, d, _group_id(group), data)
        return x

    return walk(tree, prefix)


def gather_whole(t: torch.Tensor, sharding) -> torch.Tensor:
    """The whole leaf of which ``t`` is this rank's share by
    ``sharding`` (a ``NamedSharding``), without autograd; every rank of
    the mesh must call it (a checkpoint save)."""
    with torch.no_grad():
        for d, group, _ in _split_dims(sharding.mesh, sharding.spec,
                                       t.dim()):
            t = _gather_op(t, d, _group_id(group))
    return t


def all_reduce_counts(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of ``x``, a tensor no derivative flows
    through (counts, normalisers): it leaves every ``torch.func`` level
    it is wrapped at, and its result is a constant to them."""
    while x is not None and torch._C._functorch.is_functorch_wrapped_tensor(x):
        x = torch._C._functorch.get_unwrapped(x)
    with outside_transforms():
        return _all_reduce_op(x.detach(), _group_id(group))
