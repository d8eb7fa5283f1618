"""FSDP gathers at the point of use, under explicit SPMD.

Port of ``repro.launch.fsdp``.  Under a mesh each rank stores its share
of every parameter (and θ-sized state) leaf, cut by ``launch.sharding.
param_shardings``: a 2d arch's ``wq`` is ``P(None, "data", "model")``
when stacked, the vocab table ``P("model", None)``, MoE experts split
over "model" when E divides.  The reference lets GSPMD all-gather a
2d-stored leaf to its 1d compute spec where the model uses it; here the
model calls ``gather_for_compute`` on each layer's leaves just before
the layer runs, and each leaf is gathered to its compute spec
(``launch.sharding.compute_pspec``):

  * a leaf of a unit that tensor-parallel compute splits
    (``launch.sharding.tp_unit``: an attention-family block's ``attn``,
    ``mlp`` and ``moe`` leaves, an RG-LRU, mLSTM or sLSTM block's
    temporal leaves and an RG-LRU block's ``mlp``, every attention and
    MLP of an encoder-decoder arch and its ``dec_pos``, the embedding's
    ``table`` and ``lm_head``) is gathered over its data axes only and
    keeps its "model" split: each rank computes its share of the heads,
    channels, FFN columns, experts, positions or vocabulary
    (``launch.tensor_parallel``).  Such a leaf the unit uses whole on
    every rank (kv projections whose heads "model" does not divide, the
    q/k norms, a vector the unit reads in part: ``conv_b``,
    ``log_lambda``, ``b_if``, ``b_zifo``) then passes through Megatron's
    f (``_CopyToModel``), so its gradient sums the ranks' partial ones;
    the MoE router does not (its combine weights do).  A recurrent
    block's unit is the block's own dict, with an explicit leaf set
    (``sharding.TP_UNIT_LEAVES``): its norms and its MLP sit beside
    those leaves, and are gathered as any other leaf and as a unit of
    their own.  Which units are split is decided once a step, from the
    stored layout and whether the unit's heads divide
    (``compute_specs``), and the unit's leaves reach the model as a
    ``SplitUnit``, which carries the decision (``Split``): the model
    reads it there;
  * every other leaf (the norms, a unit "model" does not divide: an
    xLSTM block whose heads it does not divide, a vocabulary such as
    whisper-base's 51865) is gathered whole, every split dim over its
    axis's group, and the ranks along "model" compute the same thing
    with it.

A float matrix (ndim >= 2) is cast to the compute dtype before the
gather under 2d storage, as the reference does, so the gather moves
bf16; vectors stay f32.  A stacked leaf is gathered one period at a
time (``leaf[i]``).

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
    does not divide the data extent), and over "model" (a leaf gathered
    whole): this rank's slice.  Every rank computed the same whole
    cotangent from the same rows, so a sum would count it once per rank.

f and g (``_CopyToModel``, ``_ReduceFromModel``) are autograd
Functions with jvps over the custom-op ``all_reduce`` in the same way;
``launch.tensor_parallel`` puts them at a split unit's edges.  So is
the activation gather inside a split unit (``_GatherFromModel``: the
custom-op all-gather forward and jvp, a reduce-scatter backward, since
each rank reads the gathered tensor with its own columns).

Sequence-parallel activations (the reference's ``constrain_activations``
and ``unshard_seq``, Megatron-SP): where tensor-parallel compute is on,
the arch is decoder-only and not "replicated" (``_Registry.seq``), and
the running forward's T divides over "model" and its batch rows are
split over the data group or the data extent is 1 (``sequence_split``),
each "model" rank holds its contiguous T/m of the (B, T, d) residual
stream between the units, and the norms and residual adds run on that
slice.  A unit's edges are then autograd Functions with jvps over
custom-op collectives along T (``launch.tensor_parallel.enter`` and
``leave``): a split unit's entry is ``_GatherFromModel`` along T
(all-gather forward, reduce-scatter backward) and its exit
``_ScatterFromModel`` (reduce-scatter forward of the f32 partials, then
one rounding; all-gather backward, in the compute dtype); a unit
computed whole on every rank enters through ``_GatherFromModel`` along
T with ``same`` (all-gather forward, this rank's slice backward) and
leaves through ``_SliceOfModel`` (the slice forward, all-gather
backward).  A leaf used on the T slice (a norm's: no unit's) passes
through f, as a unit's whole leaves do, so its gradient sums the ranks'
partial ones.  The reference's ``constrain_vocab_matrix`` pins the
head's vocab split, which the split head here is (ROADMAP 1.4, "Not to
port").

``step_context(cfg, mesh, shardings)`` registers the stored shardings
for one step (``launch.steps.build_step``); with no mesh, and outside
it, every call here is the identity, so one-device numbers do not move.
A serving step also registers its decode cache's layout (``cache``: the
``shardings`` of ``launch.sharding.place_cache``'s shares, cut by the
reference's ``input_shardings``),
and ``cache_for_compute`` hands each layer's cache to the model with the
``Split`` of every leaf whose share is cut over "model" (attention k/v
slots, the recurrent states' channels; ``models.blocks``' decode reads
them).
With a "model" extent of 1 nothing is split over "model", and every
leaf is gathered as before tensor-parallel compute.

``collective_log`` counts the collectives of this module's custom ops
(and ``tensor_parallel.all_reduce``'s) by kind, group and shape.
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
from repro_torch.launch.sharding import (TP_UNITS, compute_pspec,
                                         tp_divides, tp_unit)

# the names of newer PyTorch releases, where the old ones are deprecated
_all_gather = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
_reduce_scatter = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)


class Split(NamedTuple):
    """How tensor-parallel compute splits a unit over the mesh's
    "model" axis: ``by`` "heads", "columns" (of the FFN, or of every
    expert), "experts", "vocab", "channels" (an RG-LRU block's),
    "positions" (``dec_pos``'s rows) or "sequence" (the residual
    stream's T, ``sequence_split``); the model ``group``, this rank's
    coordinate ``index`` on it, and its ``extent``."""
    by: str
    group: object
    index: int
    extent: int


class SplitUnit(dict):
    """A split unit's leaves as ``gather_for_compute`` hands them to
    the model: ``split`` (its ``Split``) and ``whole`` (the names of the
    leaves it uses whole on every rank).  A recurrent block's unit also
    holds the block's entries outside it (its norms, and its MLP, a unit
    of its own), gathered as any other leaf."""

    def __init__(self, leaves: dict, split: Split, whole: frozenset):
        super().__init__(leaves)
        self.split, self.whole = split, whole


class _Registry(NamedTuple):
    mesh: object
    specs: dict          # {parameter path: stored spec}
    cast: bool           # cast matrices to the compute dtype first (2d)
    cfg: object          # the arch config under tensor-parallel compute
                         # over "model", or None (every leaf whole)
    units: dict          # {unit path: Split} of the units split over
                         # "model" (``_split_units``)
    seq: Optional[Split]  # the residual stream's split over "model"
                          # where the arch takes sequence-parallel
                          # activations (``_sequence``), or None
    cache: dict          # {decode cache path: spec} of a serving step


_REGISTRY: contextvars.ContextVar[Optional[_Registry]] = \
    contextvars.ContextVar("fsdp_registry", default=None)
# the data group over which the running forward's batch rows are split,
# or None (one device, or a batch kept whole on every rank)
_BATCH: contextvars.ContextVar = contextvars.ContextVar("fsdp_batch_rows",
                                                        default=None)
# the running forward's split of the residual stream over T, or None
_SEQ: contextvars.ContextVar = contextvars.ContextVar("fsdp_sequence",
                                                      default=None)
# the collectives counted by ``collective_log`` (a plain global: a
# backward may run on the autograd engine's own thread), or None
_LOG: Optional[dict] = None

# process groups by small integer id: a custom op takes no group object
_GROUPS: list = []


def _group_id(group) -> int:
    for i, g in enumerate(_GROUPS):
        if g is group:
            return i
    _GROUPS.append(group)
    return len(_GROUPS) - 1


@contextlib.contextmanager
def compute_specs(mesh, specs: dict, cast: bool, cfg=None, cache=None):
    """Register ``specs`` ({path: stored spec}) on ``mesh``; ``cast``:
    cast float matrices to the compute dtype before gathering; ``cfg``:
    the arch config, which turns on tensor-parallel compute over "model"
    (None: every leaf is gathered whole); ``cache``: {decode cache path:
    spec} of a serving step's cache shares."""
    token = _REGISTRY.set(_Registry(mesh, specs, cast, cfg,
                                    _split_units(cfg, mesh, specs),
                                    _sequence(cfg, mesh), cache or {}))
    try:
        yield
    finally:
        _REGISTRY.reset(token)


def step_context(cfg, mesh, shardings: Optional[dict],
                 cache: Optional[dict] = None):
    """The gather context of one step: ``shardings`` ({path:
    ``NamedSharding``}, the stored layout) registered, with the cast
    before the gather under ``cfg.param_sharding == "2d"`` (the
    reference's 1d archs run without it), and tensor-parallel compute
    over "model" where its extent is above 1; ``cache`` ({path:
    ``NamedSharding``}) the layout of a serving step's decode cache.
    With ``mesh=None`` it is an empty stack (identity)."""
    stack = contextlib.ExitStack()
    if mesh is not None:
        tp = "model" in mesh.axis_names and mesh.extent("model") > 1
        stack.enter_context(compute_specs(
            mesh, {k: s.spec for k, s in shardings.items()},
            cast=cfg.param_sharding == "2d", cfg=cfg if tp else None,
            cache={k: s.spec for k, s in (cache or {}).items()}))
    return stack


def _split_units(cfg, mesh, specs: dict) -> dict:
    """{unit path: ``Split``} of the units tensor-parallel compute
    splits (none without ``cfg``): each unit of ``launch.sharding.
    tp_unit`` whose deciding leaf (``TP_UNITS``) the stored layout splits
    over "model" and whose own computation divides
    (``sharding.tp_divides``).  A unit's path is its deciding leaf's
    parent: the ``attn`` dict's, a recurrent block's own, "" for
    ``dec_pos``.  A MoE unit is split "by" its experts where their dim
    is, else by every expert's columns."""
    if cfg is None:
        return {}
    coord = dict(zip(mesh.axis_names, mesh.device_mesh.get_coordinate()))
    out = {}
    for path, spec in specs.items():
        keys = path.split(".")
        unit = tp_unit(cfg, keys)
        if not unit or keys[-1] != TP_UNITS[unit][0] \
                or not _model_split(mesh, spec) \
                or not tp_divides(cfg, unit, mesh.extent("model")):
            continue
        by = TP_UNITS[unit][1]
        if by == "experts" and not _model_split(mesh, _entries(spec, 3)[:1]):
            by = "columns"
        out[".".join(keys[:-1])] = Split(by, mesh.group("model"),
                                         coord["model"], mesh.extent("model"))
    return out


def _sequence(cfg, mesh) -> Optional[Split]:
    """The residual stream's split over "model" (by "sequence") under
    the reference's conditions for sequence-parallel activations
    (``repro.launch.fsdp.step_context`` and ``constrain_activations``):
    tensor-parallel compute on (``cfg``, a "model" extent above 1), a
    stored layout other than "replicated", a decoder-only arch (the
    reference's encoder-decoder model calls neither function).  Whether
    a forward's shapes allow it is ``sequence_split``'s call."""
    if (cfg is None or cfg.param_sharding == "replicated"
            or cfg.is_encoder_decoder or mesh.extent("model") == 1):
        return None
    coord = dict(zip(mesh.axis_names, mesh.device_mesh.get_coordinate()))
    return Split("sequence", mesh.group("model"), coord["model"],
                 mesh.extent("model"))


def sequence_split(T: int) -> Optional[Split]:
    """The running step's split of a forward's (B, T, d) residual stream
    over "model": the registry's (``_sequence``) where "model" divides T
    and the batch rows are this rank's share of a batch split over the
    data group, or the data extent is 1 (a batch kept whole on every data
    rank keeps T whole too, as the reference's ``constrain_activations``
    does); else None."""
    reg = _REGISTRY.get()
    if reg is None or reg.seq is None or T % reg.seq.extent:
        return None
    if reg.mesh.data_extent > 1 and _BATCH.get() is None:
        return None
    return reg.seq


@contextlib.contextmanager
def sequence_rows(split: Optional[Split]):
    """Within the block, the forward holds its residual stream split
    over T by ``split`` (``sequence_split``'s), or whole (None)."""
    token = _SEQ.set(split)
    try:
        yield
    finally:
        _SEQ.reset(token)


def seq_split() -> Optional[Split]:
    """The running forward's split of the residual stream over T, or
    None."""
    return _SEQ.get()


class CacheShare(dict):
    """A layer's decode cache leaves as ``cache_for_compute`` hands them
    to the model: ``splits`` ({leaf name: ``Split``} by "cache") of the
    leaves this rank holds a share of over "model" (the dim
    ``launch.sharding.input_shardings`` cuts: an attention cache's
    slots, a recurrent state's channels); ``rows``, a ``Split`` by
    "rows" over the data group where the mesh has more than one data
    rank: a leaf the layout keeps whole (the xLSTM's m) holds every batch
    row, of which the step's rows are this rank's share."""

    def __init__(self, leaves: dict, splits: dict, rows=None):
        super().__init__(leaves)
        self.splits, self.rows = splits, rows


def cache_for_compute(tree: dict, prefix: str = "") -> dict:
    """A layer's cache leaves (``prefix`` + name is a leaf's cache path)
    as a ``CacheShare`` under a serving step's registered cache layout;
    ``tree`` itself without one."""
    reg = _REGISTRY.get()
    if reg is None or not reg.cache:
        return tree
    mesh = reg.mesh
    splits = {}
    for k in tree:
        if _model_split(mesh, reg.cache.get(prefix + k, ())):
            coord = dict(zip(mesh.axis_names,
                             mesh.device_mesh.get_coordinate()))
            splits[k] = Split("cache", mesh.group("model"), coord["model"],
                              mesh.extent("model"))
    rows = (Split("rows", mesh.data_group, mesh.data_index,
                  mesh.data_extent) if mesh.data_extent > 1 else None)
    return CacheShare(tree, splits, rows)


def unit_split(path: str) -> Optional[Split]:
    """The running step's ``Split`` of the unit at ``path`` (``"embed"``,
    ``"periods.slot0.attn"``), or None where it is whole."""
    reg = _REGISTRY.get()
    return None if reg is None else reg.units.get(path)


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

@contextlib.contextmanager
def collective_log():
    """Within the block, every collective this module launches (and
    ``tensor_parallel.all_reduce``) counted: {(kind, group id, shape of
    the whole tensor, bytes an element): calls}, kind "all_gather",
    "reduce_scatter" or "all_reduce", the whole tensor being the
    gather's output, the reduce-scatter's input, the all-reduce's
    operand (``_group_id`` names the group)."""
    global _LOG
    saved, _LOG = _LOG, {}
    try:
        yield _LOG
    finally:
        _LOG = saved


def log_collective(kind: str, gid: int, whole: torch.Tensor) -> None:
    """Count one collective in the running ``collective_log``, if any."""
    if _LOG is not None:
        key = (kind, gid, tuple(whole.shape), whole.element_size())
        _LOG[key] = _LOG.get(key, 0) + 1


@torch.library.custom_op("repro_torch::fsdp_all_gather", mutates_args=())
def _gather_op(x: torch.Tensor, dim: int, gid: int) -> torch.Tensor:
    group = _GROUPS[gid]
    n = dist.get_world_size(group)
    xm = x.movedim(dim, 0).contiguous()
    out = xm.new_empty((n * xm.shape[0], *xm.shape[1:]))
    _all_gather(out, xm, group=group)
    out = out.movedim(0, dim)
    log_collective("all_gather", gid, out)
    return out.contiguous()


@_gather_op.register_fake
def _(x, dim, gid):
    shape = list(x.shape)
    shape[dim] *= dist.get_world_size(_GROUPS[gid])
    return x.new_empty(shape)


@torch.library.custom_op("repro_torch::fsdp_all_reduce", mutates_args=())
def _all_reduce_op(x: torch.Tensor, gid: int) -> torch.Tensor:
    out = x.clone()
    dist.all_reduce(out, group=_GROUPS[gid])
    log_collective("all_reduce", gid, out)
    return out


@_all_reduce_op.register_fake
def _(x, gid):
    return torch.empty_like(x)


@torch.library.custom_op("repro_torch::fsdp_reduce_scatter", mutates_args=())
def _reduce_scatter_op(x: torch.Tensor, dim: int, gid: int) -> torch.Tensor:
    """This rank's piece along ``dim`` of the sum over ``_GROUPS[gid]``
    of the whole ``x``."""
    group = _GROUPS[gid]
    xm = x.movedim(dim, 0).contiguous()
    out = xm.new_empty((xm.shape[0] // dist.get_world_size(group),
                        *xm.shape[1:]))
    _reduce_scatter(out, xm, group=group)
    log_collective("reduce_scatter", gid, x)
    return out.movedim(0, dim).contiguous()


@_reduce_scatter_op.register_fake
def _(x, dim, gid):
    shape = list(x.shape)
    shape[dim] //= dist.get_world_size(_GROUPS[gid])
    return x.new_empty(shape)


def _slice(g, dim: int, group):
    """This rank's piece of the whole ``g`` along ``dim``."""
    n = g.shape[dim] // dist.get_world_size(group)
    return g.narrow(dim, dist.get_rank(group) * n, n).contiguous()


def _piece(x, dim: int, group):
    """This rank's piece of the whole ``x`` along ``dim``, a new tensor
    (never a view of ``x``)."""
    n = x.shape[dim] // dist.get_world_size(group)
    return x.narrow(dim, dist.get_rank(group) * n, n).clone(
        memory_format=torch.contiguous_format)


def _scatter_sum(g, dim: int, group):
    """This rank's piece of the sum over ``group`` of the whole ``g``."""
    return _reduce_scatter_op(g, dim, _group_id(group))


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


class _CopyToModel(torch.autograd.Function):
    """Megatron's f over ``_GROUPS[gid]``: the identity forward and
    jvp, the backward's sum."""

    @staticmethod
    def forward(x, gid: int):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.gid = inputs[1]

    @staticmethod
    def backward(ctx, g):
        (g,), level = unwrap_one_level((g,))
        first_order_only((g,), 0, "model-group copy")
        with outside_transforms():
            out = _all_reduce_op(g, ctx.gid)
        return rewrap(out, level), None

    @staticmethod
    def jvp(ctx, t, _):
        return t.view_as(t)


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g over ``_GROUPS[gid]``: the sum forward and jvp,
    the identity backward."""

    @staticmethod
    def forward(x, gid: int):
        return _all_reduce_op(x, gid)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.gid = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return g, None

    @staticmethod
    def jvp(ctx, t, _):
        (t,), level = unwrap_one_level((t,))
        first_order_only((t,), 0, "model-group sum")
        with outside_transforms():
            out = _all_reduce_op(t, ctx.gid)
        return rewrap(out, level)


class _GatherFromModel(torch.autograd.Function):
    """An activation's dim ``dim`` gathered over ``_GROUPS[gid]`` (the
    model group), forward and jvp.  The backward sums the ranks'
    cotangents of the whole tensor and keeps this rank's slice
    (reduce-scatter), since each rank uses the gathered tensor in its own
    way (its heads, its columns); with ``same`` every rank uses it the
    same way (a unit computed whole on every rank), and the backward
    keeps this rank's slice of its own cotangent.  Along the last dim
    inside a split unit; along T at a unit's entry under sequence
    parallelism (Megatron-SP's all-gather).  A leaf's gather is
    ``_Gather``."""

    @staticmethod
    def forward(x, gid: int, dim: int, same: bool):
        return _gather_op(x, dim, gid)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.gid, ctx.dim, ctx.same = inputs

    @staticmethod
    def backward(ctx, g):
        (g,), level = unwrap_one_level((g,))
        first_order_only((g,), 0, "model-group gather")
        with outside_transforms():
            out = (_slice(g, ctx.dim, _GROUPS[ctx.gid]) if ctx.same
                   else _reduce_scatter_op(g, ctx.dim, ctx.gid))
        return rewrap(out, level), None, None, None

    @staticmethod
    def jvp(ctx, t, *_):
        (t,), level = unwrap_one_level((t,))
        first_order_only((t,), 0, "model-group gather")
        with outside_transforms():
            out = _gather_op(t, ctx.dim, ctx.gid)
        return rewrap(out, level)


class _ScatterFromModel(torch.autograd.Function):
    """A split unit's exit under sequence parallelism (Megatron-SP's
    reduce-scatter): the sum over ``_GROUPS[gid]`` of the ranks' partial
    outputs (f32 where the compute dtype is narrower), of which this rank
    keeps its piece along ``dim``, rounded to ``dtype`` once, forward and
    jvp; the backward all-gathers the pieces' cotangents in ``dtype`` (the
    rounded output's, so the gather moves no more bytes than the stream
    holds) and hands each rank's partial output the whole one, upcast
    (exactly)."""

    @staticmethod
    def forward(x, gid: int, dim: int, dtype):
        return _reduce_scatter_op(x, dim, gid).to(dtype)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, ctx.gid, ctx.dim, ctx.out = inputs
        ctx.partial = x.dtype

    @staticmethod
    def backward(ctx, g):
        (g,), level = unwrap_one_level((g,))
        first_order_only((g,), 0, "model-group reduce-scatter")
        with outside_transforms():
            out = _gather_op(g.to(ctx.out), ctx.dim, ctx.gid).to(ctx.partial)
        return rewrap(out, level), None, None, None

    @staticmethod
    def jvp(ctx, t, *_):
        (t,), level = unwrap_one_level((t,))
        first_order_only((t,), 0, "model-group reduce-scatter")
        with outside_transforms():
            out = _reduce_scatter_op(t, ctx.dim, ctx.gid).to(ctx.out)
        return rewrap(out, level)


class _SliceOfModel(torch.autograd.Function):
    """The exit of a unit computed whole on every rank under sequence
    parallelism: this rank's piece along ``dim`` of the whole output,
    forward and jvp (no collective); the backward all-gathers the
    pieces' cotangents, since every rank's whole output is the same one
    and takes the whole cotangent."""

    @staticmethod
    def forward(x, gid: int, dim: int):
        return _piece(x, dim, _GROUPS[gid])

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.gid, ctx.dim = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        (g,), level = unwrap_one_level((g,))
        first_order_only((g,), 0, "model-group slice")
        with outside_transforms():
            out = _gather_op(g, ctx.dim, ctx.gid)
        return rewrap(out, level), None, None

    @staticmethod
    def jvp(ctx, t, *_):
        return _piece(t, ctx.dim, _GROUPS[ctx.gid])


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
    """(dim, entry, group, over data axes) of each entry that cuts the
    leaf."""
    for d, e in enumerate(_entries(spec, ndim)):
        if e is None or mesh.extent(e) == 1:
            continue
        axes = (e,) if isinstance(e, str) else tuple(e)
        data = all(a in DATA_AXES for a in axes)
        if not data and any(a in DATA_AXES for a in axes):
            raise NotImplementedError(
                f"a dim split over data and model axes together ({e}): "
                f"no sharding rule gives one")
        yield d, e, mesh.group(e), data


def _model_split(mesh, spec) -> bool:
    """Whether ``spec`` cuts a dim over "model" into more than one
    piece."""
    return any(e is not None and "model" in ((e,) if isinstance(e, str)
                                             else e)
               and mesh.extent(e) > 1 for e in spec or ())


def _compute_entries(reg: _Registry, keys: list, x, spec) -> list:
    """The compute spec's entries of a split unit's leaf at ``keys``
    (``x`` this rank's stored share of it, or of its period)."""
    stored = _entries(spec or (), x.dim())
    whole = [n * (1 if e is None else reg.mesh.extent(e))
             for n, e in zip(x.shape, stored)]
    return _entries(compute_pspec(reg.cfg, reg.mesh, keys, whole), x.dim())


def gather_for_compute(tree, compute_dtype=None, prefix: str = ""):
    """Every registered split leaf of ``tree`` (a layer's nested dict;
    ``prefix`` + its dotted path is the leaf's parameter path) gathered
    to its compute spec: in a unit tensor-parallel compute splits, over
    the data axes only, keeping its "model" split (the unit comes back
    as a ``SplitUnit``; a leaf it uses whole passes through f), and
    whole otherwise; a float matrix is cast to ``compute_dtype`` first
    under 2d storage.  The identity with nothing registered."""
    reg = _REGISTRY.get()
    if reg is None:
        return tree

    def leaf(x, path: str, split: Optional[Split]):
        if (reg.cast and compute_dtype is not None and x.dim() >= 2
                and x.is_floating_point()):
            x = x.to(compute_dtype)
        spec = reg.specs.get(path)
        target = (None if split is None
                  else _compute_entries(reg, path.split("."), x, spec))
        for d, e, group, data in _split_dims(reg.mesh, spec or (),
                                             x.dim()):
            if target is not None and target[d] == e:
                continue                    # this rank's share computes
            if target is not None and target[d] is not None:
                raise ValueError(f"{path}: stored over {e} on dim {d}, "
                                 f"computed over {target[d]}")
            x = _Gather.apply(x, d, _group_id(group), data)
        return x, target is not None and _model_split(reg.mesh, target)

    seq = _SEQ.get()

    def walk(node, path):
        split = reg.units.get(path[:-1])
        if split is not None:
            leaves, whole = {}, set()
            for k, x in node.items():
                if isinstance(x, dict):     # a block's norm, its MLP
                    leaves[k] = walk(x, f"{path}{k}.")
                    continue
                if not tp_unit(reg.cfg, (path + k).split(".")):
                    leaves[k] = leaf(x, path + k, None)[0]
                    continue
                x, shared = leaf(x, path + k, split)
                if not shared:
                    whole.add(k)
                    if k != "router":       # used whole inside the unit
                        x = _CopyToModel.apply(x, _group_id(split.group))
                leaves[k] = x
            return SplitUnit(leaves, split, frozenset(whole))
        if isinstance(node, dict):
            return {k: walk(v, f"{path}{k}.") for k, v in node.items()}
        x = leaf(node, path[:-1], None)[0]
        if seq is not None and not tp_unit(reg.cfg, path[:-1].split(".")):
            # used on this rank's slice of T (a norm): its gradient is
            # the sum of the ranks' partial ones
            x = _CopyToModel.apply(x, _group_id(seq.group))
        return x

    return walk(tree, prefix)


def gather_whole(t: torch.Tensor, sharding) -> torch.Tensor:
    """The whole leaf of which ``t`` is this rank's share by
    ``sharding`` (a ``NamedSharding``), without autograd; every rank of
    the mesh must call it (a checkpoint save)."""
    with torch.no_grad():
        for d, _, group, _ in _split_dims(sharding.mesh, sharding.spec,
                                          t.dim()):
            t = _gather_op(t, d, _group_id(group))
    return t


def plain(x: torch.Tensor) -> torch.Tensor:
    """``x`` outside every ``torch.func`` level it is wrapped at,
    detached: a constant to them (counts, normalisers)."""
    while x is not None and torch._C._functorch.is_functorch_wrapped_tensor(x):
        x = torch._C._functorch.get_unwrapped(x)
    return x.detach()


def all_reduce_counts(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of ``x``, a tensor no derivative flows
    through (counts, normalisers): it leaves every ``torch.func`` level
    it is wrapped at, and its result is a constant to them."""
    with outside_transforms():
        return _all_reduce_op(plain(x), _group_id(group))


def all_gather_counts(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` over ``group``, stacked in the group's rank
    order (the data group's: ``Mesh.data_index``, the order
    ``data.pipeline.shard_batch`` cuts the rows in), of a tensor no
    derivative flows through, as ``all_reduce_counts``."""
    with outside_transforms():
        return _gather_op(plain(x)[None], 0, _group_id(group))
