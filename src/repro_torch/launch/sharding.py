"""Per-architecture sharding rules, as pure functions of shapes.

Port of ``repro.launch.sharding``.  Every rule takes a mesh-like object
with ``axis_names`` and ``shape`` ({axis: extent}) — a ``launch.mesh.Mesh``
or a shape-only stand-in — and returns a ``P``: one entry per dimension,
each None (replicated), an axis name, or a tuple of names (split over
their product).  ``P()`` is fully replicated, as the reference's
``PartitionSpec()``.

Rules are keyed on (leaf name, ndim).  Three regimes per
``ArchConfig.param_sharding``:

  "replicated" — everything replicated (small models, the acoustic ones)
  "1d"         — tensor parallel over "model" only
  "2d"         — tensor parallel over "model" + FSDP-style sharding of the
                 complementary matrix dim over the data axes

Every rule is divisibility-guarded: an axis that does not divide the dim
is dropped.  The same specs serve the parameters and every θ-sized
CG/optimiser vector.

The sequence trainer uses the batch and lattice rules (``shard_batch``
in ``data.pipeline``) and replicated state (``NamedSharding(mesh, P())``
on every leaf).  The LM trainer stores each parameter and θ-sized state
leaf as this rank's share by ``param_shardings`` (``NamedSharding.
place``) and gathers it where it is used (``launch.fsdp``) to its
``compute_pspec``: over the data axes only for a leaf of a unit
``tp_unit`` names that the layout splits over "model" and whose heads
divide (``tp_divides``), which each rank then uses as its share of the
heads, channels, FFN columns, experts, positions or vocabulary
(``launch.tensor_parallel``): the attention-family blocks, the RG-LRU,
mLSTM and sLSTM blocks, an encoder-decoder arch's layers and
``dec_pos``, the embedding; and whole for any other leaf.
The serving steps place their inputs by ``input_shardings`` (the
reference's dry run does, ``repro.launch.dryrun``): the batch rows over
the data axes, and each rank allocates only its share of the decode
caches (``place_cache``): attention k/v slots over "model", the
recurrent states' channels over "model", ``enc_out`` over the data axes.
``placements`` maps a spec to ``torch.distributed.tensor`` placements.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.launch.mesh import DATA_AXES


class P(tuple):
    """A partition spec: ``P(None, "data", ("pod", "data"))``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def _axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def _guard(dim: int, axis, mesh):
    """``axis`` may be a name or a tuple of names (product extent); an
    axis that does not divide ``dim`` is dropped."""
    if axis is None:
        return None
    if isinstance(axis, tuple):
        axes = tuple(a for a in axis if a in mesh.axis_names)
        if not axes:
            return None
        size = math.prod(mesh.shape[a] for a in axes)
        if dim % size:
            # the largest single axis that divides
            for a in axes:
                if dim % mesh.shape[a] == 0:
                    return a
            return None
        return axes if len(axes) > 1 else axes[0]
    if axis not in mesh.axis_names:
        return None
    return axis if dim % mesh.shape[axis] == 0 else None


def _spec(mesh, shape, *axes) -> P:
    return P(*[_guard(d, a, mesh) for d, a in zip(shape, axes)])


def param_pspec(cfg, mesh, path_keys, shape, *, stacked: bool = True) -> P:
    """Spec of one parameter leaf.  ``path_keys``: the leaf's path split
    at its dots (``"periods.slot0.attn.wq".split(".")``).

    ``stacked=True``: leaves under ``periods/slotN`` carry a leading
    n_periods dim; the rule specs the un-stacked shape and prepends None.
    """
    if cfg.param_sharding == "replicated" or "model" not in mesh.axis_names:
        return P()
    if stacked and any(k.startswith("slot") for k in path_keys):
        inner = param_pspec(cfg, mesh, [k for k in path_keys
                                        if not k.startswith("slot")] or
                            path_keys[-1:], shape[1:])
        return P(None, *inner)
    name = path_keys[-1]
    two_d = cfg.param_sharding == "2d"
    # the FSDP axis includes "pod" when present, so θ-state spreads over
    # every rank of a multi-pod mesh
    dat = (("pod", "data") if "pod" in mesh.axis_names else "data") \
        if two_d else None
    nd = len(shape)
    model = _axis_size(mesh, "model")
    kv_ax = "model" if cfg.num_kv_heads % model == 0 else None

    # embeddings / head / positions: vocab over "model" only (a gather
    # from a d-split table would gather the whole table per use)
    if name == "table":                      # (V, d)
        return _spec(mesh, shape, "model", None)
    if name == "lm_head":                    # (d, V)
        return _spec(mesh, shape, None, "model")
    if name == "dec_pos":                    # (P, d)
        return _spec(mesh, shape, "model", None)

    # attention
    if name == "wq":
        return _spec(mesh, shape, dat, "model")
    if name in ("wk", "wv"):                 # (d, K*hd): kv heads only
        return _spec(mesh, shape, dat, kv_ax)
    if name == "wo":
        return _spec(mesh, shape, "model", dat)
    if name == "bq":
        return _spec(mesh, shape, "model")
    if name in ("bk", "bv"):
        return _spec(mesh, shape, kv_ax)

    # FFN / MoE
    if name in ("w_in", "w_gate"):
        if nd == 3:                          # MoE (E, d, ff)
            if shape[0] % model == 0:
                return _spec(mesh, shape, "model", dat, None)
            return _spec(mesh, shape, None, dat, "model")
        return _spec(mesh, shape, dat, "model")
    if name == "w_out":
        if nd == 3:                          # MoE (E, ff, d)
            if shape[0] % model == 0:
                return _spec(mesh, shape, "model", None, dat)
            return _spec(mesh, shape, None, "model", dat)
        return _spec(mesh, shape, "model", dat)
    if name == "router":                     # (d, E)
        return P()

    # recurrent blocks
    if name in ("w_x", "w_y", "w_up"):       # (d, inner)
        return _spec(mesh, shape, dat, "model")
    if name == "w_down":                     # (inner, d)
        return _spec(mesh, shape, "model", dat)
    if name in ("w_q", "w_k", "w_v"):        # mLSTM (inner, inner)
        return _spec(mesh, shape, dat, "model")
    if name == "w_if":                       # (inner, 2H)
        return _spec(mesh, shape, "model", None)
    if name in ("w_input_gate", "w_rec_gate"):   # (rg, rg)
        return _spec(mesh, shape, dat, "model")
    if name == "conv_w":                     # (K, C)
        return _spec(mesh, shape, None, "model")
    if name == "w_zifo":                     # (d, 4d)
        return _spec(mesh, shape, dat, "model")
    if name == "r_zifo":                     # (4, H, hd, hd)
        h_ax = "model" if shape[1] % model == 0 else None
        return _spec(mesh, shape, None, h_ax, None, None)

    # norms, biases, gains
    return P()


def compute_pspec(cfg, mesh, path_keys, shape) -> P:
    """Spec of an un-stacked leaf (a period's slice of a stacked one)
    where the model computes with it: the reference's ``launch.fsdp.
    make_spec_fn``, the 1d spec, to which GSPMD gathers a 2d-stored
    leaf.  Its "model" entries are those of the stored spec; a
    replicated config computes on whole leaves."""
    if cfg.param_sharding == "replicated":
        return P()
    return param_pspec(cfg.replace(param_sharding="1d"), mesh, path_keys,
                       shape, stacked=False)


ATTENTION_KINDS = ("attn", "swa", "local", "moe", "swamoe")
RECURRENT_KINDS = ("rglru", "mlstm", "slstm")
# the units tensor-parallel compute splits: (the leaf whose stored spec
# decides whether the unit is split, what it is split by; a MoE whose
# experts "model" does not divide is split by their columns)
TP_UNITS = {"attn": ("wq", "heads"), "mlp": ("w_in", "columns"),
            "moe": ("w_in", "experts"), "embed": ("table", "vocab"),
            "rglru": ("w_x", "channels"), "mlstm": ("w_q", "heads"),
            "slstm": ("r_zifo", "heads"), "positions": ("dec_pos",
                                                        "positions")}
# the leaves of a recurrent block's temporal unit: the block's norms and
# its MLP (a unit of its own) sit beside them in the block's dict
TP_UNIT_LEAVES = {
    "rglru": ("w_x", "w_y", "conv_w", "conv_b", "w_input_gate",
              "w_rec_gate", "log_lambda", "w_out"),
    "mlstm": ("w_up", "w_gate", "conv_w", "conv_b", "w_q", "w_k", "w_v",
              "w_if", "b_if", "w_down"),
    "slstm": ("w_zifo", "b_zifo", "r_zifo", "w_up", "w_down"),
}
_ENCDEC_ATTENTION = ("attn", "self_attn", "cross_attn")


def block_kind(cfg, path_keys) -> str:
    """The ``block_pattern`` kind of the layer a leaf path lies in
    (``periods.slot<s>...`` or ``rest.rest<i>...`` of a decoder-only
    arch), or "" for a leaf of no such layer (the embeddings, the final
    norm, an encoder-decoder arch's layers)."""
    if cfg.is_encoder_decoder:
        return ""
    if len(path_keys) > 1 and path_keys[0] == "periods":
        return cfg.block_pattern[int(path_keys[1][len("slot"):])]
    if len(path_keys) > 1 and path_keys[0] == "rest":
        return cfg.block_pattern[int(path_keys[1][len("rest"):])]
    return ""


def tp_unit(cfg, path_keys) -> str:
    """The unit of ``TP_UNITS`` whose tensor-parallel compute consumes
    the leaf at ``path_keys``, or "":

      * the embedding's ``table`` and ``lm_head`` ("embed");
      * an attention-family block's ``attn``, ``mlp`` and ``moe`` leaves;
      * a recurrent block's temporal leaves (``TP_UNIT_LEAVES``: "rglru",
        "mlstm", "slstm", the unit at the block's own path) and an
        RG-LRU block's ``mlp``; its norms are in no unit;
      * an encoder-decoder arch's ``attn``, ``self_attn`` and
        ``cross_attn`` ("attn"), its ``mlp``s and ``dec_pos``
        ("positions", the unit at the root path "").

    Whether a unit is split on a mesh is ``tp_divides``' and the stored
    layout's call (``launch.fsdp.compute_specs``)."""
    if path_keys[0] == "embed":
        return "embed" if path_keys[-1] in ("table", "lm_head") else ""
    if cfg.is_encoder_decoder:
        if list(path_keys) == ["dec_pos"]:
            return "positions"
        if len(path_keys) >= 2 and path_keys[0] in ("encoder", "decoder"):
            if path_keys[-2] in _ENCDEC_ATTENTION:
                return "attn"
            if path_keys[-2] == "mlp":
                return "mlp"
        return ""
    kind = block_kind(cfg, path_keys)
    if len(path_keys) < 3:
        return ""
    if kind in ATTENTION_KINDS and path_keys[-2] in ("attn", "mlp", "moe"):
        return path_keys[-2]
    if kind == "rglru" and path_keys[-2] == "mlp":
        return "mlp"
    if kind in RECURRENT_KINDS and len(path_keys) == 3 \
            and path_keys[-1] in TP_UNIT_LEAVES[kind]:
        return kind
    return ""


def tp_divides(cfg, unit: str, extent: int) -> bool:
    """Whether a unit's own computation divides over ``extent`` ranks of
    "model" where its deciding leaf's spec splits (its guard checks only
    that leaf's dim): attention, the mLSTM and the sLSTM split by whole
    heads (m | H; the guard on xlstm's 1536-wide ``w_q`` alone would cut
    a 384-wide head 8 ways), and the sLSTM's up-projection by its
    columns too."""
    if unit in ("attn", "mlstm", "slstm") and cfg.num_heads % extent:
        return False
    if unit == "slstm":
        return int(cfg.proj_factor * cfg.d_model) % extent == 0
    return True


def tp_leaf(cfg, path_keys) -> bool:
    """Whether tensor-parallel compute consumes the leaf (``tp_unit``)."""
    return bool(tp_unit(cfg, path_keys))


@dataclass(frozen=True)
class NamedSharding:
    """A leaf's layout: ``spec`` over ``mesh``.  Under explicit SPMD each
    rank holds its share of the leaf; ``place`` cuts and moves a whole
    tensor to that share."""

    mesh: object
    spec: P

    def is_replicated(self) -> bool:
        return all(e is None for e in self.spec)

    def split_axes(self) -> tuple:
        """The mesh axes the leaf is split over, in the spec's order."""
        out = []
        for e in self.spec:
            if e is not None:
                out += [e] if isinstance(e, str) else list(e)
        return tuple(out)

    def pieces(self) -> int:
        """How many distinct pieces the leaf is cut into: the number of
        ranks along the axes it is split over (1: every rank holds it
        whole)."""
        return math.prod(self.mesh.shape[a] for a in self.split_axes())

    def data_split(self) -> tuple:
        """The data axes (pod, data) of the entries that cut the leaf
        into more than one piece: the batch axes its gather's backward
        already sums the gradient over (``launch.fsdp``)."""
        out = []
        for e in self.spec:
            axes = () if e is None else (e,) if isinstance(e, str) else e
            if axes and all(a in DATA_AXES for a in axes) \
                    and math.prod(self.mesh.shape[a] for a in axes) > 1:
                out += list(axes)
        return tuple(out)

    def share_shape(self, shape) -> tuple:
        """The shape of a rank's share of a leaf of the whole ``shape``."""
        entries = list(self.spec) + [None] * (len(shape) - len(self.spec))
        return tuple(n if e is None else n // math.prod(
            self.mesh.shape[a] for a in ((e,) if isinstance(e, str) else e))
            for n, e in zip(shape, entries))

    def place(self, tensor: torch.Tensor) -> torch.Tensor:
        """This rank's share of the whole ``tensor``, on the mesh's
        device, in storage of its own (the whole tensor can be freed)."""
        out = tensor
        for d, e in enumerate(self.spec):
            if e is None:
                continue
            coord = dict(zip(self.mesh.axis_names,
                             self.mesh.device_mesh.get_coordinate()))
            axes = (e,) if isinstance(e, str) else e
            index = 0
            for a in axes:                  # row-major over the axes
                index = index * self.mesh.shape[a] + coord[a]
            n = out.shape[d] // math.prod(self.mesh.shape[a] for a in axes)
            out = out.narrow(d, index * n, n)
        return out.to(self.mesh.device, copy=out.numel() != tensor.numel())


def placements(mesh, spec: P, ndim: int) -> tuple:
    """``torch.distributed.tensor`` placements of ``spec`` on ``mesh``:
    one per mesh axis, ``Shard(d)`` where dim d is split over the axis,
    ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    entries = list(spec) + [None] * (ndim - len(spec))
    out = []
    for axis in mesh.axis_names:
        dims = [d for d, e in enumerate(entries)
                if e == axis or (isinstance(e, tuple) and axis in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def param_shardings(cfg, mesh, params_shapes: dict) -> dict:
    """{path: NamedSharding} for a parameter (or θ-sized) dict; values
    are tensors or ``(shape, dtype)`` pairs (``Model.param_shapes``)."""
    def shape_of(v):
        return tuple(v.shape) if isinstance(v, torch.Tensor) else v[0]
    return {k: NamedSharding(mesh, param_pspec(cfg, mesh, k.split("."),
                                               shape_of(v)))
            for k, v in params_shapes.items()}


def replicated_shardings(mesh, params: dict) -> dict:
    """Every leaf replicated: the acoustic models' state under a mesh."""
    return {k: NamedSharding(mesh, P()) for k in params}


# ---------------------------------------------------------------------------
# activations / inputs / caches
# ---------------------------------------------------------------------------

def data_axes(mesh):
    axes = tuple(a for a in DATA_AXES if a in mesh.axis_names)
    return axes if axes else None


def data_extent(mesh):
    """(axes, total size) of the data-parallel axes: the one definition
    of which axes carry the batch."""
    axes = data_axes(mesh)
    return axes, math.prod(mesh.shape[a] for a in (axes or ()))


def batch_pspec(mesh, ndim: int, batch_divisible: bool = True) -> P:
    return P(data_axes(mesh) if batch_divisible else None,
             *([None] * (ndim - 1)))


def lattice_pspec(mesh, shape) -> P:
    """Spec of one ``Lattice`` field or any batch-leading ASR tensor: the
    leading batch dim over the data axes, the rest replicated.  All or
    nothing: a B that does not divide the whole data extent replicates
    (a half-split lattice would put the frontier gathers out of step with
    the arc tensors)."""
    dp, size = data_extent(mesh)
    if dp is None or not shape:
        return P(*([None] * len(shape)))
    return P(dp if shape[0] % size == 0 else None,
             *([None] * (len(shape) - 1)))


def _map_leaves(fn, tree):
    """``fn`` over the tensors (or ``(shape, dtype)`` pairs) of dicts,
    lists and tuples (a ``Lattice`` included); None passes."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_leaves(fn, v) for v in tree))
    return fn(tree)


def sequence_input_shardings(mesh, batch):
    """Specs of an ASR sequence batch ({feats, labels, lattice}) or a bare
    ``Lattice``: every batch-leading tensor over the data axes with
    ``lattice_pspec``'s guard, 0-d leaves replicated."""
    def per_leaf(leaf):
        if leaf.dim() == 0:
            return P()
        return lattice_pspec(mesh, tuple(leaf.shape))
    return _map_leaves(per_leaf, batch)


lattice_shardings = sequence_input_shardings


def input_shardings(cfg, mesh, specs: dict) -> dict:
    """Specs of ``Model.input_specs()``'s tree: {name: (shape, dtype)},
    a decode cache nested beneath ``"cache"``."""
    dp, dp_size = data_extent(mesh)

    def build(shape, where: dict) -> P:
        """``where``: {negative dim: axis}, right-relative (cache leaves
        under scanned periods carry a leading stack dim)."""
        spec = [None] * len(shape)
        for rix, ax in where.items():
            if len(shape) + rix < 0:
                continue
            if ax == "__data__":
                if dp is not None and shape[rix] % dp_size == 0:
                    spec[rix] = dp
            else:
                spec[rix] = _guard(shape[rix], ax, mesh)
        return P(*spec)

    def per_leaf(name, shape):
        if len(shape) == 0:
            return P()
        if name in ("k", "v"):     # (..., B, S, K, hd): slots over model
            return build(shape, {-4: "__data__", -3: "model"})
        if name == "state":        # RG-LRU (..., B, rg)
            return build(shape, {-2: "__data__", -1: "model"})
        if name == "conv":         # (..., B, K-1, C)
            return build(shape, {-3: "__data__", -1: "model"})
        if name == "C":            # mLSTM (..., B, H, hd, hd)
            return build(shape, {-4: "__data__", -2: "model"})
        if name in ("n", "c", "h"):    # (..., B, H, hd)
            return build(shape, {-3: "__data__", -1: "model"})
        if name == "m":            # (B, H) or (B, H, hd): replicated
            return build(shape, {})
        if name in ("enc_out", "encoder_input"):
            return build(shape, {-3: "__data__"})
        return build(shape, {-len(shape): "__data__"})

    def walk(name, tree):
        if isinstance(tree, dict):
            return {k: walk(k, v) for k, v in tree.items()}
        shape = tuple(tree[0]) if isinstance(tree, tuple) \
            else tuple(tree.shape)
        return per_leaf(name.split(".")[-1], shape)

    return {k: walk(k, v) for k, v in specs.items()}


class CacheShares(dict):
    """A rank's shares of the decode cache leaves ({path: tensor}, the
    model's cache layout), with ``shardings`` ({path: ``NamedSharding``})
    saying how each leaf of the whole cache is cut: what the serving
    step registers (``launch.fsdp.step_context``) so that the model knows
    which dims of its cache are this rank's share."""

    def __init__(self, leaves: dict, shardings: dict):
        super().__init__(leaves)
        self.shardings = shardings


def place_cache(cfg, mesh, shapes: dict, fill: dict) -> CacheShares:
    """This rank's share of every decode cache leaf, on the mesh's
    device: ``shapes`` ({path: (shape, dtype)}) of the whole cache, each
    leaf cut by ``input_shardings``' rule and allocated at the share's
    shape (never whole), filled with ``fill[name]`` (the leaf's last path
    key; 0 where it is absent), as the whole cache is initialised."""
    specs = input_shardings(cfg, mesh, {"cache": shapes})["cache"]
    shardings = {k: NamedSharding(mesh, specs[k]) for k in shapes}
    leaves = {k: torch.full(shardings[k].share_shape(shape),
                            fill.get(k.split(".")[-1], 0.0), dtype=dtype,
                            device=mesh.device)
              for k, (shape, dtype) in shapes.items()}
    return CacheShares(leaves, shardings)
