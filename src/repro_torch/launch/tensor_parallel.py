"""Tensor-parallel compute over the mesh's "model" axis.

Port of what GSPMD does with the reference's 1d compute specs
(``repro.launch.fsdp.make_spec_fn``): under a mesh whose "model" extent
m is above 1, ``launch.fsdp.gather_for_compute`` hands the model the
leaves of every unit ``launch.sharding.tp_unit`` names still split over
"model", and each rank computes its share of the unit, as Megatron-LM
does:

  * attention: H/m query heads and the kv heads they read (the rank's
    own kv share when m divides K; else the matching heads of the whole
    kv projection, ``local_kv``), then its rows of ``wo``;
  * the MLP: its d_ff/m columns of ``w_in``/``w_gate`` and rows of
    ``w_out``;
  * the MoE: its E/m experts, or d_ff/m columns of every expert when m
    does not divide E (``launch.sharding.param_pspec``'s rule);
  * the embedding: the V/m rows of the table it holds (``vocab_embed``),
    and the head: V/m logit columns, which the chunked CE
    (``losses.chunked_lm``) normalises over the group (``vocab_shard``);
  * an RG-LRU block: its rg/m channels (``models.blocks``), the gate
    products reading the whole conv output (``gather_from_model``);
  * an mLSTM or sLSTM block: its H/m heads, where m divides H
    (``launch.sharding.tp_divides``; else the block runs whole);
  * an encoder-decoder arch: the attention family's rules for its
    encoder and decoder attention, cross attention (``models.encdec.
    _cross``) and MLPs, and its learned positions from the P/m rows of
    ``dec_pos`` it holds (``position_embed``).

Between the units each rank holds its contiguous T/m of the (B, T, d)
residual stream where the step takes sequence-parallel activations
(``launch.fsdp.sequence_split``: a decoder-only arch not "replicated",
m dividing T, the batch rows split over the data group or a data extent
of 1), and runs the norms and the residual adds on that slice; else the
stream, the norms and the residual are whole on every rank.  A unit's
edges are ``enter`` and ``leave``:

  * a split unit with a whole stream: ``copy_to_model`` (Megatron's f:
    the identity forward and jvp; the backward sums the cotangent over
    the model group, since each rank's share of the unit gave a partial
    one) at its entry, ``reduce_from_model`` (g: the sum of the ranks'
    partial outputs, forward and jvp; the identity backward) at its exit;
  * a split unit with the stream split over T (Megatron-SP): an
    all-gather over T at its entry (a reduce-scatter backward) and a
    reduce-scatter over T of the f32 partials at its exit, then one
    rounding to the compute dtype (an all-gather of the compute dtype's
    cotangent backward);
  * a unit computed whole on every rank with the stream split over T (an
    xLSTM block whose heads "model" does not divide, a vocabulary it
    does not divide): an all-gather at its entry (this rank's slice of
    the cotangent backward), and this rank's slice of its output at its
    exit (an all-gather backward).

The head and the chunked CE read the whole T (``models.transformer.
forward_hidden`` enters them as a unit), and so does everything inside a
unit.  A leaf used on the T slice (a norm's) passes through f
(``launch.fsdp.gather_for_compute``): each rank's gradient of it is a
partial one.  The MoE's router reads the unit's input whole on every
rank, and the aux its probabilities: its entry is the whole unit's (a
slice backward), and f sits on the experts' input and the combine
weights (``models.layers.moe_apply``).

Inside a unit, where one product's column split does not line up with
what the rank computes next (the RG-LRU's (rg, rg) gate matrices, the
mLSTM's q/k/v, the sLSTM's gate-major ``w_zifo`` and its ``w_up``), the
activation moves, never the weight: ``gather_from_model`` all-gathers
its last dim forward and jvp, and its backward reduce-scatters the
ranks' partial cotangents.  A tensor every rank reads a different part
of after a g (the mLSTM's gate pre-activations) passes through f after
it.

Every one of these is a ``launch.fsdp`` ``autograd.Function``
(``_CopyToModel``, ``_ReduceFromModel``, ``_GatherFromModel``,
``_ScatterFromModel``, ``_SliceOfModel``) whose collectives
are its ``torch.library`` ops, launched outside the ``torch.func``
levels (``core.functorch_levels``): autograd, ``torch.func.vjp``,
``jvp`` and ``linearize`` (the curvature products) run through them.  A
leaf a split unit uses whole on every rank passes through f on its way
in (``gather_for_compute``), so its gradient is the sum of the ranks'
partial ones (a vector it reads in part, as the RG-LRU's ``conv_b``, is
then cut by ``shard``); the MoE router's does not, since the
load-balance aux reads its probabilities whole on every rank: f sits on
the combine weights instead (``models.layers.moe_apply``).

Whether a unit is split is decided once a step, by the step's registry
(``launch.fsdp.compute_specs``), and travels with the unit's leaves
(``launch.fsdp.SplitUnit``): the model reads it with ``split_of``, the
chunked CE with ``vocab_shard``.  Whether the arch takes
sequence-parallel activations is decided there too; a forward's shapes
settle it (``models.transformer.forward_hidden``).  Outside a step with tensor-parallel
compute every unit is whole, and nothing here runs.

A serving step on a mesh (``launch.steps.build_serve_step(mesh=)``) also
reads its decode caches as this rank's shares: ``cache_split`` gives a
leaf's split over "model", ``cache_rows``/``put_rows`` a whole leaf's
rows of a batch split over the data ranks, and ``all_gather`` /
``gather_parts`` move the per-token vectors between a unit's layout and
its cache's (no derivative runs there).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.launch import fsdp


def split_of(p) -> Optional[fsdp.Split]:
    """The ``Split`` of a unit's leaves ``p`` (a ``SplitUnit``), or None
    where the unit is whole."""
    return getattr(p, "split", None)


def copy_to_model(x: torch.Tensor, split: fsdp.Split) -> torch.Tensor:
    """f: ``x`` entering a split unit (its gradient summed over the model
    group)."""
    return fsdp._CopyToModel.apply(x, fsdp._group_id(split.group))


def reduce_from_model(x: torch.Tensor, split: fsdp.Split) -> torch.Tensor:
    """g: the sum over the model group of the ranks' partial ``x``."""
    return fsdp._ReduceFromModel.apply(x, fsdp._group_id(split.group))


def gather_from_model(x: torch.Tensor, split: fsdp.Split) -> torch.Tensor:
    """The whole of an activation whose last dim each rank holds its
    share of (in model order), for a product that reads all of it but
    computes the rank's own columns or heads: all-gathered forward and
    jvp; the backward sums the ranks' partial cotangents and keeps this
    rank's share (reduce-scatter)."""
    return fsdp._GatherFromModel.apply(x, fsdp._group_id(split.group),
                                       x.dim() - 1, False)


def enter(x: torch.Tensor, split: Optional[fsdp.Split]) -> torch.Tensor:
    """``x`` (B, T, ...) entering a unit (``split``: its ``Split``, or
    None where it runs whole): f on a split unit, nothing on a whole
    one, with the stream whole; with it split over T
    (``fsdp.seq_split``), the whole T all-gathered, its backward a
    reduce-scatter on a split unit and this rank's slice on a whole
    one."""
    seq = fsdp.seq_split()
    if seq is None:
        return copy_to_model(x, split) if split else x
    return fsdp._GatherFromModel.apply(x, fsdp._group_id(seq.group), 1,
                                       not split)


def leave(y: torch.Tensor, split: Optional[fsdp.Split], dtype
          ) -> torch.Tensor:
    """A unit's output (B, T, ...) in ``dtype``: on a split unit ``y`` is
    the rank's partial one (f32 where the compute dtype is narrower),
    summed over the model group (g), or with the stream split over T
    reduce-scattered over T; on a whole unit ``y`` is the whole output,
    of which this rank keeps its T slice with the stream split.  Rounded
    to ``dtype`` after the sum."""
    seq = fsdp.seq_split()
    if split and seq is not None:
        return fsdp._ScatterFromModel.apply(y, fsdp._group_id(seq.group), 1,
                                            dtype)
    if split:
        y = reduce_from_model(y, split)
    elif seq is not None:
        y = fsdp._SliceOfModel.apply(y, fsdp._group_id(seq.group), 1)
    return y.to(dtype)


def shard(x: torch.Tensor, split: fsdp.Split, dim: int = -1) -> torch.Tensor:
    """This rank's 1/m of ``x`` along ``dim`` (its channels of a vector
    the unit holds whole, its heads of a whole activation), a view."""
    n = x.shape[dim] // split.extent
    return x.narrow(dim, split.index * n, n)


# ---------------------------------------------------------------------------
# decode: per-token vectors between the compute and the cache layouts
# ---------------------------------------------------------------------------

def cache_split(cache, name: str) -> Optional[fsdp.Split]:
    """The ``Split`` of the decode cache leaf ``name`` of a layer's cache
    (``launch.fsdp.cache_for_compute``'s ``CacheShare``) where this rank
    holds its share of it over "model", else None."""
    return getattr(cache, "splits", {}).get(name)


def cache_rows(cache, name: str, n: int):
    """(the ``n`` batch rows of the step in the cache leaf ``name``, the
    data ``Split`` to write them back over or None): where the leaf holds
    every row of a batch split over the data group (a leaf the layout
    keeps whole), this rank's rows of it."""
    t = cache[name]
    rows = getattr(cache, "rows", None)
    if rows is None or t.shape[0] == n:
        return t, None
    return t.narrow(0, rows.index * n, n), rows


def put_rows(cache, name: str, new: torch.Tensor, rows) -> None:
    """Write ``new`` (the step's rows) into the cache leaf ``name``:
    with ``rows`` (``cache_rows``') every data rank's rows, all-gathered,
    so that the leaf stays the same on every rank."""
    cache[name].copy_(new if rows is None else all_gather(new, rows, 0))


def all_gather(x: torch.Tensor, split: fsdp.Split, dim: int) -> torch.Tensor:
    """Every rank's ``x`` over ``split``'s group (the model group, or the
    data group of a ``cache_rows`` split), concatenated along ``dim`` in
    the group's order (no derivative: the serving steps)."""
    return fsdp._gather_op(x, dim % x.dim(), fsdp._group_id(split.group))


def gather_parts(parts: list, split: fsdp.Split, dim: int) -> list:
    """``all_gather`` of each tensor of ``parts`` along ``dim``, in one
    collective: the parts, equal in every other dim, travel side by
    side."""
    sizes = [t.shape[dim] for t in parts]
    both = all_gather(torch.cat(parts, dim), split, dim)
    dim %= both.dim()
    both = both.unflatten(dim, (split.extent, sum(sizes)))
    return [t.flatten(dim, dim + 1) for t in both.split(sizes, dim + 1)]


# ---------------------------------------------------------------------------
# attention heads
# ---------------------------------------------------------------------------

def local_kv(k: torch.Tensor, v: torch.Tensor, split: fsdp.Split,
             heads: int):
    """The kv heads this rank's query heads (``heads`` / m of them)
    read, from the whole ``k``/``v`` (B, T, K, hd): a query head h reads
    kv head h // (heads // K).  When the rank's heads hold whole groups,
    those groups' kv heads; when they lie in one group, its kv head;
    else one kv head a query head (G = 1).  Contiguous, as the attention
    kernels take them."""
    K = k.shape[2]
    G = heads // K
    h_local = heads // split.extent
    first = split.index * h_local
    if h_local % G == 0:
        sel = slice(first // G, first // G + h_local // G)
    elif G % h_local == 0:
        sel = slice(first // G, first // G + 1)
    else:
        sel = torch.arange(first, first + h_local, device=k.device) // G
    return k[:, :, sel].contiguous(), v[:, :, sel].contiguous()


# ---------------------------------------------------------------------------
# the vocabulary
# ---------------------------------------------------------------------------

class VocabShard(NamedTuple):
    """This rank's slice of the vocabulary: ids [start, start + size)
    over ``group``."""
    group: object
    start: int
    size: int


def vocab_shard(size: int) -> Optional[VocabShard]:
    """The running step's vocab slice for a head of ``size`` local
    columns, or None when the embedding unit is whole."""
    split = fsdp.unit_split("embed")
    if split is None:
        return None
    return VocabShard(split.group, split.index * size, size)


def vocab_embed(tokens: torch.Tensor, table: torch.Tensor, dtype,
                split: fsdp.Split):
    """The embedding of ``tokens`` from this rank's rows of the table
    (zero for a token another rank holds) in ``dtype``, summed over the
    model group (``leave``: reduce-scattered over T with the stream
    split): each token's row comes from the one rank that holds it, so
    the sum has its bits."""
    size = table.shape[0]
    local = tokens - split.index * size
    inside = (local >= 0) & (local < size)
    rows = F.embedding(local.clamp(0, size - 1), table).to(dtype)
    rows = torch.where(inside[..., None], rows, rows.new_zeros(()))
    return leave(rows, split, dtype)


def position_embed(T: int, table: torch.Tensor, dtype,
                   split: fsdp.Split):
    """Learned positions 0..T-1 (T, d) from this rank's rows of the
    positions table, summed over the model group (``vocab_embed`` of the
    positions): the same bits as the whole table's first T rows."""
    return vocab_embed(torch.arange(T, device=table.device), table, dtype,
                       split)


def gather_vocab(logits: torch.Tensor, split: fsdp.Split) -> torch.Tensor:
    """The whole vocab's logits from each rank's columns (the last dim);
    the backward takes this rank's columns of the cotangent, which every
    rank holds whole."""
    return fsdp._Gather.apply(logits, logits.dim() - 1,
                              fsdp._group_id(split.group), False)


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM):
    """``op`` over ``group`` of ``x``, a tensor no derivative flows
    through (the chunked CE's softmax statistics), as a new tensor."""
    out = x.detach().clone()
    dist.all_reduce(out, op=op, group=group)
    fsdp.log_collective("all_reduce", fsdp._group_id(group), out)
    return out
