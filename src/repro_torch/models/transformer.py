"""Decoder-only backbone of the language models.

Port of ``repro.models.transformer``.  Depth is ``block_pattern`` cycled
over ``num_layers``: ``num_layers // len(pattern)`` *periods*, each slot's
parameters stacked over periods (leading dimension), plus an unrolled
remainder of ``rest`` layers.  The reference's ``lax.scan`` over periods
is a Python loop here, without its remat.  Its FSDP gathers are
``launch.fsdp.gather_for_compute``'s, at the same points: the
embeddings, each layer's leaves (a stacked leaf one period at a time),
the final norm and the head.  With no mesh they are identities, so
parameters stay in their stored dtype (f32) and a matrix is cast at each
use, as the reference does.  Under tensor-parallel compute
(``launch.tensor_parallel``) the embedding, every block's unit (the
attention-family blocks' attention and FFN, the RG-LRU, mLSTM and sLSTM
blocks, ``models.blocks``) and the head run on this rank's share of
their leaves: ``forward_hidden`` hands the head its hidden state through
``tensor_parallel.enter``, ``head_matrix`` is this rank's (d, V/m)
columns, and ``forward`` gathers the logits' vocab whole.  With
sequence-parallel activations (``launch.fsdp.sequence_split``, decided
by ``forward_hidden`` from the step's registry and the batch's shape)
each rank holds its T/m rows of the residual stream from the embedding
to the final norm, and the whole T is gathered once, before the head
(the reference's ``steps.py`` ``unshard_seq``).

Parameters are a flat dict keyed by the reference's pytree path, leaves
stacked over periods as in the reference:

    "embed.table", "embed.lm_head" (none when the embeddings are tied),
    "final_norm.scale",
    "periods.slot0.w_x" (n_periods, d, rg), ...,
    "periods.slot2.attn.wq" (n_periods, d, H*hd), ...,
    "rest.rest0.w_x" (d, rg), ...

so ``convert.lm_params_from_numpy`` carries a reference tree across
without a transpose.  The decode cache is a flat dict of the same kind
(``"periods.slot2.k"`` of shape (n_periods, B, slots, K, hd), ...), and
``decode_step`` updates it in place.  On a mesh each rank holds its
share of it (``init_cache(mesh=)``), cut by the reference's
``input_shardings``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.launch import fsdp
from repro_torch.launch import tensor_parallel as tp
from repro_torch.launch.sharding import place_cache
from repro_torch.models import blocks as B
from repro_torch.models import layers as L


# options of the reference's ArchConfig that the decoder-only backbone
# does not run, with the value it runs (learned positions and the
# encoder come with ``models.encdec``)
_PORTED = {"learned_positions": False, "is_encoder_decoder": False}


def check_ported(cfg):
    """Raise ``NotImplementedError`` for a config that asks for an option
    the port does not run yet (each comes with an arch that uses it)."""
    for field, value in _PORTED.items():
        if getattr(cfg, field) != value:
            raise NotImplementedError(
                f"{cfg.name}: {field}={getattr(cfg, field)!r} is not "
                f"ported yet (the port runs {field}={value!r}; ROADMAP.md "
                f"lists the archs still to port)")


def layer_plan(cfg):
    """(pattern, n_periods, rest) of ``cfg``; every path through the
    backbone starts here, so it also checks that ``cfg`` is ported."""
    check_ported(cfg)
    pattern = cfg.block_pattern
    per = len(pattern)
    n_periods = cfg.num_layers // per
    rest = tuple(pattern[i] for i in range(cfg.num_layers - n_periods * per))
    return pattern, n_periods, rest


def flatten(tree: dict, prefix: str = "") -> dict:
    """Nested dict -> flat {"a.b.c": leaf}."""
    out = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(flatten(val, path + "."))
        else:
            out[path] = val
    return out


def nest(flat: dict, prefix: str, index=None) -> dict:
    """The leaves of ``flat`` under ``prefix`` as a nested dict (the
    reference's block parameter layout), each indexed by ``index`` (a
    period) when given: views, no copies."""
    out: dict = {}
    n = len(prefix)
    for key, val in flat.items():
        if not key.startswith(prefix):
            continue
        parts = key[n:].split(".")
        node = out
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = val if index is None else val[index]
    return out


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_tree(cfg, init: L.Init) -> dict:
    pattern, n_periods, rest = layer_plan(cfg)
    tree = {"embed": L.init_embedding(cfg, init),
            "final_norm": L.init_norm(cfg, init, cfg.d_model)}
    if n_periods:
        tree["periods"] = {
            f"slot{s}": B.init_block(cfg, init, kind, lead=(n_periods,))
            for s, kind in enumerate(pattern)}
    tree["rest"] = {f"rest{i}": B.init_block(cfg, init, kind)
                    for i, kind in enumerate(rest)}
    return flatten(tree)


def init_params(cfg, seed: int = 0, device=DEFAULT_DEVICE) -> dict:
    """Random parameters drawn on ``device`` from a ``torch.Generator`` on
    that device seeded with ``seed`` (at full width a host draw would
    need the whole f32 tree in host memory).  The reference draws with
    ``jax.random``; carry its parameters across with
    ``convert.lm_params_from_numpy``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return _init_tree(cfg, L.Init(dev, gen))


def param_shapes(cfg) -> dict:
    """{path: (shape, dtype)} of ``init_params``'s tree, built on the
    meta device: nothing is allocated."""
    return {k: (tuple(v.shape), v.dtype)
            for k, v in _init_tree(cfg, L.Init("meta")).items()}


def param_count(cfg) -> int:
    return sum(math.prod(shape) for shape, _ in param_shapes(cfg).values())


def _layer_slots(cfg) -> list:
    """[(kind, path prefix, period index or None)] in depth order."""
    pattern, n_periods, rest = layer_plan(cfg)
    out = [(kind, f"periods.slot{s}.", i) for i in range(n_periods)
           for s, kind in enumerate(pattern)]
    return out + [(kind, f"rest.rest{i}.", None)
                  for i, kind in enumerate(rest)]


def _layers(cfg, tree: dict) -> list:
    """[(kind, nested leaves of that layer)] in depth order, for the
    parameters or the decode cache."""
    return [(kind, nest(tree, prefix, i))
            for kind, prefix, i in _layer_slots(cfg)]


def gathered(cfg, params: dict, prefix: str, index=None) -> dict:
    """The leaves under ``prefix`` (of period ``index``) as a nested
    dict, each gathered whole where a mesh splits it
    (``launch.fsdp.gather_for_compute``; the identity without one)."""
    return fsdp.gather_for_compute(nest(params, prefix, index), cfg.cdtype,
                                   prefix)


# ---------------------------------------------------------------------------
# sequence forward (train / prefill)
# ---------------------------------------------------------------------------

def head_matrix(cfg, params):
    """(d, V) LM head: the ``embed.lm_head`` leaf, or the table transposed
    (a view) when the embeddings are tied, so that a transform's tangent
    and cotangent of the head reach ``embed.table``; this rank's (d, V/m)
    columns on a share of the vocabulary."""
    return L.head_matrix_of(cfg, gathered(cfg, params, "embed."))


def forward_hidden(cfg, params, batch):
    """As ``forward`` but stops before the LM head: (hidden (B,T,d), aux).
    The hidden state enters the head as a unit (``tensor_parallel.
    enter``): for a head split over the vocabulary its cotangent from the
    head is the sum of the ranks' partial ones; with sequence-parallel
    activations, which the blocks run on this rank's T/m rows, the whole
    T is gathered here."""
    tokens = batch["tokens"]
    T = tokens.shape[1]
    with fsdp.sequence_rows(fsdp.sequence_split(T)):
        emb = gathered(cfg, params, "embed.")
        x = L.embed_apply(cfg, emb, tokens)
        positions = torch.arange(T, device=tokens.device)
        aux = 0.0
        for kind, prefix, i in _layer_slots(cfg):
            x, a = B.block_apply(cfg, kind, gathered(cfg, params, prefix, i),
                                 x, positions)
            aux = aux + a
        x = L.norm_apply(cfg, gathered(cfg, params, "final_norm."), x)
        return tp.enter(x, tp.split_of(emb)), aux


def forward(cfg, params, batch):
    """batch["tokens"]: (B, T) integer.  Returns (logits (B,T,V) f32, aux);
    a head split over the vocabulary gives its columns, gathered whole."""
    x, aux = forward_hidden(cfg, params, batch)
    emb = gathered(cfg, params, "embed.")
    logits = L.lm_head_apply(cfg, emb, x)
    split = tp.split_of(emb)
    if split:
        logits = tp.gather_vocab(logits, split)
    return logits.float(), aux


# ---------------------------------------------------------------------------
# decode (serving)
# ---------------------------------------------------------------------------

def init_cache(cfg, batch_size: int, cache_len: int, *, long_mode=False,
               device=DEFAULT_DEVICE, mesh=None) -> dict:
    """Zeroed decode caches; ``long_mode`` bounds the global-attention
    caches to rings of ``cfg.long_context_window`` slots.  On a ``mesh``
    (a ``launch.mesh.Mesh``; ``device`` is then the mesh's) this rank's
    shares of the caches of a global batch of ``batch_size``, allocated
    at their shapes (``launch.sharding.place_cache``)."""
    if mesh is not None:
        return place_cache(cfg, mesh, cache_shapes(
            cfg, batch_size, cache_len, long_mode=long_mode), B.CACHE_FILL)
    return _cache_tree(cfg, batch_size, cache_len, long_mode,
                       resolve_device(device))


def cache_shapes(cfg, batch_size: int, cache_len: int, *,
                 long_mode=False) -> dict:
    """{path: (shape, dtype)} of ``init_cache``'s dict, on the meta
    device."""
    return {k: (tuple(v.shape), v.dtype) for k, v in _cache_tree(
        cfg, batch_size, cache_len, long_mode,
        torch.device("meta")).items()}


def _cache_tree(cfg, batch_size: int, cache_len: int, long_mode: bool,
                dev) -> dict:
    pattern, n_periods, rest = layer_plan(cfg)
    tree = {"periods": {}, "rest": {}}
    if n_periods:
        for s, kind in enumerate(pattern):
            tree["periods"][f"slot{s}"] = B.init_block_cache(
                cfg, kind, batch_size, cache_len, lead=(n_periods,),
                long_mode=long_mode, device=dev)
    for i, kind in enumerate(rest):
        tree["rest"][f"rest{i}"] = B.init_block_cache(
            cfg, kind, batch_size, cache_len, long_mode=long_mode,
            device=dev)
    return flatten(tree)


def decode_step(cfg, params, cache, tokens, pos: int, *, long_mode=False):
    """One decode step.  tokens: (B,1) integer; pos: the absolute position
    being written (an int).  Returns (logits (B,1,V) f32, cache), the
    cache updated in place.  ``long_mode`` as the cache was made.  Each
    layer's leaves are gathered where they are used, as in the sequence
    forward (the reference's ``decode_step``); under a serving step on a
    mesh each layer reads its cache as this rank's share
    (``launch.fsdp.cache_for_compute``), and a head split over the
    vocabulary gives its columns, gathered whole."""
    pos = int(pos)
    emb = gathered(cfg, params, "embed.")
    x = L.embed_apply(cfg, emb, tokens)
    for kind, prefix, i in _layer_slots(cfg):
        c = fsdp.cache_for_compute(nest(cache, prefix, i), prefix)
        x, _ = B.block_decode(cfg, kind, gathered(cfg, params, prefix, i), x,
                              c, pos, long_mode=long_mode)
    x = L.norm_apply(cfg, gathered(cfg, params, "final_norm."), x)
    split = tp.split_of(emb)
    logits = L.lm_head_apply(cfg, emb, x)
    if split:
        logits = tp.gather_vocab(logits, split)
    return logits.float(), cache
