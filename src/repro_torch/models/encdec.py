"""Whisper-style encoder-decoder backbone (audio family).

Port of ``repro.models.encdec``.  The mel/conv frontend is a stub, as in
the reference: the encoder consumes frame embeddings (B, encoder_frames,
d_model).  Sinusoidal encoder positions, bidirectional encoder self
attention, causal decoder self attention with a KV cache, cross
attention and learned decoder positions are the reference's.  The
reference's ``remat="full"`` only saves memory; it has no counterpart
here (``torch.utils.checkpoint`` does not compose with the
``torch.func`` transforms of the curvature products).

Parameters are a flat dict keyed by the reference's pytree path,

    "embed.table", "embed.lm_head", "dec_pos" (65536, d),
    "enc_ln_post.scale", "final_norm.bias", ...,
    "encoder.layer0.attn.wq", "encoder.layer0.mlp.w_in", ...,
    "decoder.layer0.self_attn.wq", "decoder.layer0.cross_attn.wk", ...,

so ``convert.lm_params_from_numpy`` carries a reference tree across.
The decode cache is a flat dict too (``"enc_out"``, ``"layer0.k"``,
``"layer0.v"``, ...), and ``decode_step`` updates it in place.

Under a mesh the train and prefill forwards gather each layer's leaves
where they are used (``launch.fsdp``).  The reference leaves its 1d
archs (whisper-base) to GSPMD's tensor parallelism; here, where the
mesh's "model" extent is above 1, each rank computes its share
(``launch.tensor_parallel``), as the decoder-only archs' attention
blocks do: the heads of the encoder's and the decoder's attention and
of the cross attention (``_cross``: the decoder states and the encoder
output both enter through f, so the encoder's gradient is the group's
sum), the MLPs' columns, the vocabulary where "model" divides it, and
``dec_pos``'s rows (``tensor_parallel.position_embed``).  Decode on a
mesh runs the same shares against this rank's share of the caches
(``init_cache(mesh=)``: ``enc_out`` over the data axes, the decoder's
self-attention slots over "model").
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.launch import fsdp
from repro_torch.launch import tensor_parallel as tp
from repro_torch.launch.sharding import param_shardings, place_cache
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models.transformer import flatten, gathered, nest

DEC_POSITIONS = 1 << 16        # learned decoder positions (the reference's)

# options of the reference's ArchConfig that the enc-dec path does not run
_PORTED = {"qkv_bias": False, "qk_norm": False, "tie_embeddings": False,
           "block_pattern": ("attn",), "num_experts": 0}


def check_ported(cfg):
    """Raise ``NotImplementedError`` for an enc-dec config that asks for
    an option the port's enc-dec path does not run yet."""
    for field, value in _PORTED.items():
        if getattr(cfg, field) != value:
            raise NotImplementedError(
                f"{cfg.name}: is_encoder_decoder=True with {field}="
                f"{getattr(cfg, field)!r} is not ported yet (the enc-dec "
                f"path runs {field}={value!r}; ROADMAP.md lists the archs "
                f"still to port)")


def _sinusoid(T: int, d: int, dtype, device):
    pos = torch.arange(T, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None]
    inv = torch.exp(-math.log(10000.0) * dim / max(d // 2 - 1, 1))
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(dtype)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_tree(cfg, init: L.Init) -> dict:
    check_ported(cfg)
    d = cfg.d_model
    tree = {"embed": L.init_embedding(cfg, init),
            "dec_pos": init.normal((DEC_POSITIONS, d), 0.01, cfg.pdtype),
            "enc_ln_post": L.init_norm(cfg, init, d),
            "final_norm": L.init_norm(cfg, init, d),
            "encoder": {}, "decoder": {}}
    for i in range(cfg.encoder_layers):
        tree["encoder"][f"layer{i}"] = {
            "ln1": L.init_norm(cfg, init, d),
            "attn": L.init_attention(cfg, init),
            "ln2": L.init_norm(cfg, init, d),
            "mlp": L.init_mlp(cfg, init)}
    for i in range(cfg.num_layers):
        tree["decoder"][f"layer{i}"] = {
            "ln1": L.init_norm(cfg, init, d),
            "self_attn": L.init_attention(cfg, init),
            "ln_x": L.init_norm(cfg, init, d),
            "cross_attn": L.init_attention(cfg, init),
            "ln2": L.init_norm(cfg, init, d),
            "mlp": L.init_mlp(cfg, init)}
    return flatten(tree)


def init_params(cfg, seed: int = 0, device=DEFAULT_DEVICE) -> dict:
    """Random parameters drawn on ``device`` from a ``torch.Generator`` on
    that device seeded with ``seed``.  The reference draws with
    ``jax.random``; carry its parameters across with
    ``convert.lm_params_from_numpy``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return _init_tree(cfg, L.Init(dev, gen))


def param_shapes(cfg) -> dict:
    """{path: (shape, dtype)}, built on the meta device."""
    return {k: (tuple(v.shape), v.dtype)
            for k, v in _init_tree(cfg, L.Init("meta")).items()}


def param_count(cfg) -> int:
    return sum(math.prod(shape) for shape, _ in param_shapes(cfg).values())


# ---------------------------------------------------------------------------
# sequence forward (train / prefill)
# ---------------------------------------------------------------------------

def encode(cfg, params, enc_input):
    """enc_input: (B, F, d) frame embeddings -> (B, F, d) in the compute
    dtype."""
    check_ported(cfg)
    x = enc_input.to(cfg.cdtype)
    x = x + _sinusoid(x.shape[1], cfg.d_model, x.dtype, x.device)[None]
    for i in range(cfg.encoder_layers):
        p = gathered(cfg, params, f"encoder.layer{i}.")
        h = L.norm_apply(cfg, p["ln1"], x)
        q, k, v = L.qkv_project(cfg, p["attn"], h, None, apply_rope=False)
        x = x + L.out_project(cfg, p["attn"], L.cross_attention(q, k, v))
        h = L.norm_apply(cfg, p["ln2"], x)
        x = x + L.mlp_apply(cfg, p["mlp"], h)
    return L.norm_apply(cfg, gathered(cfg, params, "enc_ln_post."), x)


def _cross(cfg, p, h, enc_out):
    """Cross attention of the decoder states ``h`` over ``enc_out``; on a
    share of the heads both enter through ``copy_to_model``, and the
    memory's kv heads are those the rank's query heads read."""
    B, T = h.shape[:2]
    hd = cfg.resolved_head_dim
    split = tp.split_of(p)
    if split:
        h, enc_out = tp.copy_to_model(h, split), tp.copy_to_model(enc_out,
                                                                  split)
    dt = h.dtype
    q = (h @ p["wq"].to(dt)).reshape(B, T, -1, hd)
    mk = (enc_out @ p["wk"].to(dt)).reshape(B, enc_out.shape[1], -1, hd)
    mv = (enc_out @ p["wv"].to(dt)).reshape(B, enc_out.shape[1], -1, hd)
    if split and "wk" in p.whole:
        mk, mv = tp.local_kv(mk, mv, split, cfg.num_heads)
    return L.out_project(cfg, p, L.cross_attention(q, mk, mv))


def _dec_layer_seq(cfg, p, x, enc_out):
    h = L.norm_apply(cfg, p["ln1"], x)
    q, k, v = L.qkv_project(cfg, p["self_attn"], h, None, apply_rope=False)
    x = x + L.out_project(cfg, p["self_attn"], L.causal_attention(q, k, v))
    h = L.norm_apply(cfg, p["ln_x"], x)
    x = x + _cross(cfg, p["cross_attn"], h, enc_out)
    h = L.norm_apply(cfg, p["ln2"], x)
    return x + L.mlp_apply(cfg, p["mlp"], h)


def head_matrix(cfg, params):
    """(d, V) LM head (untied: ``check_ported`` refuses tied embeddings)."""
    return gathered(cfg, params, "embed.")["lm_head"]


def forward_hidden(cfg, params, batch):
    """Pre-LM-head forward: (hidden (B,T,d), aux).  batch: {"tokens":
    (B,T) integer, "encoder_input": (B,F,d)}.  The learned positions
    come from each rank's rows of ``dec_pos`` summed over the model
    group where "model" splits it; for a head split over the vocabulary
    the hidden state leaves through ``copy_to_model``."""
    tokens = batch["tokens"]
    T = tokens.shape[1]
    enc_out = encode(cfg, params, batch["encoder_input"])
    emb = gathered(cfg, params, "embed.")
    x = L.embed_apply(cfg, emb, tokens)
    pos = fsdp.gather_for_compute({"dec_pos": params["dec_pos"]},
                                  cfg.cdtype)
    split = tp.split_of(pos)
    if split:
        x = x + tp.position_embed(T, pos["dec_pos"], x.dtype, split)[None]
    else:
        x = x + pos["dec_pos"][:T].to(x.dtype)[None]
    for i in range(cfg.num_layers):
        x = _dec_layer_seq(cfg, gathered(cfg, params, f"decoder.layer{i}."),
                           x, enc_out)
    x = L.norm_apply(cfg, gathered(cfg, params, "final_norm."), x)
    split = tp.split_of(emb)
    if split:
        x = tp.copy_to_model(x, split)
    return x, 0.0


def forward(cfg, params, batch):
    """Returns (logits (B,T,V) f32, aux); a head split over the
    vocabulary gives its columns, gathered whole."""
    x, aux = forward_hidden(cfg, params, batch)
    emb = gathered(cfg, params, "embed.")
    logits = L.lm_head_apply(cfg, emb, x)
    split = tp.split_of(emb)
    if split:
        logits = tp.gather_vocab(logits, split)
    return logits.float(), aux


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_cache(cfg, batch_size: int, cache_len: int, *, long_mode=False,
               device=DEFAULT_DEVICE, mesh=None) -> dict:
    """Zeroed caches of ``cache_len`` slots; ``long_mode`` is taken and
    ignored, as the reference's enc-dec does.  On a ``mesh`` this rank's
    shares (``launch.sharding.place_cache``): ``enc_out``'s rows over the
    data axes, the self-attention slots over "model"."""
    if mesh is not None:
        return place_cache(cfg, mesh, cache_shapes(cfg, batch_size,
                                                   cache_len), {})
    return _cache_tree(cfg, batch_size, cache_len, resolve_device(device))


def cache_shapes(cfg, batch_size: int, cache_len: int, *,
                 long_mode=False) -> dict:
    """{path: (shape, dtype)} of ``init_cache``'s dict, on the meta
    device."""
    return {k: (tuple(v.shape), v.dtype) for k, v in _cache_tree(
        cfg, batch_size, cache_len, torch.device("meta")).items()}


def _cache_tree(cfg, batch_size: int, cache_len: int, dev) -> dict:
    check_ported(cfg)
    K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    cache = {"enc_out": torch.zeros(batch_size, cfg.encoder_frames,
                                    cfg.d_model, dtype=cfg.cdtype,
                                    device=dev)}
    for i in range(cfg.num_layers):
        for name in ("k", "v"):
            cache[f"layer{i}.{name}"] = torch.zeros(
                batch_size, cache_len, K, hd, dtype=cfg.cdtype, device=dev)
    return cache


def prefill_cache(cfg, params, cache, enc_input, *, mesh=None):
    """Encode ``enc_input`` into ``cache["enc_out"]``; returns the cache.

    On a ``mesh``: ``params`` are this rank's shares by ``launch.sharding.
    param_shardings``, ``cache`` this rank's shares (``init_cache(...,
    mesh=)``) and ``enc_input`` the global batch, of which this rank's
    rows (``enc_out``'s placement: the data axes) are encoded as a train
    step's forward would encode them (``launch.fsdp.step_context``) into
    the rank's ``enc_out``."""
    if mesh is None:
        cache["enc_out"] = encode(cfg, params, enc_input)
        return cache
    rows = cache.shardings["enc_out"].place(enc_input)
    shardings = param_shardings(cfg, mesh, param_shapes(cfg))
    with torch.no_grad(), fsdp.step_context(cfg, mesh, shardings):
        cache["enc_out"].copy_(encode(cfg, params, rows))
    return cache


def decode_step(cfg, params, cache, tokens, pos: int, *, long_mode=False):
    """One decode step.  tokens: (B,1) integer; pos: the absolute position
    being written (an int).  Returns (logits (B,1,V) f32, cache), the
    cache's k/v rows at ``pos`` written in place (``long_mode`` ignored,
    as in the reference).  Each layer's leaves are gathered where they
    are used; on a mesh the self-attention reads its cache's share
    (``blocks.attend_decode``), the position's row comes from the rank
    that holds it where "model" splits ``dec_pos``, and a head split
    over the vocabulary gives its columns, gathered whole."""
    pos = int(pos)
    emb = gathered(cfg, params, "embed.")
    x = L.embed_apply(cfg, emb, tokens)
    dec = fsdp.gather_for_compute({"dec_pos": params["dec_pos"]}, cfg.cdtype)
    split = tp.split_of(dec)
    if split:
        x = x + tp.vocab_embed(torch.full((1,), pos, device=x.device),
                               dec["dec_pos"], x.dtype, split)[None]
    else:
        x = x + dec["dec_pos"][pos:pos + 1].to(x.dtype)[None]
    enc_out = cache["enc_out"].to(x.dtype)
    for i in range(cfg.num_layers):
        p = gathered(cfg, params, f"decoder.layer{i}.")
        c = fsdp.cache_for_compute({"k": cache[f"layer{i}.k"],
                                    "v": cache[f"layer{i}.v"]}, f"layer{i}.")
        h = L.norm_apply(cfg, p["ln1"], x)
        x = x + B.attend_decode(cfg, p["self_attn"], h, c, pos, ring=False,
                                rope=False)
        h = L.norm_apply(cfg, p["ln_x"], x)
        x = x + _cross(cfg, p["cross_attn"], h, enc_out)
        h = L.norm_apply(cfg, p["ln2"], x)
        x = x + L.mlp_apply(cfg, p["mlp"], h)
    x = L.norm_apply(cfg, gathered(cfg, params, "final_norm."), x)
    split = tp.split_of(emb)
    logits = L.lm_head_apply(cfg, emb, x)
    if split:
        logits = tp.gather_vocab(logits, split)
    return logits.float(), cache
