"""Residual blocks of the language models.

Port of the ``block_pattern`` kinds of ``repro.models.blocks`` that the
ported archs use: the attention-family blocks (``attn``, global causal
attention; ``local`` and ``swa``, windowed attention; each with a dense
MLP, and ``moe`` and ``swamoe``, global and windowed attention with a
mixture-of-experts FFN) and the RG-LRU (Griffin) block.  The xLSTM kinds
(``mlstm``, ``slstm``) raise ``NotImplementedError`` until their slice.
Each kind has the reference's four entry points, dispatched by kind at
the end of this module:

  init_block(cfg, init, kind, lead=())              -> params
  block_apply(cfg, kind, p, x, positions)           -> (x, aux)   # sequence
  init_block_cache(cfg, kind, batch, cache_len, long_mode, device) -> cache
  block_decode(cfg, kind, p, x, cache, pos, long_mode) -> (x, cache) # 1 token

``aux`` is the MoE load-balance loss (a 0-d tensor), 0.0 for the other
kinds.  The MoE FFN of a sequence is ``cfg.moe_impl``'s (the dense
one-hot combine, or the capacity dispatch); decode always runs the dense
form, as the reference's.  Windowed caches are ring buffers of
``min(cache_len, window)`` slots; an ``attn`` or ``moe`` cache holds
``cache_len`` slots, or with ``long_mode`` (the reference's bounded
cache for long_500k) a ring of ``min(cache_len,
cfg.long_context_window)``.  Unlike the reference, whose arrays are
immutable, ``block_decode`` writes the new token's cache entries into
the given cache tensors in place and returns them: a step then never
copies a cache.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def causal_conv1d(x, w, b=None):
    """Depthwise causal conv.  x: (B,T,C), w: (K,C)."""
    Kk = w.shape[0]
    T = x.shape[1]
    out = torch.zeros_like(x)
    for i in range(Kk):
        shift = Kk - 1 - i
        xi = F.pad(x, (0, 0, shift, 0))[:, :T]
        out = out + xi * w[i].to(x.dtype)
    if b is not None:
        out = out + b.to(x.dtype)
    return out


def conv1d_step(x_t, buf, w, b=None):
    """Single-step depthwise conv.  x_t: (B,C), buf: (B,K-1,C) past inputs."""
    seq = torch.cat([buf, x_t[:, None]], dim=1)              # (B,K,C)
    out = torch.einsum("bkc,kc->bc", seq, w.to(x_t.dtype))
    if b is not None:
        out = out + b.to(x_t.dtype)
    new_buf = seq[:, 1:]
    return out, new_buf


def _not_ported(kind):
    return NotImplementedError(
        f"block kind {kind!r} is not ported yet (the port runs 'attn', "
        f"'local', 'swa', 'moe', 'swamoe' and 'rglru'; ROADMAP 1.3 lists "
        f"the xLSTM kinds 'mlstm' and 'slstm')")


# ---------------------------------------------------------------------------
# Attention-family blocks (attn / local / swa / moe / swamoe)
# ---------------------------------------------------------------------------

def _attn_kind(kind):
    return kind in ("attn", "swa", "local", "moe", "swamoe")


def _uses_window(kind):
    return kind in ("swa", "local", "swamoe")


def _uses_moe(kind):
    return kind in ("moe", "swamoe")


def init_attention_block(cfg, init, kind, *, lead=()):
    p = {"ln1": L.init_norm(cfg, init, cfg.d_model, lead=lead),
         "attn": L.init_attention(cfg, init, lead=lead),
         "ln2": L.init_norm(cfg, init, cfg.d_model, lead=lead)}
    if _uses_moe(kind):
        p["moe"] = L.init_moe(cfg, init, lead=lead)
    else:
        p["mlp"] = L.init_mlp(cfg, init, lead=lead)
    return p


def attention_block_apply(cfg, kind, p, x, positions):
    h = L.norm_apply(cfg, p["ln1"], x)
    q, k, v = L.qkv_project(cfg, p["attn"], h, positions)
    if _uses_window(kind):
        ctx = L.windowed_attention(q, k, v, cfg.sliding_window)
    else:
        ctx = L.causal_attention(q, k, v)
    x = x + L.out_project(cfg, p["attn"], ctx)
    h = L.norm_apply(cfg, p["ln2"], x)
    if _uses_moe(kind):
        moe_fn = (L.moe_apply_dispatch if cfg.moe_impl == "dispatch"
                  else L.moe_apply)
        y, aux = moe_fn(cfg, p["moe"], h)
    else:
        y, aux = L.mlp_apply(cfg, p["mlp"], h), 0.0
    return x + y, aux


def init_attention_cache(cfg, kind, batch, cache_len, *, lead=(),
                         long_mode=False, device=None):
    K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    if _uses_window(kind):
        slots = min(cache_len, cfg.sliding_window)
    elif long_mode:
        slots = min(cache_len, cfg.long_context_window)
    else:
        slots = cache_len
    shape = (*lead, batch, slots, K, hd)
    return {"k": torch.zeros(shape, dtype=cfg.cdtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.cdtype, device=device)}


def attention_block_decode(cfg, kind, p, x, cache, pos: int, *,
                           long_mode=False):
    """x: (B,1,d); pos: absolute position of the new token.  Writes the
    token's k/v into ``cache`` in place: at ring slot ``pos % slots`` for
    a windowed kind or in ``long_mode``, else at ``min(pos, slots - 1)``
    (the reference's rule: past ``cache_len`` the last slot is
    overwritten).  The token attends ``min(pos + 1, slots)`` slots."""
    h = L.norm_apply(cfg, p["ln1"], x)
    q, k, v = L.qkv_project(cfg, p["attn"], h,
                            torch.full((1,), pos, device=x.device))
    slots = cache["k"].shape[1]
    ring = _uses_window(kind) or long_mode
    ix = pos % slots if ring else min(pos, slots - 1)
    cache["k"][:, ix] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, ix] = v[:, 0].to(cache["v"].dtype)
    ctx = L.decode_attention(q, cache["k"], cache["v"], min(pos + 1, slots))
    x = x + L.out_project(cfg, p["attn"], ctx)
    h = L.norm_apply(cfg, p["ln2"], x)
    if _uses_moe(kind):
        y, _ = L.moe_apply(cfg, p["moe"], h)
    else:
        y = L.mlp_apply(cfg, p["mlp"], h)
    return x + y, cache


# ---------------------------------------------------------------------------
# RG-LRU (Griffin) block
# ---------------------------------------------------------------------------

def _rg_dim(cfg):
    return cfg.rglru_dim or cfg.d_model


def init_rglru_block(cfg, init, *, lead=()):
    d, rg = cfg.d_model, _rg_dim(cfg)
    return {
        "ln1": L.init_norm(cfg, init, d, lead=lead),
        "w_x": L.dense_init(init, d, rg, cfg.pdtype, lead=lead),
        "w_y": L.dense_init(init, d, rg, cfg.pdtype, lead=lead),
        "conv_w": init.normal((*lead, cfg.conv_kernel, rg), 0.1, cfg.pdtype),
        "conv_b": init.full((*lead, rg), 0.0, cfg.pdtype),
        "w_input_gate": L.dense_init(init, rg, rg, cfg.pdtype, lead=lead),
        "w_rec_gate": L.dense_init(init, rg, rg, cfg.pdtype, lead=lead),
        "log_lambda": init.full((*lead, rg), math.log(math.expm1(0.9 * 8.0)),
                                cfg.pdtype),
        "w_out": L.dense_init(init, rg, d, cfg.pdtype, lead=lead),
        "ln2": L.init_norm(cfg, init, d, lead=lead),
        "mlp": L.init_mlp(cfg, init, lead=lead),
    }


_RG_C = 8.0


def _softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) as logaddexp(x, 0) (torch's
    ``softplus`` returns x itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _rglru_gates(p, u):
    """u: (..., rg) post-conv input.  Returns (log_a, gated_input) in f32.
    The gate products are f32 matmuls on f32 weights, as the reference's
    (``device.set_numerics`` keeps TF32 off on the card)."""
    uf = u.float()
    rg = torch.sigmoid(uf @ p["w_rec_gate"].float())
    ig = torch.sigmoid(uf @ p["w_input_gate"].float())
    log_a = -_RG_C * rg * _softplus(p["log_lambda"].float())
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6))
    return log_a, beta * ig * uf


def rglru_scan(p, u):
    """RG-LRU over time, h_t = a_t h_{t-1} + x_t, u: (B,T,rg).

    The reference's ``jax.lax.associative_scan`` becomes a log-depth
    doubling scan in f32 (ceil(log2 T) passes, 15 at T = 32768): pass s
    folds each (a, h) pair with the one 2^s steps earlier.  It combines
    the same pairs in another tree than XLA's, so it agrees with the
    reference to f32 rounding, not bitwise."""
    log_a, h = _rglru_gates(p, u)
    a = torch.exp(log_a)
    T = u.shape[1]
    shift = 1
    while shift < T:
        h[:, shift:] = h[:, shift:] + a[:, shift:] * h[:, :-shift]
        if 2 * shift < T:
            a[:, shift:] = a[:, shift:] * a[:, :-shift]
        shift *= 2
    return h.to(u.dtype)


def rglru_block_apply(cfg, p, x, positions):
    h = L.norm_apply(cfg, p["ln1"], x)
    u = h @ p["w_x"].to(h.dtype)
    y = h @ p["w_y"].to(h.dtype)
    u = causal_conv1d(u, p["conv_w"], p["conv_b"])
    r = rglru_scan(p, u)
    out = (r * F.gelu(y, approximate="tanh")) @ p["w_out"].to(h.dtype)
    x = x + out
    h = L.norm_apply(cfg, p["ln2"], x)
    return x + L.mlp_apply(cfg, p["mlp"], h), 0.0


def init_rglru_cache(cfg, batch, *, lead=(), device=None):
    rg = _rg_dim(cfg)
    return {"state": torch.zeros((*lead, batch, rg), dtype=torch.float32,
                                 device=device),
            "conv": torch.zeros((*lead, batch, cfg.conv_kernel - 1, rg),
                                dtype=cfg.cdtype, device=device)}


def rglru_block_decode(cfg, p, x, cache, pos: int):
    """One token; writes the new state and conv buffer into ``cache`` in
    place."""
    h = L.norm_apply(cfg, p["ln1"], x)               # (B,1,d)
    u = (h @ p["w_x"].to(h.dtype))[:, 0]
    y = (h @ p["w_y"].to(h.dtype))[:, 0]
    u, conv_buf = conv1d_step(u, cache["conv"], p["conv_w"], p["conv_b"])
    log_a, x_in = _rglru_gates(p, u)
    state = torch.exp(log_a) * cache["state"] + x_in
    out = ((state.to(h.dtype) * F.gelu(y, approximate="tanh"))
           @ p["w_out"].to(h.dtype))[:, None]
    x = x + out
    hh = L.norm_apply(cfg, p["ln2"], x)
    x = x + L.mlp_apply(cfg, p["mlp"], hh)
    cache["state"].copy_(state)
    cache["conv"].copy_(conv_buf)
    return x, cache


# ---------------------------------------------------------------------------
# Dispatch tables
# ---------------------------------------------------------------------------

def init_block(cfg, init, kind, *, lead=()):
    if _attn_kind(kind):
        return init_attention_block(cfg, init, kind, lead=lead)
    if kind == "rglru":
        return init_rglru_block(cfg, init, lead=lead)
    raise _not_ported(kind)


def block_apply(cfg, kind, p, x, positions):
    if _attn_kind(kind):
        return attention_block_apply(cfg, kind, p, x, positions)
    if kind == "rglru":
        return rglru_block_apply(cfg, p, x, positions)
    raise _not_ported(kind)


def init_block_cache(cfg, kind, batch, cache_len, *, lead=(),
                     long_mode=False, device=None):
    if _attn_kind(kind):
        return init_attention_cache(cfg, kind, batch, cache_len, lead=lead,
                                    long_mode=long_mode, device=device)
    if kind == "rglru":
        return init_rglru_cache(cfg, batch, lead=lead, device=device)
    raise _not_ported(kind)


def block_decode(cfg, kind, p, x, cache, pos: int, *, long_mode=False):
    if _attn_kind(kind):
        return attention_block_decode(cfg, kind, p, x, cache, pos,
                                      long_mode=long_mode)
    if kind == "rglru":
        return rglru_block_decode(cfg, p, x, cache, pos)
    raise _not_ported(kind)
