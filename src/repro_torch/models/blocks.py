"""Residual blocks of the language models.

Port of every ``block_pattern`` kind of ``repro.models.blocks``: the
attention-family blocks (``attn``, global causal attention; ``local`` and
``swa``, windowed attention; each with a dense MLP, and ``moe`` and
``swamoe``, global and windowed attention with a mixture-of-experts FFN),
the RG-LRU (Griffin) block and the xLSTM blocks (``mlstm``, matrix
memory, run over a sequence in its exact chunkwise-parallel form;
``slstm``, scalar memory, a time loop).  Each kind has the reference's
four entry points, dispatched by kind at the end of this module:

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

Under tensor-parallel compute (``launch.tensor_parallel``) every kind's
sequence forward runs on this rank's share of its unit's leaves, the
unit entered by ``tensor_parallel.enter`` and left by ``leave`` after
its row-parallel product (``layers.row_parallel``).  The norms and the
residual adds run on what the rank holds of the stream between the
units: its T/m rows under sequence-parallel activations
(``launch.fsdp.sequence_split``: the entry all-gathers T, the exit
reduce-scatters it; a unit the mesh leaves whole gathers T at its entry
and keeps this rank's slice at its exit), else the whole stream, with f
at the entry and g at the exit.  Inside a unit, T is whole:

  * an attention block's attention and FFN or MoE (in ``models.layers``'
    projections, MLP and MoE); a windowed kind's attention runs on the
    rank's query heads and the kv heads they read, whose counts the
    kernels read off the shapes;
  * an RG-LRU block on its rg/m channels: ``w_x``/``w_y`` columns, the
    conv and the scan on those channels, the gate products (whose
    (rg, rg) matrices are split by columns) reading the whole u through
    ``gather_from_model``, ``w_out``'s rows; then its MLP as its own
    split unit;
  * an mLSTM block on its H/m heads: ``w_up``/``w_gate`` columns and the
    conv on the heads' channels, q/k/v from the whole u
    (``gather_from_model``), the gates from ``w_if``'s rows summed by g
    (then f, since each rank reads its heads' gates of the sum), the
    chunkwise recurrence on the rank's heads, ``w_down``'s rows;
  * an sLSTM block on its H/m heads: ``w_zifo``'s columns (gate-major)
    gathered whole and the rank's heads taken, the time loop on those
    heads with no collective inside it, then ``w_up`` on the whole h
    (``gather_from_model``) and ``w_down``'s rows.

A vector the unit holds whole but reads in part (``conv_b``,
``log_lambda``, ``b_if``, ``b_zifo``) passes through f on its way in
(``launch.fsdp.gather_for_compute``) and is cut to the rank's channels
here (``tensor_parallel.shard``).

Decode on a mesh (``launch.steps.build_serve_step(mesh=)``) reads each
layer's cache as this rank's share (``tensor_parallel.cache_split``,
``launch.sharding.input_shardings``' layout): an attention cache's slots
over "model", attended flash-decoding style (``attend_decode``); the
RG-LRU's and the xLSTM blocks' states by channels, stepped on the rank's
channels with only per-token vectors moving between the unit's layout
and the cache's (each kind's ``*_block_decode``).
"""
from __future__ import annotations

import math
from collections import OrderedDict

import torch
import torch.nn.functional as F

from repro_torch.core.functorch_levels import (first_order_only,
                                               outside_transforms, rewrap,
                                               unwrap_one_level, wrapped)
from repro_torch.launch import tensor_parallel as tp
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


def _max1(x):
    """``jnp.maximum(x, 1.0)`` with JAX's derivative: at x == 1 the
    gradient and tangent split half and half between the two arguments
    (the mLSTM's normaliser, which autograd differentiates)."""
    return torch.maximum(x, x.new_ones(()))


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


def attend_decode(cfg, p, h, cache, pos: int, *, ring: bool,
                  rope: bool = True):
    """The new token's attention against its cache, out-projected: h
    (B,1,d) normed, ``p`` the attention leaves, ``cache`` {"k", "v"}
    (B, S, K, hd).  Writes the token's k/v in place at ring slot ``pos %
    slots`` with ``ring``, else at ``min(pos, slots - 1)`` (the
    reference's rule: past ``cache_len`` the last slot is overwritten),
    and attends ``min(pos + 1, slots)`` slots.  ``rope=False`` (the
    enc-dec decoder) writes at ``pos`` and attends ``pos + 1``.

    On a mesh, with the slots split over "model" (``tensor_parallel.
    cache_split``), slot ``ix`` of the whole lies on rank ``ix // S`` of
    the S it holds: only that rank writes the token's k/v, and the ranks
    combine their slots' partial softmaxes (``layers.decode_attention``).
    On a share of the heads (``tensor_parallel.split_of``) the token's q
    and k/v are all-gathered over "model" first (B H hd numbers, never a
    cache), every rank attends its slots with every head, and this
    rank's heads of the context enter ``wo``'s rows."""
    split = tp.split_of(p)
    slots = tp.cache_split(cache, "k")
    q, k, v = L.qkv_project(cfg, p, h, torch.full((1,), pos, device=h.device)
                            if rope else None, apply_rope=rope,
                            local_kv=False)
    if split and "wk" in p.whole:
        q = tp.all_gather(q, split, 2)
    elif split:
        q, k, v = tp.gather_parts([q, k, v], split, 2)
    S = cache["k"].shape[1]
    total = S * (slots.extent if slots else 1)
    if not rope:
        ix, valid = pos, pos + 1
    else:
        ix = pos % total if ring else min(pos, total - 1)
        valid = min(pos + 1, total)
    own = ix - slots.index * S if slots else ix
    if slots is None or 0 <= own < S:
        cache["k"][:, own] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, own] = v[:, 0].to(cache["v"].dtype)
    ctx = L.decode_attention(q, cache["k"], cache["v"], valid, slots)
    if split:
        ctx = tp.shard(ctx, split, dim=2)
    return L.out_project(cfg, p, ctx)


def attention_block_decode(cfg, kind, p, x, cache, pos: int, *,
                           long_mode=False):
    """x: (B,1,d); pos: absolute position of the new token.  The token's
    attention (``attend_decode``) over a ring for a windowed kind or in
    ``long_mode``, then the FFN."""
    h = L.norm_apply(cfg, p["ln1"], x)
    x = x + attend_decode(cfg, p["attn"], h, cache, pos,
                          ring=_uses_window(kind) or long_mode)
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


def _rglru_gates(p, u, split=None):
    """u: (..., rg) post-conv input.  Returns (log_a, gated_input) in f32.
    The gate products are f32 matmuls on f32 weights, as the reference's
    (``device.set_numerics`` keeps TF32 off on the card).  On a share of
    the channels (``split``; u the rank's rg/m) they read the whole u,
    gathered in f32, and give the rank's columns."""
    uf = u.float()
    uw = uf if split is None else tp.gather_from_model(uf, split)
    lam = p["log_lambda"] if split is None else tp.shard(p["log_lambda"],
                                                         split)
    rg = torch.sigmoid(uw @ p["w_rec_gate"].float())
    ig = torch.sigmoid(uw @ p["w_input_gate"].float())
    log_a = -_RG_C * rg * _softplus(lam.float())
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6))
    return log_a, beta * ig * uf


def _doubling_scan(a, h, *, reverse: bool = False):
    """h_t = a_t h_{t-1} + h_t over dim 1 (from the last step down with
    ``reverse``: h_t = a_t h_{t+1} + h_t): a log-depth doubling scan in f32
    (ceil(log2 T) passes, 15 at T = 32768); pass s folds each (a, h) pair
    with the one 2^s steps earlier (later with ``reverse``).  No buffer is
    written in place: ``torch.func.linearize`` traces the scan, and its
    constant folding drops writes into a tensor whose result goes unused.
    Writing the passes in place would give the same bits."""
    T = h.shape[1]
    shift = 1
    while shift < T:
        pad = (0, 0, 0, shift) if reverse else (0, 0, shift, 0)
        part = (slice(None), slice(shift, None) if reverse
                else slice(None, -shift))
        h = h + a * F.pad(h[part], pad)
        if 2 * shift < T:
            a = a * F.pad(a[part], pad, value=1.0)
        shift *= 2
    return h


def _previous(h):
    """h_{t-1} along dim 1, 0 at t = 0."""
    return F.pad(h[:, :-1], (0, 0, 1, 0))


class _LinearScan(torch.autograd.Function):
    """h_t = a_t h_{t-1} + x_t from h_{-1} = 0, over dim 1 of (B, T, rg)
    f32 tensors, with hand-written derivatives.  Autograd through the
    doubling scan would save two (B, T, rg) tensors a pass (15 passes at
    T = 32768); the derivatives are the same scan instead:

    * backward: the cotangent runs the scan in reverse, lambda_t = g_t +
      a_{t+1} lambda_{t+1}; then dx = lambda and da_t = lambda_t h_{t-1};
    * jvp: the forward scan of da_t h_{t-1} + dx_t.

    It saves a and h alone.  Its derivatives are first-order only
    (``first_order_only``)."""

    @staticmethod
    def forward(a, x):
        h = _doubling_scan(a, x)
        return h.clone() if h is x else h            # T = 1

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, _ = inputs
        ctx.save_for_backward(a, output)
        ctx.save_for_forward(a, output)

    @staticmethod
    def jvp(ctx, d_a, d_x):
        (a, h, d_a, d_x), level = unwrap_one_level(ctx.saved_tensors
                                                   + (d_a, d_x))
        first_order_only((a, h, d_a, d_x), 0, "RG-LRU scan")
        with outside_transforms():
            drive = torch.zeros_like(h) if d_x is None else d_x
            if d_a is not None:
                drive = drive + d_a * _previous(h)
            d_h = _doubling_scan(a, drive)
        return rewrap(d_h, level)

    @staticmethod
    def backward(ctx, g):
        (a, h, g), level = unwrap_one_level(ctx.saved_tensors + (g,))
        first_order_only((a, h, g), 0, "RG-LRU scan")
        with outside_transforms():
            a_next = F.pad(a[:, 1:], (0, 0, 0, 1))
            lam = _doubling_scan(a_next, g, reverse=True)
            d_a = lam * _previous(h)
        return rewrap(d_a, level), rewrap(lam, level)


def rglru_scan(p, u, split=None):
    """RG-LRU over time, h_t = a_t h_{t-1} + x_t, u: (B,T,rg) (the rank's
    channels on a share, ``split``; the scan needs no collective).

    The reference's ``jax.lax.associative_scan`` becomes a log-depth
    doubling scan in f32 (``_LinearScan``, differentiated by hand).  It
    combines the same pairs in another tree than XLA's, so it agrees with
    the reference to f32 rounding, not bitwise.  The gates stay plain
    PyTorch under autograd."""
    log_a, x = _rglru_gates(p, u, split)
    return _LinearScan.apply(torch.exp(log_a), x).to(u.dtype)


def _unit_input(h, p, split):
    """(h entering the unit, ``tensor_parallel.enter``; the unit's
    ``conv_b``, or the rank's channels of it on a share)."""
    b = p["conv_b"] if split is None else tp.shard(p["conv_b"], split)
    return tp.enter(h, split), b


def rglru_block_apply(cfg, p, x, positions):
    h = L.norm_apply(cfg, p["ln1"], x)
    split = tp.split_of(p)
    h, conv_b = _unit_input(h, p, split)
    u = h @ p["w_x"].to(h.dtype)
    y = h @ p["w_y"].to(h.dtype)
    u = causal_conv1d(u, p["conv_w"], conv_b)
    r = rglru_scan(p, u, split)
    out = L.row_parallel(r * F.gelu(y, approximate="tanh"), p["w_out"], split)
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
    place.  On a mesh whose "model" splits the cache's channels
    (``tensor_parallel.cache_split``) the rank updates its channels:
    on a share of the unit (``split_of``, whose channels are the
    cache's: both are the contiguous rg/m blocks in model order) as the
    sequence forward computes them; on a unit held whole, its channels
    of the conv, the gates read the whole conv output (all-gathered),
    and its rows of ``w_out`` give a partial output summed over the
    model group."""
    h = L.norm_apply(cfg, p["ln1"], x)               # (B,1,d)
    split = tp.split_of(p)
    cs = split or tp.cache_split(cache, "state")
    h, conv_b = _unit_input(h, p, split)
    u = (h @ p["w_x"].to(h.dtype))[:, 0]
    y = (h @ p["w_y"].to(h.dtype))[:, 0]
    if split or cs is None:
        u, conv_buf = conv1d_step(u, cache["conv"], p["conv_w"], conv_b)
        log_a, x_in = _rglru_gates(p, u, split)
    else:
        u, conv_buf = conv1d_step(tp.shard(u, cs), cache["conv"],
                                  tp.shard(p["conv_w"], cs),
                                  tp.shard(p["conv_b"], cs))
        log_a, x_in = (tp.shard(t, cs) for t in _rglru_gates(
            p, tp.all_gather(u, cs, -1)))
        y = tp.shard(y, cs)
    state = torch.exp(log_a) * cache["state"] + x_in
    gated = state.to(h.dtype) * F.gelu(y, approximate="tanh")
    if cs is None:
        out = (gated @ p["w_out"].to(h.dtype))[:, None]
    else:
        out = L.row_parallel(gated[:, None], p["w_out"] if split else
                             tp.shard(p["w_out"], cs, dim=0), cs)
    x = x + out
    hh = L.norm_apply(cfg, p["ln2"], x)
    x = x + L.mlp_apply(cfg, p["mlp"], hh)
    cache["state"].copy_(state)
    cache["conv"].copy_(conv_buf)
    return x, cache


# ---------------------------------------------------------------------------
# xLSTM: mLSTM block (matrix memory, linear-attention-like)
# ---------------------------------------------------------------------------

def _mlstm_dims(cfg):
    inner = int(cfg.proj_factor * cfg.d_model)
    H = cfg.num_heads
    inner -= inner % H
    return inner, H, inner // H


def init_mlstm_block(cfg, init, *, lead=()):
    d = cfg.d_model
    inner, H, hd = _mlstm_dims(cfg)
    b_if = init.full((*lead, 2 * H), 3.0, cfg.pdtype)
    b_if[..., :H] = 0.0                       # input gates 0, forget gates 3
    return {
        "ln": L.init_norm(cfg, init, d, lead=lead),
        "w_up": L.dense_init(init, d, inner, cfg.pdtype, lead=lead),
        "w_gate": L.dense_init(init, d, inner, cfg.pdtype, lead=lead),
        "conv_w": init.normal((*lead, cfg.conv_kernel, inner), 0.1,
                              cfg.pdtype),
        "conv_b": init.full((*lead, inner), 0.0, cfg.pdtype),
        "w_q": L.dense_init(init, inner, inner, cfg.pdtype, lead=lead),
        "w_k": L.dense_init(init, inner, inner, cfg.pdtype, lead=lead),
        "w_v": L.dense_init(init, inner, inner, cfg.pdtype, lead=lead),
        "w_if": L.dense_init(init, inner, 2 * H, cfg.pdtype, scale=0.02,
                             lead=lead),
        "b_if": b_if,
        "w_down": L.dense_init(init, inner, d, cfg.pdtype, lead=lead),
    }


def _mlstm_qkvif(cfg, p, u, split=None):
    """u: (B,T,inner) conv output -> q,k,v (B,T,H,hd) in u's dtype,
    log_i/log_f (B,T,H) f32.  On a share of the heads (``split``; u the
    rank's inner/m channels) q, k and v are the rank's H/m heads of the
    whole u's projections, and the gates those heads' of the ranks'
    partial products summed (g), then entering the rank's heads through
    f (each rank reads another part of the sum)."""
    inner, H, hd = _mlstm_dims(cfg)
    B, T, _ = u.shape
    dt = u.dtype
    uw = u if split is None else tp.gather_from_model(u, split)
    q = (uw @ p["w_q"].to(dt)).reshape(B, T, -1, hd)
    k = (uw @ p["w_k"].to(dt)).reshape(B, T, -1, hd) / math.sqrt(hd)
    v = (uw @ p["w_v"].to(dt)).reshape(B, T, -1, hd)
    if split is None:
        gif = (u @ p["w_if"].to(dt) + p["b_if"].to(dt)).float()
        return q, k, v, gif[..., :H], F.logsigmoid(gif[..., H:])
    gif = tp.copy_to_model(tp.reduce_from_model(
        L.partial_matmul(u, p["w_if"]), split), split)
    gif = (gif.to(dt) + p["b_if"].to(dt)).float()
    log_i, log_f = (tp.shard(t, split) for t in (gif[..., :H], gif[..., H:]))
    return q, k, v, log_i, F.logsigmoid(log_f)


def _mlstm_step(carry, inp, cs=None):
    """Stabilised mLSTM recurrence, one step (the reference's, kept as the
    plain oracle of ``mlstm_chunkwise`` and run by decode).  State per
    head: C (hd,hd), n (hd), m ().  With ``cs`` (a decode cache's
    ``Split`` over "model") the carry is this rank's share of every
    head's state, C's value rows and n's key columns (m whole), stepped
    from every head's per-token q, k, v and gates: n.q, a sum over the
    key dim, is all-reduced over the model group and h's value rows are
    all-gathered whole."""
    C, n, m = carry
    q, k, v, log_i, log_f = inp
    m_new = torch.maximum(log_f + m, log_i)
    i = torch.exp(log_i - m_new)[..., None]                   # (B,H,1)
    f = torch.exp(log_f + m - m_new)[..., None]
    kn, vc, qn = (k, v, q) if cs is None else (tp.shard(k, cs),
                                                tp.shard(v, cs),
                                                tp.shard(q, cs))
    n_new = f * n + i * kn
    C_new = f[..., None] * C + i[..., None] * (vc[..., :, None]
                                               * k[..., None, :])
    dot = torch.sum(n_new * qn, -1)
    if cs is not None:
        dot = tp.all_reduce(dot, cs.group)
    h = torch.einsum("bhvk,bhk->bhv", C_new, q) / _max1(torch.abs(dot))[
        ..., None]
    if cs is not None:
        h = tp.all_gather(h, cs, -1)
    return (C_new, n_new, m_new), h


def mlstm_chunkwise(q, k, v, log_i, log_f, time_chunk: int = 64):
    """The mLSTM recurrence (``_mlstm_step`` from a zero state, m = -1e30)
    over a sequence in its exact chunkwise-parallel form.

    q, k, v: (B,T,H,hd); log_i, log_f: (B,T,H) f32 (``_mlstm_qkvif``'s).
    Returns the outputs h (B,T,H,hd) in q's dtype, computed in log_i's.

    Within a chunk, with F_t the chunk-local cumsum of log_f and
    g_s = log_i_s - F_s, the recurrence's own stabiliser is
    m_t = F_t + a_t, a_t = max(m_prev, cummax_{s<=t} g_s) (m_prev carried
    from the last chunk), and

        h_t = (e^{m_prev - a_t} C_prev q_t + sum_s D_ts (q_t.k_s) v_s)
              / max(|e^{m_prev - a_t} n_prev.q_t + sum_s D_ts q_t.k_s|, 1)

    with D_ts = exp(g_s - a_t) for s <= t (every exponent <= 0).  The
    (C, n, m) state is carried across chunk boundaries, scaled as the
    recurrence scales it.  Under autograd only the T / time_chunk boundary
    states and (B,H,c,c) blocks are saved, never a per-step (B,H,hd,hd)
    state; without autograd each chunk's temporaries are freed before the
    next.  ``time_chunk`` changes the memory, not the function (T need
    not divide by it)."""
    B, T, H, hd = q.shape
    acc = log_i.dtype
    C = q.new_zeros((B, H, hd, hd), dtype=acc)
    n = q.new_zeros((B, H, hd), dtype=acc)
    m = q.new_full((B, H), -1e30, dtype=acc)
    causal = torch.ones(time_chunk, time_chunk, dtype=torch.bool,
                        device=q.device).tril()
    outs = []
    for t0 in range(0, T, time_chunk):
        t1 = min(t0 + time_chunk, T)
        qc, kc, vc = (a[:, t0:t1].to(acc).transpose(1, 2)
                      for a in (q, k, v))                     # (B,H,c,hd)
        li = log_i[:, t0:t1].transpose(1, 2)                  # (B,H,c)
        Fc = torch.cumsum(log_f[:, t0:t1].transpose(1, 2), -1)
        g = li - Fc
        a = torch.maximum(torch.cummax(g, -1).values, m[..., None])
        c = t1 - t0
        expo = (g[..., None, :] - a[..., :, None]).masked_fill(
            ~causal[:c, :c], float("-inf"))
        S = (qc @ kc.transpose(-1, -2)) * torch.exp(expo)     # (B,H,c,c)
        decay = torch.exp(m[..., None] - a)                   # (B,H,c)
        num = S @ vc + decay[..., None] * (qc @ C.transpose(-1, -2))
        den = S.sum(-1) + decay * (qc @ n[..., None])[..., 0]
        outs.append((num / _max1(torch.abs(den))[..., None]).to(q.dtype))
        w = torch.exp(g - a[..., -1:])                        # (B,H,c)
        last = decay[..., -1]
        C = last[..., None, None] * C + (vc * w[..., None]).transpose(
            -1, -2) @ kc
        n = last[..., None] * n + (kc * w[..., None]).sum(-2)
        m = Fc[..., -1] + a[..., -1]
    return torch.cat(outs, 2).transpose(1, 2)


def mlstm_block_apply(cfg, p, x, positions, *, time_chunk: int = 64):
    """mLSTM over a sequence through ``mlstm_chunkwise`` (the reference
    runs ``_mlstm_step`` as a scan in rematted time chunks; the function
    is the same, ``time_chunk`` sets only the memory)."""
    h0 = L.norm_apply(cfg, p["ln"], x)
    split = tp.split_of(p)
    h0, conv_b = _unit_input(h0, p, split)
    B, T, _ = h0.shape
    u = h0 @ p["w_up"].to(h0.dtype)
    g = h0 @ p["w_gate"].to(h0.dtype)
    u = F.silu(causal_conv1d(u, p["conv_w"], conv_b))
    q, k, v, log_i, log_f = _mlstm_qkvif(cfg, p, u, split)
    hs = mlstm_chunkwise(q, k, v, log_i, log_f, time_chunk)
    hs = hs.reshape(B, T, -1).to(x.dtype)
    return x + L.row_parallel(hs * F.silu(g), p["w_down"], split), 0.0


# the value every decode cache leaf starts from, by leaf name (0 where it
# is absent): the stabiliser m of the xLSTM blocks starts at -1e30
CACHE_FILL = {"m": -1e30}


def init_mlstm_cache(cfg, batch, *, lead=(), device=None):
    inner, H, hd = _mlstm_dims(cfg)
    f32 = torch.float32
    return {"C": torch.zeros((*lead, batch, H, hd, hd), dtype=f32,
                             device=device),
            "n": torch.zeros((*lead, batch, H, hd), dtype=f32,
                             device=device),
            "m": torch.full((*lead, batch, H), CACHE_FILL["m"], dtype=f32,
                            device=device),
            "conv": torch.zeros((*lead, batch, cfg.conv_kernel - 1, inner),
                                dtype=cfg.cdtype, device=device)}


def mlstm_block_decode(cfg, p, x, cache, pos: int):
    """One token through ``_mlstm_step``; writes the new state and conv
    buffer into ``cache`` in place.

    On a mesh the cache's layout and the unit's differ: the cache holds
    C's value rows, n's key columns and the conv's channels over
    "model" (``launch.sharding.input_shardings``; m whole), the unit its
    heads (``split_of``).  The token's q, k, v and gates of the rank's
    heads are all-gathered (B H (3 hd + 2) numbers) and each rank steps
    its share of every head's state (``_mlstm_step`` with the cache's
    ``Split``); h comes back whole and the rank's heads enter
    ``w_down``'s rows.  A unit held whole with its conv's channels split
    runs the conv on its channels and all-gathers the conv output.  Only
    per-token vectors move, never the state."""
    hd = _mlstm_dims(cfg)[2]
    B = x.shape[0]
    split = tp.split_of(p)
    cs, conv_s = tp.cache_split(cache, "C"), tp.cache_split(cache, "conv")
    h0 = L.norm_apply(cfg, p["ln"], x)
    h0, conv_b = _unit_input(h0, p, split)
    u = (h0 @ p["w_up"].to(h0.dtype))[:, 0]
    g = (h0 @ p["w_gate"].to(h0.dtype))[:, 0]
    if split or conv_s is None:
        u, conv_buf = conv1d_step(u, cache["conv"], p["conv_w"], conv_b)
    else:
        u, conv_buf = conv1d_step(tp.shard(u, conv_s), cache["conv"],
                                  tp.shard(p["conv_w"], conv_s),
                                  tp.shard(p["conv_b"], conv_s))
        u = tp.all_gather(u, conv_s, -1)
    q, k, v, log_i, log_f = _mlstm_qkvif(cfg, p, F.silu(u)[:, None], split)
    inp = (q[:, 0].float(), k[:, 0].float(), v[:, 0].float(), log_i[:, 0],
           log_f[:, 0])
    m_prev, rows = tp.cache_rows(cache, "m", B)
    if split:
        vecs = torch.cat([*inp[:3], inp[3][..., None], inp[4][..., None]], -1)
        vecs = tp.all_gather(vecs, split, 1)
        inp = vecs.split([hd, hd, hd, 1, 1], -1)
        inp = (*inp[:3], inp[3][..., 0], inp[4][..., 0])
    (C, n, m), h = _mlstm_step((cache["C"], cache["n"], m_prev), inp, cs)
    if split:
        h = tp.shard(h, split, dim=1)
    h = h.reshape(B, -1).to(x.dtype)
    out = L.row_parallel((h * F.silu(g))[:, None], p["w_down"], split)
    for key, val in (("C", C), ("n", n), ("conv", conv_buf)):
        cache[key].copy_(val)
    tp.put_rows(cache, "m", m, rows)
    return x + out, cache


# ---------------------------------------------------------------------------
# xLSTM: sLSTM block (scalar memory, per-head recurrent)
# ---------------------------------------------------------------------------

def init_slstm_block(cfg, init, *, lead=()):
    d = cfg.d_model
    H = cfg.num_heads
    hd = d // H
    up = int(cfg.proj_factor * d)
    return {
        "ln": L.init_norm(cfg, init, d, lead=lead),
        "w_zifo": L.dense_init(init, d, 4 * d, cfg.pdtype, lead=lead),
        "b_zifo": init.full((*lead, 4 * d), 0.0, cfg.pdtype),
        # per-head recurrent matrices (4, H, hd_out, hd_in)
        "r_zifo": init.normal((*lead, 4, H, hd, hd), 1.0 / math.sqrt(hd),
                              cfg.pdtype),
        "w_up": L.dense_init(init, d, up, cfg.pdtype, lead=lead),
        "w_down": L.dense_init(init, up, d, cfg.pdtype, lead=lead),
    }


def _slstm_recurrent(r_zifo):
    """(4,H,hd,hd) [gate, head, out, in] -> (H, hd_in, 4*hd_out) f32, so
    that ``h @ R`` of a head-major h (H,B,hd) gives the four gates'
    recurrent pre-activations side by side."""
    g, H, hd, _ = r_zifo.shape
    return r_zifo.float().permute(1, 3, 0, 2).reshape(H, hd, g * hd)


def _slstm_step(R, carry, pre_x, rec=None, cs=None):
    """One sLSTM step, head-major: carry (c, n, h, m) each (H,B,hd) f32,
    pre_x (H,B,4*hd) f32 the input pre-activations (z, i, f, o), R from
    ``_slstm_recurrent``.  Returns the new carry and the step's
    pre-activations (H,B,4*hd).  Autograd never differentiates it: the
    sequence path runs ``_SLSTMScan``'s derivatives, decode none.

    On a mesh (decode): ``rec`` is every head's ``h @ R``, which the
    caller formed from the whole h (the carry's h is then not read), and
    ``cs`` the cache's ``Split`` over "model": c and n are this rank's hd
    channels of every head (m whole), and so are the new c, n and h."""
    c, n, h, m = carry
    pre = torch.baddbmm(pre_x, h, R) if rec is None else pre_x + rec
    zp, log_i, fp, op = pre.unflatten(-1, (4, -1)).unbind(-2)
    z = torch.tanh(zp)
    log_f = F.logsigmoid(fp)
    o = torch.sigmoid(op)
    a = log_f + m
    m_new = torch.maximum(a, log_i)
    i = torch.exp(log_i - m_new)
    f = torch.exp(a - m_new)
    if cs is not None:
        z, i, f, o = (tp.shard(t, cs) for t in (z, i, f, o))
    c_new = torch.addcmul(f * c, i, z)
    n_new = torch.addcmul(i, f, n)
    h_new = o * c_new / n_new.clamp(min=1.0)
    return (c_new, n_new, h_new, m_new), pre


def _slstm_zero(pre_x):
    """The zero state (c, n, h, m = -1e30) for inputs (..., H, B, 4*hd)."""
    zero = pre_x.new_zeros(pre_x.shape[-3:-1] + (pre_x.shape[-1] // 4,))
    return zero, zero, zero, torch.full_like(zero, -1e30)


class _ChunkGraph:
    """``chunk`` steps of ``step`` captured as one CUDA graph that reads
    static buffers: the constants, the carried state (updated in place by
    each replay) and a chunk of the per-step inputs; its per-step outputs
    land in ``ys``."""

    def __init__(self, step, consts, state, xs, n_ys, chunk, reverse):
        self.consts = [c.clone() for c in consts]
        self.state = [s.clone() for s in state]
        self.xs = [x[:chunk].clone() for x in xs]
        order = range(chunk - 1, -1, -1) if reverse else range(chunk)

        def body():
            carry, outs = tuple(self.state), [None] * chunk
            for i in order:
                carry, outs[i] = step(self.consts, carry,
                                      tuple(x[i] for x in self.xs))
            for static, new in zip(self.state, carry):
                static.copy_(new)
            return [torch.stack([o[k] for o in outs]) for k in range(n_ys)]

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            body()                              # warm-up before capture
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.ys = body()


_CHUNK_GRAPHS: OrderedDict = OrderedDict()
# a graph keeps its memory pool (a chunk of every step's intermediates)
# while it is cached: at most this many shapes, the least recently used
# one dropped first
_CHUNK_GRAPHS_MAX = 16


def _cached_graph(key, make):
    """``_CHUNK_GRAPHS[key]``, made by ``make()`` at its first use and
    marked most recently used."""
    g = _CHUNK_GRAPHS.pop(key, None)
    _CHUNK_GRAPHS[key] = make() if g is None else g
    while len(_CHUNK_GRAPHS) > _CHUNK_GRAPHS_MAX:
        _CHUNK_GRAPHS.popitem(last=False)
    return _CHUNK_GRAPHS[key]


def _scan(step, consts, state, xs, n_ys, *, reverse=False, chunk=64):
    """Runs ``state, ys_t = step(consts, state, xs_t)`` for t along dim 0
    of the tensors ``xs`` (from the end with ``reverse``); returns the
    last state and the ``n_ys`` outputs stacked over t.

    On the card every run of ``chunk`` steps replays one CUDA graph
    (``_ChunkGraph``), captured at the first call with these shapes: a
    recurrence step is about twenty small kernels, whose launches cost
    the host far more than they cost the card.  The remaining T % chunk
    steps, and every step off the card, run as a plain loop; both give
    the same bits.  The outputs are concatenated, never written into a
    buffer in place, so that ``torch.func.linearize`` can trace them."""
    T = xs[0].shape[0]
    full = T // chunk if xs[0].is_cuda and not wrapped(xs[0]) else 0
    graphed = (range(T - full * chunk, T) if reverse
               else range(full * chunk))
    pieces = []                                 # in the order they run
    if full:
        key = (step, n_ys, chunk, reverse) + tuple(
            (tuple(t.shape), t.dtype, t.device) for t in consts + state) \
            + tuple((tuple(x.shape[1:]), x.dtype) for x in xs)
        g = _cached_graph(key, lambda: _ChunkGraph(
            step, consts, state, xs, n_ys, chunk, reverse))
        for static, value in zip(g.consts + g.state, consts + state):
            static.copy_(value)
        starts = range(graphed.start, graphed.stop, chunk)
        for t0 in (reversed(starts) if reverse else starts):
            for static, x in zip(g.xs, xs):
                static.copy_(x[t0:t0 + chunk])
            g.graph.replay()
            pieces.append([y.clone() for y in g.ys])
        state = tuple(s.clone() for s in g.state)
    rest = (range(T - full * chunk - 1, -1, -1) if reverse
            else range(full * chunk, T))
    for t in rest:
        state, ys = step(consts, state, tuple(x[t] for x in xs))
        pieces.append([y[None] for y in ys])
    if reverse:
        pieces.reverse()
    return state, tuple(torch.cat([ys[k] for ys in pieces])
                        for k in range(n_ys))


def _tie_weight(x, y):
    """d max(x, y) / dx as JAX's maximum has it: 1, 0.5 at a tie, or 0."""
    return (x > y).to(x.dtype) + 0.5 * (x == y).to(x.dtype)


def _shift(x, first: float):
    """x_{t-1} along dim 0, ``first`` at t = 0."""
    return torch.cat([torch.full_like(x[:1], first), x[:-1]])


class _SLSTMScan(torch.autograd.Function):
    """The sLSTM over a sequence (``_slstm_step`` from the zero state) with
    hand-written forward- and reverse-mode derivatives.

    pre_x (T,H,B,4*hd), R (H,hd,4*hd) -> (hs, pre, cs, ns, ms), each
    (T,H,B,·); only hs is differentiable, the rest is what the derivatives
    read.  Autograd through the time loop records about 20 operations a
    step, and ``torch.func.jvp`` wraps each in a dual tensor: the
    curvature products then pay that per-operation cost T times a layer.
    The derivatives of the recurrence are linear recurrences in the
    tangents (or cotangents) whose coefficients depend only on the
    forward's values; those are computed for all steps at once
    (``_coefficients``), and the loop that remains carries four tangents
    in about a dozen operations a step.  At ties they split half and half,
    as JAX's maximum does (m_t = max(log_f + m, log_i); the normaliser
    max(n_t, 1) is exactly 1 at the first step).  All three loops run
    through ``_scan`` (CUDA graphs on the card); the jvp first removes
    ``torch.func.jvp``'s wrapper from its inputs (``unwrap_one_level``)
    and puts its result back at that level.  The derivatives are
    first-order only (``first_order_only``): ``torch.func.jvp``,
    ``vjp``, ``grad``, ``linearize`` and ``torch.autograd.grad`` run them,
    and a derivative of them raises."""

    @staticmethod
    def forward(pre_x, R):
        return _scan(_slstm_record_step, (R,), _slstm_zero(pre_x), (pre_x,),
                     5)[1]

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, R = inputs
        ctx.mark_non_differentiable(*output[1:])
        ctx.save_for_backward(R, *output)
        ctx.save_for_forward(R, *output)

    @staticmethod
    def _coefficients(hs, pre, cs, ns, ms):
        """Per step (T,H,B,hd), in the order ``_slstm_reverse_step`` reads
        them: with u = a' - log_i' (a = log_f + m_prev), m_t' = a' - wl u,
        c_t' = f c' + A_c u + B_z z', n_t' = f n' + A_n u and h_t' = K_o o'
        + Q c_t' - S n_t'."""
        zp, ip, fp, op = pre.unflatten(-1, (4, -1)).unbind(-2)
        z, o = torch.tanh(zp), torch.sigmoid(op)
        a = F.logsigmoid(fp) + _shift(ms, -1e30)
        i, f = torch.exp(ip - ms), torch.exp(a - ms)
        wa = _tie_weight(a, ip)
        wl = 1.0 - wa
        d = ns.clamp(min=1.0)
        return {"Q": o / d, "S": o * cs * _tie_weight(ns, 1.0) / (d * d),
                "A_c": f * wl * _shift(cs, 0.0) - i * wa * z,
                "A_n": f * wl * _shift(ns, 0.0) - i * wa, "wl": wl,
                "B_z": i * (1.0 - z * z), "s_lf": torch.sigmoid(-fp),
                "K_o": o * (1.0 - o) * cs / d, "f": f}

    @staticmethod
    def jvp(ctx, d_pre_x, d_R):
        wrapped_hs = ctx.saved_tensors[1]
        (R, hs, pre, cs, ns, ms, d_pre_x, d_R), level = unwrap_one_level(
            ctx.saved_tensors + (d_pre_x, d_R))
        first_order_only((R, hs, pre, cs, ns, ms, d_pre_x, d_R), 0, "sLSTM")
        k = _SLSTMScan._coefficients(hs, pre, cs, ns, ms)
        drive = torch.zeros_like(pre) if d_pre_x is None else d_pre_x
        if d_R is not None:
            drive = drive + torch.einsum("thbk,hkg->thbg", _shift(hs, 0.0),
                                         d_R)
        zero = torch.zeros_like(hs[0])
        d_hs = _scan(_slstm_tangent_step, (R,), (zero,) * 4,
                     (drive,) + tuple(k.values()), 1)[1][0]
        if level is not None:                 # back to the jvp's level
            d_hs = torch.zeros_like(wrapped_hs) + d_hs
        return (d_hs,) + (None,) * 4

    @staticmethod
    def backward(ctx, g_hs, *_):
        R, hs, pre, cs, ns, ms = ctx.saved_tensors
        first_order_only((R, hs, pre, cs, ns, ms, g_hs), 1, "sLSTM")
        k = _SLSTMScan._coefficients(hs, pre, cs, ns, ms)
        zero = torch.zeros_like(hs[0])
        state = (zero, zero, zero, zero, torch.zeros_like(pre[0]))
        g_pre = _scan(_slstm_reverse_step, (R.transpose(1, 2),), state,
                      (g_hs,) + tuple(k.values()), 1, reverse=True)[1][0]
        return g_pre, torch.einsum("thbk,thbg->hkg", _shift(hs, 0.0), g_pre)


def _slstm_record_step(consts, carry, xs):
    """``_scan`` step of ``_SLSTMScan.forward``: outputs h, the
    pre-activations, c, n and m."""
    carry, pre = _slstm_step(consts[0], carry, xs[0])
    c, n, h, m = carry
    return carry, (h, pre, c, n, m)


def _slstm_h_step(consts, carry, xs):
    """``_scan`` step of the sLSTM without autograd: outputs h alone."""
    carry, _ = _slstm_step(consts[0], carry, xs[0])
    return carry, (carry[2],)


def _slstm_tangent_step(consts, carry, xs):
    """``_scan`` step of ``_SLSTMScan.jvp``: the tangents of (c, n, h, m)
    carried, h's out."""
    (R,) = consts
    dc, dn, dh, dm = carry
    drive, Q, S, A_c, A_n, wl, B_z, s_lf, K_o, f = xs
    dz, di, df, do = torch.baddbmm(drive, dh, R).unflatten(
        -1, (4, -1)).unbind(-2)
    da = torch.addcmul(dm, s_lf, df)
    u = da - di
    dm = torch.addcmul(da, wl, u, value=-1.0)
    dc = torch.addcmul(torch.addcmul(f * dc, A_c, u), B_z, dz)
    dn = torch.addcmul(f * dn, A_n, u)
    dh = torch.addcmul(torch.addcmul(K_o * do, Q, dc), S, dn, value=-1.0)
    return (dc, dn, dh, dm), (dh,)


def _slstm_reverse_step(consts, carry, xs):
    """``_scan`` step of ``_SLSTMScan.backward``, from the last step: the
    cotangents of (c, n, m) and of the next step's pre-activations
    carried, those of this step's pre-activations out."""
    (Rt,) = consts
    gc, gn, gm, f_next, g_next = carry
    g_h, Q, S, A_c, A_n, wl, B_z, s_lf, K_o, f = xs
    gh = torch.baddbmm(g_h, g_next, Rt)
    gc = torch.addcmul(f_next * gc, Q, gh)
    gn = torch.addcmul(f_next * gn, S, gh, value=-1.0)
    gu = torch.addcmul(torch.addcmul(A_c * gc, A_n, gn), wl, gm, value=-1.0)
    gm = gm + gu
    g_pre = torch.stack([B_z * gc, -gu, s_lf * gm, K_o * gh], -2).flatten(-2)
    return (gc, gn, gm, f, g_pre), (g_pre,)


def _slstm_inputs(cfg, p, x, split=None, heads=True):
    """The input pre-activations (z, i, f, o) of x (B,T,d) in f32, laid
    out head-major for ``_slstm_step``: (T,H,B,4*hd).  On a share of the
    heads (``split``) the rank's columns of ``w_zifo`` (gate-major: z, i,
    f, o of every head) are gathered whole and its H/m heads taken:
    (T,H/m,B,4*hd), or with ``heads=False`` every head's.  The normed x
    enters the unit (``tensor_parallel.enter``), so T is whole."""
    H = cfg.num_heads
    h0 = tp.enter(L.norm_apply(cfg, p["ln"], x), split)
    B, T, d = h0.shape
    b = p["b_zifo"] if split is None else tp.shard(p["b_zifo"], split)
    wx = h0 @ p["w_zifo"].to(h0.dtype) + b.to(h0.dtype)
    if split is not None:
        wx = tp.gather_from_model(wx, split)
    wx = wx.float().reshape(B, T, 4, H, d // H)
    if split is not None and heads:
        wx = tp.shard(wx, split, dim=3)
    return wx.permute(1, 3, 0, 2, 4).reshape(T, wx.shape[3], B, 4 * (d // H))


def _slstm_out(p, hs, x, split=None):
    """hs (B,T,d) in x's dtype (the rank's heads' channels on a share,
    ``split``, gathered whole for ``w_up``'s columns) -> the block's
    output x + MLP(hs)."""
    if split is not None:
        hs = tp.gather_from_model(hs, split)
    up = F.gelu(hs @ p["w_up"].to(x.dtype), approximate="tanh")
    return x + L.row_parallel(up, p["w_down"], split)


def slstm_block_apply(cfg, p, x, positions):
    """The sLSTM over a sequence: h feeds back through ``r_zifo``, so it
    stays a time loop of ``_slstm_step``; ``r_zifo`` is cast to f32 once,
    not at every step.  Under autograd (and ``torch.func``) the loop runs
    in ``_SLSTMScan``, which saves (T,H,B,·)-sized states and
    pre-activations (no recompute) and differentiates by hand; without
    it, a plain loop that keeps only h."""
    split = tp.split_of(p)
    wx = _slstm_inputs(cfg, p, x, split)
    T, _, B, _ = wx.shape
    R = _slstm_recurrent(p["r_zifo"])
    if torch.is_grad_enabled():
        hs = _SLSTMScan.apply(wx, R)[0]
    else:
        hs = _scan(_slstm_h_step, (R,), _slstm_zero(wx), (wx,), 1)[1][0]
    hs = hs.permute(2, 0, 1, 3).reshape(B, T, -1)
    return _slstm_out(p, hs.to(x.dtype), x, split), 0.0


def init_slstm_cache(cfg, batch, *, lead=(), device=None):
    H = cfg.num_heads
    shape = (*lead, batch, H, cfg.d_model // H)
    return {key: torch.full(shape, val, dtype=torch.float32, device=device)
            for key, val in (("c", 0.0), ("n", 0.0), ("h", 0.0),
                             ("m", CACHE_FILL["m"]))}


def slstm_block_decode(cfg, p, x, cache, pos: int):
    """One token; writes the new (c, n, h, m) into ``cache`` in place (its
    tensors keep the reference's (B,H,hd) layout).

    On a mesh the cache holds c, n and h split over hd ("model"; m whole)
    and the unit its heads (``split_of``).  The recurrence ``h @ R`` needs
    each head's whole h: h is all-gathered (B H hd numbers), each rank
    multiplies its heads' R, and the products are all-gathered by head,
    so every rank has every head's pre-activations; the rank then steps m
    whole and its channels of c, n and h, and the new h is all-gathered
    whole for the block's output (the rank's heads entering ``w_up``'s
    gather, as in the sequence forward)."""
    B, _, d = x.shape
    split = tp.split_of(p)
    cs = tp.cache_split(cache, "c")
    m_prev, rows = tp.cache_rows(cache, "m", B)
    carry = tuple(cache[key].transpose(0, 1) for key in "cnh") + (
        m_prev.transpose(0, 1),)
    R = _slstm_recurrent(p["r_zifo"])
    if split is None and cs is None:
        new, _ = _slstm_step(R, carry, _slstm_inputs(cfg, p, x)[0])
    else:
        h = carry[2] if cs is None else tp.all_gather(
            cache["h"], cs, -1).transpose(0, 1)               # (H,B,hd)
        rec = (tp.all_gather(torch.bmm(tp.shard(h, split, dim=0), R), split,
                             0) if split else torch.bmm(h, R))
        new, _ = _slstm_step(R, carry, _slstm_inputs(cfg, p, x, split,
                                                     heads=False)[0],
                             rec=rec, cs=cs)
    for key, val in zip("cnh", new):
        cache[key].copy_(val.transpose(0, 1))
    tp.put_rows(cache, "m", new[3].transpose(0, 1), rows)
    h_new = new[2] if cs is None else tp.all_gather(new[2], cs, -1)
    hs = h_new.transpose(0, 1).reshape(B, 1, d).to(x.dtype)
    if split:
        hs = tp.shard(hs, split)
    return _slstm_out(p, hs, x, split), cache


# ---------------------------------------------------------------------------
# Dispatch tables
# ---------------------------------------------------------------------------

def init_block(cfg, init, kind, *, lead=()):
    if _attn_kind(kind):
        return init_attention_block(cfg, init, kind, lead=lead)
    if kind == "rglru":
        return init_rglru_block(cfg, init, lead=lead)
    if kind == "mlstm":
        return init_mlstm_block(cfg, init, lead=lead)
    if kind == "slstm":
        return init_slstm_block(cfg, init, lead=lead)
    raise ValueError(kind)


def block_apply(cfg, kind, p, x, positions):
    if _attn_kind(kind):
        return attention_block_apply(cfg, kind, p, x, positions)
    if kind == "rglru":
        return rglru_block_apply(cfg, p, x, positions)
    if kind == "mlstm":
        return mlstm_block_apply(cfg, p, x, positions)
    if kind == "slstm":
        return slstm_block_apply(cfg, p, x, positions)
    raise ValueError(kind)


def init_block_cache(cfg, kind, batch, cache_len, *, lead=(),
                     long_mode=False, device=None):
    if _attn_kind(kind):
        return init_attention_cache(cfg, kind, batch, cache_len, lead=lead,
                                    long_mode=long_mode, device=device)
    if kind == "rglru":
        return init_rglru_cache(cfg, batch, lead=lead, device=device)
    if kind == "mlstm":
        return init_mlstm_cache(cfg, batch, lead=lead, device=device)
    if kind == "slstm":
        return init_slstm_cache(cfg, batch, lead=lead, device=device)
    raise ValueError(kind)


def block_decode(cfg, kind, p, x, cache, pos: int, *, long_mode=False):
    if _attn_kind(kind):
        return attention_block_decode(cfg, kind, p, x, cache, pos,
                                      long_mode=long_mode)
    if kind == "rglru":
        return rglru_block_decode(cfg, p, x, cache, pos)
    if kind == "mlstm":
        return mlstm_block_decode(cfg, p, x, cache, pos)
    if kind == "slstm":
        return slstm_block_decode(cfg, p, x, cache, pos)
    raise ValueError(kind)
