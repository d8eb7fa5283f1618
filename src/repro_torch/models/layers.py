"""Core neural-net layers of the language models.

Port of ``repro.models.layers`` for the ported archs (the dense ``attn``
archs, the MoE archs, recurrentgemma-9b, whisper-base): initialisers,
RMSNorm and LayerNorm, RoPE (full or partial), attention projections
(RoPE optional, q/k/v biases and q/k norms when the config asks for
them), causal, sliding-window, cross and decode attention, the gated
(GeGLU, SwiGLU) and plain (GELU, ReLU) MLPs, the mixture-of-experts FFN
in its two forms (the dense one-hot combine and the capacity dispatch),
embedding and the untied or tied LM head.  Parameters are dicts of
tensors with the reference's leaf names and layouts (``x @ w``, ``w`` of
shape (d_in, d_out)); a matrix is cast to the activations' dtype at each
use, as the reference does (the MoE casts its expert matrices once a
call).  On a share of a batch split over ranks (``launch.fsdp.
batch_group``) both MoE forms' load-balance aux, and the dispatch's
capacity and drops, are the global batch's.

Under tensor-parallel compute (``launch.tensor_parallel``) the attention
projections, the MLP, both MoE forms, the embedding and the head get
this rank's share of their leaves and compute its share of the heads,
FFN columns, experts or vocabulary: each reads whether its unit is
split off the unit's leaves (``tensor_parallel.split_of``: the step
decided it), and puts ``tensor_parallel.enter`` at its entry and
``leave`` at its exit (f and g; with sequence-parallel activations the
all-gather and the reduce-scatter over T, or on a unit computed whole
the all-gather and this rank's slice).  Head counts come from the
projections' shapes, so a share's heads are counted as they are.  A
rank's partial output (``wo``'s and ``w_out``'s rows, its experts'
share of the combine) is summed in f32 and rounded to the compute dtype
once, after the sum, as one device's GEMM rounds its f32 accumulation
once (``partial_matmul``: on the card a GEMM of the compute dtype's
operands with an f32 result).

``windowed_attention`` goes through ``kernels.swa_attention``: on a CUDA
tensor that is the hand-written kernel, on a CPU tensor its plain
version.  ``causal_attention``, ``cross_attention``,
``decode_attention`` and the MoE FFN are plain PyTorch, as the
reference's are jnp (the reference has no Pallas kernel for them).
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.kernels.swa_attention import swa_attention
from repro_torch.launch import fsdp
from repro_torch.launch import tensor_parallel as tp

NEG = -1e30


# ---------------------------------------------------------------------------
# Initialisers
# ---------------------------------------------------------------------------

class Init:
    """Draws parameters on one device from one ``torch.Generator`` on
    that device.  ``Init("meta")`` (no generator) builds the same tree of
    shapes and dtypes without allocating anything."""

    def __init__(self, device, gen: Optional[torch.Generator] = None):
        self.device = torch.device(device)
        self.gen = gen

    def normal(self, shape, scale: float, dtype):
        w = torch.randn(*shape, generator=self.gen, device=self.device)
        return w.mul_(scale).to(dtype)

    def full(self, shape, value: float, dtype):
        return torch.full(tuple(shape), value, dtype=dtype,
                          device=self.device)


def dense_init(init: Init, d_in: int, d_out: int, dtype,
               scale: Optional[float] = None, *, lead=()):
    """N(0, scale^2) of shape (*lead, d_in, d_out), default scale
    1/sqrt(d_in); ``lead`` stacks independent draws (the reference's
    vmap over periods)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return init.normal((*lead, d_in, d_out), scale, dtype)


def embed_init(init: Init, vocab: int, d: int, dtype):
    return init.normal((vocab, d), 0.02, dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(cfg, init: Init, d: int, *, lead=()):
    p = {"scale": init.full((*lead, d), 1.0, cfg.pdtype)}
    if cfg.norm == "layernorm":
        p["bias"] = init.full((*lead, d), 0.0, cfg.pdtype)
    return p


def norm_apply(cfg, p, x):
    """RMSNorm, or LayerNorm (mean taken off first, then a bias), in f32;
    output in x's dtype."""
    dt = x.dtype
    x = x.float()
    if cfg.norm == "layernorm":
        x = x - x.mean(dim=-1, keepdim=True)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + 1e-6) * p["scale"].float()
    if "bias" in p:
        x = x + p["bias"].float()
    return x.to(dt)


def _rms(x, eps: float = 1e-6):
    """The reference's q/k norm without its scale: the mean of squares in
    f32, its rsqrt cast to x's dtype and multiplied in x's dtype (this
    order keeps bf16 results the reference's)."""
    ms = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    return x * torch.rsqrt(ms + eps).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x, positions, theta: float, rotary_pct: float = 1.0):
    """Apply rotary embeddings.  x: (..., T, H, hd), positions: (..., T)."""
    hd = x.shape[-1]
    rot = int(hd * rotary_pct)
    rot -= rot % 2
    if rot == 0:
        return x
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    half = rot // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs                     # (..., T, half)
    ang = ang[..., None, :]                                        # broadcast over heads
    cos, sin = torch.cos(ang).to(x.dtype), torch.sin(ang).to(x.dtype)
    x1, x2 = x_rot[..., :half], x_rot[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    if x_pass.shape[-1]:
        out = torch.cat([out, x_pass], dim=-1)
    return out


# ---------------------------------------------------------------------------
# Attention projections
# ---------------------------------------------------------------------------

def init_attention(cfg, init: Init, *, lead=()):
    d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    p = {
        "wq": dense_init(init, d, H * hd, cfg.pdtype, lead=lead),
        "wk": dense_init(init, d, K * hd, cfg.pdtype, lead=lead),
        "wv": dense_init(init, d, K * hd, cfg.pdtype, lead=lead),
        "wo": dense_init(init, H * hd, d, cfg.pdtype, lead=lead),
    }
    if cfg.qkv_bias:
        p["bq"] = init.full((*lead, H * hd), 0.0, cfg.pdtype)
        p["bk"] = init.full((*lead, K * hd), 0.0, cfg.pdtype)
        p["bv"] = init.full((*lead, K * hd), 0.0, cfg.pdtype)
    if cfg.qk_norm:
        p["q_norm"] = init.full((*lead, hd), 1.0, cfg.pdtype)
        p["k_norm"] = init.full((*lead, hd), 1.0, cfg.pdtype)
    return p


def qkv_project(cfg, p, x, positions, *, apply_rope=True, local_kv=True):
    """x: (B, T, d) -> q (B,T,H,hd), k/v (B,T,K,hd): the biases added
    after each matmul and the q/k norms applied per head when ``p`` has
    them, then RoPE on q and k unless ``apply_rope`` is False.  H and K
    are the projections' head counts; x enters the unit
    (``tensor_parallel.enter``: on a share of the query heads through f,
    and with the stream split over T gathered whole), and on a share k/v
    are the kv heads those queries read (``tensor_parallel.local_kv``),
    or with ``local_kv=False`` the kv projections' own heads (all K when
    the unit holds them whole)."""
    hd = cfg.resolved_head_dim
    split = tp.split_of(p)
    x = tp.enter(x, split)
    B, T, _ = x.shape
    dt = x.dtype
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    H, K = q.shape[-1] // hd, k.shape[-1] // hd
    q = q.reshape(B, T, H, hd)
    k = k.reshape(B, T, K, hd)
    v = v.reshape(B, T, K, hd)
    if split and "wk" in p.whole and local_kv:
        k, v = tp.local_kv(k, v, split, cfg.num_heads)
    if "q_norm" in p:
        q = _rms(q) * p["q_norm"].to(dt)
        k = _rms(k) * p["k_norm"].to(dt)
    if apply_rope:
        q = rope(q, positions, cfg.rope_theta, cfg.rotary_pct)
        k = rope(k, positions, cfg.rope_theta, cfg.rotary_pct)
    return q, k, v


def _mm_f32(a, b):
    """a @ b of two operands of one dtype, a (..., k) and b (k, n), or
    a (E, M, k) and b (E, k, n), accumulated and returned in f32: on a
    CUDA tensor one GEMM of the operands' dtype with an f32 result
    (``torch.mm``/``bmm``'s ``out_dtype``, so bf16 runs on the tensor
    cores), else the f32 upcast's GEMM, which forms the same products
    and sums."""
    if not a.is_cuda:
        return a.float() @ b.float()
    if b.dim() == 3:
        return torch.bmm(a, b, out_dtype=torch.float32)
    out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
    return out.reshape(*a.shape[:-1], b.shape[-1])


class _PartialMatmul(torch.autograd.Function):
    """``_mm_f32`` under autograd and ``torch.func``: the cotangent, the
    upcast of compute-dtype values (the sum is rounded to that dtype
    right after), is taken in the operands' dtype, and each gradient is
    rounded to it once, as the upcast's chain would; the jvp sums both
    products in f32."""

    @staticmethod
    def forward(x, w):
        return _mm_f32(x, w)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)
        ctx.save_for_forward(*inputs)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        gx = _mm_f32(g, w.transpose(-1, -2)).to(x.dtype)
        if w.dim() == 3:
            gw = _mm_f32(x.transpose(-1, -2), g)
        else:
            gw = _mm_f32(x.reshape(-1, x.shape[-1]).T,
                         g.reshape(-1, g.shape[-1]))
        return gx, gw.to(w.dtype)

    @staticmethod
    def jvp(ctx, tx, tw):
        x, w = ctx.saved_tensors
        out = _mm_f32(tx, w) if tx is not None else 0.0
        return out + _mm_f32(x, tw) if tw is not None else out


def partial_matmul(x, w):
    """x @ w of a rank's share of the contracted dim, the product of the
    compute dtype's values accumulated and returned in f32: the ranks'
    partial sums are added before the one rounding to the compute
    dtype.  ``w`` (k, n), or (E, k, n) against x (E, M, k)."""
    w = w.to(x.dtype)
    if x.dtype == torch.float32:
        return x @ w
    return _PartialMatmul.apply(x, w)


def row_parallel(x, w, split):
    """x @ w, a unit's last product, leaving it (``tensor_parallel.
    leave``); on a share of the rows of ``w`` (``split``, a
    ``launch.fsdp.Split``, or None) the ranks' partial products summed
    in f32, then rounded to x's dtype once."""
    if not split:
        return tp.leave(x @ w.to(x.dtype), None, x.dtype)
    return tp.leave(partial_matmul(x, w), split, x.dtype)


def out_project(cfg, p, ctx):
    """ctx (B, T, H, hd) @ wo; on a share of the heads, its rows of
    ``wo`` (``row_parallel``)."""
    B, T, H, hd = ctx.shape
    return row_parallel(ctx.reshape(B, T, H * hd), p["wo"], tp.split_of(p))


# ---------------------------------------------------------------------------
# Attention cores
# ---------------------------------------------------------------------------

def repeat_kv(k, H: int):
    """GQA -> MHA: repeat the kv heads of (B, S, K, hd) to H (a copy).
    The attention cores below read the kv head of each query head
    instead; this is for callers that want the MHA layout."""
    K = k.shape[2]
    if K == H:
        return k
    return torch.repeat_interleave(k, H // K, dim=2)


def causal_attention(q, k, v, *, q_chunk=512, kv_chunk=1024, q_offset=0):
    """Chunked online-softmax causal attention, the reference's loop.

    q: (B,T,H,hd), k/v: (B,S,K,hd) with H = K*G; ``q_offset`` is the
    absolute position of q[0] relative to k[0].  T must split into
    chunks of min(q_chunk, T) and S into chunks of min(kv_chunk, S), as
    in the reference.  Scores and the running (acc, max, sum) in f32, the
    kv tiles taken in order (the first tile holds key 0, so every row's
    max is finite from then on).  Returns (B,T,H,hd) in q's dtype.
    """
    B, T, H, hd = q.shape
    S = k.shape[1]
    k = repeat_kv(k, H).float()
    v = repeat_kv(v, H).float()
    qc, kc = min(q_chunk, T), min(kv_chunk, S)
    if T % qc or S % kc:
        raise ValueError(f"causal_attention: T={T} and S={S} must split "
                         f"into chunks of {qc} and {kc}")
    scale = 1.0 / math.sqrt(hd)
    outs = []
    for qi in range(T // qc):
        qb = q[:, qi * qc:(qi + 1) * qc].float()
        qpos = q_offset + qi * qc + torch.arange(qc, device=q.device)
        acc = torch.zeros(B, H, qc, hd, dtype=torch.float32, device=q.device)
        m = torch.full((B, H, qc), NEG, dtype=torch.float32, device=q.device)
        l = torch.zeros(B, H, qc, dtype=torch.float32, device=q.device)
        for kj in range(S // kc):
            kb = k[:, kj * kc:(kj + 1) * kc]
            vb = v[:, kj * kc:(kj + 1) * kc]
            kpos = kj * kc + torch.arange(kc, device=q.device)
            s = torch.einsum("bqhd,bshd->bhqs", qb, kb) * scale
            s = torch.where(qpos[:, None] >= kpos[None, :], s, NEG)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bhqs,bshd->bhqd",
                                                       p, vb)
            m = m_new
        outs.append((acc / l[..., None].clamp(min=1e-30)).transpose(1, 2))
    return torch.cat(outs, dim=1).to(q.dtype)


def cross_attention(q, k, v):
    """Full (non-causal) attention of q: (B,T,H,hd) over a memory k/v:
    (B,S,K,hd); scores, softmax and P.V in f32, as the reference's
    ``preferred_element_type=f32`` einsums.  Returns q's dtype."""
    B, T, H, hd = q.shape
    K = k.shape[2]
    qb = q.reshape(B, T, K, H // K, hd).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qb, k.float()) \
        * (1.0 / math.sqrt(hd))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(B, T, H, hd).to(q.dtype)


def windowed_attention(q, k, v, window: int, *, q_chunk=512, q_offset=0):
    """Sliding-window causal attention: token t attends (t-window-1, t].

    q: (B,T,H,hd), k/v: (B,S,K,hd) -> (B,T,H,hd) in q's dtype.  On a CUDA
    tensor the hand-written kernel (``kernels.swa_attention``; forward
    only: it raises when autograd would record it), on a CPU tensor its
    plain version, chunked over ``q_chunk`` queries as the reference's jnp
    path is."""
    return swa_attention(q, k, v, window, q_chunk=q_chunk,
                         q_offset=q_offset)


def decode_attention(q, k_cache, v_cache, valid_len, slots=None):
    """Single-token attention against a cache.

    q: (B,1,H,hd); k/v_cache: (B,S,K,hd); valid_len: an int or (B,)
    number of valid cache positions (including the newly-written token).
    Scores, softmax and P.V in f32, as the reference's
    ``preferred_element_type=f32`` einsums.

    ``slots`` (a ``launch.fsdp.Split``): the cache is this rank's share
    of the slots, slots ``[index S, (index + 1) S)`` of the whole, and
    ``valid_len`` counts the whole's.  Each rank scores its own slots,
    masked by their global positions, and the ranks' partial softmaxes
    combine in f32 over ``slots.group`` (flash decoding): an all-reduce
    max of the row maxima, then one all-reduce sum of the rescaled P.V
    and denominators.  No collective moves a cache.
    """
    B, _, H, hd = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    qb = q.reshape(B, 1, K, G, hd).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qb, k_cache.float()) \
        * (1.0 / math.sqrt(hd))                                   # (B,K,G,1,S)
    pos = torch.arange(S, device=q.device)
    if slots is not None:
        pos = pos + slots.index * S
    if isinstance(valid_len, torch.Tensor):
        valid = pos[None] < valid_len.reshape(-1, 1)
    else:
        valid = (pos < valid_len)[None]
    s = torch.where(valid[:, None, None, None, :], s, NEG)
    if slots is None:
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bkgqs,bskd->bqkgd", p, v_cache.float())
        return out.reshape(B, 1, H, hd).to(q.dtype)
    top = tp.all_reduce(s.amax(-1, keepdim=True), slots.group,
                        op=dist.ReduceOp.MAX)
    e = torch.exp(s - top)
    pv = torch.einsum("bkgqs,bskd->bqkgd", e, v_cache.float())
    den = e.sum(-1).permute(0, 3, 1, 2)                           # (B,1,K,G)
    both = tp.all_reduce(torch.cat([pv.reshape(B, -1), den.reshape(B, -1)],
                                   -1), slots.group)
    pv, den = both.split([H * hd, H], -1)
    out = pv.reshape(B, 1, H, hd) / den.reshape(B, 1, H, 1)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------

def _act(name: str, x):
    """The reference's activations; ``jax.nn.gelu`` defaults to the tanh
    approximation (the exact GELU differs from it by up to 5e-4)."""
    if name == "swiglu":
        return F.silu(x)
    if name in ("geglu", "gelu"):
        return F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu(x)
    if name == "sigmoid":
        return torch.sigmoid(x)
    raise ValueError(name)


def is_gated(activation: str) -> bool:
    return activation in ("swiglu", "geglu")


def init_mlp(cfg, init: Init, d_ff: Optional[int] = None, *, lead=()):
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    p = {"w_in": dense_init(init, d, ff, cfg.pdtype, lead=lead),
         "w_out": dense_init(init, ff, d, cfg.pdtype, lead=lead)}
    if is_gated(cfg.activation):
        p["w_gate"] = dense_init(init, d, ff, cfg.pdtype, lead=lead)
    return p


def mlp_apply(cfg, p, x):
    """Gated: act(x w_gate) * (x w_in); plain: act(x w_in); then w_out.
    On a share of the columns of ``w_in`` (and the rows of ``w_out``)
    between ``tensor_parallel.enter`` and ``leave``, the partial outputs
    summed in f32."""
    split = tp.split_of(p)
    x = tp.enter(x, split)
    dt = x.dtype
    h = x @ p["w_in"].to(dt)
    if "w_gate" in p:
        h = _act(cfg.activation, x @ p["w_gate"].to(dt)) * h
    else:
        h = _act(cfg.activation, h)
    return row_parallel(h, p["w_out"], split)


# ---------------------------------------------------------------------------
# Mixture of experts: the dense one-hot combine and the capacity dispatch
# ---------------------------------------------------------------------------

def init_moe(cfg, init: Init, *, lead=()):
    """``router`` (d, E) f32 at scale 0.02; ``w_in``/``w_gate`` (E, d, ff)
    at 1/sqrt(d) and ``w_out`` (E, ff, d) at 1/sqrt(ff) in ``pdtype``
    (``w_gate`` only for a gated activation); ``lead`` stacks them."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {"router": dense_init(init, d, E, torch.float32, scale=0.02,
                              lead=lead),
         "w_in": init.normal((*lead, E, d, ff), 1.0 / math.sqrt(d),
                             cfg.pdtype),
         "w_out": init.normal((*lead, E, ff, d), 1.0 / math.sqrt(ff),
                              cfg.pdtype)}
    if is_gated(cfg.activation):
        p["w_gate"] = init.normal((*lead, E, d, ff), 1.0 / math.sqrt(d),
                                  cfg.pdtype)
    return p


def _route(cfg, p, x):
    """Router probabilities (..., E) in f32 and the top-k weights,
    renormalised to sum to 1, with their expert indices (..., k)."""
    probs = torch.softmax(x.float() @ p["router"].float(), dim=-1)
    top_w, top_ix = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp(min=1e-9)
    return probs, top_w, top_ix


def _expert_matrices(p, dt):
    """The expert matrices cast to the compute dtype, once per call."""
    return {k: p[k].to(dt) for k in ("w_in", "w_gate", "w_out") if k in p}


def moe_apply(cfg, p, x, *, t_chunk: int = 2048):
    """Top-k MoE FFN with the dense one-hot combine: every token runs all
    E experts and the combine weights (B, T, E), zero off its top k, sum
    them.  Returns (out (B, T, d) in x's dtype, the switch load-balance
    aux E·Σ f·P with f = the share of (token, expert) pairs routed).

    T runs in chunks of the largest divisor of T up to ``t_chunk``, so the
    (B, tc, E, ff) transients stay bounded at prefill_32k.  The reference
    remats each chunk (``jax.checkpoint``); the port just loops, so under
    autograd it holds every chunk's residuals (one chunk at T <= 2048).

    On a share of the experts (or of their columns) the router, the
    combine weights and the aux are whole on every rank; x and the
    combine weights enter the experts through ``copy_to_model`` (the
    router's leaf does not: the aux's gradient is whole on every rank),
    the rank's experts take their columns of the combine weights, and the
    ranks' partial outputs are summed in f32 (each expert's output too,
    when the rank holds a share of its columns).  With the stream split
    over T, x enters as a whole unit's input (``tensor_parallel.enter``
    without a split: the router path's cotangent is the same on every
    rank, so its backward slices), before those f."""
    x = tp.enter(x, None)
    dt = x.dtype
    B, T, d = x.shape
    E = cfg.num_experts
    probs, top_w, top_ix = _route(cfg, p, x)
    comb = torch.zeros_like(probs).scatter_add(-1, top_ix, top_w)
    w = _expert_matrices(p, dt)
    split = tp.split_of(p)
    xe, ce = x, comb
    if split:
        xe, ce = tp.copy_to_model(x, split), tp.copy_to_model(comb, split)
        if split.by == "experts":
            n = E // split.extent
            ce = ce[..., split.index * n:(split.index + 1) * n]

    def expert_ffn(xc, cc):
        h = torch.einsum("btd,edf->btef", xc, w["w_in"])
        if "w_gate" in w:
            g = torch.einsum("btd,edf->btef", xc, w["w_gate"])
            h = _act(cfg.activation, g) * h
        else:
            h = _act(cfg.activation, h)
        if not split:
            y = torch.einsum("btef,efd->bted", h, w["w_out"])
            return torch.einsum("bted,bte->btd", y, cc.to(dt))
        if split.by == "columns":               # every expert's partial
            b, t, e, f = h.shape
            y = partial_matmul(h.permute(2, 0, 1, 3).reshape(e, b * t, f),
                               w["w_out"]).reshape(e, b, t, -1)
            return torch.einsum("ebtd,bte->btd", y, cc.to(dt).float())
        y = torch.einsum("btef,efd->bted", h, w["w_out"]).float()
        return torch.einsum("bted,bte->btd", y, cc.to(dt).float())

    tc = min(t_chunk, T)
    while T % tc:
        tc -= 1
    if tc < T:
        out = torch.cat([expert_ffn(xe[:, i:i + tc], ce[:, i:i + tc])
                         for i in range(0, T, tc)], dim=1)
    else:
        out = expert_ffn(xe, ce)
    out = tp.leave(out, split, dt)
    group = fsdp.batch_group()
    if group is None:
        f = (comb > 0).float().mean((0, 1))
        aux = E * torch.sum(f * probs.mean((0, 1)))
        return out, aux
    # this rank's rows of a batch split over the data group: f and P are
    # the reference's averages over the global batch, so f takes every
    # rank's counts, and this rank's aux is its additive share of E·Σ f·P
    # (the data group's sum of the losses counts the aux once)
    counts = fsdp.all_reduce_counts(torch.cat([
        (comb > 0).float().sum((0, 1)),
        torch.full((1,), float(B * T), device=x.device)]), group)
    f = counts[:E] / counts[E]
    return out, E * torch.sum(f * probs.sum((0, 1)) / counts[E])


def moe_apply_dispatch(cfg, p, x, *, capacity_factor: float = 1.25):
    """Capacity-based token dispatch MoE (Switch-style).

    Each expert takes at most C = ceil(S·k/E · capacity_factor) of the S =
    B·T tokens' (token, expert) pairs: the pairs are sorted by expert
    (stable), numbered within their expert, gathered into (E, C, d)
    buckets, run through per-expert matmuls and added back with their
    router weights.  A pair past its expert's C goes to a drop bin (slot
    E·C, sliced off), so every kept slot is written once.  Returns (out,
    aux) as ``moe_apply``, but this f is the share of the S·k pairs each
    expert got (it sums to 1; the dense form's sums to k).

    On this rank's rows of a batch split over the data group
    (``launch.fsdp.batch_group``) it computes the reference's function of
    the global batch: S is the global B·T, and a pair's place in its
    expert's bucket is its place among this rank's pairs of that expert
    plus the number the data ranks before this one routed there (one
    all-gather of the E counts, ``fsdp.all_gather_counts``, in the order
    ``data.pipeline.shard_batch`` cuts the rows), so the same pairs are
    dropped; the aux's f and P are the global batch's, this rank's
    additive share of E·Σ f·P.  Its buckets hold min(C, local B·T) slots
    an expert, which every kept pair of its rows fits.  On a share of the
    experts (``tensor_parallel.split_of``) the rank fills and runs its
    E/m experts' buckets, or every expert's d_ff/m columns when m does
    not divide E; x and the router weights enter the experts through f
    (the router and the aux read them whole on every rank, as in
    ``moe_apply``) and the ranks' partial outputs, added up in f32, leave
    through ``tensor_parallel.leave``.  ``dispatch_drops`` counts the
    pairs each call drops."""
    x = tp.enter(x, None)
    dt = x.dtype
    B, T, d = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    S_local = B * T
    xf = x.reshape(S_local, d)
    probs, top_w, top_ix = _route(cfg, p, xf)

    flat_e = top_ix.reshape(-1)
    counts = torch.bincount(flat_e, minlength=E)
    group = fsdp.batch_group()
    split = tp.split_of(p)
    if group is None:
        S, every = S_local, None
    else:
        S = S_local * dist.get_world_size(group)
        every = fsdp.all_gather_counts(counts, group)        # (n, E)
    C = int(math.ceil(S * k / E * capacity_factor))
    Cl = min(C, S_local)
    flat_tok = torch.arange(S_local, device=x.device).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)               # group by expert
    e_sorted = flat_e[order]
    tok_sorted = flat_tok[order]
    pos = torch.arange(S_local * k, device=x.device) - torch.searchsorted(
        e_sorted, e_sorted, side="left")                     # within bucket
    if every is not None:                   # the pairs of earlier rows
        before = every[:dist.get_rank(group)].sum(0)
        keep = pos + before[e_sorted] < C
    else:
        keep = pos < C
    if _DROPS is not None:
        _DROPS.append(fsdp.plain((~keep).sum()))
    El, e0 = E, 0
    if split and split.by == "experts":
        El = E // split.extent
        e0 = split.index * El
        mine = keep & (e_sorted >= e0) & (e_sorted < e0 + El)
    else:
        mine = keep
    slot = torch.where(mine, (e_sorted - e0) * Cl + pos, El * Cl)  # drop bin

    src, weights = xf, top_w
    if split:                               # the experts' inputs: f
        src, weights = tp.copy_to_model(xf, split), tp.copy_to_model(top_w,
                                                                     split)
    w_sorted = weights.reshape(-1)[order]

    def bucket(values, dtype):
        return torch.zeros(El * Cl + 1, dtype=dtype,
                           device=x.device).index_put((slot,),
                                                      values)[:El * Cl]

    bucket_tok = bucket(tok_sorted, torch.int64)
    bucket_w = bucket(torch.where(mine, w_sorted, 0.0), torch.float32)
    bucket_valid = bucket(mine.float(), torch.float32)

    w = _expert_matrices(p, dt)
    xe = src[bucket_tok].reshape(El, Cl, d) * bucket_valid.reshape(
        El, Cl, 1).to(dt)
    h = torch.bmm(xe, w["w_in"])
    if "w_gate" in w:
        h = _act(cfg.activation, torch.bmm(xe, w["w_gate"])) * h
    else:
        h = _act(cfg.activation, h)
    if split:                               # partial outputs, in f32
        ye = (partial_matmul(h, w["w_out"]) if split.by == "columns"
              else torch.bmm(h, w["w_out"]).float()).reshape(El * Cl, d)
        ye = ye * bucket_w.reshape(-1, 1).to(dt).float()
        out = torch.zeros(S_local, d, dtype=torch.float32,
                          device=x.device).index_add(0, bucket_tok, ye)
    else:
        ye = torch.bmm(h, w["w_out"]).reshape(El * Cl, d) \
            * bucket_w.reshape(-1, 1).to(dt)
        out = torch.zeros(S_local, d, dtype=dt, device=x.device).index_add(
            0, bucket_tok, ye)
    out = tp.leave(out.reshape(B, T, d), split, dt)

    if every is None:
        f = counts.float() / (S * k)
        return out, E * torch.sum(f * probs.mean(0))
    # f and P of the global batch; this rank's additive share of E·Σ f·P
    # (the data group's sum of the losses counts the aux once)
    f = every.sum(0).float() / (S * k)
    return out, E * torch.sum(f * probs.sum(0) / S)


# the dropped pairs of each ``moe_apply_dispatch`` call while
# ``dispatch_drops`` runs (a plain global, as ``fsdp.collective_log``'s)
_DROPS: Optional[list] = None


@contextlib.contextmanager
def dispatch_drops():
    """Within the block, a list of the (token, expert) pairs each
    ``moe_apply_dispatch`` call drops past its expert's capacity, among
    this rank's rows (0-d integer tensors, in call order); on a split
    expert set every "model" rank counts the same pairs."""
    global _DROPS
    saved, _DROPS = _DROPS, []
    try:
        yield _DROPS
    finally:
        _DROPS = saved


# ---------------------------------------------------------------------------
# Embeddings / LM head
# ---------------------------------------------------------------------------

def init_embedding(cfg, init: Init):
    """The table, and an ``lm_head`` unless the embeddings are tied."""
    p = {"table": embed_init(init, cfg.vocab_size, cfg.d_model, cfg.pdtype)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(init, cfg.d_model, cfg.vocab_size,
                                  cfg.pdtype)
    return p


def embed_apply(cfg, p, tokens):
    """Rows of the table in the compute dtype.  The reference casts the
    whole table and then gathers; gathering first and casting the rows
    gives the same numbers without a copy of the table.  ``F.embedding``
    rather than indexing: its backward sums a row's contributions in a
    fixed order on the CPU (the indexing backward's accumulation is not
    bitwise repeatable there).  On a share of the vocabulary each rank
    looks up the rows it holds and the ranks' rows are summed
    (``tensor_parallel.vocab_embed``), the same bits.  With the stream
    split over T the embedding leaves as a unit (``tensor_parallel.
    leave``): this rank's T slice."""
    split = tp.split_of(p)
    if split:
        return tp.vocab_embed(tokens, p["table"], cfg.cdtype, split)
    return tp.leave(F.embedding(tokens, p["table"]).to(cfg.cdtype), None,
                    cfg.cdtype)


def head_matrix_of(cfg, p):
    """The (d, V) head of the ``embed`` dict: ``lm_head``, or the table
    transposed (a view) when the embeddings are tied; this rank's V/m
    columns on a share of the vocabulary."""
    return p["table"].T if cfg.tie_embeddings else p["lm_head"]


def lm_head_apply(cfg, p, x):
    """x @ lm_head, or x @ tableᵀ when the embeddings are tied: this
    rank's logit columns on a share of the vocabulary (the backbone's
    ``forward_hidden`` hands the head x through ``tensor_parallel.
    enter``)."""
    return x @ head_matrix_of(cfg, p).to(x.dtype)
