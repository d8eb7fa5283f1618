"""Plain PyTorch versions of the lattice, CG and attention kernels (the
allclose targets).

Port of ``repro.kernels.ref``, with ``vmap`` and ``lax.scan`` written
out as a batch dimension and a Python loop.  These are what the kernel
wrappers in ``kernels.lattice_fb``, ``kernels.cg_fused`` and
``kernels.swa_attention`` run for tensors on the CPU, and what
``chip_smoke.py`` holds the CUDA kernels against on the card.  They
repeat the kernels' arithmetic with PyTorch ops and are no yardstick of
speed.  Index tensors must be in range (``losses.lattice.
lattice_frontiers`` builds them so); the CUDA kernels additionally map
an out-of-range position to the dump slot instead of faulting.
"""
from __future__ import annotations

import math

import torch

NEG = -1e30
EPS = 1e-30


def _flag(x) -> torch.Tensor:
    """Any numeric/bool flag tensor -> bool (nonzero = set)."""
    return x.to(torch.float32) > 0.5


def sausage_arc_scores_ref(log_probs, start, end, label, kappa: float):
    """Per-arc acoustic scores from (B, T, K) log-probs via the
    mean-centred cumsum endpoint gather, for any common index shape
    (B, ...) — arc layout (B, A) or level layout (B, L, W)."""
    B, T, K = log_probs.shape
    shp = start.shape
    lp = log_probs.to(torch.float32)
    mu = lp.mean(dim=1, keepdim=True)                          # (B, 1, K)
    cum = torch.cumsum(lp - mu, dim=1)
    cum = torch.cat([torch.zeros_like(cum[:, :1]), cum], dim=1)
    flat = cum.reshape(B, (T + 1) * K)
    lab = label.reshape(B, -1).long()
    hi = flat.gather(1, end.reshape(B, -1).long() * K + lab)
    lo = flat.gather(1, start.reshape(B, -1).long() * K + lab)
    span = (end - start).reshape(B, -1).to(torch.float32)
    mu_lab = mu[:, 0, :].gather(1, lab)
    return (kappa * (hi - lo + span * mu_lab)).reshape(shp)


def sausage_arc_scores_vjp(ds, start, end, label, num_frames: int,
                           num_states: int, kappa: float):
    """Transpose of :func:`sausage_arc_scores_ref` (which is linear in the
    log-probs): (B, ...) score cotangents -> (B, T, K) log-prob
    cotangent.  The endpoint gathers become scatter-adds into the
    (T+1, K) cumsum grid, the cumsum a reverse cumsum, and the centring
    (and the ``span * mu`` term) a per-state mean over the frames."""
    B = ds.shape[0]
    T, K = num_frames, num_states
    g = ds.reshape(B, -1).to(torch.float32) * kappa
    lab = label.reshape(B, -1).long()
    grid = torch.zeros(B, (T + 1) * K, dtype=torch.float32, device=ds.device)
    grid.scatter_add_(1, end.reshape(B, -1).long() * K + lab, g)
    grid.scatter_add_(1, start.reshape(B, -1).long() * K + lab, -g)
    span = (end - start).reshape(B, -1).to(torch.float32)
    dmu = torch.zeros(B, K, dtype=torch.float32, device=ds.device)
    dmu.scatter_add_(1, lab, span * g)
    grid = grid.reshape(B, T + 1, K)[:, 1:]
    # cum[t] = sum_{t' < t} (lp[t'] - mu): d(lp - mu)[t'] = sum_{t > t'} grid[t]
    dx = grid.flip(1).cumsum(1).flip(1)
    return dx + ((dmu - dx.sum(1)) / T)[:, None, :]


def gather_sausage_ref(values, level_arcs, fill):
    """(B, A) arc values -> (B, L, W) level-major layout via the
    ``level_arcs`` frontier map (-1 slots get ``fill``)."""
    B = values.shape[0]
    safe = level_arcs.clamp(min=0).long().reshape(B, -1)
    g = values.gather(1, safe).reshape(level_arcs.shape)
    return torch.where(level_arcs >= 0, g, torch.full_like(g, fill))


def _masked_lse_row(x, dim=-1):
    """Row-wise logsumexp treating entries at/near NEG as masked; an
    all-masked row returns exactly NEG.  Companion weights (masked
    softmax: all-masked rows get all-zero weights) returned alongside."""
    valid = x > NEG * 0.5
    m = x.amax(dim=dim)
    m0 = torch.where(m > NEG * 0.5, m, torch.zeros_like(m))
    e = torch.where(valid, torch.exp(x - m0.unsqueeze(dim)),
                    torch.zeros_like(x))
    z = e.sum(dim=dim)
    has = valid.any(dim=dim)
    lse = torch.where(has, (torch.log(z.clamp(min=EPS)) + m0).clamp(min=NEG),
                      torch.full_like(z, NEG))
    w = e / z.clamp(min=EPS).unsqueeze(dim)
    return lse, w


def dag_forward_ref(own, corr, start, ok, final, pidx):
    """Plain version of the DAG forward kernel.

    All level-major (B, L, W): ``own`` arc scores (acoustic+lm, NEG at
    empty slots), ``corr`` correctness counts, ``start``/``ok``/``final``
    flags (nonzero = set); ``pidx``: (B, L, W, P) predecessor positions
    into the flat (L*W+1,) level-major buffer (dump slot L*W).

    Returns (alpha (B,L,W), c_alpha (B,L,W), logZ (B,), c_avg (B,)) —
    logZ/c_avg reduced over FINAL slots, which may sit on any level.
    """
    B, L, W = own.shape
    P = pidx.shape[-1]
    LW = L * W
    own = own.to(torch.float32)
    corr = corr.to(torch.float32)
    start, ok = _flag(start), _flag(ok)
    a_buf = torch.full((B, LW + 1), NEG, dtype=torch.float32,
                       device=own.device)
    c_buf = torch.zeros((B, LW + 1), dtype=torch.float32, device=own.device)
    for lv in range(L):
        idx = pidx[:, lv].reshape(B, W * P).long()
        pa = a_buf.gather(1, idx).reshape(B, W, P)
        pc = c_buf.gather(1, idx).reshape(B, W, P)
        in_log, w = _masked_lse_row(pa)
        c_in = (w * pc).sum(dim=-1)
        own_l, st_l, ok_l = own[:, lv], start[:, lv], ok[:, lv]
        a_val = torch.where(st_l, own_l, own_l + in_log)
        c_val = corr[:, lv] + torch.where(st_l, torch.zeros_like(c_in), c_in)
        a_buf[:, lv * W:(lv + 1) * W] = torch.where(
            ok_l, a_val, torch.full_like(a_val, NEG))
        c_buf[:, lv * W:(lv + 1) * W] = torch.where(
            ok_l, c_val, torch.zeros_like(c_val))
    fin = _flag(final).reshape(B, LW)
    af = torch.where(fin, a_buf[:, :LW], torch.full_like(a_buf[:, :LW], NEG))
    logz, w = _masked_lse_row(af)
    cavg = (w * c_buf[:, :LW]).sum(dim=-1)
    return (a_buf[:, :LW].reshape(B, L, W), c_buf[:, :LW].reshape(B, L, W),
            logz, cavg)


def dag_backward_ref(own, corr, final, ok, sidx):
    """Plain version of the DAG backward kernel: level-major
    (beta (B,L,W), c_beta (B,L,W)) over the successor positions ``sidx``
    (B, L, W, S); beta excludes the arc's own score (FBStats
    convention), so gamma = exp(alpha + beta - logZ)."""
    B, L, W = own.shape
    S = sidx.shape[-1]
    LW = L * W
    dev = own.device
    okf = _flag(ok).reshape(B, LW)
    final = _flag(final)
    ok = _flag(ok)
    own_f = own.to(torch.float32).reshape(B, LW)
    corr_f = corr.to(torch.float32).reshape(B, LW)
    own_pad = torch.cat([torch.where(okf, own_f, torch.full_like(own_f, NEG)),
                         torch.full((B, 1), NEG, device=dev)], dim=1)
    corr_pad = torch.cat([torch.where(okf, corr_f, torch.zeros_like(corr_f)),
                          torch.zeros((B, 1), device=dev)], dim=1)
    b_buf = torch.full((B, LW + 1), NEG, dtype=torch.float32, device=dev)
    cb_buf = torch.zeros((B, LW + 1), dtype=torch.float32, device=dev)
    for lv in range(L - 1, -1, -1):
        idx = sidx[:, lv].reshape(B, W * S).long()
        s_out = torch.where(idx < LW,
                            b_buf.gather(1, idx) + own_pad.gather(1, idx),
                            torch.full(idx.shape, NEG, device=dev))
        sc = cb_buf.gather(1, idx) + corr_pad.gather(1, idx)
        out_log, w = _masked_lse_row(s_out.reshape(B, W, S))
        c_out = (w * sc.reshape(B, W, S)).sum(dim=-1)
        fin_l, ok_l = final[:, lv], ok[:, lv]
        b_val = torch.where(fin_l, torch.zeros_like(out_log), out_log)
        c_val = torch.where(fin_l, torch.zeros_like(c_out), c_out)
        b_buf[:, lv * W:(lv + 1) * W] = torch.where(
            ok_l, b_val, torch.full_like(b_val, NEG))
        cb_buf[:, lv * W:(lv + 1) * W] = torch.where(
            ok_l, c_val, torch.zeros_like(c_val))
    return b_buf[:, :LW].reshape(B, L, W), cb_buf[:, :LW].reshape(B, L, W)


def dag_loss_only_ref(log_probs, start, end, label, lm, corr, arc_mask,
                      is_start, is_final, level_arcs, pidx, *,
                      kappa: float = 1.0):
    """Plain version of the fused DAG loss-only kernel: score
    construction, arc->level-major gather, and the forward-only DAG
    recursion with final-arc reduction, returning (logZ (B,), c_avg (B,)).
    Lattice fields in arc layout (B, A); level_arcs (B, L, W) and pidx
    (B, L, W, P) from ``losses.lattice.lattice_frontiers``."""
    score_arc = sausage_arc_scores_ref(log_probs, start, end, label, kappa) \
        + lm.to(torch.float32)                                 # (B, A)
    own = gather_sausage_ref(score_arc, level_arcs, NEG)
    co = gather_sausage_ref(corr.to(torch.float32), level_arcs, 0.0)
    ok = gather_sausage_ref(arc_mask.to(torch.float32), level_arcs, 0.0)
    st = gather_sausage_ref(is_start.to(torch.float32), level_arcs, 0.0) * ok
    fin = gather_sausage_ref(is_final.to(torch.float32), level_arcs,
                             0.0) * ok
    _, _, logz, cavg = dag_forward_ref(own, co, st, ok, fin, pidx)
    return logz, cavg


def _sausage_step(sc, co, mk, carry_log, carry_c):
    """One segment of the masked sausage recursion over (B, A) rows: the
    arithmetic of ``lattice_fb.py::_fwd_kernel``/``_bwd_kernel``.  Returns
    the masked row, the new carry (a fully masked segment passes it) and
    the row's softmax weights."""
    valid = mk > 0.5
    seg_valid = mk.amax(dim=-1) > 0.5
    row = torch.where(valid, sc + carry_log[:, None], torch.full_like(sc, NEG))
    mx = row.amax(dim=-1)
    e = torch.exp(row - mx[:, None]) * mk
    z = e.sum(dim=-1)
    new_log = torch.where(seg_valid, torch.log(z.clamp(min=EPS)) + mx,
                          carry_log)
    w = e / z.clamp(min=EPS)[:, None]
    return valid, seg_valid, row, new_log, w


def sausage_forward_ref(scores, corr, mask=None):
    """Plain version of the sausage forward kernel.  scores/corr: (B, S, A)
    per-arc acoustic+lm scores and correctness; mask: optional (B, S, A),
    nonzero = valid arc.  Segments run in order; a fully masked segment
    passes the carry (in_log, c_in) through unchanged.

    Returns (alpha (B,S,A), c_alpha (B,S,A), logZ (B,), c_avg (B,))."""
    B, S, A = scores.shape
    sc = scores.to(torch.float32)
    co = corr.to(torch.float32)
    mk = (torch.ones_like(sc) if mask is None else mask.to(torch.float32))
    in_log = torch.zeros(B, dtype=torch.float32, device=sc.device)
    c_in = torch.zeros_like(in_log)
    alpha, c_alpha = [], []
    for s in range(S):
        valid, seg_valid, row, new_log, w = _sausage_step(
            sc[:, s], co[:, s], mk[:, s], in_log, c_in)
        c_row = torch.where(valid, co[:, s] + c_in[:, None],
                            torch.zeros_like(row))
        c_in = torch.where(seg_valid, (w * c_row).sum(dim=-1), c_in)
        in_log = new_log
        alpha.append(row)
        c_alpha.append(c_row)
    return torch.stack(alpha, 1), torch.stack(c_alpha, 1), in_log, c_in


def sausage_backward_ref(scores, corr, mask=None):
    """Plain version of the sausage backward kernel: (beta (B,S,A),
    c_beta (B,S,A)) by the reverse recursion; beta excludes the arc's own
    score (FBStats convention), so gamma = exp(alpha + beta - logZ)."""
    B, S, A = scores.shape
    sc = scores.to(torch.float32)
    co = corr.to(torch.float32)
    mk = (torch.ones_like(sc) if mask is None else mask.to(torch.float32))
    out_log = torch.zeros(B, dtype=torch.float32, device=sc.device)
    c_out = torch.zeros_like(out_log)
    beta, c_beta = [None] * S, [None] * S
    for s in range(S - 1, -1, -1):
        valid = mk[:, s] > 0.5
        b_row = torch.where(valid, out_log[:, None].expand(B, A),
                            torch.full_like(sc[:, s], NEG))
        cb_row = torch.where(valid, c_out[:, None].expand(B, A),
                             torch.zeros_like(sc[:, s]))
        beta[s], c_beta[s] = b_row, cb_row
        # the row is score + b_row (b_row = out_log on valid arcs)
        _, seg_valid, _, new_log, w = _sausage_step(
            sc[:, s], co[:, s], mk[:, s], out_log, c_out)
        c_out = torch.where(seg_valid, (w * (co[:, s] + cb_row)).sum(dim=-1),
                            c_out)
        out_log = new_log
    return torch.stack(beta, 1), torch.stack(c_beta, 1)


def sausage_loss_only_ref(log_probs, start, end, label, lm, corr, arc_mask,
                          level_arcs, *, kappa: float = 1.0):
    """Plain version of the fused sausage loss-only kernel: score
    construction, arc -> (S, W) gather via ``level_arcs`` (-1 slots are
    masked), and the forward recursion; only (logZ (B,), c_avg (B,))."""
    score_arc = sausage_arc_scores_ref(log_probs, start, end, label, kappa) \
        + lm.to(torch.float32)                                 # (B, A)
    scores = gather_sausage_ref(score_arc, level_arcs, 0.0)
    co = gather_sausage_ref(corr.to(torch.float32), level_arcs, 0.0)
    mk = gather_sausage_ref(arc_mask.to(torch.float32), level_arcs, 0.0)
    _, _, logz, cavg = sausage_forward_ref(scores, co, mk)
    return logz, cavg


def cg_fused_update_ref(alpha, x, v, r, bv):
    """Plain version of the fused CG vector update over flat (N,) buffers:
    x + alpha v and r - alpha Bv computed in f32 and stored in x's / r's
    dtype, and rr = sum((r - alpha Bv)^2) in f32 (before the store)."""
    xf, vf = x.to(torch.float32), v.to(torch.float32)
    rf, bvf = r.to(torch.float32), bv.to(torch.float32)
    rn = rf - alpha * bvf
    return (xf + alpha * vf).to(x.dtype), rn.to(r.dtype), (rn * rn).sum()


def tree_order(tree: dict) -> list:
    """``tree``'s keys in ``ravel_pytree``'s leaf order (sorted by the
    dotted path), the order the per-leaf partials are summed in."""
    return sorted(tree, key=lambda k: tuple(k.split(".")))


def cg_fused_update_tree_ref(alpha, x, v, r, bv):
    """Plain version of the per-leaf fused CG update: ``x``, ``v``, ``r``,
    ``bv`` are dicts of one key set, each leaf updated as by
    :func:`cg_fused_update_ref` in its own shape, and rr the sum of the
    per-leaf f32 partials, taken in double in ``tree_order`` and rounded
    to f32."""
    x_new, r_new, rr = {}, {}, 0.0
    for k in tree_order(x):
        x_new[k], r_new[k], part = cg_fused_update_ref(alpha, x[k], v[k],
                                                       r[k], bv[k])
        # one scalar a leaf, folded in double as the kernel folds its tiles
        rr = rr + part.to(torch.float64)  # reprolint: disable=RL007
    return ({k: x_new[k] for k in x}, {k: r_new[k] for k in x},
            torch.as_tensor(rr).to(torch.float32))


def swa_attention_ref(q, k, v, window: int, *, q_chunk: int = 512,
                      q_offset: int = 0):
    """Sliding-window causal attention, chunked over queries.

    q: (B, T, H, hd); k/v: (B, S, K, hd) with H a multiple of K (query
    head h reads kv head h // (H // K); nothing is repeated).  Query t
    sits at absolute position ``q_offset + t`` and sees the keys at
    positions p - window ... p (window + 1 keys, clipped at 0), as
    ``repro.kernels.ref.swa_attention_ref`` and the Pallas kernel.
    Scores scaled by 1/sqrt(hd), softmax and P.V in f32, output in q's
    dtype.  Each chunk of ``q_chunk`` queries meets only its
    (window + chunk) key span, so memory is O(chunk x span), not
    O(T^2): the reference's dense (B, H, T, T) would not fit at
    T = 32768.
    """
    B, T, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    for t0 in range(0, T, q_chunk):
        t1 = min(t0 + q_chunk, T)
        lo = max(0, q_offset + t0 - window)
        hi = min(S, q_offset + t1)
        qb = q[:, t0:t1].float().reshape(B, t1 - t0, K, G, hd)
        kb = k[:, lo:hi].float()
        vb = v[:, lo:hi].float()
        s = torch.einsum("bqkgd,bskd->bkgqs", qb, kb) * scale
        qpos = q_offset + torch.arange(t0, t1, device=q.device)
        kpos = torch.arange(lo, hi, device=q.device)
        mask = ((kpos[None, :] <= qpos[:, None])
                & (kpos[None, :] > qpos[:, None] - window - 1))
        s = torch.where(mask, s, torch.full_like(s, NEG))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqs,bskd->bqkgd", p, vb)
        out[:, t0:t1] = o.reshape(B, t1 - t0, H, hd).to(q.dtype)
    return out


def _swa_chunk(q, k, v, t0: int, t1: int, window: int):
    """The f32 pieces of query chunk [t0, t1) of the windowed attention
    (q_offset 0): lo, (q (B, n, K, G, hd), k, v (B, span, K, hd)), the band
    mask (n, span) and P (B, K, G, n, span)."""
    B, _, H, hd = q.shape
    K = k.shape[2]
    lo = max(0, t0 - window)
    qb = q[:, t0:t1].float().reshape(B, t1 - t0, K, H // K, hd)
    kb, vb = k[:, lo:t1].float(), v[:, lo:t1].float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qb, kb) / math.sqrt(hd)
    qpos = torch.arange(t0, t1, device=q.device)
    kpos = torch.arange(lo, t1, device=q.device)
    mask = ((kpos[None, :] <= qpos[:, None])
            & (kpos[None, :] > qpos[:, None] - window - 1))
    p = torch.softmax(torch.where(mask, s, torch.full_like(s, NEG)), -1)
    return lo, qb, kb, vb, mask, p


def swa_attention_vjp_ref(q, k, v, g, window: int, *, q_chunk: int = 512):
    """Plain version of the attention's backward kernels: (dq, dk, dv) of
    ``swa_attention_ref`` (q_offset 0) for the output's cotangent ``g``, in
    the inputs' dtypes.  Chunked over queries as ``swa_attention_ref``, in
    f32, written out rather than taken by autograd, which cannot run inside
    a ``torch.func`` transform's backward: with dP = g V^T and D =
    sum_j P dP, dS = P (dP - D), dq = scale dS K, dk = scale dS^T q and
    dv = P^T g."""
    B, T, H, hd = q.shape
    K = k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    dq = torch.empty_like(q)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros_like(dk)
    for t0 in range(0, T, q_chunk):
        t1 = min(t0 + q_chunk, T)
        lo, qb, kb, vb, _, p = _swa_chunk(q, k, v, t0, t1, window)
        gb = g[:, t0:t1].float().reshape(qb.shape)
        dp = torch.einsum("bqkgd,bskd->bkgqs", gb, vb)
        ds = p * (dp - (p * dp).sum(-1, keepdim=True)) * scale
        dq[:, t0:t1] = torch.einsum("bkgqs,bskd->bqkgd", ds, kb).reshape(
            B, t1 - t0, H, hd).to(q.dtype)
        dk[:, lo:t1] += torch.einsum("bkgqs,bqkgd->bskd", ds, qb)
        dv[:, lo:t1] += torch.einsum("bkgqs,bqkgd->bskd", p, gb)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def swa_attention_jvp_ref(q, k, v, tq, tk, tv, window: int, *,
                          q_chunk: int = 512):
    """Plain version of the attention's jvp kernel: the tangent of
    ``swa_attention_ref`` (q_offset 0) for tangents (tq, tk, tv), in q's
    dtype.  Chunked over queries as ``swa_attention_ref``, in f32, written
    out rather than taken by ``torch.func.jvp``, which cannot run inside
    ``torch.func.linearize``'s trace (forward AD does not nest): with ds =
    scale (tq.k + q.tk), dP = P (ds - sum_j P ds) and d(PV) = dP V + P tv.
    """
    B, T, H, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    for t0 in range(0, T, q_chunk):
        t1 = min(t0 + q_chunk, T)
        lo, qb, kb, vb, mask, p = _swa_chunk(q, k, v, t0, t1, window)
        tqb = tq[:, t0:t1].float().reshape(qb.shape)
        tkb, tvb = tk[:, lo:t1].float(), tv[:, lo:t1].float()
        ds = (torch.einsum("bqkgd,bskd->bkgqs", tqb, kb)
              + torch.einsum("bqkgd,bskd->bkgqs", qb, tkb)) * scale
        pds = p * torch.where(mask, ds, torch.zeros_like(ds))
        dp = pds - p * pds.sum(-1, keepdim=True)
        o = (torch.einsum("bkgqs,bskd->bqkgd", dp, vb)
             + torch.einsum("bkgqs,bskd->bqkgd", p, tvb))
        out[:, t0:t1] = o.reshape(B, t1 - t0, H, hd).to(q.dtype)
    return out
