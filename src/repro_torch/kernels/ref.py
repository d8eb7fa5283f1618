"""Plain PyTorch versions of the lattice kernels (the allclose targets).

Port of the lattice half of ``repro.kernels.ref``, with ``vmap`` written
out as a batch dimension.  These are what the kernel wrappers in
``kernels.lattice_fb`` run for tensors on the CPU, and what
``chip_smoke.py`` holds the CUDA kernels against on the card.  They
repeat the kernels' arithmetic with PyTorch ops and are no yardstick of
speed.  Index tensors must be in range (``losses.lattice.
lattice_frontiers`` builds them so); the CUDA kernels additionally map
an out-of-range position to the dump slot instead of faulting.
"""
from __future__ import annotations

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
