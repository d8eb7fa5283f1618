"""Wrappers of the hand-written Hopper lattice kernels
(``csrc/lattice_dag.cu``, ``csrc/lattice_sausage.cu``).

Port of ``repro.kernels.lattice_fb``: the general-DAG ``dag_forward``,
``dag_backward`` and fused ``dag_loss_only``, and the sausage
``sausage_forward``, ``sausage_backward`` and fused
``sausage_loss_only`` (which, on the card, reads the raw log-probs: no
cumsum grid).  Each wrapper checks shapes; for tensors on the
CPU it returns its plain version from ``kernels.ref``; for tensors on a
CUDA device it checks dtype and contiguity, allocates outputs and
scratch, launches its kernel on the current stream and raises if the
launch was refused.  There is no fallback from the kernel to the plain
version.

Each wrapper keeps a plain integer ``launches`` (``dag_forward.launches``
...), raised by one at each kernel launch and nowhere else, so a run can
show that its path went through the kernels.  The wrappers compute
values; gradients come from the occupancy-identity ``autograd.Function``s
of ``lattice_engine.cuda_backend``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

MAX_THREADS = 512           # threads per block (one block per utterance)
# dynamic shared memory a block may take on the H100 (232,448 bytes), less
# 1 KB for the kernels' static shared arrays
SMEM_MAX = 232_448 - 1024
SCAN_ITEMS = 32             # lattice_dag.cu kScanItems: ok flags a lane

_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "lattice_dag": {
        # own corr start ok final pidx map pos gstate | gstride |
        # abuf cbuf logz cavg | B L W P threads smem_bytes
        "dag_forward_launch": [_PTR] * 9 + [_LL] + [_PTR] * 4 + [_INT] * 6
        + [_PTR],
        # own corr final ok sidx bbuf cbbuf | B L W S threads
        "dag_backward_launch": [_PTR] * 7 + [_INT] * 5 + [_PTR],
        # cum G | idx fcs level_arcs pidx lv abuf cbuf logz cavg |
        # B A L W P threads
        "dag_loss_only_launch": [_PTR, _LL] + [_PTR] * 9 + [_INT] * 6
        + [_PTR],
    },
    "lattice_sausage": {
        # score corr mask alpha c_alpha logz cavg | B S A
        "sausage_forward_launch": [_PTR] * 7 + [_INT] * 3 + [_PTR],
        # score corr mask beta c_beta | B S A
        "sausage_backward_launch": [_PTR] * 5 + [_INT] * 3 + [_PTR],
        # lp start end label lm corr mask | mask_is_bool | level_arcs
        # scratch logz cavg | kappa | B T K A S W threads smem_bytes
        "sausage_loss_only_launch": [_PTR] * 7 + [_INT] + [_PTR] * 4
        + [ctypes.c_float] + [_INT] * 8 + [_PTR],
    },
}


def launch(stem: str, fn: str, device: torch.device, *args) -> None:
    build.launch(stem, _SIGNATURES[stem], fn, device, *args)


def _launch(fn: str, device: torch.device, *args) -> None:
    launch("lattice_dag", fn, device, *args)


def _threads(width: int) -> int:
    return min(MAX_THREADS, max(32, -(-width // 32) * 32))


def _on_cuda(name: str, *tensors) -> bool:
    """True for CUDA inputs, False for CPU inputs; raises on a mix or on
    any other device."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs on several devices {devices}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev.type == "cuda"


def _check_shape(name: str, arg: str, t, shape) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def _check_kernel_input(name: str, arg: str, t, dtype) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: {arg} is {t.dtype}, the kernel takes "
                        f"{dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {arg} is not contiguous")


def dag_forward_state_bytes(n_valid: int, L: int, P: int) -> int:
    """Bytes of ``dag_forward``'s compact state for an utterance with
    ``n_valid`` valid slots over L levels with P predecessors a slot:
    alpha, c_alpha and flags for ids 0..n_valid (9 bytes each), the L+1
    level offsets and the translated predecessor rows (``csrc/
    lattice_dag.cu::compact_bytes``)."""
    return 9 * (n_valid + 1) + 4 * (L + 1) + 4 * n_valid * P


def dag_forward_plan(L: int, W: int, P: int) -> tuple:
    """(threads, dynamic shared bytes, global state bytes an utterance)
    of a ``dag_forward`` launch.  Shared memory covers the state of an
    all-valid bucket where that fits, else ``SMEM_MAX``; the kernel then
    counts the valid slots and moves a state that does not fit to the
    global scratch (0 when no utterance can need it)."""
    LW = L * W
    threads = min(512, max(128, -(-LW // (32 * SCAN_ITEMS)) * 32))
    worst = dag_forward_state_bytes(LW, L, P)
    if worst <= SMEM_MAX:
        return threads, worst, 0
    return threads, SMEM_MAX, -(-worst // 16) * 16


def dag_forward_branches(start, ok, P: int) -> list:
    """Per utterance of (B, L, W) ``start``/``ok`` flags, the branches
    ``dag_forward``'s kernel takes after its prepass, as
    ("warp" | "block", "shared" | "global"): the chain runs on warp 0
    unless a level has more than 32 valid slots that are not start slots,
    and the compact state lives in shared memory when
    ``dag_forward_state_bytes`` of the valid slots is at most SMEM_MAX.
    The kernel decides both on the card; this repeats its rule on the
    host (for logs and tests)."""
    B, L = ok.shape[0], ok.shape[1]
    valid = ok > 0.5
    steps = (valid & ~(start > 0.5)).sum(-1)
    widest = steps.amax(-1).tolist() if L else [0] * B
    n_valid = valid.flatten(1).sum(1).tolist()
    return [("block" if w > 32 else "warp",
             "shared" if dag_forward_state_bytes(n, L, P) <= SMEM_MAX
             else "global") for w, n in zip(widest, n_valid)]


def dag_forward(own, corr, start, ok, final, pidx):
    """General-DAG forward over level-major frontier tensors.

    own/corr: (B, L, W) f32 slot scores (acoustic+lm) and correctness
    counts; start/ok/final: (B, L, W) f32 flags (nonzero = set); pidx:
    (B, L, W, P) int32 predecessor positions into the flat (L*W+1,)
    buffer, dump slot L*W (``losses.lattice.lattice_frontiers``).

    Returns (alpha (B,L,W), c_alpha (B,L,W), logZ (B,), c_avg (B,)).  On
    the card alpha/c_alpha are views of the kernel's (B, L*W+1) output
    buffers without their dump slot; the kernel runs the recursion over
    the valid slots only, compacted into shared memory
    (``csrc/lattice_dag.cu``).
    """
    name = "dag_forward"
    B, L, W = own.shape
    for arg, t in (("corr", corr), ("start", start), ("ok", ok),
                   ("final", final)):
        _check_shape(name, arg, t, (B, L, W))
    _check_shape(name, "pidx", pidx, (B, L, W, pidx.shape[-1]))
    if not _on_cuda(name, own, corr, start, ok, final, pidx):
        return ref.dag_forward_ref(own, corr, start, ok, final, pidx)
    for arg, t in (("own", own), ("corr", corr), ("start", start),
                   ("ok", ok), ("final", final)):
        _check_kernel_input(name, arg, t, torch.float32)
    _check_kernel_input(name, "pidx", pidx, torch.int32)
    P, LW, dev = pidx.shape[-1], L * W, own.device
    if LW + 1 >= 2 ** 31:
        raise ValueError(f"{name}: L*W = {LW} slots overflow the kernel's "
                         f"int32 compact ids")
    threads, smem, gstride = dag_forward_plan(L, W, P)
    # outputs: alpha and c_alpha (2, B, LW+1), then logZ and c_avg (2, B);
    # int32 scratch: the position -> id map (B, LW+1), the valid positions
    # (B, LW), and the global compact state when one may be needed
    n_out = 2 * B * (LW + 1)
    buf = torch.empty(n_out + 2 * B, dtype=torch.float32, device=dev)
    if B:
        scratch = torch.empty(B * (2 * LW + 1) + B * gstride // 4,
                              dtype=torch.int32, device=dev)
        base, idx = buf.data_ptr(), scratch.data_ptr()
        red, pos = base + 4 * n_out, idx + 4 * B * (LW + 1)
        _launch("dag_forward_launch", dev, own.data_ptr(), corr.data_ptr(),
                start.data_ptr(), ok.data_ptr(), final.data_ptr(),
                pidx.data_ptr(), idx, pos,
                pos + 4 * B * LW if gstride else None, gstride, base,
                base + 4 * B * (LW + 1), red, red + 4 * B, B, L, W, P,
                threads, smem)
        dag_forward.launches += 1
    # views without the dump slot (as_strided: one call each)
    return (buf.as_strided((B, L, W), (LW + 1, W, 1), 0),
            buf.as_strided((B, L, W), (LW + 1, W, 1), B * (LW + 1)),
            buf.as_strided((B,), (1,), n_out),
            buf.as_strided((B,), (1,), n_out + B))


def dag_backward(own, corr, final, ok, sidx):
    """Backward (beta / c_beta) companion of :func:`dag_forward` over the
    successor positions ``sidx`` (B, L, W, S) int32.  beta excludes the
    arc's own score (FBStats convention).  Returns (beta, c_beta), both
    (B, L, W); on the card views of the kernel's scratch buffers."""
    name = "dag_backward"
    B, L, W = own.shape
    for arg, t in (("corr", corr), ("final", final), ("ok", ok)):
        _check_shape(name, arg, t, (B, L, W))
    _check_shape(name, "sidx", sidx, (B, L, W, sidx.shape[-1]))
    if not _on_cuda(name, own, corr, final, ok, sidx):
        return ref.dag_backward_ref(own, corr, final, ok, sidx)
    for arg, t in (("own", own), ("corr", corr), ("final", final),
                   ("ok", ok)):
        _check_kernel_input(name, arg, t, torch.float32)
    _check_kernel_input(name, "sidx", sidx, torch.int32)
    S, LW, dev = sidx.shape[-1], L * W, own.device
    bbuf = torch.empty((B, LW + 1), dtype=torch.float32, device=dev)
    cbbuf = torch.empty((B, LW + 1), dtype=torch.float32, device=dev)
    if B:
        _launch("dag_backward_launch", dev, own.data_ptr(), corr.data_ptr(),
                final.data_ptr(), ok.data_ptr(), sidx.data_ptr(),
                bbuf.data_ptr(), cbbuf.data_ptr(), B, L, W, S, _threads(W))
        dag_backward.launches += 1
    return (bbuf[:, :LW].unflatten(1, (L, W)),
            cbbuf[:, :LW].unflatten(1, (L, W)))


def loss_only_prologue(log_probs, start, end, label, lm, corr, arc_mask,
                       is_start, is_final, kappa: float):
    """``dag_loss_only``'s input preparation, in PyTorch (outside the
    kernel in the JAX package too): the kappa-scaled, mean-centred cumsum
    grid with the per-state means appended as a trailing row, packed
    [end | start | mean] gather positions into it, and the packed arc
    fields [span, lm, corr, arc_mask, is_start, is_final].

    Returns cumext (B, (T+2)*K) f32, idx (B, 3A) int32, fcs (B, 6, A) f32.
    """
    B, T, K = log_probs.shape
    lp = log_probs.to(torch.float32)
    mu = lp.mean(dim=1)                                        # (B, K)
    cum = torch.cumsum(lp - mu[:, None, :], dim=1)
    cum = torch.cat([torch.zeros_like(cum[:, :1]), cum], dim=1)
    cumext = torch.cat([cum.reshape(B, -1), mu], dim=1).mul_(kappa)
    lab = label.to(torch.int32)
    idx = torch.cat([end.to(torch.int32) * K + lab,
                     start.to(torch.int32) * K + lab,
                     (T + 1) * K + lab], dim=1)                # (B, 3A)
    fcs = torch.stack([(end - start).to(torch.float32),
                       lm.to(torch.float32), corr.to(torch.float32),
                       arc_mask.to(torch.float32),
                       is_start.to(torch.float32),
                       is_final.to(torch.float32)], dim=1)     # (B, 6, A)
    return cumext, idx.contiguous(), fcs


def dag_loss_only(log_probs, start, end, label, lm, corr, arc_mask,
                  is_start, is_final, level_arcs, pidx, *,
                  kappa: float = 1.0):
    """Fused loss-only forward for general DAG lattices: (logZ (B,),
    c_avg (B,)) straight from the (B, T, K) frame log-probs and arc-layout
    lattice fields (B, A), with level_arcs (B, L, W) int32 and pidx
    (B, L, W, P) int32 from ``losses.lattice.lattice_frontiers``.

    On the card the prologue (``loss_only_prologue``) runs as PyTorch ops
    and ONE kernel does the endpoint gather, the arc -> level-major
    gather, the forward recursion and the final-arc reduction; only the
    two (B,) outputs leave it.
    """
    name = "dag_loss_only"
    B, T, K = log_probs.shape
    A = start.shape[1]
    L, W = level_arcs.shape[1], level_arcs.shape[2]
    for arg, t in (("start", start), ("end", end), ("label", label),
                   ("lm", lm), ("corr", corr), ("arc_mask", arc_mask),
                   ("is_start", is_start), ("is_final", is_final)):
        _check_shape(name, arg, t, (B, A))
    _check_shape(name, "level_arcs", level_arcs, (B, L, W))
    _check_shape(name, "pidx", pidx, (B, L, W, pidx.shape[-1]))
    if not _on_cuda(name, log_probs, start, end, label, lm, corr, arc_mask,
                    is_start, is_final, level_arcs, pidx):
        return ref.dag_loss_only_ref(log_probs, start, end, label, lm, corr,
                                     arc_mask, is_start, is_final,
                                     level_arcs, pidx, kappa=kappa)
    if (T + 2) * K >= 2 ** 31:
        raise ValueError(f"{name}: the (T+2)*K = {(T + 2) * K} cumsum grid "
                         f"row overflows the kernel's int32 gather indices")
    cumext, idx, fcs = loss_only_prologue(log_probs, start, end, label, lm,
                                          corr, arc_mask, is_start,
                                          is_final, kappa)
    return dag_loss_only_from_grid(cumext, idx, fcs, level_arcs, pidx)


def dag_loss_only_from_grid(cumext, idx, fcs, level_arcs, pidx):
    """The fused kernel alone, on the outputs of ``loss_only_prologue``
    (all on one CUDA device): one launch, (logZ (B,), c_avg (B,)) out.
    ``dag_loss_only`` is the entry point; this is its launch step."""
    name = "dag_loss_only"
    B, L, W = level_arcs.shape
    A = fcs.shape[-1]
    _check_shape(name, "idx", idx, (B, 3 * A))
    _check_shape(name, "fcs", fcs, (B, 6, A))
    _check_shape(name, "pidx", pidx, (B, L, W, pidx.shape[-1]))
    if not _on_cuda(name, cumext, idx, fcs, level_arcs, pidx):
        raise ValueError(f"{name}: the fused kernel takes CUDA tensors")
    for arg, t, dtype in (("cumext", cumext, torch.float32),
                          ("idx", idx, torch.int32),
                          ("fcs", fcs, torch.float32),
                          ("level_arcs", level_arcs, torch.int32),
                          ("pidx", pidx, torch.int32)):
        _check_kernel_input(name, arg, t, dtype)
    P, LW, dev = pidx.shape[-1], L * W, cumext.device
    lv = torch.empty((B, 5, LW), dtype=torch.float32, device=dev)
    abuf = torch.empty((B, LW + 1), dtype=torch.float32, device=dev)
    cbuf = torch.empty((B, LW + 1), dtype=torch.float32, device=dev)
    logz = torch.empty((B,), dtype=torch.float32, device=dev)
    cavg = torch.empty((B,), dtype=torch.float32, device=dev)
    if B:
        _launch("dag_loss_only_launch", dev, cumext.data_ptr(),
                cumext.shape[1], idx.data_ptr(), fcs.data_ptr(),
                level_arcs.data_ptr(), pidx.data_ptr(), lv.data_ptr(),
                abuf.data_ptr(), cbuf.data_ptr(), logz.data_ptr(),
                cavg.data_ptr(), B, A, L, W, P, _threads(W))
        dag_loss_only.launches += 1
    return logz, cavg


def _sausage_inputs(name: str, scores, corr, mask):
    B, S, A = scores.shape
    _check_shape(name, "corr", corr, (B, S, A))
    if mask is None:
        mask = torch.ones_like(scores, dtype=torch.float32)
    _check_shape(name, "mask", mask, (B, S, A))
    return mask


def sausage_forward(scores, corr, mask=None):
    """Sausage forward recursion.  scores/corr: (B, S, A) f32 per-arc
    acoustic+lm scores and correctness; mask: optional (B, S, A) f32,
    nonzero = valid arc.

    Returns (alpha (B,S,A), c_alpha (B,S,A), logZ (B,), c_avg (B,))."""
    name = "sausage_forward"
    mask = _sausage_inputs(name, scores, corr, mask)
    if not _on_cuda(name, scores, corr, mask):
        return ref.sausage_forward_ref(scores, corr, mask)
    for arg, t in (("scores", scores), ("corr", corr), ("mask", mask)):
        _check_kernel_input(name, arg, t, torch.float32)
    B, S, A = scores.shape
    dev = scores.device
    alpha = torch.empty((B, S, A), dtype=torch.float32, device=dev)
    c_alpha = torch.empty_like(alpha)
    logz = torch.empty((B,), dtype=torch.float32, device=dev)
    cavg = torch.empty_like(logz)
    if B:
        launch("lattice_sausage", "sausage_forward_launch", dev,
               scores.data_ptr(), corr.data_ptr(), mask.data_ptr(),
               alpha.data_ptr(), c_alpha.data_ptr(), logz.data_ptr(),
               cavg.data_ptr(), B, S, A)
        sausage_forward.launches += 1
    return alpha, c_alpha, logz, cavg


def sausage_backward(scores, corr, mask=None):
    """Backward (beta / c_beta) companion of :func:`sausage_forward`.
    Returns (beta (B,S,A), c_beta (B,S,A)); beta excludes the arc's own
    score (FBStats convention), so gamma = exp(alpha + beta - logZ)."""
    name = "sausage_backward"
    mask = _sausage_inputs(name, scores, corr, mask)
    if not _on_cuda(name, scores, corr, mask):
        return ref.sausage_backward_ref(scores, corr, mask)
    for arg, t in (("scores", scores), ("corr", corr), ("mask", mask)):
        _check_kernel_input(name, arg, t, torch.float32)
    B, S, A = scores.shape
    dev = scores.device
    beta = torch.empty((B, S, A), dtype=torch.float32, device=dev)
    c_beta = torch.empty_like(beta)
    if B:
        launch("lattice_sausage", "sausage_backward_launch", dev,
               scores.data_ptr(), corr.data_ptr(), mask.data_ptr(),
               beta.data_ptr(), c_beta.data_ptr(), B, S, A)
        sausage_backward.launches += 1
    return beta, c_beta


def sausage_loss_only(log_probs, start, end, label, lm, corr, arc_mask,
                      level_arcs, *, kappa: float = 1.0):
    """Fused loss-only forward for sausage lattices: (logZ (B,), c_avg
    (B,)) straight from the (B, T, K) frame log-probs and arc-layout
    lattice fields (B, A), with level_arcs (B, S, W) int32 (-1 padded).

    On the card ONE kernel reads the raw log-probs: each slot's arc
    score is kappa times the sum of lp[t, label] over its span (no cumsum
    grid), then the S-segment forward recursion; only the two (B,)
    outputs leave it.  Frames are clamped to [0, T] and labels to
    [0, K); an arc id outside [0, A) in level_arcs is a masked slot."""
    name = "sausage_loss_only"
    B, T, K = log_probs.shape
    A = start.shape[1]
    for arg, t in (("start", start), ("end", end), ("label", label),
                   ("lm", lm), ("corr", corr), ("arc_mask", arc_mask)):
        _check_shape(name, arg, t, (B, A))
    _check_shape(name, "level_arcs", level_arcs,
                 (B,) + tuple(level_arcs.shape[1:]))
    if not _on_cuda(name, log_probs, start, end, label, lm, corr, arc_mask,
                    level_arcs):
        return ref.sausage_loss_only_ref(log_probs, start, end, label, lm,
                                         corr, arc_mask, level_arcs,
                                         kappa=kappa)
    if K == 0 and A:
        raise ValueError(f"{name}: K = 0 log-prob columns for {A} arcs")
    S, W = level_arcs.shape[1], level_arcs.shape[2]
    dev = log_probs.device
    f32 = lambda t: t.to(torch.float32).contiguous()  # noqa: E731
    i32 = lambda t: t.to(torch.int32).contiguous()    # noqa: E731
    is_bool = arc_mask.dtype == torch.bool
    mask = arc_mask.contiguous() if is_bool else f32(arc_mask)
    lp = f32(log_probs)
    start, end, label, la = i32(start), i32(end), i32(label), \
        i32(level_arcs)
    lm, corr = f32(lm), f32(corr)
    out = torch.empty(2 * B, dtype=torch.float32, device=dev)
    if B:
        # scores, correctness, mask and the long-span list: 16 B a slot
        SW = S * W
        smem, scratch = 16 * SW, None
        if smem > SMEM_MAX:
            smem, scratch = 0, torch.empty((B, 4, SW), dtype=torch.float32,
                                           device=dev)
        threads = min(1024, max(32, -(-SW // 32) * 32))
        launch("lattice_sausage", "sausage_loss_only_launch", dev,
               lp.data_ptr(), start.data_ptr(), end.data_ptr(),
               label.data_ptr(), lm.data_ptr(), corr.data_ptr(),
               mask.data_ptr(), int(is_bool), la.data_ptr(),
               scratch.data_ptr() if scratch is not None else None,
               out.data_ptr(), out.data_ptr() + 4 * B, float(kappa), B, T,
               K, A, S, W, threads, smem)
        sausage_loss_only.launches += 1
    return out.as_strided((B,), (1,), 0), out.as_strided((B,), (1,), B)


dag_forward.launches = 0
dag_backward.launches = 0
dag_loss_only.launches = 0
sausage_forward.launches = 0
sausage_backward.launches = 0
sausage_loss_only.launches = 0

KERNELS = (dag_forward, dag_backward, dag_loss_only, sausage_forward,
           sausage_backward, sausage_loss_only)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
