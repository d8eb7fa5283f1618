"""Wrappers of the hand-written Hopper lattice kernels
(``csrc/lattice_dag.cu``, ``csrc/lattice_sausage.cu``).

Port of ``repro.kernels.lattice_fb``: the general-DAG ``dag_forward``,
``dag_backward`` and fused ``dag_loss_only``, and the sausage
``sausage_forward``, ``sausage_backward`` and fused
``sausage_loss_only``.  Each wrapper checks shapes; for tensors on the
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

_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "lattice_dag": {
        # own corr start ok final pidx abuf cbuf logz cavg | B L W P threads
        "dag_forward_launch": [_PTR] * 10 + [_INT] * 5 + [_PTR],
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
        # cum G | idx fcs level_arcs logz cavg | B A S W
        "sausage_loss_only_launch": [_PTR, _LL] + [_PTR] * 5 + [_INT] * 4
        + [_PTR],
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


def dag_forward(own, corr, start, ok, final, pidx):
    """General-DAG forward over level-major frontier tensors.

    own/corr: (B, L, W) f32 slot scores (acoustic+lm) and correctness
    counts; start/ok/final: (B, L, W) f32 flags (nonzero = set); pidx:
    (B, L, W, P) int32 predecessor positions into the flat (L*W+1,)
    buffer, dump slot L*W (``losses.lattice.lattice_frontiers``).

    Returns (alpha (B,L,W), c_alpha (B,L,W), logZ (B,), c_avg (B,)).  On
    the card alpha/c_alpha are views of the kernel's (B, L*W+1) scratch
    buffers without their dump slot.
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
    abuf = torch.empty((B, LW + 1), dtype=torch.float32, device=dev)
    cbuf = torch.empty((B, LW + 1), dtype=torch.float32, device=dev)
    logz = torch.empty((B,), dtype=torch.float32, device=dev)
    cavg = torch.empty((B,), dtype=torch.float32, device=dev)
    if B:
        _launch("dag_forward_launch", dev, own.data_ptr(), corr.data_ptr(),
                start.data_ptr(), ok.data_ptr(), final.data_ptr(),
                pidx.data_ptr(), abuf.data_ptr(), cbuf.data_ptr(),
                logz.data_ptr(), cavg.data_ptr(), B, L, W, P, _threads(W))
        dag_forward.launches += 1
    return (abuf[:, :LW].unflatten(1, (L, W)),
            cbuf[:, :LW].unflatten(1, (L, W)), logz, cavg)


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
    """The fused kernel's input preparation, in PyTorch (outside the
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

    On the card the prologue (``loss_only_prologue``, shared with
    ``dag_loss_only``) runs as PyTorch ops and ONE kernel does the
    endpoint gather, the arc -> (S, W) gather and the forward recursion;
    only the two (B,) outputs leave it."""
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
    if (T + 2) * K >= 2 ** 31:
        raise ValueError(f"{name}: the (T+2)*K = {(T + 2) * K} cumsum grid "
                         f"row overflows the kernel's int32 gather indices")
    zeros = torch.zeros_like(arc_mask)
    cumext, idx, fcs = loss_only_prologue(log_probs, start, end, label, lm,
                                          corr, arc_mask, zeros, zeros,
                                          kappa)
    return sausage_loss_only_from_grid(cumext, idx, fcs, level_arcs)


def sausage_loss_only_from_grid(cumext, idx, fcs, level_arcs):
    """The fused sausage kernel alone, on the outputs of
    ``loss_only_prologue`` (all on one CUDA device): one launch,
    (logZ (B,), c_avg (B,)) out.  ``sausage_loss_only`` is the entry
    point; this is its launch step."""
    name = "sausage_loss_only"
    B, S, W = level_arcs.shape
    A = fcs.shape[-1]
    _check_shape(name, "idx", idx, (B, 3 * A))
    _check_shape(name, "fcs", fcs, (B, 6, A))
    if not _on_cuda(name, cumext, idx, fcs, level_arcs):
        raise ValueError(f"{name}: the fused kernel takes CUDA tensors")
    for arg, t, dtype in (("cumext", cumext, torch.float32),
                          ("idx", idx, torch.int32),
                          ("fcs", fcs, torch.float32),
                          ("level_arcs", level_arcs, torch.int32)):
        _check_kernel_input(name, arg, t, dtype)
    dev = cumext.device
    logz = torch.empty((B,), dtype=torch.float32, device=dev)
    cavg = torch.empty_like(logz)
    if B:
        launch("lattice_sausage", "sausage_loss_only_launch", dev,
               cumext.data_ptr(), cumext.shape[1], idx.data_ptr(),
               fcs.data_ptr(), level_arcs.data_ptr(), logz.data_ptr(),
               cavg.data_ptr(), B, A, S, W)
        sausage_loss_only.launches += 1
    return logz, cavg


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
