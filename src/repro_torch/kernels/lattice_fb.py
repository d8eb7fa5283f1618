"""Wrappers of the hand-written Hopper lattice kernels
(``csrc/lattice_dag.cu``, ``csrc/lattice_sausage.cu``).

Port of ``repro.kernels.lattice_fb``: the general-DAG ``dag_forward``,
``dag_backward`` and fused ``dag_loss_only``, and the sausage
``sausage_forward``, ``sausage_backward`` and fused
``sausage_loss_only``.  The two loss-only kernels read the raw (B, T, K)
log-probs on the card (span sums: no cumsum grid).  The three DAG
kernels share one compacted recursion over the valid slots (its state in
shared memory, or global scratch when it does not fit:
``dag_*_plan``, ``dag_branches``).  Each wrapper checks shapes; for
tensors on the CPU it returns its plain version from ``kernels.ref``;
for tensors on a CUDA device it checks dtype and contiguity, allocates
outputs and scratch, launches its kernel on the current stream and
raises if the launch was refused.  There is no fallback from the kernel
to the plain version.  The kernels compute in f32: a float input of
another dtype (bf16) is cast to f32 on entry, as the plain versions
compute, and the outputs are f32 on both routes.

Each launch, and each plain call on the CPU, is recorded for the kernel
sanitizer inside ``instrument.capture_calls`` (``instrument.record``:
the launcher, its plan and its index operands).

Each wrapper keeps a plain integer ``launches`` (``dag_forward.launches``
...), raised by one at each kernel launch and nowhere else, so a run can
show that its path went through the kernels.  The wrappers compute
values; gradients come from the occupancy-identity ``autograd.Function``s
of ``lattice_engine.cuda_backend``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, instrument, ref

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
        # own corr final ok sidx map pos gstate | gstride | bbuf cbbuf |
        # B L W S threads smem_bytes
        "dag_backward_launch": [_PTR] * 8 + [_LL] + [_PTR] * 2 + [_INT] * 6
        + [_PTR],
        # lp start end label lm corr mask is_start is_final | bool_flags |
        # level_arcs pidx map pos gstate | gstride | logz cavg | kappa |
        # B T K A L W P threads smem_bytes
        "dag_loss_only_launch": [_PTR] * 9 + [_INT] + [_PTR] * 5 + [_LL]
        + [_PTR] * 2 + [ctypes.c_float] + [_INT] * 9 + [_PTR],
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


# launcher -> the library (``csrc/<stem>.cu``) that holds it
LAUNCHERS = {fn: stem for stem, fns in _SIGNATURES.items() for fn in fns}


def launch(stem: str, fn: str, device: torch.device, *args) -> None:
    build.launch(stem, _SIGNATURES[stem], fn, device, *args)


def _record(fn: str, route: str, config: dict, **operands) -> None:
    instrument.record(LAUNCHERS[fn], fn, route, config, **operands)


def _launch(fn: str, device: torch.device, *args) -> None:
    launch("lattice_dag", fn, device, *args)


def _f32(t):
    return t.to(torch.float32).contiguous()


def _i32(t):
    return t.to(torch.int32).contiguous()


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


def _f32_inputs(name: str, ts: dict) -> list:
    """The float inputs of a kernel that computes in f32, cast to f32 as
    the plain versions do (a bf16 caller gets f32 outputs); an input that
    is not contiguous is refused, whatever its dtype."""
    out = []
    for arg, t in ts.items():
        t = t.to(torch.float32)
        _check_kernel_input(name, arg, t, torch.float32)
        out.append(t)
    return out


def _dag_config(B: int, plan: tuple) -> dict:
    threads, smem, gstride = plan
    return {"grid": (B,), "threads": threads, "smem": smem,
            "gstride": gstride}


def dag_forward_state_bytes(n_valid: int, L: int, P: int) -> int:
    """Bytes of the compact state of ``dag_forward`` and ``dag_loss_only``
    for an utterance with ``n_valid`` valid slots over L levels with P
    predecessors a slot: alpha, c_alpha and flags for ids 0..n_valid (9
    bytes each), the L+1 level offsets and the translated predecessor rows
    (``csrc/lattice_dag.cu::compact_bytes``)."""
    return 9 * (n_valid + 1) + 4 * (L + 1) + 4 * n_valid * P


def dag_backward_state_bytes(n_valid: int, L: int, S: int) -> int:
    """Bytes of ``dag_backward``'s compact state: beta, c_beta, own, corr
    and flags for ids 0..n_valid (17 bytes each), the L+1 level offsets
    and the translated successor rows (``compact_bytes``)."""
    return 17 * (n_valid + 1) + 4 * (L + 1) + 4 * n_valid * S


def _plan(LW: int, worst: int) -> tuple:
    threads = min(MAX_THREADS, max(128, -(-LW // (32 * SCAN_ITEMS)) * 32))
    if worst <= SMEM_MAX:
        return threads, worst, 0
    return threads, SMEM_MAX, -(-worst // 16) * 16


def dag_forward_plan(L: int, W: int, P: int) -> tuple:
    """(threads, dynamic shared bytes, global state bytes an utterance)
    of a ``dag_forward`` or ``dag_loss_only`` launch (the same compact
    state).  Shared memory covers the state of an all-valid bucket where
    that fits, else ``SMEM_MAX``; the kernel then counts the valid slots
    and moves a state that does not fit to the global scratch (0 when no
    utterance can need it)."""
    return _plan(L * W, dag_forward_state_bytes(L * W, L, P))


def dag_backward_plan(L: int, W: int, S: int) -> tuple:
    """As :func:`dag_forward_plan`, for ``dag_backward``'s state."""
    return _plan(L * W, dag_backward_state_bytes(L * W, L, S))


_STATE_BYTES = {"dag_forward": dag_forward_state_bytes,
                "dag_loss_only": dag_forward_state_bytes,
                "dag_backward": dag_backward_state_bytes}


def dag_branches(kernel: str, skip, ok, R: int) -> list:  # reprolint: host: logs, tests
    """Per utterance of (B, L, W) ``skip``/``ok`` flags, the branches the
    DAG kernel ``kernel`` ("dag_forward", "dag_loss_only" or
    "dag_backward") takes after its prepass, as ("warp" | "block",
    "shared" | "global").  ``skip`` marks the valid slots that take no
    step: start slots for the two forward kernels, final slots for the
    backward; R is the row width (P or S).  The chain runs on warp 0
    unless a level has more than 32 valid slots that take a step, and the
    compact state lives in shared memory when its bytes for the valid
    slots are at most SMEM_MAX.  The kernel decides both on the card;
    this repeats its rule on the host (for logs and tests)."""
    state_bytes = _STATE_BYTES[kernel]
    B, L = ok.shape[0], ok.shape[1]
    valid = ok > 0.5
    steps = (valid & ~(skip > 0.5)).sum(-1)
    widest = steps.amax(-1).tolist() if L else [0] * B
    n_valid = valid.flatten(1).sum(1).tolist()
    return [("block" if w > 32 else "warp",
             "shared" if state_bytes(n, L, R) <= SMEM_MAX else "global")
            for w, n in zip(widest, n_valid)]


def sausage_loss_only_plan(S: int, W: int) -> tuple:
    """(threads, dynamic shared bytes, global scratch) of a
    ``sausage_loss_only`` launch over (S, W) slots: scores, correctness,
    mask and the long-span list take 16 B a slot in shared memory; past
    ``SMEM_MAX`` they go to a (B, 4, S*W) f32 global scratch and the
    launch takes 0 shared bytes."""
    SW = S * W
    threads = min(1024, max(32, -(-SW // 32) * 32))
    if 16 * SW > SMEM_MAX:
        return threads, 0, True
    return threads, 16 * SW, False


def _scratch(B: int, LW: int, gstride: int, dev) -> tuple:
    """The compacted kernels' int32 scratch: the position -> id map
    (B, LW+1), the valid positions (B, LW) and, when one may be needed,
    the global compact state (B x gstride bytes).  Returns (tensor, map
    pointer, pos pointer, state pointer or None); the caller keeps the
    tensor until its launch is queued."""
    scratch = torch.empty(B * (2 * LW + 1) + B * gstride // 4,
                          dtype=torch.int32, device=dev)
    idx = scratch.data_ptr()
    pos = idx + 4 * B * (LW + 1)
    return scratch, idx, pos, (pos + 4 * B * LW if gstride else None)


def _check_ids(name: str, LW: int) -> None:
    if LW + 1 >= 2 ** 31:
        raise ValueError(f"{name}: L*W = {LW} slots overflow the kernel's "
                         f"int32 compact ids")


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
    P, LW, dev = pidx.shape[-1], L * W, own.device
    threads, smem, gstride = plan = dag_forward_plan(L, W, P)
    if not _on_cuda(name, own, corr, start, ok, final, pidx):
        if B:
            _record("dag_forward_launch", "plain", _dag_config(B, plan),
                    own=own, corr=corr, start=start, ok=ok, final=final,
                    pidx=pidx)
        return ref.dag_forward_ref(own, corr, start, ok, final, pidx)
    own, corr, start, ok, final = _f32_inputs(
        name, {"own": own, "corr": corr, "start": start, "ok": ok,
               "final": final})
    _check_kernel_input(name, "pidx", pidx, torch.int32)
    _check_ids(name, LW)
    # outputs: alpha and c_alpha (2, B, LW+1), then logZ and c_avg (2, B)
    n_out = 2 * B * (LW + 1)
    buf = torch.empty(n_out + 2 * B, dtype=torch.float32, device=dev)
    if B:
        scratch, idx, pos, gstate = _scratch(B, LW, gstride, dev)
        base = buf.data_ptr()
        red = base + 4 * n_out
        _record("dag_forward_launch", "cuda", _dag_config(B, plan),
                own=own, corr=corr, start=start, ok=ok, final=final,
                pidx=pidx)
        _launch("dag_forward_launch", dev, own.data_ptr(), corr.data_ptr(),
                start.data_ptr(), ok.data_ptr(), final.data_ptr(),
                pidx.data_ptr(), idx, pos, gstate, gstride, base,
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
    (B, L, W); on the card views of the kernel's (B, L*W+1) output buffers
    without their dump slot, from the same compacted recursion as
    ``dag_forward``'s, run from the last level to the first."""
    name = "dag_backward"
    B, L, W = own.shape
    for arg, t in (("corr", corr), ("final", final), ("ok", ok)):
        _check_shape(name, arg, t, (B, L, W))
    _check_shape(name, "sidx", sidx, (B, L, W, sidx.shape[-1]))
    S, LW, dev = sidx.shape[-1], L * W, own.device
    threads, smem, gstride = plan = dag_backward_plan(L, W, S)
    if not _on_cuda(name, own, corr, final, ok, sidx):
        if B:
            _record("dag_backward_launch", "plain", _dag_config(B, plan),
                    own=own, corr=corr, final=final, ok=ok, sidx=sidx)
        return ref.dag_backward_ref(own, corr, final, ok, sidx)
    own, corr, final, ok = _f32_inputs(
        name, {"own": own, "corr": corr, "final": final, "ok": ok})
    _check_kernel_input(name, "sidx", sidx, torch.int32)
    _check_ids(name, LW)
    buf = torch.empty(2 * B * (LW + 1), dtype=torch.float32, device=dev)
    if B:
        scratch, idx, pos, gstate = _scratch(B, LW, gstride, dev)
        base = buf.data_ptr()
        _record("dag_backward_launch", "cuda", _dag_config(B, plan),
                own=own, corr=corr, final=final, ok=ok, sidx=sidx)
        _launch("dag_backward_launch", dev, own.data_ptr(), corr.data_ptr(),
                final.data_ptr(), ok.data_ptr(), sidx.data_ptr(), idx, pos,
                gstate, gstride, base, base + 4 * B * (LW + 1), B, L, W, S,
                threads, smem)
        dag_backward.launches += 1
    return (buf.as_strided((B, L, W), (LW + 1, W, 1), 0),
            buf.as_strided((B, L, W), (LW + 1, W, 1), B * (LW + 1)))


def dag_loss_only(log_probs, start, end, label, lm, corr, arc_mask,
                  is_start, is_final, level_arcs, pidx, *,
                  kappa: float = 1.0):
    """Fused loss-only forward for general DAG lattices: (logZ (B,),
    c_avg (B,)) straight from the (B, T, K) frame log-probs and arc-layout
    lattice fields (B, A), with level_arcs (B, L, W) int32 and pidx
    (B, L, W, P) int32 from ``losses.lattice.lattice_frontiers``.

    On the card ONE kernel reads the raw log-probs: each valid slot's arc
    score is kappa times the sum of lp[t, label] over its span plus lm (no
    cumsum grid), then ``dag_forward``'s compacted recursion and its fold
    over the final slots; only the two (B,) outputs leave it.  Frames are
    clamped to [0, T] and labels to [0, K); an arc id outside [0, A) in
    level_arcs is an empty slot.  The mask and start/final flags may be
    bool or f32 (set above 0.5)."""
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
    P, LW, dev = pidx.shape[-1], L * W, log_probs.device
    plan = dag_forward_plan(L, W, P)
    if not _on_cuda(name, log_probs, start, end, label, lm, corr, arc_mask,
                    is_start, is_final, level_arcs, pidx):
        if B:
            _record("dag_loss_only_launch", "plain", _dag_config(B, plan),
                    log_probs=log_probs, start=start, end=end, label=label,
                    arc_mask=arc_mask, level_arcs=level_arcs, pidx=pidx)
        return ref.dag_loss_only_ref(log_probs, start, end, label, lm, corr,
                                     arc_mask, is_start, is_final,
                                     level_arcs, pidx, kappa=kappa)
    if K == 0 and A:
        raise ValueError(f"{name}: K = 0 log-prob columns for {A} arcs")
    _check_ids(name, LW)
    flags = [f.contiguous() if f.dtype == torch.bool else _f32(f)
             for f in (arc_mask, is_start, is_final)]
    bool_flags = sum(1 << i for i, f in enumerate(flags)
                     if f.dtype == torch.bool)
    lp, lm, corr = _f32(log_probs), _f32(lm), _f32(corr)
    start, end, label = _i32(start), _i32(end), _i32(label)
    la, pidx = _i32(level_arcs), _i32(pidx)
    threads, smem, gstride = plan
    out = torch.empty(2 * B, dtype=torch.float32, device=dev)
    if B:
        scratch, idx, pos, gstate = _scratch(B, LW, gstride, dev)
        _record("dag_loss_only_launch", "cuda", _dag_config(B, plan),
                log_probs=lp, start=start, end=end, label=label,
                arc_mask=flags[0], level_arcs=la, pidx=pidx)
        _launch("dag_loss_only_launch", dev, lp.data_ptr(), start.data_ptr(),
                end.data_ptr(), label.data_ptr(), lm.data_ptr(),
                corr.data_ptr(), *(f.data_ptr() for f in flags), bool_flags,
                la.data_ptr(), pidx.data_ptr(), idx, pos, gstate, gstride,
                out.data_ptr(), out.data_ptr() + 4 * B, float(kappa), B, T,
                K, A, L, W, P, threads, smem)
        dag_loss_only.launches += 1
    return out.as_strided((B,), (1,), 0), out.as_strided((B,), (1,), B)


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
    B, S, A = scores.shape
    if not _on_cuda(name, scores, corr, mask):
        if B:
            _record("sausage_forward_launch", "plain", {}, scores=scores,
                    corr=corr, mask=mask)
        return ref.sausage_forward_ref(scores, corr, mask)
    scores, corr, mask = _f32_inputs(
        name, {"scores": scores, "corr": corr, "mask": mask})
    dev = scores.device
    alpha = torch.empty((B, S, A), dtype=torch.float32, device=dev)
    c_alpha = torch.empty_like(alpha)
    logz = torch.empty((B,), dtype=torch.float32, device=dev)
    cavg = torch.empty_like(logz)
    if B:
        _record("sausage_forward_launch", "cuda", {}, scores=scores,
                corr=corr, mask=mask)
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
    B, S, A = scores.shape
    if not _on_cuda(name, scores, corr, mask):
        if B:
            _record("sausage_backward_launch", "plain", {}, scores=scores,
                    corr=corr, mask=mask)
        return ref.sausage_backward_ref(scores, corr, mask)
    scores, corr, mask = _f32_inputs(
        name, {"scores": scores, "corr": corr, "mask": mask})
    dev = scores.device
    beta = torch.empty((B, S, A), dtype=torch.float32, device=dev)
    c_beta = torch.empty_like(beta)
    if B:
        _record("sausage_backward_launch", "cuda", {}, scores=scores,
                corr=corr, mask=mask)
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
    S, W = level_arcs.shape[1], level_arcs.shape[2]
    threads, smem, spill = sausage_loss_only_plan(S, W)
    config = {"grid": (B,), "threads": threads, "smem": smem,
              "scratch": spill}
    if not _on_cuda(name, log_probs, start, end, label, lm, corr, arc_mask,
                    level_arcs):
        if B:
            _record("sausage_loss_only_launch", "plain", config,
                    log_probs=log_probs, start=start, end=end, label=label,
                    arc_mask=arc_mask, level_arcs=level_arcs)
        return ref.sausage_loss_only_ref(log_probs, start, end, label, lm,
                                         corr, arc_mask, level_arcs,
                                         kappa=kappa)
    if K == 0 and A:
        raise ValueError(f"{name}: K = 0 log-prob columns for {A} arcs")
    dev = log_probs.device
    is_bool = arc_mask.dtype == torch.bool
    mask = arc_mask.contiguous() if is_bool else _f32(arc_mask)
    lp = _f32(log_probs)
    start, end, label, la = _i32(start), _i32(end), _i32(label), \
        _i32(level_arcs)
    lm, corr = _f32(lm), _f32(corr)
    out = torch.empty(2 * B, dtype=torch.float32, device=dev)
    if B:
        scratch = torch.empty((B, 4, S * W), dtype=torch.float32,
                              device=dev) if spill else None
        _record("sausage_loss_only_launch", "cuda", config, log_probs=lp,
                start=start, end=end, label=label, arc_mask=mask,
                level_arcs=la)
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
