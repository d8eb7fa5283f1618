"""Shared pieces of the lattice engine: the FBStats contract, arc scoring,
log-semiring helpers, the final reduction from (alpha, beta) to
(logZ, gamma, c_avg), and the sausage-topology check that picks the
CUDA backend's kernels.

Port of ``repro.lattice_engine.common``.  Every backend produces the
same ``FBStats`` in arc layout (B, A), so callers are backend-agnostic.
"""
from __future__ import annotations

import weakref
from typing import NamedTuple

import torch

from repro_torch.losses.lattice import Lattice

NEG = -1e30


class FBStats(NamedTuple):
    alpha: torch.Tensor       # (B, A) forward log score incl. the arc
    beta: torch.Tensor        # (B, A) backward log score excl. the arc
    logZ: torch.Tensor        # (B,) total lattice log score
    gamma: torch.Tensor       # (B, A) arc posterior
    c_alpha: torch.Tensor     # (B, A) expected partial correctness (incl.)
    c_beta: torch.Tensor      # (B, A) expected remaining correctness (excl.)
    c_avg: torch.Tensor       # (B,) expected total correctness
    c_arc: torch.Tensor       # (B, A) c_q = c_alpha + c_beta


class LossStats(NamedTuple):
    """The ``accumulators="loss_only"`` contract: exactly what the MMI/MPE
    loss *values* need — no per-arc statistics, no backward recursion."""

    logZ: torch.Tensor        # (B,) total lattice log score
    c_avg: torch.Tensor       # (B,) expected total correctness


ACCUMULATORS = ("full", "loss_only")


def check_accumulators(accumulators: str) -> str:
    if accumulators not in ACCUMULATORS:
        raise ValueError(
            f"unknown accumulators mode {accumulators!r}; expected one of "
            f"{ACCUMULATORS}")
    return accumulators


def arc_scores(lat: Lattice, log_probs: torch.Tensor, kappa: float):
    """Per-arc acoustic score: kappa * sum_{t in span} log p(label | o_t),
    (B, A) f32, via the mean-centred cumsum endpoint gather (one O(T*K)
    pass + 2A gathered elements; centring keeps short-span endpoint
    differences exact enough at large T).  The identity lives in
    ``kernels.ref.sausage_arc_scores_ref``."""
    from repro_torch.kernels.ref import sausage_arc_scores_ref
    return sausage_arc_scores_ref(log_probs, lat.start_t, lat.end_t,
                                  lat.label, kappa)


def gather_log(arr, idx):
    """arr: (A,), idx: (...,) with -1 padding -> values with NEG at pads."""
    return gather_lin(arr, idx, NEG)


def gather_lin(arr, idx, fill=0.0):
    safe = idx.clamp(min=0).long()
    return torch.where(idx >= 0, arr[safe], torch.full_like(arr[safe], fill))


def masked_logsumexp(x, dim=-1):
    """logsumexp treating entries at/near ``NEG`` as masked; an all-masked
    row returns exactly ``NEG`` (masked entries are zeroed before the sum,
    so no exp(0)=1 of a masked row leaks in)."""
    valid = x > NEG * 0.5
    any_valid = valid.any(dim=dim)
    m = x.amax(dim=dim, keepdim=True)
    m = torch.where(m > NEG * 0.5, m, torch.zeros_like(m))
    e = torch.where(valid, torch.exp(x - m), torch.zeros_like(x))
    s = e.sum(dim=dim)
    out = torch.log(torch.where(any_valid, s, torch.ones_like(s))) \
        + m.squeeze(dim)
    return torch.where(any_valid, out.clamp(min=NEG),
                       torch.full_like(out, NEG))


def masked_softmax(x, dim=-1):
    """Softmax companion of ``masked_logsumexp``: all-masked rows get
    all-zero weights (not uniform 1/W)."""
    valid = x > NEG * 0.5
    m = x.amax(dim=dim, keepdim=True)
    m = torch.where(m > NEG * 0.5, m, torch.zeros_like(m))
    e = torch.where(valid, torch.exp(x - m), torch.zeros_like(x))
    s = e.sum(dim=dim, keepdim=True)
    # any valid row has s >= 1 (the max contributes exp(0)); masked rows
    # divide 0 by 1
    return e / s.clamp(min=1.0)


def from_level_major(values, arc_pos, num_arcs: int, fill):
    """(B, L, W) or (B, L*W) level-major values -> (B, A) arc layout via
    ``Frontiers.arc_pos``; arcs in no slot (masked, padding) read the dump
    slot, which holds ``fill``."""
    B = values.shape[0]
    buf = torch.cat([values.reshape(B, -1),
                     torch.full((B, 1), fill, dtype=values.dtype,
                                device=values.device)], dim=1)
    return buf.gather(1, arc_pos[:, :num_arcs].long())


def finalize_loss_only(lat: Lattice, alpha, c_alpha) -> LossStats:
    """Reduce forward-only scores to (logZ, c_avg) — the final-arc
    reduction shared by both accumulator modes."""
    final_alpha = torch.where(lat.is_final & lat.arc_mask, alpha,
                              torch.full_like(alpha, NEG))
    logZ = masked_logsumexp(final_alpha, dim=-1)               # (B,)
    wf = masked_softmax(final_alpha, dim=-1)
    c_avg = (wf * c_alpha).sum(dim=-1)
    return LossStats(logZ=logZ, c_avg=c_avg)


def finalize(lat: Lattice, alpha, beta, c_alpha, c_beta) -> FBStats:
    """Reduce per-arc forward/backward scores to the full statistics set."""
    logZ, c_avg = finalize_loss_only(lat, alpha, c_alpha)
    gamma = torch.where(lat.arc_mask,
                        torch.exp(alpha + beta - logZ[:, None]),
                        torch.zeros_like(alpha))
    return FBStats(alpha=alpha, beta=beta, logZ=logZ, gamma=gamma,
                   c_alpha=c_alpha, c_beta=c_beta, c_avg=c_avg,
                   c_arc=c_alpha + c_beta)


def _is_sausage_uncached(lat: Lattice) -> bool:  # reprolint: host: cached topology check
    # host copies of the index fields; inside a torch.func transform even
    # untransformed tensors refuse .numpy() unless functorch is paused
    with torch._C._DisableFuncTorch():
        la, preds, mask, is_start, is_final = (
            t.cpu().numpy() for t in (lat.level_arcs, lat.preds,
                                      lat.arc_mask, lat.is_start,
                                      lat.is_final))
    for b in range(la.shape[0]):
        levels = [set(row[row >= 0].tolist()) for row in la[b]]
        levels = [lv for lv in levels if lv]
        if not levels:
            return False
        for li, lv in enumerate(levels):
            prev = levels[li - 1] if li > 0 else set()
            last = li == len(levels) - 1
            for a in lv:
                p = preds[b, a]
                p = {int(x) for x in p[p >= 0] if mask[b, x]}
                if li == 0:
                    if not is_start[b, a] and p:
                        return False
                elif p != prev:
                    return False
                if bool(is_final[b, a]) != last:
                    return False
    return True


_SAUSAGE_CACHE: dict = {}


def lattice_is_sausage(lat: Lattice) -> bool:
    """Topology check: True iff every level is fully connected to the
    previous one and exactly the last level's arcs are final — the
    contract of the sausage kernels.

    The walk needs host copies of the lattice's index fields (one device
    sync), so it is memoized per ``level_arcs`` tensor, as the reference
    memoizes per array: a lattice's tensors are treated as immutable, and
    a training loop pays the walk once per batch, not once per
    statistics call."""
    key_obj = lat.level_arcs
    if key_obj is None:
        return False
    k = id(key_obj)
    hit = _SAUSAGE_CACHE.get(k)
    if hit is not None and hit[0]() is key_obj:
        return hit[1]
    val = _is_sausage_uncached(lat)
    if len(_SAUSAGE_CACHE) > 256:
        _SAUSAGE_CACHE.clear()
    _SAUSAGE_CACHE[k] = (weakref.ref(key_obj), val)
    return val
