"""Streaming lattice rescoring: alpha checkpoints + virtual-start resume.

Port of ``repro.serving.streaming``.  A streaming client re-sends a
growing partial lattice as the decoder extends it (same arc ids, new
arcs appended/unmasked).  The session checkpoints the alpha frontier
(``alpha``, ``c_alpha`` per arc) and resumes from the last completed
level by rewriting each *completed* arc — in place, same arc id — as a
zero-span virtual start arc:

  * ``start_t = end_t = 0`` — a zero-span arc's acoustic score is
    exactly 0.0 (the centred-cumsum endpoint difference of one element,
    plus ``span * mu`` with span 0), so
  * ``lm = alpha_checkpoint`` makes the arc's forward score carry the
    checkpointed value bit-for-bit, and
  * ``corr = c_alpha_checkpoint`` does the same for the correctness
    accumulator (a start arc's ``c_alpha`` is its own ``corr``);
  * ``preds = -1`` / ``is_start = True`` cut the recursion below it;
  * completed arcs that neither feed a new arc nor sit on the current
    final frontier are masked out entirely.

Re-levelizing the rewritten DAG collapses every completed level into
level 0, so the resumed forward recursion runs O(remaining levels) steps.

Bit-exactness rests on every dispatch of a session having ONE input
shape (``session_bucket`` + ``packing.pad_to_bucket``): each slot's
predecessor reduction then runs over the same fan in the same order,
and the arc-layout final reduction over the same positions.  On the
card the DAG kernels reduce each slot sequentially, so resume equals
from-scratch bitwise.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.lattice_engine import lattice_forward
from repro_torch.lattice_engine.common import LossStats, finalize_loss_only
from repro_torch.losses.lattice import batch_lattices, levelize_arcs
from repro_torch.serving.packing import (BucketSpec, fits, lattice_dims,
                                         pack_log_probs, pad_to_bucket)


def session_bucket(d: dict, *, batch: int = 1) -> BucketSpec:
    """Pin a streaming session's dispatch shape from the final lattice
    envelope.  ``level_width`` is the arc count, not the lattice's own
    level width: resume collapses every completed level into level 0,
    whose width is bounded only by the number of surviving arcs."""
    dims = lattice_dims(d)
    return BucketSpec(
        batch=batch,
        num_arcs=dims.num_arcs,
        num_frames=dims.num_frames,
        num_levels=max(dims.num_levels, 1),
        level_width=max(dims.num_arcs, dims.level_width, 1),
        fan=dims.fan,
    )


def truncate_levels(d: dict, n_levels_done: int) -> dict:  # reprolint: host: numpy lattice edit
    """The partial lattice a streaming client would send after the first
    ``n_levels_done`` topological levels: later arcs masked out, the
    current frontier (arcs with no surviving successor) marked final."""
    la = d.get("level_arcs")
    if la is None:
        la = levelize_arcs(d["preds"], d["is_start"], d["arc_mask"])
    keep = np.zeros_like(np.asarray(d["arc_mask"], bool))
    for lv in range(min(n_levels_done, la.shape[0])):
        ids = la[lv][la[lv] >= 0]
        keep[ids] = True
    out = dict(d)
    out["arc_mask"] = np.asarray(d["arc_mask"], bool) & keep
    is_final = np.zeros_like(np.asarray(d["is_final"], bool))
    for a in np.where(out["arc_mask"])[0]:
        succ = d["succs"][a]
        succ = succ[succ >= 0]
        if len(succ) == 0 or not out["arc_mask"][succ].any():
            is_final[a] = True
    out["is_final"] = is_final
    out["level_arcs"] = levelize_arcs(out["preds"], out["is_start"],
                                      out["arc_mask"])
    return out


def resume_lattice_dict(d: dict, done, alpha, c_alpha) -> dict:  # reprolint: host: numpy edit
    """Rewrite the completed arcs of ``d`` as virtual start arcs carrying
    the checkpointed (alpha, c_alpha) — see the module docstring.  Arc
    ids/positions are preserved, so per-arc outputs line up with ``d``."""
    mask = np.asarray(d["arc_mask"], bool)
    done = np.asarray(done, bool) & mask
    new = mask & ~done
    out = {k: np.array(v, copy=True) for k, v in d.items()}
    A = mask.shape[0]
    needed = np.zeros(A, bool)
    for a in np.where(new)[0]:
        ps = d["preds"][a]
        ps = ps[ps >= 0]
        needed[ps[done[ps]]] = True
    keep_virtual = done & (needed | np.asarray(d["is_final"], bool))
    out["start_t"][done] = 0
    out["end_t"][done] = 0
    out["lm"][done] = alpha[done]
    out["corr"][done] = c_alpha[done]
    out["preds"][done] = -1
    out["is_start"][done] = True
    out["arc_mask"] = new | keep_virtual
    out["level_arcs"] = levelize_arcs(out["preds"], out["is_start"],
                                      out["arc_mask"])
    return out


class StreamSession:
    """One request's streaming rescoring state.

    ``rescore(d, log_probs)`` accepts successive snapshots of a growing
    lattice (arc ids stable, arcs only ever added) and returns the
    current ``LossStats`` — bit-identical to ``rescore_from_scratch`` on
    the same snapshot, at O(levels since last call) forward cost.
    """

    def __init__(self, spec: BucketSpec, *, kappa: float,
                 backend: str = "auto", resume_levels: int | None = None,
                 device=DEFAULT_DEVICE):
        """``resume_levels`` opts into the *fast* resume path: when the
        client checkpoints at least every ``resume_levels`` topological
        levels, resume lattices (whose depth collapses to 1 + levels
        grown) dispatch at a shallow ``resume_levels + 1``-level bucket
        instead of the full one — compute proportional to the growth.
        The shallow bucket is a second input shape, so its results are
        held to from-scratch by float tolerance, not bitwise; leave it
        ``None`` for the single-shape bit-pinned mode.  A growth spurt
        deeper than ``resume_levels`` falls back to the full bucket."""
        self.spec = spec._replace(batch=1)
        self.kappa = kappa
        self.backend = backend
        self.resume_levels = resume_levels
        self.device = resolve_device(device)
        self._shapes = set()       # distinct input shapes dispatched
        self._done = None          # (A,) bool: arcs already folded in
        self._alpha = None         # (A,) f32 checkpoint
        self._c_alpha = None

    @property
    def traces(self) -> int:
        """Number of distinct input shapes this session has dispatched
        (1 in the bit-pinned mode; the reference's jit trace count)."""
        return len(self._shapes)

    def _run(self, lat, lp):
        self._shapes.add((tuple(lat.level_arcs.shape),
                          tuple(lat.preds.shape), tuple(lp.shape)))
        # The reference asks for the full statistics and XLA drops all but
        # alpha/c_alpha; eager PyTorch would run them all, so the session
        # runs the forward recursion alone (one dag_forward on the card)
        # and reduces (logZ, c_avg) in arc layout, as the reference does.
        alpha, c_alpha = lattice_forward(lat, lp, self.kappa,
                                         backend=self.backend)
        return alpha, c_alpha, finalize_loss_only(lat, alpha, c_alpha)

    def _dispatch(self, d: dict, log_probs,  # reprolint: host: the checkpoint lives on the host
                  spec: BucketSpec | None = None) -> tuple:
        spec = spec or self.spec
        lat = batch_lattices([pad_to_bucket(d, spec)], device=self.device)
        lp = torch.from_numpy(pack_log_probs([np.asarray(log_probs)],
                                             spec)).to(self.device)
        alpha, c_alpha, fin = self._run(lat, lp)
        return (alpha[0].cpu().numpy(), c_alpha[0].cpu().numpy(),
                LossStats(logZ=fin.logZ.cpu().numpy()[0],
                          c_avg=fin.c_avg.cpu().numpy()[0]))

    def rescore(self, d: dict, log_probs) -> LossStats:  # reprolint: host: numpy checkpoint
        """Rescore the current snapshot, resuming from the checkpoint."""
        padded = pad_to_bucket(d, self.spec)
        mask = np.asarray(padded["arc_mask"], bool)
        if self._done is None:
            alpha, c_alpha, fin = self._dispatch(padded, log_probs)
            self._alpha, self._c_alpha = alpha, c_alpha
        else:
            lost = self._done & ~mask
            if lost.any():
                raise ValueError(
                    f"streaming lattice shrank: {int(lost.sum())} "
                    f"previously-completed arcs are now masked (arc ids "
                    f"must be stable and arcs only ever added)")
            rd = resume_lattice_dict(padded, self._done, self._alpha,
                                     self._c_alpha)
            spec = None
            if self.resume_levels is not None:
                shallow = self.spec._replace(
                    num_levels=min(self.resume_levels + 1,
                                   self.spec.num_levels))
                if fits(lattice_dims(rd), shallow):
                    spec = shallow
            alpha, c_alpha, fin = self._dispatch(rd, log_probs, spec)
            new = mask & ~self._done
            self._alpha[new] = alpha[new]
            self._c_alpha[new] = c_alpha[new]
        self._done = mask
        return fin

    def rescore_from_scratch(self, d: dict, log_probs) -> LossStats:
        """Full recomputation at the session's shape — the bit-exactness
        reference; does not touch the checkpoint."""
        _, _, fin = self._dispatch(pad_to_bucket(d, self.spec), log_probs)
        return fin

    @property
    def checkpoint(self) -> tuple:
        """(done_mask, alpha, c_alpha) — copies of the stored frontier."""
        if self._done is None:
            return None
        return (self._done.copy(), self._alpha.copy(),
                self._c_alpha.copy())

    def restore(self, done, alpha, c_alpha) -> None:  # reprolint: host: numpy checkpoint
        """Load a (done_mask, alpha, c_alpha) checkpoint — this session's
        own ``checkpoint`` or one carried over by
        ``convert.stream_checkpoint_from_numpy`` — as the frontier the
        next ``rescore`` resumes from."""
        A = self.spec.num_arcs
        done = np.asarray(done, bool)
        alpha = np.asarray(alpha, np.float32)
        c_alpha = np.asarray(c_alpha, np.float32)
        for name, v in (("done", done), ("alpha", alpha),
                        ("c_alpha", c_alpha)):
            if v.shape != (A,):
                raise ValueError(f"checkpoint {name} has shape {v.shape}, "
                                 f"the session's bucket has {A} arcs")
        self._done = done.copy()
        self._alpha = alpha.copy()
        self._c_alpha = c_alpha.copy()
