"""Loss specifications with matched curvature factors.

Port of ``repro.losses.sequence``.  A loss spec packages everything NGHF
needs from a training criterion (paper Secs. 3.2, 3.4, 5.2):

    value(logits, batch, accumulators="full") -> (scalar loss, metrics)
    logit_grad(logits, batch)     -> G = dL/dlogits            (B,T,K)
    gn_vp(logits, batch, u)       -> per-frame GN factor product  H^ u
    fisher_vp(logits, batch, u)   -> per-frame empirical-Fisher product F^ u

``value``'s ``accumulators`` selects the lattice-engine statistics mode:
``"loss_only"`` computes only what the loss value needs (no backward
recursion; on the CUDA backend one fused forward kernel) — what CG
candidate evaluation runs.  Non-lattice losses accept and ignore it.

``logit_grad`` is ``torch.autograd.grad`` of ``value`` w.r.t. a detached
f32 copy of the logits.  The curvature products call it from
``gn_vp``/``fisher_vp`` outside any ``torch.func`` transform
(``core.curvature`` computes the factor from the plain primal logits),
so no transform ever wraps that autograd call.

Normalisation convention: ``value`` is a batch *mean*; both curvature
factors are normalised the same way (mean over loss atoms).  Under a
mesh each rank holds a share of the batch, and the means must stay the
whole batch's: ``normalisers(batch)`` gives the counts a spec divides by
(rows; MMI's real frames; CE's mask sum) summed over the share, the
caller (``core.curvature.shard_for``) sums them over the data group once
per batch and hands them back as ``batch["norms"]``, and every value,
metric and factor then divides this rank's sums by those global counts.
Without ``"norms"`` each spec divides by its batch's own counts.

Matrix-free identities (never materialising K x K blocks):
  CE / matching loss :  H^u = w (p ⊙ u - p (pᵀu)),   ĝ = w (p - y)
  MPE (Eqn. 11)      :  H^u = κ² w (y ⊙ u) + κ G (yᵀu)
  MMI Fisher (Eq.19) :  F^u = S · G_mmi (G_mmiᵀ u)  per frame, S = #atoms
For lattice training the Fisher always comes from the MMI loss (Sec. 5.2).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.lattice_engine import lattice_stats
from repro_torch.losses.lattice import (Lattice, lattice_frame_counts,
                                        lattice_frame_mask)


def _one_hot(labels, num_states: int):
    """(…,) int labels -> (…, K) f32 one-hot, by a scatter (``F.one_hot``
    checks the labels' range on the host, a device sync per call)."""
    out = torch.zeros(labels.shape + (num_states,), dtype=torch.float32,
                      device=labels.device)
    return out.scatter_(-1, labels.long()[..., None], 1.0)


def _norm(batch, key: str, local):
    """The normaliser ``key`` of ``batch``: the global count handed in
    under ``batch["norms"]``, else ``local`` (the batch's own)."""
    norms = batch.get("norms")
    return local if norms is None else norms[key]


def _mean(x, batch):
    """The batch mean of per-utterance values: over the global rows
    under ``batch["norms"]``, else ``x.mean()``."""
    norms = batch.get("norms")
    return x.mean() if norms is None else x.sum() / norms["rows"]


def _rows(x) -> torch.Tensor:
    return torch.tensor(float(x.shape[0]), device=x.device)


def _grad_of_value(spec, logits, batch):
    lg = logits.detach().to(torch.float32).requires_grad_(True)
    with torch.enable_grad():
        loss = spec.value(lg, batch)[0]
    return torch.autograd.grad(loss, lg)[0]


class CELoss:
    """Mean token/frame CE.  batch["labels"]: (B,T) int; optional
    batch["label_mask"]: (B,T)."""

    name = "ce"

    def _mask(self, batch):
        m = batch.get("label_mask")
        if m is None:
            labels = batch["labels"]
            m = torch.ones(labels.shape[:2], dtype=torch.float32,
                           device=labels.device)
        return m.to(torch.float32)

    def _denom(self, m, batch):
        return _norm(batch, "mask", m.sum()).clamp(min=1.0)

    def normalisers(self, batch) -> dict:
        return {"mask": self._mask(batch).sum()}

    def value(self, logits, batch, accumulators: str = "full"):
        labels = batch["labels"].long()
        m = self._mask(batch)
        lp = F.log_softmax(logits.to(torch.float32), -1)
        nll = -lp.gather(-1, labels[..., None])[..., 0]
        denom = self._denom(m, batch)
        loss = (nll * m).sum() / denom
        acc = ((logits.argmax(-1) == labels) * m).sum() / denom
        return loss, {"ce": loss, "acc": acc}

    def logit_grad(self, logits, batch):
        labels = batch["labels"].long()
        m = self._mask(batch)
        p = F.softmax(logits.to(torch.float32), -1)
        y = _one_hot(labels, logits.shape[-1])
        w = m / self._denom(m, batch)
        return (p - y) * w[..., None]

    def gn_vp(self, logits, batch, u):
        m = self._mask(batch)
        p = F.softmax(logits.to(torch.float32), -1)
        w = m / self._denom(m, batch)
        pu = (p * u).sum(-1, keepdim=True)
        return w[..., None] * (p * u - p * pu)

    def fisher_vp(self, logits, batch, u):
        g = self.logit_grad(logits, batch)
        S = self._denom(self._mask(batch), batch)
        gu = (g * u).sum(-1, keepdim=True)
        return S * g * gu


def _ref_one_hot(lat: Lattice, num_states: int):
    """(B, T, K) one-hot reference alignment, zero on padded frames."""
    return _one_hot(lat.ref_states, num_states) \
        * lattice_frame_mask(lat)[..., None]


class MMILoss:
    """L = -(1/Σ_b T_b) Σ_b (num_score_b - logZ_den_b), with T_b the REAL
    per-utterance frame count.  batch["lattice"]: Lattice."""

    name = "mmi"

    def __init__(self, kappa: float = 1.0, backend: str = "auto"):
        self.kappa = kappa
        self.backend = backend

    def _frames(self, batch):
        frames = lattice_frame_counts(batch["lattice"]).sum()
        return _norm(batch, "frames", frames).clamp(min=1.0)

    def normalisers(self, batch) -> dict:
        lat: Lattice = batch["lattice"]
        return {"rows": _rows(lat.num_ref_units),
                "frames": lattice_frame_counts(lat).sum()}

    def value(self, logits, batch, accumulators: str = "full"):
        lat: Lattice = batch["lattice"]
        lp = F.log_softmax(logits.to(torch.float32), -1)
        ref_lp = lp.gather(-1, lat.ref_states.long()[..., None])[..., 0]
        num = self.kappa * (ref_lp * lattice_frame_mask(lat)).sum(-1)
        stats = lattice_stats(lat, lp, self.kappa, backend=self.backend,
                              accumulators=accumulators)
        loss = -(num - stats.logZ).sum() / self._frames(batch)
        return loss, {"mmi": loss, "logZ": _mean(stats.logZ, batch)}

    def logit_grad(self, logits, batch):
        return _grad_of_value(self, logits, batch)

    def gn_vp(self, logits, batch, u):
        """Exact GN of the numerator matching part plus the rank-1
        denominator term from ``logit_grad`` (same structure as MPE's)."""
        lat: Lattice = batch["lattice"]
        w = self.kappa ** 2 / self._frames(batch)
        y = _ref_one_hot(lat, logits.shape[-1])
        g = self.logit_grad(logits, batch)
        yu = (y * u).sum(-1, keepdim=True)
        return w * (y * u) + self.kappa * g * yu

    def fisher_vp(self, logits, batch, u):
        g = self.logit_grad(logits, batch)
        gu = (g * u).sum(-1, keepdim=True)
        return self._frames(batch) * g * gu


class MPELoss:
    """L = -(1/B) Σ_b c_avg_b / n_ref_units_b (negative expected phone
    accuracy); ``metrics["mpe_acc"]`` is the paper's "MPE Acc"."""

    name = "mpe"

    def __init__(self, kappa: float = 1.0, backend: str = "auto"):
        self.kappa = kappa
        self.backend = backend
        self._mmi = MMILoss(kappa, backend=backend)

    def normalisers(self, batch) -> dict:
        return self._mmi.normalisers(batch)

    def value(self, logits, batch, accumulators: str = "full"):
        lat: Lattice = batch["lattice"]
        lp = F.log_softmax(logits.to(torch.float32), -1)
        stats = lattice_stats(lat, lp, self.kappa, backend=self.backend,
                              accumulators=accumulators)
        acc = stats.c_avg / lat.num_ref_units.clamp(min=1.0)
        mean_acc = _mean(acc, batch)
        return -mean_acc, {"mpe_acc": mean_acc,
                           "logZ": _mean(stats.logZ, batch)}

    def logit_grad(self, logits, batch):
        return _grad_of_value(self, logits, batch)

    def gn_vp(self, logits, batch, u):
        """Eqn. 11 via the Sec. 3.4 Hadamard form:
        H^u = κ² w (y ⊙ u) + κ G (yᵀu), G = dL/dlogits; edge-padded frames
        are masked out of the matching term."""
        lat: Lattice = batch["lattice"]
        B = _norm(batch, "rows", logits.shape[0])
        w = (1.0 / (B * lat.num_ref_units.clamp(min=1.0)))[:, None, None]
        y = _ref_one_hot(lat, logits.shape[-1])
        g = self.logit_grad(logits, batch)
        yu = (y * u).sum(-1, keepdim=True)
        return (self.kappa ** 2) * w * (y * u) + self.kappa * g * yu

    def fisher_vp(self, logits, batch, u):
        """Fisher from the *MMI* loss (Sec. 5.2), whatever the training
        criterion — NGHF's MPE/MMI interpolation."""
        return self._mmi.fisher_vp(logits, batch, u)


def get_loss(name: str, kappa: float = 1.0, backend: str = "auto"):
    if name == "ce":
        return CELoss()
    if name == "mmi":
        return MMILoss(kappa, backend=backend)
    if name == "mpe":
        return MPELoss(kappa, backend=backend)
    raise ValueError(f"unknown loss {name!r} (ce | mmi | mpe)")
