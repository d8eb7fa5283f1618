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
factors are normalised the same way (mean over loss atoms).

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


def _grad_of_value(spec, logits, batch):
    lg = logits.detach().to(torch.float32).requires_grad_(True)
    with torch.enable_grad():
        loss = spec.value(lg, batch)[0]
    return torch.autograd.grad(loss, lg)[0]


class CELoss:
    """Mean token/frame CE.  batch["labels"]: (B,T) int; optional
    batch["label_mask"]: (B,T)."""

    name = "ce"

    def _mask(self, logits, batch):
        m = batch.get("label_mask")
        if m is None:
            m = torch.ones(logits.shape[:2], dtype=torch.float32,
                           device=logits.device)
        return m.to(torch.float32)

    def value(self, logits, batch, accumulators: str = "full"):
        labels = batch["labels"].long()
        m = self._mask(logits, batch)
        lp = F.log_softmax(logits.to(torch.float32), -1)
        nll = -lp.gather(-1, labels[..., None])[..., 0]
        denom = m.sum().clamp(min=1.0)
        loss = (nll * m).sum() / denom
        acc = ((logits.argmax(-1) == labels) * m).sum() / denom
        return loss, {"ce": loss, "acc": acc}

    def logit_grad(self, logits, batch):
        labels = batch["labels"].long()
        m = self._mask(logits, batch)
        p = F.softmax(logits.to(torch.float32), -1)
        y = _one_hot(labels, logits.shape[-1])
        w = m / m.sum().clamp(min=1.0)
        return (p - y) * w[..., None]

    def gn_vp(self, logits, batch, u):
        m = self._mask(logits, batch)
        p = F.softmax(logits.to(torch.float32), -1)
        w = m / m.sum().clamp(min=1.0)
        pu = (p * u).sum(-1, keepdim=True)
        return w[..., None] * (p * u - p * pu)

    def fisher_vp(self, logits, batch, u):
        g = self.logit_grad(logits, batch)
        S = self._mask(logits, batch).sum().clamp(min=1.0)
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

    def _frames(self, lat: Lattice):
        return lattice_frame_counts(lat).sum().clamp(min=1.0)

    def value(self, logits, batch, accumulators: str = "full"):
        lat: Lattice = batch["lattice"]
        lp = F.log_softmax(logits.to(torch.float32), -1)
        ref_lp = lp.gather(-1, lat.ref_states.long()[..., None])[..., 0]
        num = self.kappa * (ref_lp * lattice_frame_mask(lat)).sum(-1)
        stats = lattice_stats(lat, lp, self.kappa, backend=self.backend,
                              accumulators=accumulators)
        loss = -(num - stats.logZ).sum() / self._frames(lat)
        return loss, {"mmi": loss, "logZ": stats.logZ.mean()}

    def logit_grad(self, logits, batch):
        return _grad_of_value(self, logits, batch)

    def gn_vp(self, logits, batch, u):
        """Exact GN of the numerator matching part plus the rank-1
        denominator term from ``logit_grad`` (same structure as MPE's)."""
        lat: Lattice = batch["lattice"]
        w = self.kappa ** 2 / self._frames(lat)
        y = _ref_one_hot(lat, logits.shape[-1])
        g = self.logit_grad(logits, batch)
        yu = (y * u).sum(-1, keepdim=True)
        return w * (y * u) + self.kappa * g * yu

    def fisher_vp(self, logits, batch, u):
        lat: Lattice = batch["lattice"]
        g = self.logit_grad(logits, batch)
        gu = (g * u).sum(-1, keepdim=True)
        return self._frames(lat) * g * gu


class MPELoss:
    """L = -(1/B) Σ_b c_avg_b / n_ref_units_b (negative expected phone
    accuracy); ``metrics["mpe_acc"]`` is the paper's "MPE Acc"."""

    name = "mpe"

    def __init__(self, kappa: float = 1.0, backend: str = "auto"):
        self.kappa = kappa
        self.backend = backend
        self._mmi = MMILoss(kappa, backend=backend)

    def value(self, logits, batch, accumulators: str = "full"):
        lat: Lattice = batch["lattice"]
        lp = F.log_softmax(logits.to(torch.float32), -1)
        stats = lattice_stats(lat, lp, self.kappa, backend=self.backend,
                              accumulators=accumulators)
        acc = stats.c_avg / lat.num_ref_units.clamp(min=1.0)
        loss = -acc.mean()
        return loss, {"mpe_acc": acc.mean(), "logZ": stats.logZ.mean()}

    def logit_grad(self, logits, batch):
        return _grad_of_value(self, logits, batch)

    def gn_vp(self, logits, batch, u):
        """Eqn. 11 via the Sec. 3.4 Hadamard form:
        H^u = κ² w (y ⊙ u) + κ G (yᵀu), G = dL/dlogits; edge-padded frames
        are masked out of the matching term."""
        lat: Lattice = batch["lattice"]
        B = logits.shape[0]
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
