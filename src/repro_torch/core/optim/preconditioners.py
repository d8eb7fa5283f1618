"""Pluggable diagonal preconditioners for the CG stage (paper Sec. 4.3 +
Sainath et al. 2013).

Port of ``repro.core.optim.preconditioners``:

    pre    = get_preconditioner(name, share_counts=...)
    pstate = pre.init(params)                  # dict ({} if stateless)
    pstate = pre.update(pstate, grads, constrain=None)  # gradient stage
    minv   = pre.apply_fn(pstate)              # None | (r -> M⁻¹ r)

  identity      — no preconditioning (``apply_fn`` is None).
  share_counts  — M = diag(c), c = per-leaf application counts (Sec. 4.3).
  fisher_diag   — M⁻¹ r = r / (d̂ + ε)^α with d̂ the bias-corrected EMA of
                  the squared gradient-stage gradient.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.core import tree_math as tm
from repro_torch.core.optim.base import scalar_on, theta_zeros


class Preconditioner:
    """Stateless base: no state, no-op update, no preconditioning."""

    name = "identity"
    has_state = False

    def state_template(self, theta: Callable, scalar: Callable) -> Dict:
        return {}

    def init(self, params) -> Dict:
        return self.state_template(
            lambda cast=None: theta_zeros(params, cast), scalar_on(params))

    def update(self, pstate, grads, constrain=None):
        """Gradient-stage accumulation; ``constrain`` (a ``tree_math.
        Layout``, under a mesh) checks theta-sized state against the
        optimiser's state layout."""
        return pstate

    def apply_fn(self, pstate) -> Optional[Callable]:
        return None


class IdentityPreconditioner(Preconditioner):
    pass


class ShareCountsPreconditioner(Preconditioner):
    """Sec. 4.3: M = diag(c), c broadcast per leaf."""

    name = "share_counts"

    def __init__(self, counts: Optional[dict]):
        self.counts = counts

    def apply_fn(self, pstate):
        if self.counts is None:
            return None
        counts = self.counts
        return lambda t: tm.div(t, counts)


class FisherDiagPreconditioner(Preconditioner):
    """d ← β d + (1-β) g² per leaf (f32), M⁻¹ r = r / (d̂ + ε)^α."""

    name = "fisher_diag"
    has_state = True

    def __init__(self, decay: float = 0.95, eps: float = 1e-4,
                 power: float = 0.75):
        self.decay, self.eps, self.power = decay, eps, power

    def state_template(self, theta, scalar):
        return {"d": theta(cast=lambda p: torch.float32),
                "n": scalar(torch.int32, 0)}

    def update(self, pstate, grads, constrain=None):
        b = self.decay
        d = {k: b * dd + (1.0 - b) * grads[k].to(torch.float32) ** 2
             for k, dd in pstate["d"].items()}
        if constrain is not None:
            d = constrain(d)
        return {"d": d, "n": pstate["n"] + 1}

    def apply_fn(self, pstate):
        bc = 1.0 - self.decay ** pstate["n"].to(torch.float32).clamp(min=1.0)

        def minv(t):
            return {k: (x.to(torch.float32)
                        * (pstate["d"][k] / bc + self.eps) ** -self.power
                        ).to(x.dtype) for k, x in t.items()}

        return minv


def get_preconditioner(name: str, *, share_counts=None,
                       fisher_decay: float = 0.95, fisher_eps: float = 1e-4,
                       fisher_power: float = 0.75) -> Preconditioner:
    if name == "identity":
        return IdentityPreconditioner()
    if name == "share_counts":
        return ShareCountsPreconditioner(share_counts)
    if name == "fisher_diag":
        return FisherDiagPreconditioner(decay=fisher_decay, eps=fisher_eps,
                                        power=fisher_power)
    raise ValueError(f"unknown preconditioner {name!r} "
                     "(identity | share_counts | fisher_diag)")


PRECONDITIONERS = ("identity", "share_counts", "fisher_diag")
