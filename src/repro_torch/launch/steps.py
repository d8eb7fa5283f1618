"""Step builder for lattice sequence training.

Port of ``repro.launch.steps.acoustic_forward_fn`` and
``build_sequence_step``: one uniform update for any registered optimiser
— the paper's SGD/Adam-vs-NGHF comparison included —

    step, opt = build_sequence_step(acfg, "nghf", loss="mpe", kappa=0.5)
    params, opt_state, metrics = step(params, opt.init(params),
                                      grad_batch, cg_batch)

with both batches from ``data.synthetic.asr_batch`` (feats + labels + a
``Lattice``).  The CG batch is explicit because the paper samples it from
the whole training set (Sec. 4.1); first-order optimisers ignore it
(``opt.uses_cg_batch``).  The port runs on one device: ``mesh`` and
``state_sharding`` raise ``NotImplementedError`` until the distribution
slice.
"""
from __future__ import annotations

from typing import Callable, Tuple

from repro_torch.core.optim import Optimizer, get_optimizer
from repro_torch.losses.sequence import get_loss
from repro_torch.models import acoustic


def scalar_metrics(metrics: dict) -> dict:
    """Keep the 0-d entries (tensors or Python numbers)."""
    return {k: v for k, v in metrics.items()
            if getattr(v, "ndim", 0) == 0}


def acoustic_forward_fn(acfg) -> Callable:
    """forward for the acoustic models: (params, batch) -> (logits, 0.0)."""
    def fwd(params, batch):
        return acoustic.forward(acfg, params, batch["feats"]), 0.0
    return fwd


def build_sequence_step(acfg, opt_spec, *, loss: str = "mpe",
                        kappa: float = 0.5, backend: str = "auto",
                        mesh=None, state_sharding=None, share_counts=None,
                        timer=None, **opt_overrides
                        ) -> Tuple[Callable, Optimizer]:
    """Returns ``(step, opt)``; ``step(params, opt_state, grad_batch,
    cg_batch=None) -> (params, opt_state, scalar metrics)``.

    ``backend``: lattice-engine backend, ``"auto" | "cuda" |
    "levelized"`` (``lattice_engine.api``).  ``timer``: an optional
    ``core.timing.StageTimer`` for second-order optimisers.
    """
    if mesh is not None:
        raise NotImplementedError(
            "mesh: the port's sequence step runs on one device; the "
            "distribution slice brings meshes")
    loss_spec = get_loss(loss, kappa=kappa, backend=backend)
    opt = get_optimizer(opt_spec, acoustic_forward_fn(acfg), loss_spec,
                        share_counts=share_counts,
                        state_sharding=state_sharding, **opt_overrides)
    if timer is not None:
        opt.timer = timer

    def sequence_step(params, opt_state, grad_batch, cg_batch=None):
        new_params, new_state, metrics = opt.step(params, opt_state,
                                                  grad_batch, cg_batch)
        return new_params, new_state, scalar_metrics(metrics)

    return sequence_step, opt
