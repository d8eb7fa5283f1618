"""Step builders: lattice sequence training and LM serving.

Port of ``repro.launch.steps.acoustic_forward_fn``,
``build_sequence_step``, ``build_prefill_step`` and ``build_serve_step``.

Sequence training is one uniform update for any registered optimiser
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

LM serving: ``build_prefill_step(cfg)`` runs a prompt batch through the
backbone and returns the last position's logits (the prefill_32k step;
its windowed-attention layers go through the hand-written kernel on the
card); ``build_serve_step(cfg)`` is one token of batched decode.  Both
run without autograd (``torch.no_grad``).
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from repro_torch.core.optim import Optimizer, get_optimizer
from repro_torch.losses.sequence import get_loss
from repro_torch.models import acoustic
from repro_torch.models.registry import get_model


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
        out = scalar_metrics(metrics)
        used = int(metrics.get("cg_iters_used", 0))
        if used:
            # the (outer) CG's first and last vᵀBv: how far the solve's
            # curvature grew, which the per-iteration history shows and
            # the scalar log would drop
            out["cg_curv_first"] = metrics["cg_curv"][0]
            out["cg_curv_last"] = metrics["cg_curv"][used - 1]
        return new_params, new_state, out

    return sequence_step, opt


def build_prefill_step(cfg) -> Callable:
    """``prefill_step(params, batch) -> (B, 1, V) f32`` logits of the last
    position, ``batch["tokens"]`` of shape (B, T)."""
    model = get_model(cfg)

    @torch.no_grad()
    def prefill_step(params, batch):
        hidden, _ = model.forward_hidden(params, batch)
        last = hidden[:, -1:]
        logits = last @ model.head_matrix(params).to(last.dtype)
        return logits.float()

    return prefill_step


def build_serve_step(cfg) -> Callable:
    """``serve_step(params, cache, tokens, pos) -> (logits (B,1,V) f32,
    cache)``; the cache is updated in place."""
    model = get_model(cfg)

    @torch.no_grad()
    def serve_step(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, pos)

    return serve_step
