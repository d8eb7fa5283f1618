"""First-order optimisers on the unified protocol: SGD with momentum
(optional 1/(1+kt) learning-rate decay) and Adam.  Port of
``repro.core.optim.first_order`` — the paper's baselines, through the
same protocol, step builder and driver as NG/HF/NGHF.  Under a mesh
(``state_sharding``) each step takes the gradient summed over the data
group (``core.curvature.grad_and_loss``); the update is then the same on
every rank, each rank updating its share of a split leaf."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core import tree_math as tm
from repro_torch.core.curvature import grad_and_loss
from repro_torch.core.optim.base import Optimizer, register_optimizer


@dataclass(frozen=True)
class SGDConfig:
    lr: float = 1e-2
    momentum: float = 0.0
    clip_norm: float = 0.0
    decay: float = 0.0       # lr_t = lr / (1 + decay * t), t = state["step"]


@dataclass(frozen=True)
class AdamConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    clip_norm: float = 0.0


def _clip(grads, clip_norm):
    if not clip_norm:
        return grads
    factor = (clip_norm / tm.norm(grads).clamp(min=1e-12)).clamp(max=1.0)
    return tm.scale(grads, factor)


class SGD(Optimizer):
    """state = {"mom": theta-like momentum, "step": int32 counter}."""

    name = "sgd"

    def __init__(self, cfg: SGDConfig, forward_fn, loss_spec, *,
                 state_sharding=None, **_):
        self.cfg, self.forward_fn, self.loss_spec = cfg, forward_fn, loss_spec
        self.bind_mesh(state_sharding)

    def state_template(self, theta, scalar):
        return {"mom": theta(), "step": scalar(torch.int32, 0)}

    def update(self, params, state, grad_batch, cg_batch=None):
        cfg = self.cfg
        loss, metrics, grads = grad_and_loss(self.forward_fn, self.loss_spec,
                                             params, grad_batch,
                                             mesh=self.mesh,
                                             data_split=self.data_split)
        grads = _clip(grads, cfg.clip_norm)
        mom = tm.axpy(cfg.momentum, state["mom"], grads)
        lr = torch.full((), cfg.lr, dtype=torch.float32,
                        device=state["step"].device)
        if cfg.decay:
            lr = lr / (1.0 + cfg.decay * state["step"].to(torch.float32))
        new_params = tm.add(params, tm.cast_like(tm.scale(mom, -lr), params))
        metrics = dict(metrics, loss=loss, grad_norm=tm.norm(grads), lr=lr)
        return new_params, {"mom": mom, "step": state["step"] + 1}, metrics


class Adam(Optimizer):
    """state = {"m": theta-like, "v": theta-like, "step": int32}."""

    name = "adam"

    def __init__(self, cfg: AdamConfig, forward_fn, loss_spec, *,
                 state_sharding=None, **_):
        self.cfg, self.forward_fn, self.loss_spec = cfg, forward_fn, loss_spec
        self.bind_mesh(state_sharding)

    def state_template(self, theta, scalar):
        return {"m": theta(), "v": theta(), "step": scalar(torch.int32, 0)}

    def update(self, params, state, grad_batch, cg_batch=None):
        cfg = self.cfg
        loss, metrics, grads = grad_and_loss(self.forward_fn, self.loss_spec,
                                             params, grad_batch,
                                             mesh=self.mesh,
                                             data_split=self.data_split)
        grads = _clip(grads, cfg.clip_norm)
        step = state["step"] + 1
        m = {k: cfg.b1 * mm + (1 - cfg.b1) * grads[k]
             for k, mm in state["m"].items()}
        v = {k: cfg.b2 * vv + (1 - cfg.b2) * grads[k] ** 2
             for k, vv in state["v"].items()}
        bc1 = 1 - cfg.b1 ** step.to(torch.float32)
        bc2 = 1 - cfg.b2 ** step.to(torch.float32)
        upd = {k: -cfg.lr * (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + cfg.eps)
               for k in m}
        new_params = tm.add(params, tm.cast_like(upd, params))
        metrics = dict(metrics, loss=loss, grad_norm=tm.norm(grads))
        return new_params, {"m": m, "v": v, "step": step}, metrics


register_optimizer("sgd", SGDConfig, SGD)
register_optimizer("adam", AdamConfig, Adam)
