"""The unified stateful optimiser protocol (paper Fig. 1 as ONE
interface).

Port of ``repro.core.optim.base``.  Every optimiser — first- or second-
order — is an object with the same surface,

    opt    = get_optimizer(name, forward_fn, loss_spec, **overrides)
    state  = opt.init(params)                       # dict of tensors
    params, state, metrics = opt.step(params, state, grad_batch,
                                      cg_batch=None)

so the drivers (``launch.train``) and step builders (``launch.steps``)
contain no per-optimiser branching.  Parameters are a flat
``dict[str, Tensor]``; theta-sized state slots are dicts of the same
keys, scalars 0-d tensors on the parameters' device.  State contents:

  sgd   : {"mom": theta-like momentum, "step": int32 update counter}
  adam  : {"m": theta-like, "v": theta-like, "step": int32}
  ng/hf/nghf : {"step": int32, "lam": f32 λ (live iff ``adapt_lam``),
                "precond": preconditioner state ({} unless fisher_diag),
                "delta": theta-like previous Δθ (iff ``warm_start``)}

Sharded optimiser state (the reference's ``state_sharding``) waits for
the distribution slice: passing one raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch


def no_state_sharding(state_sharding) -> None:
    if state_sharding is not None:
        raise NotImplementedError(
            "state_sharding: sharded optimiser state comes with the "
            "port's distribution slice; the port runs on one device")


def theta_zeros(params: dict, cast: Optional[Callable] = None) -> dict:
    """Zeros shaped like ``params``; ``cast(leaf)`` may pick the dtype."""
    return {k: torch.zeros(p.shape, dtype=cast(p) if cast else p.dtype,
                           device=p.device) for k, p in params.items()}


def scalar_on(params: dict) -> Callable:
    dev = next(iter(params.values())).device
    return lambda dt, v0: torch.full((), v0, dtype=dt, device=dev)


class Optimizer:
    """Protocol base.  Subclasses bind (config, forward_fn, loss_spec) at
    construction and implement ``state_template``/``step``."""

    name: str = "?"
    uses_cg_batch: bool = False   # second-order optimisers consume an
                                  # explicit CG batch (paper Sec. 4.1)

    def state_template(self, theta: Callable, scalar: Callable) -> Dict:
        """Build the state structure: ``theta(cast=None)`` -> a
        theta-shaped dict (``cast`` maps a parameter to its slot's
        dtype); ``scalar(dtype, v0)`` -> a 0-d slot."""
        raise NotImplementedError

    def init(self, params: dict, state_sharding=None) -> Dict:
        no_state_sharding(state_sharding)
        return self.state_template(
            lambda cast=None: theta_zeros(params, cast), scalar_on(params))

    def step(self, params, state, grad_batch, cg_batch=None):
        """One update: (params, state, metrics)."""
        raise NotImplementedError


class OptimizerSpec(NamedTuple):
    config_cls: type
    defaults: Dict[str, Any]
    factory: Callable          # (cfg, forward_fn, loss_spec, share_counts=)


OPTIMIZERS: Dict[str, OptimizerSpec] = {}


def register_optimizer(name: str, config_cls, factory, **defaults):
    OPTIMIZERS[name] = OptimizerSpec(config_cls, defaults, factory)


def list_optimizers():
    return sorted(OPTIMIZERS)


def config_for(name: str, **kw):
    """Build ``name``'s config dataclass from CLI-style kwargs; keys the
    config does not declare, and None values, are dropped."""
    if name not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {name!r} "
                         f"(have {list_optimizers()})")
    spec = OPTIMIZERS[name]
    fields = {f.name for f in dataclasses.fields(spec.config_cls)}
    clean = dict(spec.defaults)
    clean.update({k: v for k, v in kw.items()
                  if k in fields and v is not None})
    return spec.config_cls(**clean)


def _name_of_config(cfg) -> str:
    method = getattr(cfg, "method", None)
    if method is not None and method in OPTIMIZERS:
        return method
    for name, spec in OPTIMIZERS.items():
        if type(cfg) is spec.config_cls and not spec.defaults:
            return name
    raise ValueError(f"no registered optimizer for config {type(cfg)}")


def get_optimizer(spec, forward_fn, loss_spec, *,
                  share_counts: Optional[dict] = None,
                  state_sharding=None, **overrides) -> Optimizer:
    """The one constructor: ``spec`` is a registry name ("sgd" | "adam" |
    "ng" | "hf" | "nghf") or a config dataclass.  ``share_counts`` feeds
    the Sec. 4.3 preconditioner (second-order only)."""
    no_state_sharding(state_sharding)
    if isinstance(spec, str):
        if spec not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {spec!r} "
                             f"(have {list_optimizers()})")
        fields = {f.name for f in
                  dataclasses.fields(OPTIMIZERS[spec].config_cls)}
        unknown = {k for k, v in overrides.items()
                   if k not in fields and v is not None}
        if unknown:
            raise TypeError(f"unknown {spec} option(s): {sorted(unknown)}")
        cfg = config_for(spec, **overrides)
        name = spec
    else:
        cfg = dataclasses.replace(spec, **overrides) if overrides else spec
        name = _name_of_config(cfg)
    return OPTIMIZERS[name].factory(cfg, forward_fn, loss_spec,
                                    share_counts=share_counts)
