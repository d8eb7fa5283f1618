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

Under a mesh ``state_sharding`` is a dict of ``launch.sharding.
NamedSharding`` matching the parameters (``get_optimizer(...,
state_sharding=)``, ``init(params, state_sharding=)``): each rank holds
its share of every leaf (the whole leaf where the spec replicates it,
as for every acoustic model), theta-sized state takes its parameter's
sharding and scalars are replicated (``state_shardings``).  The
optimiser reads its mesh off the shardings (``mesh_of``) and runs the
gradient and curvature sums over the mesh's data group.  Each update
runs inside ``tree_math.reducing`` of the state's layout, so every
``vdot`` and ``norm`` of a split theta-sized dict is the whole vector's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.core import tree_math as tm


def mesh_of(state_sharding):
    """The mesh of a state sharding ({key: NamedSharding}); None without
    one.  Raises ``TypeError`` for anything else."""
    if state_sharding is None:
        return None
    if not isinstance(state_sharding, dict) or not all(
            hasattr(s, "mesh") and hasattr(s, "spec")
            for s in state_sharding.values()):
        raise TypeError(f"state_sharding must be a dict of launch.sharding."
                        f"NamedSharding, got {type(state_sharding).__name__}")
    meshes = {id(s.mesh) for s in state_sharding.values()}
    if len(meshes) != 1:
        raise ValueError("state_sharding: the leaves lie on "
                         f"{len(meshes)} meshes, the optimiser needs one")
    return next(iter(state_sharding.values())).mesh


def split_groups(state_sharding) -> dict:
    """{key: process group} of the leaves the sharding cuts into more
    than one piece (none for replicated state): the ranks that hold the
    distinct pieces, over which a reduction of the leaf sums."""
    if state_sharding is None:
        return {}
    return {k: s.mesh.group(s.split_axes())
            for k, s in state_sharding.items() if s.pieces() > 1}


def split_replicas(state_sharding) -> dict:
    """{key: how many ranks hold each piece} of the leaves the sharding
    cuts into more than one piece."""
    if state_sharding is None:
        return {}
    out = {}
    for k, s in state_sharding.items():
        if s.pieces() > 1:
            out[k] = math.prod(s.mesh.shape.values()) // s.pieces()
    return out


def data_splits(state_sharding) -> dict:
    """{key: the data axes a leaf is split over}: its gather's backward
    sums its gradient over them (``launch.fsdp``)."""
    if state_sharding is None:
        return {}
    return {k: s.data_split() for k, s in state_sharding.items()
            if s.data_split()}


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
    mesh = None

    def bind_mesh(self, state_sharding) -> None:
        """Read the mesh and the state's split leaves off
        ``state_sharding`` (None: one device)."""
        self.mesh = mesh_of(state_sharding)
        self.groups = split_groups(state_sharding)
        self.replicas = split_replicas(state_sharding)
        self.data_split = data_splits(state_sharding)

    def layout(self, params: dict):
        """The state's layout on this rank (``tree_math.Layout``), or
        None on one device."""
        if self.mesh is None:
            return None
        return tm.Layout({k: tuple(p.shape) for k, p in params.items()},
                         self.groups, self.replicas)

    def state_template(self, theta: Callable, scalar: Callable) -> Dict:
        """Build the state structure: ``theta(cast=None)`` -> a
        theta-shaped dict (``cast`` maps a parameter to its slot's
        dtype); ``scalar(dtype, v0)`` -> a 0-d slot."""
        raise NotImplementedError

    def init(self, params: dict, state_sharding=None) -> Dict:
        """Fresh state for ``params``.  Under ``state_sharding`` the
        parameters are this rank's shares, so each theta-sized slot is
        built as its parameter's share; the sharding must cover every
        parameter."""
        if state_sharding is not None:
            mesh_of(state_sharding)
            if set(state_sharding) != set(params):
                raise ValueError(
                    "state_sharding does not match the parameters: "
                    f"{sorted(set(state_sharding) ^ set(params))[:5]}")
        return self.state_template(
            lambda cast=None: theta_zeros(params, cast), scalar_on(params))

    def state_shardings(self, param_shardings: dict,
                        scalar_sharding=None) -> Dict:
        """The sharding of each leaf of ``init``'s state: theta-sized
        slots take their parameter's, scalars ``scalar_sharding`` (by
        default replicated on the same mesh)."""
        if scalar_sharding is None:
            first = next(iter(param_shardings.values()))
            scalar_sharding = type(first)(first.mesh, type(first.spec)())
        return self.state_template(lambda cast=None: param_shardings,
                                   lambda dt, v0: scalar_sharding)

    def step(self, params, state, grad_batch, cg_batch=None):
        """One update: (params, state, metrics)."""
        with tm.reducing(self.layout(params)):
            return self.update(params, state, grad_batch, cg_batch)

    def update(self, params, state, grad_batch, cg_batch=None):
        """``step``'s body, with the reductions of the state's layout."""
        raise NotImplementedError


class OptimizerSpec(NamedTuple):
    config_cls: type
    defaults: Dict[str, Any]
    factory: Callable          # (cfg, forward_fn, loss_spec, share_counts=,
                               #  state_sharding=)


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
    the Sec. 4.3 preconditioner (second-order only); ``state_sharding``
    ({key: NamedSharding}) puts the optimiser on its mesh."""
    mesh_of(state_sharding)
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
                                    share_counts=share_counts,
                                    state_sharding=state_sharding)
