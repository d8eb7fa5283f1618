"""Step builders: LM training, lattice sequence training and LM serving.

Port of ``repro.launch.steps.build_step``, ``cg_sub_batch``,
``acoustic_forward_fn``, ``build_sequence_step``, ``build_prefill_step``
and ``build_serve_step``.

Both training builders return ``(step, opt)`` for any registered
optimiser — the paper's SGD/Adam-vs-NGHF comparison included:

    step, opt = build_step(cfg, "nghf", cg_fused=True)
    params, opt_state, metrics = step(params, opt.init(params), batch)

trains a language model on ``data.synthetic.lm_batch`` batches (an
enc-dec arch also takes ``batch["encoder_input"]``) with the
vocab-chunked CE (``losses.chunked_lm``); second-order optimisers slice
their CG batch from the front of the gradient batch (``cg_frac``), and
the model's share counts feed the Sec. 4.3 preconditioner.

    step, opt = build_sequence_step(acfg, "nghf", loss="mpe", kappa=0.5)
    params, opt_state, metrics = step(params, opt.init(params),
                                      grad_batch, cg_batch)

is lattice sequence training, with both batches from
``data.synthetic.asr_batch`` (feats + labels + a ``Lattice``).  Its CG
batch is explicit because the paper samples it from the whole training
set (Sec. 4.1); first-order optimisers ignore it (``opt.uses_cg_batch``).
Under a mesh (``mesh=`` and ``state_sharding=``, the acoustic state
replicated: ``launch.sharding.replicated_shardings``) the step takes the
same global batches on every rank and runs data-parallel over the
mesh's data axes (``core.optim.second_order``).  So does the LM path:
``build_step(cfg, opt, mesh=, state_sharding=)`` with the state stored
as each rank's share by ``launch.sharding.param_shardings``, the step
run inside ``launch.fsdp.step_context``, which gathers each layer's
leaves where the model uses them: where the mesh's "model" extent is
above 1, to each rank's share of the heads, FFN columns, experts and
vocabulary (``launch.tensor_parallel``), a decoder-only arch's residual
stream split over T between the units (sequence-parallel activations,
``launch.fsdp.sequence_split``).

LM serving: ``build_prefill_step(cfg)`` runs a prompt batch through the
backbone and returns the last position's logits (the prefill_32k step;
its windowed-attention layers go through the hand-written kernel on the
card); ``build_serve_step(cfg, long_mode=...)`` is one token of batched
decode.  Both run without autograd (``torch.no_grad``).  Both take a
``mesh=``: parameters stored as each rank's share, the batch's rows and
the decode caches placed by ``launch.sharding.input_shardings`` (the
reference's dry run places them so), each rank allocating only its share
of the caches (``Model.init_cache(..., mesh=)``):

    step = build_serve_step(cfg, mesh=mesh)
    cache = model.init_cache(B, S, mesh=mesh)      # this rank's share
    logits, cache = step(my_params, cache, tokens, pos)  # its rows
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from repro_torch.core.optim import Optimizer, get_optimizer
from repro_torch.core.optim.base import mesh_of
from repro_torch.launch import fsdp
from repro_torch.launch import tensor_parallel as tp
from repro_torch.launch.sharding import (NamedSharding, input_shardings,
                                         param_shardings)
from repro_torch.losses.chunked_lm import ChunkedCELoss
from repro_torch.losses.sequence import get_loss
from repro_torch.models import acoustic
from repro_torch.models.registry import get_model


def scalar_metrics(metrics: dict) -> dict:
    """Keep the 0-d entries (tensors or Python numbers)."""
    return {k: v for k, v in metrics.items()
            if getattr(v, "ndim", 0) == 0}


def step_metrics(metrics: dict) -> dict:
    """The scalar metrics, plus the (outer) CG's first and last vᵀBv:
    how far the solve's curvature grew, which the per-iteration history
    shows and the scalar log would drop."""
    out = scalar_metrics(metrics)
    used = int(metrics.get("cg_iters_used", 0))
    if used:
        out["cg_curv_first"] = metrics["cg_curv"][0]
        out["cg_curv_last"] = metrics["cg_curv"][used - 1]
    return out


def on_mesh(caller: str, mesh, state_sharding):
    """The mesh a step runs on: ``mesh``, or the state sharding's when
    only that is given (None: one device).  A mesh needs the state's
    sharding on it."""
    if mesh is None:
        return mesh_of(state_sharding)
    if mesh_of(state_sharding) is not mesh:
        raise ValueError(f"{caller}: a mesh needs the state's sharding on "
                         f"it (launch.sharding.param_shardings, or "
                         f"replicated_shardings)")
    return mesh


# ---------------------------------------------------------------------------
# LM training
# ---------------------------------------------------------------------------

def lm_forward(cfg, model) -> Callable:
    """forward for ``ChunkedCELoss``: (params, batch) -> ((hidden, head
    matrix), router_aux_coef * aux).  The head matrix is the parameter
    leaf itself, so the curvature products' tangents and cotangents reach
    it.  The hidden state holds the whole T: with sequence-parallel
    activations the backbone gathers it once before the head
    (``models.transformer.forward_hidden``; the reference's
    ``unshard_seq`` here), so the chunked CE slices T chunks of it."""
    def fwd(params, batch):
        hidden, aux = model.forward_hidden(params, batch)
        return (hidden, model.head_matrix(params)), cfg.router_aux_coef * aux
    return fwd


def cg_sub_batch(batch: dict, frac: int, min_size: int) -> dict:
    """The first max(B // frac, min_size) rows of every tensor of
    ``batch`` with the batch's leading dim B: the paper's (much smaller)
    CG batch."""
    ref = batch["tokens"] if "tokens" in batch else batch["feats"]
    B = ref.shape[0]
    nb = max(B // frac, min_size)
    return {k: v[:nb] if isinstance(v, torch.Tensor) and v.dim() >= 1
            and v.shape[0] == B else v for k, v in batch.items()}


def build_step(cfg, opt_spec, *, cg_frac: int = 8, min_cg: int = 1,
               state_sharding=None, mesh=None,
               **opt_overrides) -> Tuple[Callable, Optimizer]:
    """One uniform LM train step for any registered optimiser.

    ``opt_spec``: a registry name ("sgd" | "adam" | "ng" | "hf" |
    "nghf") or a config dataclass; ``opt_overrides`` go to
    ``optim.get_optimizer``.  Returns ``(step, opt)`` with ``step(params,
    opt_state, batch) -> (params, opt_state, scalar metrics)``; labels
    default to the tokens.

    ``mesh`` / ``state_sharding`` ({path: ``NamedSharding``} of the
    parameters, on ``mesh``): ``params`` and every θ-sized slot of
    ``opt_state`` are this rank's shares (``opt.init(params,
    state_sharding=)``), the step takes the same GLOBAL batch on every
    rank, and each layer's leaves are gathered where they are used
    (``launch.fsdp.step_context``).  The CG batch is cut from the global
    batch first; pass ``min_cg`` = the data extent so that it splits
    over the data ranks.
    """
    mesh = on_mesh("build_step", mesh, state_sharding)
    model = get_model(cfg)
    counts = model.share_counts(model.param_shapes())
    opt = get_optimizer(opt_spec, lm_forward(cfg, model), ChunkedCELoss(),
                        share_counts=counts, state_sharding=state_sharding,
                        **opt_overrides)

    def step(params, opt_state, batch):
        with fsdp.step_context(cfg, mesh, state_sharding):
            lm = dict(batch)
            lm.setdefault("labels", lm["tokens"])
            cg_batch = (cg_sub_batch(lm, cg_frac, min_cg)
                        if opt.uses_cg_batch else None)
            new_params, new_state, metrics = opt.step(params, opt_state, lm,
                                                      cg_batch)
        return new_params, new_state, step_metrics(metrics)

    return step, opt


# ---------------------------------------------------------------------------
# lattice sequence training
# ---------------------------------------------------------------------------

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
    ``mesh`` / ``state_sharding``: data-parallel over the mesh, the
    state laid out by ``state_sharding`` (which a mesh requires, and
    whose mesh it must be).
    """
    on_mesh("build_sequence_step", mesh, state_sharding)
    loss_spec = get_loss(loss, kappa=kappa, backend=backend)
    opt = get_optimizer(opt_spec, acoustic_forward_fn(acfg), loss_spec,
                        share_counts=share_counts,
                        state_sharding=state_sharding, **opt_overrides)
    if timer is not None:
        opt.timer = timer

    def sequence_step(params, opt_state, grad_batch, cg_batch=None):
        new_params, new_state, metrics = opt.step(params, opt_state,
                                                  grad_batch, cg_batch)
        return new_params, new_state, step_metrics(metrics)

    return sequence_step, opt


def _placed_rows(cfg, mesh, batch: dict):
    """(this rank's rows of every tensor of ``batch``, the data group they
    are split over or None): each tensor cut by ``launch.sharding.
    input_shardings`` (rows over the data axes where they divide, 0-d
    leaves whole)."""
    specs = input_shardings(cfg, mesh, {k: v for k, v in batch.items()
                                        if isinstance(v, torch.Tensor)})
    rows = {k: NamedSharding(mesh, specs[k]).place(v) if k in specs else v
            for k, v in batch.items()}
    split = any(e is not None for k in specs for e in specs[k][:1])
    return rows, (mesh.data_group if split else None)


def build_prefill_step(cfg, *, mesh=None) -> Callable:
    """``prefill_step(params, batch) -> (B, 1, V) f32`` logits of the last
    position, ``batch["tokens"]`` of shape (B, T).

    On a ``mesh`` (a ``launch.mesh.Mesh``) ``params`` are this rank's
    shares by ``launch.sharding.param_shardings``, ``batch`` the global
    batch, of which the step keeps this rank's rows by ``input_shardings``
    (the rows over the data axes); the backbone runs as a train step's
    forward does (``launch.fsdp.step_context``: the gathers, the
    tensor-parallel units, sequence-parallel rows), and the logits are
    this rank's rows' (B_local, 1, V), the vocabulary gathered whole where
    the head is split over it."""
    model = get_model(cfg)
    shardings = (None if mesh is None
                 else param_shardings(cfg, mesh, model.param_shapes()))

    @torch.no_grad()
    def prefill_step(params, batch):
        group = None
        if mesh is not None:
            batch, group = _placed_rows(cfg, mesh, batch)
        with fsdp.step_context(cfg, mesh, shardings), fsdp.batch_rows(group):
            hidden, _ = model.forward_hidden(params, batch)
            last = hidden[:, -1:]
            logits = last @ model.head_matrix(params).to(last.dtype)
            split = fsdp.unit_split("embed")
            if split:
                logits = tp.gather_vocab(logits, split)
        return logits.float()

    return prefill_step


def build_serve_step(cfg, *, long_mode: bool = False, mesh=None) -> Callable:
    """``serve_step(params, cache, tokens, pos) -> (logits (B,1,V) f32,
    cache)``; the cache is updated in place.  ``long_mode``: the cache
    is the bounded one of ``init_cache(..., long_mode=True)``.

    On a ``mesh``: ``params`` are this rank's shares by
    ``param_shardings``, ``cache`` this rank's shares of the caches
    (``Model.init_cache(..., mesh=)``, which says how they are cut),
    ``tokens`` the global (B, 1) of which the step keeps this rank's rows
    (``input_shardings``), and the logits are those rows' (B_local, 1,
    V).  Each layer is gathered where it is used, and each kind of cache
    is read as the rank's share of it (``models.blocks``: the attention
    slots split over "model" combine flash-decoding style)."""
    model = get_model(cfg)
    shardings = (None if mesh is None
                 else param_shardings(cfg, mesh, model.param_shapes()))

    @torch.no_grad()
    def serve_step(params, cache, tokens, pos):
        if mesh is None:
            return model.decode_step(params, cache, tokens, pos,
                                     long_mode=long_mode)
        placed = getattr(cache, "shardings", None)
        if placed is None:
            raise ValueError("build_serve_step(mesh=): the cache must be "
                             "this rank's shares, placed by "
                             "Model.init_cache(..., mesh=)")
        tokens = _placed_rows(cfg, mesh, {"tokens": tokens})[0]["tokens"]
        with fsdp.step_context(cfg, mesh, shardings, cache=placed):
            return model.decode_step(params, cache, tokens, pos,
                                     long_mode=long_mode)

    return serve_step
