"""Curvature-matrix-vector products (paper Secs. 3.4 and 5.2).

Port of ``repro.core.curvature``.  The Gauss-Newton product
G v = Jᵀ (H^ (J v)) and the empirical-Fisher product F v = Jᵀ (F^ (J v))
are computed matrix-free:

  * ``J v`` — the R-operator — is ``torch.func.jvp`` through the model
    (forward mode through the written-out LSTM loop; Eqn. 13's gating
    rule is what the JVP does for Hadamard products);
  * ``H^ ·`` / ``F^ ·`` are the loss spec's per-frame factors, computed
    OUTSIDE any transform from the plain primal logits (they call
    ``logit_grad``, an autograd call of their own);
  * ``Jᵀ u`` is ``torch.func.vjp``'s pullback with the factor's output
    as cotangent.

``mode="rematvp"`` runs one jvp and one vjp per product (live tensors
only); ``mode="linearize"`` builds ``torch.func.linearize`` once plus
one ``vjp`` pullback and reuses both for every product of the CG stage.

Sec. 4.2 stabilisation: with ``stabilize=True`` the product runs on
v' = (‖θ‖/‖v‖) v and is rescaled by the inverse factor — a no-op for the
linear G, and what keeps the directional derivative precise when
‖θ‖ ≫ ‖v‖.

Under a mesh (``mesh=``, a ``launch.mesh.Mesh``) every function here
takes the GLOBAL batch, as the reference's jitted update does, and runs
this rank's share of it (``data.pipeline.shard_batch``).  The loss
spec's batch normalisers (``loss_spec.normalisers``) are summed over the
data group once per batch and handed in as constants under
``batch["norms"]``, so each rank's loss is the sum over its rows divided
by the global normaliser; the gradient stage, each curvature product and
each candidate evaluation then sum their result over the data group with
one ``all_reduce`` (``core.collectives``), and every rank holds the
reference's mean.  A batch that does not divide the data extent is kept
whole on every rank and summed over none.

Under FSDP storage (``launch.fsdp``) a leaf split over data axes is
gathered in the forward, and its gather's backward already sums the
gradient over those axes (a reduce-scatter): ``data_split`` ({key: the
data axes its stored spec splits}) leaves it out of the data-group sum,
or it would count D times.  Every forward runs inside ``fsdp.
batch_rows``, which tells the gathers (and the MoE aux) whether its rows
are a split share.

Under tensor-parallel compute (``launch.tensor_parallel``) nothing here
sums over "model": a leaf a split unit uses as its share gets its share
of the gradient, a leaf it uses whole, or uses on this rank's T slice of
a sequence-parallel stream (a norm's), gets the model group's sum from
``copy_to_model``'s backward, and every other leaf is used whole on
every rank, so each holds the same whole gradient.  The data-group sums
are as above.
"""
from __future__ import annotations

import inspect
from typing import Callable, NamedTuple

import torch
import torch.func

from repro_torch.core import tree_math as tm
from repro_torch.core.collectives import all_reduce_sum
from repro_torch.data.pipeline import (batch_size, batch_splits, map_batch,
                                       shard_batch)
from repro_torch.launch import fsdp
from repro_torch.launch.mesh import DATA_AXES


class CurvatureOps(NamedTuple):
    """Matrix-free operators bound to (params, cg_batch)."""

    gnvp: Callable        # v -> G v      (Gauss-Newton)
    fvp: Callable         # v -> F v      (empirical Fisher, from MMI/CE)
    eval_loss: Callable   # delta -> loss(params + delta) on the FULL CG batch
    logits: torch.Tensor  # primal logits on the curvature batch (linearize)


def subsample_batch(batch, fraction: float, multiple: int = 1):
    """Deterministic leading-dim prefix of a batch: keeps
    ``max(1, round(B * fraction))`` utterances of every batch-leading
    tensor.  The CG batch is itself drawn at random (Sec. 4.1), so a
    prefix is an unbiased sample.

    ``multiple`` (the mesh's data extent) rounds the kept size up to a
    whole multiple when B divides it, so that the sample splits evenly
    over the data ranks (He et al.'s worker split); the sample is then
    a prefix of the GLOBAL batch, of which each rank runs its share."""
    B = batch_size(batch)
    n = max(1, int(round(B * float(fraction))))
    if multiple > 1 and B % multiple == 0:
        n = min(B, -(-n // multiple) * multiple)
    if n >= B:
        return batch
    return map_batch(lambda x: x[:n], batch, B)


def shard_for(loss_spec, batch, mesh):
    """(the batch this rank computes, the group to sum its results over).

    Without a mesh, or for a batch that does not divide the mesh's data
    extent: (``batch``, None), computed whole.  Otherwise this rank's
    share, with the global normalisers of ``loss_spec`` (its
    ``normalisers`` of the share, summed over the data group by one
    ``all_reduce``) under ``"norms"``, and the data group."""
    if mesh is None or not batch_splits(batch, mesh):
        return batch, None
    local = shard_batch(batch, mesh)
    norms = all_reduce_sum(loss_spec.normalisers(local), mesh.data_group)
    return dict(local, norms=norms), mesh.data_group


def batch_sum(tree: dict, group, mesh, data_split=None) -> dict:
    """``tree`` summed over ``group`` (the data group, over which the
    batch rows were split; None: nothing to sum), with one
    ``all_reduce`` a group: a leaf in ``data_split`` ({key: data axes its
    gather's backward summed over}) is summed over the remaining data
    axes only, and not at all when none remain."""
    if group is None:
        return tree
    groups: dict = {}
    for k in tree:
        axes = (data_split or {}).get(k, ())
        if axes:
            rest = tuple(a for a in DATA_AXES
                         if a in mesh.axis_names and a not in axes)
            if mesh.extent(rest) == 1:
                continue
            g = mesh.group(rest)
        else:
            g = group
        groups.setdefault(id(g), (g, []))[1].append(k)
    out = dict(tree)
    for g, keys in groups.values():
        out.update(all_reduce_sum({k: tree[k] for k in keys}, g))
    return {k: out[k] for k in tree}


def _eval_kwargs(loss_spec, eval_accumulators: str) -> dict:
    """Pass ``accumulators`` only to loss specs that declare it."""
    if eval_accumulators == "full":
        return {}
    try:
        sig = inspect.signature(loss_spec.value).parameters
    except (TypeError, ValueError):
        return {}
    accepts = "accumulators" in sig or any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in sig.values())
    return {"accumulators": eval_accumulators} if accepts else {}


def make_curvature_ops(forward_fn, loss_spec, params: dict, batch, *,
                       stabilize: bool = True, theta_norm=None,
                       mode: str = "rematvp",
                       eval_accumulators: str = "full",
                       curvature_sample: float = 1.0,
                       mesh=None, data_split=None) -> CurvatureOps:
    """forward_fn(params, batch) -> (logits, aux).

    eval_accumulators: statistics mode of ``eval_loss`` (candidate
    evaluation); "loss_only" asks the loss spec for its value-only path.
    curvature_sample: fraction of the CG batch the GN/Fisher products run
    on (a deterministic prefix); ``eval_loss`` always sees the full batch.
    mesh: the products and ``eval_loss`` run this rank's share and sum
    their results over the data group (one ``all_reduce`` each, but for
    the ``data_split`` leaves, ``batch_sum``); the sample is rounded up
    to a multiple of the data extent.
    """
    if mode not in ("rematvp", "linearize"):
        raise ValueError(f"unknown curvature mode {mode!r} "
                         "(rematvp | linearize)")
    extent = 1 if mesh is None else mesh.data_extent
    curv_global = (batch if curvature_sample >= 1.0
                   else subsample_batch(batch, curvature_sample,
                                        multiple=extent))
    curv_batch, curv_group = shard_for(loss_spec, curv_global, mesh)
    eval_batch, eval_group = (
        (curv_batch, curv_group) if curv_global is batch
        else shard_for(loss_spec, batch, mesh))

    def f(p):
        with fsdp.batch_rows(curv_group):
            return forward_fn(p, curv_batch)[0]

    logits = None
    if mode == "linearize":
        logits, jvp_fn = torch.func.linearize(f, params)
        _, vjp_fn = torch.func.vjp(f, params)

    if theta_norm is None:
        theta_norm = tm.norm(params)

    def _product(factor_vp, v):
        if stabilize:
            s = theta_norm / tm.norm(v).clamp(min=1e-30)
            v_in = tm.scale(v, s)
        else:
            v_in = v
        # the JVP needs tangent dtype == primal dtype (bf16 CG state vs
        # f32 parameters)
        v_in = tm.cast_like(v_in, params)
        if mode == "linearize":
            out_primal, jv = logits, jvp_fn(v_in)
            (out,) = vjp_fn(factor_vp(out_primal, curv_batch, jv))
        else:
            out_primal, jv = torch.func.jvp(f, (params,), (v_in,))
            hu = factor_vp(out_primal, curv_batch, jv)
            _, pullback = torch.func.vjp(f, params)
            (out,) = pullback(hu)
        out = batch_sum(out, curv_group, mesh, data_split)
        return tm.scale(out, 1.0 / s) if stabilize else out

    def gnvp(v):
        return _product(loss_spec.gn_vp, v)

    def fvp(v):
        return _product(loss_spec.fisher_vp, v)

    eval_kw = _eval_kwargs(loss_spec, eval_accumulators)

    def eval_loss(delta):
        # ranks candidates by the SAME objective the gradient stage
        # minimises (loss + aux)
        with torch.no_grad(), fsdp.batch_rows(eval_group):
            lg, aux = forward_fn(tm.add(params, tm.cast_like(delta, params)),
                                 eval_batch)
            loss = loss_spec.value(lg, eval_batch, **eval_kw)[0] + aux
        if eval_group is not None:
            loss = all_reduce_sum({"loss": loss}, eval_group)["loss"]
        return loss

    return CurvatureOps(gnvp=gnvp, fvp=fvp, eval_loss=eval_loss,
                        logits=logits)


def grad_and_loss(forward_fn, loss_spec, params: dict, batch, *,
                  microbatches: int = 1, mesh=None, data_split=None):
    """Gradient stage: (mean loss, metrics, grads) over the gradient
    batch, by ``torch.autograd.grad``.  ``microbatches > 1`` splits the
    batch's leading dim and accumulates the gradient sequentially (grads
    and loss divided by the count, metrics averaged).  Under ``mesh``
    each microbatch of the global batch runs as this rank's share, and
    the gradient, loss and metrics are summed over the data group by one
    ``all_reduce`` (``batch_sum``: not the ``data_split`` leaves, which
    their gathers summed)."""
    keys = list(params)
    group = None

    def one(b):
        nonlocal group
        b, group = shard_for(loss_spec, b, mesh)
        leaves = {k: params[k].detach().requires_grad_(True) for k in keys}
        with torch.enable_grad(), fsdp.batch_rows(group):
            logits, aux = forward_fn(leaves, b)
            loss, metrics = loss_spec.value(logits, b)
            loss = loss + aux
            grads = torch.autograd.grad(loss, [leaves[k] for k in keys])
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                dict(zip(keys, grads)))

    if microbatches <= 1:
        loss, metrics, grads = one(batch)
        return _summed(loss, metrics, grads, group, mesh, data_split)
    B = batch_size(batch)
    k = microbatches
    if B % k:
        raise ValueError(f"batch of {B} does not split into {k} "
                         f"microbatches")
    n = B // k
    loss, metrics, grads = None, None, None
    for i in range(k):
        lo, mo, go = one(map_batch(lambda x, i=i: x[i * n:(i + 1) * n],
                                   batch, B))
        go = {key: g / k for key, g in go.items()}
        if grads is None:
            loss, metrics, grads = lo / k, [mo], go
        else:
            loss = loss + lo / k
            metrics.append(mo)
            grads = tm.add(grads, go)
    metrics = {key: torch.stack([m[key] for m in metrics]).mean()
               for key in metrics[0]}
    return _summed(loss, metrics, grads, group, mesh, data_split)


def _summed(loss, metrics: dict, grads: dict, group, mesh, data_split):
    """(loss, metrics, grads) summed over ``group`` (``batch_sum``); as
    they are without one."""
    if group is None:
        return loss, metrics, grads
    out = batch_sum({"loss": loss, **{"m." + k: v for k, v in
                                     metrics.items()},
                     **{"g." + k: v for k, v in grads.items()}},
                    group, mesh, {"g." + k: v for k, v in
                                  (data_split or {}).items()})
    return (out["loss"], {k: out["m." + k] for k in metrics},
            {k: out["g." + k] for k in grads})
