"""Training driver: lattice MPE/MMI (or frame-CE) sequence training of an
acoustic model, the paper's experiment, and LM training on the synthetic
token pipeline, each on one device or over a mesh of ranks.

Port of ``repro.launch.train``: ``train_sequence``, ``evaluate_sequence``,
the LM loop of its ``main`` (``train_lm`` here) and the CLI ``main``.
Every registered optimiser runs the same loop, step signature and
checkpoint format (the full ``(params, opt_state, step)``, so a resumed
run continues exactly).

    from repro_torch.launch.train import train_sequence
    params, log = train_sequence(arch="lstm-asr", optimizer="nghf",
                                 loss="mpe", steps=3, device="cuda")

    PYTHONPATH=src python -m repro_torch.launch.train --arch lstm-asr \
        --smoke --device cpu --optimizer nghf --steps 4 --batch 8 \
        --frames 24 --ckpt-dir /path/to/ckpt [--resume]
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-base \
        --smoke --device cpu --steps 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
        --smoke --device cpu --steps 2
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch granite-moe-3b-a800m --smoke --device cpu --steps 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \
        --smoke --device cpu --steps 2
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch recurrentgemma-9b --smoke --device cpu --steps 1
    PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x22b \
        --smoke --device cpu --steps 1

``device`` defaults to ``"cuda"`` and raises without a card; pass
``device="cpu"`` (with ``smoke=True`` for the reduced geometry) to run
the plain PyTorch versions of the kernels on the CPU.  The LM archs that
train are ``LM_TRAIN_ARCHS``, every registered one; another name raises,
naming ROADMAP 1.3.

Sequence training runs data-parallel over a mesh of ranks (``mesh=``:
"DxM", "single-pod", "multi-pod" or a ``launch.mesh.Mesh``), one
process a rank, with the acoustic state replicated: every rank draws the
same global batches from the seed, and each update runs its share of
them (``launch.steps.build_sequence_step``).  Under torchrun:

    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \
        -m repro_torch.launch.train --arch lstm-asr --smoke --device cpu \
        --mesh 4x1 --steps 2 --batch 8 --frames 24

LM training runs on a mesh too (``train_lm(mesh=)``, ``--mesh DxM``):
each rank stores its share of every parameter and θ-sized state leaf,
cut by ``launch.sharding.param_shardings`` in the config's regime
(``train_lm(param_sharding=)`` replaces it; a smoke config's is
"replicated"), gathers each layer where it is used (``launch.fsdp``),
computes its share of the attention archs' heads, FFN columns, experts
and vocabulary where "model" spans more than one rank
(``launch.tensor_parallel``), and runs its share of the global batch:

    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \
        -m repro_torch.launch.train --arch qwen2.5-3b --smoke --device cpu \
        --mesh 2x2 --steps 2 --batch 8 --seq 16
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.io import load_train_state, save_train_state
from repro_torch.configs import base as arch_configs
from repro_torch.configs.acoustic import ASR_ARCHS, get_acoustic_config
from repro_torch.core.collectives import broadcast_tree
from repro_torch.core.optim import config_for, list_optimizers
from repro_torch.data.synthetic import EpochPlan, asr_batch, lm_batch
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import (Mesh, make_debug_mesh,
                                     make_production_mesh)
from repro_torch.launch.sharding import (param_shardings,
                                         replicated_shardings)
from repro_torch.losses.sequence import get_loss
from repro_torch.models import acoustic
from repro_torch.models.registry import get_model

# default learning rates when ``lr`` is not given (second-order configs
# have no ``lr`` field)
SEQ_DEFAULT_LR = {"sgd": 0.2, "adam": 2e-3}
LM_DEFAULT_LR = {"sgd": 0.3, "adam": 3e-4}
# the LM archs the port trains: every registered one, as the reference's
# launch.train does.  An arch whose state does not fit one card runs out
# of its memory there: NGHF on recurrentgemma-9b (10.4 B parameters) and
# mixtral-8x22b (140.6 B) at full width needs a mesh of cards.
LM_TRAIN_ARCHS = ("whisper-base", "stablelm-1.6b", "qwen2.5-3b",
                  "minitron-8b", "chameleon-34b", "qwen2-72b",
                  "granite-moe-3b-a800m", "xlstm-125m",
                  "recurrentgemma-9b", "mixtral-8x22b")


def parse_sample_schedule(sched):
    """"0:1.0,100:0.5" (or [(step, frac), ...]) -> sorted [(step, frac)]:
    the curvature-sample fraction from each update index on."""
    if sched is None:
        return None
    pairs = ([p.split(":") for p in sched.split(",") if p.strip()]
             if isinstance(sched, str) else sched)
    return sorted((int(s), float(f)) for s, f in pairs)


def resolve_mesh(mesh, device=DEFAULT_DEVICE):
    """None / "none" -> None; "DxM" -> ``make_debug_mesh(D, M)`` (D-way
    data x M-way model); "single-pod" / "multi-pod" ->
    ``make_production_mesh``; a ``Mesh`` passes.  Each raises unless the
    run has the mesh's number of ranks."""
    if mesh is None or mesh == "none":
        return None
    if isinstance(mesh, Mesh):
        return mesh
    if isinstance(mesh, str) and "x" in mesh \
            and mesh.split("x")[0].isdigit():
        d, m = (int(v) for v in mesh.split("x"))
        return make_debug_mesh(d, m, device=device)
    if mesh in ("single-pod", "multi-pod"):
        return make_production_mesh(multi_pod=mesh == "multi-pod",
                                    device=device)
    raise ValueError(f"mesh={mesh!r}: expected 'none', 'DxM', "
                     f"'single-pod', 'multi-pod' or a launch.mesh.Mesh")


def train_sequence(*, arch=None, acfg=None, optimizer="nghf", loss="mpe",
                   steps=8, batch=32, cg_batch=8, frames=32, kappa=0.5,
                   cg_iters=6, ng_iters=2, lam=1.0, lr=None, noise=1.2,
                   smoke=False, mesh=None, backend="auto", init_params=None,
                   seed=0, verbose=True, ckpt_dir=None, resume=False,
                   dataset_batches=None, ckpt_every=10, warm_start=False,
                   adapt_lam=False, preconditioner=None,
                   curvature_sample=None, curvature_sample_schedule=None,
                   cg_tol=None, cg_fused=False, device=DEFAULT_DEVICE,
                   timer=None):
    """Lattice sequence training; returns ``(params, log)``.

    ``init_params``: a flat parameter dict to start from (copied); else
    ``models.acoustic.init_params(acfg, seed)``.  ``dataset_batches``:
    gradient batches cycle over that many seeds (a finite training set);
    None draws a fresh batch per update.  ``ckpt_dir``: the train state
    is saved there every ``ckpt_every`` updates and after the last;
    with ``resume`` and an existing ``ckpt_dir`` the run continues from
    the saved step.  ``timer``: an optional
    ``core.timing.StageTimer`` handed to a second-order optimiser; each
    log entry then carries its update's ``stage_<name>_s`` seconds.
    ``mesh`` (``resolve_mesh``): data-parallel over its data axes, the
    parameters and optimiser state replicated (rank 0's initial values
    broadcast to every rank); rank 0 alone prints and writes checkpoints.
    """
    dev = resolve_device(device)
    mesh = resolve_mesh(mesh, dev)
    if acfg is None:
        acfg = get_acoustic_config(arch)
        if smoke:
            acfg = acfg.smoke()
    if init_params is not None:
        params = {k: v.detach().to(dev, copy=True)
                  for k, v in init_params.items()}
    else:
        params = acoustic.init_params(acfg, seed, device=dev)
    state_sharding = None
    if mesh is not None:
        state_sharding = replicated_shardings(mesh, params)
        params = broadcast_tree(params)
        verbose = verbose and mesh.rank == 0

    def make_batch(s, n):
        return asr_batch(s, batch=n, num_frames=frames,
                         num_states=acfg.num_outputs,
                         input_dim=acfg.input_dim, noise=noise, device=dev)

    sample_sched = parse_sample_schedule(curvature_sample_schedule)
    ocfg = config_for(optimizer, cg_iters=cg_iters, ng_iters=ng_iters,
                      lam=lam, warm_start=warm_start, adapt_lam=adapt_lam,
                      preconditioner=preconditioner,
                      curvature_sample=curvature_sample, cg_tol=cg_tol,
                      cg_fused=cg_fused or None,
                      lr=lr if lr is not None
                      else SEQ_DEFAULT_LR.get(optimizer))
    counts = acoustic.share_counts(acfg, params)

    def build(frac=None):
        cfg_u = ocfg if frac is None else ocfg.replace(curvature_sample=frac)
        return S.build_sequence_step(acfg, cfg_u, loss=loss, kappa=kappa,
                                     backend=backend, mesh=mesh,
                                     state_sharding=state_sharding,
                                     share_counts=counts, timer=timer)

    def sched_frac(u):
        if not sample_sched:
            return None
        frac = getattr(ocfg, "curvature_sample", 1.0)
        for boundary, f in sample_sched:
            if u >= boundary:
                frac = f
        return frac

    step, opt = build()
    opt_state = opt.init(params, state_sharding=state_sharding)
    start = 0
    if resume and ckpt_dir and os.path.exists(ckpt_dir):
        params, opt_state, start = load_train_state(
            ckpt_dir, params, opt_state, shardings=state_sharding)
        if verbose:
            print(f"[train] resumed from step {start}")
    plan = EpochPlan(num_updates_per_epoch=max(steps, 1), base_seed=seed)

    def grad_seed(u):
        return plan.grad_seed(0, u % dataset_batches if dataset_batches
                              else u)

    log = []
    cur_frac = None
    for u in range(start, steps):
        t0 = time.perf_counter()
        want = sched_frac(u) if opt.uses_cg_batch else None
        if want is not None and want != cur_frac:
            # a schedule boundary: rebuild the step (the state carries over)
            step, opt = build(want)
            cur_frac = want
            if verbose:
                print(f"  [curvature-sample] step {u}: fraction -> {want}")
        gb = make_batch(grad_seed(u), batch)
        cb = make_batch(plan.cg_seed(0, u), cg_batch) \
            if opt.uses_cg_batch else None
        before = dict(timer.totals) if timer is not None else {}
        params, opt_state, metrics = step(params, opt_state, gb, cb)
        metrics = {k: float(v) for k, v in metrics.items()}
        dt = time.perf_counter() - t0
        if timer is not None:
            metrics.update({f"stage_{k}_s": v - before.get(k, 0.0)
                            for k, v in timer.totals.items()})
        log.append(dict(step=u, time_s=dt, **metrics))
        if verbose:
            key_metric = metrics.get("mpe_acc", metrics.get(
                "mmi", metrics.get("ce", metrics.get("loss", float("nan")))))
            print(f"  seq step {u:4d} {loss}={key_metric:.4f} ({dt:.3f}s)")
        if ckpt_dir and (u + 1) % ckpt_every == 0:
            save_train_state(ckpt_dir, params, opt_state, step=u + 1,
                             shardings=state_sharding)
    if ckpt_dir:
        save_train_state(ckpt_dir, params, opt_state, step=steps,
                         shardings=state_sharding)
    return params, log


def train_lm(*, arch="whisper-base", optimizer="nghf", steps=10, batch=8,
             seq=128, cg_iters=8, ng_iters=4, lr=None, smoke=False,
             ckpt_dir=None, resume=False, warm_start=False,
             adapt_lam=False, preconditioner=None, curvature_sample=None,
             cg_tol=None, cg_fused=False, device=DEFAULT_DEVICE, mesh=None,
             num_layers=None, param_sharding=None, verbose=True):
    """LM training on ``lm_batch`` streams (the reference's ``main`` LM
    loop); returns ``(params, log)``.

    Parameters from ``Model.init(0)``; batch ``i`` is ``lm_batch(i)``,
    and an enc-dec arch's ``encoder_input`` (B, encoder_frames, d) in the
    compute dtype is drawn from a ``torch.Generator`` on the device
    seeded with ``i`` (the reference folds ``i`` into a JAX key).  Second-
    order optimisers take the batch's first B // 4 rows as the CG batch
    (``cg_frac=4``).  ``ckpt_dir``: the train state is saved
    there every 10 steps and after the last; with ``resume`` and an
    existing ``ckpt_dir`` the run continues from the saved step.
    ``num_layers`` cuts the depth and ``param_sharding`` replaces the
    config's regime (None: the config's).

    ``mesh`` (``resolve_mesh``): every rank builds the parameters whole
    from the seed and keeps its share by ``param_shardings``, its
    optimiser state is its share too, every rank draws the same global
    batches (an enc-dec arch's ``encoder_input`` whole), and each step
    runs this rank's rows of them; the CG batch is at least the data
    extent (``min_cg``), so that it splits.  Rank 0 alone prints; the
    checkpoint gathers the split leaves and rank 0 writes it.
    """
    if arch.startswith("lm-"):
        arch = arch[3:]                # 'lm-whisper-base' alias
    if arch not in LM_TRAIN_ARCHS:
        raise NotImplementedError(
            f"--arch {arch}: LM training of this arch is not ported yet "
            f"(ROADMAP 1.3); the port trains the LM archs "
            f"{list(LM_TRAIN_ARCHS)} and the acoustic archs "
            f"{sorted(ASR_ARCHS)}")
    dev = resolve_device(device)
    mesh = resolve_mesh(mesh, dev)
    cfg = arch_configs.get_config(arch)
    if smoke:
        cfg = cfg.smoke()
    if num_layers is not None:
        cfg = cfg.replace(num_layers=num_layers)
    if param_sharding is not None:
        cfg = cfg.replace(param_sharding=param_sharding)
    model = get_model(cfg)
    params = model.init(0, device=dev)
    pshard = None
    if mesh is not None:
        pshard = param_shardings(cfg, mesh, model.param_shapes())
        params = {k: pshard[k].place(v) for k, v in params.items()}
        verbose = verbose and mesh.rank == 0
    say = print if verbose else (lambda *a, **k: None)
    say(f"[train] arch={cfg.name} params={model.param_count() / 1e6:.1f}M "
        f"optimizer={optimizer}"
        + (f" mesh={'x'.join(map(str, mesh.shape.values()))} "
           f"param_sharding={cfg.param_sharding}" if mesh else ""))
    ocfg = config_for(optimizer, cg_iters=cg_iters, ng_iters=ng_iters,
                      warm_start=warm_start, adapt_lam=adapt_lam,
                      preconditioner=preconditioner,
                      curvature_sample=curvature_sample, cg_tol=cg_tol,
                      cg_fused=cg_fused or None,
                      lr=lr if lr is not None
                      else LM_DEFAULT_LR.get(optimizer))
    step, opt = S.build_step(cfg, ocfg, cg_frac=4,
                             min_cg=1 if mesh is None else mesh.data_extent,
                             mesh=mesh, state_sharding=pshard)
    opt_state = opt.init(params, state_sharding=pshard)
    sshard = None if mesh is None else opt.state_shardings(pshard)
    start = 0
    if resume and ckpt_dir and os.path.exists(ckpt_dir):
        params, opt_state, start = load_train_state(
            ckpt_dir, params, opt_state, shardings=pshard,
            state_shardings=sshard)
        say(f"[train] resumed from step {start}")

    def save(at):
        save_train_state(ckpt_dir, params, opt_state, step=at,
                         shardings=pshard, state_shardings=sshard)

    log = []
    for i in range(start, steps):
        b = lm_batch(i, batch=batch, seq_len=seq, vocab=cfg.vocab_size,
                     device=dev)
        if cfg.is_encoder_decoder:
            gen = torch.Generator(device=dev).manual_seed(i)
            b["encoder_input"] = torch.randn(
                batch, cfg.encoder_frames, cfg.d_model, generator=gen,
                device=dev).to(cfg.cdtype)
        t0 = time.perf_counter()
        params, opt_state, metrics = step(params, opt_state, b)
        metrics = {k: float(v) for k, v in metrics.items()}
        dt = time.perf_counter() - t0
        log.append(dict(step=i, time_s=dt, **metrics))
        say(f"  step {i:4d} loss={metrics['ce']:.4f} "
            f"acc={metrics['acc']:.3f} ({dt:.3f}s)")
        if ckpt_dir and (i + 1) % 10 == 0:
            save(i + 1)
    if ckpt_dir:
        save(steps)
    return params, log


def evaluate_sequence(acfg, params, *, loss="mpe", kappa=0.5, frames=32,
                      batch=32, n=4, noise=1.2, seed0=90_000,
                      backend="auto", device=DEFAULT_DEVICE):
    """Held-out metric (mpe_acc for MPE, -loss otherwise) over n batches."""
    dev = resolve_device(device)
    loss_spec = get_loss(loss, kappa=kappa, backend=backend)
    vals = []
    for i in range(n):
        b = asr_batch(seed0 + i, batch=batch, num_frames=frames,
                      num_states=acfg.num_outputs, input_dim=acfg.input_dim,
                      noise=noise, device=dev)
        logits = acoustic.forward(acfg, params, b["feats"])
        val, metrics = loss_spec.value(logits, b)
        vals.append(float(metrics.get("mpe_acc", -val)))
    return float(np.mean(vals))


def main(argv=None):
    """The training CLI; returns the log.  ``*-asr`` archs run
    ``train_sequence``, the LM archs of ``LM_TRAIN_ARCHS`` (or
    ``lm-<arch>``) ``train_lm``."""
    lm_archs = arch_configs.list_archs() + list(arch_configs.NOT_PORTED)
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b",
                    choices=(lm_archs + ["lm-" + a for a in lm_archs]
                             + sorted(ASR_ARCHS)),
                    help="architecture id; '*-asr' ids run lattice "
                    "sequence training, LM ids (or 'lm-<arch>') LM "
                    "training")
    ap.add_argument("--optimizer", default="nghf",
                    choices=list_optimizers())
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128,
                    help="LM sequence length (LM archs only)")
    ap.add_argument("--cg-iters", type=int, default=8)
    ap.add_argument("--ng-iters", type=int, default=4)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--warm-start", action="store_true",
                    help="warm-start the outer CG from the previous Δθ")
    ap.add_argument("--adapt-lam", action="store_true",
                    help="Levenberg-Marquardt-style λ adaptation")
    ap.add_argument("--preconditioner", default=None,
                    choices=["identity", "share_counts", "fisher_diag"])
    ap.add_argument("--curvature-sample", type=float, default=None,
                    help="fraction of the CG batch used for GN/Fisher "
                    "curvature products (candidate eval keeps the full "
                    "batch); e.g. 0.5")
    ap.add_argument("--curvature-sample-schedule", default=None,
                    help="shrink the curvature sample across updates, "
                    "e.g. '0:1.0,100:0.5,300:0.25'")
    ap.add_argument("--cg-tol", type=float, default=None,
                    help="adaptive CG budget: stop when the quadratic "
                    "model's relative per-iteration gain drops below "
                    "this; --cg-iters becomes the ceiling")
    ap.add_argument("--cg-fused", action="store_true",
                    help="fused flat-buffer CG vector work (one kernel "
                    "launch for x+=av, r-=aBv, <r,r>)")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced geometry for the CPU")
    ap.add_argument("--mesh", default="none",
                    help="'none', 'DxM' (D-way data x M-way model), "
                    "'single-pod' or 'multi-pod', one process a rank "
                    "(run under torchrun --nproc-per-node D*M): "
                    "data-parallel sequence training of the *-asr archs "
                    "(replicated state); for the LM archs each rank "
                    "stores its share of the parameters and θ-sized state "
                    "by the config's param_sharding (a --smoke config's is "
                    "'replicated') and gathers each layer where it is "
                    "used, computing its share of the attention archs' "
                    "heads, FFN and vocab where M > 1")

    ap.add_argument("--layers", type=int, default=None,
                    help="LM archs: cut the depth to this many layers "
                    "(default: the config's)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-json", default=None)
    # lattice sequence training (``*-asr`` archs) only:
    ap.add_argument("--loss", default="mpe", choices=["mpe", "mmi", "ce"])
    ap.add_argument("--kappa", type=float, default=0.5)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--cg-batch", type=int, default=8)
    ap.add_argument("--lattice-backend", default="auto")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    started = not dist.is_initialized()
    try:
        return _run(args)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def _run(args) -> list:
    """``main``'s run; the log is written (by rank 0 under a mesh)."""
    common = dict(
        optimizer=args.optimizer, steps=args.steps, batch=args.batch,
        cg_iters=args.cg_iters, ng_iters=args.ng_iters, lr=args.lr,
        smoke=args.smoke, ckpt_dir=args.ckpt_dir, resume=args.resume,
        warm_start=args.warm_start, adapt_lam=args.adapt_lam,
        preconditioner=args.preconditioner,
        curvature_sample=args.curvature_sample, cg_tol=args.cg_tol,
        cg_fused=args.cg_fused, device=args.device, mesh=args.mesh)
    if args.arch in ASR_ARCHS:
        _, log = train_sequence(
            arch=args.arch, loss=args.loss, cg_batch=args.cg_batch,
            frames=args.frames, kappa=args.kappa,
            backend=args.lattice_backend,
            curvature_sample_schedule=args.curvature_sample_schedule,
            **common)
    else:
        _, log = train_lm(arch=args.arch, seq=args.seq,
                          num_layers=args.layers, **common)
    if args.log_json and (not dist.is_initialized() or dist.get_rank() == 0):
        with open(args.log_json, "w") as f:
            json.dump(log, f, indent=1)
    return log


if __name__ == "__main__":
    main()
