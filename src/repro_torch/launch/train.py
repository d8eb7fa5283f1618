"""Training driver: lattice MPE/MMI (or frame-CE) sequence training of an
acoustic model, the paper's experiment, on one device.

Port of ``repro.launch.train.train_sequence`` / ``evaluate_sequence``.
Every registered optimiser runs the same loop and step signature.

    from repro_torch.launch.train import train_sequence
    params, log = train_sequence(arch="lstm-asr", optimizer="nghf",
                                 loss="mpe", steps=3, device="cuda")

``device`` defaults to ``"cuda"`` and raises without a card; pass
``device="cpu"`` (with ``smoke=True`` for the reduced geometry) to run
the plain PyTorch versions of the kernels on the CPU.  ``mesh``,
``ckpt_dir`` and ``resume`` raise ``NotImplementedError`` until the
distribution and checkpoint slices.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.configs.acoustic import get_acoustic_config
from repro_torch.core.optim import config_for
from repro_torch.data.synthetic import EpochPlan, asr_batch
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.launch import steps as S
from repro_torch.losses.sequence import get_loss
from repro_torch.models import acoustic

# default learning rates when ``lr`` is not given (second-order configs
# have no ``lr`` field)
SEQ_DEFAULT_LR = {"sgd": 0.2, "adam": 2e-3}


def parse_sample_schedule(sched):
    """"0:1.0,100:0.5" (or [(step, frac), ...]) -> sorted [(step, frac)]:
    the curvature-sample fraction from each update index on."""
    if sched is None:
        return None
    pairs = ([p.split(":") for p in sched.split(",") if p.strip()]
             if isinstance(sched, str) else sched)
    return sorted((int(s), float(f)) for s, f in pairs)


def _not_yet(name: str, value) -> None:
    if value:
        raise NotImplementedError(
            f"{name}: not in the port yet (the checkpoint and "
            f"distribution slices bring it)")


def train_sequence(*, arch=None, acfg=None, optimizer="nghf", loss="mpe",
                   steps=8, batch=32, cg_batch=8, frames=32, kappa=0.5,
                   cg_iters=6, ng_iters=2, lam=1.0, lr=None, noise=1.2,
                   smoke=False, mesh=None, backend="auto", init_params=None,
                   seed=0, verbose=True, ckpt_dir=None, resume=False,
                   dataset_batches=None, warm_start=False, adapt_lam=False,
                   preconditioner=None, curvature_sample=None,
                   curvature_sample_schedule=None, cg_tol=None,
                   cg_fused=False, device=DEFAULT_DEVICE, timer=None):
    """Lattice sequence training; returns ``(params, log)``.

    ``init_params``: a flat parameter dict to start from (copied); else
    ``models.acoustic.init_params(acfg, seed)``.  ``dataset_batches``:
    gradient batches cycle over that many seeds (a finite training set);
    None draws a fresh batch per update.  ``timer``: an optional
    ``core.timing.StageTimer`` handed to a second-order optimiser; each
    log entry then carries its update's ``stage_<name>_s`` seconds.
    """
    _not_yet("mesh", mesh not in (None, "none"))
    _not_yet("ckpt_dir", ckpt_dir)
    _not_yet("resume", resume)
    dev = resolve_device(device)
    if acfg is None:
        acfg = get_acoustic_config(arch)
        if smoke:
            acfg = acfg.smoke()
    if init_params is not None:
        params = {k: v.detach().to(dev, copy=True)
                  for k, v in init_params.items()}
    else:
        params = acoustic.init_params(acfg, seed, device=dev)

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
                                     backend=backend, share_counts=counts,
                                     timer=timer)

    def sched_frac(u):
        if not sample_sched:
            return None
        frac = getattr(ocfg, "curvature_sample", 1.0)
        for boundary, f in sample_sched:
            if u >= boundary:
                frac = f
        return frac

    step, opt = build()
    opt_state = opt.init(params)
    plan = EpochPlan(num_updates_per_epoch=max(steps, 1), base_seed=seed)

    def grad_seed(u):
        return plan.grad_seed(0, u % dataset_batches if dataset_batches
                              else u)

    log = []
    cur_frac = None
    for u in range(steps):
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
