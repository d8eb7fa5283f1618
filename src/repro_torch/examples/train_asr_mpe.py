"""The paper's experiment, end to end: lattice-based discriminative
sequence training (MPE) of an LSTM acoustic model with NGHF against the
first-order baselines.

    PYTHONPATH=src python -m repro_torch.examples.train_asr_mpe \
        [--updates 8] [--device cpu]

Port of ``examples/train_asr_mpe.py``, with the same stages, seeds,
batches and learning rates; every training loop is ``launch.train.
train_sequence``, the loop behind the training CLI.  Pipeline (paper
Secs. 7-8 on synthetic data):

  1. frame-level CE pretraining of the LSTM-HMM output model by Adam,
  2. MPE sequence training with NGHF from the CE model (large gradient
     batch + CG batch, shared-parameter preconditioning, candidate
     selection); each update's acceptance, best CG iterate and the outer
     CG's first and last vᵀBv are printed,
  3. SGD and Adam from the same CE model, given 20x the updates,
  4. a paper-Table-2-style summary: held-out MPE accuracy, updates and
     the wall time of each stage.

``run_pipeline(acfg, ...)`` runs the same pipeline on another acoustic
config, e.g. the paper's full-width LSTM on the card.  ``--mesh DxM``
runs every stage data-parallel over D x M ranks (one process a rank,
under ``torchrun --nproc-per-node D*M``), as ``launch.train`` does;
rank 0 prints.
"""
from __future__ import annotations

import argparse
import time

import torch.distributed as dist

from repro_torch.configs.acoustic import LSTM
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.launch.train import evaluate_sequence, resolve_mesh, \
    train_sequence

CFG = LSTM.smoke().replace(hidden_dim=48, num_outputs=30)
KAPPA = 0.5
FRAMES = 32
NOISE = 1.2
BASELINES = (("SGD", 0.2), ("Adam", 2e-3))


def evaluate(acfg, params, device) -> float:
    return evaluate_sequence(acfg, params, loss="mpe", kappa=KAPPA,
                             frames=FRAMES, batch=32, n=4, noise=NOISE,
                             device=device)


def run_pipeline(acfg=CFG, *, updates: int = 8, device=DEFAULT_DEVICE,
                 verbose: bool = True, mesh=None) -> dict:
    """CE pretraining, NGHF, SGD and Adam on ``acfg``.  Returns {"rows":
    {stage: {"updates", "acc", "wall_s"}}, "nghf_log": NGHF's log,
    "ce_params": the CE-pretrained parameters}.  ``mesh``: as
    ``launch.train.resolve_mesh`` takes it."""
    dev = resolve_device(device)
    mesh = resolve_mesh(mesh, dev)
    rows = {}

    def say(*a):
        if mesh is None or mesh.rank == 0:
            print(*a)

    def stage(name, n_updates, **kw):
        t0 = time.perf_counter()
        params, log = train_sequence(acfg=acfg, frames=FRAMES, noise=NOISE,
                                     device=dev, mesh=mesh, **kw)
        wall = time.perf_counter() - t0      # the log's floats synchronized
        rows[name] = {"updates": n_updates, "acc": evaluate(acfg, params,
                                                            dev),
                      "wall_s": wall}
        return params, log

    # --- 1. CE pretraining -------------------------------------------------
    # seed=1000 keeps the CE stream disjoint from the MPE gradient seeds
    base, _ = stage("CE", 0, optimizer="adam", loss="ce", steps=60,
                    batch=16, lr=3e-3, seed=1000, verbose=False)
    say(f"CE baseline MPE-acc: {rows['CE']['acc']:.4f}")

    # --- 2. MPE with NGHF --------------------------------------------------
    _, nghf_log = stage("NGHF", updates, optimizer="nghf", loss="mpe",
                        steps=updates, batch=64, cg_batch=8, kappa=KAPPA,
                        cg_iters=6, ng_iters=2, init_params=base,
                        verbose=verbose)
    for m in nghf_log:
        say(f"  [nghf] update {m['step']}: accepted "
            f"{bool(m['cg_accepted'])}, best iterate "
            f"{int(m['cg_best_iter'])}, best {m['cg_best_loss']:.6f} vs "
            f"Δθ=0 {m['cg_base_loss']:.6f}; outer CG vᵀBv "
            f"{m['cg_curv_first']:.4g} -> {m['cg_curv_last']:.4g}")

    # --- 3. SGD / Adam with 20x the updates --------------------------------
    for name, lr in BASELINES:
        # dataset_batches=64: the baselines revisit a fixed 64-batch
        # training set (epoch regime), as in the paper's comparison
        stage(name, updates * 20, optimizer=name.lower(), loss="mpe",
              steps=updates * 20, batch=16, kappa=KAPPA, lr=lr,
              init_params=base, dataset_batches=64, verbose=False)

    # --- 4. summary (paper Table 2 shape) ----------------------------------
    say("\noptimiser  #updates   MPE acc (held out)   wall s")
    for name, row in rows.items():
        say(f"{name:<11s} {row['updates']:<10d} {row['acc']:<20.4f} "
            f"{row['wall_s']:.3f}")
    return {"rows": rows, "nghf_log": nghf_log, "ce_params": base}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--updates", type=int, default=8)
    ap.add_argument("--mesh", default=None,
                    help="none (default), 'DxM', 'single-pod' or "
                    "'multi-pod': every stage data-parallel over the mesh "
                    "(under torchrun, one process a rank)")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    started = not dist.is_initialized()
    try:
        return run_pipeline(updates=args.updates, device=args.device,
                            mesh=args.mesh)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
