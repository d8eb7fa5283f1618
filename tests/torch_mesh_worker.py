"""Rank processes for the port's mesh tests: gloo over the CPU, one
process a rank, started (``start``, ``finish``) from the test process.

This module imports ``torch`` and ``repro_torch`` only, never JAX (the
spawned interpreters import it to find their task): the tests compute
the reference's results in the pytest process and pass numpy arrays in
and out through files of a temporary directory.  Each rank runs on one
thread; the process group meets at a ``FileStore`` in that directory.
"""
from __future__ import annotations

import importlib
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

KAPPA = 0.5
TIMEOUT_S = 240


def start(task: str, world: int, tmp, **kw):
    """Start ``TASKS[task](tmp=tmp, **kw)`` on ``world`` gloo ranks and
    return at once (the caller may work meanwhile); ``task`` may also be
    ``"module:function"``, a task of another module of this directory."""
    tmp = str(tmp)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(rank, world, tmp, task, kw))
             for rank in range(world)]
    for p in procs:
        p.start()
    return task, world, tmp, procs


def finish(started) -> list:
    """Wait for ``start``'s ranks (killed past ``TIMEOUT_S``); each
    rank's result dict (numpy arrays)."""
    task, world, tmp, procs = started
    for p in procs:
        p.join(TIMEOUT_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    errs = [os.path.join(tmp, f"err{r}.txt") for r in range(world)]
    msg = "".join(open(e).read() for e in errs if os.path.exists(e))
    if alive or msg or any(p.exitcode for p in procs):
        raise RuntimeError(f"{task}: {len(alive)} ranks hung, exit codes "
                           f"{[p.exitcode for p in procs]}\n{msg}")
    out = []
    for r in range(world):
        with np.load(os.path.join(tmp, f"out{r}.npz")) as f:
            out.append({k: f[k] for k in f.files})
    return out


def _entry(rank: int, world: int, tmp: str, task: str, kw: dict) -> None:
    torch.set_num_threads(1)
    try:
        store = dist.FileStore(os.path.join(tmp, "store"), world)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world)
        try:
            out = _task(task)(tmp=tmp, **kw)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        np.savez(os.path.join(tmp, f"out{rank}.npz"), **out)
    except BaseException:
        with open(os.path.join(tmp, f"err{rank}.txt"), "w") as f:
            f.write(f"rank {rank}:\n{traceback.format_exc()}")
        raise


def _task(name: str):
    if ":" in name:
        module, fn = name.split(":")
        return getattr(importlib.import_module(module), fn)
    return TASKS[name]


def load_params(tmp: str) -> dict:
    with np.load(os.path.join(tmp, "params.npz")) as f:
        return {k: torch.from_numpy(f[k].copy()) for k in f.files}


def smoke_cfg():
    from repro_torch.configs.acoustic import LSTM
    return LSTM.smoke().replace(hidden_dim=16, num_outputs=12)


def batch(seed: int, n: int, frames: int = 16) -> dict:
    from repro_torch.data.synthetic import asr_batch
    cfg = smoke_cfg()
    return asr_batch(seed, batch=n, num_frames=frames,
                     num_states=cfg.num_outputs, input_dim=cfg.input_dim,
                     device="cpu")


def one_update(params: dict, mesh, *, grad_batch: int, cg_batch: int,
               optimizer: str = "nghf", loss: str = "mpe",
               **overrides) -> dict:
    """One update of the smoke LSTM (hidden 16, K 12; NGHF with cg 2, ng
    1, or a first-order ``optimizer``) from ``params`` on the gradient
    batch of seed 0 and the CG batch of seed 1, on ``mesh`` (None: one
    process); parameters and metrics."""
    from repro_torch.launch.sharding import replicated_shardings
    from repro_torch.launch.steps import build_sequence_step
    from repro_torch.models import acoustic
    cfg = smoke_cfg()
    ss = None if mesh is None else replicated_shardings(mesh, params)
    if optimizer == "nghf":
        overrides = dict(overrides, cg_iters=2, ng_iters=1)
    step, opt = build_sequence_step(
        cfg, optimizer, loss=loss, kappa=KAPPA, backend="cuda", mesh=mesh,
        state_sharding=ss, share_counts=acoustic.share_counts(cfg, params),
        **overrides)
    new, state, m = step(params, opt.init(params, state_sharding=ss),
                         batch(0, grad_batch), batch(1, cg_batch))
    out = {"p." + k: v.numpy() for k, v in new.items()}
    out.update({"m." + k: np.asarray(float(v)) for k, v in m.items()})
    out["step"] = np.asarray(int(state["step"]))
    return out


# ---------------------------------------------------------------------------
# tasks: each runs on every rank and returns a dict of numpy arrays
# ---------------------------------------------------------------------------

def updates(*, tmp: str, mesh: str, cases: dict) -> dict:
    """One update per case ({name: one_update keywords}) on a ``mesh``
    ("DxM") of this run's ranks, keys "<case>/<name>"; and an NGHF
    case's last CG iterate (no candidate selection),
    "<case>/last.<param>"."""
    from repro_torch.launch.mesh import make_debug_mesh
    d, m = (int(v) for v in mesh.split("x"))
    mesh = make_debug_mesh(d, m, device="cpu")
    params = load_params(tmp)
    out = {"data_index": np.asarray(mesh.data_index),
           "data_extent": np.asarray(mesh.data_extent),
           "groups": np.asarray([
               mesh.group("data") is mesh.data_group,
               dist.get_world_size(mesh.group("model")) == m])}
    for case, kw in cases.items():
        for k, v in one_update(params, mesh, **kw).items():
            out[f"{case}/{k}"] = v
        if kw.get("optimizer", "nghf") == "nghf":
            last = one_update(params, mesh, eval_candidates=False, **kw)
            out.update({f"{case}/last.{k[2:]}": v for k, v in last.items()
                        if k.startswith("p.")})
    return out


def cg_tree(*, tmp: str) -> dict:
    """``cg_fused_update_tree`` with leaf "w" split over 2 ranks (rows
    by rank) and leaf "b" replicated, against the unsplit plain version
    on the whole vectors; and every update-step input it sums."""
    from repro_torch.kernels.cg_fused import cg_fused_update_tree
    from repro_torch.kernels.ref import cg_fused_update_tree_ref
    rank = dist.get_rank()
    gen = torch.Generator().manual_seed(3)
    whole = [{"w": torch.randn(6, 5, generator=gen),
              "b": torch.randn(7, generator=gen)} for _ in range(4)]
    alpha = torch.tensor(0.37)
    mine = [{"w": t["w"][3 * rank:3 * rank + 3], "b": t["b"]}
            for t in whole]
    x, r, rr = cg_fused_update_tree(alpha, *mine,
                                    groups={"w": dist.group.WORLD})
    xw, rw, rrw = cg_fused_update_tree_ref(alpha, *whole)
    return {"x_w": x["w"].numpy(), "x_b": x["b"].numpy(),
            "r_w": r["w"].numpy(), "rr": rr.numpy(),
            "want_x_w": xw["w"][3 * rank:3 * rank + 3].numpy(),
            "want_x_b": xw["b"].numpy(),
            "want_r_w": rw["w"][3 * rank:3 * rank + 3].numpy(),
            "want_rr": rrw.numpy()}


def resume(*, tmp: str, mesh: str) -> dict:
    """Three NGHF updates through ``train_sequence`` on ``mesh``
    uninterrupted, and two then a resume to three from the checkpoint
    rank 0 wrote; the final parameters of both."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.train import train_sequence
    d, m = (int(v) for v in mesh.split("x"))
    mesh = make_debug_mesh(d, m, device="cpu")
    kw = dict(acfg=smoke_cfg(), optimizer="nghf", loss="mpe", batch=8,
              cg_batch=4, frames=16, cg_iters=2, ng_iters=1, warm_start=True,
              adapt_lam=True, backend="cuda", device="cpu", mesh=mesh,
              verbose=False)
    full, _ = train_sequence(steps=3, **kw)
    ck = os.path.join(tmp, "ck")
    train_sequence(steps=2, ckpt_dir=ck, **kw)
    resumed, log = train_sequence(steps=3, ckpt_dir=ck, resume=True, **kw)
    out = {"full." + k: v.numpy() for k, v in full.items()}
    out.update({"resumed." + k: v.numpy() for k, v in resumed.items()})
    out["resumed_steps"] = np.asarray([e["step"] for e in log])
    return out


TASKS = {"updates": updates, "cg_tree": cg_tree, "resume": resume}
