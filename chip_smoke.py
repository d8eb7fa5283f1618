#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Drives the port's lattice-rescoring service on one CUDA card at the
acoustic model's full output width (K = 6000 tied triphone states,
utterances of up to T = 1000 frames), through the entry points a user
calls, and holds every hand-written kernel of that path against its
plain PyTorch version on the card:

  1. environment: the card, torch/CUDA versions, the kernels' build;
  2. each kernel against its plain version (``kernels/ref.py``) on the
     card: the five adversarial corpus cases, full-size B=8 random-DAG
     and sausage buckets, and a streaming session's bucket (W = A);
  3. the service (``RescoringService.run``) over a Poisson mix of 48
     requests — every request ``ok``, results equal to the plain
     levelized path on the card, batch-mix independence bitwise, and
     ``dag_loss_only`` launched on the way;
  4. streaming: checkpoint half the levels of a T=1000 lattice, resume,
     bit-exact against from-scratch, ``dag_forward``/``dag_backward``
     launched on the way; the kernels held against their plain versions
     on the resume lattice that the session dispatched, and the forward
     kernel's own final-arc fold bit-exact between resume and scratch;
  5. times: each kernel against its plain version at the service's and
     the session's shapes (outputs compared, then timed with CUDA
     events), the bound from the bytes each must move, one
     ``{"kernels": [...]}`` line.

The last line is ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero before it; without a card, or outside a checkout of the repo,
the script exits non-zero and prints no result.

    python3 chip_smoke.py
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs.acoustic import get_acoustic_config  # noqa: E402

SEED = 0
KAPPA = 0.5
# log-prob width K: the paper's LSTM acoustic model's tied triphone states
NUM_STATES = get_acoustic_config("lstm-asr").num_outputs
N_REQUESTS = 48
BATCH = 8
# Kernel vs plain version: |kernel - plain| <= ATOL + RTOL * |plain|.  Both
# are f32; they sum in different orders (sequential per slot in the
# kernel, PyTorch's reductions in the plain version) and the fused kernel
# scales the cumsum grid by kappa before the endpoint difference.  Scores
# reach |alpha| ~ 5e3 at T=1000, where one f32 ulp is 4.9e-4.
ATOL, RTOL = 1e-3, 1e-5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak rate
F32_FLOPS = 67e12          # H100 SXM f32 outside the tensor cores
TPU_KERNELS = {
    "dag_forward": "src/repro/kernels/lattice_fb.py:419",
    "dag_backward": "src/repro/kernels/lattice_fb.py:465",
    "dag_loss_only": "src/repro/kernels/lattice_fb.py:563",
}
SOURCE = "src/repro_torch/kernels/csrc/lattice_dag.cu"


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def log_probs(gen: torch.Generator, frames: int, dev) -> torch.Tensor:
    return torch.randn(frames, NUM_STATES, generator=gen,
                       device=dev).log_softmax(-1)


def compare(name: str, got, want, errs: dict, rel_errs: dict) -> None:
    """Hold kernel outputs against the plain version's; record the max
    abs error and the max relative error (over |plain| > ATOL) per case."""
    worst = worst_rel = 0.0
    for g, w in zip(got, want):
        diff = (g - w).abs()
        bad = diff > ATOL + RTOL * w.abs()
        check(not bool(bad.any()),
              f"{name}: {int(bad.sum())} entries outside |d| <= {ATOL} + "
              f"{RTOL}|ref| (max |d| {float(diff.max()):.3g})")
        if diff.numel():
            worst = max(worst, float(diff.max()))
        big = w.abs() > ATOL           # relative error where |plain| > ATOL
        if bool(big.any()):
            worst_rel = max(worst_rel,
                            float((diff[big] / w.abs()[big]).max()))
    errs[name] = max(errs.get(name, 0.0), worst)
    rel_errs[name] = max(rel_errs.get(name, 0.0), worst_rel)


def level_inputs(lat, lp):
    """The DAG kernels' level-major inputs for ``lat`` as the CUDA backend
    builds them: (forward args, backward args, frontiers)."""
    from repro_torch.lattice_engine.common import arc_scores
    from repro_torch.lattice_engine.cuda_backend import dag_level_tensors
    from repro_torch.losses.lattice import lattice_frontiers
    fr = lattice_frontiers(lat)
    own, corr, start, ok, final = dag_level_tensors(
        lat, arc_scores(lat, lp, KAPPA) + lat.lm, fr)
    return ((own, corr, start, ok, final, fr.pidx),
            (own, corr, final, ok, fr.sidx), fr)


def loss_only_inputs(lat, lp, fr):
    return (lp, lat.start_t, lat.end_t, lat.label, lat.lm, lat.corr,
            lat.arc_mask, lat.is_start, lat.is_final, lat.level_arcs,
            fr.pidx)


def check_kernels(lat, lp, errs: dict, rel_errs: dict, tag: str) -> None:
    from repro_torch.kernels import lattice_fb as K
    from repro_torch.kernels import ref as R
    fwd, bwd, fr = level_inputs(lat, lp)
    compare(f"dag_forward[{tag}]", K.dag_forward(*fwd),
            R.dag_forward_ref(*fwd), errs, rel_errs)
    compare(f"dag_backward[{tag}]", K.dag_backward(*bwd),
            R.dag_backward_ref(*bwd), errs, rel_errs)
    lo = loss_only_inputs(lat, lp, fr)
    compare(f"dag_loss_only[{tag}]", K.dag_loss_only(*lo, kappa=KAPPA),
            R.dag_loss_only_ref(*lo, kappa=KAPPA), errs, rel_errs)
    torch.cuda.synchronize()


def full_width_workload(dev):
    """Poisson mix at K=6000: sausages of T=300 and T=1000 and random
    DAGs of T=1000 (up to 10 s of 10 ms frames, MGB-like lengths)."""
    from repro_torch.losses.lattice import (make_random_dag_lattice,
                                            make_sausage_lattice)
    from repro_torch.serving.service import RescoreRequest
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    reqs, clock = [], 0.0
    for rid in range(N_REQUESTS):
        clock += float(rng.exponential(1.0 / 200.0))
        kind = rid % 3
        if kind == 0:
            d = make_sausage_lattice(rng, num_frames=300,
                                     num_states=NUM_STATES)
        elif kind == 1:
            d = make_sausage_lattice(rng, num_frames=1000,
                                     num_states=NUM_STATES)
        else:
            d = make_random_dag_lattice(rng, num_frames=1000,
                                        num_states=NUM_STATES)
        lp = log_probs(gen, d["ref_states"].shape[0], dev).cpu().numpy()
        reqs.append(RescoreRequest(rid, d, lp, arrival_s=clock))
    return reqs


def cuda_time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def bound(bytes_moved: float, flops: float) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def forward_work(fwd) -> tuple:
    """(bytes, flops) the forward function must move/do on these inputs:
    ok flags of every slot, own/corr/start/final of valid slots, the
    predecessor rows of valid non-start slots; alpha/c_alpha written."""
    own, _, start, ok, _, pidx = fwd
    okb = ok > 0.5
    n_ok = int(okb.sum())
    n_rec = int((okb & ~(start > 0.5)).sum())
    P = pidx.shape[-1]
    slots = own.numel()
    byt = 4 * slots + 16 * n_ok + 4 * P * n_rec + 8 * slots + 8 * own.shape[0]
    return byt, 8 * P * n_rec + 4 * n_ok


def backward_work(bwd) -> tuple:
    own, _, final, ok, sidx = bwd
    okb = ok > 0.5
    n_ok = int(okb.sum())
    n_rec = int((okb & ~(final > 0.5)).sum())
    S = sidx.shape[-1]
    slots = own.numel()
    byt = 4 * slots + 12 * n_ok + 4 * S * n_rec + 8 * slots
    return byt, 10 * S * n_rec


def loss_only_work(lat, lp, fr) -> tuple:
    """The whole function from log-probs: every log-prob read once (the
    cumsum needs all of them), the arc fields, level_arcs, the predecessor
    rows of valid non-start slots; two (B,) outputs."""
    B, A = lat.start_t.shape
    okb = fr.ok
    n_ok = int(okb.sum())
    n_rec = int((okb & ~fr.start).sum())
    P = fr.pidx.shape[-1]
    byt = (4 * lp.numel() + B * A * (4 * 5 + 3)
           + 4 * lat.level_arcs.numel() + 4 * P * n_rec + 8 * B)
    return byt, 4 * lp.numel() + 8 * P * n_rec + 10 * n_ok


def phase_kernels(dev, errs: dict) -> None:
    rel_errs: dict = {}
    from repro_torch.analysis.corpus import ADVERSARIAL_CASES
    from repro_torch.losses.lattice import (make_random_dag_lattice,
                                            make_sausage_lattice)
    from repro_torch.serving import packing
    from repro_torch.serving.streaming import session_bucket
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    for name, case in sorted(ADVERSARIAL_CASES.items()):
        lat, T, Kc = case(SEED, device=dev)
        lp = torch.randn(lat.start_t.shape[0], T, Kc, generator=gen,
                         device=dev).log_softmax(-1)
        check_kernels(lat, lp, errs, rel_errs, name)
    rng = np.random.default_rng(SEED + 2)
    for tag, make in (
            ("dag_b8_t1000", lambda: make_random_dag_lattice(
                rng, num_frames=1000, num_states=NUM_STATES)),
            ("sausage_b8_t1000", lambda: make_sausage_lattice(
                rng, num_frames=1000, num_states=NUM_STATES))):
        dicts = [make() for _ in range(BATCH)]
        spec = packing.derive_buckets(dicts, batch=BATCH, tiers=1)[0]
        lat, _ = packing.pack_requests(dicts, spec, device=dev)
        lp = torch.stack([log_probs(gen, spec.num_frames, dev)
                          for _ in range(BATCH)])
        check_kernels(lat, lp, errs, rel_errs, tag)
        log(f"kernels == plain at {tag}: bucket {tuple(spec)}")
    d = make_random_dag_lattice(rng, num_frames=1000, num_states=NUM_STATES)
    spec = session_bucket(d)
    lat, _ = packing.pack_requests([d], spec, device=dev)
    check_kernels(lat, log_probs(gen, spec.num_frames, dev)[None], errs,
                  rel_errs, "stream_bucket")
    log(f"kernels == plain at the streaming bucket {tuple(spec)} "
        f"(W = A)")
    log(f"every case within |kernel - plain| <= {ATOL} + {RTOL}|plain|; "
        f"max abs / max rel diff by case: "
        + ", ".join(f"{k} {v:.3g} / {rel_errs[k]:.3g}"
                    for k, v in sorted(errs.items())))


def phase_service(dev) -> dict:
    from repro_torch.kernels import lattice_fb as K
    from repro_torch.serving import packing
    from repro_torch.serving.service import RescoringService
    t0 = time.perf_counter()
    reqs = full_width_workload(dev)
    buckets = packing.derive_buckets([r.lattice for r in reqs],
                                     batch=BATCH, tiers=2)
    log(f"workload: {len(reqs)} requests made in "
        f"{time.perf_counter() - t0:.1f} s; buckets "
        + "; ".join(str(tuple(b)) for b in buckets))
    svc = RescoringService(buckets, kappa=KAPPA, device=dev)
    K.reset_launch_counts()
    reqs, metrics = svc.run(reqs)
    launches = K.dag_loss_only.launches
    check(all(r.status == "ok" for r in reqs),
          f"service: statuses {[r.status for r in reqs]}")
    check(all(c == 1 for c in svc.traces.values()),
          f"service: a bucket dispatched several shapes {svc.traces}")
    check(launches > 0, "service: dag_loss_only was never launched")
    check(K.dag_forward.launches == 0 and K.dag_backward.launches == 0,
          "service: the loss-only path launched the full-statistics kernels")
    n_dispatch = metrics["dispatches"] + len(buckets)     # + warm-up
    log(f"service on the card: {metrics['completed']}/{len(reqs)} ok, "
        f"{metrics['requests_per_s']:.2f} req/s, "
        f"p50 {metrics['latency_p50_s'] * 1e3:.3f} ms, "
        f"p99 {metrics['latency_p99_s'] * 1e3:.3f} ms, "
        f"slot_fill {metrics['slot_fill']:.3f}, "
        f"arc_fill {metrics['arc_fill']:.3f}, "
        f"{metrics['dispatches']} dispatches (+{len(buckets)} warm-up), "
        f"dag_loss_only launches {launches}")
    # per-request results against the plain levelized path on the card
    plain = RescoringService(buckets, kappa=KAPPA, backend="levelized",
                             device=dev).rescore(
        [r.lattice for r in reqs], [r.log_probs for r in reqs])
    worst = 0.0
    for r, p in zip(reqs, plain):
        for key in ("logZ", "c_avg"):
            d = abs(r.result[key] - p[key])
            check(d <= ATOL + RTOL * abs(p[key]),
                  f"service request {r.rid} {key}: kernel {r.result[key]} "
                  f"vs plain {p[key]}")
            worst = max(worst, d)
    log(f"service results == plain levelized path on the card "
        f"(max |d| {worst:.3g})")
    # batch-mix independence: the same requests in other mixes, bitwise
    spec = max(buckets, key=lambda b: b.cost)
    group = [r for r in reqs if packing.fits(r.dims, spec)][:spec.batch]
    base = svc.dispatch([r.lattice for r in group],
                        [r.log_probs for r in group], spec)
    rev = svc.dispatch([r.lattice for r in group[::-1]],
                       [r.log_probs for r in group[::-1]], spec)
    for k, r in enumerate(group):
        alone = svc.dispatch([r.lattice], [r.log_probs], spec)
        j = len(group) - 1 - k
        for i in range(2):
            check(base[i][k] == alone[i][0] == rev[i][j],
                  f"batch mix changed request {r.rid}'s bits")
    log(f"batch-mix independence: {len(group)} requests bitwise equal "
        f"alone, in order and reversed, bucket {tuple(spec)}")
    # where a full-bucket dispatch's time goes: the whole timed region
    # against the host-to-device copy of its log-probs alone
    lat, _ = packing.pack_requests([r.lattice for r in group], spec,
                                   device=dev)
    lp_host = packing.pack_log_probs([r.log_probs for r in group], spec)
    dispatch_ms = min(svc.dispatch([r.lattice for r in group],
                                   [r.log_probs for r in group], spec)[2]
                      for _ in range(3)) * 1e3
    copies = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lp = torch.from_numpy(lp_host).to(dev)
        torch.cuda.synchronize()
        copies.append((time.perf_counter() - t0) * 1e3)
    h2d_ms = min(copies)
    log(f"full-bucket dispatch {dispatch_ms:.3f} ms (min of 3), of which "
        f"the log-prob copy to the card {h2d_ms:.3f} ms "
        f"({lp_host.nbytes / 1e6:.0f} MB from pageable host memory)")
    return {"metrics": metrics, "launches": launches,
            "dispatch_ms": dispatch_ms, "h2d_ms": h2d_ms,
            "launches_per_dispatch": launches / n_dispatch,
            "bucket": spec, "lat": lat, "lp": lp}


def phase_streaming(dev, errs: dict) -> dict:
    from repro_torch.kernels import lattice_fb as K
    from repro_torch.lattice_engine import lattice_stats
    from repro_torch.losses.lattice import (batch_lattices,
                                            make_random_dag_lattice)
    from repro_torch.serving.packing import (pack_log_probs, pack_requests,
                                             pad_to_bucket)
    from repro_torch.serving.streaming import (StreamSession,
                                               resume_lattice_dict,
                                               session_bucket,
                                               truncate_levels)
    rng = np.random.default_rng(SEED + 3)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    d = make_random_dag_lattice(rng, num_frames=1000, num_states=NUM_STATES)
    lp = log_probs(gen, d["ref_states"].shape[0], dev).cpu().numpy()
    spec = session_bucket(d)
    sess = StreamSession(spec, kappa=KAPPA, device=dev)
    cut = max(1, d["level_arcs"].shape[0] // 2)
    K.reset_launch_counts()
    sess.rescore(truncate_levels(d, cut), lp)
    half = sess.checkpoint
    resumed = sess.rescore(d, lp)
    launches = {"dag_forward": K.dag_forward.launches,
                "dag_backward": K.dag_backward.launches,
                "dag_loss_only": K.dag_loss_only.launches}
    check(launches["dag_forward"] > 0 and launches["dag_backward"] > 0,
          f"streaming: full-statistics kernels not launched {launches}")
    scratch = sess.rescore_from_scratch(d, lp)
    check(resumed.logZ == scratch.logZ and resumed.c_avg == scratch.c_avg,
          f"streaming resume ({resumed.logZ!r}, {resumed.c_avg!r}) != "
          f"from scratch ({scratch.logZ!r}, {scratch.c_avg!r})")
    check(sess.traces == 1, f"streaming dispatched {sess.traces} shapes")
    plain = StreamSession(spec, kappa=KAPPA, backend="levelized",
                          device=dev).rescore_from_scratch(d, lp)
    for key in ("logZ", "c_avg"):
        a, b = float(getattr(resumed, key)), float(getattr(plain, key))
        check(abs(a - b) <= ATOL + RTOL * abs(b),
              f"streaming {key}: kernel path {a} vs plain {b}")
    log(f"streaming on the card: cut {cut}/{d['level_arcs'].shape[0]} "
        f"levels, resume bit-exact vs from-scratch (logZ "
        f"{float(resumed.logZ)!r}, c_avg {float(resumed.c_avg)!r}), "
        f"== plain levelized path; launches {launches} over 2 session "
        f"dispatches")
    # The session's result goes through finalize_loss_only (arc layout),
    # as the JAX session's does.  Hold the kernels at the resume lattice
    # the second dispatch ran, and the forward kernel's own final-arc
    # fold (flat level-major order) bit-exact between resume and scratch.
    lp_dev = torch.from_numpy(pack_log_probs([lp], spec)).to(dev)
    rd = resume_lattice_dict(pad_to_bucket(d, spec), *half)
    lat_resume = batch_lattices([pad_to_bucket(rd, spec)], device=dev)
    rel_errs: dict = {}
    check_kernels(lat_resume, lp_dev, errs, rel_errs, "stream_resume")
    lat, _ = pack_requests([pad_to_bucket(d, spec)], spec, device=dev)
    folds = [lattice_stats(x, lp_dev, KAPPA, backend="cuda",
                           accumulators="full") for x in (lat_resume, lat)]
    for key in ("logZ", "c_avg"):
        a, b = (getattr(st, key) for st in folds)
        check(torch.equal(a, b),
              f"streaming: dag_forward's final fold {key} on the resume "
              f"lattice {a.tolist()} != from scratch {b.tolist()}")
    log(f"kernels == plain on the resume lattice (max |d| forward "
        f"{errs['dag_forward[stream_resume]']:.3g}, backward "
        f"{errs['dag_backward[stream_resume]']:.3g}); dag_forward's own "
        f"final fold bit-exact resume vs scratch (logZ "
        f"{float(folds[0].logZ[0])!r}, c_avg {float(folds[0].c_avg[0])!r})")
    return {"launches": launches, "dispatches": 2, "bucket": spec,
            "lat": lat, "lp": lp_dev}


def phase_times(service: dict, stream: dict, errs: dict) -> list:
    from repro_torch.kernels import lattice_fb as K
    from repro_torch.kernels import ref as R
    rows = []
    rel_errs: dict = {}
    shapes = {"service": service, "session": stream}
    for where in ("service", "session"):
        sh = shapes[where]
        lat, lp = sh["lat"], sh["lp"]
        fwd, bwd, fr = level_inputs(lat, lp)
        lo = loss_only_inputs(lat, lp, fr)
        pro = K.loss_only_prologue(*lo[:9], KAPPA)
        timed = {
            "dag_forward": (lambda: K.dag_forward(*fwd),
                            lambda: R.dag_forward_ref(*fwd),
                            forward_work(fwd)),
            "dag_backward": (lambda: K.dag_backward(*bwd),
                             lambda: R.dag_backward_ref(*bwd),
                             backward_work(bwd)),
            "dag_loss_only": (lambda: K.dag_loss_only(*lo, kappa=KAPPA),
                              lambda: R.dag_loss_only_ref(*lo, kappa=KAPPA),
                              loss_only_work(lat, lp, fr)),
        }
        for name, (kern, plain, (byt, flops)) in timed.items():
            compare(f"{name}[{where}]", kern(), plain(), errs, rel_errs)
            ms = cuda_time_ms(kern, 20)
            plain_ms = cuda_time_ms(plain, 3)
            b_ms, b_by = bound(byt, flops)
            row = {"name": name, "shape": where,
                   "B_L_W": list(lat.level_arcs.shape),
                   "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                   "bound_by": b_by, "bytes": byt}
            if name == "dag_loss_only":
                row["prologue_ms"] = cuda_time_ms(
                    lambda: K.loss_only_prologue(*lo[:9], KAPPA), 20)
                row["kernel_only_ms"] = cuda_time_ms(
                    lambda: K.dag_loss_only_from_grid(*pro, lat.level_arcs,
                                                      fr.pidx), 20)
            rows.append(row)
            log(f"{name} == plain at the {where} shape {row['B_L_W']} "
                f"(max |d| {errs[f'{name}[{where}]']:.3g}, max rel "
                f"{rel_errs[f'{name}[{where}]']:.3g}); time: "
                + ", ".join(f"{k} {v:.6g}" for k, v in row.items()
                            if isinstance(v, float)))
    main = {"dag_loss_only": "service", "dag_forward": "session",
            "dag_backward": "session"}
    out = []
    for name in ("dag_forward", "dag_backward", "dag_loss_only"):
        row = next(r for r in rows
                   if r["name"] == name and r["shape"] == main[name])
        path = shapes[main[name]]
        launches = path["launches"] if name == "dag_loss_only" else \
            stream["launches"][name]
        per_dispatch = (service["launches_per_dispatch"]
                        if name == "dag_loss_only"
                        else launches / stream["dispatches"])
        err = max(v for k, v in errs.items() if k.startswith(name + "["))
        entry = {"name": name, "route": "cuda", "source": SOURCE,
                 "replaces": TPU_KERNELS[name], "launches": launches,
                 "max_abs_err": err, "ms": row["ms"],
                 "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                 "bound_by": row["bound_by"], "library_ms": None,
                 "launches_per_dispatch": per_dispatch,
                 "shape": f"{main[name]} B,L,W={row['B_L_W']}"}
        for extra in ("prologue_ms", "kernel_only_ms"):
            if extra in row:
                entry[extra] = row[extra]
        out.append(entry)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("[chip_smoke] torch.cuda.is_available() is False: this "
              "script runs the port on a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build

    dev = resolve_device("cuda")
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    build.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.2f} s")
    for line in build.build_log("lattice_dag").splitlines():
        if "registers" in line or "spill" in line:
            log(f"ptxas: {line.strip()}")
    errs: dict = {}
    phase_kernels(dev, errs)
    service = phase_service(dev)
    stream = phase_streaming(dev, errs)
    kernels = phase_times(service, stream, errs)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
