"""Lattice-rescoring service: queue, admission, slots, batched dispatch.

Port of ``repro.serving.service``, for the lattice engine's forward-only
rescoring primitive (``lattice_stats(accumulators="loss_only")``: one
``dag_loss_only`` kernel launch per dispatch on the card).  Requests
carry one lattice + its frame log-probs; the service:

  * **admits** them into a bounded queue (overflow is rejected at
    arrival — backpressure, not unbounded buffering);
  * **assigns slots** bucket-wise: the head-of-line request picks the
    smallest fitting ``BucketSpec``, then up to ``spec.batch`` queued
    requests that fit the same bucket share the dispatch (idle slots are
    fully-masked lattices; only live slots count toward throughput/fill);
  * **enforces deadlines** per request at batch formation (an expired
    request times out instead of wasting a slot);
  * **dispatches** one input shape per bucket — ``traces`` counts the
    distinct shapes each bucket dispatched, and must stay 1.

Scheduling runs on a *virtual clock* driven by the requests' arrival
offsets while each dispatch is timed for real (``torch.cuda.
synchronize()`` on both sides of the call on the card), so a synthetic
workload yields reproducible queueing behaviour with honest compute
costs.

Smoke:  PYTHONPATH=src python -m repro_torch.serving.service --smoke
        [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from collections import deque

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.lattice_engine import BACKENDS, lattice_stats
from repro_torch.serving import packing
from repro_torch.serving.metrics import latency_summary
from repro_torch.serving.streaming import (StreamSession, session_bucket,
                                           truncate_levels)


def _sync(device: torch.device) -> None:  # reprolint: host: the serving clock waits for the card
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class RescoreRequest:
    """One rescoring request: a lattice dict + (T, K) log-probs."""

    def __init__(self, rid, lattice: dict, log_probs, *,  # reprolint: host: numpy request
                 arrival_s: float = 0.0, deadline_s=None):
        self.rid = rid
        self.lattice = lattice
        self.log_probs = np.asarray(log_probs, np.float32)
        self.arrival_s = float(arrival_s)
        self.deadline_s = deadline_s
        self.dims = packing.lattice_dims(lattice)
        self.status = "pending"     # -> ok | timeout | rejected
        self.result = None          # {"logZ": float, "c_avg": float}
        self.latency_s = None


class RescoringService:
    """Bucket-batched rescoring behind an admission/slot loop."""

    def __init__(self, buckets, *, kappa: float = 0.5,
                 backend: str = "auto", max_queue: int = 64,
                 device=DEFAULT_DEVICE):
        self.buckets = tuple(buckets)
        if not self.buckets:
            raise ValueError("RescoringService needs at least one "
                             "BucketSpec (see packing.derive_buckets)")
        if backend not in BACKENDS + ("auto",):
            raise ValueError(f"unknown lattice backend {backend!r}; "
                             f"expected one of {BACKENDS + ('auto',)}")
        self.kappa = kappa
        self.backend = backend
        self.max_queue = max_queue
        self.device = resolve_device(device)
        self.traces = {}            # spec -> distinct input shapes seen
        self._shapes = {}

    def _run(self, spec, lat, lp):
        shapes = self._shapes.setdefault(spec, set())
        shapes.add((tuple(lat.level_arcs.shape), tuple(lat.preds.shape),
                    tuple(lp.shape)))
        self.traces[spec] = len(shapes)
        # DAG kernels for every bucket, sausages included, as the jitted
        # reference service runs them: a request's bits must not depend on
        # whether its batch mates make the batch a sausage
        return lattice_stats(lat, lp, self.kappa, backend=self.backend,
                             accumulators="loss_only", topology="dag")

    def warmup(self, num_states: int):  # reprolint: host: numpy inputs, off the clock
        """Run every bucket once off the serving clock (builds the kernels
        and warms the allocator).  ``num_states`` must match the traffic's
        log-prob K — one acoustic model, hence one K, per deployment."""
        for spec in self.buckets:
            self.dispatch(
                [packing.empty_lattice_dict(spec)],
                [np.zeros((spec.num_frames, num_states), np.float32)],
                spec)

    def dispatch(self, dicts, lps, spec):
        """Pack + run one bucket dispatch; returns (logZ, c_avg, dt_s)
        for the live slots.  The timed region starts with the log-probs'
        copy to the device and ends when the device is done."""
        lat, n_live = packing.pack_requests(dicts, spec, device=self.device)
        lp = packing.pack_log_probs(lps, spec)
        _sync(self.device)
        t0 = time.perf_counter()
        out = self._run(spec, lat, torch.from_numpy(lp).to(self.device))
        _sync(self.device)
        dt = time.perf_counter() - t0
        return (packing.unpack(out.logZ, n_live),
                packing.unpack(out.c_avg, n_live), dt)

    def rescore(self, dicts, lps):
        """One-shot convenience: rescore a list of lattices now (no
        queueing), grouped greedily into bucket dispatches.  Returns a
        list of {"logZ", "c_avg"} in input order."""
        results = [None] * len(dicts)
        pending = deque(range(len(dicts)))
        while pending:
            spec = packing.choose_bucket(
                packing.lattice_dims(dicts[pending[0]]), self.buckets)
            batch = [i for i in pending
                     if packing.fits(packing.lattice_dims(dicts[i]), spec)
                     ][:spec.batch]
            for i in batch:
                pending.remove(i)
            logZ, c_avg, _ = self.dispatch([dicts[i] for i in batch],
                                           [lps[i] for i in batch], spec)
            for k, i in enumerate(batch):
                results[i] = {"logZ": float(logZ[k]),
                              "c_avg": float(c_avg[k])}
        return results

    def run(self, requests, *, warmup: bool = True):
        """Serve a workload of ``RescoreRequest``s to completion.

        Virtual clock: starts at 0, jumps forward to arrivals when idle,
        and advances by each dispatch's measured wall time.  Returns
        ``(requests, metrics)``.
        """
        if warmup and requests:
            self.warmup(int(requests[0].log_probs.shape[-1]))
        events = sorted(requests, key=lambda r: r.arrival_s)
        queue: deque = deque()
        clock = 0.0
        i = 0
        dispatches = 0
        live_slots = 0
        total_slots = 0
        arc_fill_num = 0.0
        while i < len(events) or queue:
            while i < len(events) and events[i].arrival_s <= clock:
                r = events[i]
                i += 1
                if len(queue) >= self.max_queue:
                    r.status = "rejected"
                    continue
                queue.append(r)
            if not queue:
                clock = events[i].arrival_s
                continue
            # drop requests whose deadline expired while queued
            alive = deque()
            for r in queue:
                if (r.deadline_s is not None
                        and clock - r.arrival_s > r.deadline_s):
                    r.status = "timeout"
                else:
                    alive.append(r)
            queue = alive
            if not queue:
                continue
            # slot assignment: head-of-line picks the bucket, everyone
            # queued that fits the same bucket shares the dispatch
            spec = packing.choose_bucket(queue[0].dims, self.buckets)
            batch = [r for r in queue
                     if packing.fits(r.dims, spec)][:spec.batch]
            for r in batch:
                queue.remove(r)
            logZ, c_avg, dt = self.dispatch([r.lattice for r in batch],
                                            [r.log_probs for r in batch],
                                            spec)
            clock += dt
            dispatches += 1
            live_slots += len(batch)
            total_slots += spec.batch
            arc_fill_num += sum(r.dims.num_arcs for r in batch) / float(
                spec.num_arcs)
            for k, r in enumerate(batch):
                r.status = "ok"
                r.result = {"logZ": float(logZ[k]),
                            "c_avg": float(c_avg[k])}
                r.latency_s = clock - r.arrival_s
        done = [r for r in requests if r.status == "ok"]
        metrics = {
            "completed": len(done),
            "rejected": sum(r.status == "rejected" for r in requests),
            "timeout": sum(r.status == "timeout" for r in requests),
            "dispatches": dispatches,
            "wall_s": clock,
            "requests_per_s": len(done) / max(clock, 1e-9),
            "slot_fill": live_slots / max(total_slots, 1),
            "arc_fill": arc_fill_num / max(total_slots, 1),
        }
        metrics.update(latency_summary([r.latency_s for r in done]))
        return requests, metrics

    def stream_session(self, final_dict: dict,
                       resume_levels: int | None = None) -> StreamSession:
        """Open a streaming session pinned to ``final_dict``'s envelope,
        on the service's device.  ``resume_levels`` opts into the
        shallow-bucket fast resume path (see ``StreamSession``)."""
        return StreamSession(session_bucket(final_dict),
                             kappa=self.kappa, backend=self.backend,
                             resume_levels=resume_levels,
                             device=self.device)


def synthetic_workload(seed: int, n_requests: int, *,  # reprolint: host: numpy request generator
                       rate_hz: float = 200.0, num_states: int = 6,
                       deadline_s: float | None = None):
    """Poisson-arrival mixed-size workload: small/large sausages and
    random DAGs, exponential inter-arrival gaps at ``rate_hz``."""
    from repro_torch.losses.lattice import (make_random_dag_lattice,
                                            make_sausage_lattice)

    rng = np.random.default_rng(seed)
    reqs = []
    clock = 0.0
    for rid in range(n_requests):
        clock += float(rng.exponential(1.0 / rate_hz))
        kind = rid % 3
        if kind == 0:
            d = make_sausage_lattice(rng, num_frames=8,
                                     num_states=num_states, seg_len=4,
                                     n_alt=2)
        elif kind == 1:
            d = make_sausage_lattice(rng, num_frames=16,
                                     num_states=num_states, seg_len=4,
                                     n_alt=3)
        else:
            d = make_random_dag_lattice(rng, num_frames=12,
                                        num_states=num_states)
        T = d["ref_states"].shape[0]
        lp = np.asarray(rng.normal(0, 1, (T, num_states)), np.float32)
        lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
        reqs.append(RescoreRequest(rid, d, lp, arrival_s=clock,
                                   deadline_s=deadline_s))
    return reqs


def main(argv=None):  # reprolint: host: the CLI
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serving.service",
        description="bucket-batched lattice rescoring service")
    ap.add_argument("--smoke", action="store_true",
                    help="small synthetic workload + streaming demo")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--rate-hz", type=float, default=200.0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="'cuda' (default; raises without a card) or 'cpu'")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    n = min(args.requests, 12) if args.smoke else args.requests
    reqs = synthetic_workload(args.seed, n, rate_hz=args.rate_hz)
    buckets = packing.derive_buckets([r.lattice for r in reqs],
                                     batch=args.batch, tiers=2)
    svc = RescoringService(buckets, backend=args.backend,
                           device=args.device)
    reqs, metrics = svc.run(reqs)
    for spec, count in svc.traces.items():
        if count != 1:
            raise SystemExit(f"bucket {tuple(spec)} dispatched {count} "
                             f"input shapes")
    print(f"[serving] {metrics['completed']}/{len(reqs)} ok on "
          f"{svc.device}, {metrics['requests_per_s']:.1f} req/s, "
          f"p50 {metrics['latency_p50_s'] * 1e3:.1f}ms "
          f"p99 {metrics['latency_p99_s'] * 1e3:.1f}ms, "
          f"slot_fill {metrics['slot_fill']:.2f} "
          f"arc_fill {metrics['arc_fill']:.2f} "
          f"over {metrics['dispatches']} dispatches "
          f"({len(buckets)} buckets, one shape each)")

    # streaming demo: checkpoint half the levels, resume, compare bits
    from repro_torch.losses.lattice import make_random_dag_lattice
    rng = np.random.default_rng(args.seed)
    d = make_random_dag_lattice(rng, num_frames=12, num_states=6)
    T = d["ref_states"].shape[0]
    lp = np.asarray(rng.normal(0, 1, (T, 6)), np.float32)
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
    sess = svc.stream_session(d)
    cut = max(1, d["level_arcs"].shape[0] // 2)
    sess.rescore(truncate_levels(d, cut), lp)
    resumed = sess.rescore(d, lp)
    scratch = sess.rescore_from_scratch(d, lp)
    exact = (resumed.logZ == scratch.logZ
             and resumed.c_avg == scratch.c_avg)
    print(f"[serving] streaming resume bit-exact vs from-scratch: "
          f"{bool(exact)} (logZ {float(resumed.logZ):.4f}, "
          f"{sess.traces} shape)")
    if not exact:
        raise SystemExit("streaming resume diverged from from-scratch")
    return metrics


if __name__ == "__main__":
    main()
