"""Batched serving driver: continuous-batching style decode loop.

Port of ``repro.launch.serve``.  Requests arrive with prompts of varying
length; slots are assigned from a fixed batch; every slot shares one
serve step (ONE token per step against the cache).  Prompts are fed
token by token through the same decode path (``launch.steps.
build_prefill_step`` is the dedicated prefill path).

CPU demo (plain PyTorch versions of the kernels):
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch recurrentgemma-9b --smoke --device cpu --requests 6
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch qwen2.5-3b --smoke --device cpu --long-mode
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch granite-moe-3b-a800m --smoke --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config, list_archs
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.launch.steps import build_serve_step
from repro_torch.models.registry import get_model
from repro_torch.serving.metrics import latency_summary


class Request:
    def __init__(self, rid, prompt, max_new):
        self.rid = rid
        self.prompt = list(prompt)
        self.max_new = max_new
        self.generated = []
        self.done = False


def make_requests(cfg, n: int, max_new: int, seed: int = 0) -> list:
    """``n`` requests with prompts of 4-11 tokens drawn uniformly from the
    vocabulary by ``np.random.default_rng(seed)``, as ``main`` (and the
    reference's ``main``) draws them."""
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, cfg.vocab_size,
                                    size=rng.integers(4, 12)).tolist(),
                    max_new)
            for i in range(n)]


def serve(cfg, model, params, requests, *, cache_len=256, greedy=True,
          long_mode=False, seed=0):
    """Run all requests to completion with a shared batched decode step.

    Returns the list of Requests with ``generated`` filled in, plus a
    metrics dict with throughput (``tokens_per_s``) and per-request
    wall-clock completion latency (``latency_p50_s``/``latency_p99_s``,
    measured from serve start to the step that finishes the request).
    Slots all advance in lock-step positions.  The device is that of
    ``params``; every step reads its next tokens back to the host, so the
    clock sees finished device work.  Greedy decoding picks the first
    maximal logit, as ``jnp.argmax``.  Sampling draws from the softmax
    of the logits (temperature 1) with a ``torch.Generator`` on the
    device seeded with ``seed``: it cannot give ``jax.random``'s draws,
    so sampled tokens differ from the reference's for the same seed.
    The reference's ``temperature`` is left out until a caller needs
    another one.  ``long_mode`` bounds the caches of global attention to
    rings of ``cfg.long_context_window`` slots (the reference's long_500k
    cache).
    """
    if not requests:
        return requests, {"tokens_per_s": 0.0, "wall_s": 0.0, "steps": 0,
                          "latency_p50_s": float("nan"),
                          "latency_p99_s": float("nan")}
    dev = params["embed.table"].device
    B = len(requests)
    cache = model.init_cache(B, cache_len, long_mode=long_mode, device=dev)
    step = build_serve_step(cfg, long_mode=long_mode)
    gen = torch.Generator(device=dev).manual_seed(seed)
    max_prompt = max(len(r.prompt) for r in requests)
    max_steps = max_prompt + max(r.max_new for r in requests)
    t0 = time.perf_counter()
    n_tok = 0
    latencies = []
    for pos in range(max_steps):
        feed = []
        n_live = 0
        for r in requests:
            if pos < len(r.prompt):
                feed.append(r.prompt[pos])
                n_live += 1
            elif r.generated and not r.done:
                feed.append(r.generated[-1])
                n_live += 1
            else:
                feed.append(0)            # idle/finished slot: pad token
        tokens = torch.tensor(feed, dtype=torch.int64, device=dev)[:, None]
        logits, cache = step(params, cache, tokens, pos)
        # only slots doing real work count toward throughput
        n_tok += n_live
        if greedy:
            nxt = torch.argmax(logits[:, 0], -1)
        else:
            probs = torch.softmax(logits[:, 0], -1)
            nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
        nxt = nxt.cpu().tolist()
        for i, r in enumerate(requests):
            if r.done or pos < len(r.prompt) - 1:
                continue
            r.generated.append(int(nxt[i]))
            if len(r.generated) >= r.max_new:
                r.done = True
                latencies.append(time.perf_counter() - t0)
        if all(r.done for r in requests):
            break
    dt = time.perf_counter() - t0
    # requests still live when max_steps ran out completed at loop exit
    latencies += [dt] * (len(requests) - len(latencies))
    metrics = {"tokens_per_s": n_tok / max(dt, 1e-9),
               "wall_s": dt, "steps": pos + 1}
    metrics.update(latency_summary(latencies))
    return requests, metrics


def main(argv=None):
    archs = list_archs()
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m", choices=archs)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--long-mode", action="store_true",
                    help="bounded ring caches for global attention")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    model = get_model(cfg)
    params = model.init(0, device=dev)
    reqs = make_requests(cfg, args.requests, args.max_new, seed=0)
    reqs, stats = serve(cfg, model, params, reqs, cache_len=args.cache_len,
                        long_mode=args.long_mode)
    for r in reqs:
        print(f"req {r.rid}: prompt[{len(r.prompt)}] -> {r.generated}")
    print(f"[serve] {stats['tokens_per_s']:.1f} tok/s over {stats['steps']} "
          f"steps, latency p50 {stats['latency_p50_s'] * 1e3:.0f}ms "
          f"p99 {stats['latency_p99_s'] * 1e3:.0f}ms on {dev}")
    return stats


if __name__ == "__main__":
    main()
