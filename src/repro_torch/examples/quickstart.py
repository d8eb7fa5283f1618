"""Quickstart: train a tiny transformer LM with the NGHF optimiser, then
decode a few tokens greedily.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Port of ``examples/quickstart.py``: the public API end to end, config ->
model -> loss -> NGHF update -> KV-cache decode, on qwen2.5-3b's smoke
config (GQA + SwiGLU), the same batches (``data.synthetic.lm_batch``,
bitwise the reference's) and optimiser settings.  The parameters are
drawn by ``torch.Generator``, so the numbers differ from the reference's
unless its parameters are carried across (``convert.
lm_params_from_numpy``, as the port's test does).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs.base import get_config
from repro_torch.core import optim
from repro_torch.data.synthetic import lm_batch
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.losses.chunked_lm import ChunkedCELoss
from repro_torch.models.registry import get_model

CFG = get_config("qwen2.5-3b").smoke()
BATCH, SEQ, CG_ROWS = 32, 64, 8


def train(cfg, model, params, *, steps: int, device) -> tuple:
    """``steps`` NGHF updates of ``params`` on ``lm_batch(step)``; the CG
    batch is the gradient batch's first ``CG_ROWS`` rows.  Returns (the
    new parameters, each update's metrics)."""
    # the loss works on (hidden, lm_head), so the (B, T, V) logits are
    # never materialised: the same code path scales to 256k vocabularies
    loss = ChunkedCELoss(t_chunk=32)

    def fwd(p, batch):
        hidden, aux = model.forward_hidden(p, batch)
        return (hidden, model.head_matrix(p)), cfg.router_aux_coef * aux

    # one NGHF update = the gradient, the Fisher CG, the GN CG and the
    # candidate selection (paper Fig. 1); every optimiser ("sgd" | "adam"
    # | "ng" | "hf" | "nghf") has the same protocol: init once, then step
    opt = optim.get_optimizer("nghf", fwd, loss, cg_iters=4, ng_iters=2,
                              lam=1.0)
    opt_state = opt.init(params)
    log = []
    for step in range(steps):
        gb = lm_batch(step, batch=BATCH, seq_len=SEQ, vocab=cfg.vocab_size,
                      device=device)
        # the CG batch is a slice of the gradient batch (at toy scale the
        # gradient noise across disjoint batches swamps the quadratic
        # model, and the acceptance guard would reject every step)
        cb = {k: v[:CG_ROWS] for k, v in gb.items()}
        params, opt_state, metrics = opt.step(params, opt_state, gb, cb)
        log.append(metrics)
        print(f"step {step}: ce={float(metrics['ce']):.4f} "
              f"acc={float(metrics['acc']):.3f} "
              f"cg_best_iter={int(metrics['cg_best_iter'])} "
              f"accepted={bool(metrics['cg_accepted'])}")
    return params, log


def greedy(model, params, *, tokens: int = 8, device) -> list:
    """``tokens`` greedy decode steps from token 0 with the KV cache."""
    cache = model.init_cache(1, 32, device=device)
    tok = torch.zeros((1, 1), dtype=torch.int64, device=device)
    out = []
    with torch.no_grad():
        for t in range(tokens):
            logits, cache = model.decode_step(params, cache, tok, t)
            tok = torch.argmax(logits[:, 0], -1)[:, None]
            out.append(int(tok[0, 0]))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    model = get_model(CFG)
    params = model.init(0, device=dev)
    print(f"model: {CFG.name} ({model.param_count() / 1e6:.2f}M params, "
          f"smoke)")
    params, log = train(CFG, model, params, steps=args.steps, device=dev)
    sampled = greedy(model, params, device=dev)
    print("sampled:", sampled)
    return {"log": log, "sampled": sampled}


if __name__ == "__main__":
    main()
