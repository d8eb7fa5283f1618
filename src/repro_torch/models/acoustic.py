"""Paper-faithful acoustic models (Sec. 4.3 / 7 of the NGHF paper).

Port of ``repro.models.acoustic``: hybrid NN-HMM output models mapping
features (B, T, input_dim) to per-frame logits over ~6000 tied states.

  * RNN  — two 1000-dim Elman recurrent layers + one 1000-dim FF layer.
  * LSTM — same structure with LSTM cells (paper Sec. 4.3 equations).
  * TDNN — five 1000-dim FC layers splicing time contexts
           {-2..2},{-1,2},{-3,3},{-7,2},{0}.

Parameters are a flat ``dict[str, Tensor]`` keyed like the reference's
pytree (``"rec0.w"``, ``"rec0.b"``, ``"ff0.w"``, ``"out.w"`` ...) with
the reference's layout: ``x @ w + b``, ``w`` of shape (d_in, d_out), the
LSTM gates in the order (i, f, g, o) with the ``+1.0`` forget bias.  The
time loop is written out: ``nn.LSTM``/cuDNN computes other gate math and
has no forward-mode derivative, which the R-operator (``torch.func.jvp``)
needs.  The recurrent layers project every frame's input in one matrix
product before the loop and multiply only h_{t-1} inside it; that is the
same sum as the reference's ``concat(x_t, h) @ w`` in another order.
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device


def _act(name: str, x):
    if name == "relu":
        return torch.relu(x)
    if name == "sigmoid":
        return torch.sigmoid(x)
    raise ValueError(f"unknown activation {name!r}")


def _fc(gen: torch.Generator, d_in: int, d_out: int, prefix: str) -> dict:
    w = torch.randn(d_in, d_out, generator=gen) / math.sqrt(d_in)
    return {f"{prefix}.w": w, f"{prefix}.b": torch.zeros(d_out)}


def init_params(cfg, seed: int = 0, device=DEFAULT_DEVICE) -> dict:
    """Random parameters: N(0, 1/d_in) weights, zero biases, drawn on the
    CPU from a ``torch.Generator`` seeded with ``seed`` and placed on
    ``device`` (default the card; raises without one).  (The reference
    draws with ``jax.random``; carry its parameters across with
    ``convert.acoustic_params_from_numpy``.)"""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    h = cfg.hidden_dim
    params = {}
    if cfg.kind in ("rnn", "lstm"):
        mult = 4 if cfg.kind == "lstm" else 1
        d_in = cfg.input_dim
        for i in range(cfg.num_recurrent_layers):
            params.update(_fc(gen, d_in + h, mult * h, f"rec{i}"))
            d_in = h
        for i in range(cfg.num_ff_layers):
            params.update(_fc(gen, d_in, h, f"ff{i}"))
            d_in = h
        params.update(_fc(gen, d_in, cfg.num_outputs, "out"))
    elif cfg.kind == "tdnn":
        d_in = cfg.input_dim
        for i, ctx in enumerate(cfg.tdnn_contexts):
            params.update(_fc(gen, d_in * len(ctx), h, f"tdnn{i}"))
            d_in = h
        params.update(_fc(gen, d_in, cfg.num_outputs, "out"))
    else:
        raise ValueError(cfg.kind)
    return {k: v.to(dev) for k, v in params.items()}


def _fc_apply(params: dict, prefix: str, x):
    return x @ params[f"{prefix}.w"] + params[f"{prefix}.b"]


def _recurrent(cfg, params: dict, prefix: str, x, lstm: bool):
    """One recurrent layer over x (B, T, D) -> (B, T, H)."""
    B, T, D = x.shape
    H = cfg.hidden_dim
    w, b = params[f"{prefix}.w"], params[f"{prefix}.b"]
    xw = x @ w[:D] + b                        # every frame's input part
    w_h = w[D:]
    h = x.new_zeros(B, H)
    c = x.new_zeros(B, H)
    hs = []
    for t in range(T):
        z = xw[:, t] + h @ w_h
        if lstm:
            i, f, g, o = z.split(H, dim=-1)
            i, f, o = torch.sigmoid(i), torch.sigmoid(f + 1.0), \
                torch.sigmoid(o)
            c = f * c + i * torch.tanh(g)
            h = o * torch.tanh(c)
        else:
            h = _act(cfg.activation, z)
        hs.append(h)
    return torch.stack(hs, dim=1)


def _splice(x, ctx):
    """Concatenate x shifted by each offset in ctx (edge-padded)."""
    T = x.shape[1]
    t = torch.arange(T, device=x.device)
    return torch.cat([x[:, (t + c).clamp(0, T - 1)] for c in ctx], dim=-1)


def forward(cfg, params: dict, feats):
    """feats: (B, T, input_dim) -> logits (B, T, num_outputs)."""
    x = feats.to(torch.float32)
    if cfg.kind in ("rnn", "lstm"):
        for i in range(cfg.num_recurrent_layers):
            x = _recurrent(cfg, params, f"rec{i}", x, cfg.kind == "lstm")
        for i in range(cfg.num_ff_layers):
            x = _act(cfg.activation, _fc_apply(params, f"ff{i}", x))
    else:
        for i, ctx in enumerate(cfg.tdnn_contexts):
            x = _act(cfg.activation,
                     _fc_apply(params, f"tdnn{i}", _splice(x, ctx)))
    return _fc_apply(params, "out", x)


def share_counts(cfg, params: dict) -> dict:
    """Per-leaf application counts c(i) for the Sec. 4.3 preconditioner
    (Python floats, one per parameter key).

    Recurrent cells: ``unfold`` applications per output frame (truncated
    BPTT depth).  TDNN layer l (tree view): prod of |ctx_j| for j > l.
    FF / output layers: 1."""
    counts = {}
    if cfg.kind in ("rnn", "lstm"):
        for i in range(cfg.num_recurrent_layers):
            counts[f"rec{i}"] = float(cfg.unfold)
    elif cfg.kind == "tdnn":
        n = len(cfg.tdnn_contexts)
        for i in range(n):
            c = 1.0
            for j in range(i + 1, n):
                c *= len(cfg.tdnn_contexts[j])
            counts[f"tdnn{i}"] = c
    return {k: counts.get(k.split(".")[0], 1.0) for k in params}


def param_count(params: dict) -> int:
    return sum(v.numel() for v in params.values())
