"""Rank code of ``tests/test_torch_serve_mesh.py``: the port's prefill and
decode steps on a mesh of gloo CPU ranks (``torch_mesh_worker.start`` as
``"torch_serve_mesh_worker:serve"``), and the one-process results the
test holds them against (``one_process``).

Like ``torch_mesh_worker`` this module imports ``torch`` and
``repro_torch`` only, never JAX.  Every case runs at f32 compute on a
smoke config in its arch's own storage regime, its norms' scales and
biases and its q/k/v biases moved off their initial values, so that a
leaf left out shows.
"""
from __future__ import annotations

import numpy as np
import torch

# (arch, storage regime, config overrides, prefill T, cache slots, decode
# steps, long mode).  Each cache is long enough that every k/v or C share
# holds more numbers than any per-token exchange of a step (the gathered
# q, the logits), and the steps run past a ring's length (a wrap) and
# past the first rank's slots (a write by another rank): qwen's 64 slots
# over 40 steps, its long-mode ring of 64 over 70; recurrentgemma's local
# ring at a window of 64 over 70 steps, its prefill past the window
SERVE_CASES = {
    "qwen": dict(arch="qwen2.5-3b", sharding="2d", T=16, slots=64,
                 steps=40),
    "qwen_long": dict(arch="qwen2.5-3b", sharding="2d", T=16, slots=64,
                      steps=70, long_mode=True),
    # whole attention units (a replicated config) over split slots
    "qwen_repl": dict(arch="qwen2.5-3b", sharding="replicated", T=16,
                      slots=64, steps=40),
    "rg": dict(arch="recurrentgemma-9b", sharding="2d", T=80, slots=128,
               steps=70, over=dict(sliding_window=64)),
    "xlstm": dict(arch="xlstm-125m", sharding="1d", T=16, slots=16,
                  steps=8),
    # mLSTM and sLSTM units whole (2 heads) over state split by channels
    "xlstm_h2": dict(arch="xlstm-125m", sharding="1d", T=16, slots=16,
                     steps=8, over=dict(num_heads=2)),
    "granite": dict(arch="granite-moe-3b-a800m", sharding="2d", T=16,
                    slots=64, steps=40),
    "whisper": dict(arch="whisper-base", sharding="1d", T=16, slots=64,
                    steps=40),
}
BATCH = 4
PERTURBED = ("bq", "bk", "bv", "q_norm", "k_norm", "scale", "bias")
ENC_SEED = 5


def serve_cfg(name: str):
    from repro_torch.configs.base import get_config
    case = SERVE_CASES[name]
    return get_config(case["arch"]).smoke().replace(
        compute_dtype="float32", param_sharding=case["sharding"],
        **case.get("over", {}))


def case_inputs(name: str):
    """(cfg, model, whole parameters, prefill batch, decode tokens (steps,
    B, 1)), the same on every rank and in the test process."""
    from repro_torch.models.registry import get_model
    case = SERVE_CASES[name]
    cfg = serve_cfg(name)
    model = get_model(cfg)
    rng = np.random.default_rng(17)
    params = {k: p + 0.1 * torch.from_numpy(
                  rng.normal(size=p.shape).astype(np.float32))
              if k.split(".")[-1] in PERTURBED else p
              for k, p in model.init(0, device="cpu").items()}
    rng = np.random.default_rng(23)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(BATCH, case["T"])))}
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(case["steps"], BATCH, 1)))
    if cfg.is_encoder_decoder:
        batch["encoder_input"] = torch.from_numpy(
            np.random.default_rng(ENC_SEED).normal(
                size=(BATCH, cfg.encoder_frames, cfg.d_model))
            .astype(np.float32))
    return cfg, model, params, batch, tokens


def _decode(name: str, model, params, cache, tokens, step) -> np.ndarray:
    """Every step's logits (steps, B, V), the cache filled token by
    token from position 0."""
    return np.stack([step(params, cache, tokens[t], t)[0][:, 0].numpy()
                     for t in range(tokens.shape[0])])


def one_process(name: str) -> dict:
    """One process's prefill logits, decode logits and final cache."""
    from repro_torch.launch.steps import build_prefill_step, build_serve_step
    from repro_torch.models import encdec
    case = SERVE_CASES[name]
    cfg, model, params, batch, tokens = case_inputs(name)
    long_mode = case.get("long_mode", False)
    out = {"prefill": build_prefill_step(cfg)(params, batch).numpy()}
    cache = model.init_cache(BATCH, case["slots"], long_mode=long_mode,
                             device="cpu")
    if cfg.is_encoder_decoder:
        with torch.no_grad():
            encdec.prefill_cache(cfg, params, cache, batch["encoder_input"])
    out["decode"] = _decode(name, model, params, cache, tokens,
                            build_serve_step(cfg, long_mode=long_mode))
    out.update({"cache." + k: v.numpy() for k, v in cache.items()})
    return out


class _Collectives:
    """Within the block, the largest collective (bytes of its whole
    tensor, and its kind and shape) launched outside a parameter gather
    (``fsdp.gather_for_compute``) since the last ``take``."""

    def __enter__(self):
        from repro_torch.launch import fsdp
        self.log, self.gather = fsdp.log_collective, fsdp.gather_for_compute
        self.inside, self.top = 0, (0, "")

        def gather(*a, **kw):
            self.inside += 1
            try:
                return self.gather(*a, **kw)
            finally:
                self.inside -= 1

        def log(kind, gid, whole):
            self.log(kind, gid, whole)
            size = whole.numel() * whole.element_size()
            if not self.inside and size > self.top[0]:
                self.top = (size, f"{kind} {tuple(whole.shape)}")

        fsdp.log_collective, fsdp.gather_for_compute = log, gather
        return self

    def take(self):
        top, self.top = self.top, (0, "")
        return top

    def __exit__(self, *exc):
        from repro_torch.launch import fsdp
        fsdp.log_collective, fsdp.gather_for_compute = self.log, self.gather


def serve(*, tmp: str, mesh: str, cases: list) -> dict:
    """On a ``mesh`` ("DxM") of this run's ranks, each case's prefill
    logits of this rank's rows ("<case>/prefill"), every decode step's
    ("<case>/decode", the cache filled token by token), this rank's
    cache shares after the last step ("<case>/cache.<path>"), and the
    largest collective of a decode step outside the parameter gathers
    ("<case>/coll_bytes", "<case>/coll")."""
    from repro_torch.launch import fsdp
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.sharding import param_shardings
    from repro_torch.launch.steps import build_prefill_step, build_serve_step
    from repro_torch.models import encdec
    d, m = (int(v) for v in mesh.split("x"))
    mesh = make_debug_mesh(d, m, device="cpu")
    coord = dict(zip(mesh.axis_names, mesh.device_mesh.get_coordinate()))
    out = {"data_index": np.asarray(mesh.data_index),
           "model_index": np.asarray(coord["model"])}
    for name in cases:
        case = SERVE_CASES[name]
        long_mode = case.get("long_mode", False)
        cfg, model, params, batch, tokens = case_inputs(name)
        ss = param_shardings(cfg, mesh, params)
        mine = {k: ss[k].place(v) for k, v in params.items()}
        out[f"{name}/prefill"] = build_prefill_step(cfg, mesh=mesh)(
            mine, batch).numpy()
        cache = model.init_cache(BATCH, case["slots"], long_mode=long_mode,
                                 mesh=mesh)
        if cfg.is_encoder_decoder:
            encdec.prefill_cache(cfg, mine, cache, batch["encoder_input"],
                                 mesh=mesh)
        step = build_serve_step(cfg, long_mode=long_mode, mesh=mesh)
        logits, tops = [], []
        with _Collectives() as watch:
            for t in range(tokens.shape[0]):
                logits.append(step(mine, cache, tokens[t], t)[0][:, 0]
                              .numpy())
                tops.append(watch.take())
        out[f"{name}/decode"] = np.stack(logits)
        size, what = max(tops)
        out[f"{name}/coll_bytes"] = np.asarray(size)
        out[f"{name}/coll"] = np.asarray(what)
        out.update({f"{name}/cache.{k}": v.numpy() for k, v in cache.items()})
    return out
