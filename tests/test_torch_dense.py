"""Port parity: the dense ``attn`` archs (stablelm-1.6b, qwen2.5-3b,
minitron-8b, chameleon-34b, qwen2-72b) and their options — global causal
attention, q/k/v biases, q/k norms, LayerNorm, partial rotary, tied
embeddings, SwiGLU and ReLU — and ``serve``'s ``long_mode``.

Every arch at its ``.smoke()`` size (2 layers, d 128, 4 heads of hd 32,
vocab 512, long_context_window 64) on the CPU, with the reference's
parameters carried across by ``convert.lm_params_from_numpy``.  The
reference draws its biases as zeros and its norms' scales as ones, so
the tests first perturb every vector leaf (biases, q/k norms, norm
scales and biases) with numpy-seeded noise: a bias that is not added, or
a norm that is not applied, then shows.

Tolerances:
  * f32 compute: relative max 1e-5 (|d| / max|ref|) — the same f32
    arithmetic, matmuls summed in another order.
  * bf16 compute (the configs'): relative L2 2e-2 against the reference's
    bf16 logits, and no farther from the reference's f32 logits than 1.5x
    the reference's own bf16 logits are (as ``test_torch_lm.py``): bf16
    rounds at other places in the two frameworks, so the two bf16
    results differ by about as much as either differs from f32.
  * q/k norm alone at bf16: within one bf16 ulp (2^-7 relative) of the
    reference's; the order of its casts is the reference's.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget  # noqa: E402
from repro.launch import serve as JS  # noqa: E402
from repro.launch.steps import build_prefill_step as jprefill  # noqa: E402
from repro.launch.steps import build_serve_step as jserve_step  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.registry import get_model as jmodel  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as TCB  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.launch.steps import build_prefill_step  # noqa: E402
from repro_torch.launch.steps import build_serve_step  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.registry import get_model as tmodel  # noqa: E402
from torch_perturb import perturb  # noqa: E402

# the parameter counts of the reference's ``eval_shape`` at full size
FULL_PARAMS = {
    "stablelm-1.6b": 1_644_367_872,
    "qwen2.5-3b": 3_085_938_688,
    "minitron-8b": 7_734_562_816,
    "chameleon-34b": 34_293_436_416,
    "qwen2-72b": 72_706_203_648,
}
ARCHS = sorted(FULL_PARAMS)
F32_TOL = 1e-5
BF16_L2 = 2e-2
BF16_FACTOR = 1.5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """PyTorch on one thread: the smoke shapes gain nothing from more, and
    beside the suite's parallel workers more threads oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, compute_dtype="float32", **kw):
    return (jget(arch).smoke().replace(compute_dtype=compute_dtype, **kw),
            TCB.get_config(arch).smoke().replace(compute_dtype=compute_dtype,
                                                 **kw))


_PARAMS: dict = {}


def params_for(jcfg, key=None):
    """Reference smoke parameters (seed 0, perturbed) and the port's copy,
    cached per config."""
    key = key or jcfg
    if key not in _PARAMS:
        jp = perturb(jmodel(jcfg).init(jax.random.PRNGKey(0)), 1)
        tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                          device="cpu")
        _PARAMS[key] = (jp, tp)
    return _PARAMS[key]


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _l2(a, b):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _tokens(cfg, B, T, seed=0):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                size=(B, T))
    return {"tokens": jnp.asarray(toks, jnp.int32)}, \
        {"tokens": torch.from_numpy(toks)}


def _flat_shapes(tree) -> dict:
    return {jax.tree_util.keystr(p, simple=True, separator="."):
            (tuple(leaf.shape), str(leaf.dtype))
            for p, leaf in jax.tree_util.tree_leaves_with_path(tree)}


# ---------------------------------------------------------------------------
# configs, the parameter tree, input specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_the_reference_config(arch, smoke):
    j, t = jget(arch), TCB.get_config(arch)
    if smoke:
        j, t = j.smoke(), t.smoke()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.block_pattern == ("attn",)
    assert TCB.get_config(arch.replace("-", "_").replace(".", "_")) \
        is TCB.get_config(arch)


def test_stablelm_smoke_rotates_eight_dims():
    cfg = TCB.get_config("stablelm-1.6b").smoke()
    assert (cfg.resolved_head_dim, cfg.rotary_pct) == (32, 0.25)
    x = torch.randn(1, 3, 4, 32)
    out = TL.rope(x, torch.arange(3), cfg.rope_theta, cfg.rotary_pct)
    assert torch.equal(out[..., 8:], x[..., 8:])
    assert not torch.equal(out[:, 1:, :, :8], x[:, 1:, :, :8])


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_parameter_tree_by_shape_only(arch):
    """The port's tree against ``jax.eval_shape`` of the reference's
    init, leaf for leaf, and its parameter count, on the meta device."""
    want = jax.eval_shape(
        lambda: jmodel(jget(arch)).init(jax.random.PRNGKey(0)))
    want = {k: s for k, (s, _) in _flat_shapes(want).items()}
    model = tmodel(TCB.get_config(arch))
    got = model.param_shapes()
    assert {k: s for k, (s, _) in got.items()} == want
    assert all(dt == torch.float32 for _, dt in got.values())
    assert model.param_count() == FULL_PARAMS[arch]
    assert ("embed.lm_head" in got) == (not jget(arch).tie_embeddings)


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_tree_carries_across(arch):
    """``lm_params_from_numpy`` of a reference smoke tree gives the
    port's keys, shapes and dtypes: no ``embed.lm_head`` when tied, the
    bias and q/k-norm leaves when the config has them."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = params_for(jcfg)
    mine = TT.init_params(tcfg, 0, device="cpu")
    assert {k: (v.shape, v.dtype) for k, v in tp.items()} == \
        {k: (v.shape, v.dtype) for k, v in mine.items()}
    assert ("periods.slot0.attn.bq" in tp) == jcfg.qkv_bias
    assert ("periods.slot0.attn.q_norm" in tp) == jcfg.qk_norm
    assert ("periods.slot0.ln1.bias" in tp) == (jcfg.norm == "layernorm")
    assert ("periods.slot0.mlp.w_gate" in tp) == (jcfg.activation
                                                  == "swiglu")
    for k, v in tp.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(_leaf(jp, k)))


def _leaf(tree, path):
    for part in path.split("."):
        tree = tree[part]
    return tree


@pytest.mark.parametrize("shape", ["long_500k", "decode_32k", "prefill_32k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch, shape):
    """At full size, by shape: long_500k's bounded cache (8192 slots) and
    decode_32k's full one, as the reference's ``input_specs``."""
    want = jmodel(jget(arch)).input_specs(shape)
    got = tmodel(TCB.get_config(arch)).input_specs(shape)
    assert got["tokens"][0] == tuple(want["tokens"].shape)
    if shape == "prefill_32k":
        return
    cache = {k: (s, str(dt).replace("torch.", ""))
             for k, (s, dt) in got["cache"].items()}
    assert cache == _flat_shapes(want["cache"])
    slots = {s[2] for s, _ in cache.values()}
    assert slots == ({8192} if shape == "long_500k" else {32768})


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qkv_project_with_biases_and_qk_norm_matches_reference(dtype):
    """q/k/v biases and q/k norms on qwen2.5-3b's smoke projections (GQA
    4/2), at f32 and bf16; the q/k norm alone within one bf16 ulp."""
    jcfg, tcfg = _cfgs("qwen2.5-3b", dtype, qk_norm=True)
    jp, tp = params_for(jcfg)
    ja = jax.tree.map(lambda a: a[0], jp["periods"]["slot0"]["attn"])
    ta = TT.nest(tp, "periods.slot0.attn.", 0)
    x = np.random.default_rng(4).normal(size=(2, 9, jcfg.d_model))
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(x.astype(np.float32)).to(getattr(torch, dtype))
    pos = np.arange(5, 14)
    got = TL.qkv_project(tcfg, ta, tx, torch.from_numpy(pos))
    want = JL.qkv_project(jcfg, ja, jx, jnp.asarray(pos))
    tol = F32_TOL if dtype == "float32" else 2.0 ** -7
    for g, w in zip(got, want):
        assert g.dtype == tx.dtype and g.shape == w.shape
        assert _rel(g, w) < tol
    q = torch.from_numpy(np.array(want[0], np.float32)).to(tx.dtype)
    got = TL._rms(q)
    want = JL._rms(jnp.asarray(np.asarray(want[0]), dtype))
    assert got.dtype == tx.dtype and _rel(got, want) <= 2.0 ** -7


def test_tied_head_is_the_table_transposed():
    jcfg, tcfg = _cfgs("qwen2.5-3b")
    jp, tp = params_for(jcfg)
    head = TT.head_matrix(tcfg, tp)
    assert head.data_ptr() == tp["embed.table"].data_ptr()
    assert torch.equal(head, tp["embed.table"].T)
    x = np.random.default_rng(5).normal(size=(2, 3, jcfg.d_model))
    got = TL.lm_head_apply(tcfg, TT.nest(tp, "embed."),
                           torch.from_numpy(x.astype(np.float32)))
    want = JL.lm_head_apply(jcfg, jp["embed"], jnp.asarray(x, jnp.float32))
    assert _rel(got, want) < F32_TOL


# ---------------------------------------------------------------------------
# forward, prefill, decode, long mode, serve — each arch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_match_reference_f32(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = params_for(jcfg)
    jb, tb = _tokens(jcfg, 2, 32)
    want, _ = jmodel(jcfg).forward(jp, jb)
    got, aux = tmodel(tcfg).forward(tp, tb)
    assert got.shape == (2, 32, jcfg.vocab_size) and got.dtype == torch.float32
    assert aux == 0.0 and _rel(got, want) < F32_TOL
    got = build_prefill_step(tcfg)(tp, tb)
    assert got.shape == (2, 1, jcfg.vocab_size)
    assert _rel(got, jprefill(jcfg)(jp, jb)) < F32_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_match_reference_bf16(arch):
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    jp, tp = params_for(jcfg.replace(compute_dtype="float32"))
    jb, tb = _tokens(jcfg, 2, 32, seed=1)
    ref32, _ = jmodel(jcfg.replace(compute_dtype="float32")).forward(jp, jb)
    want, _ = jmodel(jcfg).forward(jp, jb)
    got, _ = tmodel(tcfg).forward(tp, tb)
    assert _l2(got, want) < BF16_L2
    assert _l2(got, ref32) < BF16_FACTOR * _l2(want, ref32)
    got = build_prefill_step(tcfg)(tp, tb)
    assert _l2(got, jprefill(jcfg)(jp, jb)) < BF16_L2


def _decode(jcfg, tcfg, jp, tp, toks, cache_len, long_mode):
    """The reference's and the port's decode over ``toks`` (B, T) from
    zero caches: per-step logits of both, and both final caches."""
    jm, tm = jmodel(jcfg), tmodel(tcfg)
    jstep = jax.jit(jserve_step(jcfg, long_mode=long_mode))
    tstep = build_serve_step(tcfg, long_mode=long_mode)
    jc = jm.init_cache(toks.shape[0], cache_len, long_mode=long_mode)
    tc = tm.init_cache(toks.shape[0], cache_len, long_mode=long_mode,
                       device="cpu")
    jdec, tdec = [], []
    for t in range(toks.shape[1]):
        tok = toks[:, t:t + 1]
        jl, jc = jstep(jp, jc, jnp.asarray(tok, jnp.int32), jnp.int32(t))
        tl, tc = tstep(tp, tc, torch.from_numpy(tok), t)
        jdec.append(np.asarray(jl[:, 0]))
        tdec.append(tl[:, 0].numpy())
    return np.stack(jdec, 1), np.stack(tdec, 1), jc, tc


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference_and_forward(arch):
    """24 decode steps into a 32-slot cache against the reference's
    ``decode_step`` step by step, the final caches, and the port's own
    sequence forward (global attention: decode == forward)."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = params_for(jcfg)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 24))
    jdec, tdec, jc, tc = _decode(jcfg, tcfg, jp, tp, toks, 32, False)
    assert tc["periods.slot0.k"].shape == (2, 2, 32, jcfg.num_kv_heads,
                                           jcfg.resolved_head_dim)
    assert _rel(tdec, jdec) < F32_TOL
    flat = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jc),
                                        device="cpu")
    assert set(flat) == set(tc)
    for k in tc:
        assert _rel(tc[k], flat[k]) < F32_TOL, k
    full, _ = tmodel(tcfg).forward(tp, {"tokens": torch.from_numpy(toks)})
    assert _rel(tdec, full) < F32_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_long_mode_decode_past_the_ring_matches_reference(arch):
    """``long_mode``: a 128-token cache bounded to a ring of 64 slots
    (the smoke ``long_context_window``), 80 steps — the ring wraps at 64
    — against the reference's long-mode decode, logits and caches."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = params_for(jcfg)
    assert tcfg.long_context_window == 64
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 80))
    jdec, tdec, jc, tc = _decode(jcfg, tcfg, jp, tp, toks, 128, True)
    assert tc["periods.slot0.k"].shape[2] == 64
    assert _rel(tdec, jdec) < F32_TOL
    flat = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jc),
                                        device="cpu")
    for k in tc:
        assert _rel(tc[k], flat[k]) < F32_TOL, k
    # past the ring the decode is no longer the sequence forward
    full, _ = tmodel(tcfg).forward(tp, {"tokens": torch.from_numpy(toks)})
    assert _rel(tdec[:, :64], full[:, :64]) < F32_TOL
    assert _rel(tdec[:, 64:], full[:, 64:]) > 1e-3


def test_full_cache_overwrites_its_last_slot_past_cache_len():
    """Without ``long_mode`` a global cache is written at ``min(pos,
    slots - 1)``: past ``cache_len`` the last slot is overwritten, as in
    the reference."""
    jcfg, tcfg = _cfgs("qwen2.5-3b")
    jp, tp = params_for(jcfg)
    toks = np.random.default_rng(6).integers(0, jcfg.vocab_size, (1, 12))
    jdec, tdec, jc, tc = _decode(jcfg, tcfg, jp, tp, toks, 8, False)
    assert _rel(tdec, jdec) < F32_TOL
    flat = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jc),
                                        device="cpu")
    for k in tc:
        assert _rel(tc[k], flat[k]) < F32_TOL, k


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_long_mode_greedy_matches_reference(arch):
    """``serve`` with ``long_mode`` and greedy decoding, prompts long
    enough that the 64-slot ring wraps: the reference's tokens."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = params_for(jcfg)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, jcfg.vocab_size, size=n).tolist()
               for n in (60, 52)]
    jreqs = [JS.Request(i, p, 10) for i, p in enumerate(prompts)]
    treqs = [TS.Request(i, p, 10) for i, p in enumerate(prompts)]
    jreqs, jstats = JS.serve(jcfg, jmodel(jcfg), jp, jreqs, cache_len=128,
                             long_mode=True)
    treqs, tstats = TS.serve(tcfg, tmodel(tcfg), tp, treqs, cache_len=128,
                             long_mode=True)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert all(r.done and len(r.generated) == 10 for r in treqs)
    assert tstats["steps"] == jstats["steps"] == 60 + 10 - 1


def test_serve_long_mode_sampling_repeats_for_its_seed():
    """Sampled decoding through the 64-slot ring: every request finishes
    with tokens of the vocabulary, and a draw repeats for its seed."""
    _, tcfg = _cfgs("qwen2.5-3b")
    model = tmodel(tcfg)
    tp = model.init(0, device="cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, tcfg.vocab_size, size=n).tolist()
               for n in (70, 9)]
    runs = [TS.serve(tcfg, model, tp,
                     [TS.Request(i, p, 6) for i, p in enumerate(prompts)],
                     cache_len=128, greedy=False, long_mode=True,
                     seed=3)[0] for _ in range(2)]
    assert [r.generated for r in runs[0]] == [r.generated for r in runs[1]]
    assert all(r.done and len(r.generated) == 6
               and all(0 <= t < tcfg.vocab_size for t in r.generated)
               for r in runs[0])


# ---------------------------------------------------------------------------
# each option alone on one base config
# ---------------------------------------------------------------------------

# a plain dense base: RMSNorm, GELU (ungated), full rotary, no biases, no
# q/k norm, untied; each case turns one option on
BASE = dict(qkv_bias=False, qk_norm=False, norm="rmsnorm", rotary_pct=1.0,
            tie_embeddings=False, activation="gelu", rope_theta=10_000.0)
OPTIONS = {
    "qkv_bias": dict(qkv_bias=True),
    "qk_norm": dict(qk_norm=True),
    "layernorm": dict(norm="layernorm"),
    "rotary_pct": dict(rotary_pct=0.25),
    "tied": dict(tie_embeddings=True),
    "swiglu": dict(activation="swiglu"),
    "relu": dict(activation="relu"),
}


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_each_option_alone_matches_reference(option):
    """Forward at f32 and bf16 and 6 decode steps at f32, on qwen2.5-3b's
    smoke geometry with only ``option`` on."""
    kw = dict(BASE, **OPTIONS[option])
    jcfg, tcfg = _cfgs("qwen2.5-3b", **kw)
    jp, tp = params_for(jcfg)
    jb, tb = _tokens(jcfg, 2, 16, seed=7)
    want, _ = jmodel(jcfg).forward(jp, jb)
    got, _ = tmodel(tcfg).forward(tp, tb)
    assert _rel(got, want) < F32_TOL
    j16, t16 = (c.replace(compute_dtype="bfloat16") for c in (jcfg, tcfg))
    want16, _ = jmodel(j16).forward(jp, jb)
    got16, _ = tmodel(t16).forward(tp, tb)
    assert _l2(got16, want16) < BF16_L2
    assert _l2(got16, want) < BF16_FACTOR * _l2(want16, want)
    toks = np.asarray(jb["tokens"])[:, :6]
    jdec, tdec, _, _ = _decode(jcfg, tcfg, jp, tp, toks, 8, False)
    assert _rel(tdec, jdec) < F32_TOL
    assert math.isfinite(float(got.abs().max()))
