"""Port parity: recurrentgemma-9b serving (configs, layers, RG-LRU and
local-attention blocks, backbone, prefill/serve steps, the server).

Every module of ``repro_torch`` against its ``repro`` counterpart on the
same inputs (numpy-seeded) and the same parameters (the JAX pytree
carried across by ``convert.lm_params_from_numpy``), at the smoke size of
recurrentgemma-9b (3 layers = one (rglru, rglru, local) period, d 128,
4 heads MQA of hd 32, window 16, vocab 512), on the CPU: the windowed
attention goes through the kernel's plain version here.

Tolerances:
  * f32 compute: relative max 1e-5 (|d| / max|ref|) — the same f32
    arithmetic; the RG-LRU doubling scan combines in another tree than
    ``lax.associative_scan`` and matmuls sum in another order.
  * bf16 compute (the config's): relative L2 2e-2 against the reference's
    bf16 logits, and no farther from the f32 logits than 1.5x the
    reference's own bf16 logits are (about 2 % L2): bf16 rounds at other
    places in the two frameworks (XLA may keep f32 between fused ops), so
    the two bf16 results differ by about as much as either differs from
    f32.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as JCB  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
from repro.launch import serve as JS  # noqa: E402
from repro.launch.steps import build_prefill_step as jprefill  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.registry import get_model as jmodel  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as TCB  # noqa: E402
from repro_torch.configs.acoustic import LSTM  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.launch.steps import build_prefill_step  # noqa: E402
from repro_torch.models import acoustic as TA  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.registry import get_model as tmodel  # noqa: E402
from torch_perturb import perturb  # noqa: E402

ARCH = "recurrentgemma-9b"
FULL_PARAMS = 10_444_771_328
F32_TOL = 1e-5
BF16_L2 = 2e-2


def _cfgs(compute_dtype="float32"):
    return (jget(ARCH).smoke().replace(compute_dtype=compute_dtype),
            TCB.get_config(ARCH).smoke().replace(compute_dtype=compute_dtype))


@pytest.fixture(scope="module")
def params():
    """Reference smoke parameters (seed 0) and the port's copy of them."""
    jcfg, _ = _cfgs()
    jp = jmodel(jcfg).init(jax.random.PRNGKey(0))
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                      device="cpu")
    return jp, tp


def _block(jp, tp, slot):
    """One period-0 block's parameters: reference nested tree and the
    port's nested views."""
    return (jax.tree.map(lambda a: a[0], jp["periods"][slot]),
            TT.nest(tp, f"periods.{slot}.", 0))


def _x(shape, seed=0):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


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


# ---------------------------------------------------------------------------
# configs and the parameter tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
def test_config_is_the_reference_config(smoke):
    j, t = jget(ARCH), TCB.get_config(ARCH)
    if smoke:
        j, t = j.smoke(), t.smoke()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.cdtype == torch.bfloat16 and t.pdtype == torch.float32
    assert TCB.INPUT_SHAPES == {
        k: TCB.InputShape(**dataclasses.asdict(v))
        for k, v in JCB.INPUT_SHAPES.items()}


def test_unported_archs_and_blocks_raise():
    """Since the xLSTM slice every arch of the reference's pool is ported
    (the name is kept from when xLSTM raised): ``NOT_PORTED`` is empty,
    xlstm-125m is registered, every block kind builds, and an unknown
    arch still raises, naming ROADMAP."""
    assert TCB.list_archs() == [ARCH, "whisper-base", "stablelm-1.6b",
                                "qwen2.5-3b", "minitron-8b", "chameleon-34b",
                                "qwen2-72b", "granite-moe-3b-a800m",
                                "mixtral-8x22b", "xlstm-125m"]
    assert TCB.NOT_PORTED == ()
    assert TCB.get_config("xlstm-125m").block_pattern == (
        "mlstm", "mlstm", "mlstm", "slstm")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TCB.get_config("gpt-5")
    cfg = TCB.get_config(ARCH).smoke()
    for kind in ("moe", "swamoe"):
        assert "moe" in TB.init_block(cfg, TL.Init("meta"), kind)
    assert "w_q" in TB.init_block(cfg, TL.Init("meta"), "mlstm")
    assert "r_zifo" in TB.init_block(cfg, TL.Init("meta"), "slstm")


def test_full_width_parameter_tree_by_shape_only():
    """The port's tree against ``jax.eval_shape`` of the reference's init,
    leaf for leaf, at full width and depth; nothing is allocated."""
    cfg = jget(ARCH)
    want = jax.eval_shape(lambda: jmodel(cfg).init(jax.random.PRNGKey(0)))
    want = {jax.tree_util.keystr(path, simple=True, separator="."):
            tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_leaves_with_path(want)}
    got = tmodel(TCB.get_config(ARCH)).param_shapes()
    assert {k: s for k, (s, _) in got.items()} == want
    assert all(dt == torch.float32 for _, dt in got.values())
    assert tmodel(TCB.get_config(ARCH)).param_count() == FULL_PARAMS
    assert got["periods.slot2.attn.wk"] == ((12, 4096, 256), torch.float32)
    assert [k for k in got if k.startswith("rest.")][:1] == ["rest.rest0.ln1.scale"]


def test_init_params_on_cpu_and_default_device(params, monkeypatch):
    _, tcfg = _cfgs()
    _, tp = params
    a = TT.init_params(tcfg, seed=1, device="cpu")
    assert {k: tuple(v.shape) for k, v in a.items()} == \
        {k: tuple(v.shape) for k, v in tp.items()}
    assert all(v.device.type == "cpu" for v in a.values())
    b = TT.init_params(tcfg, seed=1, device="cpu")
    c = TT.init_params(tcfg, seed=2, device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed.table"], c["embed.table"])
    assert float(a["periods.slot0.w_x"].std()) == pytest.approx(
        1 / np.sqrt(tcfg.d_model), rel=0.1)
    # no card: the default device raises (the acoustic models too)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.init_params(tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TA.init_params(LSTM.smoke())


# ---------------------------------------------------------------------------
# layers and blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rotary_pct", [0.5, 0.25])
def test_partial_rope_matches_reference(rotary_pct):
    """``rotary_pct`` < 1 rotates the leading dims and passes the rest."""
    jx, tx = _x((2, 9, 4, 32), seed=7)
    pos = np.arange(9)
    got = TL.rope(tx, torch.from_numpy(pos), 10_000.0, rotary_pct)
    want = JL.rope(jx, jnp.asarray(pos), 10_000.0, rotary_pct)
    assert _rel(got, want) < F32_TOL
    rot = int(32 * rotary_pct)
    assert torch.equal(got[..., rot:], tx[..., rot:])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_and_norm_match_reference(dtype):
    jcfg, tcfg = _cfgs()
    jx, tx = _x((2, 9, 4, 32), seed=1)
    jx, tx = jx.astype(dtype), tx.to(getattr(torch, dtype))
    pos = np.arange(3, 12)
    got = TL.rope(tx, torch.from_numpy(pos), 10_000.0)
    want = JL.rope(jx, jnp.asarray(pos), 10_000.0)
    tol = F32_TOL if dtype == "float32" else 1e-2
    assert _rel(got, want) < tol
    scale = np.random.default_rng(2).normal(size=32).astype(np.float32)
    got = TL.norm_apply(tcfg, {"scale": torch.from_numpy(scale)}, tx)
    want = JL.norm_apply(jcfg, {"scale": jnp.asarray(scale)}, jx)
    assert got.dtype == tx.dtype and _rel(got, want) < tol


def test_geglu_mlp_matches_reference(params):
    jcfg, tcfg = _cfgs()
    jp, tp = _block(*params, "slot2")
    jx, tx = _x((2, 7, jcfg.d_model), seed=3)
    got = TL.mlp_apply(tcfg, tp["mlp"], tx)
    assert _rel(got, JL.mlp_apply(jcfg, jp["mlp"], jx)) < F32_TOL


def test_causal_conv_and_its_step_match_reference(params):
    jp, tp = _block(*params, "slot0")
    jx, tx = _x((2, 11, 128), seed=4)
    got = TB.causal_conv1d(tx, tp["conv_w"], tp["conv_b"])
    assert _rel(got, JB.causal_conv1d(jx, jp["conv_w"], jp["conv_b"])) \
        < F32_TOL
    jb, tb = _x((2, 3, 128), seed=5)
    out, buf = TB.conv1d_step(tx[:, 0], tb, tp["conv_w"], tp["conv_b"])
    j_out, j_buf = JB.conv1d_step(jx[:, 0], jb, jp["conv_w"], jp["conv_b"])
    assert _rel(out, j_out) < F32_TOL and _rel(buf, j_buf) == 0.0


@pytest.mark.parametrize("T", [1, 48, 1000])
def test_rglru_scan_matches_associative_scan(params, T):
    jp, tp = _block(*params, "slot0")
    jx, tx = _x((2, T, 128), seed=T)
    assert _rel(TB.rglru_scan(tp, tx), JB.rglru_scan(jp, jx)) < F32_TOL


@pytest.mark.parametrize("slot", ["slot0", "slot2"])
def test_blocks_apply_and_decode_match_reference(params, slot):
    """The RG-LRU block (slot0) and the local-attention block (slot2):
    sequence mode at T = 24 (past the window), then 20 decode steps from
    a zero cache, the ring wrapping at step 16."""
    jcfg, tcfg = _cfgs()
    jp, tp = _block(*params, slot)
    kind = jcfg.block_pattern[int(slot[-1])]
    jx, tx = _x((2, 24, jcfg.d_model), seed=6)
    pos = np.arange(24)
    got, aux = TB.block_apply(tcfg, kind, tp, tx, torch.from_numpy(pos))
    want, _ = JB.block_apply(jcfg, kind, jp, jx, jnp.asarray(pos))
    assert aux == 0.0 and _rel(got, want) < F32_TOL
    jc = JB.init_block_cache(jcfg, kind, 2, 32)
    tc = TB.init_block_cache(tcfg, kind, 2, 32)
    assert {k: v.shape for k, v in tc.items()} == \
        {k: torch.Size(v.shape) for k, v in jc.items()}
    for t in range(20):
        jy, jc = JB.block_decode(jcfg, kind, jp, jx[:, t:t + 1], jc,
                                 jnp.int32(t))
        ty, tc = TB.block_decode(tcfg, kind, tp, tx[:, t:t + 1], tc, t)
        assert _rel(ty, jy) < F32_TOL, t
    for k in tc:
        assert _rel(tc[k], jc[k]) < F32_TOL, k


def test_decode_attention_matches_reference():
    (jq, tq), (jk, tk), (jv, tv) = (_x(s, seed=i) for i, s in enumerate(
        [(3, 1, 4, 32), (3, 16, 1, 32), (3, 16, 1, 32)]))
    for valid in (1, 9, 16):
        got = TL.decode_attention(tq, tk, tv, valid)
        assert _rel(got, JL.decode_attention(jq, jk, jv, valid)) < F32_TOL
    per_row = np.array([3, 16, 7])                  # (B,) valid lengths
    got = TL.decode_attention(tq, tk, tv, torch.from_numpy(per_row))
    want = JL.decode_attention(jq, jk, jv, jnp.asarray(per_row))
    assert _rel(got, want) < F32_TOL


# ---------------------------------------------------------------------------
# the slice: prefill, forward, decode, serve
# ---------------------------------------------------------------------------

def test_forward_and_prefill_match_reference_f32(params):
    jcfg, tcfg = _cfgs()
    jp, tp = params
    jb, tb = _tokens(jcfg, 2, 48)
    want, _ = jmodel(jcfg).forward(jp, jb)
    got, aux = tmodel(tcfg).forward(tp, tb)
    assert got.shape == (2, 48, jcfg.vocab_size) and got.dtype == torch.float32
    assert aux == 0.0 and _rel(got, want) < F32_TOL
    got = build_prefill_step(tcfg)(tp, tb)
    want = jprefill(jcfg)(jp, jb)
    assert got.shape == (2, 1, jcfg.vocab_size)
    assert _rel(got, want) < F32_TOL


def test_forward_and_prefill_match_reference_bf16(params):
    jcfg, tcfg = _cfgs("bfloat16")
    jp, tp = params
    jb, tb = _tokens(jcfg, 2, 48, seed=1)
    ref32, _ = jmodel(jcfg.replace(compute_dtype="float32")).forward(jp, jb)
    want, _ = jmodel(jcfg).forward(jp, jb)
    got, _ = tmodel(tcfg).forward(tp, tb)
    assert _l2(got, want) < BF16_L2
    assert _l2(got, ref32) < 1.5 * _l2(want, ref32)
    got = build_prefill_step(tcfg)(tp, tb)
    want = jprefill(jcfg)(jp, jb)
    assert _l2(got, want) < BF16_L2


def _prefill_vs_decode(full, dec, t):
    """Relative max distance of decode's logits at position t from the
    sequence forward's."""
    full, dec = np.asarray(full)[:, t], np.asarray(dec)[:, t]
    return float(np.abs(dec - full).max() / np.abs(full).max())


def test_decode_steps_match_reference_as_the_ring_wraps(params):
    """40 decode steps (the 16-slot local ring wraps twice) against the
    reference's ``decode_step`` step by step, and the reference's window
    quirk kept: its prefill attends window + 1 keys and its ring decode
    window keys, so the two agree up to position window - 1 and part
    from position window on — in the reference and in the port alike."""
    jcfg, tcfg = _cfgs()
    jp, tp = params
    jm, tm = jmodel(jcfg), tmodel(tcfg)
    jb, tb = _tokens(jcfg, 2, 40, seed=2)
    jstep = jax.jit(jm.decode_step)
    jc = jm.init_cache(2, 64)
    tc = tm.init_cache(2, 64, device="cpu")
    assert tc["periods.slot2.k"].shape == (1, 2, 16, 1, 32)
    jdec, tdec = [], []
    for t in range(40):
        jl, jc = jstep(jp, jc, jb["tokens"][:, t:t + 1], jnp.int32(t))
        tl, tc = tm.decode_step(tp, tc, tb["tokens"][:, t:t + 1], t)
        assert _rel(tl, jl) < F32_TOL, t
        jdec.append(np.asarray(jl[:, 0]))
        tdec.append(tl[:, 0].numpy())
    flat = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jc),
                                        device="cpu")
    assert set(flat) == set(tc)
    for k in tc:
        assert _rel(tc[k], flat[k]) < F32_TOL, k
    jfull = jm.forward(jp, jb)[0]
    tfull = tm.forward(tp, tb)[0].numpy()
    jdec, tdec = np.stack(jdec, 1), np.stack(tdec, 1)
    window = jcfg.sliding_window
    for t in (window - 1, window, 39):
        ref = _prefill_vs_decode(jfull, jdec, t)
        port = _prefill_vs_decode(tfull, tdec, t)
        if t < window:
            assert ref < F32_TOL and port < F32_TOL, (t, ref, port)
        else:
            assert ref > 1e-2 and port > 1e-2, (t, ref, port)
            assert abs(port - ref) < 1e-3 * ref, (t, ref, port)


def test_serve_greedy_matches_reference_token_for_token(params):
    jcfg, tcfg = _cfgs()
    jp, tp = params
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, jcfg.vocab_size, size=n).tolist()
               for n in (20, 25, 18)]
    jreqs = [JS.Request(i, p, 8) for i, p in enumerate(prompts)]
    treqs = [TS.Request(i, p, 8) for i, p in enumerate(prompts)]
    jreqs, jstats = JS.serve(jcfg, jmodel(jcfg), jp, jreqs, cache_len=64)
    treqs, tstats = TS.serve(tcfg, tmodel(tcfg), tp, treqs, cache_len=64)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert all(r.done and len(r.generated) == 8 for r in treqs)
    assert tstats["steps"] == jstats["steps"] == 25 + 8 - 1
    assert tstats["tokens_per_s"] > 0 and np.isfinite(tstats["latency_p99_s"])


def test_serve_sampling_and_cli_on_cpu(capsys):
    _, tcfg = _cfgs()
    model = tmodel(tcfg)
    tp = model.init(0, device="cpu")
    reqs = TS.make_requests(tcfg, 3, 5, seed=1)
    rng = np.random.default_rng(1)          # the reference main's draws
    assert [r.prompt for r in reqs] == [
        rng.integers(0, tcfg.vocab_size, size=rng.integers(4, 12)).tolist()
        for _ in range(3)]
    out = [TS.serve(tcfg, model, tp, TS.make_requests(tcfg, 3, 5, seed=1),
                    greedy=False, seed=7)[0] for _ in range(2)]
    toks = [[r.generated for r in o] for o in out]
    assert toks[0] == toks[1]
    assert all(0 <= t < tcfg.vocab_size for g in toks[0] for t in g)
    stats = TS.main(["--smoke", "--device", "cpu", "--requests", "2",
                     "--max-new", "3"])
    assert stats["steps"] > 0
    assert "[serve]" in capsys.readouterr().out


@pytest.mark.parametrize("field,value", [
    ("qkv_bias", True), ("qk_norm", True), ("norm", "layernorm"),
    ("activation", "swiglu"), ("tie_embeddings", True),
    ("learned_positions", True), ("is_encoder_decoder", True)])
def test_unported_options_raise(field, value):
    """The two options the decoder-only backbone still does not run are
    refused by the model, its parameters, its cache and its shapes alike;
    the five the dense archs brought run, and each alone on the
    recurrentgemma-9b smoke config (its vector leaves perturbed) matches
    the reference's forward at f32."""
    jcfg, tcfg = _cfgs()
    cfg = tcfg.replace(**{field: value})
    if field in ("learned_positions", "is_encoder_decoder"):
        for call in (lambda: tmodel(cfg), lambda: TT.param_count(cfg),
                     lambda: TT.init_params(cfg, 0, device="cpu"),
                     lambda: TT.init_cache(cfg, 1, 8, device="cpu")):
            with pytest.raises(NotImplementedError, match=field):
                call()
        return
    jcfg = jcfg.replace(**{field: value})
    jp = perturb(jmodel(jcfg).init(jax.random.PRNGKey(0)), 8)
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                      device="cpu")
    assert set(tp) == set(tmodel(cfg).param_shapes())
    jb, tb = _tokens(jcfg, 2, 24, seed=9)
    want, _ = jmodel(jcfg).forward(jp, jb)
    got, _ = tmodel(cfg).forward(tp, tb)
    assert _rel(got, want) < F32_TOL


def test_serve_cli_long_mode_is_not_ported(capsys):
    """``--long-mode`` runs at smoke size now (the name is kept from
    when it raised): on recurrentgemma-9b it changes nothing (its caches
    are windowed rings already), and on qwen2.5-3b it bounds the global
    caches to the smoke ``long_context_window`` of 64 slots."""
    base = ["--arch", ARCH, "--smoke", "--device", "cpu", "--requests",
            "2", "--max-new", "4"]
    tokens = []
    for extra in (["--long-mode"], []):
        TS.main(base + extra)
        tokens.append([line for line in capsys.readouterr().out.splitlines()
                       if line.startswith("req ")])
    assert tokens[0] == tokens[1] and len(tokens[0]) == 2
    stats = TS.main(base + ["--arch", "qwen2.5-3b", "--long-mode",
                            "--cache-len", "128"])
    assert stats["steps"] > 0
    assert "[serve]" in capsys.readouterr().out
