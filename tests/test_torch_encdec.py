"""Port parity: whisper-base's layers and encoder-decoder backbone.

Every module of ``repro_torch`` against its ``repro`` counterpart on the
same inputs (numpy-seeded) and the same parameters (the JAX pytree
carried across by ``convert.lm_params_from_numpy``), at the smoke size of
whisper-base (2 encoder + 2 decoder layers, d 128, 4 heads of hd 32,
d_ff 256, vocab 512, 16 frames), on the CPU.

Tolerances:
  * f32 compute: relative max 1e-5 (|d| / max|ref|) — the same f32
    arithmetic, matmuls and softmax sums in another order.
  * bf16 compute (the config's): relative L2 2e-2 against the reference's
    bf16 output, and no farther from the f32 output than 1.5x the
    reference's own bf16 output is (the rule of ``test_torch_lm.py``):
    bf16 rounds at other places in the two frameworks.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget  # noqa: E402
from repro.models import encdec as JE  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.registry import get_model as jmodel  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as TCB  # noqa: E402
from repro_torch.models import encdec as TE  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.registry import get_model as tmodel  # noqa: E402
from repro_torch.models.registry import share_counts  # noqa: E402

ARCH = "whisper-base"
FULL_PARAMS = 130_737_152
FULL_LEAVES = 163
F32_TOL = 1e-5
BF16_L2 = 2e-2
BF16_FACTOR = 1.5
B, T = 2, 12


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


def _x(shape, seed=0, scale=1.0):
    x = (np.random.default_rng(seed).normal(size=shape) * scale
         ).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _l2(a, b):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, T))
    enc = rng.normal(size=(B, cfg.encoder_frames, cfg.d_model)
                     ).astype(np.float32)
    return ({"tokens": jnp.asarray(toks, jnp.int32),
             "encoder_input": jnp.asarray(enc)},
            {"tokens": torch.from_numpy(toks),
             "encoder_input": torch.from_numpy(enc)})


# ---------------------------------------------------------------------------
# config, parameter tree, share counts, input specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
def test_config_is_the_reference_config(smoke):
    j, t = jget(ARCH), TCB.get_config(ARCH)
    if smoke:
        j, t = j.smoke(), t.smoke()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def _ref_paths(tree):
    return {jax.tree_util.keystr(path, simple=True, separator="."): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def test_full_width_parameter_tree_by_shape_only():
    """The port's tree against ``jax.eval_shape`` of the reference's init,
    leaf for leaf, at full width and depth; nothing is allocated."""
    cfg = jget(ARCH)
    want = {k: tuple(v.shape) for k, v in _ref_paths(jax.eval_shape(
        lambda: jmodel(cfg).init(jax.random.PRNGKey(0)))).items()}
    model = tmodel(TCB.get_config(ARCH))
    got = model.param_shapes()
    assert {k: s for k, (s, _) in got.items()} == want
    assert len(got) == FULL_LEAVES
    assert model.param_count() == FULL_PARAMS == jmodel(cfg).param_count()
    assert {dt for _, dt in got.values()} == {torch.float32}


def test_convert_carries_the_reference_tree(params):
    """``convert.lm_params_from_numpy`` carries the reference's enc-dec
    tree across leaf for leaf: the port's own keys, shapes and dtypes,
    and the reference's values bitwise."""
    jp, tp = params
    _, tcfg = _cfgs()
    shapes = TE.param_shapes(tcfg)
    assert set(tp) == set(shapes)
    assert {k: (tuple(v.shape), v.dtype) for k, v in tp.items()} == shapes
    for k, v in _ref_paths(jp).items():
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(v))


@pytest.mark.parametrize("smoke", [False, True])
def test_share_counts_are_the_reference_counts(smoke):
    jcfg, tcfg = jget(ARCH), TCB.get_config(ARCH)
    if smoke:
        jcfg, tcfg = jcfg.smoke(), tcfg.smoke()
    jm = jmodel(jcfg)
    want = {k: float(v) for k, v in _ref_paths(
        jm.share_counts(jm.param_shapes())).items()}
    tm = tmodel(tcfg)
    got = tm.share_counts(tm.param_shapes())
    assert got == want
    assert got["encoder.layer0.attn.wq"] == tcfg.encoder_frames / 1024.0
    assert got["decoder.layer0.self_attn.wq"] == 1.0


@pytest.mark.parametrize("field,value,count", [
    ("tie_embeddings", True, {"embed.table": 2.0, "embed.lm_head": 1.0}),
    ("num_experts", 4, {"periods.slot0.moe.w_in": 0.5,
                        "periods.slot0.attn.wq": 1.0}),
])
def test_share_count_rules_the_archs_to_come_use(field, value, count):
    """The tied-table and MoE-expert rules, on paths of the reference's
    shape, on a config that is neither tied nor MoE until ``field`` makes
    it so (the MoE archs' own trees: ``tests/test_torch_moe_train.py``)."""
    cfg = TCB.get_config("recurrentgemma-9b").replace(
        **{field: value, "num_experts_per_tok": 2})
    assert share_counts(cfg, list(count)) == count


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k",
                                        "decode_32k"])
def test_input_specs_are_the_reference_specs(shape_name):
    cfg = jget(ARCH)
    want = jmodel(cfg).input_specs(shape_name)
    got = tmodel(TCB.get_config(ARCH)).input_specs(shape_name)
    if "cache" in want:
        wc = {k: (tuple(v.shape), str(v.dtype))
              for k, v in _ref_paths(want.pop("cache")).items()}
        gc = {k: (s, str(d)[6:]) for k, (s, d) in got.pop("cache").items()}
        assert gc == wc
    assert {k: (tuple(s), str(d)[6:]) for k, (s, d) in got.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}


def test_encdec_refuses_options_it_does_not_run():
    _, tcfg = _cfgs()
    for field, value in (("qkv_bias", True), ("qk_norm", True),
                         ("tie_embeddings", True),
                         ("block_pattern", ("attn", "moe"))):
        cfg = tcfg.replace(**{field: value})
        for call in (lambda: tmodel(cfg), lambda: TE.param_count(cfg),
                     lambda: TE.init_cache(cfg, 1, 8, device="cpu")):
            with pytest.raises(NotImplementedError, match=field):
                call()
    # the decoder-only backbone still refuses the enc-dec options; it
    # runs whisper's LayerNorm and GELU (the dense archs' options)
    plain = dict(is_encoder_decoder=False, sliding_window=16,
                 block_pattern=("local",), learned_positions=False)
    TT.check_ported(tcfg.replace(**plain))
    for field in ("learned_positions", "is_encoder_decoder"):
        cfg = tcfg.replace(**dict(plain, **{field: getattr(tcfg, field)}))
        with pytest.raises(NotImplementedError, match=field):
            TT.check_ported(cfg)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("norm", ["layernorm", "rmsnorm"])
def test_norm_matches(norm):
    jcfg, tcfg = _cfgs()
    jcfg, tcfg = jcfg.replace(norm=norm), tcfg.replace(norm=norm)
    jx, tx = _x((2, 5, 128), seed=1, scale=3.0)
    js, ts = _x((128,), seed=2)
    jb, tb = _x((128,), seed=3)
    jp = {"scale": js, "bias": jb} if norm == "layernorm" else {"scale": js}
    tp = {"scale": ts, "bias": tb} if norm == "layernorm" else {"scale": ts}
    tinit = TL.init_norm(tcfg, TL.Init("cpu"), 128)
    assert sorted(tinit) == sorted(JL.init_norm(jcfg, 128))
    got = TL.norm_apply(tcfg, tp, tx + 0.5)
    want = JL.norm_apply(jcfg, jp, jx + 0.5)
    assert _rel(got, want) <= F32_TOL


@pytest.mark.parametrize("activation", ["gelu", "relu", "geglu", "swiglu"])
def test_mlp_matches(activation):
    jcfg, tcfg = _cfgs()
    jcfg = jcfg.replace(activation=activation)
    tcfg = tcfg.replace(activation=activation)
    jp = JL.init_mlp(jcfg, jax.random.PRNGKey(1))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    assert sorted(tp) == sorted(TL.init_mlp(tcfg, TL.Init("meta")))
    jx, tx = _x((2, 7, 128), seed=4)
    assert _rel(TL.mlp_apply(tcfg, tp, tx), JL.mlp_apply(jcfg, jp, jx)) \
        <= F32_TOL


def test_gelu_is_the_tanh_approximation():
    jx, tx = _x((4096,), seed=5, scale=4.0)
    got = TL._act("gelu", tx)
    assert _rel(got, jax.nn.gelu(jx)) <= F32_TOL
    # the exact GELU is another function: it would fail the parity tests
    exact = torch.nn.functional.gelu(tx)
    assert float((exact - got).abs().max()) > 1e-4


@pytest.mark.parametrize("T,S,K,q_chunk,kv_chunk,q_offset", [
    (12, 12, 4, 512, 1024, 0),      # one tile
    (64, 64, 2, 16, 32, 0),         # T > q_chunk, GQA, several kv tiles
    (32, 96, 1, 8, 32, 64),         # a prefix of 64 keys: q_offset 64, MQA
    (48, 80, 4, 16, 16, 32),        # q_offset, kv tiles past the queries
])
def test_causal_attention_matches(T, S, K, q_chunk, kv_chunk, q_offset):
    H, hd = 4, 32
    jq, tq = _x((2, T, H, hd), seed=6)
    jk, tk = _x((2, S, K, hd), seed=7)
    jv, tv = _x((2, S, K, hd), seed=8)
    kw = dict(q_chunk=q_chunk, kv_chunk=kv_chunk, q_offset=q_offset)
    got = TL.causal_attention(tq, tk, tv, **kw)
    want = JL.causal_attention(jq, jk, jv, **kw)
    assert got.shape == (2, T, H, hd)
    assert _rel(got, want) <= F32_TOL


@pytest.mark.parametrize("T,S,K", [(5, 16, 4), (1, 16, 2), (12, 40, 1)])
def test_cross_attention_matches(T, S, K):
    H, hd = 4, 32
    jq, tq = _x((2, T, H, hd), seed=9)
    jk, tk = _x((2, S, K, hd), seed=10)
    jv, tv = _x((2, S, K, hd), seed=11)
    got = TL.cross_attention(tq, tk, tv)
    assert _rel(got, JL.cross_attention(jq, jk, jv)) <= F32_TOL


def test_qkv_project_without_rope(params):
    jp, tp = params
    jcfg, tcfg = _cfgs()
    jx, tx = _x((2, 6, 128), seed=12)
    jattn = jp["decoder"]["layer0"]["self_attn"]
    tattn = TT.nest(tp, "decoder.layer0.self_attn.")
    want = JL.qkv_project(jcfg, jattn, jx, jnp.arange(6), apply_rope=False)
    got = TL.qkv_project(tcfg, tattn, tx, None, apply_rope=False)
    for g, w in zip(got, want):
        assert _rel(g, w) <= F32_TOL


# ---------------------------------------------------------------------------
# the backbone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("F_,d", [(16, 128), (3, 2), (1500, 512)])
def test_sinusoid_matches(F_, d):
    """At 16 frames within 1e-5.  The frequencies come from f32 ``exp``,
    whose last bit differs between XLA and PyTorch; at frame 1500 one ulp
    of a frequency (2^-23 relative) is up to 1.8e-4 rad of angle, so the
    full-width table is held within 1500 * 2 * 2^-23 = 3.6e-4."""
    got = TE._sinusoid(F_, d, torch.float32, "cpu")
    want = JE._sinusoid(F_, d, jnp.float32)
    tol = F32_TOL if F_ <= 16 else F_ * 2 * 2.0 ** -23
    assert _rel(got, want) <= tol


def test_encode_and_forward_match_at_f32(params):
    jp, tp = params
    jcfg, tcfg = _cfgs()
    jb, tb = _batch(jcfg)
    assert _rel(TE.encode(tcfg, tp, tb["encoder_input"]),
                JE.encode(jcfg, jp, jb["encoder_input"])) <= F32_TOL
    jh, _ = jmodel(jcfg).forward_hidden(jp, jb)
    th, aux = tmodel(tcfg).forward_hidden(tp, tb)
    assert aux == 0.0 and th.dtype == torch.float32
    assert _rel(th, jh) <= F32_TOL
    jl, _ = jmodel(jcfg).forward(jp, jb)
    tl, _ = tmodel(tcfg).forward(tp, tb)
    assert tl.shape == (B, T, tcfg.vocab_size) and tl.dtype == torch.float32
    assert _rel(tl, jl) <= F32_TOL
    assert tmodel(tcfg).head_matrix(tp) is tp["embed.lm_head"]


def test_forward_at_bf16_is_as_close_as_the_reference(params):
    jp, tp = params
    jcfg, tcfg = _cfgs("bfloat16")
    j32, t32 = _cfgs()
    jb, tb = _batch(jcfg)
    jl, _ = jmodel(jcfg).forward(jp, jb)
    tl, _ = tmodel(tcfg).forward(tp, tb)
    f32, _ = jmodel(j32).forward(jp, jb)
    assert _l2(tl, jl) <= BF16_L2
    assert _l2(tl, f32) <= BF16_FACTOR * _l2(jl, f32)
    th, _ = tmodel(tcfg).forward_hidden(tp, tb)
    assert th.dtype == torch.bfloat16


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_decode_matches_the_reference_decode(params, compute_dtype):
    """prefill_cache + decode_step token by token, against the reference's
    (f32: relative max 1e-5; bf16: relative L2 2e-2), and at f32 against
    the port's own forward (relative max 1e-5)."""
    jp, tp = params
    jcfg, tcfg = _cfgs(compute_dtype)
    jb, tb = _batch(jcfg, seed=1)
    jc = JE.prefill_cache(jcfg, jp, JE.init_cache(jcfg, B, T),
                          jb["encoder_input"])
    tc = TE.prefill_cache(tcfg, tp, TE.init_cache(tcfg, B, T, device="cpu"),
                          tb["encoder_input"])
    assert sorted(tc) == ["enc_out"] + sorted(
        f"layer{i}.{n}" for i in range(tcfg.num_layers) for n in "kv")
    jouts, touts = [], []
    for t in range(T):
        jl, jc = JE.decode_step(jcfg, jp, jc, jb["tokens"][:, t:t + 1],
                                jnp.int32(t))
        tl, tc2 = TE.decode_step(tcfg, tp, tc, tb["tokens"][:, t:t + 1], t)
        assert tc2 is tc                       # the cache, in place
        jouts.append(np.asarray(jl[:, 0]))
        touts.append(tl[:, 0])
    jd, td = np.stack(jouts, 1), torch.stack(touts, 1)
    if compute_dtype == "float32":
        assert _rel(td, jd) <= F32_TOL
        tf, _ = TE.forward(tcfg, tp, tb)
        assert _rel(td, tf.numpy()) <= F32_TOL
    else:
        assert _l2(td, jd) <= BF16_L2
    for i in range(tcfg.num_layers):
        assert _rel(tc[f"layer{i}.k"], jc[f"layer{i}"]["k"]) <= (
            F32_TOL if compute_dtype == "float32" else BF16_L2)


def test_init_draws_on_the_device_from_a_seed():
    _, tcfg = _cfgs()
    a = TE.init_params(tcfg, 3, device="cpu")
    b = TE.init_params(tcfg, 3, device="cpu")
    c = TE.init_params(tcfg, 4, device="cpu")
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["encoder.layer0.attn.wq"],
                           c["encoder.layer0.attn.wq"])
    assert torch.equal(a["final_norm.bias"], torch.zeros(tcfg.d_model))
    assert float(a["dec_pos"].std()) == pytest.approx(0.01, rel=0.05)
