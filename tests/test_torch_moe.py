"""Port parity: the mixture-of-experts archs (granite-moe-3b-a800m, the
``moe`` block: global attention; mixtral-8x22b, the ``swamoe`` block:
sliding-window attention) and both expert FFNs, ``moe_apply`` (the dense
one-hot combine, ``moe_impl="dense"``) and ``moe_apply_dispatch`` (the
capacity dispatch, ``moe_impl="dispatch"``).

The layers on numpy-seeded inputs at the smoke config (4 experts, top-2)
and at granite's 40 experts, top-8 with narrow widths (d 64, ff 32);
with a routing biased onto one expert, so that the dispatch form drops
tokens; and with a ``t_chunk`` smaller than T that does not divide it.
Then the blocks, the smoke archs' forward (logits and aux), prefill,
decode and ``serve``, ``input_specs`` at all four shapes, and the
full-size parameter trees by shape.  The reference's parameters cross by
``convert.lm_params_from_numpy`` with their vector leaves (norm scales)
perturbed by ``tests/torch_perturb.py``.

Tolerances:
  * f32 compute: relative max 1e-5 (|d| / max|ref|), outputs and aux —
    the same f32 arithmetic, sums in another order.  The router's top-k
    is discontinuous; the narrow gaps between the probabilities of the
    smoke router (scale 0.02) are still far wider than f32 rounding.
  * bf16 compute (the layers alone, on the same bf16 input): relative L2
    2e-2 (the dense archs' bf16 limit) for the output; the routing runs
    in f32 on both sides, so the aux stays within 1e-5.
  * input gradients and parameter gradients of (output · a numpy
    cotangent + aux) against ``jax.grad``: relative max 1e-4 (the f32
    backward sums over the experts and the scatter in another order).
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
from repro.models import blocks as JB  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.registry import get_model as jmodel  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as TCB  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.launch.steps import build_prefill_step  # noqa: E402
from repro_torch.launch.steps import build_serve_step  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.registry import get_model as tmodel  # noqa: E402
from torch_perturb import perturb  # noqa: E402

# the parameter counts of the reference's ``eval_shape`` at full size
FULL_PARAMS = {"granite-moe-3b-a800m": 3_298_793_472,
               "mixtral-8x22b": 140_630_071_296}
ARCHS = sorted(FULL_PARAMS)
KIND = {"granite-moe-3b-a800m": "moe", "mixtral-8x22b": "swamoe"}
F32_TOL = 1e-5
BF16_L2 = 2e-2
GRAD_TOL = 1e-4
FFNS = ("moe_apply", "moe_apply_dispatch")


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


def params_for(jcfg):
    """Reference smoke parameters (seed 0, perturbed) and the port's copy,
    cached per config."""
    if jcfg not in _PARAMS:
        jp = perturb(jmodel(jcfg).init(jax.random.PRNGKey(0)), 1)
        tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                          device="cpu")
        _PARAMS[jcfg] = (jp, tp)
    return _PARAMS[jcfg]


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _l2(got, want):
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


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
# configs, parameter trees, input specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_the_reference_config(arch, smoke):
    j, t = jget(arch), TCB.get_config(arch)
    if smoke:
        j, t = j.smoke(), t.smoke()
        assert (t.num_experts, t.num_experts_per_tok) == (4, 2)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.block_pattern == (KIND[arch],) and t.moe_impl == "dense"
    assert TCB.get_config(arch.replace("-", "_")) is TCB.get_config(arch)


@pytest.mark.parametrize("lead", [(), (3,)])
@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
def test_init_moe_shapes_and_dtypes_match_reference(activation, lead):
    """``init_moe`` against ``jax.eval_shape`` of the reference's, at
    granite's full width (a gated and an ungated activation); ``lead``
    stacks every leaf as the periods do."""
    jcfg = jget("granite-moe-3b-a800m").replace(activation=activation)
    tcfg = TCB.get_config("granite-moe-3b-a800m").replace(
        activation=activation)
    want = _flat_shapes(jax.eval_shape(
        lambda: JL.init_moe(jcfg, jax.random.PRNGKey(0))))
    got = TL.init_moe(tcfg, TL.Init("meta"), lead=lead)
    assert {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in got.items()} \
        == {k: (lead + s, dt) for k, (s, dt) in want.items()}
    assert ("w_gate" in got) == (activation == "swiglu")
    # the draws' scales: router 0.02, w_in 1/sqrt(d), w_out 1/sqrt(ff)
    small = tcfg.replace(d_model=256, d_ff=64, num_experts=8)
    p = TL.init_moe(small, TL.Init("cpu", torch.Generator().manual_seed(0)))
    for name, scale in (("router", 0.02), ("w_in", 1 / 16), ("w_out", 1 / 8)):
        assert abs(float(p[name].std()) / scale - 1) < 0.05, name


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_parameter_tree_by_shape_only(arch):
    """The port's tree against ``jax.eval_shape`` of the reference's
    init, leaf for leaf (4-D stacked expert leaves), and its parameter
    count, on the meta device."""
    want = jax.eval_shape(
        lambda: jmodel(jget(arch)).init(jax.random.PRNGKey(0)))
    want = {k: s for k, (s, _) in _flat_shapes(want).items()}
    model = tmodel(TCB.get_config(arch))
    got = model.param_shapes()
    assert {k: s for k, (s, _) in got.items()} == want
    assert all(dt == torch.float32 for _, dt in got.values())
    assert model.param_count() == FULL_PARAMS[arch]
    cfg = model.cfg
    assert got["periods.slot0.moe.w_in"][0] == (
        cfg.num_layers, cfg.num_experts, cfg.d_model, cfg.d_ff)
    assert got["periods.slot0.moe.router"][0] == (
        cfg.num_layers, cfg.d_model, cfg.num_experts)
    assert ("embed.lm_head" in got) == (not cfg.tie_embeddings)


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_tree_carries_across(arch):
    """``lm_params_from_numpy`` carries a reference smoke tree across with
    its 4-D stacked expert leaves unchanged: the port's keys, shapes and
    dtypes, and the reference's values bit for bit."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = params_for(jcfg)
    mine = TT.init_params(tcfg, 0, device="cpu")
    assert {k: (v.shape, v.dtype) for k, v in tp.items()} == \
        {k: (v.shape, v.dtype) for k, v in mine.items()}
    leaf = jp["periods"]["slot0"]["moe"]["w_in"]
    assert tp["periods.slot0.moe.w_in"].shape == (
        jcfg.num_layers, jcfg.num_experts, jcfg.d_model, jcfg.d_ff)
    np.testing.assert_array_equal(tp["periods.slot0.moe.w_in"].numpy(),
                                  np.asarray(leaf))
    for k, v in tp.items():
        node = jp
        for part in k.split("."):
            node = node[part]
        np.testing.assert_array_equal(v.numpy(), np.asarray(node))


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k",
                                   "long_500k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch, shape):
    """At full size, by shape: granite's global caches (32768 slots, and
    long_500k's 8192-slot ring), mixtral's 4096-slot window rings."""
    want = jmodel(jget(arch)).input_specs(shape)
    got = tmodel(TCB.get_config(arch)).input_specs(shape)
    if "cache" in want:
        cache = {k: (s, str(dt)[6:]) for k, (s, dt) in got.pop(
            "cache").items()}
        assert cache == _flat_shapes(want.pop("cache"))
        slots = {s[2] for s, _ in cache.values()}
        if arch == "mixtral-8x22b":
            assert slots == {4096}
        else:
            assert slots == ({8192} if shape == "long_500k" else {32768})
    assert {k: (tuple(s), str(d)[6:]) for k, (s, d) in got.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}


# ---------------------------------------------------------------------------
# the two expert FFNs
# ---------------------------------------------------------------------------

def _moe_case(E, k, dtype="float32", *, d=64, ff=32, activation="swiglu",
              seed=0):
    kw = dict(num_experts=E, num_experts_per_tok=k, d_model=d, d_ff=ff,
              activation=activation)
    jcfg, tcfg = _cfgs("granite-moe-3b-a800m", dtype, **kw)
    jp = JL.init_moe(jcfg, jax.random.PRNGKey(seed))
    tp = {n: torch.from_numpy(np.array(v)) for n, v in jp.items()}
    return jcfg, tcfg, jp, tp


def _x(B, T, d, dtype, seed=3):
    x = np.random.default_rng(seed).normal(size=(B, T, d)).astype(np.float32)
    return jnp.asarray(x, dtype), torch.from_numpy(x).to(getattr(torch,
                                                                 dtype))


def _top_sets(cfg, p, x):
    """The top-k expert sets of each token, as the port routes them."""
    _, _, ix = TL._route(cfg, p, x)
    return torch.sort(ix, dim=-1).values


@pytest.mark.parametrize("fn", FFNS)
@pytest.mark.parametrize("E,k,activation", [(4, 2, "swiglu"),
                                            (40, 8, "swiglu"),
                                            (4, 2, "gelu")],
                         ids=["smoke", "e40_top8", "ungated"])
def test_moe_ffn_matches_reference_f32(fn, E, k, activation):
    jcfg, tcfg, jp, tp = _moe_case(E, k, activation=activation)
    jx, tx = _x(2, 16, jcfg.d_model, "float32")
    want, waux = getattr(JL, fn)(jcfg, jp, jx)
    got, aux = getattr(TL, fn)(tcfg, tp, tx)
    assert got.shape == tx.shape and got.dtype == torch.float32
    assert aux.shape == () and aux.dtype == torch.float32
    assert _rel(got, want) < F32_TOL
    assert abs(float(aux) - float(waux)) <= F32_TOL * abs(float(waux))


@pytest.mark.parametrize("fn", FFNS)
@pytest.mark.parametrize("E,k", [(4, 2), (40, 8)], ids=["smoke", "e40_top8"])
def test_moe_ffn_matches_reference_bf16(fn, E, k):
    jcfg, tcfg, jp, tp = _moe_case(E, k, "bfloat16")
    jx, tx = _x(2, 16, jcfg.d_model, "bfloat16", seed=4)
    want, waux = getattr(JL, fn)(jcfg, jp, jx)
    got, aux = getattr(TL, fn)(tcfg, tp, tx)
    assert got.dtype == torch.bfloat16 and aux.dtype == torch.float32
    assert _l2(got, want) < BF16_L2
    assert abs(float(aux) - float(waux)) <= F32_TOL * abs(float(waux))


def test_the_reference_aux_forms_differ_by_k():
    """The dense form's f sums to k and the dispatch form's to 1, so on the
    same inputs the dense aux is about k times the dispatch aux (8.059
    against 1.007 here).  A difference inside the reference, kept."""
    jcfg, tcfg, jp, tp = _moe_case(40, 8)
    jx, tx = _x(2, 16, jcfg.d_model, "float32")
    dense = float(TL.moe_apply(tcfg, tp, tx)[1])
    dispatch = float(TL.moe_apply_dispatch(tcfg, tp, tx)[1])
    assert dense == pytest.approx(float(JL.moe_apply(jcfg, jp, jx)[1]),
                                  rel=F32_TOL)
    assert dispatch == pytest.approx(
        float(JL.moe_apply_dispatch(jcfg, jp, jx)[1]), rel=F32_TOL)
    assert 7.5 < dense / dispatch < 8.5


def test_dispatch_drops_tokens_as_the_reference_does():
    """A router biased onto expert 0: every token routes there, past its
    capacity C = ceil(S·k/E · 1.25) = 20 of the S = 32 tokens, so 12
    (token, expert 0) pairs are dropped.  The dispatch output and aux are
    the reference's; the dropped tokens' outputs lose expert 0's share, so
    they differ from the dense form, the kept ones do not."""
    jcfg, tcfg, jp, tp = _moe_case(4, 2, seed=1)
    d = jcfg.d_model
    bias = np.zeros((d, 4), np.float32)
    bias[:, 0] = 4.0 / d
    router = np.asarray(jp["router"]) + bias
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    x = np.random.default_rng(5).normal(size=(2, 16, d)).astype(np.float32)
    x += 1.0                                  # along the biased column
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    assert bool((_top_sets(tcfg, tp, tx)[..., 0] == 0).all())
    S, C = 32, math.ceil(32 * 2 / 4 * 1.25)
    assert C == 20
    want, waux = JL.moe_apply_dispatch(jcfg, jp, jx)
    got, aux = TL.moe_apply_dispatch(tcfg, tp, tx)
    assert _rel(got, want) < F32_TOL
    assert abs(float(aux) - float(waux)) <= F32_TOL * abs(float(waux))
    dense, _ = TL.moe_apply(tcfg, tp, tx)
    differs = ((got - dense).abs().amax(-1) > 1e-4 * dense.abs().max())
    differs = differs.reshape(S)
    # the stable sort keeps the first C tokens in expert 0's bucket
    assert differs.tolist() == [False] * C + [True] * (S - C)


@pytest.mark.parametrize("t_chunk,T", [(5, 12), (4, 12), (7, 13)])
def test_dense_t_chunks_match_reference(t_chunk, T):
    """``t_chunk`` below T: T runs in chunks of the largest divisor of T
    up to ``t_chunk`` (4 for (5, 12), 1 for (7, 13)), as the reference's
    rematted chunks; the same output as one chunk."""
    jcfg, tcfg, jp, tp = _moe_case(4, 2)
    jx, tx = _x(2, T, jcfg.d_model, "float32", seed=6)
    want, waux = JL.moe_apply(jcfg, jp, jx, t_chunk=t_chunk)
    got, aux = TL.moe_apply(tcfg, tp, tx, t_chunk=t_chunk)
    assert _rel(got, want) < F32_TOL
    assert abs(float(aux) - float(waux)) <= F32_TOL * abs(float(waux))
    whole, _ = TL.moe_apply(tcfg, tp, tx)
    assert _rel(got, whole) < F32_TOL


@pytest.mark.parametrize("fn", FFNS)
def test_moe_ffn_gradients_match_reference(fn):
    """d(out · c + aux)/d(x, router, w_in, w_gate, w_out) against
    ``jax.grad``, at 40 experts top-8: the backward through the top-k,
    the combine (scatter_add) or the buckets (index_put, the gather and
    index_add)."""
    jcfg, tcfg, jp, tp = _moe_case(40, 8)
    jx, tx = _x(2, 8, jcfg.d_model, "float32", seed=7)
    c = np.random.default_rng(8).normal(size=tx.shape).astype(np.float32)

    def jloss(p, x):
        out, aux = getattr(JL, fn)(jcfg, p, x)
        return jnp.sum(out * c) + aux

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(jp, jx)
    leaves = {n: v.clone().requires_grad_(True) for n, v in tp.items()}
    xx = tx.clone().requires_grad_(True)
    out, aux = getattr(TL, fn)(tcfg, leaves, xx)
    (torch.sum(out * torch.from_numpy(c)) + aux).backward()
    assert _rel(xx.grad, jg_x) < GRAD_TOL
    for n, v in leaves.items():
        assert _rel(v.grad, jg_p[n]) < GRAD_TOL, n


@pytest.mark.parametrize("fn", FFNS)
def test_moe_ffn_jvp_matches_reference(fn):
    """``torch.func.jvp`` through both forms (the curvature products'
    forward mode: the top-k weights, the combine or the buckets) against
    ``jax.jvp`` of the reference's, tangents on every parameter and on x."""
    jcfg, tcfg, jp, tp = _moe_case(40, 8)
    jx, tx = _x(2, 8, jcfg.d_model, "float32", seed=9)
    rng = np.random.default_rng(10)
    tang = {n: rng.normal(size=v.shape).astype(np.float32)
            for n, v in tp.items()}
    tx_dot = rng.normal(size=tx.shape).astype(np.float32)
    (want, waux), (wdot, wadot) = jax.jvp(
        lambda p, x: getattr(JL, fn)(jcfg, p, x), (jp, jx),
        ({n: jnp.asarray(v) for n, v in tang.items()}, jnp.asarray(tx_dot)))
    (got, aux), (gdot, adot) = torch.func.jvp(
        lambda p, x: getattr(TL, fn)(tcfg, p, x), (tp, tx),
        ({n: torch.from_numpy(v) for n, v in tang.items()},
         torch.from_numpy(tx_dot)))
    assert _rel(got, want) < F32_TOL
    assert _rel(gdot, wdot) < GRAD_TOL
    assert abs(float(adot) - float(wadot)) <= GRAD_TOL * abs(float(wadot))


# ---------------------------------------------------------------------------
# blocks, forward, prefill, decode, serve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["dense", "dispatch"])
@pytest.mark.parametrize("arch", ARCHS)
def test_block_apply_matches_reference(arch, impl):
    """One ``moe``/``swamoe`` block (layer 0 of the smoke tree) at f32,
    with either FFN: the output and the aux."""
    jcfg, tcfg = _cfgs(arch, moe_impl=impl)
    jp, tp = params_for(jcfg)
    kind = KIND[arch]
    jx, tx = _x(2, 24, jcfg.d_model, "float32", seed=10)
    pos = np.arange(24)
    want, waux = JB.block_apply(
        jcfg, kind, jax.tree.map(lambda a: a[0], jp["periods"]["slot0"]),
        jx, jnp.asarray(pos))
    got, aux = TB.block_apply(tcfg, kind, TT.nest(tp, "periods.slot0.", 0),
                              tx, torch.from_numpy(pos))
    assert _rel(got, want) < F32_TOL
    assert abs(float(aux) - float(waux)) <= F32_TOL * abs(float(waux))


@pytest.mark.parametrize("impl", ["dense", "dispatch"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_match_reference_f32(arch, impl):
    """Logits and the summed aux of both layers (T = 32: past mixtral's
    smoke window of 16), and the prefill's last logits."""
    jcfg, tcfg = _cfgs(arch, moe_impl=impl)
    jp, tp = params_for(jcfg)
    jb, tb = _tokens(jcfg, 2, 32)
    want, waux = jmodel(jcfg).forward(jp, jb)
    got, aux = tmodel(tcfg).forward(tp, tb)
    assert got.shape == (2, 32, jcfg.vocab_size) and got.dtype == torch.float32
    assert _rel(got, want) < F32_TOL
    assert aux.shape == () and float(aux) > 0
    assert abs(float(aux) - float(waux)) <= F32_TOL * abs(float(waux))
    got = build_prefill_step(tcfg)(tp, tb)
    assert got.shape == (2, 1, jcfg.vocab_size)
    assert _rel(got, jprefill(jcfg)(jp, jb)) < F32_TOL


def test_forward_sums_a_tensor_aux_from_the_first_layer():
    """``forward_hidden`` starts its aux at 0.0 and adds each block's: a
    tensor from an MoE layer, 0.0 from a dense one, in any order."""
    jcfg, tcfg = _cfgs("granite-moe-3b-a800m",
                       block_pattern=("moe", "attn"))
    jp, tp = params_for(jcfg)
    jb, tb = _tokens(jcfg, 1, 8, seed=11)
    want, waux = jmodel(jcfg).forward(jp, jb)
    got, aux = tmodel(tcfg).forward(tp, tb)
    assert _rel(got, want) < F32_TOL and isinstance(aux, torch.Tensor)
    assert abs(float(aux) - float(waux)) <= F32_TOL * abs(float(waux))
    _, dense_aux = tmodel(tcfg.replace(block_pattern=("attn",))).forward(
        TT.init_params(tcfg.replace(block_pattern=("attn",)), 0,
                       device="cpu"), tb)
    assert dense_aux == 0.0


def _decode(jcfg, tcfg, jp, tp, toks, cache_len, long_mode=False):
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
def test_decode_matches_reference_and_prefill(arch):
    """24 decode steps into a 32-slot cache (mixtral's smoke ring of 16
    wraps) against the reference's decode step by step and its final
    caches; decode runs the dense form even when ``moe_impl`` is
    "dispatch", as the reference's.  Over the first 16 tokens (T <=
    window) the last decode logits are the prefill's (ROADMAP §3.3)."""
    jcfg, tcfg = _cfgs(arch, moe_impl="dispatch")
    jp, tp = params_for(jcfg)
    toks = np.random.default_rng(12).integers(0, jcfg.vocab_size, (2, 24))
    jdec, tdec, jc, tc = _decode(jcfg, tcfg, jp, tp, toks, 32)
    slots = 16 if arch == "mixtral-8x22b" else 32
    assert tc["periods.slot0.k"].shape == (2, 2, slots, jcfg.num_kv_heads,
                                           jcfg.resolved_head_dim)
    assert _rel(tdec, jdec) < F32_TOL
    flat = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jc),
                                        device="cpu")
    assert set(flat) == set(tc)
    for k in tc:
        assert _rel(tc[k], flat[k]) < F32_TOL, k
    pre = build_prefill_step(tcfg.replace(moe_impl="dense"))(
        tp, {"tokens": torch.from_numpy(toks[:, :16])})
    assert _rel(tdec[:, 15], pre[:, 0]) < F32_TOL


def test_granite_long_mode_ring_matches_reference():
    """granite's ``long_mode``: a 128-token cache bounded to the smoke
    ring of 64 slots, 72 steps (the ring wraps), logits and caches."""
    jcfg, tcfg = _cfgs("granite-moe-3b-a800m")
    jp, tp = params_for(jcfg)
    toks = np.random.default_rng(13).integers(0, jcfg.vocab_size, (1, 72))
    jdec, tdec, jc, tc = _decode(jcfg, tcfg, jp, tp, toks, 128, True)
    assert tc["periods.slot0.k"].shape[2] == 64
    assert _rel(tdec, jdec) < F32_TOL
    flat = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jc),
                                        device="cpu")
    for k in tc:
        assert _rel(tc[k], flat[k]) < F32_TOL, k


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_greedy_matches_reference(arch):
    """``serve`` with greedy decoding at f32 compute: the reference's
    tokens (prompts past mixtral's smoke window)."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = params_for(jcfg)
    rng = np.random.default_rng(14)
    prompts = [rng.integers(0, jcfg.vocab_size, size=n).tolist()
               for n in (20, 5)]
    jreqs = [JS.Request(i, p, 6) for i, p in enumerate(prompts)]
    treqs = [TS.Request(i, p, 6) for i, p in enumerate(prompts)]
    jreqs, _ = JS.serve(jcfg, jmodel(jcfg), jp, jreqs, cache_len=32)
    treqs, stats = TS.serve(tcfg, tmodel(tcfg), tp, treqs, cache_len=32)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert stats["steps"] == 20 + 6 - 1


def test_serve_cli_runs_granite_smoke(capsys):
    stats = TS.main(["--arch", "granite-moe-3b-a800m", "--smoke",
                     "--device", "cpu", "--requests", "2", "--max-new", "3",
                     "--long-mode"])
    assert stats["steps"] > 0 and "[serve]" in capsys.readouterr().out
