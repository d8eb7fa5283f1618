"""Port parity: the xLSTM arch (xlstm-125m: the ``mlstm`` and ``slstm``
blocks, the backbone, decode, ``serve``, LM training through
``launch.steps.build_step`` and the CLIs).

Every module of ``repro_torch`` against its ``repro`` counterpart on the
same numpy-seeded inputs and the same parameters (the reference's tree
with its zero biases, ``b_if`` and unit norm scales perturbed by
``tests/torch_perturb.py``, carried across by
``convert.lm_params_from_numpy``), at the smoke size of xlstm-125m (one
(mlstm, mlstm, mlstm, slstm) period, d 128, 4 heads: mLSTM heads of hd 64,
sLSTM heads of hd 32; vocab 512), on the CPU.

The port runs the mLSTM over a sequence in its exact chunkwise-parallel
form (``blocks.mlstm_chunkwise``); the reference scans the step
recurrence.  Tolerances:
  * f32 compute: relative max 1e-5 (|d| / max|ref|) for the recurrences'
    outputs, the blocks' residual branches (output - input), the logits
    and the decode states — the same function in f32, sums in another
    order (the mLSTM's stabiliser as a cumsum plus cummax, not a running
    max); jvp tangents and vjp cotangents within 1e-4 (derivatives
    carried back through 96 sLSTM steps).
  * float64, the port alone: the chunkwise form against the step
    recurrence within 1e-10 (outputs) and 1e-9 (gradients), at chunk
    sizes that do and do not divide T.
  * bf16 compute (the config's): relative L2 2e-2 against the reference's
    bf16 logits, and no farther from the f32 logits than 1.5x the
    reference's own bf16 logits are (as ``tests/test_torch_lm.py``).
  * one NGHF update without candidate selection: the same CG iterate
    count, Δθ within relative L2 1e-4 (as ``tests/test_torch_moe_train.py``).
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget  # noqa: E402
from repro.data.synthetic import lm_batch as jbatch  # noqa: E402
from repro.launch import serve as JS  # noqa: E402
from repro.launch.steps import build_prefill_step as jprefill  # noqa: E402
from repro.launch.steps import build_step as jbuild  # noqa: E402
from repro.launch.steps import cg_sub_batch as jsub  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models.registry import get_model as jmodel  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as TCB  # noqa: E402
from repro_torch.data.synthetic import lm_batch  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.steps import build_prefill_step  # noqa: E402
from repro_torch.launch.steps import build_step, cg_sub_batch  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.registry import get_model as tmodel  # noqa: E402
from torch_perturb import VECTOR_LEAVES, perturb  # noqa: E402

ARCH = "xlstm-125m"
FULL_PARAMS = 150_319_176
F32_TOL = 1e-5
GRAD_TOL = 1e-4
F64_TOL, F64_GRAD_TOL = 1e-10, 1e-9
BF16_L2 = 2e-2
DELTA_REL_L2 = 1e-4
EXACT = ("cg_best_iter", "cg_accepted", "cg_iters_used")
# the reference draws these as constants (zeros, b_if's 0 / 3, ones)
PERTURBED = VECTOR_LEAVES + ("b_if", "b_zifo", "conv_b")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(compute_dtype="float32"):
    return (jget(ARCH).smoke().replace(compute_dtype=compute_dtype),
            TCB.get_config(ARCH).smoke().replace(compute_dtype=compute_dtype))


@pytest.fixture(scope="module")
def params():
    """Reference smoke parameters (seed 0, perturbed) and the port's copy."""
    jcfg, _ = _cfgs()
    jp = perturb(jmodel(jcfg).init(jax.random.PRNGKey(0)), 1, PERTURBED)
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                      device="cpu")
    return jp, tp


def _block(jp, tp, slot):
    return (jax.tree.map(lambda a: a[0], jp["periods"][slot]),
            TT.nest(tp, f"periods.{slot}.", 0))


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


def _x(shape, seed=0, scale=1.0):
    x = (scale * np.random.default_rng(seed).normal(size=shape)).astype(
        np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


# block inputs at 0.01 N(0, 1): the blocks' pre-norms make the residual
# branch independent of the scale, and the branch (about 1e-3 for an
# mLSTM block at the smoke init) is then not lost in the f32 rounding of
# x + branch
BLOCK_X = 0.01


def _tokens(cfg, B, T, seed=0):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                size=(B, T))
    return {"tokens": jnp.asarray(toks, jnp.int32)}, \
        {"tokens": torch.from_numpy(toks)}


def _recurrence_inputs(B, T, H, hd, seed, dtype=np.float32):
    """q, k, v (B,T,H,hd) and log_i, log_f (B,T,H): gates spread so that
    the stabiliser's running max and the denominator's clamp at 1 both
    switch along the sequence."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, T, H, hd)).astype(dtype)
               for _ in range(3))
    k = (k / np.sqrt(hd)).astype(dtype)
    log_i = (2.0 * rng.normal(size=(B, T, H))).astype(dtype)
    f_pre = (3.0 + 2.0 * rng.normal(size=(B, T, H))).astype(dtype)
    log_f = -np.logaddexp(0.0, -f_pre).astype(dtype)
    return q, k, v, log_i, log_f


def _step_loop(step, q, k, v, log_i, log_f, zeros, full):
    """A step recurrence run from the zero state: its outputs h_t, its
    final carry and its unclamped denominators |n_t · q_t|."""
    B, T, H, hd = q.shape
    carry = (zeros((B, H, hd, hd)), zeros((B, H, hd)), full((B, H), -1e30))
    hs, dens = [], []
    for t in range(T):
        carry, h = step(carry, (q[:, t], k[:, t], v[:, t], log_i[:, t],
                                log_f[:, t]))
        hs.append(h)
        dens.append(abs((carry[1] * q[:, t]).sum(-1)))
    return hs, carry, dens


# ---------------------------------------------------------------------------
# configs and the parameter tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
def test_config_is_the_reference_config(smoke):
    j, t = jget(ARCH), TCB.get_config(ARCH)
    if smoke:
        j, t = j.smoke(), t.smoke()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_full_width_parameter_tree_by_shape_only():
    """The port's tree against ``jax.eval_shape`` of the reference's init,
    leaf for leaf, at full width and depth; 150,319,176 parameters."""
    cfg = jget(ARCH)
    want = jax.eval_shape(lambda: jmodel(cfg).init(jax.random.PRNGKey(0)))
    want = {jax.tree_util.keystr(path, simple=True, separator="."):
            tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_leaves_with_path(want)}
    model = tmodel(TCB.get_config(ARCH))
    got = model.param_shapes()
    assert {k: s for k, (s, _) in got.items()} == want
    assert model.param_count() == FULL_PARAMS
    assert got["periods.slot0.w_q"] == ((3, 1536, 1536), torch.float32)
    assert got["periods.slot3.r_zifo"] == ((3, 4, 4, 192, 192),
                                           torch.float32)
    assert "embed.lm_head" not in got and not any(
        k.startswith("rest.") for k in got)


def test_init_draws_the_reference_distributions():
    _, tcfg = _cfgs()
    p = TT.init_params(tcfg, seed=0, device="cpu")
    H = tcfg.num_heads
    assert torch.equal(p["periods.slot0.b_if"][0],
                       torch.tensor([0.0] * H + [3.0] * H))
    assert float(p["periods.slot0.conv_w"].std()) == pytest.approx(0.1,
                                                                   rel=0.1)
    hd = tcfg.d_model // H
    assert float(p["periods.slot3.r_zifo"].std()) == pytest.approx(
        1 / np.sqrt(hd), rel=0.1)
    assert not p["periods.slot3.b_zifo"].any()


def test_share_counts_are_one_but_the_tied_table():
    model = tmodel(TCB.get_config(ARCH))
    counts = model.share_counts(model.param_shapes())
    assert {k: c for k, c in counts.items() if c != 1.0} == \
        {"embed.table": 2.0}


# ---------------------------------------------------------------------------
# the recurrences
# ---------------------------------------------------------------------------

def test_mlstm_step_matches_reference():
    """``_mlstm_step`` over a loop of 40 steps: outputs and final state."""
    q, k, v, li, lf = _recurrence_inputs(2, 40, 4, 16, seed=1)
    jh, (jC, jn, jm), _ = _step_loop(
        JB._mlstm_step, *(jnp.asarray(a) for a in (q, k, v, li, lf)),
        jnp.zeros, lambda s, x: jnp.full(s, x))
    th, (tC, tn, tm), _ = _step_loop(
        TB._mlstm_step, *(torch.from_numpy(a) for a in (q, k, v, li, lf)),
        torch.zeros, torch.full)
    assert _rel(torch.stack(th, 1), jnp.stack(jh, 1)) < F32_TOL
    for got, want in ((tC, jC), (tn, jn), (tm, jm)):
        assert _rel(got, want) < F32_TOL


@pytest.mark.parametrize("T,chunk", [(50, 16), (50, 64), (96, 32), (96, 40),
                                     (96, 96)])
def test_mlstm_chunkwise_is_the_reference_recurrence(T, chunk):
    """``mlstm_chunkwise`` at chunk sizes that do and do not divide T (and
    one chunk past T) against the reference's ``_mlstm_step`` scan; some
    denominators are clamped at 1 and some are not."""
    q, k, v, li, lf = _recurrence_inputs(2, T, 4, 16, seed=T)
    jh, _, dens = _step_loop(JB._mlstm_step,
                             *(jnp.asarray(a) for a in (q, k, v, li, lf)),
                             jnp.zeros, lambda s, x: jnp.full(s, x))
    dens = np.stack([np.asarray(d) for d in dens])
    assert 0.1 < (dens < 1.0).mean() < 0.9
    want = jnp.stack(jh, 1)
    got = TB.mlstm_chunkwise(*(torch.from_numpy(a)
                               for a in (q, k, v, li, lf)), time_chunk=chunk)
    assert got.shape == (2, T, 4, 16) and got.dtype == torch.float32
    assert _rel(got, want) < F32_TOL


@pytest.mark.parametrize("chunk", [7, 32, 64])
def test_mlstm_chunkwise_float64_values_and_gradients(chunk):
    """In float64, the port's chunkwise form against its own step
    recurrence: outputs, and the gradients of (h · c) by autograd with
    respect to every input."""
    T = 64
    ins = [torch.from_numpy(a).requires_grad_(True) for a in
           _recurrence_inputs(2, T, 2, 8, seed=11, dtype=np.float64)]
    c = torch.from_numpy(np.random.default_rng(12).normal(
        size=(2, T, 2, 8)))
    hs, _, _ = _step_loop(TB._mlstm_step, *ins,
                       lambda s: torch.zeros(s, dtype=torch.float64),
                       lambda s, x: torch.full(s, x, dtype=torch.float64))
    want = torch.stack(hs, 1)
    want_g = torch.autograd.grad((want * c).sum(), ins)
    got = TB.mlstm_chunkwise(*ins, time_chunk=chunk)
    got_g = torch.autograd.grad((got * c).sum(), ins)
    got, want = got.detach(), want.detach()
    assert float((got - want).abs().max() / want.abs().max()) < F64_TOL
    for g, w in zip(got_g, want_g):
        assert float((g - w).abs().max() / w.abs().max()) < F64_GRAD_TOL


def _slstm_autograd_loop(pre_x, R):
    """The sLSTM recurrence as plain autograd operations, with JAX's tie
    rules (``torch.maximum`` splits its gradient at a tie)."""
    T, H, B, G = pre_x.shape
    zero = pre_x.new_zeros(H, B, G // 4)
    c, n, h, m = zero, zero, zero, torch.full_like(zero, -1e30)
    hs = []
    for t in range(T):
        pre = torch.baddbmm(pre_x[t], h, R).unflatten(-1, (4, -1))
        z, log_i = torch.tanh(pre[..., 0, :]), pre[..., 1, :]
        log_f = torch.nn.functional.logsigmoid(pre[..., 2, :])
        o = torch.sigmoid(pre[..., 3, :])
        m_new = torch.maximum(log_f + m, log_i)
        i, f = torch.exp(log_i - m_new), torch.exp(log_f + m - m_new)
        c, n = f * c + i * z, f * n + i
        h, m = o * c / torch.maximum(n, n.new_ones(())), m_new
        hs.append(h)
    return torch.stack(hs)


def test_slstm_scan_derivatives_are_autograds():
    """``_SLSTMScan``'s hand-written jvp and vjp against forward- and
    reverse-mode autograd through the plain loop, in float64 (the first
    step's normaliser ties at n = 1), and ``gradcheck``."""
    rng = np.random.default_rng(13)
    T, H, B, hd = 24, 2, 3, 5
    pre_x = torch.from_numpy(2 * rng.normal(size=(T, H, B, 4 * hd)))
    R = torch.from_numpy(rng.normal(size=(H, hd, 4 * hd)) / np.sqrt(hd))
    tang = (torch.from_numpy(rng.normal(size=pre_x.shape)),
            torch.from_numpy(rng.normal(size=R.shape)))
    ct = torch.from_numpy(rng.normal(size=(T, H, B, hd)))
    scan = lambda a, b: TB._SLSTMScan.apply(a, b)[0]      # noqa: E731
    want, w_dot = torch.func.jvp(_slstm_autograd_loop, (pre_x, R), tang)
    got, g_dot = torch.func.jvp(scan, (pre_x, R), tang)
    assert float((got - want).abs().max()) < F64_TOL
    assert float((g_dot - w_dot).abs().max() / w_dot.abs().max()) \
        < F64_GRAD_TOL
    w_bar = torch.func.vjp(_slstm_autograd_loop, pre_x, R)[1](ct)
    g_bar = torch.func.vjp(scan, pre_x, R)[1](ct)
    for g, w in zip(g_bar, w_bar):
        assert float((g - w).abs().max() / w.abs().max()) < F64_GRAD_TOL
    assert torch.autograd.gradcheck(
        scan, (pre_x[:6].clone().requires_grad_(True),
               R.clone().requires_grad_(True)))


def _slstm_case(seed):
    rng = np.random.default_rng(seed)
    T, H, B, hd = 12, 2, 3, 5
    pre_x = torch.from_numpy(2 * rng.normal(size=(T, H, B, 4 * hd)))
    R = torch.from_numpy(rng.normal(size=(H, hd, 4 * hd)) / np.sqrt(hd))
    tang = (torch.from_numpy(rng.normal(size=pre_x.shape)),
            torch.from_numpy(rng.normal(size=R.shape)))
    return pre_x, R, tang, torch.from_numpy(rng.normal(size=(T, H, B, hd)))


def _slstm_scan(pre_x, R):
    return TB._SLSTMScan.apply(pre_x, R)[0]


def test_slstm_scan_under_linearize_is_autograds_jvp():
    """``torch.func.linearize`` (NGHF's ``curvature_mode="linearize"``)
    traces ``_SLSTMScan``'s jvp once and replays it: the same tangent as
    forward-mode autograd through the plain loop, float64."""
    pre_x, R, tang, _ = _slstm_case(17)
    want = torch.func.jvp(_slstm_autograd_loop, (pre_x, R), tang)[1]
    out, jvp_fn = torch.func.linearize(_slstm_scan, pre_x, R)
    got = jvp_fn(*tang)
    assert float((out - _slstm_autograd_loop(pre_x, R)).abs().max()) \
        < F64_TOL
    assert float((got - want).abs().max() / want.abs().max()) \
        < F64_GRAD_TOL


@pytest.mark.parametrize("nest", ["jvp(jvp)", "jvp(vjp)", "vjp(jvp)",
                                  "vjp(vjp)", "double backward"])
def test_slstm_scan_refuses_second_order(nest):
    """The hand-written derivatives read the saved states as constants,
    so a derivative of them would be wrong: every second-order
    composition raises instead of returning it."""
    pre_x, R, tang, ct = _slstm_case(19)
    f = _slstm_scan

    def jvp(a, b):
        return torch.func.jvp(f, (a, b), tang)[1]

    def vjp(a, b):
        return torch.func.vjp(f, a, b)[1](ct)

    runs = {
        "jvp(jvp)": lambda: torch.func.jvp(jvp, (pre_x, R), tang),
        "jvp(vjp)": lambda: torch.func.jvp(vjp, (pre_x, R), tang),
        "vjp(jvp)": lambda: torch.func.vjp(jvp, pre_x, R)[1](ct),
        "vjp(vjp)": lambda: torch.func.vjp(vjp, pre_x, R)[1](tang),
    }

    def double_backward():
        a = pre_x.clone().requires_grad_(True)
        (g,) = torch.autograd.grad((f(a, R) * ct).sum(), a,
                                   create_graph=True)
        torch.autograd.grad((g * tang[0]).sum(), a)

    runs["double backward"] = double_backward
    with pytest.raises(NotImplementedError, match="first-order only"):
        runs[nest]()


def test_chunk_graph_cache_keeps_the_most_recent_shapes(monkeypatch):
    """``blocks._cached_graph``: a shape's graph is made once while it is
    cached; past ``_CHUNK_GRAPHS_MAX`` shapes the least recently used one
    is dropped (with it its memory pool)."""
    monkeypatch.setattr(TB, "_CHUNK_GRAPHS", type(TB._CHUNK_GRAPHS)())
    made = []

    def make(key):
        return lambda: made.append(key) or f"graph {key}"

    n = TB._CHUNK_GRAPHS_MAX
    for key in range(n):
        assert TB._cached_graph(key, make(key)) == f"graph {key}"
    assert TB._cached_graph(0, make(0)) == "graph 0" and made == list(
        range(n))                                    # 0 is now the newest
    TB._cached_graph(n, make(n))
    assert len(TB._CHUNK_GRAPHS) == n and 1 not in TB._CHUNK_GRAPHS
    assert 0 in TB._CHUNK_GRAPHS and made == list(range(n + 1))


@pytest.mark.parametrize("T,chunk", [(50, 16), (50, 64), (96, 32),
                                     (96, 40)])
def test_mlstm_block_matches_reference(params, T, chunk):
    """The mLSTM block at T = 50 (one flat scan in the reference) and T = 96
    (two rematted chunks of 48 there), at port chunk sizes that do and do
    not divide T: the residual branch (output - input)."""
    jcfg, tcfg = _cfgs()
    jp, tp = _block(*params, "slot0")
    jx, tx = _x((2, T, jcfg.d_model), seed=T, scale=BLOCK_X)
    want, _ = JB.block_apply(jcfg, "mlstm", jp, jx, jnp.arange(T))
    got, aux = TB.mlstm_block_apply(tcfg, tp, tx, None, time_chunk=chunk)
    assert aux == 0.0
    assert _rel(got - tx, np.asarray(want) - _np(tx)) < F32_TOL


def test_slstm_block_matches_reference(params):
    jcfg, tcfg = _cfgs()
    jp, tp = _block(*params, "slot3")
    jx, tx = _x((2, 50, jcfg.d_model), seed=3, scale=BLOCK_X)
    want, _ = JB.block_apply(jcfg, "slstm", jp, jx, jnp.arange(50))
    got, aux = TB.block_apply(tcfg, "slstm", tp, tx, None)
    assert aux == 0.0
    assert _rel(got - tx, np.asarray(want) - _np(tx)) < F32_TOL


@pytest.mark.parametrize("slot", ["slot0", "slot3"])
def test_block_decode_matches_reference(params, slot):
    """20 decode steps of an mLSTM (slot0) and an sLSTM (slot3) block from
    a zero cache against the reference's, the caches in its layout, and
    the last step against the sequence path."""
    jcfg, tcfg = _cfgs()
    jp, tp = _block(*params, slot)
    kind = jcfg.block_pattern[int(slot[-1])]
    jx, tx = _x((2, 20, jcfg.d_model), seed=6, scale=BLOCK_X)
    jc = JB.init_block_cache(jcfg, kind, 2, 32)
    tc = TB.init_block_cache(tcfg, kind, 2, 32)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in tc.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in jc.items()}
    for t in range(20):
        jy, jc = JB.block_decode(jcfg, kind, jp, jx[:, t:t + 1], jc,
                                 jnp.int32(t))
        ty, tc = TB.block_decode(tcfg, kind, tp, tx[:, t:t + 1], tc, t)
        assert _rel(ty - tx[:, t:t + 1], np.asarray(jy) - np.asarray(
            jx[:, t:t + 1])) < F32_TOL, t
    for k in tc:
        assert _rel(tc[k], jc[k]) < F32_TOL, k
    seq, _ = TB.block_apply(tcfg, kind, tp, tx, None)
    assert _rel(ty[:, 0] - tx[:, -1], seq[:, -1] - tx[:, -1]) < F32_TOL


def test_mlstm_block_saves_no_per_step_state():
    """The bytes an mLSTM block at xlstm-125m's full width (hd 384) saves
    for its backward at T = 256, counted by ``saved_tensors_hooks``, stay
    below a quarter of T·B·H·hd²·4 (the per-step state stack a scan would
    save); the step recurrence's own loop saves more than its stack (the
    counter sees it).  ``torch.func.vjp`` (the curvature products') refuses
    saved-tensor hooks; it records the same autograd graph, so the count
    is taken with inputs that require grad."""
    def saved_bytes(fn, *args):
        total = [0]

        def pack(t):
            total[0] += t.numel() * t.element_size()
            return t

        args = [a.detach().requires_grad_(True) for a in args]
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            fn(*args)
        return total[0]

    T, B = 256, 1
    cfg = TCB.get_config(ARCH).replace(compute_dtype="float32")
    inner, H, hd = TB._mlstm_dims(cfg)
    flat = {k: v[0] for k, v in TT.init_params(
        cfg.replace(num_layers=4), 0, device="cpu").items()
        if k.startswith("periods.slot0.")}
    names = list(flat)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(B, T, cfg.d_model)).astype(np.float32))
    stack = T * B * H * hd * hd * 4
    got = saved_bytes(lambda x_, *w: TB.mlstm_block_apply(
        cfg, TT.nest(dict(zip(names, w)), "periods.slot0."), x_, None)[0],
        x, *flat.values())
    assert got < stack / 4, (got, stack)
    # the oracle, at a narrow width: a per-step loop saves the stack
    q, k, v, li, lf = (torch.from_numpy(a) for a in
                       _recurrence_inputs(1, 64, 2, 16, seed=4))
    small = 64 * 1 * 2 * 16 * 16 * 4

    def loop(q_, k_, v_):
        hs, _, _ = _step_loop(TB._mlstm_step, q_, k_, v_, li, lf,
                              torch.zeros, torch.full)
        return torch.stack(hs, 1)

    assert saved_bytes(loop, q, k, v) >= small


# ---------------------------------------------------------------------------
# the backbone: forward, prefill, decode, serve, jvp, vjp
# ---------------------------------------------------------------------------

def test_forward_and_prefill_match_reference_f32(params):
    jcfg, tcfg = _cfgs()
    jp, tp = params
    jb, tb = _tokens(jcfg, 2, 72)
    want, _ = jmodel(jcfg).forward(jp, jb)
    got, aux = tmodel(tcfg).forward(tp, tb)
    assert got.shape == (2, 72, jcfg.vocab_size) and got.dtype == torch.float32
    assert aux == 0.0 and _rel(got, want) < F32_TOL
    got = build_prefill_step(tcfg)(tp, tb)
    assert got.shape == (2, 1, jcfg.vocab_size)
    assert _rel(got, jprefill(jcfg)(jp, jb)) < F32_TOL


def test_forward_matches_reference_bf16(params):
    jcfg, tcfg = _cfgs("bfloat16")
    jp, tp = params
    jb, tb = _tokens(jcfg, 2, 48, seed=1)
    ref32, _ = jmodel(jcfg.replace(compute_dtype="float32")).forward(jp, jb)
    want, _ = jmodel(jcfg).forward(jp, jb)
    got, _ = tmodel(tcfg).forward(tp, tb)
    assert _l2(got, want) < BF16_L2
    assert _l2(got, ref32) < 1.5 * _l2(want, ref32)


def test_decode_steps_match_reference_and_forward(params):
    """16 ``decode_step``s against the reference's step by step, the
    caches at the end, and the decode logits against ``forward``'s."""
    jcfg, tcfg = _cfgs()
    jp, tp = params
    jm, tm = jmodel(jcfg), tmodel(tcfg)
    jb, tb = _tokens(jcfg, 2, 16, seed=2)
    jstep = jax.jit(jm.decode_step)
    jc = jm.init_cache(2, 16)
    tc = tm.init_cache(2, 16, device="cpu")
    dec = []
    for t in range(16):
        jl, jc = jstep(jp, jc, jb["tokens"][:, t:t + 1], jnp.int32(t))
        tl, tc = tm.decode_step(tp, tc, tb["tokens"][:, t:t + 1], t)
        assert _rel(tl, jl) < F32_TOL, t
        dec.append(tl[:, 0])
    flat = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jc),
                                        device="cpu")
    assert set(flat) == set(tc)
    for k in tc:
        assert _rel(tc[k], flat[k]) < F32_TOL, k
    full, _ = tm.forward(tp, tb)
    assert _rel(torch.stack(dec, 1), full) < F32_TOL


def test_serve_greedy_matches_reference_token_for_token(params):
    jcfg, tcfg = _cfgs()
    jp, tp = params
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, jcfg.vocab_size, size=n).tolist()
               for n in (9, 12, 5)]
    jreqs = [JS.Request(i, p, 8) for i, p in enumerate(prompts)]
    treqs = [TS.Request(i, p, 8) for i, p in enumerate(prompts)]
    jreqs, jstats = JS.serve(jcfg, jmodel(jcfg), jp, jreqs, cache_len=32)
    treqs, tstats = TS.serve(tcfg, tmodel(tcfg), tp, treqs, cache_len=32)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert all(r.done and len(r.generated) == 8 for r in treqs)
    assert tstats["steps"] == jstats["steps"] == 12 + 8 - 1


def _tangents(tp, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=tuple(v.shape)).astype(np.float32)
            for k, v in tp.items()}


def test_jvp_and_vjp_match_reference(params):
    """``torch.func.jvp`` and ``torch.func.vjp`` of the model's logits (the
    curvature products' two halves) against ``jax.jvp`` and ``jax.vjp``,
    tangents on every parameter, at T = 40 (chunks of 64 in neither)."""
    jcfg, tcfg = _cfgs()
    jp, tp = params
    jm, tm = jmodel(jcfg), tmodel(tcfg)
    jb, tb = _tokens(jcfg, 2, 40, seed=4)
    flat = jax.tree_util.tree_flatten_with_path(jp)
    names = [jax.tree_util.keystr(p, simple=True, separator=".")
             for p, _ in flat[0]]
    tang = _tangents(tp, 5)
    jt = jax.tree_util.tree_unflatten(flat[1], [jnp.asarray(tang[n])
                                                for n in names])
    jf = lambda p: jm.forward(p, jb)[0]           # noqa: E731
    tf = lambda p: tm.forward(p, tb)[0]           # noqa: E731
    want, wdot = jax.jit(lambda p, t: jax.jvp(jf, (p,), (t,)))(jp, jt)
    got, gdot = torch.func.jvp(tf, (tp,), ({k: torch.from_numpy(v)
                                            for k, v in tang.items()},))
    assert _rel(got, want) < F32_TOL
    assert _rel(gdot, wdot) < GRAD_TOL
    ct = np.random.default_rng(6).normal(size=want.shape).astype(np.float32)
    (jg,) = jax.jit(lambda p, c: jax.vjp(jf, p)[1](c))(jp, jnp.asarray(ct))
    (tg,) = torch.func.vjp(tf, tp)[1](torch.from_numpy(ct))
    jg = dict(zip(names, jax.tree_util.tree_leaves(jg)))
    for k in tp:
        assert _rel(tg[k], jg[k]) < GRAD_TOL, k


# ---------------------------------------------------------------------------
# training: build_step and the CLIs
# ---------------------------------------------------------------------------

def _flat(tree) -> dict:
    return {jax.tree_util.keystr(p, simple=True, separator="."):
            np.asarray(v) for p, v in
            jax.tree_util.tree_leaves_with_path(tree)}


def test_nghf_update_matches_the_reference(params):
    """One NGHF update (4 CG, 2 NG iterations, the share-counts
    preconditioner, fused CG, ``cg_frac=4``) through each package's
    ``build_step`` optimiser from the same parameters and ``lm_batch``,
    without candidate selection: the last CG iterate.  (With selection
    both packages reject every candidate of this smoke model, whose CG
    iterates are far steps, |Δθ| about 420, with CE 21-250 against 5.9
    at Δθ = 0; there the f32 forward is ill-conditioned, the reference's
    logits 1e-3 relative off their float64 values.)"""
    jcfg, tcfg = _cfgs()
    jp, tp = params
    B, T = 8, 32
    jb = jbatch(0, batch=B, seq_len=T, vocab=jcfg.vocab_size)
    tb = lm_batch(0, batch=B, seq_len=T, vocab=tcfg.vocab_size, device="cpu")
    kw = dict(cg_iters=4, ng_iters=2, cg_fused=True, eval_candidates=False)
    _, jopt = jbuild(jcfg, "nghf", cg_frac=4, **kw)
    _, topt = build_step(tcfg, "nghf", cg_frac=4, **kw)
    jb = dict(jb, labels=jb["tokens"])
    tb = dict(tb, labels=tb["tokens"])
    new_j, _, mj = jax.jit(lambda p: jopt.step(p, jopt.init(p), jb,
                                               jsub(jb, 4, 1)))(jp)
    new_t, st, mt = topt.step(tp, topt.init(tp), tb, cg_sub_batch(tb, 4, 1))
    assert int(st["step"]) == 1
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               rtol=1e-5)
    for key in EXACT:
        assert float(mt[key]) == float(mj[key]), key
    nj, pj = _flat(new_j), _flat(jp)
    num = den = 0.0
    for k, p in tp.items():
        dj = nj[k] - pj[k]
        num += float((((new_t[k] - p).numpy() - dj) ** 2).sum())
        den += float((dj ** 2).sum())
    assert den > 0 and (num / den) ** 0.5 <= DELTA_REL_L2


def test_nghf_linearize_mode_gives_the_rematvp_update(params):
    """``curvature_mode="linearize"`` (``torch.func.linearize`` once, its
    jvp replayed per product) against the default ``"rematvp"`` (a jvp
    and a vjp per product): one NGHF update as above, the same CG
    iterate count and Δθ within relative L2 1e-4."""
    _, tcfg = _cfgs()
    tp = params[1]
    tb = lm_batch(0, batch=8, seq_len=32, vocab=tcfg.vocab_size,
                  device="cpu")
    tb["labels"] = tb["tokens"]
    out = []
    for mode in ("rematvp", "linearize"):
        _, opt = build_step(tcfg, "nghf", cg_frac=4, cg_iters=4, ng_iters=2,
                            cg_fused=True, eval_candidates=False,
                            curvature_mode=mode)
        new, _, m = opt.step(tp, opt.init(tp), tb, cg_sub_batch(tb, 4, 1))
        out.append(({k: new[k] - tp[k] for k in tp}, m))
    (d_r, m_r), (d_l, m_l) = out
    assert int(m_l["cg_iters_used"]) == int(m_r["cg_iters_used"])
    num = sum(float(((d_l[k] - d_r[k]) ** 2).sum()) for k in tp)
    den = sum(float((d_r[k] ** 2).sum()) for k in tp)
    assert den > 0 and (num / den) ** 0.5 <= DELTA_REL_L2


CLI = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "4",
       "--seq", "32"]


def test_cli_trains_nghf_with_a_checkpoint(tmp_path):
    """The reference's ``test_train_driver_nghf`` on the port."""
    log = ttrain.main(CLI + ["--optimizer", "nghf", "--steps", "2",
                             "--cg-iters", "2", "--ng-iters", "1",
                             "--ckpt-dir", str(tmp_path / "ckpt")])
    assert len(log) == 2 and np.isfinite(log[-1]["loss"])
    assert os.path.exists(tmp_path / "ckpt" / "manifest.json")


def test_cli_resumes_sgd_mid_run(tmp_path):
    """The reference's ``test_train_driver_resume`` on the port; the
    ``lm-`` alias trains too."""
    ck = str(tmp_path / "ckpt")
    ttrain.main(CLI + ["--optimizer", "sgd", "--steps", "2", "--ckpt-dir",
                       ck])
    log = ttrain.main(CLI[:1] + ["lm-" + ARCH] + CLI[2:] + [
        "--optimizer", "sgd", "--steps", "4", "--ckpt-dir", ck, "--resume"])
    assert [m["step"] for m in log] == [2, 3]
    assert all(np.isfinite(m["loss"]) for m in log)


def test_serve_cli_defaults_to_xlstm(capsys):
    """The reference's ``test_serve_driver`` on the port, with the CLI's
    default arch (xlstm-125m, as the reference's)."""
    stats = TS.main(["--smoke", "--device", "cpu", "--requests", "3",
                     "--max-new", "4", "--cache-len", "32"])
    assert stats["tokens_per_s"] > 0
    assert 0 < stats["latency_p50_s"] <= stats["latency_p99_s"]
    assert stats["latency_p99_s"] <= stats["wall_s"] + 1e-6
    out = capsys.readouterr().out
    assert out.count("req ") == 3 and "[serve]" in out


def test_unknown_block_kind_raises():
    _, tcfg = _cfgs()
    with pytest.raises(ValueError, match="conv"):
        TB.init_block(tcfg, TL.Init("meta"), "conv")
