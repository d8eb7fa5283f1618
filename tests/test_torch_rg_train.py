"""Port parity: training recurrentgemma-9b, on the CPU.

  * ``models.blocks.rglru_scan``'s derivatives (the RG-LRU gates under
    autograd around ``_LinearScan``, the doubling scan differentiated by
    hand) against ``jax.vjp`` / ``jax.jvp`` of
    ``repro.models.blocks.rglru_scan`` (``lax.associative_scan``) on the
    same numpy inputs, f32: every cotangent and the tangent within
    relative L2 1e-5 (the same f32 arithmetic; the scans combine in other
    trees).
  * ``_LinearScan`` against a plain step loop under autograd, at T = 1
    and ragged lengths, in f64: forward, vjp, jvp and
    ``torch.func.linearize`` at two vectors within 1e-12 relative; its
    derivatives raise at second order.
  * One NGHF update (4 CG, 2 NG iterations, ``cg_frac=4``) of the
    recurrentgemma-9b smoke model (3 layers, window 16) at T 32, past the
    window, through each package's ``build_step``, from the same
    parameters (the reference's tree with its constant leaves perturbed,
    carried across by ``convert.lm_params_from_numpy``): the same
    ``cg_best_iter``, ``cg_accepted`` and ``cg_iters_used``, candidate
    losses within 1e-4 relative and Δθ within relative L2 1e-4 (f32 on
    both sides, sums in other orders carried through 6 curvature
    products), as ``tests/test_torch_moe_train.py``.
  * The CLI trains recurrentgemma-9b and mixtral-8x22b at smoke size for
    one step.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget  # noqa: E402
from repro.data.synthetic import lm_batch as jbatch  # noqa: E402
from repro.launch.steps import build_step as jbuild  # noqa: E402
from repro.launch.steps import cg_sub_batch as jsub  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models.registry import get_model as jmodel  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as TCB  # noqa: E402
from repro_torch.data.synthetic import lm_batch  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.steps import build_step, cg_sub_batch  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402
from torch_perturb import VECTOR_LEAVES, perturb  # noqa: E402

ARCH = "recurrentgemma-9b"
SCAN_REL_L2 = 1e-5
LOOP_REL = 1e-12
DELTA_REL_L2 = 1e-4
LOSS_RTOL = 1e-4
EXACT = ("cg_best_iter", "cg_accepted", "cg_iters_used")
NGHF = dict(cg_iters=4, ng_iters=2)
B, T = 8, 32
# the RG-LRU's constant leaves: conv_b is drawn as zeros (perturbed as
# the vector leaves are), log_lambda as log(expm1(7.2)), where the decay a
# = exp(-8 r softplus(log_lambda)) is about 1e-13 and the scan barely
# carries h: the test draws log_lambda from N(-4, 0.5) (a about 0.9)
CONSTANT_LEAVES = VECTOR_LEAVES + ("conv_b",)
GATES = ("w_rec_gate", "w_input_gate", "log_lambda")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _l2(a, b) -> float:
    a = a.detach().double().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _scan_inputs(T_, seed=0):
    """Gate parameters at rg 64, u (2, T, 64), a cotangent and tangents,
    numpy-seeded; log_lambda varied per channel."""
    rng = np.random.default_rng(seed)
    rg = 64
    p = {"w_rec_gate": rng.normal(size=(rg, rg)) / 8,
         "w_input_gate": rng.normal(size=(rg, rg)) / 8,
         "log_lambda": np.log(np.expm1(rng.uniform(0.5, 8.0, size=rg)))}
    arrays = {k: v.astype(np.float32) for k, v in p.items()}
    for name in ("u", "g", "du"):
        arrays[name] = rng.normal(size=(2, T_, rg)).astype(np.float32)
    for k in GATES:
        arrays["d" + k] = rng.normal(size=arrays[k].shape).astype(np.float32)
    return arrays


@pytest.mark.parametrize("T_", [1, 37, 64])
def test_rglru_scan_vjp_and_jvp_match_the_reference(T_):
    x = _scan_inputs(T_, seed=T_)
    jp = {k: jnp.asarray(x[k]) for k in GATES}
    tp = {k: torch.from_numpy(x[k]) for k in GATES}
    ju, tu = jnp.asarray(x["u"]), torch.from_numpy(x["u"])
    want, jg = jax.jit(lambda p, u, g: (
        lambda out, pull: (out, pull(g)))(*jax.vjp(JB.rglru_scan, p, u)))(
            jp, ju, jnp.asarray(x["g"]))
    got, t_pull = torch.func.vjp(TB.rglru_scan, tp, tu)
    assert _l2(got, want) <= SCAN_REL_L2
    tg = t_pull(torch.from_numpy(x["g"]))
    assert _l2(tg[1], jg[1]) <= SCAN_REL_L2
    for k in GATES:
        assert _l2(tg[0][k], jg[0][k]) <= SCAN_REL_L2, k
    # plain autograd gives the same cotangents as torch.func.vjp
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    uu = tu.clone().requires_grad_()
    (TB.rglru_scan(leaves, uu) * torch.from_numpy(x["g"])).sum().backward()
    assert torch.allclose(uu.grad, tg[1], rtol=1e-6, atol=1e-7)
    tangents = ({k: x["d" + k] for k in GATES}, x["du"])
    _, jt = jax.jit(lambda p, u, dp, du: jax.jvp(
        JB.rglru_scan, (p, u), (dp, du)))(
            jp, ju, {k: jnp.asarray(v) for k, v in tangents[0].items()},
            jnp.asarray(tangents[1]))
    _, tt = torch.func.jvp(
        TB.rglru_scan, (tp, tu),
        ({k: torch.from_numpy(v) for k, v in tangents[0].items()},
         torch.from_numpy(tangents[1])))
    assert _l2(tt, jt) <= SCAN_REL_L2


def _loop(a, x):
    h, prev = [], torch.zeros_like(x[:, 0])
    for t in range(x.shape[1]):
        prev = a[:, t] * prev + x[:, t]
        h.append(prev)
    return torch.stack(h, 1)


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm().clamp(min=1e-300))


@pytest.mark.parametrize("T_", [1, 2, 9, 33])
def test_linear_scan_matches_a_step_loop(T_):
    gen = torch.Generator().manual_seed(T_)
    a = torch.rand(2, T_, 5, generator=gen, dtype=torch.float64) * 0.95
    x, g, da, dx = (torch.randn(2, T_, 5, generator=gen,
                                dtype=torch.float64) for _ in range(4))
    scan = TB._LinearScan.apply
    assert _rel(scan(a, x), _loop(a, x)) <= LOOP_REL
    leaves = [t.clone().requires_grad_() for t in (a, x)]
    want = torch.autograd.grad((_loop(*leaves) * g).sum(), leaves)
    got = torch.autograd.grad((scan(*leaves) * g).sum(), leaves)
    assert all(_rel(u, w) <= LOOP_REL for u, w in zip(got, want))
    _, pull = torch.func.vjp(scan, a, x)
    assert all(_rel(u, w) <= LOOP_REL for u, w in zip(pull(g), want))
    want_t = torch.func.jvp(_loop, (a, x), (da, dx))[1]
    assert _rel(torch.func.jvp(scan, (a, x), (da, dx))[1], want_t) \
        <= LOOP_REL
    _, lin = torch.func.linearize(scan, a, x)
    for s in (1.0, -2.5):
        want_t = torch.func.jvp(_loop, (a, x), (s * da, dx.flip(1)))[1]
        assert _rel(lin(s * da, dx.flip(1)), want_t) <= LOOP_REL


def test_linear_scan_is_first_order_only():
    gen = torch.Generator().manual_seed(0)
    a = torch.rand(1, 6, 3, generator=gen, dtype=torch.float64)
    x, g, dx = (torch.randn(1, 6, 3, generator=gen, dtype=torch.float64)
                for _ in range(3))

    def f(y):
        return TB._LinearScan.apply(a, y)

    with pytest.raises(NotImplementedError, match="first-order only"):
        torch.func.jvp(lambda y: torch.func.vjp(f, y)[1](g)[0], (x,), (dx,))
    with pytest.raises(NotImplementedError, match="first-order only"):
        torch.func.vjp(lambda y: torch.func.jvp(f, (y,), (dx,))[1], x)[1](g)
    with pytest.raises(NotImplementedError, match="first-order only"):
        torch.func.grad(lambda y: torch.func.grad(
            lambda z: f(z).sum())(y).sum())(x)
    y = x.clone().requires_grad_()
    with pytest.raises(NotImplementedError, match="first-order only"):
        torch.autograd.grad((f(y) * g).sum(), y, create_graph=True)


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(p, simple=True, separator="."):
            np.asarray(v) for p, v in
            jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def reference_update():
    """The reference's NGHF update of the smoke model, once."""
    jcfg = jget(ARCH).smoke().replace(compute_dtype="float32")
    jp = perturb(jmodel(jcfg).init(jax.random.PRNGKey(0)), 3,
                 CONSTANT_LEAVES)
    rng = np.random.default_rng(4)
    jp = jax.tree_util.tree_map_with_path(
        lambda path, leaf: jnp.asarray(
            rng.normal(-4.0, 0.5, size=leaf.shape).astype(np.float32))
        if str(getattr(path[-1], "key", "")) == "log_lambda" else leaf, jp)
    jb = jbatch(0, batch=B, seq_len=T, vocab=jcfg.vocab_size)
    jb = dict(jb, labels=jb["tokens"])
    _, jopt = jbuild(jcfg, "nghf", cg_frac=4, cg_fused=True, **NGHF)
    new_j, _, mj = jax.jit(lambda p: jopt.step(p, jopt.init(p), jb,
                                               jsub(jb, 4, 1)))(jp)
    return jp, new_j, mj


def test_nghf_update_matches_the_reference(reference_update):
    jp, new_j, mj = reference_update
    tcfg = TCB.get_config(ARCH).smoke().replace(compute_dtype="float32")
    assert tcfg.sliding_window < T
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                      device="cpu")
    tb = lm_batch(0, batch=B, seq_len=T, vocab=tcfg.vocab_size, device="cpu")
    tb = dict(tb, labels=tb["tokens"])
    _, topt = build_step(tcfg, "nghf", cg_frac=4, cg_fused=True, **NGHF)
    new_t, _, mt = topt.step(tp, topt.init(tp), tb, cg_sub_batch(tb, 4, 1))
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               rtol=1e-5)
    for key in EXACT:
        assert float(mt[key]) == float(mj[key]), key
    np.testing.assert_allclose(mt["cg_losses"].numpy(),
                               np.asarray(mj["cg_losses"]), rtol=LOSS_RTOL)
    nj, pj = _flat(new_j), _flat(jp)
    num = den = 0.0
    for k, p in tp.items():
        dj = nj[k] - pj[k]
        num += float((((new_t[k] - p).numpy() - dj) ** 2).sum())
        den += float((dj ** 2).sum())
    assert (num / den) ** 0.5 <= DELTA_REL_L2
    # an accepted step moves the RG-LRU's decay
    assert bool(mt["cg_accepted"]) != np.array_equal(
        nj["periods.slot0.log_lambda"], pj["periods.slot0.log_lambda"])


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "mixtral-8x22b"])
def test_cli_trains_the_windowed_archs(arch):
    log = ttrain.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--steps", "1", "--batch", "4", "--seq", "32",
                       "--cg-iters", "2", "--ng-iters", "1"])
    assert [m["step"] for m in log] == [0]
    assert all(np.isfinite(v) for v in log[0].values())
