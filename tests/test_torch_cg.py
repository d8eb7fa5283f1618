"""Port parity: theta-vector helpers, the CG engine and the fused CG
update's plain version.

``core.tree_math`` on flat ``"layer.leaf"`` dicts against
``repro.core.tree_math`` on the nested pytree, and ``tree_math.ravel``'s
order against ``jax.flatten_util.ravel_pytree`` (so 65536-element blocks
of the fused path cover the same elements).  ``core.cg.cg_solve``
against ``repro.core.cg.cg_solve`` on fixed SPD (and, for the guard, one
indefinite) systems over the same pytree: fixed budget, the ``tol``
loop, warm start, count-tree and callable preconditioners, the
negative-curvature guard, ``eval_every``, fused and unfused.
``kernels.ref.cg_fused_update_ref`` against ``repro.kernels.ref.
cg_fused_update_ref`` with a ragged tail in f32 and bf16 storage, and
its Σr² bitwise on a repeat.

Tolerances: tree_math rtol 1e-5 / atol 1e-6 (f32, one or two roundings);
CG iterates, histories and losses rtol 1e-4 / atol 1e-5 (f32, up to a
dozen iterations on 57-dim systems, the dot products summed in other
orders and the differences carried through the recurrence); the
iteration counts and selected iterates must match exactly; bf16 buffers
within one bf16 rounding
(2^-8 relative) since the two frameworks may round the f32 result at
slightly different values; Σr² rtol 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from repro.core import cg as jcg  # noqa: E402
from repro.core import tree_math as jtm  # noqa: E402
from repro.kernels import ref as JR  # noqa: E402
from repro_torch.core import cg as tcg  # noqa: E402
from repro_torch.core import tree_math as tm  # noqa: E402
from repro_torch.kernels import cg_fused as CG  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
SHAPES = {"rec1": {"w": (4, 5), "b": (5,)}, "out": {"w": (3, 7),
                                                    "b": (7,)},
          "ff0": {"b": (4,)}}


def _tree(rng, scale=1.0):
    return {k: {n: (rng.normal(size=s) * scale).astype(np.float32)
                for n, s in v.items()} for k, v in SHAPES.items()}


def _flat(tree) -> dict:
    return {f"{k}.{n}": torch.from_numpy(np.array(a)) for k, v in
            tree.items() for n, a in v.items()}


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _assert_tree(got_flat, want_tree, rtol=RTOL, atol=ATOL):
    want = _flat(jax.tree.map(np.asarray, want_tree))
    assert set(got_flat) == set(want)
    for k in want:
        np.testing.assert_allclose(got_flat[k].float().numpy(),
                                   want[k].float().numpy(), rtol=rtol,
                                   atol=atol, err_msg=k)


def test_tree_math_matches_jax():
    rng = np.random.default_rng(0)
    a, b = _tree(rng), _tree(rng)
    ta, tb = _flat(a), _flat(b)
    ja, jb = _j(a), _j(b)
    _assert_tree(tm.add(ta, tb), jtm.add(ja, jb))
    _assert_tree(tm.sub(ta, tb), jtm.sub(ja, jb))
    _assert_tree(tm.scale(ta, 0.3), jtm.scale(ja, 0.3))
    _assert_tree(tm.axpy(-1.7, ta, tb), jtm.axpy(-1.7, ja, jb))
    _assert_tree(tm.where(torch.tensor(False), ta, tb),
                 jtm.where(jnp.asarray(False), ja, jb))
    np.testing.assert_allclose(float(tm.vdot(ta, tb)),
                               float(jtm.vdot(ja, jb)), rtol=1e-6)
    np.testing.assert_allclose(float(tm.norm(ta)), float(jtm.norm(ja)),
                               rtol=1e-6)
    half = {k: v.to(torch.bfloat16) for k, v in ta.items()}
    cast = tm.cast_like(half, ta)
    assert all(v.dtype == torch.float32 for v in cast.values())
    # scale keeps each leaf's dtype, as jnp.asarray(s, x.dtype) * x
    assert all(v.dtype == torch.bfloat16
               for v in tm.scale(half, torch.tensor(2.5)).values())


def test_ravel_order_matches_ravel_pytree():
    rng = np.random.default_rng(1)
    tree = _tree(rng)
    want, _ = ravel_pytree(_j(tree))
    flat = _flat(tree)
    got, unravel = tm.ravel(dict(reversed(list(flat.items()))))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = unravel(got)
    assert list(back) == list(reversed(list(flat)))   # the input's order
    for k in flat:
        assert torch.equal(back[k], flat[k])


def _system(seed, indefinite=False):
    """A fixed 57-dim system B = Q diag(e) Qᵀ acting on the ravelled tree,
    b, and a candidate loss (the quadratic plus a quartic term, so the
    best candidate is not simply the last)."""
    rng = np.random.default_rng(seed)
    n = int(sum(np.prod(s) for v in SHAPES.values() for s in v.values()))
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    e = np.linspace(0.5, 8.0, n)
    if indefinite:
        e[::3] *= -1.0
    mat = (q * e) @ q.T
    return mat.astype(np.float32), _tree(rng)


def _jax_ops(mat, b):
    jm = jnp.asarray(mat)
    bflat, unravel = ravel_pytree(b)

    def bv(v):
        return unravel(jm @ ravel_pytree(v)[0])

    def ev(x):
        xf = ravel_pytree(x)[0]
        return 0.5 * xf @ (jm @ xf) - xf @ bflat + 0.05 * jnp.sum(xf ** 4)
    return bv, ev


def _port_ops(mat, b):
    tm_ = torch.from_numpy(mat)
    bflat, unravel = tm.ravel(b)

    def bv(v):
        return unravel(tm_ @ tm.ravel(v)[0])

    def ev(x):
        xf = tm.ravel(x)[0]
        return 0.5 * xf @ (tm_ @ xf) - xf @ bflat + 0.05 * (xf ** 4).sum()
    return bv, ev


def _counts(theta_shaped: bool):
    c = {"rec1": 5.0, "out": 1.0, "ff0": 2.0}
    return {k: {n: (np.full(s, c[k], np.float32) if theta_shaped
                    else np.float32(c[k]))
                for n, s in v.items()} for k, v in SHAPES.items()}


def _flat_counts(tree):
    return {f"{k}.{n}": (torch.from_numpy(np.array(a)) if np.ndim(a)
                         else float(a))
            for k, v in tree.items() for n, a in v.items()}


CASES = {
    "fixed": dict(iters=6),
    "fixed_eval_every": dict(iters=7, eval_every=3),
    "no_eval": dict(iters=5, evaluate=False),
    "tol": dict(iters=12, tol=1e-3, min_iters=2),
    "tol_eval_every": dict(iters=12, tol=1e-3, eval_every=2),
    "warm": dict(iters=5, warm=True),
    "damping": dict(iters=5, damping=0.7),
    "counts": dict(iters=6, precond="counts"),
    "callable": dict(iters=6, precond="callable"),
    "negative": dict(iters=6, indefinite=True),
    "negative_tol": dict(iters=6, indefinite=True, tol=1e-6),
}


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_cg_solve_matches_jax(name, fused):
    kw = dict(CASES[name])
    mat, b = _system(sum(map(ord, name)), kw.pop("indefinite", False))
    evaluate = kw.pop("evaluate", True)
    warm = kw.pop("warm", False)
    precond = kw.pop("precond", None)
    jbv, jev = _jax_ops(mat, _j(b))
    tb = _flat(b)
    tbv, tev = _port_ops(mat, tb)
    jkw, tkw = dict(kw), dict(kw)
    if warm:
        x0 = _tree(np.random.default_rng(9), 0.1)
        jkw["x0"], tkw["x0"] = _j(x0), _flat(x0)
    if precond == "counts":
        # fused needs theta-shaped counts in the reference (ravel_pytree)
        c = _counts(theta_shaped=fused)
        jkw["precond"], tkw["precond"] = _j(c), _flat_counts(c)
    elif precond == "callable":
        c = _counts(theta_shaped=False)
        jkw["precond"] = lambda t: jax.tree.map(lambda x, s: x / s, t, c)
        tc = _flat_counts(c)
        tkw["precond"] = lambda t: {k: x / tc[k] for k, x in t.items()}
    want = jcg.cg_solve(jbv, _j(b), eval_fn=jev if evaluate else None,
                        fused=fused, **jkw)
    got = tcg.cg_solve(tbv, tb, eval_fn=tev if evaluate else None,
                       fused=fused, **tkw)
    assert int(got.iters_used) == int(want.iters_used)
    assert int(got.best_iter) == int(want.best_iter)
    _assert_tree(got.x, want.x, rtol=1e-4, atol=1e-5)
    for field in ("quad", "resid", "curv", "losses", "best_loss"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)),
                                   rtol=1e-4, atol=1e-5, err_msg=field)
    assert got.host_syncs <= int(got.iters_used) + 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cg_fused_update_plain_matches_jax(dtype):
    rng = np.random.default_rng(4)
    n = 2 * CG.TILE + 777                      # a ragged last tile
    arrs = [rng.normal(size=n).astype(np.float32) for _ in range(4)]
    jd = jnp.dtype(dtype)
    td = getattr(torch, dtype)
    jx = [jnp.asarray(a).astype(jd) for a in arrs]
    tx = [torch.from_numpy(a).to(td) for a in arrs]
    alpha = np.float32(-0.61)
    want = JR.cg_fused_update_ref(jnp.float32(alpha), *jx)
    got = R.cg_fused_update_ref(torch.tensor(alpha), *tx)
    tol = 0.0 if dtype == "float32" else 2.0 ** -8
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == td
        w = np.asarray(w.astype(jnp.float32))
        np.testing.assert_allclose(g.float().numpy(), w, rtol=tol,
                                   atol=1e-7)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-6)
    # the wrapper runs the plain version on CPU tensors; rr is
    # deterministic (same bits on a repeat)
    again = CG.cg_fused_update(torch.tensor(alpha), *tx)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


def test_cg_fused_update_checks_shapes():
    x = torch.zeros(5)
    with pytest.raises(ValueError, match="shape"):
        CG.cg_fused_update(0.5, x, x, torch.zeros(4), x)
