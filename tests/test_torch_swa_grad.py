"""Port parity: the windowed attention's derivatives, on the CPU.

On the same numpy inputs (f32, T 48 past windows of 5 and 16, GQA and
MQA, one query chunk of 48 and ragged chunks of 20 in the port):

  * ``models.layers.windowed_attention``'s vjp and jvp (the kernel's
    plain version under ``torch.func``) against ``jax.vjp`` / ``jax.jvp``
    of ``repro.models.layers.windowed_attention``;
  * the derivative kernels' plain versions, ``kernels.ref.
    swa_attention_vjp_ref`` and ``swa_attention_jvp_ref`` (the yardsticks
    the card holds the kernels against), against the same;
  * ``kernels.swa_attention._SwaAttention``, the autograd Function every
    CUDA call runs through, on CPU tensors (its launches then take the
    plain versions): its forward, plain autograd, ``torch.func.vjp``,
    ``jvp`` and ``linearize`` at two vectors against the reference, its
    no-grad output bitwise the direct call's, and second order raising.

Every tensor within relative L2 1e-5 of the reference's (the same f32
arithmetic, sums in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402
from repro_torch.kernels import swa_attention as SWA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

REL_L2 = 1e-5
T = 48
# (H, K, window): GQA and MQA, windows inside T
GEOMETRIES = [(4, 2, 5), (4, 1, 16)]


def _l2(a, b) -> float:
    a = a.detach().double().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module", params=GEOMETRIES,
                ids=[f"H{h}_K{k}_w{w}" for h, k, w in GEOMETRIES])
def case(request):
    """numpy inputs, cotangent and tangents, and the reference's output,
    vjp and jvp (one jit each) for one geometry."""
    H, K, w = request.param
    rng = np.random.default_rng(H + K + w)
    hd = 16
    shapes = [(2, T, h, hd) for h in (H, K, K, H, H, K, K)]
    x = [rng.normal(size=s).astype(np.float32) for s in shapes]
    q, k, v, g, tq, tk, tv = map(jnp.asarray, x)

    def f(a, b, c):
        return JL.windowed_attention(a, b, c, w, q_chunk=T)

    out, grads = jax.jit(lambda a, b, c, g_: (
        lambda o, pull: (o, pull(g_)))(*jax.vjp(f, a, b, c)))(q, k, v, g)
    _, tangent = jax.jit(lambda *a: jax.jvp(f, a[:3], a[3:]))(
        q, k, v, tq, tk, tv)
    return {"w": w, "x": [torch.from_numpy(a) for a in x], "out": out,
            "grads": grads, "tangent": tangent}


def test_windowed_attention_vjp_and_jvp_match_the_reference(case):
    q, k, v, g, tq, tk, tv = case["x"]
    w = case["w"]
    for chunk in (T, 20):
        def f(a, b, c, chunk=chunk):
            return TL.windowed_attention(a, b, c, w, q_chunk=chunk)

        out, pull = torch.func.vjp(f, q, k, v)
        assert _l2(out, case["out"]) <= REL_L2
        for got, want in zip(pull(g), case["grads"]):
            assert _l2(got, want) <= REL_L2
        _, tangent = torch.func.jvp(f, (q, k, v), (tq, tk, tv))
        assert _l2(tangent, case["tangent"]) <= REL_L2


def test_plain_versions_of_the_kernels_match_the_reference(case):
    q, k, v, g, tq, tk, tv = case["x"]
    w = case["w"]
    for chunk in (T, 20):
        grads = R.swa_attention_vjp_ref(q, k, v, g, w, q_chunk=chunk)
        for got, want in zip(grads, case["grads"]):
            assert _l2(got, want) <= REL_L2
        tangent = R.swa_attention_jvp_ref(q, k, v, tq, tk, tv, w,
                                          q_chunk=chunk)
        assert _l2(tangent, case["tangent"]) <= REL_L2


def test_the_autograd_function_matches_the_reference(case):
    q, k, v, g, tq, tk, tv = case["x"]
    w = case["w"]

    def f(a, b, c):
        return SWA._SwaAttention.apply(a, b, c, w, False)

    with torch.no_grad():
        assert torch.equal(f(q, k, v), SWA._forward(q, k, v, w, False))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = f(*leaves)
    assert _l2(out, case["out"]) <= REL_L2
    out.backward(g)
    for got, want in zip(leaves, case["grads"]):
        assert _l2(got.grad, want) <= REL_L2
    _, pull = torch.func.vjp(f, q, k, v)
    for got, want in zip(pull(g), case["grads"]):
        assert _l2(got, want) <= REL_L2
    gq = torch.func.grad(lambda a: (f(a, k, v) * g).sum())(q)
    assert _l2(gq, case["grads"][0]) <= REL_L2
    assert _l2(torch.func.jvp(f, (q, k, v), (tq, tk, tv))[1],
               case["tangent"]) <= REL_L2
    # linearize records the jvp's launch: right at the traced vector and
    # at another one
    _, jvp_fn = torch.func.linearize(f, q, k, v)
    assert _l2(jvp_fn(tq, tk, tv), case["tangent"]) <= REL_L2
    other = (-2.0 * tq, tk.flip(1), 0.5 * tv - tk)
    want = R.swa_attention_jvp_ref(q, k, v, *other, w)
    assert _l2(jvp_fn(*other), want.numpy()) <= REL_L2


def test_the_autograd_function_is_first_order_only(case):
    q, k, v, g, tq, _, _ = case["x"]
    w = case["w"]

    def f(a):
        return SWA._SwaAttention.apply(a, k, v, w, False)

    with pytest.raises(NotImplementedError, match="first-order only"):
        torch.func.jvp(lambda a: torch.func.vjp(f, a)[1](g)[0], (q,), (tq,))
    with pytest.raises(NotImplementedError, match="first-order only"):
        torch.func.vjp(lambda a: torch.func.jvp(f, (a,), (tq,))[1], q)[1](g)
    a = q.clone().requires_grad_()
    with pytest.raises(NotImplementedError, match="first-order only"):
        torch.autograd.grad((f(a) * g).sum(), a, create_graph=True)
