"""Port parity: sliding-window attention.

The port's plain version ``repro_torch.kernels.ref.swa_attention_ref``
against the reference's dense ``repro.kernels.ref.swa_attention_ref``
and its Pallas kernel ``repro.kernels.ops.swa_attention`` (interpret
mode on the CPU, as ``tests/test_kernels.py`` runs it), on the sweep
shapes of ``tests/test_kernels.py``, GQA/MQA, ragged T, T = 1, window 0
and a window past T; the port's ``layers.windowed_attention`` against
the reference's; the CPU wrapper's routing and checks.  The CUDA kernel
itself is held against the plain version on the card
(``tests/test_torch_cuda_lm.py``, ``chip_smoke.py``).

Tolerances (max abs, as ``tests/test_kernels.py``): f32 2e-5 — the same
f32 arithmetic, sums in another order; bf16 2e-2 — outputs are rounded
to bf16 (one ulp is 2^-8 relative) from f32 values that differ in the
last bits.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops, ref as JR  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402
from repro_torch.kernels import swa_attention as SWA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _qkv(B, T, H, K, hd, dtype, seed=0, S=None):
    """numpy-seeded q (B,T,H,hd), k/v (B,S,K,hd), rounded to ``dtype`` once
    and handed to both sides as the same values."""
    rng = np.random.default_rng(seed)
    S = T if S is None else S
    arrs = [rng.normal(size=(B, T, H, hd)), rng.normal(size=(B, S, K, hd)),
            rng.normal(size=(B, S, K, hd))]
    jx = [jnp.asarray(a, jnp.float32).astype(dtype) for a in arrs]
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        getattr(torch, dtype)) for a in jx]
    return jx, tx


def _np(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,hd,window,H", [
    (256, 64, 128, 2), (512, 64, 128, 4), (256, 128, 128, 2),
    (512, 128, 256, 1),
])
def test_plain_version_matches_reference_and_pallas(T, hd, window, H, dtype):
    (jq, jk, jv), (tq, tk, tv) = _qkv(2, T, H, H, hd, dtype)
    got = TR.swa_attention_ref(tq, tk, tv, window)
    assert got.dtype == tq.dtype and got.shape == (2, T, H, hd)
    tol = TOL[dtype]
    np.testing.assert_allclose(
        _np(got), _np(JR.swa_attention_ref(jq, jk, jv, window)),
        atol=tol, rtol=tol)
    np.testing.assert_allclose(
        _np(got), _np(ops.swa_attention(jq, jk, jv, window)),
        atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,K", [(4, 1), (4, 2), (8, 2)])
def test_gqa_and_mqa_read_the_kv_head_without_repeating(H, K, dtype):
    """K < H: query head h reads kv head h // (H // K); the reference
    takes the heads repeated (``repeat_kv``)."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(2, 128, H, K, 32, dtype, seed=1)
    got = TR.swa_attention_ref(tq, tk, tv, 40)
    want = JR.swa_attention_ref(jq, JL.repeat_kv(jk, H), JL.repeat_kv(jv, H),
                                40)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype],
                               rtol=TOL[dtype])
    np.testing.assert_array_equal(
        TL.repeat_kv(tk, H).float().numpy(), _np(JL.repeat_kv(jk, H)))


@pytest.mark.parametrize("T,window,q_chunk", [
    (1, 16, 512), (37, 16, 512), (200, 0, 64), (200, 5, 48),
    (100, 300, 32), (333, 64, 128),
])
def test_ragged_t_and_edge_windows_match_reference(T, window, q_chunk):
    """Any T (not a multiple of the chunk), window 0 (the diagonal only),
    a window past T (plain causal attention)."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, T, 4, 1, 16, "float32", seed=T)
    got = TR.swa_attention_ref(tq, tk, tv, window, q_chunk=q_chunk)
    want = JR.swa_attention_ref(jq, JL.repeat_kv(jk, 4), JL.repeat_kv(jv, 4),
                                window)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)
    if window == 0:
        np.testing.assert_allclose(_np(got), _np(jv.repeat(4, 2)),
                                   atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,H,K,hd,window,q_chunk", [
    (2, 48, 4, 1, 32, 16, 512),       # the recurrentgemma smoke layer
    (1, 256, 2, 2, 64, 128, 128),     # tests/test_kernels.py's layer case
    (1, 1024, 2, 1, 32, 128, 512),    # several query chunks
])
def test_windowed_attention_matches_reference_layer(B, T, H, K, hd, window,
                                                    q_chunk, dtype):
    (jq, jk, jv), (tq, tk, tv) = _qkv(B, T, H, K, hd, dtype, seed=2)
    got = TL.windowed_attention(tq, tk, tv, window, q_chunk=q_chunk)
    want = JL.windowed_attention(jq, jk, jv, window, q_chunk=q_chunk)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_query_offset_matches_reference_layer():
    """Queries past the keys' start (``q_offset``), plain version only."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, 32, 2, 1, 16, "float32", seed=3,
                                      S=48)
    got = TL.windowed_attention(tq, tk, tv, 8, q_chunk=16, q_offset=16)
    want = JL.windowed_attention(jq, jk, jv, 8, q_chunk=16, q_offset=16)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)


def test_cpu_wrapper_is_the_plain_version_and_launches_nothing():
    _, (tq, tk, tv) = _qkv(2, 70, 4, 1, 32, "bfloat16", seed=4)
    SWA.reset_launch_counts()
    got = SWA.swa_attention(tq, tk, tv, 16, q_chunk=32)
    assert torch.equal(got, TR.swa_attention_ref(tq, tk, tv, 16, q_chunk=32))
    assert SWA.swa_attention.launches == 0


def test_wrapper_rejects_what_no_path_can_take():
    _, (tq, tk, tv) = _qkv(1, 8, 4, 2, 16, "float32")
    with pytest.raises(ValueError, match="do not pair"):
        SWA.swa_attention(tq, tk[..., :8], tv[..., :8], 4)
    with pytest.raises(ValueError, match="do not pair"):
        SWA.swa_attention(tq[:, :, :3], tk, tv, 4)
    with pytest.raises(ValueError, match="two equal"):
        SWA.swa_attention(tq, tk, tv[:, :4], 4)
    with pytest.raises(ValueError, match="window"):
        SWA.swa_attention(tq, tk, tv, -1)
    with pytest.raises(ValueError, match="several devices"):
        SWA.swa_attention(tq, tk, tv.to("meta"), 4)


@pytest.mark.parametrize("grad_on", [False, True])
@pytest.mark.parametrize("requires", [None, 0, 1, 2])
def test_autograd_guard_fires_only_with_grad_on_and_an_input_requiring_grad(
        grad_on, requires):
    """Autograd records the windowed attention only with grad on and one
    of q/k/v requiring grad.  The CUDA kernels refused exactly that case
    until their derivative kernels were written; now the autograd
    Function every CUDA call runs through (here on CPU tensors, its
    launches taking the plain versions) records it, as the plain version
    on the CPU does, and otherwise runs the forward alone."""
    _, qkv = _qkv(1, 8, 2, 1, 16, "float32", seed=5)
    if requires is not None:
        qkv[requires].requires_grad_()
    recorded = grad_on and requires is not None
    with torch.set_grad_enabled(grad_on):
        for out in (SWA._SwaAttention.apply(*qkv, 4, False),
                    SWA.swa_attention(*qkv, 4)):
            assert (out.grad_fn is not None) == recorded
            assert out.requires_grad == recorded


def test_cpu_wrapper_stays_differentiable_as_the_reference_layer():
    """On the CPU the wrapper is the plain version, and its gradients
    match the reference layer's (jax.vjp) within 2e-5."""
    import jax
    (jq, jk, jv), qkv = _qkv(1, 48, 4, 2, 16, "float32", seed=6)
    cot = np.random.default_rng(7).normal(size=(1, 48, 4, 16)).astype(
        np.float32)
    for t in qkv:
        t.requires_grad_()
    out = SWA.swa_attention(*qkv, 8, q_chunk=16)
    out.backward(torch.from_numpy(cot))
    _, vjp = jax.vjp(lambda q, k, v: JL.windowed_attention(
        q, k, v, 8, q_chunk=16), jq, jk, jv)
    for got, want in zip(qkv, vjp(jnp.asarray(cot))):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   atol=2e-5, rtol=2e-5)
