"""Port parity: the vocab-chunked LM cross-entropy, its curvature factors,
the synthetic token pipeline and the CG sub-batch.

``losses.chunked_lm.ChunkedCELoss`` against the reference's on the same
numpy-seeded (hidden, W, labels) and tangents: the value and accuracy,
the autograd gradient through the recomputing backward, and the
Gauss-Newton and Fisher factors, relative max 1e-5 (f32 on both sides,
sums in another order).  ``lm_batch`` is bitwise the reference's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data.synthetic import lm_batch as jbatch  # noqa: E402
from repro.launch.steps import cg_sub_batch as jsub  # noqa: E402
from repro.losses.chunked_lm import ChunkedCELoss as JLoss  # noqa: E402
from repro_torch.data.synthetic import lm_batch  # noqa: E402
from repro_torch.launch.steps import cg_sub_batch  # noqa: E402
from repro_torch.losses.chunked_lm import ChunkedCELoss, _chunks  # noqa: E402

TOL = 1e-5
V, D = 512, 64


def _rel(got, want):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _inputs(B, T, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, T, D)).astype(np.float32)
    W = (rng.normal(size=(D, V)) * 0.3).astype(np.float32)
    y = rng.integers(0, V, size=(B, T)).astype(np.int32)
    uh = rng.normal(size=(B, T, D)).astype(np.float32)
    uW = (rng.normal(size=(D, V)) * 0.1).astype(np.float32)
    j = [jnp.asarray(a) for a in (h, W, y, uh, uW)]
    t = [torch.from_numpy(a) for a in (h, W, y, uh, uW)]
    return j, t


CASES = [(2, 12, 256), (3, 20, 8), (2, 21, 6), (1, 7, 256)]


def test_chunks_is_the_largest_divisor():
    for T, tc in ((448, 256), (12, 256), (21, 6), (13, 4), (4096, 256)):
        c = _chunks(T, tc)
        assert T % c == 0 and c <= tc
        assert all(T % k for k in range(c + 1, min(tc, T) + 1))
    assert _chunks(448, 256) == 224


@pytest.mark.parametrize("B,T,t_chunk", CASES)
def test_value_and_gradient_match(B, T, t_chunk):
    (jh, jW, jy, _, _), (th, tW, ty, _, _) = _inputs(B, T)
    jl = JLoss(t_chunk=t_chunk)
    tl = ChunkedCELoss(t_chunk=t_chunk)
    jv, jm = jl.value((jh, jW), {"labels": jy})
    th.requires_grad_(True)
    tW.requires_grad_(True)
    tv, tm = tl.value((th, tW), {"labels": ty}, accumulators="loss_only")
    assert _rel(tv, jv) <= TOL and _rel(tm["ce"], jm["ce"]) <= TOL
    assert float(tm["acc"]) == float(jm["acc"])
    gh, gW = torch.autograd.grad(tv, (th, tW))
    jgh, jgW = jax.grad(lambda h, W: jl.value((h, W), {"labels": jy})[0],
                        argnums=(0, 1))(jh, jW)
    assert _rel(gh, jgh) <= TOL and _rel(gW, jgW) <= TOL


def test_gradient_at_bf16_hidden_keeps_dtypes():
    (jh, jW, jy, _, _), (th, tW, ty, _, _) = _inputs(2, 16)
    th = th.to(torch.bfloat16).requires_grad_(True)
    tW.requires_grad_(True)
    tv, _ = ChunkedCELoss(t_chunk=8).value((th, tW), {"labels": ty})
    gh, gW = torch.autograd.grad(tv, (th, tW))
    assert gh.dtype == torch.bfloat16 and gW.dtype == torch.float32
    jv, _ = JLoss(t_chunk=8).value((jh.astype(jnp.bfloat16), jW),
                                   {"labels": jy})
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-2)


@pytest.mark.parametrize("kind", ["gn_vp", "fisher_vp"])
@pytest.mark.parametrize("B,T,t_chunk", CASES)
def test_curvature_factors_match(B, T, t_chunk, kind):
    (jh, jW, jy, juh, juW), (th, tW, ty, tuh, tuW) = _inputs(B, T, seed=1)
    want = getattr(JLoss(t_chunk=t_chunk), kind)((jh, jW), {"labels": jy},
                                                 (juh, juW))
    got = getattr(ChunkedCELoss(t_chunk=t_chunk), kind)(
        (th, tW), {"labels": ty}, (tuh, tuW))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert _rel(g, w) <= TOL


def test_gn_factor_is_the_loss_hessian_through_the_head():
    """Cross-check without the reference: uᵀ (GN u) over the chunked
    factor equals the softmax-Hessian quadratic form of the full logits'
    JVP, and the Fisher factor is PSD."""
    _, (th, tW, ty, tuh, tuW) = _inputs(2, 6, seed=2)
    loss = ChunkedCELoss(t_chunk=4)
    ch, cW = loss.gn_vp((th, tW), {"labels": ty}, (tuh, tuW))
    quad = float((ch * tuh).sum() + (cW * tuW).sum())
    a = th @ tW
    ja = tuh @ tW + th @ tuW
    p = torch.softmax(a, -1)
    want = float(((p * ja * ja).sum(-1) - (p * ja).sum(-1) ** 2).sum()) / 12
    assert quad == pytest.approx(want, rel=1e-5)
    fh, fW = loss.fisher_vp((th, tW), {"labels": ty}, (tuh, tuW))
    assert float((fh * tuh).sum() + (fW * tuW).sum()) >= 0.0


@pytest.mark.parametrize("seed,batch,seq_len,vocab", [
    (0, 8, 32, 512), (7, 3, 5, 51865), (12, 16, 448, 51865)])
def test_lm_batch_is_the_reference_batch(seed, batch, seq_len, vocab):
    want = jbatch(seed, batch=batch, seq_len=seq_len, vocab=vocab)
    got = lm_batch(seed, batch=batch, seq_len=seq_len, vocab=vocab,
                   device="cpu")
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert torch.equal(got["tokens"][:, 1:], got["labels"][:, :-1])


@pytest.mark.parametrize("B,frac,min_size", [(16, 4, 1), (8, 8, 1),
                                             (3, 8, 2), (16, 4, 8)])
def test_cg_sub_batch_is_the_reference_slice(B, frac, min_size):
    rng = np.random.default_rng(B)
    toks = rng.integers(0, 10, size=(B, 5)).astype(np.int32)
    enc = rng.normal(size=(B, 4, 3)).astype(np.float32)
    other = rng.normal(size=(B + 1, 2)).astype(np.float32)
    want = jsub({"tokens": jnp.asarray(toks), "encoder_input":
                 jnp.asarray(enc), "other": jnp.asarray(other)},
                frac, min_size)
    got = cg_sub_batch({"tokens": torch.from_numpy(toks), "encoder_input":
                        torch.from_numpy(enc),
                        "other": torch.from_numpy(other)}, frac, min_size)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
