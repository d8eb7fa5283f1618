"""Port parity: the sequence-training loss specs.

CE, MMI and MPE ``value`` (both accumulator modes for the lattice
losses), ``logit_grad``, ``gn_vp`` and ``fisher_vp`` of
``repro_torch.losses.sequence`` against ``repro.losses.sequence`` on the
same logits, direction and batch (``data.synthetic.asr_batch`` from one
seed in both packages; the port's batch must equal the reference's
bitwise).  The port's lattice losses run on the ``cuda`` backend (the
kernels' plain versions on CPU tensors, sausage dispatch) and on
``levelized``; the reference on its ``levelized`` backend.

Tolerance: rtol 1e-4, atol 1e-6 — f32 values and per-frame factors of
size 1e-3..1; the lattice statistics sum in other orders.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.data.synthetic import asr_batch as jax_batch  # noqa: E402
from repro.losses import sequence as JS  # noqa: E402
from repro_torch.data.synthetic import asr_batch  # noqa: E402
from repro_torch.losses import sequence as TS  # noqa: E402

RTOL, ATOL = 1e-4, 1e-6
KAPPA = 0.5
K = 20
SPECS = ("ce", "mmi", "mpe")


@pytest.fixture(scope="module")
def data():
    jb = jax_batch(5, batch=4, num_frames=24, num_states=K, input_dim=8)
    tb = asr_batch(5, batch=4, num_frames=24, num_states=K, input_dim=8,
                   device="cpu")
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 2, (4, 24, K)).astype(np.float32)
    u = rng.normal(size=(4, 24, K)).astype(np.float32)
    return jb, tb, logits, u


def test_batches_match_bitwise(data):
    jb, tb, _, _ = data
    np.testing.assert_array_equal(tb["feats"].numpy(), np.asarray(jb["feats"]))
    for f in jb["lattice"]._fields:
        np.testing.assert_array_equal(
            getattr(tb["lattice"], f).numpy(),
            np.asarray(getattr(jb["lattice"], f)), err_msg=f)


def _specs(name, backend):
    if name == "ce":
        return JS.CELoss(), TS.CELoss()
    return (JS.get_loss(name, kappa=KAPPA, backend="levelized"),
            TS.get_loss(name, kappa=KAPPA, backend=backend))


@pytest.mark.parametrize("backend", ["cuda", "levelized"])
@pytest.mark.parametrize("name", SPECS)
def test_value_matches_jax(data, name, backend):
    jb, tb, logits, _ = data
    js, ts = _specs(name, backend)
    for acc in ("full", "loss_only"):
        jl, jm = js.value(jnp.asarray(logits), jb, accumulators=acc)
        tl, tmet = ts.value(torch.from_numpy(logits), tb, accumulators=acc)
        np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL,
                                   atol=ATOL)
        assert set(tmet) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(tmet[k]), float(jm[k]),
                                       rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("backend", ["cuda", "levelized"])
@pytest.mark.parametrize("name", SPECS)
def test_logit_grad_and_factors_match_jax(data, name, backend):
    jb, tb, logits, u = data
    js, ts = _specs(name, backend)
    jl, tl = jnp.asarray(logits), torch.from_numpy(logits)
    ju, tu = jnp.asarray(u), torch.from_numpy(u)
    pairs = ((js.logit_grad(jl, jb), ts.logit_grad(tl, tb)),
             (js.gn_vp(jl, jb, ju), ts.gn_vp(tl, tb, tu)),
             (js.fisher_vp(jl, jb, ju), ts.fisher_vp(tl, tb, tu)))
    for want, got in pairs:
        want = np.asarray(want)
        scale = np.abs(want).max()
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                                   atol=ATOL * max(scale, 1.0))


def test_unknown_loss_raises():
    with pytest.raises(ValueError, match="mpe"):
        TS.get_loss("ctc")
