"""Port parity: the acoustic models.

RNN, LSTM and TDNN forwards of ``repro_torch.models.acoustic`` against
``repro.models.acoustic`` on the same parameters (the JAX pytree carried
across by ``convert.acoustic_params_from_numpy``) and features;
``share_counts`` per leaf; and the R-operator — ``torch.func.jvp`` of the
LSTM forward against ``jax.jvp`` — which the curvature products rest on.

Tolerance: atol 1e-5 (rtol 1e-5) on logits of O(1): f32 on both sides;
the port projects each frame's input before the time loop, which sums
``x_t @ w_x + h @ w_h`` in another order than the reference's
``concat(x_t, h) @ w``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.acoustic import LSTM, RNN_RELU, TDNN_SIGMOID  # noqa: E402
from repro.models import acoustic as JA  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import acoustic as TC  # noqa: E402
from repro_torch.models import acoustic as TA  # noqa: E402

RTOL, ATOL = 1e-5, 1e-5
CONFIGS = {"lstm": (LSTM, TC.LSTM), "rnn-relu": (RNN_RELU, TC.RNN_RELU),
           "tdnn": (TDNN_SIGMOID, TC.TDNN_SIGMOID)}


def _setup(name, seed=0):
    jcfg, tcfg = (c.smoke() for c in CONFIGS[name])
    jp = JA.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = convert.acoustic_params_from_numpy(jax.tree.map(np.asarray, jp),
                                            device="cpu")
    feats = np.random.default_rng(seed).normal(
        size=(3, 11, jcfg.input_dim)).astype(np.float32)
    return jcfg, tcfg, jp, tp, feats


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_matches_jax(name):
    jcfg, tcfg, jp, tp, feats = _setup(name)
    want = np.asarray(JA.forward(jcfg, jp, jnp.asarray(feats)))
    got = TA.forward(tcfg, tp, torch.from_numpy(feats))
    assert got.shape == want.shape == (3, 11, jcfg.num_outputs)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_share_counts_and_params_match_jax(name):
    jcfg, tcfg, jp, tp, _ = _setup(name)
    want = JA.share_counts(jcfg, jp)
    got = TA.share_counts(tcfg, tp)
    assert set(got) == {f"{k}.{n}" for k, v in want.items() for n in v}
    for key, c in got.items():
        layer, leaf = key.split(".")
        assert c == float(want[layer][leaf])
    init = TA.init_params(tcfg, seed=3, device="cpu")
    assert {k: tuple(v.shape) for k, v in init.items()} == \
        {k: tuple(v.shape) for k, v in tp.items()}
    assert TA.param_count(init) == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(jp))


def test_full_width_lstm_has_the_papers_parameter_count():
    shapes = TA.init_params(TC.LSTM.replace(num_outputs=6000), seed=0,
                            device="cpu")
    assert TA.param_count(shapes) == 19_335_000


def test_lstm_jvp_matches_jax():
    jcfg, tcfg, jp, tp, feats = _setup("lstm", seed=1)
    rng = np.random.default_rng(2)
    tangent = jax.tree.map(
        lambda x: rng.normal(size=x.shape).astype(np.float32), jp)
    x = jnp.asarray(feats)
    _, want = jax.jvp(lambda p: JA.forward(jcfg, p, x), (jp,), (tangent,))
    tt = convert.acoustic_params_from_numpy(tangent, device="cpu")
    xt = torch.from_numpy(feats)
    _, got = torch.func.jvp(lambda p: TA.forward(tcfg, p, xt), (tp,), (tt,))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
