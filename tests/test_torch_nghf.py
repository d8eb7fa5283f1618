"""Port parity: one NG / HF / NGHF update on the paper's setting.

The LSTM smoke config (input 8, hidden 32, K 20) with lattice MPE, the
JAX parameters carried across with ``convert.acoustic_params_from_numpy``
and the same ``asr_batch`` seeds in both packages (bitwise-equal
batches): the port's ``launch.steps.build_sequence_step`` — the ``cuda``
lattice backend, i.e. the kernels' plain versions behind the occupancy
Functions on CPU tensors, unfused and fused CG — against the reference's
jitted ``second_order_update`` (the pattern of ``tests/test_nghf.py``).
Both must pick the same ``cg_best_iter``, ``cg_accepted`` and
``cg_iters_used``; metrics agree within rtol 1e-4; Δθ within rel-L2
1e-4 (measured about 1e-6: f32 on both sides, statistics and dot
products summed in other orders, carried through 5 CG iterations).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.acoustic import LSTM  # noqa: E402
from repro.core.nghf import SecondOrderConfig, second_order_update  # noqa: E402,E501
from repro.data.synthetic import asr_batch as jax_batch  # noqa: E402
from repro.losses.sequence import MPELoss  # noqa: E402
from repro.models import acoustic as JA  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.acoustic import LSTM as TLSTM  # noqa: E402
from repro_torch.data.synthetic import asr_batch  # noqa: E402
from repro_torch.launch.steps import build_sequence_step  # noqa: E402
from repro_torch.models import acoustic as TA  # noqa: E402

CFG, TCFG = LSTM.smoke(), TLSTM.smoke()
KAPPA = 0.5
DELTA_REL_L2 = 1e-4
METRIC_RTOL = 1e-4
EXACT = ("cg_best_iter", "cg_accepted", "cg_iters_used")
CASES = {"nghf": ("nghf", False), "nghf_fused": ("nghf", True),
         "ng": ("ng", False), "hf_fused": ("hf", True)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """PyTorch on one thread for this module: beside the suite's parallel
    workers the default thread pool oversubscribes the cores and
    multiplies the file's time."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(mod_batch, **kw):
    return [mod_batch(i, batch=8, num_frames=24, num_states=CFG.num_outputs,
                      input_dim=CFG.input_dim, **kw) for i in range(2)]


@pytest.fixture(scope="module")
def setup():
    jp = JA.init_params(CFG, jax.random.PRNGKey(0))
    tp = convert.acoustic_params_from_numpy(jax.tree.map(np.asarray, jp),
                                            device="cpu")
    return jp, tp, _batches(jax_batch), _batches(asr_batch, device="cpu")


def delta_rel_l2(new_t: dict, tp: dict, new_j, jp) -> float:
    num = den = 0.0
    for key, p in tp.items():
        layer, leaf = key.split(".")
        dj = np.asarray(new_j[layer][leaf]) - np.asarray(jp[layer][leaf])
        dt = (new_t[key] - p).numpy()
        num += float(((dt - dj) ** 2).sum())
        den += float((dj ** 2).sum())
    return (num / max(den, 1e-30)) ** 0.5


@pytest.mark.parametrize("case", sorted(CASES))
def test_update_matches_jax(setup, case):
    method, fused = CASES[case]
    jp, tp, (jgb, jcb), (tgb, tcb) = setup
    cfg = SecondOrderConfig(method=method, cg_iters=5, ng_iters=2,
                            cg_fused=fused)

    def fwd(p, b):
        return JA.forward(CFG, p, b["feats"]), 0.0

    new_j, mj = jax.jit(lambda p: second_order_update(
        fwd, MPELoss(kappa=KAPPA), cfg, p, jgb, jcb,
        share_counts=JA.share_counts(CFG, p)))(jp)
    step, opt = build_sequence_step(
        TCFG, method, loss="mpe", kappa=KAPPA, backend="cuda",
        share_counts=TA.share_counts(TCFG, tp), cg_iters=5, ng_iters=2,
        cg_fused=fused)
    new_t, state, mt = step(tp, opt.init(tp), tgb, tcb)
    for key in EXACT:
        assert float(mt[key]) == float(mj[key]), key
    for key in ("loss", "mpe_acc", "grad_norm", "update_norm",
                "cg_best_loss"):
        np.testing.assert_allclose(float(mt[key]), float(mj[key]),
                                   rtol=METRIC_RTOL, err_msg=key)
    assert delta_rel_l2(new_t, tp, new_j, jp) <= DELTA_REL_L2
    assert int(state["step"]) == 1
    assert mt["cg_host_syncs"] <= 5


def test_mid_size_update_matches_jax():
    """A wider LSTM (input 80, hidden 128, K 1000, T 48): the same
    candidate and acceptance as the reference at more than smoke width."""
    jcfg = LSTM.replace(hidden_dim=128, num_outputs=1000)
    tcfg = TLSTM.replace(hidden_dim=128, num_outputs=1000)
    jp = JA.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.acoustic_params_from_numpy(jax.tree.map(np.asarray, jp),
                                            device="cpu")
    kw = dict(num_frames=48, num_states=1000, input_dim=80, noise=1.2)
    jb = [jax_batch(s, batch=n, **kw) for s, n in ((0, 16), (1, 8))]
    tb = [asr_batch(s, batch=n, device="cpu", **kw)
          for s, n in ((0, 16), (1, 8))]
    cfg = SecondOrderConfig(method="nghf", cg_iters=6, ng_iters=2,
                            cg_fused=True)

    def fwd(p, b):
        return JA.forward(jcfg, p, b["feats"]), 0.0

    new_j, mj = jax.jit(lambda p: second_order_update(
        fwd, MPELoss(kappa=KAPPA), cfg, p, *jb,
        share_counts=JA.share_counts(jcfg, p)))(jp)
    step, opt = build_sequence_step(
        tcfg, "nghf", loss="mpe", kappa=KAPPA, backend="cuda",
        share_counts=TA.share_counts(tcfg, tp), cg_iters=6, ng_iters=2,
        cg_fused=True)
    new_t, _, mt = step(tp, opt.init(tp), *tb)
    for key in EXACT:
        assert float(mt[key]) == float(mj[key]), key
    assert delta_rel_l2(new_t, tp, new_j, jp) <= DELTA_REL_L2
