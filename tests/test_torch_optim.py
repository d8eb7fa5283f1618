"""Port parity: optimiser state across updates, the first-order
baselines, and the training driver on the CPU.

  * Two consecutive NGHF updates with the ``fisher_diag`` preconditioner,
    ``warm_start`` and ``adapt_lam`` — the port's stateful optimiser
    against the reference's ``core.optim.get_optimizer`` — so the carried
    state (λ, the previous Δθ, the Fisher-diagonal EMA and its count) is
    compared after each update.  Same exact-match keys and Δθ rel-L2
    bound as ``test_torch_nghf.py``; state within rtol 1e-4.
  * bf16 CG state (``state_dtype="bfloat16"``, fused CG on both sides):
    same selected candidate as the reference; Δθ within rel-L2 5e-2
    (bf16 rounds at 2^-8 per stored vector; the reference's own fused
    and unfused bf16 paths differ by rel-L2 2.2e-2 on this case, the
    port's fused path from the reference's by 1.8e-2).
  * ``curvature_mode="linearize"`` (``torch.func.linearize`` + one reused
    pullback) against the default ``rematvp`` within the port (rel-L2 1e-5).
  * One SGD and one Adam step against the reference: Δθ rel-L2 1e-4
    (Adam's first step is lr·g/(|g|+ε), which turns the f32 noise of
    the tiniest gradient entries into O(lr) differences of a few
    elements).
  * ``train_sequence(..., device="cpu", steps=2)`` on the smoke config
    raises the MPE accuracy of its CG batch; a mesh larger than the run
    raises, as does a state sharding that is not one, and the card path
    without a card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.acoustic import LSTM  # noqa: E402
from repro.core import optim as joptim  # noqa: E402
from repro.data.synthetic import asr_batch as jax_batch  # noqa: E402
from repro.losses.sequence import MPELoss  # noqa: E402
from repro.models import acoustic as JA  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.acoustic import LSTM as TLSTM  # noqa: E402
from repro_torch.data.synthetic import asr_batch  # noqa: E402
from repro_torch.launch.steps import build_sequence_step  # noqa: E402
from repro_torch.losses.sequence import get_loss  # noqa: E402
from repro_torch.models import acoustic as TA  # noqa: E402

CFG, TCFG = LSTM.smoke(), TLSTM.smoke()
KAPPA = 0.5
DELTA_REL_L2 = 1e-4
EXACT = ("cg_best_iter", "cg_accepted", "cg_iters_used")


def _batches(mod_batch, n, **kw):
    return [mod_batch(i, batch=8, num_frames=24, num_states=CFG.num_outputs,
                      input_dim=CFG.input_dim, **kw) for i in range(n)]


@pytest.fixture(scope="module")
def setup():
    jp = JA.init_params(CFG, jax.random.PRNGKey(1))
    tp = convert.acoustic_params_from_numpy(jax.tree.map(np.asarray, jp),
                                            device="cpu")
    return jp, tp, _batches(jax_batch, 4), _batches(asr_batch, 4,
                                                     device="cpu")


def _jfwd(p, b):
    return JA.forward(CFG, p, b["feats"]), 0.0


def _flat(tree) -> dict:
    return {f"{k}.{n}": np.asarray(a) for k, v in tree.items()
            for n, a in v.items()}


def _rel_l2(got: dict, want: dict) -> float:
    num = sum(float(((got[k].float().numpy() - want[k]) ** 2).sum())
              for k in want)
    den = sum(float((want[k] ** 2).sum()) for k in want)
    return (num / max(den, 1e-30)) ** 0.5


def _delta(new: dict, old: dict) -> dict:
    return {k: new[k] - old[k] for k in old}


def test_stateful_updates_match_jax(setup):
    jp, tp, jb, tb = setup
    kw = dict(cg_iters=5, ng_iters=2, preconditioner="fisher_diag",
              warm_start=True, adapt_lam=True)
    jopt = joptim.get_optimizer("nghf", _jfwd, MPELoss(kappa=KAPPA), **kw)
    jstep = jax.jit(jopt.step)
    step, opt = build_sequence_step(TCFG, "nghf", loss="mpe", kappa=KAPPA,
                                    backend="cuda", **kw)
    jstate, tstate = jopt.init(jp), opt.init(tp)
    for u in range(2):
        new_j, jstate, mj = jstep(jp, jstate, jb[2 * u], jb[2 * u + 1])
        new_t, tstate, mt = step(tp, tstate, tb[2 * u], tb[2 * u + 1])
        for key in EXACT:
            assert float(mt[key]) == float(mj[key]), (u, key)
        dj = {k: v - _flat(jp)[k] for k, v in _flat(new_j).items()}
        assert _rel_l2(_delta(new_t, tp), dj) <= DELTA_REL_L2
        np.testing.assert_allclose(float(tstate["lam"]),
                                   float(jstate["lam"]), rtol=1e-4)
        assert int(tstate["step"]) == int(jstate["step"]) == u + 1
        assert int(tstate["precond"]["n"]) == int(jstate["precond"]["n"])
        assert _rel_l2(tstate["precond"]["d"],
                       _flat(jstate["precond"]["d"])) <= 1e-4
        assert _rel_l2(tstate["delta"], _flat(jstate["delta"])) \
            <= DELTA_REL_L2
        np.testing.assert_allclose(float(mt["cg_rho"]), float(mj["cg_rho"]),
                                   rtol=1e-3)
        jp, tp = new_j, new_t


def test_bf16_state_matches_jax(setup):
    jp, tp, jb, tb = setup
    kw = dict(cg_iters=5, ng_iters=2, state_dtype="bfloat16",
              cg_fused=True)
    jopt = joptim.get_optimizer("nghf", _jfwd, MPELoss(kappa=KAPPA), **kw)
    new_j, _, mj = jax.jit(jopt.step)(jp, jopt.init(jp), jb[0], jb[1])
    step, opt = build_sequence_step(TCFG, "nghf", loss="mpe", kappa=KAPPA,
                                    backend="cuda", **kw)
    new_t, _, mt = step(tp, opt.init(tp), tb[0], tb[1])
    for key in EXACT:
        assert float(mt[key]) == float(mj[key]), key
    dj = {k: v - _flat(jp)[k] for k, v in _flat(new_j).items()}
    assert _rel_l2(_delta(new_t, tp), dj) <= 5e-2


def test_linearize_mode_matches_rematvp(setup):
    _, tp, _, tb = setup
    out = {}
    for mode in ("rematvp", "linearize"):
        step, opt = build_sequence_step(TCFG, "hf", loss="mpe", kappa=KAPPA,
                                        backend="cuda", cg_iters=3,
                                        curvature_mode=mode)
        new, _, m = step(tp, opt.init(tp), tb[0], tb[1])
        out[mode] = (_delta(new, tp), m)
    (d_r, m_r), (d_l, m_l) = out["rematvp"], out["linearize"]
    assert float(m_r["cg_best_iter"]) == float(m_l["cg_best_iter"])
    assert _rel_l2(d_l, {k: v.numpy() for k, v in d_r.items()}) <= 1e-5


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_first_order_step_matches_jax(setup, name):
    jp, tp, jb, tb = setup
    kw = dict(lr=0.05, momentum=0.9) if name == "sgd" else dict(lr=1e-2)
    jopt = joptim.get_optimizer(name, _jfwd, MPELoss(kappa=KAPPA), **kw)
    new_j, jstate, mj = jax.jit(jopt.step)(jp, jopt.init(jp), jb[0])
    step, opt = build_sequence_step(TCFG, name, loss="mpe", kappa=KAPPA,
                                    backend="cuda", **kw)
    new_t, tstate, mt = step(tp, opt.init(tp), tb[0])
    dj = {k: v - _flat(jp)[k] for k, v in _flat(new_j).items()}
    assert _rel_l2(_delta(new_t, tp), dj) <= 1e-4
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               rtol=1e-5)
    assert int(tstate["step"]) == int(jstate["step"]) == 1


def test_train_sequence_raises_mpe_accuracy_on_cpu():
    from repro_torch.launch.train import train_sequence
    kw = dict(arch="lstm-asr", smoke=True, optimizer="nghf", loss="mpe",
              batch=8, cg_batch=8, frames=24, device="cpu", verbose=False)
    p0, _ = train_sequence(steps=0, **kw)
    p2, log = train_sequence(steps=2, **kw)
    assert len(log) == 2 and all(np.isfinite(m["loss"]) for m in log)
    assert any(m["cg_accepted"] for m in log)
    # MPE accuracy on update 0's CG batch, before and after
    cb = asr_batch(1_000_000, batch=8, num_frames=24, num_states=20,
                   input_dim=8, device="cpu")
    spec = get_loss("mpe", kappa=KAPPA)
    accs = [float(spec.value(TA.forward(TCFG, p, cb["feats"]), cb)[1][
        "mpe_acc"]) for p in (p0, p2)]
    assert accs[1] > accs[0], accs


def test_later_slices_raise_not_implemented(setup):
    """No fallback: a 4x2 mesh in a run of one process raises (meshes
    run one process a rank, ``tests/test_torch_mesh_train.py``); a
    state sharding must be a dict of ``NamedSharding``."""
    from repro_torch.launch.train import train_sequence
    with pytest.raises(RuntimeError, match="needs 8 ranks"):
        train_sequence(arch="lstm-asr", smoke=True, steps=1, device="cpu",
                       verbose=False, mesh="4x2")
    with pytest.raises(TypeError, match="state_sharding"):
        build_sequence_step(TCFG, "nghf", state_sharding=object())
    with pytest.raises(RuntimeError, match="cpu"):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        train_sequence(arch="lstm-asr", smoke=True, steps=1, verbose=False)
