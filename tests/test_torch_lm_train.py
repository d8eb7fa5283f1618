"""Port parity: LM training through ``launch.steps.build_step`` and the
training CLI, on whisper-base's smoke config (2 + 2 layers, d 128, 4
heads, vocab 512, 16 frames) at f32 compute, on the CPU.

  * One update from the same parameters (the JAX tree carried across by
    ``convert.lm_params_from_numpy``) and the same batch (``lm_batch``,
    bitwise equal in both packages, and a numpy-seeded
    ``encoder_input``), through each package's ``build_step`` optimiser
    with ``cg_frac=4``:
      - NGHF (4 CG, 2 NG iterations, the share-counts preconditioner),
        fused and unfused CG: the same ``cg_best_iter``, ``cg_accepted``
        and ``cg_iters_used``; candidate losses within 1e-4 relative; Δθ
        within relative L2 1e-4 (f32 on both sides, sums in other orders
        carried through 6 curvature products).  On the CPU the port's
        fused path runs ``cg_fused_update``'s plain version.
      - SGD: loss and Δθ within 1e-5.  Adam: loss and the moments m, v
        within 1e-5; Δθ within relative L2 1e-4 (the bound of
        ``test_torch_optim.py``'s one-step test): the first Adam step is
        lr g / (|g| + eps), which maps the gradients' 2e-6 relative
        disagreement on near-zero entries to O(1) relative changes there
        (measured 6.3e-5 overall).
  * The CLI ``main([...])``: 2 NGHF updates with a checkpoint, then
    ``--resume`` to 3, bitwise equal to an uninterrupted 3-update run
    (parameters, optimiser state and the logged metrics of update 2).
  * Train states across packages: the port's whisper Adam state (the
    CLI's checkpoint) loads in the reference, and the reference's loads in
    the port, every leaf equal.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint import io as jio  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
from repro.data.synthetic import lm_batch as jbatch  # noqa: E402
from repro.launch.steps import build_step as jbuild  # noqa: E402
from repro.launch.steps import cg_sub_batch as jsub  # noqa: E402
from repro.models.registry import get_model as jmodel  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import io as tio  # noqa: E402
from repro_torch.configs import base as TCB  # noqa: E402
from repro_torch.data.synthetic import lm_batch  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.steps import build_step, cg_sub_batch  # noqa: E402
from repro_torch.models.registry import get_model as tmodel  # noqa: E402

ARCH = "whisper-base"
B, T = 8, 32
DELTA_REL_L2 = 1e-4
LOSS_RTOL = 1e-4
FIRST_ORDER_TOL = 1e-5
ADAM_DELTA_REL_L2 = 1e-4
EXACT = ("cg_best_iter", "cg_accepted", "cg_iters_used")
CASES = {
    "nghf_fused": ("nghf", dict(cg_iters=4, ng_iters=2, cg_fused=True)),
    "nghf": ("nghf", dict(cg_iters=4, ng_iters=2)),
    "sgd": ("sgd", dict(lr=0.3)),
    "adam": ("adam", dict(lr=3e-4)),
}
CLI = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "4",
       "--seq", "16", "--cg-iters", "3", "--ng-iters", "1", "--cg-fused"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """PyTorch on one thread for this module: the smoke shapes gain
    nothing from more, and beside the suite's parallel workers the
    default thread pool oversubscribes the cores and multiplies the
    file's time."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    return (jget(ARCH).smoke().replace(compute_dtype="float32"),
            TCB.get_config(ARCH).smoke().replace(compute_dtype="float32"))


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _cfgs()
    jp = jmodel(jcfg).init(jax.random.PRNGKey(0))
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                      device="cpu")
    enc = np.random.default_rng(5).normal(
        size=(B, jcfg.encoder_frames, jcfg.d_model)).astype(np.float32)
    jb = dict(jbatch(0, batch=B, seq_len=T, vocab=jcfg.vocab_size),
              encoder_input=jax.numpy.asarray(enc))
    tb = dict(lm_batch(0, batch=B, seq_len=T, vocab=tcfg.vocab_size,
                       device="cpu"), encoder_input=torch.from_numpy(enc))
    return jp, tp, jb, tb


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(p, simple=True, separator="."):
            np.asarray(v) for p, v in
            jax.tree_util.tree_leaves_with_path(tree)}


def _delta_rel_l2(new_t, tp, new_j, jp) -> float:
    nj, pj = _flat(new_j), _flat(jp)
    num = den = 0.0
    for k, p in tp.items():
        dj = nj[k] - pj[k]
        num += float((((new_t[k] - p).numpy() - dj) ** 2).sum())
        den += float((dj ** 2).sum())
    return (num / max(den, 1e-30)) ** 0.5


@pytest.mark.parametrize("case", sorted(CASES))
def test_update_matches_the_reference(setup, case):
    jp, tp, jb, tb = setup
    jcfg, tcfg = _cfgs()
    name, kw = CASES[case]
    _, jopt = jbuild(jcfg, name, cg_frac=4, **kw)
    step, topt = build_step(tcfg, name, cg_frac=4, **kw)
    jcg = jsub(jb, 4, 1) if jopt.uses_cg_batch else None
    tcg = cg_sub_batch(tb, 4, 1) if topt.uses_cg_batch else None
    # the optimisers' own step, for the metrics the step's scalar view
    # drops (the candidate losses)
    new_j, sj, mj = jax.jit(lambda p: jopt.step(p, jopt.init(p), jb,
                                                jcg))(jp)
    new_t, st, mt = topt.step(tp, topt.init(tp), tb, tcg)
    assert int(st["step"]) == 1
    rel = _delta_rel_l2(new_t, tp, new_j, jp)
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               rtol=FIRST_ORDER_TOL)
    if name == "sgd":
        assert rel <= FIRST_ORDER_TOL
    elif name == "adam":
        zero = {k: torch.zeros_like(v) for k, v in tp.items()}
        for slot in ("m", "v"):
            assert _delta_rel_l2(st[slot], zero, sj[slot],
                                 jax.tree.map(np.zeros_like, sj[slot])) \
                <= FIRST_ORDER_TOL
        assert rel <= ADAM_DELTA_REL_L2
    else:
        for key in EXACT:
            assert float(mt[key]) == float(mj[key]), key
        np.testing.assert_allclose(mt["cg_losses"].numpy(),
                                   np.asarray(mj["cg_losses"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(mt["cg_best_loss"]),
                                   float(mj["cg_best_loss"]),
                                   rtol=LOSS_RTOL)
        assert bool(mt["cg_accepted"]) == bool(
            mt["cg_best_loss"] < mt["cg_base_loss"])
        assert rel <= DELTA_REL_L2
    # build_step's step is that update, with scalar metrics
    new_s, _, ms = step(tp, topt.init(tp), tb)
    assert all(torch.equal(new_s[k], new_t[k]) for k in tp)
    assert all(getattr(v, "ndim", 0) == 0 for v in ms.values())


def test_build_step_refuses_a_mesh_and_state_sharding():
    """``build_step`` trains on a mesh since ROADMAP 1.4 part 2
    (``tests/test_torch_mesh_lm.py``); it refuses a mesh without the
    state's sharding on it, and a sharding that is not a dict of
    ``NamedSharding``."""
    _, tcfg = _cfgs()
    with pytest.raises(ValueError, match="sharding on it"):
        build_step(tcfg, "nghf", mesh=object())
    with pytest.raises(TypeError, match="state_sharding"):
        build_step(tcfg, "nghf", state_sharding=object())


def _state(ck, opt):
    cfg = TCB.get_config(ARCH).smoke()
    params = tmodel(cfg).init(0, device="cpu")
    _, o = build_step(cfg, opt)
    return tio.load_train_state(ck, params, o.init(params))


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and torch.equal(a, b)


def test_cli_resume_is_bitwise(tmp_path, capsys):
    ck, whole = str(tmp_path / "ck"), str(tmp_path / "whole")
    lj = str(tmp_path / "log.json")
    first = ttrain.main(CLI + ["--ckpt-dir", ck, "--steps", "2"])
    assert [m["step"] for m in first] == [0, 1]
    assert all(np.isfinite(v) for m in first for v in m.values())
    for m in first:
        if m["cg_accepted"]:
            assert m["cg_best_loss"] < m["cg_base_loss"]
    resumed = ttrain.main(CLI + ["--ckpt-dir", ck, "--steps", "3",
                                 "--resume", "--log-json", lj])
    assert "resumed from step 2" in capsys.readouterr().out
    assert [m["step"] for m in resumed] == [2]
    with open(lj) as f:
        assert json.load(f) == resumed
    straight = ttrain.main(CLI + ["--ckpt-dir", whole, "--steps", "3"])
    skip = ("time_s",)
    assert {k: v for k, v in resumed[0].items() if k not in skip} == \
        {k: v for k, v in straight[2].items() if k not in skip}
    p1, s1, n1 = _state(ck, "nghf")
    p2, s2, n2 = _state(whole, "nghf")
    assert n1 == n2 == 3 and _same(p1, p2) and _same(s1, s2)


def test_train_states_load_across_packages(tmp_path):
    """Adam (θ-sized m and v): the port's CLI checkpoint in the
    reference, and the reference's train state in the port."""
    ck = str(tmp_path / "port")
    ttrain.main(CLI + ["--optimizer", "adam", "--steps", "1",
                       "--ckpt-dir", ck])
    tparams, tstate, step = _state(ck, "adam")
    jcfg = jget(ARCH).smoke()
    jp = jmodel(jcfg).init(jax.random.PRNGKey(1))
    _, jopt = jbuild(jcfg, "adam")
    got_p, got_s, jstep = jio.load_train_state(ck, jp, jopt.init(jp))
    assert jstep == step == 1
    for k, v in _flat(got_p).items():
        np.testing.assert_array_equal(v, tparams[k].numpy())
    for slot in ("m", "v"):
        for k, v in _flat(got_s[slot]).items():
            np.testing.assert_array_equal(v, tstate[slot][k].numpy())
            assert np.any(v != 0)
    assert int(got_s["step"]) == int(tstate["step"]) == 1
    # the reference's state (its own draws) into the port
    rng = np.random.default_rng(3)
    jstate = jax.tree.map(
        lambda x: rng.normal(size=x.shape).astype(np.float32)
        if x.ndim else x, jopt.init(jp))
    jck = str(tmp_path / "ref")
    jio.save_train_state(jck, jp, jstate, step=4)
    tp2, ts2, n = _state(jck, "adam")
    assert n == 4
    for k, v in _flat(jp).items():
        np.testing.assert_array_equal(tp2[k].numpy(), v)
    for slot in ("m", "v"):
        for k, v in _flat(jstate[slot]).items():
            np.testing.assert_array_equal(ts2[slot][k].numpy(), v)


def test_cli_lm_smoke_trains_and_refuses_the_rest():
    log = ttrain.main(CLI + ["--steps", "2", "--optimizer", "nghf"])
    assert len(log) == 2 and all(np.isfinite(m["loss"]) for m in log)
    # since the windowed archs' slice every registered LM arch trains (the
    # CLI's choices are those); a name outside them is refused, naming
    # ROADMAP 1.3
    assert set(ttrain.LM_TRAIN_ARCHS) == set(TCB.list_archs())
    with pytest.raises(NotImplementedError, match="ROADMAP 1.3"):
        ttrain.train_lm(arch="no-such-arch", smoke=True, device="cpu")
    # since the xLSTM slice lm-xlstm-125m trains
    log = ttrain.main(["--arch", "lm-xlstm-125m", "--smoke", "--device",
                       "cpu", "--steps", "1", "--batch", "4", "--seq", "16",
                       "--cg-iters", "2", "--ng-iters", "1"])
    assert len(log) == 1 and all(np.isfinite(v) for v in log[0].values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cpu"):
            ttrain.main(["--arch", ARCH, "--smoke", "--steps", "1"])
