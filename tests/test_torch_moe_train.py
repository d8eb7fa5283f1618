"""Port parity: LM training of the MoE archs through
``launch.steps.build_step`` and the training CLI, at smoke size (4
experts, top-2) and f32 compute, on the CPU.

  * One NGHF update (4 CG, 2 NG iterations, the share-counts
    preconditioner, ``cg_frac=4``) of granite-moe-3b-a800m's smoke model,
    fused and unfused CG and with the dispatch FFN, and of mixtral-8x22b's
    (its windowed attention through the plain version, which autograd
    differentiates on the CPU), from the same parameters (the reference's
    tree, norm scales perturbed, carried across by
    ``convert.lm_params_from_numpy``) and the same ``lm_batch``: the same
    ``cg_best_iter``, ``cg_accepted`` and ``cg_iters_used``; candidate
    losses within 1e-4 relative; Δθ within relative L2 1e-4 (f32 on both
    sides, sums in other orders carried through 6 curvature products), as
    ``tests/test_torch_dense_train.py``.  The load-balance aux enters the
    gradient stage and the candidates: ``loss`` = CE + router_aux_coef ·
    aux on the gradient batch, and the Δθ=0 candidate's loss is CE + that
    aux term on the CG batch.
  * ``share_counts`` over granite's full-size tree: the expert matrices
    top_k / E = 0.2, the tied table 2, every other leaf (the router
    included) 1, as the reference's.
  * The CLI trains granite's smoke model for 2 steps and mixtral-8x22b's
    for one (its windowed attention has a backward on the card since
    ROADMAP 1.3.3).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import get_config as jget  # noqa: E402
from repro.data.synthetic import lm_batch as jbatch  # noqa: E402
from repro.launch.steps import build_step as jbuild  # noqa: E402
from repro.launch.steps import cg_sub_batch as jsub  # noqa: E402
from repro.models.registry import get_model as jmodel  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as TCB  # noqa: E402
from repro_torch.data.synthetic import lm_batch  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.steps import build_step, cg_sub_batch  # noqa: E402
from repro_torch.launch.steps import lm_forward  # noqa: E402
from repro_torch.losses.chunked_lm import ChunkedCELoss  # noqa: E402
from repro_torch.models.registry import get_model as tmodel  # noqa: E402
from torch_perturb import perturb  # noqa: E402

B, T = 8, 32
DELTA_REL_L2 = 1e-4
LOSS_RTOL = 1e-4
EXACT = ("cg_best_iter", "cg_accepted", "cg_iters_used")
NGHF = dict(cg_iters=4, ng_iters=2)
GRANITE = "granite-moe-3b-a800m"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    return (jget(arch).smoke().replace(compute_dtype="float32", **kw),
            TCB.get_config(arch).smoke().replace(compute_dtype="float32",
                                                 **kw))


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


@pytest.mark.parametrize("arch,impl,fused", [
    (GRANITE, "dense", True), (GRANITE, "dense", False),
    (GRANITE, "dispatch", True), ("mixtral-8x22b", "dense", True)],
    ids=["granite-fused", "granite-unfused", "granite-dispatch",
         "mixtral-fused"])
def test_nghf_update_matches_the_reference(arch, impl, fused):
    jcfg, tcfg = _cfgs(arch, moe_impl=impl)
    jp = perturb(jmodel(jcfg).init(jax.random.PRNGKey(0)), 1)
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                      device="cpu")
    jb = jbatch(0, batch=B, seq_len=T, vocab=jcfg.vocab_size)
    tb = lm_batch(0, batch=B, seq_len=T, vocab=tcfg.vocab_size, device="cpu")
    _, jopt = jbuild(jcfg, "nghf", cg_frac=4, cg_fused=fused, **NGHF)
    _, topt = build_step(tcfg, "nghf", cg_frac=4, cg_fused=fused, **NGHF)
    jb = dict(jb, labels=jb["tokens"])
    tb = dict(tb, labels=tb["tokens"])
    new_j, _, mj = jax.jit(lambda p: jopt.step(p, jopt.init(p), jb,
                                               jsub(jb, 4, 1)))(jp)
    new_t, st, mt = topt.step(tp, topt.init(tp), tb, cg_sub_batch(tb, 4, 1))
    assert int(st["step"]) == 1
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               rtol=1e-5)
    for key in EXACT:
        assert float(mt[key]) == float(mj[key]), key
    np.testing.assert_allclose(mt["cg_losses"].numpy(),
                               np.asarray(mj["cg_losses"]), rtol=LOSS_RTOL)
    assert bool(mt["cg_accepted"]) == bool(
        mt["cg_best_loss"] < mt["cg_base_loss"])
    assert _delta_rel_l2(new_t, tp, new_j, jp) <= DELTA_REL_L2
    # the aux is in the gradient stage's loss and in the candidates' (the
    # Δθ=0 candidate on the CG batch)
    fwd = lm_forward(tcfg, tmodel(tcfg))
    _, aux = fwd(tp, tb)
    assert float(aux) > 0
    np.testing.assert_allclose(float(mt["loss"]) - float(mt["ce"]),
                               float(aux), rtol=1e-4)
    cb = cg_sub_batch(tb, 4, 1)
    out, aux_cg = fwd(tp, cb)
    np.testing.assert_allclose(
        float(mt["cg_base_loss"]),
        float(ChunkedCELoss().value(out, cb)[0] + aux_cg), rtol=1e-5)
    assert not torch.equal(new_t["periods.slot0.moe.router"],
                           tp["periods.slot0.moe.router"]) \
        or not bool(mt["cg_accepted"])


def test_share_counts_of_the_experts_match_the_reference():
    for cfg_j, cfg_t in (_cfgs(GRANITE), (jget(GRANITE),
                                          TCB.get_config(GRANITE))):
        jm = jmodel(cfg_j)
        want = _flat(jm.share_counts(jm.param_shapes()))
        tm = tmodel(cfg_t)
        got = tm.share_counts(tm.param_shapes())
        # the reference's expert counts are f32 0.2
        assert got == pytest.approx({k: float(v) for k, v in want.items()},
                                    rel=1e-7)
    assert {k: c for k, c in got.items() if c != 1.0} == {
        "embed.table": 2.0, "periods.slot0.moe.w_in": 0.2,
        "periods.slot0.moe.w_gate": 0.2, "periods.slot0.moe.w_out": 0.2}
    assert got["periods.slot0.moe.router"] == 1.0


def test_cli_trains_granite_and_refuses_mixtral():
    log = ttrain.main(["--arch", GRANITE, "--smoke", "--device", "cpu",
                       "--steps", "2", "--batch", "4", "--seq", "16",
                       "--cg-iters", "3", "--ng-iters", "1", "--cg-fused"])
    assert [m["step"] for m in log] == [0, 1]
    assert all(np.isfinite(v) for m in log for v in m.values())
    for m in log:
        assert m["loss"] > m["ce"]            # the aux is in the loss
        if m["cg_accepted"]:
            assert m["cg_best_loss"] < m["cg_base_loss"]
    # mixtral-8x22b was refused until its windowed attention had a
    # backward on the card (ROADMAP 1.3.3); now it trains, its aux in the
    # loss as granite's
    log = ttrain.main(["--arch", "mixtral-8x22b", "--smoke", "--device",
                       "cpu", "--steps", "1", "--batch", "4", "--seq", "32",
                       "--cg-iters", "2", "--ng-iters", "1"])
    assert [m["step"] for m in log] == [0]
    assert all(np.isfinite(v) for v in log[0].values())
    assert log[0]["loss"] > log[0]["ce"]
