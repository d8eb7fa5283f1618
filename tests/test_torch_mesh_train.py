"""Port parity: the paper's data-parallel NGHF sequence training across
processes (``launch.mesh``, ``data.pipeline``, the mesh path of
``core.curvature`` and ``core.optim``, ``launch.train``'s ``mesh=``).

The reference's ``tests/test_sharding.py::test_sequence_step_matches_
single_device`` setting: the smoke LSTM at hidden 16, K 12, NGHF MPE with
2 CG and 1 NG iterations, gradient batch 8 (seed 0) and CG batch 4 (seed
1) at T 16.  One update runs on 4x1 and 2x2 gloo meshes (four CPU
processes, one thread each, ``tests/torch_mesh_worker.py``), against the
reference's single-device jitted ``build_sequence_step`` from the same
parameters and batches: parameters within atol 5e-5, loss within 1e-5,
the same ``cg_best_iter`` and acceptance (the reference test's
tolerances), and the best candidate's CG-batch loss within 1e-5 too.
Against the one-process port, the Δθ=0 baseline's loss within 1e-5, Δθ
within rel-L2 1e-5, and so is the last CG iterate of the same update
without candidate
selection, which a rejected update (Δθ = 0) would otherwise hide (both
measured 2.9e-7 to 5.1e-7 where accepted: the same f32 arithmetic, each
sum over the batch split into per-rank partials).  Every rank ends with
the same bits.

Cases: the plain update; ``curvature_sample=0.5`` on a CG batch of 8 (a
prefix of 4 rows of the GLOBAL batch, each data rank taking its share of
that prefix); a gradient batch of 6, which 4 data ranks cannot split
(kept whole on every rank and summed over none) and 2 can; and
``cg_fused=True`` (the per-leaf ``cg_fused_update_tree`` under a mesh,
the flat buffer in the reference).

An Adam step on the CE loss (the example's pretraining stage) on both
meshes against the one-process port: rel-L2 1e-5, loss 1e-5.

Also on two ranks: ``cg_fused_update_tree`` with a leaf split over them
against the unsplit plain version (x, r bitwise, rr rtol 1e-6), and a
``train_sequence`` run on a 2x1 mesh checkpointed after 2 updates (rank
0 writes) and resumed to 3, bitwise equal to the uninterrupted run.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import torch_mesh_worker as W  # noqa: E402
from repro.configs.acoustic import LSTM  # noqa: E402
from repro.core.optim import SecondOrderConfig  # noqa: E402
from repro.data.synthetic import asr_batch as jasr_batch  # noqa: E402
from repro.launch.steps import build_sequence_step as jbuild  # noqa: E402
from repro.models import acoustic as JA  # noqa: E402
from repro_torch import convert  # noqa: E402

JCFG = LSTM.smoke().replace(hidden_dim=16, num_outputs=12)
PARAM_ATOL = 5e-5
LOSS_ATOL = 1e-5
DELTA_REL_L2 = 1e-5
CASES = {"plain": dict(grad_batch=8, cg_batch=4),
         "sample": dict(grad_batch=8, cg_batch=8, curvature_sample=0.5),
         "b6": dict(grad_batch=6, cg_batch=4),
         "fused": dict(grad_batch=8, cg_batch=4, cg_fused=True)}
# a first-order step on the CE loss (the example's pretraining stage):
# its normaliser is the global mask sum; against the one-process port
FIRST_ORDER = {"adam_ce": dict(grad_batch=8, cg_batch=4, optimizer="adam",
                               loss="ce", lr=2e-3)}
MESHES = ("4x1", "2x2")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def start(tmp_path_factory):
    """(the reference's parameters, the port's, a directory holding them
    for the ranks)."""
    jp = JA.init_params(JCFG, jax.random.PRNGKey(0))
    tp = convert.acoustic_params_from_numpy(jax.tree.map(np.asarray, jp),
                                            device="cpu")
    tmp = tmp_path_factory.mktemp("mesh_params")
    np.savez(tmp / "params.npz", **{k: v.numpy() for k, v in tp.items()})
    return jp, tp, tmp


def _reference(jp, grad_batch, cg_batch, **overrides):
    """The reference's single-device jitted update: (new params by the
    port's keys, metrics)."""
    cfg = SecondOrderConfig(method="nghf", cg_iters=2, ng_iters=1,
                            **overrides)
    fn, opt = jbuild(JCFG, cfg, loss="mpe", kappa=W.KAPPA,
                     share_counts=JA.share_counts(JCFG, jp))
    kw = dict(num_frames=16, num_states=JCFG.num_outputs,
              input_dim=JCFG.input_dim)
    new, _, m = jax.jit(fn)(jp, opt.init(jp), jasr_batch(0, batch=grad_batch,
                                                         **kw),
                            jasr_batch(1, batch=cg_batch, **kw))
    flat = convert.acoustic_params_from_numpy(jax.tree.map(np.asarray, new),
                                              device="cpu")
    return {k: v.numpy() for k, v in flat.items()}, \
        {k: float(v) for k, v in m.items() if np.ndim(v) == 0}


@pytest.fixture(scope="module")
def runs(start, tmp_path_factory):
    """(per case: the reference's update, the one-process port's and the
    port's last CG iterate of it (no candidate selection); per mesh:
    every rank's results of every case).  The meshes' ranks run while
    this process computes the references."""
    jp, tp, params_dir = start
    started = {}
    for mesh in MESHES:
        tmp = tmp_path_factory.mktemp(f"mesh_{mesh}")
        (tmp / "params.npz").write_bytes((params_dir /
                                          "params.npz").read_bytes())
        started[mesh] = W.start("updates", 4, tmp, mesh=mesh,
                                cases=dict(CASES, **FIRST_ORDER))
    refs = {case: (_reference(jp, **kw), W.one_update(tp, None, **kw),
                   W.one_update(tp, None, eval_candidates=False, **kw))
            for case, kw in CASES.items()}
    return refs, {mesh: W.finish(h) for mesh, h in started.items()}


def _rel_l2(got: dict, want: dict, base: dict) -> float:
    num = sum(float(((got[k] - want[k]) ** 2).sum()) for k in base)
    den = sum(float(((want[k] - base[k].numpy()) ** 2).sum()) for k in base)
    return (num / max(den, 1e-30)) ** 0.5


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_update_matches_reference(start, runs, mesh, case):
    _, tp, _ = start
    (want_p, want_m), one, one_last = runs[0][case]
    outs = runs[1][mesh]
    d, m = (int(v) for v in mesh.split("x"))
    assert sorted(int(o["data_index"]) for o in outs) == sorted(
        list(range(d)) * m)
    assert all(int(o["data_extent"]) == d and o["groups"].all()
               for o in outs)
    got = {k: outs[0][f"{case}/p.{k}"] for k in tp}
    for o in outs[1:]:                  # the ranks never fork
        for k in tp:
            assert np.array_equal(o[f"{case}/p.{k}"], got[k]), k
    for k in tp:
        np.testing.assert_allclose(got[k], want_p[k], rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)
    metric = {k[len(case) + 3:]: float(v) for k, v in outs[0].items()
              if k.startswith(f"{case}/m.")}
    for key in ("loss", "cg_best_loss"):
        assert abs(metric[key] - want_m[key]) <= LOSS_ATOL, key
    assert abs(metric["cg_base_loss"] - float(one["m.cg_base_loss"])) \
        <= LOSS_ATOL
    assert metric["cg_best_iter"] == want_m["cg_best_iter"]
    assert metric["cg_accepted"] == want_m["cg_accepted"]
    assert metric["cg_best_iter"] == float(one["m.cg_best_iter"])
    assert _rel_l2(got, {k: one["p." + k] for k in tp}, tp) <= DELTA_REL_L2
    last = {k: outs[0][f"{case}/last.{k}"] for k in tp}
    assert _rel_l2(last, {k: one_last["p." + k] for k in tp},
                   tp) <= DELTA_REL_L2
    assert int(outs[0][f"{case}/step"]) == 1


@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_first_order_ce_step_matches_one_process(start, runs, mesh):
    """Adam on the CE loss: the mesh's step equals the one-process port's
    within rel-L2 1e-5 and loss 1e-5, the same bits on every rank."""
    _, tp, _ = start
    for case, kw in FIRST_ORDER.items():
        one = W.one_update(tp, None, **kw)
        outs = runs[1][mesh]
        got = {k: outs[0][f"{case}/p.{k}"] for k in tp}
        for o in outs[1:]:
            assert all(np.array_equal(o[f"{case}/p.{k}"], got[k])
                       for k in tp)
        assert abs(float(outs[0][f"{case}/m.loss"])
                   - float(one["m.loss"])) <= LOSS_ATOL
        assert _rel_l2(got, {k: one["p." + k] for k in tp}, tp) \
            <= DELTA_REL_L2


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The 2-rank tasks, run together: {"cg_tree": ..., "resume": ...}."""
    started = {"cg_tree": W.start("cg_tree", 2,
                                  tmp_path_factory.mktemp("cg_tree")),
               "resume": W.start("resume", 2,
                                 tmp_path_factory.mktemp("resume"),
                                 mesh="2x1")}
    return {k: W.finish(h) for k, h in started.items()}


def test_cg_fused_update_tree_sums_a_split_leaf(two_ranks):
    for o in two_ranks["cg_tree"]:
        for k in ("x_w", "x_b", "r_w"):
            assert np.array_equal(o[k], o["want_" + k]), k
        np.testing.assert_allclose(float(o["rr"]), float(o["want_rr"]),
                                   rtol=1e-6)


def test_resumed_mesh_run_equals_uninterrupted(two_ranks):
    outs = two_ranks["resume"]
    for o in outs:
        assert list(o["resumed_steps"]) == [2]
        keys = [k[5:] for k in o if k.startswith("full.")]
        assert keys
        for k in keys:
            assert np.array_equal(o["full." + k], o["resumed." + k]), k
        for k in keys:
            assert np.array_equal(o["full." + k], outs[0]["full." + k]), k
