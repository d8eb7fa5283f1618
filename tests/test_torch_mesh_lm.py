"""Port parity: LM training across processes under FSDP storage and
tensor-parallel compute over "model" (``launch.fsdp``,
``launch.tensor_parallel``, ``launch.steps.build_step(mesh=,
state_sharding=)``, ``launch.train.train_lm(mesh=)``).

The reference's acceptance test, ``tests/test_sharding.py::
test_lm_fsdp_nghf_step_matches_single_device``: the qwen2.5-3b smoke
config in 2d storage at f32 compute, B 8 x T 16, one NGHF update (2 CG
and 1 NG iterations, the ``fisher_diag`` preconditioner, ``warm_start``,
``cg_frac=2``, ``min_cg=4``).  Here it runs on 2x2, 4x1, 1x2 and 1x4
gloo meshes (a CPU process a rank, one thread each, ``tests/torch_mesh_
lm_worker.py``), each rank holding its share of every parameter and
θ-sized state leaf and, where "model" has more than one rank, computing
its share of the heads, FFN columns, experts and vocabulary, with a
decoder-only arch's residual stream split over T between the units (on
1x4 the qwen smoke's 2 kv heads are whole on every rank, each of its 4
ranks reading the one its query head reads), against the reference's
single-device jitted update from the same parameters (its zero biases and unit scales perturbed,
``tests/torch_perturb.py``) and batch, with the reference test's
tolerances: the same ``cg_best_iter``, loss within 1e-4, the parameters'
relative L2 below 1e-4 and allclose at rtol 1e-3 / atol 3e-5.  Against
the one-process port: Δθ within relative L2 1e-5, and so is the last CG
iterate of the same update without candidate selection.  Every rank
holds the same bits of every leaf it shares with another.  At least 10
leaves of ``delta`` and of ``precond.d`` are split, each of its share's
shape (the reference's fisher_diag check).

Cases: the plain update; ``cg_fused=True`` (``cg_fused_update_tree`` on
the shares); ``b6``, a gradient batch of 6, which 4 data ranks cannot
split (kept whole on every rank: the gathers' backward then slices
instead of summing) and 2 can; granite-moe-3b-a800m's smoke config (2x2:
each rank computing its 2 of the 4 experts, the load-balance aux over
the global batch); mixtral-8x22b's and recurrentgemma-9b's (1x2: the
windowed attention on each rank's heads; recurrentgemma's RG-LRU blocks
on each rank's channels, their MLPs on its columns; recurrentgemma's on
2x2 too, its rows split and its stream split over T); xlstm-125m's in 1d
storage (1x2: the mLSTM and sLSTM blocks on each rank's heads);
whisper-base's in 1d storage (2x2: an enc-dec arch, each rank computing
its heads, MLP columns, vocab and ``dec_pos`` rows, one Adam
step, held to the reference and to the one-process port by the same
parameter tolerances, and its gradient, read off Adam's first moment,
within relative L2 1e-5 of the one-process port's.  Adam's first step
maps the near-zero gradients' last-bit differences to changes of order
lr: its Δθ reads 2.1e-4 from the reference's for the one-process port
itself at this batch, and 2.1e-5 between the mesh and one process).
Also a ``train_lm`` run on a 2x1 mesh and on a 1x2 one (tensor-parallel
compute) checkpointed after 2 updates and resumed to 3, bitwise equal to
the uninterrupted run, its checkpoint holding whole leaves; and on 1x2
(whisper's on 2x2), the shapes the model used its leaves at (``wq``,
``w_in``, ``w_out``, the experts, the vocab table, the RG-LRU blocks'
``w_x``, the xLSTM blocks' ``w_q``, ``w_zifo`` and ``r_zifo``, whisper's
cross attention and ``dec_pos`` at their split shapes) with no
``_Gather`` over "model".
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_mesh_lm_worker as LW  # noqa: E402
import torch_mesh_worker as W  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
from repro.core.optim import config_for  # noqa: E402
from repro.data.synthetic import lm_batch as jbatch  # noqa: E402
from repro.launch.steps import build_step as jbuild  # noqa: E402
from repro.models.registry import get_model as jmodel  # noqa: E402
from repro_torch import convert  # noqa: E402
from torch_perturb import perturb  # noqa: E402

LOSS_ATOL = 1e-4
PARAM_REL_L2 = 1e-4
PARAM_RTOL, PARAM_ATOL = 1e-3, 3e-5
DELTA_REL_L2 = 1e-5
MESH_CASES = {"2x2": ["plain", "fused", "b6", "granite", "whisper_adam",
                       "rg"],
              "4x1": ["plain", "fused", "b6"],
              "1x2": ["plain", "mixtral", "rg", "xlstm"], "1x4": ["plain"]}
# a train_lm run checkpointed and resumed, by mesh: its split leaves
RESUME_SPLIT = {"2x1": 7, "1x2": 11}
NGHF_RUNS = [(mesh, case) for mesh, cases in MESH_CASES.items()
             for case in cases if LW.LM_CASES[case]["optimizer"] == "nghf"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg(case):
    kw = LW.LM_CASES[case]
    return jget(kw["arch"]).smoke().replace(
        compute_dtype="float32", param_sharding=kw["sharding"],
        **kw.get("over", {}))


@pytest.fixture(scope="module")
def start(tmp_path_factory):
    """(the reference's parameters by arch, the port's, the directory
    holding the port's for the ranks)."""
    tmp = tmp_path_factory.mktemp("mesh_lm_params")
    jps, tps = {}, {}
    for case in ("plain", "granite", "whisper_adam", "mixtral", "rg",
                 "xlstm"):
        arch = LW.LM_CASES[case]["arch"]
        jps[arch] = perturb(jmodel(_jcfg(case)).init(jax.random.PRNGKey(0)),
                            1)
        tps[arch] = convert.lm_params_from_numpy(
            jax.tree.map(np.asarray, jps[arch]), device="cpu")
        np.savez(tmp / f"params_{arch}.npz",
                 **{k: v.numpy() for k, v in tps[arch].items()})
    return jps, tps, tmp


def _reference(jp, case):
    """The reference's single-device jitted update: (new params by the
    port's keys, scalar metrics)."""
    kw = LW.LM_CASES[case]
    cfg = _jcfg(case)
    ocfg = config_for(kw["optimizer"], **kw["opt"])
    fn, opt = jbuild(cfg, ocfg, cg_frac=LW.CG_FRAC, min_cg=LW.MIN_CG)
    batch = jbatch(0, batch=kw["batch"], seq_len=LW.SEQ,
                   vocab=cfg.vocab_size)
    if cfg.is_encoder_decoder:
        batch["encoder_input"] = jnp.asarray(
            LW.encoder_input(cfg, kw["batch"]))
    new, _, m = jax.jit(fn)(jp, opt.init(jp), batch)
    flat = convert.lm_params_from_numpy(jax.tree.map(np.asarray, new),
                                        device="cpu")
    return {k: v.numpy() for k, v in flat.items()}, \
        {k: float(v) for k, v in m.items() if np.ndim(v) == 0}


@pytest.fixture(scope="module")
def runs(start, tmp_path_factory):
    """(per case: the reference's update, the one-process port's and its
    last CG iterate; per mesh: every rank's results; the 2-rank resume's
    results).  The ranks run while this process computes the
    references."""
    jps, tps, params_dir = start
    started = {}
    for mesh, cases in MESH_CASES.items():
        tmp = tmp_path_factory.mktemp(f"mesh_lm_{mesh}")
        for f in params_dir.iterdir():
            (tmp / f.name).write_bytes(f.read_bytes())
        d, m = (int(n) for n in mesh.split("x"))
        started[mesh] = W.start("torch_mesh_lm_worker:lm_updates", d * m,
                                tmp, mesh=mesh, cases=cases)
    resume = {mesh: W.start("torch_mesh_lm_worker:lm_resume", 2,
                            tmp_path_factory.mktemp(f"mesh_lm_resume_{mesh}"),
                            mesh=mesh) for mesh in RESUME_SPLIT}
    refs = {}
    for case in sorted({c for cases in MESH_CASES.values() for c in cases}):
        kw = LW.LM_CASES[case]
        tp = tps[kw["arch"]]
        last = (LW.lm_update(tp, None, kw, eval_candidates=False)
                if kw["optimizer"] == "nghf" else None)
        refs[case] = (_reference(jps[kw["arch"]], case),
                      LW.lm_update(tp, None, kw), last)
    return refs, {m: W.finish(h) for m, h in started.items()}, \
        {m: W.finish(h) for m, h in resume.items()}


def _delta_rel_l2(got: dict, want: dict, base: dict) -> float:
    num = sum(float(((got[k] - want[k]) ** 2).sum()) for k in base)
    den = sum(float(((want[k] - base[k].numpy()) ** 2).sum()) for k in base)
    return (num / max(den, 1e-30)) ** 0.5


def _rank0(outs, case, tp, what="p"):
    got = {k: outs[0][f"{case}/{what}.{k}"] for k in tp}
    for o in outs[1:]:                  # the ranks never fork
        for k in tp:
            assert np.array_equal(o[f"{case}/{what}.{k}"], got[k]), k
    return got


@pytest.mark.parametrize("mesh,case", NGHF_RUNS)
def test_mesh_lm_nghf_update_matches_reference(start, runs, mesh, case):
    _, tps, _ = start
    tp = tps[LW.LM_CASES[case]["arch"]]
    (want_p, want_m), one, one_last = runs[0][case]
    outs = runs[1][mesh]
    d = int(mesh.split("x")[0])
    assert sorted(int(o["data_index"]) for o in outs) == sorted(
        list(range(d)) * (len(outs) // d))
    got = _rank0(outs, case, tp)
    metric = {k[len(case) + 3:]: float(v) for k, v in outs[0].items()
              if k.startswith(f"{case}/m.")}
    # the reference test's own tolerances
    assert metric["cg_best_iter"] == want_m["cg_best_iter"]
    assert abs(metric["loss"] - want_m["loss"]) < LOSS_ATOL
    a = np.concatenate([want_p[k].ravel().astype(np.float64) for k in tp])
    c = np.concatenate([got[k].ravel().astype(np.float64) for k in tp])
    assert np.linalg.norm(a - c) / np.linalg.norm(a) < PARAM_REL_L2
    np.testing.assert_allclose(c, a, rtol=PARAM_RTOL, atol=PARAM_ATOL)
    # against the one-process port
    assert metric["cg_best_iter"] == float(one["m.cg_best_iter"])
    assert metric["cg_accepted"] == float(one["m.cg_accepted"])
    assert _delta_rel_l2(got, {k: one["p." + k] for k in tp}, tp) \
        <= DELTA_REL_L2
    last = _rank0(outs, case, tp, "last")
    assert _delta_rel_l2(last, {k: one_last["p." + k] for k in tp}, tp) \
        <= DELTA_REL_L2
    # a replicated leaf: the same bits on every rank (a split one's
    # pieces gathered whole are compared by _rank0)
    for k in tp:
        if outs[0][f"{case}/share.{k}"].shape == tuple(tp[k].shape):
            assert all(np.array_equal(o[f"{case}/share.{k}"],
                                      outs[0][f"{case}/share.{k}"])
                       for o in outs), k


@pytest.mark.parametrize("mesh", sorted(MESH_CASES))
def test_mesh_lm_state_is_split(start, runs, mesh):
    """The reference's fisher_diag check: θ-sized state keeps the 2d
    storage leaf for leaf — every leaf of ``delta`` and ``precond.d`` of
    its share's shape, and split wherever its parameter is; on 2x2, where
    both axes split, at least 10 leaves each (the reference's bound on
    4x2).  On 4x1 the vocab table and the q/k/v biases split over
    "model" only, so the 7 layer matrices are split; on 1x4 the 4
    query-side and FFN matrices, ``bq`` and the table (the 2 kv heads do
    not split 4 ways), and on 1x2 those and the 4 kv leaves."""
    _, tps, _ = start
    tp = tps["qwen2.5-3b"]
    for o in runs[1][mesh]:
        for slot in ("delta", "d"):
            split = 0
            for k in tp:
                shape = tuple(o[f"plain/shape.{slot}.{k}"])
                assert shape == tuple(o[f"plain/want.{slot}.{k}"]), (slot, k)
                assert shape == o[f"plain/share.{k}"].shape, (slot, k)
                split += shape != tuple(tp[k].shape)
            assert split >= (10 if mesh == "2x2" else 7), (slot, split)


# (case, the leaves used at a split shape, the leaves used whole) on 1x2,
# whisper's on 2x2 (its "model" extent 2 too)
TP_USED = {
    "plain": (("periods.slot0.attn.wq", 1), ("periods.slot0.attn.wk", 1),
              ("periods.slot0.mlp.w_in", 1), ("periods.slot0.mlp.w_out", 0),
              ("periods.slot0.attn.wo", 0), ("embed.table", 0)),
    "mixtral": (("periods.slot0.attn.wq", 1), ("periods.slot0.moe.w_in", 0),
                ("periods.slot0.moe.w_out", 0), ("embed.lm_head", 1),
                ("embed.table", 0)),
    "rg": (("periods.slot2.attn.wq", 1), ("periods.slot2.mlp.w_in", 1),
           ("embed.table", 0), ("periods.slot0.w_x", 1),
           ("periods.slot0.mlp.w_in", 1), ("periods.slot1.conv_w", 1),
           ("periods.slot1.w_input_gate", 1), ("periods.slot0.w_out", 0)),
    "xlstm": (("periods.slot0.w_q", 1), ("periods.slot1.w_up", 1),
              ("periods.slot2.w_if", 0), ("periods.slot0.w_down", 0),
              ("periods.slot3.w_zifo", 1), ("periods.slot3.r_zifo", 1),
              ("periods.slot3.w_up", 1), ("embed.table", 0)),
    "whisper_adam": (("encoder.layer0.attn.wq", 1),
                     ("decoder.layer0.self_attn.wq", 1),
                     ("decoder.layer1.cross_attn.wq", 1),
                     ("decoder.layer1.cross_attn.wk", 1),
                     ("encoder.layer1.mlp.w_out", 0), ("dec_pos", 0),
                     ("embed.lm_head", 1)),
}
TP_WHOLE = {"plain": ("periods.slot0.ln1.scale",),
            "mixtral": ("periods.slot0.moe.router",),
            "rg": ("periods.slot2.attn.wk", "periods.slot0.conv_b",
                   "periods.slot1.log_lambda", "periods.slot0.ln1.scale"),
            "xlstm": ("periods.slot0.conv_b", "periods.slot2.b_if",
                      "periods.slot3.b_zifo", "periods.slot3.ln.scale"),
            "whisper_adam": ("decoder.layer0.ln_x.scale",
                             "encoder.layer1.ln2.bias")}
# the mesh each case's shapes are read on
TP_MESH = {"whisper_adam": "2x2"}


@pytest.mark.parametrize("case", sorted(TP_USED))
def test_tp_leaves_are_used_split_without_a_model_gather(start, runs, case):
    """On 1x2 (whisper on 2x2) each rank uses its half of ``wq`` (its
    query heads), of the FFN's columns, of the experts, of the vocab
    table, of recurrentgemma's RG-LRU channels (``w_x``, the conv, the
    gate matrices' columns, ``w_out``'s rows) and of xlstm's mLSTM and
    sLSTM heads, of whisper's cross attention and ``dec_pos``, as it
    stores them: no ``_Gather`` over "model" at all.  A vector the unit
    reads in part (``conv_b``, ``log_lambda``, ``b_if``, ``b_zifo``), the
    norms and recurrentgemma's one kv head are whole on each rank."""
    _, tps, _ = start
    tp = tps[LW.LM_CASES[case]["arch"]]
    def used_whole(key) -> list:
        return list(tp[key].shape[1:] if key.startswith("periods")
                    else tp[key].shape)

    for o in runs[1][TP_MESH.get(case, "1x2")]:
        for key, dim in TP_USED[case]:
            want = used_whole(key)
            want[dim] //= 2
            assert list(o[f"{case}/used.{key}"]) == want, key
        for key in TP_WHOLE[case]:
            assert list(o[f"{case}/used.{key}"]) == used_whole(key), key
        n = int(o[f"{case}/model_gathers"])
        assert n == 0, n
        # no data axis splits these leaves (1d storage, or data extent 1)
        assert int(o[f"{case}/gathers"]) == n


def test_mesh_lm_adam_step_of_an_encdec_arch(start, runs):
    """whisper-base in 1d storage on 2x2: one Adam step, every rank the
    same bits, the parameters within the reference test's tolerances of
    the reference's and of the one-process port's, and the gradient
    (Adam's first moment) within relative L2 1e-5 of the one-process
    port's; Adam's moments split as the parameters."""
    _, tps, _ = start
    tp = tps["whisper-base"]
    (want_p, want_m), one, _ = runs[0]["whisper_adam"]
    outs = runs[1]["2x2"]
    got = _rank0(outs, "whisper_adam", tp)
    assert abs(float(outs[0]["whisper_adam/m.loss"]) - want_m["loss"]) \
        < LOSS_ATOL
    a = np.concatenate([want_p[k].ravel().astype(np.float64) for k in tp])
    c = np.concatenate([got[k].ravel().astype(np.float64) for k in tp])
    assert np.linalg.norm(a - c) / np.linalg.norm(a) < PARAM_REL_L2
    np.testing.assert_allclose(c, a, rtol=PARAM_RTOL, atol=PARAM_ATOL)
    # the distributed gradient, through Adam's first moment (1 - b1) g
    m = {k: outs[0]["whisper_adam/adam_m." + k] for k in tp}
    num = sum(float(((m[k] - one["adam_m." + k]) ** 2).sum()) for k in tp)
    den = sum(float((one["adam_m." + k] ** 2).sum()) for k in tp)
    assert (num / den) ** 0.5 <= DELTA_REL_L2
    c1 = np.concatenate([one["p." + k].ravel().astype(np.float64)
                         for k in tp])
    np.testing.assert_allclose(c, c1, rtol=PARAM_RTOL, atol=PARAM_ATOL)
    split = sum(tuple(outs[0][f"whisper_adam/shape.m.{k}"])
                != tuple(tp[k].shape) for k in tp)
    assert split >= 10
    for k in tp:
        assert tuple(outs[0][f"whisper_adam/shape.m.{k}"]) == tuple(
            outs[0][f"whisper_adam/want.m.{k}"]), k


def _resumed_equals_uninterrupted(tp: dict, outs: list, n_split: int):
    for o in outs:
        assert list(o["resumed_steps"]) == [2]
        keys = [k[5:] for k in o if k.startswith("full.")]
        assert sorted(keys) == sorted(tp)
        for k in keys:
            assert np.array_equal(o["full." + k], o["resumed." + k]), k
        # the checkpoint holds whole leaves
        for k in tp:
            key = "ckpt_shape.params/" + k.replace(".", "/")
            assert tuple(o[key]) == tuple(tp[k].shape), k
    assert sum(tuple(outs[0]["full." + k].shape) != tuple(tp[k].shape)
               for k in tp) == n_split


def test_resumed_lm_mesh_run_equals_uninterrupted(start, runs):
    """2x1: the 7 layer matrices split over "data"."""
    _, tps, _ = start
    _resumed_equals_uninterrupted(tps["qwen2.5-3b"], runs[2]["2x1"],
                                  RESUME_SPLIT["2x1"])


def test_resumed_lm_tp_run_equals_uninterrupted(start, runs):
    """1x2, tensor-parallel compute: those 7, the q/k/v biases and the
    table split over "model"; the checkpoint's leaves whole, as on one
    device."""
    _, tps, _ = start
    _resumed_equals_uninterrupted(tps["qwen2.5-3b"], runs[2]["1x2"],
                                  RESUME_SPLIT["1x2"])
