"""Port parity: sequence-parallel activations (Megatron-SP) and the
dispatch MoE on a mesh (``launch.fsdp.sequence_split``,
``launch.tensor_parallel.enter`` / ``leave``,
``models.layers.moe_apply_dispatch``).

On gloo meshes of CPU ranks (a process a rank, one thread each; the rank
code is ``tests/torch_mesh_lm_worker.py``'s ``tp_units`` and
``lm_updates``):

  * the unit edges along T (``_toy_sp``: a leaf used on the T slice
    through f, a split unit entered by the all-gather and left by the
    reduce-scatter, a whole unit entered by the all-gather with a slice
    backward and left by the slice) under the forward, ``torch.func.jvp``,
    ``linearize``, ``vjp`` and autograd on 1x2, 2x2 and 1x4: each rank's
    T slice of the whole toy's output and tangent, and its share of the
    whole gradient, within 1e-5 of the largest entry;
  * the residual stream's shape at every block boundary (the input and
    output of each ``blocks.block_apply`` of a gradient): (B_local, T/m,
    d) where sequence parallelism runs, (B_local, T, d) where it falls
    back (T 15, which "model" does not divide; a batch of 3, which the 2
    data ranks of 2x2 keep whole, as they keep ``b6`` on 4);
  * the collectives of that gradient: where sequence parallelism runs no
    all-reduce over "model" of a (B_local, T, d) activation, f32
    reduce-scatters and all-gathers of it instead; where it falls back,
    the all-reduce;
  * the gradients and logits (on the whole batch and on this rank's
    rows) of ``SP_CASES`` against one process, within 1e-5 (relative to
    a leaf's largest entry, relative to the largest logit), the norms'
    scales and biases and the q/k/v biases perturbed: qwen2.5-3b's with
    q/k norms (its kv heads whole on 1x4), recurrentgemma-9b's,
    xlstm-125m's with 2 heads (its units whole on 1x4, the stream
    split), the two fallbacks, granite's with an odd vocabulary (its
    embedding and head whole on every rank) and granite's dispatch MoE.
    The GN products (rematvp and linearize) of the cases that are also
    ``TP_GRAD_CASES``, under sequence parallelism on the same meshes,
    are ``tests/test_torch_tensor_parallel.py``'s;
  * ``moe_apply_dispatch`` on 2x1, 1x2, 2x2 and 1x4 (split rows, split T,
    4 experts split by experts, 3 by their columns) against the
    reference's single-device ``repro.models.layers.moe_apply_dispatch``
    on the global batch: the output, the aux, the gradients of x, the
    router and every expert matrix within 1e-5, and the dropped pairs
    counted the reference's (above 0);
  * the reference's acceptance test (``tests/test_sharding.py::
    test_lm_fsdp_nghf_step_matches_single_device``, as
    ``tests/test_torch_mesh_lm.py`` runs it, on 2x2 for qwen2.5-3b and
    recurrentgemma-9b too) on 2x2 for granite-moe-3b-a800m with the
    dispatch MoE: the same
    ``cg_best_iter``, loss within 1e-4, the parameters within relative L2
    1e-4 and rtol 1e-3 / atol 3e-5 of the reference's jitted update, and
    Δθ within relative L2 1e-5 of the one-process port's.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_mesh_lm_worker as LW  # noqa: E402
import torch_mesh_worker as W  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.registry import get_model as jmodel  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from test_torch_mesh_lm import (_delta_rel_l2, _jcfg, _rank0,  # noqa: E402
                                _reference)
from test_torch_tensor_parallel import _ce_inputs  # noqa: E402
from torch_perturb import perturb  # noqa: E402

MESHES = {"2x1": 2, "1x2": 2, "2x2": 4, "1x4": 4}
SP_MESHES = ("1x2", "2x2", "1x4")
REL = 1e-5
LOSS_ATOL = 1e-4
PARAM_REL_L2 = 1e-4
PARAM_RTOL, PARAM_ATOL = 1e-3, 3e-5
LM_MESH, LM_CASES = "2x2", ["granite_dispatch"]


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _dispatch_reference(by: str) -> dict:
    """The reference's single-device dispatch MoE on the global batch:
    out, aux, the gradients of (out · ct) + aux_ct · aux, and the pairs
    it drops (each expert's count past its capacity)."""
    E, k = LW.DISPATCH[by]
    _, _, d, ff = LW.DISPATCH_SHAPE
    cfg = jget("granite-moe-3b-a800m").smoke().replace(
        compute_dtype="float32", d_model=d, d_ff=ff, num_experts=E,
        num_experts_per_tok=k, moe_impl="dispatch")
    x = {n: jnp.asarray(v) for n, v in LW.dispatch_inputs(E).items()}
    p = {n: x[n] for n in ("router", "w_in", "w_gate", "w_out")}

    def f(h, p):
        out, aux = JL.moe_apply_dispatch(cfg, p, h)
        return (out * x["ct"]).sum() + x["aux_ct"] * aux, (out, aux)

    (_, (out, aux)), (gx, gp) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(x["x"], p)
    B, T = x["x"].shape[:2]
    probs = jax.nn.softmax(x["x"].reshape(B * T, d) @ x["router"], -1)
    counts = np.bincount(np.asarray(jax.lax.top_k(probs, k)[1]).ravel(),
                         minlength=E)
    C = int(math.ceil(B * T * k / E * 1.25))
    res = {"out": out, "aux": aux, "g.x": gx}
    res.update({"g." + n: v for n, v in gp.items()})
    res = {n: np.asarray(v) for n, v in res.items()}
    res["drops"] = int(np.maximum(counts - C, 0).sum())
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(every rank's ``tp_units`` results by mesh, one process's results
    by case, the dispatch references, every rank's ``lm_updates`` on
    2x2, the LM references by case).  The ranks run while this process
    computes the references."""
    x = _ce_inputs()
    started = {}
    for mesh, n in MESHES.items():
        tmp = tmp_path_factory.mktemp(f"sp_{mesh}")
        np.savez(tmp / "ce_inputs.npz", **x)
        cases = list(LW.SP_CASES) if mesh in SP_MESHES else []
        started[mesh] = W.start("torch_mesh_lm_worker:tp_units", n, tmp,
                                mesh=mesh, cases=cases, products=False)
    tmp = tmp_path_factory.mktemp("sp_lm")
    jps, tps = {}, {}
    for case in LM_CASES:
        arch = LW.LM_CASES[case]["arch"]
        jps[arch] = perturb(jmodel(_jcfg(case)).init(jax.random.PRNGKey(0)),
                            1)
        tps[arch] = convert.lm_params_from_numpy(
            jax.tree.map(np.asarray, jps[arch]), device="cpu")
        np.savez(tmp / f"params_{arch}.npz",
                 **{k: v.numpy() for k, v in tps[arch].items()})
    d, m = (int(v) for v in LM_MESH.split("x"))
    lm = W.start("torch_mesh_lm_worker:lm_updates", d * m, tmp,
                 mesh=LM_MESH, cases=LM_CASES, last=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = {name: LW.tp_one_process(name, products=False)
               for name in LW.SP_CASES}
        dispatch = {by: _dispatch_reference(by) for by in LW.DISPATCH}
        refs = {}
        for case in LM_CASES:
            kw = LW.LM_CASES[case]
            tp = tps[kw["arch"]]
            refs[case] = (_reference(jps[kw["arch"]], case),
                          LW.lm_update(tp, None, kw), tp)
    finally:
        torch.set_num_threads(n)
    return ({m: W.finish(h) for m, h in started.items()}, one, dispatch,
            W.finish(lm), refs)


@pytest.fixture(params=SP_MESHES)
def outs(request, runs):
    got = runs[0][request.param]
    assert len(got) == MESHES[request.param]
    return request.param, got


def _layout(mesh: str, case: dict):
    """(data extent, "model" extent, rows a rank, T, whether the stream
    is split over T) of a ``SP_CASES`` case on ``mesh``."""
    d, m = (int(v) for v in mesh.split("x"))
    B = case.get("batch", LW.TP_BATCH)
    T = case.get("seq", LW.SEQ)
    rows = B // d if B % d == 0 else B
    split = m > 1 and T % m == 0 and (d == 1 or B % d == 0)
    return d, m, rows, T, split


@pytest.mark.parametrize("what", ["forward", "jvp", "linearize", "vjp",
                                  "autograd"])
def test_sequence_parallel_edges_match_one_process(outs, what):
    """The unit edges along T: each rank's T slice of the whole toy's
    output and tangent, and its share of the whole gradient."""
    for o in outs[1]:
        assert float(o["sp_toy_" + what]) <= REL, (what, o["sp_toy_" + what])


@pytest.mark.parametrize("name", sorted(LW.SP_CASES))
def test_residual_stream_is_split_over_T_between_blocks(outs, name):
    """(B_local, T/m, d) at every block boundary where sequence
    parallelism runs; (B_local, T, d) where it falls back."""
    mesh, got = outs
    case = LW.SP_CASES[name]
    _, m, rows, T, split = _layout(mesh, case)
    d_model = LW.tp_grad_cfg(name).d_model
    want = (rows, T // m if split else T, d_model)
    n_blocks = LW.tp_grad_cfg(name).num_layers
    for o in got:
        shapes = [tuple(s) for s in o[f"{name}/residual"]]
        assert len(shapes) == 2 * n_blocks, shapes
        assert set(shapes) == {want}, (mesh, name, set(shapes), want)
    if name in ("qwen_t15",) or (name == "qwen_b3" and mesh == "2x2"):
        assert not split


def _collectives(o, name) -> dict:
    """{(kind, group, shape, bytes an element): calls} of a case's
    gradient on one rank."""
    out = {}
    for text, n in zip(o[f"{name}/coll"], o[f"{name}/coll_calls"]):
        if text:
            kind, group, shape, size = text.split()
            out[(kind, group, tuple(int(v) for v in shape.split("x")),
                 int(size))] = int(n)
    return out


def _dense_moe_layers(cfg) -> int:
    """The layers whose FFN is the dense MoE (``layers.moe_apply``)."""
    if cfg.moe_impl == "dispatch":
        return 0
    pattern = cfg.block_pattern
    return sum(pattern[i % len(pattern)] in ("moe", "swamoe")
               for i in range(cfg.num_layers))


@pytest.mark.parametrize("name", sorted(LW.SP_CASES))
def test_no_unit_exit_all_reduces_the_stream(outs, name):
    """Where sequence parallelism runs, no unit's exit moves a (B_local,
    T, d) activation over "model" by an all-reduce: the split units'
    exits reduce-scatter their f32 partials and their entries all-gather
    T.  The one all-reduce of that shape left is the dense MoE's f on
    its experts' input (its backward, once a layer), which the router's
    whole-T input on every rank needs.  Where sequence parallelism falls
    back, the units' exits all-reduce the stream (g), as before."""
    mesh, got = outs
    _, _, rows, T, split = _layout(mesh, LW.SP_CASES[name])
    cfg = LW.tp_grad_cfg(name)
    stream = (rows, T, cfg.d_model)
    for o in got:
        coll = _collectives(o, name)
        over = {}
        for k, n in coll.items():
            if k[1] == "model" and k[2] == stream:
                over[k[0]] = over.get(k[0], 0) + n
        if split:
            assert over.get("all_reduce", 0) == _dense_moe_layers(cfg), \
                (mesh, name, coll)
            assert over.get("reduce_scatter", 0) > 0, (mesh, name, coll)
            assert over.get("all_gather", 0) > 0, (mesh, name, coll)
            assert any(k[0] == "reduce_scatter" and k[1] == "model"
                       and k[2] == stream and k[3] == 4 for k in coll)
        else:
            assert over.get("all_reduce", 0) > 0, (mesh, name, coll)
            assert "reduce_scatter" not in over, (mesh, name, coll)


@pytest.mark.parametrize("name", sorted(LW.SP_CASES))
def test_sequence_parallel_gradients_match_one_process(runs, outs, name):
    """Every leaf's gradient (the perturbed norms' among them: their f
    sums the ranks' T slices), within 1e-5 of one process's relative to
    the leaf's largest entry; the split gradient's ``norm`` within rtol
    1e-5 and
    its ``vdot`` with the tangent within 1e-5 of |g| |v| (a vdot that
    cancels to 1e-4 of that scale, as granite's with 511 tokens, has no
    relative digits to hold)."""
    one = runs[1][name]
    v = LW._tp_case(name)[6]
    v_norm = float(sum((t.double() ** 2).sum() for t in v.values())) ** 0.5
    keys = list(get_model(LW.tp_grad_cfg(name)).param_shapes())
    for o in outs[1]:
        for k in keys:
            assert _rel(o[f"{name}/g.{k}"], one[f"g_one.{k}"]) <= REL, k
        (dot, norm), (dot1, norm1) = o[f"{name}/dots"], one["dots_one"]
        assert abs(dot - dot1) <= REL * norm1 * v_norm, (dot, dot1)
        assert abs(norm - norm1) <= REL * norm1, (norm, norm1)


@pytest.mark.parametrize("name", sorted(LW.SP_CASES))
def test_sequence_parallel_logits_match_one_process(runs, outs, name):
    """``forward``'s logits, the whole T's, on the whole batch and on this
    rank's rows, within 1e-5 of one process's relative to the largest
    logit."""
    mesh, got = outs
    one = runs[1][name]["logits_one"]
    _, _, rows, _, _ = _layout(mesh, LW.SP_CASES[name])
    for o in got:
        assert _rel(o[f"{name}/logits"], one) <= REL
        lo = int(o["data_index"]) * rows if rows < one.shape[0] else 0
        assert _rel(o[f"{name}/logits_rows"], one[lo:lo + rows]) <= REL


def _dispatch_whole(outs, by: str, key: str, E: int):
    """The global tensor of a dispatch result from every rank's piece:
    x-like ones by data rows and T slices, the experts' matrices by their
    experts or columns, summed over the data ranks where each holds a
    partial gradient (the router, the matrices, the aux)."""
    B, T, _, _ = LW.DISPATCH_SHAPE
    d = 1 + max(int(o["data_index"]) for o in outs)
    m = 1 + max(int(o["model_index"]) for o in outs)
    nb, t = B // d, T // m
    pieces = {(int(o["data_index"]), int(o["model_index"])):
              o[f"dispatch_{by}/{key}"] for o in outs}
    if key in ("out", "g.x"):
        whole = np.zeros((B, T, pieces[0, 0].shape[-1]), np.float32)
        for (i, r), v in pieces.items():
            whole[i * nb:(i + 1) * nb, r * t:(r + 1) * t] = v
        return whole
    summed = {r: sum(pieces[i, r] for i in range(d)) for r in range(m)}
    if key in ("aux", "g.router") or m == 1:
        for r in range(1, m):       # every "model" rank holds the same
            np.testing.assert_allclose(summed[r], summed[0], rtol=1e-6,
                                       atol=1e-7)
        return summed[0]
    dim = 0 if by == "experts" else (1 if key == "g.w_out" else 2)
    return np.concatenate([summed[r] for r in range(m)], dim)


@pytest.mark.parametrize("by", sorted(LW.DISPATCH))
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_dispatch_moe_on_a_mesh_matches_reference(runs, mesh, by):
    """The global batch's capacity and drops: the output, the aux and the
    gradients within 1e-5 of the reference's single-device ones, and as
    many dropped pairs (above 0)."""
    outs, ref = runs[0][mesh], runs[2][by]
    E = LW.DISPATCH[by][0]
    for key in ("out", "aux", "g.x", "g.router", "g.w_in", "g.w_gate",
                "g.w_out"):
        got = _dispatch_whole(outs, by, key, E)
        assert got.shape == ref[key].shape, (key, got.shape)
        assert _rel(got, ref[key]) <= REL, key
    d = 1 + max(int(o["data_index"]) for o in outs)
    for r in range(1 + max(int(o["model_index"]) for o in outs)):
        drops = sum(int(o[f"dispatch_{by}/drops"].sum()) for o in outs
                    if int(o["model_index"]) == r)
        assert drops == ref["drops"] > 0, (r, drops, ref["drops"])
    assert sum(1 for o in outs if int(o["model_index"]) == 0) == d


@pytest.mark.parametrize("case", LM_CASES)
def test_sequence_parallel_nghf_update_matches_reference(runs, case):
    """The reference's acceptance test on 2x2, each rank holding its
    rows, its T/2 of the stream and its share of every unit."""
    outs = runs[3]
    (want_p, want_m), one, tp = runs[4][case]
    got = _rank0(outs, case, tp)
    metric = {k[len(case) + 3:]: float(v) for k, v in outs[0].items()
              if k.startswith(f"{case}/m.")}
    assert metric["cg_best_iter"] == want_m["cg_best_iter"]
    assert abs(metric["loss"] - want_m["loss"]) < LOSS_ATOL
    a = np.concatenate([want_p[k].ravel().astype(np.float64) for k in tp])
    c = np.concatenate([got[k].ravel().astype(np.float64) for k in tp])
    assert np.linalg.norm(a - c) / np.linalg.norm(a) < PARAM_REL_L2
    np.testing.assert_allclose(c, a, rtol=PARAM_RTOL, atol=PARAM_ATOL)
    assert metric["cg_best_iter"] == float(one["m.cg_best_iter"])
    assert metric["cg_accepted"] == float(one["m.cg_accepted"])
    assert _delta_rel_l2(got, {k: one["p." + k] for k in tp}, tp) <= REL
