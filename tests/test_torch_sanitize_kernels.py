"""The port's kernel sanitizer (``repro_torch.analysis.sanitize_kernels``)
on the CPU: every KS rule on hand-built records, the capture hook's
scoping and its ``plain`` records, the seeded mutants, the whole sweep,
and the reference's KS002/KS004 against the port's on the same corpus
lattices and the same perturbed outputs.

Records are built over ``meta`` tensors where only their shapes matter.
The card's half (every launcher's ``cuda`` records equal to its
``build.launch`` calls, ptxas's static shared bytes in KS001) runs in
``chip_smoke.py`` phase 18.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.analysis import corpus as jax_corpus  # noqa: E402
from repro.analysis import rules_kernel as jax_rules  # noqa: E402
from repro.analysis import sanitize_kernels as jax_sanitize  # noqa: E402
from repro.losses.lattice import lattice_frontiers as jax_frontiers  # noqa: E402
from repro_torch.analysis import corpus, rules_kernel, sanitize_kernels  # noqa: E402
from repro_torch.kernels import instrument, ref  # noqa: E402
from repro_torch.kernels import lattice_fb as LF  # noqa: E402
from repro_torch.kernels import swa_attention as SWA  # noqa: E402
from repro_torch.kernels.instrument import KernelCall, capture_calls  # noqa: E402
from repro_torch.losses.lattice import lattice_frontiers  # noqa: E402

CPU = torch.device("cpu")


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _dag_record(L=2, W=3, P=2, B=1, name="dag_forward_launch", pidx=None,
                **config):
    plan = (LF.dag_backward_plan if name == "dag_backward_launch"
            else LF.dag_forward_plan)(L, W, P)
    cfg = {"grid": (B,), "threads": plan[0], "smem": plan[1],
           "gstride": plan[2]}
    cfg.update(config)
    idx = "sidx" if name == "dag_backward_launch" else "pidx"
    if pidx is None:
        pidx = torch.zeros(B, L, W, P, dtype=torch.int32)
    return KernelCall(name, "lattice_dag", "plain", cfg,
                      {"own": torch.zeros(B, L, W), idx: pidx})


# --------------------------------------------------------------------------
# KS001: launch structure
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["dag_forward_launch",
                                  "dag_backward_launch"])
def test_ks001_plan_of_the_host_is_clean(name):
    assert rules_kernel.check_call_structure(_dag_record(name=name)) == []
    # a bucket whose worst-case state passes SMEM_MAX takes gstride
    big = _dag_record(L=400, W=150, P=9, name=name)
    assert big.config["gstride"] > 0 and big.config["gstride"] % 16 == 0
    assert rules_kernel.check_call_structure(big) == []


@pytest.mark.parametrize("config,needle", [
    ({"threads": 100}, "threads"),
    ({"threads": 1024}, "[32, 512]"),
    ({"smem": 1}, "is not the plan"),
    ({"gstride": 8}, "multiple of 16"),
    ({"gstride": 64}, "worst-case state"),
])
def test_ks001_flags_a_launch_off_its_plan(config, needle):
    fails = rules_kernel.check_call_structure(_dag_record(**config))
    assert fails and all(f.startswith("KS001") for f in fails)
    assert any(needle in f for f in fails), fails


def test_ks001_shared_memory_against_static_bytes():
    rec = _dag_record(L=60, W=40, P=9)
    smem = rec.config["smem"]
    room = rules_kernel.SMEM_PER_BLOCK - smem
    ok = rules_kernel.check_call_structure(
        rec, static={"dag_forward_launch": room})
    assert ok == []
    fails = rules_kernel.check_call_structure(
        rec, static={"dag_forward_launch": room + 1})
    assert len(fails) == 1 and "static" in fails[0]


def test_ks001_grid_limits_and_swa_geometry():
    q, k = _meta(70_000, 8, 2, 32), _meta(70_000, 8, 1, 32)
    core = KernelCall("swa_attention_launch", "swa_attention", "cuda",
                      {"window": 4}, {"q": q, "k": k, "v": k})
    assert any("grid" in f for f in rules_kernel.check_call_structure(core))
    q, k = _meta(2, 40, 4, 64), _meta(2, 40, 2, 64)
    geo = SWA.swa_geometry(2, 40, 4, 2, 64, 16)
    good = KernelCall("swa_attention_sm90_launch", "swa_attention_sm90",
                      "cuda", {"window": 16, "geometry": geo},
                      {"q": q, "k": k, "v": k})
    assert rules_kernel.check_call_structure(good) == []
    dyn = {("swa_attention_sm90_launch", 64): 200_000}
    assert rules_kernel.check_call_structure(
        good, static={"swa_attention_sm90_launch": 32_448},
        dynamic_smem=dyn) == []
    assert rules_kernel.check_call_structure(
        good, static={"swa_attention_sm90_launch": 32_449},
        dynamic_smem=dyn)
    bad = KernelCall("swa_attention_sm90_launch", "swa_attention_sm90",
                     "cuda", {"window": 16,
                              "geometry": geo._replace(hd_pad=32)},
                     {"q": q, "k": k, "v": k})
    fails = rules_kernel.check_call_structure(bad)
    assert any("geometry" in f for f in fails)
    dkdv = KernelCall("swa_attention_dkdv_sm90_launch",
                      "swa_attention_bwd_sm90", "cuda",
                      {"window": 16, "geometry": geo},
                      {"q": q, "k": k, "v": k})
    assert any("is not" in f for f in rules_kernel.check_call_structure(dkdv))


def test_ks001_sausage_loss_only_plan():
    la = torch.zeros(1, 50, 3, dtype=torch.int32)
    plan = LF.sausage_loss_only_plan(50, 3)
    cfg = {"grid": (1,), "threads": plan[0], "smem": plan[1],
           "scratch": plan[2]}
    rec = KernelCall("sausage_loss_only_launch", "lattice_sausage", "plain",
                     cfg, {"level_arcs": la})
    assert rules_kernel.check_call_structure(rec) == []
    rec.config["scratch"] = True
    assert rules_kernel.check_call_structure(rec)
    # past SMEM_MAX the slots spill to a global scratch with 0 shared bytes
    assert LF.sausage_loss_only_plan(1000, 16)[1:] == (0, True)


PTXAS = """\
ptxas info    : Compiling entry function '_ZN4anon18dag_forward_kernelEv' for 'sm_90a'
ptxas info    : Function properties for _ZN4anon18dag_forward_kernelEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 144 bytes smem
ptxas info    : Compiling entry function '_Z14swa_fwd_kernelIfLi64EEvv' for 'sm_90a'
    24 bytes stack frame, 56 bytes spill stores, 40 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 24 bytes cumulative stack size
"""


def test_parse_ptxas_static_shared_memory():
    rep = rules_kernel.parse_ptxas(PTXAS)
    assert rep["_ZN4anon18dag_forward_kernelEv"] == {
        "registers": 128, "smem": 144, "spill": 0}
    assert rep["_Z14swa_fwd_kernelIfLi64EEvv"]["spill"] == 56
    assert rules_kernel.static_smem(rep, "dag_forward_launch") == 144
    assert rules_kernel.static_smem(rep, "swa_attention_launch") == 0
    assert rules_kernel.static_smem(rep, "dag_backward_launch") == 0


def test_every_launcher_has_its_library():
    stems = {p.stem for p in (sanitize_kernels.FIXTURES_DIR.parents[2]
                              / "src" / "repro_torch" / "kernels"
                              / "csrc").glob("*.cu")}
    assert set(rules_kernel.STEM_OF.values()) == stems
    assert set(rules_kernel.STEM_OF) == set(rules_kernel.KERNELS_OF)
    assert len(stems) == 7 and len(rules_kernel.STEM_OF) == 15


# --------------------------------------------------------------------------
# KS002: frontier invariants
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(corpus.ADVERSARIAL_CASES))
def test_ks002_real_frontiers_are_clean(case):
    lat, _, _ = corpus.ADVERSARIAL_CASES[case](device=CPU)
    fr = lattice_frontiers(lat)
    assert rules_kernel.check_frontier_invariants(lat, fr) == []


def test_ks002_flags_out_of_buffer_and_masked_arc_on_live_slot():
    lat, _, _ = corpus.max_fanin_case(device=CPU)
    fr = lattice_frontiers(lat)
    fails = rules_kernel.check_frontier_invariants(
        lat, fr._replace(pidx=fr.pidx + 1))
    assert any("KS002" in f and "pidx" in f for f in fails)
    lat, _, _ = corpus.padded_row_case(device=CPU)
    fr = lattice_frontiers(lat)
    ap = fr.arc_pos.clone()
    b, a = torch.nonzero(~lat.arc_mask)[0].tolist()
    ap[b, a] = 0
    fails = rules_kernel.check_frontier_invariants(
        lat, fr._replace(arc_pos=ap))
    assert any("masked arcs" in f for f in fails)


# --------------------------------------------------------------------------
# KS003: gather bounds of captured operands
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["dag_forward_launch",
                                  "dag_backward_launch"])
def test_ks003_dump_slot_is_legal_one_past_is_not(name):
    full = torch.full((1, 2, 3, 2), 6, dtype=torch.int32)   # dump = L*W
    assert rules_kernel.check_gather_bounds(
        _dag_record(name=name, pidx=full)) == []
    fails = rules_kernel.check_gather_bounds(
        _dag_record(name=name, pidx=full + 1))
    assert len(fails) == 1 and "KS003" in fails[0]


def _loss_only_record(name, **change):
    B, T, K, A, S, W = 1, 8, 6, 4, 2, 2
    ops = {"log_probs": torch.zeros(B, T, K),
           "start": torch.tensor([[0, 0, 4, 4]], dtype=torch.int32),
           "end": torch.tensor([[4, 4, 8, 8]], dtype=torch.int32),
           "label": torch.tensor([[0, 5, 1, 2]], dtype=torch.int32),
           "arc_mask": torch.tensor([[True, True, True, False]]),
           "level_arcs": torch.tensor([[[0, 1], [2, -1]]],
                                      dtype=torch.int32)}
    if name == "dag_loss_only_launch":
        ops["pidx"] = torch.full((B, S, W, 2), S * W, dtype=torch.int32)
    ops.update(change)
    return KernelCall(name, "lattice", "plain", {}, ops)


@pytest.mark.parametrize("name", ["dag_loss_only_launch",
                                  "sausage_loss_only_launch"])
@pytest.mark.parametrize("operand,bad,needle", [
    ("end", [[4, 4, 9, 8]], "end"),             # a frame past T
    ("start", [[-1, 0, 4, 4]], "start"),
    ("label", [[0, 6, 1, 2]], "label"),         # label K
    ("level_arcs", [[[0, 4], [2, -1]]], "level_arcs"),   # arc id A
])
def test_ks003_spans_labels_and_level_arcs(name, operand, bad, needle):
    assert rules_kernel.check_gather_bounds(_loss_only_record(name)) == []
    rec = _loss_only_record(name, **{operand: torch.tensor(
        bad, dtype=torch.int32)})
    fails = rules_kernel.check_gather_bounds(rec)
    assert len(fails) == 1 and needle in fails[0], fails


@pytest.mark.parametrize("mask", [
    torch.tensor([[True, True, True, False]]),
    torch.tensor([[1.0, 1.0, 0.7, 0.3]])])
def test_ks003_masked_arcs_are_never_read(mask):
    """A masked arc's span and label may be anything (chip_smoke.py's
    adversarial spans give such arcs labels past K): the kernels skip it."""
    for name in ("dag_loss_only_launch", "sausage_loss_only_launch"):
        rec = _loss_only_record(name, arc_mask=mask, label=torch.tensor(
            [[0, 5, 1, 99]], dtype=torch.int32), end=torch.tensor(
            [[4, 4, 8, 1000]], dtype=torch.int32))
        assert rules_kernel.check_gather_bounds(rec) == []


def test_ks003_pidx_of_the_dag_loss_only_launch():
    rec = _loss_only_record("dag_loss_only_launch")
    rec.operands["pidx"] = rec.operands["pidx"] + 1
    assert any("pidx" in f
               for f in rules_kernel.check_gather_bounds(rec))


def test_ks003_skips_launchers_that_gather_nothing():
    rec = KernelCall("sausage_forward_launch", "lattice_sausage", "plain",
                     {}, {"scores": torch.zeros(1, 2, 3)})
    assert rules_kernel.check_gather_bounds(rec) == []


# --------------------------------------------------------------------------
# KS004 and KS005
# --------------------------------------------------------------------------

def test_ks004_finite_accepts_sentinel_rejects_nan_inf():
    assert rules_kernel.check_finite(
        "k", [torch.tensor([0.0, -1e30, -5.0])]) == []
    assert rules_kernel.check_finite("k", [torch.tensor([float("nan")])])
    assert rules_kernel.check_finite("k", [torch.tensor([float("inf")])])


def test_ks004_diff_matches_masked_sentinels():
    g = torch.tensor([1.0, -1e30])
    w = torch.tensor([1.0, -9e29])
    assert rules_kernel.diff_outputs("k", [g], [w]) == []
    fails = rules_kernel.diff_outputs("k", [torch.tensor([1.0, 2.0])],
                                      [torch.tensor([1.0, 3.0])])
    assert len(fails) == 1 and "differs from oracle" in fails[0]


def test_ks005_flags_a_degraded_accumulator_and_a_refusal():
    x = torch.linspace(0, 1, 8).to(torch.bfloat16)
    bad = rules_kernel.check_output_dtypes(
        "bad", lambda x: torch.cumsum(x, 0), (x,),
        [("cumsum", torch.float32)])
    assert len(bad) == 1 and "KS005" in bad[0]
    good = rules_kernel.check_output_dtypes(
        "good", lambda x: torch.cumsum(x.float(), 0), (x,),
        [("cumsum", torch.float32)])
    assert good == []

    def refuses(x):
        raise TypeError("the kernel takes float32")
    assert "raised" in rules_kernel.check_output_dtypes(
        "refuses", refuses, (x,), [("out", torch.float32)])[0]


def test_precision_flow_of_the_wrappers():
    assert sanitize_kernels.check_precision_flow("cpu") == []


# --------------------------------------------------------------------------
# the capture hook
# --------------------------------------------------------------------------

def test_capture_is_scoped_and_counts_only_while_open():
    assert not instrument.capturing()
    instrument.record("s", "x_launch", "cuda", {})      # no capture: no-op
    instrument.count_launch()
    with capture_calls() as recs:
        with capture_calls() as inner:
            instrument.count_launch()
            instrument.record("s", "x_launch", "cuda", {"threads": 32})
        assert instrument.capturing()
        assert instrument._RECORDS is recs
    assert instrument._RECORDS is None
    assert recs == [] and recs.launches == 0
    assert inner.launches == 1 and inner[0].config == {"threads": 32}


def test_plain_records_hold_what_the_kernel_would_get():
    lat, T, K = corpus.max_fanin_case(device=CPU)
    fr = lattice_frontiers(lat)
    lp = sanitize_kernels._log_probs(lat, T, K, seed=1)
    own, co, st, ok, fin = sanitize_kernels._dag_layout(lat, lp)
    plain = LF.dag_forward(own, co, st, ok, fin, fr.pidx)
    with capture_calls() as recs:
        got = LF.dag_forward(own, co, st, ok, fin, fr.pidx)
        LF.dag_loss_only(lp, lat.start_t, lat.end_t, lat.label, lat.lm,
                         lat.corr, lat.arc_mask, lat.is_start, lat.is_final,
                         lat.level_arcs, fr.pidx, kappa=0.5)
    assert all(torch.equal(a, b) for a, b in zip(got, plain))
    assert [r.name for r in recs] == ["dag_forward_launch",
                                      "dag_loss_only_launch"]
    assert all(r.route == "plain" and r.stem == "lattice_dag" for r in recs)
    assert recs[0].operands["pidx"] is fr.pidx
    L, W, P = fr.pidx.shape[1:]
    assert (recs[0].config["threads"], recs[0].config["smem"],
            recs[0].config["gstride"]) == LF.dag_forward_plan(L, W, P)
    assert recs.launches == 0


def test_plain_records_of_the_attention_follow_the_card_routes():
    rng = np.random.default_rng(0)
    x = sanitize_kernels._swa_inputs(rng, torch.bfloat16, CPU)
    q, k, v, g = x["q"], x["k"], x["v"], x["g"]
    with capture_calls() as recs:
        SWA.swa_attention(q, k, v, 16)
        SWA.swa_attention_vjp(q, k, v, g, 16, core=True)
        SWA.swa_attention_jvp(q.float(), k.float(), v.float(), q.float(),
                              k.float(), v.float(), 16)
        SWA.swa_attention(q[:, :5], k, v, 16, q_offset=35)   # no kernel
    assert [r.name for r in recs] == [
        "swa_attention_sm90_launch", "swa_attention_dq_launch",
        "swa_attention_dkdv_launch", "swa_attention_jvp_launch"]
    assert recs[0].config["geometry"] == SWA.swa_geometry(2, 40, 4, 2, 64,
                                                          16)


# --------------------------------------------------------------------------
# the seeded mutants and the whole sweep
# --------------------------------------------------------------------------

def test_seeded_mutants_are_flagged():
    assert sanitize_kernels.self_test("cpu") == []


def test_bad_precision_fixture_really_degrades():
    mod = sanitize_kernels._load_fixture("bad_precision")
    lat, T, K = corpus.padded_row_case(device=CPU)
    lp = sanitize_kernels._log_probs(lat, T, K, seed=2,
                                     dtype=torch.bfloat16)
    args = sanitize_kernels._loss_only_args(lat, lp) + (lat.level_arcs,)
    logz, _ = mod.bad_sausage_loss_only(*args, kappa=0.5)
    good, _ = LF.sausage_loss_only(*args, kappa=0.5)
    assert logz.dtype == torch.bfloat16 and good.dtype == torch.float32


def test_run_sanitize_on_the_cpu_is_clean(tmp_path, capsys):
    path = tmp_path / "report.json"
    assert sanitize_kernels.main(["--device", "cpu", "--self-test",
                                  "--report", str(path)]) == 0
    assert "0 failures" in capsys.readouterr().out
    report = json.loads(path.read_text())
    assert report["failures"] == [] and report["self_test_problems"] == []
    assert set(report["cases"]) == set(corpus.ADVERSARIAL_CASES) | set(
        corpus.SPILL_CASES) | {"vector_kernels"}
    assert set(report["launches"]) == set(rules_kernel.STEM_OF)
    assert report["build_launches"] == 0 and report["precision_flow_ok"]
    for name, facts in report["cases"].items():
        assert facts["calls"] > 0, name
    ks001 = report["ks001"]
    for name in rules_kernel.STEM_OF:
        if name.endswith("_sm90_launch"):
            assert ks001[name]["hd_pad"] == [64, 128, 256], name
        if name.startswith("dag_"):
            assert 0 in ks001[name]["gstride"], name
            assert max(ks001[name]["gstride"]) > 0, name
    assert ks001["sausage_loss_only_launch"]["scratch"] == [False, True]


def test_branch_coverage_names_what_the_sweep_missed():
    tally = sanitize_kernels._Tally({})
    assert len(sanitize_kernels._branch_coverage(tally)) == 8
    for name in rules_kernel.STEM_OF:
        tally.ks001[name] = {"hd_pad": {64, 128, 256}, "gstride": {0, 16},
                             "scratch": {False, True}}
    assert sanitize_kernels._branch_coverage(tally) == []
    tally.ks001["dag_backward_launch"]["gstride"] = {0}
    tally.ks001["swa_attention_jvp_sm90_launch"]["hd_pad"] = {64, 128}
    missed = sanitize_kernels._branch_coverage(tally)
    assert len(missed) == 2
    assert any("dag_backward_launch never ran with gstride" in m
               for m in missed)
    assert any("swa_attention_jvp_sm90_launch never ran with hd_pad [64, "
               "128, 256]" in m for m in missed)


def test_cli_exit_codes(monkeypatch, capsys):
    monkeypatch.setattr(sanitize_kernels, "run_sanitize", lambda device: (
        {"device": device, "cases": {}, "records": 0, "build_launches": 0,
         "launches": {}}, ["KS003: seeded"]))
    assert sanitize_kernels.main(["--device", "cpu"]) == 1
    assert "FAIL KS003: seeded" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        sanitize_kernels.main(["--device", "tpu"])


# --------------------------------------------------------------------------
# against the reference: the same lattices, the same perturbed outputs
# --------------------------------------------------------------------------

def test_captured_index_operands_are_the_references():
    """The reference's captured ``pidx`` of its DAG forward kernel and the
    port's of ``dag_forward_launch`` on the same corpus lattice: the same
    values, and KS003 clean in both packages."""
    from repro.kernels.instrument import capture_calls as jax_capture
    from repro.kernels.lattice_fb import dag_forward as jax_dag_forward
    lat_j, T, K = jax_corpus.max_fanin_case()
    fr_j = jax_frontiers(lat_j)
    lp_j = jax_sanitize._log_probs(lat_j, T, K, seed=7)
    with jax_capture() as recs_j:
        jax_dag_forward(*jax_sanitize._dag_layout(lat_j, lp_j), fr_j.pidx)
    lat_t, _, _ = corpus.max_fanin_case(device=CPU)
    fr_t = lattice_frontiers(lat_t)
    lp_t = sanitize_kernels._log_probs(lat_t, T, K, seed=7)
    with capture_calls() as recs_t:
        LF.dag_forward(*sanitize_kernels._dag_layout(lat_t, lp_t), fr_t.pidx)
    np.testing.assert_array_equal(np.asarray(recs_j[0].operands[5]),
                                  recs_t[0].operands["pidx"].numpy())
    assert jax_rules.check_gather_bounds(recs_j[0]) == []
    assert rules_kernel.check_gather_bounds(recs_t[0]) == []


@pytest.mark.parametrize("case", ["max_fanin", "padded_row"])
def test_ks002_same_failures_as_the_reference(case):
    lat_j, _, _ = jax_corpus.ADVERSARIAL_CASES[case]()
    lat_t, _, _ = corpus.ADVERSARIAL_CASES[case](device=CPU)
    fr_j, fr_t = jax_frontiers(lat_j), lattice_frontiers(lat_t)
    np.testing.assert_array_equal(np.asarray(fr_j.pidx), fr_t.pidx.numpy())
    dead = np.argwhere(~np.asarray(lat_j.arc_mask))
    perturbed = [("clean", lambda f, np_: f),
                 ("pidx+1", lambda f, np_: f._replace(pidx=f.pidx + 1)),
                 ("sidx+1", lambda f, np_: f._replace(sidx=f.sidx + 1))]
    if len(dead):
        b, a = dead[0]

        def live(f, np_):
            ap = np.array(f.arc_pos)
            ap[b, a] = 0
            return f._replace(arc_pos=jnp.asarray(ap) if np_ == "jax"
                              else torch.from_numpy(ap))
        perturbed.append(("masked->live", live))
    for tag, bend in perturbed:
        want = jax_rules.check_frontier_invariants(lat_j, bend(fr_j, "jax"))
        got = rules_kernel.check_frontier_invariants(lat_t,
                                                     bend(fr_t, "torch"))
        assert got == want, tag
        assert (tag == "clean") == (got == [])


def test_ks004_same_failures_as_the_reference():
    lat_j, T, K = jax_corpus.max_fanin_case()
    lat_t, _, _ = corpus.max_fanin_case(device=CPU)
    lp_j = jax_sanitize._log_probs(lat_j, T, K, seed=7)
    lp_t = sanitize_kernels._log_probs(lat_t, T, K, seed=7)
    np.testing.assert_allclose(np.asarray(lp_j), lp_t.numpy(), atol=1e-6)
    fr_j, fr_t = jax_frontiers(lat_j), lattice_frontiers(lat_t)
    args_j = jax_sanitize._dag_layout(lat_j, lp_j) + (fr_j.pidx,)
    args_t = sanitize_kernels._dag_layout(lat_t, lp_t) + (fr_t.pidx,)
    from repro.kernels import ref as jax_ref
    want_j = jax_ref.dag_forward_ref(*args_j)
    want_t = ref.dag_forward_ref(*args_t)
    for a, b in zip(want_j, want_t):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-5,
                                   atol=1e-4)
    # the same perturbed outputs through both packages' rules
    got = [w.numpy().copy() for w in want_t]
    got[0][0, 1, 0] = np.nan
    got[1][0, 0, 2] += 1.0
    got[2][0] = np.inf
    labels = ("alpha", "c_alpha", "logZ", "c_avg")
    plain = [w.numpy() for w in want_t]
    for fn in ("check_finite", "diff_outputs"):
        extra = (plain,) if fn == "diff_outputs" else ()
        want = getattr(jax_rules, fn)("dag_forward[f32]", got, *extra,
                                      labels=labels)
        mine = getattr(rules_kernel, fn)(
            "dag_forward[f32]", [torch.from_numpy(g) for g in got],
            *[[torch.from_numpy(p) for p in e] for e in extra],
            labels=labels)
        assert mine == want and len(mine) >= 2, fn
