"""The port's training loop on the CPU: checkpointed resume, parity
with the reference's ``train_sequence``, the CLI and the paper's example.

  * Resume: a run killed after update 2 and resumed equals the
    uninterrupted 4-update run bitwise (parameters and logged metrics),
    for SGD (gradient batches cycling over ``dataset_batches=3``, so the
    cycle crosses the resume point), Adam, NGHF with ``warm_start`` and
    ``adapt_lam``, and NGHF with ``fisher_diag``, ``warm_start`` and a
    curvature-sample schedule whose boundary (update 3) falls after the
    resume point.
  * Parity: the reference's ``train_sequence(init_params=p)`` and
    the port's ``train_sequence(init_params=convert(p))`` on the same
    seeds — Adam/CE 3 steps, SGD/MPE 3 steps, NGHF/MPE 2 steps.  Final
    parameters, and the run's whole step from the start, within relative
    L2 1e-4 (the bound of ``test_torch_optim.py``'s one-step test), the
    logged losses within rtol 1e-5, NGHF's best iterate and acceptance
    exactly.
  * The CLI ``main([...])``: one step of each ``*-asr`` arch, checkpoint
    then ``--resume``, ``--log-json``, an LM arch's ``--mesh`` of more
    ranks than the run has (refused before a process group starts), and
    one step of the windowed LM archs, refused until ROADMAP 1.3.3.
  * The example's pipeline (``repro_torch.examples.train_asr_mpe``) at
    its default config with one NGHF update prints the four-row table
    with finite values.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.acoustic import LSTM  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import acoustic as JA  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.acoustic import ASR_ARCHS  # noqa: E402
from repro_torch.configs.acoustic import LSTM as TLSTM  # noqa: E402
from repro_torch.examples import train_asr_mpe  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402

CFG, TCFG = LSTM.smoke(), TLSTM.smoke()
REL_L2 = 1e-4
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """PyTorch on one thread for this module: beside the suite's parallel
    workers the default thread pool oversubscribes the cores and
    multiplies the file's time (the example's test: 13 s alone on one
    thread, 245-449 s with the default pool in the suite)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_l2(got: dict, want: dict) -> float:
    num = sum(float(((got[k].numpy() - want[k]) ** 2).sum()) for k in want)
    den = sum(float((want[k] ** 2).sum()) for k in want)
    return (num / max(den, 1e-30)) ** 0.5


RESUME_CASES = {
    "sgd": dict(optimizer="sgd", dataset_batches=3),
    "adam": dict(optimizer="adam"),
    "nghf": dict(optimizer="nghf", warm_start=True, adapt_lam=True),
    "nghf_schedule": dict(optimizer="nghf", warm_start=True,
                          preconditioner="fisher_diag",
                          curvature_sample_schedule="0:1.0,3:0.5"),
}


@pytest.mark.parametrize("case", sorted(RESUME_CASES))
def test_kill_and_resume_matches_uninterrupted(tmp_path, case):
    kw = dict(acfg=TCFG, loss="mpe", batch=4, cg_batch=4, frames=16,
              cg_iters=2, ng_iters=1, verbose=False, device="cpu",
              **RESUME_CASES[case])
    ck = str(tmp_path / "ck")
    p_full, log_full = ttrain.train_sequence(steps=4, **kw)
    ttrain.train_sequence(steps=2, ckpt_dir=ck, **kw)
    p_res, log = ttrain.train_sequence(steps=4, ckpt_dir=ck, resume=True,
                                       **kw)
    assert [m["step"] for m in log] == [2, 3]
    for k, v in p_full.items():
        assert torch.equal(v, p_res[k]), k
    for a, b in zip(log_full[2:], log):
        assert {k: v for k, v in a.items() if k != "time_s"} \
            == {k: v for k, v in b.items() if k != "time_s"}


PARITY_CASES = {
    "adam_ce": dict(optimizer="adam", loss="ce", steps=3),
    "sgd_mpe": dict(optimizer="sgd", loss="mpe", steps=3),
    "nghf_mpe": dict(optimizer="nghf", loss="mpe", steps=2, cg_iters=3,
                     ng_iters=1),
}


@pytest.mark.parametrize("case", sorted(PARITY_CASES))
def test_train_sequence_matches_reference(case):
    kw = dict(batch=8, cg_batch=8, frames=24, verbose=False,
              **PARITY_CASES[case])
    jp = JA.init_params(CFG, jax.random.PRNGKey(3))
    jp_np = jax.tree.map(np.asarray, jp)
    jnew, jlog = jtrain.train_sequence(acfg=CFG, init_params=jp, **kw)
    tnew, tlog = ttrain.train_sequence(
        acfg=TCFG, init_params=convert.acoustic_params_from_numpy(
            jp_np, device="cpu"), device="cpu", **kw)
    want, p0 = ({f"{k}.{n}": np.asarray(a) for k, v in tree.items()
                 for n, a in v.items()} for tree in (jnew, jp_np))
    assert _rel_l2(tnew, want) <= REL_L2
    # and the whole run's step from the start (measured about 2e-6)
    assert _rel_l2({k: v - torch.from_numpy(p0[k]) for k, v in tnew.items()},
                   {k: want[k] - p0[k] for k in p0}) <= REL_L2
    assert len(tlog) == len(jlog) == kw["steps"]
    for mt, mj in zip(tlog, jlog):
        assert mt["step"] == mj["step"]
        np.testing.assert_allclose(mt["loss"], mj["loss"], rtol=LOSS_RTOL)
        if kw["optimizer"] == "nghf":
            for key in ("cg_best_iter", "cg_accepted"):
                assert mt[key] == mj[key], key


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

CLI = ["--smoke", "--device", "cpu", "--batch", "4", "--cg-batch", "4",
       "--frames", "16", "--cg-iters", "2", "--ng-iters", "1"]


@pytest.mark.parametrize("arch", sorted(ASR_ARCHS))
def test_cli_one_step_each_arch(arch):
    extra = [] if arch == "lstm-asr" else ["--preconditioner",
                                          "share_counts"]
    log = ttrain.main(["--arch", arch, "--steps", "1", "--cg-fused"]
                      + CLI + extra)
    assert len(log) == 1 and log[0]["step"] == 0
    assert all(np.isfinite(v) for v in log[0].values())


def test_cli_checkpoint_resume_and_log_json(tmp_path):
    ck, lj = str(tmp_path / "ck"), str(tmp_path / "log.json")
    args = ["--arch", "lstm-asr", "--ckpt-dir", ck, "--warm-start"] + CLI
    first = ttrain.main(args + ["--steps", "2"])
    assert [m["step"] for m in first] == [0, 1]
    log = ttrain.main(args + ["--steps", "3", "--resume", "--log-json", lj])
    assert log[0]["step"] == 2 and len(log) == 1
    with open(lj) as f:
        assert json.load(f) == log


@pytest.mark.parametrize("argv,item", [
    (["--arch", "qwen2.5-3b", "--mesh", "4x2"], "ROADMAP 1.4"),
    (["--arch", "recurrentgemma-9b"], "ROADMAP 1.3"),
    (["--arch", "lm-mixtral-8x22b"], "ROADMAP 1.3"),
])
def test_cli_refuses_what_is_not_ported(argv, item):
    """An LM arch's mesh (ROADMAP 1.4; its second part trains the LM
    archs on a mesh, ``tests/test_torch_mesh_lm.py``) needs as many
    ranks as the mesh has: a one-process run of a 4x2 mesh is refused
    before any process group starts.  The windowed archs were
    refused, naming ROADMAP 1.3, until its item 1.3.3 gave their attention
    derivative kernels on the card: now the CLI trains them (one smoke
    step each)."""
    if item == "ROADMAP 1.4":
        with pytest.raises(RuntimeError, match="needs 8 ranks"):
            ttrain.main(argv + CLI)
        return
    log = ttrain.main(argv + CLI + ["--steps", "1", "--seq", "16"])
    assert len(log) == 1 and all(np.isfinite(v) for v in log[0].values())


def test_example_prints_the_table(capsys):
    out = train_asr_mpe.run_pipeline(updates=1, device="cpu",
                                     verbose=False)
    text = capsys.readouterr().out
    table = text[text.index("optimiser  #updates"):].splitlines()[1:]
    rows = [line.split() for line in table if line.strip()]
    assert [r[0] for r in rows] == ["CE", "NGHF", "SGD", "Adam"]
    assert [int(r[1]) for r in rows] == [0, 1, 20, 20]
    assert all(np.isfinite(float(r[2])) and np.isfinite(float(r[3]))
               for r in rows)
    assert list(out["rows"]) == ["CE", "NGHF", "SGD", "Adam"]
    (m,) = out["nghf_log"]
    assert np.isfinite(m["cg_curv_first"]) and np.isfinite(m["cg_curv_last"])
    assert "[nghf] update 0: accepted" in text
