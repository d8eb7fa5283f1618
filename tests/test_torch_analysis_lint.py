"""The port's reprolint (``repro_torch.analysis.lint``): every rule
catches its seeded fixture under ``tests/fixtures/torch_lint/`` and
nothing else, the escape hatches work, the CLI exits 0, 1 and 2 as the
reference's does, RL007 agrees with the reference's on the reference's
own fixture, and ``src/repro_torch`` is clean."""
import os

import pytest

from repro.analysis import rules_ast as jax_rules_ast
from repro.analysis.lint import scope_for as jax_scope_for
from repro_torch.analysis.lint import (check_kernel_oracles, iter_py_files,
                                       main, run_lint, scope_for)
from repro_torch.analysis.rules_ast import Scope, lint_source

HERE = os.path.dirname(__file__)
FIXTURES = os.path.join(HERE, "fixtures", "torch_lint")
SRC = os.path.join(HERE, "..", "src")

DEVICE = Scope(device=True)


def rules_of(violations):
    return sorted({v.rule for v in violations})


def _fixture(*parts):
    return os.path.join(FIXTURES, "src", "repro_torch", *parts)


# ---------------------------------------------------------------------------
# fixtures: every seeded violation is caught, and only those
# ---------------------------------------------------------------------------

def test_device_path_fixture_flags_rl001_002_003_007():
    path = _fixture("kernels", "bad_device.py")
    vs = run_lint([path])
    assert rules_of(vs) == ["RL001", "RL002", "RL003", "RL007"]
    text = open(path).read().splitlines()
    lines = {v.rule: text[v.line - 1] for v in vs}
    assert len(vs) == 4
    assert "np.exp" in lines["RL001"] and ".item()" in lines["RL002"]
    assert "torch.any" in lines["RL003"]
    assert "float64" in lines["RL007"]  # reprolint: disable=RL007


def test_function_fixture_flags_only_the_unregistered():
    vs = run_lint([_fixture("core", "bad_function.py")])
    assert rules_of(vs) == ["RL005"]
    msgs = " ".join(v.msg for v in vs)
    assert len(vs) == 2 and "Forgotten" in msgs and "unfaked" in msgs
    assert "Registered" not in msgs and "'faked'" not in msgs


def test_masked_domain_fixture_flags_rl006():
    vs = run_lint([_fixture("lattice_engine", "bad_masked.py")])
    assert rules_of(vs) == ["RL006"]
    assert len(vs) == 2            # raw logsumexp + .softmax, not the helper


def test_rl004_missing_plain_version_test_and_launch():
    tree = os.path.join(FIXTURES, "kernel_tree")
    vs = check_kernel_oracles(tree, tests_root=os.path.join(tree, "no"))
    assert [v.rule for v in vs] == ["RL004", "RL004"]
    msgs = " ".join(v.msg for v in vs)
    assert "orphan_kernel_ref" in msgs and "unlaunched.cu" in msgs
    assert "paired_kernel" not in msgs and "_private" not in msgs
    assert "used.cu" not in msgs


def test_rl004_missing_test(tmp_path):
    tests = tmp_path / "tests"
    tests.mkdir()
    (tests / "test_torch_x.py").write_text("def test_paired_kernel(): pass\n")
    (tests / "test_other.py").write_text("orphan_kernel\n")   # not a port test
    tree = os.path.join(FIXTURES, "kernel_tree")
    msgs = [v.msg for v in check_kernel_oracles(tree, tests_root=str(tests))]
    assert any("'orphan_kernel' is not named" in m for m in msgs)
    assert not any("'paired_kernel' is not named" in m for m in msgs)


@pytest.mark.parametrize("table, flagged", [
    ('LAUNCHERS = {"tabled_launch": "tabled"}', False),
    ('_LAUNCHERS = {"fwd": (("tabled", "tabled_launch"),)}', False),
    ('OTHER = {"tabled_launch": "tabled"}', True),
])
def test_rl004_reads_the_launcher_table(tmp_path, table, flagged):
    kdir = tmp_path / "repro_torch" / "kernels"
    (kdir / "csrc").mkdir(parents=True)
    (kdir / "csrc" / "tabled.cu").write_text("")
    (kdir / "ref.py").write_text("def tabled_kernel_ref(x): return x\n")
    (kdir / "tabled.py").write_text(
        "from repro_torch.kernels import build\n" + table + "\n\n"
        "def tabled_kernel(x, stem, fn):\n"
        "    build.launch(stem, {}, fn, x.device)\n")
    msgs = [v.msg for v in check_kernel_oracles(
        str(tmp_path), tests_root=str(tmp_path / "no"))]
    assert any("tabled.cu" in m for m in msgs) == flagged
    assert not any("tabled_kernel_ref" in m for m in msgs)


def test_rl004_holds_on_the_port():
    assert check_kernel_oracles(SRC) == []


# ---------------------------------------------------------------------------
# escape hatches + scoping
# ---------------------------------------------------------------------------

def test_host_marker_exempts_function():
    src = ("import numpy as np\n"
           "def builder(x):  # reprolint: host: numpy builder\n"
           "    return np.asarray(x).tolist()\n")
    assert lint_source(src, "f.py", DEVICE) == []


def test_disable_comment_is_rule_specific():
    src = "import numpy as np\ndef f(x):\n    return np.exp(x)\n"
    ok = src.replace("np.exp(x)", "np.exp(x)  # reprolint: disable=RL001")
    other = src.replace("np.exp(x)", "np.exp(x)  # reprolint: disable=RL002")
    assert lint_source(ok, "f.py", DEVICE) == []
    assert rules_of(lint_source(other, "f.py", DEVICE)) == ["RL001"]


def test_skip_file():
    src = ("# reprolint: skip-file\n"
           "import numpy as np\n"
           "def f(x):\n    return np.exp(x)\n")
    assert lint_source(src, "f.py", DEVICE) == []


@pytest.mark.parametrize("call", ["x.cpu()", "x.numpy()", "x.tolist()",
                                  "np.array(x)", "torch.cuda.synchronize()"])
def test_rl002_host_syncs(call):
    src = f"import numpy as np\nimport torch\ndef f(x):\n    return {call}\n"
    assert "RL002" in rules_of(lint_source(src, "f.py", DEVICE))
    assert lint_source(src, "f.py", Scope()) == []


@pytest.mark.parametrize("test,flagged", [
    ("(x > 0).any()", True), ("x.sum() > 0", True), ("torch.equal(x, y)", True),
    ("torch.is_grad_enabled()", False), ("x.numel() == 0", False),
    ("torch.cuda.current_device() == 0", False), ("any(y)", False)])
def test_rl003_tests_that_wait_for_the_card(test, flagged):
    src = (f"import torch\ndef f(x, y):\n    while {test}:\n"
           f"        x = x - 1\n    return x\n")
    assert (rules_of(lint_source(src, "f.py", DEVICE)) == ["RL003"]) \
        == flagged


def test_scope_for_paths():
    assert scope_for("src/repro_torch/kernels/lattice_fb.py").device
    assert scope_for("src/repro_torch/serving/service.py").device
    assert scope_for("src/repro_torch/lattice_engine/common.py").masked_domain
    assert not scope_for("src/repro_torch/launch/train.py").device
    assert not scope_for("src/repro_torch/analysis/lint.py").device
    assert not scope_for("src/repro/kernels/lattice_fb.py").device


# ---------------------------------------------------------------------------
# against the reference, the real tree, the CLI
# ---------------------------------------------------------------------------

def test_rl007_matches_the_reference_on_its_fixture():
    path = os.path.join(HERE, "fixtures", "lint", "src", "repro", "kernels",
                        "bad_traced.py")
    text = open(path).read()
    want = [(v.line, v.rule) for v in jax_rules_ast.lint_source(
        text, path, jax_scope_for(path)) if v.rule == "RL007"]
    got = [(v.line, v.rule) for v in lint_source(text, path, DEVICE)
           if v.rule == "RL007"]
    assert got == want and len(got) == 1


def test_src_tree_is_clean():
    vs = run_lint([os.path.join(SRC, "repro_torch")])
    assert vs == [], "\n".join(str(v) for v in vs)


def test_iter_py_files_dedups_and_sorts(tmp_path):
    (tmp_path / "a.py").write_text("x = 1\n")
    (tmp_path / "b.txt").write_text("not python\n")
    got = iter_py_files([str(tmp_path), str(tmp_path / "a.py")])
    assert got == [str(tmp_path / "a.py")]


def test_cli_exit_codes(capsys, tmp_path):
    bad = os.path.join(FIXTURES, "src")
    assert main([bad]) == 1
    assert main([bad, "--json"]) == 1
    assert '"rule": "RL001"' in capsys.readouterr().out
    assert main([os.path.join(SRC, "repro_torch", "analysis")]) == 0
    assert main(["--list-rules", bad]) == 0
    assert "RL004" in capsys.readouterr().out
    assert main([str(tmp_path / "no_such_dir")]) == 2
    assert "does not exist" in capsys.readouterr().err
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "README.md").write_text("not python\n")
    assert main([str(empty)]) == 2
    assert "no .py files" in capsys.readouterr().err
    good = os.path.join(SRC, "repro_torch", "analysis", "corpus.py")
    assert main([good, str(tmp_path / "typo")]) == 2
    assert main([good]) == 0
