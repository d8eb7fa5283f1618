"""Import guard: the port and ``chip_smoke.py`` never import JAX or the
JAX package ``repro`` (the machine with the card has no JAX), and
importing the service leaves ``jax`` out of ``sys.modules``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_port_tree_is_nonempty():
    assert len(PORT_FILES) > 10
    for src in ("lattice_dag.cu", "lattice_sausage.cu", "cg_fused.cu",
                "swa_attention.cu"):
        assert (ROOT / "src" / "repro_torch" / "kernels" / "csrc"
                / src).exists()


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_forbidden_names():
    assert _forbidden("jax.numpy") and _forbidden("repro.serving")
    assert _forbidden("repro") and not _forbidden("repro_torch.serving")


def test_service_import_leaves_jax_out():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = ("import sys, repro_torch.serving.service, repro_torch.convert, "
            "repro_torch.analysis.corpus, repro_torch.launch.train, "
            "repro_torch.kernels.cg_fused, repro_torch.launch.serve, "
            "repro_torch.kernels.swa_attention, repro_torch.models.registry; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')); print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
