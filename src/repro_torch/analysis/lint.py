"""reprolint for the port: the repo-specific AST lint of ``src/repro_torch``.

    python -m repro_torch.analysis.lint src/repro_torch          # exit 1 on
    python -m repro_torch.analysis.lint src/repro_torch --json   # findings
    python -m repro_torch.analysis.lint --list-rules x

Port of ``repro.analysis.lint``.  Scoping (which rule families apply
where) is decided here from a file's location; the rules live in
``rules_ast``.  One repo-level rule (RL004, the pairing of each kernel
wrapper with its plain version and a test, and of each CUDA source with
a launch) needs facts across files and is implemented below.  Exit codes:
0 clean, 1 violations, 2 a path that does not exist or holds no ``.py``
file.
"""
from __future__ import annotations

import argparse
import ast
import json
import os
import sys
from typing import Dict, Iterable, List, Optional

from repro_torch.analysis.rules_ast import (RULES, Scope, Violation, _dotted,
                                            lint_source)

# modules whose functions run on the device path (RL001/RL002/RL003).
# Everything else (launch entry points, data pipeline, checkpoint IO, configs,
# analysis) is host-side by construction.
DEVICE_PREFIXES = (
    "repro_torch/kernels/",
    "repro_torch/lattice_engine/",
    "repro_torch/losses/",
    "repro_torch/core/",
    "repro_torch/models/",
    # serving: the dispatch runs on the device path; the host-side packing
    # and queueing helpers carry '# reprolint: host'
    "repro_torch/serving/",
)
# modules whose reduction axes are padded arc/frontier axes (RL006)
MASKED_DOMAIN_PREFIXES = ("repro_torch/lattice_engine/",)

# RL004 geography
KERNEL_DIR = "repro_torch/kernels"
ORACLE_FILE = "repro_torch/kernels/ref.py"
# the plain versions themselves, the build module and the capture hook
KERNEL_EXEMPT = ("ref.py", "__init__.py", "build.py", "instrument.py")
# public wrappers whose plain version has another name
ORACLE_OF: Dict[str, str] = {
    "launch_dq": "swa_attention_vjp_ref",
    "launch_dkdv": "swa_attention_vjp_ref",
    "cuda_core_swa_attention": "swa_attention_ref",
}
# public helpers that reach ``build.launch`` for the wrappers of their
# module and compute nothing of their own
LAUNCH_HELPERS = ("launch",)
# module-level tables of launcher -> library that the wrappers launch from
LAUNCHER_TABLES = ("LAUNCHERS", "_LAUNCHERS")


def _module_rel(relpath: str) -> str:
    rel = relpath.replace(os.sep, "/")
    # anchor-independent: strip everything before repro_torch/
    if "/repro_torch/" in rel:
        rel = "repro_torch/" + rel.split("/repro_torch/", 1)[1]
    return rel


def scope_for(relpath: str) -> Scope:
    rel = _module_rel(relpath)
    return Scope(device=rel.startswith(DEVICE_PREFIXES),
                 masked_domain=rel.startswith(MASKED_DOMAIN_PREFIXES))


def iter_py_files(paths: Iterable[str]) -> List[str]:
    out = []
    for p in paths:
        if os.path.isfile(p) and p.endswith(".py"):
            out.append(p)
        elif os.path.isdir(p):
            for root, _dirs, files in os.walk(p):
                if "__pycache__" in root:
                    continue
                out.extend(os.path.join(root, f) for f in sorted(files)
                           if f.endswith(".py"))
    return sorted(set(out))


# ---------------------------------------------------------------------------
# RL004: every wrapper that launches needs a plain version and a test;
# every CUDA source needs a launch
# ---------------------------------------------------------------------------

def _calls(node) -> set:
    """Root names of everything ``node`` calls, ``a.b(...)`` as ``a.b``
    and ``a``."""
    out = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            d = _dotted(sub.func)
            if d:
                out.update((d, d.split(".")[0]))
    return out


def _launching(tree: ast.Module) -> tuple:
    """({top-level function: line} of those that reach ``build.launch``
    through this module's own functions and classes, {the string first
    arguments of calls to them or to ``build.launch``, and the strings of
    the module's launcher table ``LAUNCHERS`` / ``_LAUNCHERS``, from which
    a wrapper reads the library it launches})."""
    defs = {n.name: n for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
    calls = {name: _calls(n) for name, n in defs.items()}
    reach = {name for name, c in calls.items() if "build.launch" in c}
    changed = True
    while changed:
        changed = False
        for name, c in calls.items():
            if name not in reach and c & reach:
                reach.add(name)
                changed = True
    stems = set()
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id in LAUNCHER_TABLES
                for t in node.targets):
            stems.update(c.value for c in ast.walk(node.value)
                         if isinstance(c, ast.Constant)
                         and isinstance(c.value, str))
    for sub in ast.walk(tree):
        if isinstance(sub, ast.Call) and sub.args \
                and isinstance(sub.args[0], ast.Constant) \
                and isinstance(sub.args[0].value, str):
            d = _dotted(sub.func) or ""
            if d == "build.launch" or d in reach:
                stems.add(sub.args[0].value)
    return ({name: defs[name].lineno for name in reach
             if isinstance(defs[name], ast.FunctionDef)}, stems)


def _defined_functions(text: str) -> set:
    try:
        tree = ast.parse(text)
    except SyntaxError:
        return set()
    return {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}


def check_kernel_oracles(src_root: str,
                         tests_root: Optional[str] = None
                         ) -> List[Violation]:
    """RL004: every public wrapper ``k`` in ``kernels/`` that reaches
    ``build.launch`` must have a plain version ``k_ref`` (or the one
    ``ORACLE_OF`` names) in ``kernels/ref.py`` AND be named in a
    ``tests/test_torch_*.py``; every ``kernels/csrc/*.cu`` must be the
    library of some launch.  A kernel without a plain version has no
    ground truth on the CPU, and a source nothing launches is dead."""
    out: List[Violation] = []
    kdir = os.path.join(src_root, KERNEL_DIR)
    if not os.path.isdir(kdir):
        return out
    oracle_path = os.path.join(src_root, ORACLE_FILE)
    oracles = set()
    if os.path.exists(oracle_path):
        with open(oracle_path) as f:
            oracles = _defined_functions(f.read())
    if tests_root is None:
        # src/ -> the repo root's tests/ (this repo's layout)
        tests_root = os.path.join(os.path.dirname(os.path.abspath(
            src_root.rstrip("/"))), "tests")
    test_text = ""
    if os.path.isdir(tests_root):
        for f in sorted(os.listdir(tests_root)):
            if f.startswith("test_torch") and f.endswith(".py"):
                with open(os.path.join(tests_root, f)) as fh:
                    test_text += fh.read()
    launched = set()
    for fname in sorted(os.listdir(kdir)):
        if not fname.endswith(".py") or fname in KERNEL_EXEMPT:
            continue
        path = os.path.join(kdir, fname)
        with open(path) as f:
            try:
                tree = ast.parse(f.read())
            except SyntaxError:
                continue
        wrappers, stems = _launching(tree)
        launched |= stems
        for name, line in sorted(wrappers.items(), key=lambda kv: kv[1]):
            if name.startswith("_") or name in LAUNCH_HELPERS:
                continue
            oracle = ORACLE_OF.get(name, f"{name}_ref")
            if oracle not in oracles:
                out.append(Violation(
                    "RL004", path, line,
                    f"kernel wrapper {name!r} has no plain version "
                    f"{oracle} in kernels/ref.py"))
            if test_text and name not in test_text:
                out.append(Violation(
                    "RL004", path, line,
                    f"kernel wrapper {name!r} is not named in any "
                    f"tests/test_torch_*.py (a kernel-vs-plain test is "
                    f"required)"))
    csrc = os.path.join(kdir, "csrc")
    if os.path.isdir(csrc):
        for fname in sorted(os.listdir(csrc)):
            stem, ext = os.path.splitext(fname)
            if ext == ".cu" and stem not in launched:
                out.append(Violation(
                    "RL004", os.path.join(csrc, fname), 1,
                    f"CUDA source {fname} is the library of no "
                    f"build.launch in kernels/"))
    return out


# ---------------------------------------------------------------------------
# the lint run
# ---------------------------------------------------------------------------

def run_lint(paths: Iterable[str]) -> List[Violation]:
    """Lint every .py file under ``paths``, with RL004 over each
    ``repro_torch`` tree they lie in; returns all violations."""
    violations: List[Violation] = []
    files = iter_py_files(paths)
    src_roots = set()
    for path in files:
        with open(path, encoding="utf-8") as f:
            text = f.read()
        violations.extend(lint_source(text, path, scope_for(path)))
        norm = path.replace(os.sep, "/")
        if "/repro_torch/" in norm:
            src_roots.add(norm.split("/repro_torch/", 1)[0] or ".")
        elif norm.startswith("repro_torch/"):
            src_roots.add(".")
    for root in sorted(src_roots):
        violations.extend(check_kernel_oracles(root))
    return sorted(set(violations), key=lambda v: (v.path, v.line, v.rule))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="the port's repo-specific AST lint (rule catalog: "
                    "repro_torch.analysis.rules_ast)")
    ap.add_argument("paths", nargs="+", help="files or directories")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)
    if args.list_rules:
        for rid, (_, summary) in sorted(RULES.items()):
            print(f"{rid}  {summary}")
        print("RL004  every kernel wrapper needs a plain version and a "
              "test; every CUDA source a launch")
        return 0
    # a lint run that silently scans nothing is worse than a failing one:
    # a mistyped path would report "0 violations" forever.  Exit 2, not
    # the violations-found 1, so callers can tell usage errors apart.
    missing = [p for p in args.paths if not os.path.exists(p)]
    if missing:
        for p in missing:
            print(f"error: path does not exist: {p}", file=sys.stderr)
        return 2
    if not iter_py_files(args.paths):
        print("error: no .py files found under: "
              + " ".join(args.paths), file=sys.stderr)
        return 2
    violations = run_lint(args.paths)
    if args.json:
        print(json.dumps([v.to_json() for v in violations], indent=1))
    else:
        for v in violations:
            print(v)
        n = len(violations)
        print(f"reprolint: {n} violation{'s' if n != 1 else ''} in "
              f"{len(iter_py_files(args.paths))} files")
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
