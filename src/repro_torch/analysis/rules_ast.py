"""reprolint's AST rules for the port: repo-specific invariants of
``src/repro_torch``.

Port of ``repro.analysis.rules_ast`` in torch's idiom, under the same
rule ids and escape hatches.  Every rule has an ``RLxxx`` id, a one-line
summary and a reason tied to how this code breaks.  Most rules apply only
on the *device path*: the modules whose functions run between a caller's
tensors on the card and the kernels (``repro_torch/{kernels,
lattice_engine,losses,core,models,serving}/``, decided by ``lint``), where
a host sync stalls the launch queue and host numpy either fails on a CUDA
tensor or copies it back.

  RL001  no ``np.*`` inside device-path functions
  RL002  no host sync there: ``.item()``, ``.tolist()``, ``.cpu()``,
         ``.numpy()``, ``np.asarray``/``np.array``,
         ``torch.cuda.synchronize``
  RL003  no Python ``if``/``while`` whose test calls ``torch.*`` (its
         ``is_*``/``get_*``/``current_*`` queries aside) or a tensor reduction: the
         branch waits for the card and decides on data
  RL004  (``lint.check_kernel_oracles``) every public wrapper in
         ``kernels/`` that reaches ``build.launch`` has a plain version
         ``<name>_ref`` in ``kernels/ref.py`` and is named in a
         ``tests/test_torch_*.py``; every ``csrc/*.cu`` is launched
  RL005  every ``torch.autograd.Function`` subclass defines
         ``backward``; every ``torch.library.custom_op`` registers its
         fake in the same module (``torch.func.linearize`` traces it)
  RL006  no raw ``logsumexp``/``softmax`` in ``lattice_engine/``
         outside the all-masked-row-safe ``masked_*`` helpers of
         ``lattice_engine/common.py``
  RL007  no float64 requests (``float64``, ``torch.double``,
         ``.double()``), anywhere

Escape hatches (annotations in the linted source):

  * ``# reprolint: host`` on a ``def`` line marks the function (and its
    nested functions) as host-side by design; the device-path rules skip
    it.  Say why on the same line.
  * ``# reprolint: disable=RL001[,RL002]`` on a line suppresses those
    rules for that line.
  * ``# reprolint: skip-file`` in the first ten lines skips the file.

The module is pure stdlib ``ast``: no torch import, so the lint runs in
milliseconds and never needs a card.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

HOST_MARKER = "# reprolint: host"
_DISABLE_RE = re.compile(r"#\s*reprolint:\s*disable=([A-Z0-9, ]+)")
_SKIP_FILE = "# reprolint: skip-file"

# the all-masked-row-safe helpers (lattice_engine.common and the plain
# versions' own copies in kernels/ref.py)
_SAFE_HELPERS = ("masked_logsumexp", "masked_softmax", "_masked_lse_rows",
                 "_masked_lse_row")
_RAW_REDUCERS = ("logsumexp", "softmax")
# tensor reductions whose value a Python branch would have to wait for
_REDUCTIONS = ("any", "all", "sum", "max", "min", "amax", "amin", "mean",
               "prod", "norm", "argmax", "argmin", "count_nonzero", "equal",
               "allclose")
# torch calls that answer from the host: queries and constructors
_HOST_QUERY_PREFIXES = ("is_", "are_", "get_", "has_", "current_")
_HOST_CONSTRUCTORS = ("Size", "device", "dtype", "finfo", "iinfo")
_F64_NAMES = ("float64", "double")  # reprolint: disable=RL007


@dataclass(frozen=True)
class Violation:
    rule: str            # "RL001"
    path: str            # the file as given
    line: int            # 1-based
    msg: str

    def __str__(self):
        return f"{self.path}:{self.line}: {self.rule} {self.msg}"

    def to_json(self):
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "msg": self.msg}


class Scope(NamedTuple):
    """Which rule families apply to a file (decided by ``lint`` from the
    file's location; tests force scopes on fixture files)."""
    device: bool = False          # a device-path module (RL001/2/3)
    masked_domain: bool = False   # reduces over masked arc axes (RL006)


class _Ctx:
    """Per-file facts shared by all rules."""

    def __init__(self, tree: ast.Module, text: str, path: str,
                 scope: Scope):
        self.tree = tree
        self.path = path
        self.scope = scope
        self.lines = text.splitlines()
        # numpy and torch aliases bound by imports in this module
        self.np_aliases: set = set()
        self.torch_aliases: set = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "numpy":
                        self.np_aliases.add(a.asname or "numpy")
                    if a.name == "torch":
                        self.torch_aliases.add(a.asname or "torch")
        # spans (lineno, end_lineno) of functions marked host-side
        self.host_spans: List[Tuple[int, int]] = []
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                line = self.lines[node.lineno - 1]
                if HOST_MARKER in line:
                    self.host_spans.append((node.lineno, node.end_lineno))
        # line -> set of disabled rule ids
        self.disabled: Dict[int, set] = {}
        for i, line in enumerate(self.lines, 1):
            m = _DISABLE_RE.search(line)
            if m:
                self.disabled[i] = {r.strip()
                                    for r in m.group(1).split(",")}

    def is_host(self, node: ast.AST) -> bool:
        ln = getattr(node, "lineno", None)
        return ln is not None and any(lo <= ln <= hi
                                      for lo, hi in self.host_spans)

    def device_functions(self):
        """Function defs not marked host-side."""
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and not self.is_host(node):
                yield node

    def allowed(self, rule: str, line: int) -> bool:
        return rule not in self.disabled.get(line, ())


def _dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for an Attribute/Name chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _callee(call: ast.Call) -> Tuple[str, List[str]]:
    """(the called name, the dotted parts of what it is called on): a
    method called on any expression keeps its name, ``(x > 0).any()``
    giving ("any", [])."""
    d = _dotted(call.func)
    if d is not None:
        parts = d.split(".")
        return parts[-1], parts[:-1]
    if isinstance(call.func, ast.Attribute):
        return call.func.attr, []
    return "", []


def _own_nodes(fn):
    """The nodes of ``fn``'s body, its nested defs excluded (they are
    visited as functions of their own)."""
    stack = list(fn.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _waits_for_device(node: ast.AST, ctx: _Ctx) -> bool:
    """Does the expression call ``torch.*`` (but a host query) or a
    tensor reduction method?"""
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Call):
            continue
        leaf, owner = _callee(sub)
        if owner and owner[0] in ctx.torch_aliases:
            if not (leaf.startswith(_HOST_QUERY_PREFIXES)
                    or leaf in _HOST_CONSTRUCTORS):
                return True
        elif isinstance(sub.func, ast.Attribute) and leaf in _REDUCTIONS \
                and not (owner and owner[0] in ctx.np_aliases):
            return True
    return False


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------

def rule_RL001(ctx: _Ctx) -> List[Violation]:
    """host-numpy-on-device-path: no ``np.*`` inside device-path
    functions.  Host numpy there either fails on a CUDA tensor or copies
    it to the host and back.  Host-side builders (lattice construction,
    packing) carry ``# reprolint: host``."""
    out = []
    if not ctx.scope.device or not ctx.np_aliases:
        return out
    for fn in ctx.device_functions():
        for node in _own_nodes(fn):
            if isinstance(node, ast.Name) and node.id in ctx.np_aliases \
                    and isinstance(node.ctx, ast.Load) \
                    and ctx.allowed("RL001", node.lineno):
                out.append(Violation(
                    "RL001", ctx.path, node.lineno,
                    f"host numpy ({node.id}.*) inside device-path function "
                    f"{fn.name!r}: use torch, or mark the function "
                    f"'# reprolint: host'"))
    return sorted(set(out), key=lambda v: v.line)


def rule_RL002(ctx: _Ctx) -> List[Violation]:
    """host-sync-on-device-path: no ``.item()``, ``.tolist()``,
    ``.cpu()``, ``.numpy()``, ``np.asarray(x)``/``np.array(x)`` or
    ``torch.cuda.synchronize()`` inside device-path functions.  Each
    waits for the card and serialises the launch queue."""
    out = []
    if not ctx.scope.device:
        return out
    for fn in ctx.device_functions():
        for node in _own_nodes(fn):
            if not isinstance(node, ast.Call):
                continue
            leaf, owner = _callee(node)
            root = owner[0] if owner else None
            bad = None
            if leaf in ("item", "tolist", "cpu", "numpy") \
                    and isinstance(node.func, ast.Attribute) \
                    and root not in ctx.np_aliases:
                bad = f".{leaf}() host sync"
            elif root in ctx.np_aliases and leaf in ("asarray", "array"):
                bad = f"{root}.{leaf}() host copy"
            elif root in ctx.torch_aliases and owner[1:] == ["cuda"] \
                    and leaf == "synchronize":
                bad = f"{root}.cuda.synchronize() host sync"
            if bad and ctx.allowed("RL002", node.lineno):
                out.append(Violation(
                    "RL002", ctx.path, node.lineno,
                    f"{bad} inside device-path function {fn.name!r}"))
    return sorted(set(out), key=lambda v: v.line)


def rule_RL003(ctx: _Ctx) -> List[Violation]:
    """python-branch-on-device-value: no Python ``if``/``while`` (or
    conditional expression) whose test calls ``torch.*`` or a tensor
    reduction.  The branch waits for the card, and a data-dependent
    branch breaks ``torch.func`` transforms and CUDA graphs.  Use
    ``torch.where``, or decide on the host by design and say so."""
    out = []
    if not ctx.scope.device:
        return out
    for fn in ctx.device_functions():
        for node in _own_nodes(fn):
            if not isinstance(node, (ast.If, ast.While, ast.IfExp)):
                continue
            if not _waits_for_device(node.test, ctx) \
                    or not ctx.allowed("RL003", node.lineno):
                continue
            kind = {"If": "if", "While": "while",
                    "IfExp": "conditional expression"}[type(node).__name__]
            out.append(Violation(
                "RL003", ctx.path, node.lineno,
                f"Python {kind} on a device value in {fn.name!r}: use "
                f"torch.where, or mark the function '# reprolint: host'"))
    return sorted(set(out), key=lambda v: v.line)


def _decorator_target(dec) -> str:
    """Dotted name of a decorator, looking through a Call decorator
    (``@torch.library.custom_op("ns::op", ...)``)."""
    if isinstance(dec, ast.Call):
        return _dotted(dec.func) or ""
    return _dotted(dec) or ""


def rule_RL005(ctx: _Ctx) -> List[Violation]:
    """derivative-unregistered: every ``torch.autograd.Function``
    subclass defines ``backward``, and every ``torch.library.custom_op``
    registers its fake (``register_fake``) in the same module.  A
    Function without a backward runs forward and fails only when the
    optimiser first differentiates through it, at CG-product depth; a
    custom op without a fake fails when ``torch.func.linearize`` traces
    it."""
    out = []
    ops: Dict[str, int] = {}
    faked: set = set()
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.ClassDef):
            bases = [_dotted(b) or "" for b in node.bases]
            if any(b == "Function" or b.endswith("autograd.Function")
                   for b in bases):
                methods = {n.name for n in node.body
                           if isinstance(n, ast.FunctionDef)}
                if "backward" not in methods \
                        and ctx.allowed("RL005", node.lineno):
                    out.append(Violation(
                        "RL005", ctx.path, node.lineno,
                        f"autograd.Function {node.name!r} defines no "
                        f"backward: differentiating through it fails at "
                        f"CG-product depth"))
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                d = _decorator_target(dec)
                if d.endswith("custom_op"):
                    ops[node.name] = node.lineno
                if d.endswith(".register_fake"):
                    faked.add(d.rsplit(".", 1)[0])
        elif isinstance(node, ast.Call):
            d = _dotted(node.func) or ""
            if d.endswith(".register_fake"):
                faked.add(d.rsplit(".", 1)[0])
    for name, line in ops.items():
        if name not in faked and ctx.allowed("RL005", line):
            out.append(Violation(
                "RL005", ctx.path, line,
                f"custom_op {name!r} registers no fake in this module: "
                f"torch.func.linearize cannot trace it"))
    return sorted(set(out), key=lambda v: v.line)


def rule_RL006(ctx: _Ctx) -> List[Violation]:
    """unsafe-masked-reduction: in the lattice engine every reduction
    axis is a padded arc or frontier axis, so a raw ``logsumexp`` or
    ``softmax`` gives an all-masked row -inf and NaN gradients.  Use the
    ``masked_*`` helpers of ``lattice_engine.common``."""
    out = []
    if not ctx.scope.masked_domain:
        return out
    safe_spans = [(n.lineno, n.end_lineno) for n in ast.walk(ctx.tree)
                  if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                  and n.name in _SAFE_HELPERS]
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        leaf = (_dotted(node.func) or "").split(".")[-1]
        if leaf not in _RAW_REDUCERS or ctx.is_host(node) \
                or any(lo <= node.lineno <= hi for lo, hi in safe_spans) \
                or not ctx.allowed("RL006", node.lineno):
            continue
        out.append(Violation(
            "RL006", ctx.path, node.lineno,
            f"raw {leaf} in a masked-domain module: arc/frontier axes are "
            f"padded; use the masked_* helpers of lattice_engine.common"))
    return sorted(set(out), key=lambda v: v.line)


def rule_RL007(ctx: _Ctx) -> List[Violation]:
    """f64-request: no float64 dtype requests in library code
    (``torch.float64``, ``torch.double``, ``.double()``, ``np.float64``,
    ``'float64'``).  f64 on the card runs at a sixtieth of the f32 rate
    and doubles the CG state; host folds that need it say so with
    ``disable=RL007``."""
    out = []
    for node in ast.walk(ctx.tree):
        line = what = None
        if isinstance(node, ast.Attribute) and node.attr in _F64_NAMES:
            line, what = node.lineno, _dotted(node) or f".{node.attr}"
        elif isinstance(node, ast.Constant) and node.value in _F64_NAMES:
            line, what = node.lineno, repr(node.value)
        if line is not None and ctx.allowed("RL007", line):
            out.append(Violation(
                "RL007", ctx.path, line,
                f"f64 dtype request ({what}): use float32/bfloat16, or say "
                f"why with '# reprolint: disable=RL007'"))
    return sorted(set(out), key=lambda v: v.line)


# rule id -> (fn, summary).  RL004 (the wrapper/oracle/test pairing) is a
# repo-level rule and lives in ``lint.check_kernel_oracles``.
RULES: Dict[str, Tuple[Callable[[_Ctx], List[Violation]], str]] = {
    "RL001": (rule_RL001, "no host numpy inside device-path functions"),
    "RL002": (rule_RL002, "no .item()/.tolist()/.cpu()/.numpy()/"
                          "np.asarray/torch.cuda.synchronize host sync "
                          "inside device-path functions"),
    "RL003": (rule_RL003, "no Python if/while on a device value"),
    "RL005": (rule_RL005, "autograd.Function defines backward; custom_op "
                          "registers its fake"),
    "RL006": (rule_RL006, "no raw logsumexp/softmax in the lattice engine "
                          "outside the masked_* helpers"),
    "RL007": (rule_RL007, "no float64 requests in library code"),
}


def lint_source(text: str, path: str, scope: Scope) -> List[Violation]:
    """Run every AST rule over one file's source."""
    head = "\n".join(text.splitlines()[:10])
    if _SKIP_FILE in head:
        return []
    try:
        tree = ast.parse(text)
    except SyntaxError as e:
        return [Violation("RL000", path, e.lineno or 0,
                          f"syntax error: {e.msg}")]
    ctx = _Ctx(tree, text, path, scope)
    out: List[Violation] = []
    for fn, _ in RULES.values():
        out.extend(fn(ctx))
    return sorted(out, key=lambda v: (v.path, v.line, v.rule))
