"""Layer 2 of the port's determinism auditor: AST lint over the source tree.

The torch counterpart of ``repro.analysis.ast_lint``.  Where the trace
rules (R1-R4) check the programs the registry runs, the AST rules catch
contract violations in the source, including code no registered program
runs.  Rules, with their scope under ``src/repro_torch``:

* ``raw-argmax``       — ``torch.argmax``/``torch.argmin``, or ``.argmax()``
  / ``.argmin()`` on a score-like name, not routed through
  ``quantize_scores`` (the source twin of trace rule R1).  ``core/``.
* ``nonliteral-split`` — ``prng.split(key, n)`` with a non-literal count
  (the source twin of R2).  ``core/`` and ``service/``.
* ``float-accum``      — budget state accumulated in Python floats
  (float64) instead of ``np.float32``.  ``core/`` and ``service/``.
* ``hash-derivation``  — the ``hash()`` builtin: salted per interpreter, so
  nothing derived from it repeats across processes.  Everywhere.
* ``unpinned-reduction`` — ``torch.sum``/``mean``/``std`` (function or
  method) or a matrix product (``@``, ``torch.matmul``) in a decision
  module, outside the pinned-sum helpers: the backend picks such a
  reduction's order, so a decision taken on its result can move between
  devices and shapes.  The decision modules are ``core/acquisition.py``,
  ``core/lookahead.py``, ``core/trees.py`` and the selector kernels'
  plain versions.
* ``tf32``             — TF32 enabled (``allow_tf32 = True``, or a float32
  matmul precision other than "highest"): it rounds the operands of every
  float32 product.  Everywhere.
* ``triton-fp-fusion`` — a Triton launch (``kernel[grid](...)`` in a module
  that imports triton) without ``enable_fp_fusion=False``: Triton contracts
  products into FMAs by default, which no plain version reproduces.
  Everywhere.

``compat-drift`` has no counterpart: it guards jax APIs that moved between
jax versions, and the port imports no jax.

Suppressions live in ``analysis/allowlist.py``; every entry carries a
justification, and unused entries are reported.
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib
from typing import Iterable

from repro_torch.analysis.allowlist import ALLOWLIST, Allow

__all__ = ["LintFinding", "lint_file", "lint_tree", "RULES"]

RULES = ("raw-argmax", "nonliteral-split", "float-accum", "hash-derivation",
         "unpinned-reduction", "tf32", "triton-fp-fusion")

# Scope per rule, as path prefixes relative to the src/repro_torch package.
_SCOPE = {
    "hash-derivation": ("",),
    "tf32": ("",),
    "triton-fp-fusion": ("",),
    "raw-argmax": ("core/",),
    "nonliteral-split": ("core/", "service/"),
    "float-accum": ("core/", "service/"),
    "unpinned-reduction": ("core/acquisition.py", "core/lookahead.py",
                           "core/trees.py", "kernels/select_step/ref.py",
                           "kernels/masked_argmax/ref.py"),
}

_SCORE_NAMES = ("score", "gain", "ei", "reward", "acq")
_REDUCTIONS = ("sum", "mean", "std")
# Functions that fix a reduction's order themselves (each documents it).
_PINNED_HELPERS = frozenset({"_pinned_sum", "xla_sum", "_seq_sum_by_node",
                             "_lane_sum_by_node",
                             "_xla_dot", "_seq_sum0", "gh_expect"})


@dataclasses.dataclass(frozen=True)
class LintFinding:
    rule: str
    file: str          # path relative to the repo root
    line: int
    message: str
    source: str = ""   # the offending source line, stripped

    def __str__(self):
        return f"{self.file}:{self.line}: [{self.rule}] {self.message}"


def _dotted(node) -> str:
    """Render an attribute/name chain like ``torch.backends.cuda``."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _contains_quantize(node) -> bool:
    return any(isinstance(sub, ast.Call) and "quantize" in _dotted(sub.func)
               for sub in ast.walk(node))


def _is_pyfloat_expr(node, pyfloat_names: set) -> bool:
    """Does this initializer expression produce a Python float?"""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, float)
    if isinstance(node, ast.Call):
        name = _dotted(node.func)
        # `.budget()` is the job tables' accessor, annotated `-> float`.
        return name == "float" or name.endswith(".budget")
    if isinstance(node, ast.Name):
        return node.id in pyfloat_names
    if isinstance(node, ast.BinOp):
        return (_is_pyfloat_expr(node.left, pyfloat_names)
                or _is_pyfloat_expr(node.right, pyfloat_names))
    return False


def _imports_triton(tree) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.Import) and any(
                a.name.split(".")[0] == "triton" for a in node.names):
            return True
        if isinstance(node, ast.ImportFrom) and (
                node.module or "").split(".")[0] == "triton":
            return True
    return False


class _FileLinter(ast.NodeVisitor):
    def __init__(self, relpath: str, source: str, rules: tuple,
                 triton: bool):
        self.relpath = relpath
        self.lines = source.splitlines()
        self.rules = rules
        self.triton = triton
        self.findings: list[LintFinding] = []
        # Per-enclosing-function assignment maps (innermost last).
        self._assign_stack: list[dict] = [{}]
        self._pyfloat_stack: list[set] = [set()]
        self._functions: list[str] = []

    def _emit(self, rule: str, node, message: str):
        if rule not in self.rules:
            return
        line = getattr(node, "lineno", 0)
        src = (self.lines[line - 1].strip()
               if 0 < line <= len(self.lines) else "")
        self.findings.append(LintFinding(rule, self.relpath, line, message,
                                         src))

    # -- scope bookkeeping -------------------------------------------------- #
    def _visit_function(self, node):
        pyfloats = set()
        for arg in list(node.args.args) + list(node.args.kwonlyargs):
            ann = arg.annotation
            if ann is not None and "float" in ast.unparse(ann):
                pyfloats.add(arg.arg)
        defaults = list(node.args.defaults)
        for arg, default in zip(node.args.args[-len(defaults):] if defaults
                                else [], defaults):
            if isinstance(default, ast.Constant) and isinstance(
                    default.value, float):
                pyfloats.add(arg.arg)
        self._assign_stack.append({})
        self._pyfloat_stack.append(pyfloats)
        self._functions.append(node.name)
        self.generic_visit(node)
        self._functions.pop()
        self._assign_stack.pop()
        self._pyfloat_stack.pop()

    visit_FunctionDef = _visit_function
    visit_AsyncFunctionDef = _visit_function

    def _lookup_assign(self, name: str):
        for frame in reversed(self._assign_stack):
            if name in frame:
                return frame[name]
        return None

    def _pyfloats(self) -> set:
        out = set()
        for s in self._pyfloat_stack:
            out |= s
        return out

    def _pinned(self) -> bool:
        return any(f in _PINNED_HELPERS for f in self._functions)

    # -- assignments: dataflow for raw-argmax, float-accum and tf32 --------- #
    def visit_Assign(self, node):
        for tgt in node.targets:
            if isinstance(tgt, ast.Name):
                self._assign_stack[-1][tgt.id] = node.value
                if _is_pyfloat_expr(node.value, self._pyfloats()):
                    self._pyfloat_stack[-1].add(tgt.id)
                else:
                    self._pyfloat_stack[-1].discard(tgt.id)
            elif (isinstance(tgt, ast.Attribute) and tgt.attr == "allow_tf32"
                  and not (isinstance(node.value, ast.Constant)
                           and node.value.value is False)):
                self._emit("tf32", node,
                           f"{_dotted(tgt)} set to "
                           f"{ast.unparse(node.value)}: TF32 rounds the "
                           "operands of every float32 product; keep it "
                           "False")
        self.generic_visit(node)

    def visit_AugAssign(self, node):
        if (isinstance(node.target, ast.Name)
                and isinstance(node.op, (ast.Add, ast.Sub))
                and node.target.id in self._pyfloats()):
            self._emit(
                "float-accum", node,
                f"'{node.target.id}' accumulates in Python-float (f64) "
                "arithmetic; budget state must accumulate in np.float32 to "
                "replay the device's f32 bookkeeping bit for bit (e.g. "
                "`x = np.float32(x - c)`)")
        self.generic_visit(node)

    def visit_BinOp(self, node):
        if isinstance(node.op, ast.MatMult) and not self._pinned():
            self._emit("unpinned-reduction", node,
                       "`@` in a decision module: the backend picks the "
                       "product's summation order; use a pinned-sum helper")
        self.generic_visit(node)

    # -- calls: everything else --------------------------------------------- #
    def visit_Call(self, node):
        name = _dotted(node.func)

        if name == "hash":
            self._emit("hash-derivation", node,
                       "builtin hash() is salted per interpreter "
                       "(PYTHONHASHSEED): anything derived from it is not "
                       "reproducible across processes; use a stable digest "
                       "(zlib.crc32 / hashlib) instead")

        if name == "prng.split" and len(node.args) >= 2:
            n = node.args[1]
            if not (isinstance(n, ast.Constant)
                    and isinstance(n.value, int)):
                self._emit(
                    "nonliteral-split", node,
                    "prng.split with a non-literal count: a key tree whose "
                    "width derives from a runtime size breaks the "
                    "size-invariant PRNG contract (R2); derive per-index "
                    "keys with prng.fold_in")

        if name.endswith("argmax") or name.endswith("argmin"):
            self._check_argmax(node, name)

        if name.endswith("set_float32_matmul_precision") and not (
                node.args and isinstance(node.args[0], ast.Constant)
                and node.args[0].value == "highest"):
            self._emit("tf32", node,
                       "float32 matmul precision other than 'highest' lets "
                       "the card multiply float32 in TF32")

        self._check_reduction(node, name)

        if (self.triton and isinstance(node.func, ast.Subscript)
                and not any(k.arg == "enable_fp_fusion"
                            and isinstance(k.value, ast.Constant)
                            and k.value.value is False
                            for k in node.keywords)):
            self._emit("triton-fp-fusion", node,
                       "Triton launch without enable_fp_fusion=False: "
                       "Triton contracts products into FMAs by default, "
                       "which the plain version does not")

        self.generic_visit(node)

    def _check_reduction(self, node, name: str):
        if self._pinned() or not isinstance(node.func, ast.Attribute):
            return
        attr = node.func.attr
        recv = _dotted(node.func.value)
        if attr in _REDUCTIONS and recv not in ("np", "numpy", "math"):
            what = f"{name}()" if recv == "torch" else f".{attr}()"
        elif name == "torch.matmul":
            what = "torch.matmul()"
        else:
            return
        self._emit("unpinned-reduction", node,
                   f"{what} in a decision module: the backend picks the "
                   "reduction's order; use a pinned-sum helper (or "
                   "allowlist an exact sum, e.g. of 0/1 counts)")

    def _check_argmax(self, node, name: str):
        if name in ("torch.argmax", "torch.argmin"):
            operand = node.args[0] if node.args else None
            if operand is None or self._quantized(operand):
                return
            self._emit(
                "raw-argmax", node,
                f"{name} on unquantized scores: selection argmaxes in "
                "core/ must run on quantize_scores-rounded values so "
                "near-ties break identically on every device and shape "
                "(trace rule R1)")
        elif isinstance(node.func, ast.Attribute):
            recv = ast.unparse(node.func.value)
            if any(s in recv.lower() for s in _SCORE_NAMES) and \
                    not self._quantized(node.func.value):
                self._emit(
                    "raw-argmax", node,
                    f".{node.func.attr}() on score-like value "
                    f"'{recv}' without quantize_scores (trace rule R1)")

    def _quantized(self, operand) -> bool:
        if _contains_quantize(operand):
            return True
        if isinstance(operand, ast.Name):
            bound = self._lookup_assign(operand.id)
            if bound is not None and _contains_quantize(bound):
                return True
        return False


def _apply_allowlist(findings: list[LintFinding],
                     allowlist: Iterable[Allow]):
    """Split findings into (kept, suppressed); also report unused entries."""
    allowlist = list(allowlist)
    used = [False] * len(allowlist)
    kept, suppressed = [], []
    for f in findings:
        hit = None
        for i, a in enumerate(allowlist):
            if (f.file.endswith(a.file) and f.rule == a.rule
                    and a.match in f.source):
                hit = i
                break
        if hit is None:
            kept.append(f)
        else:
            used[hit] = True
            suppressed.append(f)
    stale = [a for a, u in zip(allowlist, used) if not u]
    return kept, suppressed, stale


def lint_file(path: pathlib.Path, root: pathlib.Path,
              rules: tuple = RULES) -> list[LintFinding]:
    rel = path.relative_to(root).as_posix()
    try:
        pkg_rel = path.relative_to(root / "src" / "repro_torch").as_posix()
    except ValueError:
        pkg_rel = rel
    active = tuple(r for r in rules
                   if any(pkg_rel.startswith(p) for p in _SCOPE[r]))
    if not active:
        return []
    source = path.read_text()
    tree = ast.parse(source, filename=str(path))
    linter = _FileLinter(rel, source, active, _imports_triton(tree))
    linter.visit(tree)
    return linter.findings


def lint_tree(root: pathlib.Path | str, *, allowlist: Iterable[Allow] = None
              ) -> tuple[list[LintFinding], list[LintFinding], list[Allow]]:
    """Lint ``src/repro_torch`` under ``root``.

    Returns ``(findings, suppressed, stale_allowlist_entries)``; the gate
    fails on non-empty ``findings`` or ``stale``.
    """
    root = pathlib.Path(root)
    if allowlist is None:
        allowlist = ALLOWLIST
    findings: list[LintFinding] = []
    for path in sorted((root / "src" / "repro_torch").rglob("*.py")):
        findings.extend(lint_file(path, root))
    return _apply_allowlist(findings, allowlist)
