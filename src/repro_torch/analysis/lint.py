"""AST lint with the port's two repo-specific rules (DESIGN.md §11).

The port of the JAX package's ``analysis/lint.py``, with its finding
format ``path:line:col: CODE message`` and its ``# lint-ok:`` suppressions,
and the two rule families that apply to torch code as written:

* **even-tiling arithmetic** (``tile-floordiv``) — a plain ``a // b``
  in launch-shape arithmetic drops the trailing partial block unless the
  operand was padded to a multiple first.  Flagged unless the enclosing
  function also contains the ceil-div idiom ``-(-a // b)`` or a ``% b``
  guard with the same divisor (the ``pad = -n % b`` padding idiom).  The
  rule reads the functions that carry a ``# tile-math`` marker on their
  ``def`` line: the host-side plan arithmetic of ``kernels/ops.py``,
  ``kernels/autotune.py`` and ``launch/roofline.py``.  (The reference also
  reads jit regions and functions that call ``pallas_call``; the port has
  neither.)
* **lock discipline** (``lock-guard``) — shared attributes annotated
  ``# guarded-by: <lock>`` must only be touched inside a
  ``with self.<lock>:`` block (``__init__`` exempt; a method whose
  ``def`` line carries the same annotation asserts its callers hold the
  lock).  Nested closures reset the held-lock set: a closure defined
  under the lock typically *runs* after it is released.  The port also
  holds module globals to it (``_x = ...  # guarded-by: _lock`` touched
  only under ``with _lock:``), where its shared state mostly lives: the
  kernel build, the ``full_fp32_matmul`` count, the autotune cache.

The reference's jit-purity family (``jit-branch``, ``jit-item``,
``jit-numpy``) is left out: it finds its regions only through
``jax.jit``, ``shard_map``, ``pallas_call`` or a ``# jit-region`` marker,
and the port has none of them.

Suppress a finding with a same-line ``# lint-ok: <code>`` comment
carrying a justification.  CLI: ``python -m repro_torch.analysis --check``.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from pathlib import Path

_GUARDED_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_]\w*)")
_TILE_MARK_RE = re.compile(r"#\s*tile-math\b")
_OK_RE = re.compile(r"#\s*lint-ok:\s*([a-z-]+(?:\s*,\s*[a-z-]+)*)")


@dataclass(frozen=True)
class LintFinding:
    path: str
    line: int
    col: int
    code: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.code} {self.message}"


def _suppressed(lines: list[str], lineno: int, code: str) -> bool:
    if 1 <= lineno <= len(lines):
        m = _OK_RE.search(lines[lineno - 1])
        if m:
            return code in [c.strip() for c in m.group(1).split(",")]
    return False


# ----------------------------------------------------------------------
# rule: even-tiling arithmetic
# ----------------------------------------------------------------------


def _ceil_div_nodes(fn: ast.FunctionDef) -> set[ast.BinOp]:
    """FloorDiv nodes that are part of the ``-(-a // b)`` ceil idiom."""
    out: set[ast.BinOp] = set()
    for node in ast.walk(fn):
        if (
            isinstance(node, ast.UnaryOp)
            and isinstance(node.op, ast.USub)
            and isinstance(node.operand, ast.BinOp)
            and isinstance(node.operand.op, ast.FloorDiv)
            and isinstance(node.operand.left, ast.UnaryOp)
            and isinstance(node.operand.left.op, ast.USub)
        ):
            out.add(node.operand)
    return out


def _check_tiling(fn: ast.FunctionDef, path: str, lines: list[str]) -> list[LintFinding]:
    findings: list[LintFinding] = []
    ceil = _ceil_div_nodes(fn)
    mod_divisors = {
        ast.dump(n.right)
        for n in ast.walk(fn)
        if isinstance(n, ast.BinOp) and isinstance(n.op, ast.Mod)
    }
    for node in ast.walk(fn):
        if not (isinstance(node, ast.BinOp) and isinstance(node.op, ast.FloorDiv)):
            continue
        if node in ceil:
            continue
        if ast.dump(node.right) in mod_divisors:
            # the `pad = -n % b` (or divisibility-check) idiom guards
            # this divisor somewhere in the same function
            continue
        if _suppressed(lines, node.lineno, "tile-floordiv"):
            continue
        findings.append(
            LintFinding(
                path,
                node.lineno,
                node.col_offset,
                "tile-floordiv",
                "floor division without a padding/ceil-div guard for "
                "this divisor assumes even tiling and drops the "
                "trailing partial block — pad first (`-n % b`) or use "
                "`-(-n // b)`",
            )
        )
    return findings


def _tile_marked(fn: ast.FunctionDef, lines: list[str]) -> bool:
    """Explicit ``# tile-math`` marker on the ``def`` line."""
    return 1 <= fn.lineno <= len(lines) and bool(_TILE_MARK_RE.search(lines[fn.lineno - 1]))


# ----------------------------------------------------------------------
# rule: lock discipline (# guarded-by)
# ----------------------------------------------------------------------


def _guard_comment(lines: list[str], lineno: int) -> str | None:
    if 1 <= lineno <= len(lines):
        m = _GUARDED_RE.search(lines[lineno - 1])
        if m:
            return m.group(1)
    return None


def _self_attr(node: ast.expr) -> str | None:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


class _LockChecker:
    """Per-class ``# guarded-by: <lock>`` discipline: ``self.<attr>``
    annotated in the class, held by ``with self.<lock>:``."""

    def __init__(self, scope: ast.AST, path: str, lines: list[str]):
        self.scope = scope
        self.path = path
        self.lines = lines
        self.guards: dict[str, str] = {}  # attr -> lock attr
        self.findings: list[LintFinding] = []

    def _name(self, node: ast.AST) -> str | None:
        """The guarded name ``node`` spells, if it spells one."""
        return _self_attr(node) if isinstance(node, ast.expr) else None

    def _targets(self):
        """``(node, name)`` of every assignment that may carry a guard."""
        for node in ast.walk(self.scope):
            attr = None
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    attr = _self_attr(t) or attr
            elif isinstance(node, ast.AnnAssign):
                t = node.target
                attr = t.id if isinstance(t, ast.Name) else _self_attr(t)  # dataclass field
            if attr is not None:
                yield node, attr

    def _functions(self):
        """The functions whose bodies are checked (``__init__`` exempt)."""
        return [n for n in self.scope.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) and n.name != "__init__"]

    def run(self) -> list[LintFinding]:
        for node, attr in self._targets():
            lock = _guard_comment(self.lines, node.lineno)
            if lock is not None:
                self.guards[attr] = lock
        if not self.guards:
            return []
        for node in self._functions():
            held: set[str] = set()
            lock = _guard_comment(self.lines, node.lineno)
            if lock is not None:
                held.add(lock)  # caller-holds-lock helper
            self._walk(node.body, held)
        return self.findings

    def _check_expr(self, node: ast.AST, held: set[str]) -> None:
        for sub in ast.walk(node):
            name = self._name(sub)
            if name not in self.guards:
                continue
            lock = self.guards[name]
            if lock not in held and not _suppressed(self.lines, sub.lineno, "lock-guard"):
                shown = f"self.{name}" if isinstance(sub, ast.Attribute) else name
                held_as = f"self.{lock}" if isinstance(sub, ast.Attribute) else lock
                self.findings.append(
                    LintFinding(
                        self.path,
                        sub.lineno,
                        sub.col_offset,
                        "lock-guard",
                        f"{shown} is guarded-by {lock!r} but "
                        f"accessed without holding `with {held_as}:`",
                    )
                )

    def _walk(self, body: list[ast.stmt], held: set[str]) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # a closure defined here typically RUNS after the lock
                # is released — it holds nothing
                inner = set()
                lock = _guard_comment(self.lines, stmt.lineno)
                if lock is not None:
                    inner.add(lock)
                self._walk(stmt.body, inner)
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                got = {self._name(item.context_expr) for item in stmt.items} - {None}
                for item in stmt.items:
                    self._check_expr(item.context_expr, held)
                self._walk(stmt.body, held | got)
                continue
            # check every expression in this statement, then recurse
            for _name, value in ast.iter_fields(stmt):
                for v in value if isinstance(value, list) else [value]:
                    if isinstance(v, ast.expr):
                        self._check_expr(v, held)
            for attr in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, attr, None)
                if isinstance(sub, list):
                    self._walk(sub, held)
            if isinstance(stmt, ast.Try):
                for h in stmt.handlers:
                    self._walk(h.body, held)


class _ModuleLockChecker(_LockChecker):
    """The same discipline for a module's globals, which the reference
    does not check: a top-level ``name = ...  # guarded-by: <lock>`` may
    only be touched under ``with <lock>:`` in the module's functions and
    its classes' methods (top-level statements exempt, as ``__init__``
    is for attributes)."""

    def _name(self, node: ast.AST) -> str | None:
        return node.id if isinstance(node, ast.Name) else None

    def _targets(self):
        for node in self.scope.body:
            if isinstance(node, ast.Assign):
                names = [t.id for t in node.targets if isinstance(t, ast.Name)]
                if names:
                    yield node, names[-1]
            elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
                yield node, node.target.id

    def _functions(self):
        out = []
        for node in self.scope.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append(node)
            elif isinstance(node, ast.ClassDef):
                out += [n for n in node.body if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        return out


# ----------------------------------------------------------------------
# drivers
# ----------------------------------------------------------------------


def lint_source(src: str, path: str = "<string>") -> list[LintFinding]:
    tree = ast.parse(src, filename=path)
    lines = src.splitlines()
    findings: list[LintFinding] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and _tile_marked(node, lines):
            findings += _check_tiling(node, path, lines)
        elif isinstance(node, ast.ClassDef):
            findings += _LockChecker(node, path, lines).run()
    findings += _ModuleLockChecker(tree, path, lines).run()
    return sorted(findings, key=lambda f: (f.path, f.line, f.col, f.code))


def lint_file(path: str | Path) -> list[LintFinding]:
    p = Path(path)
    try:
        src = p.read_text()
    except (OSError, UnicodeDecodeError) as e:
        return [LintFinding(str(p), 1, 0, "io-error", str(e))]
    try:
        return lint_source(src, str(p))
    except SyntaxError as e:
        return [LintFinding(str(p), e.lineno or 1, 0, "syntax-error", e.msg or "")]


def iter_python_files(paths: list[str | Path]) -> list[Path]:
    out: list[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_file() and p.suffix == ".py":
            out.append(p)
        elif p.is_dir():
            out.extend(
                f
                for f in sorted(p.rglob("*.py"))
                if "__pycache__" not in f.parts
                and not any(part.startswith(".") for part in f.parts)
            )
    return out


def lint_paths(paths: list[str | Path]) -> list[LintFinding]:
    findings: list[LintFinding] = []
    for f in iter_python_files(paths):
        findings += lint_file(f)
    return findings
