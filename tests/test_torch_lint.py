"""The port's lint (``repro_torch.analysis.lint``) against the JAX
package's (``repro.analysis.lint``).

On every ``lock-guard``, ``tile-floordiv`` and ``lint-ok`` snippet of
``tests/test_analysis_lint.py`` (read from that file, not copied) the
port's lint gives the reference's findings, code, line and column.  The
port's ``tile-floordiv`` reads only functions marked ``# tile-math``
(it has no jit region), so a snippet whose scope is a ``@jax.jit``
decorator is linted in its port form: the decorator line left blank and
the marker put on the ``def`` line, which keeps every line and column.
Then: the port's own sources lint clean, ``python -m repro_torch.analysis
--check`` exits 0 on them and 1 on a planted violation, and the rules
really read the port's annotations (a removed lock or ``lint-ok`` shows).
"""
import ast
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.analysis import lint as ref_lint
from repro_torch.analysis import lint

ROOT = Path(__file__).resolve().parent.parent
REFERENCE_TESTS = ROOT / "tests" / "test_analysis_lint.py"
SHARED = (
    "test_tile_floordiv_fires_without_guard",
    "test_ceil_div_idiom_is_exempt",
    "test_same_divisor_mod_guard_is_exempt",
    "test_tile_math_marker_extends_rule_to_host_functions",
    "test_unmarked_host_function_stays_out_of_scope",
    "test_tile_math_marker_accepts_ceil_div",
    "test_lint_ok_suppression",
    "test_lock_guard_fires_on_unlocked_access",
    "test_lock_guard_quiet_under_with",
    "test_closure_does_not_inherit_the_lock",
    "test_def_line_annotation_means_caller_holds",
    "test_init_is_exempt",
)
JIT_FAMILY = (
    "test_jit_branch_on_traced_argument",
    "test_marker_comment_makes_a_region",
    "test_function_passed_to_pallas_call_is_a_region",
    "test_item_and_host_numpy_flagged",
    "test_taint_propagates_through_assignment",
)


def snippets(name: str) -> list[str]:
    """The source snippets that the reference's test ``name`` lints."""
    tree = ast.parse(REFERENCE_TESTS.read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)
    found = [
        textwrap.dedent(n.value) for n in ast.walk(fn)
        if isinstance(n, ast.Constant) and isinstance(n.value, str) and "def " in n.value
    ]
    assert found, name
    return found


def port_form(src: str) -> str:
    """``src`` with each ``@jax.jit`` decorator's line blanked and a
    ``# tile-math`` marker on the decorated ``def`` line."""
    lines = src.splitlines()
    for i, line in enumerate(lines):
        if line.strip() == "@jax.jit":
            lines[i] = ""
            j = next(j for j in range(i + 1, len(lines)) if lines[j].lstrip().startswith("def "))
            lines[j] += "  # tile-math"
    return "\n".join(lines) + "\n"


def found(module, src: str) -> list[tuple[str, int, int]]:
    return [(f.code, f.line, f.col) for f in module.lint_source(src, "t.py")]


@pytest.mark.parametrize("name", SHARED)
def test_shared_rules_give_the_reference_findings(name):
    for src in snippets(name):
        want = [f for f in found(ref_lint, src) if f[0] in ("lock-guard", "tile-floordiv")]
        assert found(lint, port_form(src)) == want


@pytest.mark.parametrize("name", ["test_tile_floordiv_fires_without_guard",
                                  "test_lock_guard_fires_on_unlocked_access",
                                  "test_closure_does_not_inherit_the_lock"])
def test_findings_print_as_the_reference_prints_them(name):
    (src,) = snippets(name)
    got = [str(f) for f in lint.lint_source(port_form(src), "t.py")]
    want = [str(f) for f in ref_lint.lint_source(src, "t.py") if f.code != "jit-branch"]
    assert got == want and got


@pytest.mark.parametrize("name", JIT_FAMILY)
def test_the_jit_family_is_left_out(name):
    for src in snippets(name):
        assert any(f[0].startswith("jit-") for f in found(ref_lint, src))
        assert not any(f[0].startswith("jit-") for f in found(lint, src))


def test_lint_ok_suppresses_a_lock_guard_finding():
    src = textwrap.dedent(
        """
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self.n = 0  # guarded-by: _lock

            def peek(self):
                return self.n  # lint-ok: lock-guard (a racy read is fine here)

            def bump(self):
                self.n += 1
        """
    )
    assert found(lint, src) == found(ref_lint, src) == [("lock-guard", 13, 8)]


def test_module_globals_are_held_to_their_lock():
    """The port's addition: a module global annotated ``# guarded-by:``
    is touched only under ``with <lock>:`` (or in a function whose def
    line says its callers hold it); the reference checks attributes
    only."""
    src = textwrap.dedent(
        """
        import threading

        _lock = threading.Lock()
        _n = 0  # guarded-by: _lock

        def bump():
            global _n
            with _lock:
                _n += 1

        def _bump_locked():  # guarded-by: _lock
            return _n

        def peek():
            return _n

        def deferred():
            with _lock:
                def cb():
                    return _n
                return cb

        class C:
            def read(self):
                return _n
        """
    )
    assert found(lint, src) == [("lock-guard", 16, 11), ("lock-guard", 21, 19),
                                ("lock-guard", 26, 15)]
    assert found(ref_lint, src) == []


def test_the_port_lints_clean():
    findings = lint.lint_paths([ROOT / "src" / "repro_torch"])
    assert findings == [], [str(f) for f in findings]


def test_the_rules_read_the_ports_annotations():
    """Each rule sees the port's own annotations: dropping a
    ``lint-ok`` from ``kernels/ops.py`` or a lock from
    ``full_fp32_matmul``, ``ops.build`` (the two faults repaired in the
    port's query-server slice) or ``autotune.reset_cache`` makes
    findings."""
    ops_src = (ROOT / "src/repro_torch/kernels/ops.py").read_text()
    unmarked = re.sub(r"  # lint-ok: tile-floordiv.*", "", ops_src)
    assert [f.code for f in lint.lint_source(unmarked)] == ["tile-floordiv"] * 2
    engine = (ROOT / "src/repro_torch/core/torch_engine.py").read_text()
    unlocked = engine.replace("    with _fp32_lock:\n        if _fp32_users == 0:",
                              "    if True:\n        if _fp32_users == 0:")
    assert unlocked != engine
    assert {f.code for f in lint.lint_source(unlocked)} == {"lock-guard"}
    unbuilt = ops_src.replace("    with _build_lock:\n        if not _built:",
                              "    if True:\n        if not _built:")
    assert unbuilt != ops_src
    assert {f.code for f in lint.lint_source(unbuilt)} == {"lock-guard"}
    tune = (ROOT / "src/repro_torch/kernels/autotune.py").read_text()
    unlocked = tune.replace("    with _lock:\n        _memory.clear()", "    if True:\n        _memory.clear()")
    assert unlocked != tune
    assert [f.code for f in lint.lint_source(unlocked)] == ["lock-guard", "lock-guard"]


def _cli(*args: str, cwd=ROOT) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis", *args],
                          capture_output=True, text=True, cwd=cwd, env=env, timeout=120)


def test_check_exits_0_on_the_port():
    done = _cli("--check")
    assert done.returncode == 0, done.stdout + done.stderr
    assert "lint: clean (1 path(s))" in done.stdout


def test_check_exits_1_on_a_planted_violation(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("def tiles(n, b):  # tile-math\n    return n // b\n")
    done = _cli("--check", str(bad), str(ROOT / "src" / "repro_torch" / "kernels"))
    assert done.returncode == 1
    assert done.stdout.splitlines() == [f"{bad}:2:11: tile-floordiv " + lint.lint_file(bad)[0].message]
    assert "1 finding(s)" in done.stderr
