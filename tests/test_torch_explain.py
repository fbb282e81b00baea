"""``Plan.explain()`` of the port against the JAX package's.

Rendered with the reference's golden options (``.fused(True)``,
``actuals=True``), the port's explain of every catalog query equals
``tests/goldens/plans/<name>.txt`` line for line after exactly these
substitutions (``golden_as_port``):

* the engine name: ``(engine=jax)`` → ``(engine=torch)``;
* the path section's head: ``jax path:`` → ``torch path:``;
* the ``kernels:`` section (the reference's TPU tile configurations) is
  replaced by the port's own: each fused hop's launch shape.

The golden's first line, the ``# plan golden`` header written by
``benchmarks/plan_goldens.py``, is not part of ``explain()``.  Without
``.fused(True)`` (and with ``REPRO_FUSED`` unset) both packages print no
``pinned:`` line and no ``kernels:`` section, and the port's explain
equals the reference's rendered live, statistics on and off.
"""
import math

import pytest

from benchmarks.plan_goldens import GOLDEN_DIR
from repro.api import Q as JQ
from repro_torch.api import Q, TorchChannelEngine
from repro_torch.core.torch_engine import hop_launch_shapes
from tests.test_torch_dense import NAMES, PORT, bundle, catalog, measured

CPU = TorchChannelEngine(device="cpu")
SUBSTITUTIONS = (("(engine=jax)", "(engine=torch)"), ("jax path:", "torch path:"))


def substituted(line: str) -> str:
    for old, new in SUBSTITUTIONS:
        line = line.replace(old, new)
    return line


def golden_as_port(lines: list[str], port_kernels: list[str]) -> list[str]:
    """The reference's explain lines with the substitutions applied and
    its ``kernels:`` section swapped for ``port_kernels``."""
    out: list[str] = []
    in_kernels = False
    for line in lines:
        if line.startswith("kernels:"):
            out.extend(port_kernels)
            in_kernels = True
            continue
        if in_kernels and line.startswith("  "):
            continue
        in_kernels = False
        out.append(substituted(line))
    return out


@pytest.mark.parametrize("name", NAMES)
def test_explain_equals_the_golden(name, monkeypatch):
    monkeypatch.delenv("REPRO_FUSED", raising=False)
    _, _, db, q = catalog(name)
    plan = Q.from_query(q).engine(CPU).fused(True).plan(db)
    assert plan.verify() == []
    got = plan.explain(actuals=True).splitlines()
    golden = (GOLDEN_DIR / f"{name}.txt").read_text().splitlines()
    assert golden[0].startswith("# plan golden:")
    kernels = plan._explain_kernels()
    runs = plan.fused_runs()
    shapes = [hop_launch_shapes(r["prep"], r["k"], r["encoded"], r["domains"])
              for r in runs]
    heads = len(runs) if len(runs) > 1 else 0
    assert kernels[0].startswith("kernels:")
    assert len(kernels) == 1 + heads + sum(map(len, shapes))
    assert all(e["plan"] is not None for one in shapes for e in one)
    assert got == golden_as_port(golden[1:], kernels)
    assert sum(line.startswith("  pinned: sparse (.fused(True)") for line in got) == 1


def _launched_shapes(plan, monkeypatch) -> list[tuple]:
    """Run ``plan.execute()`` with a spy on the walk's ``fused_hop``
    calls; for each call that launches (an output row and a column),
    the route and launch shape the wrapper gives it on a card (the
    ``plan`` the engine passes, else the wrapper's own), as ``(walk,
    edges, segments, width, plan bytes)``."""
    from repro_torch.core import torch_engine
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_hop import gathers_one_child

    calls = []
    real = torch_engine.fused_hop

    def spy(keys, weights, msgs, idxs, num_segments, k=1, kind="sum", out=None, plan=None):
        msgs = list(msgs)
        d = k * math.prod(m.shape[1] // k for m in msgs)
        if num_segments and d:
            walk = "gather" if gathers_one_child(len(msgs), d) else "tile"
            make = ops.gather_plan if walk == "gather" else ops.walk_plan
            n = keys.shape[0]
            launched = plan if plan is not None else make(n, num_segments, d)
            calls.append((walk, n, num_segments, d, bytes(launched)))
        return real(keys, weights, msgs, idxs, num_segments, k, kind, out, plan)

    monkeypatch.setattr(torch_engine, "fused_hop", spy)
    plan.execute()
    return calls


def _modelled_shapes(plan) -> list[list[tuple]]:
    """``hop_launch_shapes`` of every pass of ``plan.fused_runs()``, one
    list per pass (repeated passes repeated), sorted within a pass: the
    walk launches children first, the model lists the tree root first."""
    out = []
    for r in plan.fused_runs():
        shapes = hop_launch_shapes(r["prep"], r["k"], r["encoded"], r["domains"])
        one = sorted((e["walk"], e["edges"], e["num_segments"], e["width"],
                      bytes(e["plan"])) for e in shapes)
        out.extend([one] * r["repeat"])
    return out


def _in_passes(calls: list[tuple], passes: list[list[tuple]]) -> list[list[tuple]]:
    at, out = 0, []
    for one in passes:
        out.append(sorted(calls[at:at + len(one)]))
        at += len(one)
    assert at == len(calls)
    return out


def _stream_bundle_plan():
    """DBLP with a MIN/MAX bundle and a two-way stream: tiles and k = 1
    MIN/MAX passes beside the k-channel pass."""
    _, _, db, q, m = measured("DBLP", lambda rng, n: rng.integers(0, 9, n))
    spec = bundle(Q, PORT, q, m).engine(CPU).fused(True)
    attr = spec.plan(db).prep.group_attrs[0][1]
    return spec.stream(attr, 2).plan(db)


@pytest.mark.parametrize("name", NAMES + ["DBLP, stream, MIN/MAX"])
def test_kernels_section_equals_the_fused_launches(name, monkeypatch):
    """What ``explain``'s ``kernels:`` section and V-KERN read
    (``fused_runs`` × ``hop_launch_shapes``) is what a fused execute
    launches: the same routes and launch shapes, pass by pass — per key
    range of a split plan, per stream tile, and the MIN/MAX passes."""
    monkeypatch.delenv("REPRO_FUSED", raising=False)
    if name.startswith("DBLP, stream"):
        plan = _stream_bundle_plan()
        assert plan.resolved_stream() is not None and plan.minmax
    else:
        plan = Q.from_query(catalog(name)[3]).engine(CPU).fused(True).plan(catalog(name)[2])
    passes = _modelled_shapes(plan)
    calls = _launched_shapes(plan, monkeypatch)
    assert calls and _in_passes(calls, passes) == passes
    heads = [line for line in plan._explain_kernels() if line.endswith(":")]
    runs = plan.fused_runs()
    assert len(heads) == (len(runs) if len(runs) > 1 else 0)


@pytest.mark.parametrize("stats", [True, False])
@pytest.mark.parametrize("name", NAMES)
def test_explain_unfused_equals_the_reference(name, stats, monkeypatch):
    """Unfused plans: no ``pinned:`` line, no ``kernels:`` section, the
    rest as the reference renders it (statistics off: no estimates)."""
    monkeypatch.delenv("REPRO_FUSED", raising=False)
    jdb, jq, db, q = catalog(name)
    want = JQ.from_query(jq).stats(stats).engine("jax").plan(jdb).explain(actuals=True)
    got = Q.from_query(q).stats(stats).engine(CPU).plan(db).explain(actuals=True)
    lines = got.splitlines()
    assert lines == [substituted(line) for line in want.splitlines()]
    assert not any(line.startswith(("  pinned:", "kernels:")) for line in lines)
    assert ("stats: disabled (byte-heuristic planning)" in lines) is (not stats)


def test_explain_with_a_stream_and_a_budget_equals_the_reference(monkeypatch):
    """A budget below the peak message streams, and the path section
    says why it is sparse."""
    monkeypatch.delenv("REPRO_FUSED", raising=False)
    jdb, jq, db, q = catalog("DBLP")
    budget = Q.from_query(q).engine(CPU).plan(db).message_peak // 3
    want = JQ.from_query(jq).memory_budget(budget).engine("jax").plan(jdb).explain()
    got = Q.from_query(q).memory_budget(budget).engine(CPU).plan(db).explain()
    assert got.splitlines() == [substituted(line) for line in want.splitlines()]
    assert "torch path: sparse — stream tiles over" in got


def test_explain_names_a_pinned_engine_mode():
    _, _, db, q = catalog("ORDS")
    auto = Q.from_query(q).engine(CPU).plan(db).explain()
    pinned = Q.from_query(q).engine(TorchChannelEngine("cpu", "sparse")).plan(db).explain()
    extra = [line for line in pinned.splitlines() if line not in auto.splitlines()]
    assert extra == ["  pinned: sparse (engine mode='sparse')"]


def test_rejected_roots_equal_the_reference(monkeypatch):
    """A candidate root whose fold/decompose fails is kept with its
    reason (``root_notes``) and listed under ``rejected roots:``."""
    import repro.api.plan as jplan_mod
    import repro_torch.api.plan as plan_mod

    def refusing(real):
        def finish(query, schema, dicts, encoded, root=None, measures=None, **kw):
            if root == "AP1":
                raise ValueError("root 'AP1' refused for this test")
            return real(query, schema, dicts, encoded, root=root, measures=measures, **kw)

        return finish

    monkeypatch.setattr(jplan_mod, "finish_prepare", refusing(jplan_mod.finish_prepare))
    monkeypatch.setattr(plan_mod, "finish_prepare", refusing(plan_mod.finish_prepare))
    jdb, jq, db, q = catalog("DBLP")
    jplan = JQ.from_query(jq).engine("jax").plan(jdb)
    plan = Q.from_query(q).engine(CPU).plan(db)
    assert plan.root_notes == jplan.root_notes == ("AP1: root 'AP1' refused for this test",)
    assert plan.prep.decomposition.root == "AP2"
    lines = plan.explain().splitlines()
    at = lines.index("rejected roots:")
    assert lines[at + 1] == "  AP1: root 'AP1' refused for this test"
    assert lines == [substituted(line) for line in jplan.explain().splitlines()]


def test_actual_cards_come_from_the_port_walk():
    """``explain(actuals=True)`` measures each node's message cells on
    the plan's device; they equal the reference's boolean pass."""
    from repro.planner.cost import actual_node_cards as j_actual
    from repro_torch.planner.cost import actual_node_cards

    for name in ("IMDB", "TPCH", "FOFGROUP"):
        jdb, jq, db, q = catalog(name)
        jplan = JQ.from_query(jq).engine("jax").plan(jdb)
        plan = Q.from_query(q).engine(CPU).plan(db)
        got = actual_node_cards(plan.prep, "cpu")
        assert got == j_actual(jplan.prep)
        assert all(isinstance(v, int) and v > 0 for v in got.values())


@pytest.mark.parametrize("name", NAMES)
def test_statistics_summary_and_max_share_equal_the_reference(name):
    """The two pieces of the statistics that ``explain`` reads."""
    jdb, jq, db, q = catalog(name)
    jst = JQ.from_query(jq).engine("jax").plan(jdb).prep.stats
    st = Q.from_query(q).engine(CPU).plan(db).prep.stats
    assert st.summary_lines() == jst.summary_lines()
    assert st.generation == jst.generation == 0
    for rel, rs in jst.relations.items():
        for attr in list(rs.cols) + ["missing"]:
            assert st.max_share(rel, attr) == jst.max_share(rel, attr), (rel, attr)
