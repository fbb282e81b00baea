"""Maintenance behind the port's logical planner against the JAX
package's: ``Q ... .maintain(db)`` and ``Plan.maintain()`` on
``TorchChannelEngine(device="cpu")`` against ``repro.api``'s
``.engine("tensor").maintain(db)``, through the same batches.

The handles must be of the same kinds (a raw ``MaintainedJoinAgg`` for a
single aggregate with no rewrite, else a ``MaintainedPlan``), apply the
plan's rewrites to every batch — alias fan-out, column renames, pushed-
down predicates and group-attribute copies — and answer bit for bit as
the reference does and as a from-scratch execute of the port does on the
mutated database (integer measures: every float32 partial is exact).
"""
import numpy as np
import pytest

from repro.api import Avg as JAvg
from repro.api import Count as JCount
from repro.api import MaintainedPlan as JMaintainedPlan
from repro.api import Max as JMax
from repro.api import Min as JMin
from repro.api import Q as JQ
from repro.api import Sum as JSum
from repro.incremental import MaintainedJoinAgg as JMaintained
from repro.relational.relation import Database as JDatabase
from repro_torch.api import (
    Avg,
    Count,
    MaintainedPlan,
    Max,
    Min,
    Q,
    Sum,
    TorchChannelEngine,
    UnsupportedPlanOption,
    compile_plan,
)
from repro_torch.incremental import MaintainedJoinAgg
from repro_torch.relational.relation import Database
from test_torch_planner import assert_identical

CPU = TorchChannelEngine(device="cpu")
PORT = {"count": Count, "sum": Sum, "avg": Avg, "min": Min, "max": Max}
REF = {"count": JCount, "sum": JSum, "avg": JAvg, "min": JMin, "max": JMax}


def chain_cols(n=150, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "R1": {"g1": rng.integers(0, 5, n), "p0": rng.integers(0, 6, n)},
        "R2": {"p0": rng.integers(0, 6, n), "p1": rng.integers(0, 6, n),
               "m": rng.integers(1, 20, n)},
        "R3": {"p1": rng.integers(0, 6, n), "g2": rng.integers(0, 5, n)},
    }


def items_cols(n=120, seed=1):
    rng = np.random.default_rng(seed)
    return {"Items": {"item": rng.integers(0, 10, n), "invoice": rng.integers(0, 30, n)}}


def grown(cols, rel, batch, sign=1):
    """``cols`` after inserting (``sign`` 1) or deleting (-1: the first
    occurrence of each row) ``batch`` in ``rel``."""
    out = {r: dict(c) for r, c in cols.items()}
    if sign > 0:
        out[rel] = {a: np.concatenate([c, np.asarray(batch[a])]) for a, c in cols[rel].items()}
        return out
    keep = np.ones(len(next(iter(cols[rel].values()))), bool)
    for row in zip(*(np.asarray(batch[a]) for a in cols[rel])):
        hit = np.flatnonzero(keep & np.logical_and.reduce(
            [cols[rel][a] == v for a, v in zip(cols[rel], row)]))
        keep[hit[0]] = False
    out[rel] = {a: c[keep] for a, c in cols[rel].items()}
    return out


def both(build, aggs):
    """``build(Q)`` for the port and the reference, each with the named
    aggregates ``aggs`` = {name: (kind, measure or None)}."""
    def named(table):
        return {n: table[k](*(m.split(".") if m else ())) for n, (k, m) in aggs.items()}

    return build(Q).agg(**named(PORT)).engine(CPU), build(JQ).agg(**named(REF)).engine("tensor")


class Maintained:
    """The port's and the reference's handle for the same builder, driven
    together; after each batch both results equal each other and the
    port's fresh execute."""

    def __init__(self, q, jq, cols):
        self.q, self.cols = q, cols
        self.port = q.maintain(cols)
        self.ref = jq.maintain(JDatabase.from_mapping(cols))
        self.check()

    def apply(self, op, rel, batch):
        getattr(self.port, op)(rel, batch)
        getattr(self.ref, op)(rel, batch)
        self.cols = grown(self.cols, rel, batch, 1 if op == "insert" else -1)
        self.check()

    def check(self):
        fresh = self.q.plan(self.cols).execute()
        got, want = self.port.result(), self.ref.result()
        if isinstance(self.port, MaintainedPlan):
            assert_identical(want, got)
            assert_identical(fresh, got)
        else:
            assert got == want == fresh.to_dict()


def test_handle_kinds_follow_the_reference():
    cols = chain_cols()

    def count(Q_):
        return Q_.over("R1", "R2", "R3").group_by("R1.g1", "R3.g2")

    q, jq = both(count, {"n": ("count", None)})
    assert isinstance(q.maintain(cols), MaintainedJoinAgg)
    assert isinstance(jq.maintain(JDatabase.from_mapping(cols)), JMaintained)
    q, jq = both(count, {"n": ("count", None), "s": ("sum", "R2.m")})
    assert isinstance(q.maintain(cols), MaintainedPlan)
    assert isinstance(jq.maintain(JDatabase.from_mapping(cols)), JMaintainedPlan)
    plan = q.plan(cols)
    assert isinstance(plan.maintain(), MaintainedPlan)


def test_bundle_refreshes_bit_identical():
    def build(Q_):
        return Q_.over("R1", "R2", "R3").group_by("R1.g1", "R3.g2")

    aggs = {"n": ("count", None), "s": ("sum", "R2.m"), "a": ("avg", "R2.m"),
            "lo": ("min", "R2.m"), "hi": ("max", "R2.m")}
    m = Maintained(*both(build, aggs), chain_cols())
    extra = {"p0": np.array([0, 1, 5]), "p1": np.array([2, 2, 4]), "m": np.array([3, 19, 7])}
    m.apply("insert", "R2", extra)
    m.apply("insert", "R3", {"p1": np.array([2, 9]), "g2": np.array([0, 7])})
    m.apply("delete", "R2", extra)
    m.apply("delete", "R2", {a: c[:4] for a, c in m.cols["R2"].items()})
    stats = m.port.stats
    assert set(stats) == set(aggs)
    assert stats["lo"].fallback_recomputes > 0 and stats["n"].fallback_recomputes == 0


def test_self_join_aliases_and_renames_fan_out():
    def build(Q_):
        return (
            Q_.over(("I1", "Items"), ("I2", "Items"))
            .rename("I1", item="i1")
            .rename("I2", item="i2")
            .group_by("I1.i1", "I2.i2")
        )

    m = Maintained(*both(build, {"pairs": ("count", None), "inv_lo": ("min", "I1.invoice")}),
                   items_cols())
    assert isinstance(m.port, MaintainedPlan)
    rng = np.random.default_rng(2)
    extra = {"item": rng.integers(0, 10, 11), "invoice": rng.integers(0, 30, 11)}
    m.apply("insert", "Items", extra)  # fans out to both aliases, renamed
    m.apply("delete", "Items", extra)


def test_predicates_filter_every_batch():
    def build(Q_):
        return (
            Q_.over("R1", "R2", "R3")
            .where("R2", "m", ">", 9)
            .group_by("R1.g1", "R3.g2")
        )

    m = Maintained(*both(build, {"s": ("sum", "R2.m")}), chain_cols())
    assert isinstance(m.port, MaintainedPlan)
    m.apply("insert", "R2", {"p0": np.array([1, 2, 3]), "p1": np.array([1, 1, 1]),
                             "m": np.array([4, 12, 15])})  # one row filtered out
    m.apply("insert", "R2", {"p0": np.array([0]), "p1": np.array([0]),
                             "m": np.array([2])})  # the whole batch filtered out
    assert m.port.stats["s"].refreshes == m.ref.stats["s"].refreshes == 1


def test_group_attr_copies_follow_the_batches():
    """Grouping by a join attribute makes the planner copy it
    (``R1.p0`` -> ``p0__grp``); every batch into R1 gets the copy."""
    def build(Q_):
        return Q_.over("R1", "R2", "R3").group_by("R1.p0", "R3.g2")

    q, jq = both(build, {"n": ("count", None)})
    plan = q.plan(chain_cols())
    assert plan._group_copies() == {"R1": ("p0", "p0__grp")}
    m = Maintained(q, jq, chain_cols())
    assert isinstance(m.port, MaintainedPlan)
    m.apply("insert", "R1", {"g1": np.array([1, 2]), "p0": np.array([3, 8])})
    m.apply("insert", "R2", {"p0": np.array([8]), "p1": np.array([1]), "m": np.array([5])})


def test_cyclic_plan_maintains():
    rng = np.random.default_rng(4)
    cols = {
        "E1": {"a": rng.integers(0, 9, 60), "b": rng.integers(0, 9, 60)},
        "E2": {"b": rng.integers(0, 9, 60), "c": rng.integers(0, 9, 60)},
        "E3": {"c": rng.integers(0, 9, 60), "a": rng.integers(0, 9, 60)},
    }

    def build(Q_):
        return Q_.over("E1", "E2", "E3").group_by("E1.a")

    m = Maintained(*both(build, {"n": ("count", None)}), cols)
    assert m.port.cyclic
    m.apply("insert", "E2", {"b": np.array([1, 2, 3]), "c": np.array([4, 4, 12])})
    assert m.port.stats.dirty_bags == m.ref.stats.dirty_bags > 0


def test_maintain_refuses_stream_and_budget_options():
    cols = chain_cols()
    base = Q.over("R1", "R2", "R3").group_by("R1.g1", "R3.g2").engine(CPU)
    for q in (base.stream("g1", 2), base.memory_budget(1 << 20)):
        with pytest.raises(UnsupportedPlanOption):
            q.maintain(cols)
        with pytest.raises(UnsupportedPlanOption):
            q.plan(cols).maintain()


def test_maintenance_only_plan_refuses_execute():
    """``Q.maintain`` compiles without the physical stage; such a plan
    cannot execute, explain or verify."""
    q = Q.over("R1", "R2", "R3").group_by("R1.g1", "R3.g2").engine(CPU)
    plan = compile_plan(q, Database.from_mapping(chain_cols()), physical=False)
    assert plan.prep is None and "root=None" in repr(plan)
    for call in (plan.execute, plan.explain, plan.verify):
        with pytest.raises(RuntimeError, match="maintenance only"):
            call()
    assert isinstance(plan.maintain(), MaintainedJoinAgg)


def test_fused_option_leaves_the_delta_hops_unfused(monkeypatch):
    """The reference's maintenance never fuses: a ``.fused(True)`` plan's
    handles build and refresh on ``coo_spmm``/``segment_sum`` alone."""
    from repro_torch.core import torch_engine

    def refuse(*args, **kwargs):
        raise AssertionError("a maintenance hop launched fused_hop")

    monkeypatch.setattr(torch_engine, "fused_hop", refuse)

    def build(Q_):
        return Q_.over("R1", "R2", "R3").group_by("R1.g1", "R3.g2")

    q, jq = both(build, {"n": ("count", None), "s": ("sum", "R2.m")})
    cols = chain_cols()
    port, ref = q.fused(True).maintain(cols), jq.maintain(JDatabase.from_mapping(cols))
    extra = {"p0": np.array([2, 4]), "p1": np.array([0, 5]), "m": np.array([6, 11])}
    port.insert("R2", extra)
    ref.insert("R2", extra)
    assert_identical(ref.result(), port.result())
