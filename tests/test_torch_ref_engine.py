"""The port's data graph and ``"ref"`` engine against the JAX package's,
on the same numpy inputs made from a seed, on the CPU (where
``segment_sum`` and ``segment_reduce`` take their plain versions).

* The data graph (``repro_torch.core.datagraph``) against
  ``repro.core.datagraph.build_data_graph`` on every synthetic dataset
  and the REAL/SKEWED catalog: counts, ``memory_bytes()``, sources, the
  node set and the edge multiset up to relabelling, channel weights.
* Stage 2 source by source against ``_traverse``/``_traverse_ch``:
  c-pairs, path counts (path-id tuples rebuilt) and child path-ids.
* Source tiles forced to 1, 2 and all sources, and the row bound made
  small enough to split tiles: the same answers.
* Plans through ``RefChannelEngine(device="cpu")`` against the
  reference's ``Q.engine("ref")`` on the catalog (statistics on and
  off; COUNT, SUM, AVG, MIN, MAX), a folded single-group query, an empty
  join and a fractional SUM (1e-5 relative).
* The ``join_agg``/``ghd_join_agg`` shims, option refusals, no split.
* ``MaintainedJoinAgg(engine="ref")`` batch by batch against the
  reference's ``engine="ref"`` handle, a served ``"ref"`` request, and
  the device rule.
Integer data compares exactly.
"""
from collections import Counter
from functools import partial

import numpy as np
import pytest
import torch

from repro.api import Avg as JAvg
from repro.api import Count as JCount
from repro.api import Max as JMax
from repro.api import Min as JMin
from repro.api import Q as JQ
from repro.api import Sum as JSum
from repro.core import datagraph as jdg
from repro.core import operator as joperator
from repro.core import ref_engine as jref
from repro.core.prepare import prepare as jprepare
from repro.core.query import JoinAggQuery as JQuery
from repro.data import queries as jqueries
from repro.data import synth as jsynth
from repro.ghd import rewrite as jrewrite
from repro.incremental import MaintainedJoinAgg as JMaintained
from repro.relational.relation import Database as JDatabase
from repro_torch.aggregates.semiring import Sum
from repro_torch.api import (
    Avg,
    Count,
    Max,
    Min,
    Q,
    RefChannelEngine,
    TorchChannelEngine,
    UnsupportedPlanOption,
)
from repro_torch.core import datagraph, join_agg, ref_engine
from repro_torch.core.prepare import prepare
from repro_torch.core.query import JoinAggQuery
from repro_torch.data import queries as port_queries
from repro_torch.data import synth as port_synth
from repro_torch.ghd import ghd_join_agg
from repro_torch.incremental import MaintainedJoinAgg
from repro_torch.relational.relation import Database
from repro_torch.serve import JoinAggServer

CPU = RefChannelEngine(device="cpu")
ACYCLIC = {**jqueries.REAL, **jqueries.SKEWED}
GENERATORS = {**ACYCLIC, **jqueries.CYCLIC}
MAINTAIN_STATS = ("refreshes", "delta_rows", "rows_rescanned", "fallback_recomputes",
                  "dirty_bags", "clean_bags_reused")


def catalog(name: str, n: int, seed: int = 0):
    """``(jax db, jax query, port db, port query)`` for one dataset."""
    if name in jsynth.ALL:
        jdb, jq = jsynth.make(name, n, seed=seed)
        db, q = port_synth.make(name, n, seed=seed)
    else:
        gen = GENERATORS[name]
        jdb, jq = gen(n, seed=seed)
        db, q = getattr(port_queries, gen.__name__)(n, seed=seed)
    return jdb, jq, db, q


def with_measure(jdb, rel: str, values):
    """The columns of ``jdb`` with a measure ``m`` on ``rel``, as both
    packages' databases."""
    cols = {r: dict(jdb[r].columns) for r in jdb.relations}
    cols[rel]["m"] = values
    return JDatabase.from_mapping(cols), Database.from_mapping(cols)


def ref_nodes(g):
    return [
        (g.node_rel[i], g.node_side[i], tuple(int(v) for v in g.node_vals[i]), g.node_type[i])
        for i in range(g.num_nodes)
    ]


def edge_multiset(offsets, dst, weights, keys):
    """Counter of ``(src key, dst key, weight)`` over a CSR graph."""
    out = Counter()
    for src in range(len(offsets) - 1):
        for e in range(offsets[src], offsets[src + 1]):
            out[(keys[src], keys[dst[e]], weights[e])] += 1
    return out


def both_graphs(jp, pp, **kw):
    jg = jdg.build_data_graph(jp, **{k: v for k, v in kw.items() if k != "device"})
    pg = datagraph.build_data_graph(pp, device="cpu", **kw)
    return jg, pg


# ----------------------------------------------------------------------
# the data graph
# ----------------------------------------------------------------------


@pytest.mark.parametrize("name", list(jsynth.ALL) + list(ACYCLIC))
def test_data_graph_matches_reference(name):
    n = 1500 if name in jsynth.ALL else 400
    jdb, jq, db, q = catalog(name, n)
    jg, pg = both_graphs(jprepare(jq, jdb), prepare(q, db))
    assert (pg.num_nodes, pg.num_edges, pg.memory_bytes()) == (
        jg.num_nodes, jg.num_edges, jg.memory_bytes()
    )
    assert pg.device_bytes() > 0
    jkeys, pkeys = ref_nodes(jg), pg.node_table()
    assert Counter(pkeys) == Counter(jkeys)  # the same node set, each once
    assert len(set(pkeys)) == len(pkeys)
    assert sorted(pkeys[s] for s in pg.sources.tolist()) == sorted(jkeys[s] for s in jg.sources)
    want = edge_multiset(jg.offsets, jg.edge_dst, jg.edge_mult.tolist(), jkeys)
    got = edge_multiset(pg.offsets.tolist(), pg.edge_dst.tolist(), pg.edge_mult.tolist(), pkeys)
    assert got == want
    typ = pg.node_type.tolist()
    assert [t for *_, t in pkeys] == typ


@pytest.mark.parametrize("name,rel", [("B2", "R2"), ("C1", "R3"), ("IMDB", "E1")])
def test_channel_weights_match_reference(name, rel):
    jdb, jq, _, q = catalog(name, 600)
    rng = np.random.default_rng(4)
    jdb, db = with_measure(jdb, rel, rng.integers(1, 9, jdb[rel].num_rows))
    jp, pp = jprepare(jq, jdb, measures={rel: "m"}), prepare(q, db, measures={rel: "m"})
    mrel = pp.measure_moves.get(rel, rel)
    assert mrel == jp.measure_moves.get(rel, rel)

    def channels(p):
        er = p.encoded[mrel]
        return {mrel: np.stack([er.count, er.payloads["sum"]], 1).astype(np.float64)}

    jg = jdg.build_data_graph(jp, weight_channels=channels(jp), channels=2)
    pg = datagraph.build_data_graph(pp, weight_channels=channels(pp), channels=2, device="cpu")
    jkeys, pkeys = ref_nodes(jg), pg.node_table()
    want = edge_multiset(jg.offsets, jg.edge_dst, [tuple(w) for w in jg.edge_w.tolist()], jkeys)
    got = edge_multiset(pg.offsets.tolist(), pg.edge_dst.tolist(),
                        [tuple(w) for w in pg.edge_w.tolist()], pkeys)
    assert got == want


# ----------------------------------------------------------------------
# Stage 2, source by source
# ----------------------------------------------------------------------


def traversal_state(g: datagraph.DataGraph, source: int):
    """The reference's Stage 2 output for one source node, rebuilt on
    the host: ``(cpairs, path_counts, child_pids)`` with path-ids as
    tuples of branching node ids and values as float64 (k,) arrays
    (``_traverse_ch``'s layout)."""
    tr = ref_engine.traverse(g, torch.tensor([source], device=g.device))
    parent = tr.pid_parent.tolist()
    node = tr.pid_node.tolist()
    count = tr.pid_count.double().cpu().numpy()

    def tup(p: int) -> tuple[int, ...]:
        out = []
        while parent[p] >= 0:
            out.append(node[p])
            p = parent[p]
        return tuple(reversed(out))

    table = g.node_table()
    cpairs: dict = {}
    for p, n, v in zip(tr.cp_pid.tolist(), tr.cp_node.tolist(), tr.cp_val.double().cpu().numpy()):
        rel, _, vals, _ = table[n]
        cpairs.setdefault((rel, tup(p)), {})[vals[0]] = v
    path_counts, child_pids = {}, {}
    for p in range(1, len(parent)):
        path_counts[tup(p)] = count[p]
        child_pids.setdefault(tup(parent[p]), []).append(node[p])
    return cpairs, path_counts, child_pids


def _relabel(state, to_ref):
    cpairs, counts, children = state
    tup = lambda pid: tuple(to_ref[v] for v in pid)  # noqa: E731
    return (
        {(rel, tup(pid)): {c: np.asarray(v) for c, v in d.items()} for (rel, pid), d in cpairs.items()},
        {tup(pid): np.asarray(v) for pid, v in counts.items()},
        {tup(pid): sorted(to_ref[v] for v in vs) for pid, vs in children.items()},
    )


def _same_state(got, want):
    for g, w in zip(got[:2], want[:2]):
        assert set(g) == set(w)
    for key, d in want[0].items():
        assert set(got[0][key]) == set(d), key
        for code, v in d.items():
            np.testing.assert_array_equal(np.ravel(got[0][key][code]), np.ravel(v))
    for pid, v in want[1].items():
        np.testing.assert_array_equal(np.ravel(got[1][pid]), np.ravel(v))
    assert got[2] == {pid: sorted(v) for pid, v in want[2].items() if v}


@pytest.mark.parametrize("name", ["B2", "B3", "C1", "IMDB", "TPCH"])
def test_traverse_matches_reference_source_by_source(name):
    jdb, jq, db, q = catalog(name, 800)
    jp, pp = jprepare(jq, jdb), prepare(q, db)
    jg = jdg.build_data_graph(jp)
    pg = datagraph.build_data_graph(pp, channels=1, device="cpu")
    index = {key: i for i, key in enumerate(ref_nodes(jg))}
    pkeys = pg.node_table()
    to_ref = [index[key] for key in pkeys]
    sources = pg.sources.tolist()[:12]
    branched = 0
    for s in sources:
        want = jref._traverse(jg, to_ref[s])
        got = _relabel(traversal_state(pg, s), to_ref)
        _same_state(got, (want.cpairs, want.path_counts, want.child_pids))
        branched += len(want.path_counts)
    if name in ("B2", "B3"):
        assert branched > 0  # path-ids were made and checked


def test_traverse_channels_match_reference_source_by_source():
    jdb, jq, _, q = catalog("B2", 800)
    jdb, db = with_measure(jdb, "R4", np.random.default_rng(5).integers(1, 30, 800))
    jp, pp = jprepare(jq, jdb, measures={"R4": "m"}), prepare(q, db, measures={"R4": "m"})

    def channels(p):
        er = p.encoded["R4"]
        return {"R4": np.stack([er.count, er.payloads["sum"]], 1).astype(np.float64)}

    jg = jdg.build_data_graph(jp, weight_channels=channels(jp), channels=2)
    pg = datagraph.build_data_graph(pp, weight_channels=channels(pp), channels=2, device="cpu")
    index = {key: i for i, key in enumerate(ref_nodes(jg))}
    to_ref = [index[key] for key in pg.node_table()]
    for s in pg.sources.tolist()[:8]:
        want = jref._traverse_ch(jg, to_ref[s], 2)
        got = _relabel(traversal_state(pg, s), to_ref)
        _same_state(got, (want.cpairs, want.path_counts, want.child_pids))


# ----------------------------------------------------------------------
# source tiles
# ----------------------------------------------------------------------


@pytest.mark.parametrize("tile", [1, 2, None])
@pytest.mark.parametrize("name,rel", [("B2", "R2"), ("C1", "R3"), ("SKEWCHAIN", "R2")])
def test_source_tiles_give_the_reference_answers(name, rel, tile, monkeypatch):
    jdb, jq, _, q = catalog(name, 900)
    jdb, db = with_measure(jdb, rel, np.random.default_rng(6).integers(0, 20, jdb[rel].num_rows))
    jp, pp = jprepare(jq, jdb, measures={rel: "m"}), prepare(q, db, measures={rel: "m"})
    mrel = pp.measure_moves.get(rel, rel)
    cm = (None, mrel)
    want = jref.execute_ref_channels(jp, cm)
    monkeypatch.setattr(ref_engine, "ref_run", partial(ref_engine.ref_run, tile=tile))
    got = ref_engine.execute_ref_channels(pp, cm, device="cpu")
    assert set(got) == set(want) and want
    for key, v in want.items():
        np.testing.assert_array_equal(got[key], v)
    assert ref_engine.execute_ref(q, db, device="cpu") == jref.execute_ref(jq, jdb)


@pytest.mark.parametrize("name", ["B2", "C1"])
def test_row_bound_splits_tiles_and_keeps_the_answer(name, monkeypatch):
    _, _, db, q = catalog(name, 900)
    pp = prepare(q, db)
    whole = ref_engine.ref_run(pp, (None,), "cpu", tile=10**9)
    monkeypatch.setattr(ref_engine, "TILE_ROWS", 200)
    small = ref_engine.ref_run(pp, (None,), "cpu")
    assert whole.tiles == 1 and small.splits > 0 and small.tiles > 1
    assert small.peak_rows <= whole.peak_rows
    assert torch.equal(small.codes, whole.codes) and torch.equal(small.values, whole.values)


def test_split_ranges_respect_the_bound():
    assert ref_engine._split(np.array([5, 5, 5, 20, 1, 1]), 10) == [(0, 2), (2, 3), (3, 4), (4, 6)]
    assert ref_engine._split(np.array([3]), 1) == [(0, 1)]


@pytest.mark.parametrize("dims", [[7, 5, 3], [2**40, 2**20, 2**10]])
def test_composite_keys_group_past_int64(dims):
    """Key tuples whose ranges multiply past 2**63 group through
    ``torch.unique(dim=0)`` with the same order and sums."""
    rng = np.random.default_rng(8)
    cols = [torch.from_numpy(rng.integers(0, 3, 400)) for _ in dims]
    vals = torch.from_numpy(rng.integers(-4, 5, (400, 2)).astype(np.float32))
    first, sums = ref_engine._keyed_sum(cols, dims, vals)
    rows = torch.stack([c[first] for c in cols], 1).tolist()
    assert rows == sorted(rows) and len(set(map(tuple, rows))) == len(rows)
    want = {}
    for i in range(400):
        key = tuple(int(c[i]) for c in cols)
        want[key] = want.get(key, 0) + vals[i].numpy()
    for row, s in zip(rows, sums.numpy()):
        np.testing.assert_array_equal(s, want[tuple(row)])


# ----------------------------------------------------------------------
# plans
# ----------------------------------------------------------------------


def bundle(api, qcls, q, rel):
    count, total, avg, lo, hi = api
    groups = [f"{r}.{a}" for r, a in q.group_by]
    m = f"{rel}.m"
    return qcls.over(*q.relations).group_by(*groups).agg(
        n=count(), s=total(m), a=avg(m), lo=lo(m), hi=hi(m)
    )


def assert_identical(want, got):
    assert list(got.relation.columns) == list(want.relation.columns)
    for c in want.relation.columns:
        a, b = want.column(c), got.column(c)
        assert a.dtype == b.dtype, c
        np.testing.assert_array_equal(b, a, err_msg=c)


@pytest.mark.parametrize("stats", [True, False])
@pytest.mark.parametrize("name", list(GENERATORS))
def test_plans_match_reference(name, stats):
    jdb, jq, _, q = catalog(name, 300 if name in jqueries.CYCLIC else 500)
    rel = q.relations[-1]
    jdb, db = with_measure(jdb, rel, np.random.default_rng(1).integers(0, 50, jdb[rel].num_rows))
    want = bundle((JCount, JSum, JAvg, JMin, JMax), JQ, jq, rel).stats(stats).engine("ref").execute(jdb)
    got = bundle((Count, Sum, Avg, Min, Max), Q, q, rel).stats(stats).engine(CPU).execute(db)
    assert got.num_rows > 0
    assert_identical(want, got)


def test_folded_single_group_query_matches_reference():
    """R2 and R3 fold into R1, leaving the root alone: the count per
    source is the sum over its maximal paths."""
    rng = np.random.default_rng(2)
    cols = {
        "R1": {"g": rng.integers(0, 9, 300), "j": rng.integers(0, 12, 300)},
        "R2": {"j": rng.integers(0, 12, 300), "k": rng.integers(0, 7, 300),
               "m": rng.integers(0, 9, 300)},
        "R3": {"k": rng.integers(0, 7, 100)},
    }
    jdb, db = JDatabase.from_mapping(cols), Database.from_mapping(cols)
    want = JQ.over("R1", "R2", "R3").group_by("R1.g").agg(n=JCount(), s=JSum("R2.m")).engine("ref")
    got = Q.over("R1", "R2", "R3").group_by("R1.g").agg(n=Count(), s=Sum("R2.m")).engine(CPU)
    plan = got.plan(db)
    assert len(plan.prep.decomposition.nodes) == 1
    assert_identical(want.execute(jdb), plan.execute())
    q = JoinAggQuery(("R1", "R2", "R3"), (("R1", "g"),))
    assert ref_engine.execute_ref(q, db, device="cpu") == jref.execute_ref(
        JQuery(("R1", "R2", "R3"), (("R1", "g"),)), jdb
    )


def test_empty_join_returns_no_rows():
    rng = np.random.default_rng(3)
    cols = {
        "R": {"g1": rng.integers(0, 5, 100), "j": rng.integers(0, 9, 100)},
        "S": {"j": rng.integers(0, 9, 100) + 100, "k": rng.integers(0, 9, 100),
              "m": rng.integers(0, 9, 100)},
        "T": {"k": rng.integers(0, 9, 100), "g2": rng.integers(0, 5, 100)},
    }
    jdb, db = JDatabase.from_mapping(cols), Database.from_mapping(cols)
    want = (JQ.over("R", "S", "T").group_by("R.g1", "T.g2")
            .agg(n=JCount(), s=JSum("S.m")).engine("ref").execute(jdb))
    got = (Q.over("R", "S", "T").group_by("R.g1", "T.g2")
           .agg(n=Count(), s=Sum("S.m")).engine(CPU).execute(db))
    assert want.num_rows == got.num_rows == 0
    assert_identical(want, got)
    # MIN/MAX over it raise in the JAX package; the port returns 0 rows
    mm = (Q.over("R", "S", "T").group_by("R.g1", "T.g2")
          .agg(n=Count(), lo=Min("S.m"), hi=Max("S.m")).engine(CPU).execute(db))
    assert mm.num_rows == 0


def test_fractional_sum_within_tolerance():
    jdb, jq, _, q = catalog("B2", 1500)
    jdb, db = with_measure(jdb, "R2", np.random.default_rng(9).uniform(0.0, 7.0, 1500))
    api = (JCount, JSum, JAvg, JMin, JMax), (Count, Sum, Avg, Min, Max)
    want = bundle(api[0], JQ, jq, "R2").engine("ref").execute(jdb)
    got = bundle(api[1], Q, q, "R2").engine(CPU).execute(db)
    assert want.num_rows == got.num_rows > 0
    for c in ("g1", "g2", "g3", "n", "lo", "hi"):
        np.testing.assert_array_equal(got.column(c), want.column(c))
    for c in ("s", "a"):
        np.testing.assert_allclose(got.column(c), want.column(c), rtol=1e-5)


# ----------------------------------------------------------------------
# shims and options
# ----------------------------------------------------------------------


@pytest.mark.parametrize("name", ["C1", "TPCH", "SKEWCHAIN", "TRIANGLE"])
def test_join_agg_ref_matches_reference(name):
    jdb, jq, db, q = catalog(name, 400)
    assert join_agg(q, db, engine=CPU) == joperator.join_agg(jq, jdb, engine="ref")


@pytest.mark.parametrize("name", list(jqueries.CYCLIC))
def test_ghd_join_agg_ref_matches_reference(name):
    jdb, jq, db, q = catalog(name, 300)
    want = jrewrite.ghd_join_agg(jq, jdb, engine="ref")
    assert want and ghd_join_agg(q, db, engine=CPU) == want


def test_ref_refuses_what_the_reference_refuses():
    jdb, jq, db, q = catalog("TRIANGLE", 200)
    attr = jdb["E1"].attrs[0]
    jq_sum = JQuery(jq.relations, jq.group_by, JSum("E1", attr))
    q_sum = JoinAggQuery(q.relations, q.group_by, Sum("E1", attr))
    with pytest.raises(NotImplementedError):
        jrewrite.ghd_join_agg(jq_sum, jdb, engine="ref")
    with pytest.raises(NotImplementedError):
        ghd_join_agg(q_sum, db, engine=CPU)
    jdb, jq, db, q = catalog("C1", 200)
    with pytest.raises(NotImplementedError):
        jref.execute_ref(JQuery(jq.relations, jq.group_by, JSum("R1", "p0")), jdb)
    with pytest.raises(NotImplementedError):
        ref_engine.execute_ref(JoinAggQuery(q.relations, q.group_by, Sum("R1", "p0")), db,
                               device="cpu")
    groups = [f"{r}.{a}" for r, a in q.group_by]
    for option in (lambda x: x.stream("g1", 4), lambda x: x.memory_budget(1 << 20)):
        with pytest.raises(UnsupportedPlanOption):
            option(Q.over(*q.relations).group_by(*groups).agg(n=Count()).engine(CPU)).plan(db)
        with pytest.raises(joperator.UnsupportedPlanOption):
            option(JQ.over(*jq.relations).group_by(*groups).agg(n=JCount())
                   .engine("ref")).plan(jdb)
    for option in (lambda x: x.fused(True), lambda x: x.mesh(1)):
        with pytest.raises(UnsupportedPlanOption):
            option(Q.over(*q.relations).group_by(*groups).agg(n=Count()).engine(CPU)).plan(db)


def test_ref_plan_does_not_split():
    jdb, jq, db, q = catalog("SKEWCHAIN", 3000)
    groups = [f"{r}.{a}" for r, a in q.group_by]
    spec = Q.over(*q.relations).group_by(*groups).agg(n=Count())
    assert spec.engine(TorchChannelEngine(device="cpu")).plan(db).split is not None
    plan = spec.engine(CPU).plan(db)
    assert plan.split is None
    jplan = JQ.over(*jq.relations).group_by(*groups).agg(n=JCount()).engine("ref").plan(jdb)
    assert jplan.split is None
    assert_identical(jplan.execute(), plan.execute())


# ----------------------------------------------------------------------
# maintenance
# ----------------------------------------------------------------------


class RefTwin:
    """The port's ``engine="ref"`` handle on the CPU and the reference's,
    through the same batches, compared after each."""

    def __init__(self, cols, relations, group_by):
        self.port = MaintainedJoinAgg(
            JoinAggQuery(relations, group_by, Count()), Database.from_mapping(cols),
            engine="ref", device="cpu",
        )
        self.ref = JMaintained(
            JQuery(relations, group_by, JCount()), JDatabase.from_mapping(cols), engine="ref"
        )
        self.check()

    def apply(self, op, rel, batch):
        getattr(self.port, op)(rel, batch)
        getattr(self.ref, op)(rel, batch)
        self.check()

    def check(self):
        assert self.port.result() == self.ref.result()
        for name in MAINTAIN_STATS:
            assert getattr(self.port.stats, name) == getattr(self.ref.stats, name), name


def star(n=300, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "R1": {"g1": rng.integers(0, 5, n), "j": rng.integers(0, 6, n)},
        "R2": {"j": rng.integers(0, 6, n), "b": rng.integers(0, 4, n)},
        "R3": {"b": rng.integers(0, 4, n), "g2": rng.integers(0, 5, n)},
        "R4": {"b": rng.integers(0, 4, n), "g3": rng.integers(0, 3, n)},
    }


def test_maintained_ref_inserts_and_deletes_match_reference():
    cols = star()
    t = RefTwin(cols, ("R1", "R2", "R3", "R4"), (("R1", "g1"), ("R3", "g2"), ("R4", "g3")))
    t.apply("insert", "R2", {"j": np.array([0, 1, 9]), "b": np.array([2, 2, 7])})  # grows j, b
    t.apply("delete", "R2", {a: c[:40] for a, c in cols["R2"].items()})
    t.apply("insert", "R3", {"b": np.array([7, 1]), "g2": np.array([11, 2])})
    t.apply("delete", "R1", {a: c[5:25] for a, c in cols["R1"].items()})
    t.apply("insert", "R1", {"g1": np.array([6, 0]), "j": np.array([9, 1])})
    assert t.port.stats.rows_rescanned > 0


def test_maintained_ref_fold_breaking_delta_matches_reference():
    rng = np.random.default_rng(4)
    n = 150
    cols = {
        "R1": {"g1": rng.integers(0, 5, n), "p": rng.integers(0, 6, n)},
        "R2": {"p": rng.integers(0, 6, n), "g2": rng.integers(0, 5, n)},
        "R3": {"p": rng.integers(0, 6, n // 3)},
    }
    t = RefTwin(cols, ("R1", "R2", "R3"), (("R1", "g1"), ("R2", "g2")))
    assert t.port.fold_mode and "R3" in t.port._fold_affected
    t.apply("insert", "R3", {"p": np.array([0, 0, 3])})
    t.apply("delete", "R3", {"p": cols["R3"]["p"][:10]})
    assert t.port.stats.fallback_recomputes == 2
    t.apply("insert", "R2", {"p": np.array([1]), "g2": np.array([0])})


def test_maintained_ref_cyclic_query_matches_reference():
    rng = np.random.default_rng(3)
    m = 200
    cols = {
        "E1": {"x": rng.integers(0, 15, m), "y": rng.integers(0, 15, m)},
        "E2": {"y": rng.integers(0, 15, m), "z": rng.integers(0, 15, m)},
        "E3": {"z": rng.integers(0, 15, m), "x": rng.integers(0, 15, m),
               "g": rng.integers(0, 6, m)},
    }
    t = RefTwin(cols, ("E1", "E2", "E3"), (("E3", "g"),))
    assert t.port.cyclic
    extra = {"x": np.array([3, 5]), "y": np.array([7, 2])}
    t.apply("insert", "E1", extra)
    t.apply("delete", "E1", extra)
    t.apply("insert", "E2", {"y": np.array([7, 40]), "z": np.array([1, 41])})


def test_maintained_ref_is_count_only():
    cols = star()
    rels, groups = ("R1", "R2", "R3", "R4"), (("R1", "g1"), ("R3", "g2"), ("R4", "g3"))
    cols["R2"]["m"] = np.arange(300)
    with pytest.raises(NotImplementedError, match="COUNT only"):
        JMaintained(JQuery(rels, groups, JSum("R2", "m")), JDatabase.from_mapping(cols),
                    engine="ref")
    with pytest.raises(NotImplementedError, match="COUNT only"):
        MaintainedJoinAgg(JoinAggQuery(rels, groups, Sum("R2", "m")),
                          Database.from_mapping(cols), engine="ref", device="cpu")
    spec = Q.over(*rels).group_by("R1.g1", "R3.g2", "R4.g3")
    handle = spec.agg(n=Count()).engine(CPU).maintain(cols)
    assert isinstance(handle, MaintainedJoinAgg) and handle.engine == "ref"
    with pytest.raises(NotImplementedError):
        spec.agg(n=Count(), a=Avg("R2.m")).engine(CPU).maintain(cols)


# ----------------------------------------------------------------------
# serving and the device rule
# ----------------------------------------------------------------------


def test_served_ref_request_equals_its_solo_execute():
    _, _, db, q = catalog("B2", 1500)
    spec = Q.over(*q.relations).group_by("R1.g1", "R3.g2", "R4.g3").agg(n=Count())
    srv = JoinAggServer(db, device="cpu", workers=2)
    try:
        got = srv.submit(spec.engine("ref")).result(timeout=120)
    finally:
        srv.close()
    want = spec.engine(CPU).execute(db)
    assert got.num_rows == want.num_rows > 0
    assert_identical(want, got)


def test_ref_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, db, q = catalog("C1", 200)
    spec = Q.over(*q.relations).group_by("R1.g1", "R4.g2").agg(n=Count())
    with pytest.raises(RuntimeError, match=r'RefChannelEngine\(device="cpu"\)'):
        spec.engine("ref").execute(db)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MaintainedJoinAgg(q, db, engine="ref")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ref_engine.execute_ref(q, db)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        datagraph.build_data_graph(prepare(q, db))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        join_agg(q, db, engine="ref")
    tri = catalog("TRIANGLE", 100)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ghd_join_agg(tri[3], tri[2], engine="ref")
    assert spec.engine(CPU).execute(db).num_rows > 0


@pytest.mark.parametrize("name,rel", [("C1", "R3"), ("B2", "R2")])
def test_out_edges_equal_the_reference(name, rel):
    """``DataGraph.out``/``.out_w`` of every node of a small graph built
    on the CPU: the reference's out-edges of the same node (matched by
    relation, side and codes), as multisets, and in channel mode the
    weight rows."""
    jdb, jq, _, q = catalog(name, 300)
    rng = np.random.default_rng(6)
    jdb, db = with_measure(jdb, rel, rng.integers(1, 9, jdb[rel].num_rows))
    jp, pp = jprepare(jq, jdb, measures={rel: "m"}), prepare(q, db, measures={rel: "m"})
    jg, pg = both_graphs(jp, pp)
    jkeys, pkeys = ref_nodes(jg), pg.node_table()
    to_ref = {k: i for i, k in enumerate(jkeys)}
    for n, key in enumerate(pkeys):
        j = to_ref[key]
        got = Counter((pkeys[d], m) for d, m in pg.out(n))
        assert got == Counter((jkeys[d], m) for d, m in jg.out(j)), key
    mrel = pp.measure_moves.get(rel, rel)

    def channels(p):
        er = p.encoded[mrel]
        return {mrel: np.stack([er.count, er.payloads["sum"]], 1).astype(np.float64)}

    jg = jdg.build_data_graph(jp, weight_channels=channels(jp), channels=2)
    pg = datagraph.build_data_graph(pp, weight_channels=channels(pp), channels=2, device="cpu")
    jkeys, pkeys = ref_nodes(jg), pg.node_table()
    to_ref = {k: i for i, k in enumerate(jkeys)}
    for n, key in enumerate(pkeys):
        dst, w = pg.out_w(n)
        jdst, jw = jg.out_w(to_ref[key])
        assert isinstance(dst, np.ndarray) and w.shape == (len(dst), 2)
        assert Counter((pkeys[d], tuple(r)) for d, r in zip(dst.tolist(), w.tolist())) == Counter(
            (jkeys[d], tuple(r)) for d, r in zip(jdst.tolist(), jw.tolist())), key
