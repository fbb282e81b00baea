"""The port's statistics, cost model and split plans against the JAX
package's, on the same numpy inputs.

Every catalog query (the synthetic C1, S1 and B1, the REAL, SKEWED and
CYCLIC catalogs of ``data/queries.py``) is planned by
``repro.api.Q.from_query(...).engine("jax")`` and by the port's
``Q.from_query(...).engine(TorchChannelEngine(device="cpu"))``, with
statistics on (the default of both) and off: the statistics, the cost
of the chosen plan, the root and the split must be the same.  Results
of split plans are held bit for bit against ``engine("jax")`` (CPU auto
mode, its plain kernels) and ``engine("tensor")``: the measures are
integers, so every float32 partial and every float64 merge is exact.
Tests that mean the sparse walk pin it (``mode="sparse"``) beside a case
in the default ``mode="auto"``, which runs each key range of a split
plan on the path ``choose_path`` picks for it (dense at these sizes).
"""
import numpy as np
import pytest

from repro.api import Avg as JAvg
from repro.api import Count as JCount
from repro.api import Max as JMax
from repro.api import Min as JMin
from repro.api import Q as JQ
from repro.api import Sum as JSum
from repro.data import queries as jqueries
from repro.data import synth as jsynth
from repro.planner import qerror as j_qerror
from repro.planner.cost import actual_node_cards as j_actual_cards
from repro.planner.cost import node_card_estimates as j_node_cards
from repro.planner.cost import plan_cost as j_plan_cost
from repro.relational.relation import Database as JDatabase
from repro_torch.api import Avg, Count, Max, Min, Q, Sum, TorchChannelEngine
from repro_torch.core import torch_engine
from repro_torch.data import queries as port_queries
from repro_torch.data import synth as port_synth
from repro_torch import planner
from repro_torch.planner.cost import actual_node_cards, node_card_estimates, plan_cost
from repro_torch.relational.relation import Database

CPU = TorchChannelEngine(device="cpu")
MODES = pytest.mark.parametrize("mode", ["sparse", "auto"])
SYNTH = ("C1", "S1", "B1")
GENERATORS = {**jqueries.REAL, **jqueries.SKEWED, **jqueries.CYCLIC}
CATALOG = SYNTH + tuple(GENERATORS)


def catalog(name: str, n: int, seed: int = 0):
    """``(jax db, jax query, port db, port query)`` for one catalog entry."""
    if name in SYNTH:
        jdb, jq = jsynth.make(name, n, seed=seed)
        db, q = port_synth.make(name, n, seed=seed)
    else:
        gen = GENERATORS[name]
        jdb, jq = gen(n, seed=seed)
        db, q = getattr(port_queries, gen.__name__)(n, seed=seed)
    return jdb, jq, db, q


def with_column(jdb, db, rel: str, attr: str, values):
    """Both databases with one more column on ``rel``."""
    cols = {r: dict(jdb[r].columns) for r in jdb.relations}
    cols[rel][attr] = values
    return JDatabase.from_mapping(cols), Database.from_mapping(cols)


def assert_identical(ref, got):
    assert list(got.relation.columns) == list(ref.relation.columns)
    for c in ref.relation.columns:
        a, b = ref.column(c), got.column(c)
        assert a.dtype == b.dtype, (c, a.dtype, b.dtype)
        np.testing.assert_array_equal(b, a, err_msg=c)


def assert_stats_equal(want, got):
    assert list(got.relations) == list(want.relations)
    for rel, wr in want.relations.items():
        gr = got.relations[rel]
        assert (gr.rows, gr.num_rows) == (wr.rows, wr.num_rows), rel
        assert list(gr.cols) == list(wr.cols), rel
        for attr, wc in wr.cols.items():
            gc = gr.cols[attr]
            assert gc.domain == wc.domain, (rel, attr)
            np.testing.assert_array_equal(gc.distinct._hashes, wc.distinct._hashes)
            assert gc.est_distinct == wc.est_distinct, (rel, attr)
            assert (gc.heavy.counts, gc.heavy.n, gc.heavy.err) == (
                wc.heavy.counts, wc.heavy.n, wc.heavy.err
            ), (rel, attr)
            for share in (0.0, 0.05, 0.15):
                assert got.heavy_keys(rel, attr, share) == want.heavy_keys(
                    rel, attr, share
                )
    assert got.fanouts == want.fanouts


def assert_same_split(want, got):
    assert (got is None) == (want is None)
    if want is not None:
        assert (got.attr, got.ranges, got.roots, got.heavy) == (
            want.attr, want.ranges, want.roots, want.heavy
        )
        assert (got.est_unsplit_peak, got.est_split_peak) == (
            want.est_unsplit_peak, want.est_split_peak
        )


@pytest.mark.parametrize("name", CATALOG)
def test_statistics_equal_the_reference(name):
    """Sketches (KMV hashes, Misra-Gries counters, heavy keys) and the
    seeded fanout samples of every catalog query, post-fold; for a
    cyclic query those of the derived bag relations."""
    jdb, jq, db, q = catalog(name, 3000)
    jplan = JQ.from_query(jq).engine("jax").plan(jdb)
    plan = Q.from_query(q).engine(CPU).plan(db)
    assert_stats_equal(jplan.stats, plan.stats)


@pytest.mark.parametrize("stats", [True, False])
@pytest.mark.parametrize("name", CATALOG)
def test_plan_choice_matches_the_reference(name, stats):
    """Root, split (attribute, ranges, roots, heavy keys, peaks), the
    estimated peak and, with statistics on, the cost model's estimates
    of the chosen plan."""
    jdb, jq, db, q = catalog(name, 3000)
    jplan = JQ.from_query(jq).engine("jax").stats(stats).plan(jdb)
    plan = Q.from_query(q).engine(CPU).stats(stats).plan(db)
    assert plan.stats_enabled is stats and plan.cyclic == jplan.cyclic
    assert plan.prep.decomposition.root == jplan.prep.decomposition.root
    assert plan.prep.decomposition.order == jplan.prep.decomposition.order
    assert_same_split(jplan.split, plan.split)
    assert plan.est_peak == jplan.est_peak
    if stats:
        assert plan_cost(plan.prep, plan.stats) == j_plan_cost(jplan.prep, jplan.stats)
        assert node_card_estimates(plan.prep, plan.stats) == j_node_cards(
            jplan.prep, jplan.stats
        )


def test_skewed_chain_splits_on_its_hot_key():
    _, _, db, q = catalog("SKEWCHAIN", 3000)
    plan = Q.from_query(q).engine(CPU).plan(db)
    split = plan.split
    assert split is not None and split.attr == "p0" and split.num_splits == 9
    assert [code for code, _ in split.heavy] == [0]
    assert split.est_split_peak * 2 <= split.est_unsplit_peak
    assert plan.est_peak == split.est_split_peak
    assert plan.resolved_stream() is None
    assert Q.from_query(q).engine(CPU).stats(False).plan(db).split is None


def _skew_bundle(qcls, api, fused, stats):
    count, total, avg = api
    q = qcls.over("R1", "R2").group_by("R1.g1", "R2.g2").agg(
        n=count(), s=total("R2.m"), a=avg("R2.m")
    ).stats(stats)
    return q.fused(fused) if fused is not None else q


@MODES
@pytest.mark.parametrize("stats", [True, False])
@pytest.mark.parametrize("fused", [None, True])
def test_split_results_bit_identical(fused, stats, mode):
    """SKEWCHAIN with COUNT/SUM/AVG of an integer measure (MIN/MAX would
    turn the split off), unfused and fused, split (statistics on) or
    not: equal bit for bit to engine("jax") and engine("tensor")."""
    jdb, _, db, _ = catalog("SKEWCHAIN", 3000)
    m = np.random.default_rng(5).integers(0, 50, 3000)
    jdb, db = with_column(jdb, db, "R2", "m", m)
    engine = TorchChannelEngine(device="cpu", mode=mode)
    plan = _skew_bundle(Q, (Count, Sum, Avg), fused, stats).engine(engine).plan(db)
    assert (plan.split is not None) is stats
    got = plan.execute()
    assert got.num_rows > 0
    for name in ("jax", "tensor"):
        jplan = _skew_bundle(JQ, (JCount, JSum, JAvg), None, stats).engine(name).plan(jdb)
        assert_same_split(jplan.split, plan.split)
        assert_identical(jplan.execute(), got)


@MODES
def test_split_parts_built_once_and_reused(mode):
    """The per-range ``Prepared`` set is built on the first execute and
    kept: a warm execute uploads no view (sparse) and gives the same
    bits.  A range's dense relation tensors (auto: every range runs
    dense) are built per run and dropped, so the split holds one
    range's tensors at a time."""
    _, _, db, q = catalog("SKEWCHAIN", 3000)
    plan = Q.from_query(q).engine(TorchChannelEngine(device="cpu", mode=mode)).plan(db)
    first = plan.execute()
    parts = plan._split_parts
    assert 1 < len(parts) <= plan.split.num_splits
    want = "dense" if mode == "auto" else "sparse"
    assert all(plan.engine.path(p, plan.channels) == want for p in parts)
    views = [dict(p.device_views) for p in parts]
    assert not any(k[0] == "dense" for v in views for k in v)
    assert all(views) if mode == "sparse" else not any(views)
    second = plan.execute()
    assert plan._split_parts is parts
    for p, before in zip(parts, views):
        assert p.device_views.keys() == before.keys()
        assert all(p.device_views[k] is v for k, v in before.items())
    assert_identical(first, second)
    unsplit = Q.from_query(q).engine(CPU).stats(False).plan(db).execute()
    assert_identical(unsplit, first)


def test_split_over_budget_falls_back_like_the_reference():
    """A memory budget below the split's estimated peak drops the split
    (and streams instead), in both packages."""
    jdb, jq, db, q = catalog("SKEWCHAIN", 3000)
    peak = Q.from_query(q).engine(CPU).plan(db).split.est_split_peak
    plan = Q.from_query(q).engine(CPU).memory_budget(peak - 1).plan(db)
    jplan = JQ.from_query(jq).engine("jax").memory_budget(peak - 1).plan(jdb)
    assert plan.split is None and jplan.split is None
    assert plan.resolved_stream() is not None
    assert_identical(jplan.execute(), plan.execute())


# ----------------------------------------------------------------------
# fractional measures and empty joins
# ----------------------------------------------------------------------

# Every term of these sums is positive, so each engine's float32 result
# is within (terms added in one chain) x 2**-24 of the exact sum; the
# engines add in different orders.  On these inputs the port and either
# JAX engine differ by at most 4.0e-7 relative; 1e-5 (about 168 float32
# ulps) leaves room for the rounding of either order.  Counts and
# MIN/MAX stay exact.
FRACTIONAL_RTOL = 1e-5


@MODES
@pytest.mark.parametrize("name,rel,minmax", [
    ("IMDB", "E1", True),  # the bundle with MIN/MAX, unsplit
    ("SKEWCHAIN", "R2", False),  # COUNT/SUM/AVG: a split plan
])
def test_fractional_measure_sum_within_tolerance(name, rel, minmax, mode):
    jdb, jq, db, q = catalog(name, 3000)
    m = np.random.default_rng(9).uniform(0.0, 7.0, jdb[rel].num_rows)
    jdb, db = with_column(jdb, db, rel, "m", m)
    groups = [f"{r}.{a}" for r, a in q.group_by]

    def bundle(api, qcls):
        count, total, avg, lo, hi = api
        aggs = dict(n=count(), s=total(f"{rel}.m"), a=avg(f"{rel}.m"))
        if minmax:
            aggs.update(lo=lo(f"{rel}.m"), hi=hi(f"{rel}.m"))
        return qcls.over(*q.relations).group_by(*groups).agg(**aggs)

    engine = TorchChannelEngine(device="cpu", mode=mode)
    plan = bundle((Count, Sum, Avg, Min, Max), Q).engine(engine).plan(db)
    assert (plan.split is not None) is (not minmax)
    got = plan.execute()
    for engine in ("jax", "tensor"):
        want = bundle((JCount, JSum, JAvg, JMin, JMax), JQ).engine(engine).plan(jdb).execute()
        assert want.num_rows == got.num_rows > 0
        for g in plan.group_display:
            np.testing.assert_array_equal(got.column(g), want.column(g))
        np.testing.assert_array_equal(got.column("n"), want.column("n"))
        for c in ("s", "a"):
            np.testing.assert_allclose(got.column(c), want.column(c), rtol=FRACTIONAL_RTOL)
        for c in ("lo", "hi") if minmax else ():
            np.testing.assert_array_equal(got.column(c), want.column(c))


def test_minmax_past_the_exact_rank_limit_walks_the_payloads(monkeypatch):
    """With more distinct payloads than ranks float32 holds exactly (the
    limit lowered to 4 here), MIN/MAX walk the payloads themselves in
    float32; integer measures still equal the reference bit for bit."""
    monkeypatch.setattr(torch_engine, "_MAX_EXACT_RANKS", 4)
    jdb, jq, db, q = catalog("C1", 1000)
    jdb, db = with_column(
        jdb, db, "R3", "m", np.random.default_rng(2).integers(0, 50, 1000)
    )
    groups = [f"{r}.{a}" for r, a in q.group_by]
    got = (
        Q.over(*q.relations).group_by(*groups)
        .agg(n=Count(), lo=Min("R3.m"), hi=Max("R3.m")).engine(CPU).execute(db)
    )
    want = (
        JQ.over(*jq.relations).group_by(*groups)
        .agg(n=JCount(), lo=JMin("R3.m"), hi=JMax("R3.m")).engine("tensor")
        .plan(jdb).execute()
    )
    assert got.num_rows > 0
    assert_identical(want, got)


def test_minmax_over_an_empty_join_returns_no_rows():
    """A ``where`` that empties the middle relation: the port returns 0
    rows with the group columns' and aggregates' dtypes (the JAX
    package's engines raise here, so the port is checked alone)."""
    rng = np.random.default_rng(3)
    cols = {
        "R": {"g1": rng.integers(0, 5, 100), "j": rng.integers(0, 9, 100)},
        "S": {"j": rng.integers(0, 9, 100), "k": rng.integers(0, 9, 100),
              "m": rng.integers(0, 9, 100)},
        "T": {"k": rng.integers(0, 9, 100), "g2": rng.integers(0, 5, 100)},
    }
    res = (
        Q.over("R", "S", "T").where("S", "m", ">", 100).group_by("R.g1", "T.g2")
        .agg(n=Count(), s=Sum("S.m"), lo=Min("S.m"), hi=Max("S.m"))
        .engine(CPU).execute(cols)
    )
    assert res.num_rows == 0
    assert res.column("g1").dtype == cols["R"]["g1"].dtype
    assert res.column("g2").dtype == cols["T"]["g2"].dtype
    for c in ("n", "s", "lo", "hi"):
        assert res.column(c).dtype == np.float64 and res.column(c).shape == (0,)


# ---------------------------------------------------------------- host accessors


@pytest.mark.parametrize("name", CATALOG)
def test_relation_rows_project_and_from_rows(name):
    """``Relation.rows``/``.project``/``.from_rows`` on every relation of
    a catalog database, against the reference's ``Relation``."""
    jdb, _, db, _ = catalog(name, 500)
    for rel in jdb.relations:
        want, got = jdb[rel], db[rel]
        np.testing.assert_array_equal(got.rows(), want.rows())
        attrs = tuple(reversed(want.attrs))[:2]
        wp, gp = want.project(attrs), got.project(attrs)
        assert gp.attrs == wp.attrs == attrs and gp.num_rows == wp.num_rows
        np.testing.assert_array_equal(gp.rows(), wp.rows())
        back = type(got).from_rows(rel, got.attrs, got.rows())
        wback = type(want).from_rows(rel, want.attrs, want.rows())
        assert back.attrs == wback.attrs
        for a in want.attrs:
            np.testing.assert_array_equal(back.columns[a], wback.columns[a])
    rel = next(iter(jdb.relations))
    for table in (jdb[rel], db[rel]):
        with pytest.raises(KeyError, match="has no attrs"):
            table.project(("nope",))
        with pytest.raises(ValueError, match=r"rows shape"):
            type(table).from_rows(rel, ("a", "b", "c"), np.zeros((4, 2)))


@pytest.mark.parametrize("name", CATALOG)
def test_statistics_accessors_equal_the_reference(name):
    """``Statistics.attr_distinct``, ``DistinctSketch.error_bound``/
    ``.state`` and ``HeavyHitterSketch.estimate``/``.share``/``.top`` on
    every sketched column of a catalog query (post-fold), and each
    attribute's ``EncodedRelation.domain_sizes`` and ``Prepared.domain``."""
    jdb, jq, db, q = catalog(name, 3000)
    jplan = JQ.from_query(jq).engine("jax").plan(jdb)
    plan = Q.from_query(q).engine(CPU).plan(db)
    want, got = jplan.stats, plan.stats
    attrs = sorted({a for rs in want.relations.values() for a in rs.cols})
    for attr in attrs + ["absent"]:
        assert got.attr_distinct(attr, 77) == want.attr_distinct(attr, 77), attr
    for rel, wr in want.relations.items():
        for attr, wc in wr.cols.items():
            gc = got.relations[rel].cols[attr]
            assert gc.distinct.state() == wc.distinct.state(), (rel, attr)
            assert gc.distinct.error_bound() == wc.distinct.error_bound()
            keys = list(wc.heavy.counts)[:8] + [-1, 10**9]
            for key in keys:
                assert gc.heavy.estimate(key) == wc.heavy.estimate(key), (rel, attr, key)
                assert gc.heavy.share(key) == wc.heavy.share(key), (rel, attr, key)
            for j in (0, 1, 5, 100):
                assert gc.heavy.top(j) == wc.heavy.top(j), (rel, attr, j)
    prep, jprep = plan.prep, jplan.prep
    for rel, wer in jprep.encoded.items():
        assert prep.encoded[rel].domain_sizes(prep.dicts) == wer.domain_sizes(jprep.dicts)
    for attr in jprep.dicts:
        assert prep.domain(attr) == jprep.domain(attr), attr


def test_qerror_equals_the_reference():
    """``planner.qerror`` on a grid that crosses its floor of 1 and on
    the cost model's estimate against each node's measured cardinality."""
    grid = [0.0, 0.5, 1.0, 2.0, 3.5, 1e6]
    for est in grid:
        for act in grid:
            assert planner.qerror(est, act) == j_qerror(est, act)
    jdb, jq, db, q = catalog("C1", 2000)
    jplan = JQ.from_query(jq).engine("jax").plan(jdb)
    plan = Q.from_query(q).engine(CPU).plan(db)
    jest, jact = j_node_cards(jplan.prep, jplan.stats), j_actual_cards(jplan.prep)
    est, act = node_card_estimates(plan.prep, plan.stats), actual_node_cards(plan.prep, "cpu")
    assert act == jact
    assert {n: planner.qerror(est[n], act[n]) for n in act} == {
        n: j_qerror(jest[n], jact[n]) for n in jact}
    assert "qerror" in planner.__all__
