"""The port's GHD compiler against the JAX package's, on the same numpy
inputs.

For the cyclic catalog (TRIANGLE, FOURCYCLE and FOFGROUP of
``data/queries.py``) the port must build the reference's decomposition
(bags, attributes, order, relation cover), materialize the same bag
tables on the host, fold them to the same root, and answer a
COUNT/SUM/AVG/MIN/MAX bundle over an integer measure bit for bit as
``engine("jax")`` (CPU auto mode, its plain kernels) and
``engine("tensor")`` do, unfused and fused, with statistics on and off.
"""
import numpy as np
import pytest

from repro.api import Avg as JAvg
from repro.api import Count as JCount
from repro.api import Max as JMax
from repro.api import Min as JMin
from repro.api import Q as JQ
from repro.api import Sum as JSum
from repro.core.jax_engine import MAX_DENSE_ELEMS as JAX_MAX_DENSE_ELEMS
from repro.ghd import bags as jbags
from repro.ghd.rewrite import compile_ghd as j_compile_ghd
from repro.ghd.rewrite import is_cyclic_query as j_is_cyclic_query
from repro_torch.api import (
    Avg,
    Count,
    Max,
    Min,
    Q,
    Sum,
    TorchChannelEngine,
    UnsupportedPlanOption,
)
from repro_torch.core.query import resolve_schema
from repro_torch.ghd import bags, compile_ghd, is_cyclic_query, verify_ghd
from test_torch_planner import CATALOG, assert_identical, catalog, with_column

CPU = TorchChannelEngine(device="cpu")
CYCLIC = ("TRIANGLE", "FOURCYCLE", "FOFGROUP")
# (measure relation, rows per relation, measure values in [0, high)):
# sized so that every group's SUM stays below 2**24, where float32 sums
# are exact, the precondition of bit-identity (DESIGN.md §2); the test
# asserts it
MEASURED = {
    "TRIANGLE": ("E1", 2000, 20),
    "FOURCYCLE": ("E3", 2000, 8),
    "FOFGROUP": ("F2", 1000, 4),
}


def test_max_dense_elems_matches_the_reference():
    assert bags.MAX_DENSE_ELEMS == JAX_MAX_DENSE_ELEMS == jbags.MAX_DENSE_ELEMS


@pytest.mark.parametrize("name", CATALOG)
def test_cyclic_detection_matches_the_reference(name):
    jdb, jq, db, q = catalog(name, 1000)
    assert is_cyclic_query(q, db) == j_is_cyclic_query(jq, jdb)
    assert is_cyclic_query(q, db) == (name in CYCLIC)


@pytest.mark.parametrize("stats", [True, False])
@pytest.mark.parametrize("name", CYCLIC)
def test_ghd_and_bags_match_the_reference(name, stats):
    """Bags (attributes, parent, assigned relations), order, cover,
    estimates; the materialized bag tables and their peak bytes; the
    column copies, measure bags and the folded derived plan."""
    jdb, jq, db, q = catalog(name, 4000)
    jplan = JQ.from_query(jq).engine("jax").stats(stats).plan(jdb)
    plan = Q.from_query(q).engine(CPU).stats(stats).plan(db)
    want, got = jplan.ghd_plan, plan.ghd_plan
    assert plan.cyclic and got is not None
    a, b = want.ghd, got.ghd
    assert (b.root, b.order, b.cover_of) == (a.root, a.order, a.cover_of)
    assert (b.est_elems, b.width) == (a.est_elems, a.width)
    for bag in a.order:
        assert (b.bags[bag].attrs, b.bags[bag].parent, b.bags[bag].relations) == (
            a.bags[bag].attrs, a.bags[bag].parent, a.bags[bag].relations
        )
    schema = resolve_schema(q, db, allow_group_join_attrs=True)
    verify_ghd(b, {r: frozenset(attrs) for r, attrs in schema.relevant.items()})
    assert list(got.bag_tables) == list(want.bag_tables)
    for bag, wt in want.bag_tables.items():
        gt = got.bag_tables[bag]
        assert gt.attrs == wt.attrs and gt.peak_bytes == wt.peak_bytes
        np.testing.assert_array_equal(gt.codes, wt.codes)
        np.testing.assert_array_equal(gt.count, wt.count)
    assert got.bag_peak_bytes == want.bag_peak_bytes
    assert got.copied_attrs == want.copied_attrs
    assert got.measure_bags == want.measure_bags
    dq, jdq = got.derived_query, want.derived_query
    assert (dq.relations, dq.group_by) == (jdq.relations, jdq.group_by)
    assert plan.prep.folded == jplan.prep.folded
    assert plan.prep.fold_hosts == jplan.prep.fold_hosts
    assert list(plan.prep.decomposition.nodes) == list(jplan.prep.decomposition.nodes)
    assert plan.est_peak == jplan.est_peak
    assert set(got.seconds) == {"encode", "build_ghd", "bags", "finish_prepare"}


def _bundle(qcls, api, q, rel):
    count, total, avg, lo, hi = api
    m = f"{rel}.m"
    return qcls.over(*q.relations).group_by(
        *(f"{r}.{a}" for r, a in q.group_by)
    ).agg(n=count(), s=total(m), a=avg(m), lo=lo(m), hi=hi(m))


@pytest.mark.parametrize("stats", [True, False])
@pytest.mark.parametrize("fused", [None, True])
@pytest.mark.parametrize("name", CYCLIC)
def test_cyclic_bundle_bit_identical(name, fused, stats):
    rel, n, high = MEASURED[name]
    jdb, jq, db, q = catalog(name, n)
    m = np.random.default_rng(11).integers(0, high, jdb[rel].num_rows)
    jdb, db = with_column(jdb, db, rel, "m", m)
    pq = _bundle(Q, (Count, Sum, Avg, Min, Max), q, rel).stats(stats)
    if fused is not None:
        pq = pq.fused(fused)
    plan = pq.engine(CPU).plan(db)
    assert plan.cyclic and plan.split is None
    got = plan.execute()
    assert got.num_rows > 0 and got.column("s").max() < 2**24
    for engine in ("jax", "tensor"):
        want = (
            _bundle(JQ, (JCount, JSum, JAvg, JMin, JMax), jq, rel)
            .stats(stats).engine(engine).plan(jdb).execute()
        )
        assert_identical(want, got)


def test_two_measure_relations_in_one_bag_raise():
    """TRIANGLE puts E1, E2 and E3 in one bag: measuring two of them
    cannot share the bag's payload key space, in either package."""
    jdb, jq, db, q = catalog("TRIANGLE", 800)
    rng = np.random.default_rng(1)
    jdb, db = with_column(jdb, db, "E1", "m", rng.integers(0, 9, 800))
    jdb, db = with_column(jdb, db, "E2", "m2", rng.integers(0, 9, 800))
    spec = dict(a=("E1", "m"), b=("E2", "m2"))
    with pytest.raises(UnsupportedPlanOption, match="same GHD bag"):
        Q.over(*q.relations).group_by("L.vlabel").agg(
            **{k: Sum(*v) for k, v in spec.items()}
        ).engine(CPU).plan(db)
    with pytest.raises(ValueError, match="same GHD bag"):
        JQ.over(*jq.relations).group_by("L.vlabel").agg(
            **{k: JSum(*v) for k, v in spec.items()}
        ).engine("tensor").plan(jdb)


def test_bag_cap_raises_memory_error():
    jdb, jq, db, q = catalog("TRIANGLE", 800)
    with pytest.raises(MemoryError, match="MAX_DENSE_ELEMS"):
        compile_ghd(q, db, cap_rows=4)
    with pytest.raises(MemoryError, match="MAX_DENSE_ELEMS"):
        j_compile_ghd(jq, jdb, cap_rows=4)
    assert compile_ghd(q, db).bag_peak_bytes == j_compile_ghd(jq, jdb).bag_peak_bytes
