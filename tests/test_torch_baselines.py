"""The port's baselines (``repro_torch.baselines``) against the JAX
package's ``repro.baselines``, on the same numpy inputs made from a
seed, with ``device="cpu"``.

Both the answers and ``BaselineStats`` must be equal: the largest
intermediate's rows and bytes and every intermediate's row count, the
bytes summed over the same columns at the same dtypes (``preagg``'s
float64 ``__w`` included).  The catalog's measures and weights are
integers, so the answers are exact.
"""
import numpy as np
import pytest
import torch

from repro.aggregates.semiring import Sum as JSum
from repro.baselines import binary_join_agg as j_binary
from repro.baselines import preagg_join_agg as j_preagg
from repro.core.query import JoinAggQuery as JQuery
from repro.data import queries as jqueries
from repro.data import synth as jsynth
from repro.relational.relation import Database as JDatabase
from repro_torch.aggregates.semiring import Sum
from repro_torch.baselines import binary_join_agg, preagg_join_agg
from repro_torch.baselines.binary_join import BaselineStats
from repro_torch.core.query import JoinAggQuery
from repro_torch.data import queries as port_queries
from repro_torch.data import synth as port_synth
from repro_torch.relational.relation import Database

BASELINES = {"binary": (j_binary, binary_join_agg), "preagg": (j_preagg, preagg_join_agg)}


def catalog(name: str, n: int, seed: int = 0):
    if name in jsynth.ALL:
        jdb, jq = jsynth.make(name, n, seed=seed)
        db, q = port_synth.make(name, n, seed=seed)
        return jdb, jq, db, q
    gen = {**jqueries.REAL, **jqueries.SKEWED, **jqueries.CYCLIC}[name]
    jdb, jq = gen(n, seed=seed)
    db, q = getattr(port_queries, gen.__name__)(n, seed=seed)
    return jdb, jq, db, q


def assert_same(want, got) -> None:
    (wres, wstats), (res, stats) = want, got
    assert wres and res == wres
    for key, v in res.items():
        assert all(type(x) is int for x in key) and type(v) is float
    assert isinstance(stats, BaselineStats)
    assert vars(stats) == vars(wstats)
    assert stats.max_intermediate_rows == max(stats.intermediates)


CASES = [(name, 400) for name in jsynth.ALL] + [(name, 600) for name in jqueries.REAL]


@pytest.mark.parametrize("method", list(BASELINES))
@pytest.mark.parametrize("name,n", CASES, ids=[c[0] for c in CASES])
def test_baseline_matches_reference(name, n, method):
    jdb, jq, db, q = catalog(name, n)
    ref, port = BASELINES[method]
    assert_same(ref(jq, jdb), port(q, db, device="cpu"))


@pytest.mark.parametrize("method", list(BASELINES))
def test_baseline_counts_bytes_at_the_columns_dtypes(method):
    """int32 columns count 4 bytes a value, as numpy's ``nbytes`` does."""
    jdb, jq, _, q = catalog("S2", 400)
    cols = {r: {a: c.astype(np.int32) for a, c in jdb[r].columns.items()}
            for r in jdb.relations}
    ref, port = BASELINES[method]
    want = ref(jq, JDatabase.from_mapping(cols))
    got = port(q, Database.from_mapping(cols), device="cpu")
    assert_same(want, got)
    wide = ref(jq, jdb)[1]
    assert got[1].max_intermediate_bytes < wide.max_intermediate_bytes


@pytest.mark.parametrize("name", ["TRIANGLE", "FOURCYCLE"])
def test_binary_join_agg_on_cyclic_queries(name):
    jdb, jq, db, q = catalog(name, 300)
    assert_same(j_binary(jq, jdb), binary_join_agg(q, db, device="cpu"))


def test_binary_join_agg_refuses_a_joining_group_attr():
    jdb, jq, db, q = catalog("FOFGROUP", 300)
    match = r"group attr G1\.grp participates in a join"
    with pytest.raises(ValueError, match=match) as want:
        j_binary(jq, jdb)
    with pytest.raises(ValueError, match=match) as got:
        binary_join_agg(q, db, device="cpu")
    assert str(got.value) == str(want.value).replace("repro.api", "repro_torch.api")


def test_preagg_implements_count_only():
    jdb, jq, db, q = catalog("S1", 200)
    with pytest.raises(NotImplementedError, match="implements COUNT"):
        j_preagg(JQuery(jq.relations, jq.group_by, JSum("R1", "p")), jdb)
    with pytest.raises(NotImplementedError, match="implements COUNT"):
        preagg_join_agg(JoinAggQuery(q.relations, q.group_by, Sum("R1", "p")), db,
                        device="cpu")


def test_sum_over_a_measure_matches_reference():
    jdb, jq, db, q = catalog("C1", 400)
    want = j_binary(JQuery(jq.relations, jq.group_by, JSum("R2", "p1")), jdb)
    got = binary_join_agg(JoinAggQuery(q.relations, q.group_by, Sum("R2", "p1")), db,
                          device="cpu")
    assert_same(want, got)


@pytest.mark.parametrize("method", list(BASELINES))
def test_disconnected_join_graph(method):
    rng = np.random.default_rng(0)
    cols = {"R1": {"g1": rng.integers(0, 3, 20), "a": rng.integers(0, 3, 20)},
            "R2": {"a": rng.integers(0, 3, 20), "g2": rng.integers(0, 3, 20)},
            "R3": {"g3": rng.integers(0, 3, 20), "c": rng.integers(0, 3, 20)},
            "R4": {"c": rng.integers(0, 3, 20), "g4": rng.integers(0, 3, 20)}}
    rels = ("R1", "R2", "R3", "R4")
    groups = (("R1", "g1"), ("R2", "g2"), ("R3", "g3"), ("R4", "g4"))
    ref, port = BASELINES[method]
    with pytest.raises(ValueError, match="disconnected join graph"):
        ref(JQuery(rels, groups), JDatabase.from_mapping(cols))
    with pytest.raises(ValueError, match="disconnected join graph"):
        port(JoinAggQuery(rels, groups), Database.from_mapping(cols), device="cpu")


@pytest.mark.parametrize("method", list(BASELINES))
def test_baselines_run_on_the_cpu_only_when_asked(monkeypatch, method):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, db, q = catalog("S3", 200)
    port = BASELINES[method][1]
    with pytest.raises(RuntimeError, match=rf'{port.__name__} runs on CUDA.*device="cpu"'):
        port(q, db)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port(q, db, device="cuda")
    res, stats = port(q, db, device="cpu")
    assert res and stats.max_intermediate_rows > 0
