"""The port's brute-force oracle (``repro_torch.relational.oracle``)
against the JAX package's ``repro.relational.oracle``, on the same
numpy inputs made from a seed, with ``device="cpu"``.

Answers must be equal dicts — the same group keys as Python ints, the
same values — except fractional SUM/AVG, which hold within 1e-12
relative (summation order is the device's).  Joins are compared as
sorted multisets of rows, column names, order and dtypes included.
"""
import numpy as np
import pytest
import torch

from repro.aggregates.semiring import Avg as JAvg
from repro.aggregates.semiring import Count as JCount
from repro.aggregates.semiring import Max as JMax
from repro.aggregates.semiring import Min as JMin
from repro.aggregates.semiring import Sum as JSum
from repro.core.query import JoinAggQuery as JQuery
from repro.data import queries as jqueries
from repro.relational import oracle as joracle
from repro.relational.relation import Database as JDatabase
from repro_torch.aggregates.semiring import Avg, Count, Max, Min, Sum
from repro_torch.core.query import JoinAggQuery
from repro_torch.data import queries as port_queries
from repro_torch.relational import oracle
from repro_torch.relational.relation import Database

RTOL = 1e-12
KINDS = {"count": (JCount, Count), "sum": (JSum, Sum), "avg": (JAvg, Avg),
         "min": (JMin, Min), "max": (JMax, Max)}
ACYCLIC = {**jqueries.REAL, **jqueries.SKEWED}


def catalog(name: str, n: int, seed: int = 0):
    gen = {**ACYCLIC, **jqueries.CYCLIC}[name]
    jdb, jq = gen(n, seed=seed)
    db, q = getattr(port_queries, gen.__name__)(n, seed=seed)
    return jdb, jq, db, q


def agg_pair(kind: str, measure):
    jcls, cls = KINDS[kind]
    return (jcls(), cls()) if kind == "count" else (jcls(*measure), cls(*measure))


def assert_answers(want: dict, got: dict, fractional: bool = False) -> None:
    assert set(got) == set(want)
    for key in got:
        assert all(type(v) is int for v in key), key
    for key, w in want.items():
        g = got[key]
        if isinstance(w, dict):
            assert list(g) == list(w)
            for name in w:
                check_value(w[name], g[name], fractional and name in ("s", "a"))
        else:
            check_value(w, g, fractional)


def check_value(w: float, g: float, fractional: bool) -> None:
    assert type(g) is float
    if fractional:
        assert abs(g - w) <= RTOL * abs(w), (g, w)
    else:
        assert g == w


def sorted_rows(table: dict) -> tuple[list[str], list, np.ndarray]:
    cols = [np.asarray(c.numpy() if isinstance(c, torch.Tensor) else c) for c in table.values()]
    rows = np.stack(cols, axis=1) if cols and len(cols[0]) else np.zeros((0, len(cols)))
    order = np.lexsort(rows.T[::-1]) if len(rows) else np.arange(0)
    return list(table), [c.dtype for c in cols], rows[order]


def join_case(case: str):
    rng = np.random.default_rng({"one": 1, "two": 2, "empty_left": 3, "empty_right": 4,
                                 "wide": 5, "float": 6, "mixed": 7}[case])
    n1, n2 = (0, 40) if case == "empty_left" else (40, 0) if case == "empty_right" else (60, 50)
    t1 = {"g": rng.integers(0, 5, n1), "a": rng.integers(0, 6, n1), "b": rng.integers(0, 3, n1)}
    t2 = {"a": rng.integers(0, 6, n2), "b": rng.integers(0, 3, n2), "h": rng.integers(0, 9, n2)}
    on = ["a"] if case in ("one", "float") else ["a", "b"]
    if case == "wide":  # the key columns' ranges overflow one int64 key
        for t in (t1, t2):
            t["a"] = t["a"] * (1 << 40) - (1 << 42)
            t["b"] = t["b"] * (1 << 40)
    if case == "float":
        t1["a"] = t1["a"] / 4.0
        t2["a"] = t2["a"] / 4.0
    if case == "mixed":
        t1["a"] = t1["a"].astype(np.int32)
    return t1, t2, on


@pytest.mark.parametrize(
    "case", ["one", "two", "empty_left", "empty_right", "wide", "float", "mixed"]
)
def test_natural_join_matches_reference(case):
    t1, t2, on = join_case(case)
    want = joracle.natural_join(t1, t2, on)
    got = oracle.natural_join(t1, t2, on, device="cpu")
    assert all(c.device.type == "cpu" for c in got.values())
    wn, wd, wr = sorted_rows(want)
    gn, gd, gr = sorted_rows(got)
    assert (gn, gd) == (wn, wd)
    np.testing.assert_array_equal(gr, wr)
    if case not in ("empty_left", "empty_right"):
        assert len(gr) > len(t1["g"])  # duplicate keys fan out


def test_natural_join_refuses_a_cross_product():
    t1, t2, _ = join_case("one")
    with pytest.raises(ValueError, match="cross product joins unsupported"):
        joracle.natural_join(t1, t2, [])
    with pytest.raises(ValueError, match="cross product joins unsupported"):
        oracle.natural_join(t1, t2, [], device="cpu")


@pytest.mark.parametrize("fractional", [False, True], ids=["integer", "fractional"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_groupby_aggregate_matches_reference(kind, fractional):
    rng = np.random.default_rng(11)
    n = 5000
    joined = {"g1": rng.integers(0, 7, n), "g2": rng.integers(-3, 4, n),
              "m": rng.integers(-50, 50, n)}
    if fractional:
        joined["m"] = rng.normal(size=n) * 1e3
    jagg, agg = agg_pair(kind, ("R", "m"))
    want = joracle.groupby_aggregate(joined, ["g1", "g2"], jagg, "m")
    got = oracle.groupby_aggregate(joined, ["g1", "g2"], agg, "m", device="cpu")
    assert_answers(want, got, fractional and kind in ("sum", "avg"))
    assert oracle.groupby_aggregate({}, ["g1"], agg, "m", device="cpu") == {}


def with_measure(jdb, db, rel: str, values):
    cols = {r: dict(jdb[r].columns) for r in jdb.relations}
    cols[rel]["m"] = values
    return JDatabase.from_mapping(cols), Database.from_mapping(cols)


CASES = [(name, 600) for name in ACYCLIC] + [(name, 300) for name in jqueries.CYCLIC]


@pytest.mark.parametrize("name,n", CASES, ids=[c[0] for c in CASES])
def test_oracle_joinagg_matches_reference(name, n):
    jdb, jq, db, q = catalog(name, n)
    lenient = name in jqueries.CYCLIC
    want = joracle.oracle_joinagg(jq, jdb, lenient=lenient)
    got = oracle.oracle_joinagg(q, db, lenient=lenient, device="cpu")
    assert want and got == want
    assert_answers(want, got)


@pytest.mark.parametrize("fractional", [False, True], ids=["integer", "fractional"])
@pytest.mark.parametrize("name,n", CASES, ids=[c[0] for c in CASES])
def test_oracle_multiagg_matches_reference(name, n, fractional):
    jdb, jq, db, q = catalog(name, n)
    rel = jq.relations[-1]
    rng = np.random.default_rng(5)
    rows = jdb[rel].num_rows
    values = rng.normal(size=rows) * 100 if fractional else rng.integers(0, 1000, rows)
    jdb, db = with_measure(jdb, db, rel, values)
    jaggs, aggs = {}, {}
    for name_, kind in zip(("n", "s", "a", "lo", "hi"), KINDS):
        jaggs[name_], aggs[name_] = agg_pair(kind, (rel, "m"))
    want = joracle.oracle_multiagg(jq.relations, jq.group_by, jaggs, jdb)
    got = oracle.oracle_multiagg(q.relations, q.group_by, aggs, db, device="cpu")
    assert want
    assert_answers(want, got, fractional)


def test_oracle_raises_as_the_reference_does():
    jdb, jq, db, q = catalog("FOFGROUP", 200)
    for fn, args in ((joracle.oracle_joinagg, (jq, jdb)),
                     (oracle.oracle_joinagg, (q, db))):
        with pytest.raises(ValueError, match=r"group attr G1\.grp participates in a join"):
            fn(*args, **({} if fn is joracle.oracle_joinagg else {"device": "cpu"}))
    rng = np.random.default_rng(0)
    cols = {"R1": {"g1": rng.integers(0, 3, 20), "a": rng.integers(0, 3, 20)},
            "R2": {"a": rng.integers(0, 3, 20), "g2": rng.integers(0, 3, 20)},
            "R3": {"g3": rng.integers(0, 3, 20), "c": rng.integers(0, 3, 20)},
            "R4": {"c": rng.integers(0, 3, 20), "g4": rng.integers(0, 3, 20)}}
    rels = ("R1", "R2", "R3", "R4")
    with pytest.raises(ValueError, match="disconnected join graph"):
        joracle.materialize_relations(rels, JDatabase.from_mapping(cols))
    with pytest.raises(ValueError, match="disconnected join graph"):
        oracle.materialize_relations(rels, Database.from_mapping(cols), device="cpu")


def test_oracle_runs_on_the_cpu_only_when_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, db, q = catalog("DBLP", 100)
    with pytest.raises(RuntimeError, match=r'no CUDA device.*device="cpu"'):
        oracle.oracle_joinagg(q, db)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        oracle.oracle_multiagg(q.relations, q.group_by, {"n": Count()}, db)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        oracle.natural_join({"a": np.arange(3)}, {"a": np.arange(3)}, ["a"])
    assert oracle.oracle_joinagg(q, db, device="cpu")
    q2 = JoinAggQuery(q.relations, q.group_by, Count())
    assert oracle.oracle_joinagg(q2, db, device="cpu") == oracle.oracle_joinagg(
        q, db, device="cpu")
