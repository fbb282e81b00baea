"""The port's incremental maintenance against the JAX package's, on the
same numpy inputs through the same batch sequences.

``repro_torch.incremental.MaintainedJoinAgg(device="cpu")`` is held
against ``repro.incremental.MaintainedJoinAgg(engine="tensor")`` — the
reference's ``engine="jax"`` calls the Pallas kernels with no plain
fallback, which the installed JAX cannot lower — after every batch:
results exact on integer data and within 1e-4 relative on fractional
SUM/AVG (the tolerance the reference's property test gives its float32
engine), and the ``RefreshStats`` counters equal.  Each case of
``tests/test_incremental.py`` that has a counterpart is here with its
seeds and assertions; the port's results are also held bit for bit
against a from-scratch execute of the port on the mutated database.
Three tests are the port's own: a spy on ``segment_sum``/``coo_spmm``
during refreshes (ascending segment ids, the reference's routing), and
interleaved R2/R3/R2 batches and a domain that grows under an unchanged
relation's view, which a stale device view would get wrong.
"""
from collections import Counter

import numpy as np
import pytest
import torch

from repro.aggregates.semiring import Avg as JAvg
from repro.aggregates.semiring import Count as JCount
from repro.aggregates.semiring import Max as JMax
from repro.aggregates.semiring import Min as JMin
from repro.aggregates.semiring import Sum as JSum
from repro.core.query import JoinAggQuery as JQuery
from repro.data import synth as jsynth
from repro.incremental import MaintainedJoinAgg as JMaintained
from repro.relational.encoding import GrowableDictionary as JGrowable
from repro.relational.relation import Database as JDatabase
from repro_torch.aggregates.semiring import Avg, Count, Max, Min, Sum
from repro_torch.api import Q, TorchChannelEngine
from repro_torch.core import torch_engine
from repro_torch.core.operator import maintain
from repro_torch.core.query import JoinAggQuery
from repro_torch.data import synth
from repro_torch.incremental import KernelDeltaEngine, MaintainedJoinAgg
from repro_torch.relational.encoding import GrowableDictionary
from repro_torch.relational.relation import Database

CPU = TorchChannelEngine(device="cpu")
AGGS = {"count": (Count, JCount), "sum": (Sum, JSum), "avg": (Avg, JAvg),
        "min": (Min, JMin), "max": (Max, JMax)}
STATS = ("refreshes", "delta_rows", "rows_rescanned", "fallback_recomputes",
         "dirty_bags", "clean_bags_reused")
STAR = (("R1", "R2", "R3"), (("R1", "g1"), ("R3", "g2")))
RNG = np.random.default_rng(0)


def star_cols(n=300, gdom=5, jdom=6, bdom=4, measure=False, rng=RNG):
    cols = {
        "R1": {"g1": rng.integers(0, gdom, n), "j": rng.integers(0, jdom, n)},
        "R2": {"j": rng.integers(0, jdom, n), "b": rng.integers(0, bdom, n)},
        "R3": {"b": rng.integers(0, bdom, n), "g2": rng.integers(0, gdom, n)},
    }
    if measure:
        cols["R2"]["m"] = rng.integers(1, 40, n).astype(np.float64)
    return cols


def with_rows(cols, rel, batch):
    out = {r: dict(cs) for r, cs in cols.items()}
    out[rel] = {a: np.concatenate([c, np.asarray(batch[a])]) for a, c in cols[rel].items()}
    return out


def without_rows(cols, rel, batch):
    """``cols`` with one occurrence of every row of ``batch`` removed from
    ``rel`` (the batch's rows are present)."""
    attrs = list(cols[rel])
    want = Counter(zip(*(np.asarray(batch[a]).tolist() for a in attrs)))
    keep = np.ones(len(cols[rel][attrs[0]]), dtype=bool)
    for i, row in enumerate(zip(*(cols[rel][a].tolist() for a in attrs))):
        if want.get(row, 0) > 0:
            want[row] -= 1
            keep[i] = False
    assert not +want, "deleted rows that are not present"
    out = {r: dict(cs) for r, cs in cols.items()}
    out[rel] = {a: c[keep] for a, c in cols[rel].items()}
    return out


def assert_close(got, want, tol=0.0):
    assert set(got) == set(want), (len(got), len(want))
    for k, v in want.items():
        assert abs(got[k] - v) <= tol * max(1.0, abs(v)), (k, got[k], v)


class Twin:
    """The port's handle on the CPU and the reference's ``engine="tensor"``
    handle over the same columns, driven through the same batches and
    compared after each; ``cols`` follows the database they maintain."""

    def __init__(self, cols, relations=STAR[0], group_by=STAR[1], kind="count",
                 measure=None, tol=0.0):
        port_agg, ref_agg = AGGS[kind]
        args = () if measure is None else measure
        self.query = JoinAggQuery(relations, group_by, port_agg(*args))
        self.port = MaintainedJoinAgg(self.query, Database.from_mapping(cols), device="cpu")
        self.ref = JMaintained(
            JQuery(relations, group_by, ref_agg(*args)), JDatabase.from_mapping(cols),
            engine="tensor",
        )
        self.cols, self.tol = cols, tol
        self.check()

    def insert(self, rel, batch):
        self.port.insert(rel, batch)
        self.ref.insert(rel, batch)
        self.cols = with_rows(self.cols, rel, batch)
        self.check()

    def delete(self, rel, batch):
        self.port.delete(rel, batch)
        self.ref.delete(rel, batch)
        self.cols = without_rows(self.cols, rel, batch)
        self.check()

    def rejects(self, op, rel, batch, errors=ValueError):
        with pytest.raises(errors):
            getattr(self.ref, op)(rel, batch)
        with pytest.raises(errors):
            getattr(self.port, op)(rel, batch)
        self.check()

    def check(self):
        got = self.port.result()
        assert_close(got, self.ref.result(), self.tol)
        for name in STATS:
            assert getattr(self.port.stats, name) == getattr(self.ref.stats, name), name
        if self.tol == 0.0:  # integer data: the port's fresh answer, bit for bit
            scratch = Q.from_query(self.query).engine(CPU).plan(self.cols).execute()
            assert got == scratch.to_dict()


def test_growable_dictionary_appends_codes():
    for cls in (GrowableDictionary, JGrowable):
        d = cls("a", np.array([3, 7, 9]))
        np.testing.assert_array_equal(d.encode(np.array([9, 3])), [2, 0])
        codes = d.encode(np.array([5, 9, 5, 100]), grow=True)
        # old codes unchanged, new values appended in sorted order of novelty
        np.testing.assert_array_equal(d.encode(np.array([3, 7, 9])), [0, 1, 2])
        assert d.size == 5
        np.testing.assert_array_equal(d.decode(codes), [5, 9, 5, 100])
        with pytest.raises(ValueError):
            d.encode(np.array([42]))


def test_count_insert_delete_matches_scratch():
    t = Twin(star_cols())
    extra = {"j": np.array([0, 1, 1, 2]), "b": np.array([3, 0, 2, 1])}
    t.insert("R2", extra)
    t.delete("R2", extra)


def test_domain_growth_new_codes():
    """Inserts carrying never-seen attribute values must grow the shared
    dictionaries in place and zero-pad every cached message."""
    t = Twin(star_cols())
    t.insert("R2", {"j": np.array([99, 99]), "b": np.array([0, 77])})  # new j, b
    t.insert("R3", {"b": np.array([77]), "g2": np.array([55])})  # new group value
    assert t.port.dicts["g2"].size == t.ref.dicts["g2"].size == 6
    t.insert("R1", {"g1": np.array([66]), "j": np.array([99])})  # root grows too


def test_multi_relation_batches_and_root_delta():
    t = Twin(star_cols())
    for rel, extra in [
        ("R1", {"g1": np.array([0, 4]), "j": np.array([2, 2])}),
        ("R3", {"b": np.array([1]), "g2": np.array([3])}),
        ("R2", {"j": np.array([2]), "b": np.array([1])}),
    ]:
        t.insert(rel, extra)


def test_over_delete_raises():
    t = Twin(star_cols())
    t.rejects("delete", "R2", {"j": np.array([999]), "b": np.array([999])})


def test_rejected_delete_leaves_state_consistent():
    """A batch mixing one present and one absent tuple must be rejected
    atomically: later refreshes stay equal to from-scratch recompute."""
    cols = star_cols()
    t = Twin(cols)
    present = {a: cols["R2"][a][:1] for a in ("j", "b")}
    mixed = {a: np.concatenate([present[a], np.array([999])]) for a in ("j", "b")}
    t.rejects("delete", "R2", mixed)
    t.insert("R2", {"j": np.array([0, 1]), "b": np.array([1, 2])})


def test_minmax_delete_missing_measure_column_is_atomic():
    cols = star_cols(measure=True)
    t = Twin(cols, kind="min", measure=("R2", "m"))
    t.rejects("delete", "R2", {a: cols["R2"][a][:2] for a in ("j", "b")},
              (ValueError, KeyError))  # no "m"


@pytest.mark.parametrize("kind", ["sum", "avg", "min", "max"])
def test_measured_aggregates(kind):
    cols = star_cols(measure=True)
    t = Twin(cols, kind=kind, measure=("R2", "m"))
    extra = {
        "j": np.array([0, 1, 2]), "b": np.array([2, 3, 0]),
        "m": np.array([5.0, 90.0, 1.0]),
    }
    t.insert("R2", extra)
    # delete original tuples: exercises the MIN/MAX non-invertible fallback
    t.delete("R2", extra)
    t.delete("R2", {a: cols["R2"][a][:7] for a in ("j", "b", "m")})
    if kind in ("min", "max"):
        assert t.port.stats.fallback_recomputes > 0


@pytest.mark.parametrize("kind", ["sum", "avg"])
def test_fractional_measures_within_float32_tolerance(kind):
    rng = np.random.default_rng(5)
    cols = star_cols(measure=True, rng=rng)
    cols["R2"]["m"] = rng.random(300) * 50.0
    t = Twin(cols, kind=kind, measure=("R2", "m"), tol=1e-4)
    t.insert("R2", {"j": np.array([0, 3]), "b": np.array([1, 1]),
                    "m": np.array([0.125, 17.3])})
    t.insert("R3", {"b": np.array([2, 0]), "g2": np.array([4, 1])})
    t.delete("R2", {a: cols["R2"][a][:5] for a in ("j", "b", "m")})


def test_fold_mode_fallback():
    """A delta on a relation consumed by the fold rewrite re-derives the
    fold from maintained encodings instead of delta-patching."""
    n = 150
    cols = {
        "R1": {"g1": RNG.integers(0, 5, n), "p": RNG.integers(0, 6, n)},
        "R2": {"p": RNG.integers(0, 6, n), "g2": RNG.integers(0, 5, n)},
        "R3": {"p": RNG.integers(0, 6, n // 3)},
    }
    t = Twin(cols, ("R1", "R2", "R3"), (("R1", "g1"), ("R2", "g2")))
    assert t.port.fold_mode and "R3" in t.port.prep.fold_hosts
    assert t.port._fold_affected == t.ref._fold_affected
    t.insert("R3", {"p": np.array([0, 0, 3])})
    assert t.port.stats.fallback_recomputes == 1
    # a delta on a fold-UNaffected relation must propagate, not refold
    for rel in ("R1", "R2"):
        if rel in t.port._fold_affected:
            continue
        t.insert(rel, {"g1": np.array([2]), "p": np.array([1])} if rel == "R1"
                 else {"p": np.array([1]), "g2": np.array([0])})
        assert t.port.stats.fallback_recomputes == 1  # unchanged: no refold


def triangle_cols(m=250, measure=False):
    rng = np.random.default_rng(3)
    cols = {
        "E1": {"x": rng.integers(0, 15, m), "y": rng.integers(0, 15, m)},
        "E2": {"y": rng.integers(0, 15, m), "z": rng.integers(0, 15, m)},
        "E3": {"z": rng.integers(0, 15, m), "x": rng.integers(0, 15, m),
               "g": rng.integers(0, 6, m)},
    }
    if measure:
        cols["E1"]["w"] = rng.integers(1, 9, m).astype(np.float64)
    return cols


@pytest.mark.parametrize("kind", ["count", "sum", "avg", "min", "max"])
def test_cyclic_dirty_bag_invalidation(kind):
    measured = kind != "count"
    cols = triangle_cols(measure=measured)
    t = Twin(cols, ("E1", "E2", "E3"), (("E3", "g"),), kind=kind,
             measure=("E1", "w") if measured else None)
    assert t.port.cyclic
    extra = {"x": np.array([3, 5]), "y": np.array([7, 2])}
    if measured:
        extra["w"] = np.array([4.0, 1.0])
    t.insert("E1", extra)
    assert t.port.stats.dirty_bags > 0 and t.port.stats.clean_bags_reused > 0
    t.delete("E1", extra)
    t.insert("E2", {"y": np.array([7, 40]), "z": np.array([1, 41])})  # grows y, z


def test_maintain_factory_and_stats():
    h = maintain(JoinAggQuery(*STAR), Database.from_mapping(star_cols()), engine=CPU)
    assert isinstance(h, MaintainedJoinAgg)
    h.insert("R2", {"j": np.array([0]), "b": np.array([0])})
    s = h.stats
    assert s.refreshes == 1 and s.delta_rows >= 1
    assert s.peak_delta_bytes > 0  # maintenance memory is accounted
    assert s.host_syncs > 0  # the dirty path's reads are counted
    assert h.result_relation().attrs == ("g1", "g2", "count")


def test_empty_batch_is_a_noop():
    cols = star_cols()
    t = Twin(cols)
    before = t.port.result()
    for rel in ("R1", "R2", "R3"):
        cur = {a: np.array([], dtype=np.int64) for a in cols[rel]}
        t.insert(rel, cur)
        t.delete(rel, cur)
    assert t.port.result() == before
    assert t.port.stats.delta_rows == 0


def test_rejected_delete_does_not_grow_domains():
    """A delete of absent tuples with never-seen values must not grow the
    shared dictionaries (rejected operations leave NO state behind)."""
    t = Twin(star_cols())
    sizes = {a: d.size for a, d in t.port.dicts.items()}
    t.rejects("delete", "R2", {"j": np.array([12345]), "b": np.array([54321])})
    assert {a: d.size for a, d in t.port.dicts.items()} == sizes


def test_refresh_work_is_delta_proportional():
    """A small delta rescans a tiny fraction of the data — as many rows
    as the reference rescans — and the refreshed result equals a fresh
    execute bit for bit."""
    n = 8000
    db, q = synth.make("B2", n)
    jdb, jq = jsynth.make("B2", n)
    h = MaintainedJoinAgg(q, db, device="cpu")
    jh = JMaintained(jq, jdb, engine="tensor")
    rng = np.random.default_rng(0)
    delta = {"j": rng.integers(0, 100, 50), "b": rng.integers(0, 100, 50)}
    h.insert("R2", delta)
    jh.insert("R2", delta)
    cols = with_rows({r: dict(db[r].columns) for r in db.relations}, "R2", delta)
    assert h.result() == Q.from_query(q).engine(CPU).plan(cols).execute().to_dict()
    assert h.result() == jh.result()
    assert h.stats.rows_rescanned == jh.stats.rows_rescanned < n // 4


def _batch(rng, rel, cols, k, gdom=4, jdom=5, bdom=4):
    """A batch of k tuples for ``rel``: fresh random tuples mixed with
    copies of current ones (so deletes have something to hit)."""
    cur = cols[rel]
    n = len(next(iter(cur.values())))
    reuse = rng.random(k) < 0.5 if n else np.zeros(k, dtype=bool)
    pick = rng.integers(0, max(n, 1), k)
    out = {}
    for a, c in cur.items():
        hi = {"g1": gdom, "g2": gdom, "j": jdom, "b": bdom}.get(a, 20)
        fresh = rng.integers(1, hi, k).astype(c.dtype)
        out[a] = np.where(reuse, c[pick] if n else fresh, fresh)
    return out


def _present(cols, rel, batch):
    """``batch`` restricted to rows currently present in ``rel``."""
    attrs = list(cols[rel])
    cur = Counter(zip(*(cols[rel][a].tolist() for a in attrs)))
    keep = []
    for i, row in enumerate(zip(*(np.asarray(batch[a]).tolist() for a in attrs))):
        if cur.get(row, 0) > 0:
            cur[row] -= 1
            keep.append(i)
    return {a: np.asarray(batch[a])[keep] for a in attrs} if keep else None


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("kind", ["count", "sum", "avg", "min", "max"])
def test_interleaved_inserts_and_deletes(kind, seed):
    """Seeded interleavings of insert and delete batches over all three
    relations (the reference's property-test generator, fixed seeds)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(10, 60))
    cols = star_cols(n, 4, 5, 4, rng=rng)
    cols["R2"]["m"] = rng.integers(1, 20, n).astype(np.float64)
    t = Twin(cols, kind=kind, measure=None if kind == "count" else ("R2", "m"))
    for _ in range(6):
        rel = ("R1", "R2", "R3")[int(rng.integers(0, 3))]
        batch = _batch(rng, rel, t.cols, int(rng.integers(1, 7)))
        if rng.random() < 0.5:
            t.insert(rel, batch)
        elif (present := _present(t.cols, rel, batch)) is not None:
            t.delete(rel, present)


@pytest.mark.parametrize("kind", ["count", "sum"])
def test_interleaved_relations_refresh_from_current_views(kind):
    """Batches into R2, R3, then R2 again: each rescan must read its
    parent's rows as they are now.  The port memoizes every relation's
    device view, weights included; without dropping the changed
    relation's memos after a batch, the R3 batch's rescan of R2 would
    miss R2's new rows."""
    cols = star_cols(measure=True)
    t = Twin(cols, kind=kind, measure=("R2", "m") if kind == "sum" else None)
    views = t.port.prep.device_views
    assert any(k[1] == "R2" for k in views)  # built by the full pass
    t.insert("R2", {"j": np.array([0, 2, 2]), "b": np.array([1, 1, 3]),
                    "m": np.array([3.0, 4.0, 5.0])})
    assert not any(k[1] == "R2" for k in views if k[0] != "dense")
    t.insert("R3", {"b": np.array([1, 3]), "g2": np.array([2, 2])})
    t.insert("R2", {"j": np.array([0, 5]), "b": np.array([3, 3]),
                    "m": np.array([7.0, 1.0])})
    t.delete("R2", {"j": np.array([0]), "b": np.array([1]), "m": np.array([3.0])})


def test_delta_hops_run_the_kernels_in_grouped_csr_order(monkeypatch):
    """Every delta hop runs on ``coo_spmm`` (one child) or ``segment_sum``
    (zero or several), the routing of ``jax_delta.py``, with ascending
    segment ids — the kernels' unchecked precondition, which their plain
    versions do not need, so only a spy can see it on the CPU."""
    db, q = synth.make("B2", 2000)
    h = MaintainedJoinAgg(q, db, device="cpu")
    launched: list[tuple[str, bool]] = []
    hops: list[tuple[str, int, list[str]]] = []

    def spy(name, ids_at):
        real = getattr(torch_engine, name)

        def wrapped(*args, **kwargs):
            ids = args[ids_at]
            launched.append((name, bool(torch.all(ids[1:] >= ids[:-1]))))
            return real(*args, **kwargs)

        monkeypatch.setattr(torch_engine, name, wrapped)

    spy("segment_sum", 1)
    spy("coo_spmm", 0)
    real_contract = KernelDeltaEngine.contract_rows

    def contract(self, rel, parent, view, weights, child_msgs):
        at = len(launched)
        out = real_contract(self, rel, parent, view, weights, child_msgs)
        kids = len(self.deco.nodes[rel].children)
        hops.append((rel, kids, [name for name, _ in launched[at:]]))
        return out

    monkeypatch.setattr(KernelDeltaEngine, "contract_rows", contract)
    rng = np.random.default_rng(7)
    for rel, cols in [
        ("R2", {"j": rng.integers(0, 200, 300), "b": rng.integers(0, 200, 300)}),
        ("R3", {"b": rng.integers(0, 200, 40), "g2": rng.integers(0, 16, 40)}),
        ("R1", {"g1": rng.integers(0, 16, 25), "j": rng.integers(0, 200, 25)}),
    ]:
        h.insert(rel, cols)
    assert hops and all(ok for _, ok in launched)
    for rel, kids, names in hops:
        if kids == 1:
            assert names == ["coo_spmm"], (rel, names)
        else:
            assert names and set(names) == {"segment_sum"}, (rel, names)
    # the R3 leaf, R2 with two children, and the one-child root all ran
    assert {kids for _, kids, _ in hops} == {0, 1, 2}


def test_engine_torch_needs_a_card(monkeypatch):
    cols = star_cols()
    q = JoinAggQuery(*STAR)
    with pytest.raises(ValueError, match="unknown engine"):
        MaintainedJoinAgg(q, Database.from_mapping(cols), engine="tensor", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MaintainedJoinAgg(q, Database.from_mapping(cols))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Q.from_query(q).maintain(cols)


def test_maintained_deltas_update_stats():
    """Materialized statistics follow the deltas as the reference's do:
    inserts merge sketches, deletes recollect, each bumps generation."""
    cols = star_cols()
    t = Twin(cols)
    stats, jstats = t.port.prep.stats, t.ref.prep.stats
    gen0, rows0 = stats.generation, stats.relations["R1"].rows
    t.insert("R1", {"g1": np.array([3, 4, 4]), "j": np.array([0, 0, 1])})
    assert stats.generation == jstats.generation == gen0 + 1
    assert stats.relations["R1"].rows == jstats.relations["R1"].rows == rows0 + 3
    t.delete("R1", {"g1": np.array([3]), "j": np.array([0])})
    assert stats.generation == jstats.generation == gen0 + 2
    for attr in ("g1", "j"):
        assert stats.distinct("R1", attr) == jstats.distinct("R1", attr)
        assert stats.max_share("R1", attr) == jstats.max_share("R1", attr)


def test_domain_growth_rekeys_the_views_of_unchanged_relations():
    """A view's keys ravel its hop key with the domain sizes of the time
    it was built.  An insert into R1 grows ``c``, which R2's two-attribute
    hop key (a, c) carries; R2 itself is unchanged, but its view must be
    rebuilt before the R3 batch rescans R2."""
    rng = np.random.default_rng(11)
    n = 200
    cols = {
        "R1": {"g1": rng.integers(0, 4, n), "a": rng.integers(0, 5, n),
               "c": rng.integers(0, 5, n)},
        "R2": {"a": rng.integers(0, 5, n), "c": rng.integers(0, 5, n),
               "d": rng.integers(0, 6, n)},
        "R3": {"d": rng.integers(0, 6, n), "g2": rng.integers(0, 4, n)},
    }
    t = Twin(cols, ("R1", "R2", "R3"), (("R1", "g1"), ("R3", "g2")))
    deco = t.port.prep.decomposition
    assert deco.nodes["R2"].parent == "R1" and deco.nodes["R3"].parent == "R2"
    t.insert("R1", {"g1": np.array([1, 2]), "a": np.array([0, 3]),
                    "c": np.array([7, 2])})  # c grows: 7 is new
    t.insert("R3", {"d": np.array([1, 2, 5]), "g2": np.array([0, 3, 3])})
