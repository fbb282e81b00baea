"""The port's whole slice on the CPU against the JAX package.

The same numpy inputs go through ``repro.api.Q ... .engine("jax")``
(CPU auto mode, which runs the jnp reference kernels, with
``.stats(False)`` so both planners choose the root by the same byte
heuristic), ``.engine("tensor")`` and the port's
``.engine(TorchChannelEngine(device="cpu"))``.  Every result column must
be bit-identical: measures are integer-valued, so every float32 sum is
exact.
"""
import numpy as np
import pytest
import torch

from repro.api import Avg as JAvg
from repro.api import Count as JCount
from repro.api import Max as JMax
from repro.api import Min as JMin
from repro.api import Q as JQ
from repro.api import Sum as JSum
from repro.data import synth
from repro.relational.relation import Database as JDatabase
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
from repro_torch.core import torch_engine
from repro_torch.data import synth as port_synth
from repro_torch.relational.relation import Database

CPU = TorchChannelEngine(device="cpu")


def _bundle(measure: str, api) -> dict:
    count, total, avg, lo, hi = api
    return dict(n=count(), s=total(measure), a=avg(measure), lo=lo(measure),
                hi=hi(measure))


PORT = (Count, Sum, Avg, Min, Max)
JAX = (JCount, JSum, JAvg, JMin, JMax)


def _build(q, relations, groups, aggs, where=(), stream=None, renames=()):
    q = q.over(*relations).group_by(*groups).agg(**aggs)
    for rel, kwargs in renames:
        q = q.rename(rel, **kwargs)
    for w in where:
        q = q.where(*w)
    if stream is not None:
        q = q.stream(*stream)
    return q


def _run_all(cols, relations, groups, measure, where=(), stream=None, renames=()):
    """Plan and execute on jax, tensor and the port; return the three
    results and the port's plan."""
    jdb = JDatabase.from_mapping(cols)
    out = {}
    for name in ("jax", "tensor"):
        jq = _build(JQ, relations, groups, _bundle(measure, JAX), where, stream, renames)
        out[name] = jq.engine(name).stats(False).plan(jdb)
    q = _build(Q, relations, groups, _bundle(measure, PORT), where, stream, renames)
    plan = q.engine(CPU).plan(Database.from_mapping(cols))
    return {k: p.execute() for k, p in out.items()}, plan.execute(), plan, out["jax"]


def _assert_identical(ref, got):
    assert list(got.relation.columns) == list(ref.relation.columns)
    for c in ref.relation.columns:
        a, b = ref.column(c), got.column(c)
        assert a.dtype == b.dtype, (c, a.dtype, b.dtype)
        np.testing.assert_array_equal(b, a, err_msg=c)


def _synth_cols(name: str, n: int) -> tuple[dict, tuple, list, str]:
    db, q = synth.make(name, n, seed=0)
    cols = {r: dict(db[r].columns) for r in q.relations}
    measure_rel = q.relations[2] if len(q.relations) > 2 else q.relations[1]
    cols[measure_rel]["m"] = np.random.default_rng(1).integers(0, 50, n)
    groups = [f"{r}.{a}" for r, a in q.group_by]
    return cols, q.relations, groups, f"{measure_rel}.m"


@pytest.mark.parametrize("name", synth.ALL)
def test_port_synth_generates_the_jax_datasets(name):
    jdb, jq = synth.make(name, 500, seed=3)
    db, q = port_synth.make(name, 500, seed=3)
    assert (q.relations, q.group_by) == (jq.relations, jq.group_by)
    for rel in q.relations:
        assert db[rel].attrs == jdb[rel].attrs
        for attr in db[rel].attrs:
            np.testing.assert_array_equal(db[rel].columns[attr], jdb[rel].columns[attr])


@pytest.mark.parametrize("tiles", [None, 3])
@pytest.mark.parametrize("name,n", [("C1", 3000), ("S1", 3000), ("B1", 2000)])
def test_synthetic_bundle_bit_identical(name, n, tiles):
    cols, relations, groups, measure = _synth_cols(name, n)
    stream = None
    if tiles is not None:
        attr = groups[0].split(".")[1]
        dom = len(np.unique(cols[groups[0].split(".")[0]][attr]))
        stream = (attr, -(-dom // tiles))
    refs, got, plan, jplan = _run_all(cols, relations, groups, measure, stream=stream)
    assert plan.prep.decomposition.root == jplan.prep.decomposition.root
    assert got.num_rows > 0
    _assert_identical(refs["jax"], got)
    _assert_identical(refs["tensor"], got)


def _quickstart_cols(n: int = 2000) -> dict:
    rng = np.random.default_rng(0)
    return {
        "R1": {"g1": rng.integers(0, 30, n), "j": rng.integers(0, 200, n)},
        "R2": {"j": rng.integers(0, 200, n), "k": rng.integers(0, 200, n),
               "m": rng.integers(1, 50, n)},
        "R3": {"k": rng.integers(0, 200, n), "g2": rng.integers(0, 30, n)},
    }


@pytest.mark.parametrize(
    "groups,stream",
    [
        (("R1.g1", "R3.g2"), None),  # the README quickstart as written
        (("R1.g1", "R2.k"), None),  # R2.k joins R3: copied group attribute
        (("R1.j", "R3.g2"), ("g2", 11)),  # R1.j joins R2, three stream tiles
    ],
)
def test_quickstart_where_and_joining_group_attr(groups, stream):
    cols = _quickstart_cols()
    refs, got, plan, _ = _run_all(
        cols, ("R1", "R2", "R3"), groups, "R2.m", where=[("R2", "m", ">", 5)],
        stream=stream,
    )
    assert any(note.startswith("where R2") for note in plan.rewrite_notes)
    if groups[1] == "R2.k" or groups[0] == "R1.j":
        assert any(note.startswith("copy group attr") for note in plan.rewrite_notes)
    _assert_identical(refs["jax"], got)
    _assert_identical(refs["tensor"], got)


def test_self_join_aliases_bit_identical():
    rng = np.random.default_rng(4)
    cols = {"Items": {"basket": rng.integers(0, 60, 800),
                      "item": rng.integers(0, 25, 800),
                      "m": rng.integers(0, 9, 800)}}
    relations = (("I1", "Items"), ("I2", "Items"))
    renames = (("I1", {"item": "i1"}), ("I2", {"item": "i2", "m": "m2"}))
    refs, got, _, _ = _run_all(
        cols, relations, ("I1.i1", "I2.i2"), "I2.m2", renames=renames,
    )
    _assert_identical(refs["jax"], got)
    _assert_identical(refs["tensor"], got)


def test_auto_stream_from_memory_budget_matches_unstreamed():
    cols, relations, groups, measure = _synth_cols("C1", 3000)
    base = _build(Q, relations, groups, _bundle(measure, PORT)).engine(CPU)
    db = Database.from_mapping(cols)
    whole = base.plan(db)
    tiled = base.memory_budget(whole.message_peak // 3).plan(db)
    assert whole.resolved_stream() is None
    attr, tile = tiled.resolved_stream()
    assert tile < tiled.prep.dicts[attr].size
    _assert_identical(whole.execute(), tiled.execute())


def test_edge_chunks_split_runs_without_changing_results(monkeypatch):
    """A tiny gather bound forces the general and MIN/MAX hops through
    many key-range chunks of the 1024-edge minimum; R3's three p1 keys
    carry runs longer than that, so runs are split across chunks."""
    rng = np.random.default_rng(5)
    n, big = 300, 6000  # small ends keep every sum below 2**24
    cols = {
        "R1": {"g1": rng.integers(0, 20, n), "p0": rng.integers(0, 40, n)},
        "R2": {"p0": rng.integers(0, 40, n), "p1": rng.integers(0, 3, n)},
        "R3": {"p1": rng.integers(0, 3, big), "p2": rng.integers(0, 3000, big),
               "m": rng.integers(0, 3, big)},
        "R4": {"p2": rng.integers(0, 3000, 3000), "g2": rng.integers(0, 20, 3000)},
    }
    relations, groups = ("R1", "R2", "R3", "R4"), ("R1.g1", "R4.g2")
    refs, want, _, _ = _run_all(cols, relations, groups, "R3.m")
    _assert_identical(refs["jax"], want)
    _assert_identical(refs["tensor"], want)
    monkeypatch.setattr(torch_engine, "_REF_GATHER_BYTES", 1)
    chunks = []
    real = torch_engine.key_chunks

    def spy(keys, num_keys, chunk):
        out = list(real(keys, num_keys, chunk))
        chunks.append(out)
        return iter(out)

    monkeypatch.setattr(torch_engine, "key_chunks", spy)
    q = _build(Q, relations, groups, _bundle("R3.m", PORT)).engine(CPU)
    got = q.plan(Database.from_mapping(cols)).execute()
    assert max(len(c) for c in chunks) > 2
    assert any(shared for c in chunks for *_, shared in c)
    _assert_identical(want, got)


@pytest.mark.parametrize("chunk", [1, 2, 3, 1024])
def test_key_chunks_tile_the_key_range(chunk):
    keys = np.array([0, 0, 0, 2, 2, 5, 5, 5, 5, 6, 9])
    parts = list(torch_engine.key_chunks(keys, 12, chunk))
    assert parts[0][0] == 0 and parts[-1][1] == len(keys)
    assert parts[0][2] == 0 and parts[-1][3] == 12
    for (e_lo, e_hi, k_lo, k_hi, shared), nxt in zip(parts, parts[1:] + [None]):
        assert 0 < e_hi - e_lo <= max(chunk, 1)
        assert np.all((keys[e_lo:e_hi] >= k_lo) & (keys[e_lo:e_hi] < k_hi))
        if nxt is not None:
            assert nxt[0] == e_hi
            # consecutive ranges meet, overlapping by one key iff shared
            assert nxt[2] == k_hi - (1 if nxt[4] else 0)
        assert shared == (e_lo > 0 and keys[e_lo - 1] == keys[e_lo])
    assert list(torch_engine.key_chunks(keys[:0], 4, 3)) == [(0, 0, 0, 4, False)]


def test_main_path_routes_hops_to_all_three_kernels(monkeypatch):
    """C1 with a SUM/MIN/MAX bundle on R3 runs leaf and measure-weighted
    hops on segment_sum, single-child uniform hops on coo_spmm and the
    MIN/MAX passes on segment_reduce — as the JAX engine routes them."""
    calls = {"segment_sum": 0, "coo_spmm": 0, "segment_reduce": 0}
    for name in calls:
        fn = getattr(torch_engine, name)

        def counting(*args, _fn=fn, _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(torch_engine, name, counting)
    cols, relations, groups, measure = _synth_cols("C1", 2000)
    _build(Q, relations, groups, _bundle(measure, PORT)).engine(CPU).execute(cols)
    assert all(v > 0 for v in calls.values()), calls


def test_messages_and_views_stay_on_the_engine_device():
    cols, relations, groups, measure = _synth_cols("S1", 1000)
    plan = _build(Q, relations, groups, _bundle(measure, PORT)).engine(CPU).plan(cols)
    plan.execute()
    views = plan.prep.device_views
    assert views, "no grouped-CSR view was moved to the device"
    for view in views.values():
        assert view.keys.device == torch.device("cpu")
        assert bool(torch.all(view.keys[1:] >= view.keys[:-1]))
    n_views = len(views)
    plan.execute()  # a second execute reuses every view
    assert len(plan.prep.device_views) == n_views


def test_cyclic_query_and_unported_options_raise():
    rng = np.random.default_rng(2)
    tri = {
        "E1": {"a": rng.integers(0, 9, 50), "b": rng.integers(0, 9, 50)},
        "E2": {"b": rng.integers(0, 9, 50), "c": rng.integers(0, 9, 50)},
        "E3": {"c": rng.integers(0, 9, 50), "a": rng.integers(0, 9, 50)},
    }
    q = Q.over("E1", "E2", "E3").group_by("E1.a").agg(n=Count()).engine(CPU)
    with pytest.raises(UnsupportedPlanOption, match="cyclic"):
        q.plan(tri)
    with pytest.raises(UnsupportedPlanOption):
        q.mesh(2)
    with pytest.raises(UnsupportedPlanOption):
        q.fused()
    with pytest.raises(UnsupportedPlanOption):
        q.maintain(tri)
    cols = _quickstart_cols(200)
    plan = Q.over("R1", "R2", "R3").group_by("R1.g1").engine(CPU).plan(cols)
    with pytest.raises(UnsupportedPlanOption):
        plan.maintain()
