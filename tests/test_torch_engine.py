"""The port's whole slice on the CPU against the JAX package.

The same numpy inputs go through ``repro.api.Q ... .engine("jax")``
(CPU auto mode, which runs the jnp reference kernels),
``.engine("tensor")`` and the port's
``.engine(TorchChannelEngine(device="cpu"))``, unfused and with
``.fused(True)``, all three planning with statistics, their default
(``tests/test_torch_planner.py`` holds both settings).  The JAX side always runs unfused: its fused path
cannot run on the installed JAX, and its own contract (DESIGN.md §13) is
that fused hops equal the three-dispatch path bit for bit.  Every result
column must be bit-identical: measures are integer-valued, so every
float32 sum is exact.

Tests that mean the sparse walk pin it with ``mode="sparse"`` and run a
second case in the default ``mode="auto"``, which takes the path
``choose_path`` picks (dense at these sizes unless a stream is set) —
the path ``engine("jax")`` takes (``tests/test_torch_dense.py``).
"""
import dataclasses
import math

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
from repro_torch.core.torch_engine import choose_path
from repro_torch.data import synth as port_synth
from repro_torch.kernels import ops
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


def _run_all(
    cols, relations, groups, measure, where=(), stream=None, renames=(), fused=None,
    mode="auto",
):
    """Plan and execute on jax, tensor and the port (with ``.fused(fused)``
    unless None, on the CPU engine in ``mode``); return the three results
    and the port's plan."""
    jdb = JDatabase.from_mapping(cols)
    out = {}
    for name in ("jax", "tensor"):
        jq = _build(JQ, relations, groups, _bundle(measure, JAX), where, stream, renames)
        out[name] = jq.engine(name).plan(jdb)
    q = _build(Q, relations, groups, _bundle(measure, PORT), where, stream, renames)
    if fused is not None:
        q = q.fused(fused)
    plan = q.engine(TorchChannelEngine(device="cpu", mode=mode)).plan(
        Database.from_mapping(cols)
    )
    return {k: p.execute() for k, p in out.items()}, plan.execute(), plan, out["jax"]


def _taken_path(plan) -> str:
    return plan.engine.path(
        plan.prep, plan.channels, plan.resolved_stream(), plan.memory_budget, plan.fused
    )


def _check_mode(plan, mode: str, streamed: bool = False) -> None:
    """``mode="sparse"`` takes the sparse walk; ``"auto"`` the path
    ``choose_path`` picks — dense here unless the plan streams."""
    taken = _taken_path(plan)
    if mode == "sparse":
        assert taken == "sparse"
        return
    cm = tuple(ch.measure[0] if ch.kind == "sum" else None for ch in plan.channels)
    choice = choose_path(
        plan.prep, k=len(cm), memory_budget=plan.memory_budget,
        stream=plan.resolved_stream(), measured=cm,
    )
    assert taken == choice.path == ("sparse" if streamed else "dense"), choice.reason


MODES = pytest.mark.parametrize("mode", ["sparse", "auto"])


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


def _tile_stream(cols, groups, tiles):
    if tiles is None:
        return None
    attr = groups[0].split(".")[1]
    dom = len(np.unique(cols[groups[0].split(".")[0]][attr]))
    return (attr, -(-dom // tiles))


@MODES
@pytest.mark.parametrize("tiles", [None, 3])
@pytest.mark.parametrize("name,n", [("C1", 3000), ("S1", 3000), ("B1", 2000)])
def test_synthetic_bundle_bit_identical(name, n, tiles, mode):
    cols, relations, groups, measure = _synth_cols(name, n)
    stream = _tile_stream(cols, groups, tiles)
    refs, got, plan, jplan = _run_all(
        cols, relations, groups, measure, stream=stream, mode=mode
    )
    _check_mode(plan, mode, streamed=stream is not None)
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
@MODES
def test_quickstart_where_and_joining_group_attr(groups, stream, mode):
    cols = _quickstart_cols()
    refs, got, plan, _ = _run_all(
        cols, ("R1", "R2", "R3"), groups, "R2.m", where=[("R2", "m", ">", 5)],
        stream=stream, mode=mode,
    )
    _check_mode(plan, mode, streamed=stream is not None)
    assert any(note.startswith("where R2") for note in plan.rewrite_notes)
    if groups[1] == "R2.k" or groups[0] == "R1.j":
        assert any(note.startswith("copy group attr") for note in plan.rewrite_notes)
    _assert_identical(refs["jax"], got)
    _assert_identical(refs["tensor"], got)


@MODES
def test_self_join_aliases_bit_identical(mode):
    rng = np.random.default_rng(4)
    cols = {"Items": {"basket": rng.integers(0, 60, 800),
                      "item": rng.integers(0, 25, 800),
                      "m": rng.integers(0, 9, 800)}}
    relations = (("I1", "Items"), ("I2", "Items"))
    renames = (("I1", {"item": "i1"}), ("I2", {"item": "i2", "m": "m2"}))
    refs, got, plan, _ = _run_all(
        cols, relations, ("I1.i1", "I2.i2"), "I2.m2", renames=renames, mode=mode,
    )
    _check_mode(plan, mode)
    _assert_identical(refs["jax"], got)
    _assert_identical(refs["tensor"], got)


@MODES
def test_auto_stream_from_memory_budget_matches_unstreamed(mode):
    cols, relations, groups, measure = _synth_cols("C1", 3000)
    base = _build(Q, relations, groups, _bundle(measure, PORT)).engine(
        TorchChannelEngine(device="cpu", mode=mode)
    )
    db = Database.from_mapping(cols)
    whole = base.plan(db)
    tiled = base.memory_budget(whole.message_peak // 3).plan(db)
    _check_mode(whole, mode)
    _check_mode(tiled, mode, streamed=True)
    assert whole.resolved_stream() is None
    attr, tile = tiled.resolved_stream()
    assert tile < tiled.prep.dicts[attr].size
    _assert_identical(whole.execute(), tiled.execute())


@MODES
def test_edge_chunks_split_runs_without_changing_results(monkeypatch, mode):
    """A tiny gather bound forces the general and MIN/MAX hops through
    many key-range chunks of the 1024-edge minimum; R3's three p1 keys
    carry runs longer than that, so runs are split across chunks.  The
    dense path (``auto``) contracts the channels without chunks; its
    MIN/MAX passes still walk them."""
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
    refs, want, plan, _ = _run_all(cols, relations, groups, "R3.m", mode=mode)
    _check_mode(plan, mode)
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
    q = _build(Q, relations, groups, _bundle("R3.m", PORT)).engine(plan.engine)
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


@MODES
def test_main_path_routes_hops_to_all_three_kernels(monkeypatch, mode):
    """C1 with a SUM/MIN/MAX bundle on R3 runs leaf and measure-weighted
    hops on segment_sum, single-child uniform hops on coo_spmm and the
    MIN/MAX passes on segment_reduce — as the JAX engine routes them.
    On the dense path (``auto``) the einsum contracts the channels and
    only the MIN/MAX passes launch, on segment_reduce."""
    calls = {"segment_sum": 0, "coo_spmm": 0, "segment_reduce": 0}
    for name in calls:
        fn = getattr(torch_engine, name)

        def counting(*args, _fn=fn, _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(torch_engine, name, counting)
    cols, relations, groups, measure = _synth_cols("C1", 2000)
    engine = TorchChannelEngine(device="cpu", mode=mode)
    plan = _build(Q, relations, groups, _bundle(measure, PORT)).engine(engine).plan(cols)
    _check_mode(plan, mode)
    plan.execute()
    if mode == "sparse":
        assert all(v > 0 for v in calls.values()), calls
    else:
        assert calls["segment_sum"] == calls["coo_spmm"] == 0, calls
        assert calls["segment_reduce"] > 0, calls


@MODES
def test_messages_and_views_stay_on_the_engine_device(mode):
    """Grouped-CSR views (and, on the dense path, relation tensors) are
    moved to the engine's device once and reused by the next execute."""
    cols, relations, groups, measure = _synth_cols("S1", 1000)
    engine = TorchChannelEngine(device="cpu", mode=mode)
    plan = _build(Q, relations, groups, _bundle(measure, PORT)).engine(engine).plan(cols)
    _check_mode(plan, mode)
    plan.execute()
    views = plan.prep.device_views
    assert views, "no grouped-CSR view was moved to the device"
    dense = {k: v for k, v in views.items() if k[0] == "dense"}
    assert bool(dense) == (mode == "auto")
    assert sorted(k[2] for k in dense) == sorted(plan.prep.encoded) * bool(dense)
    for key, view in views.items():
        if key[0] == "dense":
            assert view.device == torch.device("cpu") and view.dtype == torch.float32
            continue
        assert view.keys.device == torch.device("cpu")
        assert bool(torch.all(view.keys[1:] >= view.keys[:-1]))
    before = dict(views)
    plan.execute()  # a second execute reuses every view and tensor
    assert plan.prep.device_views.keys() == before.keys()
    assert all(plan.prep.device_views[k] is v for k, v in before.items())


def test_cyclic_query_and_unported_options_raise():
    """The triangle is answered (through the GHD compiler) as the JAX
    package answers it; meshes still raise, and maintenance, ported
    since, returns handles that answer as ``execute()`` does."""
    rng = np.random.default_rng(2)
    tri = {
        "E1": {"a": rng.integers(0, 9, 50), "b": rng.integers(0, 9, 50)},
        "E2": {"b": rng.integers(0, 9, 50), "c": rng.integers(0, 9, 50)},
        "E3": {"c": rng.integers(0, 9, 50), "a": rng.integers(0, 9, 50)},
    }
    q = Q.over("E1", "E2", "E3").group_by("E1.a").agg(n=Count()).engine(CPU)
    plan = q.plan(tri)
    assert plan.cyclic and plan.ghd_plan is not None
    got = plan.execute()
    want = (
        JQ.over("E1", "E2", "E3").group_by("E1.a").agg(n=JCount())
        .engine("tensor").plan(JDatabase.from_mapping(tri)).execute()
    )
    assert got.num_rows > 0
    _assert_identical(want, got)
    # a mesh of 2 plans anywhere; its execute needs a process group of 2
    with pytest.raises(ValueError, match="process group of 2 ranks"):
        q.mesh(2).plan(tri).execute()
    assert q.maintain(tri).result() == got.to_dict()
    cols = _quickstart_cols(200)
    plan = Q.over("R1", "R2", "R3").group_by("R1.g1").engine(CPU).plan(cols)
    assert plan.maintain().result() == plan.execute().to_dict()


# ----------------------------------------------------------------------
# the fused-hop path: Q.fused(True) / REPRO_FUSED
# ----------------------------------------------------------------------


@pytest.mark.parametrize("tiles", [None, 3])
@pytest.mark.parametrize("name,n", [("C1", 3000), ("S1", 3000), ("B1", 2000)])
def test_fused_synthetic_bundle_bit_identical(name, n, tiles):
    cols, relations, groups, measure = _synth_cols(name, n)
    stream = _tile_stream(cols, groups, tiles)
    refs, got, plan, _ = _run_all(
        cols, relations, groups, measure, stream=stream, fused=True
    )
    assert plan.fused is True and got.num_rows > 0
    _assert_identical(refs["jax"], got)
    _assert_identical(refs["tensor"], got)


@pytest.mark.parametrize(
    "groups,stream",
    [
        (("R1.g1", "R3.g2"), None),
        (("R1.g1", "R2.k"), None),
        (("R1.j", "R3.g2"), ("g2", 11)),
    ],
)
def test_fused_quickstart_where_and_joining_group_attr(groups, stream):
    refs, got, _, _ = _run_all(
        _quickstart_cols(), ("R1", "R2", "R3"), groups, "R2.m",
        where=[("R2", "m", ">", 5)], stream=stream, fused=True,
    )
    _assert_identical(refs["jax"], got)
    _assert_identical(refs["tensor"], got)


def test_fused_self_join_aliases_bit_identical():
    rng = np.random.default_rng(4)
    cols = {"Items": {"basket": rng.integers(0, 60, 800),
                      "item": rng.integers(0, 25, 800),
                      "m": rng.integers(0, 9, 800)}}
    renames = (("I1", {"item": "i1"}), ("I2", {"item": "i2", "m": "m2"}))
    refs, got, _, _ = _run_all(
        cols, (("I1", "Items"), ("I2", "Items")), ("I1.i1", "I2.i2"), "I2.m2",
        renames=renames, fused=True,
    )
    _assert_identical(refs["jax"], got)
    _assert_identical(refs["tensor"], got)


def _star_cols(n=300, seed=7) -> dict:
    """Three relations around R2, which carries the measure and a group
    attribute of its own: the shape of ``tests/test_fused_hop.py``'s
    ``_star_db`` plus R2.g, with join domains wider than the group ones so
    that the root with the smallest peak message is R2, which contracts
    two children with measure-weighted channels."""
    rng = np.random.default_rng(seed)
    a, b = 9, 20
    return {
        "R1": {"g1": rng.integers(0, a, n), "p": rng.integers(0, b, n)},
        "R2": {"p": rng.integers(0, b, n), "q": rng.integers(0, b, n),
               "g": rng.integers(0, 3, n), "m": rng.integers(0, 10, n)},
        "R3": {"q": rng.integers(0, b, n), "g2": rng.integers(0, a, n)},
    }


def test_fused_star_measure_weighted_multi_child_hop():
    refs, got, plan, jplan = _run_all(
        _star_cols(), ("R1", "R2", "R3"), ("R1.g1", "R2.g", "R3.g2"), "R2.m",
        fused=True,
    )
    deco = plan.prep.decomposition
    assert plan.prep.decomposition.root == jplan.prep.decomposition.root
    assert max(len(node.children) for node in deco.nodes.values()) >= 2
    _assert_identical(refs["jax"], got)
    _assert_identical(refs["tensor"], got)


def _count_kernel_calls(monkeypatch) -> dict[str, int]:
    calls = {"segment_sum": 0, "coo_spmm": 0, "segment_reduce": 0, "fused_hop": 0}
    for name in calls:
        fn = getattr(torch_engine, name)

        def counting(*args, _fn=fn, _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(torch_engine, name, counting)
    return calls


@pytest.mark.parametrize("fused", [True, False, None])
def test_fused_option_routes_every_hop_to_one_fused_launch(monkeypatch, fused):
    """``.fused(True)``: one ``fused_hop`` call per hop, per pass, per
    stream tile and nothing else.  ``.fused(False)`` and the option left
    unset: the three-dispatch routing, with the same calls."""
    monkeypatch.delenv("REPRO_FUSED", raising=False)
    calls = _count_kernel_calls(monkeypatch)
    cols, relations, groups, measure = _synth_cols("C1", 2000)
    stream = _tile_stream(cols, groups, 3)
    q = _build(Q, relations, groups, _bundle(measure, PORT), stream=stream)
    if fused is not None:
        q = q.fused(fused)
    plan = q.engine(CPU).plan(Database.from_mapping(cols))
    got = plan.execute()
    hops = len(plan.prep.decomposition.nodes)
    passes = 1 + len(plan.minmax)
    attr, tile = plan.resolved_stream()
    tiles = math.ceil(plan.prep.dicts[attr].size / tile)
    assert tiles > 1 and passes == 3
    if fused:
        assert calls == {"segment_sum": 0, "coo_spmm": 0, "segment_reduce": 0,
                         "fused_hop": hops * passes * tiles}, calls
        unfused = dataclasses.replace(plan, fused=False).execute()
        _assert_identical(unfused, got)
    else:
        assert calls["fused_hop"] == 0
        assert all(calls[n] > 0 for n in ("segment_sum", "coo_spmm", "segment_reduce"))


@MODES
def test_fused_env_switch(monkeypatch, mode):
    """``REPRO_FUSED=1`` turns fused hops on for plans that did not pin a
    choice; an explicit ``.fused(False)`` still wins.  On the dense path
    (``auto``) it does not move the choice: no hop runs fused."""
    assert ops.fused_enabled(True) is True
    assert ops.fused_enabled(False) is False
    monkeypatch.delenv("REPRO_FUSED", raising=False)
    assert ops.fused_enabled(None) is False
    calls = _count_kernel_calls(monkeypatch)
    engine = TorchChannelEngine(device="cpu", mode=mode)
    q = Q.over("R1", "R2", "R3").group_by("R1.g1", "R3.g2").agg(n=Count()).engine(engine)
    cols = _quickstart_cols(300)
    q.execute(cols)
    assert calls["fused_hop"] == 0
    monkeypatch.setenv("REPRO_FUSED", "1")
    assert ops.fused_enabled(None) is True
    want = q.fused(False).execute(cols)
    assert calls["fused_hop"] == 0
    plan = q.plan(cols)
    _check_mode(plan, mode)
    got = plan.execute()
    assert calls["fused_hop"] == (3 if mode == "sparse" else 0)
    _assert_identical(want, got)


def test_fused_option_rejected_by_an_engine_without_fused_hops():
    class NoFused(TorchChannelEngine):
        supports_fused = False

    q = Q.over("R1", "R2", "R3").group_by("R1.g1").engine(NoFused(device="cpu"))
    cols = _quickstart_cols(100)
    assert q.plan(cols).execute().num_rows > 0
    with pytest.raises(UnsupportedPlanOption, match="no fused hop kernels"):
        q.fused(True).plan(cols)
