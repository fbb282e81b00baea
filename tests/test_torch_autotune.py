"""The fused hop's launch-shape tuning (``repro_torch.kernels.autotune``,
``repro_torch.launch.roofline``) on the CPU.

Hop shapes bucket as the JAX package's ``repro.kernels.autotune.hop_shape``
does; every candidate is a launch the kernel takes; the model's ranking is
deterministic and picks today's fixed plans at the main path's (C1,
n = 500,000) hop shapes; on the CPU nothing is timed.  Measurement runs on
a card only, so its logic is held here with an injected timer and a
stand-in card name: the fastest wins and is launched last, ties go by key,
the disk cache round-trips, an entry the kernel cannot take is dropped and
tuned again, and eight threads' first launches of one shape measure once.
Explain and V-KERN show the model's pick, never a cache entry.
"""
import json
import math
import sys
import threading

import numpy as np
import pytest
import torch

from repro.kernels import autotune as ref_autotune
from repro_torch.api import Count, Q, Sum, TorchChannelEngine
from repro_torch.core import torch_engine
from repro_torch.core.torch_engine import hop_launch_shapes
from repro_torch.kernels import autotune, ops
from repro_torch.kernels.fused_hop import fused_hop
from repro_torch.launch import roofline
from repro_torch.relational.relation import Database

CPU = TorchChannelEngine(device="cpu")
CARD = torch.device("cuda")  # a descriptor only: no card is touched here
TIMEOUT = 60

# C1 at n = 500,000, seed 0, the fused bundle's hops (hop_launch_shapes of
# chip_smoke.py's fused C1 plan): (edges, num_rows, d, k, child rows, child widths)
C1_HOPS = [
    (249_430, 1125, 4500, 2, (50_000,), (2250,)),
    (249_502, 1125, 4500, 2, (50_000,), (2250,)),
    (499_948, 50_000, 4500, 2, (50_000,), (2250,)),
    (499_949, 50_000, 4500, 2, (50_000,), (2250,)),
    (498_847, 112_500_000, 2, 2, (), ()),
    (249_430, 1125, 2250, 1, (50_000,), (2250,)),
    (249_502, 1125, 2250, 1, (50_000,), (2250,)),
    (499_948, 50_000, 2250, 1, (50_000,), (2250,)),
    (499_949, 50_000, 2250, 1, (50_000,), (2250,)),
    (498_847, 112_500_000, 1, 1, (), ()),
]
# PERF.md §6's few-row hops: the storage root hop, the maintain root rescan
FEW_ROW_HOPS = [
    (2_530_424, 32, 64, 1, (100_000,), (64,)),
    (81_675, 50, 2600, 1, (50_000,), (2600,)),
]
OTHER_HOPS = [
    (3725, 389, 4500, 1, (40, 30), (150, 30)),  # two children: the row walk
    (1000, 37, 12, 2, (9,), (6,)),  # one narrow child: the narrow walk
    (0, 5, 6, 1, (9, 9), (2, 3)),  # no edges
]


def shape_of(hop):
    n, rows, d, k, child_rows, widths = hop
    return autotune.hop_shape(n, child_rows, k=k, child_widths=widths, num_segments=rows)


def dims_of(hop):
    return hop[0], hop[1], hop[2]


@pytest.fixture
def tuner(tmp_path, monkeypatch):
    """A fresh cache in ``tmp_path``, a stand-in card name and a timer that
    reads ms per plan key from ``tuner.ms`` (default 1.0), counting calls."""

    class Tuner:
        path = tmp_path / "autotune.json"
        ms: dict = {}
        timed: list = []
        lock = threading.Lock()

        def timer(self, run, plans, device):
            with self.lock:
                self.timed.append(list(plans))
            return [self.ms.get(p.key(), 1.0) for p in plans]

    t = Tuner()
    t.ms, t.timed = {}, []
    monkeypatch.setenv(autotune.CACHE_ENV, str(t.path))
    monkeypatch.setattr(autotune, "_card_name", lambda device: "Test Card")
    monkeypatch.setattr(autotune, "_time_candidates", t.timer)
    autotune.reset_cache()
    yield t
    autotune.reset_cache()


def recorder():
    launched = []
    return launched, launched.append


@pytest.mark.parametrize("seed", range(4))
def test_hop_shape_buckets_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(60):
        nchild = int(rng.integers(0, 4))
        edges = int(rng.choice([0, 1, 255, 256, 257, int(rng.integers(0, 10**8))]))
        child_rows = tuple(int(rng.choice([1, 7, 8, 9, int(rng.integers(1, 10**7))]))
                           for _ in range(nchild))
        widths = tuple(int(rng.integers(1, 70)) for _ in range(nchild))
        k = int(rng.integers(1, 4))
        kind = str(rng.choice(["sum", "min", "max"]))
        segs = int(rng.choice([0, 1, 8, 9, int(rng.integers(1, 10**9))]))
        for kw in ({"child_widths": widths}, {"width": int(rng.integers(1, 70))}):
            want = ref_autotune.hop_shape(edges, child_rows, k=k, kind=kind,
                                          num_segments=segs, **kw)
            got = autotune.hop_shape(edges, child_rows, k=k, kind=kind,
                                     num_segments=segs, **kw)
            assert (got.edges, got.child_rows, got.child_widths, got.num_segments,
                    got.k, got.kind) == (want.edges, want.child_rows, want.child_widths,
                                         want.num_segments, want.k, want.kind)
            assert got.key() == f"{want.key()}|{got.walk}"
            assert got.walk == ("gather" if nchild == 1 and got.d >= 32 else "tile")


@pytest.mark.parametrize("hop", C1_HOPS + FEW_ROW_HOPS + OTHER_HOPS)
def test_candidates_are_launches_and_rank_deterministically(hop):
    shape = shape_of(hop)
    cands = autotune.candidates(shape)
    assert cands[0] == autotune.fixed_plan(shape)
    made = [c.make(*shape.dims()) for c in cands]
    assert len({bytes(m) for m in made}) == len(made)
    for c, m in zip(cands, made):
        assert c.walk == shape.walk
        assert isinstance(m, ops.GatherPlan if shape.walk == "gather" else ops.WalkPlan)
        assert roofline.fused_hop_admissible(m)
        # the same parameters as ops' own makers take them
        again = (ops.make_gather_plan(*shape.dims(), c.slab, c.rows, c.warps, c.in_flight,
                                      c.slab_major)
                 if c.walk == "gather" else ops.make_walk_plan(*shape.dims(), c.rows, c.slabs))
        assert bytes(again) == bytes(m)
    ranked = autotune.candidate_plans(shape)
    autotune.candidate_plans.cache_clear()
    autotune.candidates.cache_clear()
    assert autotune.candidate_plans(shape) == ranked
    assert sorted(p.key() for _, p in ranked) == sorted(c.key() for c in cands)
    best = min(s for s, _ in ranked)
    band = best * (1 + autotune.MODEL_TOLERANCE)
    tied = [p for s, p in ranked if s <= band]
    assert [p for _, p in ranked[:len(tied)]] == tied
    if autotune.fixed_plan(shape) in tied:
        assert tied[0] == autotune.fixed_plan(shape)
    rest = [(s, p.key()) for s, p in ranked[len(tied):]]
    assert rest == sorted(rest)


@pytest.mark.parametrize("hop", C1_HOPS)
def test_the_model_picks_the_fixed_plans_at_c1(hop):
    shape, (n, rows, d) = shape_of(hop), dims_of(hop)
    fixed = ops.gather_plan(n, rows, d) if shape.walk == "gather" else ops.walk_plan(n, rows, d)
    assert bytes(autotune.model_plan_for(shape, (n, rows, d)).make(n, rows, d)) == bytes(fixed)


@pytest.mark.parametrize("hop", FEW_ROW_HOPS)
def test_the_model_spreads_few_rows_over_more_warps(hop):
    """At 16 rows a block the few-row hops give each warp 4 rows in turn;
    the model ranks first a plan that gives each warp one, and predicts
    it at least twice as fast."""
    shape, dims = shape_of(hop), dims_of(hop)
    pick = autotune.model_plan_for(shape, dims)
    assert pick.walk == "gather" and pick.rows == pick.warps
    fixed = autotune.fixed_plan(shape)
    assert 2 * autotune.model_seconds(shape, pick) < autotune.model_seconds(shape, fixed)


def test_bytes_term_is_perf_md_bound_at_c1():
    """C1's one-child sum hop at the fixed plan: edge columns, the child
    message once (a slab of it fits L2) and the output once, at
    3.35 TB/s: PERF.md §6's 0.5409 ms bound."""
    cost = roofline.fused_hop_cost(499_948, (50_000,), (2250,), 50_000, 2,
                                   ops.gather_plan(499_948, 50_000, 4500))
    assert cost["hbm_bytes"] / roofline.HBM_BW * 1e3 == pytest.approx(0.5409, abs=5e-5)
    assert cost["bound"] == "serial" and cost["seconds"] > cost["hbm_bytes"] / roofline.HBM_BW
    # slab 256 makes a 51.2 MB slab: no longer in L2, so every edge gathers from memory
    wide = roofline.fused_hop_cost(499_948, (50_000,), (2250,), 50_000, 2,
                                   ops.make_gather_plan(499_948, 50_000, 4500, slab=256))
    assert wide["hbm_bytes"] > 4 * cost["hbm_bytes"]


def test_plan_for_on_the_cpu_measures_nothing(tuner):
    shape = shape_of(FEW_ROW_HOPS[0])

    def run(plan):
        raise AssertionError("timed a launch on the CPU")

    before = autotune.stats()
    got = autotune.plan_for(shape, torch.device("cpu"), run, dims_of(FEW_ROW_HOPS[0]))
    assert got == autotune.model_plan_for(shape, dims_of(FEW_ROW_HOPS[0]))
    assert autotune.stats() == before and tuner.timed == [] and not tuner.path.exists()
    # without the hop's operands nothing is timed on a card either
    assert autotune.plan_for(shape, CARD) == autotune.model_plan_for(shape)
    assert tuner.timed == [] and not tuner.path.exists()


def test_the_fastest_measured_wins_and_launches_last(tuner):
    hop = FEW_ROW_HOPS[1]
    shape, dims = shape_of(hop), dims_of(hop)
    top = [p for _, p in autotune.candidate_plans(shape)][:autotune.MEASURE_TOP_N]
    fixed = autotune.fixed_plan(shape, dims[1])
    assert fixed not in top
    tuner.ms = {top[0].key(): 3.0, top[1].key(): 0.5, top[2].key(): 2.0, fixed.key(): 9.0}
    launched, run = recorder()
    before = autotune.stats()
    got = autotune.plan_for(shape, CARD, run, dims)
    assert got == top[1]
    assert tuner.timed == [top + [fixed]]  # the top 3 and the fixed plan
    assert launched == [top[1]]  # the timer is stubbed: only the winner's last launch
    after = autotune.stats()
    assert after["measurements"] == before["measurements"] + 1
    assert after["timing_launches"] == before["timing_launches"] + 4 * (1 + autotune.TIMED_LAUNCHES)
    entry = autotune.measurement_log()[autotune.cache_key(shape, CARD)]
    assert entry["winner"] == top[1] and entry["fixed"] == fixed and entry["model"] == top[0]
    assert [ms for _, ms in entry["measured"]] == [3.0, 0.5, 2.0, 9.0]
    # a hit: nothing timed, nothing launched
    assert autotune.plan_for(shape, CARD, run, dims) == top[1]
    assert len(tuner.timed) == 1 and launched == [top[1]]


def test_ties_go_by_key(tuner):
    hop = C1_HOPS[2]
    shape, dims = shape_of(hop), dims_of(hop)
    top = [p for _, p in autotune.candidate_plans(shape)][:autotune.MEASURE_TOP_N]
    assert top[0] == autotune.fixed_plan(shape)  # the fixed plan is measured once
    tuner.ms = {p.key(): 1.25 for p in top}
    launched, run = recorder()
    got = autotune.plan_for(shape, CARD, run, dims)
    assert got == min(top, key=lambda p: p.key()) and launched == [got]
    assert tuner.timed == [top]


def test_the_disk_cache_round_trips(tuner):
    hop = FEW_ROW_HOPS[0]
    shape, dims = shape_of(hop), dims_of(hop)
    launched, run = recorder()
    won = autotune.plan_for(shape, CARD, run, dims)
    key = autotune.cache_key(shape, CARD)
    assert key == f"Test Card|{ops.source_digest('fused_hop')}|{shape.key()}"
    assert json.loads(tuner.path.read_text()) == {key: won.fields()}
    assert not list(tuner.path.parent.glob("*.tmp"))
    autotune.reset_cache()
    assert autotune.cached_plan_for(shape, CARD, dims) == won
    assert autotune.plan_for(shape, CARD, run, dims) == won
    assert len(tuner.timed) == 1 and launched == [won]
    # a second shape merges into the file, keeping the first
    other = shape_of(FEW_ROW_HOPS[1])
    autotune.plan_for(other, CARD, run, dims_of(FEW_ROW_HOPS[1]))
    assert set(json.loads(tuner.path.read_text())) == {key, autotune.cache_key(other, CARD)}
    # deleting the file retunes
    tuner.path.unlink()
    autotune.reset_cache()
    autotune.plan_for(shape, CARD, run, dims)
    assert len(tuner.timed) == 3


def test_a_corrupt_file_is_ignored_and_retuned(tuner):
    tuner.path.write_text("{not json")
    hop = FEW_ROW_HOPS[0]
    launched, run = recorder()
    won = autotune.plan_for(shape_of(hop), CARD, run, dims_of(hop))
    assert len(tuner.timed) == 1
    assert json.loads(tuner.path.read_text()) == {
        autotune.cache_key(shape_of(hop), CARD): won.fields()}


@pytest.mark.parametrize("bad", [
    {"warps": 7},  # more warps than the kernel has
    {"rows": 0},
    {"in_flight": 2},  # no such instantiation
    {"walk": "tile", "slabs": 1},  # the other walk's plan
    {"rows": 64, "warps": 4, "slab": 48},  # a slab of 48 columns
    {"slab_major": 1},  # not a bool
    {"rows": "16"},  # not an int
    {"walk": "warp"},
    None,  # not a plan at all
])
def test_an_entry_the_kernel_cannot_take_is_dropped_and_retuned(tuner, bad):
    hop = FEW_ROW_HOPS[1]
    shape, dims = shape_of(hop), dims_of(hop)
    key = autotune.cache_key(shape, CARD)
    planted = {**autotune.fixed_plan(shape).fields(), **bad} if bad else [1, 2]
    tuner.path.write_text(json.dumps({key: planted}))
    before = autotune.stats()["dropped"]
    launched, run = recorder()
    got = autotune.plan_for(shape, CARD, run, dims)
    assert len(tuner.timed) == 1 and launched == [got]
    assert got.make(*dims) is not None and got.walk == "gather"
    assert autotune.stats()["dropped"] == before + 1
    assert json.loads(tuner.path.read_text())[key] == got.fields()


def test_an_entry_that_does_not_fit_this_launch_is_dropped(tuner):
    """A cached plan made for the bucket but refused at this launch's own
    sizes never reaches the launch: 2**31 - 1 edges take no tile walk
    plan whose tile spans 2**31 floats."""
    shape = autotune.hop_shape(3, (), k=1, num_segments=2**31)
    key = autotune.cache_key(shape, CARD)
    tuner.path.write_text(json.dumps({key: {**autotune.fixed_plan(shape).fields(),
                                            "rows": 2**31}}))
    launched, run = recorder()
    got = autotune.plan_for(shape, CARD, run, (3, 2**31, 1))
    assert got.rows < 2**31 and len(tuner.timed) == 1


def test_eight_threads_measure_one_shape_once(tuner):
    hop = FEW_ROW_HOPS[0]
    shape, dims = shape_of(hop), dims_of(hop)
    barrier = threading.Barrier(8)
    got, errors = [], []
    slow = tuner.timer

    def timer(run, plans, device):
        threading.Event().wait(0.2)  # the others arrive while one measures
        return slow(run, plans, device)

    autotune._time_candidates = timer
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker():
            try:
                launched, run = recorder()
                barrier.wait(TIMEOUT)
                got.append(autotune.plan_for(shape, CARD, run, dims))
            except Exception as e:  # reported below
                errors.append(e)

        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
        autotune._time_candidates = slow
    assert errors == [] and len(got) == 8 and len(set(got)) == 1
    assert len(tuner.timed) == 1


def _c1_small():
    rng = np.random.default_rng(3)
    n, dom = 3000, 40
    cols = {
        "R1": {"g1": rng.integers(0, 25, n), "p0": rng.integers(0, dom, n)},
        "R2": {"p0": rng.integers(0, dom, n), "p1": rng.integers(0, dom, n)},
        "R3": {"p1": rng.integers(0, dom, n), "p2": rng.integers(0, dom, n),
               "m": rng.integers(0, 9, n)},
        "R4": {"p2": rng.integers(0, dom, n), "g2": rng.integers(0, 30, n)},
    }
    db = Database.from_mapping(cols)
    q = (Q.over("R1", "R2", "R3", "R4").group_by("R1.g1", "R4.g2")
         .agg(n=Count(), s=Sum("R3.m")).engine(CPU).fused(True))
    return q.plan(db)


def test_explain_and_the_engine_take_the_model_pick_never_the_cache(tuner, monkeypatch):
    """Plant, for every hop of a fused plan, a cache entry (memory and
    disk) other than the model's pick: ``hop_launch_shapes``, the
    ``kernels:`` lines, V-KERN and the CPU engine's launches still take
    the model's pick."""
    monkeypatch.delenv("REPRO_FUSED", raising=False)
    plan = _c1_small()
    entries = [e for r in plan.fused_runs()
               for e in hop_launch_shapes(r["prep"], r["k"], r["encoded"], r["domains"])]
    assert entries and all(e["pick"] is not None for e in entries)
    planted = {}
    for e in entries:
        shape = e["shape"]
        dims = (e["edges"], e["num_segments"], e["width"])
        extra = (autotune.HopPlan("gather", 1, 32, 1, 1, True), autotune.HopPlan("tile", 1, slabs=1))
        other = next(c for c in autotune.candidates(shape) + extra
                     if c.walk == shape.walk and autotune._makes(c, dims) is not None
                     and bytes(c.make(*dims)) != bytes(e["plan"]))
        planted[autotune.cache_key(shape, CARD)] = other.fields()
        planted[f"cpu|{ops.source_digest('fused_hop')}|{shape.key()}"] = other.fields()
    tuner.path.write_text(json.dumps(planted))
    autotune.reset_cache()
    assert autotune.cached_plan_for(entries[0]["shape"], CARD,
                                    (entries[0]["edges"], entries[0]["num_segments"],
                                     entries[0]["width"])) is not None
    again = [e for r in plan.fused_runs()
             for e in hop_launch_shapes(r["prep"], r["k"], r["encoded"], r["domains"])]
    for e, f in zip(entries, again):
        assert f["pick"] == e["pick"] == autotune.model_plan_for(
            e["shape"], (e["edges"], e["num_segments"], e["width"]))
        assert bytes(f["plan"]) == bytes(e["pick"].make(e["edges"], e["num_segments"], e["width"]))
        assert math.isfinite(f["est_us"]) and f["est_us"] > 0
    lines = plan._explain_kernels()
    assert all(repr(e["plan"]) in "\n".join(lines) for e in again)
    assert all(line.endswith("us") for line in lines[1:] if not line.endswith(":"))
    assert [d for d in plan.verify(strict=False) if d.code == "V-KERN"] == []
    launched = []
    real = torch_engine.fused_hop

    def spy(*args, plan=None, **kw):
        launched.append(bytes(plan))
        return real(*args, plan=plan, **kw)

    monkeypatch.setattr(torch_engine, "fused_hop", spy)
    plan.execute()
    assert sorted(launched) == sorted(bytes(e["plan"]) for e in entries)
    assert tuner.timed == []


def test_fused_hop_refuses_a_plan_of_the_other_walk():
    keys = torch.tensor([0, 1, 1], dtype=torch.int64)
    w = torch.ones((3, 1))
    msg, idx = torch.ones((2, 40)), torch.tensor([0, 1, 0], dtype=torch.int64)
    with pytest.raises(ValueError, match="takes a GatherPlan"):
        fused_hop(keys, w, [msg], [idx], 2, plan=ops.walk_plan(3, 2, 40))
    with pytest.raises(ValueError, match="takes a WalkPlan"):
        fused_hop(keys, w, [], [], 2, plan=ops.gather_plan(3, 2, 40))
    want = fused_hop(keys, w, [msg], [idx], 2)
    got = fused_hop(keys, w, [msg], [idx], 2, plan=ops.make_gather_plan(3, 2, 40, rows=1))
    assert torch.equal(got, want)
