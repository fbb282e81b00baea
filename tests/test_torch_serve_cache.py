"""The serving layer's LRU and prepared-plan cache
(``repro_torch.serve.cache``); counterparts of ``tests/test_serve_cache.py``.

The port has no jit and no program memo, so the reference's two
memo-bounding cases become one: a plan the LRU evicts takes its
``Prepared`` and device views with it."""
import gc
import threading
import weakref

import pytest

from repro.serve.cache import PlanCache as JPlanCache
from repro_torch.api import Count, Q, Sum, TorchChannelEngine
from repro_torch.core import torch_engine
from repro_torch.serve.batcher import fusion_key
from repro_torch.serve.cache import LRUCache, PlanCache, plan_shape_key
from test_torch_planner import assert_identical
from test_torch_serve import J_QUERIES, TIMEOUT, serve_dbs

CPU = TorchChannelEngine(device="cpu")


@pytest.fixture(scope="module")
def dbs():
    return serve_dbs()


@pytest.fixture(scope="module")
def db(dbs):
    return dbs[1]


def base_q():
    return Q.over("R1", "R2", "R3", "R4").group_by("R1.g1").agg(n=Count())


# ----------------------------------------------------------------------
# LRUCache
# ----------------------------------------------------------------------


def test_lru_evicts_coldest_and_counts():
    c = LRUCache(2, name="t")
    c.put("a", 1)
    c.put("b", 2)
    assert c.get("a") == 1  # refresh a: b is now coldest
    c.put("c", 3)  # evicts b
    assert "b" not in c and "a" in c and "c" in c
    assert c.get("b") is None
    s = c.stats.snapshot()
    assert s == {"hits": 1, "misses": 1, "evictions": 1, "inserts": 3}


def test_lru_put_existing_key_refreshes_without_insert():
    c = LRUCache(2, name="t")
    c.put("a", 1)
    c.put("b", 2)
    c.put("a", 10)  # overwrite refreshes recency, no new insert
    c.put("c", 3)  # so b (coldest) goes
    assert c.get("a") == 10 and "b" not in c
    assert c.stats.inserts == 3 and c.stats.evictions == 1


def test_lru_setdefault_counts_hit_only_when_present():
    c = LRUCache(4, name="t")
    assert c.setdefault("k", 1) == 1
    assert c.setdefault("k", 2) == 1
    assert c.stats.hits == 1 and c.stats.inserts == 1


def test_get_or_create_builds_once_under_contention():
    c = LRUCache(8, name="t")
    builds = []
    start = threading.Barrier(8, timeout=TIMEOUT)

    def factory():
        builds.append(1)
        return "value"

    results = []

    def worker():
        start.wait()
        results.append(c.get_or_create("k", factory))

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in threads)
    assert results == ["value"] * 8
    assert len(builds) == 1  # the herd shared one factory run
    assert c.stats.misses == 1 and c.stats.hits == 7


def test_get_or_create_failure_releases_the_latch():
    c = LRUCache(8, name="t")
    calls = []

    def boom():
        calls.append(1)
        raise RuntimeError("factory failed")

    with pytest.raises(RuntimeError):
        c.get_or_create("k", boom)
    # a later caller retries instead of deadlocking on the dead latch
    assert c.get_or_create("k", lambda: 42) == 42
    assert len(calls) == 1


# ----------------------------------------------------------------------
# plan_shape_key cacheability
# ----------------------------------------------------------------------


def test_shape_key_stable_and_generation_scoped():
    k1 = plan_shape_key(base_q(), generation=0)
    k2 = plan_shape_key(base_q(), generation=0)
    assert k1 is not None and k1 == k2
    assert plan_shape_key(base_q(), generation=1) != k1


def test_shape_key_distinguishes_aggregates_and_options(db):
    q = base_q()
    assert plan_shape_key(q) != plan_shape_key(
        Q.over("R1", "R2", "R3", "R4").group_by("R1.g1").agg(n=Sum("R2.w"))
    )
    assert plan_shape_key(q) != plan_shape_key(q.engine("jax"))
    assert plan_shape_key(q) != plan_shape_key(q.stats(False))
    assert plan_shape_key(q) != plan_shape_key(q.memory_budget(1 << 20))
    # a shard count is keyed, as the reference keys it; the cache compiles
    # it (every rank of a mesh lane compiles through its own cache), and
    # only its execute is a collective call, which needs a group of 2
    assert plan_shape_key(q.mesh(2)) != plan_shape_key(q)
    assert plan_shape_key(q.mesh(2))[9] == 2
    pc = PlanCache(8, engine=CPU)
    plan = pc.lookup(q.mesh(2), db)
    assert pc.stats.compiles == 1 and plan.mesh == 2
    with pytest.raises(ValueError, match="needs a process group of 2 ranks"):
        plan.execute()
    assert pc.lookup(q.mesh(2), db) is plan
    assert pc.stats.compiles == 1


def test_shape_key_keeps_the_fused_option(db):
    """``.fused`` is keyed, after the reference's fields: a fused spec is
    never served an unfused cached plan or the reverse.  The bits agree;
    the kernels launched do not."""
    q = base_q()
    keys = [plan_shape_key(s) for s in (q, q.fused(True), q.fused(False))]
    assert len(set(keys)) == 3
    assert keys[0][:-1] == keys[1][:-1] and keys[0][-1] is None and keys[1][-1] is True
    # index 5 stays the bundle, which fusion drops; the option stays, so
    # fused and unfused queries never share a pass
    assert keys[0][5] == (("n", "count", None),)
    assert len({fusion_key(k) for k in keys}) == 3
    pc = PlanCache(8, engine=CPU)
    launched = []
    real = torch_engine.fused_hop

    def spy(*args, **kwargs):
        launched.append(1)
        return real(*args, **kwargs)

    torch_engine.fused_hop = spy
    try:
        unfused = pc.lookup(q.fused(False), db).execute()
        n_unfused = len(launched)
        fused = pc.lookup(q.fused(True), db).execute()
    finally:
        torch_engine.fused_hop = real
    assert pc.stats.compiles == 2 and pc.stats.lru.hits == 0
    assert n_unfused == 0 and len(launched) > 0
    assert_identical(unfused, fused)


def test_shape_key_keys_declarative_predicates():
    qa = base_q().where("R2", "w", ">", 10)
    qb = base_q().where("R2", "w", ">", 20)
    ka, kb = plan_shape_key(qa), plan_shape_key(qb)
    assert ka is not None and kb is not None and ka != kb


def test_shape_key_rejects_callable_predicates():
    # a lambda's label is just "<lambda>" — two distinct lambdas would
    # collide, so callable-form predicates are uncacheable
    assert plan_shape_key(base_q().where("R2", lambda c: c["w"] > 10)) is None

    def w_positive(cols):
        return cols["w"] > 0

    assert plan_shape_key(base_q().where("R2", w_positive)) is None


def test_shape_key_rejects_engine_instances_and_mesh_objects():
    assert plan_shape_key(base_q().engine(CPU)) is None

    class FakeMesh:
        pass

    assert plan_shape_key(base_q().mesh(FakeMesh())) is None


# ----------------------------------------------------------------------
# PlanCache
# ----------------------------------------------------------------------


def test_plan_cache_warm_hit_skips_compile(db, dbs):
    pc = PlanCache(8, engine=CPU)
    p1 = pc.lookup(base_q(), db)
    p2 = pc.lookup(base_q(), db)
    assert p1 is p2  # the very same compiled plan object
    s = pc.stats.snapshot()
    assert s["compiles"] == 1 and s["hits"] == 1 and s["bypasses"] == 0
    # the cached plan runs on the cache's engine, and answers as the JAX
    # package's cached plan does on engine("jax")
    assert p2.engine is CPU
    want = JPlanCache(8).lookup(J_QUERIES["count"], dbs[0]).execute()
    assert_identical(want, p2.execute())


def test_plan_cache_generation_invalidates(db):
    pc = PlanCache(8, engine=CPU)
    pc.lookup(base_q(), db, generation=0)
    pc.lookup(base_q(), db, generation=1)
    assert pc.stats.compiles == 2 and pc.stats.lru.hits == 0


def test_plan_cache_bypasses_uncacheable(db):
    pc = PlanCache(8, engine=CPU)
    q = base_q().where("R2", lambda c: c["w"] > 0)
    r1, r2 = pc.lookup(q, db), pc.lookup(q, db)
    assert r1 is not r2  # compiled fresh both times
    assert pc.stats.bypasses == 2 and pc.stats.compiles == 2
    assert len(pc) == 0


def test_plan_cache_compiles_torch_specs_with_its_engine(db):
    """The substitution is the cache's: a spec whose engine is the name
    ``"torch"`` compiles with the cache's engine, an engine instance
    keeps its own, and a cache needs an engine."""
    with pytest.raises(TypeError):
        PlanCache(8)
    pc = PlanCache(8, engine=CPU)
    assert pc.lookup(base_q(), db).engine is CPU
    own = TorchChannelEngine(device="cpu", mode="sparse")
    assert pc.lookup(base_q().engine(own), db).engine is own


def test_evicting_a_plan_frees_its_prepared_and_device_views(db):
    """The port's device views hang off each cached plan's ``Prepared``;
    the LRU bounds them: once a plan is evicted and nothing else holds
    it, its ``Prepared`` and every device view go with it."""
    pc = PlanCache(1, engine=TorchChannelEngine(device="cpu", mode="sparse"))
    plan = pc.lookup(base_q(), db)
    plan.execute()
    prep = weakref.ref(plan.prep)
    views = [weakref.ref(v.keys) for v in plan.prep.device_views.values()]
    assert views, "the sparse walk memoized no device view"
    del plan
    gc.collect()
    assert prep() is not None  # the cache still holds the plan
    pc.lookup(base_q().agg(s=Sum("R2.w")), db)  # evicts the first plan
    gc.collect()
    assert pc.stats.lru.evictions == 1
    assert prep() is None
    assert all(v() is None for v in views)
