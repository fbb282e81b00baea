"""The port's query server (``repro_torch.serve``) against the JAX
package's (``repro.serve``): concurrent clients, the warm plan cache,
fusion, channel merges, sessions, TCP, and the device rule.

Every port server here runs on ``device="cpu"``, where the kernel
wrappers take their plain versions; its answers are held against
``repro.serve.JoinAggServer`` serving the same specs with
``.engine("jax")``, bit for bit (the measure ``w`` is an integer below
2**24, so tolerance 0), and against a solo ``Plan.execute()`` of the
same spec on the same device.  Counterparts of ``tests/test_serve.py``.
"""
import json
import os
import socket
import subprocess
import sys
import threading
from concurrent.futures import Future
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.api import Avg as JAvg
from repro.api import Count as JCount
from repro.api import Max as JMax
from repro.api import Min as JMin
from repro.api import Q as JQ
from repro.api import Sum as JSum
from repro.data.synth import chain as j_chain
from repro.serve.server import JoinAggServer as JServer
from repro_torch.api import Avg, Count, Max, Min, Q, Sum, TorchChannelEngine
from repro_torch.relational.relation import Database, Relation
from repro_torch.serve import batcher
from repro_torch.serve.batcher import BatchStats, _Pending, run_group
from repro_torch.serve.server import JoinAggServer, serve_tcp
from repro_torch.serve.session import Session, connect
from test_torch_planner import assert_identical

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 120  # seconds for any one result or join; nothing may hang the suite
CPU = TorchChannelEngine(device="cpu")


def serve_dbs(n: int = 300, seed: int = 0):
    """The reference tests' C1 chain with an integer measure ``w`` on R2:
    the JAX package's ``Database`` and the port's, from the same columns."""
    jdb, _ = j_chain("C1", n, seed=seed)
    rng = np.random.default_rng(seed + 1)
    jdb.add(jdb["R2"].with_column("w", rng.integers(1, 50, jdb["R2"].num_rows)))
    cols = {r: dict(jdb[r].columns) for r in ("R1", "R2", "R3", "R4")}
    return jdb, Database.from_mapping(cols)


def shapes(Q, Count, Sum, Avg, Min, Max) -> dict:
    """The reference tests' query shapes, built with either package's
    classes."""
    base = Q.over("R1", "R2", "R3", "R4")
    return {
        "count": base.group_by("R1.g1").agg(n=Count()),
        "sum": base.group_by("R1.g1").agg(total=Sum("R2.w")),
        "multi": base.group_by("R1.g1").agg(
            n=Count(), total=Sum("R2.w"), mean=Avg("R2.w")
        ),
        "minmax": base.group_by("R4.g2").agg(lo=Min("R2.w"), hi=Max("R2.w")),
        "filtered": base.where("R2", "w", ">", 25).group_by("R1.g1").agg(n=Count()),
        "two_group": base.group_by("R1.g1", "R4.g2").agg(n=Count()),
    }


QUERIES = shapes(Q, Count, Sum, Avg, Min, Max)
J_QUERIES = {k: q.engine("jax") for k, q in shapes(JQ, JCount, JSum, JAvg, JMin, JMax).items()}


@pytest.fixture(scope="module")
def dbs():
    return serve_dbs()


@pytest.fixture(scope="module")
def db(dbs):
    return dbs[1]


@pytest.fixture(scope="module")
def jax_answers(dbs):
    """Each shape as the JAX package's server answers it on
    ``engine("jax")``."""
    with JServer(dbs[0], workers=2, fuse=False) as srv:
        return {k: srv.query(q) for k, q in J_QUERIES.items()}


def solo(q, db):
    return q.engine(CPU).plan(db).execute()


def as_rows(res):
    return {n: res.to_dict(n) for n in res.agg_names}


def test_concurrent_mixed_queries_match_oracles(db, jax_answers):
    oracles = {k: solo(q, db) for k, q in QUERIES.items()}
    for k, want in jax_answers.items():
        assert_identical(want, oracles[k])
    failures = []
    with JoinAggServer(db, device="cpu", workers=6, fusion_window=0.002) as srv:
        def client(i):
            names = list(QUERIES)
            for j in range(6):
                name = names[(i + j) % len(names)]
                got = srv.submit(QUERIES[name]).result(timeout=TIMEOUT)
                try:
                    assert_identical(oracles[name], got)
                except AssertionError:
                    failures.append((i, name))

        threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert not any(t.is_alive() for t in threads)
    assert not failures


def test_warm_cache_skips_prepare_and_compile(db):
    q = QUERIES["count"]
    with JoinAggServer(db, device="cpu", workers=2, fuse=False) as srv:
        r1 = srv.query(q)
        stats1 = srv.plan_cache.stats.snapshot()
        r2 = srv.query(q)
        stats2 = srv.plan_cache.stats.snapshot()
    assert_identical(r1, r2)
    assert stats1["compiles"] == 1
    assert stats2["compiles"] == 1  # the repeat did NOT compile
    assert stats2["hits"] == stats1["hits"] + 1


def test_identical_shape_burst_fuses_to_one_execution(db, jax_answers):
    q = QUERIES["sum"]
    with JoinAggServer(db, device="cpu", workers=4, fusion_window=0.25) as srv:
        futs = [srv.submit(q) for _ in range(6)]
        results = [f.result(timeout=TIMEOUT) for f in futs]
        fusion = srv._batcher.stats.snapshot()
        compiles = srv.plan_cache.stats.compiles
    for r in results:
        assert_identical(jax_answers["sum"], r)
    assert fusion["shared_identical"] == 6
    assert fusion["batches"] == 1
    assert compiles == 1


def test_channel_merge_demuxes_per_client(db, dbs):
    qa = Q.over("R1", "R2", "R3", "R4").group_by("R1.g1").agg(n=Count())
    qb = Q.over("R1", "R2", "R3", "R4").group_by("R1.g1").agg(
        total=Sum("R2.w"), lo=Min("R2.w")
    )
    jb = JQ.over("R1", "R2", "R3", "R4").group_by("R1.g1").agg(
        total=JSum("R2.w"), lo=JMin("R2.w")
    ).engine("jax")
    with JoinAggServer(db, device="cpu", workers=4, fusion_window=0.25) as srv:
        fa, fb = srv.submit(qa), srv.submit(qb)
        ra, rb = fa.result(timeout=TIMEOUT), fb.result(timeout=TIMEOUT)
        fusion = srv._batcher.stats.snapshot()
    assert ra.agg_names == ("n",)
    assert_identical(solo(qa, db), ra)
    assert set(rb.agg_names) == {"total", "lo"}
    assert_identical(solo(qb, db), rb)
    assert_identical(jb.plan(dbs[0]).execute(), rb)
    assert fusion["merged_channels"] == 2 and fusion["batches"] == 1


def test_channel_merge_on_a_fractional_measure(db):
    """A merged bundle has more channels than each client's, so the path
    choice may differ from a solo plan's; on a fractional measure the
    demuxed SUM is then held to the solo one within 1e-5 relative (the
    port's tolerance for fractional float32 SUM), COUNT exactly."""
    rng = np.random.default_rng(5)
    r2 = db["R2"]
    fdb = Database(dict(db.relations)).add(r2.with_column("f", rng.random(r2.num_rows) * 10))
    qa = Q.over("R1", "R2", "R3", "R4").group_by("R1.g1").agg(n=Count())
    qb = Q.over("R1", "R2", "R3", "R4").group_by("R1.g1").agg(s=Sum("R2.f"), m=Avg("R2.f"))
    with JoinAggServer(fdb, device="cpu", workers=2, fusion_window=0.25) as srv:
        fa, fb = srv.submit(qa), srv.submit(qb)
        ra, rb = fa.result(timeout=TIMEOUT), fb.result(timeout=TIMEOUT)
        assert srv._batcher.stats.snapshot()["merged_channels"] == 2
    assert_identical(solo(qa, fdb), ra)
    want = solo(qb, fdb)
    for c in want.group_names:
        np.testing.assert_array_equal(rb.column(c), want.column(c))
    for c in ("s", "m"):
        np.testing.assert_allclose(rb.column(c), want.column(c), rtol=1e-5)


def test_uncacheable_query_runs_solo_and_correct(db):
    q = Q.over("R1", "R2", "R3", "R4").where("R2", lambda c: c["w"] > 25).group_by(
        "R1.g1"
    ).agg(n=Count())
    with JoinAggServer(db, device="cpu", workers=2) as srv:
        got = srv.query(q)
        stats = srv.plan_cache.stats.snapshot()
        fusion = srv._batcher.stats.snapshot()
    assert_identical(solo(QUERIES["filtered"], db), got)
    assert stats["bypasses"] == 1 and fusion["solo"] == 1


def test_register_bumps_generation_and_serves_new_data(db):
    q = QUERIES["count"]
    with JoinAggServer(db, device="cpu", workers=2, fuse=False) as srv:
        before = srv.query(q)
        assert srv.plan_cache.stats.compiles == 1
        # double R1: every group count doubles
        r1 = srv.db["R1"]
        doubled = Relation(
            "R1", {a: np.concatenate([c, c]) for a, c in r1.columns.items()}
        )
        gen = srv.register("R1", doubled)
        after = srv.query(q)
        assert srv.plan_cache.stats.compiles == 2  # old plan unreachable
        srv.bump_stats()
        srv.query(q)
        assert srv.plan_cache.stats.compiles == 3  # statistics bump invalidates too
    assert gen == 1
    want = {k: 2 * v for k, v in before.to_dict("n").items()}
    assert after.to_dict("n") == want


def test_register_deprecates_raw_mappings():
    with JoinAggServer(device="cpu", workers=1, fuse=False) as srv:
        with pytest.warns(DeprecationWarning, match="eager"):
            srv.register("R", {"a": [1, 2, 3]})
        srv.register("S", Relation("S", {"a": np.arange(3)}))
        assert sorted(srv.db.relations) == ["R", "S"]


def test_torch_engine_queries_served(db, jax_answers):
    """A spec naming the engine ``"torch"`` runs on the server's engine
    and is cacheable; an engine instance bypasses the cache and runs
    solo (counterpart of the reference's ``engine("jax")`` case)."""
    named = QUERIES["count"].engine("torch")
    instance = QUERIES["count"].engine(TorchChannelEngine(device="cpu", mode="sparse"))
    with JoinAggServer(db, device="cpu", workers=2) as srv:
        assert_identical(jax_answers["count"], srv.query(named))
        assert_identical(jax_answers["count"], srv.query(instance))
        pc = srv.plan_cache.stats.snapshot()
        (plan,) = [srv.plan_cache._lru.get(k) for k in srv.plan_cache._lru.keys()]
        stats = srv.stats()
    assert plan.engine is srv.engine and plan.engine.device == torch.device("cpu")
    assert pc["compiles"] == 2 and pc["bypasses"] == 1
    assert stats["device"] == "cpu" and set(stats["kernels"]) >= {"segment_sum", "coo_spmm"}
    assert "jit_cache" not in stats


def test_session_prepared_statement(db, jax_answers):
    with JoinAggServer(db, device="cpu", workers=2, fuse=False) as srv:
        sess = Session(srv)
        stmt = sess.prepare(QUERIES["multi"])
        r1 = stmt.execute()
        r2 = stmt.submit().result(timeout=TIMEOUT)
        assert_identical(jax_answers["multi"], r1)
        assert_identical(r1, r2)
        assert sess.stats.queries == 2
        assert srv.plan_cache.stats.compiles == 1


def test_tcp_roundtrip_register_query_and_errors(db, jax_answers):
    with JoinAggServer(db, device="cpu", workers=2) as srv:
        tcp, _ = serve_tcp(srv)
        host, port = tcp.server_address
        try:
            with connect(host, port) as c:
                assert c.ping()
                res = c.query({
                    "relations": ["R1", "R2", "R3", "R4"],
                    "where": [["R2", "w", ">", 25]],
                    "group_by": ["R1.g1"],
                    "aggs": {"n": {"kind": "count"}},
                })
                assert as_rows(res) == as_rows(jax_answers["filtered"])
                assert as_rows(res) == as_rows(srv.query(QUERIES["filtered"]))
                with pytest.raises(RuntimeError, match="unknown op"):
                    c.call({"op": "frobnicate"})
                with pytest.raises(RuntimeError):  # bad query still answers
                    c.query({"relations": ["NoSuch"], "group_by": []})
                gen = c.register("R9", {"a": np.arange(4)})
                assert gen == 1 and "R9" in srv.db.relations
                assert c.ping()  # connection survived the errors
                stats = c.server_stats()
                assert stats["plan_cache"]["compiles"] >= 1 and stats["device"] == "cpu"
        finally:
            tcp.shutdown()
            tcp.server_close()


def _raw_call(host, port, req: dict) -> dict:
    with socket.create_connection((host, port), timeout=TIMEOUT) as s:
        s.sendall((json.dumps(req) + "\n").encode())
        return json.loads(s.makefile("rb").readline())


def test_wire_refuses_foreign_engines_and_meshes(db):
    """``"engine": "jax"`` and ``"mesh": 2`` come back as ``{"ok": false}``
    responses (the mesh refused by a server not started on a process
    group, before it compiles, with the way to start one); the server
    keeps answering."""
    q = {"relations": ["R1", "R2", "R3", "R4"], "group_by": ["R1.g1"],
         "aggs": {"n": {"kind": "count"}}}
    with JoinAggServer(db, device="cpu", workers=2) as srv:
        tcp, _ = serve_tcp(srv)
        host, port = tcp.server_address
        try:
            jax_resp = _raw_call(host, port, {"op": "query", "q": {**q, "engine": "jax"}})
            mesh_resp = _raw_call(host, port, {"op": "query", "q": {**q, "mesh": 2}})
            ok_resp = _raw_call(host, port, {"op": "query", "q": {**q, "engine": "torch"}})
        finally:
            tcp.shutdown()
            tcp.server_close()
    assert jax_resp["ok"] is False and "jax" in jax_resp["error"]
    assert mesh_resp["ok"] is False and "UnsupportedPlanOption" in mesh_resp["error"]
    assert "serve_mesh" in mesh_resp["error"]
    assert ok_resp["ok"] is True


def test_closed_server_rejects_queries(db):
    srv = JoinAggServer(db, device="cpu", workers=2)
    srv.close()
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(QUERIES["count"])


def test_cuda_server_raises_without_a_card(db, monkeypatch):
    """``device="cuda"`` (the default) raises at construction when no card
    is present, before any thread starts; nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        JoinAggServer(db)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        JoinAggServer(db, device="cuda", workers=2)
    assert threading.active_count() == before


class _Plan:
    def __init__(self, fail=None, result="ok"):
        self.fail, self.result = fail, result

    def execute(self):
        if self.fail is not None:
            raise self.fail
        return self.result


@pytest.mark.parametrize("failure", ["planner rejects the union", "merged execute fails"])
def test_merge_falls_back_only_on_a_planner_rejection(failure):
    """A union the planner refuses (a ``ValueError`` from compile) runs
    each query solo; an error while the merged plan executes reaches
    every future, with no solo retry."""
    qa, qb = QUERIES["count"], QUERIES["sum"]
    solo_runs = []

    def lookup(spec):
        merged = any(n.startswith("a0__") for n, _ in spec.aggs)
        if not merged:
            solo_runs.append(spec)
            return _Plan(result=spec)
        if failure == "planner rejects the union":
            raise ValueError("aggregates measure two different columns")
        return _Plan(fail=RuntimeError("segment_sum: CUDA launch failed"))

    items = [_Pending(q, ("key", i), Future()) for i, q in enumerate((qa, qb))]
    stats = BatchStats()
    run_group(items, lookup, stats)
    if failure == "planner rejects the union":
        assert [it.future.result(timeout=TIMEOUT) for it in items] == [qa, qb]
        assert stats.snapshot()["solo"] == 2 and len(solo_runs) == 2
    else:
        for it in items:
            with pytest.raises(RuntimeError, match="launch failed"):
                it.future.result(timeout=TIMEOUT)
        assert stats.snapshot()["solo"] == 0 and solo_runs == []


def test_planner_rejected_merge_serves_each_query_solo(db, jax_answers):
    """Two bundles measuring different columns of R2 cannot share one
    pass; the server answers each on its own."""
    qa = QUERIES["sum"]
    qb = Q.over("R1", "R2", "R3", "R4").group_by("R1.g1").agg(s1=Sum("R2.p1"))
    with JoinAggServer(db, device="cpu", workers=2, fusion_window=0.25) as srv:
        fa, fb = srv.submit(qa), srv.submit(qb)
        ra, rb = fa.result(timeout=TIMEOUT), fb.result(timeout=TIMEOUT)
        fusion = srv._batcher.stats.snapshot()
    assert fusion["solo"] == 2 and fusion["merged_channels"] == 0
    assert_identical(jax_answers["sum"], ra)
    assert_identical(solo(qb, db), rb)


def test_batcher_fails_a_group_the_pool_refuses():
    """A dispatch that raises (the pool is shut down) fails the group's
    futures instead of leaving them pending."""
    def refuse(items):
        raise RuntimeError("cannot schedule new futures after shutdown")

    b = batcher.FusionBatcher(refuse, window=0.0)
    try:
        fut = Future()
        b.submit(_Pending(QUERIES["count"], ("k",), fut))
        with pytest.raises(RuntimeError, match="after shutdown"):
            fut.result(timeout=TIMEOUT)
    finally:
        b.close()


def test_launch_serve_smoke_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke", "--device", "cpu",
         "--scale", "2000"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "serve-smoke OK" in proc.stdout and "device cpu" in proc.stdout
