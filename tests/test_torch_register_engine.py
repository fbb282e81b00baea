"""``register_engine`` and the ``Engine`` protocol in the port, against
the JAX package's.

Counterparts of ``tests/test_api_plan.py``'s
``test_unknown_engine_lists_registry`` and
``test_legacy_engine_signature_still_executes``, plus one test for each
place where the port assumed its one built-in engine: a registered
engine that has no ``device``, no streaming, no ``fused`` keyword and no
``memory_budget`` keyword must plan, explain, split, serve and refuse
maintenance as the reference does with the same engine.  The legacy
engines wrap ``TorchChannelEngine(device="cpu")`` (the port) and the
``"tensor"`` engine (the reference).
"""
import dataclasses
import json
import socket

import numpy as np
import pytest

import repro.api.engines as j_engines
import repro.api.plan as j_plan_mod
from repro.api import Count as JCount
from repro.api import Q as JQ
from repro.api import Sum as JSum
from repro.api import register_engine as j_register_engine
from repro.api.engines import TensorChannelEngine
from repro.core.operator import UnsupportedPlanOption as JUnsupportedPlanOption
from repro.core.operator import join_agg as j_join_agg
from repro.core.query import JoinAggQuery as JJoinAggQuery
from repro.relational.relation import Database as JDatabase
from repro_torch.api import (
    Count,
    Engine,
    Q,
    Sum,
    TorchChannelEngine,
    UnsupportedPlanOption,
    register_engine,
    resolve_engine,
)
from repro_torch.api import engines
from repro_torch.api import plan as plan_mod
from repro_torch.core.operator import join_agg
from repro_torch.core.query import JoinAggQuery
from repro_torch.data.queries import skewed_chain_like
from repro_torch.planner.split import execute_split
from repro_torch.relational.relation import Database
from repro_torch.serve import wire
from repro_torch.serve.cache import plan_shape_key
from repro_torch.serve.server import JoinAggServer, serve_tcp
from repro_torch.serve.session import connect

TIMEOUT = 120
CPU = TorchChannelEngine(device="cpu")
GROUPS = (("R1", "g1"), ("R3", "g2"))


@pytest.fixture(autouse=True)
def _registries():
    """Registrations leak into no other test: both registries are put back."""
    saved, j_saved = dict(engines._REGISTRY), dict(j_engines._REGISTRY)
    yield
    engines._REGISTRY.clear()
    engines._REGISTRY.update(saved)
    j_engines._REGISTRY.clear()
    j_engines._REGISTRY.update(j_saved)


class Legacy:
    """An engine written against the 4-argument ``run`` protocol: no
    ``memory_budget``, no ``fused``, no ``device``, no streaming."""

    name = "legacy-torch"
    supports_streaming = False

    def __init__(self, inner=None):
        self.inner = inner or CPU
        self.calls = 0

    def run(self, prep, channels, minmax, stream=None):
        self.calls += 1
        return self.inner.run(prep, channels, minmax, stream)


class JLegacy:
    """The reference's legacy engine, the same shape over ``"tensor"``."""

    name = "legacy-torch"
    supports_streaming = False

    def run(self, prep, channels, minmax, stream=None):
        return TensorChannelEngine().run(prep, channels, minmax, stream)


def chain_cols(n=150, a=5, b=6, seed=0):
    """The reference test's chain R1(g1,p0) ⋈ R2(p0,p1,m) ⋈ R3(p1,g2)."""
    rng = np.random.default_rng(seed)
    return {
        "R1": {"g1": rng.integers(0, a, n), "p0": rng.integers(0, b, n)},
        "R2": {
            "p0": rng.integers(0, b, n),
            "p1": rng.integers(0, b, n),
            "m": rng.integers(1, 20, n),
        },
        "R3": {"p1": rng.integers(0, b, n), "g2": rng.integers(0, a, n)},
    }


def chain_q(Q, Count, Sum):
    return Q.over("R1", "R2", "R3").group_by("R1.g1", "R3.g2").agg(
        n=Count(), s=Sum("R2.m")
    )


def assert_same(got, want):
    assert got.group_names == want.group_names and got.agg_names == want.agg_names
    assert got.num_rows == want.num_rows > 0
    for col in want.group_names + want.agg_names:
        assert np.array_equal(got.column(col), want.column(col)), col


def test_engine_and_register_engine_are_exported():
    import repro_torch.api as api

    for name in ("Engine", "register_engine", "resolve_engine"):
        assert name in api.__all__
    assert isinstance(CPU, Engine) and isinstance(Legacy(), Engine)
    assert not isinstance(object(), Engine)
    assert resolve_engine("torch") is engines._REGISTRY["torch"]
    assert resolve_engine(CPU) is CPU


def test_unknown_engine_lists_registry():
    db = Database.from_mapping(chain_cols())
    with pytest.raises(ValueError, match=r"unknown engine 'nope'; registered: \['ref', 'torch'\]"):
        Q.over("R1", "R2", "R3").group_by("R1.g1").engine("nope").plan(db)
    assert resolve_engine("torch").name == "torch"

    class Custom:
        name = "custom-null"
        supports_streaming = False

        def run(self, prep, channels, minmax, stream=None, memory_budget=None):
            raise NotImplementedError

    custom = Custom()
    assert register_engine(custom) is custom
    assert resolve_engine("custom-null") is custom
    with pytest.raises(ValueError, match=r"registered: \['custom-null', 'ref', 'torch'\]"):
        resolve_engine("nope")


def test_legacy_engine_signature_still_executes():
    """A user engine written against the 4-argument ``run`` protocol (no
    ``memory_budget`` keyword) keeps executing: the planner only passes
    the keyword to engines whose signature takes it."""
    legacy = register_engine(Legacy())
    j_register_engine(JLegacy())
    cols = chain_cols()
    db, jdb = Database.from_mapping(cols), JDatabase.from_mapping(cols)
    q = JoinAggQuery(("R1", "R2", "R3"), GROUPS)
    got = Q.from_query(q).engine("legacy-torch").plan(db).execute()
    assert legacy.calls == 1
    assert got.to_dict() == join_agg(q, db, engine=CPU)
    jq = JJoinAggQuery(("R1", "R2", "R3"), GROUPS)
    want = JQ.from_query(jq).engine("legacy-torch").plan(jdb).execute()
    assert got.to_dict() == want.to_dict() == j_join_agg(jq, jdb, engine="tensor")
    # the legacy entry point resolves the name too
    assert join_agg(q, db, engine="legacy-torch") == got.to_dict()
    assert legacy.calls == 2


def test_an_engine_without_a_device_compiles_and_explains():
    register_engine(Legacy())
    db = Database.from_mapping(chain_cols())
    plan = chain_q(Q, Count, Sum).engine("legacy-torch").plan(db)
    ref = chain_q(Q, Count, Sum).engine(CPU).plan(db)
    assert not hasattr(plan.engine, "device")
    for actuals in (False, True):
        text = plan.explain(actuals=actuals)
        assert "(engine=legacy-torch)" in text
        assert text == ref.explain(actuals=actuals).replace(
            "(engine=torch)", "(engine=legacy-torch)"
        )
    assert "actual" in plan.explain(actuals=True)
    assert plan.verify(strict=False) == ref.verify(strict=False)
    assert_same(plan.execute(), ref.execute())


@pytest.mark.parametrize("option", ["stream", "memory_budget"])
def test_streaming_options_refused_on_an_engine_without_streaming(option):
    register_engine(Legacy())
    j_register_engine(JLegacy())
    cols = chain_cols()
    db, jdb = Database.from_mapping(cols), JDatabase.from_mapping(cols)
    q = chain_q(Q, Count, Sum).engine("legacy-torch")
    jq = chain_q(JQ, JCount, JSum).engine("legacy-torch")
    if option == "stream":
        q, jq = q.stream("g1", 2), jq.stream("g1", 2)
    else:
        q, jq = q.memory_budget(1 << 20), jq.memory_budget(1 << 20)
    with pytest.raises(JUnsupportedPlanOption, match="does not support the stream/memory_budget"):
        jq.plan(jdb)
    with pytest.raises(UnsupportedPlanOption, match="does not support the stream/memory_budget"):
        q.plan(db)
    # the torch engine streams
    assert chain_q(Q, Count, Sum).engine(CPU).stream("g1", 2).plan(db).execute().num_rows > 0


def test_an_engine_without_streaming_never_auto_streams(monkeypatch):
    """Past the memory budget the torch engine's plan tiles the group axis;
    an engine that cannot stream gets the whole plan, as in the reference."""
    legacy = register_engine(Legacy())
    j_register_engine(JLegacy())
    monkeypatch.setattr(plan_mod, "DEFAULT_MEMORY_BUDGET", 1)
    monkeypatch.setattr(j_plan_mod, "DEFAULT_MEMORY_BUDGET", 1)
    cols = chain_cols()
    db, jdb = Database.from_mapping(cols), JDatabase.from_mapping(cols)
    streamed = chain_q(Q, Count, Sum).engine(CPU).plan(db)
    assert streamed.resolved_stream() is not None
    plan = chain_q(Q, Count, Sum).engine("legacy-torch").plan(db)
    assert plan.resolved_stream() is None
    jplan = chain_q(JQ, JCount, JSum).engine("legacy-torch").plan(jdb)
    assert jplan._resolved_stream() is None
    got = plan.execute()
    assert legacy.calls == 1
    assert_same(got, streamed.execute())
    want = jplan.execute()
    for col in want.group_names + want.agg_names:
        assert np.array_equal(got.column(col), want.column(col)), col


def test_a_split_plan_executes_on_an_engine_without_fused():
    """SKEWCHAIN's per-range plan, executed by an engine whose ``run``
    takes no ``fused`` keyword, even where the plan pins ``.fused(True)``."""
    db, q = skewed_chain_like(2000, seed=0)
    plan = Q.from_query(q).engine(CPU).fused(True).plan(db)
    assert plan.split is not None
    want = plan.execute()
    legacy = Legacy()
    on_legacy = dataclasses.replace(plan, engine=legacy)
    assert_same(on_legacy.execute(), want)
    parts = len(plan.split_parts())
    assert legacy.calls == parts > 1
    outs = execute_split(
        plan.split_parts(), legacy, plan.channels, len(plan.prep.group_attrs), True
    )
    assert legacy.calls == 2 * parts and len(outs) == 1


def _raw_call(host, port, req: dict) -> dict:
    with socket.create_connection((host, port), timeout=TIMEOUT) as s:
        s.sendall((json.dumps(req) + "\n").encode())
        return json.loads(s.makefile("rb").readline())


def test_a_wire_request_runs_on_a_registered_engine_and_hits_the_cache():
    legacy = register_engine(Legacy())
    db = Database.from_mapping(chain_cols())
    spec = {"relations": ["R1", "R2", "R3"], "group_by": ["R1.g1", "R3.g2"],
            "aggs": {"n": {"kind": "count"}, "s": {"kind": "sum", "measure": "R2.m"}},
            "engine": "legacy-torch"}
    assert wire.q_from_spec(spec).engine_name == "legacy-torch"
    assert plan_shape_key(wire.q_from_spec(spec))[6] == "legacy-torch"
    want = chain_q(Q, Count, Sum).engine(CPU).plan(db).execute()
    with JoinAggServer(db, device="cpu", workers=2) as srv:
        tcp, _ = serve_tcp(srv)
        host, port = tcp.server_address
        try:
            with connect(host, port) as remote:
                first = remote.query(spec)
                assert legacy.calls == 1
                second = remote.query(spec)
                assert legacy.calls == 2
                stats = remote.server_stats()["plan_cache"]
        finally:
            tcp.shutdown()
            tcp.server_close()
        plan = srv.plan_cache.lookup(wire.q_from_spec(spec), db, srv.generation,
                                     srv.stats_generation)
        assert plan.engine is legacy
    assert stats["compiles"] == 1 and stats["hits"] >= 1
    for got in (first, second):
        for col in want.group_names + want.agg_names:
            assert np.array_equal(got.column(col), want.column(col)), col


def test_an_unknown_engine_comes_back_as_an_error_reply():
    db = Database.from_mapping(chain_cols())
    q = {"relations": ["R1", "R2", "R3"], "group_by": ["R1.g1"],
         "aggs": {"n": {"kind": "count"}}}
    with JoinAggServer(db, device="cpu", workers=2) as srv:
        tcp, _ = serve_tcp(srv)
        host, port = tcp.server_address
        try:
            with connect(host, port) as remote:
                with pytest.raises(RuntimeError) as err:
                    remote.query({**q, "engine": "nope"})
                assert "unknown engine 'nope'; registered: ['ref', 'torch']" in str(err.value)
                assert remote.ping()  # the connection was not torn down
                assert remote.query({**q, "engine": "torch"}).num_rows > 0
            resp = _raw_call(host, port, {"op": "query", "q": {**q, "engine": "nope"}})
        finally:
            tcp.shutdown()
            tcp.server_close()
    assert resp["ok"] is False
    assert resp["error"] == "ValueError: unknown engine 'nope'; registered: ['ref', 'torch']"


def test_maintenance_refuses_a_registered_engine_as_the_reference_does():
    register_engine(Legacy())
    j_register_engine(JLegacy())
    cols = chain_cols()
    db, jdb = Database.from_mapping(cols), JDatabase.from_mapping(cols)
    with pytest.raises(JUnsupportedPlanOption,
                       match="maintenance supports the built-in engines .* not 'legacy-torch'"):
        JQ.over("R1", "R2", "R3").group_by("R1.g1").engine("legacy-torch").maintain(jdb)
    with pytest.raises(UnsupportedPlanOption,
                       match=r"maintenance supports the built-in engines \('torch', 'ref'\), "
                             r"not 'legacy-torch'"):
        Q.over("R1", "R2", "R3").group_by("R1.g1").engine("legacy-torch").maintain(db)
    with pytest.raises(UnsupportedPlanOption, match="not 'legacy-torch'"):
        chain_q(Q, Count, Sum).engine("legacy-torch").plan(db).maintain()


def test_the_ghd_shim_runs_on_a_registered_engine_and_refuses_its_mesh():
    from repro_torch.data.queries import triangle_like
    from repro_torch.ghd import ghd_join_agg

    legacy = register_engine(Legacy())
    db, q = triangle_like(300, seed=0)
    want = ghd_join_agg(q, db, engine=CPU)
    assert ghd_join_agg(q, db, engine="legacy-torch") == want and want
    assert legacy.calls == 1
    with pytest.raises(UnsupportedPlanOption, match="'legacy-torch' cannot execute over a mesh"):
        ghd_join_agg(q, db, engine="legacy-torch", mesh=1)
