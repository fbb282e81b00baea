"""The port's legacy operator entry points against the JAX package's, on
the same numpy inputs made from a seed.

``repro_torch.core.operator.join_agg`` (a shim over the port's planner)
on ``TorchChannelEngine(device="cpu")`` against ``repro``'s
``join_agg(engine="jax")`` in its CPU auto mode, with ``stream=`` and
``memory_budget=`` too; ``estimate_plan`` and ``choose_root`` against the
reference's (root, peak bytes, failure reasons); ``ghd_join_agg`` on the
cyclic catalog against the reference's ``engine="tensor"``, alone, with
a precompiled plan, a budget, a stream tile and a local mesh of one.
Every measure is an integer, so answers are equal dicts.
"""
import numpy as np
import pytest
import torch

from repro.core import operator as joperator
from repro.core.operator import UnsupportedPlanOption as JUnsupported
from repro.core.query import JoinAggQuery as JQuery
from repro.data import queries as jqueries
from repro.data import synth as jsynth
from repro.ghd import rewrite as jrewrite
from repro.relational.relation import Database as JDatabase
from repro_torch.api import RefChannelEngine, TorchChannelEngine, resolve_engine
from repro_torch.core import join_agg
from repro_torch.core import operator
from repro_torch.core.operator import UnsupportedPlanOption
from repro_torch.core.query import JoinAggQuery
from repro_torch.data import queries as port_queries
from repro_torch.data import synth as port_synth
from repro_torch.ghd import compile_ghd, ghd_join_agg
from repro_torch.relational.relation import Database

CPU = TorchChannelEngine(device="cpu")
ACYCLIC = {**jqueries.REAL, **jqueries.SKEWED}
SYNTH = ("S1", "C1", "B1")


def catalog(name: str, n: int, seed: int = 0):
    if name in SYNTH:
        jdb, jq = jsynth.make(name, n, seed=seed)
        db, q = port_synth.make(name, n, seed=seed)
        return jdb, jq, db, q
    gen = {**ACYCLIC, **jqueries.CYCLIC}[name]
    jdb, jq = gen(n, seed=seed)
    db, q = getattr(port_queries, gen.__name__)(n, seed=seed)
    return jdb, jq, db, q


def options(jq, jdb) -> dict:
    """The default plan, an explicit stream tile over the first group
    attribute, and a budget small enough to auto-stream."""
    attr = jq.group_by[0][1]
    dom = len(np.unique(jdb[jq.group_by[0][0]].columns[attr]))
    return {"default": {}, "stream": {"stream": (attr, max(1, dom // 3))},
            "budget": {"memory_budget": 4096}}


@pytest.mark.parametrize("option", ["default", "stream", "budget"])
@pytest.mark.parametrize("name", list(ACYCLIC))
def test_join_agg_matches_reference(name, option):
    jdb, jq, db, q = catalog(name, 600)
    kw = options(jq, jdb)[option]
    want = joperator.join_agg(jq, jdb, engine="jax", **kw)
    got = join_agg(q, db, engine=CPU, **kw)
    assert want and got == want


def test_join_agg_on_a_cyclic_query_matches_reference():
    jdb, jq, db, q = catalog("TRIANGLE", 300)
    assert join_agg(q, db, engine=CPU) == joperator.join_agg(jq, jdb, engine="jax")


def test_join_agg_engines():
    _, _, db, q = catalog("DBLP", 100)
    for name in ("tensor", "jax"):
        with pytest.raises(ValueError, match=f"unknown engine {name!r}"):
            join_agg(q, db, engine=name)
    # "ref" resolves to the port's paper-faithful engine, on CUDA by default
    assert resolve_engine("ref").name == "ref"
    assert join_agg(q, db, engine=RefChannelEngine(device="cpu")) == join_agg(q, db, engine=CPU)


def test_join_agg_runs_on_the_cpu_only_when_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, db, q = catalog("DBLP", 100)
    with pytest.raises(RuntimeError, match=r'TorchChannelEngine\(device="cpu"\)'):
        join_agg(q, db)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ghd_join_agg(*catalog("TRIANGLE", 100)[2:])
    assert join_agg(q, db, engine=CPU)


ROOTED = SYNTH + tuple(ACYCLIC) + tuple(jqueries.CYCLIC)


@pytest.mark.parametrize("name", ROOTED)
def test_choose_root_and_estimate_plan_match_reference(name):
    jdb, jq, db, q = catalog(name, 600 if name not in jqueries.CYCLIC else 300)
    jprep, jpeak = joperator.choose_root(jq, jdb)
    prep, peak = operator.choose_root(q, db)
    assert peak == jpeak
    assert prep.decomposition.root == jprep.decomposition.root
    assert list(prep.decomposition.order) == list(jprep.decomposition.order)
    for root in (None,) + tuple(jq.relations):
        try:
            want = joperator.estimate_plan(jq, jdb, root=root)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                operator.estimate_plan(q, db, root=root)
            assert str(got.value) == str(e)
            continue
        prep, peak = operator.estimate_plan(q, db, root=root)
        assert peak == want[1]
        assert prep.decomposition.root == want[0].decomposition.root


def test_choose_root_failure_reasons_match_reference():
    rng = np.random.default_rng(0)
    cols = {"R1": {"g1": rng.integers(0, 3, 20), "j": rng.integers(0, 3, 20)},
            "R2": {"j": rng.integers(0, 3, 20), "g2": rng.integers(0, 3, 20)}}
    groups = (("R1", "j"), ("R2", "g2"))
    with pytest.raises(ValueError, match="no valid group-relation root") as want:
        joperator.choose_root(JQuery(("R1", "R2"), groups), JDatabase.from_mapping(cols))
    with pytest.raises(ValueError, match="no valid group-relation root") as got:
        operator.choose_root(JoinAggQuery(("R1", "R2"), groups), Database.from_mapping(cols))
    assert str(got.value) == str(want.value).replace("repro.api", "repro_torch.api")
    assert str(got.value).count("participates in a join") == 2


@pytest.mark.parametrize("option", ["default", "plan", "stream", "budget", "mesh"])
@pytest.mark.parametrize("name", list(jqueries.CYCLIC))
def test_ghd_join_agg_matches_reference(name, option):
    jdb, jq, db, q = catalog(name, 300)
    plan = compile_ghd(q, db)
    # the derived query groups by the bag's copy of the attribute
    attr = plan.prepared.group_attrs[0][1]
    tile = max(1, plan.prepared.dicts[attr].size // 3)
    budget = operator.peak_message_bytes(plan.prepared) // 3  # streams in tiles
    kw = {"stream": {"stream": (attr, tile)}, "budget": {"memory_budget": budget}}.get(option, {})
    want = jrewrite.ghd_join_agg(jq, jdb, engine="tensor", **kw)
    kw = {"plan": {"plan": plan}, "mesh": {"mesh": 1}}.get(option, kw)
    got = ghd_join_agg(q, db, engine=CPU, **kw)
    assert want and got == want


def test_ghd_join_agg_refuses_a_stream_on_a_mesh():
    jdb, jq, db, q = catalog("TRIANGLE", 100)
    stream = (jq.group_by[0][1], 2)
    with pytest.raises(JUnsupported, match="explicit stream tiling cannot run on a device mesh"):
        jrewrite.ghd_join_agg(jq, jdb, engine="jax", mesh=1, stream=stream)
    with pytest.raises(UnsupportedPlanOption,
                       match="explicit stream tiling cannot run on a device mesh"):
        ghd_join_agg(q, db, engine=CPU, mesh=1, stream=stream)
