"""Mutation suite for the port's plan-invariant verifier (DESIGN.md §11),
modelled on ``tests/test_analysis_verify.py``.

One test per ported diagnostic code: each takes a *real* compiled port
plan, breaks exactly the structure the invariant protects, and asserts
the verifier reports that code.  Where the JAX package checks the same
invariant, the same mutation goes into its plan too and both verifiers
must report the same codes at the same sites.  V-KERN checks the port's
own launch shapes (``hop_launch_shapes``) in place of the reference's
TPU tiles.  Every catalog plan verifies clean, statistics on and off,
and ``REPRO_VERIFY=1`` turns a broken compile into an error.
"""
import dataclasses

import numpy as np
import pytest

from repro.api import Avg as JAvg
from repro.api import Count as JCount
from repro.api import Q as JQ
from repro.api import Sum as JSum
from repro.api.engines import Channel as JChannel
from repro.api.engines import MinMaxRequest as JMinMaxRequest
from repro.data.queries import skewed_chain_like as j_skewed_chain_like
from repro.data.queries import triangle_like as j_triangle_like
from repro.relational.relation import Database as JDatabase
from repro_torch.analysis import verify as verify_mod
from repro_torch.analysis.verify import (
    PlanInvariantError,
    check_kernels,
    check_overflow,
    verify_sparse_program,
)
from repro_torch.api import Avg, Count, Min, Q, Sum, TorchChannelEngine
from repro_torch.api.engines import Channel, MinMaxRequest
from repro_torch.core.torch_engine import build_sparse_program
from repro_torch.data.queries import skewed_chain_like, triangle_like
from repro_torch.kernels import ops
from repro_torch.relational.relation import Database
from tests.test_torch_dense import NAMES, catalog

CPU = TorchChannelEngine(device="cpu")


def chain_cols() -> dict:
    rng = np.random.default_rng(7)
    n = 60
    return {
        "R1": {"g1": rng.integers(0, 4, n), "p0": rng.integers(0, 3, n)},
        "R2": {"p0": rng.integers(0, 3, n), "p1": rng.integers(0, 3, n),
               "m": rng.integers(1, 9, n)},
        "R3": {"p1": rng.integers(0, 3, n), "g2": rng.integers(0, 4, n)},
    }


def chain_plans():
    """Fresh acyclic COUNT+SUM+AVG plans, (reference, port)."""
    cols = chain_cols()
    jplan = (
        JQ.over("R1", "R2", "R3").group_by("R1.g1", "R3.g2")
        .agg(n=JCount(), total=JSum("R2.m"), mean=JAvg("R2.m"))
        .engine("jax").plan(JDatabase.from_mapping(cols))
    )
    plan = (
        Q.over("R1", "R2", "R3").group_by("R1.g1", "R3.g2")
        .agg(n=Count(), total=Sum("R2.m"), mean=Avg("R2.m"))
        .engine(CPU).plan(Database.from_mapping(cols))
    )
    return jplan, plan


def skew_plans():
    """Fresh SKEWCHAIN plans at golden scale — they carry a split."""
    jdb, jq = j_skewed_chain_like(600, seed=0)
    db, q = skewed_chain_like(600, seed=0)
    jplan = JQ.from_query(jq).engine("jax").plan(jdb)
    plan = Q.from_query(q).engine(CPU).plan(db)
    assert plan.split is not None and jplan.split is not None
    return jplan, plan


def tri_plans():
    """Fresh cyclic triangle plans — they carry a GHD plan."""
    jdb, jq = j_triangle_like(120, seed=0)
    db, q = triangle_like(120, seed=0)
    jplan = JQ.from_query(jq).engine("jax").plan(jdb)
    plan = Q.from_query(q).engine(CPU).plan(db)
    assert plan.ghd_plan is not None and jplan.ghd_plan is not None
    return jplan, plan


def found(plan) -> set[tuple[str, str]]:
    return {(d.code, d.site) for d in plan.verify(strict=False)}


def mutated(make, mutate, code: str) -> set[tuple[str, str]]:
    """Apply ``mutate`` to both plans of ``make()`` (it returns the plan
    to verify, which may be a replaced copy); both verifiers must report
    the same findings, ``code`` among them."""
    jplan, plan = make()
    jbad, bad = mutate(jplan, "jax"), mutate(plan, "torch")
    want, got = found(jbad), found(bad)
    assert got == want, (got, want)
    assert code in {c for c, _ in got}, got
    return got


# ----------------------------------------------------------------------
# tree + encodings
# ----------------------------------------------------------------------


def test_tree_root_fires_on_dangling_root():
    def mutate(plan, _):
        plan.prep.decomposition.root = "NOPE"
        return plan

    mutated(chain_plans, mutate, "V-TREE-ROOT")


def test_tree_order_fires_on_reversed_order():
    def mutate(plan, _):
        plan.prep.decomposition.order.reverse()
        return plan

    mutated(chain_plans, mutate, "V-TREE-ORDER")


def test_tree_order_fires_on_broken_child_pointer():
    def mutate(plan, _):
        deco = plan.prep.decomposition
        child = next(r for r in deco.order if deco.nodes[r].parent is not None)
        deco.nodes[child].parent = child
        return plan

    mutated(chain_plans, mutate, "V-TREE-ORDER")


def test_tree_leaf_fires_on_groupless_leaf():
    def mutate(plan, _):
        deco = plan.prep.decomposition
        leaf = next(r for r in deco.order if not deco.nodes[r].children and r != deco.root)
        del plan.prep.schema.group_of[leaf]
        return plan

    mutated(chain_plans, mutate, "V-TREE-LEAF")


def test_rip_fires_on_disconnected_attribute():
    def mutate(plan, _):
        rel = plan.prep.schema.relevant
        rel["R1"] = tuple(rel["R1"]) + ("zz",)
        rel["R3"] = tuple(rel["R3"]) + ("zz",)
        return plan

    got = mutated(chain_plans, mutate, "V-RIP")
    assert ("V-RIP", "tree/zz") in got


def test_codes_fires_on_out_of_domain_code():
    def mutate(plan, _):
        plan.prep.encoded["R2"].codes[0, 0] = -5
        return plan

    assert ("V-CODES", "codes/R2") in mutated(chain_plans, mutate, "V-CODES")


def test_codes_fires_on_negative_multiplicity():
    def mutate(plan, _):
        plan.prep.encoded["R1"].count[0] = -1
        return plan

    mutated(chain_plans, mutate, "V-CODES")


# ----------------------------------------------------------------------
# semiring channels
# ----------------------------------------------------------------------


def test_chan_count_fires_when_count_slot_dropped():
    mutated(chain_plans, lambda p, _: dataclasses.replace(p, channels=p.channels[1:]),
            "V-CHAN-COUNT")


def test_chan_dup_fires_on_duplicated_channel():
    mutated(
        chain_plans,
        lambda p, _: dataclasses.replace(p, channels=p.channels + (p.channels[-1],)),
        "V-CHAN-DUP",
    )


def test_chan_measure_fires_on_payloadless_relation():
    def mutate(plan, pkg):
        ch = (JChannel if pkg == "jax" else Channel)("sum", ("R1", "m"))
        return dataclasses.replace(plan, channels=(plan.channels[0], ch))

    assert ("V-CHAN-MEASURE", "channels/R1") in mutated(chain_plans, mutate, "V-CHAN-MEASURE")


def test_chan_recipe_fires_when_avg_loses_its_sum_half():
    def mutate(plan, _):
        sum_ch = plan.assemble["mean"][1]
        return dataclasses.replace(
            plan, channels=tuple(c for c in plan.channels if c != sum_ch)
        )

    assert ("V-CHAN-RECIPE", "channels/mean") in mutated(chain_plans, mutate, "V-CHAN-RECIPE")


def test_chan_recipe_fires_on_missing_recipe():
    def mutate(plan, _):
        assemble = dict(plan.assemble)
        del assemble["total"]
        return dataclasses.replace(plan, assemble=assemble)

    mutated(chain_plans, mutate, "V-CHAN-RECIPE")


# ----------------------------------------------------------------------
# per-split plans
# ----------------------------------------------------------------------


def _with_split(plan, **changes):
    return dataclasses.replace(plan, split=dataclasses.replace(plan.split, **changes))


def test_split_partition_fires_on_range_gap():
    def mutate(plan, _):
        (lo0, hi0), *rest = plan.split.ranges
        return _with_split(plan, ranges=((lo0 + 1, hi0),) + tuple(rest))

    mutated(skew_plans, mutate, "V-SPLIT-PARTITION")


def test_split_root_fires_on_root_count_mismatch():
    mutated(skew_plans, lambda p, _: _with_split(p, roots=p.split.roots[:-1]), "V-SPLIT-ROOT")


def test_split_attr_fires_on_group_attribute():
    mutated(skew_plans, lambda p, _: _with_split(p, attr=p.prep.group_attrs[0][1]),
            "V-SPLIT-ATTR")


def test_split_minmax_fires_on_injected_request():
    def mutate(plan, pkg):
        req = (JMinMaxRequest if pkg == "jax" else MinMaxRequest)("min", ("R2", "m"))
        return dataclasses.replace(plan, minmax=(req,))

    mutated(skew_plans, mutate, "V-SPLIT-MINMAX")


def test_split_heavy_fires_on_out_of_domain_key():
    def mutate(plan, _):
        dom = plan.prep.dicts[plan.split.attr].size
        return _with_split(plan, heavy=((dom + 5, 0.5),))

    mutated(skew_plans, mutate, "V-SPLIT-HEAVY")


# ----------------------------------------------------------------------
# fused-hop launch shapes
# ----------------------------------------------------------------------


def _poison_launch_shapes(monkeypatch, **changes):
    """Replace the first hop's launch shape entry (``plan`` fields or
    entry keys) with a broken one."""
    real = verify_mod.hop_launch_shapes

    def fake(prep, k=1, encoded=None, domains=None):
        entries = [dict(e) for e in real(prep, k, encoded, domains)]
        e = entries[0]
        p = e["plan"]
        e["plan"] = type(p).from_buffer_copy(p)
        for key, val in changes.items():
            if key in e:
                e[key] = val
            else:
                setattr(e["plan"], key, val)
        return entries

    monkeypatch.setattr(verify_mod, "hop_launch_shapes", fake)


def _kern_messages(plan) -> list[str]:
    return [d.message for d in plan.verify(strict=False) if d.code == "V-KERN"]


@pytest.mark.parametrize("field", ["rows_per_tile", "slab", "slabs", "blocks"])
def test_kern_fires_on_a_non_positive_block_dimension(monkeypatch, field):
    _, plan = chain_plans()
    assert check_kernels(plan) == []
    assert any(e["walk"] == "tile" for e in verify_mod.hop_launch_shapes(plan.prep, 3))
    _poison_launch_shapes(monkeypatch, **{field: 0})
    assert any(f"{field}=0 is not positive" in m for m in _kern_messages(plan))


def test_kern_fires_on_too_many_blocks(monkeypatch):
    _, plan = chain_plans()
    _poison_launch_shapes(monkeypatch, blocks=ops.MAX_BLOCKS + 1)
    assert any("exceed one launch's" in m for m in _kern_messages(plan))


def test_kern_fires_on_too_much_shared_memory(monkeypatch):
    _, plan = chain_plans()
    _poison_launch_shapes(monkeypatch, smem_bytes=ops.SMEM_LIMIT + 4)
    assert any("dynamic shared memory" in m for m in _kern_messages(plan))


def test_kern_fires_on_an_integer_accumulator(monkeypatch):
    _, plan = chain_plans()
    _poison_launch_shapes(monkeypatch, acc_dtype="int32")
    assert any("identities" in m for m in _kern_messages(plan))


def test_kern_fires_when_no_launch_shape_fits(monkeypatch):
    """Edges past the run bounds: ``walk_plan``/``gather_plan`` refuse the
    hop and the verifier reports the refusal."""
    _, plan = chain_plans()
    monkeypatch.setattr(ops, "MAX_EDGES", 10)
    messages = _kern_messages(plan)
    assert messages and all(
        m.startswith("no tile walk launch shape") and "at most 10 edges" in m
        for m in messages
    )


def test_kern_fires_on_too_many_edges(monkeypatch):
    _, plan = chain_plans()
    _poison_launch_shapes(monkeypatch, edges=ops.MAX_EDGES + 1)
    assert any("32-bit run bounds" in m for m in _kern_messages(plan))


def test_kern_checks_the_gather_walk_too(monkeypatch):
    """A one-child hop of 32 floats or more takes the gather walk; its
    own block dimensions are checked."""
    cols = {
        "R1": {"g1": np.arange(40) % 40, "p": np.arange(40) % 7},
        "R2": {"p": np.arange(300) % 7, "g2": np.arange(300) % 50},
    }
    plan = Q.over("R1", "R2").group_by("R1.g1", "R2.g2").engine(CPU).plan(cols)
    shapes = verify_mod.hop_launch_shapes(plan.prep, k=1)
    assert any(e["walk"] == "gather" for e in shapes), shapes
    assert check_kernels(plan) == []
    real = verify_mod.hop_launch_shapes

    def fake(prep, k=1, encoded=None, domains=None):
        entries = [dict(e) for e in real(prep, k, encoded, domains)]
        for e in entries:
            if e["walk"] == "gather":
                e["plan"] = type(e["plan"]).from_buffer_copy(e["plan"])
                e["plan"].warps = 0
        return entries

    monkeypatch.setattr(verify_mod, "hop_launch_shapes", fake)
    assert any("warps=0 is not positive" in m for m in _kern_messages(plan))


def test_kern_checks_every_key_range_and_the_min_max_passes(monkeypatch):
    """V-KERN reads every pass ``execute()`` launches: a broken shape in
    one key range of a split plan, or in the k = 1 MIN/MAX pass of a
    bundle, is reported at that range or pass."""
    _, split = skew_plans()
    ranges = [r["prep"] for r in split.fused_runs()]
    assert len(ranges) > 1
    cols = chain_cols()
    bundle = (
        Q.over("R1", "R2", "R3").group_by("R1.g1", "R3.g2")
        .agg(n=Count(), total=Sum("R2.m"), lo=Min("R2.m"))
        .engine(CPU).plan(Database.from_mapping(cols))
    )
    assert [r["pass"] for r in bundle.fused_runs()] == ["channels", "min/max"]
    assert check_kernels(split) == [] and check_kernels(bundle) == []
    real = verify_mod.hop_launch_shapes

    def fake(prep, k=1, encoded=None, domains=None):
        entries = [dict(e) for e in real(prep, k, encoded, domains)]
        if prep is ranges[-1] or (prep is bundle.prep and k == 1):
            entries[0]["edges"] = ops.MAX_EDGES + 1
        return entries

    monkeypatch.setattr(verify_mod, "hop_launch_shapes", fake)
    sites = [d.site for d in split.verify(strict=False) if d.code == "V-KERN"]
    assert len(sites) == 1 and sites[0].startswith(f"kernel/key range {len(ranges) - 1} of")
    sites = [d.site for d in bundle.verify(strict=False) if d.code == "V-KERN"]
    assert len(sites) == 1 and sites[0].startswith("kernel/min-max/")


class _PlainEngine:
    name = "plain"  # no supports_fused attribute


def test_kern_silent_on_engines_without_fused_kernels(monkeypatch):
    _, plan = chain_plans()
    _poison_launch_shapes(monkeypatch, blocks=0)
    plan = dataclasses.replace(plan, engine=_PlainEngine())
    assert not any(d.code == "V-KERN" for d in plan.verify(strict=False))


# ----------------------------------------------------------------------
# accumulator overflow
# ----------------------------------------------------------------------


def test_overflow_fires_past_f32_exact_limit():
    from repro.analysis.verify import check_overflow as j_check_overflow

    jplan, plan = chain_plans()
    assert check_overflow(plan.prep, "torch") == []
    for p in (jplan, plan):
        p.prep.stats.relations[p.prep.decomposition.root].rows = 10**9
    diags = check_overflow(plan.prep, "torch")
    assert [(d.code, d.site) for d in diags] == [
        (d.code, d.site) for d in j_check_overflow(jplan.prep, "jax")
    ]
    assert any(d.code == "V-OVERFLOW" and "16777216" in d.message for d in diags)


# ----------------------------------------------------------------------
# GHD plans
# ----------------------------------------------------------------------


def test_ghd_cover_fires_on_uncovered_relation():
    def mutate(plan, _):
        gp = plan.ghd_plan
        rel = sorted(gp.edges)[0]
        gp.edges = {**gp.edges, rel: frozenset(gp.edges[rel]) | {"zz"}}
        return plan

    mutated(tri_plans, mutate, "V-GHD-COVER")


def test_ghd_rip_fires_on_detached_bag():
    def mutate(plan, _):
        ghd = plan.ghd_plan.ghd
        child = next(b for b in ghd.order if ghd.bags[b].parent is not None)
        ghd.bags[child].parent = None
        return plan

    mutated(tri_plans, mutate, "V-GHD-RIP")


def test_ghd_group_fires_on_double_hosted_bag():
    def mutate(plan, _):
        gp = plan.ghd_plan
        (grel, gattr), = gp.query.group_by
        bag = gp.ghd.cover_of[grel]
        other = next(r for r in gp.ghd.cover_of if r != grel)
        gp.ghd.cover_of[other] = bag
        gp.query = dataclasses.replace(gp.query, group_by=((grel, gattr), (other, "a")))
        return plan

    mutated(tri_plans, mutate, "V-GHD-GROUP")


# ----------------------------------------------------------------------
# sparse programs, strict mode, compile hook, clean plans
# ----------------------------------------------------------------------


def test_sparse_program_measure_fires_on_payloadless_channel():
    _, plan = chain_plans()
    prog = build_sparse_program(plan.prep, (None, "R2"), "cpu")
    assert verify_sparse_program(prog) == []
    bad = dataclasses.replace(prog, channel_measures=(None, "R1"))
    assert any(d.code == "V-CHAN-MEASURE" for d in verify_sparse_program(bad))


def test_strict_verify_raises_with_diagnostics():
    _, plan = chain_plans()
    plan.prep.encoded["R2"].codes[0, 0] = -5
    with pytest.raises(PlanInvariantError) as ei:
        plan.verify()
    assert "V-CODES" in str(ei.value)
    assert ei.value.diagnostics


def test_verify_on_compile_raises_on_a_broken_plan(monkeypatch):
    """``REPRO_VERIFY=1`` runs the verifier inside ``compile_plan``: a
    compile whose channelization loses the COUNT slot raises there;
    without the switch the same compile returns the broken plan."""
    import repro_torch.api.plan as plan_mod

    real = plan_mod._channelize

    def broken(aggs, resolve_rel):
        channels, minmax, assemble = real(aggs, resolve_rel)
        return channels[1:], minmax, assemble

    monkeypatch.setattr(plan_mod, "_channelize", broken)
    monkeypatch.delenv("REPRO_VERIFY", raising=False)
    _, plan = chain_plans()
    assert ("V-CHAN-COUNT", "channels") in found(plan)
    monkeypatch.setenv("REPRO_VERIFY", "1")
    with pytest.raises(PlanInvariantError, match="V-CHAN-COUNT"):
        chain_plans()
    monkeypatch.setattr(plan_mod, "_channelize", real)
    assert chain_plans()[1].verify() == []


@pytest.mark.parametrize("stats", [True, False])
@pytest.mark.parametrize("name", NAMES)
def test_catalog_plans_verify_clean(name, stats, monkeypatch):
    monkeypatch.setenv("REPRO_VERIFY", "1")  # compile verifies too
    jdb, jq, db, q = catalog(name)
    for fused in (None, True):
        pq = Q.from_query(q).stats(stats).engine(CPU)
        plan = (pq.fused(True) if fused else pq).plan(db)
        assert plan.verify(strict=False) == []
    jplan = JQ.from_query(jq).stats(stats).engine("jax").fused(True).plan(jdb)
    assert jplan.verify(strict=False) == []


def test_unbroken_fixtures_verify_clean():
    for make in (chain_plans, skew_plans, tri_plans):
        jplan, plan = make()
        assert plan.verify(strict=False) == []
        assert found(jplan) == found(plan) == set()
