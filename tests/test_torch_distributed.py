"""The sharded path of the port (``repro_torch.core.distributed``) against
the JAX package's ``repro.core.distributed``, in one process: the shard
partition and its verifier, the hop schedule, the distributed path
choice, the meshed explain, a local mesh of one, and the refusals.

Everything here needs no process group but the world-size check, which
initialises a gloo group of one rank.  ``tests/test_torch_mesh.py`` runs
the meshed executes on gloo groups of 2 and 4 CPU ranks.

The JAX package's shard_map call passes ``check_rep``, which the
installed JAX (0.9) renamed ``check_vma``; the reference's mesh executes
run here through :func:`reference_shard_map`, which renames the keyword
for the test's process and changes nothing else.
"""
import dataclasses
import datetime

import jax
import numpy as np
import pytest
import torch.distributed as dist

from repro.analysis.verify import check_shards as j_check_shards
from repro.analysis.verify import verify_distributed_program as j_verify_program
from repro.api import Q as JQ
from repro.core import distributed as jdist
from repro.core.jax_engine import choose_jax_path
from repro.data.queries import skewed_chain_like as j_skewed_chain_like
from repro.relational.relation import Database as JDatabase
from repro_torch.analysis.verify import check_shards, verify_distributed_program
from repro_torch.api import Count, Q, UnsupportedPlanOption
from repro_torch.core import distributed
from repro_torch.core.prepare import CSRView
from repro_torch.core.torch_engine import choose_path
from repro_torch.data.queries import skewed_chain_like
from repro_torch.relational.relation import Database
from repro_torch.serve import JoinAggServer
from tests.test_torch_dense import (
    JAX,
    NAMES,
    PORT,
    bundle,
    catalog,
    channel_args,
    cpu,
    measured,
)
from tests.test_torch_explain import substituted
from tests.test_torch_planner import assert_identical

CPU = cpu()
SHARDS = (1, 3, 8)


@pytest.fixture
def reference_shard_map(monkeypatch):
    """The reference's ``shard_map`` with its ``check_rep`` keyword
    passed on as the installed JAX's ``check_vma``."""

    def shard_map(f, *, check_rep=True, **kwargs):
        return jax.shard_map(f, check_vma=check_rep, **kwargs)

    monkeypatch.setattr(jdist, "shard_map", shard_map)


def plans(name: str):
    """Fresh COUNT plans of one catalog query, (reference, port)."""
    jdb, jq, db, q = catalog(name)
    return (
        JQ.from_query(jq).engine("jax").plan(jdb),
        Q.from_query(q).engine(CPU).plan(db),
    )


def chain_cols(n: int = 120, seed: int = 5) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "R1": {"g1": rng.integers(0, 7, n), "p": rng.integers(0, 6, n)},
        "R2": {"p": rng.integers(0, 6, n), "q": rng.integers(0, 6, n),
               "m": rng.integers(0, 10, n)},
        "R3": {"q": rng.integers(0, 6, n), "g2": rng.integers(0, 7, n)},
    }


def chain_bundle(qcls, api):
    count, total, avg, lo, hi = api
    return qcls.over("R1", "R2", "R3").group_by("R1.g1", "R3.g2").agg(
        c=count(), total=total("R2.m"), lo=lo("R2.m"), hi=hi("R2.m"), mean=avg("R2.m")
    )


def schedule_fields(hops) -> list[tuple]:
    return [dataclasses.astuple(h) for h in hops]


def diag_fields(diags) -> list[tuple[str, str]]:
    return [(d.code, d.site) for d in diags]


# ----------------------------------------------------------------------
# the shard partition
# ----------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_shard_ranges_and_check_shards_equal_the_reference(name):
    jplan, plan = plans(name)
    attr = distributed.shard_attr(plan.prep)
    assert attr == jdist.shard_attr(jplan.prep)
    root = plan.prep.decomposition.root
    view = plan.prep.csr_view(root, (attr,))
    jview = jplan.prep.csr_view(root, (attr,))
    assert view.num_keys == jview.num_keys == plan.prep.dicts[attr].size
    for s in SHARDS:
        got, want = view.shard(s), jview.shard(s)
        assert [(lo, hi, sl.start, sl.stop) for lo, hi, sl in got] == [
            (lo, hi, sl.start, sl.stop) for lo, hi, sl in want
        ]
        assert check_shards(plan.prep, s) == []
        assert j_check_shards(jplan.prep, s) == []


def test_shard_rejects_a_count_below_one():
    view = CSRView(("a",), np.arange(4), np.arange(4), 4)
    with pytest.raises(ValueError, match="num_shards"):
        view.shard(0)
    assert [(lo, hi) for lo, hi, _ in view.shard(8)] == (
        [(i, i + 1) for i in range(4)] + [(4, 4)] * 4
    )


def _poison(plan, **overrides) -> None:
    prep = plan.prep
    root = prep.decomposition.root
    attr = prep.schema.group_of[root]
    view = prep.csr_view(root, (attr,))
    prep._csr_cache[(root, (attr,))] = dataclasses.replace(view, **overrides)


class _WideShards:
    """A view whose first shard spans the whole key space: a valid
    partition whose width exceeds the tile."""

    def shard(self, num_shards):
        ne = len(self.keys)
        out = [(0, self.num_keys, slice(0, ne))]
        out += [(self.num_keys, self.num_keys, slice(ne, ne))] * (num_shards - 1)
        return out


def _widen(plan) -> None:
    prep = plan.prep
    root = prep.decomposition.root
    attr = prep.schema.group_of[root]
    view = prep.csr_view(root, (attr,))
    wide = type("Wide", (_WideShards, type(view)), {})
    prep._csr_cache[(root, (attr,))] = wide(
        attrs=view.attrs, keys=view.keys, order=view.order, num_keys=view.num_keys
    )


@pytest.mark.parametrize("mutation", ["unsorted", "key_space", "wide"])
def test_shard_mutations_fire_as_in_the_reference(mutation):
    """Each mutation goes into both plans; both verifiers report the same
    codes at the same sites."""
    cols = chain_cols()
    jplan = chain_bundle(JQ, JAX).engine("jax").plan(JDatabase.from_mapping(cols))
    plan = chain_bundle(Q, PORT).engine(CPU).plan(Database.from_mapping(cols))
    for p in (jplan, plan):
        root = p.prep.decomposition.root
        view = p.prep.csr_view(root, (p.prep.schema.group_of[root],))
        if mutation == "unsorted":
            _poison(p, keys=view.keys[::-1].copy())
        elif mutation == "key_space":
            _poison(p, num_keys=view.num_keys + 3)
        else:
            _widen(p)
    want = dataclasses.replace(jplan, mesh=2).verify(strict=False)
    got = dataclasses.replace(plan, mesh=2).verify(strict=False)
    code = "V-SHARD-TILE" if mutation == "wide" else "V-SHARD-PARTITION"
    assert code in [d.code for d in got]
    assert diag_fields(got) == diag_fields(want)
    if mutation == "unsorted":
        assert any("unsorted" in d.message for d in got)


def test_sentinel_fires_on_a_hop_key_out_of_range():
    cols = chain_cols()
    jplan = chain_bundle(JQ, JAX).engine("jax").plan(JDatabase.from_mapping(cols))
    plan = chain_bundle(Q, PORT).engine(CPU).plan(Database.from_mapping(cols))
    jprog = jdist.build_distributed_program(jplan.prep, (None,), mesh=1)
    prog = distributed.build_distributed_program(plan.prep, (None,), 1, device="cpu")
    assert j_verify_program(jprog) == [] and verify_distributed_program(prog) == []
    hop = next(h for h in prog.hops if (h.rel, h.kept_attrs) in prog.views)
    keys = np.array(jprog.inputs[f"k:{hop.rel}"], copy=True)
    keys.flat[0] = hop.knum + 7
    jprog.inputs[f"k:{hop.rel}"] = keys
    view = prog.views[(hop.rel, hop.kept_attrs)]
    bad = view.keys_host.copy()
    bad[0] = hop.knum + 7
    prog.views[(hop.rel, hop.kept_attrs)] = dataclasses.replace(view, keys_host=bad)
    got, want = verify_distributed_program(prog), j_verify_program(jprog)
    assert ("V-SENTINEL", f"distributed/{hop.rel}") in diag_fields(got)
    assert diag_fields(got) == diag_fields(want)


def test_sentinel_fires_on_descending_hop_keys():
    """The port's keys are a rank's real keys: out of order, the row walk
    would split an output row's edges."""
    plan = chain_bundle(Q, PORT).engine(CPU).plan(Database.from_mapping(chain_cols()))
    prog = distributed.build_distributed_program(plan.prep, (None,), 1, device="cpu")
    hop = next(h for h in prog.hops if (h.rel, h.kept_attrs) in prog.views)
    view = prog.views[(hop.rel, hop.kept_attrs)]
    prog.views[(hop.rel, hop.kept_attrs)] = dataclasses.replace(
        view, keys_host=view.keys_host[::-1].copy()
    )
    diags = verify_distributed_program(prog)
    assert any(d.code == "V-SENTINEL" and "ascending" in d.message for d in diags)


def test_program_ranges_and_tile_are_checked():
    plan = chain_bundle(Q, PORT).engine(CPU).plan(Database.from_mapping(chain_cols()))
    prog = distributed.build_distributed_program(plan.prep, (None,), 1, device="cpu")
    gap = dataclasses.replace(prog, ranges=((0, 2),))
    narrow = dataclasses.replace(prog, tile=1)
    assert "V-SHARD-PARTITION" in [d.code for d in verify_distributed_program(gap)]
    assert "V-SHARD-TILE" in [d.code for d in verify_distributed_program(narrow)]


# ----------------------------------------------------------------------
# the hop schedule and the path choice
# ----------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_build_schedule_equals_the_reference(name):
    jplan, plan = plans(name)
    prep, jprep = plan.prep, jplan.prep
    attr = distributed.shard_attr(prep)
    for s in SHARDS:
        tile = max(max(hi - lo for lo, hi, _ in prep.csr_view(
            prep.decomposition.root, (attr,)).shard(s)), 1)
        domains = {a: prep.dicts[a].size for a in prep.dicts}
        domains[attr] = tile
        got = distributed._build_schedule(prep, domains)
        want = jdist._build_schedule(jprep, dict(domains))
        assert schedule_fields(got) == schedule_fields(want)


@pytest.mark.parametrize("stats", [True, False])
@pytest.mark.parametrize("name", NAMES)
def test_choose_path_shards_equals_the_reference(name, stats):
    jdb, jq, db, q, m = measured(name, lambda rng, n: rng.integers(0, 9, n))
    jplan = bundle(JQ, JAX, jq, m).stats(stats).engine("jax").plan(jdb)
    plan = bundle(Q, PORT, q, m).stats(stats).engine(CPU).plan(db)
    args = channel_args(plan)
    for s in SHARDS:
        kw = dict(shards=s, stats=plan.prep.stats if stats else None)
        jkw = dict(shards=s, stats=jplan.prep.stats if stats else None)
        want = choose_jax_path(jplan.prep, **channel_args(jplan), **jkw)
        got = choose_path(plan.prep, **args, **kw)
        assert got.path == want.path == "distributed-sparse"
        assert (got.reason, got.shards) == (want.reason, want.shards)
        assert got.per_device_node_bytes == want.per_device_node_bytes
        assert got.sparse_node_bytes == want.sparse_node_bytes
        assert got.per_device_peak == want.per_device_peak


def test_skew_caps_the_divisor_like_the_reference():
    """SKEWCHAIN's hot key sits on p0, a join attribute, so its shard
    attribute g1 keeps the full divisor; a chain whose root key is hot
    (60 % of R1 on one g1) caps it.  Both as the reference says."""
    jdb, jq = j_skewed_chain_like(600, seed=0)
    db, q = skewed_chain_like(600, seed=0)
    cols = chain_cols()
    cols["R1"]["g1"] = np.where(np.arange(120) % 5 < 3, 0, cols["R1"]["g1"])
    cases = [
        (JQ.from_query(jq).engine("jax").mesh(8).plan(jdb).prep,
         Q.from_query(q).engine(CPU).mesh(8).plan(db).prep, False),
        (chain_bundle(JQ, JAX).engine("jax").mesh(8).plan(JDatabase.from_mapping(cols)).prep,
         chain_bundle(Q, PORT).engine(CPU).mesh(8).plan(Database.from_mapping(cols)).prep,
         True),
    ]
    for jprep, prep, capped in cases:
        want = choose_jax_path(jprep, shards=8, stats=jprep.stats)
        got = choose_path(prep, shards=8, stats=prep.stats)
        assert ("skew-capped divisor" in got.reason) is capped, got.reason
        assert got.reason == want.reason
        assert got.per_device_node_bytes == want.per_device_node_bytes


# ----------------------------------------------------------------------
# explain, the local mesh, the refusals
# ----------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_meshed_explain_equals_the_reference(name, monkeypatch):
    """An int mesh needs no devices and no process group: the whole
    explain of ``.mesh(8)`` equals the reference's, its ``mesh:`` and
    ``torch path:`` lines included."""
    monkeypatch.delenv("REPRO_FUSED", raising=False)
    jdb, jq, db, q = catalog(name)
    want = JQ.from_query(jq).engine("jax").mesh(8).plan(jdb).explain(actuals=True)
    plan = Q.from_query(q).engine(CPU).mesh(8).plan(db)
    lines = plan.explain(actuals=True).splitlines()
    assert lines == [substituted(line) for line in want.splitlines()]
    assert any(line.startswith("mesh: 8 shard(s) of group attr") for line in lines)
    assert any(line.startswith("torch path: distributed-sparse") for line in lines)
    assert plan.split is None and plan.resolved_stream() is None
    assert all(d.code == "V-OVERFLOW" for d in plan.verify(strict=False))


@pytest.mark.parametrize("fused", [False, True])
def test_fused_runs_list_one_run_per_shard(fused, monkeypatch):
    monkeypatch.delenv("REPRO_FUSED", raising=False)
    plan = (
        chain_bundle(Q, PORT).engine(CPU).fused(fused).mesh(3)
        .plan(Database.from_mapping(chain_cols()))
    )
    runs = plan.fused_runs()
    assert [r["run"] for r in runs] == [
        f"shard {i} of 3 (g1 from {lo})" for i, lo in enumerate((0, 3, 6)) for _ in range(2)
    ]
    assert [r["pass"] for r in runs[:2]] == ["channels", "min/max"]
    assert ("kernels:" in plan.explain()) is fused


def test_local_mesh_of_one_equals_the_reference_mesh_bit_for_bit(reference_shard_map):
    cols = chain_cols()
    want = chain_bundle(JQ, JAX).engine("jax").mesh(1).plan(
        JDatabase.from_mapping(cols)).execute()
    tensor = chain_bundle(JQ, JAX).engine("tensor").plan(JDatabase.from_mapping(cols)).execute()
    for fused in (False, True):
        plan = chain_bundle(Q, PORT).engine(CPU).fused(fused).mesh(1).plan(
            Database.from_mapping(cols))
        got = plan.execute()
        assert_identical(want, got)
        assert_identical(tensor, got)
        assert not dist.is_initialized()


def test_run_query_on_a_local_mesh_equals_the_reference(reference_shard_map):
    from repro.aggregates.semiring import Max as JMaxAgg
    from repro.core.prepare import prepare as jprepare
    from repro.core.query import JoinAggQuery as JQuery
    from repro_torch.aggregates.semiring import Max as MaxAgg
    from repro_torch.core.prepare import prepare
    from repro_torch.core.query import JoinAggQuery

    cols = chain_cols()
    group = (("R1", "g1"), ("R3", "g2"))
    rels = ("R1", "R2", "R3")
    jprep = jprepare(JQuery(rels, group, JMaxAgg("R2", "m")), JDatabase.from_mapping(cols))
    prep = prepare(JoinAggQuery(rels, group, MaxAgg("R2", "m")), Database.from_mapping(cols))
    assert distributed.run_query(prep, 1, device="cpu") == jdist.run_query(jprep, 1)
    jcount = jprepare(JQuery(rels, group), JDatabase.from_mapping(cols))
    count = prepare(JoinAggQuery(rels, group), Database.from_mapping(cols))
    assert distributed.run(count, 1, device="cpu") == jdist.run(jcount, 1)


def test_stream_and_mesh_are_refused_together():
    q = chain_bundle(Q, PORT).engine(CPU).stream("g1", 2).mesh(2)
    with pytest.raises(UnsupportedPlanOption, match="stream"):
        q.plan(Database.from_mapping(chain_cols()))
    plan = chain_bundle(Q, PORT).engine(CPU).stream("g1", 2).plan(
        Database.from_mapping(chain_cols()))
    with pytest.raises(UnsupportedPlanOption, match="stream"):
        plan.execute(mesh=1)


def test_a_mesh_of_two_without_a_group_raises():
    plan = chain_bundle(Q, PORT).engine(CPU).mesh(2).plan(Database.from_mapping(chain_cols()))
    assert plan.mesh == 2 and "mesh: 2 shard(s)" in plan.explain()
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        plan.execute()
    unmeshed = chain_bundle(Q, PORT).engine(CPU).plan(Database.from_mapping(chain_cols()))
    with pytest.raises(ValueError, match="process group of 3 ranks"):
        unmeshed.execute(mesh=3)
    with pytest.raises(ValueError, match="at least 1 shard"):
        unmeshed.execute(mesh=0)


def test_a_world_size_that_does_not_match_raises(tmp_path):
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=60),
    )
    try:
        plan = chain_bundle(Q, PORT).engine(CPU).plan(Database.from_mapping(chain_cols()))
        with pytest.raises(ValueError, match="the initialised one has 1"):
            plan.execute(mesh=2)
        # a group of one runs the collective path: the gather of one shard
        assert_identical(plan.execute(), plan.execute(mesh=1))
        prog = next(iter(plan.prep.shard_programs.values()))
        assert prog.axis.group is dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_the_server_refuses_a_mesh_before_it_compiles():
    """A server not started through ``serve_mesh`` refuses a mesh of 2
    in ``submit``, before it compiles; it serves a mesh of 1 here, and
    maintains a meshed view here (maintenance never executes over the
    mesh)."""
    cols = chain_cols()
    q = Q.over("R1", "R2", "R3").group_by("R1.g1").agg(n=Count())
    with JoinAggServer(Database.from_mapping(cols), device="cpu", workers=2) as srv:
        with pytest.raises(UnsupportedPlanOption, match="follower loop.*serve_mesh"):
            srv.submit(q.mesh(2))
        assert srv.plan_cache.stats.compiles == 0
        want = srv.query(q)
        assert want.num_rows > 0
        assert_identical(want, srv.query(q.mesh(1)))
        view = srv.create_view("v", q.mesh(2))
        assert view.read().result == want.to_dict()


def test_a_mesh_supersedes_the_split():
    """A meshed compile plans no split; a split plan executed over a mesh
    runs the shards and never builds its key-range parts."""
    db, q = skewed_chain_like(600, seed=0)
    split = Q.from_query(q).engine(CPU).plan(db)
    assert split.split is not None
    assert Q.from_query(q).engine(CPU).mesh(1).plan(db).split is None
    want = split.execute()
    split._split_parts = None
    got = split.execute(mesh=1)
    assert split._split_parts is None and split.prep.shard_programs
    assert_identical(want, got)
