"""Meshed executes of the port on gloo process groups of CPU ranks.

``_spawn_group`` starts ``world`` processes (``spawn``), each a rank of a
gloo group that meets through a ``file://`` store under the test's
temporary directory (so parallel test workers never share a port), runs
every case of ``_rank_cases`` through the port's entry points
(``Q ... .mesh(S).plan(db).execute()``, ``distributed.run_query``) and
writes its answers to that directory.  A rank that raises, hangs past
the spawn's timeout or exits non-zero fails the fixture.

Every rank's answer is held bit for bit against the JAX package's
``engine("tensor")`` on the same data, and every rank must hold the same
answer (the all_gather hands each the whole).  The chain bundle and the
single aggregates are also held against the reference's unfused mesh at
the same shard count, run in a subprocess of 4 virtual CPU devices
(:func:`tests.conftest.run_in_virtual_mesh`); its script renames
``shard_map``'s ``check_rep`` keyword to the installed JAX's
``check_vma`` (see ``tests/test_torch_distributed.py``).
"""
import datetime
import json
import multiprocessing
import pickle
import time
import traceback

import numpy as np
import pytest

from tests.conftest import run_in_virtual_mesh

WORLDS = (2, 4)
SPAWN_TIMEOUT_S = 300
FRACTIONAL_RTOL = 1e-5  # float32 sums of positive terms, chunked differently per shard
SINGLES = ("count", "sum", "min", "max")


def _columns() -> dict[str, dict]:
    """The cases' databases as plain column mappings, from fixed seeds:
    the parent and every rank build the same ones."""
    rng = np.random.default_rng(29)
    n = 180
    chain = {
        "R1": {"g1": rng.integers(0, 7, n), "p": rng.integers(0, 6, n)},
        "R2": {"p": rng.integers(0, 6, n), "q": rng.integers(0, 6, n),
               "m": rng.integers(0, 10, n)},
        "R3": {"q": rng.integers(0, 6, n), "g2": rng.integers(0, 7, n)},
    }
    # one root group code: every shard past the first owns zero rows
    skew = {
        "R1": {"g1": np.full(60, 3), "p": rng.integers(0, 4, 60)},
        "R2": {"p": rng.integers(0, 4, 60), "m": rng.integers(0, 8, 60)},
        "R3": {"p": rng.integers(0, 4, 60), "g2": rng.integers(0, 3, 60)},
    }
    frac = {r: dict(c) for r, c in chain.items()}
    frac["R2"] = {**chain["R2"], "m": rng.random(n) * 10.0}
    return {"chain": chain, "skew": skew, "frac": frac}


def _bundle(api, rels=("R1", "R2", "R3"), group=("R1.g1", "R3.g2")):
    Q, Count, Sum, Min, Max, Avg = api
    return Q.over(*rels).group_by(*group).agg(
        c=Count(), total=Sum("R2.m"), lo=Min("R2.m"), hi=Max("R2.m"), mean=Avg("R2.m")
    )


def _doc(res) -> dict:
    return {name: np.asarray(col) for name, col in res.relation.columns.items()}


def _rank_cases(world: int) -> dict:
    """Every case on this rank; ``{case: answer}``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.api import Avg, Count, Max, Min, Q, Sum, TorchChannelEngine
    from repro_torch.core import distributed, torch_engine
    from repro_torch.core.prepare import prepare
    from repro_torch.core.query import JoinAggQuery
    from repro_torch.aggregates import semiring
    from repro_torch.data.queries import triangle_like
    from repro_torch.relational.relation import Database

    cpu = TorchChannelEngine(device="cpu")
    api = (Q, Count, Sum, Min, Max, Avg)
    dbs = {k: Database.from_mapping(v) for k, v in _columns().items()}
    out: dict = {}
    for fused in (False, True):
        tag = "fused" if fused else "unfused"
        for name in ("chain", "skew", "frac"):
            plan = _bundle(api).engine(cpu).fused(fused).mesh(world).plan(dbs[name])
            out[f"{name}/{tag}"] = _doc(plan.execute())
        tdb, tq = triangle_like(300)
        plan = Q.from_query(tq).engine(cpu).fused(fused).mesh(world).plan(tdb)
        assert plan.cyclic
        out[f"cyclic/{tag}"] = _doc(plan.execute())

    group = (("R1", "g1"), ("R3", "g2"))
    for kind in SINGLES:
        agg = () if kind == "count" else (
            getattr(semiring, kind.capitalize())("R2", "m"),)
        prep = prepare(JoinAggQuery(("R1", "R2", "R3"), group, *agg), dbs["chain"])
        res = distributed.run_query(prep, world, device="cpu")
        out[f"single/{kind}"] = sorted([list(map(int, k)), v] for k, v in res.items())

    # a warm execute reuses the memoised program: no slice, no upload
    plan = _bundle(api).engine(cpu).mesh(world).plan(dbs["chain"])
    cold = plan.execute()
    progs = dict(plan.prep.shard_programs)
    calls = {"build": 0, "restrict": 0}
    build, restrict = torch_engine.DeviceView.build, distributed.csr_restrict

    def counting(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    torch_engine.DeviceView.build = staticmethod(counting("build", build))
    distributed.csr_restrict = counting("restrict", restrict)
    try:
        warm = plan.execute()
    finally:
        torch_engine.DeviceView.build = staticmethod(build)
        distributed.csr_restrict = restrict
    same = all(np.array_equal(a, b) for a, b in zip(_doc(cold).values(), _doc(warm).values()))
    (prog,) = progs.values()
    out["memo"] = {
        "programs": len(progs),
        "same_objects": all(plan.prep.shard_programs[k] is v for k, v in progs.items()),
        "warm_builds": calls["build"], "warm_restricts": calls["restrict"],
        "same_answer": same, "rank": prog.axis.rank, "shards": prog.num_shards,
        "ranges": prog.ranges, "per_device_bytes": prog.per_device_bytes(),
        "sharded_views": len(prog.views),
    }

    other = 2 if world == 4 else 4
    try:
        plan.execute(mesh=other)
        out["mismatch"] = None
    except ValueError as e:
        out["mismatch"] = str(e)

    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    out["device_mesh/data"] = _doc(_bundle(api).engine(cpu).mesh(mesh).plan(dbs["chain"]).execute())
    if world == 4:
        # the data axis is the second: 2 shards, each held by 2 ranks
        mesh2 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("model", "data"))
        plan = _bundle(api).engine(cpu).mesh(mesh2).plan(dbs["chain"])
        out["device_mesh/model_data"] = _doc(plan.execute())
        (prog,) = plan.prep.shard_programs.values()
        out["device_mesh/axis"] = (prog.num_shards, prog.axis.rank, dist.get_rank())
    return out


def _rank_main(rank: int, world: int, out_dir: str) -> None:
    """One rank: join the group, run the cases, write the answers (or the
    traceback) under ``out_dir``."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{out_dir}/store", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=120),
    )
    try:
        answers = _rank_cases(world)
        with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
            pickle.dump(answers, f)
    except BaseException:
        with open(f"{out_dir}/rank{rank}.err", "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def _spawn_group(world: int, out_dir) -> tuple[list[dict], float]:
    """Run ``world`` ranks to their end; every rank's answers, and the
    spawn's wall seconds."""
    ctx = multiprocessing.get_context("spawn")
    t0 = time.perf_counter()
    procs = [
        ctx.Process(target=_rank_main, args=(r, world, str(out_dir)), daemon=True)
        for r in range(world)
    ]
    for p in procs:
        p.start()
    deadline = t0 + SPAWN_TIMEOUT_S
    for p in procs:
        p.join(timeout=max(deadline - time.perf_counter(), 0.1))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(timeout=10)
    errors = {
        r: (out_dir / f"rank{r}.err").read_text()
        for r in range(world) if (out_dir / f"rank{r}.err").exists()
    }
    codes = [p.exitcode for p in procs]
    if hung or errors or any(codes):
        raise AssertionError(
            f"gloo group of {world}: hung ranks {hung}, exit codes {codes}\n"
            + "\n".join(f"rank {r}:\n{e}" for r, e in errors.items())
        )
    answers = []
    for r in range(world):
        with open(out_dir / f"rank{r}.pkl", "rb") as f:
            answers.append(pickle.load(f))
    return answers, time.perf_counter() - t0


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"{w}ranks")
def group(request, tmp_path_factory):
    world = request.param
    answers, seconds = _spawn_group(world, tmp_path_factory.mktemp(f"gloo{world}"))
    print(f"gloo group of {world} CPU ranks: {seconds:.1f} s")
    return world, answers


_REFERENCE = r"""
import json
import sys

import jax
import numpy as np

from repro.aggregates.semiring import Avg, Count, Max, Min, Sum
from repro.api import Q
from repro.core import distributed
from repro.core.prepare import prepare
from repro.core.query import JoinAggQuery
from repro.relational.relation import Database


def shard_map(f, *, check_rep=True, **kwargs):
    return jax.shard_map(f, check_vma=check_rep, **kwargs)


distributed.shard_map = shard_map
dbs = {
    name: Database.from_mapping(
        {r: {c: np.asarray(v) for c, v in rel.items()} for r, rel in cols.items()})
    for name, cols in json.load(sys.stdin).items()
}
db = dbs["chain"]
out = {}
for S in (2, 4):
    q = Q.over("R1", "R2", "R3").group_by("R1.g1", "R3.g2").agg(
        c=Count(), total=Sum("R2.m"), lo=Min("R2.m"), hi=Max("R2.m"), mean=Avg("R2.m"))
    for name in ("chain", "frac"):
        res = q.engine("jax").fused(False).mesh(S).plan(dbs[name]).execute()
        out[f"{name}/{S}"] = {n: [v.item() for v in res.relation.columns[n]]
                              for n in res.relation.columns}
    group = (("R1", "g1"), ("R3", "g2"))
    for kind, agg in (("count", ()), ("sum", (Sum("R2", "m"),)),
                      ("min", (Min("R2", "m"),)), ("max", (Max("R2", "m"),))):
        prep = prepare(JoinAggQuery(("R1", "R2", "R3"), group, *agg), db)
        res = distributed.run_query(prep, S)
        out[f"single/{kind}/{S}"] = sorted([list(map(int, k)), v] for k, v in res.items())
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_mesh():
    payload = {
        name: {r: {c: np.asarray(v).tolist() for c, v in rel.items()} for r, rel in cols.items()}
        for name, cols in _columns().items() if name in ("chain", "frac")
    }
    return run_in_virtual_mesh(_REFERENCE, devices=4, timeout=600, stdin=json.dumps(payload))


def _tensor(name: str, cyclic: bool = False) -> dict:
    """The JAX package's ``engine("tensor")`` answer of a case."""
    from repro.aggregates.semiring import Avg, Count, Max, Min, Sum
    from repro.api import Q
    from repro.relational.relation import Database

    if cyclic:
        from repro_torch.data.queries import triangle_like

        tdb, tq = triangle_like(300)
        cols = {r: dict(tdb[r].columns) for r in tq.relations}
        return _doc(Q.from_query(tq).engine("tensor").plan(Database.from_mapping(cols)).execute())
    api = (Q, Count, Sum, Min, Max, Avg)
    return _doc(_bundle(api).engine("tensor").plan(Database.from_mapping(_columns()[name])).execute())


def _assert_same(want: dict, got: dict, rtol: dict | None = None) -> None:
    assert list(got) == list(want)
    for c in want:
        assert got[c].dtype == want[c].dtype, (c, got[c].dtype, want[c].dtype)
        if rtol and c in rtol:
            np.testing.assert_allclose(got[c], want[c], rtol=rtol[c], err_msg=c)
        else:
            np.testing.assert_array_equal(got[c], want[c], err_msg=c)


def _every_rank(answers: list[dict], case: str):
    """The case's answer, after checking that every rank holds it."""
    first = answers[0][case]
    for other in answers[1:]:
        if isinstance(first, dict):
            _assert_same(first, other[case])
        else:
            assert other[case] == first
    return first


@pytest.mark.parametrize("fused", ["unfused", "fused"])
@pytest.mark.parametrize("name", ["chain", "skew"])
def test_bundle_equals_the_tensor_engine(group, name, fused):
    _, answers = group
    _assert_same(_tensor(name), _every_rank(answers, f"{name}/{fused}"))


@pytest.mark.parametrize("fused", ["unfused", "fused"])
def test_cyclic_triangle_equals_the_tensor_engine(group, fused):
    _, answers = group
    got = _every_rank(answers, f"cyclic/{fused}")
    assert len(got["count"]) > 0
    _assert_same(_tensor("chain", cyclic=True), got)


@pytest.mark.parametrize("fused", ["unfused", "fused"])
def test_fractional_measures(group, fused):
    """SUM and AVG within 1e-5 relative (the float32 sums of a shard split
    their edge chunks elsewhere); MIN and MAX exact, as the walk returns
    the float64 payloads."""
    _, answers = group
    got = _every_rank(answers, f"frac/{fused}")
    _assert_same(_tensor("frac"), got, rtol={"total": FRACTIONAL_RTOL, "mean": FRACTIONAL_RTOL})


def test_chain_bundle_equals_the_reference_mesh(group, reference_mesh):
    world, answers = group
    got = _every_rank(answers, "chain/unfused")
    want = reference_mesh[f"chain/{world}"]
    assert {c: got[c].tolist() for c in got} == want


def test_fractional_minmax_against_the_reference_mesh(group, reference_mesh):
    """The reference's mesh casts the MIN/MAX payloads to float32
    (``repro/core/distributed.py:532``), so on fractional payloads it
    returns them rounded; the port's ranks return the float64 payloads,
    as ``engine("tensor")`` does."""
    world, answers = group
    got = _every_rank(answers, "frac/unfused")
    want = reference_mesh[f"frac/{world}"]
    exact = _tensor("frac")
    for c in ("lo", "hi"):
        np.testing.assert_array_equal(got[c], exact[c])
        np.testing.assert_array_equal(np.asarray(want[c]), exact[c].astype(np.float32))
        assert not np.array_equal(np.asarray(want[c]), exact[c])


@pytest.mark.parametrize("kind", SINGLES)
def test_single_aggregates(group, reference_mesh, kind):
    """``run_query`` at the group's shard count equals the reference's
    ``run_query`` at the same count and the tensor engine."""
    from repro.aggregates.semiring import Max, Min, Sum
    from repro.core.prepare import prepare
    from repro.core.query import JoinAggQuery
    from repro.core.tensor_engine import execute_tensor
    from repro.relational.relation import Database

    world, answers = group
    got = _every_rank(answers, f"single/{kind}")
    assert got == reference_mesh[f"single/{kind}/{world}"]
    agg = {"sum": Sum, "min": Min, "max": Max}
    q = JoinAggQuery(("R1", "R2", "R3"), (("R1", "g1"), ("R3", "g2")),
                     *((agg[kind]("R2", "m"),) if kind in agg else ()))
    db = Database.from_mapping(_columns()["chain"])
    want = sorted([list(map(int, k)), v] for k, v in execute_tensor(q, db, prepare(q, db)).items())
    if kind in ("count", "sum"):
        want = [kv for kv in want if kv[1] != 0.0]
    assert got == want


def test_warm_execute_reuses_the_memoised_program(group):
    world, answers = group
    for rank, a in enumerate(answers):
        memo = a["memo"]
        assert memo["programs"] == 1 and memo["same_objects"] and memo["same_answer"]
        assert memo["warm_builds"] == 0 and memo["warm_restricts"] == 0
        assert (memo["rank"], memo["shards"]) == (rank, world)
        assert memo["sharded_views"] >= 1 and memo["per_device_bytes"] > 0
    ranges = answers[0]["memo"]["ranges"]
    assert all(a["memo"]["ranges"] == ranges for a in answers)
    assert ranges[0][0] == 0 and all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


def test_a_mesh_that_does_not_match_the_group_raises(group):
    world, answers = group
    other = 2 if world == 4 else 4
    for a in answers:
        assert a["mismatch"] == (
            f"mesh over {other} shards needs a process group of {other} ranks; "
            f"the initialised one has {world}"
        )


def test_device_mesh_data_axis(group):
    world, answers = group
    want = _tensor("chain")
    _assert_same(want, _every_rank(answers, "device_mesh/data"))
    if world == 4:
        _assert_same(want, _every_rank(answers, "device_mesh/model_data"))
        axes = [a["device_mesh/axis"] for a in answers]
        # ranks (0, 1) and (2, 3) hold model rows; the data axis is the second
        assert axes == [(2, 0, 0), (2, 1, 1), (2, 0, 2), (2, 1, 3)]
