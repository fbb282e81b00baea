"""Meshed requests in the port's query server (``repro_torch.serve.mesh``).

``_spawn_group`` starts ``world`` processes (``spawn``), each a rank of a
gloo group that meets through a ``file://`` store under the test's
temporary directory.  Every rank first runs the cases' shapes through a
direct ``Q ... .mesh(world).plan(db).execute()`` (a collective call),
then calls ``serve_mesh``: rank 0 gets the server and runs every case of
``_serve_cases`` against it, ranks 1…world−1 follow its lane until it
closes.  Each rank writes what it saw under the temporary directory; a
rank that raises, hangs past the spawn's timeout or exits non-zero fails
the fixture, and a case that raises is recorded as that case's failure.

Served answers are held bit for bit against the JAX package's
``engine("tensor")`` on the same seeded data (integer measures below
2**24), against the direct meshed execute, and, for the chain bundle,
against the reference's own ``JoinAggServer`` serving
``.engine("jax").mesh(S)`` in a subprocess of 4 virtual CPU devices
(:func:`tests.conftest.run_in_virtual_mesh`; its script renames
``shard_map``'s ``check_rep`` keyword to the installed JAX's
``check_vma``, as ``tests/test_torch_mesh.py`` does).
"""
import datetime
import json
import multiprocessing
import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from pathlib import Path

import numpy as np
import pytest

from tests.conftest import run_in_virtual_mesh

REPO = Path(__file__).resolve().parent.parent
WORLDS = (2, 4)
SPAWN_TIMEOUT_S = 300
TIMEOUT = 120  # seconds for any one result or join inside a rank
SHAPES = ("bundle", "count", "sum", "min", "max")
IDLE_TIMEOUT_S = 5  # the control group's timeout in the idle group


def _columns(extra_r3: int = 0) -> dict:
    """The chain R1(g1, p) ⋈ R2(p, q, m) ⋈ R3(q, g2) from a fixed seed;
    ``extra_r3`` more R3 rows (the registration case's new data)."""
    rng = np.random.default_rng(31)
    n = 160
    cols = {
        "R1": {"g1": rng.integers(0, 7, n), "p": rng.integers(0, 6, n)},
        "R2": {"p": rng.integers(0, 6, n), "q": rng.integers(0, 6, n),
               "m": rng.integers(0, 10, n)},
        "R3": {"q": rng.integers(0, 6, n), "g2": rng.integers(0, 7, n)},
    }
    if extra_r3:
        more = np.random.default_rng(32)
        cols["R3"] = {
            "q": np.concatenate([cols["R3"]["q"], more.integers(0, 6, extra_r3)]),
            "g2": np.concatenate([cols["R3"]["g2"], more.integers(0, 9, extra_r3)]),
        }
    return cols


def _shapes(Q, Count, Sum, Min, Max, Avg) -> dict:
    base = Q.over("R1", "R2", "R3").group_by("R1.g1", "R3.g2")
    return {
        "bundle": base.agg(c=Count(), total=Sum("R2.m"), lo=Min("R2.m"), hi=Max("R2.m"),
                           mean=Avg("R2.m")),
        "count": base.agg(n=Count()),
        "sum": base.agg(s=Sum("R2.m")),
        "min": base.agg(lo=Min("R2.m")),
        "max": base.agg(hi=Max("R2.m")),
    }


def _port_shapes() -> dict:
    from repro_torch.api import Avg, Count, Max, Min, Q, Sum

    return _shapes(Q, Count, Sum, Min, Max, Avg)


def _doc(res) -> dict:
    return {name: np.asarray(col) for name, col in res.relation.columns.items()}


def _same(a: dict, b: dict) -> bool:
    return list(a) == list(b) and all(
        a[c].dtype == b[c].dtype and np.array_equal(a[c], b[c]) for c in a
    )


# ----------------------------------------------------------------------
# the ranks
# ----------------------------------------------------------------------


def _serve_cases(srv, world: int, direct: dict, local: dict) -> dict:
    """Every case on rank 0's server; ``{case: what it saw}``, or
    ``{"error": traceback}`` for a case that raised."""
    from repro_torch.api import Count, Q, Sum, TorchChannelEngine
    from repro_torch.core.operator import UnsupportedPlanOption
    from repro_torch.relational.relation import Database, Relation
    from repro_torch.serve.server import serve_tcp
    from repro_torch.serve.session import Session, connect

    shapes = _port_shapes()
    lane = srv._lane
    out: dict = {}

    def case(name):
        def wrap(fn):
            try:
                out[name] = fn()
            except BaseException:
                out[name] = {"error": traceback.format_exc()}
        return wrap

    @case("served")
    def _():
        return {s: _doc(srv.query(shapes[s].mesh(world))) for s in SHAPES}

    @case("fused")
    def _():
        return _doc(srv.query(shapes["bundle"].fused(True).mesh(world)))

    @case("session")
    def _():
        session = Session(srv)
        return _doc(session.prepare(shapes["bundle"].mesh(world)).execute())

    @case("warm")
    def _():
        q = Q.over("R1", "R2", "R3").group_by("R1.g1").agg(n=Count()).mesh(world)
        before = list(lane.rank_compiles)
        first = _doc(srv.query(q))
        after_first = list(lane.rank_compiles)
        second = _doc(srv.query(q))
        return {"before": before, "first": after_first, "second": list(lane.rank_compiles),
                "same": _same(first, second)}

    @case("burst")
    def _():
        specs = [shapes["count"], shapes["sum"], shapes["count"], shapes["sum"]]
        fusion, executes = srv.stats()["fusion"], lane.executes
        futures = [srv.submit(q.mesh(world)) for q in specs]
        got = [_doc(f.result(timeout=TIMEOUT)) for f in futures]
        after = srv.stats()["fusion"]
        return {
            "same": [_same(g, direct[n]) for g, n in zip(got, ("count", "sum") * 2)],
            "merged": after["merged_channels"] - fusion["merged_channels"],
            "batches": after["batches"] - fusion["batches"],
            "executes": lane.executes - executes,
        }

    @case("clients")
    def _():
        names = list(SHAPES)
        barrier = threading.Barrier(8)
        wrong: list[str] = []
        lock = threading.Lock()

        def client(i):
            barrier.wait(timeout=TIMEOUT)
            for j in range(6):
                name = names[(i + j) % len(names)]
                meshed = (i + j) % 2 == 0
                q = shapes[name].mesh(world) if meshed else shapes[name]
                try:
                    got = _doc(srv.submit(q).result(timeout=TIMEOUT))
                    ok = _same(got, direct[name] if meshed else local[name])
                    msg = f"client {i} {name} meshed={meshed}: wrong answer"
                except Exception as e:
                    ok, msg = False, f"client {i} {name}: {e!r}"
                if not ok:
                    with lock:
                        wrong.append(msg)

        fusion = srv.stats()["fusion"]
        threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=4 * TIMEOUT)
        after = srv.stats()["fusion"]
        return {"wrong": wrong, "alive": [t.is_alive() for t in threads],
                "fused": after["fused_queries"] - fusion["fused_queries"]}

    @case("mesh_one")
    def _():
        executes = lane.executes
        got = _doc(srv.query(shapes["bundle"].mesh(1)))
        return {"same": _same(got, local["bundle"]), "executes": lane.executes - executes}

    @case("device_mesh")
    def _():
        from torch.distributed.device_mesh import init_device_mesh

        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
        got = [_doc(srv.query(shapes["bundle"].mesh(mesh))) for _ in range(2)]
        return {"same": [_same(g, direct["bundle"]) for g in got],
                "meshes": len(lane._meshes)}

    @case("stored")
    def _():
        # two stored copies of R3 cross the lane as their directories; R8
        # loses its g2 file after every rank opened the directory, and only
        # rank 0 has mapped that column, so only the other ranks fail their
        # compile in the lane (the logical stage reads only the manifest),
        # and still no rank enters execute
        from repro_torch.storage import write_relation

        tmp = Path(tempfile.mkdtemp(prefix="served-mesh-"))
        for name in ("R8", "R9"):
            srv.register(name, write_relation(Relation(name, _columns()["R3"]), tmp / name))
        r8 = srv.db["R8"]
        r8.open_column("g2")
        os.remove(r8.manifest.column_path(r8.directory, "g2"))

        def copy_of_r3(name):
            return (Q.over("R1", "R2", name).group_by("R1.g1", f"{name}.g2")
                    .agg(n=Count()).mesh(world))

        executes = lane.executes
        try:
            good = _doc(srv.query(copy_of_r3("R9")))
            srv.query(copy_of_r3("R8"))
            error = None
        except RuntimeError as e:
            error = str(e)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        return {"good": _same(good, direct["count"]), "error_text": error,
                "executes": lane.executes - executes - 1,
                "next": _same(_doc(srv.query(shapes["count"].mesh(world))), direct["count"])}

    @case("unknown")
    def _():
        q = Q.over("R1", "NoSuch").group_by("R1.g1").agg(n=Count()).mesh(world)
        try:
            srv.query(q)
            error = None
        except Exception as e:
            error = f"{type(e).__name__}: {e}"
        return {"error_text": error,
                "next": _same(_doc(srv.query(shapes["count"].mesh(world))), direct["count"])}

    @case("shards")
    def _():
        other = 3
        try:
            srv.submit(shapes["count"].mesh(other))
            error = None
        except UnsupportedPlanOption as e:
            error = str(e)
        return {"error_text": error,
                "next": _same(_doc(srv.query(shapes["count"].mesh(world))), direct["count"])}

    @case("callable")
    def _():
        q = shapes["count"].where("R2", lambda cols: cols["m"] > 2).mesh(world)
        try:
            srv.submit(q)
            error = None
        except UnsupportedPlanOption as e:
            error = str(e)
        declarative = shapes["count"].where("R2", "m", ">", 2)
        return {"error_text": error,
                "declarative": _same(_doc(srv.query(declarative.mesh(world))),
                                     _doc(srv.query(declarative)))}

    @case("tcp")
    def _():
        tcp, _ = serve_tcp(srv)
        host, port = tcp.server_address
        spec = {"relations": ["R1", "R2", "R3"], "group_by": ["R1.g1", "R3.g2"],
                "aggs": {"n": {"kind": "count"}, "s": {"kind": "sum", "measure": "R2.m"}}}
        try:
            with connect(host, port) as remote:
                got = remote.query({**spec, "mesh": world})
                with socket.create_connection((host, port), timeout=TIMEOUT) as s:
                    s.sendall((json.dumps({"op": "query", "q": {**spec, "mesh": 3}})
                               + "\n").encode())
                    bad = json.loads(s.makefile("rb").readline())
                alive = remote.ping()
        finally:
            tcp.shutdown()
            tcp.server_close()
        want = _doc(srv.query(shapes["count"].agg(s=Sum("R2.m")).mesh(world)))
        return {"same": {c: np.asarray(got.relation.columns[c]).tolist() == want[c].tolist()
                         for c in want},
                "bad": bad, "alive": alive}

    @case("view")
    def _():
        executes = lane.executes
        q = shapes["count"].mesh(world)
        view = srv.create_view("meshed", q)
        first = dict(view.read().result)
        delta = {"g1": np.array([0, 1, 6]), "p": np.array([1, 2, 3])}
        epoch = srv.apply_view("meshed", "insert", "R1", delta).result(timeout=TIMEOUT)
        second = dict(srv.read_view("meshed").result)
        shadow = shapes["count"].engine(TorchChannelEngine(device="cpu")).plan(srv.db).maintain()
        want_first = dict(shadow.result())
        want_second = dict(shadow.insert("R1", delta))
        srv.drop_view("meshed")
        return {"first": first == want_first, "second": second == want_second,
                "epoch": epoch, "executes": lane.executes - executes,
                "changed": first != second}

    @case("register")
    def _():
        generation = srv.generation
        new = _columns(extra_r3=40)["R3"]
        srv.register("R3", Relation("R3", new))
        srv.bump_stats()
        got = {s: _doc(srv.query(shapes[s].mesh(world))) for s in ("bundle", "count")}
        db = Database.from_mapping({**_columns(), "R3": new})
        local_now = _doc(shapes["bundle"].engine(TorchChannelEngine(device="cpu"))
                         .plan(db).execute())
        return {"served": got, "generations": (generation, srv.generation,
                                               srv.stats_generation),
                "equals_local": _same(got["bundle"], local_now),
                "rank_compiles": list(lane.rank_compiles)}

    return out


def _rank_run(rank: int, world: int) -> dict:
    import torch.distributed as dist

    from repro_torch.api import TorchChannelEngine
    from repro_torch.kernels import ops
    from repro_torch.relational.relation import Database
    from repro_torch.serve.mesh import serve_mesh

    cpu = TorchChannelEngine(device="cpu")
    db = Database.from_mapping(_columns())
    shapes = _port_shapes()
    direct = {s: _doc(shapes[s].engine(cpu).mesh(world).plan(db).execute()) for s in SHAPES}
    local = {s: _doc(shapes[s].engine(cpu).plan(db).execute()) for s in SHAPES}
    srv = serve_mesh(db, device="cpu", workers=4, fusion_window=0.05)
    if srv is None:
        return {"rank": rank, "followed": True, "world": dist.get_world_size(),
                "launches": ops.launch_counts()}
    try:
        out = _serve_cases(srv, world, direct, local)
    finally:
        srv.close()
    out.update(rank=rank, direct=direct, local=local, final=srv._lane.final,
               stats=srv.stats()["mesh"])
    return out


def _idle_rank_run(rank: int, world: int) -> dict:
    """A server that stays idle past the control group's timeout
    (``CONTROL_TIMEOUT``, cut to ``IDLE_TIMEOUT_S`` in this process): the
    follower's wait for rank 0's next message times out and raises out of
    ``serve_mesh``; rank 0's next meshed spec then fails on the control
    group, which closes the lane, and the spec after it is refused, while
    unmeshed queries and registrations still run on rank 0."""
    from repro_torch.api import TorchChannelEngine
    from repro_torch.relational.relation import Database
    from repro_torch.serve.mesh import serve_mesh

    db = Database.from_mapping(_columns())
    shapes = _port_shapes()
    local = _doc(shapes["count"].engine(TorchChannelEngine(device="cpu")).plan(db).execute())
    try:
        srv = serve_mesh(db, device="cpu", workers=2)
    except RuntimeError as e:
        return {"rank": rank, "raised": f"{type(e).__name__}: {e}"}
    if srv is None:
        return {"rank": rank, "raised": None}

    def error_of(fn):
        try:
            fn()
        except Exception as e:
            return f"{type(e).__name__}: {e}"
        return None

    out: dict = {"rank": rank}
    try:
        out["first"] = _same(_doc(srv.query(shapes["count"].mesh(world))), local)
        time.sleep(IDLE_TIMEOUT_S + 2)
        t0 = time.perf_counter()
        out["lost"] = error_of(lambda: srv.submit(shapes["count"].mesh(world))
                               .result(timeout=TIMEOUT))
        out["lost_s"] = time.perf_counter() - t0
        out["next"] = error_of(lambda: srv.submit(shapes["sum"].mesh(world)))
        out["unmeshed"] = _same(_doc(srv.query(shapes["count"])), local)
        stats_generation = srv.stats_generation
        srv.bump_stats()
        out["bumped"] = srv.stats_generation == stats_generation + 1
    finally:
        t0 = time.perf_counter()
        srv.close()
        out["close_s"] = time.perf_counter() - t0
    out.update(snapshot=srv._lane.snapshot(), final=srv._lane.final)
    return out


def _rank_main(rank: int, world: int, out_dir: str, idle: bool = False) -> None:
    """One rank: join the group, run (:func:`_idle_rank_run` if
    ``idle``), write what it saw (or the traceback) under ``out_dir``."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{out_dir}/store", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=120),
    )
    try:
        if idle:
            from repro_torch.serve import mesh

            mesh.CONTROL_TIMEOUT = datetime.timedelta(seconds=IDLE_TIMEOUT_S)
            answers = _idle_rank_run(rank, world)
        else:
            answers = _rank_run(rank, world)
        with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
            pickle.dump(answers, f)
    except BaseException:
        with open(f"{out_dir}/rank{rank}.err", "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def _spawn_group(world: int, out_dir, target=None) -> tuple[list[dict], float, list]:
    """Run ``world`` ranks of ``target`` (default :func:`_rank_main`) to
    their end; what each saw, the spawn's wall seconds and the exit
    codes."""
    ctx = multiprocessing.get_context("spawn")
    t0 = time.perf_counter()
    procs = [
        ctx.Process(target=target or _rank_main, args=(r, world, str(out_dir)), daemon=True)
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
    return answers, time.perf_counter() - t0, codes


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"{w}ranks")
def group(request, tmp_path_factory):
    world = request.param
    answers, seconds, codes = _spawn_group(world, tmp_path_factory.mktemp(f"serve{world}"))
    print(f"served gloo group of {world} CPU ranks: {seconds:.1f} s")
    return world, answers, codes


def _case(group, name):
    _, answers, _ = group
    got = answers[0][name]
    if isinstance(got, dict) and "error" in got and isinstance(got["error"], str) \
            and "Traceback" in got["error"]:
        pytest.fail(f"case {name} raised on rank 0:\n{got['error']}")
    return got


# ----------------------------------------------------------------------
# the JAX package's answers
# ----------------------------------------------------------------------


def _tensor(shape: str, cols: dict | None = None) -> dict:
    """The JAX package's ``engine("tensor")`` answer of a shape."""
    from repro.api import Avg, Count, Max, Min, Q, Sum
    from repro.relational.relation import Database

    q = _shapes(Q, Count, Sum, Min, Max, Avg)[shape]
    return _doc(q.engine("tensor").plan(Database.from_mapping(cols or _columns())).execute())


def _assert_same(want: dict, got: dict) -> None:
    assert list(got) == list(want)
    for c in want:
        assert got[c].dtype == want[c].dtype, (c, got[c].dtype, want[c].dtype)
        np.testing.assert_array_equal(got[c], want[c], err_msg=c)


# ----------------------------------------------------------------------
# served meshes on gloo groups of CPU ranks
# ----------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
def test_served_mesh_equals_the_tensor_engine(group, shape):
    _assert_same(_tensor(shape), _case(group, "served")[shape])


def test_served_mesh_equals_the_direct_meshed_execute(group):
    world, answers, _ = group
    served = _case(group, "served")
    for rank, a in enumerate(answers[1:], 1):
        assert a["followed"] and a["world"] == world
    for shape in SHAPES:
        _assert_same(answers[0]["direct"][shape], served[shape])
    _assert_same(answers[0]["direct"]["bundle"], _case(group, "session"))


def test_a_fused_meshed_bundle_equals_the_unfused_one(group):
    _, answers, _ = group
    _assert_same(answers[0]["direct"]["bundle"], _case(group, "fused"))


def test_a_warm_repeat_compiles_once_on_every_rank(group):
    world, _, _ = group
    warm = _case(group, "warm")
    assert warm["same"]
    assert [b + 1 for b in warm["before"]] == warm["first"] == warm["second"]
    assert len(warm["first"]) == world


def test_a_burst_of_meshed_count_and_sum_fuses_into_one_execute(group):
    burst = _case(group, "burst")
    assert burst["same"] == [True] * 4
    assert burst["merged"] == 4 and burst["batches"] == 1 and burst["executes"] == 1


def test_eight_clients_mixing_meshed_and_unmeshed_shapes(group):
    clients = _case(group, "clients")
    assert clients["wrong"] == [] and not any(clients["alive"])
    assert clients["fused"] > 0


def test_a_mesh_of_one_runs_on_rank_0_alone(group):
    one = _case(group, "mesh_one")
    assert one == {"same": True, "executes": 0}


def test_a_device_mesh_spec_runs_solo_on_a_mesh_built_once(group):
    dm = _case(group, "device_mesh")
    assert dm == {"same": [True, True], "meshes": 1}


def test_a_stored_relation_crosses_the_lane_as_its_directory(group):
    assert _case(group, "stored")["good"]


def test_a_compile_that_fails_in_the_lane_is_refused_on_every_rank(group):
    world, _, _ = group
    refusal = _case(group, "stored")
    error = refusal["error_text"]
    assert error.startswith("meshed execute refused, no rank entered it")
    assert "rank 0:" not in error
    assert all(f"rank {r}: FileNotFoundError" in error for r in range(1, world))
    assert refusal["executes"] == 0 and refusal["next"]


def test_every_rank_refuses_alike():
    """Followers and rank 0 decide from the same gathered statuses: any
    rank's error, else any prepared layout other than rank 0's."""
    from repro_torch.serve.mesh import refusals

    ok = {"error": None, "compiles": 1, "layout": ({"R1": 3}, {"g1": 2})}
    assert refusals([ok, ok, ok]) == []
    failed = {"error": "KeyError: 'x'", "compiles": 1, "layout": None}
    assert refusals([ok, failed, ok]) == ["rank 1: KeyError: 'x'"]
    assert refusals([failed, ok]) == ["rank 0: KeyError: 'x'"]
    drifted = dict(ok, layout=({"R1": 4}, {"g1": 2}))
    (why,) = refusals([ok, ok, drifted])
    assert why.startswith("rank 2: prepared on")


def test_a_spec_that_fails_to_compile_leaves_the_followers_up(group):
    unknown = _case(group, "unknown")
    assert unknown["error_text"] is not None and "NoSuch" in unknown["error_text"]
    assert unknown["next"]


def test_a_shard_count_other_than_the_group_is_refused(group):
    world, _, _ = group
    shards = _case(group, "shards")
    assert shards["error_text"] is not None
    assert f"process group has {world} ranks" in shards["error_text"]
    assert shards["next"]
    bad = _case(group, "tcp")["bad"]
    assert bad["ok"] is False and "UnsupportedPlanOption" in bad["error"]


def test_a_callable_predicate_is_refused(group):
    refused = _case(group, "callable")
    assert refused["error_text"] is not None and "callable predicate" in refused["error_text"]
    assert refused["declarative"]


def test_a_meshed_tcp_request(group):
    tcp = _case(group, "tcp")
    assert all(tcp["same"].values()) and tcp["alive"]


def test_a_meshed_view_is_maintained_on_rank_0_alone(group):
    view = _case(group, "view")
    assert view == {"first": True, "second": True, "epoch": 1, "executes": 0,
                    "changed": True}


def test_register_after_start_reaches_every_rank(group):
    world, _, _ = group
    reg = _case(group, "register")
    cols = {**_columns(), "R3": _columns(extra_r3=40)["R3"]}
    _assert_same(_tensor("bundle", cols), reg["served"]["bundle"])
    _assert_same(_tensor("count", cols), reg["served"]["count"])
    assert reg["equals_local"]
    generation, after, _ = reg["generations"]
    assert after == generation + 1
    assert len(reg["rank_compiles"]) == world


def test_close_ends_every_follower(group):
    world, answers, codes = group
    assert codes == [0] * world
    final = answers[0]["final"]
    assert len(final) == world and all(f["error"] is None for f in final)
    assert all(f["compiles"] > 0 for f in final)
    assert all(set(f["launches"]) >= {"segment_sum", "coo_spmm"} for f in final)
    assert answers[0]["stats"]["stopped"] and answers[0]["stats"]["failure"] is None


# ----------------------------------------------------------------------
# a control group that fails: a server idle past its timeout
# ----------------------------------------------------------------------


def _idle_rank_main(rank: int, world: int, out_dir: str) -> None:
    _rank_main(rank, world, out_dir, idle=True)


@pytest.fixture(scope="module")
def idle_group(tmp_path_factory):
    answers, seconds, codes = _spawn_group(2, tmp_path_factory.mktemp("idle"),
                                           target=_idle_rank_main)
    print(f"idle gloo group of 2 CPU ranks: {seconds:.1f} s")
    return answers, codes


def test_an_idle_follower_raises_out_of_serve_mesh(idle_group):
    answers, codes = idle_group
    assert codes == [0, 0]
    assert answers[0]["first"]
    assert answers[1]["raised"] is not None and answers[1]["raised"].startswith(
        ("RuntimeError", "DistBackendError")), answers[1]["raised"]


def test_a_control_group_failure_closes_the_lane(idle_group):
    rank0 = idle_group[0][0]
    assert rank0["lost"] is not None and rank0["lost_s"] < TIMEOUT
    assert rank0["snapshot"]["failure"].startswith("the control group failed")
    assert rank0["next"].startswith(
        "RuntimeError: the mesh lane closed after a failure: the control group failed")


def test_rank_0_serves_on_after_the_lane_closed(idle_group):
    rank0 = idle_group[0][0]
    assert rank0["unmeshed"] and rank0["bumped"]
    assert rank0["close_s"] < IDLE_TIMEOUT_S  # no stop waits on the lost follower
    assert rank0["final"] is None and rank0["snapshot"]["stopped"]


_REFERENCE = r"""
import json
import sys

import jax
import numpy as np

from repro.api import Avg, Count, Max, Min, Q, Sum
from repro.core import distributed
from repro.relational.relation import Database
from repro.serve.server import JoinAggServer


def shard_map(f, *, check_rep=True, **kwargs):
    return jax.shard_map(f, check_vma=check_rep, **kwargs)


distributed.shard_map = shard_map
cols = json.load(sys.stdin)
db = Database.from_mapping(
    {r: {c: np.asarray(v) for c, v in rel.items()} for r, rel in cols.items()})
q = Q.over("R1", "R2", "R3").group_by("R1.g1", "R3.g2").agg(
    c=Count(), total=Sum("R2.m"), lo=Min("R2.m"), hi=Max("R2.m"), mean=Avg("R2.m"))
out = {}
with JoinAggServer(db, workers=2) as srv:
    for S in (2, 4):
        res = srv.query(q.engine("jax").fused(False).mesh(S))
        out[str(S)] = {n: [v.item() for v in res.relation.columns[n]]
                       for n in res.relation.columns}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_served_mesh():
    payload = {r: {c: np.asarray(v).tolist() for c, v in rel.items()}
               for r, rel in _columns().items()}
    return run_in_virtual_mesh(_REFERENCE, devices=4, timeout=600, stdin=json.dumps(payload))


def test_bundle_equals_the_reference_served_mesh(group, reference_served_mesh):
    world, _, _ = group
    got = _case(group, "served")["bundle"]
    assert {c: got[c].tolist() for c in got} == reference_served_mesh[str(world)]


# ----------------------------------------------------------------------
# in process, with no group
# ----------------------------------------------------------------------


def _server_db():
    from repro_torch.relational.relation import Database

    return Database.from_mapping(_columns())


def test_a_mesh_of_one_without_a_group_is_served_cached_and_equal():
    from repro_torch.serve.server import JoinAggServer

    shapes = _port_shapes()
    with JoinAggServer(_server_db(), device="cpu", workers=2) as srv:
        first = _doc(srv.query(shapes["bundle"].mesh(1)))
        second = _doc(srv.query(shapes["bundle"].mesh(1)))
        unmeshed = _doc(srv.query(shapes["bundle"]))
        pc = srv.plan_cache.stats.snapshot()
    _assert_same(unmeshed, first)
    _assert_same(first, second)
    _assert_same(_tensor("bundle"), first)
    assert pc["compiles"] == 2 and pc["hits"] == 1  # .mesh(1) keyed apart, cached once


def test_a_mesh_of_two_without_a_group_is_refused_in_submit():
    from repro_torch.core.operator import UnsupportedPlanOption
    from repro_torch.serve.server import JoinAggServer

    shapes = _port_shapes()
    with JoinAggServer(_server_db(), device="cpu", workers=2) as srv:
        with pytest.raises(UnsupportedPlanOption, match="serve_mesh"):
            srv.submit(shapes["count"].mesh(2))
        assert srv.plan_cache.stats.compiles == 0
        assert srv.query(shapes["count"]).num_rows > 0


def test_serve_mesh_needs_a_process_group():
    from repro_torch.serve.mesh import serve_mesh

    with pytest.raises(RuntimeError, match="init_process_group"):
        serve_mesh(_server_db(), device="cpu")


def _specs() -> dict:
    from repro_torch.api import Count, Q, Sum

    base = Q.over("R1", ("R1b", "R1"), "R2").rename("R1b", g1="h1")
    return {
        "plain": _port_shapes()["bundle"].mesh(2),
        "aliased": base.group_by("R1.g1", "R1b.h1").agg(n=Count()).mesh(2),
        "where": _port_shapes()["sum"].where("R2", "m", ">=", 3).where("R1", g1=2)
        .where("R2", "q", "in", [1, 2]).mesh(4),
        "options": _port_shapes()["count"].stats(False).fused(True).memory_budget(1 << 20)
        .engine("torch").mesh(2),
        "merged": _port_shapes()["count"].agg(a0__n=Count(), a1__s=Sum("R2.m")).mesh(2),
    }


@pytest.mark.parametrize("name", list(_specs()))
def test_a_spec_description_rebuilds_the_same_shape_key(name):
    """What crosses the control group rebuilds, through ``Q``'s own
    methods, a spec whose shape key equals the original's."""
    from repro_torch.serve.cache import plan_shape_key
    from repro_torch.serve.mesh import describe_spec, rebuild_spec

    spec = _specs()[name]
    desc = pickle.loads(pickle.dumps(describe_spec(spec)))
    rebuilt = rebuild_spec(desc, {})
    assert plan_shape_key(rebuilt, 3, 5) == plan_shape_key(spec, 3, 5) is not None
    assert [p.label for p in rebuilt.predicates] == [p.label for p in spec.predicates]


def test_a_key_that_differs_from_rank_0s_is_an_error_on_that_rank():
    """A rank whose own shape key, or whose generations, differ from what
    rank 0 sent compiles nothing and reports the difference, so no rank
    enters the collective."""
    from repro_torch.api import TorchChannelEngine
    from repro_torch.serve.cache import PlanCache, plan_shape_key
    from repro_torch.serve.mesh import describe_spec, prepare_execute

    spec = _port_shapes()["count"].mesh(1)
    cache = PlanCache(4, engine=TorchChannelEngine(device="cpu"))
    db = _server_db()
    msg = {"op": "execute", "spec": describe_spec(spec), "generation": 2,
           "stats_generation": 2, "key": plan_shape_key(spec, 2, 2)}
    status, plan = prepare_execute(msg, cache, db, 2, 2, {})
    assert status["error"] is None and status["compiles"] == 1 and plan is not None
    assert set(status["layout"][0]) == {"R1", "R2", "R3"}
    other = dict(msg, key=plan_shape_key(spec.fused(True), 2, 2))
    status, plan = prepare_execute(other, cache, db, 2, 2, {})
    assert plan is None and "differs from rank 0's" in status["error"]
    status, plan = prepare_execute(msg, cache, db, 1, 2, {})
    assert plan is None and "data generation 1" in status["error"]
    assert cache.stats.compiles == 1


# ----------------------------------------------------------------------
# the launcher under torchrun, on the CPU
# ----------------------------------------------------------------------


def test_launch_serve_under_torchrun_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--smoke", "--scale", "1000", "--clients", "4", "--queries-per-client", "3"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    solo = {ln.split()[2]: ln.split()[3] for ln in lines if ln.startswith("serve-smoke solo ")}
    meshed = {ln.split()[2]: ln.split()[3] for ln in lines
              if ln.startswith("serve-smoke mesh(2) ")}
    assert set(solo) == {"count:", "sum:", "multi:", "minmax:", "two_group:"}
    assert meshed == solo
    assert "serve-smoke OK" in proc.stdout
