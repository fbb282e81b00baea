"""JOIN-AGG query server entry point (DESIGN.md §9).

Start a TCP server over a synthetic chain database on the card:

    PYTHONPATH=src python -m repro_torch.launch.serve --port 7474 --scale 5000

then talk to it with :func:`repro_torch.serve.session.connect`, or over
raw newline-delimited JSON (see :mod:`repro_torch.serve.wire`).  The demo
database is the paper's C1 chain R1(g1,p0) ⋈ R2(p0,p1) ⋈ R3(p1,p2) ⋈
R4(p2,g2) with a ``w`` measure column on R2 so SUM/AVG/MIN/MAX queries
work out of the box.  ``--device cpu`` serves from the CPU instead,
where the kernels run their plain versions.

``--smoke`` runs the concurrent-correctness gate instead of serving
forever: it starts the server, fires concurrent mixed-shape clients at
it — repeated shapes exercising the warm plan cache and the fusion
batcher, a maintained view read under writes — and exits non-zero
unless every result is bit-identical to a single-shot ``Plan.execute()``
on the same device.

Under ``torchrun --nproc-per-node S`` (``WORLD_SIZE`` > 1) every rank
joins one process group (NCCL when there are at least S cards, else
gloo; ``--device cpu``: gloo on the CPU), computes on
``cuda:{LOCAL_RANK}`` (modulo the cards present) and starts through
:func:`repro_torch.serve.mesh.serve_mesh`: rank 0 serves, the others
follow its meshed requests.  ``--smoke`` then also runs each demo shape
with ``.mesh(S)`` and requires it to equal the solo execute bit for bit
(``serve-smoke solo`` and ``serve-smoke mesh(S)`` lines, one digest
each).

Port of the JAX package's ``launch/serve.py``.
"""
from __future__ import annotations

import argparse
import hashlib
import os
import sys
import threading

import numpy as np

from repro_torch.aggregates.semiring import Avg, Count, Max, Min, Sum
from repro_torch.api.builder import Q
from repro_torch.api.engines import TorchChannelEngine
from repro_torch.data.synth import chain
from repro_torch.relational.relation import Database
from repro_torch.serve.mesh import serve_mesh
from repro_torch.serve.server import JoinAggServer, serve_tcp
from repro_torch.serve.session import connect


def demo_database(scale: int, seed: int = 0) -> Database:
    """The C1 chain at ``scale`` rows/relation, plus a measure column."""
    db, _ = chain("C1", scale, seed=seed)
    rng = np.random.default_rng(seed + 1)
    r2 = db["R2"]
    db.add(r2.with_column("w", rng.integers(1, 100, r2.num_rows)))
    return db


def demo_queries() -> dict[str, Q]:
    """The mixed query shapes the smoke clients rotate through."""
    base = Q.over("R1", "R2", "R3", "R4")
    return {
        "count": base.group_by("R1.g1").agg(n=Count()),
        "sum": base.group_by("R1.g1").agg(total=Sum("R2.w")),
        "multi": base.group_by("R1.g1").agg(
            n=Count(), total=Sum("R2.w"), mean=Avg("R2.w")
        ),
        "minmax": base.group_by("R4.g2").agg(
            lo=Min("R2.w"), hi=Max("R2.w")
        ),
        "two_group": base.group_by("R1.g1", "R4.g2").agg(n=Count()),
    }


def as_rows(res) -> dict[str, dict[tuple, float]]:
    """Every aggregate of a result as ``{group tuple: value}``."""
    return {n: res.to_dict(n) for n in res.agg_names}


def digest(res) -> str:
    """sha256 over every column's name, dtype and bytes: equal digests
    are results equal bit for bit."""
    h = hashlib.sha256()
    for name, col in res.relation.columns.items():
        col = np.ascontiguousarray(col)
        h.update(f"{name}:{col.dtype.str}:{col.shape}:".encode())
        h.update(col.tobytes())
    return h.hexdigest()


def mesh_world() -> int:
    """The ranks ``torchrun`` started (1 outside it)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def join_mesh(args) -> str:
    """Join the ``torchrun`` process group; the device this rank
    computes on."""
    import torch
    import torch.distributed as dist

    world = mesh_world()
    if args.device == "cpu":
        backend, device = "gloo", "cpu"
    else:
        cards = torch.cuda.device_count()
        if cards == 0:
            from repro_torch.core.torch_engine import require_device

            require_device(args.device)  # raises: no card
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0')) % cards}"
        torch.cuda.set_device(device)
        backend = "nccl" if cards >= world else "gloo"
    dist.init_process_group(backend, init_method="env://")
    return device


def start_server(db, args, **kwargs):
    """The server on this process, or None on a follower rank (which has
    followed rank 0's lane until it closed)."""
    if mesh_world() > 1:
        return serve_mesh(db, device=args.device, **kwargs)
    return JoinAggServer(db, device=args.device, **kwargs)


def run_smoke(args) -> int:
    db = demo_database(args.scale, seed=0)
    srv = start_server(
        db, args, workers=args.workers, fusion_window=args.fusion_window,
    )
    if srv is None:
        return 0
    queries = demo_queries()
    engine = TorchChannelEngine(device=args.device)
    solo = {name: q.engine(engine).plan(db).execute() for name, q in queries.items()}
    oracles = {name: as_rows(res) for name, res in solo.items()}
    view_q = queries["count"]
    srv.create_view("by_g1", view_q)

    failures: list[str] = []
    fail_lock = threading.Lock()

    def check(name: str, res) -> None:
        if as_rows(res) != oracles[name]:
            with fail_lock:
                failures.append(f"{name}: result != Plan.execute() oracle")

    # per-prefix oracles for the maintained view (epoch e == prefix e)
    rng = np.random.default_rng(7)
    deltas = [
        {"g1": rng.integers(0, 20, 8), "p0": rng.integers(0, 20, 8)}
        for _ in range(args.view_batches)
    ]
    prefix_oracles = [dict(srv.read_view("by_g1").result)]
    shadow = view_q.engine(engine).plan(db).maintain()
    for d in deltas:
        prefix_oracles.append(shadow.insert("R1", d))

    def client(i: int) -> None:
        names = list(queries)
        for j in range(args.queries_per_client):
            name = names[(i + j) % len(names)]
            try:
                check(name, srv.query(queries[name]))
            except Exception as e:
                with fail_lock:
                    failures.append(f"client {i} {name}: {e!r}")

    def view_reader() -> None:
        for _ in range(40 * args.view_batches):
            snap = srv.read_view("by_g1")
            got = snap.result if isinstance(snap.result, dict) else None
            want = (
                prefix_oracles[snap.epoch]
                if snap.epoch < len(prefix_oracles)
                else None
            )
            if got != want:
                with fail_lock:
                    failures.append(
                        f"view read at epoch {snap.epoch} is not the "
                        f"prefix-{snap.epoch} oracle (torn read?)"
                    )
                return

    threads = [
        threading.Thread(target=client, args=(i,))
        for i in range(args.clients)
    ] + [threading.Thread(target=view_reader) for _ in range(2)]
    for t in threads:
        t.start()
    for d in deltas:
        srv.apply_view("by_g1", "insert", "R1", d).result(timeout=600)
    for t in threads:
        t.join(timeout=600)
    failures.extend(f"{t.name} did not finish" for t in threads if t.is_alive())

    world = mesh_world()
    if world > 1:
        for name, q in queries.items():
            want, got = digest(solo[name]), digest(srv.query(q.mesh(world)))
            print(f"serve-smoke solo {name}: {want}")
            print(f"serve-smoke mesh({world}) {name}: {got}")
            if got != want:
                failures.append(f"{name}: .mesh({world}) != the solo execute")

    # TCP round-trip: remote result must equal the in-process oracle
    tcp, _ = serve_tcp(srv, args.host, 0)
    host, port = tcp.server_address
    try:
        with connect(host, port) as remote:
            if not remote.ping():
                failures.append("TCP ping unanswered")
            rres = remote.query(
                {
                    "relations": ["R1", "R2", "R3", "R4"],
                    "group_by": ["R1.g1"],
                    "aggs": {"n": {"kind": "count"}},
                }
            )
            check("count", rres)
            epoch, _ = remote.view_read("by_g1")
            if epoch != len(deltas):
                failures.append(
                    f"view at epoch {epoch}, expected {len(deltas)} after drain"
                )
            stats = remote.server_stats()
    finally:
        tcp.shutdown()
        tcp.server_close()
        srv.close()

    print(f"serve-smoke stats (device {stats['device']}):")
    for section in ("plan_cache", "fusion", "kernels"):
        print(f"  {section}: {stats[section]}")
    pc = stats["plan_cache"]
    total_queries = args.clients * args.queries_per_client
    if pc["compiles"] >= total_queries:
        failures.append(
            f"plan cache never warmed: {pc['compiles']} compiles for "
            f"{total_queries} queries"
        )
    if failures:
        print(f"serve-smoke FAILED ({len(failures)} problems):")
        for f in failures[:20]:
            print(f"  - {f}")
        return 1
    print(
        f"serve-smoke OK: {total_queries} concurrent queries over "
        f"{len(queries)} shapes, {len(deltas)} view batches, "
        f"{pc['compiles']} compiles ({pc['hits']} cache hits)"
    )
    return 0


def serve(args) -> int:
    if args.smoke:
        return run_smoke(args)

    db = demo_database(args.scale)
    core = start_server(
        db,
        args,
        workers=args.workers,
        plan_cache_size=args.plan_cache,
        fusion_window=args.fusion_window,
    )
    if core is None:
        return 0
    core.create_view(
        "by_g1", demo_queries()["count"]
    )  # a live maintained view, queryable via view_read/view_apply
    srv, thread = serve_tcp(core, args.host, args.port)
    host, port = srv.server_address
    print(f"JOIN-AGG server on {host}:{port}, device {core.device} "
          f"(C1 chain, {args.scale} rows/relation; view 'by_g1' maintained)")
    print("protocol: newline-delimited JSON — see repro_torch/serve/wire.py")
    try:
        thread.join()
    except KeyboardInterrupt:
        print("shutting down")
        srv.shutdown()
        srv.server_close()
        core.close()
    return 0


def main() -> None:
    ap = argparse.ArgumentParser(
        description="Serve concurrent JOIN-AGG queries over TCP/JSON"
    )
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7474)
    ap.add_argument("--device", default="cuda",
                    help="device the server computes on (cuda, or cpu)")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--fusion-window", type=float, default=0.002,
                    help="cross-client fusion window in seconds")
    ap.add_argument("--plan-cache", type=int, default=64,
                    help="prepared-plan cache capacity")
    ap.add_argument("--scale", type=int, default=5000,
                    help="rows per relation in the demo chain database")
    ap.add_argument("--smoke", action="store_true",
                    help="run the concurrent-correctness gate and exit")
    ap.add_argument("--clients", type=int, default=8,
                    help="(smoke) concurrent client threads")
    ap.add_argument("--queries-per-client", type=int, default=6)
    ap.add_argument("--view-batches", type=int, default=6,
                    help="(smoke) delta batches applied to the view")
    args = ap.parse_args()

    if mesh_world() > 1:
        import torch.distributed as dist

        args.device = join_mesh(args)
        try:
            code = serve(args)
        finally:
            dist.destroy_process_group()
        sys.exit(code)
    sys.exit(serve(args))


if __name__ == "__main__":
    main()
