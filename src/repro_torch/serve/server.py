"""The concurrent JOIN-AGG query server (DESIGN.md §9).

:class:`JoinAggServer` is the long-lived, in-process core: it owns the
registered :class:`~repro_torch.relational.relation.Database`, one
:class:`~repro_torch.api.engines.TorchChannelEngine` on its device, a
bounded prepared-plan cache, a worker pool, the cross-client fusion
batcher, and any maintained views.  Query paths, fastest first:

1. **warm cache** — a repeat shape finds its compiled
   :class:`~repro_torch.api.plan.Plan` in the
   :class:`~repro_torch.serve.cache.PlanCache` and goes straight to
   execution on the card: prepare, compile and the uploads of its device
   views are skipped;
2. **fusion** — cacheable shapes pass through the
   :class:`~repro_torch.serve.batcher.FusionBatcher`, so compatible
   queries landing within the window run as one contraction pass;
3. **solo** — uncacheable shapes (anonymous predicates, engine
   instances) compile fresh and run alone.

Every spec whose engine is the name ``"torch"`` (the ``Q`` default, and
what every wire request carries) runs on the server's engine, so
``device`` decides where every such answer is computed: ``"cuda"`` (the
default) raises at construction when no card is present, and nothing
falls back to the CPU; ``device="cpu"`` runs the same paths on the
kernels' plain versions.

Data registration is generational: ``register`` swaps in a *new*
database (in-flight plans keep executing against the snapshot they were
compiled on) and bumps the generation that keys the plan cache, so
stale plans become unreachable and age out of the LRU rather than
serving old data.

``serve_tcp`` wraps a server in the newline-delimited JSON protocol of
:mod:`repro_torch.serve.wire`.

Port of the JAX package's ``serve/server.py``.
"""
from __future__ import annotations

import json
import socketserver
import threading
import warnings
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path

from repro_torch.api.engines import TorchChannelEngine
from repro_torch.core.torch_engine import require_device
from repro_torch.kernels import ops
from repro_torch.relational.relation import Database, Relation
from repro_torch.relational.source import as_source, is_source
from repro_torch.serve import wire
from repro_torch.serve.batcher import FusionBatcher, _Pending, run_group
from repro_torch.serve.cache import PlanCache, plan_shape_key
from repro_torch.serve.views import ServedView


class JoinAggServer:
    """Concurrent JOIN-AGG service over a registered database, on one
    device."""

    def __init__(
        self,
        db: Database | None = None,
        *,
        device="cuda",
        workers: int = 8,
        plan_cache_size: int = 64,
        fusion_window: float = 0.002,
        fuse: bool = True,
        storage_dir: "str | Path | None" = None,
    ):
        """``storage_dir`` turns on write-through registration
        (DESIGN.md §12): registered relations are streamed to
        ``storage_dir/<name>/`` and served from the disk-backed copy,
        and maintained-view insert deltas append to the store."""
        self.device = require_device(device)
        if db is None and storage_dir is not None:
            catalog = Path(storage_dir) / "db.json"
            if catalog.is_file():
                from repro_torch.storage import open_database

                db = open_database(storage_dir)
        self._db = db if db is not None else Database()
        self._storage_dir = Path(storage_dir) if storage_dir is not None else None
        self._generation = 0
        # bumped whenever the statistics a cached plan was chosen on may
        # have changed (every registration changes the data the sketches
        # would be collected from); keys the plan cache (DESIGN.md §10)
        self._stats_generation = 0
        self._db_lock = threading.Lock()
        self.engine = TorchChannelEngine(device=self.device)
        self._pool = ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="joinagg-worker"
        )
        self.plan_cache = PlanCache(plan_cache_size, engine=self.engine)
        self._fuse = fuse
        self._batcher = FusionBatcher(self._dispatch, window=fusion_window)
        self._views: dict[str, ServedView] = {}
        self._views_lock = threading.Lock()
        self._closed = False

    # -- data registration ---------------------------------------------
    @property
    def db(self) -> Database:
        return self._db

    @property
    def generation(self) -> int:
        return self._generation

    @property
    def stats_generation(self) -> int:
        return self._stats_generation

    def bump_stats(self) -> int:
        """Invalidate cached plans after an out-of-band statistics
        refresh (e.g. a maintained view's deltas drifted the sketches the
        planner chose roots/splits on)."""
        with self._db_lock:
            self._stats_generation += 1
            return self._stats_generation

    def register(self, name: str, columns) -> int:
        """Register (or replace) a relation; returns the new generation.

        ``columns`` is anything speaking the
        :class:`~repro_torch.relational.source.RelationSource` protocol —
        an in-memory ``Relation``, a disk-backed ``StoredRelation``, or a
        column mapping (the legacy eager-copy spelling, deprecated).
        The database is swapped, not mutated: queries already compiled
        keep their snapshot, and the generation bump makes every cached
        plan key unreachable so the next lookup recompiles on new data.
        """
        if not is_source(columns):
            warnings.warn(
                "registering a raw column mapping copies it eagerly; pass "
                "a Relation / RelationSource (one ingestion surface, "
                "DESIGN.md §12)",
                DeprecationWarning,
                stacklevel=2,
            )
            if isinstance(columns, dict):
                columns = wire.columns_from_json(columns)
            else:
                columns = dict(columns)
        rel = as_source(columns, name)
        if self._storage_dir is not None:
            from repro_torch.storage import write_relation

            rel = write_relation(rel, self._storage_dir / name)
            self._write_catalog(name)
        with self._db_lock:
            new_db = Database(dict(self._db.relations))
            new_db.add(rel)
            self._db = new_db
            self._generation += 1
            self._stats_generation += 1
            return self._generation

    def _write_catalog(self, name: str) -> None:
        """Refresh ``storage_dir/db.json`` after a write-through
        registration so the directory stays mountable via
        ``storage.open_database``."""
        from repro_torch.storage.database import CATALOG_NAME, CATALOG_VERSION

        names = sorted(set(self._db.relations) | {name})
        doc = {"version": CATALOG_VERSION, "relations": names}
        tmp = self._storage_dir / (CATALOG_NAME + ".tmp")
        tmp.write_text(json.dumps(doc, indent=2) + "\n")
        tmp.replace(self._storage_dir / CATALOG_NAME)

    # -- queries --------------------------------------------------------
    def submit(self, spec) -> Future:
        """Queue one query; resolves to its
        :class:`~repro_torch.api.plan.AggResult`."""
        if self._closed:
            raise RuntimeError("server is closed")
        with self._db_lock:
            generation = self._generation
            stats_gen = self._stats_generation
        key = plan_shape_key(spec, generation, stats_gen)
        item = _Pending(spec=spec, shape_key=key, future=Future())
        if self._fuse and key is not None:
            self._batcher.submit(item)
        else:
            self._pool.submit(self._run_items, [item])
        return item.future

    def query(self, spec):
        """Run one query to completion (blocking convenience wrapper)."""
        return self.submit(spec).result()

    def _dispatch(self, items: list[_Pending]) -> None:
        self._pool.submit(self._run_items, items)

    def _run_items(self, items: list[_Pending]) -> None:
        run_group(items, self._lookup_plan, self._batcher.stats)

    def _lookup_plan(self, spec):
        with self._db_lock:
            db, generation = self._db, self._generation
            stats_gen = self._stats_generation
        return self.plan_cache.lookup(spec, db, generation, stats_gen)

    # -- maintained views -----------------------------------------------
    def create_view(self, name: str, spec) -> ServedView:
        """Compile ``spec``, hand it to the incremental-maintenance stack
        (its message caches on the server's device), and serve it under
        ``name`` via epoch-swapped snapshots."""
        plan = self._lookup_plan(spec)
        handle = plan.maintain()
        on_applied = self._persist_delta if self._storage_dir is not None else None
        with self._views_lock:
            if name in self._views:
                raise ValueError(f"view {name!r} already exists")
            view = self._views[name] = ServedView(name, handle, on_applied)
        return view

    def _persist_delta(self, op: str, rel: str, cols) -> None:
        """Write-through for maintained-view deltas: insert batches append
        to the relation's on-disk store (deletes only adjust the
        maintained state — the append-only column files keep history)."""
        if op != "insert":
            return
        from repro_torch.storage.store import StoredRelation

        with self._db_lock:
            target = self._db.relations.get(rel)
        if isinstance(target, StoredRelation):
            target.append(cols)

    def view(self, name: str) -> ServedView:
        with self._views_lock:
            try:
                return self._views[name]
            except KeyError:
                raise KeyError(f"no view named {name!r}") from None

    def read_view(self, name: str):
        return self.view(name).read()

    def apply_view(self, name: str, op: str, rel: str, tuples) -> Future:
        return self.view(name).apply(op, rel, tuples)

    def drop_view(self, name: str) -> None:
        with self._views_lock:
            view = self._views.pop(name, None)
        if view is not None:
            view.close()

    # -- introspection / lifecycle --------------------------------------
    def stats(self) -> dict:
        """Counters for reporting: the plan cache, the batcher, the
        views' epochs, the server's device and the process's kernel
        launches (the port has no jit cache to report)."""
        with self._views_lock:
            views = {n: v.epoch for n, v in self._views.items()}
        return {
            "generation": self._generation,
            "stats_generation": self._stats_generation,
            "relations": sorted(self._db.relations),
            "plan_cache": self.plan_cache.stats.snapshot(),
            "fusion": self._batcher.stats.snapshot(),
            "views": views,
            "device": str(self.device),
            "kernels": ops.launch_counts(),
        }

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._batcher.close()
        # the batcher's final flush handed stragglers to the pool
        self._pool.shutdown(wait=True)
        with self._views_lock:
            views = list(self._views.values())
            self._views.clear()
        for v in views:
            v.close()

    def __enter__(self) -> "JoinAggServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ----------------------------------------------------------------------
# TCP/JSON line frontend
# ----------------------------------------------------------------------


class _Handler(socketserver.StreamRequestHandler):
    """One client connection: newline-delimited JSON requests in, JSON
    responses out (see :mod:`repro_torch.serve.wire` for the schema)."""

    def handle(self) -> None:
        core: JoinAggServer = self.server.core  # type: ignore[attr-defined]
        for raw in self.rfile:
            line = raw.strip()
            if not line:
                continue
            try:
                req = json.loads(line)
                resp = self._serve_one(core, req)
                payload = json.dumps(resp, separators=(",", ":")) + "\n"
            except Exception as e:  # malformed request / failed query
                resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
                payload = json.dumps(resp, separators=(",", ":")) + "\n"
            try:
                self.wfile.write(payload.encode("utf-8"))
                self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                return

    def _serve_one(self, core: JoinAggServer, req: dict) -> dict:
        op = req.get("op")
        if op == "ping":
            return {"ok": True, "pong": True}
        if op == "query":
            spec = wire.q_from_spec(req["q"])
            return {"ok": True, "result": wire.result_to_json(core.query(spec))}
        if op == "register":
            rel = Relation(req["name"], wire.columns_from_json(req["columns"]))
            gen = core.register(req["name"], rel)
            return {"ok": True, "generation": gen}
        if op == "view_create":
            view = core.create_view(req["name"], wire.q_from_spec(req["q"]))
            return {"ok": True, "epoch": view.epoch}
        if op == "view_read":
            snap = core.read_view(req["name"])
            res = snap.result
            if isinstance(res, dict):
                body = {
                    "kind": "dict",
                    "rows": [
                        [[wire.plain(x) for x in k], wire.plain(v)]
                        for k, v in sorted(res.items())
                    ],
                }
            else:
                body = {"kind": "agg", **wire.result_to_json(res)}
            return {"ok": True, "epoch": snap.epoch, "result": body}
        if op == "view_apply":
            delta = req["delta"]
            fut = core.apply_view(
                req["name"], delta["op"], delta["rel"],
                wire.columns_from_json(delta["columns"]),
            )
            return {"ok": True, "epoch": fut.result()}
        if op == "stats":
            return {"ok": True, "stats": core.stats()}
        raise ValueError(f"unknown op {op!r}")


class _TCPServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, addr, core: JoinAggServer):
        self.core = core
        super().__init__(addr, _Handler)


def serve_tcp(
    core: JoinAggServer, host: str = "127.0.0.1", port: int = 0
) -> tuple[_TCPServer, threading.Thread]:
    """Expose ``core`` over TCP; returns the socket server (its
    ``server_address`` carries the bound port when ``port=0``) and the
    accept-loop thread.  Call ``server.shutdown()`` and
    ``server.server_close()`` to stop."""
    srv = _TCPServer((host, port), core)
    thread = threading.Thread(
        target=srv.serve_forever, name="joinagg-tcp", daemon=True
    )
    thread.start()
    return srv, thread
