"""Meshed requests in the query server: one ordered lane on rank 0, a
follower loop on ranks 1…S−1 (DESIGN.md §8, §9).

The JAX package serves a ``.mesh(S)`` query like any other.  JAX has one
controller: ``shard_map`` drives every local device from the worker
thread that executes the plan, so no other process takes part.  The
port's mesh is SPMD over ``torch.distributed``: every rank of the group
makes the same ``Plan.execute()`` call and joins one ``all_gather``.  A
server on rank 0 therefore needs the other ranks in a follower loop, and
it must

* issue its meshed executes one at a time, in one order;
* have every rank compile the same plan against the same data
  generation;
* never leave a follower waiting in a collective that rank 0 has given
  up on.

So this module has no counterpart in the JAX package.

Every rank calls :func:`serve_mesh` after ``init_process_group``.  It
creates a gloo *control group* (control messages are host objects, and
gloo carries them whatever the data backend), checks that every rank
holds the same relations and row counts, and then returns a
:class:`~repro_torch.serve.server.JoinAggServer` with a :class:`MeshLane`
attached on rank 0; ranks 1…S−1 run :meth:`MeshFollower.follow` until
rank 0 closes the server, and then return None.

One meshed execute, under the lane's lock:

1. rank 0 broadcasts the spec as a picklable description
   (:func:`describe_spec`; each rank rebuilds the same ``Q`` through
   ``Q``'s own methods), its shape key and the data and statistics
   generations;
2. every rank compiles, or finds, its plan in its own
   :class:`~repro_torch.serve.cache.PlanCache`; a key that differs from
   rank 0's is an error on that rank, never a wrong answer;
3. every rank reports ok or its error text, and the row counts and
   dictionary sizes its plan was prepared on (``all_gather_object`` on
   the control group); a rank whose counts differ from rank 0's is
   refused, so data that drifted apart gives an error, not a collective
   over shards of different shapes;
4. only when all are ok does every rank call ``plan.execute()``, the
   collective on the data group; otherwise no rank enters it, and rank 0
   raises with the failing rank's message.

The spec sent is the one rank 0 executes: the merged bundle of a channel
merge, or each item of a rejected merge, since the lane runs at execute
time.  ``register`` and ``bump_stats`` on rank 0 pass through the lane as
well, so every rank's generations stay equal to rank 0's: an in-memory
relation travels as its numpy columns, a stored one as its directory.
Unmeshed queries never take the lane and run in parallel on rank 0's
workers; ``.mesh(1)`` runs on rank 0 alone.  A ``DeviceMesh`` spec runs
solo: rank 0 sends the mesh's device type, rank layout and dimension
names, and every rank builds that ``DeviceMesh`` once, in lane order.

Limits.  A failure inside the collective (a rank that raises in its walk,
or dies) is bounded by the data group's timeout: rank 0's execute raises,
and the lane closes, so every later meshed spec gets an error that names
the first failure, while unmeshed serving goes on.  A failure inside a
control-group collective (a follower that died, or timed out) closes the
lane the same way; rank 0 then sends no stop, since no follower is known
to be listening.  The lane does not bring the ranks back in step after
either failure.  A follower waits for the next message inside a
collective of the control group, whose timeout is ``CONTROL_TIMEOUT``
(7 days): a server idle for longer loses its followers, each of which
raises out of :func:`serve_mesh` (under ``torchrun`` that ends the job),
and rank 0's next meshed spec closes the lane.  A predicate given as a
callable, or an engine given as an instance, cannot cross processes: a
meshed spec that carries one is refused on rank 0.
"""
from __future__ import annotations

import datetime
import sys
import threading
import time
import traceback
from collections import deque

import torch
import torch.distributed as dist

from repro_torch.api.builder import Q
from repro_torch.api.engines import TorchChannelEngine
from repro_torch.core.distributed import _is_device_mesh, resolve_mesh
from repro_torch.core.operator import UnsupportedPlanOption
from repro_torch.core.torch_engine import require_device
from repro_torch.kernels import ops
from repro_torch.relational.relation import Database, Relation
from repro_torch.relational.source import materialize_columns
from repro_torch.serve.cache import PlanCache, plan_shape_key

CONTROL_TIMEOUT = datetime.timedelta(days=7)


# ----------------------------------------------------------------------
# specs across ranks
# ----------------------------------------------------------------------


def describe_spec(spec) -> dict:
    """A picklable description of a ``Q`` spec, from which
    :func:`rebuild_spec` builds the same ``Q`` on another rank.  Raises
    :class:`UnsupportedPlanOption` for what cannot cross processes: a
    callable predicate or an engine instance."""
    if not isinstance(spec.engine_name, str):
        raise UnsupportedPlanOption(
            "a meshed query names its engine (the server's 'torch' or a "
            "registered name): an engine instance cannot cross ranks"
        )
    where = []
    for p in spec.predicates:
        if p.form is None:
            raise UnsupportedPlanOption(
                f"a meshed query cannot carry the callable predicate {p.label!r} "
                f"on {p.relation!r}: a function cannot cross ranks; use the "
                "declarative form .where(relation, attr, op, value)"
            )
        where.append((p.relation, *p.form))
    mesh = spec.mesh_opt
    if _is_device_mesh(mesh):
        mesh = (
            "device_mesh", mesh.device_type, tuple(mesh.mesh.shape),
            tuple(mesh.mesh.flatten().tolist()), mesh.mesh_dim_names,
        )
    return {
        "relations": spec.relations, "renames": spec.renames, "where": tuple(where),
        "group_by": spec.group_attrs, "aggs": spec.aggs, "engine": spec.engine_name,
        "budget": spec.budget, "stream": spec.stream_opt, "stats": spec.stats_opt,
        "fused": spec.fused_opt, "mesh": mesh,
    }


def rebuild_spec(desc: dict, meshes: dict) -> Q:
    """The ``Q`` that :func:`describe_spec` described, built through
    ``Q``'s methods.  A ``DeviceMesh`` is built on first use and kept in
    ``meshes`` under its description, so every rank builds it once, in
    lane order (building one may create process groups, a collective)."""
    q = Q.over(*desc["relations"])
    for rel, mapping in desc["renames"]:
        q = q.rename(rel, **dict(mapping))
    for rel, attr, op, value in desc["where"]:
        q = q.where(rel, attr, op, value)
    q = q.group_by(*desc["group_by"])
    if desc["aggs"]:
        q = q.agg(**dict(desc["aggs"]))
    q = q.engine(desc["engine"]).stats(desc["stats"])
    if desc["budget"] is not None:
        q = q.memory_budget(desc["budget"])
    if desc["stream"] is not None:
        q = q.stream(*desc["stream"])
    if desc["fused"] is not None:
        q = q.fused(desc["fused"])
    mesh = desc["mesh"]
    if isinstance(mesh, tuple):
        if mesh not in meshes:
            from torch.distributed.device_mesh import DeviceMesh

            _, device_type, shape, ranks, names = mesh
            meshes[mesh] = DeviceMesh(
                device_type, torch.tensor(ranks).reshape(shape), mesh_dim_names=names
            )
        mesh = meshes[mesh]
    return q.mesh(mesh)


def prepare_execute(msg: dict, cache: PlanCache, db, generation: int,
                    stats_generation: int, meshes: dict):
    """One rank's step 2 of a meshed execute: ``(status, plan)``, the
    status ``{"error": text or None, "compiles": n, "layout": ...}``.
    The plan is None unless the rank's own shape key equals rank 0's,
    the plan compiled and the mesh resolves on this rank's group;
    ``layout`` is what :func:`refusals` compares across ranks."""
    try:
        # first, as every rank does: building a DeviceMesh may be collective
        spec = rebuild_spec(msg["spec"], meshes)
        if (generation, stats_generation) != (msg["generation"], msg["stats_generation"]):
            raise RuntimeError(
                f"this rank holds data generation {generation} and statistics "
                f"generation {stats_generation}; rank 0 holds "
                f"{msg['generation']} and {msg['stats_generation']}"
            )
        key = plan_shape_key(spec, generation, stats_generation)
        if key != msg["key"]:
            raise RuntimeError(f"shape key {key} differs from rank 0's {msg['key']}")
        resolve_mesh(spec.mesh_opt)
        plan = cache.lookup(spec, db, generation, stats_generation)
        prep = plan.prep
        layout = (
            {rel: int(er.num_rows) for rel, er in sorted(prep.encoded.items())},
            {attr: int(d.size) for attr, d in sorted(prep.dicts.items())},
        )
        error = None
    except Exception as e:
        plan, layout, error = None, None, f"{type(e).__name__}: {e}"
    return {"error": error, "compiles": cache.stats.compiles, "layout": layout}, plan


def refusals(statuses: list[dict]) -> list[str]:
    """Why the ranks must not enter a meshed execute, from every rank's
    status (the same list on every rank, so every rank decides alike):
    each rank's error, and each rank whose prepared row counts and
    dictionary sizes differ from rank 0's."""
    out = [f"rank {r}: {s['error']}" for r, s in enumerate(statuses) if s["error"]]
    if not out:
        out = [
            f"rank {r}: prepared on {s['layout']}, rank 0 on {statuses[0]['layout']}"
            for r, s in enumerate(statuses) if s["layout"] != statuses[0]["layout"]
        ]
    return out


def register_message(name: str, rel) -> dict:
    """A registration as it crosses ranks: a stored relation as its
    directory, anything else as its numpy columns."""
    from repro_torch.storage.store import StoredRelation

    if isinstance(rel, StoredRelation):
        return {"op": "register", "name": name, "directory": str(rel.directory)}
    return {"op": "register", "name": name, "columns": materialize_columns(rel)}


def relation_of(msg: dict):
    """The relation a :func:`register_message` carries, opened or built
    on this rank."""
    if "directory" in msg:
        from repro_torch.relational.source import as_source
        from repro_torch.storage import open_relation

        return as_source(open_relation(msg["directory"]), msg["name"])
    return Relation(msg["name"], msg["columns"])


def _report(cache: PlanCache, error: str | None = None) -> dict:
    return {"error": error, "compiles": cache.stats.compiles, "launches": ops.launch_counts()}


def _closed(stopped: bool, failure: str | None) -> str | None:
    """Why a lane takes no more meshed executes, if it does not."""
    if stopped:
        return "the mesh lane is stopped: the server closed"
    if failure is not None:
        return f"the mesh lane closed after a failure: {failure}"
    return None


def _gather(group, status: dict) -> list[dict]:
    """Every rank's ``status``, in rank order, on every rank."""
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, status, group=group)
    return out


# ----------------------------------------------------------------------
# rank 0: the lane
# ----------------------------------------------------------------------


class MeshLane:
    """Rank 0's ordered lane of meshed executes and mirrored
    registrations (see the module docstring).  ``records`` keeps the
    last 256 executes' ``lane_ms`` (the control message and the confirm,
    apart from compiling), ``lookup_ms`` and ``execute_ms``;
    ``rank_compiles`` every rank's compile count as of the last confirm;
    ``final`` every rank's compiles and launches, gathered at close."""

    def __init__(self, control, world: int):
        self._control = control
        self.world = world
        self._lock = threading.Lock()
        self._meshes: dict = {}  # guarded-by: _lock
        self._failure: str | None = None  # guarded-by: _lock
        self._control_ok = True  # guarded-by: _lock
        self._stopped = False  # guarded-by: _lock
        self.executes = 0  # guarded-by: _lock
        self.records: deque = deque(maxlen=256)  # guarded-by: _lock
        self.rank_compiles: list[int] = [0] * world  # guarded-by: _lock
        self.final: list[dict] | None = None

    def _send(self, msg: dict) -> None:  # guarded-by: _lock
        self._on_control(dist.broadcast_object_list, [msg], src=0, group=self._control)

    def _confirm(self, status: dict) -> list[dict]:  # guarded-by: _lock
        return self._on_control(_gather, self._control, status)

    def _on_control(self, collective, *args, **kwargs):  # guarded-by: _lock
        """A collective on the control group; one that raises closes the
        lane, since no follower is then known to be in step."""
        try:
            return collective(*args, **kwargs)
        except BaseException as e:
            self._failure = f"the control group failed: {type(e).__name__}: {e}"
            self._control_ok = False
            raise

    def admit(self, spec) -> None:
        """Refuse, before it queues, a meshed spec the lane cannot run:
        a closed lane, a shard count other than the group's, a callable
        predicate or an engine instance."""
        describe_spec(spec)
        mesh = spec.mesh_opt
        if isinstance(mesh, int) and mesh != self.world:
            raise UnsupportedPlanOption(
                f"mesh over {mesh} shards, but the server's process group has "
                f"{self.world} ranks: use .mesh({self.world}) or .mesh(1)"
            )
        with self._lock:
            refusal = _closed(self._stopped, self._failure)
        if refusal is not None:
            raise RuntimeError(refusal)

    def execute(self, server, spec):
        """Run one meshed spec on every rank (steps 1–4 of the module
        docstring); rank 0's answer."""
        desc = describe_spec(spec)
        with self._lock:
            refusal = _closed(self._stopped, self._failure)
            if refusal is not None:
                raise RuntimeError(refusal)
            t0 = time.perf_counter()
            db, generation, stats_generation = server._snapshot()
            msg = {
                "op": "execute", "spec": desc, "generation": generation,
                "stats_generation": stats_generation,
                "key": plan_shape_key(spec, generation, stats_generation),
            }
            self._send(msg)
            t1 = time.perf_counter()
            status, plan = prepare_execute(
                msg, server.plan_cache, db, generation, stats_generation, self._meshes
            )
            t2 = time.perf_counter()
            statuses = self._confirm(status)
            t3 = time.perf_counter()
            self.rank_compiles = [s["compiles"] for s in statuses]
            refused = refusals(statuses)
            if refused:
                raise RuntimeError(
                    "meshed execute refused, no rank entered it: " + "; ".join(refused)
                )
            try:
                result = plan.execute()
            except BaseException as e:
                self._failure = f"{type(e).__name__}: {e}"
                raise
            t4 = time.perf_counter()
            self.executes += 1
            self.records.append({
                "lane_ms": ((t1 - t0) + (t3 - t2)) * 1e3,
                "lookup_ms": (t2 - t1) * 1e3, "execute_ms": (t4 - t3) * 1e3,
            })
            return result

    def mirror(self, msg: dict, apply):
        """Send a registration message (``register`` or ``bump_stats``),
        run ``apply()`` on rank 0, and confirm every rank applied it;
        ``apply()``'s value.  A follower that failed keeps its old
        generation, so every later meshed execute is refused on it.  A
        control-group failure closes the lane and is raised; rank 0 has
        applied the message when it came in the confirm, and applies
        every later one alone."""
        with self._lock:
            if _closed(self._stopped, self._failure) is not None:
                return apply()  # no follower is listening, or in step
            self._send(msg)
            try:
                value, error = apply(), None
            except Exception as e:
                value, error = e, f"{type(e).__name__}: {e}"
            statuses = self._confirm({"error": error})
        if error is not None:
            raise value
        failed = [(r, s["error"]) for r, s in enumerate(statuses) if s["error"]]
        if failed:
            raise RuntimeError(
                f"{msg['op']} applied on rank 0 but not on "
                + "; ".join(f"rank {r}: {e}" for r, e in failed)
            )
        return value

    def close(self, cache: PlanCache) -> None:
        """Stop every follower; gather each rank's compiles and launches
        into ``final``.  After a control-group failure no stop is sent
        and ``final`` stays None."""
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            if not self._control_ok:
                return
            self._send({"op": "stop"})
            self.final = self._confirm(_report(cache))

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "world": self.world, "executes": self.executes,
                "rank_compiles": list(self.rank_compiles),
                "failure": self._failure, "stopped": self._stopped,
            }


# ----------------------------------------------------------------------
# ranks 1…S−1: the follower loop
# ----------------------------------------------------------------------


class MeshFollower:
    """A follower rank's mirror of the server on rank 0: its own
    database and generations, kept equal through the lane's messages,
    and its own plan cache on its own engine."""

    def __init__(self, control, db: Database, *, device="cuda", plan_cache_size: int = 64):
        self._control = control
        self.db = db
        self.generation = 0
        self.stats_generation = 0
        self.plan_cache = PlanCache(plan_cache_size, engine=TorchChannelEngine(device=device))
        self._meshes: dict = {}
        self.errors: list[str] = []

    def _apply(self, msg: dict) -> None:
        if msg["op"] == "register":
            rel = relation_of(msg)
            db = Database(dict(self.db.relations))
            db.add(rel)
            self.db = db
            self.generation += 1
        self.stats_generation += 1  # both ops invalidate the statistics

    def follow(self) -> None:
        """Answer rank 0's messages in order until it sends ``stop``."""
        while True:
            box = [None]
            dist.broadcast_object_list(box, src=0, group=self._control)
            msg = box[0]
            op = msg["op"]
            if op == "stop":
                _gather(self._control, _report(self.plan_cache, "; ".join(self.errors) or None))
                return
            if op in ("register", "bump_stats"):
                try:
                    self._apply(msg)
                    error = None
                except Exception as e:
                    error = f"{type(e).__name__}: {e}"
                _gather(self._control, {"error": error})
                continue
            status, plan = prepare_execute(
                msg, self.plan_cache, self.db, self.generation, self.stats_generation,
                self._meshes,
            )
            if refusals(_gather(self._control, status)):
                continue
            try:
                plan.execute()
            except Exception:
                # rank 0 sees the collective fail (its timeout) and closes
                # the lane; keep following so that its stop is answered
                self.errors.append(traceback.format_exc(limit=3))
                print(f"mesh follower rank {dist.get_rank()}: meshed execute failed:\n"
                      f"{self.errors[-1]}", file=sys.stderr, flush=True)


# ----------------------------------------------------------------------
# the entry point
# ----------------------------------------------------------------------


def serve_mesh(db: Database | None, **server_kwargs):
    """Start a meshed server; every rank of an initialised process group
    calls it.  Rank 0 gets a
    :class:`~repro_torch.serve.server.JoinAggServer` (``server_kwargs``
    as its constructor takes them) whose meshed specs run through a
    :class:`MeshLane`; every other rank follows rank 0's lane until the
    server closes and then returns None.  Raises on every rank when a
    rank cannot start or holds other relations or row counts."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "serve_mesh needs an initialised process group: call "
            "torch.distributed.init_process_group on every rank first, or "
            "launch with torchrun"
        )
    control = dist.new_group(backend="gloo", timeout=CONTROL_TIMEOUT)
    rank, world = dist.get_rank(), dist.get_world_size()
    server = follower = error = None
    try:
        if rank == 0:
            from repro_torch.serve.server import JoinAggServer

            server = JoinAggServer(db, **server_kwargs)
            db = server.db
        else:
            require_device(server_kwargs.get("device", "cuda"))
            follower = MeshFollower(
                control, db if db is not None else Database(),
                device=server_kwargs.get("device", "cuda"),
                plan_cache_size=server_kwargs.get("plan_cache_size", 64),
            )
            db = follower.db
    except Exception as e:
        error = f"{type(e).__name__}: {e}"
    layout = None if db is None else {n: int(r.num_rows) for n, r in sorted(db.relations.items())}
    starts = _gather(control, {"error": error, "relations": layout})
    problems = [f"rank {r}: {s['error']}" for r, s in enumerate(starts) if s["error"]]
    problems += [
        f"rank {r} holds {s['relations']}, rank 0 {starts[0]['relations']}"
        for r, s in enumerate(starts) if not s["error"] and s["relations"] != starts[0]["relations"]
    ]
    if problems:
        if server is not None:
            server.close()
        raise RuntimeError("serve_mesh could not start: " + "; ".join(problems))
    if rank == 0:
        server._lane = MeshLane(control, world)
        return server
    follower.follow()
    return None
