"""Client sessions for the JOIN-AGG server (DESIGN.md §9).

* :class:`Session` — the in-process client: a thin per-client handle on a
  :class:`~repro_torch.serve.server.JoinAggServer` with prepared-statement
  ergonomics (``prepare`` once, ``execute`` many — every execution rides
  the server's plan cache and fusion batcher) and per-session counters.
* :class:`RemoteSession` / :func:`connect` — the TCP client speaking the
  newline-delimited JSON protocol of :mod:`repro_torch.serve.wire`.
  One request in flight per session (the protocol is strictly
  request/response per connection); open one session per client thread.

Port of the JAX package's ``serve/session.py``.
"""
from __future__ import annotations

import json
import socket
import threading
from concurrent.futures import Future
from dataclasses import dataclass, field

from repro_torch.serve import wire


@dataclass
class SessionStats:
    queries: int = 0
    view_reads: int = 0
    view_writes: int = 0

    def snapshot(self) -> dict[str, int]:
        return {
            "queries": self.queries,
            "view_reads": self.view_reads,
            "view_writes": self.view_writes,
        }


@dataclass
class PreparedStatement:
    """A query shape held by a session; every ``execute()`` goes through
    the server's plan cache, so only the first is a compile."""

    session: "Session"
    spec: "object"

    def execute(self):
        return self.session.query(self.spec)

    def submit(self) -> Future:
        return self.session.submit(self.spec)


@dataclass
class Session:
    """In-process client handle on a :class:`JoinAggServer`."""

    server: "object"
    stats: SessionStats = field(default_factory=SessionStats)

    def prepare(self, spec) -> PreparedStatement:
        return PreparedStatement(self, spec)

    def submit(self, spec) -> Future:
        self.stats.queries += 1
        return self.server.submit(spec)

    def query(self, spec):
        return self.submit(spec).result()

    def read_view(self, name: str):
        self.stats.view_reads += 1
        return self.server.read_view(name)

    def apply_view(self, name: str, op: str, rel: str, tuples) -> Future:
        self.stats.view_writes += 1
        return self.server.apply_view(name, op, rel, tuples)


class RemoteSession:
    """TCP client: one socket, one request in flight at a time."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._sock = socket.create_connection((host, port))
        self._rfile = self._sock.makefile("rb")
        self._lock = threading.Lock()
        self.stats = SessionStats()

    # -- protocol -------------------------------------------------------
    def call(self, req: dict) -> dict:
        """One round-trip; raises ``RuntimeError`` on an error response."""
        payload = json.dumps(req, separators=(",", ":")) + "\n"
        with self._lock:
            self._sock.sendall(payload.encode("utf-8"))
            line = self._rfile.readline()
        if not line:
            raise ConnectionError("server closed the connection")
        resp = json.loads(line)
        if not resp.get("ok"):
            raise RuntimeError(resp.get("error", "unknown server error"))
        return resp

    # -- convenience wrappers ------------------------------------------
    def ping(self) -> bool:
        return bool(self.call({"op": "ping"}).get("pong"))

    def query(self, q_json: dict):
        """Run a query given as its JSON spec; returns an
        :class:`~repro_torch.api.plan.AggResult`."""
        self.stats.queries += 1
        resp = self.call({"op": "query", "q": q_json})
        return wire.result_from_json(resp["result"])

    def register(self, name: str, columns: dict) -> int:
        return self.call(
            {"op": "register", "name": name,
             "columns": {a: list(map(wire.plain, c)) for a, c in columns.items()}}
        )["generation"]

    def view_create(self, name: str, q_json: dict) -> int:
        return self.call({"op": "view_create", "name": name, "q": q_json})[
            "epoch"
        ]

    def view_read(self, name: str) -> tuple[int, object]:
        """Returns ``(epoch, result)`` — a ``{group tuple: value}`` dict
        for single-aggregate views, an ``AggResult`` otherwise."""
        self.stats.view_reads += 1
        resp = self.call({"op": "view_read", "name": name})
        body = resp["result"]
        if body.get("kind") == "dict":
            result = {tuple(k): v for k, v in body["rows"]}
        else:
            result = wire.result_from_json(body)
        return resp["epoch"], result

    def view_apply(self, name: str, op: str, rel: str, columns: dict) -> int:
        self.stats.view_writes += 1
        return self.call(
            {"op": "view_apply", "name": name,
             "delta": {"op": op, "rel": rel,
                       "columns": {a: list(map(wire.plain, c))
                                   for a, c in columns.items()}}}
        )["epoch"]

    def server_stats(self) -> dict:
        return self.call({"op": "stats"})["stats"]

    def close(self) -> None:
        try:
            self._rfile.close()
        finally:
            self._sock.close()

    def __enter__(self) -> "RemoteSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def connect(host: str = "127.0.0.1", port: int = 0) -> RemoteSession:
    """Open a :class:`RemoteSession` to a running server."""
    return RemoteSession(host, port)

