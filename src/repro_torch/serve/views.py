"""Maintained-view serving: snapshot reads under a single writer
(DESIGN.md §9).

A :class:`ServedView` owns one incremental-maintenance handle
(:class:`~repro_torch.incremental.maintained.MaintainedJoinAgg` or the
planner's :class:`~repro_torch.api.maintain.MaintainedPlan`, their
message caches on the handle's device) and splits its callers into
exactly one **writer thread** and any number of readers:

* Writers never touch the handle directly — :meth:`insert` /
  :meth:`delete` enqueue delta batches; the view's single writer thread
  drains the queue in order and applies each batch.  The maintained
  state (message caches on the card, ``GrowableDictionary`` growth, the
  result dict) is therefore only ever mutated from one thread.
* After each batch the writer builds an immutable :class:`ViewSnapshot`
  — a *copy* of the result plus the batch epoch — and publishes it with
  a single reference swap.  Readers (:meth:`read`) only ever see a
  fully-applied snapshot: epoch ``e`` is bit-identical to replaying
  delta batches ``1..e`` on a fresh handle, never a torn intermediate.
  A snapshot holds host values only: the handle's ``result()`` is
  assembled on the host after the refresh has synchronised, so no
  published snapshot aliases a device tensor a later refresh updates in
  place.

``apply(...)`` returns a future resolving to the batch's epoch, so a
writer can read-your-writes by waiting for it and then requiring
``read().epoch >= that``.

Port of the JAX package's ``serve/views.py``.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from dataclasses import dataclass

import numpy as np

from repro_torch.incremental.maintained import _columns_of


@dataclass(frozen=True)
class ViewSnapshot:
    """One published view state: ``epoch`` delta batches applied."""

    epoch: int
    result: "object"  # dict[tuple, float] or AggResult (see as_dict)

    def as_dict(self) -> dict[tuple, float]:
        """Uniform ``{group tuple: value}`` access for single-aggregate
        views; multi-aggregate snapshots keep their AggResult shape."""
        if isinstance(self.result, dict):
            return dict(self.result)
        res = self.result
        if len(res.agg_names) != 1:
            raise ValueError(
                f"view has aggregates {res.agg_names}; use .result directly"
            )
        return res.to_dict(res.agg_names[0])


@dataclass
class _Delta:
    op: str  # "insert" | "delete" | "drain"
    rel: str
    cols: dict[str, np.ndarray]
    future: Future


class ServedView:
    """A maintained JOIN-AGG view served from epoch-swapped snapshots."""

    def __init__(self, name: str, handle, on_applied=None):
        self.name = name
        self.handle = handle
        # optional persistence hook ``on_applied(op, rel, cols)`` invoked
        # from the writer thread after each successfully-applied batch —
        # the serving layer's write-through to the storage tier
        # (DESIGN.md §12); a hook failure fails that batch's future
        self._on_applied = on_applied
        # published by one reference store, read without a lock — readers
        # see either the old or the new fully-built snapshot, never torn
        self._snap = ViewSnapshot(0, self._copy_result())
        self._queue: queue.Queue[_Delta | None] = queue.Queue()
        self._lock = threading.Lock()
        self._closed = False  # guarded-by: _lock
        self._writer = threading.Thread(
            target=self._writer_loop, name=f"joinagg-view-{name}", daemon=True
        )
        self._writer.start()

    # -- reads ----------------------------------------------------------
    def read(self) -> ViewSnapshot:
        """The latest fully-applied snapshot (never blocks on the writer)."""
        return self._snap

    @property
    def epoch(self) -> int:
        return self._snap.epoch

    # -- writes ---------------------------------------------------------
    def insert(self, rel: str, tuples) -> Future:
        return self._enqueue("insert", rel, tuples)

    def delete(self, rel: str, tuples) -> Future:
        return self._enqueue("delete", rel, tuples)

    def apply(self, op: str, rel: str, tuples) -> Future:
        if op not in ("insert", "delete"):
            raise ValueError(f"view delta op must be insert/delete, not {op!r}")
        return self._enqueue(op, rel, tuples)

    def _enqueue(self, op: str, rel: str, tuples) -> Future:
        cols = _delta_columns(tuples)
        fut: Future = Future()
        # check-and-enqueue under the lock, so no delta can slip in
        # behind close()'s shutdown sentinel and hang its future
        with self._lock:
            if self._closed:
                raise RuntimeError(f"view {self.name!r} is closed")
            self._queue.put(_Delta(op, rel, cols, fut))
        return fut

    def drain(self) -> int:
        """Block until every currently-enqueued delta is applied; returns
        the epoch after the drain."""
        fut: Future = Future()
        with self._lock:
            if self._closed:
                raise RuntimeError(f"view {self.name!r} is closed")
            self._queue.put(_Delta("drain", "", {}, fut))
        return fut.result()

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(None)
        self._writer.join(timeout=10)

    # -- writer thread ---------------------------------------------------
    def _writer_loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            if item.op == "drain":
                item.future.set_result(self._snap.epoch)
                continue
            try:
                getattr(self.handle, item.op)(item.rel, item.cols)
                if self._on_applied is not None:
                    self._on_applied(item.op, item.rel, item.cols)
                snap = ViewSnapshot(self._snap.epoch + 1, self._copy_result())
                self._snap = snap  # atomic publish: one reference store
                item.future.set_result(snap.epoch)
            except Exception as e:
                # a rejected batch (e.g. over-delete) leaves the epoch and
                # snapshot unchanged; the submitter sees the exception
                item.future.set_exception(e)

    def _copy_result(self):
        """The handle's current result: a fresh host dict / freshly
        assembled AggResult, never an alias of its internal state."""
        return self.handle.result()


def _delta_columns(tuples) -> dict[str, np.ndarray]:
    return {a: np.asarray(c).copy() for a, c in _columns_of(tuples).items()}
