"""Cross-client fusion batcher (DESIGN.md §9).

The planner fuses the aggregates *within* one query into a single
semiring-channel contraction pass; the batcher fuses across *clients*:
compatible in-flight queries collected within a short window run as one
pass and each client gets its own demultiplexed
:class:`~repro_torch.api.plan.AggResult` back.

Two fusion tiers, cheapest first:

* **identical shape** — every query in the group has the same plan-shape
  key; the plan executes once and all clients share the result (the
  repeated-shape hot path: N clients, one contraction).
* **channel merge** — same join structure / group-by / engine / options
  but different aggregate bundles; the bundles union into one plan whose
  aggregate names are prefixed per client (``a0__total``, ...), the
  merged plan runs one multi-channel pass, and each client's columns are
  selected back out under their original names.  Each channel's kernel
  hops sum in the same order as in a solo pass, so on integer measures
  below 2**24 the demuxed results equal single-query execution bit for
  bit.  The merged bundle has more channels, so the path choice
  (``choose_path`` prices ``k`` channels) may take the sparse path where
  a solo plan took the dense one; fractional SUMs may then differ from
  the solo answer in the last bits.

A query whose shape cannot be keyed (anonymous predicate, engine
instance) never enters a group — the server runs it solo.

Port of the JAX package's ``serve/batcher.py``; a merge falls back to
solo runs only when the planner rejects the union, never when the merged
pass fails while it runs.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field, replace
from typing import Callable

from repro_torch.aggregates.semiring import Count
from repro_torch.api.plan import AggResult, Plan
from repro_torch.relational.relation import Relation


@dataclass
class BatchStats:
    """Fusion counters, incremented from concurrent server workers —
    mutate only through :meth:`add`."""

    batches: int = 0  # fused executions, >= 2 queries  # guarded-by: _lock
    fused_queries: int = 0  # queries served by a fused pass  # guarded-by: _lock
    shared_identical: int = 0  # identical-shape shares  # guarded-by: _lock
    merged_channels: int = 0  # via a channel merge  # guarded-by: _lock
    solo: int = 0  # queries executed unfused  # guarded-by: _lock
    _lock: threading.Lock = field(
        default_factory=threading.Lock, repr=False, compare=False
    )

    def add(self, **deltas: int) -> None:
        """Atomically bump the named counters (worker threads race here)."""
        with self._lock:
            for name, d in deltas.items():
                setattr(self, name, getattr(self, name) + d)

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return {
                "batches": self.batches,
                "fused_queries": self.fused_queries,
                "shared_identical": self.shared_identical,
                "merged_channels": self.merged_channels,
                "solo": self.solo,
            }


@dataclass
class _Pending:
    spec: "object"  # the Q builder
    shape_key: tuple  # full plan-shape key
    future: "object"  # concurrent.futures.Future


@dataclass
class _Group:
    items: list[_Pending] = field(default_factory=list)
    deadline: float = 0.0


def fusion_key(shape_key: tuple) -> tuple:
    """The compatibility class of a shape key: everything *except* the
    aggregate bundle (index 5 of :func:`repro_torch.serve.cache
    .plan_shape_key`'s layout) — queries differing only in aggregates can
    share a pass."""
    return shape_key[:5] + shape_key[6:]


def effective_aggs(spec) -> tuple:
    """The spec's aggregate bundle with the planner's COUNT default
    applied, so merge bookkeeping sees what the plan will run."""
    return spec.aggs or (("count", Count()),)


class FusionBatcher:
    """Collect compatible queries for up to ``window`` seconds, then hand
    each group to ``dispatch`` (called on the dispatcher thread; the
    server routes it into its worker pool).

    ``window <= 0`` still fuses whatever is queued at dispatch time (a
    burst of truly concurrent submissions can group), but never waits.
    """

    def __init__(
        self,
        dispatch: Callable[[list[_Pending]], None],
        window: float = 0.002,
    ):
        self.window = max(0.0, float(window))
        self._dispatch = dispatch
        self._groups: dict[tuple, _Group] = {}  # guarded-by: _wake
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._closed = False  # guarded-by: _wake
        self.stats = BatchStats()
        self._thread = threading.Thread(
            target=self._loop, name="joinagg-fusion-batcher", daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------------------
    def submit(self, item: _Pending) -> None:
        """Queue one pending query for fusion."""
        key = fusion_key(item.shape_key)
        with self._wake:
            if self._closed:
                raise RuntimeError("batcher is closed")
            group = self._groups.get(key)
            if group is None:
                group = self._groups[key] = _Group(
                    deadline=time.monotonic() + self.window
                )
            group.items.append(item)
            self._wake.notify()

    def flush(self) -> None:
        """Dispatch everything queued right now (blocks until handed off)."""
        with self._wake:
            groups = list(self._groups.values())
            self._groups.clear()
        for g in groups:
            self._dispatch(g.items)

    def close(self) -> None:
        with self._wake:
            self._closed = True
            self._wake.notify()
        self._thread.join(timeout=5)
        self.flush()

    # ------------------------------------------------------------------
    def _loop(self) -> None:
        while True:
            with self._wake:
                while not self._closed and not self._groups:
                    self._wake.wait()
                if self._closed:
                    return
                now = time.monotonic()
                deadline = min(g.deadline for g in self._groups.values())
                if deadline > now:
                    self._wake.wait(timeout=deadline - now)
                    continue
                due = [
                    k for k, g in self._groups.items() if g.deadline <= now
                ]
                batches = [self._groups.pop(k) for k in due]
            for g in batches:
                try:
                    self._dispatch(g.items)
                except Exception as e:  # the pool refused: fail the group
                    for it in g.items:
                        if not it.future.done():
                            it.future.set_exception(e)


# ----------------------------------------------------------------------
# group execution (runs on a server worker)
# ----------------------------------------------------------------------


def run_group(items: list[_Pending], lookup_plan, stats: BatchStats) -> None:
    """Execute one fusion group and resolve every item's future.

    ``lookup_plan(spec)`` returns a compiled plan (through the server's
    prepared-plan cache).  Identical-shape groups share one execution;
    mixed bundles merge channels; a merge that the planner rejects
    (name clash, incompatible measures) degrades to solo runs.
    """
    if not items:
        return
    live = [it for it in items if not it.future.cancelled()]
    if not live:
        return
    try:
        if len(live) == 1:
            stats.add(solo=1)
            _resolve_solo(live[0], lookup_plan)
            return
        if all(it.shape_key == live[0].shape_key for it in live):
            result = lookup_plan(live[0].spec).execute()
            stats.add(
                batches=1,
                fused_queries=len(live),
                shared_identical=len(live),
            )
            for it in live:
                it.future.set_result(result)
            return
        _run_merged(live, lookup_plan, stats)
    except Exception as e:
        for it in live:
            if not it.future.done():
                it.future.set_exception(e)


def _resolve_solo(item: _Pending, lookup_plan) -> None:
    item.future.set_result(lookup_plan(item.spec).execute())


def _run_merged(items: list[_Pending], lookup_plan, stats: BatchStats) -> None:
    """Channel-merge execution: union the bundles under per-item prefixed
    names, run once, select each item's columns back out.

    Only a planner rejection of the union (``UnsupportedPlanOption`` is a
    ``ValueError``, as is every other refusal of ``compile_plan``) runs
    the items solo; an error while the merged plan executes (a kernel
    launch, out of device memory) reaches every item's future, so a
    failing kernel is not retried out of sight."""
    merged_aggs: list[tuple[str, object]] = []
    for i, it in enumerate(items):
        for name, agg in effective_aggs(it.spec):
            merged_aggs.append((f"a{i}__{name}", agg))
    merged_spec = replace(items[0].spec, aggs=tuple(merged_aggs))
    try:
        plan: Plan = lookup_plan(merged_spec)
    except ValueError:
        stats.add(solo=len(items))
        for it in items:
            try:
                _resolve_solo(it, lookup_plan)
            except Exception as e:
                if not it.future.done():
                    it.future.set_exception(e)
        return
    merged = plan.execute()
    stats.add(
        batches=1, fused_queries=len(items), merged_channels=len(items)
    )
    for i, it in enumerate(items):
        names = [n for n, _ in effective_aggs(it.spec)]
        kinds = {n: a.kind for n, a in effective_aggs(it.spec)}
        cols = {g: merged.relation.columns[g] for g in merged.group_names}
        for n in names:
            cols[n] = merged.relation.columns[f"a{i}__{n}"]
        it.future.set_result(
            AggResult(
                group_names=merged.group_names,
                agg_names=tuple(names),
                agg_kinds=kinds,
                relation=Relation("result", cols),
            )
        )
