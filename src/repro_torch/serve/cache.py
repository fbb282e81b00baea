"""The serving layer's bounded caches (DESIGN.md §9).

* :class:`LRUCache` — a thread-safe least-recently-used map with
  hit/miss/eviction counters and a per-key build latch.
* :class:`PlanCache` + :func:`plan_shape_key` — prepared-statement
  semantics for the query server: compiled :class:`~repro_torch.api.plan
  .Plan` objects keyed on query *shape* (relations, rewrites, group
  attrs, aggregate kinds, engine, execution options) plus the server's
  data generation, so a repeat query skips ``prepare`` and plan compile
  and runs straight on the cached physical plan.  Each plan carries its
  ``Prepared``, whose device views (``Prepared.device_views``) live as
  long as the plan: an eviction frees them with it.

Port of the JAX package's ``serve/cache.py``.  The port has no jit and
no program memo, so the LRU serves the plan cache alone; the shape key
also carries the ``.fused`` option, which picks the kernels a plan
launches.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, field, replace
from typing import Any, Callable


@dataclass
class CacheStats:
    """Counters of one cache's lifetime; ``snapshot()`` for reporting."""

    hits: int = 0
    misses: int = 0
    evictions: int = 0
    inserts: int = 0

    def snapshot(self) -> dict[str, int]:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "inserts": self.inserts,
        }


class LRUCache:
    """Thread-safe bounded LRU map with hit/miss/eviction counters.

    ``get_or_create(key, factory)`` gives once-per-key construction: the
    factory for a given key runs at most once at a time (concurrent
    callers of the *same* key block on a per-key latch and then share the
    produced value; distinct keys never block each other).  This is what
    lets the server compile a plan exactly once under a thundering herd
    of identical queries.
    """

    def __init__(self, maxsize: int = 128, name: str = "lru"):
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        self.maxsize = maxsize
        self.name = name
        self.stats = CacheStats()  # guarded-by: _lock
        self._data: OrderedDict[Any, Any] = OrderedDict()  # guarded-by: _lock
        self._lock = threading.RLock()
        self._building: dict[Any, threading.Event] = {}  # guarded-by: _lock

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._data

    def get(self, key, default=None):
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                self.stats.hits += 1
                return self._data[key]
            self.stats.misses += 1
            return default

    def put(self, key, value) -> None:
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                self._data[key] = value
                return
            self._data[key] = value
            self.stats.inserts += 1
            while len(self._data) > self.maxsize:
                self._data.popitem(last=False)
                self.stats.evictions += 1

    def setdefault(self, key, value):
        """Insert-if-absent; returns the stored value.  A present key
        counts as a hit; an absent key counts only the insert (callers
        pair this with a ``get`` that already counted the miss)."""
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                self.stats.hits += 1
                return self._data[key]
            self.put(key, value)
            return value

    def clear(self) -> None:
        with self._lock:
            self._data.clear()

    def keys(self) -> list:
        with self._lock:
            return list(self._data)

    def get_or_create(self, key, factory: Callable[[], Any]):
        """Return the cached value, or build it with ``factory`` exactly
        once even under concurrent callers of the same key."""
        while True:
            with self._lock:
                if key in self._data:
                    self._data.move_to_end(key)
                    self.stats.hits += 1
                    return self._data[key]
                latch = self._building.get(key)
                if latch is None:
                    self.stats.misses += 1
                    latch = self._building[key] = threading.Event()
                    mine = True
                else:
                    mine = False
            if not mine:
                latch.wait()
                # the builder may have failed — loop to retry/observe
                with self._lock:
                    if key in self._data:
                        self._data.move_to_end(key)
                        self.stats.hits += 1
                        return self._data[key]
                continue
            try:
                value = factory()
            except BaseException:
                with self._lock:
                    self._building.pop(key, None)
                latch.set()
                raise
            with self._lock:
                self.put(key, value)
                self._building.pop(key, None)
            latch.set()
            return value


# ----------------------------------------------------------------------
# plan-shape keys & the prepared-plan cache
# ----------------------------------------------------------------------


def plan_shape_key(spec, generation: int = 0, stats_generation: int = 0):
    """Hashable shape of a :class:`~repro_torch.api.builder.Q` spec, or
    ``None`` when the query cannot be cached safely.

    The key captures everything the compiled plan depends on: relations
    (with aliases), column renames, pushed-down predicate labels, group
    attributes, the named-aggregate bundle (name, kind, measure; index 5,
    which :func:`~repro_torch.serve.batcher.fusion_key` drops), engine
    name, memory budget / stream options, the server's data
    ``generation`` (bumped on every relation registration, so stale
    plans become unreachable and age out of the LRU), the
    ``stats_generation`` plus the spec's own stats toggle (a stats bump
    invalidates every plan whose root / split choices were made on the
    old sketches, DESIGN.md §10), and last the ``.fused`` option: the
    same bits either way, but other kernels launch.

    Uncacheable shapes — ``None`` is returned — are those whose identity
    the label cannot prove: callable predicates (the label is just the
    function's ``__name__``, so two distinct lambdas would collide) and
    engine *instances* (no stable name).  Declarative comparison/equality
    predicates carry ``"attr op value"`` labels (always containing a
    space) and key fine — they are the only predicate form the wire
    protocol admits, so every remote query is cacheable.
    """
    engine = spec.engine_name
    if not isinstance(engine, str):
        return None
    preds = []
    for p in spec.predicates:
        if " " not in p.label:
            return None  # callable-form predicate: label is only a name
        preds.append((p.relation, p.label))
    return (
        generation,
        spec.relations,
        spec.renames,
        tuple(preds),
        spec.group_attrs,
        tuple((name, a.kind, a.measure) for name, a in spec.aggs),
        engine,
        spec.budget,
        spec.stream_opt,
        None,  # the reference's mesh slot: one device here, Q.mesh raises
        stats_generation,
        bool(spec.stats_opt),
        spec.fused_opt,
    )


@dataclass
class PlanCacheStats:
    """Plan-cache counters: LRU traffic plus actual compiles/bypasses."""

    compiles: int = 0  # times compile_plan actually ran
    bypasses: int = 0  # uncacheable shapes compiled outside the cache
    lru: CacheStats = field(default_factory=CacheStats)

    def snapshot(self) -> dict[str, int]:
        return {
            "compiles": self.compiles,
            "bypasses": self.bypasses,
            **self.lru.snapshot(),
        }


class PlanCache:
    """Prepared-plan cache: ``Q`` shape → compiled ``Plan``.

    ``lookup(spec, db, generation)`` returns a ready-to-execute plan; a
    warm hit skips logical rewrites, encoding, root search / GHD
    compilation and, through the plan's cached ``Prepared``, the CSR-view
    sorts and uploads of every earlier execute.

    ``engine`` (the server's :class:`~repro_torch.api.engines
    .TorchChannelEngine`) runs every spec whose engine is the name
    ``"torch"``: the key keeps the name, the plan gets the instance, so
    such specs stay cacheable on whatever device the server serves.
    """

    def __init__(self, maxsize: int = 64, *, engine):
        self._lru = LRUCache(maxsize, name="plans")
        self._engine = engine
        # counters see concurrent lookup() callers, and build() runs
        # OUTSIDE the LRU's per-key latch lock — they need their own lock
        self._stats_lock = threading.Lock()
        self.stats = PlanCacheStats(lru=self._lru.stats)  # guarded-by: _stats_lock

    def __len__(self) -> int:
        return len(self._lru)

    def _compile(self, spec, db):
        from repro_torch.api.plan import compile_plan

        if spec.engine_name == "torch":
            spec = replace(spec, engine_name=self._engine)
        return compile_plan(spec, db)

    def lookup(self, spec, db, generation: int = 0, stats_generation: int = 0):
        key = plan_shape_key(spec, generation, stats_generation)
        if key is None:
            with self._stats_lock:
                self.stats.bypasses += 1
                self.stats.compiles += 1
            return self._compile(spec, db)

        def build():
            with self._stats_lock:
                self.stats.compiles += 1
            return self._compile(spec, db)

        return self._lru.get_or_create(key, build)

    def clear(self) -> None:
        self._lru.clear()
