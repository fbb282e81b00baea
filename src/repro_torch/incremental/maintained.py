"""``MaintainedJoinAgg``: a JOIN-AGG handle with sub-recompute refresh.

``prepare()`` happens once; after that, :meth:`insert` / :meth:`delete`
apply *batched* deltas by

1. extending the shared dictionary encodings in place (new codes append,
   domains grow monotonically — cached tensors only ever zero-pad),
2. re-running load-time pre-aggregation on the delta batch only
   (:func:`repro_torch.incremental.delta.encode_delta`), and
3. re-propagating messages only along the dirty root-path
   (:class:`repro_torch.incremental.planner.MessageCache`), exploiting
   distributivity: ``msg' = msg ⊕ Δmsg`` for COUNT/SUM/AVG.

Port of the JAX package's ``incremental/maintained.py`` on the port's
engine: the cached messages stay on the engine's device (CUDA unless the
caller asks for ``device="cpu"``) and every delta hop runs on the
hand-written ``coo_spmm`` / ``segment_sum`` kernels
(:class:`~repro_torch.incremental.torch_delta.KernelDeltaEngine`), for
COUNT, SUM and AVG.  There is one engine, ``"torch"``: the reference's
``"ref"`` engine re-walks the paper's data graph, which the port does
not have.

Non-invertible cases fall back to a path recompute over the maintained
encoded state (never a re-encode of the unchanged data) through
:func:`~repro_torch.core.torch_engine.execute_torch` on the same device:
MIN/MAX under deletes (payload rebuilt from retained raw tuples), and
any query whose fold rewrite baked a dirty relation into a host.  Cyclic
queries compose with the GHD compiler: a delta re-materializes only the
bags whose sources it touches (on the host, as the compiler does); clean
bag tables are reused verbatim.  Delete validation stays on the host
and is atomic: a rejected batch leaves the state and the domains
unchanged.

Refresh work and ``peak_delta_bytes`` are tracked in :attr:`stats`, so
the paper's memory-efficiency claim extends to maintenance.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.aggregates.semiring import Count, Sum
from repro_torch.core.prepare import encode_query, finish_prepare
from repro_torch.core.query import JoinAggQuery, resolve_schema
from repro_torch.core.tensor_engine import _decode_result
from repro_torch.core.torch_engine import execute_torch, require_device
from repro_torch.incremental.delta import DeltaBatch, MaintainedRelation, encode_delta
from repro_torch.incremental.planner import MessageCache
from repro_torch.relational.encoding import EncodedRelation, encode_relation
from repro_torch.relational.relation import Database, Relation

ENGINES = ("torch",)


@dataclass
class RefreshStats:
    """Counters for maintenance work (reset never; deltas accumulate)."""

    refreshes: int = 0
    delta_rows: int = 0  # pre-aggregated delta rows applied
    rows_rescanned: int = 0  # ancestor rows re-contracted on dirty paths
    fallback_recomputes: int = 0  # non-invertible / fold-path recomputes
    dirty_bags: int = 0  # GHD bags re-materialized
    clean_bags_reused: int = 0  # GHD bags reused verbatim
    peak_delta_bytes: int = 0  # high-water delta working set
    # device→host reads of the dirty-path refreshes (the zero test and
    # rescan mask per hop, the root delta's cells and values); the
    # fallbacks' full recomputes are not counted
    host_syncs: int = 0

    def charge(self, nbytes: int) -> None:
        self.peak_delta_bytes = max(self.peak_delta_bytes, nbytes)


def _columns_of(tuples) -> dict[str, np.ndarray]:
    if isinstance(tuples, Relation):
        return {a: tuples.columns[a] for a in tuples.attrs}
    return {a: np.asarray(c) for a, c in tuples.items()}


class MaintainedJoinAgg:
    """A prepared JOIN-AGG query maintained under inserts and deletes,
    its caches on ``device``."""

    def __init__(
        self,
        query: JoinAggQuery,
        db: Database,
        engine: str = "torch",
        device="cuda",
    ):
        from repro_torch.ghd.rewrite import is_cyclic_query

        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}; use one of {ENGINES}")
        self.device = require_device(device)
        self.query = query
        self.engine = engine
        self.kind = query.agg.kind
        self.stats = RefreshStats()
        self.cyclic = is_cyclic_query(query, db)
        self._init_raw(query, db)
        if self.cyclic:
            self._init_cyclic(query, db)
        else:
            self._init_acyclic(query, db)
        self._domains = {a: d.size for a, d in self.dicts.items()}

    # ------------------------------------------------------------------
    # shared construction
    # ------------------------------------------------------------------
    def _init_raw(self, query: JoinAggQuery, db: Database) -> None:
        """MIN/MAX payloads are non-invertible; retain the measure
        relation's raw tuples so deletes can rebuild them."""
        self.raw: dict[str, np.ndarray] | None = None
        if self.kind in ("min", "max"):
            from repro_torch.relational.source import materialize_columns

            rel, attr = query.agg.measure
            self.raw = {
                a: c.copy() for a, c in materialize_columns(db[rel]).items()
            }

    def _init_acyclic(self, query: JoinAggQuery, db: Database) -> None:
        self.schema = resolve_schema(query, db)
        self.dicts, encoded = encode_query(query, db, self.schema, growable=True)
        self.base = {r: MaintainedRelation(er) for r, er in encoded.items()}
        self.prep = finish_prepare(query, self.schema, self.dicts, encoded)
        self.fold_mode = bool(self.prep.folded)
        self._sync_fold_affected()
        self.caches: dict[str, MessageCache] | None = None
        if self.kind in ("min", "max"):
            self.result_dict = self._full_result()
        else:
            self._build_caches()
            self.result_dict = self._decode_full()

    def _sync_fold_affected(self) -> None:
        """Relations whose maintained encoding the fold rewrite replaced
        (folded relations via ``Prepared.fold_hosts``, their hosts, and
        any relation the dead-attr projection re-aggregated — detected by
        object identity): a delta there invalidates the fold itself, so
        it routes to :meth:`_refresh_fold`; every other relation's delta
        propagates along its dirty path even in fold mode."""
        self._fold_affected = (
            set(self.prep.fold_hosts)
            | set(self.prep.fold_hosts.values())
            | {
                r for r in self.prep.encoded
                if self.prep.encoded[r] is not self.base[r].er
            }
        )

    def _cache_specs(self) -> dict[str, str | None]:
        measure = self.prep.query.agg.measure
        if self.kind == "count":
            return {"count": None}
        if self.kind == "sum":
            return {"sum": measure[0]}
        if self.kind == "avg":
            return {"count": None, "sum": measure[0]}
        raise AssertionError(self.kind)

    def _build_caches(self) -> None:
        self.caches = {
            name: MessageCache(self.prep, mrel, self.device)
            for name, mrel in self._cache_specs().items()
        }

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def insert(self, rel: str, tuples) -> dict[tuple, float]:
        """Apply a batch of inserted tuples to ``rel``; returns the
        refreshed result."""
        return self._apply(rel, _columns_of(tuples), +1)

    def delete(self, rel: str, tuples) -> dict[tuple, float]:
        """Apply a batch of deleted tuples to ``rel`` (each tuple must be
        present; over-deletes raise); returns the refreshed result."""
        return self._apply(rel, _columns_of(tuples), -1)

    def result(self) -> dict[tuple, float]:
        """The current group → aggregate map (no recomputation)."""
        return dict(self.result_dict)

    def result_relation(self) -> Relation:
        """The current result in the columnar layout of the logical-plan
        API (group columns + one value column), sorted by group key."""
        rows = sorted(self.result_dict)
        cols: dict[str, np.ndarray] = {}
        for i, (_, attr) in enumerate(self.prep.group_attrs):
            cols[attr] = np.array([k[i] for k in rows])
        cols[self.kind] = np.array([self.result_dict[k] for k in rows])
        return Relation("result", cols)

    # ------------------------------------------------------------------
    # delta application
    # ------------------------------------------------------------------
    def _apply(self, rel: str, cols: dict[str, np.ndarray], sign: int):
        if rel not in self.query.relations:
            raise KeyError(f"relation {rel!r} not in query")
        self.stats.refreshes += 1
        measure = self.query.agg.measure
        m_attr = measure[1] if (measure and measure[0] == rel) else None
        attrs = self.schema.relevant[rel]
        raw_applies = (
            self.raw is not None and measure is not None and rel == measure[0]
        )
        if raw_applies:
            missing = [a for a in self.raw if a not in cols]
            if missing:
                raise ValueError(
                    f"delta for {rel!r} must carry columns {missing} "
                    "(MIN/MAX retains full raw tuples)"
                )
        delta = encode_delta(
            rel, attrs, cols, self.dicts, measure=m_attr, sign=sign
        )
        self._forget_grown()
        if delta.num_rows == 0:
            return self.result()
        self.stats.delta_rows += delta.num_rows
        self.stats.charge(delta.nbytes())
        # deletes validate against the raw multiset first: if any tuple is
        # absent this raises with NO state mutated; raw success implies the
        # projected (pre-aggregated) delete succeeds too
        if raw_applies and sign < 0:
            self._update_raw(cols, sign)
        self.base[rel].apply(delta)
        # the views, weights and tensors memoized from rel's old encoding
        # are stale; every other relation keeps its own
        self.prep.forget([rel])
        if raw_applies and sign > 0:
            self._update_raw(cols, sign)
        self._maintain_stats(rel, delta, sign)

        if self.cyclic:
            self._refresh_cyclic(rel)
        elif self.kind in ("min", "max"):
            self._refresh_minmax(rel)
        elif self.fold_mode and rel in self._fold_affected:
            self._refresh_fold(rel)
        else:
            self._refresh_propagate(rel, delta)
        return self.result()

    def _forget_grown(self) -> None:
        """Drop the memos of every relation carrying an attribute whose
        dictionary grew since the last batch: their raveled view keys
        and tensor shapes were made with the old domain sizes."""
        grown = {a for a, d in self.dicts.items() if d.size != self._domains.get(a)}
        if not grown:
            return
        self.prep.forget(
            r for r, er in self.prep.encoded.items() if grown & set(er.attrs)
        )
        self._domains = {a: d.size for a, d in self.dicts.items()}

    def _maintain_stats(self, rel: str, delta, sign: int) -> None:
        """Keep the prepared plan's collected statistics (DESIGN.md §10)
        current under deltas — only when a planner already materialized
        them: inserts merge the delta's sketches in (mergeability is the
        point of the sketch layer), deletes recollect the one relation
        (sketches cannot subtract).  Either path bumps the statistics
        ``generation``, so plan caches keyed on it invalidate."""
        stats = getattr(self.prep, "_stats_cache", None)
        if stats is None or rel not in stats.relations:
            return
        if sign > 0:
            stats.apply_insert(
                rel,
                EncodedRelation(rel, delta.attrs, delta.codes, delta.count, {}),
            )
        else:
            stats.refresh_relation(rel, self.base[rel].er)

    # --- dirty-path propagation (COUNT/SUM/AVG) ----------------------
    def _refresh_propagate(self, rel: str, delta: DeltaBatch) -> None:
        droots = {}
        for name, cache in self.caches.items():
            cache.sync_domains()
            if name == "sum" and rel == cache.measure_rel:
                weights = delta.payloads["sum"]
            else:
                weights = delta.count.astype(np.float64)
            rescanned, reads = cache.rows_rescanned, cache.host_reads
            droots[name] = cache.propagate(rel, delta.codes, weights)
            self.stats.rows_rescanned += cache.rows_rescanned - rescanned
            self.stats.host_syncs += cache.host_reads - reads
            self.stats.charge(cache.peak_delta_bytes)
        self._update_result(droots)

    def _root_value_arrays(self) -> dict[str, torch.Tensor]:
        return {name: c.root_array for name, c in self.caches.items()}

    def _host(self, t: torch.Tensor) -> np.ndarray:
        self.stats.host_syncs += 1
        return t.cpu().numpy()

    def _values_at(self, idxs: torch.Tensor) -> np.ndarray:
        """The aggregate at the group cells ``idxs`` (rows of codes on
        the device), float64 on the host."""
        sel = tuple(idxs.T)
        vals = {
            name: self._host(a[sel]).astype(np.float64)
            for name, a in self._root_value_arrays().items()
        }
        if self.kind in ("count", "sum"):
            return vals[self.kind]
        cnt, s = vals["count"], vals["sum"]
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.where(cnt > 0, s / np.maximum(cnt, 1), 0.0)

    def _decode_keys(self, idxs: np.ndarray) -> list[tuple]:
        cols = [
            self.dicts[attr].decode(idxs[:, i])
            for i, (_, attr) in enumerate(self.prep.group_attrs)
        ]
        return [tuple(c[j] for c in cols) for j in range(len(idxs))]

    def _decode_full(self) -> dict[tuple, float]:
        # decode the value array with the batch engine's own decoder so
        # the maintained result can never drift from execute_torch's
        # semantics
        if self.kind == "avg":
            source = self._avg_array()
        else:
            source = self._root_value_arrays()[self.kind]
        return _decode_result(self.prep, source.to(torch.float64))

    def _avg_array(self) -> torch.Tensor:
        roots = self._root_value_arrays()
        cnt, s = roots["count"].to(torch.float64), roots["sum"].to(torch.float64)
        return torch.where(cnt > 0, s / cnt.clamp(min=1), 0.0)

    def _update_result(self, droots: dict[str, torch.Tensor | None]) -> None:
        """Re-read the result at every group cell a root delta touched
        (nonzero in any of them), on the device, and patch the dict."""
        touched = None
        for d in droots.values():
            if d is not None:
                touched = (d != 0) if touched is None else touched | (d != 0)
        if touched is None:
            return
        idxs = torch.nonzero(touched)  # row-major order, as np.unique's
        self.stats.host_syncs += 1  # nonzero waits for the cell count
        if idxs.shape[0] == 0:
            return
        vals = self._values_at(idxs)
        for key, v in zip(self._decode_keys(self._host(idxs)), vals):
            v = float(v)
            if v == 0.0:
                self.result_dict.pop(key, None)
            else:
                self.result_dict[key] = v

    # --- fallbacks ----------------------------------------------------
    def _current_encoded(self, live: bool) -> dict[str, EncodedRelation]:
        """``live=True`` drops zero-count rows (required by MIN/MAX whose
        payload reductions ignore multiplicities — but it copies, so the
        COUNT/SUM paths keep the real, identity-stable arrays instead)."""
        if live:
            return {r: m.live_view() for r, m in self.base.items()}
        return {r: m.er for r, m in self.base.items()}

    def _full_result(self) -> dict[tuple, float]:
        """Path recompute over the maintained encoded state (the MIN/MAX
        non-invertible fallback) on the handle's device: re-derives the
        fold and the contraction, but never re-encodes the unchanged
        data."""
        self.prep = finish_prepare(
            self.query, self.schema, self.dicts, self._current_encoded(live=True)
        )
        return execute_torch(self.prep.query, None, prep=self.prep, device=self.device)

    def _refresh_fold(self, rel: str) -> None:
        """The delta invalidated the fold rewrite itself: re-derive the
        fold from the maintained (never re-encoded) relations, rebuild
        the message caches over the new plan, and recompute."""
        self.stats.fallback_recomputes += 1
        self.prep = finish_prepare(
            self.query, self.schema, self.dicts, self._current_encoded(live=False)
        )
        self._sync_fold_affected()
        self._build_caches()
        self.result_dict = self._decode_full()

    def _refresh_minmax(self, rel: str) -> None:
        measure = self.query.agg.measure
        if self.base[measure[0]].minmax_stale:
            self._rebuild_measure_payloads()
        self.stats.fallback_recomputes += 1
        self.result_dict = self._full_result()

    def _rebuild_measure_payloads(self) -> None:
        rel, attr = self.query.agg.measure
        er = encode_relation(
            Relation(rel, dict(self.raw)), self.schema.relevant[rel],
            self.dicts, attr,
        )
        self.base[rel] = MaintainedRelation(er)

    def _update_raw(self, cols: dict[str, np.ndarray], sign: int) -> None:
        attrs = list(self.raw)
        if sign > 0:
            for a in attrs:
                self.raw[a] = np.concatenate([self.raw[a], np.asarray(cols[a])])
            return
        # vectorized multiset removal: group raw+batch rows by exact
        # per-column value (no cross-dtype promotion), then drop the first
        # want[g] raw rows of each group — raising, with nothing mutated,
        # if any group is over-deleted
        n_raw = len(self.raw[attrs[0]])
        raw_codes, del_codes = [], []
        for a in attrs:
            both = np.concatenate([self.raw[a], np.asarray(cols[a])])
            _, inv = np.unique(both, return_inverse=True)
            inv = inv.ravel()
            raw_codes.append(inv[:n_raw])
            del_codes.append(inv[n_raw:])
        both = np.concatenate(
            [np.stack(raw_codes, axis=1), np.stack(del_codes, axis=1)]
        )
        _, inv = np.unique(both, axis=0, return_inverse=True)
        inv = inv.ravel()
        g_raw, g_del = inv[:n_raw], inv[n_raw:]
        groups = int(inv.max()) + 1 if len(inv) else 0
        want = np.bincount(g_del, minlength=groups)
        have = np.bincount(g_raw, minlength=groups)
        if (want > have).any():
            raise ValueError(
                f"delete from {self.query.agg.measure[0]!r}: "
                f"{int((want - have).clip(min=0).sum())} tuple(s) not present"
            )
        order = np.argsort(g_raw, kind="stable")
        gs = g_raw[order]
        sizes = np.bincount(gs, minlength=groups)
        starts = np.concatenate([[0], np.cumsum(sizes)])[gs]
        rank = np.arange(n_raw) - starts
        keep = np.ones(n_raw, dtype=bool)
        keep[order] = rank >= want[gs]
        for a in attrs:
            self.raw[a] = self.raw[a][keep]

    # ------------------------------------------------------------------
    # cyclic queries: GHD bag invalidation
    # ------------------------------------------------------------------
    def _init_cyclic(self, query: JoinAggQuery, db: Database) -> None:
        from repro_torch.ghd.rewrite import compile_ghd

        self.schema = resolve_schema(query, db, allow_group_join_attrs=True)
        self.dicts, encoded = encode_query(query, db, self.schema, growable=True)
        self.base = {r: MaintainedRelation(er) for r, er in encoded.items()}
        self.plan = compile_ghd(
            query, db, schema=self.schema, dicts=self.dicts, encoded=encoded
        )
        self.fold_mode = False
        self.caches = None
        # copy column -> source attr (for re-appending after rebuild)
        self._copy_of = {c: g for g, c in self.plan.copied_attrs.items()}
        self.prep = self.plan.prepared
        self._derived_root = self.prep.decomposition.root
        self.result_dict = self._run_derived()

    def _run_derived(self) -> dict[tuple, float]:
        """The derived (bag) query on the handle's device through
        ``execute_torch``; AVG, which ``execute_torch`` leaves to the
        planner, as SUM / COUNT per group, as the propagate path
        divides."""
        prep = self.prep
        if self.kind != "avg":
            return execute_torch(prep.query, None, prep=prep, device=self.device)
        q = prep.query
        sums, cnts = (
            execute_torch(
                None, None, device=self.device,
                prep=dataclasses.replace(
                    prep, query=JoinAggQuery(q.relations, q.group_by, agg)
                ),
            )
            for agg in (Sum(*q.agg.measure), Count())
        )
        out = {}
        for key, c in cnts.items():
            s = sums.get(key, 0.0)
            if s != 0.0:
                out[key] = s / c
        return out

    def _refresh_cyclic(self, rel: str) -> None:
        from repro_torch.ghd.bags import materialize_bag
        from repro_torch.ghd.rewrite import _append_copy_column

        if self.kind in ("min", "max") and self.base[
            self.query.agg.measure[0]
        ].minmax_stale:
            self._rebuild_measure_payloads()
        plan = self.plan
        dirty = plan.invalidated_bags(rel)
        self.stats.dirty_bags += len(dirty)
        self.stats.clean_bags_reused += len(plan.bag_tables) - len(dirty)
        current = self._current_encoded(live=True)
        schema_d = plan.derived_schema
        for b in dirty:
            bt = materialize_bag(
                plan.ghd.bags[b], current, plan.bag_out_attrs[b]
            )
            gattr = schema_d.group_of.get(b)
            if gattr in self._copy_of:
                bt = _append_copy_column(bt, self._copy_of[gattr], gattr)
            plan.bag_tables[b] = bt
            self.stats.charge(bt.peak_bytes)
        # copied-attr dictionaries track their (grown) source domains
        for g, copy in plan.copied_attrs.items():
            plan.derived_dicts[copy].values = self.dicts[g].values
        encoded_d = {b: bt.to_encoded() for b, bt in plan.bag_tables.items()}
        try:
            self.prep = finish_prepare(
                plan.derived_query, schema_d, plan.derived_dicts, encoded_d,
                root=self._derived_root,
            )
        except ValueError:  # the fold rewrite consumed the stored root
            self.prep = finish_prepare(
                plan.derived_query, schema_d, plan.derived_dicts, encoded_d
            )
        self.result_dict = self._run_derived()
