"""Stage-1 preparation (paper Sections II-B, III), on the host in numpy.

``prepare()`` turns ``(query, database)`` into:

1. a resolved :class:`QuerySchema` (join/group attrs, per-relation projections),
2. shared per-attribute dictionaries (codes = data-graph node ids),
3. pre-aggregated :class:`EncodedRelation`\\ s (load-time pre-aggregation,
   Section III-E — duplicate (x_l, x_r) tuples collapse into one edge with a
   multiplicity),
4. a leaf-multiplier fold rewrite (non-group leaf relations become weights
   on their neighbor — a semi-join with counts), and
5. the query decomposition tree with attribute splitting.

Copy of the JAX package's ``core/prepare.py`` without its out-of-core
view build and its growable dictionaries.  Statistics are collected
lazily (:attr:`Prepared.stats`).  The torch engine moves each
grouped-CSR view to the device once and memoizes it in
:attr:`Prepared.device_views`.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.decomposition import Decomposition, decompose
from repro_torch.core.hypergraph import Hypergraph
from repro_torch.core.query import JoinAggQuery, QuerySchema, resolve_schema
from repro_torch.relational.encoding import (
    Dictionary,
    EncodedRelation,
    build_dictionaries,
    encode_relation,
    reduce_grouped,
)
from repro_torch.relational.relation import Database


@dataclass
class CSRView:
    """Grouped-CSR view of an :class:`EncodedRelation` (DESIGN.md §7).

    The relation's COO rows are sorted by a composite *row key* — the
    ravel of the chosen key attributes — so every key's edges form one
    contiguous block (classic CSR, with the indptr replaced by binary
    search over the sorted key array: materializing ``indptr`` of length
    ``Π|dom(key attrs)|`` would reintroduce exactly the dense blowup the
    sparse path avoids).  Relations of any arity flatten this way: the
    key side and the remaining attrs each ravel to a single axis, which
    is what lets the 2-D kernels run arbitrary-arity hops.

    ``keys`` are ascending by construction (:func:`grouped_csr` sorts
    them once per view).  That is the precondition of every kernel in
    ``repro_torch.kernels``, so no kernel wrapper checks it per launch.
    """

    attrs: tuple[str, ...]  # key attrs, in relation-attr order of ravel
    keys: np.ndarray  # (n,) int64 raveled key per edge, ascending
    order: np.ndarray  # (n,) permutation: sorted position -> original row

    def slice_range(self, lo: int, hi: int) -> slice:
        """Edge slice (into the sorted order) whose keys lie in [lo, hi)."""
        a = int(np.searchsorted(self.keys, lo, "left"))
        b = int(np.searchsorted(self.keys, hi, "left"))
        return slice(a, b)


def grouped_csr(
    er: EncodedRelation, key_attrs: tuple[str, ...], dims: tuple[int, ...]
) -> CSRView:
    """Build the grouped-CSR view of ``er`` keyed on ``key_attrs``."""
    cols = [er.attrs.index(a) for a in key_attrs]
    keys = _ravel(er.codes, cols, list(dims))
    order = np.argsort(keys, kind="stable")
    return CSRView(tuple(key_attrs), keys[order], order)


@dataclass
class Prepared:
    query: JoinAggQuery
    schema: QuerySchema
    dicts: dict[str, Dictionary]
    encoded: dict[str, EncodedRelation]
    decomposition: Decomposition
    folded: list[str] = field(default_factory=list)
    # folded relation -> surviving host relation (fold chains resolved)
    fold_hosts: dict[str, str] = field(default_factory=dict)
    # measure relation -> relation now carrying its payloads after the
    # fold rewrite (resolved chains); the logical planner re-points each
    # aggregate channel through this map (DESIGN.md §6)
    measure_moves: dict[str, str] = field(default_factory=dict)

    def __post_init__(self) -> None:
        self._csr_cache: dict[tuple[str, tuple[str, ...]], CSRView] = {}
        # engine-owned memo of device-resident copies of the views above,
        # keyed by the engine (device, relation, key attrs): a view moves
        # to the device once per Prepared, however many hops and
        # executes read it
        self.device_views: dict = {}
        # engine-owned memo of the sorted distinct MIN/MAX payloads the
        # walk ranks against, keyed by (device, relation, kind)
        self.payload_values: dict = {}
        # lazily collected statistics; None until the planner (or a
        # caller) first touches .stats, so paths that never consult the
        # cost model pay nothing for them
        self._stats_cache = None

    @property
    def stats(self):
        """Collected :class:`~repro_torch.stats.collect.Statistics` over
        the (post-fold) encoded relations — lazy, cached, shareable via
        :meth:`attach_stats` across same-encoding candidate roots."""
        if self._stats_cache is None:
            from repro_torch.stats.collect import collect_statistics

            self._stats_cache = collect_statistics(self.encoded, self.dicts)
        return self._stats_cache

    def attach_stats(self, stats) -> None:
        self._stats_cache = stats

    @property
    def group_attrs(self) -> tuple[tuple[str, str], ...]:
        return self.schema.group_attrs

    def csr_view(self, rel: str, key_attrs: tuple[str, ...]) -> CSRView:
        """Memoized grouped-CSR view of an encoded relation (DESIGN.md §7).

        Views are only valid for the prepared (immutable) encodings; the
        streaming path builds tile-local views directly instead."""
        key = (rel, tuple(key_attrs))
        view = self._csr_cache.get(key)
        if view is None:
            er = self.encoded[rel]
            dims = tuple(self.dicts[a].size for a in key_attrs)
            view = grouped_csr(er, tuple(key_attrs), dims)
            view = self._csr_cache.setdefault(key, view)
        return view


def _ravel(codes: np.ndarray, cols: list[int], dims: list[int]) -> np.ndarray:
    """Composite key over selected columns of a code matrix."""
    if not cols:
        return np.zeros(len(codes), dtype=np.int64)
    return np.ravel_multi_index(
        tuple(codes[:, c] for c in cols), dims=tuple(dims)
    ).astype(np.int64)


def csr_restrict(
    prep: "Prepared", attr: str, lo: int, hi: int
) -> dict[str, EncodedRelation]:
    """Encoded relations with ``attr`` codes restricted to [lo, hi) and
    re-based to the tile-local range — the sparse path's stream tiles.

    Unlike the tensor engine's mask-based ``_restrict`` this slices each
    relation through its cached grouped-CSR view: one binary search per
    tile instead of a full COO scan, so a stream of T tiles costs one
    sort + T·O(log n) instead of T·O(n)."""
    enc: dict[str, EncodedRelation] = {}
    for rel, er in prep.encoded.items():
        if attr not in er.attrs:
            enc[rel] = er
            continue
        view = prep.csr_view(rel, (attr,))
        rows = view.order[view.slice_range(lo, hi)]
        codes = er.codes[rows].copy()
        codes[:, er.attrs.index(attr)] -= lo
        enc[rel] = EncodedRelation(
            er.name,
            er.attrs,
            codes,
            er.count[rows],
            {k: v[rows] for k, v in er.payloads.items()},
        )
    return enc


def _fold_leaf_multipliers(
    schema: QuerySchema,
    encoded: dict[str, EncodedRelation],
    dicts: dict[str, Dictionary],
    keep: set[str],
) -> tuple[
    dict[str, EncodedRelation],
    list[str],
    dict[str, tuple[str, ...]],
    dict[str, str],
    dict[str, str],
]:
    """Fold non-group leaf relations into a neighbor as count weights.

    A relation with no group attribute whose attrs are all contained in some
    other relation's attrs is a pure multiplier/filter: joining it scales
    each matching neighbor tuple by its match count (and drops non-matching
    tuples — a semi-join).  Folding it pre-execution is the data-reduction
    analogue of the paper's pre-aggregation, and guarantees every tree leaf
    holds a group attribute (the paper's standing assumption).

    The *measure* relation (``keep``) may fold too: its sum/min/max
    payloads transfer to the host (sum scales by host multiplicity,
    min/max pass through per key), and the returned ``moved`` map records
    the relation now carrying the measure so the aggregate spec can be
    re-pointed; ``host_of`` maps each folded relation to its immediate
    host.
    """
    relevant = {r: tuple(a) for r, a in schema.relevant.items()}
    folded: list[str] = []
    host_of: dict[str, str] = {}  # folded relation -> immediate host
    moved: dict[str, str] = {}
    changed = True
    while changed:
        changed = False
        for f in list(encoded):
            if f in schema.group_of:
                continue
            hosts = [
                p for p in encoded
                if p != f and set(relevant[f]) <= set(relevant[p])
            ]
            if f in keep:
                if not encoded[f].payloads:
                    continue
                # a measure relation folds only into a payload-free host:
                # two payload sets cannot merge under one sum/min/max key
                # space (multi-aggregate bundles may keep several measure
                # relations live at once)
                hosts = [
                    p for p in hosts
                    if p not in keep and not encoded[p].payloads
                ]
            if not hosts:
                continue
            p = hosts[0]
            ef, ep = encoded[f], encoded[p]
            dims = [dicts[a].size for a in ef.attrs]
            fkey = _ravel(ef.codes, list(range(len(ef.attrs))), dims)
            pcols = [ep.attrs.index(a) for a in ef.attrs]
            pkey = _ravel(ep.codes, pcols, dims)
            order = np.argsort(fkey, kind="stable")
            fk, fc = fkey[order], ef.count[order]
            lo = np.searchsorted(fk, pkey, "left")
            hi = np.searchsorted(fk, pkey, "right")
            csum = np.concatenate([[0], np.cumsum(fc)])
            factor = csum[hi] - csum[lo]
            mask = factor > 0
            if f in keep:
                # measure relation folds in: transfer its payloads
                pay: dict[str, np.ndarray] = {}
                if "sum" in ef.payloads:
                    s = np.concatenate([[0.0], np.cumsum(ef.payloads["sum"][order])])
                    pay["sum"] = ep.count[mask] * (s[hi] - s[lo])[mask]
                starts = (
                    np.flatnonzero(np.concatenate([[True], fk[1:] != fk[:-1]]))
                    if len(fk) else np.zeros(0, np.int64)
                )
                gi = np.clip(
                    np.searchsorted(fk[starts], pkey), 0, max(len(starts) - 1, 0)
                )
                for k, red in (("min", np.minimum), ("max", np.maximum)):
                    if k not in ef.payloads:
                        continue
                    if len(starts):
                        per_key = red.reduceat(ef.payloads[k][order], starts)
                        pay[k] = per_key[gi][mask]
                    else:  # empty measure relation: host is empty too
                        pay[k] = np.zeros(int(mask.sum()))
                moved[f] = p
                keep.discard(f)
                keep.add(p)
            else:
                pay = {
                    k: v[mask] * (factor[mask] if k == "sum" else 1)
                    for k, v in ep.payloads.items()
                }
            encoded[p] = EncodedRelation(
                ep.name,
                ep.attrs,
                ep.codes[mask],
                ep.count[mask] * factor[mask],
                pay,
            )
            del encoded[f]
            folded.append(f)
            host_of[f] = p
            changed = True
            # drop attrs that stopped being join attrs and re-aggregate
            counts: dict[str, int] = {}
            for r in encoded:
                for a in relevant[r]:
                    counts[a] = counts.get(a, 0) + 1
            for r in list(encoded):
                g = schema.group_of.get(r)
                new_attrs = tuple(
                    a for a in relevant[r] if a == g or counts.get(a, 0) >= 2
                )
                if new_attrs != relevant[r]:
                    er = encoded[r]
                    cols = [er.attrs.index(a) for a in new_attrs]
                    sub = er.codes[:, cols]
                    uniq, inv = np.unique(sub, axis=0, return_inverse=True)
                    cnt, pay = reduce_grouped(
                        inv.ravel(), len(uniq), er.count, er.payloads
                    )
                    encoded[r] = EncodedRelation(
                        er.name, new_attrs, uniq.astype(np.int64), cnt, pay,
                    )
                    relevant[r] = new_attrs
            break
    return encoded, folded, relevant, moved, host_of


def query_measures(
    query: JoinAggQuery, measures: dict[str, str] | None = None
) -> dict[str, str]:
    """Measure map ``relation -> measured attr``.

    Defaults to the query's single aggregate; the logical planner passes
    the union over a whole named-aggregate bundle instead (DESIGN.md §6).
    """
    if measures is not None:
        return dict(measures)
    m = query.agg.measure
    return {m[0]: m[1]} if m else {}


def encode_query(
    query: JoinAggQuery,
    db: Database,
    schema: QuerySchema,
    measures: dict[str, str] | None = None,
) -> tuple[dict[str, Dictionary], dict[str, EncodedRelation]]:
    """Front half of :func:`prepare`: shared dictionaries + encoded relations."""
    all_attrs = {a for attrs in schema.relevant.values() for a in attrs}
    rels = [db[r] for r in query.relations]
    dicts = build_dictionaries(rels, all_attrs)
    measures = query_measures(query, measures)
    encoded = {
        rname: encode_relation(
            db[rname], schema.relevant[rname], dicts, measures.get(rname)
        )
        for rname in query.relations
    }
    return dicts, encoded


def finish_prepare(
    query: JoinAggQuery,
    schema: QuerySchema,
    dicts: dict[str, Dictionary],
    encoded: dict[str, EncodedRelation],
    root: str | None = None,
    measures: dict[str, str] | None = None,
) -> Prepared:
    """Back half of :func:`prepare`: fold rewrite + decomposition.

    Also the entry point for pre-encoded relation sets whose multiplicities
    did not come from raw tuple counts — the GHD compiler feeds materialized
    bag relations (weights = within-bag join products) through here so cyclic
    queries reuse the exact same fold/decompose/engine pipeline.

    ``measures`` (relation -> measured attr) widens the fold rewrite's
    keep-set to every measure relation of a multi-aggregate bundle; the
    resulting :attr:`Prepared.measure_moves` records where each measure's
    payloads ended up.
    """
    measure = query.agg.measure
    keep = set(query_measures(query, measures))
    encoded, folded, relevant, moved, host_of = _fold_leaf_multipliers(
        schema, dict(encoded), dicts, keep
    )
    fold_hosts: dict[str, str] = {}
    for f in folded:
        cur = f
        while cur in host_of:
            cur = host_of[cur]
        fold_hosts[f] = cur

    measure_moves: dict[str, str] = {}
    for m_rel in query_measures(query, measures):
        cur = m_rel
        while cur in moved:
            cur = moved[cur]
        if cur != m_rel:
            measure_moves[m_rel] = cur

    if measure and measure[0] in moved:
        # the measure relation folded away; re-point the aggregate at the
        # relation now carrying its payloads
        query = JoinAggQuery(
            query.relations,
            query.group_by,
            type(query.agg)(measure_moves[measure[0]], measure[1]),
        )

    if folded:
        # re-resolve the schema over the surviving relations
        schema = QuerySchema(
            query=query,
            join_attrs=frozenset(
                a for a in schema.join_attrs
                if sum(a in relevant[r] for r in encoded) >= 2
            ),
            group_attrs=schema.group_attrs,
            relevant={r: relevant[r] for r in encoded},
            group_of=schema.group_of,
        )

    hg = Hypergraph({r: frozenset(relevant[r]) for r in encoded})
    deco = decompose(schema, hg, root=root)
    return Prepared(
        query, schema, dicts, encoded, deco, folded, fold_hosts, measure_moves
    )


def prepare(
    query: JoinAggQuery,
    db: Database,
    root: str | None = None,
    measures: dict[str, str] | None = None,
) -> Prepared:
    """Resolve, encode, fold and decompose ``query`` over ``db``."""
    schema = resolve_schema(query, db)
    dicts, encoded = encode_query(query, db, schema, measures=measures)
    return finish_prepare(query, schema, dicts, encoded, root=root, measures=measures)
