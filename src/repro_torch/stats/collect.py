"""Statistics collection over encoded relations (DESIGN.md §10).

``collect_statistics`` scans a prepared query's :class:`EncodedRelation`
set once and produces a :class:`Statistics` object:

* per relation, per column: weighted row count, a KMV distinct sketch
  and a Misra–Gries heavy-hitter sketch over the dictionary codes
  (weighted by tuple multiplicity — skew is a property of the data, not
  of the pre-aggregated edge list), and
* per ordered relation pair sharing join attrs: a *sampled* fanout —
  the average number of matching tuples in the right relation per
  (weighted) tuple of the left one, the pairwise join selectivity the
  cost model chains along decomposition-tree edges.

Incremental maintenance keeps a materialized collection current:
:meth:`Statistics.apply_insert` merges an insert delta's sketches in,
:meth:`Statistics.refresh_relation` recollects a relation after a
delete, and both bump ``generation``.

Copy of the JAX package's ``stats/collect.py``: in-memory encodings scan
as one chunk, memmap encodings in bounded row chunks, as the JAX package
scans them.  The fanout sampler draws from the same seeded generator in
the same order, so both packages collect the same statistics.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.relational.encoding import Dictionary, EncodedRelation
from repro_torch.stats.sketches import DistinctSketch, HeavyHitterSketch

DEFAULT_KMV_K = 256
DEFAULT_HH_M = 32
DEFAULT_FANOUT_SAMPLE = 512


@dataclass
class ColumnStats:
    """Sketched statistics of one encoded column (dictionary codes)."""

    attr: str
    rows: int  # weighted (multiplicity-summed) rows of the relation
    domain: int  # dictionary size at collection time
    distinct: DistinctSketch
    heavy: HeavyHitterSketch

    @property
    def est_distinct(self) -> float:
        return float(min(max(self.distinct.estimate(), 1.0), self.domain))

    def max_share(self) -> float:
        return self.heavy.max_share()


@dataclass
class RelationStats:
    name: str
    rows: int  # weighted rows (sum of multiplicities)
    num_rows: int  # pre-aggregated (unique-tuple) rows
    cols: dict[str, ColumnStats]


@dataclass
class Statistics:
    """Query-scoped statistics: per-relation columns + sampled fanouts."""

    relations: dict[str, RelationStats]
    # (left rel, right rel) -> avg matching right tuples per left tuple,
    # over the relations' full shared-attr set
    fanouts: dict[tuple[str, str], float]
    generation: int = 0
    sample: int = DEFAULT_FANOUT_SAMPLE
    kmv_k: int = DEFAULT_KMV_K
    hh_m: int = DEFAULT_HH_M
    _dicts: dict[str, Dictionary] = field(default_factory=dict, repr=False)

    def col(self, rel: str, attr: str) -> ColumnStats | None:
        rs = self.relations.get(rel)
        return rs.cols.get(attr) if rs is not None else None

    def distinct(self, rel: str, attr: str, default: float = 1.0) -> float:
        cs = self.col(rel, attr)
        return cs.est_distinct if cs is not None else default

    def attr_distinct(self, attr: str, domain: int) -> float:
        """Estimated distinct values of ``attr`` surviving the join:
        bounded by every relation carrying the attr."""
        ests = [
            cs.est_distinct
            for rs in self.relations.values()
            for a, cs in rs.cols.items()
            if a == attr
        ]
        return float(min(ests)) if ests else float(domain)

    def max_share(self, rel: str, attr: str) -> float:
        cs = self.col(rel, attr)
        return cs.max_share() if cs is not None else 0.0

    def heavy_keys(
        self, rel: str, attr: str, min_share: float
    ) -> list[tuple[int, float]]:
        cs = self.col(rel, attr)
        return cs.heavy.heavy(min_share) if cs is not None else []

    def fanout(self, left: str, right: str) -> float | None:
        return self.fanouts.get((left, right))

    def apply_insert(self, rel: str, delta: EncodedRelation) -> None:
        """Merge an insert delta's sketches into ``rel``'s stats.

        Mergeability is the point: the delta is sketched alone and
        merged in, never rescanning the base relation.  Fanouts are left
        as collected (sampled estimates age gracefully; ``generation``
        still invalidates any cached plan built on them)."""
        rs = self.relations.get(rel)
        if rs is None:
            return
        dstats = _relation_stats(delta, self._dicts, self.kmv_k, self.hh_m)
        rs.rows += dstats.rows
        rs.num_rows += dstats.num_rows
        for attr, dcol in dstats.cols.items():
            cur = rs.cols.get(attr)
            if cur is None:
                rs.cols[attr] = dcol
                continue
            rs.cols[attr] = ColumnStats(
                attr=attr,
                rows=rs.rows,
                domain=max(cur.domain, dcol.domain),
                distinct=cur.distinct.merge(dcol.distinct),
                heavy=cur.heavy.merge(dcol.heavy),
            )
        self.generation += 1

    def refresh_relation(self, rel: str, er: EncodedRelation) -> None:
        """Recollect one relation from its current encoding (deletes
        cannot be subtracted from sketches)."""
        self.relations[rel] = _relation_stats(er, self._dicts, self.kmv_k, self.hh_m)
        self.generation += 1

    def summary_lines(self) -> list[str]:
        """Compact per-relation rendering for ``Plan.explain()``."""
        lines = []
        for rel in sorted(self.relations):
            rs = self.relations[rel]
            cols = []
            for attr in sorted(rs.cols):
                cs = rs.cols[attr]
                frag = f"{attr}≈{cs.est_distinct:.0f} distinct"
                share = cs.max_share()
                if share >= 0.05:
                    frag += f" (top share {share:.2f})"
                cols.append(frag)
            lines.append(f"{rel}: {rs.rows} rows; " + ", ".join(cols))
        return lines


def _relation_stats(
    er: EncodedRelation,
    dicts: dict[str, Dictionary],
    kmv_k: int,
    hh_m: int,
    chunk_rows: int | None = None,
) -> RelationStats:
    """Sketch one encoded relation, feeding the sketches in bounded row
    chunks so a memmap-backed encoding is never pulled into RAM whole
    (DESIGN.md §12).  Purely in-memory encodings with no chunking forced
    scan as one chunk — the sketches see identical input either way, and
    the KMV sketch's truncated set-union makes its *state* independent
    of the chunking (the regression test asserts it)."""
    from repro_torch.relational.source import DEFAULT_CHUNK_ROWS, env_chunk_rows

    n = er.num_rows
    rows = int(er.count.sum()) if n else 0
    if chunk_rows is None:
        chunk_rows = env_chunk_rows() or (
            DEFAULT_CHUNK_ROWS if isinstance(er.codes, np.memmap) else None
        )
    step = max(int(chunk_rows), 1) if chunk_rows else max(n, 1)
    distincts = [DistinctSketch(kmv_k) for _ in er.attrs]
    heavies = [HeavyHitterSketch(hh_m) for _ in er.attrs]
    maxes = [-1] * len(er.attrs)
    for start in range(0, n, step):
        stop = min(start + step, n)
        block = np.asarray(er.codes[start:stop])
        w = np.asarray(er.count[start:stop])
        for i in range(len(er.attrs)):
            col = block[:, i]
            distincts[i].update(col)
            heavies[i].update(col, weights=w)
            maxes[i] = max(maxes[i], int(col.max(initial=-1)))
    cols: dict[str, ColumnStats] = {}
    for i, attr in enumerate(er.attrs):
        dom = dicts[attr].size if attr in dicts else max(maxes[i], 0) + 1
        cols[attr] = ColumnStats(attr, rows, dom, distincts[i], heavies[i])
    return RelationStats(er.name, rows, er.num_rows, cols)


def _sampled_fanout(
    left: EncodedRelation,
    right: EncodedRelation,
    shared: tuple[str, ...],
    dicts: dict[str, Dictionary],
    sample: int,
    rng: np.random.Generator,
) -> float:
    """Average matching right tuples (weighted) per left tuple, sampled."""
    if left.num_rows == 0 or right.num_rows == 0:
        return 0.0
    dims = tuple(dicts[a].size for a in shared)
    lcols = [left.attrs.index(a) for a in shared]
    rcols = [right.attrs.index(a) for a in shared]
    lk = np.ravel_multi_index(
        tuple(left.codes[:, c] for c in lcols), dims=dims
    ).astype(np.int64)
    rk = np.ravel_multi_index(
        tuple(right.codes[:, c] for c in rcols), dims=dims
    ).astype(np.int64)
    order = np.argsort(rk, kind="stable")
    rk_sorted = rk[order]
    csum = np.concatenate([[0], np.cumsum(right.count[order])])
    if left.num_rows > sample:
        idx = rng.choice(left.num_rows, size=sample, replace=False)
    else:
        idx = np.arange(left.num_rows)
    lo = np.searchsorted(rk_sorted, lk[idx], "left")
    hi = np.searchsorted(rk_sorted, lk[idx], "right")
    matches = (csum[hi] - csum[lo]).astype(np.float64)
    w = left.count[idx].astype(np.float64)
    return float((matches * w).sum() / w.sum())


def collect_statistics(
    encoded: dict[str, EncodedRelation],
    dicts: dict[str, Dictionary],
    sample: int = DEFAULT_FANOUT_SAMPLE,
    seed: int = 0,
    kmv_k: int = DEFAULT_KMV_K,
    hh_m: int = DEFAULT_HH_M,
) -> Statistics:
    """One pass over the encoded relations: sketches + sampled fanouts."""
    rng = np.random.default_rng(seed)
    relations = {
        rel: _relation_stats(er, dicts, kmv_k, hh_m)
        for rel, er in encoded.items()
    }
    fanouts: dict[tuple[str, str], float] = {}
    names = sorted(encoded)
    for i, a in enumerate(names):
        for b in names[i + 1 :]:
            shared = tuple(
                x for x in encoded[a].attrs if x in encoded[b].attrs
            )
            if not shared:
                continue
            fanouts[(a, b)] = _sampled_fanout(
                encoded[a], encoded[b], shared, dicts, sample, rng
            )
            fanouts[(b, a)] = _sampled_fanout(
                encoded[b], encoded[a], shared, dicts, sample, rng
            )
    return Statistics(
        relations=relations,
        fanouts=fanouts,
        sample=sample,
        kmv_k=kmv_k,
        hh_m=hh_m,
        _dicts=dict(dicts),
    )
