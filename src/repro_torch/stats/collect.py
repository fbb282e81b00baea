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

Copy of the JAX package's ``stats/collect.py`` for in-memory encodings
(one chunk per relation, as the JAX package scans them), without its
incremental-maintenance updates and its ``explain`` rendering.  The
fanout sampler draws from the same seeded generator in the same order,
so both packages collect the same statistics.
"""
from __future__ import annotations

from dataclasses import dataclass

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
    sample: int = DEFAULT_FANOUT_SAMPLE
    kmv_k: int = DEFAULT_KMV_K
    hh_m: int = DEFAULT_HH_M

    def col(self, rel: str, attr: str) -> ColumnStats | None:
        rs = self.relations.get(rel)
        return rs.cols.get(attr) if rs is not None else None

    def distinct(self, rel: str, attr: str, default: float = 1.0) -> float:
        cs = self.col(rel, attr)
        return cs.est_distinct if cs is not None else default

    def heavy_keys(
        self, rel: str, attr: str, min_share: float
    ) -> list[tuple[int, float]]:
        cs = self.col(rel, attr)
        return cs.heavy.heavy(min_share) if cs is not None else []

    def fanout(self, left: str, right: str) -> float | None:
        return self.fanouts.get((left, right))


def _relation_stats(
    er: EncodedRelation, dicts: dict[str, Dictionary], kmv_k: int, hh_m: int
) -> RelationStats:
    """Sketch one encoded relation in one pass over its columns."""
    rows = int(er.count.sum()) if er.num_rows else 0
    cols: dict[str, ColumnStats] = {}
    for i, attr in enumerate(er.attrs):
        col = np.asarray(er.codes[:, i])
        distinct = DistinctSketch(kmv_k).update(col)
        heavy = HeavyHitterSketch(hh_m).update(col, weights=er.count)
        dom = (
            dicts[attr].size if attr in dicts
            else max(int(col.max(initial=-1)), 0) + 1
        )
        cols[attr] = ColumnStats(attr, rows, dom, distinct, heavy)
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
    )
