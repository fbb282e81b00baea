"""Bag materialization: one pre-aggregated multiplicity relation per bag.

Each bag's *factors* are (1) the relations assigned to it by the GHD
(their full multiplicity tensors, restricted to the bag) and (2) where the
assigned relations do not span every bag attribute, count-1 *filler*
projections of other relations intersecting the bag (safe semi-join
filters: distinct projections are a superset of the true join's
projection, so they restrict without changing any multiplicity).

Factors are combined by blocked sparse COO natural joins in the counting
semiring — multiplicities multiply, measure payloads (sum/min/max) ride
along on the measure relation's side — so bags never densify; the
materialized bag stays a (codes, count, payloads) triple exactly like the
acyclic pipeline's :class:`EncodedRelation`.  Peak working-set bytes are
tracked per bag and folded into the plan's estimated peak.

Copy of the JAX package's ``ghd/bags.py``: host numpy, as there.  Each
bag table lists its source relations, which the incremental maintainer
reads to find the bags a delta makes dirty.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.torch_engine import MAX_DENSE_ELEMS
from repro_torch.ghd.hypertree import Bag
from repro_torch.relational.encoding import EncodedRelation, reduce_grouped

ROW_BLOCK = 65536  # probe-side rows joined per block (bounds temp memory)


@dataclass
class Factor:
    """One join factor inside a bag: COO codes + multiplicity + payloads."""

    name: str
    attrs: tuple[str, ...]
    codes: np.ndarray  # (n, k) int64
    count: np.ndarray  # (n,) — int64 counts, or float64 override weights
    payloads: dict[str, np.ndarray] = field(default_factory=dict)

    def nbytes(self) -> int:
        return (
            self.codes.nbytes
            + self.count.nbytes
            + sum(v.nbytes for v in self.payloads.values())
        )


def factor_from_encoded(er: EncodedRelation) -> Factor:
    return Factor(er.name, er.attrs, er.codes, er.count, dict(er.payloads))


def filler_factor(er: EncodedRelation, attrs: tuple[str, ...]) -> Factor:
    """Count-1 distinct projection of ``er`` onto ``attrs`` (a filter)."""
    cols = [er.attrs.index(a) for a in attrs]
    uniq = np.unique(er.codes[:, cols], axis=0)
    return Factor(
        f"{er.name}|{'x'.join(attrs)}",
        attrs,
        uniq.astype(np.int64),
        np.ones(len(uniq), dtype=np.int64),
    )


def _key_rows(a: np.ndarray, b: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Shared integer keys for two code matrices over the same columns."""
    if a.shape[1] == 0:
        return (np.zeros(len(a), np.int64), np.zeros(len(b), np.int64))
    allk, inv = np.unique(np.concatenate([a, b], axis=0), axis=0, return_inverse=True)
    inv = inv.ravel().astype(np.int64)
    del allk
    return inv[: len(a)], inv[len(a):]


class BagJoinBudget:
    """Row/byte accounting with a hard cap on materialized bag tuples."""

    def __init__(self, cap_rows: int = MAX_DENSE_ELEMS):
        self.cap_rows = cap_rows
        self.peak_bytes = 0

    def charge(self, nbytes: int) -> None:
        self.peak_bytes = max(self.peak_bytes, nbytes)

    def check_rows(self, rows: int, bag: str) -> None:
        if rows > self.cap_rows:
            raise MemoryError(
                f"bag {bag!r} would materialize {rows} tuples "
                f"(> MAX_DENSE_ELEMS={self.cap_rows}); the query's hypertree "
                "width is too large for this memory budget"
            )


def join_factors(a: Factor, b: Factor, budget: BagJoinBudget, bag: str) -> Factor:
    """Blocked COO natural join in the counting semiring.

    Counts multiply; a ``sum`` payload (only ever present on one side —
    the measure relation's) scales by the other side's count; ``min``/
    ``max`` payloads pass through per matched pair and are reduced when
    the bag is finally re-aggregated.
    """
    shared = [x for x in a.attrs if x in b.attrs]
    out_attrs = tuple(list(a.attrs) + [x for x in b.attrs if x not in shared])
    acols = [a.attrs.index(x) for x in shared]
    bcols = [b.attrs.index(x) for x in shared]
    bextra = [b.attrs.index(x) for x in b.attrs if x not in shared]

    ka, kb = _key_rows(a.codes[:, acols], b.codes[:, bcols])
    order_b = np.argsort(kb, kind="stable")
    kb_s = kb[order_b]

    out_codes: list[np.ndarray] = []
    out_count: list[np.ndarray] = []
    out_pay: dict[str, list[np.ndarray]] = {
        k: [] for k in (*a.payloads, *b.payloads)
    }
    total = 0
    retained = 0  # bytes of all output blocks kept alive until concatenation
    for lo in range(0, len(ka), ROW_BLOCK):
        hi = min(lo + ROW_BLOCK, len(ka))
        kblk = ka[lo:hi]
        start = np.searchsorted(kb_s, kblk, "left")
        end = np.searchsorted(kb_s, kblk, "right")
        matches = end - start
        n_out = int(matches.sum())
        if n_out == 0:
            continue
        total += n_out
        budget.check_rows(total, bag)
        rep_a = np.repeat(np.arange(lo, hi), matches)
        within = np.arange(n_out) - np.repeat(np.cumsum(matches) - matches, matches)
        idx_b = order_b[start[rep_a - lo] + within]
        codes = np.concatenate(
            [a.codes[rep_a], b.codes[idx_b][:, bextra]], axis=1
        ).astype(np.int64)
        cnt = a.count[rep_a] * b.count[idx_b]
        out_codes.append(codes)
        out_count.append(cnt)
        retained += codes.nbytes + cnt.nbytes
        for k in a.payloads:
            v = a.payloads[k][rep_a]
            v = v * b.count[idx_b] if k == "sum" else v
            out_pay[k].append(v)
            retained += v.nbytes
        for k in b.payloads:
            v = b.payloads[k][idx_b]
            v = v * a.count[rep_a] if k == "sum" else v
            out_pay[k].append(v)
            retained += v.nbytes
        budget.charge(retained)

    if not out_codes:
        return Factor(
            f"({a.name}*{b.name})",
            out_attrs,
            np.zeros((0, len(out_attrs)), np.int64),
            np.zeros(0, a.count.dtype),
            {k: np.zeros(0, np.float64) for k in out_pay},
        )
    joined = Factor(
        f"({a.name}*{b.name})",
        out_attrs,
        np.concatenate(out_codes, axis=0),
        np.concatenate(out_count),
        {k: np.concatenate(v) for k, v in out_pay.items()},
    )
    # the retained blocks and their concatenated copy coexist briefly
    budget.charge(retained + joined.nbytes())
    return joined


def aggregate_factor(f: Factor, attrs: tuple[str, ...], name: str) -> Factor:
    """Project ``f`` onto ``attrs`` and re-aggregate duplicates — load-time
    pre-aggregation applied to the bag relation."""
    cols = [f.attrs.index(a) for a in attrs]
    if not attrs:
        raise ValueError(f"bag {name!r}: empty projection")
    uniq, inv = np.unique(f.codes[:, cols], axis=0, return_inverse=True)
    count, pay = reduce_grouped(inv.ravel(), len(uniq), f.count, f.payloads)
    return Factor(name, attrs, uniq.astype(np.int64), count, pay)


@dataclass
class BagTable:
    """A materialized bag: the derived pipeline's relation-to-be."""

    name: str
    attrs: tuple[str, ...]
    codes: np.ndarray
    count: np.ndarray
    payloads: dict[str, np.ndarray]
    peak_bytes: int  # working-set high-water mark during materialization
    # every input relation whose tuples influenced this bag (assigned
    # relations + filler projections) — the incremental maintainer
    # invalidates exactly the bags whose sources a delta touches
    # (DESIGN.md §4); a relation not listed here cannot change the bag
    sources: tuple[str, ...] = ()

    @property
    def num_rows(self) -> int:
        return len(self.count)

    def to_encoded(self) -> EncodedRelation:
        return EncodedRelation(
            self.name, self.attrs, self.codes, self.count, dict(self.payloads)
        )


def materialize_bag(
    bag: Bag,
    encoded: dict[str, EncodedRelation],
    out_attrs: tuple[str, ...],
    cap_rows: int = MAX_DENSE_ELEMS,
) -> BagTable:
    """Join the bag's factors and pre-aggregate onto ``out_attrs``."""
    budget = BagJoinBudget(cap_rows)
    factors = [factor_from_encoded(encoded[r]) for r in bag.relations]
    sources = list(bag.relations)

    covered: set[str] = set()
    for f in factors:
        covered |= set(f.attrs)
    missing = [a for a in out_attrs if a not in covered]
    if missing:
        # fillers: distinct projections of intersecting relations, largest
        # missing-attr overlap (then fewest rows) first
        for r, er in sorted(
            encoded.items(),
            key=lambda kv: (
                -len(set(kv[1].attrs) & set(missing)),
                kv[1].num_rows,
                kv[0],
            ),
        ):
            take = tuple(a for a in er.attrs if a in set(bag.attrs) and
                         (a in missing or a in covered))
            gain = [a for a in take if a in missing]
            if not gain:
                continue
            factors.append(filler_factor(er, take))
            sources.append(r)
            covered |= set(take)
            missing = [a for a in out_attrs if a not in covered]
            if not missing:
                break
        if missing:
            raise AssertionError(f"bag {bag.name!r}: attrs {missing} uncoverable")

    if not factors:
        raise AssertionError(f"bag {bag.name!r} has no factors")

    # join connected factors first (shared attrs), cross products last
    acc = factors[0]
    rest = factors[1:]
    while rest:
        i = next(
            (k for k, f in enumerate(rest) if set(f.attrs) & set(acc.attrs)),
            0,  # genuine in-bag cross product (rare; still bounded by cap)
        )
        acc = join_factors(acc, rest.pop(i), budget, bag.name)

    out = aggregate_factor(acc, out_attrs, bag.name)
    budget.charge(acc.nbytes() + out.nbytes())  # both alive during aggregation
    return BagTable(
        bag.name, out.attrs, out.codes, out.count, out.payloads,
        budget.peak_bytes, tuple(dict.fromkeys(sources)),
    )
