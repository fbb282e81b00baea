"""Dictionary encoding of attribute values (in-memory path).

Every query-relevant attribute gets one global code space shared by all
relations that carry it (natural-join attributes *must* share codes — a
code **is** a node id in the paper's data graph).  Codes are dense int64
in ``[0, |domain|)``; ``Dictionary.values`` maps codes back to values.

Copy of the JAX package's ``relational/encoding.py`` without its
external-sort (chunk-streaming) branch.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Mapping

import numpy as np

from repro_torch.relational.relation import Relation


@dataclass
class Dictionary:
    """Sorted unique domain of one attribute."""

    attr: str
    values: np.ndarray  # sorted unique

    @property
    def size(self) -> int:
        return len(self.values)

    def encode(self, col: np.ndarray) -> np.ndarray:
        codes = np.searchsorted(self.values, col)
        codes = np.clip(codes, 0, max(self.size - 1, 0))
        if self.size == 0 or not np.array_equal(self.values[codes], col):
            raise ValueError(f"attr {self.attr!r}: values outside dictionary")
        return codes.astype(np.int64)

    def decode(self, codes: np.ndarray) -> np.ndarray:
        return self.values[np.asarray(codes)]


class GrowableDictionary(Dictionary):
    """A :class:`Dictionary` whose domain grows monotonically.

    Unknown values passed to :meth:`encode` with ``grow=True`` are
    *appended* to the value table, so existing codes never move — every
    cached message / result tensor indexed by old codes stays valid and
    only needs zero-padding on the grown axes (DESIGN.md §4).  Values are
    therefore sorted only within the initial segment; lookups go through
    a maintained sort permutation instead of assuming global order.
    """

    def __init__(self, attr: str, values: np.ndarray):
        super().__init__(attr, np.asarray(values))
        self._order = np.argsort(self.values, kind="stable")

    def encode(self, col: np.ndarray, grow: bool = False) -> np.ndarray:
        col = np.asarray(col)
        if self.size:
            sv = self.values[self._order]
            pos = np.clip(np.searchsorted(sv, col), 0, self.size - 1)
            hit = sv[pos] == col
        else:
            pos = np.zeros(len(col), dtype=np.int64)
            hit = np.zeros(len(col), dtype=bool)
        if bool(np.all(hit)):
            return self._order[pos].astype(np.int64)
        if not grow:
            raise ValueError(f"attr {self.attr!r}: values outside dictionary")
        new_vals = np.unique(col[~hit])
        self.values = (
            np.concatenate([self.values, new_vals]) if self.size else new_vals
        )
        self._order = np.argsort(self.values, kind="stable")
        return self.encode(col)


def build_dictionaries(
    relations: Iterable[Relation], attrs: Iterable[str], growable: bool = False
) -> dict[str, Dictionary]:
    """One shared dictionary per attribute name across all relations;
    ``growable`` builds :class:`GrowableDictionary` encoders (the
    incremental maintainer's)."""
    relations = list(relations)
    cls = GrowableDictionary if growable else Dictionary
    out: dict[str, Dictionary] = {}
    for attr in attrs:
        carriers = [r for r in relations if attr in r.attrs]
        if not carriers:
            raise KeyError(f"attr {attr!r} not present in any relation")
        parts = [np.asarray(r.columns[attr]) for r in carriers]
        out[attr] = cls(attr, np.unique(np.concatenate(parts)))
    return out


def reduce_grouped(
    inv: np.ndarray,
    n_out: int,
    count: np.ndarray,
    payloads: Mapping[str, np.ndarray],
) -> tuple[np.ndarray, dict[str, np.ndarray]]:
    """Re-aggregate pre-aggregated rows into ``n_out`` groups keyed by
    ``inv``: counts and ``sum`` payloads add, ``min``/``max`` reduce
    (the fold rewrite's dead-attribute projection)."""
    cnt = np.bincount(inv, weights=count.astype(np.float64), minlength=n_out)
    out_count = (
        cnt if np.issubdtype(count.dtype, np.floating)
        else np.rint(cnt).astype(np.int64)
    )
    pay: dict[str, np.ndarray] = {}
    for k, v in payloads.items():
        if k == "sum":
            pay[k] = np.bincount(inv, weights=v, minlength=n_out)
        elif k == "min":
            arr = np.full(n_out, np.inf)
            np.minimum.at(arr, inv, v)
            pay[k] = arr
        else:
            arr = np.full(n_out, -np.inf)
            np.maximum.at(arr, inv, v)
            pay[k] = arr
    return out_count, pay


@dataclass
class EncodedRelation:
    """A relation projected to query-relevant attrs, dictionary-encoded and
    pre-aggregated (the paper's load-time pre-aggregation, Section III-E):
    duplicate rows are collapsed with a ``count`` payload; optional measure
    payloads (``sum``/``min``/``max``) support Section IV-D aggregates."""

    name: str
    attrs: tuple[str, ...]
    codes: np.ndarray  # (n, k) int64, unique rows
    count: np.ndarray  # (n,) int64  edge multiplicities
    payloads: dict[str, np.ndarray]  # e.g. {"sum": ..., "min": ..., "max": ...}

    @property
    def num_rows(self) -> int:
        return len(self.count)


def preaggregate_rows(
    codes: np.ndarray, measure_vals: np.ndarray | None = None
) -> tuple[np.ndarray, np.ndarray, dict[str, np.ndarray]]:
    """Load-time pre-aggregation of raw code rows (Section III-E):
    collapse duplicate rows into ``(unique rows, count, payloads)``."""
    uniq, inverse = np.unique(codes, axis=0, return_inverse=True)
    inverse = inverse.ravel()
    count = np.bincount(inverse, minlength=len(uniq)).astype(np.int64)
    payloads: dict[str, np.ndarray] = {}
    if measure_vals is not None:
        m = np.asarray(measure_vals, dtype=np.float64)
        payloads["sum"] = np.bincount(inverse, weights=m, minlength=len(uniq))
        mn = np.full(len(uniq), np.inf)
        np.minimum.at(mn, inverse, m)
        mx = np.full(len(uniq), -np.inf)
        np.maximum.at(mx, inverse, m)
        payloads["min"] = mn
        payloads["max"] = mx
    return uniq.astype(np.int64), count, payloads


def encode_relation(
    rel: Relation,
    attrs: Iterable[str],
    dicts: Mapping[str, Dictionary],
    measure: str | None = None,
) -> EncodedRelation:
    """Project ``rel`` to ``attrs``, encode, and pre-aggregate duplicates.

    ``measure`` names a (numeric) column whose per-edge SUM/MIN/MAX are
    carried as payloads for non-COUNT aggregates.
    """
    attrs = tuple(attrs)
    if not attrs:
        raise ValueError(f"relation {rel.name!r}: empty projection")
    cols = [dicts[a].encode(np.asarray(rel.columns[a])) for a in attrs]
    codes = np.stack(cols, axis=1)
    uniq, count, payloads = preaggregate_rows(
        codes,
        np.asarray(rel.columns[measure]) if measure is not None else None,
    )
    return EncodedRelation(rel.name, attrs, uniq, count, payloads)
