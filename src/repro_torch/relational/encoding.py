"""Dictionary encoding of attribute values.

Every query-relevant attribute gets one global code space shared by all
relations that carry it (natural-join attributes *must* share codes — a
code **is** a node id in the paper's data graph).  Codes are dense int64
in ``[0, |domain|)``; ``Dictionary.values`` maps codes back to values.

Copy of the JAX package's ``relational/encoding.py``: the whole-column
path for in-memory relations and the chunk-streaming path
(:func:`encode_relation_streaming`) whose encodings land as memmaps.
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
    relations: Iterable[Relation],
    attrs: Iterable[str],
    growable: bool = False,
    chunk_rows: int | None = None,
) -> dict[str, Dictionary]:
    """One shared dictionary per attribute name across all relations.

    ``chunk_rows`` streams each source column chunk-at-a-time, folding
    per-chunk uniques into a running sorted union (``np.union1d`` is a
    truncation-free set union, so the result is identical to the
    whole-column ``np.unique``); ``None`` keeps the whole-column fast
    path for in-memory relations."""
    relations = list(relations)
    cls = GrowableDictionary if growable else Dictionary
    out: dict[str, Dictionary] = {}
    for attr in attrs:
        carriers = [r for r in relations if attr in r.attrs]
        if not carriers:
            raise KeyError(f"attr {attr!r} not present in any relation")
        if chunk_rows is None:
            parts = [np.asarray(r.open_column(attr)) for r in carriers]
            values = np.unique(np.concatenate(parts))
        else:
            values = None
            for r in carriers:
                for chunk in r.iter_chunks((attr,), chunk_rows):
                    u = np.unique(chunk[attr])
                    values = u if values is None else np.union1d(values, u)
            if values is None:  # all carriers empty: one empty column
                values = np.unique(np.asarray(carriers[0].open_column(attr)))
        out[attr] = cls(attr, values)
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

    def domain_sizes(self, dicts: Mapping[str, Dictionary]) -> tuple[int, ...]:
        return tuple(dicts[a].size for a in self.attrs)


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
    cols = [dicts[a].encode(np.asarray(rel.open_column(a))) for a in attrs]
    codes = np.stack(cols, axis=1)
    uniq, count, payloads = preaggregate_rows(
        codes,
        np.asarray(rel.open_column(measure)) if measure is not None else None,
    )
    return EncodedRelation(rel.name, attrs, uniq, count, payloads)


def encode_relation_streaming(
    rel,
    attrs: Iterable[str],
    dicts: Mapping[str, Dictionary],
    measure: str | None = None,
    chunk_rows: int = 1 << 18,
    spill_dir: str | None = None,
) -> EncodedRelation:
    """Chunk-streaming twin of :func:`encode_relation` (DESIGN.md §12).

    Each chunk is encoded, raveled to a composite row key over the full
    dictionary domains, and pre-aggregated locally; the sorted chunk
    partials land in external-sort run files and a k-way aggregating
    merge produces the final unique rows — written straight to
    ``np.memmap`` spill files, so peak RAM is bounded by the chunk size
    plus the merge windows, never the relation.

    Row-major ravel order equals ``np.unique(codes, axis=0)``'s
    lexicographic order, so codes/count come out bit-identical to the
    in-RAM path.  Float ``sum`` payloads accumulate per chunk and then
    per merged run — associative but not the sequential order of
    :func:`preaggregate_rows`, hence exact (bit-identical) only for
    integer-valued measures; ``min``/``max``/``count`` are always exact.
    """
    import shutil
    import tempfile

    from pathlib import Path

    from repro_torch.storage import sort as ext

    attrs = tuple(attrs)
    if not attrs:
        raise ValueError(f"relation {rel.name!r}: empty projection")
    dims = tuple(dicts[a].size for a in attrs)
    spill = tempfile.TemporaryDirectory(
        prefix=f"repro-enc-{rel.name}-", dir=spill_dir
    )
    base = Path(spill.name)
    run_dir = base / "runs"
    run_dir.mkdir()
    stream_cols = attrs if measure is None else attrs + (measure,)

    def chunk_partials():
        for chunk in rel.iter_chunks(stream_cols, chunk_rows):
            codes = np.stack(
                [dicts[a].encode(np.asarray(chunk[a])) for a in attrs], axis=1
            )
            keys = (
                np.ravel_multi_index(
                    tuple(codes[:, i] for i in range(len(attrs))), dims=dims
                ).astype(np.int64)
                if len(codes)
                else np.zeros(0, np.int64)
            )
            uniq, inv = np.unique(keys, return_inverse=True)
            inv = inv.ravel()
            fields = {
                ext.KEY: uniq,
                "count": np.bincount(inv, minlength=len(uniq)).astype(np.int64),
            }
            if measure is not None:
                m = np.asarray(chunk[measure], dtype=np.float64)
                fields["sum"] = np.bincount(inv, weights=m, minlength=len(uniq))
                mn = np.full(len(uniq), np.inf)
                np.minimum.at(mn, inv, m)
                mx = np.full(len(uniq), -np.inf)
                np.maximum.at(mx, inv, m)
                fields["min"] = mn
                fields["max"] = mx
            yield fields

    runs = ext.sort_chunks_to_runs(run_dir, chunk_partials())
    writer = ext.SpillWriter(base, "enc")
    codes_path = base / "enc.codes.bin"
    n_out = 0
    # tie the merge window to the chunk budget (see grouped_csr_external)
    block = max(256, int(chunk_rows) // 16)
    with open(codes_path, "wb") as codes_fh:
        for batch in ext.merge_runs(runs, block_rows=block):
            uniq, inv = np.unique(batch[ext.KEY], return_inverse=True)
            inv = inv.ravel()
            out = {
                ext.KEY: uniq,
                "count": np.bincount(
                    inv, weights=batch["count"].astype(np.float64),
                    minlength=len(uniq),
                ).astype(np.int64),
            }
            if measure is not None:
                out["sum"] = np.bincount(
                    inv, weights=batch["sum"], minlength=len(uniq)
                )
                mn = np.full(len(uniq), np.inf)
                np.minimum.at(mn, inv, batch["min"])
                mx = np.full(len(uniq), -np.inf)
                np.maximum.at(mx, inv, batch["max"])
                out["min"] = mn
                out["max"] = mx
            codes = np.column_stack(np.unravel_index(uniq, dims)).astype(np.int64)
            np.ascontiguousarray(codes).tofile(codes_fh)
            n_out += len(uniq)
            writer.append(out)
    shutil.rmtree(run_dir, ignore_errors=True)
    fields = writer.finish()
    codes_mm = (
        np.memmap(
            codes_path, dtype=np.int64, mode="r+", shape=(n_out, len(attrs))
        )
        if n_out
        else np.zeros((0, len(attrs)), np.int64)
    )
    if measure is not None:
        # empty relations still carry (empty) payloads, as the in-RAM
        # path does — the fold rewrite keys off payload presence
        payloads = {
            k: fields.get(k, np.zeros(0)) for k in ("sum", "min", "max")
        }
    else:
        payloads = {}
    count = fields["count"] if n_out else np.zeros(0, np.int64)
    er = EncodedRelation(rel.name, attrs, codes_mm, count, payloads)
    er._spill = spill  # keep the memmap files alive with the encoding
    er._chunk_rows = int(chunk_rows)  # CSR builds reuse the same budget
    return er
