"""Delta batches: encode, pre-aggregate, and merge into maintained state.

A delta is a columnar batch of inserted or deleted tuples for one
relation.  :func:`encode_delta` re-runs the paper's load-time
pre-aggregation (Section III-E) on *just the batch*: the shared
:class:`~repro_torch.relational.encoding.GrowableDictionary` encoders extend in
place (new values append codes, domains grow monotonically), duplicate
rows collapse into one row with a signed multiplicity, and measure
payloads ride along.  :class:`MaintainedRelation` then merges the batch
into the live pre-aggregated COO state in O(|Δ|) dictionary operations —
the full relation is never re-encoded (DESIGN.md §4).

Copy of the JAX package's ``incremental/delta.py``: host numpy, as
there, so a rejected batch is refused before any state on the card is
touched.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import numpy as np

from repro_torch.relational.encoding import (
    Dictionary,
    EncodedRelation,
    GrowableDictionary,
    preaggregate_rows,
)


@dataclass
class DeltaBatch:
    """One relation's pre-aggregated signed delta (columns follow the
    maintained relation's attr layout, codes are unique rows)."""

    rel: str
    attrs: tuple[str, ...]
    codes: np.ndarray  # (m, k) int64 unique rows
    count: np.ndarray  # (m,) int64, negative for deletes
    payloads: dict[str, np.ndarray]  # signed "sum"; "min"/"max" unsigned
    sign: int  # +1 insert, -1 delete

    @property
    def num_rows(self) -> int:
        return len(self.count)

    def nbytes(self) -> int:
        return (
            self.codes.nbytes
            + self.count.nbytes
            + sum(v.nbytes for v in self.payloads.values())
        )


def encode_delta(
    rel: str,
    attrs: tuple[str, ...],
    columns: Mapping[str, np.ndarray],
    dicts: Mapping[str, Dictionary],
    measure: str | None = None,
    sign: int = 1,
) -> DeltaBatch:
    """Load-time pre-aggregation applied to one delta batch.

    ``columns`` must cover every attr in ``attrs`` (the relation's
    query-relevant projection) plus ``measure`` when given.  Growable
    dictionaries extend in place for unseen *inserted* values; deletes
    never grow (a value absent from the dictionary cannot be stored, so
    the delete is rejected with no state mutated) and plain dictionaries
    raise, exactly like the bulk loader.
    """
    if sign not in (1, -1):
        raise ValueError(f"sign must be +1 or -1, got {sign}")
    lens = {len(np.asarray(columns[a])) for a in attrs}
    if len(lens) > 1:
        raise ValueError(f"delta for {rel!r}: ragged columns {lens}")
    n = lens.pop() if lens else 0
    if n == 0:
        return DeltaBatch(
            rel, tuple(attrs), np.zeros((0, len(attrs)), np.int64),
            np.zeros(0, np.int64), {}, sign,
        )
    cols = []
    for a in attrs:
        d = dicts[a]
        col = np.asarray(columns[a])
        try:
            if isinstance(d, GrowableDictionary):
                cols.append(d.encode(col, grow=sign > 0))
            else:
                cols.append(d.encode(col))
        except ValueError as e:
            verb = "insert into" if sign > 0 else "delete from"
            raise ValueError(
                f"{verb} {rel!r}: tuple(s) with unknown {a!r} value(s): {e}"
            ) from e
    codes = np.stack(cols, axis=1)
    uniq, count, payloads = preaggregate_rows(
        codes, columns[measure] if measure is not None else None
    )
    count = count * sign
    if "sum" in payloads:
        payloads["sum"] = payloads["sum"] * sign
    return DeltaBatch(rel, tuple(attrs), uniq, count, payloads, sign)


class MaintainedRelation:
    """A mutable pre-aggregated encoded relation.

    Wraps the pipeline's :class:`EncodedRelation` (mutating its arrays in
    place, so every ``Prepared`` holding the object sees updates) and
    keeps a row index keyed by code tuples for O(1) delta-row lookup.
    Rows whose multiplicity reaches zero are kept with ``count == 0``
    (weight zero contributes nothing to any COUNT/SUM contraction) and
    compacted away lazily once they dominate.

    ``min``/``max`` payloads are not invertible: a delete that touches a
    row carrying them marks the relation's payloads *stale* and the
    caller must rebuild them from raw tuples before the next MIN/MAX
    refresh (the non-invertible-aggregate fallback, DESIGN.md §4).
    """

    COMPACT_ZERO_FRACTION = 0.5

    def __init__(self, er: EncodedRelation):
        self.er = er
        self._index: dict[tuple[int, ...], int] = {
            tuple(row): i for i, row in enumerate(er.codes.tolist())
        }
        self.minmax_stale = False

    @property
    def num_rows(self) -> int:
        return self.er.num_rows

    def apply(self, delta: DeltaBatch) -> None:
        """Merge a signed, pre-aggregated delta batch. Raises ``ValueError``
        if a delete would drive any multiplicity negative (deleting tuples
        that are not present)."""
        er = self.er
        m = delta.num_rows
        if m == 0:
            return
        if delta.attrs != er.attrs:
            raise ValueError(
                f"delta for {delta.rel!r} has attrs {delta.attrs}, "
                f"maintained relation has {er.attrs}"
            )
        idx = np.empty(m, dtype=np.int64)
        fresh: list[int] = []
        rows = delta.codes.tolist()
        for j, row in enumerate(rows):
            idx[j] = self._index.get(tuple(row), -1)
            if idx[j] < 0:
                fresh.append(j)
        old = idx >= 0
        # validate the WHOLE batch before mutating anything: a rejected
        # batch must leave the maintained state (and thus every cached
        # message derived from it) untouched
        missing_pay = [k for k in er.payloads if k not in delta.payloads]
        if missing_pay:
            raise ValueError(
                f"delta for measure relation {delta.rel!r} must carry the "
                f"measure column (missing payloads {missing_pay})"
            )
        if fresh and (delta.count[np.asarray(fresh)] < 0).any():
            fi = np.asarray(fresh)
            bad = fresh[int(np.argmax(delta.count[fi] < 0))]
            raise ValueError(
                f"delete from {delta.rel!r} of absent row "
                f"{tuple(delta.codes[bad])}"
            )
        if old.any():
            oi, od = idx[old], delta.count[old]
            after = er.count[oi] + od
            if (after < 0).any():
                bad = int(np.argmax(after < 0))
                raise ValueError(
                    f"delete from {delta.rel!r} exceeds stored multiplicity "
                    f"for row {tuple(delta.codes[old][bad])}"
                )
            er.count[oi] = after
            if "sum" in er.payloads and "sum" in delta.payloads:
                er.payloads["sum"][oi] += delta.payloads["sum"][old]
            for k, red in (("min", np.minimum), ("max", np.maximum)):
                if k not in er.payloads or k not in delta.payloads:
                    continue
                if delta.sign > 0:
                    er.payloads[k][oi] = red(
                        er.payloads[k][oi], delta.payloads[k][old]
                    )
                else:
                    self.minmax_stale = True
        if fresh:
            fi = np.asarray(fresh)
            base = er.num_rows
            er.codes = np.concatenate([er.codes, delta.codes[fi]], axis=0)
            er.count = np.concatenate([er.count, delta.count[fi]])
            for k in er.payloads:  # payload presence validated above
                er.payloads[k] = np.concatenate(
                    [er.payloads[k], delta.payloads[k][fi]]
                )
            for j, f in enumerate(fresh):
                self._index[tuple(rows[f])] = base + j
        self._maybe_compact()

    def _maybe_compact(self) -> None:
        er = self.er
        zeros = int((er.count == 0).sum())
        if er.num_rows == 0 or zeros <= self.COMPACT_ZERO_FRACTION * er.num_rows:
            return
        keep = er.count != 0
        er.codes = er.codes[keep]
        er.count = er.count[keep]
        er.payloads = {k: v[keep] for k, v in er.payloads.items()}
        self._index = {
            tuple(row): i for i, row in enumerate(er.codes.tolist())
        }

    def live_view(self) -> EncodedRelation:
        """A copy restricted to rows with nonzero multiplicity (used by the
        MIN/MAX fallback, which must not see zero-count rows)."""
        er = self.er
        keep = er.count != 0
        if keep.all():
            return er
        return EncodedRelation(
            er.name, er.attrs, er.codes[keep], er.count[keep],
            {k: v[keep] for k, v in er.payloads.items()},
        )
