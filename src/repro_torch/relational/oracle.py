"""Brute-force oracle: materialize the full join, then group-by aggregate.

This is the "traditional" semantics both engines are validated against,
as vectorized hash joins over torch tensors on one device: CUDA unless
the caller passes ``device="cpu"``.  The joined intermediate lives on
that device — its size is the cost the paper's operator avoids — so
inputs are sized to fit it.

Port of the JAX package's ``relational/oracle.py``.  ``np.unique(axis=0)``
over stacked key columns becomes one int64 key per row (mixed radix over
each column's range) where the ranges' product fits below 2**63, else
``torch.unique(dim=0)``; the rest is ``torch.sort``/``searchsorted``/
``repeat_interleave`` for the join and ``bincount``/``scatter_reduce_``
for the aggregates.  The joined rows come out in the reference's order.
"""
from __future__ import annotations

from functools import reduce
from typing import Mapping

import numpy as np
import torch

from repro_torch.aggregates.semiring import AggSpec
from repro_torch.core.query import JoinAggQuery, resolve_schema
from repro_torch.core.torch_engine import require_device
from repro_torch.relational.relation import Database

Table = dict[str, torch.Tensor]

WHAT = "the brute-force oracle"
CPU = 'device="cpu"'


def on_device(col, device: torch.device) -> torch.Tensor:
    """``col`` (a host array or a tensor) as a tensor on ``device``."""
    if isinstance(col, torch.Tensor):
        return col.to(device)
    return torch.as_tensor(np.asarray(col), device=device)


def _num_rows(table: Table) -> int:
    return len(next(iter(table.values()))) if table else 0


def _ranges(cols: list[torch.Tensor]) -> list[tuple[int, int]] | None:
    """Each integer column's ``(low, radix)``, when the product of the
    radices fits below 2**63; None for float columns or a larger
    product."""
    if any(c.dtype.is_floating_point or c.dtype == torch.bool for c in cols):
        return None
    if cols[0].numel() == 0:
        return [(0, 1)] * len(cols)
    ranges = []
    for c in cols:
        lo, hi = (int(v) for v in torch.aminmax(c))
        ranges.append((lo, hi - lo + 1))
    if reduce(lambda a, b: a * b, (r for _, r in ranges)) >= 1 << 63:
        return None
    return ranges


def _ravel(cols: list[torch.Tensor], ranges) -> torch.Tensor:
    """One int64 key per row, ordered as the rows' tuples: the columns in
    mixed radix, the first most significant."""
    key = torch.zeros(cols[0].shape, dtype=torch.int64, device=cols[0].device)
    for c, (lo, radix) in zip(cols, ranges):
        key.mul_(radix).add_(c.to(torch.int64) - lo)
    return key


def group_rows(cols: list[torch.Tensor]) -> tuple[list[torch.Tensor], torch.Tensor]:
    """The distinct rows of ``cols`` in lexicographic order, as columns
    of the columns' common dtype (as ``np.stack`` promotes), and each
    row's index among them."""
    dtype = reduce(torch.promote_types, (c.dtype for c in cols))
    cols = [c.to(dtype) for c in cols]
    if len(cols) == 1:
        uniq, inv = torch.unique(cols[0], sorted=True, return_inverse=True)
        return [uniq], inv
    ranges = _ranges(cols)
    if ranges is None:
        uniq, inv = torch.unique(
            torch.stack(cols, dim=1), dim=0, sorted=True, return_inverse=True
        )
        return [uniq[:, i] for i in range(len(cols))], inv
    uniq, inv = torch.unique(_ravel(cols, ranges), sorted=True, return_inverse=True)
    out = []
    for lo, radix in reversed(ranges):
        out.append((uniq % radix + lo).to(dtype))
        uniq = uniq // radix
    return out[::-1], inv


def natural_join(t1, t2, on: list[str], *, device="cuda") -> Table:
    """All-matches natural join of two column tables on ``on`` attrs, on
    ``device``: each of ``t1``'s rows in order, with its matches in
    ``t2``'s order."""
    if not on:
        raise ValueError("cross product joins unsupported")
    dev = require_device(device, WHAT, CPU)
    t1 = {a: on_device(c, dev) for a, c in t1.items()}
    t2 = {a: on_device(c, dev) for a, c in t2.items()}
    n1 = _num_rows(t1)
    both = []
    for a in on:
        dtype = torch.promote_types(t1[a].dtype, t2[a].dtype)
        both.append(torch.cat([t1[a].to(dtype), t2[a].to(dtype)]))
    if len(both) == 1:
        key = both[0]
    else:
        ranges = _ranges(both)
        key = group_rows(both)[1] if ranges is None else _ravel(both, ranges)
    # each temporary goes as soon as it is spent: on the card the join's
    # index arrays, as long as the joined rows, set its peak
    del both
    k1, k2 = key[:n1], key[n1:]
    k2s, order2 = torch.sort(k2, stable=True)
    start = torch.searchsorted(k2s, k1, right=False)
    counts = torch.searchsorted(k2s, k1, right=True) - start
    del key, k1, k2, k2s
    total = int(counts.sum())
    rep1 = torch.repeat_interleave(
        torch.arange(n1, device=dev), counts, output_size=total
    )
    # the match's place in t2's sorted order: its key's first place plus
    # its rank among the row's matches
    shift = start - (torch.cumsum(counts, 0) - counts)
    del start, counts
    pos = shift[rep1]
    del shift
    pos += torch.arange(total, device=dev)
    idx2 = order2[pos]
    del pos, order2
    out: Table = {a: c[rep1] for a, c in t1.items()}
    del rep1
    for a, c in t2.items():
        if a not in out:
            out[a] = c[idx2]
    return out


def materialize_relations(relations, db: Database, *, device="cuda") -> Table:
    """Join the named relations (order-insensitive for natural joins) on
    ``device``; each relation's columns go there once."""
    dev = require_device(device, WHAT, CPU)

    def table(rname: str) -> Table:
        return {a: on_device(db[rname].columns[a], dev) for a in db[rname].attrs}

    remaining = list(relations)
    acc = table(remaining.pop(0))
    while remaining:
        progressed = False
        for rname in list(remaining):
            shared = [a for a in db[rname].attrs if a in acc]
            if shared:
                acc = natural_join(acc, table(rname), shared, device=dev)
                remaining.remove(rname)
                progressed = True
        if not progressed:
            raise ValueError("disconnected join graph")
    return acc


def materialize_join(query: JoinAggQuery, db: Database, *, device="cuda") -> Table:
    """Join all query relations (acyclic order-insensitive for natural joins)."""
    return materialize_relations(query.relations, db, device=device)


def groupby_aggregate(
    joined,
    group_cols: list[str],
    agg: AggSpec,
    measure_col: str | None,
    *,
    device="cuda",
) -> dict[tuple, float]:
    """``{group values: aggregate}`` over every group of ``joined`` (a
    table of host arrays or tensors), computed on ``device``."""
    dev = require_device(device, WHAT, CPU)
    if _num_rows(joined) == 0:
        return {}
    uniq, inv = group_rows([on_device(joined[c], dev) for c in group_cols])
    size = len(uniq[0])
    counts = torch.bincount(inv, minlength=size).to(torch.float64)
    if agg.kind == "count":
        vals = counts
    else:
        m = on_device(joined[measure_col], dev).to(torch.float64)
        if agg.kind == "sum":
            vals = torch.bincount(inv, weights=m, minlength=size)
        elif agg.kind == "avg":
            vals = torch.bincount(inv, weights=m, minlength=size) / counts
        elif agg.kind in ("min", "max"):
            fill = np.inf if agg.kind == "min" else -np.inf
            vals = torch.full((size,), fill, dtype=torch.float64, device=dev)
            vals.scatter_reduce_(0, inv, m, "amin" if agg.kind == "min" else "amax")
        else:
            raise ValueError(agg.kind)
    keys = zip(*(c.tolist() for c in uniq))
    return dict(zip(keys, vals.tolist()))


def oracle_joinagg(
    query: JoinAggQuery, db: Database, lenient: bool = False, *, device="cuda"
) -> dict[tuple, float]:
    """Reference answer: dict of group-value tuples -> aggregate value.

    ``lenient=True`` skips schema validation so cyclic queries whose group
    attributes participate in joins (handled by the GHD compiler's
    column-copy convention) can still be cross-checked brute-force —
    ``materialize_join`` is join-order-insensitive either way."""
    dev = require_device(device, WHAT, CPU)
    if not lenient:
        resolve_schema(query, db)  # validates
    joined = materialize_join(query, db, device=dev)
    group_cols = [attr for _, attr in query.group_by]
    measure_col = query.agg.measure[1] if query.agg.measure else None
    return groupby_aggregate(joined, group_cols, query.agg, measure_col, device=dev)


def oracle_multiagg(
    relations,
    group_by,
    aggs: Mapping[str, AggSpec],
    db: Database,
    *,
    device="cuda",
) -> dict[tuple, dict[str, float]]:
    """Brute-force answer for a *named-aggregate bundle* in one join pass.

    Returns ``{group values: {agg name: value}}`` over every group of the
    materialized join (the columnar ``AggResult`` row set — groups whose
    join is non-empty), unlike :func:`oracle_joinagg`'s legacy dict which
    drops zero-valued entries.  Group attributes may participate in joins
    (the planner's column-copy rewrite is the caller's concern; the full
    join is insensitive to it).
    """
    dev = require_device(device, WHAT, CPU)
    joined = materialize_relations(relations, db, device=dev)
    group_cols = [attr for _, attr in group_by]
    per_agg: dict[str, dict[tuple, float]] = {}
    keys: set[tuple] = set()
    for name, agg in aggs.items():
        measure_col = agg.measure[1] if agg.measure else None
        d = groupby_aggregate(joined, group_cols, agg, measure_col, device=dev)
        per_agg[name] = d
        keys |= set(d)
    return {
        key: {name: per_agg[name].get(key, 0.0) for name in aggs} for key in keys
    }
