"""Traditional RDBMS baseline: binary hash joins with materialized
intermediates, then a hash aggregate (the paper's "PostgreSQL" column,
vectorized over torch tensors so the comparison runs in-process on the
same device as JOIN-AGG: CUDA unless the caller passes
``device="cpu"``).

Instrumented: reports the largest intermediate result (rows) and its
bytes — the quantity JOIN-AGG exists to avoid.  Port of the JAX
package's ``baselines/binary_join.py``; every intermediate lives on the
device and its statistics equal the reference's, byte for byte.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.core.query import JoinAggQuery, resolve_schema
from repro_torch.core.torch_engine import require_device
from repro_torch.relational.oracle import groupby_aggregate, natural_join, on_device
from repro_torch.relational.relation import Database

@dataclass
class BaselineStats:
    max_intermediate_rows: int = 0
    max_intermediate_bytes: int = 0
    intermediates: list[int] = field(default_factory=list)

    def record(self, table: dict[str, torch.Tensor]) -> None:
        n = len(next(iter(table.values()))) if table else 0
        b = sum(c.numel() * c.element_size() for c in table.values())
        self.intermediates.append(n)
        self.max_intermediate_rows = max(self.max_intermediate_rows, n)
        self.max_intermediate_bytes = max(self.max_intermediate_bytes, b)


def binary_join_agg(
    query: JoinAggQuery, db: Database, *, device="cuda"
) -> tuple[dict[tuple, float], BaselineStats]:
    """Left-deep binary joins in query order (joinable-first), then
    aggregate, on ``device``."""
    dev = require_device(device, "binary_join_agg", 'device="cpu"')
    schema = resolve_schema(query, db)
    stats = BaselineStats()
    group_cols = [attr for _, attr in schema.group_attrs]
    measure = query.agg.measure

    needed = set(schema.join_attrs) | set(group_cols)
    if measure:
        needed.add(measure[1])

    def table(rname: str) -> dict[str, torch.Tensor]:
        return {
            a: on_device(db[rname].columns[a], dev)
            for a in db[rname].attrs if a in needed
        }

    remaining = list(query.relations)
    acc = table(remaining.pop(0))
    stats.record(acc)
    while remaining:
        for rname in list(remaining):
            shared = [a for a in db[rname].attrs if a in needed and a in acc]
            if not shared:
                continue
            acc = natural_join(acc, table(rname), shared, device=dev)
            stats.record(acc)
            remaining.remove(rname)
            break
        else:
            raise ValueError("disconnected join graph")

    res = groupby_aggregate(
        acc, group_cols, query.agg, measure[1] if measure else None, device=dev
    )
    return res, stats
