"""Aggressive partial pre-aggregation baseline [Larson, ICDE'02]
(paper Section V's "Pre-aggregation" competitor).

Left-deep binary joins where, after every join (and on every input), the
intermediate is projected to the attributes still needed (future join
attrs + group attrs) and duplicate rows collapse into a count weight.
This is the strongest classical competitor: it bounds each *relation's*
redundancy but cannot share work across branches the way JOIN-AGG's
path-id caching / subtree messages do (Section VIII).

COUNT only, matching the paper's experiments.  Port of the JAX
package's ``baselines/preagg.py`` over torch tensors on one device (CUDA
unless the caller passes ``device="cpu"``); weights are float64, as
there.
"""
from __future__ import annotations

import torch

from repro_torch.baselines.binary_join import BaselineStats
from repro_torch.core.query import JoinAggQuery, resolve_schema
from repro_torch.core.torch_engine import require_device
from repro_torch.relational.oracle import group_rows, natural_join, on_device
from repro_torch.relational.relation import Database

def _preaggregate(
    table: dict[str, torch.Tensor], weight: torch.Tensor, keep: list[str]
) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    if not keep:
        return {}, weight.sum().reshape(1)
    uniq, inv = group_rows([table[a] for a in keep])
    w = torch.bincount(inv, weights=weight, minlength=len(uniq[0]))
    return dict(zip(keep, uniq)), w


def _weighted_join(
    t1: dict[str, torch.Tensor], w1: torch.Tensor,
    t2: dict[str, torch.Tensor], w2: torch.Tensor,
    on: list[str],
) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    t1 = dict(t1)
    t2 = dict(t2)
    t1["__w1"] = w1
    t2["__w2"] = w2
    j = natural_join(t1, t2, on, device=w1.device)
    w = j.pop("__w1") * j.pop("__w2")
    return j, w


def preagg_join_agg(
    query: JoinAggQuery, db: Database, *, device="cuda"
) -> tuple[dict[tuple, float], BaselineStats]:
    if query.agg.kind != "count":
        raise NotImplementedError("pre-aggregation baseline implements COUNT")
    dev = require_device(device, "preagg_join_agg", 'device="cpu"')
    schema = resolve_schema(query, db)
    stats = BaselineStats()
    group_cols = [attr for _, attr in schema.group_attrs]

    order = list(query.relations)

    def future_attrs(remaining: list[str]) -> set[str]:
        """Join attrs of not-yet-joined relations + all group attrs."""
        need = set(group_cols)
        for r in remaining:
            need |= set(schema.relevant[r]) & schema.join_attrs
        return need

    def table(rname: str) -> dict[str, torch.Tensor]:
        return {a: on_device(db[rname].columns[a], dev) for a in schema.relevant[rname]}

    def ones(rname: str) -> torch.Tensor:
        return torch.ones(db[rname].num_rows, dtype=torch.float64, device=dev)

    first = order[0]
    remaining = order[1:]
    cols = table(first)
    keep = [a for a in cols if a in future_attrs(remaining)]
    acc, w = _preaggregate(cols, ones(first), keep)
    stats.record({**acc, "__w": w})

    while remaining:
        for rname in list(remaining):
            shared = [a for a in schema.relevant[rname] if a in acc]
            if not shared:
                continue
            cols = table(rname)
            rest = [r for r in remaining if r != rname]
            keep_r = [a for a in cols if a in future_attrs(rest) | set(shared)]
            t2, w2 = _preaggregate(cols, ones(rname), keep_r)
            acc, w = _weighted_join(acc, w, t2, w2, shared)
            stats.record({**acc, "__w": w})
            remaining.remove(rname)
            keep_now = [a for a in acc if a in future_attrs(remaining)]
            acc, w = _preaggregate(acc, w, keep_now)
            stats.record({**acc, "__w": w})
            break
        else:
            raise ValueError("disconnected join graph")

    res: dict[tuple, float] = {}
    if group_cols and acc:
        uniq, inv = group_rows([acc[a] for a in group_cols])
        vals = torch.bincount(inv, weights=w, minlength=len(uniq[0]))
        for k, v in zip(zip(*(c.tolist() for c in uniq)), vals.tolist()):
            if v:
                res[k] = float(v)
    return res, stats
