"""JSON wire format for the TCP line protocol (DESIGN.md §9).

One request per line, one response per line.  A query spec travels as a
plain JSON object and is rebuilt into a :class:`~repro_torch.api.builder.Q`
here; only the *declarative* subset crosses the wire (comparison/equality
predicates — no callables), which is exactly the subset the plan cache
can key, so remote queries are always cacheable.

Request objects::

    {"op": "query",  "q": {...}}                      -> {"ok": true, "result": {...}}
    {"op": "register", "name": "R", "columns": {...}} -> {"ok": true, "generation": g}
    {"op": "view_create", "name": "v", "q": {...}}    -> {"ok": true, "epoch": 0}
    {"op": "view_read", "name": "v"}                  -> {"ok": true, "epoch": e, "result": {...}}
    {"op": "view_apply", "name": "v", "delta": {"op": "insert",
        "rel": "R", "columns": {...}}}                -> {"ok": true, "epoch": e}
    {"op": "stats"} / {"op": "ping"}                  -> {"ok": true, ...}

Every response carries ``"ok"``; failures carry ``"error"`` with the
exception text instead of tearing the connection down.  The one engine
a request may name is ``"torch"``, the server's own; ``"mesh"`` is
refused as :meth:`Q.mesh` refuses it.

Port of the JAX package's ``serve/wire.py``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.aggregates.semiring import Avg, Count, Max, Min, Sum
from repro_torch.api.builder import Q
from repro_torch.api.plan import AggResult
from repro_torch.relational.relation import Relation

_AGG_KINDS = {"count": Count, "sum": Sum, "avg": Avg, "min": Min, "max": Max}


def q_from_spec(obj: dict) -> Q:
    """Build a :class:`Q` from its JSON form.

    Keys: ``relations`` (names or ``[alias, source]`` pairs),
    ``group_by`` (``"R.a"`` strings), ``aggs`` (name -> ``{"kind": ...,
    "measure": "R.m"}``), ``where`` (``[rel, attr, op, value]`` rows),
    ``renames`` (rel -> {old: new}), ``engine`` (``"torch"`` only),
    ``memory_budget``, ``stream`` (``[attr, tile]``), ``mesh`` (refused).
    """
    rels = [tuple(r) if isinstance(r, (list, tuple)) else r
            for r in obj.get("relations", ())]
    q = Q.over(*rels)
    for rel, mapping in obj.get("renames", {}).items():
        q = q.rename(rel, **mapping)
    for rel, attr, op, value in obj.get("where", ()):
        q = q.where(rel, attr, op, value)
    gb = obj.get("group_by", ())
    if gb:
        q = q.group_by(*gb)
    aggs = {}
    for name, spec in obj.get("aggs", {}).items():
        kind = spec["kind"] if isinstance(spec, dict) else spec
        cls = _AGG_KINDS.get(kind)
        if cls is None:
            raise ValueError(f"unknown aggregate kind {kind!r}")
        if kind == "count":
            aggs[name] = cls()
        else:
            measure = spec.get("measure") if isinstance(spec, dict) else None
            if not measure:
                raise ValueError(f"aggregate {name!r} ({kind}) needs a measure")
            aggs[name] = cls(measure)
    if aggs:
        q = q.agg(**aggs)
    if "engine" in obj:
        if obj["engine"] != "torch":
            raise ValueError(
                f"unknown engine {obj['engine']!r}; this server runs 'torch'"
            )
        q = q.engine("torch")
    if obj.get("memory_budget") is not None:
        q = q.memory_budget(obj["memory_budget"])
    if obj.get("stream") is not None:
        attr, tile = obj["stream"]
        q = q.stream(attr, tile)
    if obj.get("mesh") is not None:
        q = q.mesh(int(obj["mesh"]))
    return q


def _jsonable_column(col: np.ndarray) -> list:
    col = np.asarray(col)
    if np.issubdtype(col.dtype, np.integer):
        return [int(v) for v in col]
    if np.issubdtype(col.dtype, np.floating):
        return [float(v) for v in col]
    return [str(v) for v in col]


def result_to_json(res: AggResult) -> dict:
    return {
        "group_names": list(res.group_names),
        "agg_names": list(res.agg_names),
        "agg_kinds": dict(res.agg_kinds),
        "columns": {
            name: _jsonable_column(res.relation.columns[name])
            for name in (*res.group_names, *res.agg_names)
        },
    }


def result_from_json(obj: dict) -> AggResult:
    cols = {name: np.asarray(vals) for name, vals in obj["columns"].items()}
    return AggResult(
        group_names=tuple(obj["group_names"]),
        agg_names=tuple(obj["agg_names"]),
        agg_kinds=dict(obj["agg_kinds"]),
        relation=Relation("result", cols),
    )


def columns_from_json(obj: dict) -> dict[str, np.ndarray]:
    """Delta / registration columns: lists -> numpy arrays."""
    return {a: np.asarray(c) for a, c in obj.items()}


def plain(v):
    """numpy scalar -> builtin, for json serialisation."""
    return v.item() if hasattr(v, "item") else v
