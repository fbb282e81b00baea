"""Incremental maintenance behind the logical planner (DESIGN.md §6).

``Plan.maintain()`` returns either a raw
:class:`~repro_torch.incremental.maintained.MaintainedJoinAgg` (single
aggregate, no logical rewrites) or a :class:`MaintainedPlan`: a bundle
of maintained handles, one per named aggregate, whose
``insert``/``delete`` accept deltas **in original relation terms** —
alias fan-out, column renames, pushed-down predicates and
group-attribute copies are applied to every batch before it reaches the
handles, so callers never re-implement the plan's rewrites.  Every
handle keeps its caches on the plan engine's device.

Port of the JAX package's ``api/maintain.py``; the maintainable engines
are ``"torch"`` and ``"ref"`` (COUNT only, as the reference).
"""
from __future__ import annotations

import numpy as np

from repro_torch.api.plan import AggResult, Plan
from repro_torch.core.operator import UnsupportedPlanOption
from repro_torch.core.query import JoinAggQuery
from repro_torch.incremental.maintained import MaintainedJoinAgg, _columns_of
from repro_torch.relational.relation import Relation

_MAINTAINABLE = ("torch", "ref")


def _engine_name(plan: Plan) -> str:
    name = plan.engine.name
    if name not in _MAINTAINABLE:
        raise UnsupportedPlanOption(
            f"maintenance supports the built-in engines {_MAINTAINABLE}, "
            f"not {name!r}"
        )
    return name


def _handle(plan: Plan, query: JoinAggQuery) -> MaintainedJoinAgg:
    """``query`` over the plan's database, maintained on the plan engine's
    device (which raises when it is a card that is absent)."""
    return MaintainedJoinAgg(
        query, plan.db, engine=_engine_name(plan), device=plan.engine.device
    )


def raw_handle(plan: Plan) -> MaintainedJoinAgg:
    """Single-aggregate handle: the plan's (rewrite-free) query,
    maintained."""
    return _handle(plan, plan.query)


class MaintainedPlan:
    """Maintained named-aggregate bundle over a compiled :class:`Plan`.

    One :class:`MaintainedJoinAgg` per named aggregate (each keeps its own
    message caches — unlike ``execute()``'s single multi-channel pass,
    maintenance trades that fusion for per-aggregate dirty-path reuse).
    """

    def __init__(self, plan: Plan):
        self.plan = plan
        self._renames = {r: dict(m) for r, m in plan.spec.renames}
        self._copies = plan._group_copies()
        self._preds: dict[str, list] = {}
        for p in plan.spec.predicates:
            self._preds.setdefault(p.relation, []).append(p)
        # original source name -> aliases; alias names address themselves
        self._targets: dict[str, list[str]] = {}
        for name, source in plan.spec.relations:
            self._targets.setdefault(source, []).append(name)
            self._targets.setdefault(name, []).append(name)
        self.handles = {
            name: _handle(
                plan, JoinAggQuery(plan.query.relations, plan.query.group_by, agg)
            )
            for name, agg in plan.aggs
        }

    # ------------------------------------------------------------------
    def insert(self, rel: str, tuples) -> AggResult:
        return self._apply("insert", rel, tuples)

    def delete(self, rel: str, tuples) -> AggResult:
        return self._apply("delete", rel, tuples)

    def _apply(self, op: str, rel: str, tuples) -> AggResult:
        targets = dict.fromkeys(self._targets.get(rel, ()))
        if not targets:
            raise KeyError(f"relation {rel!r} not in query")
        cols = _columns_of(tuples)
        for alias in targets:
            acols = self._rewrite_delta(alias, cols)
            if len(next(iter(acols.values()), ())) == 0:
                continue  # predicate filtered the whole batch out
            for handle in self.handles.values():
                getattr(handle, op)(alias, acols)
        return self.result()

    def _rewrite_delta(
        self, alias: str, cols: dict[str, np.ndarray]
    ) -> dict[str, np.ndarray]:
        mapping = self._renames.get(alias, {})
        out = {mapping.get(a, a): np.asarray(c) for a, c in cols.items()}
        for pred in self._preds.get(alias, ()):
            mask = np.asarray(pred.fn(out))
            out = {a: c[mask] for a, c in out.items()}
        copy = self._copies.get(alias)
        if copy is not None:
            src, dst = copy
            out[dst] = out[src]
        return out

    # ------------------------------------------------------------------
    def result(self) -> AggResult:
        """Current columnar result assembled from every handle."""
        per = {name: h.result() for name, h in self.handles.items()}
        keys: set[tuple] = set()
        for d in per.values():
            keys |= set(d)
        rows = sorted(keys)
        plan = self.plan
        cols: dict[str, np.ndarray] = {}
        for i, g in enumerate(plan.group_display):
            cols[g] = np.array([k[i] for k in rows])
        for name, _ in plan.aggs:
            cols[name] = np.array([per[name].get(k, 0.0) for k in rows])
        return AggResult(
            group_names=plan.group_display,
            agg_names=tuple(n for n, _ in plan.aggs),
            agg_kinds={n: a.kind for n, a in plan.aggs},
            relation=Relation("result", cols),
        )

    @property
    def stats(self):
        """Per-aggregate refresh stats (name -> RefreshStats)."""
        return {name: h.stats for name, h in self.handles.items()}
