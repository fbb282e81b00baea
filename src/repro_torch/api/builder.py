"""The fluent query builder ``Q`` (DESIGN.md §6).

    res = (
        Q.over("R", "S", "T")
        .where("S", "m", ">", 0.0)
        .group_by("R.a", "T.b")
        .agg(count=Count(), total=Sum("S.m"), lo=Min("S.m"))
        .engine("torch")
        .plan(db)
        .execute()
    )

Every method returns a new immutable ``Q``; ``plan(db)`` compiles to a
:class:`~repro_torch.api.plan.Plan`.  Self-joins: pass ``("alias",
"Source")`` tuples (or repeat a bare name — occurrences auto-alias as
``name__2``, ``name__3``, ...) and rename the alias's columns with
``.rename``; ``Q.from_query`` wraps a catalog ``JoinAggQuery``.  Port
of the JAX package's ``api/builder.py``; ``.mesh`` and ``.maintain``
raise :class:`UnsupportedPlanOption`.  The port has
no dense path, so ``.fused(True)`` already runs on the sparse one.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Mapping

import numpy as np

from repro_torch.aggregates.semiring import AggSpec
from repro_torch.api.engines import TorchChannelEngine
from repro_torch.api.plan import Plan, Predicate, compile_plan
from repro_torch.core.operator import UnsupportedPlanOption
from repro_torch.core.query import JoinAggQuery
from repro_torch.relational.relation import Database


def _as_database(db) -> Database:
    """A ``Database`` passes through; a mapping of relations or column
    dicts is wrapped."""
    if isinstance(db, Database):
        return db
    if isinstance(db, Mapping):
        return Database.from_mapping(db)
    raise TypeError(
        f"cannot plan against {type(db).__name__}; pass a Database or a "
        "mapping of relations"
    )


_OPS: dict[str, Callable] = {
    "==": lambda c, v: c == v,
    "!=": lambda c, v: c != v,
    "<": lambda c, v: c < v,
    "<=": lambda c, v: c <= v,
    ">": lambda c, v: c > v,
    ">=": lambda c, v: c >= v,
    "in": lambda c, v: np.isin(c, np.asarray(list(v))),
}


def _parse_attr(spec) -> tuple[str, str]:
    """Accept ``("R", "a")`` or the dotted string ``"R.a"``."""
    if isinstance(spec, str):
        if "." not in spec:
            raise ValueError(f"group attr {spec!r}: use 'Relation.attr'")
        rel, attr = spec.split(".", 1)
        return rel, attr
    rel, attr = spec
    return rel, attr


@dataclass(frozen=True)
class Q:
    """Immutable logical-query builder; see the module docstring."""

    relations: tuple[tuple[str, str], ...] = ()  # (name-in-query, source)
    renames: tuple[tuple[str, tuple[tuple[str, str], ...]], ...] = ()
    predicates: tuple[Predicate, ...] = ()
    group_attrs: tuple[tuple[str, str], ...] = ()
    aggs: tuple[tuple[str, AggSpec], ...] = ()
    engine_name: str | TorchChannelEngine = "torch"
    budget: int | None = None
    stream_opt: tuple[str, int] | None = None
    stats_opt: bool = True  # statistics-driven planning (DESIGN.md §10)
    # fused hop kernels (DESIGN.md §13): True/False pins the choice,
    # None defers to the REPRO_FUSED environment switch
    fused_opt: bool | None = None

    # ------------------------------------------------------------------
    @staticmethod
    def over(*relations) -> "Q":
        """Start a query over the named relations.

        Entries are relation names or ``(alias, source)`` pairs; repeated
        bare names self-join via auto-aliases (``R``, ``R__2``, ...).
        """
        out: list[tuple[str, str]] = []
        seen: dict[str, int] = {}
        for r in relations:
            if isinstance(r, str):
                name = source = r
            else:
                name, source = r
            n = seen.get(name, 0) + 1
            seen[name] = n
            if n > 1:
                if name != source:
                    raise ValueError(f"duplicate alias {name!r}")
                name = f"{name}__{n}"
            out.append((name, source))
        names = [n for n, _ in out]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate relation aliases: {names}")
        return Q(relations=tuple(out))

    @staticmethod
    def from_query(query: JoinAggQuery) -> "Q":
        """Wrap a :class:`JoinAggQuery` (as the catalog in
        ``repro_torch.data`` hands them out) with its one aggregate,
        named after its kind."""
        attrs = [a for _, a in query.group_by]
        displays = {
            a if attrs.count(a) == 1 else f"{r}.{a}" for r, a in query.group_by
        }
        name = query.agg.kind
        while name in displays:  # a group column may be named e.g. "count"
            name += "_"
        return Q(
            relations=tuple((r, r) for r in query.relations),
            group_attrs=tuple(query.group_by),
            aggs=((name, query.agg),),
        )

    # ------------------------------------------------------------------
    def rename(self, relation: str, **mapping: str) -> "Q":
        """Rename columns of one (usually aliased) relation:
        ``.rename("I2", item="i2")`` renames column ``item`` to ``i2``.
        Chained calls on the same relation merge (later wins per column)."""
        self._check_rel(relation)
        merged: dict[str, str] = {}
        rest = []
        for r, m in self.renames:
            if r == relation:
                merged.update(dict(m))
            else:
                rest.append((r, m))
        merged.update(mapping)
        entry = (relation, tuple(merged.items()))
        return replace(self, renames=tuple(rest) + (entry,))

    def where(self, relation: str, *args, **eq) -> "Q":
        """Push a selection predicate down onto one relation.

        Three forms: a mask callable ``.where("R", lambda cols: mask)``,
        a comparison ``.where("R", "m", ">", 0.0)`` (ops: ``== != < <=
        > >= in``), or equality kwargs ``.where("R", a=3)``.
        """
        self._check_rel(relation)
        preds: list[Predicate] = []
        if args and callable(args[0]):
            fn = args[0]
            preds.append(Predicate(relation, getattr(fn, "__name__", "<fn>"), fn))
        elif args:
            attr, op, value = args
            if op not in _OPS:
                raise ValueError(f"unknown operator {op!r}; use {sorted(_OPS)}")
            opfn = _OPS[op]
            preds.append(
                Predicate(
                    relation,
                    f"{attr} {op} {value!r}",
                    lambda cols, a=attr, v=value, f=opfn: f(cols[a], v),
                )
            )
        for attr, value in eq.items():
            preds.append(
                Predicate(
                    relation,
                    f"{attr} == {value!r}",
                    lambda cols, a=attr, v=value: cols[a] == v,
                )
            )
        if not preds:
            raise ValueError("where() needs a callable, a comparison, or kwargs")
        return replace(self, predicates=self.predicates + tuple(preds))

    def group_by(self, *attrs) -> "Q":
        """Group attributes as ``"R.a"`` strings or ``(rel, attr)`` pairs."""
        parsed = tuple(_parse_attr(a) for a in attrs)
        for rel, _ in parsed:
            self._check_rel(rel)
        return replace(self, group_attrs=self.group_attrs + parsed)

    def agg(self, **named: AggSpec) -> "Q":
        """Named aggregates: ``.agg(n=Count(), total=Sum("S.m"))``.  All
        of them execute in one contraction pass; omitting ``.agg`` plans
        a single COUNT."""
        for name, spec in named.items():
            if not isinstance(spec, AggSpec):
                raise TypeError(
                    f"aggregate {name!r} must be an AggSpec "
                    f"(Count/Sum/Min/Max/Avg), got {type(spec).__name__}"
                )
        return replace(self, aggs=self.aggs + tuple(named.items()))

    # ------------------------------------------------------------------
    def engine(self, engine: str | TorchChannelEngine) -> "Q":
        """Pick the execution backend: ``"torch"`` (on CUDA) or an engine
        instance such as ``TorchChannelEngine(device="cpu")``."""
        return replace(self, engine_name=engine)

    def memory_budget(self, nbytes: int) -> "Q":
        """Peak-message budget before group-axis streaming kicks in."""
        return replace(self, budget=int(nbytes))

    def stream(self, attr: str, tile: int) -> "Q":
        """Explicit group-axis streaming plan: tiles of ``tile`` codes of
        group attribute ``attr``."""
        return replace(self, stream_opt=(attr, int(tile)))

    def mesh(self, mesh) -> "Q":
        raise UnsupportedPlanOption(
            "device meshes are not ported to repro_torch (one device only)"
        )

    def fused(self, enabled: bool = True) -> "Q":
        """Run every decomposition-tree hop as one ``fused_hop`` kernel
        launch (gather → product → segment reduction, DESIGN.md §13);
        ``False`` pins the three-dispatch kernels even when
        ``REPRO_FUSED`` is set.  Only fused-capable engines accept the
        option."""
        return replace(self, fused_opt=bool(enabled))

    def stats(self, enabled: bool = True) -> "Q":
        """Toggle statistics-driven planning (DESIGN.md §10).  When off,
        root choice falls back to the dense-bytes heuristic and per-split
        plans are disabled."""
        return replace(self, stats_opt=bool(enabled))

    def maintain(self, db):
        raise UnsupportedPlanOption(
            "incremental maintenance is not ported to repro_torch"
        )

    # ------------------------------------------------------------------
    def plan(self, db) -> Plan:
        """Compile against ``db`` (a :class:`Database` or a mapping of
        relations): logical rewrites, cost-based root / split / GHD
        choice, channelization."""
        return compile_plan(self, _as_database(db))

    def execute(self, db):
        """``plan(db).execute()`` in one call."""
        return self.plan(db).execute()

    # ------------------------------------------------------------------
    def _check_rel(self, relation: str) -> None:
        names = [n for n, _ in self.relations]
        if relation not in names:
            raise KeyError(f"relation {relation!r} not in query (have {names})")
