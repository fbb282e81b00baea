"""Join-aggregate query specification (paper Section II-A).

``Q(R, G)``: a natural multi-way join over relations ``R`` with group-by
attributes ``G``, one group attribute per *group relation*.  Join
attributes are attribute names shared by >= 2 participating relations
(natural-join semantics); group attributes must not participate in a join
condition (the paper relaxes this by column-copying — we require the copy
to have been done by the caller and raise otherwise).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.aggregates.semiring import AggSpec, Count
from repro_torch.relational.relation import Database


@dataclass(frozen=True)
class JoinAggQuery:
    relations: tuple[str, ...]
    group_by: tuple[tuple[str, str], ...]  # (relation, attribute)
    agg: AggSpec = field(default_factory=Count)

    def __post_init__(self) -> None:
        if len(set(self.relations)) != len(self.relations):
            raise ValueError("duplicate relation names; alias copies before querying")
        rels = set(self.relations)
        for rel, _ in self.group_by:
            if rel not in rels:
                raise ValueError(f"group-by relation {rel!r} not in query")


@dataclass(frozen=True)
class QuerySchema:
    """Resolved, validated view of a query against a database."""

    query: JoinAggQuery
    join_attrs: frozenset[str]
    group_attrs: tuple[tuple[str, str], ...]  # in query order
    # per relation: query-relevant attrs = (attrs ∩ join_attrs) ∪ own group attrs
    relevant: dict[str, tuple[str, ...]]
    group_of: dict[str, str]  # group relation -> its group attribute


def resolve_schema(
    query: JoinAggQuery, db: Database, allow_group_join_attrs: bool = False
) -> QuerySchema:
    """Validate the query against ``db``.

    ``allow_group_join_attrs=True`` permits group attrs that participate
    in joins — used by the GHD compiler, which realizes the paper's
    column-copy convention itself (Section II-A); the acyclic pipeline
    requires the caller to have done the copy and keeps the check.
    """
    attr_count: dict[str, int] = {}
    for rname in query.relations:
        for a in db[rname].attrs:
            attr_count[a] = attr_count.get(a, 0) + 1
    join_attrs = frozenset(a for a, c in attr_count.items() if c >= 2)

    group_of: dict[str, str] = {}
    for rel, attr in query.group_by:
        if attr not in db[rel].attrs:
            raise ValueError(f"group attr {rel}.{attr} does not exist")
        if attr in join_attrs and not allow_group_join_attrs:
            raise ValueError(
                f"group attr {rel}.{attr} participates in a join; "
                "copy the column under a fresh name first (Section II-A) — "
                "the logical planner (repro_torch.api.Q) performs this copy "
                "automatically"
            )
        if rel in group_of:
            raise ValueError(
                f"relation {rel!r} has two group attrs; alias a copy of the "
                "relation instead (Section II-A, w.l.o.g. assumption)"
            )
        group_of[rel] = attr

    relevant: dict[str, tuple[str, ...]] = {}
    for rname in query.relations:
        attrs = [a for a in db[rname].attrs if a in join_attrs]
        g = group_of.get(rname)
        if g and g not in attrs:
            attrs.append(g)
        if not attrs:
            raise ValueError(f"relation {rname!r} contributes no join/group attrs")
        relevant[rname] = tuple(attrs)

    # connectivity: every relation must share a join attr with some other one
    if len(query.relations) > 1:
        for rname in query.relations:
            if not any(a in join_attrs for a in relevant[rname]):
                raise ValueError(f"relation {rname!r} is a cross product (unsupported)")

    return QuerySchema(query, join_attrs, tuple(query.group_by), relevant, group_of)
