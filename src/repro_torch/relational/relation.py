"""Columnar in-memory relations — the port's storage substrate.

A :class:`Relation` is a dict of equal-length numpy columns and a
:class:`Database` a named collection of them.  This is the in-memory half
of the JAX package's ``relational/relation.py``; the planner's rewrites
(aliasing, predicate pushdown, group-attribute column copies) call
:meth:`Relation.renamed`, :meth:`Relation.filter` and
:meth:`Relation.with_column` directly, which is what the JAX package's
``rename_source``/``filter_source``/``copy_column_source`` do for an
in-memory relation.  The disk-backed ``RelationSource`` path is not
ported, so every relation's ``storage_kind`` is ``"memory"`` and
:func:`estimate_prepare_peak` knows the whole-column mode only.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping

import numpy as np


@dataclass
class Relation:
    """A named bag of tuples stored column-wise."""

    name: str
    columns: dict[str, np.ndarray]

    storage_kind = "memory"  # for explain(); no disk-backed tier is ported

    def __post_init__(self) -> None:
        lengths = {len(col) for col in self.columns.values()}
        if len(lengths) > 1:
            raise ValueError(f"relation {self.name!r}: ragged columns {lengths}")
        self.columns = {a: np.asarray(c) for a, c in self.columns.items()}

    @property
    def attrs(self) -> tuple[str, ...]:
        return tuple(self.columns)

    @property
    def num_rows(self) -> int:
        if not self.columns:
            return 0
        return len(next(iter(self.columns.values())))

    def filter(self, mask: np.ndarray) -> "Relation":
        """Rows where ``mask`` holds (the planner's selection pushdown)."""
        mask = np.asarray(mask)
        if mask.dtype != bool or len(mask) != self.num_rows:
            raise ValueError(
                f"relation {self.name!r}: predicate mask must be bool of "
                f"length {self.num_rows}, got {mask.dtype} × {len(mask)}"
            )
        return Relation(self.name, {a: c[mask] for a, c in self.columns.items()})

    def renamed(
        self, name: str | None = None, columns: Mapping[str, str] | None = None
    ) -> "Relation":
        """Copy under a new relation name and/or with renamed columns
        (the planner's self-join aliasing)."""
        columns = dict(columns or {})
        unknown = set(columns) - set(self.columns)
        if unknown:
            raise KeyError(f"relation {self.name!r} has no attrs {sorted(unknown)}")
        return Relation(
            name or self.name,
            {columns.get(a, a): c for a, c in self.columns.items()},
        )

    def with_column(self, attr: str, values: np.ndarray) -> "Relation":
        """Copy with one extra (or replaced) column — used for the
        planner's automatic group-attribute column copies."""
        cols = dict(self.columns)
        cols[attr] = np.asarray(values)
        return Relation(self.name, cols)


def estimate_prepare_peak(relations) -> int:
    """Estimated prepare-time peak bytes for ``Plan.explain()``: the
    whole-column mode materializes every encoded column at once."""
    return sum(8 * max(len(r.attrs), 1) * r.num_rows for r in relations)


@dataclass
class Database:
    """A named collection of in-memory relations."""

    relations: dict[str, Relation] = field(default_factory=dict)

    def __getitem__(self, name: str) -> Relation:
        return self.relations[name]

    def __contains__(self, name: str) -> bool:
        return name in self.relations

    def add(self, rel: Relation) -> "Database":
        self.relations[rel.name] = rel
        return self

    @staticmethod
    def from_mapping(mapping: Mapping[str, object]) -> "Database":
        """Relations from ``{name: Relation or {attr: column}}``."""
        db = Database()
        for name, obj in mapping.items():
            if isinstance(obj, Relation):
                db.add(obj if obj.name == name else obj.renamed(name))
            else:
                db.add(Relation(name, dict(obj)))
        return db

