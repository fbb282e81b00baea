"""Columnar relations — the port's storage substrate.

A :class:`Relation` is a dict of equal-length numpy columns and a
:class:`Database` a named collection of *relation sources*
(DESIGN.md §12).  A plain :class:`Relation` is the trivial
:class:`~repro_torch.relational.source.RelationSource` — one in-RAM
chunk; disk-backed relations live in :mod:`repro_torch.storage` and
stream through the same protocol.  Copy of the JAX package's
``relational/relation.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Iterator, Mapping

import numpy as np


@dataclass
class Relation:
    """A named bag of tuples stored column-wise."""

    name: str
    columns: dict[str, np.ndarray]

    storage_kind = "memory"

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

    def project(self, attrs: Iterable[str]) -> "Relation":
        """Bag-semantics projection (no duplicate elimination)."""
        attrs = tuple(attrs)
        missing = set(attrs) - set(self.columns)
        if missing:
            raise KeyError(f"relation {self.name!r} has no attrs {sorted(missing)}")
        return Relation(self.name, {a: self.columns[a] for a in attrs})

    def rows(self) -> np.ndarray:
        """Row-major (n, k) view over the columns, in attr order."""
        return np.stack([self.columns[a] for a in self.attrs], axis=1)

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

    @staticmethod
    def from_rows(name: str, attrs: Iterable[str], rows: np.ndarray) -> "Relation":
        attrs = tuple(attrs)
        rows = np.asarray(rows)
        if rows.ndim != 2 or rows.shape[1] != len(attrs):
            raise ValueError(f"rows shape {rows.shape} != (n, {len(attrs)})")
        return Relation(name, {a: rows[:, i] for i, a in enumerate(attrs)})

    # -- RelationSource protocol (the trivial in-memory source) ---------
    def iter_chunks(
        self,
        columns: tuple[str, ...] | None = None,
        chunk_rows: int | None = None,
    ) -> Iterator[dict[str, np.ndarray]]:
        """Stream row ranges as column dicts; one chunk when unbounded."""
        attrs = tuple(columns) if columns is not None else self.attrs
        missing = set(attrs) - set(self.columns)
        if missing:
            raise KeyError(f"relation {self.name!r} has no attrs {sorted(missing)}")
        n = self.num_rows
        step = n if chunk_rows is None else max(int(chunk_rows), 1)
        for start in range(0, n, step) if n else ():
            stop = min(start + step, n)
            yield {a: self.columns[a][start:stop] for a in attrs}

    def open_column(self, attr: str) -> np.ndarray:
        return self.columns[attr]


@dataclass
class Database:
    """A named collection of relation sources.

    Values are anything speaking the
    :class:`~repro_torch.relational.source.RelationSource` protocol:
    plain in-memory :class:`Relation`\\ s, disk-backed
    :class:`~repro_torch.storage.store.StoredRelation`\\ s, or the
    planner's lazy rewrite wrappers.  ``from_mapping`` stays the thin
    eager adapter; ``from_sources`` is the unified ingestion spelling."""

    relations: dict[str, "Relation"] = field(default_factory=dict)

    def __getitem__(self, name: str):
        return self.relations[name]

    def __contains__(self, name: str) -> bool:
        return name in self.relations

    def add(self, rel) -> "Database":
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

    @staticmethod
    def from_sources(mapping: Mapping[str, object]) -> "Database":
        """Named sources of any spelling (RelationSource, Relation, or a
        column mapping) — the one ingestion surface (DESIGN.md §12)."""
        from repro_torch.relational.source import as_source

        db = Database()
        for name, obj in mapping.items():
            db.add(as_source(obj, name))
        return db
