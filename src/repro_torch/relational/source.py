"""The ``RelationSource`` protocol — one ingestion surface (DESIGN.md §12).

Everything that feeds relations into the system (``prepare``, the ``Q``
builder, the incremental maintainer) speaks one protocol instead of
demanding in-RAM numpy columns:

* ``name`` / ``attrs`` / ``num_rows`` — schema without data access,
* ``iter_chunks(columns, chunk_rows)`` — stream row ranges as column
  dicts; the only way bulk data leaves a source, so disk-backed
  relations never materialize whole columns,
* ``open_column(attr)`` — a whole-column array view; ``np.memmap`` for
  disk-backed sources (reads page on demand), a plain ndarray for
  in-memory ones,
* ``storage_kind`` — ``"memory"`` / ``"mmap"`` / ``"derived"``, for
  ``Plan.explain()``'s storage section and the chunking heuristics.

The in-memory :class:`~repro_torch.relational.relation.Relation` is the
trivial source (one chunk).  The planner's logical rewrites (aliasing,
predicate pushdown, group-attr column copies) stay *lazy* over non-
memory sources via the wrapper sources below, so no caller outside
``relational/`` and ``storage/`` ever constructs columns eagerly — the
one sanctioned eager entry point is :func:`materialize_columns`.

Copy of the JAX package's ``relational/source.py``: the same protocol,
wrappers and chunking policy, so both packages stream a stored database
in the same chunks.
"""
from __future__ import annotations

import os
from typing import Callable, Iterator, Mapping, Protocol, runtime_checkable

import numpy as np

#: chunk size used when a disk-backed source is streamed and the caller
#: gave no explicit bound (rows per chunk, not bytes)
DEFAULT_CHUNK_ROWS = 1 << 18

#: assumed bytes of transient working set per streamed row when deriving
#: a chunk size from ``Q.memory_budget`` (encode buffers + sort runs)
_BUDGET_BYTES_PER_ROW = 128


@runtime_checkable
class RelationSource(Protocol):
    """Structural protocol every relation provider implements."""

    name: str

    @property
    def attrs(self) -> tuple[str, ...]: ...

    @property
    def num_rows(self) -> int: ...

    def iter_chunks(
        self,
        columns: tuple[str, ...] | None = None,
        chunk_rows: int | None = None,
    ) -> Iterator[dict[str, np.ndarray]]: ...

    def open_column(self, attr: str) -> np.ndarray: ...


def env_chunk_rows() -> int | None:
    """``REPRO_CHUNK_ROWS`` forces chunked streaming everywhere (the
    storage-smoke CI knob); unset means sources decide."""
    raw = os.environ.get("REPRO_CHUNK_ROWS", "")
    return int(raw) if raw else None


def storage_kind(source) -> str:
    """``"memory"`` / ``"mmap"`` / ``"derived(...)"`` for explain()."""
    kind = getattr(source, "storage_kind", "memory")
    if kind == "derived":
        base = getattr(source, "base", None)
        return f"derived({storage_kind(base)})" if base is not None else kind
    return kind


def is_disk_backed(source) -> bool:
    """True if the source (or any base it derives from) is mmap-backed."""
    while source is not None:
        if getattr(source, "storage_kind", "memory") == "mmap":
            return True
        source = getattr(source, "base", None)
    return False


def is_source(obj) -> bool:
    return (
        hasattr(obj, "iter_chunks")
        and hasattr(obj, "open_column")
        and hasattr(obj, "attrs")
    )


def as_source(obj, name: str | None = None):
    """The one ingestion adapter: RelationSource pass-through, Relation
    pass-through (renamed if needed), or a column mapping wrapped as an
    in-memory Relation."""
    from repro_torch.relational.relation import Relation

    if is_source(obj):
        if name is not None and obj.name != name:
            return rename_source(obj, name, {})
        return obj
    if isinstance(obj, Mapping):
        if name is None:
            raise ValueError("a column mapping needs an explicit name")
        return Relation(name, {a: np.asarray(c) for a, c in obj.items()})
    raise TypeError(
        f"cannot ingest {type(obj).__name__}; pass a RelationSource, a "
        "Relation, or a mapping of columns"
    )


# ----------------------------------------------------------------------
# the sanctioned eager exit
# ----------------------------------------------------------------------


def materialize_columns(
    source, attrs: tuple[str, ...] | None = None
) -> dict[str, np.ndarray]:
    """Whole columns as in-RAM arrays — the single sanctioned eager
    materialization (MIN/MAX raw-tuple retention, oracles, tests)."""
    attrs = tuple(attrs) if attrs is not None else tuple(source.attrs)
    return {a: np.asarray(source.open_column(a)) for a in attrs}


def materialize_relation(source):
    """``source`` as an in-memory :class:`Relation` (eager)."""
    from repro_torch.relational.relation import Relation

    return Relation(source.name, materialize_columns(source))


# ----------------------------------------------------------------------
# lazy rewrite wrappers (alias / predicate / column-copy)
# ----------------------------------------------------------------------


class _DerivedSource:
    """Base for lazy views over another source."""

    storage_kind = "derived"

    def __init__(self, base, name: str):
        self.base = base
        self.name = name

    @property
    def attrs(self) -> tuple[str, ...]:
        raise NotImplementedError

    @property
    def num_rows(self) -> int:
        return self.base.num_rows

    def iter_chunks(self, columns=None, chunk_rows=None):
        raise NotImplementedError

    def open_column(self, attr: str) -> np.ndarray:
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.name!r} over {self.base!r})"


class RenamedSource(_DerivedSource):
    """Lazy relation/column rename (the planner's self-join aliasing)."""

    def __init__(self, base, name: str, mapping: Mapping[str, str]):
        super().__init__(base, name)
        unknown = set(mapping) - set(base.attrs)
        if unknown:
            raise KeyError(
                f"relation {base.name!r} has no attrs {sorted(unknown)}"
            )
        self._fwd = {a: mapping.get(a, a) for a in base.attrs}  # base -> new
        self._rev = {v: k for k, v in self._fwd.items()}  # new -> base

    @property
    def attrs(self) -> tuple[str, ...]:
        return tuple(self._fwd[a] for a in self.base.attrs)

    def iter_chunks(self, columns=None, chunk_rows=None):
        want = tuple(columns) if columns is not None else self.attrs
        base_cols = tuple(self._rev[a] for a in want)
        for chunk in self.base.iter_chunks(base_cols, chunk_rows):
            yield {a: chunk[self._rev[a]] for a in want}

    def open_column(self, attr: str) -> np.ndarray:
        return self.base.open_column(self._rev[attr])


class FilteredSource(_DerivedSource):
    """Lazy selection: ``fn(columns) -> mask`` applied per chunk."""

    def __init__(self, base, fn: Callable[[dict], np.ndarray]):
        super().__init__(base, base.name)
        self.fn = fn
        self._num_rows: int | None = None

    @property
    def attrs(self) -> tuple[str, ...]:
        return tuple(self.base.attrs)

    @property
    def num_rows(self) -> int:
        if self._num_rows is None:
            total = 0
            for chunk in self.base.iter_chunks(None, None):
                total += int(np.count_nonzero(self._mask(chunk)))
            self._num_rows = total
        return self._num_rows

    def _mask(self, chunk: dict[str, np.ndarray]) -> np.ndarray:
        n = len(next(iter(chunk.values()))) if chunk else 0
        mask = np.asarray(self.fn(chunk))
        if mask.dtype != bool or len(mask) != n:
            raise ValueError(
                f"relation {self.name!r}: predicate mask must be bool of "
                f"length {n}, got {mask.dtype} × {len(mask)}"
            )
        return mask

    def iter_chunks(self, columns=None, chunk_rows=None):
        want = tuple(columns) if columns is not None else self.attrs
        # the predicate may touch columns outside the projection, so the
        # base streams all of them; only the projection is yielded
        for chunk in self.base.iter_chunks(None, chunk_rows):
            mask = self._mask(chunk)
            yield {a: chunk[a][mask] for a in want}

    def open_column(self, attr: str) -> np.ndarray:
        parts = [c[attr] for c in self.iter_chunks((attr,), None)]
        return (
            np.concatenate(parts)
            if parts
            else np.empty(0, self.base.open_column(attr).dtype)
        )


class ColumnCopySource(_DerivedSource):
    """Lazy duplicate of an existing column under a new name (the
    planner's automatic group-attribute column copies)."""

    def __init__(self, base, new_attr: str, src_attr: str):
        super().__init__(base, base.name)
        if src_attr not in base.attrs:
            raise KeyError(f"relation {base.name!r} has no attr {src_attr!r}")
        self.new_attr = new_attr
        self.src_attr = src_attr

    @property
    def attrs(self) -> tuple[str, ...]:
        return tuple(self.base.attrs) + (self.new_attr,)

    def iter_chunks(self, columns=None, chunk_rows=None):
        want = tuple(columns) if columns is not None else self.attrs
        base_cols = tuple(
            dict.fromkeys(
                self.src_attr if a == self.new_attr else a for a in want
            )
        )
        for chunk in self.base.iter_chunks(base_cols, chunk_rows):
            yield {
                a: chunk[self.src_attr if a == self.new_attr else a]
                for a in want
            }

    def open_column(self, attr: str) -> np.ndarray:
        if attr == self.new_attr:
            attr = self.src_attr
        return self.base.open_column(attr)


# ----------------------------------------------------------------------
# rewrite helpers used by the planner (eager for plain Relations so the
# in-memory fast path — and its golden plans — is byte-for-byte intact)
# ----------------------------------------------------------------------


def rename_source(source, name: str, mapping: Mapping[str, str]):
    from repro_torch.relational.relation import Relation

    if isinstance(source, Relation):
        return source.renamed(name, mapping)
    return RenamedSource(source, name, dict(mapping))


def filter_source(source, fn: Callable[[dict], np.ndarray]):
    from repro_torch.relational.relation import Relation

    if isinstance(source, Relation):
        return source.filter(np.asarray(fn(source.columns)))
    return FilteredSource(source, fn)


def copy_column_source(source, new_attr: str, src_attr: str):
    from repro_torch.relational.relation import Relation

    if isinstance(source, Relation):
        return source.with_column(new_attr, source.columns[src_attr])
    return ColumnCopySource(source, new_attr, src_attr)


# ----------------------------------------------------------------------
# chunking policy
# ----------------------------------------------------------------------


def resolve_chunk_rows(
    sources, chunk_rows: int | None = None, memory_budget: int | None = None
) -> int | None:
    """The effective streaming chunk size for a set of sources.

    Priority: explicit ``chunk_rows`` > ``REPRO_CHUNK_ROWS`` > a bound
    derived from ``memory_budget`` (disk-backed sources only) > the
    default for disk-backed sources > ``None`` (whole-column fast path
    for purely in-memory databases — bit-identical to the pre-storage
    pipeline)."""
    if chunk_rows is not None:
        return int(chunk_rows)
    env = env_chunk_rows()
    if env is not None:
        return env
    if any(is_disk_backed(s) for s in sources):
        if memory_budget is not None:
            derived = memory_budget // _BUDGET_BYTES_PER_ROW
            return int(min(max(derived, 1024), DEFAULT_CHUNK_ROWS))
        return DEFAULT_CHUNK_ROWS
    return None


def estimate_prepare_peak(sources, chunk_rows: int | None) -> int:
    """Estimated prepare-time peak bytes for ``Plan.explain()``.

    Whole-column mode materializes every encoded column at once; chunked
    mode holds one chunk's encode/sort working set (a few row-width
    multiples) plus the dictionaries."""
    sources = list(sources)
    whole = sum(8 * max(len(s.attrs), 1) * s.num_rows for s in sources)
    if chunk_rows is None:
        return whole
    return min(int(chunk_rows) * _BUDGET_BYTES_PER_ROW, whole)
