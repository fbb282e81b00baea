"""Memory-mapped columnar relation store (DESIGN.md §12).

:class:`StoredRelation` implements the
:class:`~repro_torch.relational.source.RelationSource` protocol over a
directory of raw column files plus a JSON manifest
(:mod:`repro_torch.storage.manifest`).  ``open_column`` returns a read-only
``np.memmap`` — pages load on demand, so downstream numpy code runs
unchanged without the column ever being resident all at once —
and ``iter_chunks`` slices those memmaps into bounded row ranges.

``write_relation`` streams any source to disk chunk-by-chunk (never
materializing a whole column), recording per-column ascending-order
flags in the manifest as it goes; ``append`` extends the files in place
for the serving layer's delta ingestion (clearing the sort flags of the
columns it touches).
"""
from __future__ import annotations

from pathlib import Path
from typing import Iterator, Mapping

import numpy as np

from repro_torch.relational.source import DEFAULT_CHUNK_ROWS
from repro_torch.storage.manifest import (
    ColumnMeta,
    Manifest,
    read_manifest,
    write_manifest,
)


class StoredRelation:
    """A disk-backed relation source: memmap columns + manifest."""

    storage_kind = "mmap"

    def __init__(self, directory: str | Path, manifest: Manifest):
        self.directory = Path(directory)
        self.manifest = manifest
        self.name = manifest.name
        self._memmaps: dict[str, np.ndarray] = {}

    # -- RelationSource -------------------------------------------------
    @property
    def attrs(self) -> tuple[str, ...]:
        return self.manifest.attrs

    @property
    def num_rows(self) -> int:
        return self.manifest.num_rows

    def open_column(self, attr: str) -> np.ndarray:
        col = self._memmaps.get(attr)
        if col is None:
            meta = self.manifest.columns.get(attr)
            if meta is None:
                raise KeyError(
                    f"relation {self.name!r} has no attr {attr!r}"
                )
            dtype = np.dtype(meta.dtype)
            n = self.manifest.num_rows
            col = self._memmaps[attr] = (
                np.memmap(
                    self.manifest.column_path(self.directory, attr),
                    dtype=dtype,
                    mode="r",
                    shape=(n,),
                )
                if n
                else np.empty(0, dtype)
            )
        return col

    def iter_chunks(
        self,
        columns: tuple[str, ...] | None = None,
        chunk_rows: int | None = None,
    ) -> Iterator[dict[str, np.ndarray]]:
        attrs = tuple(columns) if columns is not None else self.attrs
        cols = {a: self.open_column(a) for a in attrs}
        n = self.num_rows
        step = max(int(chunk_rows), 1) if chunk_rows else DEFAULT_CHUNK_ROWS
        for start in range(0, n, step) if n else ():
            stop = min(start + step, n)
            yield {a: cols[a][start:stop] for a in attrs}

    # -- metadata -------------------------------------------------------
    def sorted_by(self, attr: str) -> bool:
        """True if the manifest certifies ``attr`` ascending on disk."""
        meta = self.manifest.columns.get(attr)
        return bool(meta is not None and meta.sorted)

    # -- mutation -------------------------------------------------------
    def append(self, columns: Mapping[str, np.ndarray]) -> int:
        """Append a row batch (serving-layer delta ingestion); returns
        the new row count.  Appended columns lose their ``sorted`` flag —
        ordering of appended rows is not re-verified."""
        cols = {a: np.asarray(c) for a, c in columns.items()}
        if set(cols) != set(self.attrs):
            raise ValueError(
                f"append to {self.name!r} must cover attrs "
                f"{sorted(self.attrs)}, got {sorted(cols)}"
            )
        lengths = {len(c) for c in cols.values()}
        if len(lengths) > 1:
            raise ValueError(f"append to {self.name!r}: ragged columns {lengths}")
        n_new = lengths.pop() if lengths else 0
        if n_new == 0:
            return self.num_rows
        for attr, arr in cols.items():
            meta = self.manifest.columns[attr]
            arr = np.ascontiguousarray(arr.astype(np.dtype(meta.dtype)))
            with open(self.manifest.column_path(self.directory, attr), "ab") as fh:
                arr.tofile(fh)
            meta.sorted = False
        self.manifest.num_rows += n_new
        write_manifest(self.directory, self.manifest)
        self._memmaps.clear()  # stale lengths: remap on next access
        return self.num_rows

    def __repr__(self) -> str:
        return (
            f"StoredRelation({self.name!r}, {self.num_rows} rows, "
            f"attrs={list(self.attrs)}, dir={str(self.directory)!r})"
        )


def write_relation(
    source,
    directory: str | Path,
    chunk_rows: int | None = None,
) -> StoredRelation:
    """Stream ``source`` into ``directory`` as a stored relation.

    Columns are written chunk-at-a-time (dtype fixed by the first chunk;
    later chunks cast), tracking per-column ascending order so the
    manifest can certify pre-sorted keys."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    attrs = tuple(source.attrs)
    step = max(int(chunk_rows), 1) if chunk_rows else DEFAULT_CHUNK_ROWS
    files: dict[str, object] = {}
    dtypes: dict[str, np.dtype] = {}
    is_sorted = {a: True for a in attrs}
    last: dict[str, object] = {}
    rows = 0
    try:
        for chunk in source.iter_chunks(attrs, step):
            n = len(next(iter(chunk.values()))) if attrs else 0
            for a in attrs:
                arr = np.ascontiguousarray(chunk[a])
                if a not in files:
                    files[a] = open(directory / f"{a}.bin", "wb")
                    dtypes[a] = arr.dtype
                elif arr.dtype != dtypes[a]:
                    arr = arr.astype(dtypes[a])
                if len(arr):
                    if is_sorted[a]:
                        inner = not np.any(arr[1:] < arr[:-1])
                        edge = a not in last or last[a] <= arr[0]
                        is_sorted[a] = bool(inner and edge)
                    last[a] = arr[-1]
                fh = files[a]
                arr.tofile(fh)
            rows += n
    finally:
        for fh in files.values():
            fh.close()
    manifest = Manifest(
        name=source.name,
        num_rows=rows,
        columns={
            a: ColumnMeta(
                dtype=dtypes.get(a, np.dtype(np.int64)).str,
                sorted=bool(rows and is_sorted[a]),
            )
            for a in attrs
        },
    )
    # zero-row sources never opened files; still create empty columns
    for a in attrs:
        p = directory / f"{a}.bin"
        if not p.exists():
            p.touch()
    write_manifest(directory, manifest)
    return StoredRelation(directory, manifest)


def open_relation(directory: str | Path) -> StoredRelation:
    """Open a stored relation previously written by :func:`write_relation`."""
    directory = Path(directory)
    manifest = read_manifest(directory)
    for attr in manifest.attrs:
        path = manifest.column_path(directory, attr)
        if not path.is_file():
            raise FileNotFoundError(
                f"relation {manifest.name!r}: missing column file {path}"
            )
        expect = manifest.num_rows * np.dtype(manifest.columns[attr].dtype).itemsize
        if path.stat().st_size != expect:
            raise ValueError(
                f"relation {manifest.name!r}: column {attr!r} is "
                f"{path.stat().st_size} bytes, manifest says {expect}"
            )
    return StoredRelation(directory, manifest)
