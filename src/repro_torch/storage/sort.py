"""External chunked key-sort: sorted run files + blocked k-way merge
(DESIGN.md §12).

The grouped-CSR build and the streaming pre-aggregation both need "sort
n rows by an int64 key without holding n rows in RAM".  Both reduce to:

1. **runs** — consume the input in consecutive row-range chunks; each
   chunk is stable-sorted by key in RAM and written to one *run* (a set
   of raw column files in a scratch directory), so run ``i`` covers a
   contiguous global row range and, within a run, equal keys keep their
   original order;
2. **merge** — a blocked k-way merge over the runs.  Each iteration
   looks at a bounded window per run, computes the emit threshold ``M``
   (the minimum over *unexhausted* runs of their window's max key), and
   emits every windowed entry with ``key < M``: any key a run has not
   yet surfaced is ≥ its window max ≥ ``M``, so emitted batches are
   globally final.  Emission concatenates the per-run prefixes in run
   order and stable-sorts by key — runs cover increasing global row
   ranges, so ties come out in global row order and the merged stream
   reproduces ``np.argsort(keys, kind="stable")`` exactly.

Because nothing with ``key >= M`` is ever emitted early, one key can
never straddle two emitted batches (except in the final drain, which
emits everything at once) — which is what lets the streaming
pre-aggregation merge equal-key rows as batches arrive.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Mapping

import numpy as np

#: rows per merge window per run — bounds merge-time RAM at
#: ``O(runs × DEFAULT_BLOCK_ROWS)`` rows
DEFAULT_BLOCK_ROWS = 1 << 16

KEY = "key"


@dataclass
class Run:
    """One sorted run: per-field raw files covering a global row range."""

    directory: Path
    index: int
    length: int
    dtypes: dict[str, np.dtype]

    def open(self) -> dict[str, np.ndarray]:
        if self.length == 0:
            return {f: np.empty(0, dt) for f, dt in self.dtypes.items()}
        return {
            f: np.memmap(
                self.directory / f"run{self.index}.{f}.bin",
                dtype=dt,
                mode="r",
                shape=(self.length,),
            )
            for f, dt in self.dtypes.items()
        }


def write_run(
    directory: str | Path, index: int, fields: Mapping[str, np.ndarray]
) -> Run:
    """Persist one already-key-sorted chunk as run ``index``.

    ``fields`` must contain ``"key"`` (int64, ascending, ties in
    original order); every other field rides along row-aligned."""
    directory = Path(directory)
    keys = np.asarray(fields[KEY])
    if len(keys) > 1 and np.any(keys[1:] < keys[:-1]):
        raise ValueError(f"run {index}: keys are not sorted")
    dtypes: dict[str, np.dtype] = {}
    for f, arr in fields.items():
        arr = np.ascontiguousarray(arr)
        if len(arr) != len(keys):
            raise ValueError(
                f"run {index}: field {f!r} has {len(arr)} rows, "
                f"key has {len(keys)}"
            )
        arr.tofile(directory / f"run{index}.{f}.bin")
        dtypes[f] = arr.dtype
    return Run(directory, index, len(keys), dtypes)


def merge_runs(
    runs: list[Run], block_rows: int = DEFAULT_BLOCK_ROWS
) -> Iterator[dict[str, np.ndarray]]:
    """Yield the runs' rows in globally key-sorted stable order, as
    batches within which no key is split from its duplicates elsewhere
    (see the module docstring for the threshold argument)."""
    runs = [r for r in runs if r.length]
    if not runs:
        return
    views = [r.open() for r in runs]
    lengths = [r.length for r in runs]
    pos = [0] * len(runs)
    window = [max(int(block_rows), 1)] * len(runs)
    while True:
        active = [i for i in range(len(runs)) if pos[i] < lengths[i]]
        if not active:
            return
        ends = {i: min(pos[i] + window[i], lengths[i]) for i in active}
        blocking = [i for i in active if ends[i] < lengths[i]]
        if blocking:
            m = min(int(views[i][KEY][ends[i] - 1]) for i in blocking)
            cut = {
                i: int(
                    np.searchsorted(views[i][KEY][pos[i]: ends[i]], m, "left")
                )
                for i in active
            }
            if all(c == 0 for c in cut.values()):
                # every windowed key is >= m: widen the windows that pin
                # the threshold until one of them exhausts or admits rows
                for i in blocking:
                    if int(views[i][KEY][ends[i] - 1]) == m:
                        window[i] *= 2
                continue
        else:
            cut = {i: ends[i] - pos[i] for i in active}
        take = [i for i in active if cut[i]]
        parts = {
            f: np.concatenate(
                [np.asarray(views[i][f][pos[i]: pos[i] + cut[i]]) for i in take]
            )
            for f in runs[0].dtypes
        }
        # stable sort by key: equal keys keep run order = global row order
        order = np.argsort(parts[KEY], kind="stable")
        yield {f: arr[order] for f, arr in parts.items()}
        for i in take:
            pos[i] += cut[i]
            window[i] = max(int(block_rows), 1)


def sort_chunks_to_runs(
    directory: str | Path,
    chunks: Iterator[Mapping[str, np.ndarray]],
) -> list[Run]:
    """Stable-sort each chunk by its ``"key"`` field and persist it as a
    run.  Chunks must arrive in global row order; fields other than the
    key are carried through the per-chunk permutation."""
    runs: list[Run] = []
    for i, fields in enumerate(chunks):
        keys = np.asarray(fields[KEY])
        order = np.argsort(keys, kind="stable")
        runs.append(
            write_run(
                directory,
                i,
                {f: np.asarray(arr)[order] for f, arr in fields.items()},
            )
        )
    return runs


class SpillWriter:
    """Append-only raw column files, memmapped once finished — how merge
    output lands on disk without a second in-RAM copy."""

    def __init__(self, directory: str | Path, prefix: str):
        self.directory = Path(directory)
        self.prefix = prefix
        self._files: dict[str, object] = {}
        self._dtypes: dict[str, np.dtype] = {}
        self.rows = 0

    def path(self, field: str) -> Path:
        return self.directory / f"{self.prefix}.{field}.bin"

    def append(self, fields: Mapping[str, np.ndarray]) -> None:
        n = None
        for f, arr in fields.items():
            arr = np.ascontiguousarray(arr)
            n = len(arr) if n is None else n
            if len(arr) != n:
                raise ValueError(f"spill {self.prefix}: ragged batch at {f!r}")
            fh = self._files.get(f)
            if fh is None:
                fh = self._files[f] = open(self.path(f), "wb")
                self._dtypes[f] = arr.dtype
            elif arr.dtype != self._dtypes[f]:
                arr = arr.astype(self._dtypes[f])
            arr.tofile(fh)
        self.rows += n or 0

    def finish(self, mode: str = "r+") -> dict[str, np.ndarray]:
        """Close the files and memmap each column back."""
        for fh in self._files.values():
            fh.close()
        out = {}
        for f, dt in self._dtypes.items():
            out[f] = (
                np.memmap(self.path(f), dtype=dt, mode=mode, shape=(self.rows,))
                if self.rows
                else np.empty(0, dt)
            )
        self._files.clear()
        return out
