"""On-disk relation manifests (DESIGN.md §12).

A stored relation is a directory::

    <dir>/manifest.json      this file
    <dir>/<attr>.bin         one raw little-endian array per column

The manifest records everything needed to ``np.memmap`` the columns
back: per-column dtype (numpy ``dtype.str``), the shared row count, and
an optional per-column ``sorted`` flag (ascending order verified at
write time — the external sort can skip run generation for such
columns).  Appends update ``num_rows`` and clear the sort flags of the
columns they extend.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

MANIFEST_NAME = "manifest.json"
MANIFEST_VERSION = 1


@dataclass
class ColumnMeta:
    dtype: str  # numpy dtype.str, e.g. "<i8"
    sorted: bool = False  # ascending order verified at write time


@dataclass
class Manifest:
    name: str
    num_rows: int
    columns: dict[str, ColumnMeta] = field(default_factory=dict)
    version: int = MANIFEST_VERSION

    @property
    def attrs(self) -> tuple[str, ...]:
        return tuple(self.columns)

    def column_path(self, base: Path, attr: str) -> Path:
        if attr not in self.columns:
            raise KeyError(f"relation {self.name!r} has no attr {attr!r}")
        return Path(base) / f"{attr}.bin"

    def to_json(self) -> dict:
        return {
            "version": self.version,
            "name": self.name,
            "num_rows": self.num_rows,
            "columns": {
                a: {"dtype": m.dtype, "sorted": m.sorted}
                for a, m in self.columns.items()
            },
        }

    @staticmethod
    def from_json(doc: dict) -> "Manifest":
        version = int(doc.get("version", 0))
        if version != MANIFEST_VERSION:
            raise ValueError(
                f"unsupported manifest version {version} "
                f"(this build reads version {MANIFEST_VERSION})"
            )
        return Manifest(
            name=doc["name"],
            num_rows=int(doc["num_rows"]),
            columns={
                a: ColumnMeta(dtype=m["dtype"], sorted=bool(m.get("sorted")))
                for a, m in doc["columns"].items()
            },
            version=version,
        )


def write_manifest(directory: str | Path, manifest: Manifest) -> Path:
    path = Path(directory) / MANIFEST_NAME
    tmp = path.with_suffix(".json.tmp")
    tmp.write_text(json.dumps(manifest.to_json(), indent=2) + "\n")
    tmp.replace(path)  # atomic swap: readers never see a torn manifest
    return path


def read_manifest(directory: str | Path) -> Manifest:
    path = Path(directory) / MANIFEST_NAME
    if not path.is_file():
        raise FileNotFoundError(f"no relation manifest at {path}")
    return Manifest.from_json(json.loads(path.read_text()))
