"""Directory-of-manifests database round-trip (DESIGN.md §12).

``write_database(db, path)`` streams every relation source of a
:class:`~repro_torch.relational.relation.Database` into ``path/<name>/`` via
:func:`~repro_torch.storage.store.write_relation` and records the catalog in
``path/db.json``; ``open_database(path)`` mounts it back as a
``Database`` of :class:`~repro_torch.storage.store.StoredRelation` sources —
the out-of-core twin of ``Database.from_mapping``, bit-identical under
every engine (the tier-1 round-trip differential suite asserts it).
"""
from __future__ import annotations

import json
from pathlib import Path

from repro_torch.relational.relation import Database
from repro_torch.storage.store import open_relation, write_relation

CATALOG_NAME = "db.json"
CATALOG_VERSION = 1


def write_database(
    db: Database, path: str | Path, chunk_rows: int | None = None
) -> Path:
    """Write every relation of ``db`` under ``path``; returns ``path``."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    names = sorted(db.relations)
    for name in names:
        write_relation(db.relations[name], path / name, chunk_rows=chunk_rows)
    doc = {"version": CATALOG_VERSION, "relations": names}
    tmp = path / (CATALOG_NAME + ".tmp")
    tmp.write_text(json.dumps(doc, indent=2) + "\n")
    tmp.replace(path / CATALOG_NAME)
    return path


def open_database(path: str | Path) -> Database:
    """Mount a stored database as disk-backed relation sources."""
    path = Path(path)
    catalog = path / CATALOG_NAME
    if not catalog.is_file():
        raise FileNotFoundError(f"no database catalog at {catalog}")
    doc = json.loads(catalog.read_text())
    version = int(doc.get("version", 0))
    if version != CATALOG_VERSION:
        raise ValueError(
            f"unsupported database catalog version {version} "
            f"(this build reads version {CATALOG_VERSION})"
        )
    db = Database()
    for name in doc["relations"]:
        db.add(open_relation(path / name))
    return db
