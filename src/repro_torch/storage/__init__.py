"""Out-of-core storage tier (DESIGN.md §12): memory-mapped columnar
relation files behind the ``RelationSource`` protocol, an external
chunked key-sort for streaming grouped-CSR builds, and the
``write_database``/``open_database`` directory round-trip.

Copy of the JAX package's ``storage/``, host numpy and memmaps.  The
on-disk format (``db.json``, one ``manifest.json`` and one raw
little-endian ``<attr>.bin`` per column) is the same byte for byte, so a
directory written by either package mounts in the other."""
from repro_torch.storage.database import open_database, write_database
from repro_torch.storage.manifest import Manifest, read_manifest, write_manifest
from repro_torch.storage.sort import merge_runs, sort_chunks_to_runs, write_run
from repro_torch.storage.store import StoredRelation, open_relation, write_relation

__all__ = [
    "Manifest",
    "StoredRelation",
    "merge_runs",
    "open_database",
    "open_relation",
    "read_manifest",
    "sort_chunks_to_runs",
    "write_database",
    "write_manifest",
    "write_relation",
    "write_run",
]
