"""Out-of-core storage smoke gate (DESIGN.md §12).

    PYTHONPATH=src python -m repro_torch.launch.storage --smoke --rows 40000
    PYTHONPATH=src python -m repro_torch.launch.storage --smoke --rows 2000 --device cpu

Generates the medium measured-chain catalog, writes it to an on-disk
database, mounts it back with :func:`repro_torch.storage.open_database`,
and exits non-zero unless, on the ``"torch"`` and ``"ref"`` engines
(``TorchChannelEngine(device=--device)``, then
``RefChannelEngine(device=--device)``, CUDA by default),

* ``prepare`` + ``execute`` through the mounted (memmap-backed) database
  is bit-identical to the in-memory run,
* the same holds with ``chunk_rows`` forced far below every relation's
  row count, so every encode goes through multi-run external sorts and
  the k-way aggregating merge, and
* a ``maintain()`` handle built from the stored database tracks the
  in-memory one through insert deltas.

``--keep DIR`` writes the catalog to ``DIR`` instead of a temp dir and
leaves it behind for inspection.  Without a card and without
``--device cpu`` it exits non-zero; it never runs on the CPU instead.

Port of the JAX package's ``launch/storage.py``.
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile

import numpy as np

from repro_torch.aggregates.semiring import Avg, Count, Max, Min, Sum
from repro_torch.api.builder import Q
from repro_torch.api.engines import RefChannelEngine, TorchChannelEngine
from repro_torch.core.torch_engine import require_device
from repro_torch.relational.relation import Database
from repro_torch.storage import open_database, write_database

PROG = "python -m repro_torch.launch.storage"


def medium_chain(rows: int, seed: int = 7) -> Database:
    """The fold-free measured chain at ``rows`` rows/relation."""
    rng = np.random.default_rng(seed)
    jdom, gdom = max(4, rows // 50), 32
    return Database.from_mapping(
        {
            "R1": {
                "g1": rng.integers(0, gdom, rows),
                "p0": rng.integers(0, jdom, rows),
            },
            "R2": {
                "p0": rng.integers(0, jdom, rows),
                "p1": rng.integers(0, jdom, rows),
                "m": rng.integers(0, 100, rows).astype(np.float64),
            },
            "R3": {
                "p1": rng.integers(0, jdom, rows),
                "g2": rng.integers(0, gdom, rows),
            },
        }
    )


def _query():
    return (
        Q.over("R1", "R2", "R3")
        .group_by("R1.g1", "R3.g2")
        .agg(n=Count(), s=Sum("R2.m"), lo=Min("R2.m"), hi=Max("R2.m"),
             mean=Avg("R2.m"))
    )


def _same(a, b) -> bool:
    if a.group_names != b.group_names or a.agg_names != b.agg_names:
        return False
    if a.num_rows != b.num_rows:
        return False
    return all(
        np.array_equal(a.column(c), b.column(c))
        for c in a.group_names + a.agg_names
    )


def smoke(rows: int, keep: str | None, device: str = "cuda") -> int:
    db = medium_chain(rows)
    path = keep or tempfile.mkdtemp(prefix="repro-storage-smoke-")
    engine = TorchChannelEngine(device=device)
    failures: list[str] = []
    try:
        write_database(db, path + "/db")
        disk = open_database(path + "/db")
        for eng in (engine, RefChannelEngine(device=device)):
            eq = _query().engine(eng)
            want = eq.execute(db)
            if not _same(want, eq.execute(disk)):
                failures.append(f"{eng.name}: mounted run diverged")
            # chunk far below every relation: multi-run external sorts +
            # k-way aggregating merges on every prepare (the ref engine
            # rejects memory_budget, so force via the env knob)
            before = os.environ.get("REPRO_CHUNK_ROWS")
            os.environ["REPRO_CHUNK_ROWS"] = str(max(64, rows // 64))
            try:
                forced = eq.execute(open_database(path + "/db"))
            finally:
                if before is None:
                    del os.environ["REPRO_CHUNK_ROWS"]
                else:
                    os.environ["REPRO_CHUNK_ROWS"] = before
            if not _same(want, forced):
                failures.append(f"{eng.name}: forced-chunk run diverged")
            print(f"storage-smoke: {eng.name} ok ({want.num_rows} groups)")
        mq = Q.over("R1", "R2", "R3").group_by("R1.g1").agg(s=Sum("R2.m")).engine(engine)
        hm, hd = mq.maintain(db), mq.maintain(open_database(path + "/db"))
        rng = np.random.default_rng(1)
        jdom = max(4, rows // 50)
        for step in range(3):
            delta = {
                "p0": rng.integers(0, jdom, 100),
                "p1": rng.integers(0, jdom, 100),
                "m": rng.integers(0, 100, 100).astype(np.float64),
            }
            hm.insert("R2", delta)
            hd.insert("R2", delta)
            if hm.result() != hd.result():
                failures.append(f"maintain: diverged at insert {step}")
        print("storage-smoke: maintain() deltas ok")
    finally:
        if keep is None:
            shutil.rmtree(path, ignore_errors=True)
    for f in failures:
        print(f"storage-smoke FAILED: {f}", file=sys.stderr)
    return 1 if failures else 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog=PROG, description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true", required=True)
    ap.add_argument("--rows", type=int, default=40000)
    ap.add_argument("--keep", default=None, metavar="DIR")
    ap.add_argument("--device", default="cuda",
                    help="device the engine runs on (cuda, or cpu)")
    args = ap.parse_args(argv)
    try:
        device = require_device(args.device, PROG, "--device cpu")
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 2
    return smoke(args.rows, args.keep, device)


if __name__ == "__main__":
    sys.exit(main())
