"""Stored databases through the port, against the JAX package on the same
directory (the counterpart of ``tests/test_storage_roundtrip.py``,
DESIGN.md §12): a database written to disk and mounted back answers on
``TorchChannelEngine(device="cpu")`` bit for bit as ``engine("jax")``
answers on the same mounted directory, and as the port answers on the
in-memory twin — named-aggregate bundles on every physical path,
predicates and aliases, cyclic GHD queries, group-attribute column
copies and chunks far below every relation's size.  Maintained handles
over a stored database are held against ``engine("tensor")``, whose
``maintain`` the reference runs without its Pallas kernels.  Measures
are integer-valued, so every float32 partial is exact."""
import numpy as np
import pytest

from repro.api import Avg as JAvg
from repro.api import Count as JCount
from repro.api import Max as JMax
from repro.api import Min as JMin
from repro.api import Q as JQ
from repro.api import Sum as JSum
from repro.storage import open_database as j_open_database
from repro_torch.api import Avg, Count, MaintainedPlan, Max, Min, Q, Sum, TorchChannelEngine
from repro_torch.core import torch_engine
from repro_torch.relational.relation import Database
from repro_torch.storage import open_database, write_database
from test_torch_planner import assert_identical

CPU = TorchChannelEngine(device="cpu")
PATHS = {
    "auto": CPU,
    "sparse": TorchChannelEngine(device="cpu", mode="sparse"),
    "dense": TorchChannelEngine(device="cpu", mode="dense"),
}


def chain_cols(n=400, seed=21, gdom=6, jdom=25):
    rng = np.random.default_rng(seed)
    return {
        "R1": {"g1": rng.integers(0, gdom, n), "p0": rng.integers(0, jdom, n)},
        "R2": {
            "p0": rng.integers(0, jdom, n),
            "p1": rng.integers(0, jdom, n),
            "m": rng.integers(0, 50, n).astype(np.float64),
        },
        "R3": {"p1": rng.integers(0, jdom, n), "g2": rng.integers(0, gdom, n)},
    }


def triangle_cols(n=220, nodes=18, labels=4, seed=8):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, nodes, n), rng.integers(0, nodes, n)
    return {
        "E1": {"a": src, "b": dst},
        "E2": {"b": src, "c": dst},
        "E3": {"c": src, "a": dst},
        "L": {"a": np.arange(nodes), "vlabel": rng.integers(0, labels, nodes)},
    }


def roundtrip(cols, path):
    """The in-memory database and the path of its stored copy."""
    db = Database.from_mapping(cols)
    write_database(db, path)
    return db, str(path)


def bundle(Q_, table):
    return (
        Q_.over("R1", "R2", "R3")
        .group_by("R1.g1", "R3.g2")
        .agg(n=table["count"](), s=table["sum"]("R2.m"), lo=table["min"]("R2.m"),
             hi=table["max"]("R2.m"), mean=table["avg"]("R2.m"))
    )


PORT = {"count": Count, "sum": Sum, "avg": Avg, "min": Min, "max": Max}
REF = {"count": JCount, "sum": JSum, "avg": JAvg, "min": JMin, "max": JMax}


def spy_ranges(monkeypatch) -> list[int]:
    """Record the rows of every host range that
    :func:`torch_engine.to_device_rows` moves to the device."""
    seen: list[int] = []
    real = torch_engine.to_device_rows

    def spy(shape, dtype, device, chunk, rows_of):
        def rows(lo, hi):
            seen.append(hi - lo)
            return rows_of(lo, hi)

        return real(shape, dtype, device, chunk, rows)

    monkeypatch.setattr(torch_engine, "to_device_rows", spy)
    return seen


def check_three(q, jq, mem, path):
    """Port on the mounted directory = ``engine("jax")`` on it = the
    port on the in-memory twin; returns the port's mounted plan."""
    plan = q.plan(path)
    got = plan.execute()
    assert plan.chunk_rows is not None and plan.prep is not None
    assert_identical(jq.engine("jax").plan(path).execute(), got)
    assert_identical(q.plan(mem).execute(), got)
    assert got.num_rows > 0
    return plan


@pytest.mark.parametrize("path", ["auto", "sparse", "dense", "fused"])
def test_chain_bundle_bit_identical(path, tmp_path, monkeypatch):
    mem, disk = roundtrip(chain_cols(), tmp_path / "db")
    seen = spy_ranges(monkeypatch)
    q = bundle(Q, PORT).engine(PATHS.get(path, CPU))
    if path == "fused":
        q = q.fused(True)
    plan = check_three(q, bundle(JQ, REF), mem, disk)
    assert plan.verify(strict=False) == []
    # every view, weight and dense tensor moved to the device in ranges
    assert seen and max(seen) <= plan.chunk_rows


def test_predicates_and_aliases_bit_identical(tmp_path):
    mem, disk = roundtrip(chain_cols(seed=4), tmp_path / "db")

    def build(Q_, table):
        return (
            Q_.over("R1", ("X", "R2"), "R3")
            .rename("X", m="mx")
            .where("X", "mx", ">", 10)
            .where("R1", "p0", "<=", 20)
            .group_by("R1.g1")
            .agg(n=table["count"](), s=table["sum"]("X.mx"), hi=table["max"]("X.mx"))
        )

    plan = check_three(build(Q, PORT).engine(CPU), build(JQ, REF), mem, disk)
    kinds = plan.explain().split("storage:")[1]
    # X is a filter over a rename over the stored R2
    assert "X: derived(derived(mmap))" in kinds and "R1: derived(mmap)" in kinds


def test_cyclic_ghd_bit_identical(tmp_path):
    mem, disk = roundtrip(triangle_cols(), tmp_path / "db")

    def build(Q_, table):
        return Q_.over("E1", "E2", "E3", "L").group_by("L.vlabel").agg(n=table["count"]())

    plan = check_three(build(Q, PORT).engine(CPU), build(JQ, REF), mem, disk)
    assert plan.cyclic


def test_group_attr_in_join_column_copy_roundtrip(tmp_path):
    """The planner's automatic group-attr column copy goes through the
    lazy ColumnCopySource on disk-backed relations."""
    mem, disk = roundtrip(chain_cols(seed=13), tmp_path / "db")

    def build(Q_, table):
        return Q_.over("R1", "R2", "R3").group_by("R2.p0").agg(
            n=table["count"](), s=table["sum"]("R2.m"))

    plan = check_three(build(Q, PORT).engine(CPU), build(JQ, REF), mem, disk)
    assert any(note.startswith("copy group attr R2.p0") for note in plan.rewrite_notes)


@pytest.mark.parametrize("path", ["sparse", "dense"])
def test_tiny_chunks_force_kway_merge(path, tmp_path, monkeypatch):
    """``chunk_rows`` far below every relation's rows: each encode and
    view spills many runs through the blocked k-way merge, and each view
    moves to the device in ranges of 7 rows."""
    cols = chain_cols(n=300, seed=55)
    mem, disk = roundtrip(cols, tmp_path / "db")
    monkeypatch.setenv("REPRO_CHUNK_ROWS", "7")
    seen = spy_ranges(monkeypatch)
    plan = bundle(Q, PORT).engine(PATHS[path]).plan(disk)
    got = plan.execute()
    want = bundle(JQ, REF).engine("jax").plan(disk).execute()
    assert plan.chunk_rows == 7
    assert all(er._chunk_rows == 7 for er in plan.prep.encoded.values())
    # one range of at most 7 rows at a time, every row moved
    assert seen and max(seen) == 7
    monkeypatch.delenv("REPRO_CHUNK_ROWS")
    assert_identical(want, got)
    assert_identical(bundle(Q, PORT).engine(PATHS[path]).plan(mem).execute(), got)


MAINTAIN_AGGS = {
    "sum": {"s": ("sum", "R2.m")},
    "bundle": {"n": ("count", None), "s": ("sum", "R2.m"), "lo": ("min", "R2.m")},
}


@pytest.mark.parametrize("aggs", sorted(MAINTAIN_AGGS))
def test_maintain_deltas_over_a_stored_db(aggs, tmp_path):
    """A handle over the mounted directory tracks the reference's
    ``engine("tensor")`` handle over the same directory, and the port's
    handle over the in-memory twin, through three inserts and a delete
    of stored rows."""
    cols = chain_cols(n=250, seed=31)
    mem, disk = roundtrip(cols, tmp_path / "db")

    def named(table):
        return {n: table[k](*(m.split(".") if m else ())) for n, (k, m) in MAINTAIN_AGGS[aggs].items()}

    q = Q.over("R1", "R2", "R3").group_by("R1.g1", "R3.g2").agg(**named(PORT)).engine(CPU)
    jq = JQ.over("R1", "R2", "R3").group_by("R1.g1", "R3.g2").agg(**named(REF)).engine("tensor")
    hd, hm = q.maintain(open_database(disk)), q.maintain(mem)
    href = jq.maintain(j_open_database(disk))

    def check():
        got, want, twin = hd.result(), href.result(), hm.result()
        if isinstance(hd, MaintainedPlan):
            assert_identical(want, got)
            assert_identical(twin, got)
        else:
            assert got == want == twin

    check()
    # the stored handles encoded their relations as memmaps
    stored = hd.handles.values() if isinstance(hd, MaintainedPlan) else [hd]
    assert all(isinstance(h.base["R2"].er.codes, np.memmap) for h in stored)
    rng = np.random.default_rng(5)
    for _ in range(3):
        delta = {
            "p0": rng.integers(0, 25, 30),
            "p1": rng.integers(0, 25, 30),
            "m": rng.integers(0, 50, 30).astype(np.float64),
        }
        for h in (hd, hm, href):
            h.insert("R2", delta)
        check()
    dele = {a: c[:40] for a, c in cols["R2"].items()}
    for h in (hd, hm, href):
        h.delete("R2", dele)
    check()
