"""The port's out-of-core storage tier against the JAX package's
(``repro_torch.storage`` vs ``repro.storage``, DESIGN.md §12): manifest,
relation and database round trips, the external chunked key-sort, the
streaming encode and dictionaries, grouped-CSR views built out of core,
the ``RelationSource`` adapters and lazy rewrites, the chunking policy,
chunked statistics, explain's ``storage:`` section and the V-STORE-CSR
verifier invariant.  Each case runs the port's function and the
reference's on the same seeded inputs and holds them equal exactly; the
format test holds the two packages' directories equal byte for byte."""
import tempfile
from pathlib import Path

import numpy as np
import pytest

from repro.analysis.verify import verify_plan as j_verify_plan
from repro.api import Count as JCount
from repro.api import Q as JQ
from repro.api import Sum as JSum
from repro.core import prepare as jprepare
from repro.core.query import JoinAggQuery as JJoinAggQuery
from repro.relational import encoding as jencoding
from repro.relational import source as jsource
from repro.relational.relation import Database as JDatabase
from repro.relational.relation import Relation as JRelation
from repro.stats.collect import _relation_stats as j_relation_stats
from repro import storage as jstorage
from repro.storage import sort as jsort
from repro_torch import storage
from repro_torch.analysis.verify import verify_plan
from repro_torch.api import Count, Q, Sum, TorchChannelEngine
from repro_torch.core import prepare as pprepare
from repro_torch.core.query import JoinAggQuery
from repro_torch.relational import encoding
from repro_torch.relational import source
from repro_torch.relational.relation import Database, Relation
from repro_torch.stats.collect import _relation_stats
from repro_torch.storage import sort as psort
from repro_torch.storage.store import StoredRelation

CPU = TorchChannelEngine(device="cpu")


def rel_cols(n=500, seed=3):
    rng = np.random.default_rng(seed)
    return {
        "a": rng.integers(0, 40, n),
        "b": rng.integers(0, 9, n).astype(np.int32),
        "m": rng.integers(0, 50, n).astype(np.float64),
    }


def chain_cols(n=600, seed=5, fractional=False):
    rng = np.random.default_rng(seed)
    m = rng.random(n) * 40 if fractional else rng.integers(0, 40, n).astype(np.float64)
    return {
        "R1": {"g1": rng.integers(0, 6, n), "p0": rng.integers(0, 30, n)},
        "R2": {"p0": rng.integers(0, 30, n), "p1": rng.integers(0, 30, n), "m": m},
        "R3": {"p1": rng.integers(0, 30, n), "g2": rng.integers(0, 6, n)},
    }


def both_dbs(cols):
    return Database.from_mapping(cols), JDatabase.from_mapping(cols)


# ----------------------------------------------------------------------
# store: write/open/append round trips
# ----------------------------------------------------------------------


def test_relation_roundtrip_preserves_data_and_dtypes(tmp_path):
    cols = rel_cols()
    stored = storage.write_relation(Relation("R", cols), tmp_path / "R")
    opened = storage.open_relation(tmp_path / "R")
    assert isinstance(opened, StoredRelation)
    assert opened.name == "R" and opened.attrs == ("a", "b", "m")
    assert opened.num_rows == 500
    for a, c in cols.items():
        col = opened.open_column(a)
        assert isinstance(col, np.memmap) and not col.flags.writeable
        assert col.dtype == c.dtype and np.array_equal(col, c)
    assert stored.storage_kind == "mmap" and source.is_disk_backed(opened)
    ref = jstorage.open_relation(tmp_path / "R")
    assert ref.manifest.to_json() == opened.manifest.to_json()


def test_manifest_certifies_sorted_columns(tmp_path):
    cols = {"k": np.arange(100), "v": np.random.default_rng(11).integers(0, 5, 100)}
    storage.write_relation(Relation("S", cols), tmp_path / "S", chunk_rows=7)
    jstorage.write_relation(JRelation("S", cols), tmp_path / "J", chunk_rows=7)
    got, want = storage.open_relation(tmp_path / "S"), jstorage.open_relation(tmp_path / "J")
    for a in cols:
        assert got.sorted_by(a) == want.sorted_by(a)
    assert got.sorted_by("k") and not got.sorted_by("v")


def test_zero_row_relation_roundtrip(tmp_path):
    rel = Relation("Z", {"a": np.zeros(0, np.int64), "b": np.zeros(0)})
    storage.write_relation(rel, tmp_path / "Z")
    opened = storage.open_relation(tmp_path / "Z")
    assert opened.num_rows == 0 and opened.attrs == ("a", "b")
    assert len(opened.open_column("a")) == 0
    assert list(opened.iter_chunks()) == []
    assert jstorage.open_relation(tmp_path / "Z").num_rows == 0


def test_open_relation_detects_truncated_column(tmp_path):
    storage.write_relation(Relation("R", rel_cols(50)), tmp_path / "R")
    (tmp_path / "R" / "a.bin").write_bytes(b"\0" * 8)
    with pytest.raises(ValueError, match="8 bytes"):
        storage.open_relation(tmp_path / "R")
    with pytest.raises(ValueError, match="8 bytes"):
        jstorage.open_relation(tmp_path / "R")


def test_append_extends_store_and_clears_sort_flags(tmp_path):
    rel = Relation("S", {"k": np.arange(20), "v": np.arange(20.0)})
    stored = storage.write_relation(rel, tmp_path / "S")
    assert stored.sorted_by("k")
    stored.append({"k": np.array([5, 1]), "v": np.array([9.0, 9.0])})
    assert stored.num_rows == 22 and not stored.sorted_by("k")
    assert np.array_equal(stored.open_column("k")[-2:], [5, 1])
    # the manifest on disk agrees: a fresh mount of either package sees them
    assert storage.open_relation(tmp_path / "S").num_rows == 22
    assert jstorage.open_relation(tmp_path / "S").num_rows == 22
    with pytest.raises(ValueError, match="must cover attrs"):
        stored.append({"k": np.array([1])})
    with pytest.raises(ValueError, match="ragged"):
        stored.append({"k": np.array([1]), "v": np.zeros(2)})


def test_database_roundtrip(tmp_path):
    cols = chain_cols()
    storage.write_database(Database.from_mapping(cols), tmp_path / "db")
    db = storage.open_database(tmp_path / "db")
    assert sorted(db.relations) == sorted(cols)
    for r, rc in cols.items():
        for a, c in rc.items():
            assert np.array_equal(db[r].open_column(a), c)


def _tree_bytes(root: Path) -> dict[str, bytes]:
    return {
        str(p.relative_to(root)): p.read_bytes()
        for p in sorted(root.rglob("*")) if p.is_file()
    }


@pytest.mark.parametrize("chunk_rows", [None, 7])
def test_both_packages_write_the_same_bytes(tmp_path, chunk_rows):
    """One on-disk format: the same database written by either package
    gives byte-identical files, and each package mounts the other's."""
    cols = chain_cols(fractional=True)
    cols["E"] = {"x": np.zeros(0, np.int64), "y": np.zeros(0)}
    db, jdb = both_dbs(cols)
    storage.write_database(db, tmp_path / "port", chunk_rows=chunk_rows)
    jstorage.write_database(jdb, tmp_path / "ref", chunk_rows=chunk_rows)
    port, ref = _tree_bytes(tmp_path / "port"), _tree_bytes(tmp_path / "ref")
    assert sorted(port) == sorted(ref) and len(port) == 1 + 4 + 9
    for name in ref:
        assert port[name] == ref[name], name
    mounted = storage.open_database(tmp_path / "ref")
    jmounted = jstorage.open_database(tmp_path / "port")
    for r, rc in cols.items():
        assert mounted[r].num_rows == jmounted[r].num_rows == len(next(iter(rc.values())))
        for a, c in rc.items():
            assert np.array_equal(mounted[r].open_column(a), c)
            assert np.array_equal(jmounted[r].open_column(a), c)


def test_each_package_plans_the_others_directory(tmp_path):
    cols = chain_cols()
    db, jdb = both_dbs(cols)
    jstorage.write_database(jdb, tmp_path / "ref")
    storage.write_database(db, tmp_path / "port")
    q = Q.over("R1", "R2", "R3").group_by("R1.g1", "R3.g2").agg(n=Count(), s=Sum("R2.m"))
    jq = JQ.over("R1", "R2", "R3").group_by("R1.g1", "R3.g2").agg(n=JCount(), s=JSum("R2.m"))
    got = q.engine(CPU).plan(str(tmp_path / "ref")).execute()
    want = jq.engine("jax").plan(str(tmp_path / "port")).execute()
    for c in want.relation.columns:
        assert np.array_equal(got.column(c), want.column(c)), c


# ----------------------------------------------------------------------
# external chunked key-sort
# ----------------------------------------------------------------------


def _external_argsort(sort_mod, keys, chunk, block):
    """Chunked runs + blocked k-way merge; the merged batches as emitted."""
    n = len(keys)
    with tempfile.TemporaryDirectory() as td:

        def chunks():
            for s in range(0, n, chunk):
                e = min(s + chunk, n)
                yield {sort_mod.KEY: keys[s:e], "idx": np.arange(s, e, dtype=np.int64)}

        runs = sort_mod.sort_chunks_to_runs(Path(td), chunks())
        return [
            (np.asarray(b[sort_mod.KEY]).copy(), np.asarray(b["idx"]).copy())
            for b in sort_mod.merge_runs(runs, block_rows=block)
        ]


@pytest.mark.parametrize("chunk,block", [(64, 16), (17, 5), (1000, 8)])
def test_merge_matches_stable_argsort(chunk, block):
    keys = np.random.default_rng(11).integers(0, 37, 400).astype(np.int64)
    got = _external_argsort(psort, keys, chunk, block)
    want = _external_argsort(jsort, keys, chunk, block)
    assert len(got) == len(want)
    for (gk, gi), (wk, wi) in zip(got, want):  # the same batches
        assert np.array_equal(gk, wk) and np.array_equal(gi, wi)
    order = np.argsort(keys, kind="stable")
    assert np.array_equal(np.concatenate([i for _, i in got]), order)
    assert np.array_equal(np.concatenate([k for k, _ in got]), keys[order])


def test_merge_never_splits_a_key_across_batches():
    keys = np.repeat(np.arange(10, dtype=np.int64), 23)
    np.random.default_rng(11).shuffle(keys)
    last_key = -1
    for bk, _ in _external_argsort(psort, keys, 31, 4):
        assert bk[0] > last_key  # no key continues from the prior batch
        last_key = int(bk[-1])


def test_write_run_rejects_unsorted_keys(tmp_path):
    with pytest.raises(ValueError, match="sorted"):
        psort.write_run(tmp_path, 0, {psort.KEY: np.array([3, 1], np.int64)})


def test_run_reopens_as_memmap(tmp_path):
    run = psort.write_run(tmp_path, 0, {psort.KEY: np.array([1, 2], np.int64), "v": np.zeros(2)})
    assert isinstance(run, psort.Run)
    views = run.open()
    assert isinstance(views[psort.KEY], np.memmap)
    assert np.array_equal(views[psort.KEY], [1, 2])


def test_spill_writer_casts_and_handles_empty(tmp_path):
    w = psort.SpillWriter(tmp_path, "t")
    w.append({"x": np.array([1, 2], np.int64)})
    w.append({"x": np.array([3.0, 4.0])})  # cast to the first batch's dtype
    out = w.finish()
    assert out["x"].dtype == np.int64
    assert np.array_equal(out["x"], [1, 2, 3, 4])
    assert psort.SpillWriter(tmp_path, "e").finish() == {}


# ----------------------------------------------------------------------
# streaming encode == the reference's streaming encode == in-RAM encode
# ----------------------------------------------------------------------

ATTRS = {"g1", "p0", "p1", "g2"}


@pytest.mark.parametrize("chunk_rows", [7, 64, 10_000])
def test_build_dictionaries_chunked_matches_reference(chunk_rows):
    db, jdb = both_dbs(chain_cols())
    rels, jrels = [db[r] for r in ("R1", "R2", "R3")], [jdb[r] for r in ("R1", "R2", "R3")]
    got = encoding.build_dictionaries(rels, ATTRS, chunk_rows=chunk_rows)
    want = jencoding.build_dictionaries(jrels, ATTRS, chunk_rows=chunk_rows)
    whole = encoding.build_dictionaries(rels, ATTRS)
    for a in ATTRS:
        assert np.array_equal(got[a].values, want[a].values)
        assert np.array_equal(got[a].values, whole[a].values)


@pytest.mark.parametrize("fractional", [False, True], ids=["integer", "fractional"])
@pytest.mark.parametrize("chunk_rows", [7, 64, 10_000])
def test_encode_streaming_matches_reference(chunk_rows, fractional):
    """Codes, counts and every payload equal the reference's streaming
    encode exactly, fractional ``sum`` payloads included (the same
    per-chunk and per-merge accumulation order); on integer measures
    they also equal the in-RAM encode."""
    db, jdb = both_dbs(chain_cols(fractional=fractional))
    rels, jrels = [db[r] for r in ("R1", "R2", "R3")], [jdb[r] for r in ("R1", "R2", "R3")]
    dicts = encoding.build_dictionaries(rels, ATTRS)
    jdicts = jencoding.build_dictionaries(jrels, ATTRS)
    got = encoding.encode_relation_streaming(db["R2"], ("p0", "p1"), dicts, "m", chunk_rows=chunk_rows)
    want = jencoding.encode_relation_streaming(
        jdb["R2"], ("p0", "p1"), jdicts, "m", chunk_rows=chunk_rows
    )
    assert isinstance(got.codes, np.memmap) and got._chunk_rows == chunk_rows
    assert got.attrs == want.attrs
    assert np.array_equal(np.asarray(got.codes), np.asarray(want.codes))
    assert np.array_equal(np.asarray(got.count), np.asarray(want.count))
    assert set(got.payloads) == set(want.payloads) == {"sum", "min", "max"}
    for k in want.payloads:
        assert np.array_equal(np.asarray(got.payloads[k]), np.asarray(want.payloads[k])), k
    if not fractional:
        ram = encoding.encode_relation(db["R2"], ("p0", "p1"), dicts, "m")
        assert np.array_equal(np.asarray(got.codes), ram.codes)
        for k in ram.payloads:
            assert np.array_equal(np.asarray(got.payloads[k]), ram.payloads[k])


def test_encode_streaming_empty_relation_keeps_payload_keys():
    rel = Relation("E", {"a": np.zeros(0, np.int64), "m": np.zeros(0)})
    carrier = Relation("C", {"a": np.arange(5)})
    dicts = encoding.build_dictionaries([rel, carrier], {"a"})
    ref = encoding.encode_relation(rel, ("a",), dicts, "m")
    got = encoding.encode_relation_streaming(rel, ("a",), dicts, "m", chunk_rows=4)
    assert got.num_rows == 0
    assert set(got.payloads) == set(ref.payloads)


@pytest.mark.parametrize("chunk_rows", [19, 256])
def test_grouped_csr_external_matches_in_ram(chunk_rows):
    db, jdb = both_dbs(chain_cols())
    dicts = encoding.build_dictionaries([db[r] for r in ("R1", "R2", "R3")], ATTRS)
    jdicts = jencoding.build_dictionaries([jdb[r] for r in ("R1", "R2", "R3")], ATTRS)
    er = encoding.encode_relation(db["R2"], ("p0", "p1"), dicts, None)
    jer = jencoding.encode_relation(jdb["R2"], ("p0", "p1"), jdicts, None)
    dims = (dicts["p0"].size, dicts["p1"].size)
    for key in (("p0", "p1"), ("p1",)):
        kd = tuple(dims[("p0", "p1").index(a)] for a in key)
        ram = pprepare.grouped_csr(er, key, kd)
        got = pprepare.grouped_csr_external(er, key, kd, chunk_rows=chunk_rows)
        want = jprepare.grouped_csr_external(jer, key, kd, chunk_rows=chunk_rows)
        assert isinstance(got.keys, np.memmap) and isinstance(got.order, np.memmap)
        for g, w in ((got.keys, ram.keys), (got.order, ram.order),
                     (got.keys, want.keys), (got.order, want.order)):
            assert np.array_equal(np.asarray(g), np.asarray(w))


# ----------------------------------------------------------------------
# one ingestion surface: adapters, lazy rewrites, chunking policy
# ----------------------------------------------------------------------


def test_as_source_adapters():
    rel = Relation("R", rel_cols(30))
    assert source.as_source(rel) is rel
    renamed = source.as_source(rel, "T")
    assert isinstance(renamed, Relation) and renamed.name == "T"
    assert np.array_equal(renamed.open_column("a"), rel.columns["a"])
    wrapped = source.as_source({"x": [1, 2, 3]}, "W")
    assert isinstance(wrapped, Relation) and wrapped.num_rows == 3
    with pytest.raises(ValueError, match="explicit name"):
        source.as_source({"x": [1]})
    with pytest.raises(TypeError, match="cannot ingest"):
        source.as_source(42, "N")


def test_database_from_sources_mixes_spellings(tmp_path):
    stored = storage.write_relation(Relation("R", rel_cols(20, seed=1)), tmp_path / "R")
    db = Database.from_sources(
        {"A": {"x": np.arange(4)}, "B": Relation("X", rel_cols(10, seed=2)), "C": stored}
    )
    assert db["A"].num_rows == 4 and db["B"].name == "B"
    # a stored relation keyed under a new name becomes a lazy rename view
    assert source.storage_kind(db["C"]) == "derived(mmap)"
    assert source.is_disk_backed(db["C"]) and db["C"].name == "C"
    assert source.materialize_relation(db["C"]).name == "C"


def test_lazy_rewrites_match_the_reference(tmp_path):
    cols = rel_cols(200, seed=9)
    stored = storage.write_relation(Relation("R", cols), tmp_path / "R")
    jstored = jstorage.open_relation(tmp_path / "R")
    pred = lambda c: c["b"] > 4  # noqa: E731
    pairs = [
        (source.rename_source(stored, "R2", {"a": "aa"}),
         jsource.rename_source(jstored, "R2", {"a": "aa"})),
        (source.filter_source(stored, pred), jsource.filter_source(jstored, pred)),
        (source.copy_column_source(stored, "a__grp", "a"),
         jsource.copy_column_source(jstored, "a__grp", "a")),
    ]
    for got, want in pairs:
        assert type(got).__name__ == type(want).__name__
        assert source.storage_kind(got) == jsource.storage_kind(want) == "derived(mmap)"
        assert got.name == want.name and got.attrs == want.attrs
        assert got.num_rows == want.num_rows
        for a in got.attrs:
            assert np.array_equal(got.open_column(a), want.open_column(a)), a
        gch = list(got.iter_chunks(got.attrs[-2:], 64))
        wch = list(want.iter_chunks(want.attrs[-2:], 64))
        assert len(gch) == len(wch)
        for g, w in zip(gch, wch):
            assert all(np.array_equal(g[a], w[a]) for a in w)
    eager = Relation("R", cols).filter(pred(cols))
    assert np.array_equal(pairs[1][0].open_column("m"), eager.columns["m"])
    # eager fast path for plain Relations: stays a Relation
    rel = Relation("R", cols)
    assert isinstance(source.copy_column_source(rel, "c", "a"), Relation)
    assert isinstance(source.filter_source(rel, pred), Relation)
    assert isinstance(source.rename_source(rel, "Z", {}), Relation)


def test_filtered_source_rejects_bad_mask(tmp_path):
    stored = storage.write_relation(Relation("R", rel_cols(10)), tmp_path / "R")
    bad = source.filter_source(stored, lambda cols: cols["b"] * 1)  # not bool
    with pytest.raises(ValueError, match="bool"):
        bad.num_rows


def test_resolve_chunk_rows_policy(tmp_path, monkeypatch):
    rel = Relation("R", rel_cols(10))
    stored = storage.write_relation(rel, tmp_path / "R")
    jrel, jstored = JRelation("R", rel_cols(10)), jstorage.open_relation(tmp_path / "R")
    cases = [
        ((["rel"],), {}, None),  # in-memory fast path
        ((["rel", "stored"],), {}, 1 << 18),
        ((["stored"],), {"chunk_rows": 500}, 500),
        # a budget shrinks the chunk (128 assumed bytes/row), floor 1024
        ((["stored"],), {"memory_budget": 1 << 20}, 8192),
        ((["stored"],), {"memory_budget": 1}, 1024),
        ((["rel"],), {"memory_budget": 1 << 20}, None),
    ]
    port, ref = {"rel": rel, "stored": stored}, {"rel": jrel, "stored": jstored}
    for (names,), kw, want in cases:
        assert source.resolve_chunk_rows([port[n] for n in names], **kw) == want
        assert jsource.resolve_chunk_rows([ref[n] for n in names], **kw) == want
    monkeypatch.setenv("REPRO_CHUNK_ROWS", "77")
    assert source.resolve_chunk_rows([rel]) == jsource.resolve_chunk_rows([jrel]) == 77
    assert source.resolve_chunk_rows([stored], chunk_rows=5) == 5
    assert source.env_chunk_rows() == 77
    monkeypatch.delenv("REPRO_CHUNK_ROWS")
    assert source.env_chunk_rows() is None


@pytest.mark.parametrize("chunk_rows", [None, 2, 64, 1 << 18])
def test_estimate_prepare_peak_matches_reference(tmp_path, chunk_rows):
    rel = Relation("R", rel_cols(100))
    stored = storage.write_relation(Relation("S", rel_cols(300, seed=4)), tmp_path / "S")
    jrel = JRelation("R", rel_cols(100))
    jstored = jstorage.open_relation(tmp_path / "S")
    got = source.estimate_prepare_peak([rel, stored], chunk_rows)
    assert got == jsource.estimate_prepare_peak([jrel, jstored], chunk_rows)
    whole = 8 * 3 * 100 + 8 * 3 * 300
    assert got == (whole if chunk_rows is None else min(chunk_rows * 128, whole))


# ----------------------------------------------------------------------
# planner surface: explain + verifier
# ----------------------------------------------------------------------


def _plans_on_disk(tmp_path, cols=None):
    """The port's plan (CPU) and the reference's (jax) of the chain
    bundle over one mounted directory."""
    db, _ = both_dbs(cols or chain_cols())
    storage.write_database(db, tmp_path / "db")
    q = Q.over("R1", "R2", "R3").group_by("R1.g1", "R3.g2").agg(n=Count(), s=Sum("R2.m"))
    jq = JQ.over("R1", "R2", "R3").group_by("R1.g1", "R3.g2").agg(n=JCount(), s=JSum("R2.m"))
    path = str(tmp_path / "db")
    return q.engine(CPU).plan(path), jq.engine("jax").plan(path)


def _storage_section(text: str) -> list[str]:
    lines = text.splitlines()
    i = next(k for k, line in enumerate(lines) if line.startswith("storage:"))
    out = [lines[i]]
    for line in lines[i + 1:]:
        if not line.startswith("  "):
            break
        out.append(line)
    return out


@pytest.mark.parametrize("where", ["disk", "memory", "budget", "env"])
def test_explain_storage_section_equals_the_reference(tmp_path, monkeypatch, where):
    cols = chain_cols()
    if where == "env":
        monkeypatch.setenv("REPRO_CHUNK_ROWS", "100")
    if where in ("disk", "env"):
        plan, jplan = _plans_on_disk(tmp_path, cols)
    else:
        db, jdb = both_dbs(cols)
        if where == "budget":  # one stored relation: the budget sets the chunk
            storage.write_relation(db["R1"], tmp_path / "R1")
            db = Database.from_sources({**db.relations, "R1": storage.open_relation(tmp_path / "R1")})
            jdb = JDatabase.from_sources(
                {**jdb.relations, "R1": jstorage.open_relation(tmp_path / "R1")}
            )
        q = Q.over("R1", "R2", "R3").group_by("R1.g1", "R3.g2").agg(n=Count())
        jq = JQ.over("R1", "R2", "R3").group_by("R1.g1", "R3.g2").agg(n=JCount())
        if where == "budget":
            q, jq = q.memory_budget(1 << 20), jq.memory_budget(1 << 20)
        plan, jplan = q.engine(CPU).plan(db), jq.engine("jax").plan(jdb)
    got, want = _storage_section(plan.explain()), _storage_section(jplan.explain())
    assert got == want
    assert plan.chunk_rows == jplan.chunk_rows
    expect = {"disk": "chunked (262144", "memory": "whole-column", "budget": "chunked (8192",
              "env": "chunked (100 "}[where]
    assert got[0].startswith(f"storage: {expect}")
    kinds = {"disk": "mmap", "memory": "memory", "budget": "mmap", "env": "mmap"}[where]
    assert got[1] == f"  R1: {kinds} (600 rows)"


def _mutate(view, which: str, num_keys: int):
    if which == "descending":
        view.keys = np.asarray(view.keys)[::-1].copy()
    elif which == "not-a-permutation":
        bad = np.asarray(view.order).copy()
        bad[0] = bad[1]
        view.order = bad
    elif which == "wrong-keys":  # still ascending, but not the codes' keys
        view.keys = np.minimum(np.asarray(view.keys) + 1, num_keys - 1)
    else:  # a dropped run: the last rows of the merge are missing
        view.keys = np.asarray(view.keys)[:-5].copy()
        view.order = np.asarray(view.order)[:-5].copy()


@pytest.mark.parametrize("which", ["descending", "not-a-permutation", "wrong-keys", "dropped-run"])
def test_verify_storage_csr_catches_corruption(tmp_path, which):
    """The same corruption of the same memmap-backed view trips
    V-STORE-CSR at the same site in both verifiers; the intact plans
    verify clean."""
    plan, jplan = _plans_on_disk(tmp_path)
    rel = next(iter(plan.prep.encoded))
    attr = plan.prep.encoded[rel].attrs[0]
    view, jview = plan.prep.csr_view(rel, (attr,)), jplan.prep.csr_view(rel, (attr,))
    assert isinstance(view.keys, np.memmap)
    assert verify_plan(plan) == [] and j_verify_plan(jplan) == []
    num_keys = plan.prep.dicts[attr].size
    _mutate(view, which, num_keys)
    _mutate(jview, which, num_keys)
    got = [(d.code, d.site) for d in verify_plan(plan) if d.code == "V-STORE-CSR"]
    want = [(d.code, d.site) for d in j_verify_plan(jplan) if d.code == "V-STORE-CSR"]
    assert got == want == [("V-STORE-CSR", f"storage/{rel}")]


def test_verify_storage_skips_in_ram_views():
    cols = chain_cols()
    plan = Q.over("R1", "R2", "R3").group_by("R1.g1", "R3.g2").agg(n=Count()).engine(CPU).plan(cols)
    rel = next(iter(plan.prep.encoded))
    view = plan.prep.csr_view(rel, (plan.prep.encoded[rel].attrs[0],))
    view.keys = np.asarray(view.keys)[::-1].copy()  # argsort views are not checked
    assert not any(d.code == "V-STORE-CSR" for d in verify_plan(plan))


# ----------------------------------------------------------------------
# chunked statistics
# ----------------------------------------------------------------------


@pytest.mark.parametrize("chunk_rows", [None, 17, 64])
def test_chunked_sketches_match_the_reference(chunk_rows):
    db, jdb = both_dbs(chain_cols())
    dicts = encoding.build_dictionaries([db[r] for r in ("R1", "R2", "R3")], ATTRS)
    jdicts = jencoding.build_dictionaries([jdb[r] for r in ("R1", "R2", "R3")], ATTRS)
    er = encoding.encode_relation(db["R2"], ("p0", "p1"), dicts, None)
    jer = jencoding.encode_relation(jdb["R2"], ("p0", "p1"), jdicts, None)
    got = _relation_stats(er, dicts, kmv_k=64, hh_m=8, chunk_rows=chunk_rows)
    want = j_relation_stats(jer, jdicts, kmv_k=64, hh_m=8, chunk_rows=chunk_rows)
    batch = _relation_stats(er, dicts, kmv_k=64, hh_m=8)
    assert (got.rows, got.num_rows) == (want.rows, want.num_rows) == (batch.rows, batch.num_rows)
    for attr in want.cols:
        g, w, b = got.cols[attr], want.cols[attr], batch.cols[attr]
        # KMV truncated set-union is exactly associative: the same state
        # however the rows are chunked
        assert np.array_equal(g.distinct._hashes, w.distinct._hashes)
        assert np.array_equal(g.distinct._hashes, b.distinct._hashes)
        assert (g.heavy.counts, g.heavy.n, g.heavy.err) == (w.heavy.counts, w.heavy.n, w.heavy.err)
        assert g.heavy.n == b.heavy.n and g.domain == w.domain


def test_memmap_encoding_sketches_stream(tmp_path):
    """A disk-backed prepare sketches in chunks (its codes are memmaps)
    and collects what the reference collects from the same directory,
    and what the in-memory prepare estimates."""
    cols = chain_cols()
    db, _ = both_dbs(cols)
    storage.write_database(db, tmp_path / "db")
    q = JoinAggQuery(("R1", "R2", "R3"), (("R1", "g1"), ("R3", "g2")))
    jq = JJoinAggQuery(("R1", "R2", "R3"), (("R1", "g1"), ("R3", "g2")))
    prep = pprepare.prepare(q, storage.open_database(tmp_path / "db"), chunk_rows=23)
    jprep = jprepare.prepare(jq, jstorage.open_database(tmp_path / "db"), chunk_rows=23)
    mem = pprepare.prepare(q, db)
    assert all(isinstance(er.codes, np.memmap) for er in prep.encoded.values())
    for rel in mem.encoded:
        a, b, c = mem.stats.relations[rel], prep.stats.relations[rel], jprep.stats.relations[rel]
        assert a.rows == b.rows == c.rows and a.num_rows == b.num_rows == c.num_rows
        for attr in a.cols:
            assert a.cols[attr].est_distinct == b.cols[attr].est_distinct
            assert b.cols[attr].est_distinct == c.cols[attr].est_distinct
    assert prep.stats.fanouts == jprep.stats.fanouts
