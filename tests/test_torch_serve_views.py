"""Maintained-view serving on the port (``repro_torch.serve.views``):
epoch swap, torn-read stress and the write-through to the storage tier;
counterparts of ``tests/test_serve_views.py`` (and of the reference's
server write-through cases in ``tests/test_storage.py``).

The handles keep their message caches on ``device="cpu"`` here.  Every
snapshot is held against a shadow handle's prefix result and against the
JAX package's ``ServedView`` over an ``engine("tensor")`` handle (its
``engine("jax")`` handle calls the Pallas kernels, which cannot lower on
the installed JAX), bit for bit: integer counts, tolerance 0."""
import threading
import time

import numpy as np
import pytest

from repro.api import Count as JCount
from repro.api import Q as JQ
from repro.data.synth import chain as j_chain
from repro.serve.views import ServedView as JServedView
from repro_torch.api import Avg, Count, Q, Sum, TorchChannelEngine
from repro_torch.relational.relation import Database, Relation
from repro_torch.serve.server import JoinAggServer
from repro_torch.serve.views import ServedView
from repro_torch.storage import open_database
from repro_torch.storage.store import StoredRelation
from test_torch_serve import TIMEOUT

CPU = TorchChannelEngine(device="cpu")


def count_q():
    return Q.over("R1", "R2", "R3", "R4").group_by("R1.g1").agg(n=Count())


def j_count_q():
    return JQ.over("R1", "R2", "R3", "R4").group_by("R1.g1").agg(n=JCount())


@pytest.fixture()
def dbs():
    jdb, _ = j_chain("C1", 250, seed=3)
    cols = {r: dict(jdb[r].columns) for r in ("R1", "R2", "R3", "R4")}
    return jdb, Database.from_mapping(cols)


@pytest.fixture()
def db(dbs):
    return dbs[1]


def make_view(db, name="v", q=None):
    return ServedView(name, (q or count_q()).engine(CPU).plan(db).maintain())


def rand_batch(rng, size=6):
    return {
        "g1": rng.integers(0, 20, size),
        "p0": rng.integers(0, 25, size),
    }


def test_epoch_swap_and_read_your_writes(db):
    view = make_view(db)
    try:
        snap0 = view.read()
        assert snap0.epoch == 0
        rng = np.random.default_rng(0)
        ep = view.insert("R1", rand_batch(rng)).result(timeout=TIMEOUT)
        assert ep == 1
        snap1 = view.read()
        assert snap1.epoch == 1
        assert snap1.result != snap0.result
        # snapshots are immutable history: snap0 still holds epoch-0 data
        assert snap0.epoch == 0
    finally:
        view.close()


def test_snapshot_matches_batch_replay_oracle(dbs):
    jdb, db = dbs
    view = make_view(db)
    jview = JServedView("v", j_count_q().engine("tensor").plan(jdb).maintain())
    shadow = count_q().engine(CPU).plan(db).maintain()
    rng = np.random.default_rng(1)
    try:
        for _ in range(5):
            batch = rand_batch(rng)
            ep = view.insert("R1", batch).result(timeout=TIMEOUT)
            jep = jview.insert("R1", batch).result(timeout=TIMEOUT)
            want = shadow.insert("R1", batch)
            snap = view.read()
            assert snap.epoch == ep == jep
            assert snap.as_dict() == want == jview.read().as_dict()
    finally:
        view.close()
        jview.close()


def test_rejected_batch_leaves_epoch_and_snapshot_intact(db):
    view = make_view(db)
    try:
        before = view.read()
        fut = view.delete("R1", {"g1": np.array([9999]),
                                 "p0": np.array([9999])})
        with pytest.raises(Exception):
            fut.result(timeout=TIMEOUT)  # over-delete of a tuple never inserted
        after = view.read()
        assert after.epoch == before.epoch
        assert after.as_dict() == before.as_dict()
    finally:
        view.close()


def test_concurrent_reads_always_see_a_delta_prefix(dbs):
    """Under a writer applying delta batches and many spinning readers,
    every observed snapshot is bit-identical to SOME batch prefix — never
    a torn intermediate (a half-grown dictionary or a partially
    propagated message cache)."""
    jdb, db = dbs
    n_batches = 30
    rng = np.random.default_rng(2)
    batches = [rand_batch(rng) for _ in range(n_batches)]

    # prefix oracles: epoch e == replaying batches[:e] on a fresh handle,
    # the port's and the JAX package's alike
    shadow = count_q().engine(CPU).plan(db).maintain()
    jshadow = j_count_q().engine("tensor").plan(jdb).maintain()
    prefix = [shadow.result()]
    for b in batches:
        prefix.append(shadow.insert("R1", b))
        assert prefix[-1] == jshadow.insert("R1", b)

    view = make_view(db)
    stop = threading.Event()
    bad = []

    def reader():
        seen_epoch = -1
        while not stop.is_set() or seen_epoch < n_batches:
            snap = view.read()
            if snap.as_dict() != prefix[snap.epoch]:
                bad.append(snap.epoch)
                return
            seen_epoch = max(seen_epoch, snap.epoch)
            if seen_epoch >= n_batches:
                return
            time.sleep(0.0005)  # let the writer's many short torch calls get the GIL

    readers = [threading.Thread(target=reader) for _ in range(4)]
    for t in readers:
        t.start()
    try:
        last = None
        for b in batches:
            last = view.insert("R1", b)
        assert last.result(timeout=TIMEOUT) == n_batches == view.drain()
        stop.set()
        for t in readers:
            t.join(timeout=TIMEOUT)
        assert not any(t.is_alive() for t in readers)
        assert not bad, f"torn reads at epochs {bad}"
        assert view.read().epoch == n_batches
        assert view.read().as_dict() == prefix[n_batches]
    finally:
        stop.set()
        view.close()


def test_server_view_lifecycle(db):
    with JoinAggServer(db, device="cpu", workers=2) as srv:
        view = srv.create_view("by_g1", count_q())
        assert view.handle.device.type == "cpu"
        assert srv.read_view("by_g1").epoch == 0
        with pytest.raises(ValueError, match="already exists"):
            srv.create_view("by_g1", count_q())
        rng = np.random.default_rng(4)
        ep = srv.apply_view("by_g1", "insert", "R1", rand_batch(rng)).result(timeout=TIMEOUT)
        assert ep == 1 and srv.stats()["views"] == {"by_g1": 1}
        with pytest.raises(ValueError, match="insert/delete"):
            view.apply("upsert", "R1", rand_batch(rng))
        srv.drop_view("by_g1")
        with pytest.raises(KeyError):
            srv.read_view("by_g1")


def test_bundle_view_snapshots_stay_as_published(db):
    """A bundle view (a ``MaintainedPlan``) publishes host copies: later
    refreshes leave an earlier snapshot's columns as they were, and each
    epoch equals a fresh execute of the grown database."""
    q = Q.over("R1", "R2", "R3", "R4").group_by("R1.g1").agg(
        n=Count(), total=Sum("R2.p1"), mean=Avg("R2.p1")
    )
    view = make_view(db, q=q)
    rng = np.random.default_rng(5)
    r1 = {a: np.asarray(c) for a, c in db["R1"].columns.items()}
    try:
        snap0 = view.read()
        frozen = {c: snap0.result.column(c).copy() for c in snap0.result.relation.columns}
        for _ in range(3):
            batch = rand_batch(rng)
            view.insert("R1", batch).result(timeout=TIMEOUT)
            r1 = {a: np.concatenate([r1[a], batch[a]]) for a in r1}
        grown = Database(dict(db.relations)).add(Relation("R1", r1))
        fresh = q.engine(CPU).plan(grown).execute()
        snap = view.read()
        assert snap.epoch == 3
        for c in fresh.relation.columns:
            assert isinstance(snap.result.column(c), np.ndarray)
            np.testing.assert_array_equal(snap.result.column(c), fresh.column(c))
        for c, col in frozen.items():
            np.testing.assert_array_equal(snap0.result.column(c), col)
    finally:
        view.close()


def test_server_write_through_registration(tmp_path, db):
    with JoinAggServer(device="cpu", workers=1, fuse=False, storage_dir=tmp_path) as srv:
        srv.register("R1", db["R1"])
        assert isinstance(srv.db["R1"], StoredRelation)
    # the directory stands alone: a fresh mount (or server) sees the data
    assert open_database(tmp_path)["R1"].num_rows == db["R1"].num_rows
    with JoinAggServer(device="cpu", workers=1, fuse=False, storage_dir=tmp_path) as srv2:
        assert srv2.db["R1"].num_rows == db["R1"].num_rows


def test_view_inserts_append_to_store(tmp_path, db):
    with JoinAggServer(device="cpu", workers=1, fuse=False, storage_dir=tmp_path) as srv:
        for name in ("R1", "R2", "R3", "R4"):
            srv.register(name, db[name])
        view = srv.create_view("v", count_q())
        before = srv.db["R1"].num_rows
        view.insert("R1", {"g1": np.array([0, 1]), "p0": np.array([2, 3])}).result(
            timeout=TIMEOUT
        )
        assert srv.db["R1"].num_rows == before + 2
        served = srv.read_view("v").as_dict()
    # persisted: the remount shows the appended delta and answers as the view
    mounted = open_database(tmp_path)
    assert mounted["R1"].num_rows == before + 2
    assert count_q().engine(CPU).plan(mounted).execute().to_dict("n") == served
