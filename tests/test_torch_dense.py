"""The port's dense einsum path and its dense-vs-sparse choice against the
JAX package's, on the same numpy inputs.

Every catalog query (REAL, CYCLIC and SKEWED of ``data/queries.py``) at
the plan goldens' scales (``benchmarks/plan_goldens.py:SCALES``), with
statistics on and off:

* ``choose_path`` equals ``choose_jax_path`` — path, reason and every
  per-node byte estimate — at the default budget, at a budget one byte
  below the dense program (which flips it to sparse) and with an
  explicit stream;
* ``engine(TorchChannelEngine(device="cpu"))`` takes that path, and on
  an integer measure its COUNT/SUM/AVG/MIN/MAX bundle equals
  ``engine("jax")``'s (its dense program on the CPU) and the port's own
  ``mode="sparse"`` run bit for bit: every float32 sum of integers below
  2**24 is exact, whatever the order;
* on a fractional measure SUM and AVG are within ``FRACTIONAL_RTOL`` of
  ``engine("jax")`` (the two contract in different orders) and COUNT,
  MIN and MAX are exact.

Then what is the port's own: the contraction order does not depend on
``torch.backends.opt_einsum``, the caller's float32 matmul precision is
restored, ``MAX_DENSE_ELEMS`` raises ``MemoryError``, rows that share a
cell reduce in a fixed order, ``execute_torch`` mirrors ``execute_jax``,
and the result helpers (``to_dict``, ``group_tuples``, ``Q.count``)
equal the reference's.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmarks.plan_goldens import SCALES
from repro.api import Avg as JAvg
from repro.api import Count as JCount
from repro.api import Max as JMax
from repro.api import Min as JMin
from repro.api import Q as JQ
from repro.api import Sum as JSum
from repro.core.jax_engine import choose_jax_path, execute_jax
from repro.core.prepare import prepare as jprepare
from repro.data import queries as jqueries
from repro.relational.relation import Database as JDatabase
from repro_torch.api import Avg, Count, Max, Min, Q, Sum, TorchChannelEngine
from repro_torch.core import torch_engine
from repro_torch.core.prepare import prepare
from repro_torch.core.torch_engine import (
    build_dense_program,
    choose_path,
    dense_tensor,
    execute_torch,
)
from repro_torch.relational.encoding import EncodedRelation
from repro_torch.relational.relation import Database
from tests.conftest import REPO_ROOT
from tests.test_torch_planner import assert_identical
from tests.test_torch_planner import catalog as planner_catalog

GROUPS = {"REAL": jqueries.REAL, "CYCLIC": jqueries.CYCLIC, "SKEWED": jqueries.SKEWED}
GOLDEN = [(name, group) for group, cat in GROUPS.items() for name in sorted(cat)]
NAMES = [name for name, _ in GOLDEN]
SCALE = {name: SCALES[group] for name, group in GOLDEN}
# float32 sums of positive terms in two orders; see tests/test_torch_planner.py
FRACTIONAL_RTOL = 1e-5
JAX = (JCount, JSum, JAvg, JMin, JMax)
PORT = (Count, Sum, Avg, Min, Max)


def catalog(name: str):
    """``(jax db, jax query, port db, port query)`` at the golden scale."""
    return planner_catalog(name, SCALE[name])


def measured(name: str, values):
    """Both databases with a measure ``m`` on the query's first relation,
    and its name ``"R.m"``."""
    jdb, jq, db, q = catalog(name)
    rel = q.relations[0]
    m = values(np.random.default_rng(3), jdb[rel].num_rows)
    cols = {r: dict(jdb[r].columns) for r in jdb.relations}
    cols[rel]["m"] = m
    return JDatabase.from_mapping(cols), jq, Database.from_mapping(cols), q, f"{rel}.m"


def bundle(qcls, api, q, m):
    count, total, avg, lo, hi = api
    return qcls.over(*q.relations).group_by(
        *(f"{r}.{a}" for r, a in q.group_by)
    ).agg(n=count(), s=total(m), a=avg(m), lo=lo(m), hi=hi(m))


def cpu(mode: str = "auto") -> TorchChannelEngine:
    return TorchChannelEngine(device="cpu", mode=mode)


def channel_args(plan):
    cm = tuple(ch.measure[0] if ch.kind == "sum" else None for ch in plan.channels)
    return dict(k=len(cm), measured=cm)


def assert_same_choice(want, got):
    assert (got.path, got.reason) == (want.path, want.reason)
    assert got.dense_node_bytes == want.dense_node_bytes
    assert got.sparse_node_bytes == want.sparse_node_bytes
    assert (got.dense_peak, got.sparse_peak) == (want.dense_peak, want.sparse_peak)


# ----------------------------------------------------------------------
# the path choice
# ----------------------------------------------------------------------


@pytest.mark.parametrize("aggs", ["count", "bundle"])
@pytest.mark.parametrize("stats", [True, False])
@pytest.mark.parametrize("name", NAMES)
def test_choose_path_equals_the_reference(name, stats, aggs):
    """Default budget, a budget one byte below the dense program, and an
    explicit stream; statistics as the engine sees them (the plan's
    cached collection) and as ``explain`` passes them."""
    if aggs == "count":
        jdb, jq, db, q = catalog(name)
        jplan = JQ.from_query(jq).stats(stats).engine("jax").plan(jdb)
        plan = Q.from_query(q).stats(stats).engine(cpu()).plan(db)
    else:
        jdb, jq, db, q, m = measured(name, lambda rng, n: rng.integers(0, 9, n))
        jplan = bundle(JQ, JAX, jq, m).stats(stats).engine("jax").plan(jdb)
        plan = bundle(Q, PORT, q, m).stats(stats).engine(cpu()).plan(db)
    args, jargs = channel_args(plan), channel_args(jplan)
    assert args == jargs
    default = choose_jax_path(jplan.prep, **jargs)
    assert default.path == "dense", default.reason
    stream = (plan.prep.group_attrs[0][1], 2)
    for kw in ({}, {"memory_budget": default.dense_peak - 1}, {"stream": stream}):
        want = choose_jax_path(jplan.prep, **jargs, **kw)
        assert_same_choice(want, choose_path(plan.prep, **args, **kw))
        if stats:
            want = choose_jax_path(jplan.prep, **jargs, **kw, stats=jplan.prep.stats)
            got = choose_path(plan.prep, **args, **kw, stats=plan.prep.stats)
            assert_same_choice(want, got)
    assert choose_path(plan.prep, **args, memory_budget=default.dense_peak - 1).path == "sparse"


def _reference_parts(jplan) -> list:
    """The reference's per-key-range ``Prepared`` set, built as its
    ``execute_split`` builds it (empty ranges left out)."""
    from repro.core.prepare import csr_restrict as jcsr_restrict
    from repro.planner.split import _range_plan, _split_prepared

    prep, d = jplan.prep, jplan.split
    parts = []
    for (lo, hi), root in zip(d.ranges, d.roots):
        enc = jcsr_restrict(prep, d.attr, lo, hi)
        if all(enc[r].num_rows == 0 for r in enc if d.attr in enc[r].attrs):
            continue
        deco = prep.decomposition
        if root != deco.root:
            _, _, deco = _range_plan(prep, d.attr, hi - lo)
        parts.append(_split_prepared(prep, d.attr, lo, hi, deco))
    return parts


@pytest.mark.parametrize("n", [SCALE["SKEWCHAIN"], 100_000])
def test_split_path_choice_per_range_equals_the_reference(n):
    """A split plan chooses its path per key range, with no budget, as
    the reference's ``execute_split`` runs ``engine.run`` per range:
    every range's choice (path, reason, per-node bytes) equals the
    reference's on its own part, and the engine takes it."""
    from repro_torch.planner.split import split_parts

    jdb, jq, db, q = planner_catalog("SKEWCHAIN", n)
    jplan = JQ.from_query(jq).engine("jax").plan(jdb)
    plan = Q.from_query(q).engine(cpu()).plan(db)
    assert plan.split is not None and jplan.split is not None
    jparts, parts = _reference_parts(jplan), split_parts(plan.prep, plan.split)
    assert len(parts) == len(jparts) > 1
    args, jargs = channel_args(plan), channel_args(jplan)
    for part, jpart in zip(parts, jparts):
        assert part.decomposition.root == jpart.decomposition.root
        want = choose_jax_path(jpart, **jargs)
        assert_same_choice(want, choose_path(part, **args))
        assert plan.engine.path(part, plan.channels) == want.path


def test_split_execute_takes_the_reference_path_per_range(monkeypatch):
    """Spy on both engines' path choice and on the port's two programs
    during one execute of SKEWCHAIN's split plan: the same choices, in
    range order, and the port runs the dense program exactly where its
    choice says dense."""
    import repro.core.jax_engine as jax_engine_mod
    import repro_torch.api.engines as engines_mod

    jdb, jq, db, q = catalog("SKEWCHAIN")
    jplan = JQ.from_query(jq).engine("jax").plan(jdb)
    plan = Q.from_query(q).engine(cpu()).plan(db)
    jchoices, choices, ran = [], [], []

    def spy(real, into):
        def wrapped(*a, **kw):
            into.append(real(*a, **kw))
            return into[-1]

        return wrapped

    def dense_spy(real):
        def wrapped(prep, device):
            ran.append(prep)
            return real(prep, device)

        return wrapped

    monkeypatch.setattr(jax_engine_mod, "choose_jax_path",
                        spy(jax_engine_mod.choose_jax_path, jchoices))
    monkeypatch.setattr(engines_mod, "choose_path", spy(engines_mod.choose_path, choices))
    monkeypatch.setattr(engines_mod, "build_dense_program",
                        dense_spy(engines_mod.build_dense_program))
    want, got = jplan.execute(), plan.execute()
    assert_identical(want, got)
    parts = plan._split_parts
    assert len(jchoices) == len(choices) == len(parts) > 1
    for jc, c in zip(jchoices, choices):
        assert_same_choice(jc, c)
    assert ran == [p for p, c in zip(parts, choices) if c.path == "dense"]


def test_extreme_sparsity_flips_to_sparse_like_the_reference():
    """TPCH at 19,200 rows: orders' 4,800 × 1,920 tensor is under the
    cliff and the budget, but the statistics find it extreme-sparse."""
    jdb, jq, db, q = planner_catalog("TPCH", 19_200)
    jplan = JQ.from_query(jq).engine("jax").plan(jdb)
    plan = Q.from_query(q).engine(cpu()).plan(db)
    want = choose_jax_path(jplan.prep)
    assert want.path == "sparse" and "extreme-sparse" in want.reason
    assert_same_choice(want, choose_path(plan.prep))
    assert plan.engine.path(plan.prep, plan.channels) == "sparse"
    assert_same_choice(choose_jax_path(jplan.prep, stats=None),
                       choose_path(plan.prep, stats=None))


# ----------------------------------------------------------------------
# dense results
# ----------------------------------------------------------------------


@pytest.mark.parametrize("stats", [True, False])
@pytest.mark.parametrize("name", NAMES)
def test_dense_bundle_bit_identical(name, stats):
    jdb, jq, db, q, m = measured(name, lambda rng, n: rng.integers(0, 9, n))
    jplan = bundle(JQ, JAX, jq, m).stats(stats).engine("jax").plan(jdb)
    plan = bundle(Q, PORT, q, m).stats(stats).engine(cpu()).plan(db)
    assert choose_jax_path(jplan.prep, **channel_args(jplan)).path == "dense"
    assert plan.engine.path(plan.prep, plan.channels) == "dense"
    got = plan.execute()
    assert got.num_rows > 0
    assert_identical(jplan.execute(), got)
    sparse = bundle(Q, PORT, q, m).stats(stats).engine(cpu("sparse")).plan(db)
    assert sparse.engine.path(sparse.prep, sparse.channels) == "sparse"
    assert_identical(sparse.execute(), got)


@pytest.mark.parametrize("name", NAMES)
def test_dense_fractional_sum_within_tolerance(name):
    jdb, jq, db, q, m = measured(name, lambda rng, n: rng.uniform(0.0, 7.0, n))
    want = bundle(JQ, JAX, jq, m).engine("jax").plan(jdb).execute()
    plan = bundle(Q, PORT, q, m).engine(cpu()).plan(db)
    assert plan.engine.path(plan.prep, plan.channels) == "dense"
    got = plan.execute()
    assert want.num_rows == got.num_rows > 0
    for c in list(plan.group_display) + ["n", "lo", "hi"]:
        np.testing.assert_array_equal(got.column(c), want.column(c), err_msg=c)
    for c in ("s", "a"):
        np.testing.assert_allclose(got.column(c), want.column(c), rtol=FRACTIONAL_RTOL)


def _star_cols(n=400, seed=7) -> dict:
    """R2 joins R1 and R3 and carries the measure: rooted at R2 the dense
    program contracts three operands in one term."""
    rng = np.random.default_rng(seed)
    return {
        "R1": {"g1": rng.integers(0, 9, n), "p": rng.integers(0, 20, n)},
        "R2": {"p": rng.integers(0, 20, n), "q": rng.integers(0, 20, n),
               "g": rng.integers(0, 3, n), "m": rng.uniform(0.0, 5.0, n)},
        "R3": {"q": rng.integers(0, 20, n), "g2": rng.integers(0, 9, n)},
    }


@pytest.mark.parametrize("name", ["star", "IMDB"])
def test_result_does_not_depend_on_opt_einsum(name, monkeypatch):
    """Fractional sums on a term of three operands (the star) and on a
    chain: the same bits with ``torch.backends.opt_einsum`` on and off."""
    if name == "star":
        cols = _star_cols()
        q = Q.over("R1", "R2", "R3").group_by("R1.g1", "R2.g", "R3.g2")
        q = q.agg(n=Count(), s=Sum("R2.m"), a=Avg("R2.m")).engine(cpu())
        db = Database.from_mapping(cols)
    else:
        _, _, db, pq, m = measured(name, lambda rng, n: rng.uniform(0.0, 7.0, n))
        q = bundle(Q, PORT, pq, m).engine(cpu())
    plan = q.plan(db)
    terms = [expr.split("->")[0].count(",") + 1 for _, expr, _ in
             torch_engine.dense_plan(plan.prep)[0]]
    assert name != "star" or max(terms) >= 3, terms
    results = []
    for enabled in (True, False, True):
        monkeypatch.setattr(torch.backends.opt_einsum, "enabled", enabled)
        results.append(q.plan(db).execute())
    assert plan.engine.path(plan.prep, plan.channels) == "dense"
    for other in results[1:]:
        assert_identical(results[0], other)


def test_contract_term_pairwise_matches_einsum():
    """The pairwise order computes the einsum (fractional operands within
    float32 rounding; integers exactly)."""
    g = torch.Generator().manual_seed(0)
    a = torch.randint(0, 5, (6, 7), generator=g).float()
    b = torch.randint(0, 5, (7, 4), generator=g).float()
    c = torch.randint(0, 5, (6, 3), generator=g).float()
    for expr, ops in [("ab,bc,ad->cd", (a, b, c)), ("ab->a", (a,)), ("ab,bc->ac", (a, b)),
                      ("ab,ad->bad", (a, c))]:
        want = torch.einsum(expr, *ops)
        got = torch_engine.contract_term(expr, list(ops))
        assert torch.equal(got, want), expr


def test_full_fp32_restores_the_callers_precision():
    """The dense program runs under full FP32 and hands back the caller's
    process-wide float32 matmul precision (``"high"`` = TF32 allowed)."""
    _, _, db, q = catalog("IMDB")
    plan = Q.from_query(q).engine(cpu()).plan(db)
    saved = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        seen = []
        real = torch_engine.contract_term

        def spy(expr, ops):
            seen.append(torch.get_float32_matmul_precision())
            return real(expr, ops)

        torch_engine.contract_term = spy
        try:
            plan.execute()
        finally:
            torch_engine.contract_term = real
        assert seen and set(seen) == {"highest"}
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(saved)


_NEW_API_RUN = """
import torch
from repro_torch.api import Q, TorchChannelEngine
from repro_torch.data.queries import imdb_like

matmul = torch.backends.cuda.matmul
if not hasattr(matmul, "fp32_precision"):
    print("no per-backend switch")
else:
    matmul.fp32_precision = "tf32"
    db, q = imdb_like(600, seed=0)
    Q.from_query(q).engine(TorchChannelEngine(device="cpu")).execute(db)
    print(matmul.fp32_precision)
"""


def test_full_fp32_restores_the_per_backend_switch():
    """A caller that set TF32 through ``matmul.fp32_precision`` (where
    reading the process-wide precision raises) gets it back; in its own
    process, since that switch cannot be mixed with the other one."""
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _NEW_API_RUN], capture_output=True, text=True,
        env=env, cwd=REPO_ROOT, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] in ("tf32", "no per-backend switch")


def test_max_dense_elems_raises_memory_error(monkeypatch):
    """Past ``MAX_DENSE_ELEMS`` a pinned dense run raises; nothing falls
    back to the sparse path or to numpy."""
    _, _, db, q = catalog("DBLP")
    plan = Q.from_query(q).engine(cpu("dense")).plan(db)
    largest = max(
        int(np.prod([plan.prep.dicts[a].size for a in er.attrs]))
        for er in plan.prep.encoded.values()
    )
    monkeypatch.setattr(torch_engine, "MAX_DENSE_ELEMS", largest - 1)
    with pytest.raises(MemoryError, match="dense tensor for"):
        plan.execute()
    with pytest.raises(MemoryError):
        execute_torch(q, db, mode="dense", device="cpu")
    monkeypatch.setattr(torch_engine, "MAX_DENSE_ELEMS", largest)
    assert plan.execute().num_rows > 0


def test_engine_modes_pin_a_path():
    """``mode`` overrides the choice both ways; the dense program cannot
    tile a stream, and an unknown mode is refused."""
    _, _, db, q = catalog("DBLP")
    stream = ("a1", 10)
    sparse = Q.from_query(q).engine(cpu("sparse")).plan(db)
    dense = Q.from_query(q).engine(cpu("dense")).plan(db)
    streamed = Q.from_query(q).stream(*stream).engine(cpu()).plan(db)
    assert choose_path(dense.prep).path == "dense"
    assert sparse.engine.path(sparse.prep, sparse.channels) == "sparse"
    assert streamed.engine.path(streamed.prep, streamed.channels, stream) == "sparse"
    assert_identical(dense.execute(), sparse.execute())
    assert_identical(dense.execute(), streamed.execute())
    with pytest.raises(ValueError, match="cannot tile"):
        Q.from_query(q).stream(*stream).engine(cpu("dense")).plan(db).execute()
    with pytest.raises(ValueError, match="unknown mode"):
        cpu("fast")


def test_rows_sharing_a_cell_reduce_in_a_fixed_order():
    """Codes that repeat (pre-aggregation makes them unique, a caller's
    encoding may not) go through ``segment_sum`` in grouped-CSR order:
    the tensor equals the numpy scatter-add of the float32 rows."""
    _, _, db, q = catalog("ORDS")
    prep = prepare(q, db)
    rel = prep.decomposition.root
    er = prep.encoded[rel]
    w = np.random.default_rng(1).uniform(0.0, 3.0, er.num_rows * 2)
    doubled = EncodedRelation(
        er.name, er.attrs, np.concatenate([er.codes, er.codes[::-1]]),
        np.concatenate([er.count, er.count[::-1]]), {"sum": w},
    )
    prep.encoded[rel] = doubled
    got = dense_tensor(prep, rel, torch.device("cpu"), (None, rel))
    dims = tuple(prep.dicts[a].size for a in er.attrs)
    order = prep.csr_view(rel, er.attrs).order
    assert len(np.unique(prep.csr_view(rel, er.attrs).keys)) < doubled.num_rows
    for channel, values in ((0, doubled.count), (1, w)):
        want = np.zeros(dims, np.float32)
        np.add.at(want, tuple(doubled.codes[order].T), values[order].astype(np.float32))
        np.testing.assert_array_equal(got[channel].numpy(), want)


@pytest.mark.parametrize("kind", ["count", "sum", "min", "max"])
@pytest.mark.parametrize("mode", ["auto", "dense", "sparse"])
def test_execute_torch_equals_execute_jax(kind, mode):
    jdb, jq, db, q, m = measured("IMDB", lambda rng, n: rng.integers(0, 9, n))
    rel, attr = m.split(".")
    agg = {"count": (Count(), JCount()), "sum": (Sum(rel, attr), JSum(rel, attr)),
           "min": (Min(rel, attr), JMin(rel, attr)), "max": (Max(rel, attr), JMax(rel, attr))}
    pagg, jagg = agg[kind]
    from repro.core.query import JoinAggQuery as JJoinAggQuery
    from repro_torch.core.query import JoinAggQuery

    jquery = JJoinAggQuery(jq.relations, jq.group_by, jagg)
    query = JoinAggQuery(q.relations, q.group_by, pagg)
    if mode == "dense" and kind in ("min", "max"):
        with pytest.raises(NotImplementedError):
            execute_torch(query, db, mode=mode, device="cpu")
        return
    want = execute_jax(jquery, jdb, jprepare(jquery, jdb), mode=mode)
    got = execute_torch(query, db, mode=mode, device="cpu")
    assert got and got == want


def test_dense_program_keeps_tensors_on_the_prepared():
    """A warm dense run only contracts: the tensors built by the first
    run are the ones the second reads."""
    _, _, db, q, m = measured("TPCH", lambda rng, n: rng.integers(0, 9, n))
    plan = bundle(Q, PORT, q, m).engine(cpu()).plan(db)
    plan.execute()
    cached = {k: v for k, v in plan.prep.device_views.items() if k[0] == "dense"}
    assert len(cached) == len(plan.prep.encoded)
    prog = build_dense_program(plan.prep, "cpu")
    cm = tuple(ch.measure[0] if ch.kind == "sum" else None for ch in plan.channels)
    arr = prog.run_channels(cm)
    assert arr.shape == tuple(plan.prep.dicts[a].size for _, a in plan.prep.group_attrs) + (2,)
    assert all(plan.prep.device_views[k] is v for k, v in cached.items())


# ----------------------------------------------------------------------
# result helpers
# ----------------------------------------------------------------------


@pytest.mark.parametrize("name", ["IMDB", "TRIANGLE", "SKEWCHAIN"])
def test_result_helpers_equal_the_reference(name):
    jdb, jq, db, q, m = measured(name, lambda rng, n: rng.integers(0, 5, n))
    groups = [f"{r}.{a}" for r, a in q.group_by]
    want = JQ.over(*jq.relations).group_by(*groups).count().agg(
        s=JSum(m), lo=JMin(m)).engine("jax").plan(jdb).execute()
    got = Q.over(*q.relations).group_by(*groups).count().agg(
        s=Sum(m), lo=Min(m)).engine(cpu()).plan(db).execute()
    assert got.agg_names == want.agg_names == ("count", "s", "lo")
    assert got.group_tuples() == want.group_tuples()
    for agg in got.agg_names:
        assert got.to_dict(agg) == want.to_dict(agg)
    one = Q.over(*q.relations).group_by(*groups).count("k").engine(cpu()).plan(db).execute()
    jone = JQ.over(*jq.relations).group_by(*groups).count("k").engine("jax").plan(jdb).execute()
    assert one.to_dict() == jone.to_dict()
    with pytest.raises(ValueError, match="name one"):
        got.to_dict()
