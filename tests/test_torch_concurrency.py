"""What the port shares between threads once a server runs plans on
worker threads: the process-wide matmul precision that
``full_fp32_matmul`` switches, the one kernel build, and the memos a
cached plan's ``Prepared`` fills on its first execute."""
import os
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from repro_torch.api import Avg, Count, Max, Min, Q, Sum, TorchChannelEngine
from repro_torch.core import torch_engine
from repro_torch.core.torch_engine import full_fp32_matmul
from repro_torch.data.queries import tpch_like
from repro_torch.kernels import ops
from repro_torch.serve.cache import PlanCache
from repro_torch.serve.server import JoinAggServer
from test_torch_planner import assert_identical
from test_torch_serve import TIMEOUT, serve_dbs


def run_threads(targets) -> None:
    threads = [threading.Thread(target=t) for t in targets]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in threads)


def test_full_fp32_matmul_is_counted_across_threads():
    """A enters, B enters, A leaves while B's products still run: B must
    still see full FP32, and the caller's TF32 setting must be back once
    both have left (one save by the first in, one restore by the last
    out)."""
    saved = torch.get_float32_matmul_precision()
    both_in, a_left, check = (threading.Barrier(2, timeout=TIMEOUT) for _ in range(3))
    seen = {}

    def a():
        with full_fp32_matmul():
            seen["a inside"] = torch.get_float32_matmul_precision()
            both_in.wait()
            a_left.wait()
        check.wait()

    def b():
        both_in.wait()
        with full_fp32_matmul():
            seen["b inside"] = torch.get_float32_matmul_precision()
            a_left.wait()
            check.wait()  # A has left by now
            seen["b after a left"] = torch.get_float32_matmul_precision()

    try:
        torch.set_float32_matmul_precision("high")
        run_threads([a, b])
        seen["caller after both"] = torch.get_float32_matmul_precision()
    finally:
        torch.set_float32_matmul_precision(saved)
    assert seen == {
        "a inside": "highest", "b inside": "highest",
        "b after a left": "highest", "caller after both": "high",
    }


def test_concurrent_dense_queries_keep_the_callers_precision():
    """Four clients' dense bundles through a server, under a caller's
    TF32 setting: every einsum term runs in full FP32, every answer is
    the solo one, and the caller's setting survives."""
    db, q = tpch_like(600, seed=0)
    spec = Q.from_query(q)
    saved = torch.get_float32_matmul_precision()
    seen = []
    real = torch_engine.contract_term

    def spy(expr, ops_):
        seen.append(torch.get_float32_matmul_precision())
        time.sleep(0.001)  # widen the window a lost restore would fall in
        return real(expr, ops_)

    try:
        torch.set_float32_matmul_precision("high")
        solo = spec.engine(TorchChannelEngine(device="cpu")).plan(db)
        assert solo.engine.path(solo.prep, solo.channels) == "dense"
        want = solo.execute()
        torch_engine.contract_term = spy
        with JoinAggServer(db, device="cpu", workers=4, fuse=False) as srv:
            futs = [srv.submit(spec) for _ in range(4)]
            results = [f.result(timeout=TIMEOUT) for f in futs]
        after = torch.get_float32_matmul_precision()
    finally:
        torch_engine.contract_term = real
        torch.set_float32_matmul_precision(saved)
    for r in results:
        assert_identical(want, r)
    assert seen and set(seen) == {"highest"}
    assert after == "high"


class _FakeNvcc:
    """Stands in for an ``nvcc`` process: takes a while, then writes the
    library it was asked for."""

    started: list
    lock = threading.Lock()

    def __init__(self, cmd, **kwargs):
        self.out = Path(cmd[cmd.index("-o") + 1])
        self.returncode = None
        with self.lock:
            self.started.append(self.out.name)

    def communicate(self, timeout=None):
        time.sleep(0.2)
        self.out.write_bytes(b"\x7fELF")
        self.returncode = 0
        return "ptxas info    : Used 32 registers", None

    def poll(self):
        return self.returncode

    def kill(self):
        self.returncode = -9

    def wait(self):
        return self.returncode


def test_build_compiles_each_kernel_once_under_concurrent_callers(tmp_path, monkeypatch):
    """Eight workers' first launches on a cold server call ``build()`` at
    once: one ``nvcc`` per kernel runs, and every caller gets the same
    libraries."""
    monkeypatch.setattr(ops, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(ops, "_built", {})
    monkeypatch.setattr(ops, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_FakeNvcc, "started", [], raising=False)
    monkeypatch.setattr(ops.subprocess, "Popen", _FakeNvcc)
    start = threading.Barrier(8, timeout=TIMEOUT)
    results, errors = [], []

    def caller():
        start.wait()
        try:
            results.append(ops.build())
        except Exception as e:  # a racing build's lost temp file
            errors.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        run_threads([caller] * 8)
    finally:
        sys.setswitchinterval(switch)
    assert errors == []
    assert sorted(_FakeNvcc.started) == sorted(
        f"{ops._library_path(k).stem}.{os.getpid()}.tmp" for k in ops.KERNELS
    )
    assert len(results) == 8
    assert all({k: b.library for k, b in r.items()} == {k: b.library for k, b in results[0].items()}
               for r in results)
    assert all(b.library.exists() for b in results[0].values())


@pytest.mark.parametrize("mode", ["sparse", "dense", "fused"])
def test_concurrent_first_executes_of_one_cached_plan(mode):
    """Eight threads run a cached plan's first execute at once, racing to
    fill its ``Prepared``'s device views, weights, dense tensors and
    MIN/MAX payload values: each answer is the solo answer."""
    db = serve_dbs(n=400, seed=2)[1]
    q = Q.over("R1", "R2", "R3", "R4").group_by("R1.g1", "R4.g2").agg(
        n=Count(), s=Sum("R2.w"), a=Avg("R2.w"), lo=Min("R2.w"), hi=Max("R2.w")
    )
    engine = TorchChannelEngine(device="cpu", mode="sparse" if mode == "fused" else mode)
    if mode == "fused":
        q = q.fused(True)
    want = q.engine(engine).plan(db).execute()
    plan = PlanCache(4, engine=engine).lookup(q, db)
    assert not plan.prep.device_views and not plan.prep.payload_values
    start = threading.Barrier(8, timeout=TIMEOUT)
    results = []

    def worker():
        start.wait()
        results.append(plan.execute())

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        run_threads([worker] * 8)
    finally:
        sys.setswitchinterval(switch)
    assert len(results) == 8
    for r in results:
        assert_identical(want, r)
    assert plan.prep.device_views
