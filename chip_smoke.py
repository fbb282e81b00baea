#!/usr/bin/env python3
"""Smoke test of the repro_torch port on one NVIDIA card.

    python3 chip_smoke.py [--n 500000] [--check-n 20000] [--seed 0]

Run from the root of a checkout on a machine with a CUDA card.  It

1. builds the port's CUDA kernels from ``src/repro_torch/csrc`` and
   prints the build time and ptxas' register and spill lines;
2. drives the port's main path through ``Q ... .engine("torch")`` on the
   paper's synthetic chain C1 at ``--n`` rows per relation (Table IV
   scale by default) with an integer measure on R3: COUNT, SUM, AVG, MIN
   and MAX grouped by R1.g1 and R4.g2.  It prints prepare, cold and warm
   execute times, result rows, peak device memory, the stream tile, each
   kernel's launch count (every one must be > 0) and the device's idle
   share in a warm execute under ``torch.profiler``;
3. holds each kernel against its plain PyTorch version on the card, at
   the largest shape the main path launched it with and on edge cases,
   with tolerance 0 (integer-valued float32 below 2**24: every sum is
   exact), and times kernel, plain version, one PyTorch library call as
   a yardstick, and the bound from bytes and operations;
4. checks the result: Σ COUNT and Σ SUM against an independent numpy
   count of the chain join, and, at ``--check-n`` rows, the whole result
   on the card bit-identical to the same plan on the CPU.

The last three lines of standard output are the card's name and power
limit, one JSON object of per-kernel numbers, and
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero.
"""
from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores

KERNEL_SOURCES = {
    "segment_sum": ("src/repro_torch/csrc/segment_sum.cu", "src/repro/kernels/segment_sum.py:27"),
    "coo_spmm": ("src/repro_torch/csrc/coo_spmm.cu", "src/repro/kernels/coo_spmm.py:35"),
    "segment_reduce": ("src/repro_torch/csrc/segment_reduce.cu", "src/repro/kernels/segment_reduce.py:36"),
}


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def say(tag: str, msg: str) -> None:
    print(f"{msg} [{tag}]", flush=True)


# ----------------------------------------------------------------------
# measurement helpers
# ----------------------------------------------------------------------


def time_ms(torch, fn, reps: int = 10) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events),
    after two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def max_abs_err(torch, a, b) -> float:
    """Largest |a - b|; equal infinities count as no error, a shape or
    infinity mismatch as an infinite one."""
    if a.shape != b.shape:
        return float("inf")
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    if bool(same.all()):
        return 0.0
    return float((a[~same] - b[~same]).abs().max())


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------------
# main path
# ----------------------------------------------------------------------


def chain_db(n: int, seed: int):
    """Synthetic chain C1 at ``n`` rows per relation, plus an integer
    measure column ``m`` on R3 in [0, 100)."""
    import numpy as np

    from repro_torch.data import synth
    from repro_torch.relational.relation import Database

    db, _ = synth.chain("C1", n, seed=seed)
    cols = {r: dict(db[r].columns) for r in ("R1", "R2", "R3", "R4")}
    cols["R3"]["m"] = np.random.default_rng(seed + 1).integers(0, 100, n)
    return Database.from_mapping(cols), cols


def chain_totals(cols) -> tuple[int, int]:
    """Σ COUNT and Σ SUM(R3.m) over the chain join, counted in numpy
    without the port: path counts propagated R4 -> R1 by bincount."""
    import numpy as np

    dom = 1 + max(int(cols[r][a].max()) for r, a in (
        ("R1", "p0"), ("R2", "p0"), ("R2", "p1"), ("R3", "p1"),
        ("R3", "p2"), ("R4", "p2"),
    ))
    c4 = np.bincount(cols["R4"]["p2"], minlength=dom).astype(np.float64)
    w3 = np.bincount(cols["R3"]["p1"], weights=c4[cols["R3"]["p2"]], minlength=dom)
    s3 = np.bincount(
        cols["R3"]["p1"],
        weights=cols["R3"]["m"] * c4[cols["R3"]["p2"]],
        minlength=dom,
    )
    w2 = np.bincount(cols["R2"]["p0"], weights=w3[cols["R2"]["p1"]], minlength=dom)
    s2 = np.bincount(cols["R2"]["p0"], weights=s3[cols["R2"]["p1"]], minlength=dom)
    return int(w2[cols["R1"]["p0"]].sum()), int(s2[cols["R1"]["p0"]].sum())


def bundle_query(engine):
    from repro_torch.api import Avg, Count, Max, Min, Q, Sum

    return (
        Q.over("R1", "R2", "R3", "R4")
        .group_by("R1.g1", "R4.g2")
        .agg(n=Count(), s=Sum("R3.m"), a=Avg("R3.m"), lo=Min("R3.m"), hi=Max("R3.m"))
        .engine(engine)
    )


def idle_share(torch, run) -> tuple[float, float, list[tuple[str, float, int]]]:
    """Run ``run()`` under torch.profiler; return (wall s, device-busy s,
    top device ops by time).  Busy time is the union of the intervals of
    all device events (kernels and copies)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = []
    by_name: dict[str, list[float]] = {}
    for ev in prof.events():
        if ev.device_type.name != "CUDA":
            continue
        lo, hi = ev.time_range.start, ev.time_range.end
        spans.append((lo, hi))
        acc = by_name.setdefault(ev.name, [0.0, 0])
        acc[0] += (hi - lo) / 1e3
        acc[1] += 1
    spans.sort()
    busy_us, cur_lo, cur_hi = 0.0, None, None
    for lo, hi in spans:
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                busy_us += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    if cur_hi is not None:
        busy_us += cur_hi - cur_lo
    top = sorted(
        ((name, ms, cnt) for name, (ms, cnt) in by_name.items()),
        key=lambda t: -t[1],
    )[:10]
    return wall, busy_us / 1e6, top


def capture_launches(run):
    """Run ``run()`` with the engine's kernel wrappers wrapped, keeping
    the arguments of each kernel's largest launch (by elements read and
    written).  This run is outside any counted or timed one."""
    from repro_torch.core import torch_engine

    largest: dict[str, tuple[int, tuple, dict]] = {}
    originals = {
        name: getattr(torch_engine, name)
        for name in ("segment_sum", "coo_spmm", "segment_reduce")
    }

    def wrap(name, fn):
        def capturing(*args, **kwargs):
            out = fn(*args, **kwargs)
            size = out.numel() + sum(
                a.numel() for a in args if hasattr(a, "numel")
            )
            if name not in largest or size > largest[name][0]:
                kw = {k: v for k, v in kwargs.items() if k != "out"}
                largest[name] = (size, args, kw)
            return out

        return capturing

    for name, fn in originals.items():
        setattr(torch_engine, name, wrap(name, fn))
    try:
        run()
    finally:
        for name, fn in originals.items():
            setattr(torch_engine, name, fn)
    return {name: (args, kw) for name, (_, args, kw) in largest.items()}


# ----------------------------------------------------------------------
# kernels vs plain versions
# ----------------------------------------------------------------------


def kernel_cases(torch, dev):
    """Edge cases per kernel: empty input, ids out of range on both ends,
    one segment, a segment count that is a multiple of nothing, widths 1
    and 33, all-empty MIN/MAX segments.  Integer-valued float32."""
    g = torch.Generator(device="cpu").manual_seed(7)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g).to(dev)

    def sorted_ids(n, lo, hi):
        return torch.sort(ints(lo, hi, (n,))).values.contiguous()

    def data(n, d):
        return ints(-50, 50, (n, d)).float()

    seg = []
    for n, d, s, id_lo, id_hi in [
        (0, 4, 5, 0, 5),  # empty input
        (300, 1, 17, -4, 21),  # out of range on both ends, width 1
        (257, 33, 1, 0, 1),  # one segment, width 33
        (1000, 33, 97, -2, 100),  # 97 segments, width 33
        (40, 3, 11, 11, 20),  # every id out of range: all segments empty
    ]:
        seg.append(((data(n, d), sorted_ids(n, id_lo, id_hi), s), {}))
    spmm = []
    for nnz, k, w, s, r_lo, r_hi, c_lo, c_hi in [
        (0, 6, 5, 4, 0, 4, 0, 6),
        (500, 30, 1, 13, -3, 16, -2, 32),  # rows and cols out of range
        (200, 9, 33, 1, 0, 1, 0, 9),
        (2000, 50, 33, 97, 0, 97, 0, 50),
    ]:
        rows = sorted_ids(nnz, r_lo, r_hi)
        cols = ints(c_lo, c_hi, (nnz,))
        vals = ints(1, 9, (nnz,)).float()
        dense = data(k, w)
        spmm.append(((rows, cols, vals, dense, s), {}))
    return seg, spmm


def kernel_phase(torch, tag, captured):
    from repro_torch.kernels import ref
    from repro_torch.kernels.coo_spmm import coo_spmm
    from repro_torch.kernels.segment_reduce import segment_reduce
    from repro_torch.kernels.segment_sum import segment_sum

    dev = torch.device("cuda")
    seg_cases, spmm_cases = kernel_cases(torch, dev)
    results = {}

    def compare(name, label, kernel, plain, args, kw):
        got = kernel(*args, **kw)
        want = plain(*args, **kw)
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want)
        shapes = {
            i: tuple(a.shape) if hasattr(a, "shape") else a for i, a in enumerate(args)
        }
        say(tag, f"kernels: {name} [{label}] args {shapes} {kw}: "
                 f"max |kernel - plain| = {err} (tolerance 0)")
        check(err == 0.0, f"{name} [{label}] disagrees with its plain version: {err}")
        return err

    # --- segment_sum ---------------------------------------------------
    args, kw = captured["segment_sum"]
    data, ids, s = args
    errs = [compare("segment_sum", "main path", segment_sum, ref.segment_sum, args, kw)]
    for a, k in seg_cases:
        errs.append(compare("segment_sum", "edge", segment_sum, ref.segment_sum, a, k))
    n, d = data.shape
    b, by = bound(n * d * 4 + n * 8 + s * d * 4, n * d)
    results["segment_sum"] = dict(
        shapes={"data": [n, d], "segment_ids": [n], "num_segments": s},
        max_abs_err=max(errs),
        ms=time_ms(torch, lambda: segment_sum(data, ids, s)),
        plain_ms=time_ms(torch, lambda: ref.segment_sum(data, ids, s)),
        library_ms=time_ms(
            torch, lambda: torch.zeros((s, d), device=dev).index_add_(0, ids, data)
        ),
        bound_ms=b, bound_by=by,
    )

    # --- segment_reduce ------------------------------------------------
    args, kw = captured["segment_reduce"]
    (data, ids, s), kind = args, kw["kind"]
    errs = [compare("segment_reduce", "main path", segment_reduce,
                    ref.segment_reduce, (data, ids, s, kind), {})]
    for a, _ in seg_cases:
        for kd in ("min", "max"):
            errs.append(compare("segment_reduce", f"edge {kd}", segment_reduce,
                                ref.segment_reduce, (*a, kd), {}))
    n, d = data.shape
    b, by = bound(n * d * 4 + n * 8 + s * d * 4, n * d)
    red = "amin" if kind == "min" else "amax"
    ident = float("inf") if kind == "min" else float("-inf")
    index = ids[:, None].expand(n, d)
    results["segment_reduce"] = dict(
        shapes={"data": [n, d], "segment_ids": [n], "num_segments": s, "kind": kind},
        max_abs_err=max(errs),
        ms=time_ms(torch, lambda: segment_reduce(data, ids, s, kind)),
        plain_ms=time_ms(torch, lambda: ref.segment_reduce(data, ids, s, kind)),
        library_ms=time_ms(
            torch,
            lambda: torch.full((s, d), ident, device=dev).scatter_reduce_(
                0, index, data, red, include_self=True
            ),
        ),
        bound_ms=b, bound_by=by,
    )

    # --- coo_spmm ------------------------------------------------------
    args, kw = captured["coo_spmm"]
    rows, cols, vals, dense, s = args
    errs = [compare("coo_spmm", "main path", coo_spmm, ref.coo_spmm, args, kw)]
    for a, k in spmm_cases:
        errs.append(compare("coo_spmm", "edge", coo_spmm, ref.coo_spmm, a, k))
    nnz = rows.shape[0]
    kdense, w = dense.shape
    used = int(torch.unique(cols).numel())
    b, by = bound(nnz * 20 + used * w * 4 + s * w * 4, 2 * nnz * w)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mat = torch.sparse_coo_tensor(
            torch.stack([rows, cols]), vals, (s, kdense)
        ).coalesce().to_sparse_csr()
        library_ms = time_ms(torch, lambda: torch.sparse.mm(mat, dense))
    results["coo_spmm"] = dict(
        shapes={"rows": [nnz], "dense": [kdense, w], "num_rows": s,
                "dense_rows_used": used},
        max_abs_err=max(errs),
        ms=time_ms(torch, lambda: coo_spmm(rows, cols, vals, dense, s)),
        plain_ms=time_ms(torch, lambda: ref.coo_spmm(rows, cols, vals, dense, s), reps=3),
        library_ms=library_ms,
        bound_ms=b, bound_by=by,
    )
    for name, r in results.items():
        say(tag, f"kernels: {name} at {r['shapes']}: {r['ms']:.4f} ms, bound "
                 f"{r['bound_ms']:.4f} ms by {r['bound_by']}, plain "
                 f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms")
    return results


# ----------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=500_000, help="rows per relation")
    ap.add_argument("--check-n", type=int, default=20_000,
                    help="rows per relation of the CPU bit-identity check")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not (SRC / "repro_torch" / "kernels" / "ops.py").is_file():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              "root of a repository checkout", file=sys.stderr)
        return 2
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.api import TorchChannelEngine
    from repro_torch.api import plan as plan_mod
    from repro_torch.kernels import ops

    tag = card_line()
    dev_name = torch.cuda.get_device_name(0)
    say(tag, f"card: {dev_name}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    built = ops.build()
    say(tag, f"build: {time.perf_counter() - t0:.2f} s wall for {list(built)} "
             f"(nvcc per source: "
             + ", ".join(f"{k} {v.seconds:.2f} s" for k, v in built.items()) + ")")
    for name, b in built.items():
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line:
                say(tag, f"build: {name}: {line.strip()}")

    # 2. main path -------------------------------------------------------
    t0 = time.perf_counter()
    db, cols = chain_db(args.n, args.seed)
    plan = bundle_query("torch").plan(db)
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0
    stream = plan.resolved_stream()
    say(tag, f"main path: C1 n={args.n} seed={args.seed}; {plan}; prepare "
             f"{prepare_s:.3f} s; est peak message {plan.message_peak} B; "
             f"stream tile {stream}")

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = plan.execute()
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    say(tag, f"main path: cold execute {cold_s:.3f} s, launches {launches}")
    for name in ops.KERNELS:
        check(launches[name] > 0, f"main path never launched {name}")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = plan.execute()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    say(tag, f"main path: warm execute {warm_s:.3f} s, result rows "
             f"{res.num_rows}, peak device memory {peak} B")

    t0 = time.perf_counter()
    outputs = plan.engine.run(plan.prep, plan.channels, plan.minmax, stream)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan_mod._assemble(plan, outputs)
    assemble_s = time.perf_counter() - t0
    say(tag, f"main path: warm split: engine.run {run_s:.3f} s, assemble "
             f"{assemble_s:.3f} s")

    host = cProfile.Profile()
    host.enable()
    plan.execute()
    torch.cuda.synchronize()
    host.disable()
    stats = pstats.Stats(host)
    say(tag, f"host profile: warm execute, {stats.total_tt:.3f} s of Python "
             "profile time; top functions by own time:")
    rows = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:12]
    for (file, line, fn), (_, calls, tottime, cumtime, _) in rows:
        say(tag, f"host profile: {tottime * 1e3:9.1f} ms own {cumtime * 1e3:9.1f} ms "
                 f"cum x{calls:<6d} {fn} ({Path(file).name}:{line})")

    wall, busy, top = idle_share(torch, plan.execute)
    say(tag, f"profile: warm execute {wall:.3f} s wall, device busy {busy:.3f} s, "
             f"idle share {1 - busy / wall:.3f}")
    for name, ms, cnt in top:
        say(tag, f"profile: {ms:10.3f} ms x{cnt:<6d} {name[:90]}")

    # 3. correctness -----------------------------------------------------
    want_n, want_s = chain_totals(cols)
    got_n, got_s = res.column("n").sum(), res.column("s").sum()
    say(tag, f"check: Σ count {got_n:.0f} vs numpy {want_n}; Σ sum {got_s:.0f} "
             f"vs numpy {want_s}")
    check(got_n == want_n and got_s == want_s, "Σ count / Σ sum disagree with numpy")
    check(res.num_rows > 0, "empty result")
    for name in res.agg_names:
        check(bool(np.isfinite(res.column(name)).all()), f"non-finite values in {name}")

    small, _ = chain_db(args.check_n, args.seed)
    gpu = bundle_query("torch").plan(small).execute()
    cpu = bundle_query(TorchChannelEngine(device="cpu")).plan(small).execute()
    same = all(
        gpu.column(c).dtype == cpu.column(c).dtype
        and np.array_equal(gpu.column(c), cpu.column(c))
        for c in cpu.relation.columns
    )
    say(tag, f"check: C1 n={args.check_n}: {cpu.num_rows} rows, "
             f"{len(cpu.relation.columns)} columns bit-identical to device='cpu': {same}")
    check(same and gpu.num_rows == cpu.num_rows, "cuda result differs from cpu result")

    # 4. kernels vs plain, at the main path's shapes ---------------------
    captured = capture_launches(plan.execute)
    for name in ops.KERNELS:
        check(name in captured, f"no {name} launch captured")
    results = kernel_phase(torch, tag, captured)

    summary = {
        "prepare_s": prepare_s, "cold_execute_s": cold_s, "warm_execute_s": warm_s,
        "engine_run_s": run_s, "assemble_s": assemble_s, "rows": res.num_rows,
        "peak_bytes": peak, "stream": stream, "idle_share": 1 - busy / wall,
    }
    say(tag, f"main path summary: {json.dumps(summary)}")
    kernels = []
    for name in ops.KERNELS:
        r = results[name]
        src, replaces = KERNEL_SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shapes": r["shapes"],
        })
    print(tag, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
