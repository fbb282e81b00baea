#!/usr/bin/env python3
"""Smoke test of the repro_torch port on one NVIDIA card.

    python3 chip_smoke.py [--n 500000] [--check-n 20000] [--seed 0]
                          [--storage-n 5000000]

Run from the root of a checkout on a machine with a CUDA card.  It

1. builds the port's five CUDA kernels from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, in parallel) and prints the build time and
   ptxas' register, shared memory, stack and spill lines (per entry
   function for ``semiring_matmul``);
2. drives the port's main path through ``Q ... .engine("torch")`` (its
   default plan, statistics on) on the paper's synthetic chain C1 at
   ``--n`` rows per relation (Table IV scale by default) with an integer
   measure on R3: COUNT, SUM, AVG, MIN and MAX grouped by R1.g1 and
   R4.g2.  It prints prepare, cold and warm
   execute times, result rows, peak device memory, the stream tile, each
   kernel's launch count (``segment_sum``, ``coo_spmm`` and
   ``segment_reduce`` must be > 0, ``fused_hop`` 0) and the device's
   idle share in a warm execute under ``torch.profiler``;
3. drives the fused path, the same bundle on the same data with
   ``.fused(True)``, and prints the same numbers; there only
   ``fused_hop`` may launch, once per hop, per pass, per stream tile;
4. checks the results: Σ COUNT and Σ SUM against an independent numpy
   count of the chain join, every fused column bit-identical to the
   unfused one, and, at ``--check-n`` rows, each path's result on the
   card bit-identical to the same plan on the CPU;
5. holds each kernel against its plain PyTorch version on the card, at
   the largest shape the paths launched it with (``fused_hop``: per kind
   and child count; ``segment_sum`` and ``segment_reduce`` also at the
   largest launch of their widest rows, the general hops' edge chunks,
   with ``out=`` at that launch's alignment) and on edge cases (see
   ``kernel_cases``, ``fused_hop_cases`` and, for the slab-major warp walk
   of ``coo_spmm`` and one-child ``fused_hop`` hops, ``gather_cases``,
   with operand and output pointers off 16 bytes), with tolerance 0 (integer-valued
   float32 below 2**24: every sum is exact), and times kernel, plain
   version, one PyTorch library call as a yardstick where one computes
   the same function, ``fused_hop``'s three-dispatch counterpart on the
   same hop, and the bound from bytes and operations.  No engine calls
   ``semiring_matmul``: it is held and timed at (2048, 2048) x (2048,
   2048), held at (3000, 1000) x (1000, 2500), on fractional values, on
   ragged shapes, with ±inf in the last values of k and with operands off
   16-byte alignment, all at tolerance 0, and each semiring's time stands
   beside its bound and its instruction floor (``semiring_floor``);
6. drives the split leg: the catalog's SKEWCHAIN (``data/queries.py``, 30 %
   of both sides on one hot key of p0) at ``--n`` rows per relation, its
   COUNT through ``Q.from_query``, once with the default plan (statistics
   on: it must split p0 into key ranges) and once with ``.stats(False)``
   (unsplit), each with the numbers of 2 and its peak device memory above
   what was allocated before planning; checks split = unsplit bit for bit,
   Σ COUNT against numpy's Σ_p0 c1[p0]·c2[p0] in int64, the fused split
   plan (only ``fused_hop`` launches) and, at ``--check-n``, card = CPU;
7. drives the cyclic leg: TRIANGLE (40,000 edges per relation), FOURCYCLE
   (20,000) and FOFGROUP (40,000) through the GHD compiler, printing the
   host prepare split into encode, ``build_ghd``, bag materialization and
   ``finish_prepare`` beside warm execute, bag rows and peak bytes, and
   the decomposition left after the fold; checks each group's COUNT
   against an int64 count with ``scipy.sparse`` (exact below 2**24, within
   ``count_rtol`` above it), at 4,000 edges card = CPU bit for bit, and
   runs each query once more with ``mode="sparse"``, bit-identical, so
   that ``segment_sum`` still launches in this leg;
8. drives the dense leg: the catalog's TPCH with an integer
   ``lineitem.quantity`` in [1, 50] (TPC-H's ``l_quantity``) and the
   COUNT/SUM/AVG/MIN/MAX bundle of it, at the largest ``n`` of the
   doubling series 600, 1200, ... for which ``choose_path`` still says
   dense, printing the relation tensors' element counts; the default
   (dense) plan and a ``mode="sparse"`` plan, each with the numbers of 2;
   checks dense = sparse bit for bit, Σ COUNT and Σ SUM against numpy,
   card = CPU at 4,800 rows, and the dense result again under a global
   ``torch.backends.cuda.matmul.allow_tf32 = True``: unchanged, and the
   setting still on afterwards; then times both paths, each pinned, at
   every size of the series and one doubling past it (``path_sweep``),
   beside what ``choose_path`` picks there;
9. prints ``plan.explain(actuals=True)`` of TPCH at 600 rows on the card
   and checks that ``verify()`` finds no broken invariant in any leg's
   plan (V-OVERFLOW, an estimate the legs' exact count checks settle,
   is printed);
10. drives the maintain leg: Table VIII's B2 star (``data/synth.py``) at
   ``--n`` rows per relation with an integer measure on R2, a COUNT
   handle through ``Q.maintain(db)`` and a COUNT/SUM/AVG bundle through
   ``Plan.maintain()``, both caching their messages on the card, through
   inserts of 1, 10, 100, 1,000 and 10,000 rows into R2, a delete of
   1,000 present R2 tuples, an insert into the leaf R3 that grows two
   domains and an insert into the root R1.  After each batch both
   handles equal a from-scratch execute on the card bit for bit and Σ
   COUNT equals numpy's; per batch and handle it prints refresh and
   full-recompute ms and their ratio, ``delta_rows``,
   ``rows_rescanned``, ``peak_delta_bytes``, the device peak above
   resident, the launches and the device→host syncs of the refresh
   (only ``segment_sum`` and ``coo_spmm`` may launch).  The largest
   batch is then deleted, its launches captured and held against the
   plain versions (``maintain_kernels``), and inserted again under the
   profiler (idle share); a MIN handle takes a delete (the
   non-invertible fallback, on ``segment_reduce``); and at
   ``--check-n`` the same sequence runs on card and ``device="cpu"``
   handles, bit for bit;
11. drives the storage leg, the repo's Table XIV on the card: its
   measured chain R1(g1, p0), R2(p0, p1, m), R3(p1, g2) at
   ``--storage-n`` rows per relation (join domains n / 50, group domains
   32) is written with ``write_database`` to a temporary directory
   (removed at the end) and mounted with ``open_database``.  It prints
   the write and open seconds; prepare's seconds and host peak
   (tracemalloc) mounted, with chunk_rows
   ``max(4096, n / 25)``, and in memory, and fails unless the mounted
   peak is below twice the largest column; the Table XIV query,
   SUM(R2.m) by R1.g1 and R3.g2, planned and executed mounted and in
   memory, bit for bit, with the first execute's host peak; the storage
   smoke bundle (COUNT, SUM, MIN, MAX, AVG) on the mounted database
   driven as in 2 (``segment_sum``, ``coo_spmm`` and ``segment_reduce``
   must launch), its ``coo_spmm`` launch also held at tolerance 0 on
   exact operands at the same rows and columns (``spmm_exact_check``);
   Σ COUNT and Σ SUM against numpy in int64 (exact below
   2**24, within ``count_rtol`` above); ``verify()`` clean, V-STORE-CSR
   included; and at ``--check-n`` the mounted bundle with forced tiny
   chunks (the k-way merge), with ``.fused(True)``, on the CPU and with
   the default chunk, each bit-identical to the in-memory run, and a
   ``Q.maintain`` handle over the mounted database equal to one over the
   in-memory twin through three 100-row R2 inserts;
12. drives the serve leg: ``JoinAggServer(db, device="cuda", workers=8,
   fusion_window=0.002)`` over C1 at ``--n`` with the reference demo's
   integer ``R2.w`` in [1, 100) (``launch/serve.py``), answering its five
   shapes (count, sum, multi, minmax, two_group) and ``count`` with
   ``.fused(True)``; every answer is held against a solo
   ``plan(db).execute()`` of its spec on the card, bit for bit.  It
   prints each shape's cold and warm query time; two rounds of 8 client
   threads x 6 queries (the first while two served views take 6 insert
   batches each and 2 readers per view check every read against a
   shadow handle's prefix: ``by_g1``, COUNT by R1.g1, whose R1 batches
   recompute because the chain folds into R1, and ``pairs``, the
   two_group shape on g1 < 40 and g2 < 40, whose R2 batches must all
   propagate through the device message caches, its last prefix also
   equal to a fresh execute; the second round warm and under the
   profiler): p50/p99
   latency, queries per second, the device idle share and the device
   peak above what the full plan cache holds; 8 identical queries as one
   burst (one execute) against one after another; a count/sum/multi
   burst (a channel merge); one TCP round trip; the plan-cache and
   fusion counters (compiles fewer than queries); the dense leg's TPCH
   bundle from 4 concurrent clients of a second server under a global
   ``allow_tf32 = True`` (every einsum term run with TF32 off, read by a
   spy on ``contract_term``; the FP32 result bit for bit; the setting
   kept);
   at ``--check-n`` a ``device="cpu"`` server against a ``device="cuda"``
   one, answer by answer; and the served plans' own ``segment_sum``,
   ``coo_spmm``, ``segment_reduce`` and ``fused_hop`` launches against
   their plain versions (tolerance 0), each timed beside its library
   call.  Each of the four must launch;
13. drives the shard leg, the sharded path of DESIGN.md §8: the bundle of
   2 on C1 at ``--n`` through ``Q ... .mesh(S).plan(db).execute()`` on
   process groups of S = 1, 2 and 4 ranks (``multiprocessing`` spawns each
   rank on ``cuda:{rank % device_count}``; NCCL where there are at least S
   cards, else gloo, which gathers on the host; the kernels are built
   before the spawn), unfused and fused.  Every rank's gathered answer
   must equal 2's single-device answer bit for bit and Σ COUNT / Σ SUM
   numpy's, and every rank must launch ``segment_sum`` and
   ``segment_reduce`` (unfused) or ``fused_hop`` (fused).  It prints the
   backend and ranks per card, each rank's cold and warm execute split
   into the walk and the ``all_gather``, its peak device memory above
   resident beside the S = 1 peak (the ratio; nothing is claimed), and
   ``per_device_bytes()`` beside that peak.  At S = 4 a C1 at
   ``--check-n`` whose group attributes take 2 codes (the last two
   shards own no rows) runs meshed and alone, bit for bit, and rank 0
   holds its largest launches against the plain versions (tolerance 0).
14. drives the comparison leg, the paper's Tables II and III on the card
   through the port's own baselines and oracle (``repro_torch.baselines``,
   ``repro_torch.relational.oracle``; host numpy in the reference, torch
   tensors on the card here).  Table III: S1, S2 and S3
   (``data/synth.py``) at ``--n`` rows, each through the legacy
   ``join_agg`` cold and warm, ``binary_join_agg`` and
   ``preagg_join_agg``, printing each one's synchronised wall ms, device
   peak above resident and largest intermediate (rows and bytes); the
   three answers must have the same groups and equal counts.  Table II:
   B2 at ``--n`` / 16, / 8, / 4, / 2 and ``--n`` rows, ``join_agg``
   against ``preagg_join_agg`` on peak and ms, equal answers.  The oracle
   on the card must equal S3's ``join_agg`` answer and the main path's C1
   bundle at 100,000 rows (a join of about 10**8 rows) group by group:
   COUNT, SUM, MIN and MAX exactly, AVG within 1 ulp.  At ``--check-n``
   every baseline and oracle call on the card equals the same call with
   ``device="cpu"``, answers and statistics, and launches no kernel.

Every leg prints its ``torch path:`` line — per key range for the split
leg — and checks the path each run took against ``choose_path``: a dense
run launches no hop kernel but ``segment_reduce`` (its MIN/MAX), a
sparse one does.

The last three lines of standard output are the card's name and power
limit, one JSON object of per-kernel numbers (with each kernel's launches
in every leg, the maintain leg's refreshes summed under ``maintain``),
and ``{"ok": true, "device": {...}}``.  Any failed check
exits non-zero.
"""
from __future__ import annotations

import argparse
import cProfile
import gc
import json
import os
import pstats
import subprocess
import sys
import time
import warnings
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores
FP32_INSTR_PER_S = FP32_OPS_PER_S / 2  # float32 instructions (an FMA counts 2 operations)
# 32-bit logic and float32 min/max: 64 a clock per SM (CUDA C++ Programming
# Guide, arithmetic instruction throughput, compute capability 9.0) x 132 SMs
# x 1.98 GHz boost clock
LOGIC_OPS_PER_S = 64 * 132 * 1.98e9
SPIN_CYCLES = 100_000_000  # about 50 ms at the H100's 1.98 GHz boost clock

KERNEL_SOURCES = {
    "segment_sum": ("src/repro_torch/csrc/segment_sum.cu", "src/repro/kernels/segment_sum.py:27"),
    "coo_spmm": ("src/repro_torch/csrc/coo_spmm.cu", "src/repro/kernels/coo_spmm.py:35"),
    "segment_reduce": ("src/repro_torch/csrc/segment_reduce.cu", "src/repro/kernels/segment_reduce.py:36"),
    "fused_hop": ("src/repro_torch/csrc/fused_hop.cu", "src/repro/kernels/fused_hop.py:92"),
    "semiring_matmul": ("src/repro_torch/csrc/semiring_matmul.cu", "src/repro/kernels/semiring_matmul.py:29"),
}
UNFUSED_KERNELS = ("segment_sum", "coo_spmm", "segment_reduce")
SEGMENT_KERNELS = ("segment_sum", "segment_reduce")


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
    after two warm-up calls.  The timed launches queue behind a device-side
    spin of about 50 ms, so the host's time to enqueue them is not counted
    unless ``fn`` itself waits for the device."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
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


def idle_share(torch, run, cpu: bool = True) -> tuple[float, float, list[tuple[str, float, int]]]:
    """Run ``run()`` under torch.profiler; return (wall s, device-busy s,
    top device ops by time).  Busy time is the union of the intervals of
    all device events (kernels and copies).  ``cpu=False`` traces the
    device alone, for runs whose host threads issue too many ops to
    trace cheaply."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
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
    )[:16]
    return wall, busy_us / 1e6, top


def _numel(x) -> int:
    if isinstance(x, (list, tuple)):
        return sum(_numel(v) for v in x)
    return x.numel() if hasattr(x, "numel") else 0


class Launch(NamedTuple):
    args: tuple
    kw: dict  # without ``out``
    offset: int  # floats from ``out``'s start back to a 16-byte boundary
    count: int  # launches with this key in the run
    size: int  # elements read and written


def capture_launches(run, key_of) -> dict:
    """Run ``run()`` with the engine's kernel wrappers wrapped, keeping
    for each key ``key_of(name, args, kwargs)`` (None: not kept) the
    largest launch (by elements read and written) and the number of
    launches.  This run is outside any counted or timed one."""
    from repro_torch.core import torch_engine

    largest: dict = {}
    counts: dict = {}
    names = UNFUSED_KERNELS + ("fused_hop",)
    originals = {name: getattr(torch_engine, name) for name in names}

    def wrap(name, fn):
        def capturing(*args, **kwargs):
            out = fn(*args, **kwargs)
            key = key_of(name, args, kwargs)
            if key is None:
                return out
            counts[key] = counts.get(key, 0) + 1
            size = out.numel() + _numel(args)
            if key not in largest or size > largest[key][0]:
                kw = {k: v for k, v in kwargs.items() if k != "out"}
                dst = kwargs.get("out")
                offset = 0 if dst is None else (dst.data_ptr() // 4) % 4
                largest[key] = (size, args, kw, offset)
            return out

        return capturing

    for name, fn in originals.items():
        setattr(torch_engine, name, wrap(name, fn))
    try:
        run()
    finally:
        for name, fn in originals.items():
            setattr(torch_engine, name, fn)
    return {
        key: Launch(args, kw, offset, counts[key], size)
        for key, (size, args, kw, offset) in largest.items()
    }


def main_path_key(name, args, kwargs):
    """``segment_sum`` and ``segment_reduce`` launches by row width (the
    leaf hops are narrow, the edge chunks of general hops wide);
    ``coo_spmm`` by name."""
    if name in SEGMENT_KERNELS:
        return name, args[0].shape[1]
    return name if name in UNFUSED_KERNELS else None


def hop_class(name, args, kwargs):
    """A fused_hop launch's class: (kind, children, channel-uniform
    weights); the other kernels are not kept."""
    if name != "fused_hop":
        return None
    keys, w, msgs, idxs, num_segments, k, kind = args
    return kind, len(msgs), bool((w == w[:, :1]).all())


# ----------------------------------------------------------------------
# kernels vs plain versions
# ----------------------------------------------------------------------


def compare(torch, tag, name, label, kernel, plain, args, kw=None, out=None, tol=None):
    """Run ``kernel`` and ``plain`` on the same inputs; fail unless they
    agree exactly, or, with ``tol`` (a tensor of the result's shape),
    within ``tol`` element by element.  With ``out`` (a view into a
    larger buffer), the kernel writes there and must leave the rest of
    the buffer as it was.  Returns max |kernel - plain|."""
    kw = kw or {}
    if out is None:
        got = kernel(*args, **kw)
    else:
        buf = out._base
        before = buf.clone()
        got = kernel(*args, **kw, out=out)
        check(got is out, f"{name} [{label}] did not return its out argument")
        inside = torch.zeros(buf.shape, dtype=torch.bool, device=buf.device)
        inside.view(-1)[out.storage_offset() - buf.storage_offset():][: out.numel()] = True
        check(bool((buf == before)[~inside].all()),
              f"{name} [{label}] wrote outside its out slice")
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, want)

    def shape(a):
        if isinstance(a, (list, tuple)):
            return [shape(v) for v in a] if len(a) <= 4 else f"{len(a)} x {shape(a[0])}"
        return tuple(a.shape) if hasattr(a, "shape") else a

    where = "" if out is None else f", out at float offset {out.storage_offset()}"
    within = err == 0.0 if tol is None else bool(((got - want).abs() <= tol).all())
    stated = "0" if tol is None else f"elementwise, largest {float(tol.max()):.6g}"
    say(tag, f"kernels: {name} [{label}] args {[shape(a) for a in args]} {kw}{where}: "
             f"max |kernel - plain| = {err} (tolerance {stated}): {within}")
    check(within, f"{name} [{label}] disagrees with its plain version: {err}")
    return err


def out_view(torch, rows: int, d: int, offset: int, dev, fill: float = 7777.0):
    """A contiguous ``(rows, d)`` float32 view starting ``offset`` floats
    into a buffer filled with ``fill``: what ``out[k_lo:k_hi]`` of a larger
    output looks like to a kernel."""
    buf = torch.full((rows * d + offset + 5,), fill, device=dev)
    return buf[offset: offset + rows * d].view(rows, d)


class SegCase(NamedTuple):
    label: str
    data: object
    ids: object
    num_segments: int
    out_rows: int | None  # out= slice this many rows into a larger output


def kernel_cases(torch, dev):
    """Edge cases per kernel, integer-valued float32.  Segment kernels:
    empty input, ids out of range on both ends, one segment, a segment
    count that is a multiple of nothing, all-empty segments (narrow and
    wide); widths 1, 2, 3, 5, 33, 2250, 4097 and 4500; ``out=`` slices at
    odd row offsets (not 16-byte aligned) and input rows that are a slice
    too; many tiles with empty tiles between runs; a run longer than a
    tile, than a marking batch and than the unroll; runs across tile and
    column-slab boundaries; thousands of tiles."""
    g = torch.Generator(device="cpu").manual_seed(7)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g).to(dev)

    def sorted_ids(n, lo, hi):
        return torch.sort(ints(lo, hi, (n,))).values.contiguous()

    def data(n, d, skip=0):
        return ints(-50, 50, (n + skip, d)).float()[skip:]

    seg = []
    for n, d, s, id_lo, id_hi, out_rows in [
        (0, 4, 5, 0, 5, None),  # empty input
        (300, 1, 17, -4, 21, None),  # out of range on both ends, width 1
        (257, 33, 1, 0, 1, None),  # one segment, width 33
        (1000, 33, 97, -2, 100, None),  # 97 segments, width 33
        (40, 3, 11, 11, 20, None),  # every id out of range: all segments empty
        (300, 1, 17, -4, 21, 3),
        (500, 2, 50, 0, 50, 1),
        (500, 3, 50, -1, 52, 5),
        (700, 5, 61, 0, 61, 7),
        (2000, 2250, 150, -2, 152, 1),  # slabs of 752, 8-byte aligned out
        (1200, 4500, 300, -3, 305, None),  # slabs of 900, 16-byte vectors
        (1500, 4500, 97, 0, 97, 3),
        (3000, 4097, 20, 0, 20, 1),  # odd width: one column per thread
        (500, 2250, 30, 30, 60, 1),  # every id out of range, wide
        (50_000, 1, 9000, 0, 9000, None),  # dense runs across two tiles
        (100_000, 1, 30_000_000, 0, 30_000_000, None),  # 1,832 narrow tiles
        (3000, 4500, 1000, 0, 1000, None),  # 2,500 tiles x slabs
    ]:
        seg.append(SegCase(f"n={n} d={d} s={s} ids [{id_lo}, {id_hi})",
                           data(n, d), sorted_ids(n, id_lo, id_hi), s, out_rows))
    # input rows that are themselves a slice (8-byte aligned rows at d=2250)
    seg.append(SegCase("data rows sliced, d=2250", data(800, 2250, skip=1),
                       sorted_ids(800, 0, 90), 90, None))
    # three clusters of ids in 100,000 segments: tiles of 8,192 empty rows
    for d, out_rows in ((1, None), (2, 1)):
        centers = torch.tensor([5, 70_000, 99_999], device=dev)
        ids = torch.sort(centers[ints(0, 3, (4000,))] + ints(-2, 1, (4000,))).values
        seg.append(SegCase(f"clustered ids, 100000 segments, d={d}", data(4000, d),
                           ids.clamp(0, 99_999).contiguous(), 100_000, out_rows))
    # one run longer than a narrow tile's rows, a marking batch and the unroll
    for d, n in ((1, 20_000), (2250, 3000)):
        ids = torch.cat([torch.full((n,), 3, device=dev), sorted_ids(97, 0, 20)])
        seg.append(SegCase(f"one run of {n} edges, d={d}", data(n + 97, d),
                           torch.sort(ids).values.contiguous(), 20, 2))
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


def gather_cases(torch, dev):
    """Edge cases of the slab-major warp walk (``csrc/gathered_rows.cuh``)
    that ``coo_spmm`` and one-child ``fused_hop`` hops of width >= 32 run
    on, as (label, kernel name, args, out offset or None): d % 4 != 0,
    d below the slab width and one past it, mostly empty rows, one run of
    thousands of edges, operand rows out of range, ±inf child rows for
    MIN/MAX, and operand and output pointers 4 or 8 bytes past a 16-byte
    boundary (scalar and 8-byte lanes).  Integer-valued float32."""
    from repro_torch.kernels import ops

    g = torch.Generator(device="cpu").manual_seed(17)
    slab = ops.GATHER_SLAB

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g).to(dev)

    def operand(rows, d, offset, lo=-3, hi=4):
        """(rows, d) integers starting ``offset`` floats into a buffer."""
        buf = ints(lo, hi, (rows * d + offset,)).float()
        return buf[offset:].view(rows, d)

    cases = []
    for n, s, rows, d, offset, key_lo, key_hi, label in [
        (20_000, 300, 500, 4500, 0, 0, 300, "d=4500"),
        (5000, 97, 200, 130, 0, 0, 97, "d % 4 != 0"),
        (4000, 60, 90, slab - 28, 0, 0, 60, "d < slab width"),
        (4000, 60, 90, slab + 1, 0, -3, 63, "d = slab width + 1, keys out of range"),
        (600, 30_000, 90, 256, 0, 0, 30_000, "mostly empty rows"),
        (5000, 97, 200, 512, 1, 0, 97, "pointers 4 bytes past 16"),
        (5000, 97, 200, 512, 2, 0, 97, "pointers 8 bytes past 16"),
    ]:
        keys = torch.sort(ints(key_lo, key_hi, (n,))).values.contiguous()
        cols = ints(-2, rows + 2, (n,))  # some out of range
        vals = ints(1, 9, (n,)).float()
        cases.append((f"gather walk, {label}", "coo_spmm",
                      (keys, cols, vals, operand(rows, d, offset), s), offset))
        for kind, k in (("sum", 1), ("sum", 2), ("sum", 3), ("min", 1), ("max", 1)):
            dk = d - d % k
            w = ints(0, 4 if kind == "sum" else 50, (n, k)).float()
            msg = operand(rows, dk, offset)
            if kind != "sum":
                msg[ints(0, rows, (5,))] = float("inf" if kind == "min" else "-inf")
            cases.append((f"gather walk, {label}, {kind} k={k}", "fused_hop",
                          (keys, w, [msg], [cols], s, k, kind), offset))
    long = torch.sort(torch.cat([torch.full((6000,), 2, device=dev), ints(0, 9, (50,))])).values
    cols = ints(-1, 41, (long.shape[0],))
    cases.append(("gather walk, one run of 6000 edges", "coo_spmm",
                  (long.contiguous(), cols, ints(1, 3, cols.shape).float(),
                   operand(40, 300, 0, -1, 2), 9), 0))
    for kind in ("sum", "min", "max"):
        cases.append((f"gather walk, one run of 6000 edges, {kind}", "fused_hop",
                      (long.contiguous(), ints(0, 3, (cols.shape[0], 1)).float(),
                       [operand(40, 300, 0, -1, 2)], [cols], 9, 1, kind), 0))
    return cases


def gather_phase(torch, tag) -> dict[str, list[float]]:
    """``coo_spmm`` and ``fused_hop`` on the slab-major warp walk's edge
    cases against their plain versions, ``out=`` at the case's alignment;
    returns each kernel's errors."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.coo_spmm import coo_spmm
    from repro_torch.kernels.fused_hop import fused_hop

    dev = torch.device("cuda")
    kernels = {"coo_spmm": (coo_spmm, ref.coo_spmm), "fused_hop": (fused_hop, ref.fused_hop)}
    errs = {name: [] for name in kernels}
    for label, name, args, offset in gather_cases(torch, dev):
        kernel, plain = kernels[name]
        s = args[4]
        d = args[3].shape[1] if name == "coo_spmm" else args[2][0].shape[1]
        errs[name].append(compare(torch, tag, name, label, kernel, plain, args,
                                  out=out_view(torch, s, d, offset, dev)))
    return errs


def segment_regime(torch, tag, name, label, launch, path="main path"):
    """One captured ``segment_sum`` / ``segment_reduce`` launch: held
    against its plain version with ``out=`` at the launch's own alignment,
    and timed beside the plain version, the library call and the bound."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.segment_reduce import segment_reduce
    from repro_torch.kernels.segment_sum import segment_sum

    dev = torch.device("cuda")
    data, ids, s = launch.args[:3]
    n, d = data.shape
    kind = launch.kw.get("kind")
    out = out_view(torch, s, d, launch.offset, dev)
    if name == "segment_sum":
        args = (data, ids, s)
        kernel, plain = segment_sum, ref.segment_sum

        def library():
            return torch.zeros((s, d), device=dev).index_add_(0, ids, data)
    else:
        args = (data, ids, s, kind)
        kernel, plain = segment_reduce, ref.segment_reduce
        red = "amin" if kind == "min" else "amax"
        ident = float("inf") if kind == "min" else float("-inf")
        index = ids[:, None].expand(n, d)

        def library():
            return torch.full((s, d), ident, device=dev).scatter_reduce_(
                0, index, data, red, include_self=True
            )
    err = compare(torch, tag, name, f"{path}, {label}", kernel, plain, args, out=out)
    b, by = bound(n * d * 4 + n * 8 + s * d * 4, n * d)
    row = dict(
        shapes={"data": [n, d], "segment_ids": [n], "num_segments": s,
                **({"kind": kind} if kind else {})},
        launches=launch.count, out_offset=launch.offset, max_abs_err=err,
        ms=time_ms(torch, lambda: kernel(*args, out=out)),
        plain_ms=time_ms(torch, lambda: plain(*args)),
        library_ms=time_ms(torch, library),
        bound_ms=b, bound_by=by,
    )
    say(tag, f"kernels: {name} [{label}] at {row['shapes']}, out offset "
             f"{launch.offset}, {launch.count} launches of this width: "
             f"{row['ms']:.4f} ms, bound {b:.4f} ms by {by}, plain "
             f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms")
    return row


def kernel_phase(torch, tag, captured):
    """The three kernels of the unfused main path on edge cases and at
    their largest launch; ``segment_sum`` and ``segment_reduce`` also at
    the largest launch of their widest rows (the edge-chunk shape)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.coo_spmm import coo_spmm
    from repro_torch.kernels.segment_reduce import segment_reduce
    from repro_torch.kernels.segment_sum import segment_sum

    dev = torch.device("cuda")
    seg_cases, spmm_cases = kernel_cases(torch, dev)
    results = {}

    # --- segment_sum and segment_reduce ---------------------------------
    for name in SEGMENT_KERNELS:
        errs = []
        for case in seg_cases:
            kinds = (None,) if name == "segment_sum" else ("min", "max")
            for kd in kinds:
                args = (case.data, case.ids, case.num_segments) + ((kd,) if kd else ())
                out = None if case.out_rows is None else out_view(
                    torch, case.num_segments + case.out_rows, case.data.shape[1], 0, dev
                )[case.out_rows:]
                kernel, plain = ((segment_sum, ref.segment_sum) if kd is None
                                 else (segment_reduce, ref.segment_reduce))
                errs.append(compare(torch, tag, name, f"edge {case.label} {kd or ''}",
                                    kernel, plain, args, out=out))
        launches = {key[1]: lc for key, lc in captured.items()
                    if isinstance(key, tuple) and key[0] == name}
        leaf = max(launches.values(), key=lambda lc: lc.size)
        chunk = launches[max(launches)]
        regimes = {"leaf": segment_regime(torch, tag, name, "largest launch", leaf),
                   "chunk": segment_regime(torch, tag, name, "widest rows", chunk)}
        row = dict(regimes["leaf"])
        row.update(
            max_abs_err=max(errs + [r["max_abs_err"] for r in regimes.values()]),
            regimes=regimes,
            launches_by_width={str(d): lc.count for d, lc in sorted(launches.items())},
        )
        results[name] = row

    # --- coo_spmm ------------------------------------------------------
    args = captured["coo_spmm"].args
    rows, cols, vals, dense, s = args
    errs = [compare(torch, tag, "coo_spmm", "main path", coo_spmm, ref.coo_spmm, args)]
    for a, k in spmm_cases:
        errs.append(compare(torch, tag, "coo_spmm", "edge", coo_spmm, ref.coo_spmm,
                            a, k))
    nnz = rows.shape[0]
    kdense, w = dense.shape
    used = int(torch.unique(cols).numel())
    b, by = bound(nnz * 20 + used * w * 4 + s * w * 4, 2 * nnz * w)
    results["coo_spmm"] = dict(
        shapes={"rows": [nnz], "dense": [kdense, w], "num_rows": s,
                "dense_rows_used": used},
        walk=repr(ops.gather_plan(nnz, s, w)),
        max_abs_err=max(errs),
        ms=time_ms(torch, lambda: coo_spmm(rows, cols, vals, dense, s)),
        plain_ms=time_ms(torch, lambda: ref.coo_spmm(rows, cols, vals, dense, s), reps=3),
        library_ms=csr_spmm_ms(torch, rows, cols, vals, dense, s),
        bound_ms=b, bound_by=by,
    )
    r = results["coo_spmm"]
    say(tag, f"kernels: coo_spmm [main path] at {r['shapes']}: {r['ms']:.4f} ms, bound "
             f"{b:.4f} ms by {by}, plain {r['plain_ms']:.4f} ms, library torch.sparse.mm "
             f"{r['library_ms']:.4f} ms; {r['walk']}")
    return results


def csr_spmm_ms(torch, rows, cols, vals, dense, num_rows) -> float:
    """Time of ``torch.sparse.mm`` with the (rows, cols, vals) matrix in
    CSR form, built outside the timed calls."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mat = torch.sparse_coo_tensor(
            torch.stack([rows, cols]), vals, (num_rows, dense.shape[0])
        ).coalesce().to_sparse_csr()
        return time_ms(torch, lambda: torch.sparse.mm(mat, dense))


def fused_hop_cases(torch, dev):
    """Edge cases of ``fused_hop`` as (label, args): zero edges, one
    segment, leaf hops, two, three, five and 64 children, ±inf child rows
    for min/max, an output row wider than one 4096-float tile, a key run
    of 5000 edges, keys and child indices out of range.  Integer-valued
    float32 whose products and sums stay below 2**24."""
    g = torch.Generator(device="cpu").manual_seed(11)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g).to(dev)

    def hop(n, s, k, kind, widths, rows=9, lo=-3, hi=4, inf_rows=0, key_lo=0,
            key_hi=None, idx_hi=None):
        keys = torch.sort(ints(key_lo, s if key_hi is None else key_hi, (n,))).values
        w = ints(0, 4 if kind == "sum" else 50, (n, k)).float()
        msgs, idxs = [], []
        for wc in widths:
            msg = ints(lo, hi, (rows, wc * k)).float()
            if inf_rows:
                msg[ints(0, rows, (inf_rows,))] = float("inf" if kind == "min" else "-inf")
            msgs.append(msg.contiguous())
            idxs.append(ints(0, rows if idx_hi is None else idx_hi, (n,)))
        return (keys.contiguous(), w, msgs, idxs, s, k, kind)

    cases = []
    for kind, k in (("sum", 2), ("min", 1), ("max", 1)):
        cases += [
            (f"{kind} zero edges", hop(0, 5, k, kind, (2, 3))),
            (f"{kind} one segment", hop(400, 1, k, kind, (4,))),
            (f"{kind} leaf", hop(1000, 37, k, kind, ())),
            (f"{kind} two children", hop(1000, 37, k, kind, (3, 5))),
            (f"{kind} three children", hop(1000, 37, k, kind, (2, 3, 4))),
            (f"{kind} five children", hop(500, 13, k, kind, (2, 1, 3, 2, 2), lo=-1, hi=2)),
            (f"{kind} 64 children", hop(300, 7, k, kind, (1,) * 64, lo=-1, hi=2)),
            (f"{kind} row of 5600 floats", hop(600, 5, k, kind, (70, 80 // k))),
            (f"{kind} one run of 5000 edges", hop(5000, 1, k, kind, (33,), lo=-1, hi=2)),
            (f"{kind} keys and indices out of range",
             hop(800, 19, k, kind, (3, 2), key_lo=-3, key_hi=23, idx_hi=11)),
        ]
    for kind in ("min", "max"):
        cases.append((f"{kind} ±inf child rows", hop(1000, 37, 1, kind, (3, 4), inf_rows=4)))
    return cases


def fused_library(torch, args, uniform: bool):
    """The one PyTorch call that computes a ``fused_hop`` launch, by hop
    class, and its time: ``index_add_`` for a leaf sum, ``scatter_reduce_``
    for a leaf min/max, a CSR ``torch.sparse.mm`` for a single-child
    channel-uniform sum; ``(None, None)`` where no one call does."""
    keys, w, msgs, idxs, s, k, kind = args
    dev = keys.device
    if not msgs and kind == "sum":
        return "index_add_", time_ms(
            torch, lambda: torch.zeros((s, k), device=dev).index_add_(0, keys, w))
    if not msgs:
        ident = float("inf") if kind == "min" else float("-inf")
        return f"scatter_reduce_ a{kind}", time_ms(
            torch, lambda: torch.full((s, 1), ident, device=dev).scatter_reduce_(
                0, keys[:, None], w, f"a{kind}", include_self=True))
    if len(msgs) == 1 and kind == "sum" and uniform:
        return "torch.sparse.mm, CSR", csr_spmm_ms(
            torch, keys, idxs[0], w[:, 0].contiguous(), msgs[0], s)
    return None, None


def fused_phase(torch, tag, captured):
    """``fused_hop`` against its plain version at the largest launch of
    each hop class of the fused path and on edge cases; each class timed
    beside its three-dispatch counterpart.  The JSON row is the
    single-child channel-uniform sum hop, the hop ``coo_spmm`` runs on
    the unfused path, where ``torch.sparse.mm`` computes the same."""
    from repro_torch.core import torch_engine
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.fused_hop import fused_hop, gathers_one_child

    dev = torch.device("cuda")
    errs = []
    for label, args in fused_hop_cases(torch, dev):
        errs.append(compare(torch, tag, "fused_hop", label, fused_hop, ref.fused_hop, args))
    hops = []
    for (kind, nchild, uniform), launch in sorted(captured.items()):
        args = launch.args
        keys, w, msgs, idxs, s, k, _ = args
        label = f"main path {kind}, {nchild} children, uniform={uniform}"
        errs.append(compare(torch, tag, "fused_hop", label, fused_hop, ref.fused_hop, args))
        n = keys.shape[0]
        width = 1
        nbytes = n * 8 + n * k * 4
        for msg, idx in zip(msgs, idxs):
            width *= msg.shape[1] // k
            used = int(torch.unique(idx).numel())
            nbytes += n * 8 + used * msg.shape[1] * 4
        nbytes += s * width * k * 4
        b, by = bound(nbytes, n * width * k * (nchild + 1))
        keys_host = keys.cpu().numpy()
        gathers = [(m.view(m.shape[0], -1, k), i) for m, i in zip(msgs, idxs)]
        library, library_ms = fused_library(torch, args, uniform)
        hop = dict(
            kind=kind, children=nchild, uniform=uniform,
            shapes={"edges": n, "k": k, "num_segments": s,
                    "messages": [list(m.shape) for m in msgs]},
            walk=repr(ops.gather_plan(n, s, width * k) if gathers_one_child(nchild, width * k)
                      else ops.walk_plan(n, s, width * k)),
            ms=time_ms(torch, lambda: fused_hop(*args)),
            three_dispatch_ms=time_ms(
                torch,
                lambda: torch_engine.contract_hop(
                    keys, keys_host, w, gathers, s, kind, False, uniform
                ),
                reps=3,
            ),
            plain_ms=time_ms(torch, lambda: ref.fused_hop(*args), reps=3),
            library=library, library_ms=library_ms, bound_ms=b, bound_by=by,
        )
        hops.append(hop)
        say(tag, f"kernels: fused_hop [{label}] at {hop['shapes']}: {hop['ms']:.4f} ms, "
                 f"three-dispatch {hop['three_dispatch_ms']:.4f} ms, bound "
                 f"{b:.4f} ms by {by}, plain {hop['plain_ms']:.4f} ms, library "
                 f"{library} {library_ms if library_ms is None else f'{library_ms:.4f}'} ms; "
                 f"{hop['walk']}")
    check(hops, "no fused_hop launch captured")
    for kind in ("sum", "min", "max"):
        check(any(h["kind"] == kind for h in hops), f"fused path ran no {kind} hop")
    check(any(h["kind"] == "sum" and h["shapes"]["k"] > 1 for h in hops),
          "fused path ran no sum hop with k > 1")
    row = max(
        (h for h in hops if h["kind"] == "sum"),
        key=lambda h: (h["children"] == 1 and h["uniform"], h["ms"]),
    )
    return dict(row, max_abs_err=max(errs), hops=hops)


def semiring_floor(semiring: str, m: int, kd: int, n: int) -> float:
    """ms of the instructions the tile loop must issue for one launch:
    ``add_mul`` one FMA per step, the tropical semirings an add and a
    max/min per step, ``or_and`` one logic operation per packed word."""
    if semiring == "or_and":
        return -(-kd // 32) * m * n / LOGIC_OPS_PER_S * 1e3
    steps = m * kd * n * (1 if semiring == "add_mul" else 2)
    return steps / FP32_INSTR_PER_S * 1e3


def semiring_bound(semiring: str, m: int, kd: int, n: int) -> tuple[float, str]:
    """Bytes (A and B read once, C written once) against the operations:
    2 m kd n float32 operations, or for ``or_and`` one 32-bit logic
    operation per word of 32 packed values of k."""
    nbytes = (m * kd + kd * n + m * n) * 4
    if semiring != "or_and":
        return bound(nbytes, 2 * m * kd * n)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = semiring_floor(semiring, m, kd, n)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def semiring_phase(torch, tag, size: int = 2048):
    """``semiring_matmul`` against its plain version for every semiring,
    tolerance 0: at (size, size) x (size, size) on small integers and on
    fractional values, at (3000, 1000) x (1000, 2500) fractional, on ragged
    shapes with ±inf entries, with ±inf only in the last values of k, and
    with operands 4 and 8 bytes off 16-byte alignment; timed beside
    ``torch.matmul`` in full float32 (TF32 off) for ``add_mul``, with each
    semiring's bound and instruction floor."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.semiring_matmul import SEMIRINGS, semiring_matmul

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(13)

    def ints(shape, infs=0.0):
        x = torch.randint(-3, 4, shape, generator=g).float()
        if infs:
            pick = torch.rand(shape, generator=g)
            x[pick < infs / 2] = float("inf")
            x[(pick >= infs / 2) & (pick < infs)] = float("-inf")
        return x.to(dev)

    def fractions(shape, offset=0):
        """Normal floats; ``offset`` floats into a larger buffer."""
        buf = torch.randn(offset + shape[0] * shape[1], generator=g).to(dev)
        return buf[offset:].view(shape)

    def tail_infs(m, kd, n, last=5):
        a, b = fractions((m, kd)), fractions((kd, n))
        for x in (a[:, -last:], b[-last:]):
            pick = torch.rand(x.shape, generator=g).to(dev)
            x[pick < 0.25] = float("inf")
            x[(pick >= 0.25) & (pick < 0.5)] = float("-inf")
        return a, b

    errs = []

    def hold(semiring, label, a, b):
        plan = ops.matmul_plan(a.shape[0], b.shape[1], a.shape[1], semiring,
                               align=ops.alignment(a, b))
        errs.append(compare(torch, tag, "semiring_matmul", f"{semiring} {label}, vec "
                            f"{plan.vec}", semiring_matmul, ref.semiring_matmul,
                            (a, b, semiring)))

    a, b = ints((size, size)), ints((size, size))
    fa, fb = fractions((size, size)), fractions((size, size))
    ra, rb = fractions((3000, 1000)), fractions((1000, 2500))
    for semiring in SEMIRINGS:
        hold(semiring, "main shape", a, b)
        hold(semiring, "main shape, fractional", fa, fb)
        hold(semiring, "rectangular, fractional", ra, rb)
        for m, kd, n, infs in [(65, 33, 129, 0.0), (1, 1, 1, 0.0), (100, 0, 7, 0.0),
                               (3, 1000, 5, 0.0), (130, 70, 66, 0.1)]:
            hold(semiring, f"ragged, inf share {infs}", ints((m, kd), infs),
                 ints((kd, n), infs))
        hold(semiring, "ragged, ±inf in the last 5 values of k", *tail_infs(257, 77, 263))
        for offset in (1, 2):
            hold(semiring, f"operands {4 * offset} bytes off 16-byte alignment",
                 fractions((256, 512), offset), fractions((512, 384), offset))
    times = {}
    for semiring in SEMIRINGS:
        b_ms, by = semiring_bound(semiring, size, size, size)
        times[semiring] = dict(
            ms=time_ms(torch, lambda: semiring_matmul(a, b, semiring)),
            plain_ms=time_ms(torch, lambda: ref.semiring_matmul(a, b, semiring), reps=2),
            bound_ms=b_ms, bound_by=by, floor_ms=semiring_floor(semiring, size, size, size),
            library_ms=time_ms(torch, lambda: torch.matmul(a, b)) if semiring == "add_mul" else None,
            plan=repr(ops.matmul_plan(size, size, size, semiring, align=ops.alignment(a, b))),
        )
    for semiring, t in times.items():
        say(tag, f"kernels: semiring_matmul {semiring} at ({size}, {size}) x ({size}, "
                 f"{size}): {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
                 f"{t['bound_ms']:.4f} ms by {t['bound_by']}, instruction floor "
                 f"{t['floor_ms']:.4f} ms, {t['plan']}")
    say(tag, f"kernels: semiring_matmul library torch.matmul (float32, TF32 off) "
             f"{times['add_mul']['library_ms']:.4f} ms")
    main = times["add_mul"]
    return dict(
        shapes={"a": [size, size], "b": [size, size], "semiring": "add_mul"},
        max_abs_err=max(errs), ms=main["ms"], plain_ms=main["plain_ms"],
        library_ms=main["library_ms"], bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        semirings=times,
    )


# ----------------------------------------------------------------------
# the two paths
# ----------------------------------------------------------------------


def drive(torch, tag, label, make_plan):
    """Plan, then execute cold and warm with the launch counts set to 0
    just before the cold execute and read just after; print the times,
    peak device memory, warm split, host profile and device idle share."""
    from repro_torch.api import plan as plan_mod
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    plan = make_plan()
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0
    stream = plan.resolved_stream()
    say(tag, f"{label}: {plan}; fused={plan.fused}; statistics {plan.stats_enabled}; "
             f"prepare {prepare_s:.3f} s; est peak message {plan.message_peak} B, "
             f"est peak {plan.est_peak} B; stream tile {stream}")

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = plan.execute()
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    say(tag, f"{label}: cold execute {cold_s:.3f} s, launches {launches}")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = plan.execute()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    say(tag, f"{label}: warm execute {warm_s:.3f} s, result rows "
             f"{res.num_rows}, peak device memory {peak} B ({peak - resident} B "
             f"above the {resident} B allocated before planning)")

    t0 = time.perf_counter()
    outputs = plan.outputs()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan_mod._assemble(plan, outputs)
    assemble_s = time.perf_counter() - t0
    say(tag, f"{label}: warm split: engine.run {run_s:.3f} s, assemble "
             f"{assemble_s:.3f} s")

    host = cProfile.Profile()
    host.enable()
    plan.execute()
    torch.cuda.synchronize()
    host.disable()
    stats = pstats.Stats(host)
    say(tag, f"host profile: {label}, warm execute, {stats.total_tt:.3f} s of Python "
             "profile time; top functions by own time:")
    rows = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:12]
    for (file, line, fn), (_, calls, tottime, cumtime, _) in rows:
        say(tag, f"host profile: {tottime * 1e3:9.1f} ms own {cumtime * 1e3:9.1f} ms "
                 f"cum x{calls:<6d} {fn} ({Path(file).name}:{line})")

    wall, busy, top = idle_share(torch, plan.execute)
    say(tag, f"profile: {label}, warm execute {wall:.3f} s wall, device busy "
             f"{busy:.3f} s, idle share {1 - busy / wall:.3f}")
    for name, ms, cnt in top:
        say(tag, f"profile: {ms:10.3f} ms x{cnt:<6d} {name[:140]}")
    summary = {
        "prepare_s": prepare_s, "cold_execute_s": cold_s, "warm_execute_s": warm_s,
        "engine_run_s": run_s, "assemble_s": assemble_s, "rows": res.num_rows,
        "peak_bytes": peak, "peak_above_resident_bytes": peak - resident,
        "est_peak_bytes": plan.est_peak, "stream": stream, "device_busy_s": busy,
        "idle_share": 1 - busy / wall, "launches": launches,
    }
    return plan, res, summary


def same_result(a, b) -> bool:
    import numpy as np

    return list(a.relation.columns) == list(b.relation.columns) and all(
        a.column(c).dtype == b.column(c).dtype and np.array_equal(a.column(c), b.column(c))
        for c in a.relation.columns
    )


HOP_KERNELS = ("segment_sum", "coo_spmm", "fused_hop")


def verified(tag, label, plan) -> None:
    """Fail if ``plan.verify()`` finds any broken invariant.  V-OVERFLOW
    is printed and let pass: it compares a sketch estimate of a subtree's
    join rows with 2**24, and every leg checks its counts against an
    exact count itself (exact below 2**24, ``count_rtol`` above)."""
    diags = plan.verify(strict=False)
    say(tag, f"check: {label}: verify() on {plan}: {len(diags)} finding(s) "
             f"{[str(d) for d in diags]}")
    check(all(d.code == "V-OVERFLOW" for d in diags),
          f"{label}: the plan breaks its invariants")


def run_paths(plan) -> list[tuple[str, object]]:
    """``(label, choose_path's choice)`` for every ``engine.run`` of
    ``plan.execute()``: one, or one per key range of a split plan (no
    budget there, as the JAX package's ``execute_split`` runs them)."""
    from repro_torch.core.torch_engine import choose_path

    cm = tuple(ch.measure[0] if ch.kind == "sum" else None for ch in plan.channels)
    k = len(plan.channels)
    if plan.split is None:
        runs = [("plan", plan.prep, plan.resolved_stream(), plan.memory_budget)]
    else:
        attr = plan.split.attr
        parts = plan.split_parts()
        runs = [(f"key range {i} of {len(parts)} ({part.dicts[attr].size} keys of {attr})",
                 part, None, None) for i, part in enumerate(parts)]
    return [(label, choose_path(prep, k=k, memory_budget=budget, stream=stream, measured=cm))
            for label, prep, stream, budget in runs]


def check_paths(tag, label, plan, launches) -> list[str]:
    """Print each run's ``torch path:`` line and check, through the
    launches, that the run took ``choose_path``'s path, or the one that
    ``mode=`` or ``.fused(True)`` pins: no hop kernel when every run is
    dense, some when any is sparse.  Returns the paths."""
    mode = plan.engine.mode
    pin = mode if mode != "auto" else ("sparse" if plan.fused is True else None)
    paths = []
    for run, choice in run_paths(plan):
        path = pin or choice.path
        say(tag, f"{label}: {run}: torch path: {choice.path} — {choice.reason}; runs "
                 f"{path}{' (pinned)' if pin else ''}")
        paths.append(path)
    hops = sum(launches[name] for name in HOP_KERNELS)
    if "sparse" in paths:
        check(hops > 0, f"{label}: a sparse run launched no hop kernel")
    else:
        check(hops == 0, f"{label}: a dense run launched hop kernels: {launches}")
    return paths


def check_launch_shapes(torch, tag, label, plan) -> None:
    """Execute a fused plan once with a spy on ``ops.walk_plan`` and
    ``ops.gather_plan`` and hold the launch shapes its ``fused_hop``
    launches were given against what ``explain`` prints and V-KERN
    checks (``plan.fused_runs()`` × ``hop_launch_shapes``), pass by
    pass: per key range, per stream tile, MIN/MAX passes."""
    from repro_torch.core.torch_engine import hop_launch_shapes
    from repro_torch.kernels import ops

    made = []
    real = {"tile": ops.walk_plan, "gather": ops.gather_plan}

    def spy(walk):
        def wrapped(n, rows, d):
            p = real[walk](n, rows, d)
            made.append((walk, n, rows, d, bytes(p)))
            return p

        return wrapped

    ops.walk_plan, ops.gather_plan = spy("tile"), spy("gather")
    try:
        plan.execute()
        torch.cuda.synchronize()
    finally:
        ops.walk_plan, ops.gather_plan = real["tile"], real["gather"]
    passes = []
    for r in plan.fused_runs():
        one = sorted((e["walk"], e["edges"], e["num_segments"], e["width"], bytes(e["plan"]))
                     for e in hop_launch_shapes(r["prep"], r["k"], r["encoded"], r["domains"]))
        passes.extend([one] * r["repeat"])
    got, at = [], 0
    for one in passes:
        got.append(sorted(made[at:at + len(one)]))
        at += len(one)
    same = at == len(made) and got == passes
    say(tag, f"check: {label}: {len(made)} fused_hop launch shapes made on the card in "
             f"{len(passes)} passes equal fused_runs() x hop_launch_shapes: {same}")
    check(same and made, f"{label}: the launch shapes explain prints are not the launched ones")


# ----------------------------------------------------------------------
# the split leg and the cyclic leg
# ----------------------------------------------------------------------

CYCLIC_SIZES = {"TRIANGLE": 40_000, "FOURCYCLE": 20_000, "FOFGROUP": 40_000}
CYCLIC_CHECK_N = 4000
F32_UNIT = 2.0 ** -24  # float32 unit roundoff


def skew_total(db) -> int:
    """Σ COUNT of SKEWCHAIN's R1 ⋈ R2 in int64, without the port:
    Σ over p0 of c1[p0] · c2[p0]."""
    import numpy as np

    c1 = np.bincount(db["R1"].columns["p0"]).astype(np.int64)
    c2 = np.bincount(db["R2"].columns["p0"]).astype(np.int64)
    m = min(len(c1), len(c2))
    return int((c1[:m] * c2[:m]).sum())


def cyclic_counts(name: str, db) -> dict:
    """Per-group COUNT of a cyclic catalog query in int64 with
    ``scipy.sparse``, without the port: {group value: count} for every
    group with a nonzero count."""
    import numpy as np
    from scipy import sparse

    def mat(rel, a, b, rows=None, cols=None):
        x, y = db[rel].columns[a], db[rel].columns[b]
        shape = (rows or int(x.max()) + 1, cols or int(y.max()) + 1)
        return sparse.csr_matrix((np.ones(len(x), np.int64), (x, y)), shape=shape)

    if name in ("TRIANGLE", "FOURCYCLE"):
        v = len(db["L"].columns["a"])  # vertex ids are 0 .. v-1
        a1 = mat("E1", "a", "b", v, v)
        a2 = mat("E2", "b", "c", v, v)
        if name == "TRIANGLE":
            per_a = (a1 @ a2).multiply(mat("E3", "c", "a", v, v).T)
            label = "vlabel"
        else:
            back = mat("E3", "c", "d", v, v) @ mat("E4", "d", "a", v, v)
            per_a = (a1 @ a2).multiply(back.T)
            label = "lab"
        per_a = np.asarray(per_a.sum(axis=1)).ravel()
        node, labels = db["L"].columns["a"], db["L"].columns[label]
        out: dict = {}
        for lab, cnt in zip(labels.tolist(), per_a[node].tolist()):
            out[lab] = out.get(lab, 0) + int(cnt)
    else:  # FOFGROUP: diag(G1ᵀ (F1 @ F2) G2)
        people = 1 + max(int(db[r].columns[a].max()) for r, a in (
            ("F1", "u"), ("F1", "v"), ("F2", "v"), ("F2", "w"), ("G1", "u"), ("G2", "w")))
        groups = 1 + max(int(db[r].columns["grp"].max()) for r in ("G1", "G2"))
        f = mat("F1", "u", "v", people, people) @ mat("F2", "v", "w", people, people)
        m = f @ mat("G2", "w", "grp", people, groups)
        per_grp = np.asarray(mat("G1", "u", "grp", people, groups).multiply(m).sum(axis=0)).ravel()
        grp_values = np.arange(groups)
        out = dict(zip(grp_values.tolist(), (int(c) for c in per_grp)))
    return {k: c for k, c in out.items() if c}


def count_rtol(plan) -> float:
    """Relative tolerance of a float32 COUNT against the exact count.  Every
    weight is positive.  A hop rounds each edge weight once, multiplies by
    one gathered value per child (one rounding each) and adds at most the
    relation's edges into a key (one rounding per addition), each rounding
    at most 2**-24 relative; the errors of the hops compound, so their
    counts add to first order: Σ over the decomposition's relations of
    (edges + children + 1) × 2**-24."""
    deco = plan.prep.decomposition
    steps = sum(plan.prep.encoded[r].num_rows + len(deco.nodes[r].children) + 1
                for r in deco.order)
    return steps * F32_UNIT


def split_leg(torch, tag, args) -> dict:
    """SKEWCHAIN at ``--n``: the default plan (statistics on, split on p0)
    and the ``.stats(False)`` plan, driven and compared."""
    import numpy as np

    from repro_torch.api import Q, TorchChannelEngine
    from repro_torch.data.queries import skewed_chain_like
    from repro_torch.kernels import ops

    db, q = skewed_chain_like(args.n, seed=args.seed)
    dom = len(np.unique(np.concatenate([db["R1"].columns["p0"], db["R2"].columns["p0"]])))
    hot = float((db["R1"].columns["p0"] == 0).mean())
    say(tag, f"data: SKEWCHAIN n={args.n} seed={args.seed}: {dom} distinct p0 values, "
             f"{len(np.unique(db['R1'].columns['g1']))} group values, R1 share on p0=0 "
             f"{hot:.4f}")
    splan, sres, split = drive(torch, tag, "split leg", lambda: Q.from_query(q).plan(db))
    d = splan.split
    check(d is not None, "statistics chose no split plan on SKEWCHAIN")
    say(tag, f"split leg: {d.describe()}; roots {list(d.roots)}; ranges {list(d.ranges)}")
    split["paths"] = check_paths(tag, "split leg", splan, split["launches"])
    uplan, ures, unsplit = drive(
        torch, tag, "split leg, stats(False)", lambda: Q.from_query(q).stats(False).plan(db)
    )
    check(uplan.split is None, "the stats(False) plan split")
    unsplit["paths"] = check_paths(tag, "split leg, stats(False)", uplan, unsplit["launches"])
    same = same_result(sres, ures)
    say(tag, f"check: split leg: split = unsplit bit for bit: {same}; peak device memory "
             f"above resident {split['peak_above_resident_bytes']} B split vs "
             f"{unsplit['peak_above_resident_bytes']} B unsplit")
    check(same, "split result differs from the unsplit result")
    pplan, pres, sparse = drive(
        torch, tag, "split leg, mode=sparse",
        lambda: Q.from_query(q).engine(TorchChannelEngine(mode="sparse")).plan(db),
    )
    sparse["paths"] = check_paths(tag, "split leg, mode=sparse", pplan, sparse["launches"])
    ranges = len(pplan.split_parts())
    same = same_result(sres, pres) and pplan.split == splan.split
    plaunches = sparse["launches"]
    say(tag, f"check: split leg, mode=sparse: {ranges} key ranges, launches {plaunches}; "
             f"bit-identical to the default split plan: {same}")
    check(same, "split leg: the sparse-pinned split result differs from the default one")
    check(plaunches["segment_sum"] >= ranges and plaunches["coo_spmm"] >= ranges,
          "split leg, mode=sparse: segment_sum or coo_spmm missed a key range")
    want = skew_total(db)
    got = sres.column("count").sum()
    say(tag, f"check: split leg: Σ count {got:.0f} vs numpy {want}")
    check(got == want and sres.num_rows > 0, "split leg: Σ count disagrees with numpy")

    fplan = Q.from_query(q).fused(True).plan(db)
    ops.reset_launch_counts()
    fres = fplan.execute()
    flaunches = ops.launch_counts()
    check_paths(tag, "split leg, fused", fplan, flaunches)
    say(tag, f"check: split leg, fused: launches {flaunches}; bit-identical to unfused: "
             f"{same_result(sres, fres)}")
    check(same_result(sres, fres), "fused split result differs from the unfused one")
    check(flaunches["fused_hop"] > 0 and all(flaunches[k] == 0 for k in UNFUSED_KERNELS),
          "the fused split plan did not run on fused_hop alone")
    check_launch_shapes(torch, tag, "split leg, fused", fplan)

    small, sq = skewed_chain_like(args.check_n, seed=args.seed)
    gplan = Q.from_query(sq).plan(small)
    cplan = Q.from_query(sq).engine(TorchChannelEngine(device="cpu")).plan(small)
    gpu, cpu = gplan.execute(), cplan.execute()
    same = same_result(gpu, cpu) and gplan.split is not None and cplan.split == gplan.split
    say(tag, f"check: split leg: SKEWCHAIN n={args.check_n}: split {gplan.split.describe()}; "
             f"{cpu.num_rows} rows bit-identical to device='cpu': {same}")
    check(same, "split leg: cuda result differs from cpu result")
    for p in (splan, uplan, pplan, fplan, gplan):
        verified(tag, "split leg", p)
    return {"split": split, "split, stats(False)": unsplit, "split, mode=sparse": sparse,
            "launches": {"split": split["launches"], "split, stats(False)": unsplit["launches"],
                         "split, mode=sparse": plaunches, "split, fused": flaunches}}


def cyclic_leg(torch, tag, args) -> dict:
    """TRIANGLE, FOURCYCLE and FOFGROUP through the GHD compiler: host
    bag build against warm execute on the card, each count against
    ``scipy.sparse``, each card result against the CPU's."""
    from repro_torch.api import Q, TorchChannelEngine
    from repro_torch.data.queries import CYCLIC
    from repro_torch.kernels import ops

    out = {"launches": {}}
    for name, n in CYCLIC_SIZES.items():
        db, q = CYCLIC[name](n, seed=args.seed)
        label = f"cyclic {name}"
        plan, res, summary = drive(torch, tag, label, lambda: Q.from_query(q).plan(db))
        g = plan.ghd_plan
        check(plan.cyclic and g is not None, f"{name} was not compiled through the GHD")
        secs = g.seconds
        bags = {b: bt.num_rows for b, bt in g.bag_tables.items()}
        say(tag, f"{label}: n={n}; prepare {summary['prepare_s']:.3f} s of which encode "
                 f"{secs['encode']:.3f} s, build_ghd {secs['build_ghd']:.3f} s, bags "
                 f"{secs['bags']:.3f} s, finish_prepare {secs['finish_prepare']:.3f} s; "
                 f"bag rows {bags}; bag_peak_bytes {g.bag_peak_bytes}; max bag weight "
                 f"{max(int(bt.count.max(initial=0)) for bt in g.bag_tables.values())}; "
                 f"nodes after the fold {list(plan.prep.decomposition.nodes)} (rows "
                 f"{ {r: e.num_rows for r, e in plan.prep.encoded.items()} }, folded "
                 f"{plan.prep.folded})")
        summary.update(ghd_seconds=secs, bag_rows=bags, bag_peak_bytes=g.bag_peak_bytes,
                       nodes=list(plan.prep.decomposition.nodes))
        summary["paths"] = check_paths(tag, label, plan, summary["launches"])
        want = cyclic_counts(name, db)
        group = plan.group_display[0]
        got = dict(zip(res.column(group).tolist(), res.column("count").tolist()))
        rtol = count_rtol(plan)
        worst = 0.0
        ok = set(got) == set(want)
        for key, exact in want.items():
            err = abs(got.get(key, 0.0) - exact)
            if exact < 2 ** 24:
                ok = ok and err == 0
            else:
                worst = max(worst, err / exact)
        ok = ok and worst <= rtol
        say(tag, f"check: {label}: {len(got)} groups, Σ count {sum(got.values()):.0f} vs "
                 f"scipy {sum(want.values())}; largest count {max(want.values())}; exact "
                 f"below 2**24, above it worst relative error {worst:.3e} within "
                 f"{rtol:.3e}: {ok}")
        check(ok, f"{label}: counts disagree with scipy.sparse")
        small, sq = CYCLIC[name](CYCLIC_CHECK_N, seed=args.seed)
        gpu = Q.from_query(sq).plan(small).execute()
        cpu = Q.from_query(sq).engine(TorchChannelEngine(device="cpu")).plan(small).execute()
        same = same_result(gpu, cpu)
        say(tag, f"check: {label}: n={CYCLIC_CHECK_N}: {cpu.num_rows} rows bit-identical to "
                 f"device='cpu': {same}")
        check(same and gpu.num_rows > 0, f"{label}: cuda result differs from cpu result")
        splan = Q.from_query(q).engine(TorchChannelEngine(mode="sparse")).plan(db)
        ops.reset_launch_counts()
        sres = splan.execute()
        torch.cuda.synchronize()
        slaunches = ops.launch_counts()
        check_paths(tag, f"{label}, mode=sparse", splan, slaunches)
        same = same_result(res, sres)
        say(tag, f"check: {label}, mode=sparse: launches {slaunches}; bit-identical to the "
                 f"default plan: {same}")
        check(same, f"{label}: the sparse-pinned result differs from the default plan's")
        check(slaunches["segment_sum"] > 0, f"{label}, mode=sparse: no segment_sum launch")
        for p in (plan, splan):
            verified(tag, label, p)
        out[label] = summary
        out["launches"][label] = summary["launches"]
        out["launches"][f"{label}, mode=sparse"] = slaunches
        del plan, res, splan, sres
    return out


DENSE_START_N = 600  # the catalog's golden scale
DENSE_CHECK_N = 4800
SWEEP_REPS = 5


def tpch_db(n: int, seed: int):
    """The catalog's TPCH at ``n`` lineitem rows plus an integer measure
    ``lineitem.quantity`` in [1, 50], TPC-H's ``l_quantity``."""
    import numpy as np

    from repro_torch.data.queries import tpch_like
    from repro_torch.relational.relation import Database

    db, q = tpch_like(n, seed=seed)
    cols = {r: dict(db[r].columns) for r in q.relations}
    cols["lineitem"]["quantity"] = np.random.default_rng(seed + 1).integers(1, 51, n)
    return Database.from_mapping(cols), cols, q


def tpch_query(q, engine):
    from repro_torch.api import Avg, Count, Max, Min, Q, Sum

    m = "lineitem.quantity"
    return (Q.over(*q.relations).group_by(*(f"{r}.{a}" for r, a in q.group_by))
            .agg(n=Count(), s=Sum(m), a=Avg(m), lo=Min(m), hi=Max(m)).engine(engine))


def tpch_totals(cols) -> tuple[int, int]:
    """Σ COUNT and Σ SUM(quantity) of TPCH's chain join in numpy, without
    the port: supplier and customer matches per key by bincount, carried
    through orders to every lineitem row."""
    import numpy as np

    dom = 1 + max(int(c.max()) for rel in cols.values() for c in rel.values())
    sup = np.bincount(cols["supplier"]["suppkey"], minlength=dom)
    cust = np.bincount(cols["customer"]["custkey"], minlength=dom)
    orders = np.bincount(cols["orders"]["orderkey"], minlength=dom,
                         weights=cust[cols["orders"]["custkey"]]).astype(np.int64)
    li = cols["lineitem"]
    per_row = sup[li["suppkey"]] * orders[li["orderkey"]]
    return int(per_row.sum()), int((per_row * li["quantity"]).sum())


def dense_leg(torch, tag, args) -> dict:
    """TPCH with its quantity bundle at the largest doubling of 600 rows
    that ``choose_path`` still runs dense: the default plan against a
    ``mode="sparse"`` plan on the same data."""
    import math

    import numpy as np

    from repro_torch.api import TorchChannelEngine
    from repro_torch.core.torch_engine import choose_path

    series, n = [], DENSE_START_N
    while True:
        db, _, q = tpch_db(n, args.seed)
        plan = tpch_query(q, "torch").plan(db)
        (_, choice), = run_paths(plan)
        series.append((n, choice.path, choice.reason))
        if choice.path != "dense":
            break
        n *= 2
    say(tag, f"dense leg: doubling series {series}")
    check(len(series) > 1, "dense leg: TPCH is not dense even at 600 rows")
    n = series[-2][0]
    db, cols, q = tpch_db(n, args.seed)
    say(tag, f"data: TPCH n={n} seed={args.seed}, lineitem.quantity in [1, 50]")
    dplan, dres, dense = drive(torch, tag, "dense leg", lambda: tpch_query(q, "torch").plan(db))
    elems = {r: math.prod(dplan.prep.dicts[a].size for a in e.attrs)
             for r, e in dplan.prep.encoded.items()}
    choice = choose_path(dplan.prep, k=len(dplan.channels), measured=tuple(
        ch.measure[0] if ch.kind == "sum" else None for ch in dplan.channels))
    say(tag, f"dense leg: relation tensors' elements {elems} (rows "
             f"{ {r: e.num_rows for r, e in dplan.prep.encoded.items()} }); est dense peak "
             f"{choice.dense_peak} B vs sparse peak {choice.sparse_peak} B")
    dense.update(n=n, tensor_elems=elems, paths=check_paths(tag, "dense leg", dplan,
                                                             dense["launches"]))
    check(dense["paths"] == ["dense"], "dense leg: the default plan did not run dense")
    check(dense["launches"]["segment_reduce"] > 0, "dense leg: MIN/MAX launched no segment_reduce")
    splan, sres, sparse = drive(
        torch, tag, "dense leg, mode=sparse",
        lambda: tpch_query(q, TorchChannelEngine(mode="sparse")).plan(db),
    )
    sparse.update(n=n, paths=check_paths(tag, "dense leg, mode=sparse", splan,
                                         sparse["launches"]))
    same = same_result(dres, sres)
    say(tag, f"check: dense leg: dense = sparse bit for bit: {same}; dense vs sparse: "
             f"warm execute {dense['warm_execute_s'] * 1e3:.3f} vs "
             f"{sparse['warm_execute_s'] * 1e3:.3f} ms, device busy "
             f"{dense['device_busy_s'] * 1e3:.4f} vs {sparse['device_busy_s'] * 1e3:.4f} ms, "
             f"idle share {dense['idle_share']:.4f} vs {sparse['idle_share']:.4f}, peak "
             f"above resident {dense['peak_above_resident_bytes']} vs "
             f"{sparse['peak_above_resident_bytes']} B")
    check(same, "dense leg: the dense result differs from the sparse-pinned one")
    want_n, want_s = tpch_totals(cols)
    got_n, got_s = dres.column("n").sum(), dres.column("s").sum()
    say(tag, f"check: dense leg: Σ count {got_n:.0f} vs numpy {want_n}; Σ sum {got_s:.0f} "
             f"vs numpy {want_s}")
    check(got_n == want_n and got_s == want_s and dres.num_rows > 0,
          "dense leg: Σ count / Σ sum disagree with numpy")
    for name in dres.agg_names:
        check(bool(np.isfinite(dres.column(name)).all()), f"dense leg: non-finite {name}")

    matmul = torch.backends.cuda.matmul
    before = matmul.allow_tf32
    matmul.allow_tf32 = True
    try:
        tres = tpch_query(q, "torch").plan(db).execute()
        still = matmul.allow_tf32
    finally:
        matmul.allow_tf32 = before
    same = same_result(dres, tres)
    say(tag, f"check: dense leg: with allow_tf32 = True set globally: bit-identical "
             f"{same}; allow_tf32 still True after the run: {still}")
    check(same and still, "dense leg: a global TF32 setting changed the result or was lost")
    tf32_terms(torch, tag, dplan, args.seed)

    small, _, sq = tpch_db(DENSE_CHECK_N, args.seed)
    gplan = tpch_query(sq, "torch").plan(small)
    cplan = tpch_query(sq, TorchChannelEngine(device="cpu")).plan(small)
    gpu, cpu = gplan.execute(), cplan.execute()
    same = same_result(gpu, cpu)
    say(tag, f"check: dense leg: TPCH n={DENSE_CHECK_N}: {cpu.num_rows} rows bit-identical "
             f"to device='cpu': {same}")
    check(same and gpu.num_rows > 0, "dense leg: cuda result differs from cpu result")
    for p in (dplan, splan, gplan):
        verified(tag, "dense leg", p)
    dense["sweep"] = path_sweep(torch, tag, args.seed, [n for n, *_ in series] + [2 * series[-1][0]])
    return {"dense": dense, "dense, mode=sparse": sparse, "tpch": (db, q, dres),
            "launches": {"dense": dense["launches"],
                         "dense, mode=sparse": sparse["launches"]}}


TF32_GEMM = 2048  # a square term that cuBLAS runs on TF32 tensor cores when let


def tf32_terms(torch, tag, dplan, seed: int) -> None:
    """A TF32 check that can fail: the dense leg's integer data multiply
    exactly even in TF32 (11-bit significands), so each einsum term of
    its program, and a (2048 × 2048) · (2048 × 2048) term, is contracted
    on fractional operands of its shapes, with ``allow_tf32 = True`` set
    globally.  Inside ``full_fp32_matmul`` ``contract_term`` must equal
    its FP32 result (``allow_tf32 = False``) bit for bit; a bare
    ``torch.einsum`` of the square term must differ from it, which shows
    that TF32 was in force and the pin is what kept the bits."""
    from repro_torch.core.torch_engine import (
        build_dense_program,
        contract_term,
        dense_tensor,
        full_fp32_matmul,
    )

    prep = dplan.prep
    cm = tuple(ch.measure[0] if ch.kind == "sum" else None for ch in dplan.channels)
    prog = build_dense_program(prep, "cuda")
    shapes, results = [], {}
    with full_fp32_matmul():
        for rel, expr, children in prog.terms(cm):
            operands = [dense_tensor(prep, rel, "cuda", cm)] + [results[c] for c in children]
            results[rel] = contract_term(expr, operands)
            shapes.append((rel, expr, [tuple(o.shape) for o in operands]))
    shapes.append(("square", "ab,bc->ac", [(TF32_GEMM, TF32_GEMM)] * 2))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_tf32
    pinned_ok, square_differs = True, False
    try:
        for rel, expr, dims in shapes:
            operands = [torch.rand(d, generator=gen, device="cuda") + 0.5 for d in dims]
            matmul.allow_tf32 = False
            fp32 = contract_term(expr, operands)
            matmul.allow_tf32 = True
            bare = torch.einsum(expr, *operands)
            with full_fp32_matmul():
                pinned = contract_term(expr, operands)
            still = matmul.allow_tf32
            torch.cuda.synchronize()
            same = torch.equal(pinned, fp32) and still
            bare_err = float((bare - fp32).abs().max())
            say(tag, f"check: dense leg: TF32 term {rel} {expr} {dims}: pinned contract_term "
                     f"= FP32 bit for bit: {same}; bare torch.einsum under allow_tf32 = True "
                     f"max |diff| {bare_err:.3e}")
            pinned_ok = pinned_ok and same
            square_differs = square_differs or (rel == "square" and bare_err > 0)
    finally:
        matmul.allow_tf32 = before
    check(pinned_ok, "dense leg: a term under full_fp32_matmul differs from FP32 with TF32 on")
    check(square_differs, "dense leg: TF32 changed no bit of the bare square term; the TF32 "
                          "check cannot tell the pin from no pin")


def path_sweep(torch, tag, seed: int, sizes: list[int]) -> list[dict]:
    """Warm execute of each path, pinned, at each size of the dense leg's
    doubling series and one doubling past the first sparse choice: the
    median of ``SWEEP_REPS`` host-clock runs ending in a synchronise,
    against what ``choose_path`` picks there."""
    import statistics

    from repro_torch.api import TorchChannelEngine

    rows = []
    for n in sizes:
        db, _, q = tpch_db(n, seed)
        (_, choice), = run_paths(tpch_query(q, "torch").plan(db))
        row = {"n": n, "choice": choice.path}
        for mode in ("dense", "sparse"):
            plan = tpch_query(q, TorchChannelEngine(mode=mode)).plan(db)
            plan.execute()  # cold: builds the relation tensors or the views
            times = []
            for _ in range(SWEEP_REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                plan.execute()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            row[f"{mode}_ms"] = statistics.median(times) * 1e3
        row["faster"] = "dense" if row["dense_ms"] < row["sparse_ms"] else "sparse"
        say(tag, f"dense leg: path sweep: TPCH n={n}: choose_path {choice.path}; warm "
                 f"execute, median of {SWEEP_REPS}: dense {row['dense_ms']:.3f} ms, sparse "
                 f"{row['sparse_ms']:.3f} ms; faster {row['faster']}")
        rows.append(row)
    return rows


def explain_phase(torch, tag, seed: int) -> None:
    """``explain(actuals=True)`` of a small plan on the card, its actual
    per-node cardinalities from the card's COUNT pass."""
    db, _, q = tpch_db(DENSE_START_N, seed)
    plan = tpch_query(q, "torch").fused(True).plan(db)
    for line in plan.explain(actuals=True).splitlines():
        say(tag, f"explain: {line}")
    verified(tag, "explain", plan)


# ----------------------------------------------------------------------
# the maintain leg
# ----------------------------------------------------------------------

MAINTAIN_SIZES = (1, 10, 100, 1000, 10000)  # Table VIII's inserts into R2
MAINTAIN_DELETE = 1000  # present R2 tuples deleted after them
MAINTAIN_SIDE = 100  # rows of the R3 (leaf, growing) and R1 (root) inserts


def b2_cols(n: int, seed: int):
    """Table VIII's B2 star (``data/synth.py``) at ``n`` rows per relation
    with an integer measure ``m`` in [1, 40] on R2; its columns and query."""
    import numpy as np

    from repro_torch.data import synth

    db, q = synth.make("B2", n, seed=seed)
    cols = {r: dict(db[r].columns) for r in q.relations}
    cols["R2"]["m"] = np.random.default_rng(seed + 3).integers(1, 41, n)
    return cols, q


def b2_total(cols) -> int:
    """Σ COUNT of the B2 join R1(g1,j) ⋈ R2(j,b) ⋈ R3(b,g2) ⋈ R4(b,g3),
    counted in numpy without the port: R3 and R4 rows per b, R2 weighted
    per j, summed over R1 (integers below 2**53, exact in float64)."""
    import numpy as np

    bdom = 1 + max(int(cols[r]["b"].max()) for r in ("R2", "R3", "R4"))
    jdom = 1 + max(int(cols[r]["j"].max()) for r in ("R1", "R2"))
    per_b = (np.bincount(cols["R3"]["b"], minlength=bdom)
             * np.bincount(cols["R4"]["b"], minlength=bdom))
    w2 = np.bincount(cols["R2"]["j"], weights=per_b[cols["R2"]["b"]], minlength=jdom)
    return int(w2[cols["R1"]["j"]].sum())


def b2_bundle(engine):
    """COUNT, SUM and AVG of R2.m over B2, grouped as Table VIII groups."""
    from repro_torch.api import Avg, Count, Q, Sum

    return (Q.over("R1", "R2", "R3", "R4").group_by("R1.g1", "R3.g2", "R4.g3")
            .agg(n=Count(), s=Sum("R2.m"), a=Avg("R2.m")).engine(engine))


def b2_batches(cols, seed: int) -> list:
    """The leg's batches ``(label, op, rel, columns)``: Table VIII's five
    insert sizes into R2 (its value ranges), a delete of the first
    ``MAINTAIN_DELETE`` R2 tuples, an insert into the leaf R3 with 10 new
    b values and only new g2 values (both domains grow), and an insert
    into the root R1."""
    import numpy as np

    rng = np.random.default_rng(seed + 17)
    jdom = 1 + int(cols["R2"]["j"].max())
    bdom = 1 + max(int(cols[r]["b"].max()) for r in ("R2", "R3", "R4"))
    gdom = 1 + int(cols["R3"]["g2"].max())
    out = [(f"insert {k} into R2", "insert", "R2",
            {"j": rng.integers(0, jdom, k), "b": rng.integers(0, bdom, k),
             "m": rng.integers(1, 41, k)}) for k in MAINTAIN_SIZES]
    out.append((f"delete {MAINTAIN_DELETE} from R2", "delete", "R2",
                {a: c[:MAINTAIN_DELETE].copy() for a, c in cols["R2"].items()}))
    k = MAINTAIN_SIDE
    out.append((f"insert {k} into R3, new b and g2", "insert", "R3",
                {"b": np.concatenate([rng.integers(0, bdom, k - 10), bdom + np.arange(10)]),
                 "g2": gdom + rng.integers(0, 2, k)}))
    out.append((f"insert {k} into R1 (root)", "insert", "R1",
                {"g1": rng.integers(0, gdom, k), "j": rng.integers(0, jdom, k)}))
    return out


def mirrored(cols, op: str, rel: str, batch):
    """The host's copy of the columns after a batch.  Deletes here are a
    contiguous block of rows: the first ones, or the block that the
    ``MAINTAIN_SIZES[-1]`` insert appended (found by its rows)."""
    import numpy as np

    out = {r: dict(c) for r, c in cols.items()}
    cur = cols[rel]
    if op == "insert":
        out[rel] = {a: np.concatenate([c, np.asarray(batch[a])]) for a, c in cur.items()}
        return out
    k = len(next(iter(batch.values())))
    starts = np.flatnonzero(np.logical_and.reduce([c == batch[a][0] for a, c in cur.items()]))
    lo = next(int(i) for i in starts
              if all(np.array_equal(c[i:i + k], batch[a]) for a, c in cur.items()))
    out[rel] = {a: np.concatenate([c[:lo], c[lo + k:]]) for a, c in cur.items()}
    return out


def handle_stats(handle) -> dict:
    """A handle's refresh counters; a bundle's summed over its handles
    (``peak_delta_bytes`` their largest)."""
    stats = getattr(handle, "handles", {"": handle})
    keys = ("delta_rows", "rows_rescanned", "fallback_recomputes", "host_syncs")
    out = {k: sum(getattr(h.stats, k) for h in stats.values()) for k in keys}
    out["peak_delta_bytes"] = max(h.stats.peak_delta_bytes for h in stats.values())
    return out


def timed_refresh(torch, handle, op: str, rel: str, batch) -> dict:
    """One refresh with the launch counts set to 0 just before it and read
    just after: host ms ending in a synchronise, launches, the handle's
    counters for this refresh and the device peak above what was
    allocated before it."""
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = handle_stats(handle)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    getattr(handle, op)(rel, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = ops.launch_counts()
    after = handle_stats(handle)
    row = {k: after[k] - before[k] for k in after if k != "peak_delta_bytes"}
    row.update(ms=ms, launches=launches, peak_delta_bytes=after["peak_delta_bytes"],
               peak_above_resident_bytes=torch.cuda.max_memory_allocated() - resident)
    return row


def from_scratch(torch, q, cols):
    """The port's answer on ``cols`` with nothing kept: plan and execute
    on the card, timed (host clock ending in a synchronise)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = q.plan(cols)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = plan.execute()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return res, (t2 - t0) * 1e3, (t2 - t1) * 1e3


def maintain_leg(torch, tag, args) -> dict:
    """B2 at ``--n`` (Table VIII) maintained on the card: a COUNT handle
    through ``Q.maintain(db)`` and a COUNT/SUM/AVG bundle through
    ``Plan.maintain()`` take the batches of :func:`b2_batches`; after
    each, both equal a from-scratch execute on the card bit for bit and
    Σ COUNT equals numpy's.  Then the largest batch is deleted (its
    launches captured and held against the plain versions) and inserted
    again under the profiler, a MIN handle takes a delete (the
    non-invertible fallback), and at ``--check-n`` the same sequence runs
    on the card and on the CPU, bit for bit."""
    import numpy as np

    from repro_torch.api import Min, Q
    from repro_torch.incremental import MaintainedJoinAgg

    cols, q = b2_cols(args.n, args.seed)
    say(tag, f"data: B2 n={args.n} seed={args.seed}, R2.m in [1, 40]")
    count_q = Q.from_query(q)
    t0 = time.perf_counter()
    counter = count_q.maintain(cols)
    torch.cuda.synchronize()
    count_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    bundle = b2_bundle("torch").plan(cols).maintain()
    torch.cuda.synchronize()
    bundle_build = time.perf_counter() - t0
    check(isinstance(counter, MaintainedJoinAgg), "Q.maintain did not return a raw handle")
    caches = counter.caches["count"].msgs
    say(tag, f"maintain leg: COUNT handle (Q.maintain) built in {count_build:.3f} s, bundle "
             f"(Plan.maintain, {len(bundle.handles)} handles) in {bundle_build:.3f} s; root "
             f"{counter.prep.decomposition.root}; domains "
             f"{ {a: d.size for a, d in counter.dicts.items()} }; cached messages "
             f"{ {r: tuple(m.array.shape) for r, m in caches.items()} }; device memory "
             f"allocated {torch.cuda.memory_allocated()} B")

    def checked(label, cols):
        fresh_c, c_full, c_exec = from_scratch(torch, count_q, cols)
        fresh_b, b_full, b_exec = from_scratch(torch, b2_bundle("torch"), cols)
        want = b2_total(cols)
        ok_c = counter.result() == fresh_c.to_dict()
        ok_b = same_result(bundle.result(), fresh_b)
        total = fresh_b.column("n").sum()
        say(tag, f"check: maintain leg, {label}: COUNT handle = fresh execute bit for bit: "
                 f"{ok_c}; bundle = fresh execute bit for bit: {ok_b} ({fresh_b.num_rows} "
                 f"groups); Σ count {total:.0f} vs numpy {want}")
        check(ok_c and ok_b, f"maintain leg, {label}: a handle differs from a fresh execute")
        check(total == want and sum(counter.result().values()) == want,
              f"maintain leg, {label}: Σ count disagrees with numpy")
        for name in fresh_b.agg_names:
            check(bool(np.isfinite(fresh_b.column(name)).all()), f"maintain leg: non-finite {name}")
        return {"count": (c_full, c_exec), "bundle": (b_full, b_exec)}

    checked("as built", cols)
    totals: dict[str, int] = {}
    rows = []
    batches = b2_batches(cols, args.seed)
    for label, op, rel, batch in batches:
        row = {"batch": label}
        for name, handle in (("count", counter), ("bundle", bundle)):
            r = timed_refresh(torch, handle, op, rel, batch)
            row[name] = r
            for kernel, c in r["launches"].items():
                totals[kernel] = totals.get(kernel, 0) + c
        cols = mirrored(cols, op, rel, batch)
        full = checked(label, cols)
        for name in ("count", "bundle"):
            r = row[name]
            r.update(full_ms=full[name][0], full_execute_ms=full[name][1],
                     full_over_refresh=full[name][0] / r["ms"])
            say(tag, f"maintain leg, {label}, {name}: refresh {r['ms']:.3f} ms vs full "
                     f"recompute {r['full_ms']:.3f} ms (of it execute "
                     f"{r['full_execute_ms']:.3f} ms), ratio {r['full_over_refresh']:.2f}; "
                     f"delta_rows {r['delta_rows']}, rows_rescanned {r['rows_rescanned']}, "
                     f"fallback_recomputes {r['fallback_recomputes']}, peak_delta_bytes "
                     f"{r['peak_delta_bytes']}; device peak above resident "
                     f"{r['peak_above_resident_bytes']} B; launches {r['launches']}; "
                     f"device->host syncs {r['host_syncs']}")
            check(r["fallback_recomputes"] == 0, f"maintain leg, {label}: a fallback ran")
            check(r["launches"]["fused_hop"] == 0 and r["launches"]["segment_reduce"] == 0
                  and r["launches"]["semiring_matmul"] == 0,
                  f"maintain leg, {label}: a refresh launched a kernel off its path")
        rows.append(row)
    say(tag, f"maintain leg: launches of every refresh together: {totals}")
    check(totals["segment_sum"] > 0 and totals["coo_spmm"] > 0,
          "maintain leg: the refreshes never launched segment_sum or coo_spmm")

    # the largest batch once more: deleted (launches captured), inserted
    # again under the profiler
    big = batches[len(MAINTAIN_SIZES) - 1][3]
    captured = capture_launches(lambda: bundle.delete("R2", big), main_path_key)
    counter.delete("R2", big)
    cols = mirrored(cols, "delete", "R2", big)
    checked(f"delete the {MAINTAIN_SIZES[-1]} rows again", cols)
    profiles = {}
    for name, handle in (("count", counter), ("bundle", bundle)):
        wall, busy, top = idle_share(torch, lambda h=handle: h.insert("R2", big))
        profiles[name] = {"wall_s": wall, "device_busy_s": busy, "idle_share": 1 - busy / wall}
        say(tag, f"profile: maintain leg, {name}, insert {MAINTAIN_SIZES[-1]} into R2 again: "
                 f"{wall:.3f} s wall, device busy {busy:.4f} s, idle share "
                 f"{1 - busy / wall:.3f}")
        for op_name, ms, cnt in top[:8]:
            say(tag, f"profile: {ms:10.3f} ms x{cnt:<6d} {op_name[:140]}")
    cols = mirrored(cols, "insert", "R2", big)
    checked(f"insert the {MAINTAIN_SIZES[-1]} rows again", cols)

    # MIN through a delete: the non-invertible fallback
    min_q = (Q.over("R1", "R2", "R3", "R4").group_by("R1.g1", "R3.g2", "R4.g3")
             .agg(lo=Min("R2.m")))
    t0 = time.perf_counter()
    low = min_q.maintain(cols)
    torch.cuda.synchronize()
    min_build = time.perf_counter() - t0
    gone = {a: c[:MAINTAIN_DELETE].copy() for a, c in cols["R2"].items()}
    r = timed_refresh(torch, low, "delete", "R2", gone)
    cols = mirrored(cols, "delete", "R2", gone)
    fresh, full_ms, _ = from_scratch(torch, min_q, cols)
    same = low.result() == fresh.to_dict()
    say(tag, f"maintain leg, MIN handle: built in {min_build:.3f} s; delete "
             f"{MAINTAIN_DELETE} from R2: refresh {r['ms']:.3f} ms (fallback recomputes "
             f"{r['fallback_recomputes']}) vs full recompute {full_ms:.3f} ms; launches "
             f"{r['launches']}; = fresh execute bit for bit: {same}")
    check(same and r["fallback_recomputes"] == 1, "maintain leg: the MIN fallback is wrong")
    check(r["launches"]["segment_reduce"] > 0, "maintain leg: the MIN recompute ran no segment_reduce")
    del counter, bundle, low
    torch.cuda.empty_cache()
    maintain_cpu_check(torch, tag, args)
    return {"maintain": {"count_build_s": count_build, "bundle_build_s": bundle_build,
                         "min_build_s": min_build, "batches": rows, "profiles": profiles,
                         "min_delete": r},
            "captured": captured,
            "launches": {"maintain": totals, "maintain, MIN fallback": r["launches"]}}


def maintain_cpu_check(torch, tag, args) -> None:
    """The leg's batch sequence at ``--check-n`` on a card handle and a
    ``device="cpu"`` handle, COUNT and the bundle: equal bit for bit
    after every batch."""
    from repro_torch.api import Q, TorchChannelEngine

    cpu = TorchChannelEngine(device="cpu")
    cols, q = b2_cols(args.check_n, args.seed)
    pairs = {
        "count": (Q.from_query(q).maintain(cols), Q.from_query(q).engine(cpu).maintain(cols)),
        "bundle": (b2_bundle("torch").maintain(cols), b2_bundle(cpu).maintain(cols)),
    }
    for label, op, rel, batch in [("as built", None, None, None)] + b2_batches(cols, args.seed):
        same = True
        for gpu, host in pairs.values():
            if op is not None:
                getattr(gpu, op)(rel, batch)
                getattr(host, op)(rel, batch)
            a, b = gpu.result(), host.result()
            same = same and (a == b if isinstance(a, dict) else same_result(a, b))
        say(tag, f"check: maintain leg: B2 n={args.check_n}, {label}: card handles = "
                 f"device='cpu' handles bit for bit: {same}")
        check(same, f"maintain leg, n={args.check_n}, {label}: cuda differs from cpu")


def maintain_kernels(torch, tag, captured) -> dict:
    """The largest refresh's ``segment_sum`` and ``coo_spmm`` launches (the
    leg's own shapes) against their plain versions, tolerance 0, and
    timed beside the plain version, the library call and the bound."""
    seg = [lc for key, lc in captured.items() if isinstance(key, tuple) and key[0] == "segment_sum"]
    check(seg and "coo_spmm" in captured, "maintain leg: no segment_sum or coo_spmm captured")
    out = {"segment_sum": segment_regime(
        torch, tag, "segment_sum", "largest refresh launch",
        max(seg, key=lambda lc: lc.size), path="maintain leg")}
    out["coo_spmm"] = coo_spmm_row(
        torch, tag, "maintain leg", "largest refresh launch", captured["coo_spmm"], tol=None)
    return out


def spmm_tolerance(torch, rows, cols, vals, dense, s):
    """None (tolerance 0) when every product and partial sum of the
    float32 ``coo_spmm`` is an integer below 2**24, which both the kernel
    and its plain version then compute exactly; else the elementwise
    bound on their difference.  Summing a row's run of at most m edges in
    any order rounds each product and each addition once, at most 2**-24
    relative, so each result lies within (2m) · 2**-24 · Σ|w · x| of the
    exact sum (to first order), and the two within twice that."""
    mag = torch.zeros((s, dense.shape[1]), dtype=torch.float64, device=dense.device)
    mag.index_add_(0, rows, vals.abs().double()[:, None] * dense.abs().double()[cols])
    integral = bool((vals == vals.round()).all()) and bool((dense == dense.round()).all())
    if integral and (float(mag.max()) if mag.numel() else 0.0) < 2 ** 24:
        return None
    m = int(torch.bincount(rows, minlength=s).max())
    return (4 * m * F32_UNIT * mag).float()


def spmm_exact_check(torch, tag, path: str, lc) -> float:
    """A captured ``coo_spmm`` launch's rows and columns with exact
    operands, held against the plain version at tolerance 0: weights 1
    and a dense of integers in [1, hi], hi chosen so that no output sum
    passes 2**24.  Every edge adds at least 1 to its row, so a lost,
    repeated or misplaced edge shows, however long the row's run."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.coo_spmm import coo_spmm

    rows, cols, vals, dense, s = lc.args
    m = int(torch.bincount(rows, minlength=s).max()) if rows.numel() else 1
    hi = min(100, (2 ** 24 - 1) // m)
    check(hi >= 1, f"coo_spmm [{path}]: a row of {m} edges leaves no exact operands")
    gen = torch.Generator(device=dense.device).manual_seed(0)
    exact = torch.randint(1, hi + 1, tuple(dense.shape), generator=gen, device=dense.device)
    args = (rows, cols, torch.ones_like(vals), exact.to(dense.dtype), s)
    return compare(torch, tag, "coo_spmm", f"{path}, exact operands (weights 1, dense in "
                   f"[1, {hi}], longest run {m})", coo_spmm, ref.coo_spmm, args)


def coo_spmm_row(torch, tag, path: str, label: str, lc, tol) -> dict:
    """One captured ``coo_spmm`` launch held against its plain version
    within ``tol`` (None: exactly; else :func:`spmm_tolerance`'s bound),
    and timed beside the plain version, ``torch.sparse.mm`` and the
    bound."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.coo_spmm import coo_spmm

    rows, cols, vals, dense, s = lc.args
    err = compare(torch, tag, "coo_spmm", f"{path}, {label}", coo_spmm, ref.coo_spmm, lc.args,
                  tol=tol)
    nnz, (kdense, w) = rows.shape[0], dense.shape
    used = int(torch.unique(cols).numel())
    b, by = bound(nnz * 20 + used * w * 4 + s * w * 4, 2 * nnz * w)
    row = dict(
        shapes={"rows": [nnz], "dense": [kdense, w], "num_rows": s, "dense_rows_used": used},
        launches=lc.count, walk=repr(ops.gather_plan(nnz, s, w)), max_abs_err=err,
        ms=time_ms(torch, lambda: coo_spmm(rows, cols, vals, dense, s)),
        plain_ms=time_ms(torch, lambda: ref.coo_spmm(rows, cols, vals, dense, s), reps=3),
        library_ms=csr_spmm_ms(torch, rows, cols, vals, dense, s),
        bound_ms=b, bound_by=by,
    )
    say(tag, f"kernels: coo_spmm [{path}] at {row['shapes']}: {row['ms']:.4f} ms, "
             f"bound {b:.4f} ms by {by}, plain {row['plain_ms']:.4f} ms, library "
             f"torch.sparse.mm {row['library_ms']:.4f} ms; {row['walk']}")
    return row


# ----------------------------------------------------------------------
# storage leg (Table XIV on the card)
# ----------------------------------------------------------------------


def measured_chain_cols(n: int, seed: int) -> dict:
    """The fold-free measured chain of the repo's Table XIV
    (``benchmarks/tables.py:276``): R1(g1, p0), R2(p0, p1, m), R3(p1,
    g2) at ``n`` rows each, join domains ``n // 50``, group domains 32,
    an integer measure m in [1, 100)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    jdom, gdom = max(4, n // 50), 32
    return {
        "R1": {"g1": rng.integers(0, gdom, n), "p0": rng.integers(0, jdom, n)},
        "R2": {"p0": rng.integers(0, jdom, n), "p1": rng.integers(0, jdom, n),
               "m": rng.integers(1, 100, n)},
        "R3": {"p1": rng.integers(0, jdom, n), "g2": rng.integers(0, gdom, n)},
    }


def storage_totals(cols) -> tuple[int, int]:
    """Σ COUNT and Σ SUM(R2.m) of the chain join in int64, without the
    port: Σ over p0, p1 of c1[p0]·c2[p0, p1]·c3[p1], i.e. each R2 row
    weighed by the R1 rows on its p0 and the R3 rows on its p1."""
    import numpy as np

    dom = 1 + max(int(cols[r][a].max()) for r, a in (
        ("R1", "p0"), ("R2", "p0"), ("R2", "p1"), ("R3", "p1")))
    c1 = np.bincount(cols["R1"]["p0"], minlength=dom).astype(np.int64)
    c3 = np.bincount(cols["R3"]["p1"], minlength=dom).astype(np.int64)
    w = c1[cols["R2"]["p0"]] * c3[cols["R2"]["p1"]]
    return int(w.sum()), int((w * cols["R2"]["m"]).sum())


def storage_sum_query(engine):
    """The repo's Table XIV query: SUM(R2.m) by R1.g1, R3.g2."""
    from repro_torch.api import Q, Sum

    return Q.over("R1", "R2", "R3").group_by("R1.g1", "R3.g2").agg(s=Sum("R2.m")).engine(engine)


def storage_bundle(engine):
    """The storage smoke bundle of ``src/repro/launch/storage.py:61``."""
    from repro_torch.api import Avg, Count, Max, Min, Q, Sum

    return (
        Q.over("R1", "R2", "R3").group_by("R1.g1", "R3.g2")
        .agg(n=Count(), s=Sum("R2.m"), lo=Min("R2.m"), hi=Max("R2.m"), mean=Avg("R2.m"))
        .engine(engine)
    )


def chunk_env(rows: int):
    """``REPRO_CHUNK_ROWS`` set for a ``with`` block (the chunk a stored
    plan's prepare streams in), restored after."""
    import os
    from unittest import mock

    return mock.patch.dict(os.environ, {"REPRO_CHUNK_ROWS": str(rows)})


def host_peak(torch, fn):
    """``(result, seconds, tracemalloc peak bytes)`` of ``fn()``, the host
    clock ending in a synchronise.  tracemalloc counts numpy's and
    Python's allocations (each host range an upload gathers among them),
    not memmap pages."""
    import tracemalloc

    tracemalloc.start()
    try:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    return out, secs, peak


def storage_leg(torch, tag, args) -> dict:
    """The repo's Table XIV on the card: the measured chain at
    ``--storage-n`` rows per relation written with ``write_database`` to
    a temporary directory (removed after) and mounted with
    ``open_database``; prepare's host peak, mounted and in memory; the
    Table XIV SUM query on both, bit for bit; the storage smoke bundle
    on the mounted database, driven; Σ COUNT / Σ SUM against numpy."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.aggregates.semiring import Sum
    from repro_torch.core.prepare import prepare
    from repro_torch.core.query import JoinAggQuery
    from repro_torch.kernels import ops
    from repro_torch.relational.relation import Database
    from repro_torch.storage import open_database, write_database

    n = args.storage_n
    cols = measured_chain_cols(n, args.seed)
    db = Database.from_mapping(cols)
    col_bytes = max(c.nbytes for rc in cols.values() for c in rc.values())
    total_bytes = sum(c.nbytes for rc in cols.values() for c in rc.values())
    chunk = max(4096, n // 25)
    say(tag, f"data: storage leg: measured chain n={n} seed={args.seed}: join domains "
             f"{max(4, n // 50)}, group domains 32; {total_bytes} B of columns, largest "
             f"column {col_bytes} B; chunk_rows {chunk}")
    out: dict = {"launches": {}}
    tmp = Path(tempfile.mkdtemp(prefix="chip-smoke-storage-"))
    try:
        t0 = time.perf_counter()
        write_database(db, tmp / "db")
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        mdb = open_database(tmp / "db")
        open_s = time.perf_counter() - t0
        disk = sum(p.stat().st_size for p in (tmp / "db").rglob("*") if p.is_file())
        say(tag, f"storage leg: write_database {write_s:.3f} s ({disk} B on disk), "
                 f"open_database {open_s:.3f} s")

        # Table XIV's prepare: encode + the three grouped-CSR views
        q = JoinAggQuery(("R1", "R2", "R3"), (("R1", "g1"), ("R3", "g2")), Sum("R2", "m"))

        def prep_all(d, ch):
            prep = prepare(q, d, chunk_rows=ch)
            for rel, attr in (("R1", "p0"), ("R2", "p0"), ("R3", "p1")):
                prep.csr_view(rel, (attr,))
            return prep

        peaks = {}
        for label, d, ch in (("mmap", mdb, chunk), ("in-memory", db, None)):
            prep, secs, peak = host_peak(torch, lambda: prep_all(d, ch))
            peaks[label] = peak
            say(tag, f"storage leg: prepare {label}: {secs:.3f} s, host peak {peak} B "
                     f"(tracemalloc) = {peak / col_bytes:.2f}x the largest column")
            out[f"prepare {label}"] = {"seconds": secs, "host_peak_bytes": peak,
                                       "peak_over_column": peak / col_bytes}
            del prep
        check(peaks["mmap"] < 2 * col_bytes,
              f"storage leg: mmap prepare host peak {peaks['mmap']} B is not below 2x the "
              f"largest column ({col_bytes} B)")

        # the Table XIV query, mounted (first execute traced) and in memory
        path = str(tmp / "db")
        results = {}
        for label in ("mmap", "in-memory"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if label == "mmap":
                with chunk_env(chunk):
                    plan = storage_sum_query("torch").plan(path)
            else:
                plan = storage_sum_query("torch").plan(db)
            plan_s = time.perf_counter() - t0
            ops.reset_launch_counts()
            res, cold_s, peak = host_peak(torch, plan.execute)
            launches = ops.launch_counts()
            t0 = time.perf_counter()
            plan.execute()
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            say(tag, f"storage leg: Table XIV SUM, {label}: {plan}; chunk_rows "
                     f"{plan.chunk_rows}; plan {plan_s:.3f} s; first execute {cold_s:.3f} s "
                     f"(traced), host peak {peak} B (tracemalloc) = {peak / col_bytes:.2f}x "
                     f"the largest column; "
                     f"warm execute {warm_s:.3f} s; launches {launches}; {res.num_rows} rows")
            verified(tag, f"storage leg, Table XIV SUM, {label}", plan)
            check_paths(tag, f"storage leg, Table XIV SUM, {label}", plan, launches)
            results[label] = res
            out[f"Table XIV SUM, {label}"] = {
                "plan_s": plan_s, "first_execute_s": cold_s, "warm_execute_s": warm_s,
                "first_execute_host_peak_bytes": peak,
                "chunk_rows": plan.chunk_rows, "rows": res.num_rows,
            }
            out["launches"][f"storage, Table XIV SUM, {label}"] = launches
            del plan
        same = same_result(results["mmap"], results["in-memory"])
        say(tag, f"check: storage leg: Table XIV SUM mounted = in-memory bit for bit: {same}")
        check(same, "storage leg: the mounted result differs from the in-memory one")

        # the storage smoke bundle on the mounted database, driven; the
        # Table XIV plans' device views go first, so the bundle's peak
        # above resident counts its own
        gc.collect()
        torch.cuda.empty_cache()
        with chunk_env(chunk):
            bplan, bres, bundle = drive(
                torch, tag, "storage leg, mmap bundle", lambda: storage_bundle("torch").plan(path)
            )
        blaunches = bundle["launches"]
        bundle["paths"] = check_paths(tag, "storage leg, mmap bundle", bplan, blaunches)
        for name in UNFUSED_KERNELS:
            check(blaunches[name] > 0, f"storage leg: the stored path never launched {name}")
        check(blaunches["fused_hop"] == 0, "storage leg: the unfused bundle launched fused_hop")
        verified(tag, "storage leg, mmap bundle", bplan)
        out["mmap bundle"] = bundle
        out["launches"]["storage, mmap bundle"] = blaunches
        out["kernels"] = storage_kernels(
            torch, tag, capture_launches(bplan.execute, main_path_key))

        want_n, want_s = storage_totals(cols)
        rtol = count_rtol(bplan)
        ok = True
        for label, got, want, col in (
            ("Σ count", bres.column("n"), want_n, "n"),
            ("Σ sum", bres.column("s"), want_s, "s"),
            ("Σ sum (Table XIV)", results["mmap"].column("s"), want_s, "s"),
        ):
            total = float(got.sum())
            exact = float(got.max(initial=0)) < 2 ** 24
            err = abs(total - want) / max(want, 1)
            good = (total == want) if exact else err <= rtol
            ok = ok and good
            say(tag, f"check: storage leg: {label} {total:.0f} vs numpy {want}; largest "
                     f"group {float(got.max(initial=0)):.0f}; "
                     + ("exact below 2**24" if exact else
                        f"relative error {err:.3e} within {rtol:.3e}") + f": {good}")
        check(ok and bres.num_rows > 0, "storage leg: Σ count / Σ sum disagree with numpy")
        for name in bres.agg_names:
            check(bool(np.isfinite(bres.column(name)).all()),
                  f"storage leg: non-finite values in {name}")
        del bplan, bres, results
        torch.cuda.empty_cache()
        storage_checks(torch, tag, args, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def storage_kernels(torch, tag, captured) -> dict:
    """The stored bundle's largest ``segment_sum`` and ``segment_reduce``
    launches and its ``coo_spmm`` launch (the leg's own shapes) against
    their plain versions, and timed beside the plain version, the library
    call and the bound.  The segment kernels are held at tolerance 0.
    ``coo_spmm``'s row sums pass 2**24 here, so kernel and plain version
    round in different orders: it is held within
    :func:`spmm_tolerance`'s bound on the captured operands, and at
    tolerance 0 on exact operands at the same rows and columns
    (:func:`spmm_exact_check`)."""
    out = {}
    for name in SEGMENT_KERNELS:
        launches = [lc for key, lc in captured.items()
                    if isinstance(key, tuple) and key[0] == name]
        check(launches, f"storage leg: no {name} launch captured")
        out[name] = segment_regime(torch, tag, name, "largest stored-bundle launch",
                                   max(launches, key=lambda lc: lc.size), path="storage leg")
    check("coo_spmm" in captured, "storage leg: no coo_spmm launch captured")
    lc = captured["coo_spmm"]
    out["coo_spmm"] = coo_spmm_row(torch, tag, "storage leg", "stored-bundle launch", lc,
                                   tol=spmm_tolerance(torch, *lc.args))
    out["coo_spmm"]["exact_operands_max_abs_err"] = spmm_exact_check(
        torch, tag, "storage leg", lc)
    return out


def storage_checks(torch, tag, args, tmp: Path) -> None:
    """At ``--check-n``: the mounted bundle against forced tiny chunks
    (the k-way merge), ``.fused(True)``, the CPU and the in-memory twin,
    bit for bit; a ``Q.maintain`` handle over the mounted database
    against one over the in-memory twin through three 100-row R2
    inserts."""
    import numpy as np

    from repro_torch.api import Q, Sum, TorchChannelEngine
    from repro_torch.relational.relation import Database
    from repro_torch.storage import open_database, write_database

    n = args.check_n
    cols = measured_chain_cols(n, args.seed)
    db = Database.from_mapping(cols)
    write_database(db, tmp / "small")
    path = str(tmp / "small")
    want = storage_bundle("torch").plan(db).execute()
    tiny = max(64, n // 64)
    runs = {"default chunk": storage_bundle("torch").plan(open_database(path))}
    with chunk_env(tiny):
        runs[f"tiny chunks ({tiny} rows)"] = storage_bundle("torch").plan(path)
    runs["fused"] = storage_bundle("torch").fused(True).plan(path)
    runs["device='cpu'"] = storage_bundle(TorchChannelEngine(device="cpu")).plan(path)
    for label, plan in runs.items():
        same = same_result(want, plan.execute())
        say(tag, f"check: storage leg: n={n} mounted, {label} (chunk_rows "
                 f"{plan.chunk_rows}) = in-memory bit for bit: {same}")
        check(same and plan.chunk_rows is not None,
              f"storage leg, n={n}: the mounted {label} result differs")
    check(runs[f"tiny chunks ({tiny} rows)"].chunk_rows == tiny < n,
          "storage leg: the tiny-chunk plan did not stream in chunks of its rows")

    mq = Q.over("R1", "R2", "R3").group_by("R1.g1").agg(s=Sum("R2.m"))
    hm, hd = mq.maintain(db), mq.maintain(open_database(path))
    rng = np.random.default_rng(args.seed + 1)
    jdom = max(4, n // 50)
    for step in range(3):
        delta = {"p0": rng.integers(0, jdom, 100), "p1": rng.integers(0, jdom, 100),
                 "m": rng.integers(1, 100, 100)}
        hm.insert("R2", delta)
        hd.insert("R2", delta)
        same = hm.result() == hd.result()
        say(tag, f"check: storage leg: n={n}: maintained over the mounted database = over "
                 f"the in-memory one after insert {step + 1} of 100 R2 rows: {same}")
        check(same, f"storage leg: maintain diverged at insert {step + 1}")


# ----------------------------------------------------------------------


# ----------------------------------------------------------------------
# serve leg (the query server on the card)
# ----------------------------------------------------------------------

SERVE_WORKERS = 8
SERVE_CLIENTS = 8
SERVE_QUERIES_PER_CLIENT = 6
SERVE_VIEW_BATCHES = 6
SERVE_PAIRS_GROUPS = 40  # the incremental view keeps g1 < 40 and g2 < 40
SERVE_BURST = 8
SERVE_TF32_CLIENTS = 4
SERVE_TF32_QUERIES = 3  # per TF32 client, one after another


def serve_shapes():
    """The reference demo's five shapes (``launch/serve.py``) and the
    ``count`` shape with ``.fused(True)``."""
    from repro_torch.launch.serve import demo_queries

    shapes = demo_queries()
    shapes["count_fused"] = shapes["count"].fused(True)
    return shapes


def percentile_ms(samples: list[float], p: float) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(samples) * 1e3, p))


def client_load(srv, shapes, clients: int, per_client: int, on_answer=None) -> dict:
    """``clients`` threads, each sending ``per_client`` queries that rotate
    through ``shapes`` (client ``i`` starts at shape ``i``), each waited
    for before the next; returns every answer by (client, query) with its
    latency (host clock, ending when the answer is on the host) and the
    wall time.  Raises if a thread failed or hung."""
    import threading

    names = list(shapes)
    answers, errors = {}, []
    lock = threading.Lock()

    def client(i: int) -> None:
        for j in range(per_client):
            name = names[(i + j) % len(names)]
            try:
                t0 = time.perf_counter()
                res = srv.query(shapes[name])
                dt = time.perf_counter() - t0
                if on_answer is not None:
                    on_answer(name, res)
            except Exception as e:
                with lock:
                    errors.append(f"client {i} query {j} ({name}): {e!r}")
                return
            with lock:
                answers[(i, j)] = (name, res, dt)

    threads = [threading.Thread(target=client, args=(i,), name=f"client-{i}")
               for i in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "serve leg: a client thread hung")
    check(not errors, f"serve leg: client errors: {errors[:4]}")
    return {"answers": answers, "wall_s": wall,
            "latencies": [dt for _, _, dt in answers.values()]}


def serve_leg(torch, tag, args, tpch) -> dict:
    """The query server on the card: ``JoinAggServer(db, device="cuda")``
    over C1 at ``--n`` with the reference demo's integer ``R2.w``,
    answering the five demo shapes and a fused ``count`` from concurrent
    clients, fusing bursts, merging channels, serving two maintained
    views under writes (``by_g1``, whose R1 batches recompute because the
    whole chain folds into R1, and ``pairs``, whose R2 batches propagate
    through the device message caches) and a TCP client; a second server
    answers the dense
    leg's TPCH bundle under a global TF32 setting; at ``--check-n`` a
    ``device="cpu"`` server gives the same answers.  Every answer is held
    against a solo ``plan(db).execute()`` of its spec on the card, bit
    for bit (every partial sum is an integer below 2**24 here)."""
    import threading

    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import demo_database
    from repro_torch.relational.relation import Database, Relation
    from repro_torch.serve import JoinAggServer, connect, serve_tcp

    t_leg = time.perf_counter()
    db = demo_database(args.n, seed=args.seed)
    shapes = serve_shapes()
    say(tag, f"data: serve leg: C1 n={args.n} seed={args.seed}, R2.w in [1, 100); shapes "
             f"{list(shapes)}; {SERVE_WORKERS} workers, fusion window 0.002 s")

    # solo oracles on the card, and the view's prefix oracles from a
    # shadow handle: epoch e == R1 insert batches 1..e
    t0 = time.perf_counter()
    solo = {name: q.plan(db).execute() for name, q in shapes.items()}
    oracle_s = time.perf_counter() - t0
    rng = np.random.default_rng(args.seed + 7)
    g1_dom = int(db["R1"].columns["g1"].max()) + 1
    p0_dom = int(db["R1"].columns["p0"].max()) + 1
    deltas = [{"g1": rng.integers(0, g1_dom, 1000), "p0": rng.integers(0, p0_dom, 1000)}
              for _ in range(SERVE_VIEW_BATCHES)]
    t0 = time.perf_counter()
    shadow = shapes["count"].plan(db).maintain()
    shadow_build_s = time.perf_counter() - t0
    prefix, shadow_ms = [shadow.result()], []
    for d in deltas:
        t0 = time.perf_counter()
        prefix.append(shadow.insert("R1", d))
        shadow_ms.append((time.perf_counter() - t0) * 1e3)
    say(tag, f"serve leg: solo oracles {oracle_s:.3f} s ({ {k: r.num_rows for k, r in solo.items()} } "
             f"rows); view prefix oracles from a shadow handle built in {shadow_build_s:.3f} s, "
             f"refresh ms alone {[round(x, 1) for x in shadow_ms]}; {handle_stats(shadow)}")
    del shadow

    # the incremental view: the two_group shape on at most 40 x 40 groups,
    # taking R2 batches; with a group relation at each end of the chain
    # nothing folds, so no batch recomputes.  Its last prefix is also held
    # against a fresh execute over the grown database
    pairs_q = (shapes["two_group"].where("R1", "g1", "<", SERVE_PAIRS_GROUPS)
               .where("R4", "g2", "<", SERVE_PAIRS_GROUPS))
    r2 = db["R2"].columns
    pair_deltas = [{"p0": rng.integers(0, int(r2["p0"].max()) + 1, 1000),
                    "p1": rng.integers(0, int(r2["p1"].max()) + 1, 1000),
                    "w": rng.integers(1, 100, 1000)} for _ in range(SERVE_VIEW_BATCHES)]
    t0 = time.perf_counter()
    shadow = pairs_q.plan(db).maintain()
    shadow_build_s = time.perf_counter() - t0
    pair_prefix, pair_shadow_ms = [shadow.result()], []
    for d in pair_deltas:
        t0 = time.perf_counter()
        pair_prefix.append(shadow.insert("R2", d))
        pair_shadow_ms.append((time.perf_counter() - t0) * 1e3)
    pair_stats = handle_stats(shadow)
    del shadow
    grown = Database(relations=dict(db.relations)).add(Relation("R2", {
        a: np.concatenate([r2[a]] + [d[a].astype(r2[a].dtype) for d in pair_deltas]) for a in r2}))
    fresh = same_result(pairs_q.plan(grown).execute(), pair_prefix[-1])
    del grown
    say(tag, f"check: serve leg: view pairs prefix oracles from a shadow handle built in "
             f"{shadow_build_s:.3f} s, {pair_prefix[-1].num_rows} groups, refresh ms alone "
             f"{[round(x, 1) for x in pair_shadow_ms]}; {pair_stats}; last prefix = a fresh "
             f"execute over R2 with every batch appended: {fresh}")
    check(pair_stats["fallback_recomputes"] == 0, "serve leg: a pairs batch recomputed")
    check(fresh, "serve leg: the pairs view's last prefix differs from a fresh execute")

    largest = max(float(np.abs(r.column(a)).max()) for r in solo.values() for a in r.agg_names)
    say(tag, f"serve leg: largest aggregate of any solo answer {largest:.0f} (2**24 = {2 ** 24}): "
             "every partial sum of every served hop is an exact float32 integer")
    check(largest < 2 ** 24, "serve leg: a group passes 2**24; merged = solo is not exact")

    def same_as_solo(name, res):
        check(same_result(solo[name], res),
              f"serve leg: a served {name} answer differs from its solo execute")

    out: dict = {}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    srv = JoinAggServer(db, device="cuda", workers=SERVE_WORKERS, fusion_window=0.002)
    try:
        # cold (compile, prepare, upload, execute) and warm, per shape
        cold, warm = {}, {}
        for name, q in shapes.items():
            t0 = time.perf_counter()
            res = srv.query(q)
            cold[name] = time.perf_counter() - t0
            same_as_solo(name, res)
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                res = srv.query(q)
                times.append(time.perf_counter() - t0)
            warm[name] = float(np.median(times))
            same_as_solo(name, res)
            say(tag, f"serve leg: {name}: cold {cold[name] * 1e3:.1f} ms, warm median of 5 "
                     f"{warm[name] * 1e3:.1f} ms, {res.num_rows} rows")

        # the views: created on the server, their writers refreshing on the
        # card while the clients' queries run; 2 readers per view check
        # every read against the batch prefix of its epoch
        t0 = time.perf_counter()
        view = srv.create_view("by_g1", shapes["count"])
        view_build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pairs = srv.create_view("pairs", pairs_q)
        pairs_build_s = time.perf_counter() - t0
        stop = threading.Event()
        reads, torn = {}, []

        def reader(v, oracle, equal, i):
            key = (v.name, i)
            reads[key] = 0
            while not stop.is_set():
                snap = v.read()
                if not equal(snap.result, oracle[snap.epoch]):
                    torn.append((v.name, snap.epoch))
                    return
                reads[key] += 1
                time.sleep(0.005)

        refresh_ms, pairs_ms = [], []

        def writer(v, rel, batches, ms):
            for d in batches:
                t0 = time.perf_counter()
                v.insert(rel, d).result(timeout=600)
                ms.append((time.perf_counter() - t0) * 1e3)

        readers = [threading.Thread(target=reader, args=(v, oracle, equal, i),
                                    name=f"reader-{v.name}-{i}")
                   for v, oracle, equal in ((view, prefix, lambda a, b: a == b),
                                            (pairs, pair_prefix, same_result))
                   for i in range(2)]
        writers = [threading.Thread(target=writer, args=args, name=f"writer-{args[0].name}")
                   for args in ((view, "R1", deltas, refresh_ms),
                                (pairs, "R2", pair_deltas, pairs_ms))]
        for t in readers + writers:
            t.start()
        round1 = client_load(srv, shapes, SERVE_CLIENTS, SERVE_QUERIES_PER_CLIENT)
        for t in writers:
            t.join(timeout=900)
        check(not any(t.is_alive() for t in writers), "serve leg: a view writer hung")
        epochs = {v.name: v.drain() for v in (view, pairs)}
        stop.set()
        for t in readers:
            t.join(timeout=60)
        check(not any(t.is_alive() for t in readers), "serve leg: a view reader hung")
        for name, res, _ in round1["answers"].values():
            same_as_solo(name, res)
        served_pairs = handle_stats(pairs.handle)
        n_reads = {name: sum(n for (v, _), n in reads.items() if v == name)
                   for name in epochs}
        say(tag, f"check: serve leg: view by_g1: built in {view_build_s:.3f} s; {len(deltas)} R1 "
                 f"insert batches of 1000 rows, refresh ms {[round(x, 1) for x in refresh_ms]} "
                 f"(under the client load); {handle_stats(view.handle)}")
        say(tag, f"check: serve leg: view pairs: built in {pairs_build_s:.3f} s; {len(pair_deltas)} "
                 f"R2 insert batches of 1000 rows, refresh ms {[round(x, 1) for x in pairs_ms]} "
                 f"(under the client load and by_g1's writes); {served_pairs}")
        say(tag, f"check: serve leg: views: reads {n_reads} by 2 readers each, torn {torn}; epochs "
                 f"after the drain {epochs}")
        check(all(n > 0 for n in n_reads.values()) and not torn,
              "serve leg: a view read matched no batch prefix")
        check(served_pairs["fallback_recomputes"] == 0,
              "serve leg: a served pairs batch recomputed")
        check(epochs == {"by_g1": len(deltas), "pairs": len(pair_deltas)}
              and view.read().result == prefix[-1]
              and same_result(pairs.read().result, pair_prefix[-1]),
              "serve leg: a view did not reach its last prefix")

        # the same load again, every plan warm: under the profiler, with the
        # peak above what the full cache holds
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        box = {}
        wall, busy, top = idle_share(torch, lambda: box.setdefault(
            "r", client_load(srv, shapes, SERVE_CLIENTS, SERVE_QUERIES_PER_CLIENT)), cpu=False)
        round2 = box["r"]
        peak = torch.cuda.max_memory_allocated()
        for name, res, _ in round2["answers"].values():
            same_as_solo(name, res)
        n_q = SERVE_CLIENTS * SERVE_QUERIES_PER_CLIENT
        for label, r in (("mixed load, first round (view writes, merged compiles)", round1),
                         ("mixed load, second round (warm, profiled)", round2)):
            say(tag, f"serve leg: {label}: {n_q} queries from {SERVE_CLIENTS} clients in "
                     f"{r['wall_s']:.3f} s = {n_q / r['wall_s']:.2f} queries/s; latency p50 "
                     f"{percentile_ms(r['latencies'], 50):.1f} ms, p99 "
                     f"{percentile_ms(r['latencies'], 99):.1f} ms, max "
                     f"{max(r['latencies']) * 1e3:.1f} ms")
        say(tag, f"profile: serve leg, second round: {wall:.3f} s wall, device busy {busy:.3f} s, "
                 f"idle share {1 - busy / wall:.3f}; device peak {peak} B, {peak - resident} B "
                 f"above the {resident} B resident with the cache full")
        for name, ms, cnt in top[:8]:
            say(tag, f"profile: {ms:10.3f} ms x{cnt:<6d} {name[:140]}")

        # 8 identical queries: one burst (one execute) vs one after another
        fusion0 = srv.stats()["fusion"]
        t0 = time.perf_counter()
        futs = [srv.submit(shapes["sum"]) for _ in range(SERVE_BURST)]
        burst = [f.result(timeout=600) for f in futs]
        burst_s = time.perf_counter() - t0
        fusion1 = srv.stats()["fusion"]
        t0 = time.perf_counter()
        serial = [srv.query(shapes["sum"]) for _ in range(SERVE_BURST)]
        serial_s = time.perf_counter() - t0
        for res in burst + serial:
            same_as_solo("sum", res)
        shared = fusion1["shared_identical"] - fusion0["shared_identical"]
        batches = fusion1["batches"] - fusion0["batches"]
        say(tag, f"check: serve leg: burst of {SERVE_BURST} identical sum queries: "
                 f"{burst_s * 1e3:.1f} ms fused vs {serial_s * 1e3:.1f} ms serial; shared_identical "
                 f"+{shared}, batches +{batches}")
        check(shared == SERVE_BURST and batches == 1,
              "serve leg: the identical burst did not run as one execute")

        # a count/sum/multi burst by R1.g1: one channel-merged pass
        f0 = srv.stats()["fusion"]
        futs = {name: srv.submit(shapes[name]) for name in ("count", "sum", "multi")}
        merged = {name: f.result(timeout=600) for name, f in futs.items()}
        f1 = srv.stats()["fusion"]
        for name, res in merged.items():
            same_as_solo(name, res)
        merged_n = f1["merged_channels"] - f0["merged_channels"]
        say(tag, f"check: serve leg: count/sum/multi burst: merged_channels +{merged_n}, each "
                 f"demuxed answer = its solo answer bit for bit")
        check(merged_n >= 2, "serve leg: the count/sum/multi burst merged no channels")

        # one TCP round trip
        tcp, _ = serve_tcp(srv)
        try:
            with connect(*tcp.server_address) as remote:
                t0 = time.perf_counter()
                rres = remote.query({"relations": ["R1", "R2", "R3", "R4"],
                                     "group_by": ["R1.g1"], "aggs": {"n": {"kind": "count"}}})
                tcp_ms = (time.perf_counter() - t0) * 1e3
                remote_epoch, _ = remote.view_read("by_g1")
                stats = remote.server_stats()
        finally:
            tcp.shutdown()
            tcp.server_close()
        same = rres.to_dict("n") == solo["count"].to_dict("n")
        say(tag, f"check: serve leg: TCP round trip {tcp_ms:.1f} ms = in-process answer: "
                 f"{same}; view epoch over TCP {remote_epoch}")
        check(same and remote_epoch == len(deltas), "serve leg: the TCP answer differs")
    finally:
        srv.close()
    launches = ops.launch_counts()

    pc, fusion = stats["plan_cache"], stats["fusion"]
    served = 2 * n_q + 6 * len(shapes) + 2 * SERVE_BURST + 3 + 1
    say(tag, f"serve leg: device {stats['device']}; plan cache {pc}; fusion {fusion}; "
             f"{served} queries served; launches {launches}")
    check(pc["compiles"] < served, "serve leg: the plan cache compiled once per query")
    for name in ("segment_sum", "coo_spmm", "segment_reduce", "fused_hop"):
        check(launches[name] > 0, f"serve leg: the served queries never launched {name}")

    tf32 = serve_tf32(torch, tag, tpch)
    launches = {k: launches[k] + tf32[k] for k in launches}
    serve_cpu_check(torch, tag, args)
    out.update(
        cold_ms={k: v * 1e3 for k, v in cold.items()}, warm_ms={k: v * 1e3 for k, v in warm.items()},
        round1={"wall_s": round1["wall_s"], "qps": n_q / round1["wall_s"],
                "p50_ms": percentile_ms(round1["latencies"], 50),
                "p99_ms": percentile_ms(round1["latencies"], 99)},
        round2={"wall_s": round2["wall_s"], "qps": n_q / round2["wall_s"],
                "p50_ms": percentile_ms(round2["latencies"], 50),
                "p99_ms": percentile_ms(round2["latencies"], 99),
                "device_busy_s": busy, "idle_share": 1 - busy / wall,
                "peak_above_resident_bytes": peak - resident, "resident_bytes": resident},
        burst_ms=burst_s * 1e3, serial_ms=serial_s * 1e3, view_build_s=view_build_s,
        view_refresh_ms=refresh_ms, view_refresh_alone_ms=shadow_ms, pairs_build_s=pairs_build_s,
        pairs_refresh_ms=pairs_ms, pairs_refresh_alone_ms=pair_shadow_ms, tcp_ms=tcp_ms,
        plan_cache=pc, fusion=fusion,
        queries_served=served, leg_s=time.perf_counter() - t_leg,
    )
    out["kernels"] = serve_kernels(torch, tag, srv, shapes)
    out["launches"] = {"serve": launches}
    say(tag, f"serve leg: {out['leg_s']:.1f} s")
    return out


def serve_tf32(torch, tag, tpch) -> dict:
    """The dense leg's TPCH bundle from 4 concurrent clients of a second
    server, 3 queries each, under a global ``allow_tf32 = True``: every
    einsum term must
    run with TF32 off (a spy on ``contract_term`` reads the switch before
    and after each term, with 1 ms between the read and the products to
    widen the window a lost restore would fall in; the data's integer
    products are exact even in TF32, so the bits alone cannot show it),
    every answer equals the dense leg's FP32 result bit for bit, and the
    setting is still on afterwards (``full_fp32_matmul`` is counted
    across threads)."""
    import threading

    from repro_torch.core import torch_engine
    from repro_torch.kernels import ops
    from repro_torch.serve import JoinAggServer

    db, q, dres = tpch
    spec = tpch_query(q, "torch")
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_tf32
    answers, errors, seen = [], [], []
    real = torch_engine.contract_term

    def spy(expr, operands):
        first = matmul.allow_tf32
        time.sleep(0.001)
        out = real(expr, operands)
        seen.append((first, matmul.allow_tf32))
        return out

    ops.reset_launch_counts()
    matmul.allow_tf32 = True
    try:
        with JoinAggServer(db, device="cuda", workers=SERVE_TF32_CLIENTS, fuse=False) as srv:
            plan = srv.plan_cache.lookup(spec, db)
            path = plan.engine.path(plan.prep, plan.channels)
            start = threading.Barrier(SERVE_TF32_CLIENTS, timeout=300)

            def client():
                start.wait()
                try:
                    for _ in range(SERVE_TF32_QUERIES):
                        answers.append(srv.query(spec))
                except Exception as e:
                    errors.append(repr(e))

            threads = [threading.Thread(target=client) for _ in range(SERVE_TF32_CLIENTS)]
            torch_engine.contract_term = spy
            try:
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=300)
            finally:
                torch_engine.contract_term = real
        still = matmul.allow_tf32
    finally:
        matmul.allow_tf32 = before
    launches = ops.launch_counts()
    same = (len(answers) == SERVE_TF32_CLIENTS * SERVE_TF32_QUERIES
            and all(same_result(dres, a) for a in answers))
    tf32_terms_seen = sum(a or b for a, b in seen)
    say(tag, f"check: serve leg: TPCH bundle ({path} path) from {SERVE_TF32_CLIENTS} concurrent "
             f"clients x {SERVE_TF32_QUERIES} queries with allow_tf32 = True set globally: "
             f"{len(seen)} einsum terms, {tf32_terms_seen} "
             f"of them with TF32 on at their start or end; {len(answers)} answers bit-identical "
             f"to the dense leg's FP32 result: {same}; allow_tf32 still True after: {still}; "
             f"errors {errors}")
    check(path == "dense", "serve leg: the TPCH bundle did not take the dense path")
    check(seen and tf32_terms_seen == 0, "serve leg: a concurrent dense term ran with TF32 on")
    check(same and still and not errors,
          "serve leg: concurrent dense queries under TF32 changed a result or lost the setting")
    return launches


def serve_cpu_check(torch, tag, args) -> None:
    """At ``--check-n``: the same clients against a ``device="cpu"`` server
    and a ``device="cuda"`` server, answer by answer, bit for bit."""
    from repro_torch.launch.serve import demo_database
    from repro_torch.serve import JoinAggServer

    db = demo_database(args.check_n, seed=args.seed)
    shapes = serve_shapes()
    runs = {}
    for device in ("cpu", "cuda"):
        with JoinAggServer(db, device=device, workers=SERVE_WORKERS, fusion_window=0.002) as srv:
            runs[device] = client_load(srv, shapes, SERVE_CLIENTS, SERVE_QUERIES_PER_CLIENT)
    same = all(
        name == runs["cuda"]["answers"][key][0]
        and same_result(res, runs["cuda"]["answers"][key][1])
        for key, (name, res, _) in runs["cpu"]["answers"].items()
    ) and len(runs["cpu"]["answers"]) == len(runs["cuda"]["answers"])
    say(tag, f"check: serve leg: C1 n={args.check_n}: {len(runs['cpu']['answers'])} answers "
             f"from a device='cpu' server bit-identical to a device='cuda' server: {same}")
    check(same, "serve leg: the cuda server's answers differ from the cpu server's")


def serve_kernels(torch, tag, srv, shapes) -> dict:
    """The served plans' own launches against the plain versions at
    tolerance 0 (every partial sum is an integer below 2**24): the
    largest ``segment_sum``, ``coo_spmm`` and ``segment_reduce`` launch of
    the five unfused cached shapes and the largest ``fused_hop`` of
    ``count_fused``, each timed beside its plain version, the library
    call and the bound.  These executes are not counted."""

    def cached(name):
        return srv.plan_cache.lookup(shapes[name], srv.db, srv.generation, srv.stats_generation)

    out, captured = {}, {}
    for shape in ("count", "sum", "multi", "minmax", "two_group"):
        for key, lc in capture_launches(cached(shape).execute, main_path_key).items():
            if key not in captured or lc.size > captured[key].size:
                captured[key] = lc
    for name in SEGMENT_KERNELS:
        launches = [lc for key, lc in captured.items() if isinstance(key, tuple) and key[0] == name]
        check(launches, f"serve leg: no {name} launch captured")
        out[name] = segment_regime(torch, tag, name, "largest served launch",
                                   max(launches, key=lambda lc: lc.size), path="serve leg")
    check("coo_spmm" in captured, "serve leg: no coo_spmm launch captured")
    out["coo_spmm"] = coo_spmm_row(torch, tag, "serve leg", "largest served launch",
                                   captured["coo_spmm"], tol=None)
    fused = capture_launches(cached("count_fused").execute, hop_class)
    check(fused, "serve leg: no fused_hop launch captured")
    out["fused_hop"] = fused_hop_row(torch, tag, "serve leg", fused)
    return out


def fused_hop_row(torch, tag, path: str, captured) -> dict:
    """The largest captured ``fused_hop`` launch (``hop_class`` keys)
    against its plain version at tolerance 0, timed beside the plain
    version, the library call of its hop class and the bound."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_hop import fused_hop

    (_, _, uniform), lc = max(captured.items(), key=lambda kv: kv[1].size)
    err = compare(torch, tag, "fused_hop", f"{path}, largest launch", fused_hop,
                  ref.fused_hop, lc.args)
    keys, w, msgs, idxs, s, k, kind = lc.args
    n = keys.shape[0]
    width, nbytes = 1, n * 8 + n * k * 4
    for msg, idx in zip(msgs, idxs):
        width *= msg.shape[1] // k
        nbytes += n * 8 + int(torch.unique(idx).numel()) * msg.shape[1] * 4
    nbytes += s * width * k * 4
    b, by = bound(nbytes, n * width * k * (len(msgs) + 1))
    library, library_ms = fused_library(torch, lc.args, uniform)
    row = dict(
        shapes={"edges": n, "k": k, "num_segments": s, "kind": kind,
                "messages": [list(m.shape) for m in msgs]},
        launches=lc.count, max_abs_err=err, ms=time_ms(torch, lambda: fused_hop(*lc.args)),
        plain_ms=time_ms(torch, lambda: ref.fused_hop(*lc.args), reps=3),
        library=library, library_ms=library_ms, bound_ms=b, bound_by=by,
    )
    say(tag, f"kernels: fused_hop [{path}] at {row['shapes']}: {row['ms']:.4f} ms, bound "
             f"{b:.4f} ms by {by}, plain {row['plain_ms']:.4f} ms, library {library} "
             f"{library_ms if library_ms is None else f'{library_ms:.4f}'} ms")
    return row


# ----------------------------------------------------------------------
# shard leg (the sharded path over torch.distributed)
# ----------------------------------------------------------------------

SHARD_COUNTS = (1, 2, 4)
SHARD_TIMEOUT_S = 480  # one group's ranks, spawn to exit


def result_digest(res) -> str:
    """sha256 over every column's name, dtype, shape and bytes: equal
    digests are results equal bit for bit."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for name, col in res.relation.columns.items():
        col = np.ascontiguousarray(col)
        if col.dtype == object:
            col = col.astype(str)
        h.update(f"{name}:{col.dtype.str}:{col.shape}:".encode())
        h.update(col.tobytes())
    return h.hexdigest()


def skew_chain_db(n: int, seed: int):
    """C1 at ``n`` rows with both group attributes folded onto 2 codes:
    over 4 shards of the root group attribute the last two own no rows.
    The measure is folded onto [0, 4), so that at 20,000 rows every
    group's COUNT and SUM stays below 2**24 (4 groups hold every path):
    float32 sums are then exact in any order, and bits can be compared."""
    from repro_torch.relational.relation import Database

    _, cols = chain_db(n, seed)
    cols["R1"]["g1"] = cols["R1"]["g1"] % 2
    cols["R4"]["g2"] = cols["R4"]["g2"] % 2
    cols["R3"]["m"] = cols["R3"]["m"] % 4
    return Database.from_mapping(cols)


def shard_rank(rank: int, world: int, out_dir: str, job: dict) -> None:
    """One rank of a shard-leg group (a process of its own): join the
    group through the ``file://`` store under ``out_dir`` and run
    :func:`shard_rank_run`; write its numbers to ``rank<r>.json``, or the
    traceback to ``rank<r>.err``, and exit non-zero on any failure."""
    import datetime
    import traceback

    import torch
    import torch.distributed as dist

    try:
        torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            job["backend"], init_method=f"file://{out_dir}/store", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S),
        )
        try:
            out = shard_rank_run(torch, dist, rank, world, job)
        finally:
            dist.destroy_process_group()
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))
    except BaseException:
        Path(out_dir, f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def shard_rank_run(torch, dist, rank: int, world: int, job: dict) -> dict:
    """The rank's part of the leg: the C1 bundle through ``Q ...
    .mesh(world).plan(db).execute()``, unfused then fused, each cold and
    warm with its launches counted from 0 over the cold execute and the
    walk and the all_gather timed apart; its answer must equal the
    parent's single-device execute bit for bit and Σ COUNT / Σ SUM
    numpy's.  With ``job["kernels"]`` every rank captures a warm
    execute's launches and rank 0 holds the largest against the plain
    versions; with ``job["skew"]`` a C1 whose last shards own no rows
    runs meshed and alone on this rank's card, bit for bit."""
    from repro_torch.core.distributed import DistributedSparseProgram
    from repro_torch.kernels import ops

    tag = job["tag"]
    # the group's ranks share the host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    ops.build()  # the parent built every library: this finds and loads them
    db, _ = chain_db(job["n"], job["seed"])
    spent = {"walk": 0.0, "gather": 0.0}

    def timed(name, fn):
        def run(self, *a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(self, *a)
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t0
            return r
        return run

    DistributedSparseProgram.walk = timed("walk", DistributedSparseProgram.walk)
    DistributedSparseProgram.gather = timed("gather", DistributedSparseProgram.gather)

    def execute(plan):
        spent.update(walk=0.0, gather=0.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = plan.execute()
        torch.cuda.synchronize()
        return res, {"ms": (time.perf_counter() - t0) * 1e3, "walk_ms": spent["walk"] * 1e3,
                     "gather_ms": spent["gather"] * 1e3}

    out = {"rank": rank, "device": torch.cuda.current_device(), "modes": {}, "kernels": {}}
    label = f"shard leg, S={world} rank {rank}"
    for fused in (False, True):
        mode = "fused" if fused else "unfused"
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        plan = bundle_query("torch").fused(fused).mesh(world).plan(db)
        prepare_s = time.perf_counter() - t0
        ops.reset_launch_counts()
        res, cold = execute(plan)
        launches = ops.launch_counts()
        res, warm = execute(plan)
        peak = torch.cuda.max_memory_allocated() - resident
        (prog,) = plan.prep.shard_programs.values()
        check(prog.num_shards == world and prog.axis.rank == rank,
              f"{label}: the program is shard {prog.axis.rank} of {prog.num_shards}")
        check(result_digest(res) == job["digest"],
              f"{label} {mode}: the gathered answer differs from the single-device execute")
        got = (int(res.column("n").sum()), int(res.column("s").sum()))
        check(got == tuple(job["totals"]), f"{label} {mode}: Σ count / Σ sum {got} vs numpy "
                                           f"{job['totals']}")
        want = ("fused_hop",) if fused else SEGMENT_KERNELS
        others = UNFUSED_KERNELS if fused else ("fused_hop",)
        check(all(launches[k] > 0 for k in want) and not any(launches[k] for k in others),
              f"{label} {mode}: launches {launches}")
        lo, hi = prog.ranges[rank]
        lines = plan.explain().splitlines()
        at = next(i for i, line in enumerate(lines) if line.startswith("torch path:"))
        end = next((j for j in range(at + 1, len(lines)) if not lines[j].startswith("  ")),
                   len(lines))
        check(lines[at].startswith("torch path: distributed-sparse"),
              f"{label} {mode}: {lines[at]}")
        out["modes"][mode] = {
            "path": lines[at:end],
            "prepare_s": prepare_s, "cold": cold, "warm": warm, "launches": launches,
            "peak_above_resident_bytes": peak, "resident_bytes": resident,
            "per_device_bytes": prog.per_device_bytes(), "range": [lo, hi],
            "tile": prog.tile, "rows": res.num_rows,
            "edges": {rel: er.num_rows for rel, er in prog.encoded.items()},
        }
        if job["kernels"]:
            # every rank takes part in the captured execute (a collective
            # call); rank 0 then holds its launches while the others wait
            captured = capture_launches(plan.execute, hop_class if fused else main_path_key)
            if rank == 0:
                out["kernels"].update(shard_kernels(torch, tag, f"shard leg, S={world}",
                                                    captured, fused))
            dist.barrier()
        del plan, res, prog

    if job["skew"]:
        sdb = skew_chain_db(job["check_n"], job["seed"])
        for fused in (False, True):
            q = bundle_query("torch").fused(fused)
            ops.reset_launch_counts()
            meshed = q.mesh(world).plan(sdb)
            res = meshed.execute()
            launches = ops.launch_counts()
            (prog,) = meshed.prep.shard_programs.values()
            alone = q.plan(sdb).execute()
            largest = max(float(abs(alone.column(c)).max()) for c in ("n", "s"))
            check(largest < 2**24, f"{label}: skewed C1 aggregate {largest} is past 2**24, "
                                   "where float32 sums depend on their order")
            same = same_result(res, alone)
            edges = {rel: er.num_rows for rel, er in prog.encoded.items()
                     if prog.attr in er.attrs}
            out.setdefault("skew", {})["fused" if fused else "unfused"] = {
                "ranges": prog.ranges, "edges": edges, "launches": launches,
                "same": same, "rows": res.num_rows,
            }
            check(same, f"{label}: skewed C1 meshed differs from the single-device execute")
            del meshed, res, alone, prog
    return out


def shard_kernels(torch, tag, path: str, captured, fused: bool) -> dict:
    """A rank's largest captured launches against their plain versions
    (tolerance 0), timed beside the plain version, the library call and
    the bound: ``segment_sum``, ``segment_reduce`` and ``coo_spmm`` of an
    unfused execute, or ``fused_hop`` of a fused one."""
    if fused:
        check(captured, f"{path}: no fused_hop launch captured")
        return {"fused_hop": fused_hop_row(torch, tag, path, captured)}
    out = {}
    for name in SEGMENT_KERNELS:
        launches = [lc for key, lc in captured.items() if isinstance(key, tuple) and key[0] == name]
        check(launches, f"{path}: no {name} launch captured")
        out[name] = segment_regime(torch, tag, name, "largest launch",
                                   max(launches, key=lambda lc: lc.size), path=path)
    if "coo_spmm" in captured:
        out["coo_spmm"] = coo_spmm_row(torch, tag, path, "largest launch",
                                       captured["coo_spmm"], tol=None)
    return out


def shard_group(world: int, job: dict, tmp: Path) -> tuple[list[dict], float]:
    """Spawn ``world`` ranks of :func:`shard_rank` and join them within
    ``SHARD_TIMEOUT_S``; every rank's numbers and the group's wall
    seconds.  A rank that fails, hangs or exits non-zero fails the leg
    (a hung rank is killed first)."""
    import multiprocessing

    out_dir = tmp / f"group{world}"
    out_dir.mkdir()
    ctx = multiprocessing.get_context("spawn")
    t0 = time.perf_counter()
    procs = [ctx.Process(target=shard_rank, args=(r, world, str(out_dir), job), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = t0 + SHARD_TIMEOUT_S
    for p in procs:
        p.join(timeout=max(deadline - time.perf_counter(), 0.1))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(timeout=30)
    errors = [(r, (out_dir / f"rank{r}.err").read_text()) for r in range(world)
              if (out_dir / f"rank{r}.err").exists()]
    codes = [p.exitcode for p in procs]
    check(not hung and not errors and not any(codes),
          f"shard leg, S={world}: hung ranks {hung}, exit codes {codes}\n"
          + "\n".join(f"rank {r}:\n{e}" for r, e in errors))
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(world)]
    return ranks, time.perf_counter() - t0


def shard_leg(torch, tag, args, digest: str, totals: tuple[int, int]) -> dict:
    """The sharded path on the card (DESIGN.md §8): C1 at ``--n`` rows,
    the main path's bundle through ``Q ... .mesh(S).plan(db).execute()``
    on groups of S = 1, 2 and 4 ranks, each a process that
    ``multiprocessing`` spawns on ``cuda:{rank % device_count}``; NCCL
    when there are at least S cards, gloo otherwise (which gathers on the
    host).  The parent built the kernels before, so no rank runs
    ``nvcc``.  Every rank's answer must equal the single-device execute
    (``digest``) bit for bit and Σ COUNT / Σ SUM numpy's (``totals``);
    every rank must launch ``segment_sum`` and ``segment_reduce``
    (unfused) or ``fused_hop`` (fused).  At S = 4 a C1 whose trailing
    shards own no rows runs too, and the ranks' largest launches are held
    against the plain versions.  Prints the backend, cold and warm
    execute ms split into the walk and the all_gather, each rank's peak
    above resident beside the S = 1 peak, and ``per_device_bytes()``."""
    import shutil
    import tempfile

    cards = torch.cuda.device_count()
    tmp = Path(tempfile.mkdtemp(prefix="repro-shard-leg-"))
    groups = {}
    try:
        for world in SHARD_COUNTS:
            backend = "nccl" if cards >= world else "gloo"
            job = {"n": args.n, "seed": args.seed, "check_n": args.check_n, "tag": tag,
                   "backend": backend, "digest": digest, "totals": list(totals),
                   "kernels": world == max(SHARD_COUNTS), "skew": world == max(SHARD_COUNTS)}
            ranks, seconds = shard_group(world, job, tmp)
            per_card = -(-world // cards)
            say(tag, f"shard leg: S={world}: backend {backend}, {world} rank(s) on "
                     f"{min(world, cards)} card(s), {per_card} per card; group {seconds:.1f} s "
                     "from spawn to exit")
            groups[world] = {"backend": backend, "seconds": seconds, "ranks": ranks}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    base = {mode: groups[1]["ranks"][0]["modes"][mode]["peak_above_resident_bytes"]
            for mode in ("unfused", "fused")}
    totals_by_kernel: dict[str, int] = {}
    summary = {}
    for world, g in groups.items():
        for line in g["ranks"][0]["modes"]["unfused"]["path"]:
            say(tag, f"shard leg: S={world}: {line}")
        for r in g["ranks"]:
            for mode, m in r["modes"].items():
                peak = m["peak_above_resident_bytes"]
                say(tag, f"shard leg: S={world} rank {r['rank']} {mode}: shard {m['range']} "
                         f"(tile {m['tile']}), edges {m['edges']}; cold {m['cold']['ms']:.1f} ms "
                         f"(walk {m['cold']['walk_ms']:.1f}, all_gather "
                         f"{m['cold']['gather_ms']:.1f}), warm {m['warm']['ms']:.1f} ms (walk "
                         f"{m['warm']['walk_ms']:.1f}, all_gather {m['warm']['gather_ms']:.1f}); "
                         f"prepare {m['prepare_s']:.2f} s; launches {m['launches']}")
                say(tag, f"shard leg: S={world} rank {r['rank']} {mode}: peak above resident "
                         f"{peak} B vs S=1 {base[mode]} B, ratio {peak / base[mode]:.3f}; "
                         f"per_device_bytes() {m['per_device_bytes']} B, "
                         f"{m['per_device_bytes'] / peak:.3f} of the measured peak")
                for k, v in m["launches"].items():
                    totals_by_kernel[k] = totals_by_kernel.get(k, 0) + v
            for mode, sk in r.get("skew", {}).items():
                empty = sum(1 for lo, hi in sk["ranges"] if hi == lo)
                say(tag, f"shard leg: S={world} rank {r['rank']} skewed C1 n={args.check_n} "
                         f"{mode}: shards {sk['ranges']} ({empty} own no rows), this rank's "
                         f"sharded edges {sk['edges']}, launches {sk['launches']}, "
                         f"{sk['rows']} rows bit-identical to the single-device execute: "
                         f"{sk['same']}")
        summary[f"S={world}"] = {
            "backend": g["backend"], "seconds": g["seconds"],
            "ranks": [{mode: {k: m[k] for k in ("cold", "warm", "peak_above_resident_bytes",
                                               "per_device_bytes", "launches")}
                       for mode, m in r["modes"].items()} for r in g["ranks"]],
        }
    kernels = groups[max(SHARD_COUNTS)]["ranks"][0]["kernels"]
    for name in ("segment_sum", "segment_reduce", "fused_hop"):
        check(name in kernels, f"shard leg: {name} was not held against its plain version")
    summary["launches"] = {"shard": {k: totals_by_kernel.get(k, 0) for k in KERNEL_SOURCES}}
    summary["kernels"] = kernels
    return summary


# ----------------------------------------------------------------------
# comparison leg (the paper's Tables II and III on the card)
# ----------------------------------------------------------------------

ORACLE_N = 100_000  # the C1 bundle's oracle check: a join of about 10**8 rows


def measured(torch, fn):
    """``fn()`` on the card: its result, the synchronised wall ms and the
    device peak above what was allocated before the call."""
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return out, ms, torch.cuda.max_memory_allocated() - resident


def comparison_leg(torch, tag, args) -> dict:
    """The paper's comparison on the card, through the port's own copies
    of the reference's baselines and oracle (``benchmarks/tables.py``
    imports the JAX package's).  Table III: S1, S2 and S3 at ``--n``,
    ``join_agg`` cold and warm, ``binary_join_agg`` and
    ``preagg_join_agg``, each with its synchronised wall ms, device peak
    above resident and largest intermediate; the three answers must be
    equal.  Table II: B2 at the reference's five sizes (``--n`` / 16 …
    ``--n``), ``join_agg`` against ``preagg_join_agg`` on peak and ms,
    equal answers.  The oracle on the card holds S3's ``join_agg`` answer
    and the main path's C1 bundle at ``ORACLE_N`` rows group by group;
    at ``--check-n`` every baseline and oracle call on the card equals
    the same call with ``device="cpu"``, answers and statistics."""
    import numpy as np

    from repro_torch.aggregates.semiring import Avg, Count, Max, Min, Sum
    from repro_torch.baselines import binary_join_agg, preagg_join_agg
    from repro_torch.core import join_agg
    from repro_torch.data import synth
    from repro_torch.kernels import ops
    from repro_torch.relational.oracle import oracle_joinagg, oracle_multiagg

    t_leg = time.perf_counter()
    launches = dict.fromkeys(ops.KERNELS, 0)

    def joinagg(q, db):
        ops.reset_launch_counts()
        res = join_agg(q, db)
        torch.cuda.synchronize()
        for name, count in ops.launch_counts().items():
            launches[name] += count
        return res

    def row(table, label, ms, peak, stats):
        interm = ("none materialised" if stats is None else
                  f"max_intermediate_rows {stats.max_intermediate_rows}, "
                  f"max_intermediate_bytes {stats.max_intermediate_bytes}")
        say(tag, f"comparison leg: {table}: {label}: {ms:.1f} ms, peak above resident "
                 f"{peak} B, {interm}")
        return {"ms": ms, "peak_above_resident_bytes": peak,
                "max_intermediate_rows": None if stats is None else stats.max_intermediate_rows,
                "max_intermediate_bytes": None if stats is None else stats.max_intermediate_bytes}

    summary: dict = {"table3": {}, "table2": {}, "part_seconds": {}}
    s3_answer = None
    t_part = time.perf_counter()

    def part_done(part: str) -> None:
        nonlocal t_part
        now = time.perf_counter()
        summary["part_seconds"][part] = now - t_part
        t_part = now

    for name in synth.SELF_JOIN:
        db, q = synth.make(name, args.n, seed=args.seed)
        label = f"Table III {name} n={args.n}"
        out = {}
        answers = {}
        for method, fn in (("joinagg cold", lambda: (joinagg(q, db), None)),
                           ("joinagg warm", lambda: (joinagg(q, db), None)),
                           ("binary", lambda: binary_join_agg(q, db)),
                           ("preagg", lambda: preagg_join_agg(q, db))):
            torch.cuda.empty_cache()
            (answers[method], stats), ms, peak = measured(torch, fn)
            out[method] = row(label, method, ms, peak, stats)
        want = answers["joinagg warm"]
        same = all(a == want for a in answers.values())
        say(tag, f"check: comparison leg: {label}: {len(want)} groups, Σ count "
                 f"{sum(want.values()):.0f}; JOIN-AGG, binary and pre-aggregation give the "
                 f"same groups and equal counts: {same}; peak binary / JOIN-AGG "
                 f"{out['binary']['peak_above_resident_bytes'] / out['joinagg warm']['peak_above_resident_bytes']:.1f}, "
                 f"preagg / JOIN-AGG "
                 f"{out['preagg']['peak_above_resident_bytes'] / out['joinagg warm']['peak_above_resident_bytes']:.1f}")
        check(same and len(want) > 0, f"comparison leg: {label}: the three answers differ")
        summary["table3"][name] = out
        if name == "S3":
            s3_answer, s3 = want, (db, q)
        del answers, want
    part_done("table3")

    sizes = [max(500, args.n // 16), args.n // 8, args.n // 4, args.n // 2, args.n]
    for i, size in enumerate(sizes, start=1):
        db, q = synth.make("B2", size, seed=args.seed)
        label = f"Table II B2 P{i} n={size}"
        torch.cuda.empty_cache()
        ja, ms_j, peak_j = measured(torch, lambda: joinagg(q, db))
        torch.cuda.empty_cache()
        (pa, stats), ms_p, peak_p = measured(torch, lambda: preagg_join_agg(q, db))
        out = {"joinagg": row(label, "joinagg", ms_j, peak_j, None),
               "preagg": row(label, "preagg", ms_p, peak_p, stats)}
        same = ja == pa
        say(tag, f"check: comparison leg: {label}: {len(ja)} groups; JOIN-AGG = "
                 f"pre-aggregation: {same}; peak preagg / JOIN-AGG {peak_p / peak_j:.1f}, ms "
                 f"preagg / JOIN-AGG {ms_p / ms_j:.2f}")
        check(same and len(ja) > 0, f"comparison leg: {label}: the answers differ")
        summary["table2"][f"P{i}"] = {"rows": size, **out}
    part_done("table2")

    # the oracle on the card
    db, q = s3
    torch.cuda.empty_cache()
    want, ms, peak = measured(torch, lambda: oracle_joinagg(q, db))
    same = want == s3_answer
    say(tag, f"check: comparison leg: oracle_joinagg S3 n={args.n}: {ms:.1f} ms, peak above "
             f"resident {peak} B; {len(want)} groups, JOIN-AGG's answer equal group by "
             f"group: {same}")
    check(same, "comparison leg: S3: JOIN-AGG differs from the oracle")
    summary["oracle S3"] = {"ms": ms, "peak_above_resident_bytes": peak}
    del s3_answer, want

    oracle_n = min(ORACLE_N, args.n)
    bundle = {"n": Count(), "s": Sum("R3", "m"), "a": Avg("R3", "m"),
              "lo": Min("R3", "m"), "hi": Max("R3", "m")}
    rels, groups = ("R1", "R2", "R3", "R4"), (("R1", "g1"), ("R4", "g2"))
    db, cols = chain_db(oracle_n, args.seed)
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    res = bundle_query("torch").plan(db).execute()
    torch.cuda.synchronize()
    for name, count in ops.launch_counts().items():
        launches[name] += count
    want, ms, peak = measured(torch, lambda: oracle_multiagg(rels, groups, bundle, db))
    got = {key: {name: float(res.column(name)[i]) for name in bundle}
           for i, key in enumerate(res.group_tuples())}
    exact = set(got) == set(want) and all(
        got[k][name] == w[name] for k, w in want.items() for name in ("n", "s", "lo", "hi")
    )
    avg_ulps = max(abs(got[k]["a"] - w["a"]) / np.spacing(w["a"]) for k, w in want.items())
    joined = int(sum(w["n"] for w in want.values()))
    say(tag, f"check: comparison leg: oracle_multiagg C1 bundle n={oracle_n}: {ms:.1f} ms, "
             f"peak above resident {peak} B, join of {joined} rows, {len(want)} groups; "
             f"COUNT, SUM, MIN and MAX equal group by group: {exact}; AVG within "
             f"{avg_ulps:.1f} ulp")
    check(exact and avg_ulps <= 1.0 and len(want) > 0,
          "comparison leg: the C1 bundle differs from the oracle")
    summary["oracle C1 bundle"] = {"n": oracle_n, "ms": ms, "peak_above_resident_bytes": peak,
                                   "join_rows": joined}
    del res, want, got
    part_done("oracle")

    # card = CPU at --check-n: every baseline and oracle call, answers and statistics
    calls = []
    for name in ("S2", "S3", "B2"):
        db, q = synth.make(name, args.check_n, seed=args.seed)
        if name != "B2":
            calls.append((f"binary_join_agg {name}", binary_join_agg, (q, db)))
            calls.append((f"oracle_joinagg {name}", oracle_joinagg, (q, db)))
        calls.append((f"preagg_join_agg {name}", preagg_join_agg, (q, db)))
    db, _ = chain_db(args.check_n, args.seed)
    calls.append(("oracle_multiagg C1 bundle", oracle_multiagg, (rels, groups, bundle, db)))
    for label, fn, fargs in calls:
        ops.reset_launch_counts()
        gpu = fn(*fargs)
        check(not any(ops.launch_counts().values()),
              f"comparison leg: {label} launched a kernel")
        cpu = fn(*fargs, device="cpu")
        if isinstance(gpu, tuple):
            same = gpu[0] == cpu[0] and vars(gpu[1]) == vars(cpu[1])
            detail = f"statistics {vars(gpu[1])['max_intermediate_rows']} rows, "
        else:
            same, detail = gpu == cpu, ""
        say(tag, f"check: comparison leg: {label} n={args.check_n}: {detail}answers"
                 f"{' and statistics' if detail else ''} equal to device='cpu': {same}")
        check(same, f"comparison leg: {label}: cuda differs from cpu")
    part_done("card = cpu")

    for name in ("segment_sum", "coo_spmm", "segment_reduce"):
        check(launches[name] > 0, f"comparison leg: JOIN-AGG never launched {name}")
    seconds = time.perf_counter() - t_leg
    say(tag, f"comparison leg: JOIN-AGG launches {launches}; the leg took {seconds:.1f} s "
             f"({', '.join(f'{k} {v:.1f} s' for k, v in summary['part_seconds'].items())})")
    summary["seconds"] = seconds
    summary["launches"] = {"comparison": launches}
    return summary


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=500_000, help="rows per relation")
    ap.add_argument("--check-n", type=int, default=20_000,
                    help="rows per relation of the CPU bit-identity check")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--storage-n", type=int, default=5_000_000,
                    help="rows per relation of the storage leg")
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
            if ("registers" in line or "spill" in line or "stack frame" in line
                    or (name == "semiring_matmul" and "entry function" in line)):
                say(tag, f"build: {name}: {line.strip()}")

    # 2. main path (unfused) ---------------------------------------------
    db, cols = chain_db(args.n, args.seed)
    say(tag, f"data: C1 n={args.n} seed={args.seed}")
    plan, res, main = drive(torch, tag, "main path", lambda: bundle_query("torch").plan(db))
    say(tag, f"main path: root with statistics on (the default): "
             f"{plan.prep.decomposition.root}")
    launches = main["launches"]
    for name in UNFUSED_KERNELS:
        check(launches[name] > 0, f"main path never launched {name}")
    check(launches["fused_hop"] == 0, "the unfused main path launched fused_hop")
    check(launches["semiring_matmul"] == 0, "the main path launched semiring_matmul")
    main["paths"] = check_paths(tag, "main path", plan, launches)

    # 3. fused path -------------------------------------------------------
    fplan, fres, fused = drive(
        torch, tag, "fused path", lambda: bundle_query("torch").fused(True).plan(db)
    )
    flaunches = fused["launches"]
    hops = len(fplan.prep.decomposition.nodes)
    passes = 1 + len(fplan.minmax)
    fstream = fplan.resolved_stream()
    tiles = 1 if fstream is None else -(-fplan.prep.dicts[fstream[0]].size // fstream[1])
    say(tag, f"fused path: launches reckoned as {hops} hops x {passes} passes (1 "
             f"channel pass + {len(fplan.minmax)} MIN/MAX) x {tiles} stream tiles = "
             f"{hops * passes * tiles}; counted {flaunches['fused_hop']}")
    check(flaunches["fused_hop"] > 0, "fused path never launched fused_hop")
    check(flaunches["fused_hop"] == hops * passes * tiles,
          "fused_hop launches differ from hops x passes x stream tiles")
    for name in UNFUSED_KERNELS + ("semiring_matmul",):
        check(flaunches[name] == 0, f"fused path launched {name}")
    fused["paths"] = check_paths(tag, "fused path", fplan, flaunches)
    check_launch_shapes(torch, tag, "fused path", fplan)
    for p in (plan, fplan):
        verified(tag, "main and fused paths", p)

    # 4. correctness -----------------------------------------------------
    want_n, want_s = chain_totals(cols)
    for label, r in (("main path", res), ("fused path", fres)):
        got_n, got_s = r.column("n").sum(), r.column("s").sum()
        say(tag, f"check: {label}: Σ count {got_n:.0f} vs numpy {want_n}; Σ sum "
                 f"{got_s:.0f} vs numpy {want_s}")
        check(got_n == want_n and got_s == want_s,
              f"{label}: Σ count / Σ sum disagree with numpy")
        check(r.num_rows > 0, f"{label}: empty result")
        for name in r.agg_names:
            check(bool(np.isfinite(r.column(name)).all()),
                  f"{label}: non-finite values in {name}")
    same = same_result(res, fres)
    say(tag, f"check: fused path: {fres.num_rows} rows, every column bit-identical "
             f"to the unfused main path: {same}")
    check(same, "fused result differs from the unfused result")

    small, _ = chain_db(args.check_n, args.seed)
    for label, fuse in (("main path", None), ("fused path", True)):
        gq = bundle_query("torch")
        cq = bundle_query(TorchChannelEngine(device="cpu"))
        if fuse:
            gq, cq = gq.fused(True), cq.fused(True)
        gpu, cpu = gq.plan(small).execute(), cq.plan(small).execute()
        same = same_result(gpu, cpu)
        say(tag, f"check: {label}: C1 n={args.check_n}: {cpu.num_rows} rows, "
                 f"{len(cpu.relation.columns)} columns bit-identical to device='cpu': "
                 f"{same}")
        check(same and gpu.num_rows == cpu.num_rows,
              f"{label}: cuda result differs from cpu result")

    # 5. kernels vs plain, at the paths' shapes --------------------------
    captured = capture_launches(plan.execute, main_path_key)
    check("coo_spmm" in captured, "no coo_spmm launch captured")
    for name in SEGMENT_KERNELS:
        check(any(key[0] == name for key in captured if isinstance(key, tuple)),
              f"no {name} launch captured")
    results = kernel_phase(torch, tag, captured)
    results["fused_hop"] = fused_phase(torch, tag, capture_launches(fplan.execute, hop_class))
    results["semiring_matmul"] = semiring_phase(torch, tag)
    for name, errs in gather_phase(torch, tag).items():
        results[name]["max_abs_err"] = max([results[name]["max_abs_err"]] + errs)

    # 6. split leg, 7. cyclic leg, 8. dense leg, 9. explain --------------
    main_digest = result_digest(res)
    del plan, fplan, res, fres, captured
    torch.cuda.empty_cache()
    split = split_leg(torch, tag, args)
    cyclic = cyclic_leg(torch, tag, args)
    dense = dense_leg(torch, tag, args)
    tpch = dense.pop("tpch")
    explain_phase(torch, tag, args.seed)

    # 10. maintain leg -----------------------------------------------------
    torch.cuda.empty_cache()
    maintain = maintain_leg(torch, tag, args)
    for name, row in maintain_kernels(torch, tag, maintain.pop("captured")).items():
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], row["max_abs_err"])
        results[name]["maintain"] = row

    # 11. storage leg ------------------------------------------------------
    torch.cuda.empty_cache()
    stored = storage_leg(torch, tag, args)
    for name, row in stored.pop("kernels").items():
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], row["max_abs_err"])
        results[name]["storage"] = row

    # 12. serve leg --------------------------------------------------------
    torch.cuda.empty_cache()
    served = serve_leg(torch, tag, args, tpch)
    del tpch
    for name, row in served.pop("kernels").items():
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], row["max_abs_err"])
        results[name]["serve"] = row

    # 13. shard leg --------------------------------------------------------
    torch.cuda.empty_cache()
    sharded = shard_leg(torch, tag, args, main_digest, (want_n, want_s))
    for name, row in sharded.pop("kernels").items():
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], row["max_abs_err"])
        results[name]["shard"] = row

    # 14. comparison leg ---------------------------------------------------
    torch.cuda.empty_cache()
    compared = comparison_leg(torch, tag, args)

    legs = {"main": launches, "fused": flaunches}
    for leg in (split, cyclic, dense, maintain, stored, served, sharded, compared):
        legs.update(leg.pop("launches"))
    for label, summary in (("main path", main), ("fused path", fused), *split.items(),
                           *cyclic.items(), *dense.items(), *maintain.items(),
                           *(("storage leg, " + k, v) for k, v in stored.items()),
                           ("serve leg", served), ("shard leg", sharded),
                           ("comparison leg", compared)):
        say(tag, f"{label} summary: {json.dumps(summary)}")
    paths = {name: "main" for name in UNFUSED_KERNELS}
    paths.update(fused_hop="fused", semiring_matmul=None)
    counts = {name: launches[name] for name in UNFUSED_KERNELS}
    counts.update(fused_hop=flaunches["fused_hop"], semiring_matmul=0)
    kernels = []
    for name in ops.KERNELS:
        r = results[name]
        src, replaces = KERNEL_SOURCES[name]
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": counts[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shapes": r["shapes"], "path": paths[name],
            "leg_launches": {leg: counts_of[name] for leg, counts_of in legs.items()},
        }
        if name in SEGMENT_KERNELS:
            entry.update(regimes=r["regimes"], launches_by_width=r["launches_by_width"])
        if name == "coo_spmm":
            entry.update(walk=r["walk"])
        for leg in ("maintain", "storage", "serve", "shard"):
            if leg in r:
                entry[leg] = r[leg]
        if name == "fused_hop":
            entry.update(three_dispatch_ms=r["three_dispatch_ms"], library=r["library"],
                         hops=r["hops"], walk=r["walk"])
        if name == "semiring_matmul":
            entry.update(note="no path launches it; held and timed on its own",
                         semirings=r["semirings"])
        kernels.append(entry)
    print(tag, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
