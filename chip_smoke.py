#!/usr/bin/env python3
"""Smoke test of the repro_torch port on one NVIDIA card.

    python3 chip_smoke.py [--n 500000] [--check-n 20000] [--seed 0]

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
   ``count_rtol`` above it) and, at 4,000 edges, card = CPU bit for bit.

The last three lines of standard output are the card's name and power
limit, one JSON object of per-kernel numbers (with each kernel's launches
in every leg), and ``{"ok": true, "device": {...}}``.  Any failed check
exits non-zero.
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


def compare(torch, tag, name, label, kernel, plain, args, kw=None, out=None):
    """Run ``kernel`` and ``plain`` on the same inputs; fail unless they
    agree exactly.  With ``out`` (a view into a larger buffer), the kernel
    writes there and must leave the rest of the buffer as it was.
    Returns max |kernel - plain|."""
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
    say(tag, f"kernels: {name} [{label}] args {[shape(a) for a in args]} {kw}{where}: "
             f"max |kernel - plain| = {err} (tolerance 0)")
    check(err == 0.0, f"{name} [{label}] disagrees with its plain version: {err}")
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


def segment_regime(torch, tag, name, label, launch):
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
    err = compare(torch, tag, name, f"main path, {label}", kernel, plain, args, out=out)
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
        library, library_ms = None, None
        if nchild == 0 and kind == "sum":
            library = "index_add_"
            library_ms = time_ms(
                torch, lambda: torch.zeros((s, k), device=dev).index_add_(0, keys, w)
            )
        elif nchild == 0:
            ident = float("inf") if kind == "min" else float("-inf")
            library = f"scatter_reduce_ a{kind}"
            library_ms = time_ms(
                torch,
                lambda: torch.full((s, 1), ident, device=dev).scatter_reduce_(
                    0, keys[:, None], w, f"a{kind}", include_self=True
                ),
            )
        elif nchild == 1 and kind == "sum" and uniform:
            library = "torch.sparse.mm, CSR"
            library_ms = csr_spmm_ms(torch, keys, idxs[0], w[:, 0].contiguous(), msgs[0], s)
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
    for name in ("segment_sum", "coo_spmm"):
        check(split["launches"][name] > 0, f"split leg never launched {name}")
    uplan, ures, unsplit = drive(
        torch, tag, "split leg, stats(False)", lambda: Q.from_query(q).stats(False).plan(db)
    )
    check(uplan.split is None, "the stats(False) plan split")
    same = same_result(sres, ures)
    say(tag, f"check: split leg: split = unsplit bit for bit: {same}; peak device memory "
             f"above resident {split['peak_above_resident_bytes']} B split vs "
             f"{unsplit['peak_above_resident_bytes']} B unsplit")
    check(same, "split result differs from the unsplit result")
    want = skew_total(db)
    got = sres.column("count").sum()
    say(tag, f"check: split leg: Σ count {got:.0f} vs numpy {want}")
    check(got == want and sres.num_rows > 0, "split leg: Σ count disagrees with numpy")

    ops.reset_launch_counts()
    fres = Q.from_query(q).fused(True).plan(db).execute()
    flaunches = ops.launch_counts()
    say(tag, f"check: split leg, fused: launches {flaunches}; bit-identical to unfused: "
             f"{same_result(sres, fres)}")
    check(same_result(sres, fres), "fused split result differs from the unfused one")
    check(flaunches["fused_hop"] > 0 and all(flaunches[k] == 0 for k in UNFUSED_KERNELS),
          "the fused split plan did not run on fused_hop alone")

    small, sq = skewed_chain_like(args.check_n, seed=args.seed)
    gplan = Q.from_query(sq).plan(small)
    cplan = Q.from_query(sq).engine(TorchChannelEngine(device="cpu")).plan(small)
    gpu, cpu = gplan.execute(), cplan.execute()
    same = same_result(gpu, cpu) and gplan.split is not None and cplan.split == gplan.split
    say(tag, f"check: split leg: SKEWCHAIN n={args.check_n}: split {gplan.split.describe()}; "
             f"{cpu.num_rows} rows bit-identical to device='cpu': {same}")
    check(same, "split leg: cuda result differs from cpu result")
    return {"split": split, "split, stats(False)": unsplit,
            "launches": {"split": split["launches"], "split, stats(False)": unsplit["launches"],
                         "split, fused": flaunches}}


def cyclic_leg(torch, tag, args) -> dict:
    """TRIANGLE, FOURCYCLE and FOFGROUP through the GHD compiler: host
    bag build against warm execute on the card, each count against
    ``scipy.sparse``, each card result against the CPU's."""
    from repro_torch.api import Q, TorchChannelEngine
    from repro_torch.data.queries import CYCLIC

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
        check(sum(summary["launches"].values()) > 0, f"{label} launched no kernel")
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
        out[label] = summary
        out["launches"][label] = summary["launches"]
        del plan, res
    return out


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

    # 6. split leg and 7. cyclic leg -------------------------------------
    del plan, fplan, res, fres, captured
    torch.cuda.empty_cache()
    split = split_leg(torch, tag, args)
    cyclic = cyclic_leg(torch, tag, args)

    legs = {"main": launches, "fused": flaunches}
    legs.update(split.pop("launches"))
    legs.update(cyclic.pop("launches"))
    for label, summary in (("main path", main), ("fused path", fused), *split.items(),
                           *cyclic.items()):
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
