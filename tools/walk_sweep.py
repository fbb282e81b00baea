#!/usr/bin/env python3
"""Launch-shape sweep of the sorted-run walk on one CUDA card.

    python3 tools/walk_sweep.py [--seed 0] [--out build/walk_sweep.json]

Run from the root of a checkout.  For the shapes the C1 n=500,000 bundle
launches the walk with (leaf hops: ~500,000 edges into 112,500,000 rows of
d = 1 or 2; edge chunks: a few thousand edges into a few hundred rows of
d = 2,250 or 4,500; the ``coo_spmm`` hop: 499,948 edges into 50,000 rows of
d = 4,500, gathering from a (50000, 4500) message), it builds synthetic
inputs of the same sizes from ``--seed``, then launches the kernels' C
entry points with each candidate launch plan (``kernels/ops.py:WalkPlan``,
an argument, so no rebuild) and prints the device time of each beside
``ops.walk_plan``'s choice.  Every plan's output must equal the chosen
plan's bit for bit.  Integer-valued float32, so every sum is exact.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SPIN_CYCLES = 100_000_000


def plan_of(num_rows: int, d: int, narrow: bool, rows: int, slabs: int):
    """A WalkPlan with the given tile rows and slab count."""
    from repro_torch.kernels import ops

    rows = min(rows, num_rows)
    slab = d if slabs == 1 else 4 * -(-d // (4 * slabs))
    slabs = -(-d // slab)
    smem = 0 if narrow else 8 * rows
    return ops.WalkPlan(rows, slab, slabs, -(-num_rows // rows) * slabs, smem, int(narrow))


def check(rc: int) -> None:
    """Raise if a launch was refused (the sweep counts no launches)."""
    if rc != 0:
        raise RuntimeError(f"launch failed with cudaError_t {rc}")


def time_ms(torch, fn, reps: int = 20) -> float:
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="build/walk_sweep.json")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("walk_sweep: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import ops, segment_reduce as sr, segment_sum as ss
    from repro_torch.kernels import coo_spmm as cs

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(args.seed)
    stream = ops.stream_of(dev)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g).to(dev)

    def keys(n, s):
        return torch.sort(ints(0, s, (n,))).values.contiguous()

    libraries = {}  # the PyTorch call computing the same, as chip_smoke.py times it
    seg_sum = ops.load("segment_sum", "repro_segment_sum", ss._ARGTYPES)
    seg_red = ops.load("segment_reduce", "repro_segment_reduce", sr._ARGTYPES)
    spmm = ops.load("coo_spmm", "repro_coo_spmm", cs._ARGTYPES)

    def segment(kind, n, s, d):
        data, ids = ints(-50, 50, (n, d)).float(), keys(n, s)
        out = torch.empty((s, d), device=dev)
        if kind == "sum":
            libraries[(n, s, d)] = lambda: torch.zeros((s, d), device=dev).index_add_(0, ids, data)
        else:
            index = ids[:, None].expand(n, d)
            libraries[(n, s, d)] = lambda: torch.full((s, d), float("inf"), device=dev).scatter_reduce_(
                0, index, data, "amin", include_self=True)

        def run(plan):
            if kind == "sum":
                rc = seg_sum(0, data.data_ptr(), ids.data_ptr(), n, d, s,
                             out.data_ptr(), ctypes.byref(plan), stream)
            else:
                rc = seg_red(0, data.data_ptr(), ids.data_ptr(), n, d, s, 0,
                             out.data_ptr(), ctypes.byref(plan), stream)
            check(rc)
            return out

        return run

    def coo(n, s, d):
        rows, cols = keys(n, s), ints(0, s, (n,))
        vals, dense = ints(1, 9, (n,)).float(), ints(-3, 4, (s, d)).float()
        out = torch.empty((s, d), device=dev)

        def run(plan):
            rc = spmm(0, rows.data_ptr(), cols.data_ptr(), vals.data_ptr(), n,
                      dense.data_ptr(), s, d, s, out.data_ptr(), ctypes.byref(plan), stream)
            check(rc)
            return out

        return run

    cases = [
        ("leaf min d=1", segment("min", 498_847, 112_500_000, 1), 498_847, 112_500_000, 1,
         [(True, r, 1) for r in (4096, 8192, 16384, 32768)]),
        ("leaf sum d=2", segment("sum", 498_847, 112_500_000, 2), 498_847, 112_500_000, 2,
         [(True, r, 1) for r in (2048, 4096, 8192, 16384)]),
        ("chunk min d=2250", segment("min", 7455, 766, 2250), 7455, 766, 2250,
         [(False, r, sl) for r in (1, 2, 4) for sl in (1, 2, 3, 5)]),
        ("chunk sum d=4500", segment("sum", 3725, 389, 4500), 3725, 389, 4500,
         [(False, r, sl) for r in (1, 2, 4) for sl in (1, 3, 5, 9)]),
        ("coo_spmm d=4500", coo(499_948, 50_000, 4500), 499_948, 50_000, 4500,
         [(False, r, sl) for r in (1, 2, 4) for sl in (1, 2, 3, 5)]),
    ]
    results = []
    for label, run, n, s, d, candidates in cases:
        chosen = ops.walk_plan(n, s, d)
        want = run(chosen).clone()
        chosen_ms = time_ms(torch, lambda: run(chosen))
        library = libraries.get((n, s, d))
        library_ms = None if library is None else time_ms(torch, library)
        print(f"{label}: walk_plan {chosen}: {chosen_ms:.4f} ms; library {library_ms} ms "
              f"[{card}]", flush=True)
        rows = []
        for narrow, r, sl in candidates:
            plan = plan_of(s, d, narrow, r, sl)
            got = run(plan)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                print(f"{label}: {plan} disagrees with walk_plan's result", file=sys.stderr)
                return 1
            ms = time_ms(torch, lambda: run(plan))
            rows.append({"plan": repr(plan), "ms": ms})
            print(f"{label}:   {plan}: {ms:.4f} ms", flush=True)
        results.append({"case": label, "n": n, "num_rows": s, "d": d,
                        "walk_plan": repr(chosen), "walk_plan_ms": chosen_ms,
                        "library_ms": library_ms,
                        "candidates": rows})
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"card": card, "cases": results}, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
