#!/usr/bin/env python3
"""Launch-shape sweep of the two sorted-run walks and of
``semiring_matmul``'s tile loop on one CUDA card.

    python3 tools/walk_sweep.py [--seed 0] [--cases all|segment|gather|matmul]
                                [--out build/walk_sweep.json]

Run from the root of a checkout.  For the shapes the C1 n=500,000 bundle
launches the walks with, it builds synthetic inputs of the same sizes from
``--seed``, then launches the kernels' C entry points with each candidate
launch plan (an argument, so no rebuild) and prints the device time of
each beside the plan that ``kernels/ops.py`` chooses.  Every candidate's
output must equal the chosen plan's bit for bit.  Integer-valued float32,
so every sum is exact.

* ``segment``: the sorted-run tile walk (``ops.walk_plan``) of the leaf
  hops (~500,000 edges into 112,500,000 rows of d = 1 or 2) and the edge
  chunks (a few thousand edges into a few hundred rows of d = 2,250 or
  4,500).
* ``gather``: the slab-major warp walk (``ops.gather_plan``) of
  ``coo_spmm`` (499,948 edges into 50,000 rows of d = 4,500, gathering
  from a (50000, 4500) operand) and of the one-child ``fused_hop`` hops
  (sum with k = 2 at d = 4,500; min and max at d = 2,250), over slab
  width, edges in flight, rows and warps per block, and slab-major or
  tile-major block order.  Three probes time the ``coo_spmm`` walk with
  the chosen plan on other data and are not compared: every column out
  of range (no gathers: the search, marking and stores alone), an
  operand of 1,000 rows (18 MB: every gather hits L2), and every edge on
  one operand row (gathers that hit L1).
* ``matmul``: ``semiring_matmul``'s tile loop (``ops.matmul_plan``) at
  (2048, 2048) x (2048, 2048) for every semiring and at (3000, 1000) x
  (1000, 2500) for ``add_mul``, over every block tile the kernel is built
  for, and, at the chosen tile, 8- and 4-byte accesses on the same
  16-byte-aligned operands (what misaligned operands would cost).
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import subprocess
import sys
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SPIN_CYCLES = 100_000_000


def walk_plan_of(num_rows: int, d: int, narrow: bool, rows: int, slabs: int):
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
    ap.add_argument("--cases", choices=("all", "segment", "gather", "matmul"), default="all")
    ap.add_argument("--out", default="build/walk_sweep.json")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("walk_sweep: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import ops, segment_reduce as sr, segment_sum as ss
    from repro_torch.kernels import coo_spmm as cs, fused_hop as fh, semiring_matmul as sm

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
    alive = []  # inputs that no closure holds, kept for the whole sweep
    seg_sum = ops.load("segment_sum", "repro_segment_sum", ss._ARGTYPES)
    seg_red = ops.load("segment_reduce", "repro_segment_reduce", sr._ARGTYPES)
    spmm = ops.load("coo_spmm", "repro_coo_spmm", cs._ARGTYPES)
    one_child = ops.load("fused_hop", "repro_fused_hop_one_child", fh._ONE_CHILD_ARGTYPES)
    mm = ops.load("semiring_matmul", "repro_semiring_matmul", sm._ARGTYPES)

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

    def coo(n, s, d, probe=None, operand_rows=None):
        rows = keys(n, s)
        cols = ints(0, s, (n,)) if probe is None else probe
        vals = ints(1, 9, (n,)).float()
        dense = ints(-3, 4, (operand_rows or s, d)).float()
        out = torch.empty((s, d), device=dev)
        if probe is None:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                mat = torch.sparse_coo_tensor(
                    torch.stack([rows, cols]), vals, (s, s)
                ).coalesce().to_sparse_csr()
            libraries[("coo", n, s, d)] = lambda: torch.sparse.mm(mat, dense)

        def run(plan):
            rc = spmm(0, rows.data_ptr(), cols.data_ptr(), vals.data_ptr(), n,
                      dense.data_ptr(), dense.shape[0], d, s, out.data_ptr(),
                      ctypes.byref(plan), stream)
            check(rc)
            return out

        return run

    def hop(kind, n, s, d, k):
        ks, idx = keys(n, s), ints(0, s, (n,))
        w = ints(0, 4 if kind == "sum" else 50, (n, k)).float()
        msg = ints(-3, 4, (s, d)).float()
        child = fh._Child(msg.data_ptr(), idx.data_ptr(), s, d // k)
        out = torch.empty((s, d), device=dev)
        alive.extend((msg, idx))  # the kernel reaches them through `child` alone

        def run(plan):
            rc = one_child(0, ks.data_ptr(), n, w.data_ptr(), k, ctypes.byref(child), s,
                           fh._KINDS[kind], out.data_ptr(), ctypes.byref(plan), stream)
            check(rc)
            return out

        return run

    def matmul(semiring, m, kd, n):
        a, b = ints(-3, 4, (m, kd)).float(), ints(-3, 4, (kd, n)).float()
        out = torch.empty((m, n), device=dev)
        if semiring == "add_mul":
            libraries[("matmul", m, kd, n)] = lambda: torch.matmul(a, b)

        def run(plan):
            words = [None, None]
            if semiring == ops.PACKED:
                words = [torch.empty(shape, dtype=torch.int32, device=dev)
                         for shape in ((m, plan.k_steps), (plan.k_steps, plan.ldb))]
            rc = mm(0, a.data_ptr(), b.data_ptr(), m, kd, n, sm.SEMIRINGS[semiring],
                    out.data_ptr(), ctypes.byref(plan),
                    *(None if w is None else w.data_ptr() for w in words), stream)
            check(rc)
            return out

        return run

    segment_cases = [] if args.cases in ("gather", "matmul") else [
        ("leaf min d=1", segment("min", 498_847, 112_500_000, 1), 498_847, 112_500_000, 1,
         [(True, r, 1) for r in (4096, 8192, 16384, 32768)]),
        ("leaf sum d=2", segment("sum", 498_847, 112_500_000, 2), 498_847, 112_500_000, 2,
         [(True, r, 1) for r in (2048, 4096, 8192, 16384)]),
        ("chunk min d=2250", segment("min", 7455, 766, 2250), 7455, 766, 2250,
         [(False, r, sl) for r in (1, 2, 4) for sl in (1, 2, 3, 5)]),
        ("chunk sum d=4500", segment("sum", 3725, 389, 4500), 3725, 389, 4500,
         [(False, r, sl) for r in (1, 2, 4) for sl in (1, 3, 5, 9)]),
    ]
    ne, nr = 499_948, 50_000  # the main path's one-child hops
    gather_cases = [] if args.cases in ("segment", "matmul") else [
        ("coo_spmm d=4500", coo(ne, nr, 4500), ne, nr, 4500),
        ("fused one-child sum k=2 d=4500", hop("sum", ne, nr, 4500, 2), ne, nr, 4500),
        ("fused one-child min d=2250", hop("min", ne, nr, 2250, 1), ne, nr, 2250),
        ("fused one-child max d=2250", hop("max", ne, nr, 2250, 1), ne, nr, 2250),
    ]
    probes = [] if args.cases in ("segment", "matmul") else [
        ("coo_spmm d=4500, every column out of range",
         coo(ne, nr, 4500, torch.full((ne,), -1, device=dev))),
        ("coo_spmm d=4500, operand of 1000 rows",
         coo(ne, nr, 4500, ints(0, 1000, (ne,)), operand_rows=1000)),
        ("coo_spmm d=4500, every edge on operand row 0",
         coo(ne, nr, 4500, torch.zeros(ne, dtype=torch.int64, device=dev))),
    ]
    results = []
    disagree = []
    for label, run, n, s, d, candidates in segment_cases:
        chosen = ops.walk_plan(n, s, d)
        want = run(chosen).clone()
        chosen_ms = time_ms(torch, lambda: run(chosen))
        library = libraries.get((n, s, d))
        library_ms = None if library is None else time_ms(torch, library)
        print(f"{label}: walk_plan {chosen}: {chosen_ms:.4f} ms; library {library_ms} ms "
              f"[{card}]", flush=True)
        rows = []
        for narrow, r, sl in candidates:
            plan = walk_plan_of(s, d, narrow, r, sl)
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
    # every slab width, edges in flight and tile height in slab-major
    # order; tile-major order and fewer warps at the default plan's other
    # values
    grid = [
        (slab, in_flight, (rows, ops.GATHER_WARPS), True)
        for slab, in_flight, rows in itertools.product(
            (32, 64, 128, 256), ops.GATHER_IN_FLIGHT_CHOICES, (16, 32, 64),
        )
    ] + [
        (slab, ops.GATHER_IN_FLIGHT, (ops.GATHER_ROWS, ops.GATHER_WARPS), False)
        for slab in (32, 64, 128, 256)
    ] + [
        (ops.GATHER_SLAB, ops.GATHER_IN_FLIGHT, (ops.GATHER_ROWS, warps), True)
        for warps in (1, 2)
    ]
    for label, run, n, s, d in gather_cases:
        chosen = ops.gather_plan(n, s, d)
        want = run(chosen).clone()
        chosen_ms = time_ms(torch, lambda: run(chosen))
        library = libraries.get(("coo", n, s, d)) if label.startswith("coo") else None
        library_ms = None if library is None else time_ms(torch, library)
        print(f"{label}: gather_plan {chosen}: {chosen_ms:.4f} ms; library "
              f"{library_ms} ms [{card}]", flush=True)
        rows = []
        for slab, in_flight, (r, warps), slab_major in grid:
            plan = ops.make_gather_plan(n, s, d, slab, r, warps, in_flight, slab_major)
            got = run(plan)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                print(f"{label}: {plan} disagrees with gather_plan's result", file=sys.stderr)
                disagree.append((label, repr(plan)))
                continue
            rows.append({"plan": repr(plan), "slab": slab, "in_flight": in_flight,
                         "rows": r, "warps": warps, "slab_major": slab_major,
                         "ms": time_ms(torch, lambda: run(plan), reps=10)})
        rows.sort(key=lambda row: row["ms"])
        for row in rows[:8]:
            print(f"{label}:   {row['plan']}: {row['ms']:.4f} ms", flush=True)
        for key, values in (("slab", (32, 64, 128, 256)), ("in_flight", ops.GATHER_IN_FLIGHT_CHOICES),
                            ("slab_major", (True, False)), ("rows", (16, 32, 64)),
                            ("warps", (1, 2, 4))):
            best = {v: min((row["ms"] for row in rows if row[key] == v), default=None)
                    for v in values}
            print(f"{label}:   fastest by {key}: "
                  + ", ".join(f"{v}: {'-' if ms is None else f'{ms:.4f}'} ms"
                              for v, ms in best.items()), flush=True)
        results.append({"case": label, "n": n, "num_rows": s, "d": d,
                        "gather_plan": repr(chosen), "gather_plan_ms": chosen_ms,
                        "library_ms": library_ms, "candidates": rows})
    for label, run in probes:
        plan = ops.gather_plan(ne, nr, 4500)
        ms = time_ms(torch, lambda: run(plan))
        print(f"{label} (probe): gather_plan: {ms:.4f} ms", flush=True)
        results.append({"case": label, "probe": True, "gather_plan_ms": ms})
    matmul_cases = [] if args.cases in ("segment", "gather") else [
        (semiring, m, kd, n, matmul(semiring, m, kd, n))
        for semiring, (m, kd, n) in [(s, (2048, 2048, 2048)) for s in sm.SEMIRINGS]
        + [("add_mul", (3000, 1000, 2500))]
    ]
    for semiring, m, kd, n, run in matmul_cases:
        label = f"semiring_matmul {semiring} ({m}, {kd}) x ({kd}, {n})"
        chosen = ops.matmul_plan(m, n, kd, semiring)
        want = run(chosen).clone()
        chosen_ms = time_ms(torch, lambda: run(chosen))
        library = libraries.get(("matmul", m, kd, n))
        library_ms = None if library is None else time_ms(torch, library)
        print(f"{label}: matmul_plan {chosen}: {chosen_ms:.4f} ms; library {library_ms} ms "
              f"[{card}]", flush=True)
        candidates = [(tile, None) for tile in ops.MATMUL_TILES] + [
            (ops.MATMUL_TILE, vec) for vec in ops.MATMUL_VECS[1:] if semiring != ops.PACKED
        ]
        rows = []
        for tile, vec in candidates:
            plan = ops.matmul_plan(m, n, kd, semiring, tile=tile, vec=vec)
            got = run(plan)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                print(f"{label}: {plan} disagrees with matmul_plan's result", file=sys.stderr)
                disagree.append((label, repr(plan)))
                continue
            ms = time_ms(torch, lambda: run(plan))
            rows.append({"plan": repr(plan), "tile": list(tile), "vec": plan.vec, "ms": ms})
            print(f"{label}:   {plan}: {ms:.4f} ms", flush=True)
        results.append({"case": label, "m": m, "kd": kd, "n": n, "matmul_plan": repr(chosen),
                        "matmul_plan_ms": chosen_ms, "library_ms": library_ms,
                        "candidates": rows})
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"card": card, "cases": results}, indent=1))
    print(card)
    return 1 if disagree else 0


if __name__ == "__main__":
    sys.exit(main())
