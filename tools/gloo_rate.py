"""Rates of the LM mesh's collectives on gloo, 4 ranks on one host.

    PYTHONPATH=src python3 tools/gloo_rate.py [--mib 64 336] [--device cuda]

Spawns 4 ranks in one gloo group (a ``file://`` store in a temporary
directory) and times ``launch/mesh.py``'s ``all_gather``, ``all_to_all``
and ``all_reduce`` over groups of 2 ranks (the (data 2, model 2) mesh's
data axis) on f32 tensors of each size, held on the CPU and, with a card,
on the card (the collectives then copy through the host, as the meshed
train step's do).  Prints one line a case: seconds (the best of 3) and
the bytes each rank sends a second.
"""
from __future__ import annotations

import argparse
import datetime
import json
import multiprocessing
import tempfile
import time
from pathlib import Path

WORLD = 4


def _rank(rank: int, tmp: str, sizes: list[int], devices: list[str]) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import all_gather, all_reduce, all_to_all, make_mesh

    if "cuda" in devices:
        torch.cuda.set_device(0)
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=600))
    out = []
    try:
        mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
        group = mesh.axis_group("data")
        for dev in devices:
            for mib in sizes:
                t = torch.ones(mib * 2**20 // 4, device=dev)
                cases = {"all_gather": lambda: all_gather(t, group, 0),
                         "all_to_all": lambda: all_to_all(t.reshape(2, -1), group),
                         "all_reduce": lambda: all_reduce(t, group)}
                for name, fn in cases.items():
                    best = float("inf")
                    for _ in range(3):
                        dist.barrier()
                        t0 = time.perf_counter()
                        fn()
                        if dev == "cuda":
                            torch.cuda.synchronize()
                        best = min(best, time.perf_counter() - t0)
                    # bytes a rank sends: its tensor to 1 peer (gather), half of
                    # it (all_to_all), about its tensor (a 2-rank all-reduce)
                    sent = t.numel() * 4 // (2 if name == "all_to_all" else 1)
                    out.append({"device": dev, "mib": mib, "op": name, "s": best,
                                "sent_gb_per_s": sent / best / 1e9})
    finally:
        dist.destroy_process_group()
    if rank == 0:
        Path(tmp, "rank0.json").write_text(json.dumps(out))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mib", type=int, nargs="+", default=[64, 336])
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="only this device (default: the CPU, and the card if there is one)")
    args = ap.parse_args()
    import torch

    devices = [args.device] if args.device else ["cpu"] + (["cuda"] if torch.cuda.is_available()
                                                            else [])
    with tempfile.TemporaryDirectory() as tmp:
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_rank, args=(r, tmp, args.mib, devices)) for r in range(WORLD)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(900)
        for p in procs:
            if p.is_alive():
                p.kill()
        if any(p.exitcode for p in procs):
            raise SystemExit(f"rank exit codes {[p.exitcode for p in procs]}")
        for row in json.loads(Path(tmp, "rank0.json").read_text()):
            print(f"{row['device']} {row['mib']} MiB {row['op']}: {row['s']:.3f} s, "
                  f"{row['sent_gb_per_s']:.3f} GB/s sent a rank")


if __name__ == "__main__":
    main()
