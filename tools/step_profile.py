#!/usr/bin/env python3
"""Where one training step's time goes on one CUDA card: the host clock
against the device's busy time.

    python3 tools/step_profile.py [--arch whisper-medium] [--n-layers N]
                                  [--global-batch 4] [--seq-len 4096] [--seed 0]

Run from the root of a checkout.  It builds the model at full width
(``--n-layers`` cuts the depth), takes two steps of
``launch/train.py:build_train_step`` on the launcher's batches (a ``vlm``
batch behind zero patches, an ``audio`` batch behind zero frames) and
times the second, then profiles a third under ``torch.profiler`` and
prints: the step's ms on the host clock with and without the profiler,
the device's busy ms (the union of every kernel's and copy's interval)
against each step (the profiler slows the host, not the kernels: the
busy time over the unprofiled step is the device's share of a step run
as shipped), the kernels launched from the host, and the ten kernels
that take the most device time.  It fails if the trace holds no device
activity.
"""
from __future__ import annotations

import argparse
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))


def busy_us(intervals: list[tuple[float, float]]) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="whisper-medium")
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    from torch.autograd import DeviceType

    if not torch.cuda.is_available():
        print("step_profile: no CUDA card", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.launch.train import build_train_step
    from repro_torch.models.model import get_model
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.pipeline import DataPipeline, PipelineConfig

    cfg = get_config(args.arch)
    if args.n_layers:
        cfg = cfg.scaled(n_layers=args.n_layers)
    model = get_model(cfg, "cuda").init(torch.Generator("cuda").manual_seed(args.seed))
    opt = adamw_init(model.params())
    step = build_train_step(model, AdamWConfig(total_steps=3))
    pipe = DataPipeline(PipelineConfig(cfg.vocab, args.seq_len, args.global_batch))

    def batch_at(i: int) -> dict:
        batch = {k: torch.as_tensor(v, device="cuda") for k, v in pipe.local_batch_at(i).items()}
        extra = {"vlm": ("patches", cfg.vision_patches), "audio": ("frames", cfg.n_audio_ctx)}
        if cfg.family in extra:
            key, rows = extra[cfg.family]
            batch[key] = torch.zeros((args.global_batch, rows, cfg.d_model),
                                     dtype=torch.bfloat16, device="cuda")
        return batch

    def timed(i: int) -> float:
        batch = batch_at(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(step(opt, batch)[0])  # waits for the step, the update included
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    timed(0)  # the first step pays the allocator's and the libraries' start
    plain_ms = timed(1)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        profiled_ms = timed(2)
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    if not device:
        print("step_profile: the trace holds no device activity", file=sys.stderr)
        return 1
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in device]) / 1e3
    launches = sum(1 for e in events if e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                                                   "cudaLaunchKernelExC"))
    by_name: dict[str, float] = defaultdict(float)
    for e in device:
        by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e3
    card = torch.cuda.get_device_name(0)
    print(f"step_profile: {cfg.name} ({cfg.family}, {cfg.n_layers} layers"
          + (f", {cfg.enc_layers} encoder layers" if cfg.enc_layers else "")
          + f") on {card}, {args.global_batch} x {args.seq_len} tokens: step {plain_ms:.1f} ms "
          f"(profiled {profiled_ms:.1f} ms); device busy {busy:.1f} ms: {busy / plain_ms:.3f} "
          f"of the step, idle share {1 - busy / profiled_ms:.3f} of the profiled step; "
          f"{launches} kernels launched from the host, {len(device)} device activities",
          flush=True)
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"step_profile:   {ms:9.1f} ms  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
