"""End-to-end trainer on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
        --global-batch 4 --seq-len 4096 --steps 6 --ckpt-dir /tmp/ck --ckpt-every 3
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced \\
        --steps 4 --global-batch 2 --seq-len 64

Port of the JAX package's ``launch/train.py``: the model zoo's
families (``models/``: dense, moe, vlm, ssm, hybrid, audio), AdamW, the
deterministic pipeline, asynchronous checkpoints, the preemption
handler, the straggler monitor and gradient accumulation, wired as the
reference wires them, with its flags and its ``[train]`` lines; a
``vlm`` batch gets zero bf16 vision patches and an ``audio`` batch zero
bf16 frames, as there.  It runs on CUDA unless ``--device cpu`` is
given, and without a card it exits 2; it never falls back to the CPU.

The parameters start from ``torch.Generator`` seed 0 on the device, and
every step runs eagerly.  A resumed run starts at the restored AdamW step
counter, the number of updates the checkpoint holds, so it continues the
uninterrupted run's steps exactly; the reference restarts at the step
directory's label, which for the periodic and preemption checkpoints is
the last step already taken.
"""
from __future__ import annotations

import argparse
import contextlib
import sys
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.core.torch_engine import full_fp32_matmul, require_device
from repro_torch.models.convert import flat, nest
from repro_torch.models.model import Model, get_model
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.fault_tolerance import PreemptionHandler, StragglerMonitor
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.train.pipeline import DataPipeline, PipelineConfig

PROG = "python -m repro_torch.launch.train"


def build_train_step(model: Model, acfg: AdamWConfig, accum: int = 1):
    """``step(opt, batch) -> (loss, metrics)``: the loss and its gradients
    (over ``accum`` equal micro-batches: the losses and the gradients
    summed, then divided by ``accum``), then one AdamW update of the
    model's parameters and ``opt`` in place.  ``loss`` and the metrics
    are device scalars.  The recurrent families' backward runs inside
    ``full_fp32_matmul``, as their forward's recurrences do
    (``models/ssm.py``)."""
    params = model.params()

    def backward(loss: torch.Tensor) -> None:
        with full_fp32_matmul() if model.recurrent else contextlib.nullcontext():
            loss.backward()

    def step(opt: dict, batch: dict):
        for p in params.values():
            p.grad = None
        if accum == 1:
            loss = model.loss(batch)
            backward(loss)
        else:
            lead = next(iter(batch.values())).shape[0]
            if lead % accum:
                raise ValueError(f"batch dim {lead} not divisible by accum={accum}")
            loss = torch.zeros((), device=model.device)
            for mb in zip(*(v.chunk(accum) for v in batch.values())):
                micro = model.loss(dict(zip(batch, mb)))
                backward(micro)
                loss = loss + micro.detach()
            loss = loss / accum
            for p in params.values():
                p.grad.div_(accum)
        metrics = adamw_update(params, {n: p.grad for n, p in params.items()}, opt, acfg)
        return loss.detach(), metrics

    return step


def state_tree(params: dict, opt: dict) -> tuple:
    """``(params, opt)`` as the reference's checkpoint holds them: nested
    dicts, so the leaf names are its names."""
    return nest(params), {"m": nest(opt["m"]), "step": opt["step"], "v": nest(opt["v"])}


@torch.no_grad()
def load_state(params: dict, opt: dict, tree: tuple) -> None:
    """Copies a restored ``state_tree`` into the live parameters and state."""
    p_tree, o_tree = tree
    for name, t in flat(p_tree).items():
        params[name].copy_(t)
    for k in ("m", "v"):
        for name, t in flat(o_tree[k]).items():
            opt[k][name].copy_(t)
    opt["step"].copy_(o_tree["step"])


def main(argv: list[str] | None = None) -> dict:
    """Trains as the flags say; returns the run's numbers (``losses``,
    ``grad_norms``, the MoE auxiliary loss ``aux`` (of the last
    micro-batch), ``ms``, ``tokens_per_s`` and, on a card, ``peak_bytes``
    per step, the ``steps`` taken and ``step0``)."""
    ap = argparse.ArgumentParser(prog=PROG, description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCHS, default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--d-model", type=int, default=None)
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--vocab", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="device to train on (cuda, or cpu)")
    args = ap.parse_args(argv)
    try:
        device = require_device(args.device, PROG, "--device cpu")
    except RuntimeError as e:
        print(e, file=sys.stderr)
        raise SystemExit(2) from None

    cfg = get_config(args.arch, reduced=args.reduced)
    overrides = {}
    if args.d_model:
        overrides["d_model"] = args.d_model
    if args.n_layers:
        overrides["n_layers"] = args.n_layers
    if args.vocab:
        overrides["vocab"] = args.vocab
    if overrides:
        cfg = cfg.scaled(**overrides)
    model = get_model(cfg, device)
    print(f"[train] arch={cfg.name} params≈{cfg.param_count()/1e6:.1f}M "
          f"devices=1 ({device})")

    acfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                       warmup_steps=max(1, args.steps // 20))
    pipe = DataPipeline(PipelineConfig(cfg.vocab, args.seq_len, args.global_batch))
    model.init(torch.Generator(device=device).manual_seed(0))
    params = model.params()
    opt = adamw_init(params)
    step0 = 0

    ck = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    if ck and ck.steps():
        tree, saved = ck.restore(state_tree(params, opt))
        load_state(params, opt, tree)
        del tree
        step0 = int(opt["step"])
        print(f"[train] resumed from step {step0} (checkpoint step_{saved})")

    train_step = build_train_step(model, acfg, args.accum)
    monitor = StragglerMonitor()
    preempt = PreemptionHandler()
    cuda = device.type == "cuda"
    run = {"arch": cfg.name, "device": str(device), "step0": step0, "steps": [],
           "losses": [], "grad_norms": [], "aux": [], "ms": [], "tokens_per_s": [],
           "peak_bytes": []}

    t_start = time.perf_counter()
    try:
        for step in range(step0, args.steps):
            batch = {k: torch.as_tensor(np.ascontiguousarray(v), device=device)
                     for k, v in pipe.local_batch_at(step).items()}
            if cfg.family == "vlm":
                batch["patches"] = torch.zeros(
                    (args.global_batch, cfg.vision_patches, cfg.d_model), dtype=torch.bfloat16,
                    device=device)
            if cfg.family == "audio":
                batch["frames"] = torch.zeros(
                    (args.global_batch, cfg.n_audio_ctx, cfg.d_model), dtype=torch.bfloat16,
                    device=device)
            if cuda:
                torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            loss, metrics = train_step(opt, batch)
            loss = float(loss)  # waits for the step, the update included
            dt = time.perf_counter() - t0
            gnorm = float(metrics["grad_norm"])
            tps = args.global_batch * args.seq_len / dt
            for key, val in (("steps", step), ("losses", loss), ("grad_norms", gnorm),
                             ("aux", float(model.last_aux)), ("ms", dt * 1e3),
                             ("tokens_per_s", tps)):
                run[key].append(val)
            if cuda:
                run["peak_bytes"].append(torch.cuda.max_memory_allocated(device))
            if monitor.record(step, dt):
                print(f"[train] straggler at step {step}: {dt:.2f}s")
            if step % args.log_every == 0:
                print(f"[train] step={step} loss={loss:.4f} gnorm={gnorm:.3f} "
                      f"{dt*1e3:.0f}ms ({tps:.0f} tok/s)", flush=True)
            if ck and step > 0 and step % args.ckpt_every == 0:
                ck.save(step, state_tree(params, opt))
            if preempt.should_stop:
                print("[train] preemption signal: checkpointing and exiting")
                if ck:
                    ck.save(step, state_tree(params, opt), blocking=True)
                return run
    finally:
        preempt.restore()
    if ck:
        ck.save(args.steps, state_tree(params, opt), blocking=True)
    total = time.perf_counter() - t_start
    losses = run["losses"] or [float("nan")]
    first = np.mean(losses[: max(1, len(losses) // 10)])
    last = np.mean(losses[-max(1, len(losses) // 10):])
    print(f"[train] done: {args.steps - step0} steps in {total:.1f}s; "
          f"loss {first:.3f} -> {last:.3f}; {monitor.summary()}")
    return run


if __name__ == "__main__":
    main()
