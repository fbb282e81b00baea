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
every step runs eagerly.  ``build_train_step(..., mesh=)`` is the
reference's sharded train step (``launch/dryrun.py``'s jit with
``in_shardings``, the mesh installed): a rank holds its blocks
(:func:`shard_model`), gathers each leaf over the data axes for its
batch rows (FSDP), computes its share of the dense layers that the
reference's pins cut over ``model`` (its heads, ffn columns and
vocabulary rows; :func:`leaf_layouts`) and runs the experts
expert-parallel; like the reference's runtime, the launcher has no flag
for it.  A resumed run starts at the restored AdamW step
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

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.core.torch_engine import full_fp32_matmul, require_device
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import all_gather, all_reduce, all_to_all, data_axes
from repro_torch.models import shard_ctx
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import flat, nest, param_shapes
from repro_torch.models.model import Model, get_model
from repro_torch.models.moe_ep import EXPERT_LEAVES
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.fault_tolerance import PreemptionHandler, StragglerMonitor
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.train.pipeline import DataPipeline, PipelineConfig

PROG = "python -m repro_torch.launch.train"


def build_train_step(model: Model, acfg: AdamWConfig, accum: int = 1, mesh=None):
    """``step(opt, batch) -> (loss, metrics)``: the loss and its gradients
    (over ``accum`` equal micro-batches: the losses and the gradients
    summed, then divided by ``accum``), then one AdamW update of the
    model's parameters and ``opt`` in place.  ``loss`` and the metrics
    are device scalars.  The recurrent families' backward runs inside
    ``full_fp32_matmul``, as their forward's recurrences do
    (``models/ssm.py``).

    With ``mesh`` (``launch/mesh.py``) every rank of it calls ``step`` on
    the same global batch; ``model`` holds this rank's blocks
    (:func:`shard_model`) and ``opt`` is ``adamw_init`` of them.  The
    rank cuts its rows (``batch_shardings``), brings every leaf but the
    experts to the block it computes with (:func:`leaf_layouts`: gathered
    over the data axes, and over ``model`` only where the layer runs
    whole), and runs the loss with the mesh installed, so the dense
    layers split their heads, ffn columns and vocabulary over ``model``
    (``models/layers.py``) and the MoE layers take ``moe_block_ep`` on
    the rank's experts.  Each gradient is brought back to the rank's
    block (summed over ``model`` where the rank used a leaf in part),
    averaged over the data axes; an expert gradient, which already sums
    every data rank's tokens through the exchange's backward, is divided
    by the data axis instead.  The norm counts every element once;
    ``loss`` is the mean of the data ranks' local means, the same on
    every rank.  A data axis of ``n`` gives the unsharded step with
    ``accum = n`` (micro-batch ``i`` is data rank ``i``'s rows, and MoE
    capacity is per micro-batch as it is per rank), up to the rounding
    of the ``model`` sums (the experts' in bf16).  ``step.held`` counts
    the elements of the dense leaves a rank computes with against their
    whole leaves'."""
    params = model.params()

    def backward(loss: torch.Tensor) -> None:
        with full_fp32_matmul() if model.recurrent else contextlib.nullcontext():
            loss.backward()

    def local_grads(batch: dict) -> torch.Tensor:
        for p in params.values():
            p.grad = None
        if accum == 1:
            loss = model.loss(batch)
            backward(loss)
            return loss.detach()
        lead = next(iter(batch.values())).shape[0]
        if lead % accum:
            raise ValueError(f"batch dim {lead} not divisible by accum={accum}")
        loss = torch.zeros((), device=model.device)
        for mb in zip(*(v.chunk(accum) for v in batch.values())):
            micro = model.loss(dict(zip(batch, mb)))
            backward(micro)
            loss = loss + micro.detach()
        for p in params.values():
            p.grad.div_(accum)
        return loss / accum

    if mesh is not None:
        return _meshed_step(model, acfg, mesh, params, local_grads)

    def step(opt: dict, batch: dict):
        loss = local_grads(batch)
        metrics = adamw_update(params, {n: p.grad for n, p in params.items()}, opt, acfg)
        return loss, metrics

    return step


# ---------------------------------------------------------------- on a mesh


def param_specs(cfg: ModelConfig, mesh) -> dict[str, tuple]:
    """Every leaf's spec on ``mesh`` (``param_shardings``), by dotted name."""
    return {n: s.spec for n, s in shd.param_shardings(param_shapes(cfg), cfg, mesh).items()}


def is_expert(name: str) -> bool:
    """An expert leaf (``layers.moe.wg``/``wu``/``wd``): a rank computes
    with its block, never the whole leaf."""
    return ".moe." in name and name.rsplit(".", 1)[1] in EXPERT_LEAVES


def shard_model(cfg: ModelConfig, mesh, generator: torch.Generator) -> Model:
    """This rank's part of ``cfg``'s model on ``mesh``: every leaf drawn
    whole from ``generator`` (seeded alike on every rank) in
    ``Model.init``'s order, so as the unsharded model draws it, and only
    this rank's block kept, one leaf at a time, on the generator's device:
    no rank holds the whole model."""
    specs = param_specs(cfg, mesh)
    return Model(cfg, device="meta").init(
        generator, keep=lambda name, whole: shd.shard_of(whole, specs[name], mesh))


def whole_params(model: Model, mesh) -> dict[str, torch.Tensor]:
    """Every leaf gathered whole from the mesh's blocks (every rank calls it)."""
    specs = param_specs(model.cfg, mesh)
    return {n: shd.gather(p.detach(), specs[n], mesh) for n, p in model.params().items()}


# the expert blocks moe_block_ep computes with (the reference's shard_map
# in_specs): experts over data, the ffn dim over model
EP_LAYOUT = {"wg": (None, "data", None, "model"), "wu": (None, "data", None, "model"),
             "wd": (None, "data", "model", None)}


class LeafLayout(NamedTuple):
    """A leaf on a mesh: ``spec``, the block a rank keeps (its sharding
    rule); ``compute``, the block it computes with (``"model"`` on the
    dimension the layer splits over the model axis, or ``()``: whole);
    ``partial``, the rank reads the leaf only in part, so its gradient is
    this rank's share, to be summed over ``model``."""

    spec: tuple
    compute: tuple
    partial: bool


def _compute_dim(name: str, heads: bool, ffn: bool, vocab: bool) -> tuple[int | None, bool]:
    """(the dimension, from the end, of leaf ``name`` that its layer cuts
    over ``model``, or None; whether the rank reads it in part), given
    which pins cut: the attention's heads, the MLP's hidden width, the
    vocabulary."""
    parts = name.split(".")
    if name == "embed":
        return (-2 if vocab else None), False
    if name == "lm_head":
        return (-1 if vocab else None), False
    owner, proj, leaf = ([None] * 3 + parts)[-3:]
    if owner in ("attn", "xattn") and heads:
        if proj == "wq":  # its columns (and bias): the rank's heads
            return -1, False
        if proj == "wo":  # its rows; a bias is added after the sum
            return (-2 if leaf == "w" else None), False
        return None, True  # wk, wv: projected whole, read for the rank's heads
    if owner == "mlp" and ffn:
        if proj in ("wg", "wu", "wi"):
            return -1, False
        if proj in ("wd", "wo"):
            return (-2 if leaf == "w" else None), False
    return None, False


def leaf_layouts(cfg: ModelConfig, mesh) -> dict[str, LeafLayout]:
    """Every leaf's layout on ``mesh`` for the meshed train step, by dotted
    name: the block it keeps (``param_specs``) and the block it computes
    with under the installed mesh's pins (mode ``"all"``), ``shard_ctx.
    cuts_model``: the heads of ``"bthd"``, the ffn width and the
    vocabulary of ``"btf"``.  Where a pin does not cut (heads the axis does
    not divide, as reduced minitron-4b's 3; a vocabulary of 51,865) the
    layer runs whole.  The router, the norms and the recurrent mixers run
    whole on every rank; the experts compute with the block they keep."""
    specs = param_specs(cfg, mesh)
    heads = shard_ctx.cuts_model(mesh, "bthd", (1, 1, cfg.nh_eff, cfg.hd))
    ffn = shard_ctx.cuts_model(mesh, "btf", (1, 1, cfg.d_ff))
    vocab = shard_ctx.cuts_model(mesh, "btf", (1, 1, cfg.vocab))
    out = {}
    for name, shape in param_shapes(cfg).items():
        if is_expert(name):
            out[name] = LeafLayout(specs[name], specs[name], False)
            continue
        dim, partial = _compute_dim(name, heads, ffn, vocab)
        compute = () if dim is None else tuple(
            "model" if i == len(shape) + dim else None for i in range(len(shape)))
        out[name] = LeafLayout(specs[name], compute, partial)
    return out


def dense_held(cfg: ModelConfig, mesh) -> dict[str, int]:
    """``{"dense": the elements of the non-expert leaves a rank computes
    with, "whole": those leaves' elements}`` in the meshed step on
    ``mesh``."""
    shapes = param_shapes(cfg)
    held = {"dense": 0, "whole": 0}
    for name, lay in leaf_layouts(cfg, mesh).items():
        if is_expert(name):
            continue
        whole = math.prod(shapes[name])
        held["whole"] += whole
        held["dense"] += whole // (1 if _model_dim(lay.compute) is None else mesh.shape["model"])
    return held


def _model_dim(spec: tuple) -> int | None:
    """The dimension ``spec`` cuts over ``model`` alone, or None."""
    for dim, entry in enumerate(spec):
        axes = shd.entry_axes(entry)
        if "model" in axes:
            if len(axes) > 1:
                raise ValueError(f"{spec}: a dimension cut over model and another axis")
            return dim
    return None


def _recut(t: torch.Tensor, whole: int, cut: int, group) -> torch.Tensor:
    """``t`` with its dimension ``whole`` cut into this member's block and
    its dimension ``cut`` (this member's block) made whole: one
    ``all_to_all``, each member's block of ``whole`` sent to it."""
    n = torch.distributed.get_world_size(group)
    moved = t.movedim(whole, 0)
    at = cut + 1 if cut < whole else cut  # ``cut`` in ``moved``
    parts = all_to_all(moved.reshape(n, moved.shape[0] // n, *moved.shape[1:]), group)
    return torch.cat(list(parts.unbind(0)), dim=at).movedim(0, whole)


def _to_compute(block: torch.Tensor, lay: LeafLayout, mesh) -> torch.Tensor:
    """The block a rank computes with from the block it keeps: gathered
    over the data axes, then over ``model`` where the layer runs whole,
    narrowed where it splits a leaf the rules keep whole over ``model``,
    or re-cut where it splits another dimension than the rules (one
    ``all_to_all``)."""
    out = block
    for dim, entry in enumerate(lay.spec):
        for a in reversed(shd.entry_axes(entry)):
            if a != "model":
                out = all_gather(out, mesh.axis_group(a), dim)
    s, c = _model_dim(lay.spec), _model_dim(lay.compute)
    if s == c:
        return out
    group = mesh.axis_group("model")
    if c is None:
        return all_gather(out, group, s)
    if s is None:
        return _model_block(out, c, mesh).clone()
    return _recut(out, c, s, group)


def _model_block(t: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """This rank's ``model`` block of ``t`` along ``dim`` (a view)."""
    size = t.shape[dim] // mesh.shape["model"]
    return t.narrow(dim, mesh.coords["model"] * size, size)


def _reduce_scatter(g: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This member's block along ``dim`` of ``g`` summed over ``group``:
    ``g`` cut into equal blocks along ``dim``, block ``i`` sent to member
    ``i``, the blocks received summed in member order."""
    n = torch.distributed.get_world_size(group)
    moved = g.movedim(dim, 0)
    parts = all_to_all(moved.reshape(n, moved.shape[0] // n, *moved.shape[1:]), group)
    return parts.sum(dim=0).movedim(0, dim)


def _mean_block(g: torch.Tensor, lay: LeafLayout, mesh, daxes: tuple[str, ...]) -> torch.Tensor:
    """The rank's block of the mean of ``g`` over the data axes, ``g`` the
    gradient of the block the rank computed with from its rows.  Over
    ``model`` it is brought to the kept block first: re-cut, gathered
    where the rank computed with its block of a leaf the rules keep
    whole, summed where the rank read the leaf in part (reduce-scattered
    onto the block), narrowed where it is still whole (every rank of a
    ``model`` group holds the same).  Then the spec's data axes are cut in
    order, each by summing over its group; data axes it leaves out are
    summed last, on the block."""
    s, c = _model_dim(lay.spec), _model_dim(lay.compute)
    if s != c or lay.partial:
        group = mesh.axis_group("model")
        if c is None and s is None:
            g = all_reduce(g, group)
        elif c is None:
            g = _reduce_scatter(g, s, group) if lay.partial else _model_block(g, s, mesh)
        elif s is None:
            g = all_gather(g, group, c)
        else:
            g = _recut(g, s, c, group)
    for dim, entry in enumerate(lay.spec):
        for a in shd.entry_axes(entry):
            if a in daxes:
                g = _reduce_scatter(g, dim, mesh.axis_group(a))
    for a in daxes:
        if a not in shd.named_axes(lay.spec):
            g = all_reduce(g, mesh.axis_group(a))
    return g / math.prod(mesh.shape[a] for a in daxes)


def _meshed_step(model: Model, acfg: AdamWConfig, mesh, params: dict, local_grads):
    cfg = model.cfg
    layouts = leaf_layouts(cfg, mesh)
    specs = {n: lay.spec for n, lay in layouts.items()}
    daxes = data_axes(mesh)
    n_data = math.prod(mesh.shape[a] for a in daxes)
    for name in filter(is_expert, params):
        want = EP_LAYOUT[name.rsplit(".", 1)[1]]
        if specs[name] != want:
            raise ValueError(
                f"{cfg.name} on {mesh}: {name} is laid out as {specs[name]}; the expert-parallel "
                f"step needs {want} ({cfg.moe.n_experts} experts over "
                f"the data axis, d_ff {cfg.d_ff} over the model axis)")
    blocks = {n: p.data for n, p in params.items()}
    dense = [n for n in params if not is_expert(n)]

    def step(opt: dict, batch: dict):
        rows = shd.batch_shardings(batch, mesh)
        local = {k: shd.shard_of(v, rows[k].spec, mesh) for k, v in batch.items()}
        before = (shard_ctx._MESH, shard_ctx._MODE)
        try:
            for n in dense:
                params[n].data = _to_compute(blocks[n], layouts[n], mesh)
            shard_ctx.set_mesh(mesh, "all")
            loss = local_grads(local)
            grads = {n: p.grad for n, p in params.items()}
        finally:
            shard_ctx.set_mesh(*before)
            for n, p in params.items():
                p.grad = None
                p.data = blocks[n]
        for n, g in grads.items():
            if is_expert(n):
                for a in daxes:
                    if a != "data":
                        g = all_reduce(g, mesh.axis_group(a)) / mesh.shape[a]
                grads[n] = g / mesh.shape["data"]
            else:
                grads[n] = _mean_block(g, layouts[n], mesh, daxes)
        metrics = adamw_update(blocks, grads, opt, acfg, mesh, specs)
        for a in daxes:
            loss = all_reduce(loss, mesh.axis_group(a))
        return loss / n_data, metrics

    step.held = dense_held(cfg, mesh)
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
