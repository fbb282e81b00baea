"""The reference's dry run: every (arch × shape × mesh) cell built at full
size on a fake world, counted, allocating nothing.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
        --shape decode_32k --mesh single --device cpu --out launch_results
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out launch_results
    PYTHONPATH=src python -m repro_torch.launch.roofline --results launch_results

Port of the JAX package's ``launch/dryrun.py``.  The reference lowers and
compiles each cell from ``ShapeDtypeStruct`` inputs on 512 virtual CPU
devices and reads the HLO's memory, cost and collectives.  The port has
no HLO.  :func:`run_cell` builds the cell with :func:`build_cell` once on
a fake world of ``prod(mesh)`` ranks (``launch/mesh.py:make_dry_mesh``,
torch's ``"fake"`` backend) under a ``FakeTensorMode``, this process
rank 0, and runs it once under ``launch/hlo_analysis.py:analyze``: the
aten ops rank 0 dispatches and the collectives it records stand in for
the HLO.  Tensors are fake (on ``--device``: ``cuda`` by default, ``cpu``
where torch has no CUDA): shapes, dtypes and devices, no memory.  Each
cell's record is the reference's (``status``, the analysis's keys,
``memory``), with ``build_s``/``run_s`` in place of
``lower_s``/``compile_s``, every per-device number rank 0's (``rank``),
and ``model_flops`` of the cell's config and shape
(``launch/roofline.py``).  ``hlo_dir``'s counterpart holds each cell's
ops and collectives as gzipped JSON lines.  :func:`measure_cell` is the
part that builds, runs and counts; on a real mesh every rank calls it,
so a dry count can be held to a real one.

:func:`build_cell` builds the cell on a ``launch/mesh.py`` mesh (every
rank calls it) and returns the step with its inputs, each rank holding
its block:

* ``"train"``: ``launch/train.py:build_train_step(mesh=)`` and (``opt``,
  the global batch), the step cutting its rows as the reference's
  ``in_shardings`` do;
* ``"prefill"``: ``model.prefill`` over the rank's rows of the batch
  (``batch_shardings``), returning the logits whole on every rank (the
  reference's ``out_shardings`` ``P()``) and the rank's cache blocks under
  ``cache_shardings(cache, cfg, mesh, shape.global_batch)``;
* ``"decode"``: one token a row at ``pos`` against a cache of
  ``shape.seq_len`` positions laid out the same way, written in place
  (the reference donates it), returning the logits whole and the cache.

A prefill or decode computes with the blocks ``train.leaf_layouts``
gives (gathered once, when the cell is built, from the rank's kept
blocks): the dense layers' heads, ffn columns and vocabulary and the
recurrent mixers' heads cut over ``model`` as in the sharded train step,
forward only.  Each rank projects keys and values whole, so its cache
block is a narrowing to its rows and its positions; ``wkv`` and ``ssm``
hold its heads; the shift and conv carries are whole, alike on every rank
of a ``model`` group.  A decode attends over the rank's positions and
combines the blocks' softmax over the axes that cut them
(``layers.attend_cached``).  The reference's serving cells install no
mesh, so its MoE routes every token of the call at once; the port's
does too (``moe_ep.moe_block_served``), dropped choices included.

The reference's knobs:

* ``REPRO_ACCUM`` (gradient accumulation of a train cell) is honoured;
* ``REPRO_SHARD_CONSTRAINTS`` changes only which collectives GSPMD
  chooses in the reference, never a value; the port always splits as
  under ``"all"`` (its mesh installed, the pins' cuts taken);
* ``REPRO_PAD_HEADS``: the port pads no heads; heads the ``model`` axis
  does not divide run whole, as in the sharded train step.

A serving cell takes a mesh of ``data`` and ``model`` axes: with a
``pod`` axis the rules cut the batch over ``(pod, data)`` but the cache's
rows over ``data`` alone, which the reference leaves to GSPMD to
reconcile; the port refuses it, so the multi-pod mesh's serving cells
are recorded as errors (the reference's own multi-pod decode fails too,
with ``DuplicateSpecError``).
"""
from __future__ import annotations

import argparse
import contextlib
import gzip
import json
import math
import os
import time
import traceback

import torch
from torch import nn

from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import hlo_analysis, roofline
from repro_torch.launch import sharding as shd
from repro_torch.launch import train
from repro_torch.launch.mesh import (all_gather, make_dry_mesh, make_production_mesh,
                                     recording)
from repro_torch.models import model as M
from repro_torch.models import shard_ctx
from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig
from repro_torch.models.ssm import mamba2_dims
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.pipeline import DataPipeline, PipelineConfig


def applicable(arch: str, shape_name: str) -> tuple[bool, str]:
    cfg = get_config(arch)
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return False, "long_500k skipped: pure full attention (see DESIGN.md)"
    return True, ""


def compute_model(model: M.Model, mesh) -> M.Model:
    """A model (parameters on ``model``'s device, no gradients) holding the
    blocks this rank computes with (``train.leaf_layouts``), made from
    ``model``'s kept blocks (:func:`train.shard_model`); the experts keep
    theirs.  Every rank of ``mesh`` calls it (the gathers are collective)."""
    cfg = model.cfg
    layouts = train.leaf_layouts(cfg, mesh)
    out = M.Model(cfg, device="meta")
    for name, p in model.params().items():
        block = p.detach()
        if train.is_expert(name):
            # the rules cut ``wd``'s columns where d_ff equals d_model
            # (reduced scout): its rows are re-cut over ``model``
            spec, want = layouts[name].spec, train.EP_LAYOUT[name.rsplit(".", 1)[1]]
            s, c = train._model_dim(spec), train._model_dim(want)
            if [None if e == "model" else e for e in spec] != \
                    [None if e == "model" else e for e in want] or s is None:
                raise ValueError(f"{cfg.name} on {mesh}: {name} is laid out as {spec}; the "
                                 f"meshed MoE needs {want}")
            if s != c:
                block = train._recut(block, c, s, mesh.axis_group("model"))
        else:
            block = train._to_compute(block, layouts[name], mesh)
        owner, _, leaf = name.rpartition(".")
        module = out.get_submodule(owner) if owner else out
        module._parameters[leaf] = nn.Parameter(block, requires_grad=False)
    return out


class MeshServe:
    """A rank's meshed prefill and decode of ``model`` (its kept blocks) for
    ``batch_size`` rows on ``mesh``; ``slots``: the positions of the cache
    a decode reads and a prefill lays its keys and values out for (None:
    a prefill's own positions; a decode needs it).  ``weights``: another
    ``MeshServe``'s ``model`` of the same blocks, used instead of
    gathering them again."""

    def __init__(self, model: M.Model, mesh, batch_size: int, slots: int | None = None,
                 weights: M.Model | None = None):
        if set(mesh.axis_names) != {"data", "model"}:
            raise NotImplementedError(
                f"a meshed prefill or decode takes a mesh of data and model axes; got "
                f"{mesh.axis_names} (see launch/dryrun.py)")
        self.cfg, self.mesh, self.batch_size, self.slots = model.cfg, mesh, batch_size, slots
        self.model = weights if weights is not None else compute_model(model, mesh)
        spec = shd.batch_shardings({"tokens": (batch_size, 1)}, mesh)["tokens"].spec
        self.rows = shd.entry_axes(spec[0]) if spec else ()

    def layout(self, slots: int) -> tuple[dict, dict, shard_ctx.Serving]:
        """(each cache leaf's whole (shape, dtype), its spec under
        ``cache_shardings``, the serving layout) for ``slots`` positions."""
        shapes = self.model.cache_shapes(self.batch_size, slots)
        specs = {n: s.spec for n, s in shd.cache_shardings(
            {n: dims for n, (dims, _) in shapes.items()}, self.cfg, self.mesh,
            self.batch_size).items()}
        seq = {leaf: shd.entry_axes(specs[leaf][2]) for leaf in ("k", "mem_k") if leaf in specs}
        return shapes, specs, shard_ctx.Serving(self.rows, seq)

    def local_shape(self, dims: tuple, spec: tuple) -> tuple:
        """The block of a leaf of ``dims`` this rank holds under ``spec``."""
        return tuple(n // shd._block(spec[i], self.mesh)[0] if i < len(spec) else n
                     for i, n in enumerate(dims))

    def rows_of(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global batch leaf."""
        count, index = shd._block(self.rows, self.mesh)
        size = t.shape[0] // count
        return t[index * size:(index + 1) * size]

    @contextlib.contextmanager
    def installed(self, serving: shard_ctx.Serving):
        before = (shard_ctx._MESH, shard_ctx._MODE, shard_ctx._SERVE)
        shard_ctx.set_mesh(self.mesh, "all", serving)
        try:
            yield
        finally:
            shard_ctx.set_mesh(*before)

    def computed(self, name: str, spec: tuple, decode: bool) -> tuple:
        """How this rank's prefill or decode lays out cache leaf ``name``
        (spec ``spec``): its rows over the axes that cut the batch, the
        recurrent states' heads over ``model`` where the mixer splits them;
        the keys' and values' positions whole in a prefill (each rank
        projects them all) and as ``spec`` cuts them in a decode.  It
        differs from ``spec`` where the rules cut otherwise: a prefill's
        positions, and the hybrid's ``conv`` carry, which the rules take
        for keys or values (its name ends in ``v``)."""
        cfg = self.cfg
        out = [None] * len(spec)
        out[2 if name in ("ssm", "conv") else 1] = self.rows or None
        if decode and name in ("k", "v", "mem_k", "mem_v"):
            out[2] = spec[2]
        if name == "wkv" and shard_ctx.cuts_model(self.mesh, "bthd", (1, 1, cfg.n_heads, cfg.hd)):
            out[2] = "model"
        if name == "ssm" and shard_ctx.cuts_model(self.mesh, "bthd",
                                                  (1, 1, *mamba2_dims(cfg)[1:])):
            out[3] = "model"
        return tuple(out)

    def relayout(self, t: torch.Tensor, src: tuple, dst: tuple) -> torch.Tensor:
        """This rank's block under ``dst`` of a leaf whose block under
        ``src`` is ``t``: each dimension the two cut differently gathered
        over ``src``'s axes, then narrowed to ``dst``'s block (collective
        where a dimension is gathered; every rank makes the same calls)."""
        for dim in range(t.dim()):
            a = shd.entry_axes(src[dim] if dim < len(src) else None)
            b = shd.entry_axes(dst[dim] if dim < len(dst) else None)
            if a == b:
                continue
            for axis in reversed(a):
                t = all_gather(t, self.mesh.axis_group(axis), dim)
            count, index = shd._block(b, self.mesh)
            t = t.narrow(dim, index * (t.shape[dim] // count), t.shape[dim] // count)
        return t

    @torch.no_grad()
    def prefill(self, batch: dict):
        """``batch``: this rank's rows.  Returns (f32 logits (B, 1, V) whole,
        the rank's cache blocks): the keys and values padded to the
        cache's positions, then every leaf brought from the layout it was
        computed in (:meth:`computed`) to its spec."""
        total = batch["tokens"].shape[1] + (
            batch["patches"].shape[1] if "patches" in batch else 0)
        shapes, specs, serving = self.layout(self.slots or total)
        with self.installed(serving):
            logits, cache = self.model.prefill(batch)
            logits = shard_ctx.gather_over(logits, self.rows, 0)
        out = {}
        for name, t in cache.items():
            dims = shapes[name][0]
            if name in ("k", "v") and t.shape[2] < dims[2]:
                t = torch.nn.functional.pad(t, (0, 0, 0, 0, 0, dims[2] - t.shape[2]))
            t = self.relayout(t, self.computed(name, specs[name], False), specs[name])
            out[name] = t.clone(memory_format=torch.contiguous_format)
        return logits, out

    @torch.no_grad()
    def decode(self, cache: dict, tokens: torch.Tensor, pos):
        """``cache``: the rank's blocks of a ``slots``-position cache, written
        in place; ``tokens`` (B_loc, 1): the rank's rows.  Returns (f32
        logits (B, 1, V) whole, the cache).  A leaf whose spec is not the
        layout the step computes in (:meth:`computed`, the hybrid's
        ``conv``) is brought to it for the step and back."""
        if self.slots is None:
            raise ValueError("a meshed decode needs the cache's positions (slots=)")
        _, specs, serving = self.layout(self.slots)
        moved = {n: self.computed(n, specs[n], True) for n in cache}
        moved = {n: have for n, have in moved.items()
                 if list(map(shd.entry_axes, have)) != list(map(shd.entry_axes, specs[n]))}
        work = {n: self.relayout(t, specs[n], moved[n]).clone() if n in moved else t
                for n, t in cache.items()}
        with self.installed(serving):
            logits, work = self.model.decode_step(work, tokens, pos)
            logits = shard_ctx.gather_over(logits, self.rows, 0)
        for n, have in moved.items():
            cache[n].copy_(self.relayout(work[n], have, specs[n]))
        return logits, cache

    def empty_cache(self) -> dict:
        """This rank's zeroed blocks of a ``slots``-position cache."""
        shapes, specs, _ = self.layout(self.slots)
        return {n: torch.zeros(self.local_shape(dims, specs[n]), dtype=dt,
                               device=self.model.device) for n, (dims, dt) in shapes.items()}


def _batch(cfg: ModelConfig, shape: ShapeConfig, device, train_kind: bool) -> dict:
    """The pipeline's batch at step 0, with zero vision patches (vlm) or
    frames (audio) in ``ACT_DTYPE``, as ``launch/train.py`` feeds them."""
    b = DataPipeline(PipelineConfig(cfg.vocab, shape.seq_len, shape.global_batch)).local_batch_at(0)
    out = {k: torch.as_tensor(v, device=device) for k, v in b.items()
           if train_kind or k == "tokens"}
    B = shape.global_batch
    if cfg.family == "vlm":
        out["patches"] = torch.zeros((B, cfg.vision_patches, cfg.d_model), dtype=M.ACT_DTYPE,
                                     device=device)
    if cfg.family == "audio":
        out["frames"] = torch.zeros((B, cfg.n_audio_ctx, cfg.d_model), dtype=M.ACT_DTYPE,
                                    device=device)
    return out


def build_cell(arch: str, shape_name: str, mesh, *, cfg: ModelConfig | None = None,
               shape: ShapeConfig | None = None, model: M.Model | None = None,
               slots: int | None = None):
    """``(fn, args)``: the cell of ``arch`` × ``shape_name`` on ``mesh``,
    ``fn(*args)`` running it on this rank (every rank of ``mesh`` calls
    both).  ``cfg`` and ``shape`` replace the reference's config and shape
    (a size the host or card holds); ``model``: this rank's kept blocks
    (``train.shard_model``; by default drawn from seed 0 on the mesh's
    device); ``slots``: a prefill's cache laid out for a decode of that
    many positions (by default the prompt's).  ``fn`` is ``step(opt,
    batch)`` (train), ``prefill(batch_rows)`` or ``decode(cache_blocks,
    token_rows, pos)`` (:class:`MeshServe`); ``args`` the pipeline's batch
    at step 0 (zero patches or frames), its rows, or a zeroed cache and
    ``pos`` 0."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    device = mesh.device
    if model is None:
        model = train.shard_model(cfg, mesh, torch.Generator(device=device).manual_seed(0))
    if shape.kind == "train":
        accum = int(os.environ.get("REPRO_ACCUM", "1"))
        step = train.build_train_step(model, AdamWConfig(), accum, mesh=mesh)
        return step, (adamw_init(model.params()), _batch(cfg, shape, device, True))
    if shape.kind == "prefill":
        serve = MeshServe(model, mesh, shape.global_batch, slots)
        batch = _batch(cfg, shape, device, False)
        return serve.prefill, ({k: serve.rows_of(v) for k, v in batch.items()},)
    serve = MeshServe(model, mesh, shape.global_batch, shape.seq_len)
    tokens = _batch(cfg, shape, device, False)["tokens"][:, :1]
    return serve.decode, (serve.empty_cache(), serve.rows_of(tokens), 0)


# ---------------------------------------------------------------- the dry run

# the axes of a mesh of 2 or 3 dimensions (launch/mesh.py:make_production_mesh's)
MESH_AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _block_bytes(t: torch.Tensor, spec: tuple, mesh) -> int:
    """The bytes of this rank's block of ``t`` under ``spec``."""
    return _nbytes(t) // math.prod(shd._block(e, mesh)[0] for e in spec)


def cell_arguments(kind: str, model: M.Model, fn, args: tuple, mesh) -> dict[str, int]:
    """The bytes of each block the rank holds when the cell's call starts,
    by name: a train step's parameter blocks (``params/<leaf>``), AdamW's
    ``opt/m/<leaf>``, ``opt/v/<leaf>`` and ``opt/step``, and the rank's rows
    of the batch (``batch/<key>``: the step is handed the global batch and
    cuts them itself); a served call's compute blocks (``params/<leaf>``,
    gathered when the cell is built), its rows (``batch/<key>``) and, for a
    decode, its cache blocks (``cache/<leaf>``; ``pos`` is a host integer)."""
    if kind == "train":
        opt, batch = args
        out = {f"params/{n}": _nbytes(p) for n, p in model.params().items()}
        for k in ("m", "v"):
            out.update({f"opt/{k}/{n}": _nbytes(t) for n, t in opt[k].items()})
        out["opt/step"] = _nbytes(opt["step"])
        rows = shd.batch_shardings(batch, mesh)
        out.update({f"batch/{k}": _block_bytes(v, rows[k].spec, mesh) for k, v in batch.items()})
        return out
    out = {f"params/{n}": _nbytes(p) for n, p in fn.__self__.model.params().items()}
    if kind == "prefill":
        return {**out, **{f"batch/{k}": _nbytes(v) for k, v in args[0].items()}}
    cache, tokens, _ = args
    return {**out, **{f"cache/{n}": _nbytes(t) for n, t in cache.items()},
            "batch/tokens": _nbytes(tokens)}


def measure_cell(arch: str, shape_name: str, mesh, *, cfg: ModelConfig | None = None,
                 shape: ShapeConfig | None = None, model: M.Model | None = None,
                 slots: int | None = None, keep_ops: bool = False):
    """Builds the cell on ``mesh`` (:func:`build_cell`; every rank of a real
    mesh calls it) and runs it once under ``hlo_analysis.analyze``.
    Returns (the call's result, its numbers): the analysis's keys,
    ``argument_leaves`` (:func:`cell_arguments`), ``build_s`` and ``run_s``
    (host seconds), and ``build_collectives``, the build's collectives
    (:func:`_summarize`; a served cell gathers its compute blocks then).
    ``model``: the rank's kept blocks, by default drawn from seed 0."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    t0 = time.perf_counter()
    with recording() as built:
        if model is None:
            model = train.shard_model(cfg, mesh,
                                      torch.Generator(device=mesh.device).manual_seed(0))
        fn, args = build_cell(arch, shape_name, mesh, cfg=cfg, shape=shape, model=model,
                              slots=slots)
    t1 = time.perf_counter()
    leaves = cell_arguments(shape.kind, model, fn, args, mesh)
    out, deep = hlo_analysis.analyze(fn, args, leaves, keep_ops)
    deep.update(argument_leaves=leaves, build_s=t1 - t0, run_s=time.perf_counter() - t1,
                build_collectives=_summarize(hlo_analysis.collectives_of(built)))
    return out, deep


def run_cell(arch: str, shape_name: str, mesh_kind: str, hlo_dir: str | None = None, *,
             cfg: ModelConfig | None = None, shape: ShapeConfig | None = None,
             mesh_shape: tuple[int, ...] | None = None, device="cuda", rank: int = 0,
             slots: int | None = None) -> dict:
    """The record of one cell, built dry (module docstring) as rank
    ``rank`` of a fake world of ``mesh_shape`` (by default the production
    mesh of ``mesh_kind``), its tensors fake on ``device``.  ``cfg`` and
    ``shape`` replace the published config and shape, ``slots`` is
    :func:`build_cell`'s.  A failure is recorded (``status`` ``"error"``,
    the error, the traceback's end)."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode, is_fake

    ok, why = applicable(arch, shape_name)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind}
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = why
        return rec
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    rec.update(rank=rank, device=str(device), model_flops=roofline.model_flops_of(cfg, shape))
    try:
        if mesh_shape is None:
            mesh = make_production_mesh(multi_pod=mesh_kind == "multi", device=device,
                                        dry=True, rank=rank)
        else:
            mesh = make_dry_mesh(tuple(mesh_shape), MESH_AXES[len(mesh_shape)], device, rank)
        rec["mesh_shape"] = list(mesh.shape.values())
        with FakeTensorMode():
            t0 = time.perf_counter()
            model = train.shard_model(cfg, mesh,
                                      torch.Generator(device=mesh.device).manual_seed(0))
            init_s = time.perf_counter() - t0
            _, deep = measure_cell(arch, shape_name, mesh, cfg=cfg, shape=shape, model=model,
                                   slots=slots, keep_ops=bool(hlo_dir))
        real = [n for n, p in model.params().items() if not is_fake(p)]
        if real:
            raise RuntimeError(f"the dry cell holds real parameter blocks: {real}")
        colls = deep.pop("collectives")
        ops = deep.pop("ops", [])
        if hlo_dir:
            os.makedirs(hlo_dir, exist_ok=True)
            with gzip.open(os.path.join(
                    hlo_dir, f"{arch}__{shape_name}__{mesh_kind}.ops.jsonl.gz"), "wt") as zf:
                for line in ops:
                    zf.write(json.dumps(line) + "\n")
                for c in colls:
                    zf.write(json.dumps({"collective": c}) + "\n")
        rec.update(status="ok", build_s=round(init_s + deep.pop("build_s"), 2),
                   run_s=round(deep.pop("run_s"), 2), **deep)
        print(
            f"[dryrun] {arch} × {shape_name} × {mesh_kind}: OK "
            f"run={rec['run_s']}s dot_flops={rec['dot_flops']:.3e} "
            f"coll_bytes={rec['collective_bytes']:.3e} "
            f"temp={rec['memory']['temp_size_in_bytes'] / 2**30:.2f}GiB",
            flush=True,
        )
    except Exception as e:  # record and continue: failures are bugs to fix
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-3000:]
        print(f"[dryrun] {arch} × {shape_name} × {mesh_kind}: FAIL {rec['error']}",
              flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return rec


def _summarize(colls: list[dict]) -> dict:
    agg: dict = {"total_bytes": 0.0, "by_kind": {}, "count": len(colls)}
    for c in colls:
        agg["total_bytes"] += c["bytes"]
        k = c["kind"]
        e = agg["by_kind"].setdefault(k, {"bytes": 0.0, "count": 0, "groups": {}})
        e["bytes"] += c["bytes"]
        e["count"] += 1
        g = str(c["group"])
        e["groups"][g] = e["groups"].get(g, 0) + 1
    return agg


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="launch_results")
    ap.add_argument("--resume", action="store_true", help="skip cells already done")
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device (cuda, or cpu where torch has no CUDA)")
    args = ap.parse_args()

    os.makedirs(args.out, exist_ok=True)

    cells = (
        [(a, s, m) for a in ARCHS for s in SHAPES for m in ("single", "multi")]
        if args.all
        else [(args.arch, args.shape, args.mesh)]
    )
    for arch, shape_name, mesh_kind in cells:
        path = os.path.join(args.out, f"{arch}__{shape_name}__{mesh_kind}.json")
        if args.resume and os.path.exists(path):
            with open(path) as f:
                if json.load(f).get("status") in ("ok", "skipped"):
                    continue
        rec = run_cell(arch, shape_name, mesh_kind, hlo_dir=os.path.join(args.out, "hlo"),
                       device=args.device)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)


if __name__ == "__main__":
    main()
