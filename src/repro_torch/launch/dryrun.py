"""The reference's cells on a mesh: :func:`build_cell` and :func:`applicable`.

Port of the JAX package's ``launch/dryrun.py``, its ``build_cell``.  The
reference lowers and compiles every (arch × shape × mesh) cell from
``ShapeDtypeStruct`` inputs and reads the HLO's memory, cost and
collectives; the port has no HLO, so :func:`build_cell` builds the cell
for real on a ``launch/mesh.py`` mesh (every rank calls it) and returns
the step with its inputs, each rank holding its block:

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
reconcile; the port refuses it.  ``run_cell``, ``main`` and the HLO
analysis are not ported (ROADMAP.md §1).
"""
from __future__ import annotations

import contextlib
import os

import torch
from torch import nn

from repro_torch.configs import get_config
from repro_torch.launch import sharding as shd
from repro_torch.launch import train
from repro_torch.launch.mesh import all_gather
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
