"""Sharding rules: parameter / optimizer / batch / cache partition specs.

Port of the JAX package's ``launch/sharding.py``, rule for rule.
Baseline strategy:

* FSDP over ``data`` — every matrix shards its d_model-sized dim,
* Megatron TP over ``model`` — the head/ffn-sized dim,
* MoE expert parallelism — experts over ``data`` + TP over ``model``,
* cross-pod (``pod``): pure data parallelism (params replicated over the
  pod axis; gradients all-reduce over it),
* batch over (pod, data); decode caches: batch over data, kv-heads over
  model; long-context (batch < data size): KV sequence over data.

A spec is the reference's ``PartitionSpec`` as a tuple, one entry per
leading dimension: ``None``, an axis name, or a tuple of names (the
dimension cut over their product, the first the major).  The rules read
the port's dotted names (``layers.moe.wg``) where the reference reads
``layers/moe/wg``; every test they make (``startswith("layers")``,
``"moe" in name``, ``endswith("embed")``) answers the same for both.
A :class:`NamedSharding` pairs a spec with its :class:`~repro_torch.launch.mesh.Mesh`.

:func:`shard_of` and :func:`gather` are the port's own: a leaf's block
on this rank (contiguous equal blocks in mesh order, as ``NamedSharding``
lays them out) and its inverse, one ``all_gather`` per axis the spec names.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.launch.mesh import Mesh, all_gather, data_axes
from repro_torch.models.config import ModelConfig


@dataclass(frozen=True)
class NamedSharding:
    mesh: Mesh
    spec: tuple


def _shape(leaf) -> tuple[int, ...]:
    return tuple(leaf) if isinstance(leaf, (tuple, list, torch.Size)) else tuple(leaf.shape)


def param_spec(name: str, shape, cfg: ModelConfig) -> tuple:
    shape = _shape(shape)
    d = cfg.d_model

    if name.endswith("embed"):
        return ("model", "data")  # vocab-parallel + FSDP
    if name.endswith("lm_head"):
        return ("data", "model")

    # layer-stacked params carry scan dims in front: (L, ...) — and the
    # hybrid family stacks (groups, period, ...)
    stack = 0
    if name.startswith("layers") or name.startswith("enc_layers"):
        stack = 2 if cfg.family == "hybrid" else 1
    body = shape[stack:]
    lead = (None,) * stack

    if "moe" in name and len(body) == 3:
        # (E, a, b): expert-parallel over data, TP over the ffn dim
        if body[1] == d:  # wg/wu: (E, d, f)
            return (*lead, "data", None, "model")
        return (*lead, "data", "model", None)  # wd: (E, f, d)
    if len(body) != 2:
        return ()  # norms, biases, scalars, small tensors: replicated
    a, b = body
    if a == d:  # in-projections (d -> X): FSDP on d, TP on X
        return (*lead, "data", "model")
    if b == d:  # out-projections (X -> d): TP on X, FSDP on d
        return (*lead, "model", "data") if a >= 128 else (*lead, None, "data")
    if a >= 128 and b >= 128 and b % 128 == 0:
        return (*lead, None, "model")
    return ()


def entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes one spec entry cuts a dimension over, the major first."""
    return () if entry is None else entry if isinstance(entry, tuple) else (entry,)


def named_axes(spec: tuple) -> set[str]:
    """The mesh axes ``spec`` cuts over."""
    return {a for entry in spec for a in entry_axes(entry)}


def _sanitize(spec: tuple, shape, mesh: Mesh) -> tuple:
    """Argument shardings must divide evenly — drop any axis that doesn't
    divide its dim."""
    shape = _shape(shape)
    out = []
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape):
            out.append(None)
            continue
        total = 1
        for a in entry_axes(entry):
            total *= mesh.shape[a]
        out.append(entry if shape[i] % total == 0 else None)
    return tuple(out)


def param_shardings(params: dict, cfg: ModelConfig, mesh: Mesh) -> dict[str, NamedSharding]:
    """By dotted name; ``params`` maps names to tensors or shapes
    (``models/convert.py:param_shapes``)."""
    return {name: NamedSharding(mesh, _sanitize(param_spec(name, leaf, cfg), _shape(leaf), mesh))
            for name, leaf in params.items()}


def opt_shardings(opt_state, params_shardings: dict, mesh: Mesh) -> dict:
    """m/v shard exactly like their parameter; step is replicated."""
    return {"m": params_shardings, "v": params_shardings, "step": NamedSharding(mesh, ())}


def batch_spec(name: str, leaf, mesh: Mesh) -> tuple:
    shape = _shape(leaf)
    if len(shape) == 0:
        return ()
    total_dp = 1
    for a in data_axes(mesh):
        total_dp *= mesh.shape[a]
    if shape[0] < total_dp:
        return ()  # tiny batch (long-context decode): replicate
    dp = data_axes(mesh)
    dp = dp if len(dp) > 1 else dp[0]
    return (dp, *(None,) * (len(shape) - 1))


def batch_shardings(batch: dict, mesh: Mesh) -> dict[str, NamedSharding]:
    return {k: NamedSharding(mesh, _sanitize(batch_spec(k, v, mesh), _shape(v), mesh))
            for k, v in batch.items()}


def cache_spec(name: str, shape, cfg: ModelConfig, mesh: Mesh, batch_size: int) -> tuple:
    """KV caches (L, B, S, nkv, hd) / SSM states (L, B, ...).

    KV is batch-sharded over ``data`` and **sequence-sharded over
    ``model``**; a tiny batch (long_500k) puts the sequence over both axes."""
    dsize = mesh.shape["data"]
    shape = _shape(shape)
    if name.endswith(("k", "v")) and len(shape) == 5:
        S_len = shape[2]
        if batch_size >= dsize:
            return (None, "data", "model", None, None)
        if S_len % (dsize * mesh.shape["model"]) == 0:
            return (None, None, ("data", "model"), None, None)
        return (None, None, "model", None, None)
    bax = "data" if batch_size >= dsize else None
    if name.endswith("ssm") or name.endswith("wkv"):
        lead = (None,) * (len(shape) - 4)
        return (*lead, bax, "model", None, None)
    if name.endswith("conv"):  # (G, period, B, K-1, C)
        return (None, None, bax, None, None)
    if len(shape) >= 3:
        return (None, bax, *(None,) * (len(shape) - 2))
    return ()


def cache_shardings(cache: dict, cfg: ModelConfig, mesh: Mesh,
                    batch_size: int) -> dict[str, NamedSharding]:
    return {name: NamedSharding(mesh, _sanitize(cache_spec(name, leaf, cfg, mesh, batch_size),
                                                _shape(leaf), mesh))
            for name, leaf in cache.items()}


# ---------------------------------------------------------------- blocks


def _block(entry, mesh: Mesh) -> tuple[int, int]:
    """(the number of blocks, this rank's block) of a dimension cut over
    ``entry``'s axes, the first the major."""
    count, index = 1, 0
    for a in entry_axes(entry):
        count *= mesh.shape[a]
        index = index * mesh.shape[a] + mesh.coords[a]
    return count, index


def shard_of(full, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """This rank's block of the whole leaf ``full`` (a tensor or a numpy
    array), a tensor of its own (``full`` can be freed) on ``full``'s
    device."""
    out = torch.from_numpy(np.asarray(full)) if not isinstance(full, torch.Tensor) else full
    for dim, entry in enumerate(spec):
        count, index = _block(entry, mesh)
        if count == 1:
            continue
        if out.shape[dim] % count:
            raise ValueError(f"dimension {dim} of {tuple(out.shape)} does not divide into "
                             f"{count} blocks over {entry_axes(entry)}")
        size = out.shape[dim] // count
        out = out.narrow(dim, index * size, size)
    return out.clone(memory_format=torch.contiguous_format)


def gather(shard: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """The whole leaf from every rank's block (:func:`shard_of`'s inverse),
    a tensor of its own: an ``all_gather`` over each axis the spec names,
    the minor first."""
    out = shard
    for dim, entry in enumerate(spec):
        for a in reversed(entry_axes(entry)):
            out = all_gather(out, mesh.axis_group(a), dim)
    return out.clone() if out is shard else out
