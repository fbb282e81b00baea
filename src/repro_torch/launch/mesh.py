"""Meshes of ranks on ``torch.distributed``.

Port of the JAX package's ``launch/mesh.py``.  A :class:`Mesh` lays the
ranks of the default process group out on named axes, as a
``jax.sharding.Mesh`` lays out devices: ``shape`` (axis → size, in
order), ``axis_names``, this rank's ``coords`` (axis → index) and one
process group per axis, from a ``torch.distributed.device_mesh.DeviceMesh``
whose rank ``r`` sits at the row-major position ``r`` of the shape.
Single pod = 256 ranks as (data=16, model=16); multi-pod = 2 pods × 256
as (pod=2, data=16, model=16), the ``pod`` axis data parallel.

:func:`abstract_mesh` has the axes and no ranks, as ``AbstractMesh``:
the sharding rules (``launch/sharding.py``) read only ``shape`` and
``axis_names``.

The collectives below are the ones the meshed training code takes.  A
gloo group runs them on the host, so a tensor on a card is copied there
and back (NCCL does not take two ranks on one card; ranks that share a
card share it through gloo); a group with both backends
(``"cpu:gloo,cuda:nccl"``) hands a card's tensor to NCCL and a CPU
tensor to gloo.  None of them falls back to a local computation: each
runs over its group, also a group of one.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.core.torch_engine import require_device


class Mesh:
    """Named axes over ranks.  ``coords`` is None on a rank outside the
    mesh and on an abstract mesh, which has no groups either."""

    def __init__(self, shape: dict[str, int], device=None, device_mesh=None, group=None):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.device = None if device is None else torch.device(device)
        self.device_mesh = device_mesh
        self.group = group
        coords = None if device_mesh is None else device_mesh.get_coordinate()
        self.coords = None if coords is None else dict(zip(self.axis_names, coords))

    def axis_group(self, axis: str):
        """The process group of this rank's line along ``axis``, its
        members in the order of their coordinate on ``axis``."""
        return self.device_mesh.get_group(axis)

    def __repr__(self) -> str:
        where = "abstract" if self.device_mesh is None else f"{self.device}, coords {self.coords}"
        return f"Mesh({self.shape}, {where})"


def abstract_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> Mesh:
    """Axes without ranks: what the sharding rules read, for any size."""
    return Mesh(dict(zip(axes, shape)))


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], device="cuda") -> Mesh:
    """The first ``prod(shape)`` ranks of the default process group laid
    out row-major on ``axes`` (``jax.make_mesh``'s counterpart); every rank
    of the group calls it, since building the axis groups is collective.
    Tensors of the mesh live on ``device``: CUDA (the rank's current card)
    unless the caller asks for the CPU."""
    from torch.distributed.device_mesh import DeviceMesh

    device = require_device(device, "make_mesh", 'device="cpu"')
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(
            f"mesh {tuple(shape)} needs {n} ranks, have {have}; start {n} processes in one "
            "torch.distributed group (dist.init_process_group, or torchrun "
            f"--nproc-per-node {n}) before building it"
        )
    dm = DeviceMesh(device.type, torch.arange(n).reshape(shape), mesh_dim_names=tuple(axes))
    group = dist.group.WORLD if have == n else dist.new_group(list(range(n)))
    return Mesh(dict(zip(axes, shape)), device, dm, group)


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def data_axes(mesh: Mesh) -> tuple[str, ...]:
    """Axes carrying batch/data parallelism (pod included when present)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


# ---------------------------------------------------------------- collectives


def _host(t: torch.Tensor, group) -> str | torch.device:
    """Where the collective takes ``t``: the host when gloo carries it (a
    CPU tensor, or a card's on a gloo group), else its card."""
    return "cpu" if not t.is_cuda or dist.get_backend(group) == "gloo" else t.device


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """A new tensor: ``t`` summed (or its ``"max"``) over ``group``."""
    out = t.detach().to(_host(t, group), copy=True).contiguous()
    dist.all_reduce(out, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                    group=group)
    return out.to(t.device)


def all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every member's ``t`` concatenated along ``dim``, in member order."""
    src = t.detach().to(_host(t, group)).contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` cut into equal chunks along dim 0, chunk ``i`` sent to member
    ``i``; the received chunks stacked along dim 0 in member order.  The
    operation is its own inverse.  Bytes move as they are (gloo takes no
    bf16: a bf16 tensor crosses it as float16 of the same bits)."""
    host = _host(t, group)
    src = t.detach().to(host).contiguous()
    raw = src.view(torch.float16) if host == "cpu" and src.dtype == torch.bfloat16 else src
    out = torch.empty_like(raw)
    dist.all_to_all_single(out, raw, group=group)
    return out.view(src.dtype).to(t.device)
