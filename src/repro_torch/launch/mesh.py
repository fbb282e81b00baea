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

:func:`make_dry_mesh` (and ``make_production_mesh(dry=True)``) lays the
same axes over a fake world of ``prod(shape)`` ranks in this one process,
torch's ``"fake"`` process-group backend: its collectives return tensors
of the right shape and move nothing, so a cell built on it under a
``FakeTensorMode`` costs what one rank would count and allocates nothing
(``launch/dryrun.py``), with no card, as the reference's dry run needs no
TPU.

The collectives below are the ones the meshed training code takes.  A
gloo group runs them on the host, so a tensor on a card is copied there
and back (NCCL does not take two ranks on one card; ranks that share a
card share it through gloo); a group with both backends
(``"cpu:gloo,cuda:nccl"``) hands a card's tensor to NCCL and a CPU
tensor to gloo.  None of them falls back to a local computation: each
runs over its group, also a group of one.  Inside :func:`recording`
each call also appends one entry to the log it yields (:func:`_record`).
"""
from __future__ import annotations

import contextlib
import math
import sys
import time

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
        if coords is not None:
            for axis in self.axis_names:
                _AXIS_OF_GROUP[device_mesh.get_group(axis).group_name] = axis

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


def make_dry_mesh(shape: tuple[int, ...], axes: tuple[str, ...], device="cuda",
                  rank: int = 0) -> Mesh:
    """``make_mesh``'s axes over a fake world of ``prod(shape)`` ranks, this
    process being rank ``rank``: torch's ``"fake"`` backend, started here
    unless a fake world of that size and rank is already up.  Tensors of
    the mesh are fake tensors on ``device`` (the caller's
    ``FakeTensorMode``); no card is needed.  Raises if the fake backend
    cannot be had or another process group is up."""
    from torch.distributed.device_mesh import DeviceMesh

    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "a dry mesh needs torch's fake process-group backend "
            "(torch.testing._internal.distributed.fake_pg.FakeStore), which this torch "
            f"{torch.__version__} lacks") from e
    n = math.prod(shape)
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=n)
    elif (dist.get_backend(), dist.get_world_size(), dist.get_rank()) != ("fake", n, rank):
        raise RuntimeError(
            f"a dry mesh of {n} ranks (this one {rank}) needs a fake world of its own; a "
            f"{dist.get_backend()} group of {dist.get_world_size()} ranks is up "
            "(destroy it first)")
    device = torch.device(device)
    dm = DeviceMesh(device.type, torch.arange(n).reshape(shape), mesh_dim_names=tuple(axes))
    return Mesh(dict(zip(axes, shape)), device, dm, dist.group.WORLD)


def make_production_mesh(*, multi_pod: bool = False, device="cuda", dry: bool = False,
                         rank: int = 0) -> Mesh:
    """Single pod = (data=16, model=16), multi-pod = (pod=2, data=16,
    model=16): over the default group's ranks, or with ``dry`` over a fake
    world this process is rank ``rank`` of (:func:`make_dry_mesh`)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if dry:
        return make_dry_mesh(shape, axes, device, rank)
    return make_mesh(shape, axes, device)


def data_axes(mesh: Mesh) -> tuple[str, ...]:
    """Axes carrying batch/data parallelism (pod included when present)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


# ---------------------------------------------------------------- collectives

# each mesh axis's process group, by group name, as the mesh built it
_AXIS_OF_GROUP: dict[str, str] = {}
# the logs of the open :func:`recording` contexts, innermost last
_LOGS: list[list[dict]] = []


@contextlib.contextmanager
def recording():
    """Yields a list to which every collective below, while the context is
    open, appends one entry (:func:`_record`), in call order."""
    log: list[dict] = []
    _LOGS.append(log)
    try:
        yield log
    finally:
        _LOGS.remove(log)


def _record(kind: str, t: torch.Tensor, out: torch.Tensor, group, t0: float) -> None:
    """One entry in every open log: ``kind`` in the reference's names
    (``all-reduce``, ``all-gather``, ``all-to-all``); ``bytes``, the result's
    bytes on this rank, as ``hlo_analysis`` counts a collective; ``in_bytes``,
    the input's; ``group``, the group's size; ``axes``, the mesh axis the
    group runs along (empty for a group no mesh built); ``ranks``, its first
    and last member; ``seconds`` from the call to its return (host copies
    included); ``caller``, the module of the function that called it."""
    if not _LOGS:
        return
    ranks = dist.get_process_group_ranks(group)
    axis = _AXIS_OF_GROUP.get(group.group_name)
    entry = {"kind": kind, "bytes": out.numel() * out.element_size(),
             "in_bytes": t.numel() * t.element_size(), "group": len(ranks),
             "axes": [axis] if axis else [], "ranks": [ranks[0], ranks[-1]],
             "seconds": time.perf_counter() - t0,
             "caller": sys._getframe(2).f_globals.get("__name__", "")}
    for log in _LOGS:
        log.append(entry)


def _host(t: torch.Tensor, group) -> str | torch.device:
    """Where the collective takes ``t``: the host when gloo carries it (a
    CPU tensor, or a card's on a gloo group), else its card."""
    return "cpu" if not t.is_cuda or dist.get_backend(group) == "gloo" else t.device


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """A new tensor: ``t`` summed (or its ``"max"``) over ``group``."""
    t0 = time.perf_counter()
    out = t.detach().to(_host(t, group), copy=True).contiguous()
    dist.all_reduce(out, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                    group=group)
    out = out.to(t.device)
    _record("all-reduce", t, out, group, t0)
    return out


def all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every member's ``t`` concatenated along ``dim``, in member order."""
    t0 = time.perf_counter()
    src = t.detach().to(_host(t, group)).contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim).to(t.device)
    _record("all-gather", t, out, group, t0)
    return out


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` cut into equal chunks along dim 0, chunk ``i`` sent to member
    ``i``; the received chunks stacked along dim 0 in member order.  The
    operation is its own inverse.  Bytes move as they are (gloo takes no
    bf16: a bf16 tensor crosses it as float16 of the same bits)."""
    t0 = time.perf_counter()
    host = _host(t, group)
    src = t.detach().to(host).contiguous()
    raw = src.view(torch.float16) if host == "cpu" and src.dtype == torch.bfloat16 else src
    out = torch.empty_like(raw)
    dist.all_to_all_single(out, raw, group=group)
    out = out.view(src.dtype).to(t.device)
    _record("all-to-all", t, out, group, t0)
    return out
