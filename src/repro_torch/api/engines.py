"""The execution engine behind the logical planner (DESIGN.md §6).

The planner compiles a query down to one :class:`Prepared` plus

* an ordered tuple of distributive semiring :class:`Channel`\\ s (COUNT, or
  SUM over a measure relation's payload) contracted **in a single pass**
  — weight vectors become weight matrices, messages carry a channel axis,
  and AVG is assembled from a SUM/COUNT pair at decode time, and
* a tuple of :class:`MinMaxRequest`\\ s, one ``(min, +)``/``(max, +)``
  semiring pass each.

:class:`TorchChannelEngine` turns those into sparse :class:`EngineOutput`
tiles on one device: CUDA unless the caller asks for the CPU.  It is the
port of the JAX package's ``JaxChannelEngine.run`` (the dense einsum
program or the sparse kernel walk, chosen per run; over a mesh, the
sharded sparse walk of ``repro_torch.core.distributed``) and is
registered under the name ``"torch"``.  :class:`RefChannelEngine`, the
paper's own data-graph traversal (``repro_torch.core.ref_engine``), is
registered as ``"ref"``.  Any other backend that meets the
:class:`Engine` protocol joins them through :func:`register_engine`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core.prepare import Prepared
from repro_torch.core.torch_engine import (
    build_dense_program,
    build_sparse_program,
    choose_path,
    require_device,
)

MODES = ("auto", "dense", "sparse")


@dataclass(frozen=True)
class Channel:
    """One distributive channel: ``count``, or ``sum`` over a measure.

    ``measure`` names the *post-rewrite* relation carrying the payload
    (the planner resolves folds before engines run).
    """

    kind: str  # "count" | "sum"
    measure: tuple[str, str] | None = None


COUNT_CHANNEL = Channel("count")


@dataclass(frozen=True)
class MinMaxRequest:
    kind: str  # "min" | "max"
    measure: tuple[str, str]


@dataclass
class EngineOutput:
    """Sparse results for one (tile of the) group space, on the host.

    ``group_codes`` rows are global dictionary codes over the canonical
    group attributes (stream tiles are already offset back), in
    ascending order; rows are the groups whose join is non-empty (COUNT
    channel > 0).
    """

    group_codes: np.ndarray  # (n, n_group_attrs) int64, column-major
    channel_values: np.ndarray  # (n, k) float64, column-major, order = channels
    minmax_values: dict[MinMaxRequest, np.ndarray]  # (n,) float64 each


@runtime_checkable
class Engine(Protocol):
    """The contract an execution backend implements for the planner.

    Register an instance with :func:`register_engine` and name it in
    ``Q.engine(name)``, or pass the instance itself."""

    name: str
    supports_streaming: bool

    def run(
        self,
        prep: Prepared,
        channels: tuple[Channel, ...],
        minmax: tuple[MinMaxRequest, ...],
        stream: tuple[str, int] | None = None,
        memory_budget: int | None = None,
    ) -> list[EngineOutput]:
        """Contract all channels in one pass; one output per stream tile.

        ``memory_budget`` is advisory: engines with an internal physical
        choice (the torch engine's dense-vs-sparse path) use it; others
        may leave it out of their signature, and the planner then does
        not pass it (it has already resolved ``stream`` from it).

        Engines that run fused hop kernels set ``supports_fused = True``
        and take a ``fused`` keyword; the planner passes it to no other.
        Engines that can execute over a mesh set ``supports_mesh = True``
        and take a ``mesh`` keyword: a shard count, or a
        ``torch.distributed.device_mesh.DeviceMesh``.  The planner raises
        :class:`~repro_torch.core.operator.UnsupportedPlanOption` before
        it calls an engine that cannot honour a requested option."""
        ...


def _to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` as a host array; from a card through pinned memory."""
    if t.device.type == "cpu":
        return t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return host.numpy()


def sparsify(
    prep: Prepared,
    channels: tuple[Channel, ...],
    arr: torch.Tensor,
    mm: dict[MinMaxRequest, torch.Tensor],
    offsets: dict[str, int] | None,
) -> EngineOutput:
    """Dense ``(*group_dims, k)`` channel tensor -> sparse EngineOutput.

    Selects the ``COUNT > 0`` groups, computes their global codes and
    gathers their values on the tensor's device, then copies only those
    rows to the host: the one transfer back of a tile."""
    ci = channels.index(COUNT_CHANNEL)
    dims = tuple(arr.shape[:-1])
    k = arr.shape[-1]
    flat = torch.nonzero(arr[..., ci].reshape(-1) > 0).squeeze(1)
    # built column by column, so each result column arrives contiguous
    codes = torch.empty((len(dims), flat.numel()), dtype=torch.int64, device=arr.device)
    rem = flat
    for i in reversed(range(len(dims)) if flat.numel() else ()):
        codes[i] = rem % dims[i]
        rem = rem // dims[i]
    for i, (_, attr) in enumerate(prep.group_attrs):
        if offsets and offsets.get(attr):
            codes[i] += offsets[attr]
    values = torch.cat(
        [arr.reshape(-1, k)[flat].T.to(torch.float64)]
        + [a.reshape(-1)[flat][None].to(torch.float64) for a in mm.values()]
    )
    codes_h, values_h = _to_host(codes), _to_host(values)
    return EngineOutput(
        codes_h.T,
        values_h[:k].T,
        {req: values_h[k + j] for j, req in enumerate(mm)},
    )


class TorchChannelEngine:
    """The torch backend on one device.

    :func:`~repro_torch.core.torch_engine.choose_path` prices both paths
    for every run, as the JAX package's engine does: the sparse
    :class:`~repro_torch.core.torch_engine.SparseProgram` (hops on the
    hand-written kernels over grouped-CSR relations, group-axis stream
    tiles, MIN/MAX on the semiring kernel; with ``fused`` every hop is
    one ``fused_hop`` launch) runs when a stream is requested or the
    dense einsum program would cross its 2**24-cell cliff, its memory
    budget or, by the statistics, be extreme-sparse; otherwise the
    :class:`~repro_torch.core.torch_engine.DenseProgram` contracts the
    COUNT/SUM channels.  A dense run's MIN/MAX come from
    ``SparseProgram.run_minmax`` on the same device — ``segment_reduce``
    hops, the float64 payloads the JAX package's host reachability pass
    returns — so nothing of a run leaves the card before its result.

    ``device`` defaults to ``"cuda"``; a plan fails at compile time when
    no card is present.  ``TorchChannelEngine(device="cpu")`` runs the
    same paths on the CPU, where every kernel wrapper takes its plain
    PyTorch version.  ``mode`` pins the path: ``"auto"`` (the default)
    follows the choice, ``"dense"`` or ``"sparse"`` override it.
    Channel values are float32, exact to 2**24 per partial product
    (DESIGN.md §2, §7).

    ``run(..., mesh=...)`` runs the sharded path instead (DESIGN.md §8):
    a collective call that every rank of the mesh's process group makes,
    each on its own device, and each gets every shard's output."""

    name = "torch"
    supports_streaming = True
    supports_fused = True
    supports_mesh = True

    def __init__(self, device: str | torch.device = "cuda", mode: str = "auto"):
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; use one of {MODES}")
        self._device = torch.device(device)
        self.mode = mode

    @property
    def device(self) -> torch.device:
        """The device to run on; raises when it is a card that is absent."""
        return require_device(self._device)

    def path(self, prep, channels, stream=None, memory_budget=None, fused=None) -> str:
        """``"dense"`` or ``"sparse"``: the path :meth:`run` takes.  In
        auto mode an explicit ``.fused(True)`` pins sparse — fused hops
        have no dense-einsum form; ``REPRO_FUSED`` alone does not move
        the choice."""
        if self.mode != "auto":
            return self.mode
        cm = tuple(ch.measure[0] if ch.kind == "sum" else None for ch in channels)
        choice = choose_path(
            prep, k=len(channels), memory_budget=memory_budget, stream=stream,
            measured=cm,
        )
        return "dense" if choice.path == "dense" and fused is not True else "sparse"

    def run(
        self, prep, channels, minmax, stream=None, memory_budget=None, fused=None,
        mesh=None,
    ):
        """Contract all channels in one pass; one output per stream tile
        (``stream`` = ``(group attr, tile)``, as the planner resolved it).
        ``memory_budget`` is the dense program's budget in the path
        choice; ``fused`` True/False pins the fused hops, None follows
        ``REPRO_FUSED``.  ``mesh`` (a shard count or a ``DeviceMesh``)
        runs the sharded path: one output per shard."""
        cm = tuple(ch.measure[0] if ch.kind == "sum" else None for ch in channels)
        if mesh is not None:
            return self._run_distributed(prep, channels, minmax, cm, mesh, fused)
        prog = build_sparse_program(prep, cm, self.device, fused)
        if self.path(prep, channels, stream, memory_budget, fused) == "dense":
            if stream is not None:
                raise ValueError("the dense program cannot tile a stream")
            arr = build_dense_program(prep, self.device).run_channels(cm)
            mm = {req: prog.run_minmax(req.kind, req.measure[0]) for req in minmax}
            return [sparsify(prep, channels, arr, mm, None)]
        tiles = [(None, None, None)] if stream is None else prog.run_stream(*stream)
        outs = []
        for enc, domains, offsets in tiles:
            views: dict = {}  # share per-tile CSR views across the passes
            arr = prog.run_channels(enc, domains, view_cache=views)
            mm = {
                req: prog.run_minmax(
                    req.kind, req.measure[0], enc, domains, view_cache=views
                )
                for req in minmax
            }
            outs.append(sparsify(prep, channels, arr, mm, offsets))
        return outs

    def _run_distributed(self, prep, channels, minmax, cm, mesh, fused):
        """Sharded sparse execution over the mesh's data axis: this rank
        walks its CSR partition of the root group attribute and gathers
        every shard's partial; one :class:`EngineOutput` per shard
        (DESIGN.md §8).  MIN/MAX ride the same program, masked by the
        COUNT channel like every other sparse path."""
        from repro_torch.core.distributed import build_distributed_program

        prog = build_distributed_program(
            prep, cm, mesh, minmax=tuple((r.kind, r.measure[0]) for r in minmax),
            fused=fused, device=self.device,
        )
        return [
            sparsify(prep, channels, arr, dict(zip(minmax, mms)), offsets)
            for arr, mms, offsets in prog.run()
        ]


class RefChannelEngine:
    """The paper-faithful engine on one device: the data graph built on
    the card and walked breadth-first over tiles of sources, carrying k
    COUNT/SUM channels (:func:`~repro_torch.core.ref_engine.ref_run`),
    each keyed sum on the ``segment_sum`` kernel.  MIN/MAX at the
    joined groups come from ``SparseProgram.run_minmax`` on the same
    device (``segment_reduce`` hops), as the torch engine's dense path
    takes them.  No streaming, no fused hops, no mesh, no split plans:
    the reference's ``"ref"`` has none either.

    ``device`` defaults to ``"cuda"``; a plan fails at compile time when
    no card is present, and ``RefChannelEngine(device="cpu")`` is the
    only way onto the CPU."""

    name = "ref"
    supports_streaming = False

    def __init__(self, device: str | torch.device = "cuda"):
        self._device = torch.device(device)

    @property
    def device(self) -> torch.device:
        """The device to run on; raises when it is a card that is absent."""
        return require_device(
            self._device, "engine 'ref'", '.engine(RefChannelEngine(device="cpu"))'
        )

    def run(self, prep, channels, minmax, stream=None):
        """All channels in one traversal; one output, its groups those
        with COUNT > 0 in ascending order."""
        from repro_torch.core.ref_engine import ref_run

        if stream is not None:
            raise ValueError("the ref engine cannot tile a stream")
        device = self.device
        cm = tuple(ch.measure[0] if ch.kind == "sum" else None for ch in channels)
        run = ref_run(prep, cm, device)
        keep = run.values[:, channels.index(COUNT_CHANNEL)] > 0
        codes, vals = run.codes[keep], run.values[keep]
        mm = {}
        if minmax:
            prog = build_sparse_program(prep, cm, device)
            at = tuple(codes.T)
            mm = {req: prog.run_minmax(req.kind, req.measure[0])[at] for req in minmax}
        k = len(channels)
        values = torch.cat(
            [vals.T.to(torch.float64)] + [m[None].to(torch.float64) for m in mm.values()]
        )
        codes_h, values_h = _to_host(codes.T.contiguous()), _to_host(values)
        return [EngineOutput(
            codes_h.T, values_h[:k].T, {req: values_h[k + j] for j, req in enumerate(mm)},
        )]


_REGISTRY: dict[str, Engine] = {}


def register_engine(engine: Engine) -> Engine:
    """Register an execution backend under ``engine.name``."""
    _REGISTRY[engine.name] = engine
    return engine


def resolve_engine(engine: str | Engine) -> Engine:
    """A registered engine by name, or the instance itself."""
    if isinstance(engine, str):
        try:
            return _REGISTRY[engine]
        except KeyError:
            raise ValueError(
                f"unknown engine {engine!r}; registered: {sorted(_REGISTRY)}"
            ) from None
    return engine


register_engine(TorchChannelEngine())
register_engine(RefChannelEngine())
