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
port of the sparse branch of the JAX package's ``JaxChannelEngine.run``
and is registered under the name ``"torch"``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.prepare import Prepared
from repro_torch.core.torch_engine import build_sparse_program


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
    """Sparse torch backend: :class:`~repro_torch.core.torch_engine.
    SparseProgram` hops on the hand-written kernels over grouped-CSR
    relations, group-axis stream tiles, MIN/MAX on the semiring kernel;
    with ``fused`` every hop is one ``fused_hop`` launch.

    ``device`` defaults to ``"cuda"``; a plan fails at compile time when
    no card is present.  ``TorchChannelEngine(device="cpu")`` runs the
    same walk on the CPU, where every kernel wrapper takes its plain
    PyTorch version.  Channel values are float32, exact to 2**24 per
    partial product (DESIGN.md §2, §7); MIN/MAX walk payload ranks and
    return the payloads themselves, in float64."""

    name = "torch"
    supports_streaming = True
    supports_fused = True

    def __init__(self, device: str | torch.device = "cuda"):
        self._device = torch.device(device)

    @property
    def device(self) -> torch.device:
        """The device to run on; raises when it is a card that is absent."""
        if self._device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "engine 'torch' runs on CUDA and no CUDA device is available; "
                'pass .engine(TorchChannelEngine(device="cpu")) to run on the CPU'
            )
        return self._device

    def run(self, prep, channels, minmax, stream=None, fused=None):
        """Contract all channels in one pass; one output per stream tile
        (``stream`` = ``(group attr, tile)``, as the planner resolved it).
        ``fused`` True/False pins the fused hops, None follows
        ``REPRO_FUSED``."""
        cm = tuple(ch.measure[0] if ch.kind == "sum" else None for ch in channels)
        prog = build_sparse_program(prep, cm, self.device, fused)
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


_REGISTRY = {"torch": TorchChannelEngine()}


def resolve_engine(engine: str | TorchChannelEngine) -> TorchChannelEngine:
    """A registered engine by name (only ``"torch"``), or the instance."""
    if isinstance(engine, str):
        try:
            return _REGISTRY[engine]
        except KeyError:
            raise ValueError(
                f"unknown engine {engine!r}; registered: {sorted(_REGISTRY)}"
            ) from None
    return engine
