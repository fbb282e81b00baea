"""Sparse execution of the JOIN-AGG contraction on the card (DESIGN.md §7).

Port of the sparse half of the JAX package's ``core/jax_engine.py``
(``_CsrHopMixin``, ``_KernelChannelEngine``, ``_MinMaxKernelEngine``,
``SparseProgram``, ``build_sparse_program``).  Relations stay in
grouped-CSR coordinate form and every decomposition-tree hop runs on the
hand-written kernels, with the same routing as the JAX engine:

* single-child hop with channel-uniform weights → ``coo_spmm``, the child
  message as the dense operand (its ``k`` channels ride the columns);
* leaf / multi-child / measure-weighted hop → the per-edge
  channel-diagonal product of gathered child message rows (plain tensor
  code), reduced with ``segment_sum``;
* MIN/MAX → ``(min, +)`` / ``(max, +)`` semiring hops on
  ``segment_reduce``;
* fused (``Q.fused(True)`` or ``REPRO_FUSED``) → every hop, sum or
  MIN/MAX, is one ``fused_hop`` launch: no edge chunks, no edge-sized
  product (DESIGN.md §13).

What lives on the device: each grouped-CSR view (sorted keys, permuted
codes and weights), moved once per ``Prepared`` or stream tile, and every
message of the walk.  No dense relation tensor is ever built; peak
memory is the largest message, and group-axis stream tiles bound even
that.  The JAX engine's ``EDGE_BUCKET`` padding (static shapes for jit)
and its numpy fallback for ``≥ 2**31`` segments are gone: the kernels
index in int64.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field
from typing import Iterator

import numpy as np
import torch

from repro_torch.core.prepare import CSRView, Prepared, csr_restrict, grouped_csr
from repro_torch.core.tensor_engine import ChannelTensorEngine, TensorEngine
from repro_torch.kernels.coo_spmm import coo_spmm
from repro_torch.kernels.fused_hop import fused_hop
from repro_torch.kernels.ops import fused_enabled
from repro_torch.kernels.segment_reduce import segment_reduce
from repro_torch.kernels.segment_sum import segment_sum

# the general hop's per-edge product materializes (edges × width·k)
# floats; the edge axis is chunked so that temporary stays within this
# bound however large the relation
_REF_GATHER_BYTES = 64 << 20


@dataclass
class DeviceView:
    """A :class:`~repro_torch.core.prepare.CSRView` moved to the device:
    the relation's codes in ascending-key order and the keys themselves
    (kept on the host too, where edge chunks are planned without reading
    the device), plus the engines' memo of weights uploaded in that
    order."""

    attrs: tuple[str, ...]
    keys: torch.Tensor  # (n,) int64, ascending
    keys_host: np.ndarray  # the same keys on the host
    codes: torch.Tensor  # (n, arity) int64
    order: np.ndarray  # sorted position -> encoded row
    memo: dict = field(default_factory=dict)

    @staticmethod
    def build(er, view: CSRView, device: torch.device) -> "DeviceView":
        codes = np.ascontiguousarray(er.codes[view.order], dtype=np.int64)
        return DeviceView(
            view.attrs,
            torch.from_numpy(view.keys).to(device),
            view.keys,
            torch.from_numpy(codes).to(device),
            view.order,
        )

    def upload(self, host: np.ndarray) -> torch.Tensor:
        """Per-edge ``host`` values (rows in encoded order), permuted into
        key order, as float32 on the view's device."""
        w = np.ascontiguousarray(host[self.order], dtype=np.float32)
        return torch.from_numpy(w).to(self.keys.device)


def key_chunks(
    keys: np.ndarray, num_keys: int, chunk: int
) -> Iterator[tuple[int, int, int, int, bool]]:
    """Split ascending ``keys`` into edge ranges of at most ``chunk`` edges.

    Yields ``(e_lo, e_hi, k_lo, k_hi, shared)``: edges ``[e_lo, e_hi)``
    hold every edge with a key in ``[k_lo, k_hi)`` except, when
    ``shared``, the earlier edges of key ``k_lo`` (a run longer than a
    chunk is split, and its key appears in two ranges).  The key ranges
    tile ``[0, num_keys)``, so one kernel launch per chunk writes each
    output row once and only split runs need combining.
    """
    n = len(keys)
    if n == 0:
        yield 0, 0, 0, num_keys, False
        return
    bounds = [0]
    while bounds[-1] < n:
        lo = bounds[-1]
        hi = min(lo + chunk, n)
        if hi < n:
            cut = int(np.searchsorted(keys, keys[hi], "left"))
            if cut > lo:  # end at a run boundary unless the run fills the chunk
                hi = cut
        bounds.append(hi)
    for i in range(len(bounds) - 1):
        lo, hi = bounds[i], bounds[i + 1]
        shared = i > 0 and keys[lo - 1] == keys[lo]
        k_lo = 0 if i == 0 else int(keys[lo])
        if hi == n:
            k_hi = num_keys
        else:
            k_hi = int(keys[hi]) + int(keys[hi - 1] == keys[hi])
        yield lo, hi, k_lo, k_hi, shared


class _CsrHopMixin:
    """Feed every hop its relation in grouped-CSR order on the device:
    edges sorted by the hop's raveled output key (up attrs + own group
    attr), so each output row's edges form one contiguous run.  Views of
    the prepared relations are memoized on the ``Prepared``; a stream
    tile's views in ``view_cache``, shared by the tile's channel pass and
    each MIN/MAX pass, so every relation moves to the device once."""

    view_cache: dict

    def _view(self, rel: str, key_attrs: tuple[str, ...]) -> DeviceView:
        er = self.encoded[rel]
        if er is self.prep.encoded.get(rel):
            cache, key = self.prep.device_views, (str(self.device), rel, key_attrs)
        else:  # stream tile: restricted domains, tile-local view
            cache, key = self.view_cache, (rel, key_attrs)
        view = cache.get(key)
        if view is None:
            if cache is self.view_cache:
                host = grouped_csr(er, key_attrs, self._dims(key_attrs))
            else:
                host = self.prep.csr_view(rel, key_attrs)
            view = cache[key] = DeviceView.build(er, host, self.device)
        return view


def _gathered_products(vals, gathers, sl, combine, chan: tuple[int, ...]):
    """Per-edge outer product (``combine`` = ``*`` or ``+``) of the edge
    weights with each child's gathered message rows, channel-diagonal."""
    for m2, idx in gathers:
        rows = m2[idx[sl]]  # (c, Wc, *chan)
        width = vals.shape[1] * rows.shape[1]
        vals = combine(
            vals.unsqueeze(2), rows.unsqueeze(1)
        ).reshape((vals.shape[0], width) + chan)
    return vals


def _reduce_in_chunks(
    keys: torch.Tensor, keys_host: np.ndarray, out: torch.Tensor, chunk: int,
    edge_values, reduce, combine,
) -> torch.Tensor:
    """Fill ``out`` (one row per key) chunk by chunk: for each key range
    of :func:`key_chunks`, form the chunk's per-edge values
    (``edge_values(edge slice)``) and let the kernel (``reduce(values,
    ids, num_keys, out=rows)``) write the range's rows; a run split
    across two chunks combines its two partials with ``combine``."""
    for e_lo, e_hi, k_lo, k_hi, shared in key_chunks(keys_host, out.shape[0], chunk):
        sl = slice(e_lo, e_hi)
        dst = out[k_lo:k_hi]
        carry = dst[0].clone() if shared else None
        reduce(edge_values(sl), keys[sl] - k_lo, k_hi - k_lo, out=dst)
        if carry is not None:
            dst[0] = combine(dst[0], carry)
    return out


def contract_hop(
    keys: torch.Tensor,
    keys_host: np.ndarray,
    w: torch.Tensor,
    gathers,
    knum: int,
    kind: str,
    fused: bool,
    uniform: bool = False,
) -> torch.Tensor:
    """One hop into ``(knum, width·k)``: ``out[keys[e]] ⊕= w[e] ⊗ Π_c
    m2_c[idx_c[e]]`` (outer product over the children's widths,
    channel-diagonal) for edges in grouped-CSR order — ``keys`` ascending
    on the device, ``keys_host`` the same keys on the host —, ``w (n,
    k)``, ``gathers`` of ``(m2 (rows, width_c[, k]), idx (n,))`` pairs and
    ``kind`` ``"sum"`` (×, +) or ``"min"``/``"max"`` (+, min/max; k = 1).

    ``fused`` → one ``fused_hop`` launch.  Otherwise the JAX engine's
    three-dispatch routing: a single-child sum hop with channel-
    ``uniform`` weights on ``coo_spmm``; every other hop as the per-edge
    product of gathered child rows, in edge chunks bounded by
    ``_REF_GATHER_BYTES``, reduced by ``segment_sum`` or
    ``segment_reduce``."""
    k = w.shape[1]
    gathers = [(m2.reshape(m2.shape[0], m2.shape[1], k), idx) for m2, idx in gathers]
    if fused:
        return fused_hop(
            keys, w, [m2.reshape(m2.shape[0], -1) for m2, _ in gathers],
            [idx for _, idx in gathers], knum, k, kind,
        )
    if kind == "sum" and len(gathers) == 1 and uniform:
        m2, idx = gathers[0]
        return coo_spmm(
            keys, idx, w[:, 0].contiguous(), m2.reshape(m2.shape[0], -1), knum
        )
    width = math.prod(m2.shape[1] for m2, _ in gathers)
    out = torch.empty((knum, width * k), dtype=torch.float32, device=w.device)
    if kind == "sum":
        combine, reduce, merge = torch.mul, segment_sum, torch.add
    else:
        combine = torch.add
        reduce = functools.partial(segment_reduce, kind=kind)
        merge = torch.minimum if kind == "min" else torch.maximum
    return _reduce_in_chunks(
        keys, keys_host, out, max(1024, _REF_GATHER_BYTES // max(4 * width * k, 1)),
        lambda sl: _gathered_products(
            w[sl].reshape(-1, 1, k), gathers, sl, combine, (k,)
        ).reshape(sl.stop - sl.start, width * k),
        reduce, merge,
    )


class _KernelChannelEngine(_CsrHopMixin, ChannelTensorEngine):
    """k-channel contraction whose hops run on ``coo_spmm`` (single child,
    channel-uniform weights) or ``segment_sum`` (everything else), or each
    on one ``fused_hop`` launch when ``fused``."""

    def __init__(
        self, *args, view_cache: dict | None = None, fused: bool = False, **kwargs
    ):
        super().__init__(*args, **kwargs)
        self.view_cache = {} if view_cache is None else view_cache
        self.fused = fused

    def _weights(self, rel: str, view: DeviceView):
        """``((n, k) weights, uniform)``; ``uniform`` (every channel
        weighs an edge alike) is decided once per view on the host."""
        key = ("channels", self.channel_measures)
        if key not in view.memo:
            w = self._host_weights(rel).astype(np.float32)
            uniform = self.k == 1 or bool((w == w[:, :1]).all())
            view.memo[key] = (view.upload(w), uniform)
        return view.memo[key]

    def _contract_block(self, weights, gathers, view, knum):
        w, uniform = weights
        return contract_hop(
            view.keys, view.keys_host, w, gathers, knum, "sum", self.fused, uniform
        )


# MIN/MAX walk payload ranks while they stay exact in float32
_MAX_EXACT_RANKS = 1 << 24


class _MinMaxKernelEngine(_CsrHopMixin, TensorEngine):
    """(min, +) / (max, +) semiring message passing over the tree: the
    measure relation contributes its per-edge payload rank (its position
    in ``values``, the sorted distinct payloads; or, with ``values``
    None, the payload itself in float32), every other relation
    contributes 0, and each hop reduces the per-edge candidate sums into
    their row keys with ``segment_reduce`` (or forms and reduces them in
    one ``fused_hop`` launch when ``fused``).  Unreached entries hold the
    identity (±inf) until :meth:`SparseProgram.run_minmax` masks them."""

    def __init__(
        self, prep, kind: str, rel_m: str, device, *,
        values: np.ndarray | None = None,
        domains=None, encoded=None, view_cache: dict | None = None,
        fused: bool = False,
    ):
        super().__init__(prep, device, domains=domains, encoded=encoded)
        self.kind = kind
        self.rel_m = rel_m
        self.values = values
        self.view_cache = {} if view_cache is None else view_cache
        self.fused = fused

    def _weights(self, rel: str, view: DeviceView) -> torch.Tensor:
        er = self.encoded[rel]
        if rel != self.rel_m:
            return torch.zeros(er.num_rows, dtype=torch.float32, device=self.device)
        key = ("payload", self.kind, self.values is None)
        if key not in view.memo:
            payload = er.payloads[self.kind]
            if self.values is not None:
                payload = np.searchsorted(self.values, payload)
            view.memo[key] = view.upload(payload)
        return view.memo[key]

    def _contract_block(self, weights, gathers, view, knum):
        return contract_hop(
            view.keys, view.keys_host, weights.reshape(-1, 1), gathers, knum,
            self.kind, self.fused,
        )


@dataclass
class SparseProgram:
    """A sparse execution of one ``Prepared`` on ``device``.

    ``channel_measures`` entry ``c`` names the relation whose ``sum``
    payload rides channel ``c`` (None = COUNT).  Grouped-CSR views are
    memoized on the ``Prepared`` (host and device), so repeated runs and
    stream tiles reuse the sorted, uploaded edge blocks.  ``fused``
    (True/False pins it, None follows ``REPRO_FUSED``, read once per
    pass) runs every hop on ``fused_hop``.
    """

    prep: Prepared
    channel_measures: tuple[str | None, ...]
    device: torch.device
    fused: bool | None = None

    @property
    def k(self) -> int:
        return len(self.channel_measures)

    def run_channels(
        self, encoded=None, domains=None, view_cache: dict | None = None
    ) -> torch.Tensor:
        """One leaves→root kernel pass; ``(*group_dims, k)`` float32 on
        the device."""
        eng = _KernelChannelEngine(
            self.prep, self.channel_measures, self.device,
            domains=domains, encoded=encoded, view_cache=view_cache,
            fused=fused_enabled(self.fused),
        )
        return eng.run()

    def _payload_values(self, kind: str, rel_m: str):
        """Sorted distinct ``kind`` payloads of ``rel_m`` (host, and as
        float64 on the device), memoized on the ``Prepared``; None when
        there are too many for their ranks to stay exact in float32."""
        key = (str(self.device), rel_m, kind)
        memo = self.prep.payload_values
        if key not in memo:
            host = np.unique(self.prep.encoded[rel_m].payloads[kind])
            memo[key] = (
                (host, torch.from_numpy(host).to(self.device))
                if len(host) <= _MAX_EXACT_RANKS else None
            )
        return memo[key]

    def run_minmax(
        self, kind: str, rel_m: str, encoded=None, domains=None,
        view_cache: dict | None = None,
    ) -> torch.Tensor:
        """MIN/MAX(rel_m) over canonical group axes on the device, float64;
        unreached groups hold 0.0 — mask with a COUNT support before use.

        The walk runs on payload ranks, which float32 holds exactly, and
        the reached ranks map back to the float64 payloads here, so
        fractional measures come back unrounded (a min or max is one of
        the payloads, and ranks order as the payloads do)."""
        values = self._payload_values(kind, rel_m)
        eng = _MinMaxKernelEngine(
            self.prep, kind, rel_m, self.device,
            values=None if values is None else values[0],
            domains=domains, encoded=encoded, view_cache=view_cache,
            fused=fused_enabled(self.fused),
        )
        arr = eng.run()
        reached = torch.isfinite(arr)
        out = torch.where(reached, arr, torch.zeros_like(arr))
        if values is None or not len(values[0]):  # no payloads: none reached
            return out.to(torch.float64)
        return torch.where(reached, values[1][out.long()], 0.0)

    def run_stream(self, attr: str, tile: int):
        """Yield ``(encoded, domains, offsets)`` per group-axis row tile;
        relations are sliced through their grouped-CSR views, re-based to
        the tile-local code range."""
        total = self.prep.dicts[attr].size
        for lo in range(0, total, tile):
            hi = min(lo + tile, total)
            enc = csr_restrict(self.prep, attr, lo, hi)
            domains = {a: self.prep.dicts[a].size for a in self.prep.dicts}
            domains[attr] = hi - lo
            yield enc, domains, {attr: lo}


def build_sparse_program(
    prep: Prepared,
    channel_measures: tuple[str | None, ...],
    device,
    fused: bool | None = None,
) -> SparseProgram:
    """Bind ``Prepared`` + channel spec + device (+ the fused-hop option)
    into a :class:`SparseProgram`."""
    return SparseProgram(prep, tuple(channel_measures), torch.device(device), fused)
