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
  ``segment_reduce``.

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
    view: DeviceView, out: torch.Tensor, chunk: int, edge_values, reduce, combine
) -> torch.Tensor:
    """Fill ``out`` (one row per key) chunk by chunk: for each key range
    of :func:`key_chunks`, form the chunk's per-edge values
    (``edge_values(edge slice)``) and let the kernel (``reduce(values,
    ids, num_keys, out=rows)``) write the range's rows; a run split
    across two chunks combines its two partials with ``combine``."""
    chunks = key_chunks(view.keys_host, out.shape[0], chunk)
    for e_lo, e_hi, k_lo, k_hi, shared in chunks:
        sl = slice(e_lo, e_hi)
        dst = out[k_lo:k_hi]
        carry = dst[0].clone() if shared else None
        reduce(edge_values(sl), view.keys[sl] - k_lo, k_hi - k_lo, out=dst)
        if carry is not None:
            dst[0] = combine(dst[0], carry)
    return out


class _KernelChannelEngine(_CsrHopMixin, ChannelTensorEngine):
    """k-channel contraction whose hops run on ``coo_spmm`` (single child,
    channel-uniform weights) or ``segment_sum`` (everything else)."""

    def __init__(self, *args, view_cache: dict | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.view_cache = {} if view_cache is None else view_cache

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
        k = self.k
        if len(gathers) == 1 and uniform:
            m2, idx = gathers[0]  # m2 (rows, width, k)
            rows, width = m2.shape[0], m2.shape[1]
            out = coo_spmm(
                view.keys, idx, w[:, 0].contiguous(),
                m2.reshape(rows, width * k), knum,
            )
            return out.view(knum, width, k)
        width = math.prod(m2.shape[1] for m2, _ in gathers)
        out = torch.empty((knum, width * k), dtype=torch.float32, device=self.device)
        _reduce_in_chunks(
            view, out, max(1024, _REF_GATHER_BYTES // max(4 * width * k, 1)),
            lambda sl: _gathered_products(
                w[sl].reshape(-1, 1, k), gathers, sl, torch.mul, (k,)
            ).reshape(sl.stop - sl.start, width * k),
            segment_sum, torch.add,
        )
        return out.view(knum, width, k)


class _MinMaxKernelEngine(_CsrHopMixin, TensorEngine):
    """(min, +) / (max, +) semiring message passing over the tree: the
    measure relation contributes its per-edge payload, every other
    relation contributes 0, and each hop reduces the per-edge candidate
    sums into their row keys with ``segment_reduce``.  Unreached entries
    hold the identity (±inf) until :meth:`SparseProgram.run_minmax`
    masks them."""

    def __init__(
        self, prep, kind: str, rel_m: str, device, *,
        domains=None, encoded=None, view_cache: dict | None = None,
    ):
        super().__init__(prep, device, domains=domains, encoded=encoded)
        self.kind = kind
        self.rel_m = rel_m
        self.view_cache = {} if view_cache is None else view_cache

    def _weights(self, rel: str, view: DeviceView) -> torch.Tensor:
        er = self.encoded[rel]
        if rel != self.rel_m:
            return torch.zeros(er.num_rows, dtype=torch.float32, device=self.device)
        key = ("payload", self.kind)
        if key not in view.memo:
            view.memo[key] = view.upload(er.payloads[self.kind])
        return view.memo[key]

    def _contract_block(self, weights, gathers, view, knum):
        width = math.prod(m2.shape[1] for m2, _ in gathers)
        out = torch.empty((knum, width), dtype=torch.float32, device=self.device)
        return _reduce_in_chunks(
            view, out, max(1024, _REF_GATHER_BYTES // max(4 * width, 1)),
            lambda sl: _gathered_products(
                weights[sl].reshape(-1, 1), gathers, sl, torch.add, ()
            ),
            functools.partial(segment_reduce, kind=self.kind),
            torch.minimum if self.kind == "min" else torch.maximum,
        )


@dataclass
class SparseProgram:
    """A sparse execution of one ``Prepared`` on ``device``.

    ``channel_measures`` entry ``c`` names the relation whose ``sum``
    payload rides channel ``c`` (None = COUNT).  Grouped-CSR views are
    memoized on the ``Prepared`` (host and device), so repeated runs and
    stream tiles reuse the sorted, uploaded edge blocks.
    """

    prep: Prepared
    channel_measures: tuple[str | None, ...]
    device: torch.device

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
        )
        return eng.run()

    def run_minmax(
        self, kind: str, rel_m: str, encoded=None, domains=None,
        view_cache: dict | None = None,
    ) -> torch.Tensor:
        """MIN/MAX(rel_m) over canonical group axes on the device;
        unreached groups hold 0.0 — mask with a COUNT support before use."""
        eng = _MinMaxKernelEngine(
            self.prep, kind, rel_m, self.device,
            domains=domains, encoded=encoded, view_cache=view_cache,
        )
        arr = eng.run()
        return torch.where(torch.isfinite(arr), arr, torch.zeros_like(arr))

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
    prep: Prepared, channel_measures: tuple[str | None, ...], device
) -> SparseProgram:
    """Bind ``Prepared`` + channel spec + device into a :class:`SparseProgram`."""
    return SparseProgram(prep, tuple(channel_measures), torch.device(device))
