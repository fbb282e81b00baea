"""Kernel-backed delta contraction on the card (DESIGN.md §4).

Port of the JAX package's ``incremental/jax_delta.py``.
:class:`KernelDeltaEngine` is the port's k = 1 kernel channel engine
(``core/torch_engine.py:_KernelChannelEngine``) contracting arbitrary
row blocks — a delta, or the parent rows matched to a delta message —
through the same unfused hop as a full pass
(``core/torch_engine.py:contract_hop``), so its routing is the
reference's:

* one child message → ``coo_spmm``: ``out[key[i]] += w[i] * M[idx[i]]``
  with the block's rows as the COO entries and the cached (or delta)
  child message as the dense operand;
* zero or several children → the per-row products of the gathered child
  rows, reduced with ``segment_sum``.

Every block reaches the kernels in grouped-CSR order, the kernels'
unchecked precondition: a delta block is sorted once, stably, by its
raveled hop key (:meth:`KernelDeltaEngine.delta_block`); an ancestor's
rescan takes its rows from the device view of the full pass, already in
that order, under a boolean mask, which keeps it
(:meth:`KernelDeltaEngine.masked_block`).  Two parts of the reference
are left out: the ``EDGE_BUCKET`` padding with key -1 (it bounds JAX's
retracing, and here it would put -1 after ascending keys) and the numpy
fallback for ``≥ 2**31`` segments (the kernels index in int64).  Nothing
on this path falls back to the CPU: the blocks, weights and messages
live on the engine's device, where the kernel wrappers launch or raise.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.prepare import Prepared, _ravel
from repro_torch.core.torch_engine import DeviceView, _KernelChannelEngine


class KernelDeltaEngine(_KernelChannelEngine):
    """One channel (COUNT, or SUM over ``measure_rel``'s payload) whose
    hops contract row blocks on ``coo_spmm`` / ``segment_sum``; never
    fused (the reference's maintenance never fuses)."""

    def __init__(self, prep: Prepared, measure_rel: str | None, device):
        super().__init__(prep, (measure_rel,), device, fused=False)

    def hop_view(self, rel: str, parent: str | None) -> DeviceView:
        """``rel``'s device view keyed on its hop key (memoized on the
        ``Prepared`` as the full pass's)."""
        return self._view(rel, self._hop_key_attrs(rel, parent))

    def delta_block(
        self, rel: str, parent: str | None, codes: np.ndarray, weights: np.ndarray
    ) -> tuple[DeviceView, tuple[torch.Tensor, bool]]:
        """A delta's rows (``codes`` in ``rel``'s attr layout, signed
        ``weights``) on the device in grouped-CSR order of the hop key,
        with their ``(n, 1)`` float32 weights."""
        key_attrs = self._hop_key_attrs(rel, parent)
        cols = [self.encoded[rel].attrs.index(a) for a in key_attrs]
        keys = _ravel(codes, cols, list(self._dims(key_attrs)))
        order = np.argsort(keys, kind="stable")
        keys = keys[order]
        w = np.ascontiguousarray(
            np.asarray(weights, np.float64)[order], dtype=np.float32
        ).reshape(-1, 1)
        block = DeviceView(
            key_attrs,
            torch.from_numpy(keys).to(self.device),
            keys,
            torch.from_numpy(np.ascontiguousarray(codes[order], np.int64)).to(self.device),
            order,
        )
        return block, (torch.from_numpy(w).to(self.device), True)

    def masked_block(
        self, view: DeviceView, weights, mask: torch.Tensor, mask_host: np.ndarray
    ) -> tuple[DeviceView, tuple[torch.Tensor, bool]]:
        """The rows of ``view`` where ``mask`` holds (the same mask on the
        device and on the host), in the view's order, with their
        weights."""
        w, uniform = weights
        block = DeviceView(
            view.attrs, view.keys[mask], view.keys_host[mask_host],
            view.codes[mask], view.order[mask_host],
        )
        return block, (w[mask], uniform)
