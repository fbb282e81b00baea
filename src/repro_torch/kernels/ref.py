"""Plain PyTorch versions of the three on-path kernels.

Each computes the same function as its hand-written CUDA kernel and is
what the kernel wrappers run on CPU tensors; ``chip_smoke.py`` holds each
kernel against these on the card.  Ids outside ``[0, num_segments)``
are dropped (``repro/kernels/segment_sum.py:58``,
``repro/kernels/segment_reduce.py:87``); empty MIN/MAX segments hold
``+inf``/``-inf``.  Unlike the kernels, these take ids in any order.
"""
from __future__ import annotations

import torch


def segment_sum(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """out[s] = sum of ``data`` rows with ``segment_ids == s``."""
    keep = (segment_ids >= 0) & (segment_ids < num_segments)
    out = data.new_zeros((num_segments, data.shape[1]))
    return out.index_add_(0, segment_ids[keep], data[keep])


def segment_reduce(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int, kind: str
) -> torch.Tensor:
    """out[s] = min/max of ``data`` rows with ``segment_ids == s``
    (the identity ``+inf``/``-inf`` where no row maps)."""
    if kind not in ("min", "max"):
        raise ValueError(f"unknown reduction {kind!r}")
    ident = float("inf") if kind == "min" else float("-inf")
    keep = (segment_ids >= 0) & (segment_ids < num_segments)
    rows = data[keep]
    out = data.new_full((num_segments, data.shape[1]), ident)
    index = segment_ids[keep][:, None].expand_as(rows)
    return out.scatter_reduce_(
        0, index, rows, "amin" if kind == "min" else "amax", include_self=True
    )


def coo_spmm(
    rows: torch.Tensor,
    cols: torch.Tensor,
    vals: torch.Tensor,
    dense: torch.Tensor,
    num_rows: int,
) -> torch.Tensor:
    """out[rows[i]] += vals[i] * dense[cols[i]], dropping edges whose row
    or column is out of range."""
    keep = (
        (rows >= 0) & (rows < num_rows) & (cols >= 0) & (cols < dense.shape[0])
    )
    gathered = dense[cols[keep]] * vals[keep][:, None]
    out = dense.new_zeros((num_rows, dense.shape[1]))
    return out.index_add_(0, rows[keep], gathered)
