"""Plain PyTorch versions of the five kernels.

Each computes the same function as its hand-written CUDA kernel and is
what the kernel wrappers run on CPU tensors; ``chip_smoke.py`` holds each
kernel against these on the card.  Ids outside ``[0, num_segments)``
are dropped (``repro/kernels/segment_sum.py:58``,
``repro/kernels/segment_reduce.py:87``); empty MIN/MAX segments hold
``+inf``/``-inf``.  Unlike the kernels, these take ids in any order.
"""
from __future__ import annotations

import math

import torch

_SEMIRING_IDENTITY = {
    "add_mul": 0.0, "max_add": -math.inf, "min_add": math.inf, "or_and": 0.0,
}


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


def fused_hop(
    keys: torch.Tensor,
    weights: torch.Tensor,
    msgs,
    idxs,
    num_segments: int,
    k: int = 1,
    kind: str = "sum",
) -> torch.Tensor:
    """One hop as three steps: gather each child's rows, form the
    channel-diagonal product (``sum``) or sum (``min``/``max``) with the
    edge weight in child order, then reduce into the keys' rows — what
    ``repro/kernels/fused_hop.py:fused_hop`` computes.  ``weights`` is
    ``(n, k)``, ``msgs[i]`` ``(rows_i, width_i·k)``, ``idxs[i]`` ``(n,)``;
    returns ``(num_segments, Π width_i · k)``.  Edges whose key or any
    child index is out of range are dropped."""
    if kind not in ("sum", "min", "max"):
        raise ValueError(f"unknown hop kind {kind!r}")
    keep = (keys >= 0) & (keys < num_segments)
    for msg, idx in zip(msgs, idxs):
        keep &= (idx >= 0) & (idx < msg.shape[0])
    vals = weights[keep].reshape(-1, 1, k)
    combine = torch.mul if kind == "sum" else torch.add
    width = 1
    for msg, idx in zip(msgs, idxs):
        wc = msg.shape[1] // k
        rows = msg.reshape(msg.shape[0], wc, k)[idx[keep]]  # (c, wc, k)
        vals = combine(vals.unsqueeze(2), rows.unsqueeze(1))
        width *= wc
        vals = vals.reshape(vals.shape[0], width, k)
    flat = vals.reshape(vals.shape[0], width * k)
    if kind == "sum":
        return segment_sum(flat, keys[keep], num_segments)
    return segment_reduce(flat, keys[keep], num_segments, kind)


def semiring_matmul(
    a: torch.Tensor, b: torch.Tensor, semiring: str = "add_mul"
) -> torch.Tensor:
    """``C[i, j] = ⊕_k a[i, k] ⊗ b[k, j]`` over ``add_mul``, ``max_add``,
    ``min_add`` or ``or_and`` (``any(a > 0 & b > 0)`` as 0/1), as
    ``repro/kernels/ref.py:semiring_matmul_ref``.  One step per ``k`` in
    ascending order, each rounded on its own, as the kernel reduces, so
    the two agree bit for bit on any data; an empty ``k`` gives the
    identity (0, -inf, +inf, 0)."""
    if semiring not in _SEMIRING_IDENTITY:
        raise ValueError(f"unknown semiring {semiring!r}")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"semiring_matmul: shapes {tuple(a.shape)} x {tuple(b.shape)}")
    out = a.new_full((a.shape[0], b.shape[1]), _SEMIRING_IDENTITY[semiring])
    for i in range(a.shape[1]):
        x, y = a[:, i : i + 1], b[i : i + 1, :]
        if semiring == "add_mul":
            out = out + x * y
        elif semiring == "max_add":
            out = torch.maximum(out, x + y)
        elif semiring == "min_add":
            out = torch.minimum(out, x + y)
        else:
            out = torch.where((x > 0) & (y > 0), 1.0, out)
    return out
