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
    ascending order, as the kernel reduces: ``add_mul``'s step is one
    fused multiply-add (:func:`fma`), the others an add then a NaN-
    propagating max or min, so the two agree bit for bit on any data; an
    empty ``k`` gives the identity (0, -inf, +inf, 0)."""
    if semiring not in _SEMIRING_IDENTITY:
        raise ValueError(f"unknown semiring {semiring!r}")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"semiring_matmul: shapes {tuple(a.shape)} x {tuple(b.shape)}")
    out = a.new_full((a.shape[0], b.shape[1]), _SEMIRING_IDENTITY[semiring])
    for i in range(a.shape[1]):
        x, y = a[:, i : i + 1], b[i : i + 1, :]
        if semiring == "add_mul":
            out = fma(x, y, out)
        elif semiring == "max_add":
            out = torch.maximum(out, x + y)
        elif semiring == "min_add":
            out = torch.minimum(out, x + y)
        else:
            out = torch.where((x > 0) & (y > 0), 1.0, out)
    return out


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of float32 tensors (broadcast) rounded once, as the
    card's fused multiply-add ``__fmaf_rn`` and libm's ``fmaf`` round it.

    In float64 the product is exact (24 + 24 significand bits) and TwoSum
    gives the sum's rounding error ``e`` exactly; rounding the sum to odd
    (one step toward ``e`` where ``e != 0`` and its last bit is even) and
    then to nearest float32 is correctly rounded, since 53 >= 24 + 2."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    z = s - p
    e = (p - (s - z)) + (c - z)
    to_odd = (e != 0) & ((s.view(torch.int64) & 1) == 0) & torch.isfinite(s)
    toward = torch.copysign(torch.tensor(math.inf, dtype=torch.float64, device=s.device), e)
    return torch.where(to_odd, torch.nextafter(s, toward), s).float()


def pack_positive(x: torch.Tensor, words: int) -> torch.Tensor:
    """``(rows, words)`` int32 whose word ``w`` of row ``r`` has bit ``t``
    set where ``x[r, 32 w + t] > 0`` (NaN, -0.0 and -inf count as not
    positive; bits past ``x``'s columns are 0): the packing that
    ``semiring_matmul``'s ``or_and`` pre-pass kernels write, A as
    ``pack_positive(a, k_steps)`` and B as ``pack_positive(b.T, k_steps).T``
    in ``ldb`` columns."""
    rows, kd = x.shape
    if words * 32 < kd:
        raise ValueError(f"{words} words hold fewer than the {kd} values of a row")
    bits = torch.zeros((rows, words * 32), dtype=torch.int64, device=x.device)
    bits[:, :kd] = (x > 0).long()
    shifts = torch.arange(32, device=x.device)
    packed = (bits.view(rows, words, 32) << shifts).sum(dim=2)
    return torch.where(packed >= 2**31, packed - 2**32, packed).to(torch.int32)
