"""Segment sum over sorted ids: the Hopper port of the TPU kernel
``repro/kernels/segment_sum.py:segment_sum``.

The CUDA source is ``csrc/segment_sum.cu``; ``ref.segment_sum`` is its
plain version.  The sparse engine sends leaf, multi-child and
measure-weighted hops here (the per-edge products are formed beforehand
by plain tensor code).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ops, ref

_ARGTYPES = (
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
)


def segment_sum(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """``out[s] = Σ data[r]`` over rows with ``segment_ids[r] == s``, for
    ``data (n, d)`` float32 into ``(num_segments, d)`` float32; ids
    outside ``[0, num_segments)`` are dropped.  ``out``, when given, is
    written in full and returned.

    On CUDA tensors the kernel requires: ``segment_ids`` int64 and
    ascending (grouped-CSR order — not checked here), all tensors
    contiguous on one card.  CPU tensors run :func:`ref.segment_sum`.
    """
    device = ops.device_of(data, segment_ids, out)
    if device.type == "cpu":
        res = ref.segment_sum(data, segment_ids, num_segments)
        return res if out is None else out.copy_(res)
    if device.type != "cuda":
        raise ValueError(f"segment_sum: unsupported device {device}")
    ops.require("segment_sum", "data", data, torch.float32, 2)
    ops.require("segment_sum", "segment_ids", segment_ids, torch.int64, 1)
    n, d = data.shape
    if segment_ids.shape[0] != n:
        raise ValueError(f"segment_sum: {segment_ids.shape[0]} ids for {n} rows")
    ops.check_width("segment_sum", d)
    out = ops.output("segment_sum", out, (num_segments, d), data)
    if num_segments == 0 or d == 0:
        return out
    fn = ops.load("segment_sum", "repro_segment_sum", _ARGTYPES)
    rc = fn(
        device.index, data.data_ptr(), segment_ids.data_ptr(), n, d,
        num_segments, out.data_ptr(), ops.stream_of(device),
    )
    ops.check_launch("segment_sum", rc)
    return out
