"""Segment MIN/MAX over sorted ids: the Hopper port of the TPU kernel
``repro/kernels/segment_reduce.py:segment_reduce``.

The CUDA source is ``csrc/segment_reduce.cu``; ``ref.segment_reduce`` is
its plain version.  The sparse engine sends every MIN/MAX hop here.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ops, ref

_ARGTYPES = (
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_void_p,
)
_KINDS = {"min": 0, "max": 1}


def segment_reduce(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    kind: str = "min",
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-segment min or max of ``data (n, d)`` float32 into
    ``(num_segments, d)`` float32; segments no row maps to hold ``+inf``
    (min) or ``-inf`` (max), and ids outside ``[0, num_segments)`` are
    dropped.  ``out``, when given, is written in full and returned.

    On CUDA tensors the kernel requires: ``segment_ids`` int64 and
    ascending (grouped-CSR order — not checked here), NaN-free ``data``,
    all tensors contiguous on one card.  CPU tensors run
    :func:`ref.segment_reduce`.
    """
    if kind not in _KINDS:
        raise ValueError(f"unknown reduction {kind!r}")
    device = ops.device_of(data, segment_ids, out)
    if device.type == "cpu":
        res = ref.segment_reduce(data, segment_ids, num_segments, kind)
        return res if out is None else out.copy_(res)
    if device.type != "cuda":
        raise ValueError(f"segment_reduce: unsupported device {device}")
    ops.require("segment_reduce", "data", data, torch.float32, 2)
    ops.require("segment_reduce", "segment_ids", segment_ids, torch.int64, 1)
    n, d = data.shape
    if segment_ids.shape[0] != n:
        raise ValueError(f"segment_reduce: {segment_ids.shape[0]} ids for {n} rows")
    ops.check_width("segment_reduce", d)
    out = ops.output("segment_reduce", out, (num_segments, d), data)
    if num_segments == 0 or d == 0:
        return out
    fn = ops.load("segment_reduce", "repro_segment_reduce", _ARGTYPES)
    rc = fn(
        device.index, data.data_ptr(), segment_ids.data_ptr(), n, d,
        num_segments, _KINDS[kind], out.data_ptr(), ops.stream_of(device),
    )
    ops.check_launch("segment_reduce", rc)
    return out
