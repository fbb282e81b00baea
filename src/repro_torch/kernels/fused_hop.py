"""One whole JOIN-AGG hop in one launch: the Hopper port of the TPU
kernel ``repro/kernels/fused_hop.py:fused_hop``.

The CUDA source is ``csrc/fused_hop.cu``; ``ref.fused_hop`` is its plain
version.  Hops with one child and rows of 32 floats or more run the
slab-major warp walk (``csrc/gathered_rows.cuh``, launch shape
:func:`ops.gather_plan`), the others the sorted-run tile walk
(:func:`ops.walk_plan`).  Under ``.fused(True)`` (or ``REPRO_FUSED``)
the sparse engine sends every hop here — sum hops with any children and
weights, and MIN/MAX hops — in place of the gather, product and
``segment_sum`` / ``coo_spmm`` / ``segment_reduce`` launches of the
three-dispatch path.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import ops, ref

#: children a hop may have: the kernel carries them by value in its
#: launch parameter (``csrc/fused_hop.cu``)
MAX_CHILDREN = 64
_KINDS = {"sum": 0, "min": 1, "max": 2}


class _Child(ctypes.Structure):
    """``ReproFusedChild`` of ``csrc/fused_hop.cu``."""

    _fields_ = [
        ("msg", ctypes.c_void_p),
        ("idx", ctypes.c_void_p),
        ("rows", ctypes.c_int64),
        ("width", ctypes.c_int64),
    ]


_ARGTYPES = (
    ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
    ctypes.c_int64, ctypes.POINTER(_Child), ctypes.c_int, ctypes.c_int64,
    ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ops.WalkPlan), ctypes.c_void_p,
)
_ONE_CHILD_ARGTYPES = (
    ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
    ctypes.c_int64, ctypes.POINTER(_Child), ctypes.c_int64, ctypes.c_int,
    ctypes.c_void_p, ctypes.POINTER(ops.GatherPlan), ctypes.c_void_p,
)


def gathers_one_child(nchild: int, d: int) -> bool:
    """Whether a hop with ``nchild`` children into rows of ``d`` floats
    runs the slab-major warp walk (``csrc/gathered_rows.cuh``) rather than
    the sorted-run tile walk."""
    return nchild == 1 and d >= ops.NARROW_WIDTH


def fused_hop(
    keys: torch.Tensor,
    weights: torch.Tensor,
    msgs,
    idxs,
    num_segments: int,
    k: int = 1,
    kind: str = "sum",
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """One hop: ``keys (n,)`` output row per edge, ``weights (n, k)``
    float32, per child ``msgs[i] (rows_i, width_i·k)`` float32 (width-
    major, channel-minor) and ``idxs[i] (n,)`` its row per edge; returns
    ``(num_segments, Π width_i · k)`` float32.  ``sum`` reduces
    ``w[e, c] · Π_i msg_i[idx_i[e], col_i·k + c]``; ``min``/``max``
    (``k = 1``) reduce ``w[e] + Σ_i msg_i[idx_i[e], col_i]``; the output
    column's child columns ``col_i`` run row-major over the widths, last
    child fastest.  Rows no edge reaches hold 0 or ±inf; edges whose key
    or any child index is out of range are dropped.  ``out``, when given,
    is written in full and returned.

    Every call requires: ``keys`` and ``idxs`` int64, float32 weights and
    messages, at most :data:`MAX_CHILDREN` children, all tensors
    contiguous on one device.  On CUDA tensors the kernel also requires
    ``keys`` ascending (grouped-CSR order — not checked here) and
    NaN-free MIN/MAX inputs; CPU tensors run :func:`ref.fused_hop`.
    """
    if kind not in _KINDS:
        raise ValueError(f"unknown hop kind {kind!r}")
    if k < 1 or (kind != "sum" and k != 1):
        raise ValueError(f"fused_hop: k={k}; sum hops take k >= 1, min/max k = 1")
    msgs, idxs = tuple(msgs), tuple(idxs)
    if len(msgs) != len(idxs):
        raise ValueError(f"fused_hop: {len(msgs)} child messages, {len(idxs)} indices")
    if len(msgs) > MAX_CHILDREN:
        raise ValueError(
            f"fused_hop: {len(msgs)} children exceed the kernel's limit of "
            f"{MAX_CHILDREN} (MAX_CHILDREN)"
        )
    ops.require("fused_hop", "keys", keys, torch.int64, 1)
    ops.require("fused_hop", "weights", weights, torch.float32, 2)
    n = keys.shape[0]
    if tuple(weights.shape) != (n, k):
        raise ValueError(f"fused_hop: weights {tuple(weights.shape)} for {n} edges, k={k}")
    widths = []
    for i, (msg, idx) in enumerate(zip(msgs, idxs)):
        ops.require("fused_hop", f"msgs[{i}]", msg, torch.float32, 2)
        ops.require("fused_hop", f"idxs[{i}]", idx, torch.int64, 1)
        if idx.shape[0] != n or msg.shape[1] % k:
            raise ValueError(
                f"fused_hop: child {i}: {idx.shape[0]} indices for {n} edges, "
                f"message width {msg.shape[1]} for k={k}"
            )
        widths.append(msg.shape[1] // k)
    width = math.prod(widths)
    ops.check_width("fused_hop", width * k)
    device = ops.device_of(keys, weights, *msgs, *idxs, out)
    if device.type == "cpu":
        res = ref.fused_hop(keys, weights, msgs, idxs, num_segments, k, kind)
        return res if out is None else out.copy_(res)
    if device.type != "cuda":
        raise ValueError(f"fused_hop: unsupported device {device}")
    out = ops.output("fused_hop", out, (num_segments, width * k), weights)
    if num_segments == 0 or width == 0:
        return out
    children = (_Child * max(len(msgs), 1))(*(
        _Child(msg.data_ptr(), idx.data_ptr(), msg.shape[0], w)
        for msg, idx, w in zip(msgs, idxs, widths)
    ))
    if gathers_one_child(len(msgs), width * k):
        plan = ops.gather_plan(n, num_segments, width * k)
        fn = ops.load("fused_hop", "repro_fused_hop_one_child", _ONE_CHILD_ARGTYPES)
        rc = fn(
            device.index, keys.data_ptr(), n, weights.data_ptr(), k, children,
            num_segments, _KINDS[kind], out.data_ptr(), ctypes.byref(plan),
            ops.stream_of(device),
        )
    else:
        plan = ops.walk_plan(n, num_segments, width * k)
        fn = ops.load("fused_hop", "repro_fused_hop", _ARGTYPES)
        rc = fn(
            device.index, keys.data_ptr(), n, weights.data_ptr(), k, children,
            len(msgs), num_segments, _KINDS[kind], out.data_ptr(), ctypes.byref(plan),
            ops.stream_of(device),
        )
    ops.check_launch("fused_hop", rc)
    return out
