"""COO sparse × dense product over sorted rows: the Hopper port of the
TPU kernel ``repro/kernels/coo_spmm.py:coo_spmm``.

The CUDA source is ``csrc/coo_spmm.cu``; ``ref.coo_spmm`` is its plain
version.  The sparse engine sends single-child hops with channel-uniform
weights here, the child message as the dense operand with its ``k``
channels riding the columns (``(rows, width·k)``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ops, ref

_ARGTYPES = (
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
    ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
)


def coo_spmm(
    rows: torch.Tensor,
    cols: torch.Tensor,
    vals: torch.Tensor,
    dense: torch.Tensor,
    num_rows: int,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """``out[rows[i]] += vals[i] · dense[cols[i]]`` for ``rows``/``cols``
    ``(nnz,)``, ``vals (nnz,)`` float32 and ``dense (K, width)`` float32,
    into ``(num_rows, width)`` float32.  Edges whose row lies outside
    ``[0, num_rows)`` or whose column lies outside ``[0, K)`` are
    dropped.  ``out``, when given, is written in full and returned.

    On CUDA tensors the kernel requires: ``rows`` and ``cols`` int64 with
    ``rows`` ascending (grouped-CSR order — not checked here), all
    tensors contiguous on one card.  CPU tensors run :func:`ref.coo_spmm`.
    """
    device = ops.device_of(rows, cols, vals, dense, out)
    if device.type == "cpu":
        res = ref.coo_spmm(rows, cols, vals, dense, num_rows)
        return res if out is None else out.copy_(res)
    if device.type != "cuda":
        raise ValueError(f"coo_spmm: unsupported device {device}")
    ops.require("coo_spmm", "rows", rows, torch.int64, 1)
    ops.require("coo_spmm", "cols", cols, torch.int64, 1)
    ops.require("coo_spmm", "vals", vals, torch.float32, 1)
    ops.require("coo_spmm", "dense", dense, torch.float32, 2)
    nnz = rows.shape[0]
    if cols.shape[0] != nnz or vals.shape[0] != nnz:
        raise ValueError(
            f"coo_spmm: rows/cols/vals lengths {nnz}/{cols.shape[0]}/{vals.shape[0]}"
        )
    k, width = dense.shape
    ops.check_width("coo_spmm", width)
    out = ops.output("coo_spmm", out, (num_rows, width), dense)
    if num_rows == 0 or width == 0:
        return out
    fn = ops.load("coo_spmm", "repro_coo_spmm", _ARGTYPES)
    rc = fn(
        device.index, rows.data_ptr(), cols.data_ptr(), vals.data_ptr(), nnz,
        dense.data_ptr(), k, width, num_rows, out.data_ptr(),
        ops.stream_of(device),
    )
    ops.check_launch("coo_spmm", rc)
    return out
