"""Blocked matrix product over a semiring: the Hopper port of the TPU
kernel ``repro/kernels/semiring_matmul.py:semiring_matmul``.

The CUDA source is ``csrc/semiring_matmul.cu``; ``ref.semiring_matmul``
is its plain version.  No engine calls it, in the JAX package either:
``chip_smoke.py`` holds it against its plain version on the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ops, ref

SEMIRINGS = {"add_mul": 0, "max_add": 1, "min_add": 2, "or_and": 3}
_ARGTYPES = (
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
    ctypes.POINTER(ops.MatmulPlan), ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p,
)


def semiring_matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    semiring: str = "add_mul",
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """``C[i, j] = ⊕_k a[i, k] ⊗ b[k, j]`` for ``a (m, kd)`` and ``b (kd,
    n)`` float32 into ``(m, n)`` float32, over ``add_mul``, ``max_add``,
    ``min_add`` or ``or_and``; reduced over ``k`` in ascending order, one
    step per ``k`` (``add_mul``: one fused multiply-add).  ``out``, when
    given, is written in full and returned.  The launch shape is
    :func:`ops.matmul_plan`'s; ``or_and`` packs ``a > 0`` and ``b > 0``
    into 32-bit words in scratch the wrapper allocates.

    Every call requires contiguous 2-d float32 tensors on one device;
    CPU tensors run :func:`ref.semiring_matmul`.
    """
    if semiring not in SEMIRINGS:
        raise ValueError(f"unknown semiring {semiring!r}")
    ops.require("semiring_matmul", "a", a, torch.float32, 2)
    ops.require("semiring_matmul", "b", b, torch.float32, 2)
    (m, kd), (kd2, n) = a.shape, b.shape
    if kd != kd2:
        raise ValueError(f"semiring_matmul: shapes {(m, kd)} x {(kd2, n)}")
    device = ops.device_of(a, b, out)
    if device.type == "cpu":
        res = ref.semiring_matmul(a, b, semiring)
        return res if out is None else out.copy_(res)
    if device.type != "cuda":
        raise ValueError(f"semiring_matmul: unsupported device {device}")
    out = ops.output("semiring_matmul", out, (m, n), a)
    if m == 0 or n == 0:
        return out
    plan = ops.matmul_plan(m, n, kd, semiring, align=ops.alignment(a, b))
    a_words = b_words = None
    if semiring == ops.PACKED:
        a_words = torch.empty((m, plan.k_steps), dtype=torch.int32, device=device)
        b_words = torch.empty((plan.k_steps, plan.ldb), dtype=torch.int32, device=device)
    fn = ops.load("semiring_matmul", "repro_semiring_matmul", _ARGTYPES)
    rc = fn(
        device.index, a.data_ptr(), b.data_ptr(), m, kd, n, SEMIRINGS[semiring],
        out.data_ptr(), ctypes.byref(plan),
        None if a_words is None else a_words.data_ptr(),
        None if b_words is None else b_words.data_ptr(), ops.stream_of(device),
    )
    ops.check_launch("semiring_matmul", rc)
    return out
