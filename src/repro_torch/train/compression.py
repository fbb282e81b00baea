"""Error-feedback int8 gradient compression for the cross-pod hop.

Port of the JAX package's ``train/compression.py``.  Quantizing
gradients to int8 with an error-feedback accumulator cuts the bytes of
the slowest gradient all-reduce 4× versus f32 while the residual keeps
the update unbiased over time [Seide et al. '14; 1-bit SGD lineage].

``compress`` and ``decompress`` give the reference's bits
(``torch.round`` rounds half to even, as ``jnp.round`` does); the error
buffer shards like the gradient.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import all_reduce


def compress(g: torch.Tensor, err: torch.Tensor):
    """-> (q int8, scale f32 scalar, new_err).  g + err ≈ q * scale."""
    corrected = g.float() + err
    amax = torch.max(torch.abs(corrected))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(corrected / scale), -127, 127).to(torch.int8)
    new_err = corrected - q.float() * scale
    return q, scale, new_err


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_buffers(grads: dict) -> dict:
    return {n: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for n, g in grads.items()}


def compressed_psum_tree(grads: dict, errs: dict, group):
    """Every rank of ``group`` quantizes, the int8 payloads are summed in
    int32, the scales' maximum taken, and each sum dequantized with that
    maximum and divided by the group's size, as the reference does.
    Returns (reduced grads, new error buffers), by name."""
    n = dist.get_world_size(group)
    out, new_errs = {}, {}
    for name, g in grads.items():
        q, scale, new_errs[name] = compress(g, errs[name])
        # sum int8 payloads in int32 to avoid overflow across ranks
        summed = all_reduce(q.to(torch.int32), group)
        scale_max = all_reduce(scale, group, op="max")
        out[name] = decompress(summed, scale_max) / float(n)
    return out, new_errs
