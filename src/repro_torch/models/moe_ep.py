"""Expert-parallel MoE over ``all_to_all`` (GShard-style).

Port of the JAX package's ``models/moe_ep.py``.  The reference runs it
inside ``shard_map``; here every rank of the mesh installed in
``shard_ctx`` calls it on its own tokens and its own experts:

  1. local routing (``layers.moe_route``) and dispatch into (E, C, d),
     ``C = max(1, int(capacity_factor · k · T_loc / E))`` per rank,
  2. ``all_to_all`` over ``data``: (E, C, d) -> (E_loc, n·C, d), every
     rank now holding all tokens routed to its ``E / n`` experts, in
     source-rank order,
  3. the experts' SwiGLU on the rank's cut of the ffn dimension over
     ``model``, and the down-projection summed over ``model`` in bf16,
  4. the inverse ``all_to_all`` and the local gather-back and combine;
     ``aux`` averaged over the data axes.

Both exchanges carry gradients: an ``all_to_all`` is its own transpose,
so its backward exchanges the cotangents the same way.  Every rank of a
``model`` group holds the same tokens and the same copy of everything
downstream of the sum, so the backward of the ``model`` sum passes the
cotangent on unscaled, as the reference's does, and the received tokens'
cotangent is summed over ``model`` (each rank's cut of the ffn dimension
adds its part, as the reference's ``shard_map`` sums an input's
cotangent over the axes its spec leaves out).  The backward of the
``aux`` mean is the mean of the cotangents.  So a rank's expert gradient
sums every data rank's tokens routed to its experts; the train step
divides it by the data axis and does not reduce it again.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import all_reduce, all_to_all, data_axes
from repro_torch.models import shard_ctx
from repro_torch.models import layers as L

EXPERT_LEAVES = ("wg", "wu", "wd")


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.group), None


class _ModelSum(torch.autograd.Function):
    """The sum over ``group`` of bf16 partials, in f32 and rounded to bf16
    once (for a group of two, the bits of one bf16 addition)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.float(), group).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ModelCopy(torch.autograd.Function):
    """The identity on a tensor every rank of ``group`` holds alike, whose
    cotangent sums over the group: each rank's cut of the ffn dimension
    adds its part of the inputs' gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Mean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group) / torch.distributed.get_world_size(group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group) / torch.distributed.get_world_size(ctx.group), None


def moe_block_ep(p, x: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """x (T_loc, d): this rank's tokens; ``p``: the full router (d, E)
    and this rank's experts, ``wg``/``wu`` (E / n_data, d, f / n_model)
    and ``wd`` (E / n_data, f / n_model, d).  Returns (y (T_loc, d),
    aux), ``y`` in bf16 when the mesh has a ``model`` axis (the sum's
    dtype, as in the reference)."""
    mesh = shard_ctx._MESH
    if mesh is None:
        raise RuntimeError("moe_block_ep needs a mesh installed (shard_ctx.set_mesh)")
    names = mesh.axis_names
    tp = "model" if "model" in names else None
    n = mesh.shape["data"]
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    if E % n:
        raise ValueError(f"{E} experts do not divide over a data axis of {n}")
    E_loc = E // n
    if p["wg"].shape[0] != E_loc:
        raise ValueError(f"moe_block_ep takes this rank's {E_loc} experts; got "
                         f"{tuple(p['wg'].shape)}")
    data = mesh.axis_group("data")
    T_loc, d = x.shape

    r = L.moe_route(p, x, cfg)
    C = r.capacity
    xr = x.repeat_interleave(k, dim=0)
    # one spare row takes the dropped choices, as mode="drop" does
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device).index_add(0, r.slot, xr)
    # (E, C, d) = (n, E_loc, C, d): block i to rank i; back as (n_src, E_loc, C, d)
    recv = _Exchange.apply(buf[:E * C].reshape(E, C, d), data)
    recv = recv.reshape(n, E_loc, C, d).transpose(0, 1).reshape(E_loc, n * C, d)
    if tp is not None:
        recv = _ModelCopy.apply(recv, mesh.axis_group(tp))
    h = F.silu(torch.bmm(recv, p["wg"].to(x.dtype))) * torch.bmm(recv, p["wu"].to(x.dtype))
    ob = torch.bmm(h, p["wd"].to(x.dtype))
    if tp is not None:
        ob = _ModelSum.apply(ob.to(torch.bfloat16), mesh.axis_group(tp))
    # (E_loc, n, C, d) -> (n, E_loc, C, d): source rank s's tokens back to s
    send = ob.reshape(E_loc, n, C, d).transpose(0, 1).contiguous()
    flat = _Exchange.apply(send, data).reshape(E * C, d)
    y = torch.where(r.valid[:, None], flat[r.slot.clamp(max=E * C - 1)], 0.0)
    y = (y * r.gate.reshape(-1)[:, None].to(y.dtype)).reshape(T_loc, k, d).sum(dim=1)

    frac = (r.onehot > 0).float().mean(dim=0)
    aux = E * torch.sum(frac * r.probs.mean(dim=0))
    for ax in data_axes(mesh):
        aux = _Mean.apply(aux, mesh.axis_group(ax))
    return y, aux
