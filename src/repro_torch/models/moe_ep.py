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
divides it by the data axis and does not reduce it again.  The ``model``
sum and copy are ``shard_ctx``'s :func:`~repro_torch.models.shard_ctx.model_sum`
and :func:`~repro_torch.models.shard_ctx.model_copy`, the dense layers' too.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import all_gather, all_reduce, all_to_all, data_axes
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
    cut = None if tp is None else shard_ctx.Cut(mesh.axis_group(tp), mesh.shape[tp],
                                                mesh.coords[tp])
    recv = shard_ctx.model_copy(recv, cut)
    h = F.silu(torch.bmm(recv, p["wg"].to(x.dtype))) * torch.bmm(recv, p["wu"].to(x.dtype))
    ob = torch.bmm(h, p["wd"].to(x.dtype))
    if cut is not None:
        ob = shard_ctx.model_sum(ob.to(torch.bfloat16), cut)
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


def moe_block_served(p, x: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """The MoE of a meshed prefill or decode (``shard_ctx.serving``).  The
    reference's serving cell installs no mesh (``launch/dryrun.py:101-108``),
    so its MoE is ``moe_block`` over every token of the call, routed at
    once with that call's capacity; these are its values, dropped choices
    included.  x (T_loc, d): this rank's tokens; ``p``: the whole router
    and this rank's experts, as :func:`moe_block_ep` takes them.

    Every rank gathers the call's tokens over the axes that cut the batch
    rows (row order), routes them all as ``layers.moe_block`` does, fills
    the ``(E · C, d)`` buffer, runs its ``E / n_data`` experts on their
    slots with its cut of the ffn dimension, sums the down-projection over
    ``model`` (f32 partials rounded once), gathers every expert's slots
    over ``data`` and combines its own tokens' choices.  Returns (y (T_loc,
    d) in ``x``'s dtype, the call's f32 aux)."""
    mesh = shard_ctx._MESH
    serve = shard_ctx.serving()
    if serve is None or "data" not in mesh.axis_names:
        raise RuntimeError("moe_block_served needs a serving layout on a mesh with a data axis "
                           "(shard_ctx.set_mesh(mesh, serving=...))")
    n = mesh.shape["data"]
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    if E % n or p["wg"].shape[0] != E // n:
        raise ValueError(f"moe_block_served takes this rank's {E // n} of {E} experts over a data "
                         f"axis of {n}; got {tuple(p['wg'].shape)}")
    E_loc = E // n
    T_loc, d = x.shape
    xs = shard_ctx.gather_over(x, serve.rows, 0)
    r = L.moe_route(p, xs, cfg)
    C = r.capacity
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device).index_add(
        0, r.slot, xs.repeat_interleave(k, dim=0))
    e0 = mesh.coords["data"] * E_loc
    eb = buf[e0 * C:(e0 + E_loc) * C].reshape(E_loc, C, d)
    h = F.silu(torch.bmm(eb, p["wg"].to(x.dtype))) * torch.bmm(eb, p["wu"].to(x.dtype))
    ob = torch.bmm(h, p["wd"].to(x.dtype))
    if "model" in mesh.axis_names and mesh.shape["model"] > 1:
        ob = shard_ctx.model_sum(ob, shard_ctx.Cut(mesh.axis_group("model"),
                                                   mesh.shape["model"], mesh.coords["model"]))
    flat = all_gather(ob, mesh.axis_group("data"), 0).reshape(E * C, d)
    t0 = shard_ctx.axes_block(serve.rows)[1] * T_loc
    mine = slice(t0 * k, (t0 + T_loc) * k)
    slot, valid = r.slot[mine], r.valid[mine]
    y = torch.where(valid[:, None], flat[slot.clamp(max=E * C - 1)], 0.0)
    y = (y * r.gate.reshape(-1)[mine, None].to(y.dtype)).reshape(T_loc, k, d).sum(dim=1)
    frac = (r.onehot > 0).float().mean(dim=0)
    return y, E * torch.sum(frac * r.probs.mean(dim=0))
