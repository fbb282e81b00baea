"""Activation-sharding context and the ``model`` axis's conjugate operations.

Port of the JAX package's ``models/shard_ctx.py``.  ``set_mesh`` installs
a mesh (``launch/mesh.py``) and a mode in ``_MESH`` and ``_MODE``; the
layers read them: ``layers.moe_block`` takes the expert-parallel
``moe_ep.py`` path under the reference's four conditions, and the dense
layers split their work over ``model`` where the reference's ``constrain``
pins cut it (:func:`model_cut`).

In the reference, ``constrain`` pins an activation's layout with
``with_sharding_constraint`` so that GSPMD chooses the collectives it
should (gather weights, not activations).  The port has no GSPMD: the
meshed train step (``launch/train.py:build_train_step(mesh=)``) hands
each rank the blocks it computes with, so :func:`constrain` returns
``x``, and at the reference's constrain sites the layers ask
:func:`model_cut` whether the pin cuts a dimension over ``model``.
Where it does, the rank computes its share (its heads, its ffn columns,
its vocabulary rows) between the two conjugate operations of a
Megatron-style region: :func:`model_copy` (identity forward, the
cotangent summed over ``model`` backward) at the region's input and
:func:`model_sum` (the partials summed forward, identity backward) at
its output.  Downstream of the sum every rank of a ``model`` group holds
the same activations, so the cotangent reaching the sum is whole, and a
replicated leaf used outside a region gets its whole gradient on every
rank.  :func:`activation_spec` gives the spec the reference's
``constrain`` pins, for every kind under every mode.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.launch.mesh import all_reduce

_MESH = None
_MODE: str = "all"  # all | attn | mlp | ep | sp (sequence-parallel residuals)

KINDS = ("btd", "btdg", "btf", "bthd", "bthd_rep", "td", "ecd", "ecf")


def set_mesh(mesh, mode: str = "all") -> None:
    global _MESH, _MODE
    _MESH = mesh
    _MODE = mode


def constrain(x, kind: str):
    """The identity: the meshed step lays activations out by construction."""
    return x


def activation_spec(kind: str, shape) -> tuple | None:
    """The spec the reference's ``constrain`` pins on an activation of
    ``shape`` of ``kind`` under the installed mesh and mode, or None
    where it leaves ``x`` as it is.  kinds: 'btd' (batch, seq, d_model) |
    'btdg' (a norm's output feeding a TP projection) | 'btf' (ffn hidden)
    | 'bthd' (batch, seq, heads, head_dim) | 'bthd_rep' | 'td' (flattened
    tokens) | 'ecd' / 'ecf' (MoE dispatch buffer and expert hidden)."""
    return spec_on(_MESH, _MODE, kind, shape)


def spec_on(mesh, mode: str, kind: str, shape) -> tuple | None:
    """:func:`activation_spec` on ``mesh`` (None: no mesh) under ``mode``."""
    if mesh is None:
        return None
    if mode == "ep":
        return None  # only the expert-parallel MoE path is active
    if mode == "attn" and kind in ("btd", "btdg", "btf", "td", "ecd", "ecf"):
        return None
    if mode == "mlp" and kind in ("bthd", "bthd_rep"):
        return None
    shape = tuple(shape)
    names = mesh.axis_names
    dp_axes = tuple(a for a in names if a in ("pod", "data"))
    dp = dp_axes if len(dp_axes) > 1 else (dp_axes[0] if dp_axes else None)
    tp = "model" if "model" in names else None
    tp_size = mesh.shape.get("model", 1)
    if kind == "btd":
        # sp: the residual stream shards its sequence over the TP axis
        if mode == "sp" and shape[1] % tp_size == 0:
            spec = (dp, tp, None)
        else:
            spec = (dp, None, None)
    elif kind == "btdg":
        spec = (dp, None, None)
    elif kind == "btf":
        spec = (dp, None, tp if shape[-1] % tp_size == 0 else None)
    elif kind == "bthd":
        ok = shape[2] % tp_size == 0
        spec = (dp, None, tp if ok else None, None)
    elif kind == "bthd_rep":
        spec = (dp, None, None, None)
    elif kind == "td":
        spec = (dp, None)
    elif kind == "ecd":
        spec = ("data" if "data" in names else None, None, None)
    elif kind == "ecf":
        spec = ("data" if "data" in names else None, None, tp)
    else:
        raise ValueError(kind)
    if len(shape) != len(spec):
        return None
    return spec


# ---------------------------------------------------------------- the model axis


class Cut(NamedTuple):
    """A dimension cut over ``model``: this rank's block ``index`` of
    ``size`` equal blocks, and the axis's process group (None on an
    abstract mesh)."""

    group: object
    size: int
    index: int


def cuts_model(mesh, kind: str, shape, mode: str = "all") -> bool:
    """Whether the reference's pin of ``kind`` on ``shape`` cuts a
    dimension over a ``model`` axis of more than one rank."""
    spec = spec_on(mesh, mode, kind, shape)
    return spec is not None and "model" in spec and mesh.shape["model"] > 1


def model_cut(kind: str, shape) -> Cut | None:
    """Where the installed mesh's pin of ``kind`` on the whole ``shape``
    cuts a dimension over ``model`` (the heads of ``"bthd"``, the last
    dimension of ``"btf"``), this rank's share of it; None where the
    layer runs whole on every rank (no mesh, a ``model`` axis of one
    rank, or a dimension it does not divide)."""
    if not cuts_model(_MESH, kind, shape, _MODE):
        return None
    return Cut(_MESH.axis_group("model"), _MESH.shape["model"], _MESH.coords["model"])


class _ModelSum(torch.autograd.Function):
    """The sum over ``group`` of partials, in f32 and rounded to the
    partials' dtype once (for two bf16 partials, the bits of one bf16
    addition)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.float(), group).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ModelCopy(torch.autograd.Function):
    """The identity on a tensor every rank of ``group`` holds alike, whose
    cotangent sums over the group: each rank's share of the work adds its
    part of the input's gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


def model_sum(x: torch.Tensor, cut: Cut | None) -> torch.Tensor:
    """A region's output: the partials summed over ``cut``'s group
    (identity backward); ``x`` itself when ``cut`` is None."""
    return x if cut is None else _ModelSum.apply(x, cut.group)


def model_copy(x: torch.Tensor, cut: Cut | None) -> torch.Tensor:
    """A region's input: ``x`` (its cotangent summed over ``cut``'s group
    backward); ``x`` itself when ``cut`` is None."""
    return x if cut is None else _ModelCopy.apply(x, cut.group)
