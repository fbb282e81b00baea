"""Activation-sharding context.

Port of the JAX package's ``models/shard_ctx.py``.  ``set_mesh`` installs
a mesh (``launch/mesh.py``) and a mode in ``_MESH`` and ``_MODE``;
``layers.moe_block`` reads them and, with a mesh installed, takes the
expert-parallel ``moe_ep.py`` path, under the reference's four
conditions.

In the reference, ``constrain`` pins an activation's layout with
``with_sharding_constraint`` so that GSPMD chooses the collectives it
should (gather weights, not activations).  The port has no GSPMD: the
meshed train step (``launch/train.py:build_train_step(mesh=)``) fixes
every layout by construction (a rank's batch rows, its gathered dense
weights, its experts), so :func:`constrain` returns ``x`` and the
model's code leaves its call sites out.  :func:`activation_spec` gives
the spec the reference's ``constrain`` pins, for every kind under every
mode.
"""
from __future__ import annotations

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
    if _MESH is None:
        return None
    if _MODE == "ep":
        return None  # only the expert-parallel MoE path is active
    if _MODE == "attn" and kind in ("btd", "btdg", "btf", "td", "ecd", "ecf"):
        return None
    if _MODE == "mlp" and kind in ("bthd", "bthd_rep"):
        return None
    shape = tuple(shape)
    names = _MESH.axis_names
    dp_axes = tuple(a for a in names if a in ("pod", "data"))
    dp = dp_axes if len(dp_axes) > 1 else (dp_axes[0] if dp_axes else None)
    tp = "model" if "model" in names else None
    tp_size = _MESH.shape.get("model", 1)
    if kind == "btd":
        # sp: the residual stream shards its sequence over the TP axis
        if _MODE == "sp" and shape[1] % tp_size == 0:
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
