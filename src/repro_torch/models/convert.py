"""The reference's parameter pytrees and the port's module state.

The JAX package keeps a model's parameters as a nested dict of arrays
(``params["layers"]["attn"]["wq"]["w"]``) and AdamW's state as
``{"m": <same tree>, "v": <same tree>, "step": int32}``.  The port keeps
them by dotted name (``layers.attn.wq.w``, ``Model.params()``), with the
same shapes, so a conversion is a renaming and a copy:

* ``from_numpy(cfg, tree)``: numpy arrays, as
  ``jax.tree.map(np.asarray, params)`` gives them, to the port's state
  dict; ``(params, opt)`` to ``(state dict, AdamW state)``;
* ``to_numpy(cfg, state)``: the inverse; ``to_numpy(cfg, state, opt)``
  gives ``(params, opt)``.

``nest`` and ``flat`` are the renaming alone, on any leaves; the
checkpointer saves the nested form, so its leaf names are the
reference's.  Every family's leaves keep the reference's stacking: the
hybrid's Mamba2 leaves both leading axes, ``(n_layers // shared_period,
shared_period, ...)``, beside the unstacked ``shared`` block.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model


def flat(tree: dict, prefix: str = "") -> dict:
    """Nested dicts to ``{dotted name: leaf}``, keys sorted at every level
    (the order of the reference's pytree leaves)."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flat(v, name + "."))
        else:
            out[name] = v
    return out


def nest(named: dict) -> dict:
    """``{dotted name: leaf}`` to nested dicts."""
    out: dict = {}
    for name, v in named.items():
        *path, leaf = name.split(".")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def param_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """Every parameter's shape by dotted name, in the reference's order."""
    return {n: tuple(p.shape) for n, p in Model(cfg, device="meta").params().items()}


def _checked(cfg: ModelConfig, named: dict, what: str) -> dict:
    want = param_shapes(cfg)
    got = {k: tuple(v.shape) for k, v in named.items()}
    if got != want:
        missing = sorted(set(want) - set(got))
        extra = sorted(set(got) - set(want))
        wrong = sorted(k for k in set(want) & set(got) if want[k] != got[k])
        raise ValueError(f"{what} does not match {cfg.name}: missing {missing}, "
                         f"unexpected {extra}, other shapes {wrong}")
    return named


def _t(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a), device=device)  # a copy: the state is updated in place


def from_numpy(cfg: ModelConfig, tree, device="cpu"):
    """The reference's ``params`` tree to a state dict of f32 tensors on
    ``device``; a ``(params, opt)`` pair to ``(state dict, AdamW state)``."""
    if isinstance(tree, tuple):
        params, opt = tree
        state = from_numpy(cfg, params, device)
        moments = {k: _checked(cfg, {n: _t(a, device) for n, a in flat(opt[k]).items()},
                               f"opt[{k!r}]")
                   for k in ("m", "v")}
        step = _t(opt["step"], device).to(torch.int32)
        return state, {"m": moments["m"], "v": moments["v"], "step": step}
    named = {n: _t(a, device) for n, a in flat(tree).items()}
    return _checked(cfg, named, "params")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", copy=True).numpy()  # never a view of a live parameter


def to_numpy(cfg: ModelConfig, state: dict, opt: dict | None = None):
    """A state dict (or ``Model.params()``) to the reference's ``params``
    tree of numpy arrays; with ``opt``, ``(params, opt)``."""
    params = nest({n: _np(t) for n, t in _checked(cfg, dict(state), "state").items()})
    if opt is None:
        return params
    return params, {"m": nest({n: _np(t) for n, t in _checked(cfg, opt["m"], "m").items()}),
                    "v": nest({n: _np(t) for n, t in _checked(cfg, opt["v"], "v").items()}),
                    "step": _np(opt["step"])}
