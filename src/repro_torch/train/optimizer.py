"""AdamW with global-norm clipping and a warmup-cosine schedule.

Port of the JAX package's ``train/optimizer.py`` on tensors.  The state
is f32 (``m``, ``v``: one tensor per parameter, by the parameter's name)
and an int32 step counter, all on the parameters' device; the update
runs under ``torch.no_grad()`` and writes parameters and state in place.
Every scalar (the norm, the clip factor, the learning rate, the bias
corrections) stays a device tensor: an update waits for nothing.

As in the reference, weight decay applies to every parameter with two
or more dimensions.  The model stacks its per-layer tensors along a
leading ``n_layers`` axis, so per-layer norm scales and biases decay and
the top-level ``final_norm`` scale does not.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor), f32: linear
    warmup to ``cfg.lr`` over ``warmup_steps``, then a cosine down to
    ``min_lr_frac`` of it at ``total_steps``."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0
    )
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


def adamw_init(params: dict[str, torch.Tensor]) -> dict:
    """Zero f32 moments beside each named parameter, and step 0."""
    device = next(iter(params.values())).device
    return {
        "m": {n: torch.zeros(p.shape, dtype=torch.float32, device=device)
              for n, p in params.items()},
        "v": {n: torch.zeros(p.shape, dtype=torch.float32, device=device)
              for n, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tensors: dict[str, torch.Tensor], mesh=None, specs=None) -> torch.Tensor:
    """The f32 L2 norm over every tensor, summed leaf by leaf in order.

    On a mesh (``launch/mesh.py``) each tensor is this rank's block of its
    leaf under ``specs[name]`` (``launch/sharding.py``), and every element
    counts once: a block held by several ranks (the spec leaves out a mesh
    axis, as ``()`` or a ``data``-only spec do) counts on the rank at
    coordinate 0 of every axis it leaves out, and the squares are summed
    over the mesh."""
    squares = [torch.sum(torch.square(t.float())) for t in tensors.values()]
    if mesh is None:
        return torch.sqrt(torch.stack(squares).sum())
    from repro_torch.launch.mesh import all_reduce
    from repro_torch.launch.sharding import named_axes

    counted = []
    for name, sq in zip(tensors, squares):
        named = named_axes(specs[name])
        first = all(mesh.coords[a] == 0 for a in mesh.axis_names if a not in named)
        counted.append(sq if first else torch.zeros_like(sq))
    return torch.sqrt(all_reduce(torch.stack(counted).sum(), mesh.group))


@torch.no_grad()
def adamw_update(params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor],
                 state: dict, cfg: AdamWConfig, mesh=None, specs=None) -> dict[str, torch.Tensor]:
    """One AdamW step on ``params`` (by name) from ``grads``, clipped to
    ``clip_norm`` by their global norm; the learning rate is the schedule
    at the incremented step.  Updates ``params`` and ``state`` in place
    and returns ``{"grad_norm", "lr"}`` as device scalars.  On a mesh the
    tensors are this rank's blocks under ``specs``: the update is
    elementwise but for the norm, which counts every element once
    (:func:`global_norm`)."""
    step = state["step"] + 1
    gnorm = global_norm(grads, mesh, specs)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    for name, p in params.items():
        g = grads[name].float() * scale
        m, v = state["m"][name], state["v"][name]
        m2 = cfg.b1 * m + (1 - cfg.b1) * g
        v2 = cfg.b2 * v + (1 - cfg.b2) * g * g
        delta = (m2 / b1c) / (torch.sqrt(v2 / b2c) + cfg.eps)
        if p.ndim >= 2:  # decoupled decay on matrices (and stacked layers) only
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m2)
        v.copy_(v2)
    state["step"].copy_(step)
    return {"grad_norm": gnorm, "lr": lr}
