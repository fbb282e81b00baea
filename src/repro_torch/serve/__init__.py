"""Query-serving subsystem: a long-lived, concurrent JOIN-AGG service on
one device, layered on the logical-plan API (DESIGN.md §9).

Pieces:

* :mod:`repro_torch.serve.cache`   — bounded LRU + the prepared-plan cache.
* :mod:`repro_torch.serve.batcher` — cross-client fusion of compatible
  in-flight queries into one semiring-channel contraction pass.
* :mod:`repro_torch.serve.views`   — maintained-view serving: snapshot
  reads with epoch swap while one writer thread applies delta batches.
* :mod:`repro_torch.serve.server`  — the server core + a TCP/JSON line
  protocol.
* :mod:`repro_torch.serve.session` — in-process sessions and the TCP
  client.
* :mod:`repro_torch.serve.mesh`    — meshed requests: ``serve_mesh`` on
  every rank, an ordered lane on rank 0, followers on the others.

This ``__init__`` is lazy (PEP 562), as the JAX package's is: importing
it loads none of the modules above.
"""
from __future__ import annotations

_EXPORTS = {
    "LRUCache": "repro_torch.serve.cache",
    "CacheStats": "repro_torch.serve.cache",
    "PlanCache": "repro_torch.serve.cache",
    "plan_shape_key": "repro_torch.serve.cache",
    "FusionBatcher": "repro_torch.serve.batcher",
    "ServedView": "repro_torch.serve.views",
    "ViewSnapshot": "repro_torch.serve.views",
    "JoinAggServer": "repro_torch.serve.server",
    "serve_tcp": "repro_torch.serve.server",
    "Session": "repro_torch.serve.session",
    "RemoteSession": "repro_torch.serve.session",
    "connect": "repro_torch.serve.session",
    "serve_mesh": "repro_torch.serve.mesh",
    "MeshLane": "repro_torch.serve.mesh",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)
