"""Incremental JOIN-AGG maintenance on the card (DESIGN.md §4).

``prepare()`` once, then apply batched inserts/deletes with refresh cost
proportional to the delta's dirty root-path — not the database:

    handle = MaintainedJoinAgg(query, db)        # or Q ... .maintain(db)
    handle.insert("R2", {"j": ..., "b": ...})
    handle.delete("R2", {"j": ..., "b": ...})
    handle.result()   # equal to the query's answer on the current db

The cached messages stay on the engine's device and every delta hop runs
on the hand-written ``coo_spmm`` / ``segment_sum`` kernels.  Port of the
JAX package's ``incremental/`` (its ``"tensor"`` engine is the reference
the port is checked against).
"""
from repro_torch.incremental.delta import DeltaBatch, MaintainedRelation, encode_delta
from repro_torch.incremental.maintained import MaintainedJoinAgg, RefreshStats
from repro_torch.incremental.planner import MessageCache
from repro_torch.incremental.torch_delta import KernelDeltaEngine

__all__ = [
    "DeltaBatch",
    "KernelDeltaEngine",
    "MaintainedRelation",
    "encode_delta",
    "MaintainedJoinAgg",
    "RefreshStats",
    "MessageCache",
]
