"""Schema, encoding, decomposition and the leaves-to-root walk; the
multi-way JOIN-AGG operator itself is :func:`join_agg`."""
from repro_torch.core.query import JoinAggQuery
from repro_torch.core.operator import join_agg

__all__ = ["JoinAggQuery", "join_agg"]
