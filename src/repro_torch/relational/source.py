"""Whole columns as in-memory arrays.

Copy of the part of the JAX package's ``relational/source.py`` that the
incremental maintainer needs: :func:`materialize_columns`, the one
sanctioned eager read of a relation's columns (MIN/MAX keep their
measure relation's raw tuples so a delete can rebuild the
non-invertible payloads).  The port's relations are in memory only
(``relational/relation.py``), so this is a copy of their columns.
"""
from __future__ import annotations

import numpy as np

from repro_torch.relational.relation import Relation


def materialize_columns(
    rel: Relation, attrs: tuple[str, ...] | None = None
) -> dict[str, np.ndarray]:
    """``rel``'s columns ``attrs`` (default: all) as in-RAM arrays."""
    attrs = tuple(attrs) if attrs is not None else rel.attrs
    return {a: np.asarray(rel.columns[a]) for a in attrs}
