"""Statistics layer: sketches + collection (DESIGN.md §10)."""
from repro_torch.stats.collect import (
    ColumnStats,
    RelationStats,
    Statistics,
    collect_statistics,
)
from repro_torch.stats.sketches import DistinctSketch, HeavyHitterSketch, splitmix64

__all__ = [
    "ColumnStats",
    "DistinctSketch",
    "HeavyHitterSketch",
    "RelationStats",
    "Statistics",
    "collect_statistics",
    "splitmix64",
]
