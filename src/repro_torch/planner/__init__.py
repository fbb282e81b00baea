"""Statistics-driven cost model + per-split planning (DESIGN.md §10)."""
from repro_torch.planner.cost import node_card_estimates, plan_cost
from repro_torch.planner.split import (
    SPLIT_MIN_BENEFIT,
    SPLIT_MIN_SHARE,
    SplitDecision,
    decide_split,
    execute_split,
    split_parts,
)

__all__ = [
    "SPLIT_MIN_BENEFIT",
    "SPLIT_MIN_SHARE",
    "SplitDecision",
    "decide_split",
    "execute_split",
    "node_card_estimates",
    "plan_cost",
    "split_parts",
]
