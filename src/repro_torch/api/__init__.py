"""The logical-plan front end — the port's one public entry point.

    from repro_torch.api import Q, Count, Sum, Min, Avg

    res = (
        Q.over("R", "S", "T")
        .where("S", "m", ">", 0.0)
        .group_by("R.a", "T.b")
        .agg(count=Count(), total=Sum("S.m"), lo=Min("S.m"))
        .engine("torch")
        .plan(db)
        .execute()
    )

``.maintain(db)`` in place of ``.plan(db)`` returns a handle whose
``insert``/``delete`` refresh the result along the dirty root-path only.
"""
from repro_torch.aggregates.semiring import AggSpec, Avg, Count, Max, Min, Sum
from repro_torch.api.builder import Q
from repro_torch.api.engines import (
    Channel,
    EngineOutput,
    MinMaxRequest,
    TorchChannelEngine,
    resolve_engine,
)
from repro_torch.api.maintain import MaintainedPlan
from repro_torch.api.plan import AggResult, Plan, compile_plan
from repro_torch.core.operator import UnsupportedPlanOption

__all__ = [
    "AggResult",
    "AggSpec",
    "Avg",
    "Channel",
    "Count",
    "EngineOutput",
    "MaintainedPlan",
    "Max",
    "Min",
    "MinMaxRequest",
    "Plan",
    "Q",
    "Sum",
    "TorchChannelEngine",
    "UnsupportedPlanOption",
    "compile_plan",
    "resolve_engine",
]
