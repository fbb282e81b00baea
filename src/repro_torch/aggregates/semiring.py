"""Aggregate specifications (paper Section IV-D).

COUNT is the paper's running example; SUM/MIN/MAX/AVG generalize over the
same data-graph/contraction machinery:

* COUNT — contraction of edge multiplicities in the (+, x) semiring.
* SUM(R.m) — identical contraction, with the *measure relation*'s edge
  weight replaced by the per-edge sum of ``m`` (distributivity of + over x).
* MIN/MAX(R.m) — a (min, +) / (max, +) semiring pass over the same tree:
  the measure relation contributes its per-edge payload, every other
  relation 0.
* AVG — SUM and COUNT carried as a pair, divided at output.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class AggSpec:
    """Base class; ``measure`` = (relation, attribute) or None for COUNT."""

    kind = "count"

    @property
    def measure(self) -> tuple[str, str] | None:
        return None

    def describe(self) -> str:
        """Human-readable form used by ``Plan.explain()``."""
        m = self.measure
        inner = f"{m[0]}.{m[1]}" if m else "*"
        return f"{self.kind.upper()}({inner})"


@dataclass(frozen=True)
class Count(AggSpec):
    kind = "count"


@dataclass(frozen=True)
class _Measured(AggSpec):
    """Measured aggregate over ``relation.attr``.

    Accepts either ``Sum("R", "m")`` or the dotted shorthand ``Sum("R.m")``
    (the logical-plan builder's preferred spelling).
    """

    relation: str
    attr: str = ""

    def __post_init__(self) -> None:
        if not self.attr:
            if "." not in self.relation:
                raise ValueError(
                    f"{type(self).__name__}: pass (relation, attr) or 'R.attr', "
                    f"got {self.relation!r}"
                )
            rel, attr = self.relation.split(".", 1)
            object.__setattr__(self, "relation", rel)
            object.__setattr__(self, "attr", attr)

    @property
    def measure(self) -> tuple[str, str]:
        return (self.relation, self.attr)


@dataclass(frozen=True)
class Sum(_Measured):
    kind = "sum"


@dataclass(frozen=True)
class Min(_Measured):
    kind = "min"


@dataclass(frozen=True)
class Max(_Measured):
    kind = "max"


@dataclass(frozen=True)
class Avg(_Measured):
    kind = "avg"
