"""Three-objective Pareto frontier over evaluated plans (DESIGN.md §16)
(the port's own copy of ``repro.tune.pareto``).

The paper's headline table is itself a Pareto argument: the scalable
middle is not the fastest point NOR the smallest, it is the point no
other configuration beats on *both* axes at once.  The tuner makes that
argument mechanical over three objectives:

  * ``tok_per_s``  — maximize (fleet throughput on the virtual clock);
  * ``p99_ms``     — minimize (tail latency of the trace's completions);
  * ``footprint``  — minimize (the plan's mean footprint score — the
    "third of the resources" axis).

Dominance is the standard strict partial order: ``a`` dominates ``b``
when ``a`` is at least as good on every objective and strictly better on
at least one.  ``pareto_front`` returns the non-dominated subset in ONE
deterministic order — descending throughput, then ascending p99, then
ascending footprint, then the candidate's own sort key — so the same
evaluations always serialize to the same frontier (the bit-reproducible
contract the plan repository and bench rely on).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

#: Objective senses, in objective-tuple order: +1 maximizes, -1 minimizes.
SENSES: Tuple[int, ...] = (+1, -1, -1)
OBJECTIVES: Tuple[str, ...] = ("tok_per_s", "p99_ms", "footprint")


def dominates(a: Sequence[float], b: Sequence[float]) -> bool:
    """True when objective tuple ``a`` Pareto-dominates ``b``: at least
    as good everywhere (per ``SENSES``), strictly better somewhere.
    Non-finite objectives (a failed evaluation's ``inf`` p99) can never
    dominate and are dominated by any finite tuple that matches
    elsewhere."""
    if len(a) != len(b) or len(a) != len(SENSES):
        raise ValueError(f"objective tuples must have {len(SENSES)} "
                         f"entries, got {len(a)} vs {len(b)}")
    at_least_as_good = strictly_better = True
    strictly_better = False
    for s, x, y in zip(SENSES, a, b):
        dx, dy = s * x, s * y
        if math.isnan(dx) or math.isnan(dy):
            raise ValueError("objectives must not be NaN")
        if dx < dy:
            at_least_as_good = False
            break
        if dx > dy:
            strictly_better = True
    return at_least_as_good and strictly_better


@dataclasses.dataclass(frozen=True)
class FrontierPoint:
    """One non-dominated evaluation: the candidate plan (anything the
    caller evaluated — the tuner stores ``EndpointPlan``s) plus its
    objective tuple and the full measurement it came from."""

    plan: object
    objectives: Tuple[float, float, float]
    measurement: object = None

    @property
    def tok_per_s(self) -> float:
        return self.objectives[0]

    @property
    def p99_ms(self) -> float:
        return self.objectives[1]

    @property
    def footprint(self) -> float:
        return self.objectives[2]


def _tie_key(p: FrontierPoint):
    """THE deterministic frontier order: throughput desc, p99 asc,
    footprint asc, then the plan's own stable key (its repr — every
    candidate type the tuner produces has a deterministic repr)."""
    return (-p.objectives[0], p.objectives[1], p.objectives[2],
            repr(p.plan))


def pareto_front(points: Sequence[FrontierPoint]) -> List[FrontierPoint]:
    """The non-dominated subset of ``points`` in the deterministic
    tie-break order.  Duplicate objective tuples (distinct plans landing
    on the same point) all survive — neither dominates the other — and
    exact duplicate (plan, objectives) pairs collapse to one entry, so
    re-evaluating a cached candidate can never fatten the frontier."""
    seen = set()
    unique: List[FrontierPoint] = []
    for p in points:
        key = (repr(p.plan), p.objectives)
        if key in seen:
            continue
        seen.add(key)
        unique.append(p)
    front = [p for p in unique
             if not any(dominates(q.objectives, p.objectives)
                        for q in unique)]
    front.sort(key=_tie_key)
    return front


__all__ = ["SENSES", "OBJECTIVES", "dominates", "FrontierPoint",
           "pareto_front"]
