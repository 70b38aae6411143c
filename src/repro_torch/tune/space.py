"""Declarative plan search spaces (DESIGN.md §16)
(the port's own copy of ``repro.tune.space``).

A ``PlanSpace`` names, per axis, the values a tuner may try: the four
``SharingVector`` levels (slots, channels, execs, pages) plus the
structural ``EndpointPlan`` knobs (workers, slots per worker, decode
horizon, prefill buckets, page size/budget).  A ``PlanPoint`` is one
assignment; ``build`` turns it into a real ``EndpointPlan``.

Validity pruning happens HERE, before any simulation is paid for, with
the planner's own machinery rather than parallel re-implementations:

* a ``footprint_budget`` admits exactly the points the planner's one
  budget clamp (``core.plan.fit_budget``) would leave untouched — a
  point the clamp would bump is a point ``resolve`` could never return;
* a shared page level (``pages > 1``) requires paged accounting to be
  engaged (``page_size > 0``), else the point would claim a pooled-
  footprint win the simulation never models;
* a ``page_budget`` must let a worst-case full-length request ever fit
  (``supports_paged_cache``-style structural check: at least
  ``max_len / page_size`` pages), else every evaluation of the point
  dies in ``SimWorker``'s never-satisfiable-budget error.

Everything is deterministic: ``points()`` enumerates the grid in one
fixed axis order, ``sample(rng)`` is a pure function of the caller's
generator state, and ``neighbors()`` yields single-axis moves to
adjacent values in a fixed order — the annealing driver's move set.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Iterator, Optional, Tuple

from repro_torch.core.plan import (Buckets, EndpointPlan, SharingVector,
                                   fit_budget)

#: Axis enumeration order — the one order ``points``/``sample``/
#: ``neighbors`` walk, so every driver sees the same grid.
AXES = ("slots", "channels", "execs", "pages", "n_workers", "n_slots",
        "decode_horizon", "prefill_buckets", "page_size", "page_budget")


@dataclasses.dataclass(frozen=True)
class PlanPoint:
    """One assignment of every searched axis — hashable, so drivers can
    cache evaluations and dedupe candidates by identity."""

    slots: int = 1
    channels: int = 1
    execs: int = 4
    pages: int = 1
    n_workers: int = 8
    n_slots: int = 4
    decode_horizon: int = 1
    prefill_buckets: Buckets = "auto"
    page_size: int = 0
    page_budget: Optional[int] = None

    @property
    def vector(self) -> SharingVector:
        return SharingVector(slots=self.slots, channels=self.channels,
                             execs=self.execs, pages=self.pages)


@dataclasses.dataclass(frozen=True)
class PlanSpace:
    """Candidate values per axis (a 1-tuple freezes the axis), plus the
    cross-axis constraints every candidate must clear."""

    slots: Tuple[int, ...] = (1, 2, 3, 4)
    channels: Tuple[int, ...] = (1, 2, 3, 4)
    execs: Tuple[int, ...] = (1, 2, 3, 4)
    pages: Tuple[int, ...] = (1,)
    n_workers: Tuple[int, ...] = (8,)
    n_slots: Tuple[int, ...] = (4,)
    decode_horizon: Tuple[int, ...] = (1,)
    prefill_buckets: Tuple[Buckets, ...] = ("auto",)
    page_size: Tuple[int, ...] = (0,)
    page_budget: Tuple[Optional[int], ...] = (None,)
    max_len: int = 512
    #: optional ceiling on ``SharingVector.footprint_score`` — pruned
    #: with the planner's own clamp, see ``is_valid``
    footprint_budget: Optional[float] = None

    def __post_init__(self):
        for axis in AXES:
            values = getattr(self, axis)
            if not values:
                raise ValueError(f"axis {axis!r} needs at least one value")
            if len(set(values)) != len(values):
                raise ValueError(f"axis {axis!r} repeats values: {values}")

    # ----- membership / validity ----------------------------------------
    def axis_values(self, axis: str) -> Tuple:
        return getattr(self, axis)

    def contains(self, point: PlanPoint) -> bool:
        return all(getattr(point, a) in self.axis_values(a) for a in AXES)

    def is_valid(self, point: PlanPoint) -> bool:
        """Cross-axis constraints (see module docstring).  Points the
        grid enumerates but this rejects are never evaluated."""
        for level in (point.slots, point.channels, point.execs,
                      point.pages):
            if not 1 <= level <= 4:
                return False
        if point.pages > 1 and point.page_size == 0:
            return False            # phantom pooled-footprint win
        if point.page_size:
            if self.max_len % point.page_size:
                return False
            if point.page_budget is not None \
                    and point.page_budget < self.max_len // point.page_size:
                return False        # a full-length request never fits
        elif point.page_budget is not None:
            return False            # budget without paged accounting
        if self.footprint_budget is not None:
            vec = point.vector
            clamped = fit_budget(vec, self.footprint_budget,
                                 n_workers=point.n_workers,
                                 n_slots=point.n_slots)
            if clamped != vec:
                return False        # the planner's clamp would bump it
        return True

    # ----- enumeration ---------------------------------------------------
    @property
    def raw_size(self) -> int:
        """Grid size before validity pruning."""
        n = 1
        for axis in AXES:
            n *= len(self.axis_values(axis))
        return n

    def points(self) -> Iterator[PlanPoint]:
        """Every valid point, in the fixed ``AXES``-major grid order —
        the grid driver's (and any dedupe pass's) canonical order."""
        for combo in itertools.product(
                *(self.axis_values(a) for a in AXES)):
            point = PlanPoint(**dict(zip(AXES, combo)))
            if self.is_valid(point):
                yield point

    def sample(self, rng, max_tries: int = 10_000) -> PlanPoint:
        """One valid point drawn uniformly from the grid — a pure
        function of ``rng``'s state (numpy ``Generator``), so seeded
        drivers replay identical candidate streams."""
        for _ in range(max_tries):
            point = PlanPoint(**{
                a: self.axis_values(a)[
                    int(rng.integers(len(self.axis_values(a))))]
                for a in AXES})
            if self.is_valid(point):
                return point
        raise ValueError(f"no valid point found in {max_tries} draws — "
                         f"is the space over-constrained?")

    def neighbors(self, point: PlanPoint) -> Iterator[PlanPoint]:
        """Single-axis moves to ADJACENT values (one index step along
        one axis), valid points only, in fixed (axis, -1 then +1) order
        — the annealing move set: every hop crosses exactly one sharing
        or structural boundary, so the walk explores the tradeoff
        surface the way the paper's Table 1 does, one resource at a
        time."""
        for axis in AXES:
            values = self.axis_values(axis)
            if len(values) < 2:
                continue
            idx = values.index(getattr(point, axis))
            for delta in (-1, +1):
                j = idx + delta
                if 0 <= j < len(values):
                    cand = dataclasses.replace(point, **{axis: values[j]})
                    if self.is_valid(cand):
                        yield cand

    # ----- realization ---------------------------------------------------
    def build(self, point: PlanPoint) -> EndpointPlan:
        """The real ``EndpointPlan`` for one point — what the evaluator
        simulates and the repository stores."""
        return EndpointPlan(
            vector=point.vector, n_workers=point.n_workers,
            n_slots=point.n_slots, max_len=self.max_len,
            decode_horizon=point.decode_horizon,
            prefill_buckets=point.prefill_buckets,
            page_size=point.page_size, page_budget=point.page_budget)


#: Named spaces the CLI / bench / CI smoke address by name.
SPACES = {
    # the full sharing cube on the canonical 8-worker/4-slot fleet —
    # the space whose diagonal is the old Category sweep
    "sharing": PlanSpace(),
    # sharing cube + the paged-cache axes: pooled page levels with a
    # 64-token page and optional hard pool budgets (8 pages = exactly
    # one worst-case request; 16 = two)
    "paged": PlanSpace(slots=(1, 2), channels=(1, 2, 3, 4), execs=(4,),
                       pages=(1, 2, 3, 4), page_size=(0, 64),
                       page_budget=(None, 8, 16)),
    # sharing levels x structural knobs (fleet width, slots per worker,
    # decode horizon) — horizon/buckets ride into the plan unchanged
    "structural": PlanSpace(execs=(4,), n_workers=(4, 8),
                            n_slots=(2, 4),
                            decode_horizon=(1, 2, 4)),
    # CI smoke: 6 points, all cheap
    "tiny": PlanSpace(slots=(1, 2), channels=(1, 2, 4), execs=(4,),
                      n_workers=(4,)),
}


def space_by_name(name: str) -> PlanSpace:
    if name not in SPACES:
        raise KeyError(f"unknown space {name!r}; "
                       f"choose from {sorted(SPACES)}")
    return SPACES[name]


__all__ = ["AXES", "PlanPoint", "PlanSpace", "SPACES", "space_by_name"]
