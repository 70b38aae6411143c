"""Seeded, fully deterministic search drivers over a ``PlanSpace``
(the port's own copy of ``repro.tune.search``).

Three drivers, one evaluation loop (``tune.evaluate``), one frontier
(``tune.pareto``):

* **grid** — exhaust the space in its canonical ``points()`` order
  until the eval budget runs out.  Complete for small spaces; the
  reference the stochastic drivers are tested against.
* **random** — uniform seeded sampling (``numpy`` ``default_rng``).
  Duplicate draws hit the eval cache and cost nothing, so the budget
  counts *unique simulations*, not draws.
* **anneal** — simulated annealing whose move set is the space's
  ``neighbors()`` (single-axis steps to adjacent values — hill-climbing
  along one sharing axis at a time, the ``benchmarks/hillclimb.py``
  shape with an acceptance temperature on top).  Energy scalarizes the
  three objectives; the temperature decays geometrically with *budget
  consumed*, so the schedule is a pure function of how many unique
  evaluations have been paid for.

Every driver is a pure function of ``(space, trace, seed, budget)``:
no wall clock, no global RNG — the property the same-seed ⇒ identical
frontier tests (and the repository's byte-identical SQLite guarantee)
stand on.  The frontier is computed over EVERY evaluation the run paid
for, not just the driver's final position: a rejected annealing move is
still a measured point and may well be Pareto-optimal.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.plan import EndpointPlan
from repro_torch.tune.evaluate import Measurement, evaluate_plan, trace_by_name
from repro_torch.tune.pareto import FrontierPoint, pareto_front
from repro_torch.tune.space import PlanPoint, PlanSpace

DRIVERS = ("grid", "random", "anneal")


def energy(m: Measurement) -> float:
    """Scalarized objectives for the annealing walk (lower = better):
    log-throughput dominates, tail latency and footprint temper it.
    Infeasible points are infinitely hot — the walk never settles on
    one.  Used ONLY to steer the walk; the returned frontier is ranked
    by true dominance, never by this scalar."""
    if not m.feasible or m.tok_per_s <= 0.0:
        return math.inf
    return (-math.log(m.tok_per_s)
            + 0.25 * math.log(max(m.p99_ms, 1e-9))
            + 0.5 * m.footprint)


@dataclasses.dataclass
class TuneResult:
    """One search run: every evaluation it paid for (in evaluation
    order) and the Pareto frontier over them."""

    space: PlanSpace
    trace: str
    driver: str
    seed: int
    budget_evals: int
    evals: List[Tuple[PlanPoint, Measurement]]
    front: List[FrontierPoint]

    @property
    def n_evals(self) -> int:
        return len(self.evals)

    def frontier_plans(self) -> List[EndpointPlan]:
        return [p.plan for p in self.front]

    def best_by(self, objective: str) -> FrontierPoint:
        """The frontier point winning one objective outright
        (deterministic: the frontier order already tie-breaks)."""
        idx = {"tok_per_s": 0, "p99_ms": 1, "footprint": 2}[objective]
        sense = (-1, +1, +1)[idx]
        return min(self.front, key=lambda p: sense * p.objectives[idx])


class Tuner:
    """Driver harness: owns the eval cache and budget accounting.

    ``budget_evals`` caps *unique* plan simulations; re-visiting a
    cached point is free.  ``run()`` is deterministic per
    (space, trace, driver, seed, budget)."""

    def __init__(self, space: PlanSpace, *,
                 trace: str = "canonical_bursty",
                 driver: str = "random", budget_evals: int = 32,
                 seed: int = 0, anneal_t0: float = 1.0,
                 anneal_t_final: float = 0.05):
        if driver not in DRIVERS:
            raise ValueError(f"driver must be one of {DRIVERS}, "
                             f"got {driver!r}")
        if budget_evals < 1:
            raise ValueError("budget_evals must be >= 1")
        self.space = space
        self.trace_name = trace
        self._trace = trace_by_name(trace)
        self.driver = driver
        self.budget_evals = budget_evals
        self.seed = seed
        self.anneal_t0 = anneal_t0
        self.anneal_t_final = anneal_t_final
        self._cache: Dict[PlanPoint, Measurement] = {}
        self._order: List[PlanPoint] = []

    # ----- budgeted evaluation -------------------------------------------
    def evals_left(self) -> int:
        return self.budget_evals - len(self._cache)

    def _eval(self, point: PlanPoint) -> Optional[Measurement]:
        """Measure ``point``, paying budget only for cache misses; None
        when the budget is exhausted (drivers stop cleanly)."""
        hit = self._cache.get(point)
        if hit is not None:
            return hit
        if self.evals_left() <= 0:
            return None
        m = evaluate_plan(self.space.build(point), self._trace)
        self._cache[point] = m
        self._order.append(point)
        return m

    # ----- drivers --------------------------------------------------------
    def _run_grid(self, rng) -> None:
        for point in self.space.points():
            if self._eval(point) is None:
                break

    def _run_random(self, rng) -> None:
        tries = 0
        while self.evals_left() > 0 and tries < 50 * self.budget_evals:
            tries += 1
            self._eval(self.space.sample(rng))

    def _run_anneal(self, rng) -> None:
        cur = self.space.sample(rng)
        cur_m = self._eval(cur)
        steps = 0
        while cur_m is not None and self.evals_left() > 0 \
                and steps < 40 * self.budget_evals:
            steps += 1
            nbrs = list(self.space.neighbors(cur))
            if not nbrs:
                break
            nxt = nbrs[int(rng.integers(len(nbrs)))]
            # geometric cooling over budget CONSUMED — the schedule is a
            # pure function of paid evaluations, not of step count, so
            # cache hits neither stall nor rush it
            frac = len(self._cache) / self.budget_evals
            temp = self.anneal_t0 * (
                self.anneal_t_final / self.anneal_t0) ** min(1.0, frac)
            m = self._eval(nxt)
            if m is None:
                break
            e_cur, e_nxt = energy(cur_m), energy(m)
            if not math.isfinite(e_nxt):
                continue              # never walk onto an infeasible point
            if e_nxt <= e_cur:
                cur, cur_m = nxt, m
            elif float(rng.random()) < math.exp(-(e_nxt - e_cur) / temp):
                cur, cur_m = nxt, m

    # ----- run ------------------------------------------------------------
    def run(self) -> TuneResult:
        rng = np.random.default_rng(self.seed)
        {"grid": self._run_grid, "random": self._run_random,
         "anneal": self._run_anneal}[self.driver](rng)
        if not self._cache:
            raise ValueError("the search evaluated nothing — empty or "
                             "fully pruned space?")
        evals = [(p, self._cache[p]) for p in self._order]
        candidates = [(p, m) for p, m in evals if m.feasible]
        if not candidates:
            candidates = evals        # all-infeasible: report as-is
        front = pareto_front([
            FrontierPoint(plan=self.space.build(p),
                          objectives=m.objectives, measurement=m)
            for p, m in candidates])
        return TuneResult(space=self.space, trace=self.trace_name,
                          driver=self.driver, seed=self.seed,
                          budget_evals=self.budget_evals,
                          evals=evals, front=front)


def tune(space: PlanSpace, **kwargs) -> TuneResult:
    """One-call convenience: ``tune(space, driver=..., seed=...)``."""
    return Tuner(space, **kwargs).run()


__all__ = ["DRIVERS", "energy", "TuneResult", "Tuner", "tune"]
