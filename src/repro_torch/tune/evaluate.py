"""THE sim-evaluation loop: one candidate plan → one ``Measurement``
(the port's own copy of ``repro.tune.evaluate``).

Every consumer of "run a plan against a named trace and read the
numbers" — the tuner's drivers and ``bench_metrics``, the row the
reference's ``benchmarks/bench_plan_space.py`` emits — goes through
``evaluate_plan`` so the loop exists exactly once.  The substrate is
the virtual-time fleet (``fabric.build_sim_fleet``): thousands of
virtual requests per host-millisecond, bit-deterministic per
(plan, trace) pair, which is what makes a 64-eval search cheap and a
same-seed rerun byte-identical.

A plan whose page budget can never grant a worst-case request makes the
simulation raise (``SimWorker``'s never-satisfiable-budget error); the
evaluator converts that into a *degenerate* measurement — zero
throughput, infinite p99, ``feasible=False`` — which every finite point
dominates, so infeasible corners of a space are self-pruning instead of
search-aborting.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.plan import EndpointPlan
from repro_torch.serve.fabric import (build_sim_fleet,
                                      canonical_bursty_trace,
                                      canonical_phased_trace)

#: Named traces a tuner run is keyed by — the repository stores results
#: under these names, so a lookup only ever answers for traffic it was
#: actually tuned against.
TRACES: Dict[str, Callable[[], list]] = {
    "canonical_bursty": canonical_bursty_trace,
    "canonical_phased": lambda: canonical_phased_trace()[0],
}


def trace_by_name(name: str) -> list:
    if name not in TRACES:
        raise KeyError(f"unknown trace {name!r}; "
                       f"choose from {sorted(TRACES)}")
    return TRACES[name]()


@dataclasses.dataclass(frozen=True)
class Measurement:
    """What one sim evaluation measured — the ``FleetReport`` slice the
    tuner, the plan repository, and the bench rows all read."""

    tok_per_s: float
    p50_ms: float
    p99_ms: float
    occupancy: float
    fairness: float
    lock_wait_ns: float
    footprint: float                  # static plan footprint score
    mean_footprint: float             # time-weighted over the run
    completed: int
    n_arrivals: int
    page_hwm_frac: Optional[float] = None
    page_deferrals: int = 0
    feasible: bool = True

    @property
    def objectives(self) -> Tuple[float, float, float]:
        """The 3-objective tuple ``tune.pareto`` ranks: throughput
        (max), tail latency (min), footprint (min)."""
        return (self.tok_per_s, self.p99_ms, self.footprint)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["objectives"] = list(self.objectives)
        return d


def evaluate_plan(plan: EndpointPlan, trace) -> Measurement:
    """Run ``plan`` on the virtual fleet against ``trace`` (a trace
    name from ``TRACES`` or a prebuilt arrival list) and measure it.
    Pure and deterministic: same (plan, trace) → same Measurement."""
    if isinstance(trace, str):
        trace = trace_by_name(trace)
    footprint = plan.footprint_score()
    try:
        router = build_sim_fleet(plan.n_workers, plan,
                                 n_slots=plan.n_slots)
        rep = router.run(trace)
    except ValueError:
        # the plan's page budget can never grant some request: the
        # degenerate point every feasible plan dominates
        return Measurement(
            tok_per_s=0.0, p50_ms=math.inf, p99_ms=math.inf,
            occupancy=0.0, fairness=1.0, lock_wait_ns=0.0,
            footprint=footprint, mean_footprint=footprint,
            completed=0, n_arrivals=len(trace), feasible=False)
    return Measurement(
        tok_per_s=rep.tok_per_s,
        p50_ms=rep.latency_percentile(0.5) / 1e6,
        p99_ms=rep.latency_percentile(0.99) / 1e6,
        occupancy=rep.occupancy,
        fairness=rep.fairness,
        lock_wait_ns=rep.lock_wait_ns,
        footprint=footprint,
        mean_footprint=(rep.mean_footprint if rep.mean_footprint
                        is not None else footprint),
        completed=rep.n_completed,
        n_arrivals=rep.n_arrivals,
        page_hwm_frac=rep.page_hwm_frac,
        page_deferrals=rep.page_deferrals,
        feasible=rep.n_completed == rep.n_arrivals)


def evaluate_vector(vector, trace, *, n_workers: int = 8,
                    n_slots: int = 4, **plan_kwargs) -> Measurement:
    """Convenience wrapper for vector-level sweeps (the plan-space
    bench): wraps the vector in a structural-default ``EndpointPlan``
    and evaluates it — numerically identical to the historical
    ``build_sim_fleet(n_workers, vector, n_slots=...)`` loop."""
    plan = EndpointPlan(vector=vector, n_workers=n_workers,
                        n_slots=n_slots, **plan_kwargs)
    return evaluate_plan(plan, trace)


def bench_metrics(vector, m: Measurement, *, n_workers: int = 8,
                  n_slots: int = 4) -> dict:
    """The exact metrics dict ``benchmarks/bench_plan_space.py`` has
    always emitted for one vector — kept here so the bench is a thin
    shell over the one evaluator and its committed baselines stay
    row-for-row comparable."""
    return {
        "tok_per_s": m.tok_per_s,
        "p50_ms": m.p50_ms,
        "p99_ms": m.p99_ms,
        "occupancy": m.occupancy,
        "fairness": m.fairness,
        "lock_wait_ns": m.lock_wait_ns,
        "footprint": vector.footprint_score(n_workers, n_slots),
        "footprint_per_resource": vector.footprint(n_workers, n_slots),
        "diagonal": vector.is_diagonal,
        "completed": m.completed,
    }


__all__ = ["TRACES", "trace_by_name", "Measurement", "evaluate_plan",
           "evaluate_vector", "bench_metrics"]
