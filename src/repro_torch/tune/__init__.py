"""Plan-space auto-tuning (DESIGN.md §16): the port's own copy of
``repro.tune``, host code in virtual time, held to the reference's
frontiers and repository bytes.

The search layer over everything below it: declarative plan spaces
(``tune.space``), the one sim-evaluation loop (``tune.evaluate``),
seeded deterministic drivers (``tune.search``), the 3-objective Pareto
frontier (``tune.pareto``), and the persisted SQLite plan repository
(``tune.repository``) that ``core.plan.resolve`` and
``core.adapt.Replanner`` consult at serve time.

    from repro_torch.tune import PlanSpace, Tuner, PlanRepository

    result = Tuner(PlanSpace(), driver="anneal", budget_evals=64,
                   seed=0).run()
    with PlanRepository("repo.sqlite", fresh=True) as repo:
        repo.store_front(result.front, traffic=result.trace)
"""

from repro_torch.tune.evaluate import (Measurement, TRACES,
                                       bench_metrics, evaluate_plan,
                                       evaluate_vector, trace_by_name)
from repro_torch.tune.pareto import (FrontierPoint, OBJECTIVES, SENSES,
                                     dominates, pareto_front)
from repro_torch.tune.repository import (PlanRepository, StoredPlan,
                                         measurement_from_json,
                                         measurement_to_json,
                                         plan_from_json, plan_to_json)
from repro_torch.tune.search import (DRIVERS, Tuner, TuneResult, energy,
                                     tune)
from repro_torch.tune.space import (AXES, PlanPoint, PlanSpace, SPACES,
                                    space_by_name)

__all__ = [
    # space
    "AXES", "PlanPoint", "PlanSpace", "SPACES", "space_by_name",
    # evaluate
    "Measurement", "TRACES", "bench_metrics", "evaluate_plan",
    "evaluate_vector", "trace_by_name",
    # pareto
    "FrontierPoint", "OBJECTIVES", "SENSES", "dominates", "pareto_front",
    # search
    "DRIVERS", "Tuner", "TuneResult", "energy", "tune",
    # repository
    "PlanRepository", "StoredPlan", "plan_to_json", "plan_from_json",
    "measurement_to_json", "measurement_from_json",
]
