"""Plan-space auto-tuner launcher (DESIGN.md §16), the port's own copy of
``repro.launch.tune``.

Search a named ``PlanSpace`` with a seeded driver on the virtual-time
fleet, print the Pareto frontier, and optionally persist it into a
SQLite plan repository that ``serve.connect(hints, plan_repository=…)``
consults at serve time:

  # 64-eval annealing search on the canonical bursty trace
  PYTHONPATH=src python -m repro_torch.launch.tune --space sharing \
      --driver anneal --budget-evals 64 --seed 0 --out repo.sqlite

  # exhaustive grid over the CI smoke space
  PYTHONPATH=src python -m repro_torch.launch.tune --space tiny --driver grid \
      --budget-evals 20

The whole run is deterministic: the same (space, driver, trace, seed,
budget) prints the same frontier and — with ``--out`` — writes a
byte-identical repository file.
"""

from __future__ import annotations

import argparse
import json
import time

from repro_torch.tune import (DRIVERS, PlanRepository, SPACES, TRACES,
                              Tuner, space_by_name)


def format_front(result) -> str:
    lines = [f"{'rank':>4} {'plan':<12} {'tok/s':>10} {'p99_ms':>8} "
             f"{'footprint':>9} {'p50_ms':>8} {'occ':>5}"]
    for rank, p in enumerate(result.front):
        m = p.measurement
        lines.append(
            f"{rank:>4} {p.plan.vector.label:<12} "
            f"{p.tok_per_s:>10.0f} {p.p99_ms:>8.2f} "
            f"{p.footprint:>9.3f} {m.p50_ms:>8.2f} {m.occupancy:>5.2f}")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Pareto-front search over the serving plan space")
    ap.add_argument("--space", default="sharing",
                    choices=sorted(SPACES),
                    help="named PlanSpace to search (default: sharing)")
    ap.add_argument("--driver", default="anneal", choices=DRIVERS,
                    help="search driver (default: anneal)")
    ap.add_argument("--budget-evals", type=int, default=64,
                    help="max unique plan simulations (default: 64)")
    ap.add_argument("--seed", type=int, default=0,
                    help="driver seed — the whole run is a pure "
                         "function of it (default: 0)")
    ap.add_argument("--trace", default="canonical_bursty",
                    choices=sorted(TRACES),
                    help="named traffic trace to evaluate against")
    ap.add_argument("--model", default="sim",
                    help="model-config tag the repository keys plans "
                         "under (default: sim — the virtual fleet)")
    ap.add_argument("--out", default=None, metavar="repo.sqlite",
                    help="persist the frontier into this plan "
                         "repository (file is rewritten fresh for "
                         "byte-reproducibility)")
    ap.add_argument("--json", action="store_true",
                    help="emit the frontier as JSON instead of a table")
    args = ap.parse_args(argv)

    space = space_by_name(args.space)
    tuner = Tuner(space, trace=args.trace, driver=args.driver,
                  budget_evals=args.budget_evals, seed=args.seed)
    t0 = time.perf_counter()
    result = tuner.run()
    dt = time.perf_counter() - t0

    if args.json:
        print(json.dumps({
            "space": args.space, "driver": args.driver,
            "trace": args.trace, "seed": args.seed,
            "budget_evals": args.budget_evals,
            "n_evals": result.n_evals,
            "front": [{"plan": p.plan.vector.label,
                       "tok_per_s": p.tok_per_s, "p99_ms": p.p99_ms,
                       "footprint": p.footprint,
                       "measurement": p.measurement.as_dict()}
                      for p in result.front]}, indent=2))
    else:
        print(f"space={args.space} driver={args.driver} "
              f"trace={args.trace} seed={args.seed} "
              f"evals={result.n_evals}/{args.budget_evals} "
              f"({dt * 1e3:.0f} ms host)")
        print(format_front(result))

    if args.out:
        with PlanRepository(args.out, fresh=True) as repo:
            written = repo.store_front(result.front, traffic=args.trace,
                                      model=args.model)
        print(f"wrote {written} frontier plan(s) -> {args.out}")
    return result


if __name__ == "__main__":
    main()
