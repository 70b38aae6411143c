"""The port's plan tuner (``repro_torch.tune``, ``launch/tune.py``)
against the reference's, live.

The tuner is host code in virtual time (the sim fleet of
``serve.fabric``), seeded by ``np.random.default_rng``, so the port is
held to exact equality:

* every named space enumerates the same points in the same order;
* each driver's frontier equals the reference's point by point (the
  plan's canonical JSON, the measurement, the objectives), with the
  evaluations it paid for: ``grid`` and ``random`` on ``tiny``,
  ``anneal`` on ``sharing`` with a small budget, for seeds 0 and 1;
* ``launch/tune.py --out`` writes the reference launcher's bytes (both
  files written in this process, with the same sqlite);
* a copy of the committed repository resolves ``Hints()`` for the
  canonical 8-worker, 4-slot fleet to the same frontier vector in both
  packages (never the committed file itself: opening a repository
  writes to it);
* ``resolve_hints`` and ``frontier_vectors`` answer alike, and a
  repository-guided ``Replanner`` takes the reference's transitions.
"""

import dataclasses
import shutil
from pathlib import Path

import numpy as np
import pytest

import repro.tune as jtune
import repro_torch.tune as ttune
from repro.core.adapt import Replanner as JReplanner
from repro.core.adapt import WindowStats as JStats
from repro.core.plan import Hints as JHints
from repro.core.plan import SharingVector as JVector
from repro.core.plan import resolve as j_resolve
from repro.launch import tune as j_launch
from repro_torch.core.adapt import Replanner as TReplanner
from repro_torch.core.adapt import WindowStats as TStats
from repro_torch.core.plan import Hints as THints
from repro_torch.core.plan import SharingVector as TVector
from repro_torch.core.plan import resolve as t_resolve
from repro_torch.launch import tune as t_launch

ROOT = Path(__file__).resolve().parents[1]
COMMITTED = ROOT / "benchmarks" / "baselines" / "plan_repo.sqlite"


def _point(pkg, p):
    """A frontier point as plain data: the plan's canonical JSON, the
    measurement and the objectives."""
    return (pkg.plan_to_json(p.plan), p.measurement.as_dict(),
            tuple(p.objectives))


def _evals(result):
    return [(dataclasses.astuple(pt), m.as_dict()) for pt, m in result.evals]


def test_exports_match_the_reference():
    assert sorted(ttune.__all__) == sorted(jtune.__all__)
    assert ttune.AXES == jtune.AXES
    assert ttune.OBJECTIVES == jtune.OBJECTIVES
    assert ttune.SENSES == jtune.SENSES
    assert ttune.DRIVERS == jtune.DRIVERS
    assert sorted(ttune.TRACES) == sorted(jtune.TRACES)


@pytest.mark.parametrize("name", sorted(jtune.SPACES))
def test_every_space_enumerates_the_reference_points(name):
    j = list(jtune.space_by_name(name).points())
    t = list(ttune.space_by_name(name).points())
    assert len(t) == len(j) > 0
    assert [dataclasses.astuple(p) for p in t] == \
        [dataclasses.astuple(p) for p in j]


def test_space_sampling_and_neighbors_follow_the_reference_rng():
    for name in ("tiny", "sharing", "paged"):
        js, ts = jtune.space_by_name(name), ttune.space_by_name(name)
        jr, tr = np.random.default_rng(7), np.random.default_rng(7)
        for _ in range(5):
            jp, tp = js.sample(jr), ts.sample(tr)
            assert dataclasses.astuple(tp) == dataclasses.astuple(jp)
            assert [dataclasses.astuple(n) for n in ts.neighbors(tp)] == \
                [dataclasses.astuple(n) for n in js.neighbors(jp)]


#: (space, driver, budget): grid and random on the CI smoke space,
#: anneal on the sharing cube with a small budget
RUNS = [("tiny", "grid", 20), ("tiny", "random", 5),
        ("sharing", "anneal", 24)]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("space,driver,budget", RUNS,
                         ids=[f"{s}-{d}" for s, d, _ in RUNS])
def test_each_driver_s_frontier_equals_the_reference(space, driver, budget,
                                                     seed):
    j = jtune.Tuner(jtune.space_by_name(space), driver=driver,
                    budget_evals=budget, seed=seed).run()
    t = ttune.Tuner(ttune.space_by_name(space), driver=driver,
                    budget_evals=budget, seed=seed).run()
    assert t.n_evals == j.n_evals
    assert _evals(t) == _evals(j)
    assert len(t.front) == len(j.front) > 0
    for tp, jp in zip(t.front, j.front):
        assert _point(ttune, tp) == _point(jtune, jp)
    for obj in ttune.OBJECTIVES:
        assert _point(ttune, t.best_by(obj)) == \
            _point(jtune, j.best_by(obj))


def test_evaluate_and_pareto_equal_the_reference():
    """One plan on each canonical trace, and the frontier filter over
    the same objective tuples."""
    for trace in sorted(jtune.TRACES):
        for vec in ((1, 1, 4, 1), (2, 3, 4, 1), (4, 4, 1, 1)):
            j = jtune.evaluate_vector(JVector(*vec), trace=trace,
                                      n_workers=4)
            t = ttune.evaluate_vector(TVector(*vec), trace=trace,
                                      n_workers=4)
            assert t.as_dict() == j.as_dict()
            assert ttune.bench_metrics(TVector(*vec), t, n_workers=4) == \
                jtune.bench_metrics(JVector(*vec), j, n_workers=4)
    rng = np.random.default_rng(3)
    objs = [tuple(float(x) for x in rng.integers(0, 5, 3))
            for _ in range(40)]
    for a in objs[:8]:
        for b in objs[:8]:
            assert ttune.dominates(a, b) == jtune.dominates(a, b)


ARGS = [["--space", "tiny", "--driver", "grid", "--budget-evals", "20"],
        ["--space", "sharing", "--driver", "anneal", "--budget-evals", "8",
         "--seed", "1", "--trace", "canonical_phased", "--model", "m"]]


@pytest.mark.parametrize("args", ARGS, ids=["tiny-grid", "sharing-anneal"])
def test_launcher_writes_the_reference_repository_bytes(args, tmp_path,
                                                        capsys):
    paths = {}
    for side, launch in (("repro", j_launch), ("port", t_launch)):
        paths[side] = tmp_path / f"{side}.sqlite"
        launch.main(args + ["--out", str(paths[side])])
    out = capsys.readouterr().out
    assert paths["port"].read_bytes() == paths["repro"].read_bytes()
    # the same frontier table, but for the host time of each run
    tables = [block.split("\n", 1)[1].split("wrote")[0]
              for block in out.split("space=")[1:]]
    assert len(tables) == 2 and tables[0] == tables[1]


def test_committed_repository_copy_resolves_alike(tmp_path):
    copies = {}
    for side in ("repro", "port"):
        copies[side] = tmp_path / f"{side}.sqlite"
        shutil.copyfile(COMMITTED, copies[side])
    with jtune.PlanRepository(str(copies["repro"])) as jrepo, \
            ttune.PlanRepository(str(copies["port"])) as trepo:
        assert trepo.keys() == jrepo.keys() == \
            [("canonical_bursty", "sim", 8, 4)]
        stored = trepo.frontier_vectors(n_workers=8, n_slots=4)
        assert [dataclasses.astuple(v) for v in stored] == \
            [dataclasses.astuple(v) for v in jrepo.frontier_vectors(
                n_workers=8, n_slots=4)]
        t = t_resolve(THints(), n_workers=8, n_slots=4, repository=trepo)
        j = j_resolve(JHints(), n_workers=8, n_slots=4, repository=jrepo)
        assert t in stored
        assert dataclasses.astuple(t) == dataclasses.astuple(j)
        for hints in ({"footprint_budget": 0.4},
                      {"latency_target_ms": 2.0},
                      {"compile_isolation": True},
                      {"latency_target_ms": 50.0, "burstiness": 0.9}):
            tv = trepo.resolve_hints(THints(**hints), n_workers=8,
                                     n_slots=4)
            jv = jrepo.resolve_hints(JHints(**hints), n_workers=8,
                                     n_slots=4)
            assert (tv and dataclasses.astuple(tv)) == \
                (jv and dataclasses.astuple(jv)), hints
        assert [(sp.rank, ttune.plan_to_json(sp.plan),
                 ttune.measurement_to_json(sp.measurement))
                for sp in trepo.lookup()] == \
            [(sp.rank, jtune.plan_to_json(sp.plan),
              jtune.measurement_to_json(sp.measurement))
             for sp in jrepo.lookup()]


def test_repository_guided_replanner_takes_the_reference_transitions(
        tmp_path):
    """Both controllers on a repository of the same tuned frontier (4
    workers), fed the same telemetry: the same vectors at every window,
    repository jumps included."""
    repos = {}
    for side, pkg in (("repro", jtune), ("port", ttune)):
        front = pkg.tune(pkg.space_by_name("tiny"), driver="grid",
                         budget_evals=20, seed=0).front
        repos[side] = pkg.PlanRepository(str(tmp_path / f"{side}.sqlite"),
                                         fresh=True)
        repos[side].store_front(front, traffic="canonical_bursty")
    rng = np.random.default_rng(5)
    stats = [dict(occupancy=float(rng.random()),
                  queue_depth=float(rng.integers(0, 12)),
                  lock_wait_ns=float(rng.integers(0, 4000)),
                  jit_compiles=int(rng.integers(0, 3)))
             for _ in range(60)]
    jr = JReplanner(JVector(2, 2, 4, 1), n_workers=4, n_slots=4,
                    repository=repos["repro"])
    tr = TReplanner(TVector(2, 2, 4, 1), n_workers=4, n_slots=4,
                    repository=repos["port"])
    path = []
    for s in stats:
        jv, tv = jr.observe(JStats(**s)), tr.observe(TStats(**s))
        assert (tv and dataclasses.astuple(tv)) == \
            (jv and dataclasses.astuple(jv))
        if tv is not None:
            path.append(dataclasses.astuple(tv))
    # a repository jump: more than one level or one axis at once
    steps = zip([(2, 2, 4, 1)] + path, path)
    assert any(sum(abs(a - b) for a, b in zip(u, v)) > 1 for u, v in steps)
    for repo in repos.values():
        repo.close()
