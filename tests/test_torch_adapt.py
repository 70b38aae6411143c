"""The port's adaptive controller and plan accounting against the
reference's, live, and the exec groups of its engines.

* ``Replanner``: fed the same ``WindowStats`` sequence as ``repro``'s
  (seeded random telemetry, bursts, idle stretches, constant pressure),
  under every knob the serving stack sets (budget, paged, patience,
  cooldown, window), it proposes the same vectors in the same windows,
  and reads the same pressures and footprints.
* ``SharingVector`` labels, categories, footprints and ``fit_budget``
  over every vector of the plan space; ``EndpointModel``'s Table-1
  usage for every category.
* ``ExecGroup``: engines of one exec group share one group object (one
  graph memory pool on the card), so ``EngineWorker.compile_probe``
  reports one key at exec level 4 and N keys at level 1; ``regroup``
  moves an engine to another group and keeps its graphs.
"""

import dataclasses
import itertools

import numpy as np
import pytest

from repro.core.adapt import Replanner as JReplanner
from repro.core.adapt import WindowStats as JStats
from repro.core.endpoints import Category as JCategory
from repro.core.endpoints import EndpointModel as JModelE
from repro.core.plan import SharingVector as JVector
from repro.core.plan import fit_budget as j_fit
from repro_torch import serve as tserve
from repro_torch.core.adapt import Replanner as TReplanner
from repro_torch.core.adapt import WindowStats as TStats
from repro_torch.core.endpoints import Category as TCategory
from repro_torch.core.endpoints import EndpointModel as TModelE
from repro_torch.core.plan import SharingVector as TVector
from repro_torch.core.plan import fit_budget as t_fit
from repro_torch.serve.engine import shared_exec_group
from tests import test_torch_engine as qwen2

ALL_LEVELS = list(itertools.product(range(1, 5), repeat=4))


def _telemetry(seed: int, n: int):
    """A seeded window sequence: bursts, idle stretches, page pressure
    and compile spikes, as dicts of ``WindowStats`` fields."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        phase = (i // 6) % 3            # busy, idle, mixed
        busy = phase == 0 or (phase == 2 and rng.random() < 0.5)
        out.append(dict(
            occupancy=float(rng.uniform(0.6, 1.0) if busy
                            else rng.uniform(0.0, 0.2)),
            queue_depth=float(rng.integers(0, 6) if busy else 0),
            lock_wait_ns=float(rng.integers(0, 5000)),
            p99_ms=float(rng.uniform(0.0, 3.0)),
            jit_compiles=int(rng.integers(0, 6) if rng.random() < 0.3
                             else 0),
            tokens=int(rng.integers(0, 200)),
            page_pressure=float(rng.uniform(0.5, 1.0) if busy
                                else rng.uniform(0.0, 0.1))))
    return out


CONFIGS = [
    dict(),
    dict(budget=0.6),
    dict(budget=0.35, paged=True),
    dict(paged=True, patience=2, demote_patience=2, cooldown=0),
    dict(window=4, hi=0.8, lo=0.1, depth_scale=3.0, compile_scale=2.0),
    dict(n_workers=8, n_slots=8, budget=0.5),
]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("cfg", range(len(CONFIGS)))
@pytest.mark.parametrize("start", ["diag1", "diag2", "diag4", "s1c3e4p2"])
def test_replanner_proposes_the_reference_vectors(start, cfg, seed):
    kw = dict(n_workers=4, n_slots=4)
    kw.update(CONFIGS[cfg])

    def vec(cls):
        if start.startswith("diag"):
            return cls.diagonal(int(start[4:]))
        return cls(slots=1, channels=3, execs=4, pages=2)

    t = TReplanner(vec(TVector), **kw)
    j = JReplanner(vec(JVector), **kw)
    assert dataclasses.astuple(t.vector) == dataclasses.astuple(j.vector)
    for window in _telemetry(seed, 60):
        t_prop = t.observe(TStats(**window))
        j_prop = j.observe(JStats(**window))
        assert (t_prop is None) == (j_prop is None)
        if t_prop is not None:
            assert dataclasses.astuple(t_prop) == \
                dataclasses.astuple(j_prop)
        assert t.pressures() == j.pressures()
        assert t.footprint_score() == j.footprint_score()
    assert [(w, dataclasses.astuple(v)) for w, v in t.transitions] == \
        [(w, dataclasses.astuple(v)) for w, v in j.transitions]
    assert t.max_windows_to_reach() == j.max_windows_to_reach()
    assert repr(t) == repr(j)


@pytest.mark.parametrize("pressure", [0.0, 0.1, 0.5, 0.9, 1.0])
def test_constant_telemetry_matches_reference(pressure):
    """A constant window, many times: the same monotone trajectory."""
    t = TReplanner(TVector.diagonal(2), n_workers=4, n_slots=4, paged=True)
    j = JReplanner(JVector.diagonal(2), n_workers=4, n_slots=4, paged=True)
    w = dict(occupancy=pressure, queue_depth=2 * pressure,
             jit_compiles=int(4 * pressure), page_pressure=pressure)
    for _ in range(30):
        t.observe(TStats(**w))
        j.observe(JStats(**w))
    assert dataclasses.astuple(t.vector) == dataclasses.astuple(j.vector)
    assert len(t.transitions) == len(j.transitions)


def test_replanner_validation_matches_reference():
    for kw in (dict(lo=0.8, hi=0.2), dict(window=0), dict(budget=-1.0),
               dict(cooldown=-1)):
        with pytest.raises(ValueError) as t_err:
            TReplanner(TVector(), **kw)
        with pytest.raises(ValueError) as j_err:
            JReplanner(JVector(), **kw)
        assert str(t_err.value) == str(j_err.value)


@pytest.mark.parametrize("n_workers,n_slots", [(1, 4), (4, 4), (8, 8)])
def test_plan_accounting_matches_reference(n_workers, n_slots):
    for levels in ALL_LEVELS:
        t, j = TVector(*levels), JVector(*levels)
        assert (t.label, t.is_diagonal) == (j.label, j.is_diagonal)
        assert (t.category and t.category.value) == \
            (j.category and j.category.value)
        assert t.footprint(n_workers, n_slots) == \
            j.footprint(n_workers, n_slots)
        assert t.footprint_score(n_workers, n_slots) == \
            j.footprint_score(n_workers, n_slots)
        assert [t.exec_group_of(w, n_workers) for w in range(n_workers)] \
            == [j.exec_group_of(w, n_workers) for w in range(n_workers)]
        for budget in (None, 0.25, 0.4, 0.6, 0.9):
            assert dataclasses.astuple(t_fit(t, budget, n_workers=n_workers,
                                             n_slots=n_slots)) == \
                dataclasses.astuple(j_fit(j, budget, n_workers=n_workers,
                                          n_slots=n_slots))


@pytest.mark.parametrize("n_threads", [1, 4, 16])
def test_endpoint_model_usage_matches_reference(n_threads):
    for cat in JCategory:
        t = TModelE.build(TCategory(cat.value), n_threads)
        j = JModelE.build(cat, n_threads)
        assert t.relative_usage() == j.relative_usage()
        assert dataclasses.astuple(t.usage) == dataclasses.astuple(j.usage)
        assert [dataclasses.astuple(p) for p in t.paths] == \
            [dataclasses.astuple(p) for p in j.paths]


# ----- exec groups ----------------------------------------------------------

def _fleet(execs: int, n_workers: int = 4):
    _, tcfg, _, tparams = qwen2._served()
    client = tserve.connect(tcfg, TVector(execs=execs), params=tparams,
                            n_workers=n_workers, n_slots=2, max_len=32,
                            decode_horizon=4, device="cpu")
    client.generate([np.arange(1, 6, dtype=np.int32)], 3)
    return client


@pytest.mark.parametrize("execs,keys", [(4, 1), (3, 1), (2, 2), (1, 4)])
def test_compile_probe_keys_follow_the_execs_level(execs, keys):
    """One exec group (one probe key, one graph memory pool on the card)
    per execs group of the fleet: one at level 4, N at level 1.  A probe
    reads its group's specializations, and the fleet counts each group
    once; on the CPU nothing is captured, so every graph count is 0."""
    client = _fleet(execs)
    probes = [w.compile_probe() for w in client.workers]
    assert len({key for key, _ in probes}) == keys
    assert [count for _, count in probes] == \
        [w.engine.group.compile_count() for w in client.workers]
    assert [w.engine.graph_count() for w in client.workers] == [0] * 4
    groups = {id(w.engine.group): w.engine.group for w in client.workers}
    assert len(groups) == keys
    assert [w.engine.exec_group for w in client.workers] == \
        [client.plan.exec_group_of(w) for w in range(4)]
    assert client.report.metrics.total("exec.jit_compiles") == \
        sum(g.compile_count() for g in groups.values()) > 0


def test_exec_groups_are_keyed_like_the_reference_steps():
    """(config, use_ragged_kernel, group id, device): the same key gives
    the same group object across engines and clients, any part of it
    another group."""
    _, tcfg, _, _ = qwen2._served()
    import torch
    cpu = torch.device("cpu")
    g = shared_exec_group(tcfg, True, 0, cpu)
    assert shared_exec_group(tcfg, True, 0, cpu) is g
    assert shared_exec_group(tcfg, False, 0, cpu) is not g
    assert shared_exec_group(tcfg, True, 1, cpu) is not g
    other = dataclasses.replace(tcfg, n_layers=tcfg.n_layers + 1)
    assert shared_exec_group(other, True, 0, cpu) is not g
    a, b = _fleet(4), _fleet(4)
    assert a.workers[0].engine.group is b.workers[3].engine.group


def test_regroup_moves_an_engine_between_groups_and_keeps_its_graphs():
    client = _fleet(1)
    eng = client.workers[2].engine
    graphs, old = eng._horizons, eng.group
    assert eng.regroup(exec_group=0)
    assert eng.group is client.workers[0].engine.group is not old
    assert eng._horizons is graphs and graphs.group is eng.group
    assert eng.graph_count() == 0
    assert eng.compile_count() == eng.group.compile_count()
    client.replan(TVector(execs=4))
    assert len({id(w.engine.group) for w in client.workers}) == 1
    assert len({w.compile_probe()[0] for w in client.workers}) == 1
