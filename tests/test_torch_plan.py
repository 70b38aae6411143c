"""The port's planner (``Hints``, ``resolve``, ``EndpointPlan.from_hints``,
``as_plan``), its facade (``connect(plan_repository=...)``,
``ServeClient.replan(Hints)``) and the launcher's ``--hint`` against the
reference's, live.

* ``resolve`` and ``from_hints`` equal the reference's over the
  reference's hypothesis strategies (plus ``memory_budget``), the
  validation raises the same errors, and the level tables are the same.
* ``connect(cfg, Hints(...), plan_repository=<a tuned repository>,
  adaptive=True, n_workers=4)`` on qwen2-0.5b's smoke config at fp32
  serves the reference's tokens with a ``FleetReport`` equal in every
  field: the transitions (repository jumps included), the compile series.
  The repository is each package's own tuner's frontier for the
  4-worker fleet (``tiny``, ``grid``), written to a temporary file.
* ``replan(Hints)`` re-resolves against the fleet shape and the attached
  repository as the reference does; the launcher's ``--hint`` builds the
  reference launcher's plan and refuses what it refuses.
"""

import argparse
import dataclasses

import pytest
from hypothesis import given, settings, strategies as st

import repro.core.plan as jplan
import repro.launch.serve as j_launch
import repro.tune as jtune
import repro_torch.core.plan as tplan
import repro_torch.launch.serve as t_launch
import repro_torch.tune as ttune
from repro import serve as jserve
from repro_torch import serve as tserve
from tests.test_torch_fleet import (MAX_LEN, N_SLOTS, SERVED,
                                    assert_reports_equal, clear_caches,
                                    submit)

#: the reference's strategy (tests/test_plan.py ``HINTS``) as field
#: dicts, with the memory budget the reference's strategy leaves out
HINT_FIELDS = st.builds(
    dict,
    latency_target_ms=st.one_of(st.none(), st.floats(1.0, 5000.0)),
    burstiness=st.floats(0.0, 1.0),
    session_ordering=st.booleans(),
    footprint_budget=st.one_of(st.none(), st.floats(0.2, 1.0)),
    compile_isolation=st.booleans(),
    memory_budget=st.one_of(st.none(), st.floats(0.05, 1.0)))


def _vec(v):
    return dataclasses.astuple(v)


def _plan_dict(p):
    return dataclasses.asdict(p)


@given(fields=HINT_FIELDS, n_workers=st.integers(1, 16),
       n_slots=st.integers(1, 16))
@settings(max_examples=60, deadline=None)
def test_resolve_equals_the_reference(fields, n_workers, n_slots):
    t = tplan.resolve(tplan.Hints(**fields), n_workers=n_workers,
                      n_slots=n_slots)
    j = jplan.resolve(jplan.Hints(**fields), n_workers=n_workers,
                      n_slots=n_slots)
    assert _vec(t) == _vec(j)
    assert _vec(tplan.Hints(**fields).resolve(
        n_workers=n_workers, n_slots=n_slots)) == _vec(j)


@given(fields=HINT_FIELDS, n_workers=st.integers(1, 16),
       n_slots=st.integers(1, 16))
@settings(max_examples=60, deadline=None)
def test_from_hints_and_as_plan_equal_the_reference(fields, n_workers,
                                                    n_slots):
    kw = dict(n_workers=n_workers, n_slots=n_slots, max_len=256)
    t = tplan.EndpointPlan.from_hints(tplan.Hints(**fields), **kw)
    j = jplan.EndpointPlan.from_hints(jplan.Hints(**fields), **kw)
    assert _plan_dict(t) == _plan_dict(j)
    assert _plan_dict(tplan.as_plan(tplan.Hints(**fields), **kw)) == \
        _plan_dict(jplan.as_plan(jplan.Hints(**fields), **kw))


@pytest.mark.parametrize("fields", [
    {"burstiness": 1.5}, {"burstiness": -0.1}, {"latency_target_ms": 0.0},
    {"latency_target_ms": -3.0}, {"footprint_budget": 0.0},
    {"memory_budget": 0.0}, {"memory_budget": 1.5}])
def test_hints_validation_raises_the_reference_errors(fields):
    with pytest.raises(ValueError) as j:
        jplan.Hints(**fields)
    with pytest.raises(ValueError) as t:
        tplan.Hints(**fields)
    assert str(t.value) == str(j.value)


def test_level_tables_equal_the_reference():
    assert tplan._LATENCY_LEVELS == jplan._LATENCY_LEVELS
    assert tplan._MEMORY_LEVELS == jplan._MEMORY_LEVELS
    for ms in (None, 0.5, 49.9, 50.0, 249.0, 250.0, 999.0, 1000.0, 9e9):
        assert tplan._latency_level(ms) == jplan._latency_level(ms)
    for frac in (None, 0.01, 0.25, 0.3, 0.5, 0.7, 1.0):
        assert tplan._pages_level(frac) == jplan._pages_level(frac)
    assert set(jplan.__all__) == set(tplan.__all__)


# ----- the facade ----------------------------------------------------------

HINTS = dict(burstiness=0.9)
ADAPT = dict(adaptive=True, adapt_window_ns=100_000.0)


def _repository(side, path):
    """The side's own tuner's frontier for the 4-worker, 4-slot fleet."""
    pkg = jtune if side == "repro" else ttune
    front = pkg.tune(pkg.space_by_name("tiny"), driver="grid",
                     budget_evals=20, seed=0).front
    repo = pkg.PlanRepository(str(path), fresh=True)
    repo.store_front(front, traffic="canonical_bursty")
    return repo


def _hinted(side, repo, **kw):
    """A 4-worker fleet of the smoke config at fp32, connected with
    ``Hints`` and ``repo``, from cleared caches; -> the client."""
    jcfg, tcfg, jparams, tparams = SERVED["qwen2-0.5b"]()
    clear_caches(side)
    common = dict(plan_repository=repo, n_workers=4, n_slots=N_SLOTS,
                  max_len=MAX_LEN, decode_horizon=8, **kw)
    if side == "repro":
        return jserve.connect(jcfg, jplan.Hints(**HINTS), params=jparams,
                              **common)
    return tserve.connect(tcfg, tplan.Hints(**HINTS), params=tparams,
                          device="cpu", **common)


def _served(client):
    submit(client, "qwen2-0.5b")
    return {rid: list(map(int, t)) for rid, t in client.run().items()}


def test_hinted_adaptive_fleet_with_a_repository_matches_reference(
        tmp_path):
    clients, tokens, start = {}, {}, {}
    for side in ("repro", "port"):
        repo = _repository(side, tmp_path / f"{side}.sqlite")
        clients[side] = _hinted(side, repo, **ADAPT)
        start[side] = clients[side].plan.vector
        tokens[side] = _served(clients[side])
    t_client, j_client = clients["port"], clients["repro"]
    assert tokens["port"] == tokens["repro"]
    assert len(tokens["port"]) == 24 and all(tokens["port"].values())
    # the hints resolved through the repository to a frontier vector
    stored = t_client.plan_repository.frontier_vectors(n_workers=4,
                                                       n_slots=4)
    assert start["port"] in stored
    assert _vec(start["port"]) == _vec(start["repro"])
    assert _plan_dict(t_client.plan) == _plan_dict(j_client.plan)
    rep = t_client.report
    assert rep.transitions and rep.n_windows > 0
    assert_reports_equal(rep, j_client.report)
    assert rep.metrics.total("exec.jit_compiles") == \
        j_client.report.metrics.total("exec.jit_compiles") > 0
    assert [(t, _vec(v)) for t, v in t_client.transitions] == \
        [(t, _vec(v)) for t, v in j_client.transitions]
    # the controller jumped to a frontier plan: more than one level or
    # one axis at once
    path = [_vec(start["port"])] + [_vec(v) for _, v in rep.transitions]
    assert any(sum(abs(a - b) for a, b in zip(u, v)) > 1
               for u, v in zip(path, path[1:]))
    for tw, jw in zip(t_client.workers, j_client.workers):
        assert tw.engine.pool.level == jw.engine.pool.level
        assert tw.engine.exec_group == jw.engine.exec_group


def test_repository_resolution_and_its_escape_hatch(tmp_path):
    """The hints resolve to the repository's best frontier vector; with
    ``use_repository=False`` to the analytic vector, the repository kept
    for the controller."""
    for side, pkg in (("repro", jplan), ("port", tplan)):
        repo = _repository(side, tmp_path / f"{side}.sqlite")
        via = _hinted(side, repo)
        off = _hinted(side, repo, use_repository=False)
        assert via.plan.vector == repo.resolve_hints(
            pkg.Hints(**HINTS), n_workers=4, n_slots=4)
        assert off.plan.vector == pkg.resolve(pkg.Hints(**HINTS),
                                              n_workers=4, n_slots=N_SLOTS)
        assert off.plan_repository is repo
    assert _vec(via.plan.vector) != _vec(off.plan.vector)


def test_replan_hints_re_resolves_against_the_repository(tmp_path):
    """A live ``replan(Hints)`` between two runs: the same new plan as
    the reference (the repository first, the fleet shape kept), then the
    same tokens."""
    got = {}
    for side, pkg in (("repro", jplan), ("port", tplan)):
        repo = _repository(side, tmp_path / f"{side}.sqlite")
        client = _hinted(side, repo, use_repository=False)
        _served(client)
        new = client.replan(pkg.Hints(footprint_budget=0.5,
                                      session_ordering=True))
        assert new.vector == repo.resolve_hints(
            pkg.Hints(footprint_budget=0.5), n_workers=4, n_slots=4)
        assert new.placement == "session_affinity"
        assert new.adapt_budget == 0.5
        got[side] = (_plan_dict(new), _served(client),
                     [(t, _vec(v)) for t, v in client.transitions])
    assert got["port"] == got["repro"]


# ----- the launcher's --hint -----------------------------------------------

def _namespace(**kw):
    base = dict(workers=4, slots=2, max_len=64, decode_horizon=4,
                prefill_buckets="auto", ragged_kernel=False,
                adaptive=False, adapt_window=250.0, roles=None, pages=1,
                page_size=0, page_budget=None, placement=None, plan=None,
                hint=[], category=None, engine=None)
    base.update(kw)
    return argparse.Namespace(**base)


class _Refused(Exception):
    pass


class _Parser:
    def error(self, message):
        raise _Refused(message)


@pytest.mark.parametrize("hint", [
    ["latency_target_ms=80", "burstiness=0.9"],
    ["footprint_budget=0.4", "compile_isolation=yes"],
    ["session_ordering=true", "memory_budget=0.3"],
    ["latency_target_ms=5000"]])
@pytest.mark.parametrize("workers", [1, 4])
def test_launcher_hint_builds_the_reference_plan(hint, workers):
    args = _namespace(hint=hint, workers=workers)
    t = t_launch.build_plan(args, _Parser())
    j = j_launch.build_plan(args, _Parser())
    assert _plan_dict(t) == _plan_dict(j)
    assert t.resolved_executor == j.resolved_executor


@pytest.mark.parametrize("kw", [
    dict(plan="dynamic", hint=["burstiness=1"]),
    dict(category="static", hint=["burstiness=1"]),
    dict(engine="wave", hint=["burstiness=1"]),
    dict(hint=["bogus=1"]),
    dict(hint=["burstiness=2"]),
    dict(hint=["latency_target_ms=0"])],
    ids=["plan", "category", "engine", "unknown", "burstiness", "latency"])
def test_launcher_hint_refuses_what_the_reference_refuses(kw):
    args = _namespace(**kw)
    with pytest.raises(_Refused) as j:
        j_launch.build_plan(args, _Parser())
    with pytest.raises(_Refused) as t:
        t_launch.build_plan(args, _Parser())
    assert str(t.value) == str(j.value)


def test_launcher_serves_a_hinted_fleet_on_the_cpu(capsys):
    t_launch.main(["--smoke", "--device", "cpu", "--max-len", "64",
                   "--prompt-len", "8", "--max-new", "6",
                   "--decode-horizon", "4", "--slots", "2", "--workers",
                   "4", "--requests", "8", "--hint",
                   "latency_target_ms=80", "--hint", "burstiness=0.9"])
    out = capsys.readouterr().out
    label = jplan.resolve(jplan.Hints(latency_target_ms=80,
                                      burstiness=0.9),
                          n_workers=4, n_slots=2).label
    assert f"vector {label}" in out and "8/8 requests" in out, out
