"""Live re-planning on one engine: the port's ``ContinuousEngine.regroup``
and ``ServeClient.replan`` against the JAX reference's, live, on the
same weights and requests (CPU, fp32 compute: greedy tokens exact), and
the two repairs of ``connect``'s validation.

* Regrouping slots and pages mid-stream leaves the tokens unchanged and
  matches the reference's schedule and ``stats``; a page regroup on a
  contiguous engine raises ``ValueError``; an exec-group regroup records
  the group id and keeps the engine's horizon graphs.
* ``replan`` between runs serves the reference's tokens and transitions;
  it refuses structural fields and layout flips (``ValueError``), planner
  hints (``NotImplementedError``, the planner slice) and the wave
  executor (``ValueError``); ``replan(None, adaptive=True)`` turns the
  controller on for the next run, as in the reference.
* An unknown ``placement`` and faults, recovery or migrations on a
  single-engine plan raise ``ValueError``, as in the reference; a fleet
  plan accepts them.
"""

import dataclasses

import pytest

from repro import serve as jserve
from repro.core.plan import EndpointPlan as JPlan
from repro.core.plan import Hints
from repro.core.plan import SharingVector as JVector
from repro.serve.engine import ContinuousEngine as JEngine
from repro.serve.engine import Request as JRequest
from repro_torch import serve as tserve
from repro_torch.core.plan import EndpointPlan as TPlan
from repro_torch.core.plan import SharingVector as TVector
from repro_torch.obs import enabled_obs
from repro_torch.serve.engine import ContinuousEngine as TEngine
from repro_torch.serve.engine import Request as TRequest
from tests import test_torch_engine as qwen2

SIDES = {"repro": (JEngine, JRequest, JPlan, JVector),
         "port": (TEngine, TRequest, TPlan, TVector)}


def _engine(side, pages, horizon):
    eng_cls, _, plan_cls, vec_cls = SIDES[side]
    jcfg, tcfg, jparams, tparams = qwen2._served()
    plan = qwen2._plan(plan_cls, vec_cls, horizon, pages)
    if side == "repro":
        return eng_cls(jcfg, jparams, plan=plan)
    return eng_cls(tcfg, tparams, plan=plan, device="cpu")


def _regrouped(side, pages, horizon):
    """The parity requests, with the slot level moved 1 -> 2 (and the
    page level 4 -> 2 on the paged engine) after two admission rounds."""
    eng = _engine(side, pages, horizon)
    req_cls = SIDES[side][1]
    for rid, (prompt, max_new, eos) in enumerate(qwen2._specs()):
        eng.submit(req_cls(rid=rid, prompt=prompt, max_new_tokens=max_new,
                           eos_id=eos))
    eng.start()
    for _ in range(2):
        eng.admit_waiting()
        eng.step()
    assert eng.regroup(slot_level=2, page_level=2 if pages else None)
    assert not eng.regroup(slot_level=2, page_level=2 if pages else None)
    done = {r.rid: list(r.output) for r in eng.run()}
    return done, eng


@pytest.mark.parametrize("pages", [False, True], ids=["contiguous", "pages4"])
@pytest.mark.parametrize("horizon", [1, 4])
def test_regroup_mid_stream_keeps_tokens_and_matches_reference(pages,
                                                               horizon):
    expect, j_eng = _regrouped("repro", pages, horizon)
    got, t_eng = _regrouped("port", pages, horizon)
    assert got == expect == qwen2._reference(horizon, pages)[0][0]
    assert t_eng.admit_order == j_eng.admit_order
    assert t_eng.admit_steps == j_eng.admit_steps
    assert t_eng.retire_steps == j_eng.retire_steps
    for key in ("regroups", "decode_steps", "decode_calls", "prefills",
                "prefilled_requests", "slot_steps", "busy_slot_steps"):
        assert t_eng.stats[key] == j_eng.stats[key], key
    assert t_eng.stats["regroups"] == 1
    assert t_eng.pool.level == 2
    assert t_eng.plan.vector == TVector(
        slots=2, pages=2 if pages else 1)
    assert t_eng.plan.preset is None
    if pages:
        assert t_eng.page_pool.level == 2
        assert t_eng.stats["page_deferrals"] == j_eng.stats["page_deferrals"]


def test_page_regroup_on_a_contiguous_engine_raises():
    for side in SIDES:
        eng = _engine(side, False, 4)
        with pytest.raises(ValueError, match="contiguous"):
            eng.regroup(page_level=2)
        assert not eng.regroup(page_level=1)
        assert eng.stats["regroups"] == 0


def test_exec_group_regroup_keeps_the_graphs():
    """The reference swaps the engine onto another group's executables;
    the port records the group id and keeps its horizon graphs (its
    ``HorizonGraphs`` object, so ``compile_count()`` does not move)."""
    j_eng, t_eng = _engine("repro", False, 4), _engine("port", False, 4)
    t_eng.start()
    graphs, count = t_eng._horizons, t_eng.compile_count()
    for eng in (j_eng, t_eng):
        assert eng.exec_group == 0
        assert eng.regroup(exec_group=3)
        assert eng.exec_group == 3 and eng.stats["regroups"] == 1
        assert not eng.regroup(exec_group=3)
    assert t_eng._horizons is graphs and t_eng.compile_count() == count
    assert dataclasses.asdict(t_eng.plan.vector) == \
        dataclasses.asdict(j_eng.plan.vector)
    obs = enabled_obs()
    t_eng.publish_metrics(obs.metrics, worker=0)
    assert obs.metrics.value("engine.jit_compiles", axis="execs", group=3,
                             worker=0) == count


def _clients(plan_spec=None, **overrides):
    """(reference client, port client) on the parity weights; a
    ``SharingVector`` spec is the port's and is rebuilt for the
    reference."""
    jcfg, tcfg, jparams, tparams = qwen2._served()
    kw = dict(n_slots=qwen2.N_SLOTS, max_len=qwen2.MAX_LEN, **overrides)
    j_spec = plan_spec
    if isinstance(plan_spec, TVector):
        j_spec = JVector(**dataclasses.asdict(plan_spec))
    return (jserve.connect(jcfg, j_spec, params=jparams, **kw),
            tserve.connect(tcfg, plan_spec, params=tparams, device="cpu",
                           **kw))


@pytest.mark.parametrize("horizon", [1, 4])
def test_replan_between_runs_matches_reference(horizon):
    specs = qwen2._specs()
    outs = []
    for client, vec_cls in zip(_clients(TVector(pages=4),
                                        decode_horizon=horizon),
                               (JVector, TVector)):
        first = client.generate([p for p, _, _ in specs[:6]], 6)
        new = client.replan(vec_cls(slots=2, pages=2))
        assert new.vector == vec_cls(slots=2, pages=2) and new.preset is None
        second = client.generate([p for p, _, _ in specs[6:]], 6)
        # the vector again: nothing moves, nothing is recorded
        client.replan(vec_cls(slots=2, pages=2))
        outs.append((first, second, len(client.transitions),
                     client.transitions[0][0],
                     client.engine.stats["regroups"],
                     client.engine.pool.level,
                     client.engine.page_pool.level))
    assert outs[1] == outs[0]
    assert outs[1][2:] == (1, None, 1, 2, 2)


def test_replan_takes_a_preset_and_an_endpoint_plan():
    for client in _clients("mpi_everywhere"):
        plan = client.replan("shared_dynamic")
        assert plan.vector.slots == 2 and plan.preset == "shared_dynamic"
        assert client.engine.pool.level == 2
        again = client.replan(dataclasses.replace(plan,
                                                  placement="least_loaded"))
        assert again.placement == "least_loaded"
        assert len(client.transitions) == 1


@pytest.mark.parametrize("field,value", [
    ("n_slots", 4), ("max_len", 64), ("decode_horizon", 2),
    ("prefill_buckets", None), ("use_ragged_kernel", True),
    ("page_size", 8), ("page_budget", 5)])
def test_replan_refuses_structural_fields(field, value):
    for client in _clients():
        with pytest.raises(ValueError, match=f"cannot change {field}"):
            client.replan(None, **{field: value})
        assert client.transitions == []


def test_replan_refuses_layout_flips_and_unknown_placement():
    for side, client in zip(("repro", "port"), _clients()):
        vec_cls = JVector if side == "repro" else TVector
        with pytest.raises(ValueError, match="KV-cache layout"):
            client.replan(vec_cls(pages=4))
        with pytest.raises(ValueError, match="unknown placement"):
            client.replan(None, placement="nearest")


def test_replan_hints_and_adaptive_name_their_slices():
    """Hints still name the planner slice; an adaptive replan lands on
    the plan, and the next run's controller starts from it, as in the
    reference."""
    j_client, client = _clients()
    with pytest.raises(NotImplementedError, match="planner slice"):
        client.replan(Hints(latency_target_ms=10.0))
    for c in (j_client, client):
        plan = c.replan(None, adaptive=True, adapt_window_ns=60_000.0)
        assert plan.adaptive and c.plan.adaptive
        assert c.transitions == [] and c.engine.stats["regroups"] == 0
    prompts = [p for p, _, _ in qwen2._specs()]
    assert client.generate(prompts, 6) == j_client.generate(prompts, 6)


def test_wave_executor_refuses_replan():
    for side, client in zip(("repro", "port"), _clients(executor="wave")):
        vec_cls = JVector if side == "repro" else TVector
        with pytest.raises(ValueError, match="wave executor"):
            client.replan(vec_cls(slots=2))
        assert client.plan.vector == vec_cls()


# ----- the two repaired faults of connect's validation -----------------------

def test_unknown_placement_raises_value_error():
    jcfg, tcfg, jparams, tparams = qwen2._served()
    with pytest.raises(ValueError, match="unknown placement"):
        jserve.connect(jcfg, params=jparams, placement="nearest")
    with pytest.raises(ValueError, match="unknown placement"):
        tserve.connect(tcfg, params=tparams, placement="nearest",
                       device="cpu")
    for name in ("round_robin", "least_loaded", "session_affinity"):
        client = tserve.connect(tcfg, params=tparams, placement=name,
                                n_slots=1, max_len=16, device="cpu")
        assert client.plan.placement == name


@pytest.mark.parametrize("kw", [dict(faults="crash@1ms:w0"),
                                dict(recovery=object()),
                                dict(migrations=[(1000.0, 0, 1)])],
                         ids=["faults", "recovery", "migrations"])
@pytest.mark.parametrize("executor", ["continuous", "wave"])
def test_off_fleet_faults_raise_value_error(kw, executor):
    jcfg, tcfg, jparams, tparams = qwen2._served()
    with pytest.raises(ValueError, match="fleet"):
        jserve.connect(jcfg, params=jparams, executor=executor, **kw)
    with pytest.raises(ValueError, match="fleet"):
        tserve.connect(tcfg, params=tparams, executor=executor,
                       device="cpu", **kw)
    # on a fleet plan both packages accept them
    for client in (jserve.connect(jcfg, params=jparams, n_workers=2, **kw),
                   tserve.connect(tcfg, params=tparams, n_workers=2,
                                  device="cpu", **kw)):
        assert client.executor == "fleet"
        assert (client.faults, client.recovery, client.migrations) == \
            (kw.get("faults"), kw.get("recovery"), kw.get("migrations"))
