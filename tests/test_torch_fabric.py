"""The port's serving fabric in virtual time against the reference's, live.

Everything here is host code that the port copies (``core/channels.py``,
``core/endpoints.py``'s ``EndpointModel``, ``core/plan.py``'s footprint
accounting, ``serve/fabric/*``, ``serve/recovery.py``), so every check
asks for exact equality with ``repro``:

* the traffic generators and the canonical traces, arrival by arrival;
* the placement policies' choices over a seeded stream of queue states;
* ``DispatchPlan`` (and ``RoleDispatchPlan``) for every category at 1, 2,
  4 and 8 workers, with its Table-1 endpoint usage;
* the fault grammar: parsed plans, their ``describe()`` round trip, the
  canonical plans and the validation errors;
* ``build_sim_fleet`` ``FleetReport``s on the canonical traces for the
  four diagonals, s1c3e4, paged p1 and p4, 2P+2D, the canonical crash
  and chaos plans, a scheduled migration and an adaptive
  ``Replanner`` fleet: every field (completions with their worker and
  ``t_done_ns``, tok/s, p50/p99, peak depths, shed, failed, transitions)
  and the metrics registry's export.
"""

import dataclasses
import json

import numpy as np
import pytest

import repro.serve.fabric as jfab
import repro_torch.serve.fabric as tfab
from repro.core import channels as jch
from repro.core.adapt import Replanner as JReplanner
from repro.core.endpoints import Category as JCategory
from repro.core.plan import SharingVector as JVector
from repro.serve.recovery import RecoveryPolicy as JPolicy
from repro_torch.core import channels as tch
from repro_torch.core.adapt import Replanner as TReplanner
from repro_torch.core.endpoints import Category as TCategory
from repro_torch.core.plan import SharingVector as TVector
from repro_torch.serve.recovery import RecoveryPolicy as TPolicy

SIDES = {"repro": (jfab, JVector, JReplanner, JPolicy, JCategory),
         "port": (tfab, TVector, TReplanner, TPolicy, TCategory)}


def _arrivals(trace):
    return [dataclasses.astuple(a) for a in trace]


def report_dict(rep) -> dict:
    """Every field of a ``FleetReport`` as plain data (enums by value,
    vectors and completions as tuples), its derived rates and
    percentiles, and the metrics registry's JSON export."""
    out = {}
    for f in dataclasses.fields(rep):
        v = getattr(rep, f.name)
        if f.name == "metrics":
            v = None if v is None else json.dumps(v.to_json(),
                                                  sort_keys=True)
        elif f.name == "category":
            v = v.value
        elif f.name == "vector":
            v = None if v is None else dataclasses.astuple(v)
        elif f.name == "completions":
            v = [dataclasses.astuple(c) for c in v]
        elif f.name == "transitions":
            v = [(t, dataclasses.astuple(vec)) for t, vec in v]
        out[f.name] = v
    out.update(tok_per_s=rep.tok_per_s, fairness=rep.fairness,
               p50=rep.latency_percentile(0.5),
               p99=rep.latency_percentile(0.99), n_shed=rep.n_shed)
    return out


# ----- traffic ------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3, 7])
def test_traffic_generators_match_reference(seed):
    for kw in (dict(prompt_lens=(8, 16), new_tokens=(2, 9)), {}):
        assert _arrivals(tfab.poisson_trace(40, seed=seed, **kw)) == \
            _arrivals(jfab.poisson_trace(40, seed=seed, **kw))
        assert _arrivals(tfab.bursty_trace(40, burst_size=7, seed=seed,
                                           **kw)) == \
            _arrivals(jfab.bursty_trace(40, burst_size=7, seed=seed, **kw))
        assert _arrivals(tfab.session_trace(5, 4, seed=seed, **kw)) == \
            _arrivals(jfab.session_trace(5, 4, seed=seed, **kw))
        t_tr, t_ph = tfab.phased_trace(12, seed=seed, **kw)
        j_tr, j_ph = jfab.phased_trace(12, seed=seed, **kw)
        assert _arrivals(t_tr) == _arrivals(j_tr)
        assert [dataclasses.astuple(p) for p in t_ph] == \
            [dataclasses.astuple(p) for p in j_ph]
    for name in tfab.TRAFFIC_SHAPES:
        assert _arrivals(tfab.TRAFFIC_SHAPES[name](24, seed=seed)) == \
            _arrivals(jfab.TRAFFIC_SHAPES[name](24, seed=seed))


def test_canonical_traces_match_reference():
    assert sorted(tfab.TRAFFIC_SHAPES) == sorted(jfab.TRAFFIC_SHAPES)
    assert _arrivals(tfab.canonical_bursty_trace()) == \
        _arrivals(jfab.canonical_bursty_trace())
    assert _arrivals(tfab.canonical_faulted_trace()) == \
        _arrivals(jfab.canonical_faulted_trace())
    t_tr, _ = tfab.canonical_phased_trace()
    j_tr, _ = jfab.canonical_phased_trace()
    assert _arrivals(t_tr) == _arrivals(j_tr)
    with pytest.raises(ValueError, match="turns"):
        tfab.session_trace(4, -2)


# ----- placement ------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(jfab.POLICIES))
def test_placement_choices_match_reference(name):
    """One policy of each package fed the same 400 arrivals and queue
    states (random depths, loads, eligibility and sessions) chooses the
    same queue every time."""
    assert sorted(tfab.POLICIES) == sorted(jfab.POLICIES)
    t_pol, j_pol = tfab.make_policy(name), jfab.make_policy(name)
    assert t_pol.name == j_pol.name == name
    rng = np.random.default_rng(11)
    for rid in range(400):
        n = int(rng.integers(1, 7))
        depths = [int(x) for x in rng.integers(0, 5, n)]
        loads = [float(x) for x in rng.integers(0, 9, n)]
        eligible = None
        if rng.random() < 0.4:
            eligible = sorted({int(x) for x in rng.integers(0, n, 2)})
        session = int(rng.integers(-1, 6))
        args = dict(rid=rid, t_ns=float(rid), prompt_len=8,
                    max_new_tokens=4, session=session)
        t_q = t_pol.choose(tfab.Arrival(**args), depths, loads, eligible)
        j_q = j_pol.choose(jfab.Arrival(**args), depths, loads, eligible)
        assert t_q == j_q, (rid, depths, loads, eligible, session)
    with pytest.raises(ValueError) as t_err:
        tfab.make_policy("nearest")
    with pytest.raises(ValueError) as j_err:
        jfab.make_policy("nearest")
    assert str(t_err.value) == str(j_err.value)


# ----- dispatch plans --------------------------------------------------------

@pytest.mark.parametrize("n_workers", [1, 2, 4, 8])
@pytest.mark.parametrize("category", [c.value for c in JCategory])
def test_dispatch_plan_matches_reference(category, n_workers):
    for key in (category, JCategory(category).level):
        t_key = TCategory(key) if isinstance(key, str) else key
        j_key = JCategory(key) if isinstance(key, str) else key
        t, j = (tch.DispatchPlan(t_key, n_workers),
                jch.DispatchPlan(j_key, n_workers))
        assert (t.level, t.group_size, t.n_queues, t.category.value) == \
            (j.level, j.group_size, j.n_queues, j.category.value)
        assert [t.queue_of(w) for w in range(n_workers)] == \
            [j.queue_of(w) for w in range(n_workers)]
        assert [list(t.workers_of(q)) for q in range(t.n_queues)] == \
            [list(j.workers_of(q)) for q in range(j.n_queues)]
        assert t.endpoint_usage() == j.endpoint_usage()
    t_cp, j_cp = (tch.plan_for(TCategory(category)),
                  jch.plan_for(JCategory(category)))
    assert (t_cp.n_channels, t_cp.per_producer, t_cp.double_buffered,
            t_cp.serialize) == (j_cp.n_channels, j_cp.per_producer,
                                j_cp.double_buffered, j_cp.serialize)
    assert [t_cp.staging_buffers(n) for n in (1, 7, 32)] == \
        [j_cp.staging_buffers(n) for n in (1, 7, 32)]


@pytest.mark.parametrize("level", [1, 2, 3, 4])
def test_role_dispatch_plan_matches_reference(level):
    for n_p, n_d in ((1, 1), (2, 2), (1, 3), (3, 5)):
        t = tfab.RoleDispatchPlan(level, n_p, n_d)
        j = jfab.RoleDispatchPlan(level, n_p, n_d)
        n = n_p + n_d
        assert (t.n_queues, t.prefill_queues, t.decode_queues) == \
            (j.n_queues, j.prefill_queues, j.decode_queues)
        assert [(t.role_of(w), t.queue_of(w)) for w in range(n)] == \
            [(j.role_of(w), j.queue_of(w)) for w in range(n)]
        assert [t.workers_of(q) for q in range(t.n_queues)] == \
            [j.workers_of(q) for q in range(j.n_queues)]
        assert t.endpoint_usage() == j.endpoint_usage()


# ----- fault grammar ---------------------------------------------------------

FAULT_SPECS = ("crash@4.5ms:w0", "crash@0.6ms:w0,stall@2ms:w1:1ms",
               "chan_stall@2.1ms:c1:500us,page_pressure@6.1ms:w2:1ms:0.5",
               "stall@1200us:w3:250us", "crash@700000:w1")


@pytest.mark.parametrize("text", FAULT_SPECS)
def test_fault_parsing_matches_reference(text):
    t, j = tfab.parse_faults(text), jfab.parse_faults(text)
    assert [dataclasses.astuple(s) for s in t.specs] == \
        [dataclasses.astuple(s) for s in j.specs]
    assert t.describe() == j.describe()
    assert tfab.parse_faults(t.describe()).describe() == t.describe()
    assert [(ts, dataclasses.astuple(s))
            for ts, s in tfab.FaultInjector(t.validate(4, 4)).schedule()] \
        == [(ts, dataclasses.astuple(s))
            for ts, s in jfab.FaultInjector(j.validate(4, 4)).schedule()]


def test_canonical_fault_plans_and_errors_match_reference():
    for name in ("canonical_crash_plan", "canonical_chaos_plan"):
        assert getattr(tfab, name)().describe() == \
            getattr(jfab, name)().describe()
    for bad in ("melt@1ms:w0", "crash@1ms", "crash@xs:w0", "crash@1ms:q0",
                "stall@1ms:w0"):
        with pytest.raises(ValueError) as t_err:
            tfab.parse_faults(bad)
        with pytest.raises(ValueError) as j_err:
            jfab.parse_faults(bad)
        assert str(t_err.value) == str(j_err.value), bad
    with pytest.raises(ValueError) as t_err:
        tfab.parse_faults("crash@1ms:w9").validate(4, 4)
    with pytest.raises(ValueError) as j_err:
        jfab.parse_faults("crash@1ms:w9").validate(4, 4)
    assert str(t_err.value) == str(j_err.value)


# ----- the virtual-time fleet ------------------------------------------------

def _vec(side, name):
    vec = SIDES[side][1]
    if name.startswith("diag"):
        return vec.diagonal(int(name[4:]))
    return {"s1c3e4": vec(slots=1, channels=3, execs=4),
            "p1": vec(pages=1), "p4": vec(slots=1, channels=2, pages=4),
            "d2_paged": vec.diagonal(2)}[name]


#: (case, n_workers, vector, traffic, build_sim_fleet keywords)
SIM_CASES = [
    ("diag1", 8, "diag1", "bursty", {}),
    ("diag2", 8, "diag2", "bursty", {}),
    ("diag3", 8, "diag3", "bursty", {}),
    ("diag4", 8, "diag4", "bursty", {}),
    ("s1c3e4", 8, "s1c3e4", "bursty", {}),
    ("least_loaded", 8, "diag2", "bursty", dict(placement="least_loaded")),
    ("session_affinity", 4, "diag2", "session",
     dict(placement="session_affinity")),
    ("paged_p1", 8, "p1", "bursty", dict(page_size=16, max_len=64)),
    ("paged_p4", 8, "p4", "bursty", dict(page_size=16, max_len=64,
                                          page_budget=12)),
    ("2P+2D", 4, "diag2", "bursty", dict(roles="2P+2D")),
    ("crash", 4, "diag2", "faulted", dict(faults="canonical_crash")),
    ("chaos", 4, "diag2", "faulted", dict(faults="canonical_chaos",
                                          page_size=16, max_len=64)),
    ("shed", 4, "diag2", "faulted", dict(faults="canonical_crash",
                                         recovery=dict(shed_capacity=10))),
    ("migration", 4, "diag2", "bursty",
     dict(migrations=[(1_000_000.0, 0, 2), (4_600_000.0, 3, 1)])),
    ("2P+2D_migration", 4, "diag2", "bursty",
     dict(roles="2P+2D", migrations=[(1_500_000.0, 2, 3)])),
    ("adaptive_phased", 8, "diag2", "phased", dict(adapt=True)),
    ("adaptive_bursty", 8, "diag2", "bursty", dict(adapt=True)),
    ("adaptive_paged", 8, "d2_paged", "bursty",
     dict(adapt=True, page_size=16, max_len=64)),
]


def _sim(side, n_workers, vname, traffic, kw):
    fab, _, replanner, policy, _ = SIDES[side]
    kw = dict(kw)
    vec = _vec(side, vname)
    if kw.pop("adapt", False):
        kw["adapt"] = replanner(vec, n_workers=n_workers, n_slots=4,
                                paged=kw.get("page_size", 0) > 0)
        kw["adapt_window_ns"] = 100_000.0
    if "faults" in kw:
        kw["faults"] = getattr(fab, kw["faults"] + "_plan")()
    if "recovery" in kw:
        kw["recovery"] = policy(**kw["recovery"])
    trace = {"bursty": fab.canonical_bursty_trace,
             "faulted": fab.canonical_faulted_trace,
             "phased": lambda: fab.canonical_phased_trace()[0],
             "session": lambda: fab.session_trace(6, 4, seed=2)}[traffic]()
    router = fab.build_sim_fleet(n_workers, vec, n_slots=4, **kw)
    return router.run(trace)


@pytest.mark.parametrize("case,n_workers,vname,traffic,kw", SIM_CASES,
                         ids=[c[0] for c in SIM_CASES])
def test_sim_fleet_report_matches_reference(case, n_workers, vname,
                                            traffic, kw):
    got = report_dict(_sim("port", n_workers, vname, traffic, kw))
    expect = report_dict(_sim("repro", n_workers, vname, traffic, kw))
    assert got.keys() == expect.keys()
    for field in expect:
        assert got[field] == expect[field], field
    assert got["completions"]
    if case.startswith(("crash", "chaos", "shed")):
        assert got["faults_injected"] >= 1
    if case.startswith("adaptive"):
        assert got["transitions"] and got["n_windows"]
    if "migration" in case:
        assert got["migrations"] >= 1
    if case == "shed":
        assert got["shed"]
