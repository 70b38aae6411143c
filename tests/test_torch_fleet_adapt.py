"""Live re-planning on the port's engine fleet and single engine against
the reference's, live, and recurrentgemma's fleet.  Same workload and
comparison as ``test_torch_fleet`` (smoke configs at fp32, CPU).

* ``adaptive=True`` at diag2, 4 workers, K 8, ``adapt_window_ns=1e5``:
  the tokens equal the reference's.  The controller's execs signal
  differs: the port's ``exec.jit_compiles`` counts captured horizon
  graphs, 0 on the CPU, where the reference counts its jit cache
  entries, so the two controllers may take other transitions.  With the
  reference's compile counts read as 0 (its ``compile_probe`` and
  ``compile_count`` patched in the test, as the port's CPU reads them),
  every ``FleetReport`` field, the transitions included, is equal.
* ``adaptive=True`` on the single continuous engine (diag3, K 1): the
  same tokens; with the reference's counts read as 0, the same
  transitions at the same engine steps.
* A manual ``replan`` between two runs at 4 workers (diag3 -> s1c3e4):
  the tokens, the second run's report and every worker's pool level and
  exec group equal the reference's.
* recurrentgemma-2b's smoke config at 2 workers, co-located and 1P+1D:
  the tokens and reports equal the reference's.
"""

import dataclasses

import pytest

from repro.serve import engine as j_engine
from repro.serve.fabric import router as j_router
from tests.test_torch_fleet import (COMPILE_SERIES, assert_reports_equal,
                                    connect, prompt_of, reference, serve,
                                    trace)
from tests.test_torch_fabric import report_dict

DIAG2, DIAG3 = (2, 2, 2, 1), (3, 3, 3, 1)
S1C3E4 = (1, 3, 4, 1)
#: what the execs signal moves on this run: the vector path (each
#: controller walks the execs axis its own way; the slots and channels
#: moves land in the same windows, so the schedule is the same) and the
#: engines' regroup counts
EXECS_FIELDS = ("vector", "transitions", "mean_footprint")
EXECS_SERIES = COMPILE_SERIES + ("engine.regroups",)


def _zero_reference_compiles(monkeypatch):
    """Read the reference's compile counts as the port reads its own on
    the CPU: 0."""
    monkeypatch.setattr(j_router.EngineWorker, "compile_probe",
                        lambda self: (id(self.engine._steps), 0))
    monkeypatch.setattr(j_engine.ContinuousEngine, "compile_count",
                        lambda self: 0)


ADAPT = dict(adaptive=True, adapt_window_ns=100_000.0)


def test_adaptive_fleet_tokens_match_reference():
    expect, j_client = reference(DIAG2, 8, **ADAPT)
    got, t_client = serve("port", DIAG2, 8, **ADAPT)
    assert got == expect
    rep = t_client.report
    assert t_client.plan.adaptive and rep.n_windows > 0
    assert rep.metrics.total("exec.jit_compiles") == 0
    assert j_client.report.metrics.total("exec.jit_compiles") > 0
    assert_reports_equal(rep, j_client.report, skip=EXECS_FIELDS,
                         skip_series=EXECS_SERIES)
    assert _slot_channel_moves(rep) == \
        _slot_channel_moves(j_client.report)


def _slot_channel_moves(rep):
    """(t_ns, slots, channels) at each transition that moves either."""
    out, last = [], (None, None)
    for t, v in rep.transitions:
        if (v.slots, v.channels) != last:
            last = (v.slots, v.channels)
            out.append((t,) + last)
    return out


def test_adaptive_fleet_matches_reference_with_its_compiles_read_as_zero(
        monkeypatch):
    _zero_reference_compiles(monkeypatch)
    expect, j_client = serve("repro", DIAG2, 8, **ADAPT)
    got, t_client = serve("port", DIAG2, 8, **ADAPT)
    assert got == expect
    rep = t_client.report
    assert rep.transitions and rep.n_windows > 0
    assert_reports_equal(rep, j_client.report)
    assert [(t, dataclasses.astuple(v)) for t, v in t_client.transitions] \
        == [(t, dataclasses.astuple(v)) for t, v in j_client.transitions]
    assert dataclasses.astuple(t_client.plan.vector) == \
        dataclasses.astuple(j_client.plan.vector)
    for tw, jw in zip(t_client.workers, j_client.workers):
        assert tw.engine.pool.level == jw.engine.pool.level
        assert tw.engine.exec_group == jw.engine.exec_group


def _single(side):
    return serve(side, DIAG3, 1, n_workers=1, **ADAPT)


def test_adaptive_single_engine_matches_reference(monkeypatch):
    expect, _ = reference(DIAG3, 1, n_workers=1, **ADAPT)
    got, t_client = _single("port")
    assert got == expect
    assert t_client.executor == "continuous" and t_client.plan.adaptive
    _zero_reference_compiles(monkeypatch)
    zeroed, j_client = _single("repro")
    assert zeroed == got
    assert [(s, dataclasses.astuple(v)) for s, v in t_client.transitions] \
        == [(s, dataclasses.astuple(v)) for s, v in j_client.transitions]
    assert t_client.transitions
    eng, j_eng = t_client.engine, j_client.engine
    assert eng.stats["regroups"] == j_eng.stats["regroups"] > 0
    assert (eng.pool.level, eng.exec_group) == \
        (j_eng.pool.level, j_eng.exec_group)
    assert dataclasses.astuple(t_client.plan.vector) == \
        dataclasses.astuple(j_client.plan.vector)


def _manual_replan(side):
    """Half the burst on diag3, a live replan to s1c3e4, the rest."""
    client = connect(side, "qwen2-0.5b", DIAG3, n_workers=4, n_slots=4,
                     max_len=64, decode_horizon=8)
    vec_cls = type(client.plan.vector)
    out = {}
    full = trace()
    vocab = client.cfg.vocab
    for a in full[:12]:
        client.submit(prompt_of(vocab, a), max_new_tokens=a.max_new_tokens,
                      at_ns=a.t_ns)
    out.update(client.run())
    first = report_dict(client.report)
    client.replan(vec_cls(*S1C3E4))
    for a in full[12:]:
        client.submit(prompt_of(vocab, a), max_new_tokens=a.max_new_tokens,
                      at_ns=a.t_ns)
    out.update(client.run())
    return out, client, first


def test_manual_replan_mid_stream_matches_reference():
    got, t_client, t_first = _manual_replan("port")
    expect, j_client, j_first = _manual_replan("repro")
    assert got == expect == reference(DIAG3, 8)[0]
    assert {k: v for k, v in t_first.items() if k != "metrics"} == \
        {k: v for k, v in j_first.items() if k != "metrics"}
    assert_reports_equal(t_client.report, j_client.report)
    assert [(t, dataclasses.astuple(v)) for t, v in t_client.transitions] \
        == [(t, dataclasses.astuple(v)) for t, v in j_client.transitions]
    assert all(w.engine.pool.level == 1 for w in t_client.workers)
    assert [w.engine.exec_group for w in t_client.workers] == \
        [w.engine.exec_group for w in j_client.workers] == [0, 0, 0, 0]
    assert len(t_client.report.peak_depths) == 1      # one shared channel


@pytest.mark.parametrize("roles", [None, "1P+1D"], ids=["colocated",
                                                         "1P+1D"])
def test_recurrentgemma_fleet_matches_reference(roles):
    kw = dict(arch="recurrentgemma-2b", n_workers=2)
    if roles:
        kw["roles"] = roles
    expect, j_client = reference(DIAG2, 8, **kw)
    got, t_client = serve("port", DIAG2, 8, **kw)
    assert got == expect
    assert len(got) == 24 and all(got.values())
    if roles:
        assert got == reference(DIAG2, 8, arch="recurrentgemma-2b",
                                n_workers=2)[0]
        assert t_client.report.handoffs == 24
    assert not any(w.engine.paged for w in t_client.workers)
    # exact-length admission: the reference reads each admitted
    # prefill's first token on the host (one sync), the port keeps it on
    # the device for the next horizon; so engine.host_syncs differs by
    # the co-located workers' prefills (``prefill_only`` reads the token
    # on both sides)
    assert_reports_equal(t_client.report, j_client.report,
                         skip_series=COMPILE_SERIES + ("engine.host_syncs",))
    for tw, jw in zip(t_client.workers, j_client.workers):
        t_st, j_st = tw.engine.stats, jw.engine.stats
        assert j_st["host_syncs"] - t_st["host_syncs"] == \
            (0 if roles else t_st["prefills"])
