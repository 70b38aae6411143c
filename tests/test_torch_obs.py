"""The port's observability layer (``repro_torch.obs``) against the
reference's (``repro.obs``), live.

* The same sequence of registry, sketch, window and flight-recorder
  operations exports byte-identical JSON through both packages, and the
  windows read the same deltas.
* ``validate_trace`` flags the same broken traces with the same words.
* A single-engine ``connect(obs=enabled_obs())`` run (CPU, fp32, the
  parity tests' weights and requests) exports the reference's trace JSON
  byte for byte, and its metrics export equals the reference's in every
  series but one: ``engine.jit_compiles``, which counts the reference's
  jit cache entries and the port's horizon graphs (0 on the CPU, where
  nothing is captured).
* The launcher's ``--trace-out`` / ``--metrics-out`` write a trace the
  port's validator accepts and the registry's JSON.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import repro.obs as jobs
import repro_torch.obs as tobs
from repro import serve as jserve
from repro.core.plan import EndpointPlan as JPlan
from repro.core.plan import SharingVector as JVector
from repro.obs.trace import PID_FLEET as J_PID_FLEET
from repro_torch import serve as tserve
from repro_torch.core.plan import EndpointPlan as TPlan
from repro_torch.core.plan import SharingVector as TVector
from repro_torch.obs.trace import (PID_FLEET, PID_REQUESTS, PID_RESOURCES,
                                   TID_ROUTER)
from tests import test_torch_engine as qwen2

ROOT = Path(__file__).resolve().parents[1]


def test_public_names_match_reference():
    assert sorted(tobs.__all__) == sorted(jobs.__all__)
    for name in ("PID_FLEET", "PID_RESOURCES", "PID_REQUESTS",
                 "TID_ROUTER", "TID_WORKER0", "TID_CHANNEL0", "TID_PAGES0"):
        assert getattr(tobs, name) == getattr(jobs, name)
    assert PID_FLEET == J_PID_FLEET


def _stream(n):
    """Deterministic heavy-tailed positive samples."""
    return [((i * 2654435761) % 9973 + 1) ** 1.5 for i in range(n)]


def _exercise(obs, rel_err):
    """One fixed sequence of metrics and recorder operations on the
    package ``obs``; -> (metrics JSON, trace JSON, sketch JSON, window
    reads, quantiles), every export serialized with sorted keys."""
    reg = obs.MetricsRegistry(rel_err)
    reg.counter("engine.decode_steps", axis="execs", worker=0).set_total(40)
    reg.counter("fleet.lock_wait_ns", axis="channels", group=1).inc(2.5)
    reg.counter("fleet.lock_wait_ns", group=1, axis="channels").inc()
    reg.gauge("pages.pressure", axis="pages", worker=1).set(0.25)
    reg.gauge("pages.pressure", axis="pages", worker=1).max_of(0.125)
    hist = reg.histogram("fleet.latency_ns", worker=0)
    for v in _stream(300):
        hist.observe(v)
    win = reg.window()
    reg.counter("engine.decode_steps", axis="execs", worker=0).set_total(65)
    reg.counter("engine.decode_steps", axis="execs", worker=1).inc(7)
    for v in _stream(50):
        hist.observe(2 * v)
    reads = [win.delta("engine.decode_steps", axis="execs", worker=0),
             win.delta_total("engine.decode_steps"),
             win.delta_histogram("fleet.latency_ns", worker=0).n]
    win.roll()
    reads.append(win.delta_total("engine.decode_steps"))
    a, b = obs.QuantileSketch(rel_err), obs.QuantileSketch(rel_err)
    for v in _stream(700):
        a.add(v)
    snap = a.snapshot()
    for v in (0.0, -3.0, 5.0):
        b.add(v)
    a.merge(b)
    tail = a.minus(snap)
    quantiles = [a.quantile(q) for q in (0.0, 0.1, 0.5, 0.99, 1.0)] + [
        obs.quantile(_stream(99), q) for q in (0.5, 0.99)] + [tail.n]
    rec = obs.FlightRecorder()
    rec.name_process(PID_FLEET, "fleet")
    rec.name_track(PID_FLEET, TID_ROUTER, "router")
    rec.complete(PID_FLEET, TID_ROUTER, "dispatch", 1000.0, 250.0,
                 args={"rid": 3})
    rec.instant(PID_RESOURCES, 7, "page_defer", 1500.0, args={"slot": 2})
    rec.begin(PID_REQUESTS, "request", 3, 900.0, args={"admit_step": 1})
    rec.end(PID_REQUESTS, "request", 3, 4000.0, args={"new_tokens": 5})
    rec.counter(PID_RESOURCES, 8, "pages_live", 2000.0, {"live": 12})
    dumps = lambda d: json.dumps(d, sort_keys=True)     # noqa: E731
    return (dumps(reg.to_json()), dumps(rec.to_chrome()),
            dumps(a.to_json()), reads, quantiles)


@pytest.mark.parametrize("rel_err", [0.01, 0.05])
def test_same_operations_export_identical_json(rel_err, tmp_path):
    expect = _exercise(jobs, rel_err)
    got = _exercise(tobs, rel_err)
    assert got == expect
    # the files each package dumps are byte-identical too
    for i, pkg in enumerate((jobs, tobs)):
        reg = pkg.MetricsRegistry(rel_err)
        reg.counter("x", axis="slots", worker=0).inc(3)
        reg.dump(str(tmp_path / f"metrics{i}.json"))
        rec = pkg.FlightRecorder()
        rec.complete(PID_FLEET, TID_ROUTER, "a", 0.0, 10.0)
        rec.dump(str(tmp_path / f"trace{i}.json"))
    for name in ("metrics", "trace"):
        assert (tmp_path / f"{name}0.json").read_bytes() == \
            (tmp_path / f"{name}1.json").read_bytes()


def _overlap(rec):
    rec.complete(PID_FLEET, 100, "a", 0.0, 2000.0)
    rec.complete(PID_FLEET, 100, "b", 1000.0, 2000.0)


def _unclosed(rec):
    rec.begin(PID_REQUESTS, "request", 1, 0.0)


def _unopened(rec):
    rec.end(PID_REQUESTS, "request", 2, 5.0)


def _all_broken(rec):
    _overlap(rec)
    _unclosed(rec)
    _unopened(rec)


@pytest.mark.parametrize("breakage", [_overlap, _unclosed, _unopened,
                                      _all_broken])
def test_validator_flags_the_same_broken_traces(breakage):
    problems = []
    for pkg in (jobs, tobs):
        rec = pkg.FlightRecorder()
        breakage(rec)
        problems.append(pkg.validate_trace(rec.to_chrome()))
    assert problems[1] == problems[0] and problems[1]
    assert tobs.validate_trace(tobs.FlightRecorder().to_chrome()) == []
    assert tobs.validate_trace({"traceEvents": "x"}) == \
        jobs.validate_trace({"traceEvents": "x"})


def test_noop_surfaces_are_inert():
    assert not tobs.NOOP_REGISTRY.enabled and not tobs.NOOP_RECORDER.enabled
    assert not tobs.NOOP_OBS.enabled and not tobs.NOOP_OBS.tracing
    tobs.NOOP_REGISTRY.counter("x", worker=0).inc(5)
    assert tobs.NOOP_REGISTRY.total("x") == 0.0
    assert tobs.NOOP_RECORDER.to_chrome()["traceEvents"] == []
    assert tobs.enabled_obs().enabled and tobs.enabled_obs().tracing


def _observed_run(side, horizon, pages):
    """connect(obs=enabled_obs()) on the parity tests' weights, plan and
    requests; -> (trace JSON, metrics export, client)."""
    jcfg, tcfg, jparams, tparams = qwen2._served()
    if side == "repro":
        obs = jobs.enabled_obs()
        client = jserve.connect(
            jcfg, qwen2._plan(JPlan, JVector, horizon, pages),
            params=jparams, obs=obs)
    else:
        obs = tobs.enabled_obs()
        client = tserve.connect(
            tcfg, qwen2._plan(TPlan, TVector, horizon, pages),
            params=tparams, obs=obs, device="cpu")
    for prompt, max_new, eos in qwen2._specs():
        client.submit(prompt, max_new_tokens=max_new, eos_id=eos)
    client.run()
    trace = obs.recorder.to_chrome()
    assert (jobs if side == "repro" else tobs).validate_trace(trace) == []
    return (json.dumps(trace, sort_keys=True), obs.metrics.to_json(),
            client)


@pytest.mark.parametrize("horizon,pages", [(1, False), (8, True)],
                         ids=["K1-contiguous", "K8-pages4"])
def test_single_engine_run_exports_the_reference_trace_and_metrics(
        horizon, pages):
    j_trace, j_metrics, _ = _observed_run("repro", horizon, pages)
    t_trace, t_metrics, client = _observed_run("port", horizon, pages)
    assert t_trace == j_trace
    spans = [e for e in json.loads(t_trace)["traceEvents"]
             if e["ph"] == "b" and e["name"] == "request"]
    assert len(spans) == len(qwen2._specs())
    # the one named exception: jit cache entries against horizon graphs
    j_compiles = j_metrics["metrics"].pop("engine.jit_compiles")
    t_compiles = t_metrics["metrics"].pop("engine.jit_compiles")
    assert t_metrics == j_metrics
    assert [row["labels"] for row in t_compiles] == \
        [row["labels"] for row in j_compiles]
    assert t_compiles[0]["value"] == client.engine.compile_count() == 0
    assert j_compiles[0]["value"] > 0
    eng = client.engine
    for name in ("decode_steps", "host_syncs", "prefills", "slot_steps",
                 "busy_slot_steps", "regroups"):
        row, = t_metrics["metrics"][f"engine.{name}"]
        assert row["value"] == eng.stats[name]
    assert ("pages.hwm" in t_metrics["metrics"]) == pages


def test_obs_off_records_nothing():
    _, tcfg, _, tparams = qwen2._served()
    client = tserve.connect(tcfg, params=tparams, n_slots=2, max_len=32,
                            device="cpu")
    assert client.obs is tobs.NOOP_OBS
    client.generate([qwen2._specs()[0][0]], max_new_tokens=2)
    assert tobs.NOOP_RECORDER.to_chrome()["traceEvents"] == []


def test_launcher_writes_a_valid_trace_and_the_metrics(tmp_path):
    trace, metrics = tmp_path / "trace.json", tmp_path / "metrics.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", "--max-len", "64", "--requests", "6",
         "--prompt-len", "8", "--max-new", "4", "--decode-horizon", "4",
         "--pages", "4", "--trace-out", str(trace), "--metrics-out",
         str(metrics)],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    doc = json.loads(trace.read_text())
    assert tobs.validate_trace(doc) == []
    assert sum(e["ph"] == "b" for e in doc["traceEvents"]) == 6
    reg = json.loads(metrics.read_text())
    assert reg["schema"] == "repro-metrics-v1"
    assert reg["metrics"]["engine.decode_steps"][0]["value"] > 0
    assert "pages.hwm" in reg["metrics"]
