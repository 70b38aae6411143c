"""Flight recorder: structured spans over the serving stack's virtual
time, exported as Chrome trace-event JSON (Perfetto-loadable)
(DESIGN.md §14).

The recorder captures every request's lifecycle — arrive → route →
queue-wait → admit/prefill → decode steps/horizons → retire → deliver —
plus instant events for replan transitions, page-pool deferrals, jit
compiles, and channel-lock waits.  All timestamps are the fabric's
VIRTUAL nanoseconds (`serve.fabric.router`), so two runs of the same
seed export bit-identical traces; no wall clock ever enters an event.

Track layout (Chrome's pid/tid hierarchy, one Perfetto track each):

* pid 1 ``fleet``      — tid 0 ``router`` (arrivals, routing, replans,
  deliveries), tid 100+w ``worker w`` (admit + step/horizon duration
  spans, page-deferral and jit-compile instants).
* pid 2 ``resources``  — tid per resource group: 200+q ``channel q``
  (lock-wait instants, queue-depth counters), 300+w ``pages w``
  (page-pool pressure counters).
* pid 3 ``requests``   — async begin/end pairs keyed by rid: one
  horizontal bar per request from arrival to delivery, with queue-wait
  sub-spans nested by the same id (Perfetto groups async events by id).

Duration ("X") spans are emitted only on the serially-timed worker
tracks, so spans on one track never overlap (an invariant
``repro_torch.obs.validate`` checks); anything that can overlap — queue
residency, request lifetimes — rides async ("b"/"e") events instead.

``NoopRecorder`` is the default everywhere: its ``enabled`` flag lets
hot paths skip even argument construction, which is what keeps the
tracing-disabled serving path inside the <1% overhead budget
(``benchmarks/bench_obs.py`` enforces the band).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

__all__ = ["FlightRecorder", "NoopRecorder", "NOOP_RECORDER",
           "Observability", "NOOP_OBS", "enabled_obs",
           "PID_FLEET", "PID_RESOURCES", "PID_REQUESTS",
           "TID_ROUTER", "TID_WORKER0", "TID_CHANNEL0", "TID_PAGES0"]

PID_FLEET = 1
PID_RESOURCES = 2
PID_REQUESTS = 3

TID_ROUTER = 0
TID_WORKER0 = 100        # worker w -> tid TID_WORKER0 + w
TID_CHANNEL0 = 200       # channel q -> tid TID_CHANNEL0 + q
TID_PAGES0 = 300         # worker w's page pool -> tid TID_PAGES0 + w


def _ts(t_ns: float) -> float:
    """Chrome trace timestamps are microseconds; virtual ns are exact
    binary floats at fabric scale, so the /1e3 stays deterministic."""
    return t_ns / 1e3


class FlightRecorder:
    """Collects trace events in memory; export via ``to_chrome`` /
    ``dump``.  Every method takes virtual-ns timestamps."""

    enabled = True

    def __init__(self):
        self.events: List[dict] = []
        self._track_names: Dict[tuple, str] = {}
        self._process_names: Dict[int, str] = {
            PID_FLEET: "fleet", PID_RESOURCES: "resources",
            PID_REQUESTS: "requests"}

    # ----- track naming ---------------------------------------------------
    def name_track(self, pid: int, tid: int, name: str) -> None:
        self._track_names[(pid, tid)] = name

    def name_process(self, pid: int, name: str) -> None:
        self._process_names[pid] = name

    # ----- emission -------------------------------------------------------
    def complete(self, pid: int, tid: int, name: str, t_ns: float,
                 dur_ns: float, cat: str = "span",
                 args: Optional[dict] = None) -> None:
        """One duration span (ph "X").  Only serially-timed tracks may
        emit these — overlapping residencies use ``begin``/``end``."""
        ev = {"ph": "X", "pid": pid, "tid": tid, "name": name,
              "cat": cat, "ts": _ts(t_ns), "dur": _ts(dur_ns)}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def instant(self, pid: int, tid: int, name: str, t_ns: float,
                cat: str = "event", args: Optional[dict] = None) -> None:
        ev = {"ph": "i", "pid": pid, "tid": tid, "name": name,
              "cat": cat, "ts": _ts(t_ns), "s": "t"}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def begin(self, pid: int, name: str, ident, t_ns: float,
              cat: str = "request", args: Optional[dict] = None) -> None:
        """Async span begin, keyed by ``ident`` (rid for request spans);
        pair with ``end`` on the same (pid, cat, ident)."""
        ev = {"ph": "b", "pid": pid, "tid": 0, "name": name, "cat": cat,
              "id": str(ident), "ts": _ts(t_ns)}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def end(self, pid: int, name: str, ident, t_ns: float,
            cat: str = "request", args: Optional[dict] = None) -> None:
        ev = {"ph": "e", "pid": pid, "tid": 0, "name": name, "cat": cat,
              "id": str(ident), "ts": _ts(t_ns)}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def counter(self, pid: int, tid: int, name: str, t_ns: float,
                values: dict) -> None:
        self.events.append({"ph": "C", "pid": pid, "tid": tid,
                            "name": name, "cat": "counter",
                            "ts": _ts(t_ns), "args": dict(values)})

    # ----- export ---------------------------------------------------------
    def _metadata(self) -> List[dict]:
        out = []
        for pid in sorted(self._process_names):
            out.append({"ph": "M", "pid": pid, "tid": 0,
                        "name": "process_name", "ts": 0.0,
                        "args": {"name": self._process_names[pid]}})
        for (pid, tid) in sorted(self._track_names):
            out.append({"ph": "M", "pid": pid, "tid": tid,
                        "name": "thread_name", "ts": 0.0,
                        "args": {"name": self._track_names[(pid, tid)]}})
        return out

    def to_chrome(self) -> dict:
        """The Chrome trace-event document.  Events sort by a total
        deterministic key (ts, then a stable serialization), so the
        export is bit-identical across runs of the same seed regardless
        of emission interleaving."""
        body = sorted(
            self.events,
            key=lambda e: (e["ts"], e["pid"], e["tid"], e["ph"],
                           e["name"], e.get("id", ""),
                           json.dumps(e.get("args", {}), sort_keys=True)))
        return {"displayTimeUnit": "ns",
                "otherData": {"clock": "virtual",
                              "source": "repro.obs.FlightRecorder"},
                "traceEvents": self._metadata() + body}

    def dump(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, indent=1, sort_keys=True)
            f.write("\n")
        return path


class NoopRecorder:
    """The disabled recorder: ``enabled`` is False and every method is
    an immediate no-op, so instrumented code either skips emission on
    the flag or pays one empty call."""

    enabled = False
    events: List[dict] = []

    def name_track(self, pid, tid, name):
        pass

    def name_process(self, pid, name):
        pass

    def complete(self, pid, tid, name, t_ns, dur_ns, cat="span",
                 args=None):
        pass

    def instant(self, pid, tid, name, t_ns, cat="event", args=None):
        pass

    def begin(self, pid, name, ident, t_ns, cat="request", args=None):
        pass

    def end(self, pid, name, ident, t_ns, cat="request", args=None):
        pass

    def counter(self, pid, tid, name, t_ns, values):
        pass

    def to_chrome(self) -> dict:
        return {"displayTimeUnit": "ns", "traceEvents": []}


NOOP_RECORDER = NoopRecorder()


class Observability:
    """The bundle every serving layer threads: one flight recorder plus
    one metrics registry.  The default (``NOOP_OBS``) is fully disabled;
    ``enabled_obs()`` turns both on."""

    def __init__(self, recorder=None, metrics=None):
        from repro_torch.obs.metrics import NOOP_REGISTRY
        self.recorder = recorder if recorder is not None else NOOP_RECORDER
        self.metrics = metrics if metrics is not None else NOOP_REGISTRY

    @property
    def tracing(self) -> bool:
        return self.recorder.enabled

    @property
    def enabled(self) -> bool:
        return self.recorder.enabled or self.metrics.enabled


def enabled_obs(rel_err: float = 0.01) -> Observability:
    from repro_torch.obs.metrics import MetricsRegistry
    return Observability(FlightRecorder(), MetricsRegistry(rel_err))


NOOP_OBS = Observability()
