"""Unified observability layer for the serving stack (DESIGN.md §14).

Two halves, bundled by :class:`Observability`:

* :mod:`repro_torch.obs.trace` — the flight recorder: per-request
  lifecycle spans and resource instant events in virtual time, exported as
  Chrome trace-event / Perfetto JSON;
* :mod:`repro_torch.obs.metrics` — the metrics registry: named counters /
  gauges / histograms keyed by (resource axis, sharing group, worker),
  histograms backed by a deterministic streaming quantile sketch.

Everything defaults to the no-op singletons (``NOOP_OBS``), so the
serving hot path pays nothing unless a caller opts in via
``enabled_obs()`` / ``--trace-out`` / ``--metrics-out``.

The port's own copy of ``repro.obs``: pure Python, the same public names,
and for the same sequence of operations the same JSON exports, byte for
byte (the schema tags ``repro-metrics-v1`` and the recorder's ``source``
are part of the format and stay as they are).
"""

from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, MetricsWindow,
                                     NOOP_REGISTRY, QuantileSketch, quantile)
from repro_torch.obs.trace import (FlightRecorder, NoopRecorder,
                                   NOOP_RECORDER, Observability, NOOP_OBS,
                                   enabled_obs, PID_FLEET, PID_RESOURCES,
                                   PID_REQUESTS, TID_ROUTER, TID_WORKER0,
                                   TID_CHANNEL0, TID_PAGES0)
from repro_torch.obs.validate import validate_trace

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "MetricsWindow",
    "NOOP_REGISTRY", "QuantileSketch", "quantile",
    "FlightRecorder", "NoopRecorder", "NOOP_RECORDER",
    "Observability", "NOOP_OBS", "enabled_obs",
    "PID_FLEET", "PID_RESOURCES", "PID_REQUESTS",
    "TID_ROUTER", "TID_WORKER0", "TID_CHANNEL0", "TID_PAGES0",
    "validate_trace",
]
