"""Unified metrics fabric: counters/gauges/histograms keyed by
(resource axis, sharing group, worker) labels (DESIGN.md §14).

The paper's measurement campaign worked because every contended resource
— CTX, PD, CQ, QP — had its own hardware counter; sharing regressions
showed up *per resource*, not as one blurred aggregate.  This module is
the serving stack's equivalent substrate: every emitter (`Router`,
`ContinuousEngine`, `DispatchChannel`, `PagePool`) publishes named
metrics into ONE `MetricsRegistry`, labeled by which resource axis and
sharing group produced them, and every consumer — the adaptive
`Replanner`'s telemetry windows, `FleetReport`, the launcher's
``--metrics-out`` export, future auto-tuners — reads the same registry
instead of hand-threading private counter fields.

Three metric kinds:

* ``Counter`` — monotone totals (slot steps, lock-wait ns, deferrals).
  Emitters that already keep authoritative local totals publish them via
  ``set_total`` (absolute, idempotent), hot paths use ``inc``.
* ``Gauge`` — last-value samples (queue depth, page-pool pressure).
* ``Histogram`` — a deterministic streaming quantile sketch
  (``QuantileSketch``): p50/p99 over millions of samples in O(buckets)
  memory, no latency list retained.

Windows: ``registry.window()`` snapshots every counter; ``delta`` /
``delta_total`` then report what accrued since, and ``roll()``
re-baselines — the mechanism `Router._window_stats` feeds the
``Replanner`` from.  All bookkeeping is plain host arithmetic over
deterministic inputs, so identical runs publish identical registries.

``quantile`` is THE nearest-rank percentile helper: the single
definition `FleetReport.latency_percentile` and the router's window p99
both call (they historically carried two inline copies).
"""

from __future__ import annotations

import json
import math
from typing import Dict, Iterable, List, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "MetricsWindow", "NOOP_REGISTRY", "QuantileSketch", "quantile"]


def quantile(values: Iterable[float], q: float) -> float:
    """Nearest-rank quantile over raw samples: ``sorted(v)[int(q*(n-1))]``
    (0.0 for an empty set).  The one percentile definition in the repo —
    every former inline copy routes here so call sites cannot drift."""
    vals = sorted(values)
    if not vals:
        return 0.0
    q = min(1.0, max(0.0, q))
    return vals[int(q * (len(vals) - 1))]


class QuantileSketch:
    """Deterministic streaming quantile sketch with a relative-error
    bound (the DDSketch bucket scheme on a plain dict).

    Positive samples land in logarithmic buckets ``i = ceil(log_g x)``
    with ``g = (1 + rel_err) / (1 - rel_err)``; the bucket midpoint
    ``2 g^i / (g + 1)`` is then within ``rel_err`` (relative) of every
    sample the bucket holds, so any quantile estimate ``est`` satisfies

        |est - true| <= rel_err * true

    for the sample at the nearest rank.  Zero/negative samples count in a
    dedicated zero bucket (estimate 0.0).  Memory is O(distinct buckets)
    — about ``log(max/min)/log(g)`` — independent of sample count, which
    is what lets p99 survive 10^6-request streaming traces without
    holding every latency.  All arithmetic is pure float/dict work: the
    same add sequence always yields the same buckets (merge included).
    """

    def __init__(self, rel_err: float = 0.01):
        if not 0.0 < rel_err < 1.0:
            raise ValueError(f"rel_err must be in (0, 1), got {rel_err}")
        self.rel_err = rel_err
        self.gamma = (1.0 + rel_err) / (1.0 - rel_err)
        self._lg = math.log(self.gamma)
        self._buckets: Dict[int, int] = {}
        self._zeros = 0
        self.n = 0
        self.sum = 0.0
        self.max = float("-inf")
        self.min = float("inf")

    def add(self, x: float) -> None:
        x = float(x)
        self.n += 1
        self.sum += x
        self.max = max(self.max, x)
        self.min = min(self.min, x)
        if x <= 0.0:
            self._zeros += 1
            return
        key = math.ceil(math.log(x) / self._lg)
        self._buckets[key] = self._buckets.get(key, 0) + 1

    def value_of(self, key: int) -> float:
        """The representative (midpoint) value of bucket ``key``."""
        return 2.0 * self.gamma ** key / (self.gamma + 1.0)

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile estimate (same rank convention as
        ``quantile``), within ``rel_err`` relative error of the true
        sample at that rank."""
        if self.n == 0:
            return 0.0
        q = min(1.0, max(0.0, q))
        rank = int(q * (self.n - 1))          # 0-based nearest rank
        if rank < self._zeros:
            return 0.0
        seen = self._zeros
        for key in sorted(self._buckets):
            seen += self._buckets[key]
            if rank < seen:
                return self.value_of(key)
        return self.value_of(max(self._buckets))      # float-slop guard

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """Fold ``other`` into self (same rel_err required); the result
        equals sketching the concatenated streams."""
        if other.rel_err != self.rel_err:
            raise ValueError("cannot merge sketches with different "
                             f"rel_err: {self.rel_err} vs {other.rel_err}")
        for key, c in other._buckets.items():
            self._buckets[key] = self._buckets.get(key, 0) + c
        self._zeros += other._zeros
        self.n += other.n
        self.sum += other.sum
        if other.n:
            self.max = max(self.max, other.max)
            self.min = min(self.min, other.min)
        return self

    def minus(self, older: "QuantileSketch") -> "QuantileSketch":
        """The window delta: a sketch of exactly the samples added since
        ``older`` was snapshotted from this stream (bucket-wise
        subtraction; min/max are not recoverable and report the window
        sketch's own estimates)."""
        out = QuantileSketch(self.rel_err)
        for key, c in self._buckets.items():
            d = c - older._buckets.get(key, 0)
            if d > 0:
                out._buckets[key] = d
        out._zeros = max(0, self._zeros - older._zeros)
        out.n = max(0, self.n - older.n)
        out.sum = self.sum - older.sum
        if out.n:
            out.max, out.min = self.max, self.min
        return out

    def snapshot(self) -> "QuantileSketch":
        out = QuantileSketch(self.rel_err)
        out._buckets = dict(self._buckets)
        out._zeros = self._zeros
        out.n, out.sum = self.n, self.sum
        out.max, out.min = self.max, self.min
        return out

    def to_json(self) -> dict:
        return {
            "kind": "sketch", "rel_err": self.rel_err, "count": self.n,
            "sum": self.sum,
            "min": self.min if self.n else 0.0,
            "max": self.max if self.n else 0.0,
            "p50": self.quantile(0.5), "p90": self.quantile(0.9),
            "p99": self.quantile(0.99),
            "buckets": {str(k): self._buckets[k]
                        for k in sorted(self._buckets)},
            "zeros": self._zeros,
        }


class Counter:
    """Monotone total.  ``inc`` for hot-path deltas, ``set_total`` for
    emitters that keep the authoritative absolute count locally (the
    sync is then idempotent — publishing twice is harmless)."""

    __slots__ = ("value",)
    kind = "counter"

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def set_total(self, total: float) -> None:
        self.value = float(total)


class Gauge:
    """Last-value sample."""

    __slots__ = ("value",)
    kind = "gauge"

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def max_of(self, v: float) -> None:
        self.value = max(self.value, float(v))


class Histogram:
    """A named quantile sketch (plus count/sum, which the sketch keeps)."""

    __slots__ = ("sketch",)
    kind = "histogram"

    def __init__(self, rel_err: float = 0.01):
        self.sketch = QuantileSketch(rel_err)

    def observe(self, x: float) -> None:
        self.sketch.add(x)

    def quantile(self, q: float) -> float:
        return self.sketch.quantile(q)

    @property
    def value(self) -> float:          # registry-uniform read: the count
        return float(self.sketch.n)


LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: dict) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """Named, labeled metrics with deterministic window deltas.

    Label convention across the serving stack: ``axis`` (one of
    slots/channels/execs/pages — the `SharingVector` resource the metric
    describes), ``group`` (the sharing-group id inside that axis), and
    ``worker`` (the emitting worker).  Any subset may be present;
    ``total(name)`` folds over all label sets of a name.
    """

    enabled = True

    def __init__(self, rel_err: float = 0.01):
        self.rel_err = rel_err
        self._metrics: Dict[str, Dict[LabelKey, object]] = {}

    # ----- handles --------------------------------------------------------
    def _get(self, name: str, labels: dict, factory):
        by_label = self._metrics.setdefault(name, {})
        key = _label_key(labels)
        m = by_label.get(key)
        if m is None:
            m = by_label[key] = factory()
            return m
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(name, labels, Gauge)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(name, labels,
                         lambda: Histogram(self.rel_err))

    # ----- reads ----------------------------------------------------------
    def value(self, name: str, **labels) -> float:
        by_label = self._metrics.get(name, {})
        m = by_label.get(_label_key(labels))
        return m.value if m is not None else 0.0

    def total(self, name: str) -> float:
        return sum(m.value for m in self._metrics.get(name, {}).values())

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def merged_histogram(self, name: str) -> QuantileSketch:
        """All of ``name``'s label sets folded into one sketch."""
        out = QuantileSketch(self.rel_err)
        for m in self._metrics.get(name, {}).values():
            if isinstance(m, Histogram):
                out.merge(m.sketch)
        return out

    # ----- windows --------------------------------------------------------
    def window(self) -> "MetricsWindow":
        return MetricsWindow(self)

    # ----- export ---------------------------------------------------------
    def to_json(self) -> dict:
        out = {}
        for name in sorted(self._metrics):
            rows = []
            for key in sorted(self._metrics[name]):
                m = self._metrics[name][key]
                entry = {"labels": dict(key), "kind": m.kind}
                if isinstance(m, Histogram):
                    entry.update(m.sketch.to_json())
                    entry["kind"] = "histogram"
                else:
                    entry["value"] = m.value
                rows.append(entry)
            out[name] = rows
        return {"schema": "repro-metrics-v1", "rel_err": self.rel_err,
                "metrics": out}

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)
            f.write("\n")


class MetricsWindow:
    """A snapshot of every counter (and histogram sketch) in a registry;
    ``delta*`` report what accrued since, ``roll()`` re-baselines.  The
    snapshot taken at construction is the *"baselines snapshotted NOW,
    not zero"* contract: a window opened over workers carrying history
    reads an idle first window as idle."""

    def __init__(self, registry: MetricsRegistry):
        self.registry = registry
        self._base: Dict[Tuple[str, LabelKey], float] = {}
        self._sketches: Dict[Tuple[str, LabelKey], QuantileSketch] = {}
        self.roll()

    def roll(self) -> None:
        self._base.clear()
        self._sketches.clear()
        for name, by_label in self.registry._metrics.items():
            for key, m in by_label.items():
                if isinstance(m, Histogram):
                    self._sketches[(name, key)] = m.sketch.snapshot()
                elif isinstance(m, Counter):
                    self._base[(name, key)] = m.value

    def delta(self, name: str, **labels) -> float:
        key = (name, _label_key(labels))
        return self.registry.value(name, **labels) \
            - self._base.get(key, 0.0)

    def delta_total(self, name: str) -> float:
        base = sum(v for (n, _), v in self._base.items() if n == name)
        return self.registry.total(name) - base

    def delta_histogram(self, name: str, **labels) -> QuantileSketch:
        """Sketch of exactly the samples observed since the snapshot."""
        h = self.registry.histogram(name, **labels)
        old = self._sketches.get((name, _label_key(labels)))
        if old is None:
            return h.sketch.snapshot()
        return h.sketch.minus(old)


class _NoopMetric:
    """One shared do-nothing handle for every metric kind."""

    __slots__ = ()
    kind = "noop"
    value = 0.0

    def inc(self, n: float = 1.0) -> None:
        pass

    def set_total(self, total: float) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def max_of(self, v: float) -> None:
        pass

    def observe(self, x: float) -> None:
        pass

    def quantile(self, q: float) -> float:
        return 0.0


_NOOP_METRIC = _NoopMetric()


class NoopRegistry:
    """The disabled registry: every handle is the shared no-op metric.
    One ``enabled`` check (or nothing at all — the handles are inert)
    is the entire disabled-path cost."""

    enabled = False
    rel_err = 0.0

    def counter(self, name: str, **labels):
        return _NOOP_METRIC

    gauge = counter
    histogram = counter

    def value(self, name: str, **labels) -> float:
        return 0.0

    def total(self, name: str) -> float:
        return 0.0

    def names(self) -> List[str]:
        return []

    def to_json(self) -> dict:
        return {"schema": "repro-metrics-v1", "metrics": {}}


NOOP_REGISTRY = NoopRegistry()
