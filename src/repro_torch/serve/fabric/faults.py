"""Deterministic fault injection for the serving fabric (DESIGN.md §15).

A ``FaultPlan`` is a sorted set of ``FaultSpec``s — *what* breaks,
*when* (virtual ns), and for *how long*.  The Router schedules each
spec as an ordinary event on its virtual-time heap, so a faulted run is
exactly as reproducible as a healthy one: same trace + same plan ⇒
bit-identical ``FleetReport``, goldens and all.  Nothing here touches
wall clocks, threads, or randomness.

Four fault kinds:

* ``crash``         — the worker dies fail-stop at a step boundary: its
  in-flight step commits, everything still resident (live decode slots
  and queued admissions) is lost, its pages return to the pool, and it
  never heartbeats again.  Detection + re-placement is the recovery
  layer's job (``serve/recovery.py``).
* ``stall``         — the worker freezes for ``duration_ns``: wakes are
  deferred, no steps run, no heartbeats.  Short stalls surface as
  straggler events; stalls longer than the detection deadline are
  indistinguishable from a crash and get fenced (fail-stop semantics —
  the exactly-once cursor in the client makes that safe).
* ``chan_stall``    — the dispatch channel's lock is held for
  ``duration_ns``, so every endpoint sharing it queues behind the hold
  (the paper's contention window, induced on demand).
* ``page_pressure`` — ``frac`` of the worker's FREE pages vanish for
  ``duration_ns`` (a tenant spike on the shared pool): admissions defer
  against the shrunken free list, then the pages return.

Spec grammar (the launcher's ``--faults`` flag)::

    kind@time:target[:duration[:frac]]  [, more specs]
    crash@4.5ms:w0
    stall@2.2ms:w1:1ms
    chan_stall@2.1ms:c1:500us
    page_pressure@6.1ms:w2:1ms:0.5

Times accept ``ns``/``us``/``ms`` suffixes (bare numbers are ns);
targets are ``wN`` (worker) or ``cN`` (channel; ``chan_stall`` only).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Tuple

KINDS = ("crash", "stall", "chan_stall", "page_pressure")

#: fault kinds whose target names a worker (vs a channel)
WORKER_KINDS = ("crash", "stall", "page_pressure")

_UNIT_NS = {"ns": 1.0, "us": 1_000.0, "ms": 1_000_000.0, "s": 1e9}


def _parse_time_ns(text: str) -> float:
    """'2.5ms' -> 2_500_000.0; bare numbers are nanoseconds."""
    t = text.strip().lower()
    for unit in ("ns", "us", "ms", "s"):       # 'ns' before 's'
        if t.endswith(unit) and t[: -len(unit)]:
            return float(t[: -len(unit)]) * _UNIT_NS[unit]
    return float(t)


def _fmt_time(t_ns: float) -> str:
    for unit, scale in (("ms", 1e6), ("us", 1e3)):
        v = t_ns / scale
        if v >= 1 and v == round(v, 3):
            return f"{v:g}{unit}"
    return f"{t_ns:g}ns"


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault.  ``target`` is a worker id, except for
    ``chan_stall`` where it is a channel id."""

    kind: str
    t_ns: float
    target: int
    duration_ns: float = 0.0
    frac: float = 0.5                  # page_pressure: share of free pages

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; one of {KINDS}")
        if self.t_ns < 0 or self.target < 0:
            raise ValueError(f"negative time/target in {self}")
        if self.kind in ("stall", "chan_stall", "page_pressure") \
                and self.duration_ns <= 0:
            raise ValueError(f"{self.kind} needs a positive duration")
        if not 0.0 < self.frac <= 1.0:
            raise ValueError(f"frac must be in (0, 1], got {self.frac}")

    def describe(self) -> str:
        prefix = "c" if self.kind == "chan_stall" else "w"
        s = f"{self.kind}@{_fmt_time(self.t_ns)}:{prefix}{self.target}"
        if self.kind != "crash":
            s += f":{_fmt_time(self.duration_ns)}"
        if self.kind == "page_pressure":
            s += f":{self.frac:g}"
        return s


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable, time-sorted batch of faults."""

    specs: Tuple[FaultSpec, ...] = ()

    def __post_init__(self):
        ordered = tuple(sorted(
            self.specs, key=lambda s: (s.t_ns, KINDS.index(s.kind),
                                       s.target)))
        object.__setattr__(self, "specs", ordered)

    def __iter__(self) -> Iterator[FaultSpec]:
        return iter(self.specs)

    def __len__(self) -> int:
        return len(self.specs)

    def describe(self) -> str:
        return ",".join(s.describe() for s in self.specs)

    def validate(self, n_workers: int, n_channels: int) -> "FaultPlan":
        """Raise if any spec targets outside the fleet."""
        for s in self.specs:
            n = n_channels if s.kind == "chan_stall" else n_workers
            what = "channel" if s.kind == "chan_stall" else "worker"
            if s.target >= n:
                raise ValueError(
                    f"{s.describe()}: {what} {s.target} out of range "
                    f"(fleet has {n})")
        return self


def parse_faults(text: str) -> FaultPlan:
    """Parse the ``--faults`` grammar into a ``FaultPlan``."""
    specs: List[FaultSpec] = []
    for raw in text.split(","):
        raw = raw.strip()
        if not raw:
            continue
        try:
            head, _, rest = raw.partition("@")
            if not rest:
                raise ValueError("missing '@time'")
            parts = rest.split(":")
            t_ns = _parse_time_ns(parts[0])
            if len(parts) < 2:
                raise ValueError("missing ':target'")
            tgt = parts[1].strip().lower()
            target = int(tgt.lstrip("wc") if tgt[:1] in "wc" else tgt)
            dur = _parse_time_ns(parts[2]) if len(parts) > 2 else 0.0
            frac = float(parts[3]) if len(parts) > 3 else 0.5
            specs.append(FaultSpec(kind=head.strip(), t_ns=t_ns,
                                   target=target, duration_ns=dur,
                                   frac=frac))
        except (ValueError, IndexError) as e:
            raise ValueError(f"bad fault spec {raw!r}: {e}") from None
    return FaultPlan(tuple(specs))


class FaultInjector:
    """Binds a ``FaultPlan`` to one Router run.

    The Router asks for :meth:`schedule` once (at ``run()`` start) and
    pushes each ``(t_ns, spec)`` onto its event heap; when the event
    pops it applies the fault and calls :meth:`fire`.  The injector is
    pure bookkeeping — all mutation happens through Router hooks — so
    determinism is inherited from the event loop."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.fired: List[FaultSpec] = []

    def schedule(self) -> List[Tuple[float, FaultSpec]]:
        return [(s.t_ns, s) for s in self.plan]

    def fire(self, spec: FaultSpec) -> None:
        self.fired.append(spec)

    @property
    def n_fired(self) -> int:
        return len(self.fired)


def canonical_crash_plan() -> FaultPlan:
    """THE single-crash plan for goldens/benches: kill worker 0 at
    4.5 ms — mid-decode of the canonical bursty trace's third burst, so
    w0 dies holding live prefixes AND queued admissions."""
    return FaultPlan((FaultSpec("crash", 4_500_000.0, 0),))


def canonical_chaos_plan() -> FaultPlan:
    """All four fault kinds on one run: a channel-lock hold and a worker
    stall inside burst 2, a page-pool spike inside burst 4, and the
    canonical w0 crash in between."""
    return FaultPlan((
        FaultSpec("chan_stall", 2_100_000.0, 1, duration_ns=500_000.0),
        FaultSpec("stall", 2_200_000.0, 1, duration_ns=1_000_000.0),
        FaultSpec("crash", 4_500_000.0, 0),
        FaultSpec("page_pressure", 6_100_000.0, 2,
                  duration_ns=1_000_000.0, frac=0.5),
    ))
