"""Crash recovery for the serving fabric (DESIGN.md §15).

The Router owns the event loop; this module owns the *policy* and the
*state* of surviving failures on it:

* ``RecoveryPolicy`` — the knobs: heartbeat cadence and detection
  deadline (virtual ns), capped exponential retry backoff, overload
  shed capacity, straggler thresholds.
* ``LostWork``       — what a dead worker was holding for one request:
  how many tokens it had already emitted and (for real-engine workers)
  the token prefix itself, so the request can be re-admitted on a
  survivor as ``prompt + prefix`` and decoding resumes bit-exactly
  (greedy argmax is a pure function of the context).
* ``RecoveryManager`` — per-run bookkeeping: virtual heartbeats, death
  fences, detection marks, per-request attempt counts and accumulated
  prefixes, shed/failed/recovered ledgers, recovery latencies.  Pure
  bookkeeping — every mutation is driven by a Router event, so a
  faulted run replays bit-identically.

Failure model (fail-stop at step boundaries): a worker's step is
atomic — a crash voids nothing already committed and loses everything
still resident.  Detection is heartbeat/deadline based: workers beat at
every wake; a probe event fires every ``heartbeat_ns`` and declares a
worker dead once it holds work but has not beaten for ``deadline_ns``.
Stalls longer than the deadline are *indistinguishable* from crashes
and get fenced the same way (if the stalled worker later wakes, the
fence voids it) — the client's exactly-once cursor makes that safe.

The straggler policy is NOT re-implemented here: the Router feeds its
virtual wake-to-wake gaps into ``runtime.fault_tolerance.
StragglerMitigator`` — the same rolling-median detector the training
stack uses — and avoids placing new work on straggling workers.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.runtime.fault_tolerance import StragglerMitigator


@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """Failure-handling knobs, all in virtual time.

    Defaults assume fleet step costs in the tens of microseconds (the
    ``FabricCosts`` scale): the deadline must exceed the largest single
    step a healthy worker can take, or busy workers get fenced as dead.
    Fused-horizon engine fleets (K×30 µs steps) should widen it."""

    heartbeat_ns: float = 100_000.0   # probe cadence
    deadline_ns: float = 400_000.0    # silence ⇒ declared dead
    backoff_base_ns: float = 50_000.0
    backoff_cap_ns: float = 800_000.0
    max_retries: int = 5              # per request, across workers
    shed_capacity: int = 0            # max outstanding; 0 = unlimited
    straggler_factor: float = 3.0
    straggler_patience: int = 2
    straggler_window: int = 16

    def backoff_ns(self, attempt: int) -> float:
        """Delay before re-placement attempt ``attempt`` (1-based).
        First retry is immediate — the work is known-lost, waiting buys
        nothing — then exponential: base·2^(k−2), capped."""
        if attempt <= 1:
            return 0.0
        return min(self.backoff_cap_ns,
                   self.backoff_base_ns * (2.0 ** (attempt - 2)))

    def shed_threshold(self, priority: int) -> int:
        """Outstanding-request level at which ``priority`` tier sheds.
        Tier p admits until C·(1 − 2^−(p+1)): tier 0 sheds at C/2,
        tier 1 at 3C/4, ... — lowest tiers always shed first and no
        tier is admitted past capacity."""
        c = self.shed_capacity
        if c <= 0:
            return 0
        return max(1, int(c * (1.0 - 0.5 ** (priority + 1))))


@dataclasses.dataclass
class LostWork:
    """One request's residue on a dead worker.  ``emitted`` counts the
    tokens committed before the crash (0 for still-queued admissions);
    ``tokens`` carries the actual ids when the worker ran a real engine
    (sim workers only track counts)."""

    rid: int
    emitted: int = 0
    tokens: Optional[List[int]] = None
    eos_id: int = -1


class RecoveryManager:
    """All mutable fault-tolerance state for one Router run."""

    def __init__(self, policy: RecoveryPolicy, n_workers: int,
                 critical=None):
        self.policy = policy
        self.n_workers = n_workers
        #: the worker subset new arrivals cannot be served without —
        #: under prefill/decode disaggregation (DESIGN.md §17) that is
        #: the PREFILL sub-fleet (a fresh prompt needs a prefill worker
        #: even while decode workers live); None = any worker will do
        self.critical: Optional[Tuple[int, ...]] = (
            tuple(critical) if critical is not None else None)
        self.beats = [0.0] * n_workers            # last proof of life
        self.dead: List[Optional[float]] = [None] * n_workers
        self.detected: List[Optional[float]] = [None] * n_workers
        self.stall_until = [0.0] * n_workers
        self.straggling = [False] * n_workers
        self.mitigators = [
            StragglerMitigator(window=policy.straggler_window,
                               factor=policy.straggler_factor,
                               patience=policy.straggler_patience)
            for _ in range(n_workers)]
        # retry bookkeeping, keyed by rid
        self.attempts: Dict[int, int] = {}
        self.prefix_emitted: Dict[int, int] = {}
        self.prefix_tokens: Dict[int, List[int]] = {}
        # ledgers
        self.shed: List[Tuple[int, str, float]] = []   # (rid, reason, t)
        self.failed: List[int] = []       # retry budget exhausted
        self.recovered: List[int] = []    # completed after ≥1 retry
        self.retries = 0                  # re-placements scheduled
        self.detections = 0
        self.latency_ns: List[float] = [] # death→detection per worker
        self.duplicates = 0               # defensive: dup completions

    # ---- liveness ---------------------------------------------------
    def beat(self, w: int, t: float) -> None:
        if t > self.beats[w]:
            self.beats[w] = t

    def fenced(self, w: int) -> bool:
        return self.dead[w] is not None

    def is_detected(self, w: int) -> bool:
        return self.detected[w] is not None

    def overdue(self, w: int, t: float) -> bool:
        return (t - self.beats[w]) > self.policy.deadline_ns

    def mark_dead(self, w: int, t: float) -> None:
        if self.dead[w] is None:
            self.dead[w] = t

    def mark_detected(self, w: int, t: float) -> float:
        """-> outage-to-detection latency (ns).  The outage reference is
        the physical death time when known (crash fault), else the last
        heartbeat (stall fenced as dead)."""
        self.detected[w] = t
        self.detections += 1
        ref = self.dead[w] if self.dead[w] is not None else self.beats[w]
        lat = max(0.0, t - ref)
        self.latency_ns.append(lat)
        return lat

    def live_workers(self) -> List[int]:
        return [w for w in range(self.n_workers) if not self.fenced(w)]

    # ---- stragglers -------------------------------------------------
    def observe_gap(self, w: int, t: float) -> bool:
        """Feed the wake-to-wake gap into the shared StragglerMitigator.
        Call BEFORE beating ``w`` at ``t``.  -> True when the mitigator
        fires (worker newly marked straggling)."""
        gap = max(0.0, t - self.beats[w])
        m = self.mitigators[w]
        n_events = len(m.events)
        fired = m.observe(step=int(t), step_time_s=gap)
        if fired:
            self.straggling[w] = True
        elif len(m.events) == n_events:
            self.straggling[w] = False    # a normal step clears the mark
        return fired

    # ---- shedding ---------------------------------------------------
    def shed_reason(self, arrival, t: float,
                    outstanding: int) -> Optional[str]:
        """Why this arrival must be shed BEFORE acceptance, or None."""
        pool = (self.critical if self.critical is not None
                else range(self.n_workers))
        if all(self.is_detected(w) for w in pool):
            return "no_workers"
        if arrival.deadline_ns >= 0 and t > arrival.deadline_ns:
            return "deadline"
        thr = self.policy.shed_threshold(arrival.priority)
        if thr and outstanding >= thr:
            return "capacity"
        return None

    def record_shed(self, rid: int, reason: str, t: float) -> None:
        self.shed.append((rid, reason, t))

    # ---- retries ----------------------------------------------------
    def note_lost(self, lost: LostWork) -> None:
        """Fold one worker's residue into the request's cumulative
        prefix (a request can lose work on several workers in turn)."""
        self.prefix_emitted[lost.rid] = \
            self.prefix_emitted.get(lost.rid, 0) + lost.emitted
        if lost.tokens:
            self.prefix_tokens.setdefault(lost.rid, []).extend(lost.tokens)

    def next_attempt(self, rid: int) -> Optional[float]:
        """Register a re-placement attempt for ``rid``; -> backoff delay
        ns, or None when the retry budget is exhausted (request failed).
        """
        a = self.attempts.get(rid, 0) + 1
        self.attempts[rid] = a
        if a > self.policy.max_retries:
            self.failed.append(rid)
            return None
        self.retries += 1
        return self.policy.backoff_ns(a)

    def prefix_of(self, rid: int) -> Tuple[int, Optional[List[int]]]:
        return (self.prefix_emitted.get(rid, 0),
                self.prefix_tokens.get(rid))

    def note_completed(self, rid: int) -> None:
        if self.attempts.get(rid, 0) > 0:
            self.recovered.append(rid)

    # ---- reporting --------------------------------------------------
    def summary(self) -> dict:
        lat_ms = sorted(x / 1e6 for x in self.latency_ns)
        return {
            "detections": self.detections,
            "retries": self.retries,
            "recovered": len(self.recovered),
            "failed": len(self.failed),
            "shed": len(self.shed),
            "duplicates": self.duplicates,
            "recovery_latency_ms": lat_ms,
        }
