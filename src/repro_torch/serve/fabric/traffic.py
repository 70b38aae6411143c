"""Traffic generators for the serving fabric (DESIGN.md §9).

Every generator returns a list of ``Arrival``s sorted by virtual arrival
time (nanoseconds, float) and is fully determined by its arguments — the
same seed always replays the same trace, which is what makes fleet
behavior unit-testable and the bench sweeps reproducible.

Four shapes:
  * ``poisson_trace``   — memoryless open-loop load (exponential gaps).
  * ``bursty_trace``    — whole bursts land at one instant, the dispatch
    analogue of the paper's "all threads post at once" contention window;
    this is the trace that separates dedicated queues (head-of-line
    blocking) from shared queue groups (any group member may pull).
  * ``session_trace``   — multi-turn sessions with think time; turns
    carry the session id so affinity placement has something to key on.
  * ``phased_trace``    — the adaptive-replanning workload (DESIGN.md
    §12): poisson → burst → idle → burst, so the best static
    ``SharingVector`` SHIFTS mid-trace and a frozen plan must lose
    throughput or waste footprint on at least one phase.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One request entering the fabric at virtual time ``t_ns``.

    ``deadline_ns``/``priority`` exist for the chaos/recovery layer
    (DESIGN.md §15): a deadline in virtual time after which admitting
    the request is pointless (the Router sheds it BEFORE accepting),
    and a priority tier (higher = more important) that orders overload
    shedding.  Both default to "no constraint" so every pre-existing
    trace, golden, and bench row is byte-identical."""

    rid: int
    t_ns: float
    prompt_len: int
    max_new_tokens: int
    session: int = -1                 # -1 = sessionless
    deadline_ns: float = -1.0         # -1 = no deadline
    priority: int = 0                 # higher tiers shed last

    @property
    def cost_tokens(self) -> int:
        """Total tokens this request moves through a worker."""
        return self.prompt_len + self.max_new_tokens


def _check_counts(**counts) -> None:
    """Generator-argument validation shared by all four shapes: request
    counts must be non-negative (zero is a graceful empty trace), burst
    sizes strictly positive (they divide)."""
    for name, value in counts.items():
        if name == "burst_size":
            if value < 1:
                raise ValueError(f"burst_size must be >= 1, got {value}")
        elif value < 0:
            raise ValueError(f"{name} must be >= 0, got {value}")


def _draw(rng, rid, t, prompt_lens, new_tokens, session=-1) -> Arrival:
    lo, hi = new_tokens
    return Arrival(rid=rid, t_ns=float(t),
                   prompt_len=int(rng.choice(prompt_lens)),
                   max_new_tokens=int(rng.integers(lo, hi + 1)),
                   session=session)


def poisson_trace(n_requests: int, *,
                  mean_gap_ns: float = 60_000.0,
                  prompt_lens: Sequence[int] = (8, 16, 32),
                  new_tokens: Tuple[int, int] = (4, 16),
                  seed: int = 0) -> List[Arrival]:
    """Open-loop Poisson arrivals: exponential inter-arrival gaps."""
    _check_counts(n_requests=n_requests)
    rng = np.random.default_rng(seed)
    out, t = [], 0.0
    for rid in range(n_requests):
        t += float(rng.exponential(mean_gap_ns))
        out.append(_draw(rng, rid, t, prompt_lens, new_tokens))
    return out


def bursty_trace(n_requests: int, *,
                 burst_size: int = 6,
                 burst_gap_ns: float = 500_000.0,
                 prompt_lens: Sequence[int] = (8, 16, 32),
                 new_tokens: Tuple[int, int] = (2, 24),
                 seed: int = 0) -> List[Arrival]:
    """Bursts of ``burst_size`` simultaneous arrivals every
    ``burst_gap_ns``.  Request sizes inside a burst are deliberately
    heterogeneous (wide ``new_tokens`` spread) so blind per-worker
    placement strands short requests behind long ones."""
    _check_counts(n_requests=n_requests, burst_size=burst_size)
    rng = np.random.default_rng(seed)
    out = []
    for rid in range(n_requests):
        t = (rid // burst_size) * burst_gap_ns
        out.append(_draw(rng, rid, t, prompt_lens, new_tokens))
    return out


def session_trace(n_sessions: int, turns_per_session: int, *,
                  think_ns: float = 300_000.0,
                  session_stagger_ns: float = 40_000.0,
                  prompt_lens: Sequence[int] = (8, 16, 32),
                  new_tokens: Tuple[int, int] = (4, 16),
                  seed: int = 0) -> List[Arrival]:
    """Session replay: each session issues ``turns_per_session`` turns
    separated by an exponential think time; sessions start staggered.
    Turns of one session share its ``session`` id (affinity key)."""
    _check_counts(n_sessions=n_sessions,
                  turns_per_session=turns_per_session)
    rng = np.random.default_rng(seed)
    out, rid = [], 0
    for s in range(n_sessions):
        t = s * session_stagger_ns
        for _ in range(turns_per_session):
            out.append(_draw(rng, rid, t, prompt_lens, new_tokens,
                             session=s))
            rid += 1
            t += float(rng.exponential(think_ns))
    out.sort(key=lambda a: (a.t_ns, a.rid))
    return out


@dataclasses.dataclass(frozen=True)
class Phase:
    """One arrival-time interval of a phased trace.  ``t_end_ns`` is the
    start of the next phase (exclusive); requests belong to the phase
    their ARRIVAL falls in, even if they complete later."""

    name: str
    t_start_ns: float
    t_end_ns: float

    @property
    def duration_ns(self) -> float:
        return self.t_end_ns - self.t_start_ns

    def arrivals(self, trace: Sequence[Arrival]) -> List[Arrival]:
        return [a for a in trace
                if self.t_start_ns <= a.t_ns < self.t_end_ns]


def phased_trace(requests_per_phase: int = 24, *,
                 mean_gap_ns: float = 40_000.0,
                 burst_size: int = 12,
                 burst_gap_ns: float = 400_000.0,
                 idle_ns: float = 4_000_000.0,
                 prompt_lens: Sequence[int] = (8, 16, 32),
                 new_tokens: Tuple[int, int] = (2, 24),
                 seed: int = 0) -> Tuple[List[Arrival], List[Phase]]:
    """Phase-shifting traffic: poisson → burst → idle → burst.

    The workload whose best static plan changes mid-trace — steady
    poisson load rewards dedicated resources, the bursts punish grouped
    admission hardest, and the idle window makes a dedicated plan pure
    footprint waste.  Returns ``(arrivals, phases)``; arrivals are
    sorted by ``(t_ns, rid)`` and phases partition the arrival span.
    """
    _check_counts(requests_per_phase=requests_per_phase,
                  burst_size=burst_size)
    rng = np.random.default_rng(seed)
    out: List[Arrival] = []
    phases: List[Phase] = []
    rid, t = 0, 0.0

    start = t
    for _ in range(requests_per_phase):          # phase 1: poisson
        t += float(rng.exponential(mean_gap_ns))
        out.append(_draw(rng, rid, t, prompt_lens, new_tokens))
        rid += 1
    t += mean_gap_ns                             # boundary gap
    phases.append(Phase("poisson", start, t))

    def burst_phase(name: str, t0: float) -> float:
        tb = t0
        for i in range(requests_per_phase):
            tb = t0 + (i // burst_size) * burst_gap_ns
            out.append(_draw(rng, rid + i, tb, prompt_lens, new_tokens))
        end = tb + burst_gap_ns
        phases.append(Phase(name, t0, end))
        return end

    t = burst_phase("burst", t)
    rid += requests_per_phase

    phases.append(Phase("idle", t, t + idle_ns))  # phase 3: nothing lands
    t += idle_ns

    burst_phase("burst2", t)
    out.sort(key=lambda a: (a.t_ns, a.rid))
    return out, phases


def canonical_phased_trace() -> Tuple[List[Arrival], List[Phase]]:
    """THE deterministic phased trace (adaptive bench + tests): 48
    requests per busy phase on an 8-worker fleet, each burst phase
    landing as ONE 48-request instant — 1.5× the fleet's 32 decode slots,
    so grouped admission pays real head-of-line blocking — and a 4 ms
    idle window, long enough that a frozen dedicated plan's footprint
    waste dominates its mean, short enough that the bench stays
    milliseconds."""
    return phased_trace(48, burst_size=48, mean_gap_ns=30_000.0, seed=5)


def canonical_bursty_trace() -> List[Arrival]:
    """THE deterministic bursty trace (tests + bench acceptance row): 4
    bursts of 24 heterogeneous requests on an 8-worker fleet — enough
    simultaneous skew that dedicated queues pay head-of-line blocking
    while any sharing level keeps ≥ 0.9x dedicated throughput."""
    return bursty_trace(96, burst_size=24, burst_gap_ns=2_000_000.0,
                        new_tokens=(2, 24), seed=3)


def canonical_faulted_trace() -> List[Arrival]:
    """THE deterministic chaos-workload trace (fault tests + golden +
    bench): the canonical bursty trace re-annotated with priority tiers
    (``rid % 3`` — so every burst mixes all tiers) and a per-request
    deadline two burst gaps after arrival on the LOWEST tier only.  The
    token schedule of a fault-free run is identical to
    ``canonical_bursty_trace`` because annotations only matter once the
    Router's recovery layer is armed."""
    out = []
    for a in canonical_bursty_trace():
        pri = a.rid % 3
        ddl = a.t_ns + 4_000_000.0 if pri == 0 else -1.0
        out.append(dataclasses.replace(a, priority=pri, deadline_ns=ddl))
    return out


TRAFFIC_SHAPES = {
    "poisson": lambda n, seed=0: poisson_trace(n, seed=seed),
    "bursty": lambda n, seed=0: bursty_trace(n, seed=seed),
    "session": lambda n, seed=0: session_trace(
        max(1, n // 4), 4, seed=seed),
    "phased": lambda n, seed=0: phased_trace(
        max(1, n // 3), seed=seed)[0],
}
