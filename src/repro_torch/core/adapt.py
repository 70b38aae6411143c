"""Online adaptive re-planning: live ``SharingVector`` migration.

The port's own copy of ``repro.core.adapt``, the controller whole.

The paper's ``shared_dynamic``/``dynamic`` categories are *runtime*
ideas — UARs and TDs are allocated and reclaimed as contention shifts —
yet through DESIGN.md §11 a plan's ``SharingVector`` was chosen once at
``serve.connect`` time and frozen for the fleet's lifetime.  This module
is the missing controller (DESIGN.md §12): a deterministic ``Replanner``
samples per-resource telemetry over a sliding window and proposes
one-level ``SharingVector`` transitions under a hysteresis policy —

* **promote** a resource toward dedicated (level − 1) on sustained
  contention (pressure ≥ ``hi`` for ``patience`` consecutive windows —
  default 1: contention is the expensive direction, so promotion is the
  fast path);
* **demote** it toward shared (level + 1) on sustained idleness
  (pressure ≤ ``lo`` for ``demote_patience`` consecutive windows, plus a
  ``cooldown`` hold after each demotion — capacity is released lazily);
* **hold** in the dead band and whenever the pressure direction flips
  (a flip restarts the streak — the hysteresis core);
* never exceed a ``footprint_budget`` (``Hints``' knob): a promotion
  that would overrun the budget is withheld until sharing elsewhere
  pays for it.

The policy is pure bookkeeping over ``WindowStats`` — no wall clock, no
randomness — so identical telemetry replays identical transition
schedules, and three properties hold by construction:

* constant telemetry never oscillates: a constant pressure pins a
  constant direction, so each resource's level trajectory is monotone
  and converges;
* transitions are monotone in contention: higher pressure never yields a
  *more shared* level than lower pressure over the same horizon;
* any level is reachable from any other within
  ``max_windows_to_reach()`` windows given suitable telemetry.

Executing a proposal is the serving stack's job: ``SlotPool.regroup``
remaps admission groups without evicting in-flight slots, the fabric
``Router`` rebuilds its dispatch plan draining queued work in arrival
order, and engines move to another exec group (their future horizon
captures draw on its graph memory pool; the graphs they have keep
running).  Migration changes WHEN tokens are produced, never their
values.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Tuple

from repro_torch.core.plan import (PAGED_RESOURCES, RESOURCES, SharingVector,
                             fit_budget)

#: Sacrifice order when a budget blocks several promotions at once:
#: withhold the cheapest-benefit promotion first — execs (bit-exact,
#: only compile locality), then channels, keeping slots (the most
#: scheduling freedom) longest.  This is exactly the planner's bump
#: order (``core.plan.RESOURCES``).
_SACRIFICE_ORDER = RESOURCES


@dataclasses.dataclass(frozen=True)
class WindowStats:
    """One adaptation window's aggregated telemetry.

    Every field is already emitted by the serving stack: ``occupancy``
    from the slot pools' busy/total slot-step counters, ``queue_depth``
    (peak queued requests per draining worker) and ``lock_wait_ns`` from
    the dispatch channels, ``p99_ms`` from the window's completions, and
    ``jit_compiles`` from the executable cache.  A window with no
    activity is all-zero — the idleness signal.
    """

    occupancy: float = 0.0        # busy_slot_steps / slot_steps (0 idle)
    queue_depth: float = 0.0      # peak queued per worker in the window
    lock_wait_ns: float = 0.0     # channel-lock wait accrued in window
    p99_ms: float = 0.0           # window completions' p99 latency
    jit_compiles: int = 0         # fresh executable compiles in window
    tokens: int = 0               # tokens produced in the window
    page_pressure: float = 0.0    # live-page fraction of the KV page
    #                               pool (``PagePool.pressure``); stays 0
    #                               on contiguous layouts


class Replanner:
    """Deterministic hysteresis controller over the sharing-vector space.

    Feed one ``WindowStats`` per adaptation window through ``observe``;
    it returns the new ``SharingVector`` when a transition fires, else
    None.  The controller owns no execution — callers apply returned
    vectors to their pools/channels/executables.
    """

    def __init__(self, vector: SharingVector = None, *,
                 n_workers: int = 1, n_slots: int = 4,
                 window: int = 2, patience: int = 1,
                 demote_patience: int = 3, cooldown: int = 1,
                 hi: float = 0.7, lo: float = 0.2,
                 depth_scale: float = 2.0, compile_scale: float = 4.0,
                 budget: Optional[float] = None, paged: bool = False,
                 repository=None):
        if not 0.0 <= lo < hi <= 1.0:
            raise ValueError(f"need 0 <= lo < hi <= 1, got lo={lo} hi={hi}")
        if window < 1 or patience < 1 or demote_patience < 1 \
                or cooldown < 0:
            raise ValueError("window/patience must be >= 1, cooldown >= 0")
        if budget is not None and budget <= 0.0:
            raise ValueError("footprint budget must be positive")
        self.n_workers = max(1, n_workers)
        self.n_slots = max(1, n_slots)
        self.window = window
        self.patience = patience
        self.demote_patience = demote_patience
        self.cooldown = cooldown
        self.hi, self.lo = hi, lo
        self.depth_scale = depth_scale
        self.compile_scale = compile_scale
        self.budget = budget
        #: paged=True adds the ``pages`` axis (KV page-pool sharing) to
        #: the controlled set — off by default so every pre-pages
        #: deployment (and its committed transition traces) is unchanged.
        self.paged = bool(paged)
        self._resources = PAGED_RESOURCES if paged else RESOURCES
        #: optional tuned-plan store (duck-typed ``frontier_vectors``,
        #: canonically ``tune.PlanRepository``, DESIGN.md §16): when the
        #: hysteresis fires, jump to the NEAREST stored Pareto-frontier
        #: vector in the fired direction instead of stepping one level
        #: on one axis.  None (the default) keeps the single-axis
        #: stepping bit-identical to the historical controller.
        self.repository = repository
        self.vector = self._fit_budget(vector or SharingVector.diagonal(2))
        self._win: deque = deque(maxlen=window)
        self._streak: Dict[str, int] = {r: 0 for r in self._resources}
        self._dir: Dict[str, int] = {r: 0 for r in self._resources}
        self._cool: Dict[str, int] = {r: 0 for r in self._resources}
        self._windows = 0
        #: (window index, vector) after every applied transition
        self.transitions: List[Tuple[int, SharingVector]] = []

    # ----- budget ---------------------------------------------------------
    def _score(self, vec: SharingVector) -> float:
        return vec.footprint_score(self.n_workers, self.n_slots)

    def _fit_budget(self, vec: SharingVector) -> SharingVector:
        """Clamp the starting vector through the planner's one budget
        loop (``core.plan.fit_budget``)."""
        return fit_budget(vec, self.budget, n_workers=self.n_workers,
                          n_slots=self.n_slots)

    # ----- pressures ------------------------------------------------------
    def _pressure_of(self, occ: float, depth: float, compiles: float,
                     page: float = 0.0) -> Dict[str, float]:
        """Per-resource pressure in [0, 1] from raw telemetry.

        slots: occupancy, or queued backlog when admission is the
        bottleneck (a starved shared pool shows low occupancy but a deep
        queue); channels: per-worker backlog against ``depth_scale``;
        execs: fresh-compile rate against ``compile_scale`` (an idle
        executable cache is safely shareable — sharing execs is
        bit-exact and only costs compile locality); pages (paged mode):
        the pool's live-page fraction straight through.
        """
        clamp = lambda x: min(1.0, max(0.0, x))
        backlog = clamp(depth / self.depth_scale)
        p = {
            "slots": max(clamp(occ), backlog),
            "channels": backlog,
            "execs": clamp(compiles / self.compile_scale),
        }
        if self.paged:
            p["pages"] = clamp(page)
        return p

    def pressures(self) -> Dict[str, float]:
        """Window-MEAN pressures — the sustained signal demotion needs."""
        if not self._win:
            return {r: 0.0 for r in self._resources}
        n = len(self._win)
        return self._pressure_of(
            sum(s.occupancy for s in self._win) / n,
            sum(s.queue_depth for s in self._win) / n,
            sum(s.jit_compiles for s in self._win) / n,
            sum(s.page_pressure for s in self._win) / n)

    def _spot_pressures(self) -> Dict[str, float]:
        """Latest-sample pressures — the spike signal promotion reacts
        to (a burst must not wait for the sliding mean to catch up)."""
        s = self._win[-1]
        return self._pressure_of(s.occupancy, s.queue_depth,
                                 s.jit_compiles, s.page_pressure)

    # ----- the hysteresis step -------------------------------------------
    def observe(self, stats: WindowStats) -> Optional[SharingVector]:
        """Feed one window of telemetry; -> the new vector if a
        transition fires, else None."""
        self._win.append(stats)
        self._windows += 1
        mean = self.pressures()
        spot = self._spot_pressures()
        moves: Dict[str, int] = {}
        for r in self._resources:
            level = getattr(self.vector, r)
            # pages is the INVERTED axis: its capacity lives in the
            # pooling itself (a group hitting its budget while other
            # groups idle is cured by sharing harder, not dedicating),
            # so pool pressure drives pages toward shared and idleness
            # back toward dedicated — the mirror image of the
            # scheduling axes, on the same hysteresis machinery.
            fast = +1 if r == "pages" else -1     # pressure response
            slow = -fast                          # idleness response
            if spot[r] >= self.hi and 1 <= level + fast <= 4:
                want = fast
            elif max(mean[r], spot[r]) <= self.lo \
                    and 1 <= level + slow <= 4:
                want = slow
            else:
                self._streak[r], self._dir[r] = 0, 0
                self._cool[r] = max(0, self._cool[r] - 1)
                continue
            if want == slow and self._cool[r] > 0:
                self._cool[r] -= 1    # lazy-release hold after idleness
                self._streak[r] = 0
                continue
            # a direction flip restarts the streak — the hysteresis core
            self._streak[r] = self._streak[r] + 1 \
                if self._dir[r] == want else 1
            self._dir[r] = want
            need = self.patience if want == fast \
                else self.demote_patience
            if self._streak[r] >= need:
                moves[r] = level + want
        if not moves:
            return None
        cand = dataclasses.replace(self.vector, **moves)
        if self.budget is not None:
            # withhold footprint-raising moves (cheapest benefit first:
            # pages dedication, then execs, channels, slots last) until
            # the candidate fits; withheld streaks stay saturated so the
            # move lands the moment sharing elsewhere pays for it
            order = (("pages",) + _SACRIFICE_ORDER if self.paged
                     else _SACRIFICE_ORDER)
            for r in order:
                if self._score(cand) <= self.budget:
                    break
                if r in moves and moves[r] < getattr(self.vector, r):
                    del moves[r]
                    cand = dataclasses.replace(self.vector, **moves)
        if not moves or cand == self.vector:
            return None
        if self.repository is not None:
            jump = self._repository_jump(moves)
            if jump is not None:
                # repository-guided transition: land ON a measured
                # frontier plan instead of an arbitrary intermediate
                # point, in possibly several levels at once
                cand = jump
                moves = {r: getattr(cand, r) for r in self._resources
                         if getattr(cand, r) != getattr(self.vector, r)}
        for r in moves:
            self._streak[r] = 0
            slow = -1 if r == "pages" else +1
            if (moves[r] - getattr(self.vector, r)) * slow > 0:
                self._cool[r] = self.cooldown   # idleness releases lazily
        self.vector = cand
        self.transitions.append((self._windows, cand))
        return cand

    def _repository_jump(self, moves: Dict[str, int]
                         ) -> Optional[SharingVector]:
        """The nearest stored frontier vector that moves EVERY fired
        resource in its fired direction (DESIGN.md §16) — the hysteresis
        decides *when* and *which way*, the repository decides *where to
        land*.  None (single-axis fallback) when no stored plan agrees:
        the controller never trusts a tuned plan against live pressure.

        Candidates must hold the pages axis fixed when the controller
        does not own it (``paged=False``) and must fit the footprint
        budget; "nearest" is L1 distance over all four axes with a
        deterministic per-axis tie-break."""
        cur = self.vector
        want = {r: moves[r] - getattr(cur, r) for r in moves}
        cands = []
        for vec in self.repository.frontier_vectors(
                n_workers=self.n_workers, n_slots=self.n_slots):
            if vec == cur:
                continue
            if not self.paged and vec.pages != cur.pages:
                continue
            if self.budget is not None \
                    and self._score(vec) > self.budget:
                continue
            if all((getattr(vec, r) - getattr(cur, r)) * d > 0
                   for r, d in want.items()):
                cands.append(vec)
        if not cands:
            return None
        return min(cands, key=lambda v: (
            sum(abs(getattr(v, r) - getattr(cur, r))
                for r in PAGED_RESOURCES),
            v.slots, v.channels, v.execs, v.pages))

    # ----- derived --------------------------------------------------------
    def footprint_score(self) -> float:
        return self._score(self.vector)

    def max_windows_to_reach(self, level_distance: int = 3) -> int:
        """Upper bound on windows to move one resource
        ``level_distance`` levels under saturated telemetry, in either
        direction: promotion chains pace at ``patience`` windows per
        level; demotion chains additionally pay the ``cooldown`` hold
        between levels."""
        d = max(0, level_distance)
        if d == 0:
            return 0
        demote = self.demote_patience \
            + (d - 1) * (self.demote_patience + self.cooldown)
        return max(d * self.patience, demote)

    def __repr__(self):
        v = self.vector
        return (f"Replanner(vector={v.label}, "
                f"window={self.window}, patience={self.patience}, "
                f"cooldown={self.cooldown}, hi={self.hi}, lo={self.lo}, "
                f"budget={self.budget}, windows={self._windows}, "
                f"transitions={len(self.transitions)})")


__all__ = ["Replanner", "WindowStats"]
