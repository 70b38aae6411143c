"""Dispatch channels: the fleet-level endpoints of the serving fabric.

A ``DispatchChannel`` is one request queue plus the serially-held lock
protecting it — the same ``Resource`` next-free timeline the ibsim sender
loop uses for QP/uUAR/CQ locks (``core.ibsim.engine.Resource``), so
queueing contention *emerges* from how many workers the
``core.channels.DispatchPlan`` hangs off one channel rather than being a
per-category constant: a dedicated channel per worker never waits on its
lock, a k-way-shared channel serializes the k group members' pops inside
a burst, and the single global channel of the MPI+threads plan serializes
the whole fleet.
"""

from __future__ import annotations

from collections import deque
from typing import Optional, Tuple

from repro_torch.core.ibsim.engine import Resource
from repro_torch.obs.trace import NOOP_RECORDER, PID_RESOURCES, TID_CHANNEL0


class DispatchChannel:
    """One dispatch queue shared by a group of workers.

    ``recorder`` (an ``obs.FlightRecorder``; default no-op) receives an
    instant event per contended lock acquisition — the channel-lock-wait
    telemetry of the flight recorder (DESIGN.md §14)."""

    def __init__(self, cid: int, workers, recorder=None):
        self.cid = cid
        self.workers = tuple(workers)
        self._q: deque = deque()
        self.lock = Resource()
        self._rec = recorder if recorder is not None else NOOP_RECORDER
        self.stats = {"enqueued": 0, "dequeued": 0,
                      "lock_wait_ns": 0.0, "lock_hold_ns": 0.0,
                      "peak_depth": 0, "win_peak_depth": 0}

    def __len__(self) -> int:
        return len(self._q)

    def reset_window(self) -> int:
        """-> the peak depth since the last reset, then re-baseline to
        the CURRENT depth (a standing backlog keeps signalling) — the
        adaptive controller's per-window contention probe."""
        peak = self.stats["win_peak_depth"]
        self.stats["win_peak_depth"] = len(self._q)
        return peak

    def drain(self) -> list:
        """Remove and return every queued item (migration: the router
        re-places them, in arrival order, onto a rebuilt channel set).
        No lock cost — the fabric is quiesced at a replan point."""
        items = list(self._q)
        self._q.clear()
        return items

    def _locked(self, t_ns: float, hold_ns: float) -> float:
        start, end = self.lock.acquire(t_ns, hold_ns)
        wait = start - t_ns
        self.stats["lock_wait_ns"] += wait
        self.stats["lock_hold_ns"] += hold_ns
        if wait > 0.0 and self._rec.enabled:
            self._rec.instant(PID_RESOURCES, TID_CHANNEL0 + self.cid,
                              "lock_wait", t_ns, cat="channels",
                              args={"wait_ns": wait, "queue": self.cid})
        return end

    def hold(self, t_ns: float, hold_ns: float) -> float:
        """Occupy the channel lock for ``hold_ns`` without touching the
        queue — the chaos fabric's ``chan_stall`` fault: every push/pop
        sharing this channel serializes behind the hold, so the
        contention window shows up in lock-wait telemetry exactly like
        organic contention.  -> lock release time."""
        return self._locked(t_ns, hold_ns)

    def push(self, t_ns: float, item, hold_ns: float) -> float:
        """Enqueue at ``t_ns``; -> virtual time the lock was released."""
        end = self._locked(t_ns, hold_ns)
        self._q.append(item)
        self.stats["enqueued"] += 1
        self.stats["peak_depth"] = max(self.stats["peak_depth"],
                                       len(self._q))
        self.stats["win_peak_depth"] = max(self.stats["win_peak_depth"],
                                           len(self._q))
        return end

    def pop(self, t_ns: float, hold_ns: float) -> Tuple[Optional[object],
                                                        float]:
        """Dequeue at ``t_ns``; -> (item or None, lock release time).
        The emptiness probe is lock-free (len()); only a successful pop
        pays the lock, so idle group members never inflate contention."""
        if not self._q:
            return None, t_ns
        end = self._locked(t_ns, hold_ns)
        item = self._q.popleft()
        self.stats["dequeued"] += 1
        return item, end
