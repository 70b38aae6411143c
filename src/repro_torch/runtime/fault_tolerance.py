"""Fault tolerance: supervised execution with restart from a checkpoint,
heartbeat files, straggler mitigation (the port of
``repro.runtime.fault_tolerance``).

``Supervisor`` runs the trainer's steps and, on a
``TransientWorkerFailure`` (preemption, a lost peer), restores the last
complete checkpoint and carries on; any other exception propagates.
``Heartbeat`` is a file-based liveness beacon.  ``StragglerMitigator``
flags straggling steps from a step-time stream; the serving recovery
layer (``serve.recovery.RecoveryManager``) also feeds it each fleet
worker's wake-to-wake gaps.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from collections import deque
from typing import Callable, Optional


class TransientWorkerFailure(RuntimeError):
    """A failure the supervisor treats as survivable (preemption, network
    flap, lost heartbeat): it restores and retries."""


@dataclasses.dataclass
class Heartbeat:
    """File-based liveness beacon (one per host; a failure detector polls
    the file's mtime)."""

    path: str
    interval_s: float = 10.0
    _last: float = 0.0

    def beat(self, step: int):
        now = time.time()
        if now - self._last >= self.interval_s:
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"step": step, "t": now}, f)
            os.replace(tmp, self.path)
            self._last = now

    @staticmethod
    def is_alive(path: str, timeout_s: float) -> bool:
        try:
            return time.time() - os.path.getmtime(path) < timeout_s
        except OSError:
            return False


class StragglerMitigator:
    """Detects straggling steps from the step-time stream and fires a
    mitigation callback (at pod scale: re-shard away from the slow host /
    flag it for exclusion at the next restart; here: injected hook).

    Policy: a step is a straggle event if it exceeds ``factor`` x the
    rolling median of the last ``window`` steps; ``patience`` consecutive
    events trigger mitigation (transient noise is ignored).
    """

    def __init__(self, window: int = 32, factor: float = 3.0,
                 patience: int = 3,
                 on_straggler: Optional[Callable] = None):
        self.window = window
        self.factor = factor
        self.patience = patience
        self.on_straggler = on_straggler
        self.times = deque(maxlen=window)
        self.consecutive = 0
        self.events = []

    def observe(self, step: int, step_time_s: float) -> bool:
        """Record a step time; returns True if mitigation fired."""
        if len(self.times) >= max(4, self.window // 4):
            med = sorted(self.times)[len(self.times) // 2]
            if step_time_s > self.factor * med:
                self.consecutive += 1
                self.events.append((step, step_time_s, med))
                if self.consecutive >= self.patience:
                    self.consecutive = 0
                    if self.on_straggler is not None:
                        self.on_straggler(step, step_time_s, med)
                    self.times.append(step_time_s)
                    return True
            else:
                self.consecutive = 0
        self.times.append(step_time_s)
        return False


class Supervisor:
    """Runs a step function under restart-on-failure semantics.

    ``run(start, n_steps)`` executes ``step_fn(step) -> metrics``; on
    TransientWorkerFailure it calls ``restore_fn() -> resume_step`` and
    continues.  ``max_restarts`` bounds CONSECUTIVE failures (a completed
    step resets the budget), so a long job that weathers occasional
    preemptions lives while a crash loop gives up promptly; ``restarts``
    counts every restart.  Anything other than TransientWorkerFailure
    propagates: a real bug ends the job."""

    def __init__(self, step_fn: Callable, restore_fn: Callable,
                 max_restarts: int = 3,
                 straggler: Optional[StragglerMitigator] = None,
                 heartbeat: Optional[Heartbeat] = None):
        self.step_fn = step_fn
        self.restore_fn = restore_fn
        self.max_restarts = max_restarts
        self.straggler = straggler
        self.heartbeat = heartbeat
        self.restarts = 0              # lifetime total (telemetry)
        self.consecutive_failures = 0  # the give-up budget

    def run(self, start_step: int, n_steps: int) -> dict:
        step = start_step
        metrics = {}
        while step < n_steps:
            try:
                t0 = time.time()
                metrics = self.step_fn(step) or {}
                dt = time.time() - t0
                self.consecutive_failures = 0
                if self.straggler is not None:
                    self.straggler.observe(step, dt)
                if self.heartbeat is not None:
                    self.heartbeat.beat(step)
                step += 1
            except TransientWorkerFailure:
                self.restarts += 1
                self.consecutive_failures += 1
                if self.consecutive_failures > self.max_restarts:
                    raise
                step = self.restore_fn()
        return metrics
