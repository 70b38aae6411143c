"""Straggler mitigation from a step-time stream.

The port's copy of ``StragglerMitigator`` from
``repro.runtime.fault_tolerance``: the serving recovery layer
(``serve.recovery.RecoveryManager``) feeds it each fleet worker's
wake-to-wake gaps.  The training supervisor and heartbeat files come
with the training slice.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Optional


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
