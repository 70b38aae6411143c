"""Serially-held resources of the event-driven simulators.

The port's copy of ``Resource`` from ``repro.core.ibsim.engine``: a lock
or engine that one holder at a time occupies, modelled as a next-free
timeline.  The fleet's dispatch channels hold their queue lock through
it (``serve.fabric.channels``), so lock contention emerges from the
sharing structure in virtual time.
"""

from __future__ import annotations


class Resource:
    """A serially-held resource with a next-free timeline."""

    __slots__ = ("next_free",)

    def __init__(self):
        self.next_free = 0.0

    def acquire(self, ready: float, hold: float) -> tuple:
        start = max(ready, self.next_free)
        self.next_free = start + hold
        return start, start + hold
