"""Share of the window's host time spent inside ``admit_waiting`` (synced),
chat-rate, in %."""

from perfbench.metrics_common import admit_share as read  # noqa: F401
