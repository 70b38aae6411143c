"""Device idle share of the traced window (chat-rate): 1 - the union of the
device operations' intervals over the window, in %."""

from perfbench.metrics_common import idle_share as read  # noqa: F401
