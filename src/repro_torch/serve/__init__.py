"""Serving: one `connect` facade over the continuous and wave engines."""

from repro_torch.core.plan import (EndpointPlan, PRESETS, SharingVector,
                                   as_plan, parse_roles)
from repro_torch.serve.api import ServeClient, Stream, connect
from repro_torch.serve.engine import (ContinuousEngine, KVHandoff, Request,
                                      ServeEngine)
from repro_torch.serve.pages import PagePool
from repro_torch.serve.slots import SlotPool

__all__ = [
    "ContinuousEngine", "EndpointPlan", "KVHandoff", "PRESETS", "PagePool",
    "Request", "ServeClient", "ServeEngine", "SharingVector", "SlotPool",
    "Stream", "as_plan", "connect", "parse_roles",
]
