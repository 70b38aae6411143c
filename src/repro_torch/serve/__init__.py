"""Serving: one `connect` facade over plan-selected executors.

`serve.connect(cfg, plan_or_hints) -> ServeClient` is the public entry
point (DESIGN.md §11); `ServeEngine` / `ContinuousEngine` / the fabric
`Router` remain importable as the internal executors it selects.
"""

from repro_torch.core.adapt import Replanner, WindowStats
from repro_torch.core.plan import (EndpointPlan, Hints, PRESETS,
                                   SharingVector, as_plan, parse_roles,
                                   resolve)
from repro_torch.serve.api import ServeClient, Stream, connect
from repro_torch.serve.engine import (ContinuousEngine, KVHandoff, Request,
                                      ServeEngine)
from repro_torch.serve.fabric.faults import FaultPlan, FaultSpec, parse_faults
from repro_torch.serve.pages import PagePool
from repro_torch.serve.recovery import (LostWork, RecoveryManager,
                                        RecoveryPolicy)
from repro_torch.serve.slots import SlotPool

__all__ = [
    "ContinuousEngine", "EndpointPlan", "FaultPlan", "FaultSpec", "Hints",
    "KVHandoff", "LostWork", "PRESETS", "PagePool", "RecoveryManager",
    "RecoveryPolicy", "Replanner", "Request", "ServeClient", "ServeEngine",
    "SharingVector", "SlotPool", "Stream", "WindowStats", "as_plan",
    "connect", "parse_faults", "parse_roles", "resolve",
]
