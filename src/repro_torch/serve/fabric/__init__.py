"""Serving fabric: router, dispatch channels, and a worker fleet whose
queue sharing structure is keyed by the ``channels`` axis of a
``core.plan.SharingVector`` (historically: the paper's endpoint
categories — still accepted) (DESIGN.md §9, §11)."""

from repro_torch.serve.fabric.channels import DispatchChannel
from repro_torch.serve.fabric.faults import (FaultInjector, FaultPlan,
                                       FaultSpec, canonical_chaos_plan,
                                       canonical_crash_plan, parse_faults)
from repro_torch.serve.fabric.placement import POLICIES, make_policy
from repro_torch.serve.fabric.router import (Completion, EngineWorker,
                                       FabricCosts, FleetReport,
                                       RoleDispatchPlan, Router,
                                       SimWorker, build_sim_fleet)
from repro_torch.serve.fabric.traffic import (Arrival, Phase, TRAFFIC_SHAPES,
                                        bursty_trace,
                                        canonical_bursty_trace,
                                        canonical_faulted_trace,
                                        canonical_phased_trace,
                                        phased_trace, poisson_trace,
                                        session_trace)

__all__ = [
    "Arrival", "Completion", "DispatchChannel", "EngineWorker",
    "FabricCosts", "FaultInjector", "FaultPlan", "FaultSpec",
    "FleetReport", "POLICIES", "Phase", "RoleDispatchPlan", "Router",
    "SimWorker",
    "TRAFFIC_SHAPES", "build_sim_fleet", "bursty_trace",
    "canonical_bursty_trace", "canonical_chaos_plan",
    "canonical_crash_plan", "canonical_faulted_trace",
    "canonical_phased_trace", "make_policy", "parse_faults",
    "phased_trace", "poisson_trace", "session_trace",
]
