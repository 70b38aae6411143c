"""The fleet's virtual-time cost model (DESIGN.md §9).

For now only ``FabricCosts``, the port's copy of
``repro.serve.fabric.router.FabricCosts``: the single continuous engine
lays its request spans out on ``t_step_base_ns`` per decode step, the
virtual-ns axis fleet traces use.  The router and its workers come with
the fleet slice.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FabricCosts:
    """Virtual-time cost model of the fleet data path (ns).

    Queue-lock holds sit at the scale of the ibsim CPU-side lock costs;
    step costs sit at model-forward scale, so lock contention is a
    second-order effect on throughput exactly as QP locks are against the
    wire — it shows up in the p99, not the mean.
    """

    t_enqueue_ns: float = 120.0       # router holds the channel lock
    t_dequeue_ns: float = 180.0       # worker holds the channel lock
    t_admit_base_ns: float = 4_000.0  # slot bookkeeping per admission
    t_admit_per_token_ns: float = 300.0   # prefill, per prompt token
    t_step_base_ns: float = 30_000.0      # one fleet-worker decode step
    t_step_per_slot_ns: float = 6_000.0   # marginal cost per live slot
    # KV handoff (prefill/decode disaggregation, DESIGN.md §17): moving
    # a session's cache between workers costs a base latch plus a
    # per-resident-token transfer — size-proportional, like the bytes
    t_handoff_base_ns: float = 2_000.0
    t_handoff_per_token_ns: float = 150.0
