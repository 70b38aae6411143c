"""Alpha-beta cost model of ring collectives (the port of
``repro.comm.costs``, with the same formulas and no hardware constant:
the link bandwidth and the per-step latency are the caller's).

The paper's perf-vs-resources tradeoff shows up here as
  per-tensor collectives  -> alpha-dominated (many doorbells),
  one fused collective    -> no overlap, full beta serialized,
  k bucketed channels     -> alphas amortized, betas overlappable.

A ring all-reduce over n participants moving B bytes each:
  2(n-1) hops of B/n -> beta = 2B(n-1)/(n*bw), 2(n-1) alphas.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.channels import ChannelPlan

#: channels that can be in flight at once before they serialize (the
#: uUAR-slot analogue)
MAX_INFLIGHT_CHANNELS = 4


@dataclasses.dataclass(frozen=True)
class CollectiveCost:
    seconds: float
    alpha_seconds: float
    beta_seconds: float
    n_collectives: int


def ring_allreduce_seconds(bytes_per_chip: float, axis_size: int, *,
                           link_bw: float, alpha: float) -> tuple:
    """-> (alpha seconds, beta seconds) of one ring all-reduce."""
    if axis_size <= 1 or bytes_per_chip == 0:
        return 0.0, 0.0
    steps = 2 * (axis_size - 1)
    beta = bytes_per_chip * 2 * (axis_size - 1) / (axis_size * link_bw)
    return steps * alpha, beta


def estimate_sync_time(bucket_bytes: Sequence[float], plan: ChannelPlan,
                       axis_size: int, *, link_bw: float, alpha: float,
                       max_inflight: int = MAX_INFLIGHT_CHANNELS
                       ) -> CollectiveCost:
    """Estimated wall time of a gradient sync under the channel plan.

    Serialized plans chain every beta AND alpha on one dependency;
    channelled plans overlap up to ``max_inflight`` collectives (alphas
    pipeline, betas share the links); double-buffered plans also hide the
    packing latency of the next bucket (one alpha per bucket)."""
    alphas, betas = [], []
    for b in bucket_bytes:
        a, be = ring_allreduce_seconds(b, axis_size, link_bw=link_bw,
                                       alpha=alpha)
        alphas.append(a)
        betas.append(be)
    n = len(bucket_bytes)
    if plan.serialize or n == 1:
        total = sum(alphas) + sum(betas)
        return CollectiveCost(total, sum(alphas), sum(betas), n)
    inflight = min(max_inflight, n)
    alpha_eff = sum(alphas) / inflight
    if plan.double_buffered:
        alpha_eff = max(alphas) if n > 1 else alpha_eff
    total = alpha_eff + sum(betas)
    return CollectiveCost(total, alpha_eff, sum(betas), n)
