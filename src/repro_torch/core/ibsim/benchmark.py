"""Section-IV multithreaded sender-receiver RDMA-write message-rate benchmark
(the port's own copy of ``repro.core.ibsim.benchmark``).

Mirrors the perftest-derived benchmark the paper uses: each thread posts
2-byte RDMA writes on its endpoint path with the configured Postlist /
Unsignaled-Completion / Inlining / BlueFlame features and polls its CQ for
``depth/q`` completions per poll.  Defaults follow the paper: p=32, q=64,
16 threads, QP depth 128.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.endpoints import Category, EndpointModel
from repro_torch.core.ibsim.costmodel import (ALL_FEATURES, BufferConfig,
                                              CostModel, Features)
from repro_torch.core.ibsim.engine import Simulator


@dataclasses.dataclass
class MessageRateResult:
    label: str
    rate_mmps: float            # million messages / second
    makespan_ns: float
    total_msgs: int
    features: Features
    usage: dict                 # resource usage snapshot

    def csv_row(self) -> str:
        u = self.usage
        return (f"{self.label},{self.rate_mmps:.2f},{u['qps']},{u['cqs']},"
                f"{u['uars']},{u['uuars']},{u['memory_mb']:.2f}")


CSV_HEADER = "label,rate_mmps,qps,cqs,uars,uuars,memory_mb"


def message_rate(model: EndpointModel, *,
                 features: Features = ALL_FEATURES,
                 buffers: Optional[BufferConfig] = None,
                 msgs_per_thread: int = 4096,
                 msg_bytes: int = 2,
                 qp_depth: int = 128,
                 cost: Optional[CostModel] = None) -> MessageRateResult:
    sim = Simulator(model, cost=cost, features=features, buffers=buffers,
                    msgs_per_thread=msgs_per_thread, msg_bytes=msg_bytes,
                    qp_depth=qp_depth)
    res = sim.run()
    u = model.usage
    return MessageRateResult(
        label=model.label, rate_mmps=res.rate_mmps,
        makespan_ns=res.makespan_ns, total_msgs=res.total_msgs,
        features=features,
        usage={"qps": u.qps, "cqs": u.cqs, "uars": u.uars, "uuars": u.uuars,
               "uuars_used": u.uuars_used,
               "memory_mb": u.memory_bytes / 2**20})


def category_rate(category: Category, n_threads: int = 16,
                  **kw) -> MessageRateResult:
    return message_rate(EndpointModel.build(category, n_threads), **kw)


def category_table(n_threads: int = 16, *,
                   features: Features = ALL_FEATURES,
                   msgs_per_thread: int = 4096,
                   **kw) -> dict:
    """Rates for all six categories, normalized to MPI everywhere —
    reproduces the Fig.-12-style comparison."""
    out = {}
    for cat in Category:
        out[cat] = category_rate(cat, n_threads, features=features,
                                 msgs_per_thread=msgs_per_thread, **kw)
    base = out[Category.MPI_EVERYWHERE].rate_mmps
    return {cat: {"result": r, "vs_everywhere": r.rate_mmps / base}
            for cat, r in out.items()}
