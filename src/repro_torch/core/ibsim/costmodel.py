"""Cost model for the IB data-path simulator (the port's own copy of
``repro.core.ibsim.costmodel``).

All constants are nanoseconds (or bytes/ns for bandwidths).  They were
calibrated ONCE against the ratios the paper reports (Section VII, Figs
2/7/9/10/11/12) and are pinned by tests/test_ibsim_calibration.py; the
absolute message rates are model-relative, which is the paper's own framing
("we are interested in the change in throughput with increasing sharing
rather than the absolute throughput", Section V).

The data path being modeled is Appendix C / Fig. 17:
  (1) CPU prepares WQE(s) in the QP buffer (lock if QP shared / not elided),
  (2) CPU rings the DoorBell (8-byte atomic MMIO) or BlueFlame-writes the
      WQE (64-byte WC MMIO; uUAR lock if the uUAR is shared),
  (3) NIC fetches WQE (DMA read; skipped for BlueFlame), fetches payload
      (DMA read; skipped when inlined; TLB-rail serialized per cache line),
  (4) NIC transmits; on remote ACK DMA-writes a CQE (every q-th WQE),
  (5) CPU polls the CQ (lock; atomic completion counters if shared).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

CACHE_LINE = 64


@dataclasses.dataclass(frozen=True)
class Features:
    """IB operational features (paper Section II-B / IV)."""

    postlist: int = 32          # p: WQEs per ibv_post_send
    unsignaled: int = 64        # q: one signaled completion every q WQEs
    inline: bool = True         # payload copied into the WQE by the CPU
    blueflame: bool = True      # WC-write WQE with the doorbell (p==1 only)

    def without(self, name: str) -> "Features":
        """The paper's "All w/o f" ablation."""
        if name == "postlist":
            return dataclasses.replace(self, postlist=1)
        if name == "unsignaled":
            return dataclasses.replace(self, unsignaled=1)
        if name == "inline":
            return dataclasses.replace(self, inline=False)
        if name == "blueflame":
            return dataclasses.replace(self, blueflame=False)
        raise ValueError(name)


ALL_FEATURES = Features()
# Conservative application semantics (paper Section VII): no Postlist, no
# Unsignaled Completions, BlueFlame writes.
CONSERVATIVE = Features(postlist=1, unsignaled=1, inline=True, blueflame=True)


@dataclasses.dataclass(frozen=True)
class BufferConfig:
    """Payload buffer layout: which cache line each thread's BUF lives on.

    ``cacheline_of[i]`` is an abstract cache-line id; threads mapping to the
    same id contend on the same NIC TLB rail for payload DMA reads
    (Section V-A) — only relevant when Inlining is off.
    """

    cacheline_of: Sequence[int]

    @staticmethod
    def aligned(n_threads: int) -> "BufferConfig":
        return BufferConfig(tuple(range(n_threads)))

    @staticmethod
    def shared(n_threads: int, ways: int) -> "BufferConfig":
        """x-way BUF sharing: groups of ``ways`` threads share one BUF."""
        return BufferConfig(tuple(i // ways for i in range(n_threads)))

    @staticmethod
    def unaligned(n_threads: int, msg_bytes: int) -> "BufferConfig":
        """Independent but not cache-aligned buffers packed back to back."""
        return BufferConfig(
            tuple((i * msg_bytes) // CACHE_LINE for i in range(n_threads)))


@dataclasses.dataclass(frozen=True)
class CostModel:
    # --- CPU-side costs (ns) ---
    t_wqe_prep: float = 35.0        # build one WQE in the QP buffer
    t_inline_copy: float = 5.0      # copy a small payload into the WQE
    t_lock: float = 12.0            # uncontended lock acquire+release
    t_lock_contended: float = 110.0  # contended acquire (cache-line bounce)
    t_atomic: float = 10.0          # atomic op (QP-depth fetch-sub, counters)
    t_atomic_contended: float = 70.0
    t_branch_overhead: float = 6.0  # extra branches on the shared-QP path
    t_doorbell: float = 45.0        # 8-byte atomic MMIO DoorBell
    t_bf_write: float = 60.0        # 64-byte BlueFlame WC write
    t_poll_base: float = 30.0       # entering/leaving a CQ poll
    t_poll_cqe: float = 25.0        # per CQE dequeued

    # --- NIC-side costs (ns) ---
    t_pcie_lat: float = 350.0       # one PCIe round-trip latency
    t_nic_wqe: float = 5.0          # per-WQE NIC processing (per-uUAR engine)
    t_wqe_fetch: float = 160.0      # non-posted PCIe read per post-call
    #   (one DMA read covers the whole Postlist — BlueFlame skips it, which
    #   is why BF wins small-message throughput at p=1)
    t_tlb: float = 85.0             # TLB translation slot per payload DMA
    t_cqe_write: float = 20.0       # DMA-write of a CQE (pipelined)
    t_wire: float = 600.0           # transmit + remote hardware ACK latency
    pcie_bw: float = 13.0           # bytes/ns effective PCIe bandwidth
    nic_rate: float = 0.2           # global NIC WQE rate cap, msgs/ns (200M/s)

    # --- contention penalties (phenomenological, Section V-B) ---
    t_wc_conflict: float = 82.0    # BF writes from sibling uUARs on one UAR
    t_uar_anomaly: float = 21.0     # the unexplained >=12-contiguous-page
    uar_anomaly_min_pages: int = 12 #   BlueFlame drop (fixed by 2xQPs spacing)
    conflict_window: float = 800.0  # "recently active" window for conflicts

    def wqe_bytes(self, msg_bytes: int, inline: bool) -> int:
        base = CACHE_LINE
        if inline:
            return base + max(0, msg_bytes - 12)
        return base
