"""Deterministic event-driven simulator of the IB sender data path (the
port's own copy of ``repro.core.ibsim.engine``).

The simulator executes the paper's Section-IV sender loop for every thread of
an ``EndpointModel``: post WQEs in Postlist-sized batches onto the thread's
QP until the QP depth is full, then poll the CQ for ``c = depth/q``
completions; repeat until all messages complete.  Threads are interleaved in
virtual-time order (min-heap on per-thread clocks); every shared object (QP
lock, uUAR lock for BlueFlame, CQ lock, NIC per-uUAR engine, global NIC rate,
PCIe bandwidth, NIC TLB rails per payload cache line) is a serializing
resource timeline.  Contention therefore *emerges* from the category's
lock/sharing structure rather than being hard-coded per category.
``Resource`` also carries the serving fleet's dispatch-channel locks
(``serve.fabric.channels``).
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import defaultdict
from typing import Optional

from repro_torch.core.endpoints import EndpointModel
from repro_torch.core.ibsim.costmodel import (BufferConfig, CostModel,
                                              Features)


class Resource:
    """A serially-held resource with a next-free timeline."""

    __slots__ = ("next_free",)

    def __init__(self):
        self.next_free = 0.0

    def acquire(self, ready: float, hold: float) -> tuple:
        start = max(ready, self.next_free)
        self.next_free = start + hold
        return start, start + hold


class _QP:
    __slots__ = ("qid", "target", "sent", "completed", "outstanding",
                 "signal_ctr", "lock", "shared_by")

    def __init__(self, qid, target, shared_by):
        self.qid = qid
        self.target = target
        self.sent = 0
        self.completed = 0
        self.outstanding = 0
        self.signal_ctr = 0
        self.lock = Resource()
        self.shared_by = shared_by


class _CQ:
    __slots__ = ("cid", "pending", "lock", "shared_by")

    def __init__(self, cid, shared_by):
        self.cid = cid
        self.pending = []     # heap of (avail_time, qp_id, n_wqes_signaled)
        self.lock = Resource()
        self.shared_by = shared_by


@dataclasses.dataclass
class SimResult:
    total_msgs: int
    makespan_ns: float
    per_thread_done_ns: list

    @property
    def rate_mmps(self) -> float:
        """Aggregate message rate in million messages per second."""
        return self.total_msgs / self.makespan_ns * 1e3  # msgs/ns -> M/s


class Simulator:
    def __init__(self, model: EndpointModel, *,
                 cost: Optional[CostModel] = None,
                 features: Optional[Features] = None,
                 buffers: Optional[BufferConfig] = None,
                 msgs_per_thread: int = 4096,
                 msg_bytes: int = 2,
                 qp_depth: int = 128):
        self.m = model
        self.cost = cost or CostModel()
        self.f = features or Features()
        self.buffers = buffers or BufferConfig.aligned(model.n_threads)
        self.msgs_per_thread = msgs_per_thread
        self.msg_bytes = msg_bytes
        self.depth = qp_depth
        # effective q never exceeds depth (need >=1 signal per window)
        self.q = max(1, min(self.f.unsignaled, self.depth))
        self.p = max(1, min(self.f.postlist, self.depth))
        self.c = max(1, self.depth // self.q)

        # --- instantiate shared state from the endpoint topology ---
        qp_threads = defaultdict(list)
        cq_threads = defaultdict(list)
        for path in model.paths:
            qp_threads[path.qp].append(path.thread)
            cq_threads[(path.ctx, path.cq)].append(path.thread)
        self.qps = {qid: _QP(qid, msgs_per_thread * len(ths), len(ths))
                    for qid, ths in qp_threads.items()}
        self.cqs = {key: _CQ(key, len(ths))
                    for key, ths in cq_threads.items()}
        self.uuar_lock = defaultdict(Resource)    # (ctx, uuar) -> lock
        self.uuar_engine = defaultdict(Resource)  # (ctx, uuar) -> NIC engine
        self.tlb_rail = defaultdict(Resource)     # cacheline -> TLB slot
        self.pcie = Resource()
        self.nic_global = Resource()

        # static contention structure
        by_uuar = defaultdict(list)
        by_page = defaultdict(list)
        pages_by_ctx = defaultdict(set)
        for path in model.paths:
            by_uuar[(path.ctx, path.uuar_index)].append(path.thread)
            by_page[(path.ctx, path.uar_page)].append(path.uuar_index)
            pages_by_ctx[path.ctx].add(path.uar_page)
        self.uuar_shared = {k: len(set(v)) > 1 for k, v in by_uuar.items()}
        self.page_multi_uuar = {k: len(set(v)) > 1 for k, v in by_page.items()}
        # the unexplained contiguous-page BlueFlame anomaly (Section V-B):
        # >= min_pages actively driven pages in one CTX with at least one
        # adjacent pair ("2xQPs" spacing removes adjacency and the drop).
        self.ctx_anomaly = {}
        for ctx, pages in pages_by_ctx.items():
            ps = sorted(pages)
            adjacent = any(b - a == 1 for a, b in zip(ps, ps[1:]))
            self.ctx_anomaly[ctx] = (
                len(ps) >= self.cost.uar_anomaly_min_pages and adjacent)

    # ------------------------------------------------------------------
    def run(self) -> SimResult:
        m, c, f = self.m, self.cost, self.f
        clock = [(0.0, t) for t in range(m.n_threads)]
        heapq.heapify(clock)
        done_at = [0.0] * m.n_threads
        paths = {p.thread: p for p in m.paths}

        while clock:
            t_now, th = heapq.heappop(clock)
            path = paths[th]
            qp = self.qps[path.qp]
            cq = self.cqs[(path.ctx, path.cq)]

            if qp.sent >= qp.target and qp.completed >= qp.target:
                done_at[th] = t_now
                continue

            can_post = (qp.sent < qp.target
                        and qp.outstanding < self.depth)
            if can_post:
                t_next = self._post(t_now, path, qp, cq)
            else:
                t_next = self._poll(t_now, path, qp, cq)
            heapq.heappush(clock, (t_next, th))

        return SimResult(
            total_msgs=self.msgs_per_thread * m.n_threads,
            makespan_ns=max(done_at), per_thread_done_ns=done_at)

    # ------------------------------------------------------------------
    def _post(self, t0: float, path, qp: _QP, cq: _CQ) -> float:
        c, f = self.cost, self.f
        n = min(self.p, qp.target - qp.sent, self.depth - qp.outstanding)
        shared_qp = qp.shared_by > 1
        need_qp_lock = path.qp_lock or shared_qp

        prep = n * (c.t_wqe_prep
                    + (c.t_inline_copy if f.inline else 0.0))
        if shared_qp:
            # one atomic fetch-sub on the shared QP depth per post call,
            # plus the extra branches of the shared path (Section V-F)
            prep += c.t_atomic_contended + c.t_branch_overhead
        bf_used = f.blueflame and n == 1

        # CPU: lock -> WQE prep -> doorbell/BlueFlame -> unlock
        if need_qp_lock:
            start, _ = qp.lock.acquire(t0, 0.0)   # placed; extended below
            t_acq = c.t_lock_contended if shared_qp else c.t_lock
            t = start + t_acq + prep
        else:
            t = t0 + prep

        uuar_key = (path.ctx, path.uuar_index)
        if bf_used:
            ring_hold = c.t_bf_write
            if self.page_multi_uuar.get((path.ctx, path.uar_page), False):
                # WC-buffer flush conflict between sibling uUARs on one UAR
                # page (PAT page-granularity memory attributes, Section V-B)
                ring_hold += c.t_wc_conflict
            if self.ctx_anomaly.get(path.ctx, False):
                ring_hold += c.t_uar_anomaly
            if path.uuar_lock:
                ring_hold += c.t_lock
            if self.uuar_shared.get(uuar_key, False):
                # concurrent BlueFlame writes to one uUAR serialize on its
                # lock (Fig. 4b level 3)
                _, t = self.uuar_lock[uuar_key].acquire(t, ring_hold)
            else:
                t = t + ring_hold
        else:
            t = t + c.t_doorbell
        if need_qp_lock:
            qp.lock.next_free = t                # released after the ring

        # NIC: rate cap -> WQE fetch -> payload fetch -> per-uUAR engine ->
        # wire.  Global resources (NIC rate, PCIe bandwidth) are acquired at
        # CPU-ordered (near-monotonic) times so they act as bandwidth caps;
        # per-thread stages (TLB rail, uUAR engine) queue after them.
        _, nic_t = self.nic_global.acquire(t, n / c.nic_rate)
        if not bf_used:
            bytes_wqe = n * c.wqe_bytes(self.msg_bytes, f.inline)
            _, end = self.pcie.acquire(nic_t, bytes_wqe / c.pcie_bw)
            nic_t = end + c.t_pcie_lat
        if not f.inline:
            _, end_pcie = self.pcie.acquire(
                nic_t, n * self.msg_bytes / c.pcie_bw)
            rail = self.tlb_rail[self.buffers.cacheline_of[path.thread]]
            _, end_rail = rail.acquire(end_pcie, n * c.t_tlb)
            nic_t = end_rail + c.t_pcie_lat
        # non-BF posts occupy the uUAR's read engine for the WQE-list fetch
        fetch = 0.0 if bf_used else c.t_wqe_fetch
        _, nic_t = self.uuar_engine[uuar_key].acquire(
            nic_t, fetch + n * c.t_nic_wqe)
        done = nic_t + c.t_wire

        # completions: every q-th WQE on the QP is signaled
        qp.signal_ctr += n
        k = 0
        while qp.signal_ctr >= self.q:
            qp.signal_ctr -= self.q
            k += 1
            heapq.heappush(cq.pending,
                           (done + k * c.t_cqe_write, qp.qid, self.q))
        # tail flush: if this post finishes the QP's target, signal remainder
        if qp.sent + n >= qp.target and qp.signal_ctr > 0:
            k += 1
            heapq.heappush(cq.pending,
                           (done + k * c.t_cqe_write, qp.qid, qp.signal_ctr))
            qp.signal_ctr = 0

        qp.sent += n
        qp.outstanding += n
        return t

    # ------------------------------------------------------------------
    def _poll(self, t0: float, path, qp: _QP, cq: _CQ) -> float:
        c = self.cost
        if not cq.pending:
            # nothing in flight for this CQ: re-check shortly (progress is
            # driven by other threads reaping or posting)
            return t0 + c.t_poll_base
        if cq.pending[0][0] > t0:
            # CQEs in flight but not yet delivered: wait for the earliest,
            # paying one empty poll
            return max(cq.pending[0][0], t0 + c.t_poll_base)

        reaped = []
        while cq.pending and cq.pending[0][0] <= t0 and len(reaped) < self.c:
            reaped.append(heapq.heappop(cq.pending))
        cost = (c.t_poll_base + len(reaped) * c.t_poll_cqe
                + (len(reaped) * c.t_atomic_contended
                   if cq.shared_by > 1 else 0.0))
        if cq.shared_by > 1:
            _, t = cq.lock.acquire(t0, c.t_lock_contended + cost)
        else:
            t = t0 + cost
        for _, qid, n_wqes in reaped:
            owner = self.qps[qid]
            owner.completed += n_wqes
            owner.outstanding -= n_wqes
        return t
