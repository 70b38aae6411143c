"""Router + virtual-time fleet scheduler (DESIGN.md §9).

The port's own copy of ``repro.serve.fabric.router``: the same event
loop, workers and report, with ``EngineWorker`` driving the port's
``ContinuousEngine`` (its horizons replayed as CUDA graphs on the card).

The ``Router`` is the fabric frontend: it admits a traffic stream
(``fabric.traffic``), places every arrival onto a ``DispatchChannel``
(``fabric.placement`` chooses among the queues the
``core.channels.DispatchPlan`` defines for the category), and drives N
continuous-batching workers that pull from their group's channel.

Scheduling is event-driven in VIRTUAL time — the scheduler contract:

  * all times are float nanoseconds starting at 0; no wall clock anywhere;
  * events are totally ordered by ``(t, seq)`` where ``seq`` is a
    monotonic counter, so ties are deterministic;
  * a worker is either *scheduled* (exactly one pending wake event) or
    *idle* (zero events — an idle fleet burns no events, the no-spin
    contract), and is woken by arrivals on its group's channel;
  * every shared object (channel lock) is a serially-held ``Resource``
    next-free timeline, so contention emerges from the category's sharing
    structure, not from per-category constants.

Identical (trace, config) pairs therefore replay identical schedules —
fleet behavior is unit-testable without real parallelism.  Online
adaptation rides the same event loop (DESIGN.md §12): a ``replan`` event
fires every ``adapt_window_ns`` of virtual time, feeds the window's
telemetry to a ``core.adapt.Replanner``, and executes any proposed
``SharingVector`` transition via ``apply_vector`` — rebuilt dispatch
channels drain queued work in arrival order, worker pools re-key in
place, engine workers swap executable groups — so even migration replays
deterministically.

Two worker types share one protocol (``capacity`` / ``admit`` / ``step``):
``SimWorker`` models decode cost only (bench sweeps: thousands of virtual
requests in milliseconds of host time) and ``EngineWorker`` wraps a real
``ContinuousEngine`` stepped externally (real tokens, virtual time).
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.adapt import Replanner, WindowStats
from repro_torch.core.channels import DispatchPlan
from repro_torch.core.endpoints import Category, category_for_level
from repro_torch.core.plan import EndpointPlan, SharingVector
from repro_torch.obs.metrics import MetricsRegistry, quantile
from repro_torch.obs.trace import (NOOP_OBS, Observability, PID_FLEET,
                             PID_REQUESTS, PID_RESOURCES, TID_CHANNEL0,
                             TID_PAGES0, TID_ROUTER, TID_WORKER0)
from repro_torch.core.plan import parse_roles
from repro_torch.serve.engine import ContinuousEngine, KVHandoff, Request
from repro_torch.serve.fabric.channels import DispatchChannel
from repro_torch.serve.fabric.faults import (FaultInjector, FaultPlan,
                                       parse_faults)
from repro_torch.serve.fabric.placement import PlacementPolicy, make_policy
from repro_torch.serve.fabric.traffic import Arrival
from repro_torch.serve.pages import PagePool
from repro_torch.serve.recovery import (LostWork, RecoveryManager,
                                  RecoveryPolicy)
from repro_torch.serve.slots import SlotPool


@dataclasses.dataclass(frozen=True)
class FabricCosts:
    """Virtual-time cost model of the fleet data path (ns).

    Queue-lock holds sit at the scale of the ibsim CPU-side lock costs
    (``core.ibsim.costmodel``); step costs sit at model-forward scale, so
    lock contention is a second-order effect on throughput exactly as QP
    locks are against the wire — it shows up in the p99, not the mean.
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


@dataclasses.dataclass(frozen=True)
class Completion:
    rid: int
    worker: int
    t_done_ns: float
    new_tokens: int
    output: Optional[list] = None     # real tokens (EngineWorker only)


# ---------------------------------------------------------------------------
# Workers
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Live:
    arrival: Arrival
    remaining: int


#: nominal KV bytes per resident token for VIRTUAL workers — SimWorker
#: has no real cache, but the handoff ledger (``fleet.kv_bytes_moved``)
#: must stay deterministic and size-proportional for the bench gates
SIM_KV_BYTES_PER_TOKEN = 1024


class SimWorker:
    """Continuous-batching worker in pure virtual time (no model): each
    live request needs ``max_new_tokens`` decode steps; a step decodes one
    token for every live slot and costs ``t_step_base + n*t_step_per_slot``."""

    def __init__(self, wid: int, *, n_slots: int = 4,
                 costs: FabricCosts = FabricCosts(),
                 slot_level: int = 1, slot_category: Category = None,
                 pages_level: int = 1, page_size: int = 0,
                 max_len: int = 512,
                 page_budget: Optional[int] = None):
        self.wid = wid
        self.n_slots = n_slots
        self.costs = costs
        # slot_category is the deprecated spelling (SlotPool warns)
        self.pool = (SlotPool(category=slot_category, n_slots=n_slots)
                     if slot_category is not None
                     else SlotPool(slot_level, n_slots))
        self._slots: List[Optional[_Live]] = [None] * n_slots
        self.stats = {"steps": 0, "slot_steps": 0, "busy_slot_steps": 0,
                      "tokens": 0, "admitted": 0}
        # ----- virtual page pool (DESIGN.md §13) -------------------------
        # page_size > 0 engages KV-page accounting: admission reserves
        # the request's worst-case page span from a shared PagePool, a
        # dry pool defers the request into a FIFO waiting line (retried
        # before every step), and completion frees the pages — the exact
        # host bookkeeping the real engine does, in pure virtual time.
        self.max_len = int(max_len)
        self.page_size = int(page_size)
        self.page_pool: Optional[PagePool] = None
        #: FIFO deferral line: (arrival, remaining, pos) — remaining/pos
        #: are None for plain admissions, set for KV-handoff admissions
        #: (whose page span is keyed by the RESIDENT cache, not the
        #: prompt)
        self._waiting: List[tuple] = []
        if self.page_size > 0:
            assert self.max_len % self.page_size == 0, \
                "page_size must divide max_len"
            self.page_pool = PagePool(
                pages_level, n_slots, self.max_len // self.page_size,
                total_pages=page_budget)
            self.stats["page_deferrals"] = 0
            self.stats["page_hwm"] = 0

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self._slots) \
            + len(self._waiting)

    def regroup(self, slot_level: Optional[int] = None,
                exec_group: Optional[int] = None,
                page_level: Optional[int] = None) -> bool:
        """Live migration: re-key the slot pool and/or the page-pool
        budgets (pure admission/budget policy — in-flight virtual
        requests keep their slots and pages).  ``exec_group`` is
        accepted for worker-protocol symmetry and ignored: a virtual
        worker compiles nothing."""
        changed = False
        if slot_level is not None and slot_level != self.pool.level:
            self.pool.regroup(slot_level)
            changed = True
        if page_level is not None and self.page_pool is not None \
                and int(page_level) != self.page_pool.level:
            self.page_pool.regroup(int(page_level))
            changed = True
        return changed

    def compile_probe(self):
        """-> (key, count) for the window's compile telemetry; a
        virtual worker compiles nothing."""
        return None, 0

    def capacity(self) -> int:
        occupied = [s is not None for s in self._slots]
        cap = len(self.pool.admissible(occupied))
        # page-deferred requests already hold a place in line: don't let
        # the router hand over more work than the pool can even queue
        return max(0, cap - len(self._waiting))

    def _page_need(self, arrival: Arrival) -> int:
        span = min(arrival.prompt_len + arrival.max_new_tokens,
                   self.max_len)
        return max(1, -(-span // self.page_size))

    def _try_place(self, arrival: Arrival, remaining=None,
                   pos=None) -> bool:
        """Bind ``arrival`` to an admissible slot, reserving its pages
        first when the pool is paged; False defers (nothing granted).
        ``remaining``/``pos`` override the decode budget and resident
        token count for KV-handoff admissions (the pages cover the
        imported cache, not a fresh prefill)."""
        occupied = [s is not None for s in self._slots]
        slots = self.pool.admissible(occupied, queue_len=1)
        if not slots:
            return False
        if self.page_pool is not None:
            if pos is None:
                need = self._page_need(arrival)
            else:
                span = min(pos + remaining, self.max_len)
                need = max(1, -(-span // self.page_size))
            if self.page_pool.alloc(slots[0], need) is None:
                return False
        rem = (remaining if remaining is not None
               else max(1, arrival.max_new_tokens))
        self._slots[slots[0]] = _Live(arrival, rem)
        self.stats["admitted"] += 1
        return True

    def admit(self, arrival: Arrival, t_ns: float) -> float:
        if self.page_pool is None:
            ok = self._try_place(arrival)
            assert ok, "admit() called with no admissible slot"
        elif not self._try_place(arrival):
            self._waiting.append((arrival, None, None))  # FIFO defer
        return (self.costs.t_admit_base_ns
                + arrival.prompt_len * self.costs.t_admit_per_token_ns)

    # ----- prefill/decode disaggregation (DESIGN.md §17) -----------------
    def admit_prefill(self, arrival: Arrival, t_ns: float):
        """Prefill-role admission: the virtual admit cost IS the forward
        pass; no decode slot is bound (prefill workers never decode) —
        -> (cost_ns, KV payload bound for the decode sub-fleet)."""
        self.stats["admitted"] += 1
        cost = (self.costs.t_admit_base_ns
                + arrival.prompt_len * self.costs.t_admit_per_token_ns)
        h = KVHandoff(rid=arrival.rid, cache=None, next_tok=-1,
                      pos=arrival.prompt_len,
                      remaining=max(1, arrival.max_new_tokens),
                      emitted=[], kv_tokens=arrival.prompt_len,
                      kv_bytes=arrival.prompt_len * SIM_KV_BYTES_PER_TOKEN)
        return cost, h

    def admit_retry_prefill(self, arrival: Arrival, orig: Arrival,
                            prefix, t_ns: float):
        """Crash-recovery redo of a prefill: a virtual worker has no
        real prompt, so the inflated ``arrival`` (prompt + emitted
        prefix, shrunken budget) carries everything the cost model and
        the payload need."""
        return self.admit_prefill(arrival, t_ns)

    def admit_handoff(self, arrival: Arrival, h: KVHandoff,
                      t_ns: float) -> float:
        """Decode-side landing of a KV payload: bind a slot with the
        handoff's remaining budget (pages sized by the resident cache).
        The prefill already happened elsewhere — only the slot
        bookkeeping cost is charged."""
        rem = max(1, h.remaining)
        if self.page_pool is None:
            ok = self._try_place(arrival, rem, h.pos)
            assert ok, "admit_handoff() called with no admissible slot"
        elif not self._try_place(arrival, rem, h.pos):
            self._waiting.append((arrival, rem, h.pos))
        return self.costs.t_admit_base_ns

    def export_sessions(self) -> List[KVHandoff]:
        """Live decode→decode migration: strip every live slot into a
        KV payload (pages freed here, re-keyed at the destination).
        The page-deferred waiting line stays put — it holds no KV yet."""
        out = []
        for i, s in enumerate(self._slots):
            if s is None:
                continue
            a = s.arrival
            done = max(1, a.max_new_tokens) - s.remaining
            pos = min(a.prompt_len + done, self.max_len)
            out.append(KVHandoff(
                rid=a.rid, cache=None, next_tok=-1, pos=pos,
                remaining=s.remaining, emitted=[], kv_tokens=pos,
                kv_bytes=pos * SIM_KV_BYTES_PER_TOKEN))
            self._slots[i] = None
            if self.page_pool is not None:
                self.page_pool.free(i)
        return out

    def kill(self) -> List[LostWork]:
        """Fail-stop death (chaos fabric, DESIGN.md §15): every live
        slot and page-deferred admission is lost at its current emitted
        count, pages return to the pool (a dead worker leaks nothing),
        and the worker is left empty — the Router fences it so nothing
        new arrives."""
        lost: List[LostWork] = []
        for i, s in enumerate(self._slots):
            if s is None:
                continue
            emitted = max(1, s.arrival.max_new_tokens) - s.remaining
            lost.append(LostWork(rid=s.arrival.rid, emitted=emitted))
            self._slots[i] = None
            if self.page_pool is not None:
                self.page_pool.free(i)
        for a, rem, _pos in self._waiting:
            emitted = (0 if rem is None
                       else max(1, a.max_new_tokens) - rem)
            lost.append(LostWork(rid=a.rid, emitted=emitted))
        self._waiting.clear()
        return lost

    def step(self, t_ns: float):
        """-> (cost_ns, completions finishing at t_ns + cost_ns)."""
        if self._waiting:
            # retry the deferred line in FIFO order; stop at the first
            # request that still cannot fit (no overtaking)
            while self._waiting and self._try_place(*self._waiting[0]):
                self._waiting.pop(0)
        if self.page_pool is not None:
            self.stats["page_deferrals"] = self.page_pool.deferrals
            self.stats["page_hwm"] = self.page_pool.hwm
        live = [i for i, s in enumerate(self._slots) if s is not None]
        if not live:
            if self._waiting:
                if self.page_pool is not None \
                        and self.page_pool.seized_pages:
                    # transient external pressure (page_pressure fault):
                    # the restore event re-wakes this worker
                    return 0.0, []
                # nothing live will ever free pages for these: the plan's
                # budget cannot fit the request at all
                raise ValueError(
                    f"worker {self.wid}: {len(self._waiting)} request(s) "
                    f"need more pages than the page budget ever grants")
            return 0.0, []
        cost = (self.costs.t_step_base_ns
                + len(live) * self.costs.t_step_per_slot_ns)
        t_end = t_ns + cost
        done = []
        self.stats["steps"] += 1
        self.stats["slot_steps"] += self.n_slots
        self.stats["busy_slot_steps"] += len(live)
        self.stats["tokens"] += len(live)
        for i in live:
            s = self._slots[i]
            s.remaining -= 1
            if s.remaining <= 0:
                done.append(Completion(
                    rid=s.arrival.rid, worker=self.wid, t_done_ns=t_end,
                    new_tokens=s.arrival.max_new_tokens))
                self._slots[i] = None
                if self.page_pool is not None:
                    self.page_pool.free(i)
        return cost, done


class EngineWorker:
    """A real ``ContinuousEngine`` stepped externally: tokens are real
    model output; time is the same virtual cost model as ``SimWorker`` so
    a mixed fleet still schedules deterministically."""

    def __init__(self, wid: int, engine: ContinuousEngine, *,
                 costs: FabricCosts = FabricCosts(),
                 prompt_fn: Optional[Callable[[Arrival], np.ndarray]] = None,
                 request_fn: Optional[Callable[[Arrival], Request]] = None,
                 vocab: int = 256):
        self.wid = wid
        self.engine = engine
        self.costs = costs
        self.n_slots = engine.n_slots
        self.prompt_fn = prompt_fn or (lambda a: np.random.default_rng(
            a.rid).integers(1, vocab, size=a.prompt_len).astype(np.int32))
        # request_fn overrides the whole Request (the ServeClient facade
        # carries real prompts and eos ids through the fabric this way)
        self.request_fn = request_fn
        self.stats = {"steps": 0, "slot_steps": 0, "busy_slot_steps": 0,
                      "tokens": 0, "admitted": 0}
        engine.start()

    @property
    def n_active(self) -> int:
        return self.engine.n_active + len(self.engine.queue)

    @property
    def page_pool(self) -> Optional[PagePool]:
        """The wrapped engine's page pool (None on contiguous layouts) —
        the fleet report reads page telemetry through this."""
        return self.engine.page_pool

    def regroup(self, slot_level: Optional[int] = None,
                exec_group: Optional[int] = None,
                page_level: Optional[int] = None) -> bool:
        """Live migration: delegate to the real engine — slot pool
        re-keyed without evicting in-flight requests, the engine moved
        to another exec group between steps (its future horizon captures
        draw on that group's graph memory pool; the graphs it has keep
        running), page-pool budgets re-keyed in place.  A pages level is
        quietly dropped on contiguous-layout engines (the layout is
        structural)."""
        return self.engine.regroup(
            slot_level=slot_level, exec_group=exec_group,
            page_level=(page_level if self.engine.paged else None))

    def compile_probe(self):
        """-> (exec group identity, horizon graphs its engines captured
        so far).  The key lets the router count each SHARED group once —
        at exec level 4 the whole fleet reports one group, not N copies
        of it.  0 captures on the CPU, where nothing is captured."""
        group = self.engine.group
        return id(group), group.captures

    def capacity(self) -> int:
        return max(0, len(self.engine.free_slots())
                   - len(self.engine.queue))

    def _base_request(self, arrival: Arrival) -> Request:
        if self.request_fn is not None:
            return self.request_fn(arrival)
        return Request(rid=arrival.rid, prompt=self.prompt_fn(arrival),
                       max_new_tokens=arrival.max_new_tokens)

    def admit(self, arrival: Arrival, t_ns: float) -> float:
        self.engine.submit(self._base_request(arrival))
        self.stats["admitted"] += 1
        return (self.costs.t_admit_base_ns
                + arrival.prompt_len * self.costs.t_admit_per_token_ns)

    def _retry_request(self, arrival: Arrival, orig: Arrival,
                       prefix: Optional[List[int]]) -> Request:
        """The re-admission Request of a crash-lost rid: the ORIGINAL
        prompt (rebuilt from ``orig`` — ``arrival`` carries the inflated
        prompt_len for cost accounting only) extended by the already-
        emitted ``prefix`` tokens, with the shrunken budget."""
        base = self._base_request(orig)
        prompt = np.asarray(base.prompt, np.int32)
        if prefix:
            prompt = np.concatenate(
                [prompt, np.asarray(prefix, np.int32)])
        return dataclasses.replace(
            base, prompt=prompt, max_new_tokens=arrival.max_new_tokens)

    def admit_retry(self, arrival: Arrival, orig: Arrival,
                    prefix: Optional[List[int]], t_ns: float) -> float:
        """Re-admit a crash-lost request.  Greedy decoding is a pure
        function of the context, so the continuation is bit-identical to
        what the dead worker would have produced."""
        self.engine.submit(self._retry_request(arrival, orig, prefix))
        self.stats["admitted"] += 1
        # cost covers the full re-prefill (prompt + prefix)
        return (self.costs.t_admit_base_ns
                + arrival.prompt_len * self.costs.t_admit_per_token_ns)

    # ----- prefill/decode disaggregation (DESIGN.md §17) -----------------
    def admit_prefill(self, arrival: Arrival, t_ns: float):
        """Prefill-role admission: batch-1 exact-length prefill NOW (the
        virtual admit cost covers the forward pass) — -> (cost_ns, the
        session's KV payload).  Exact-length batch-1 prefill is bit-
        identical to the co-located admission path, so the decode
        continuation elsewhere reproduces the co-located stream."""
        h = self.engine.prefill_only(self._base_request(arrival))
        self.stats["admitted"] += 1
        cost = (self.costs.t_admit_base_ns
                + arrival.prompt_len * self.costs.t_admit_per_token_ns)
        return cost, h

    def admit_retry_prefill(self, arrival: Arrival, orig: Arrival,
                            prefix: Optional[List[int]], t_ns: float):
        """Crash-recovery redo of a prefill: original prompt + emitted
        prefix, shrunken budget (the splice layer re-attaches the prefix
        at completion, exactly as for co-located retries)."""
        h = self.engine.prefill_only(
            self._retry_request(arrival, orig, prefix))
        self.stats["admitted"] += 1
        cost = (self.costs.t_admit_base_ns
                + arrival.prompt_len * self.costs.t_admit_per_token_ns)
        return cost, h

    def admit_handoff(self, arrival: Arrival, h: KVHandoff,
                      t_ns: float) -> float:
        """Decode-side import: the payload rides the engine's normal
        admission queue (page reservation included) and is installed by
        cache merge instead of a prefill."""
        base = self._base_request(arrival)
        self.engine.submit(dataclasses.replace(
            base, max_new_tokens=max(1, h.remaining), kv=h))
        self.stats["admitted"] += 1
        return self.costs.t_admit_base_ns

    def export_sessions(self) -> List[KVHandoff]:
        """Live decode→decode migration: every live slot leaves as a KV
        payload (the engine frees the slot and its pages); the engine's
        own admission queue stays put — it holds no KV yet."""
        return self.engine.export_sessions()

    def kill(self) -> List[LostWork]:
        """Fail-stop death: evacuate the wrapped engine (pages freed,
        nothing retired) and hand every resident request's emitted
        prefix to the recovery layer."""
        live, queued = self.engine.evacuate()
        lost = [LostWork(rid=r.rid, emitted=len(r.output or []),
                         tokens=list(r.output or []),
                         eos_id=(-1 if r.eos_id is None else r.eos_id))
                for r in live]
        lost += [LostWork(rid=r.rid, emitted=0,
                          eos_id=(-1 if r.eos_id is None else r.eos_id))
                 for r in queued]
        return lost

    def step(self, t_ns: float):
        self.engine.admit_waiting()
        if self.engine.n_active == 0:
            return 0.0, []
        # one external step may execute K fused decode steps (the engine's
        # decode horizon); virtual time accounts every one of them, so
        # read the engine's own counters instead of assuming one step
        before = (self.engine.stats["decode_steps"],
                  self.engine.stats["busy_slot_steps"])
        retired = self.engine.step()
        d_steps = self.engine.stats["decode_steps"] - before[0]
        d_busy = self.engine.stats["busy_slot_steps"] - before[1]
        cost = (d_steps * self.costs.t_step_base_ns
                + d_busy * self.costs.t_step_per_slot_ns)
        t_end = t_ns + cost
        self.stats["steps"] += d_steps
        self.stats["slot_steps"] += d_steps * self.n_slots
        self.stats["busy_slot_steps"] += d_busy
        self.stats["tokens"] += d_busy
        done = [Completion(rid=r.rid, worker=self.wid, t_done_ns=t_end,
                           new_tokens=len(r.output), output=list(r.output))
                for r in retired]
        return cost, done


# ---------------------------------------------------------------------------
# Router
# ---------------------------------------------------------------------------

class RoleDispatchPlan:
    """Dispatch topology of a DISAGGREGATED fleet (DESIGN.md §17):
    prefill workers ``[0, n_prefill)`` and decode workers
    ``[n_prefill, n)`` each get their own ``DispatchPlan`` at the same
    sharing level, so neither role's queue group ever mixes with the
    other's — prefill workers never decode, decode workers never see a
    raw prompt.  Global queue ids concatenate prefill queues first."""

    def __init__(self, level, n_prefill: int, n_decode: int):
        self.prefill = DispatchPlan(level, n_prefill)
        self.decode = DispatchPlan(level, n_decode)
        self.n_prefill = n_prefill
        self.n_decode = n_decode
        self.n_workers = n_prefill + n_decode

    @property
    def level(self):
        return self.prefill.level

    @property
    def category(self) -> Category:
        return self.prefill.category

    @property
    def n_queues(self) -> int:
        return self.prefill.n_queues + self.decode.n_queues

    @property
    def prefill_queues(self) -> List[int]:
        return list(range(self.prefill.n_queues))

    @property
    def decode_queues(self) -> List[int]:
        return list(range(self.prefill.n_queues, self.n_queues))

    def role_of(self, worker: int) -> str:
        return "prefill" if worker < self.n_prefill else "decode"

    def queue_of(self, worker: int) -> int:
        if worker < self.n_prefill:
            return self.prefill.queue_of(worker)
        return self.prefill.n_queues + self.decode.queue_of(
            worker - self.n_prefill)

    def workers_of(self, queue: int) -> List[int]:
        if queue < self.prefill.n_queues:
            return list(self.prefill.workers_of(queue))
        return [self.n_prefill + w for w in self.decode.workers_of(
            queue - self.prefill.n_queues)]

    def endpoint_usage(self) -> dict:
        """Worker-weighted mean of the two sub-fleets' Table-1 usage."""
        pu = self.prefill.endpoint_usage()
        du = self.decode.endpoint_usage()
        n = self.n_workers
        return {k: (pu[k] * self.n_prefill + du[k] * self.n_decode) / n
                for k in pu}


@dataclasses.dataclass
class FleetReport:
    category: Category
    placement: str
    n_workers: int
    n_arrivals: int
    completions: List[Completion]
    latency_ns: Dict[int, float]          # rid -> completion - arrival
    makespan_ns: float
    total_new_tokens: int
    per_worker_tokens: List[int]
    occupancy: float
    lock_wait_ns: float
    peak_depths: List[int]
    endpoint_usage: dict
    vector: Optional[SharingVector] = None    # final plan axes run
    #: (virtual t_ns, vector) per live migration — empty for frozen plans
    transitions: List = dataclasses.field(default_factory=list)
    #: time-weighted mean of SharingVector.footprint_score over the run
    #: (== the static score for frozen plans; None for Category-keyed
    #: routers, which never owned the slot/exec axes)
    mean_footprint: Optional[float] = None
    n_windows: int = 0                        # telemetry windows sampled
    #: peak live KV pages over the fleet as a fraction of the dedicated
    #: reservation (n_slots x max_pages per worker); None when no worker
    #: runs the paged layout
    page_hwm_frac: Optional[float] = None
    page_deferrals: int = 0                   # admissions the pools refused
    #: the run's metrics registry (DESIGN.md §14) — the report's
    #: occupancy/lock-wait numbers are read back from it, and callers
    #: can query any published counter/gauge/histogram (e.g. the
    #: streaming ``request.latency_ms`` sketch) without new report fields
    metrics: Optional[MetricsRegistry] = dataclasses.field(
        default=None, repr=False, compare=False)
    # ----- chaos/recovery (DESIGN.md §15; all empty on fault-free runs)
    faults_injected: int = 0
    detections: int = 0                       # workers declared dead
    retries: int = 0                          # re-placements scheduled
    recovered: List[int] = dataclasses.field(default_factory=list)
    failed: List[int] = dataclasses.field(default_factory=list)
    #: arrivals shed BEFORE acceptance: (rid, reason, t_ns)
    shed: List = dataclasses.field(default_factory=list)
    #: outage→detection per declared death (ns)
    recovery_latency_ns: List[float] = dataclasses.field(
        default_factory=list)
    duplicate_completions: int = 0            # must stay 0 (exactly-once)
    # ----- disaggregation (DESIGN.md §17; zero on co-located fleets) ----
    roles: Optional[tuple] = None             # (n_prefill, n_decode)
    handoffs: int = 0                         # KV payloads moved
    kv_tokens_moved: int = 0                  # resident tokens shipped
    kv_bytes_moved: int = 0                   # cache bytes shipped
    migrations: int = 0                       # decode→decode migrate events

    @property
    def n_completed(self) -> int:
        return len(self.completions)

    @property
    def tok_per_s(self) -> float:
        return self.total_new_tokens / max(self.makespan_ns, 1e-9) * 1e9

    def latency_percentile(self, q: float) -> float:
        return quantile(self.latency_ns.values(), q)

    @property
    def fairness(self) -> float:
        """Jain's index over per-worker token counts (1.0 = even split)."""
        x = np.asarray(self.per_worker_tokens, np.float64)
        if not x.sum():
            return 1.0
        return float(x.sum() ** 2 / (len(x) * (x ** 2).sum()))

    @property
    def n_shed(self) -> int:
        return len(self.shed)

    def recovery_latency_ms(self, q: float) -> float:
        """Outage→detection latency percentile, milliseconds."""
        return quantile([x / 1e6 for x in self.recovery_latency_ns], q)


class Router:
    """Fabric frontend: place arrivals onto dispatch channels and drive
    the worker fleet in virtual time.

    ``sharing`` is anything that names a channel sharing level: a bare
    Fig. 4b level int, a ``core.plan.SharingVector`` / ``EndpointPlan``
    (their ``channels`` axis), or — the historical spelling — a
    ``Category`` (collapses to its level).  ``on_complete``, if given, is
    called once per completion and may return new ``Arrival``s to inject
    at (or after) the completion's virtual time — the ``ServeClient``
    facade chains each stream's next request this way (per-stream FIFO).
    """

    def __init__(self, workers: List, sharing, *,
                 placement: str = "round_robin",
                 costs: FabricCosts = FabricCosts(),
                 on_complete: Optional[Callable] = None,
                 adapt: Optional[Replanner] = None,
                 adapt_window_ns: float = 250_000.0,
                 obs: Optional[Observability] = None,
                 faults=None,
                 recovery: Optional[RecoveryPolicy] = None,
                 roles=None,
                 migrations: Optional[List] = None):
        if not workers:
            raise ValueError("a fleet needs at least one worker")
        # ----- observability (DESIGN.md §14) -----------------------------
        # The flight recorder defaults to the no-op (hot paths pay one
        # bool check), but window accounting ALWAYS runs through a real
        # MetricsRegistry — obs.metrics when the caller wants the export,
        # a private one otherwise — so the Replanner-feeding path is one
        # code path, exercised identically with observability on or off.
        self.obs = obs if obs is not None else NOOP_OBS
        self._rec = self.obs.recorder
        self.metrics = (self.obs.metrics if self.obs.metrics.enabled
                        else MetricsRegistry())
        if adapt is not None and adapt_window_ns <= 0:
            raise ValueError("adapt_window_ns must be positive")
        if isinstance(sharing, EndpointPlan):
            if roles is None:
                roles = sharing.role_split
            sharing = sharing.vector
        # ----- prefill/decode disaggregation (DESIGN.md §17) -------------
        # ``roles`` splits the fleet into prefill workers [0, nP) and
        # decode workers [nP, n): arrivals route to prefill channels
        # only, finished prefills travel to a decode channel as a
        # ``handoff`` event carrying their KV.  None = co-located
        # (every worker does both — the byte-identical historical path).
        self.roles = parse_roles(roles)
        if self.roles is not None:
            n_p, n_d = self.roles
            if n_p < 1 or n_d < 1 or n_p + n_d != len(workers):
                raise ValueError(
                    f"roles {n_p}P+{n_d}D need exactly "
                    f"{n_p + n_d} workers, fleet has {len(workers)}")
        if isinstance(sharing, SharingVector):
            self.vector = sharing
            plan_key = sharing.channels
            self.category = category_for_level(plan_key)
        elif isinstance(sharing, Category):
            # the historical scalar spelling keys the dispatch queues
            # only — the fabric never owned the slot/exec axes, so no
            # vector is claimed for the report
            self.vector = None
            plan_key = sharing            # DispatchPlan keeps the exact
            self.category = sharing       # category for Table-1 pricing
        else:
            self.vector = None
            plan_key = int(sharing)
            self.category = category_for_level(plan_key)
        self.workers = workers
        self.costs = costs
        self.on_complete = on_complete
        self.plan = self._build_plan(plan_key, len(workers))
        self._chan_epoch = 0           # bumps per channel-plan migration
        self.channels = [DispatchChannel(q, self.plan.workers_of(q),
                                         recorder=self._rec)
                         for q in range(self.plan.n_queues)]
        self.policy: PlacementPolicy = make_policy(placement)
        # decode-side placement gets its own policy instance so e.g. a
        # round-robin rotation over prefill channels never perturbs the
        # rotation over decode channels (and session pins stay per-role)
        self._decode_policy: Optional[PlacementPolicy] = (
            make_policy(placement) if self.roles is not None else None)
        # in-flight + queued KV payloads: rid -> (KVHandoff, span key)
        self._handoff_payload: Dict[int, tuple] = {}
        self._handoff_seq: Dict[int, int] = {}
        self._handoffs = 0
        self._kv_tokens_moved = 0
        self._kv_bytes_moved = 0
        self._migrations = 0
        #: scheduled decode→decode live migrations: (t_ns, src, dst)
        self.migrations: List = []
        for t_mig, src, dst in (migrations or []):
            self._check_migration(src, dst)
            self.migrations.append((float(t_mig), int(src), int(dst)))
        # ----- online adaptation (DESIGN.md §12) -------------------------
        if adapt is not None:
            if self.vector is None:
                raise ValueError("adaptive routing needs a SharingVector "
                                 "or EndpointPlan, not a scalar category")
            if adapt.vector != self.vector:
                raise ValueError(f"the replanner starts at {adapt.vector} "
                                 f"but the fleet runs {self.vector}")
        self.adapt = adapt
        self.adapt_window_ns = adapt_window_ns
        self.transitions: List = []            # (t_ns, vector)
        self._n_windows = 0
        self._lock_wait_retired = 0.0          # pre-migration channels
        self._foot_t = 0.0                     # footprint integration
        self._foot_acc = 0.0
        # telemetry baselines for window deltas — the registry window
        # snapshots every counter NOW, not at zero: workers (and their
        # engines' graphs) persist across a ServeClient's runs while
        # each run builds a fresh router, so a zero baseline would hand
        # the first window the entire previous run's history as one
        # giant delta.  ``_sync_metrics`` publishes the fleet's absolute
        # totals first so the snapshot sees them.
        self._done_ingested = 0                # completions index
        self._sync_metrics()
        self._mwin = self.metrics.window()
        if self._rec.enabled:
            self._rec.name_track(PID_FLEET, TID_ROUTER, "router")
            for w in range(len(workers)):
                self._rec.name_track(PID_FLEET, TID_WORKER0 + w,
                                     f"worker {w}")
                if getattr(workers[w], "page_pool", None) is not None:
                    self._rec.name_track(PID_RESOURCES, TID_PAGES0 + w,
                                         f"pages {w}")
            for c in self.channels:
                self._rec.name_track(PID_RESOURCES, TID_CHANNEL0 + c.cid,
                                     f"channel {c.cid}")
        # scheduler state
        self._heap: list = []
        self._seq = 0
        self._clock = [0.0] * len(workers)     # per-worker virtual time
        self._scheduled = [False] * len(workers)
        self._arrivals: Dict[int, Arrival] = {}
        self.completions: List[Completion] = []
        self._events = 0
        # ----- chaos / recovery (DESIGN.md §15) --------------------------
        # Fault tolerance is STRICTLY opt-in: with neither a fault plan
        # nor a recovery policy the Router runs today's exact event
        # sequence (no probes, no extra event kinds, bit-identical
        # goldens).  Arming either switches on heartbeat probing,
        # placement fencing, shedding, and the retry machinery.
        if isinstance(faults, str):
            faults = parse_faults(faults)
        self.injector: Optional[FaultInjector] = None
        if isinstance(faults, FaultPlan) and len(faults):
            self.injector = FaultInjector(
                faults.validate(len(workers), self.plan.n_queues))
        self._ft: Optional[RecoveryManager] = None
        if self.injector is not None or recovery is not None:
            self._ft = RecoveryManager(
                recovery or RecoveryPolicy(), len(workers),
                critical=(range(self.roles[0])
                          if self.roles is not None else None))
        #: worker -> LostWork captured at death, pending detection
        self._lost: Dict[int, List[LostWork]] = {}
        self._completed_rids: set = set()      # exactly-once guard (FT)

    # ----- topology -------------------------------------------------------
    def _build_plan(self, key, n: int):
        """The dispatch topology for sharing-level ``key``: per-role
        sub-plans under disaggregation, the flat plan otherwise."""
        if self.roles is not None:
            return RoleDispatchPlan(key, *self.roles)
        return DispatchPlan(key, n)

    def _check_migration(self, src: int, dst: int) -> None:
        n = len(self.workers)
        if not (0 <= src < n and 0 <= dst < n) or src == dst:
            raise ValueError(f"bad migration {src}->{dst} "
                             f"on a {n}-worker fleet")
        if self.roles is not None and (src < self.roles[0]
                                       or dst < self.roles[0]):
            raise ValueError(
                f"migration {src}->{dst} must stay inside the decode "
                f"sub-fleet [{self.roles[0]}, {n})")

    # ----- event plumbing -------------------------------------------------
    def _push(self, t: float, kind: str, data) -> None:
        heapq.heappush(self._heap, (t, self._seq, kind, data))
        self._seq += 1

    def _wake(self, w: int, t: float) -> None:
        """Schedule worker ``w`` unless it already has a pending wake —
        idle workers hold zero events (no spinning on empty queues).
        Fenced (dead) workers are never scheduled."""
        if self._ft is not None and self._ft.fenced(w):
            return
        if not self._scheduled[w]:
            self._scheduled[w] = True
            self._push(t, "wake", w)

    # ----- handlers -------------------------------------------------------
    def _qkey(self, rid: int) -> str:
        """Queue-span key: (rid, channel epoch), plus the retry attempt
        when the recovery layer has re-placed the request — each
        re-placement opens a fresh span instead of colliding with the
        one its admission (or death) closed."""
        a = self._ft.attempts.get(rid, 0) if self._ft is not None else 0
        base = f"{rid}q{self._chan_epoch}"
        return base if a == 0 else f"{base}a{a}"

    def _queue_span_key(self, rid: int) -> str:
        """The open queue span's key for ``rid``: handoff placements
        carry their own key (suffixed by the handoff sequence number so
        a session migrated repeatedly never collides)."""
        entry = self._handoff_payload.get(rid)
        return entry[1] if entry is not None else self._qkey(rid)

    def _eligible_channels(self) -> Optional[List[int]]:
        """FT placement fence: channels with at least one worker NOT
        declared dead; among those, prefer channels with a
        non-straggling live worker.  None = no filtering (fault-free
        mode, or nothing detected yet)."""
        ft = self._ft
        if ft is None or (not any(d is not None for d in ft.detected)
                          and not any(ft.straggling)):
            return None
        live = [q for q, c in enumerate(self.channels)
                if any(not ft.is_detected(w) for w in c.workers)]
        if not live:
            return None               # everyone is dead: place anywhere
        good = [q for q in live
                if any(not ft.is_detected(w) and not ft.straggling[w]
                       for w in self.channels[q].workers)]
        return good or live

    def _channel_load(self, c: DispatchChannel) -> float:
        """Aggregate in-flight load of a channel's worker group.  Fenced
        (dead) members are excluded and the survivors' load is scaled
        back up to the full group size, so a half-dead group reads as
        the reduced-capacity channel it is (bugfix: the raw sum let
        ``LeastLoaded`` treat a group that lost a member as having shed
        load, steering arrivals at its lone survivor).  Fault-free
        fleets take the exact integer sum — golden-stable."""
        ft = self._ft
        members = c.workers
        if ft is None or not any(ft.fenced(w) for w in members):
            return sum(self.workers[w].n_active for w in members)
        live = [w for w in members if not ft.fenced(w)]
        if not live:
            return sum(self.workers[w].n_active for w in members)
        return (sum(self.workers[w].n_active for w in live)
                * len(members) / len(live))

    def _place(self, t: float, arr: Arrival) -> None:
        """Put one arrival onto a channel via the placement policy and
        wake that channel's workers — shared by fresh arrivals, the
        re-placement of queued work after a channel-plan migration, and
        crash-recovery retries.  Disaggregated fleets restrict fresh
        prompts to the PREFILL channels."""
        if self.roles is not None and self._ft is not None \
                and all(self._ft.is_detected(w)
                        for w in range(self.roles[0])):
            # nowhere left to prefill: re-prefill on a survivor is
            # impossible, the request fails here instead of stranding
            # on a drained channel
            self._fail_request(t, arr.rid, "no_prefill_workers")
            return
        depths = [len(c) for c in self.channels]
        loads = [self._channel_load(c) for c in self.channels]
        eligible = self._eligible_channels()
        if self.roles is not None:
            pool = self.plan.prefill_queues
            if eligible is not None:
                live = set(eligible)
                eligible = [q for q in pool if q in live] or pool
            else:
                eligible = pool
        qid = self.policy.choose(arr, depths, loads, eligible)
        if eligible is not None and qid not in eligible:
            # deterministic remap off fenced/straggling channels; works
            # for ANY policy (round-robin never sees queue state)
            qid = eligible[qid % len(eligible)]
        released = self.channels[qid].push(t, arr, self.costs.t_enqueue_ns)
        if self._rec.enabled:
            # the queue-wait span is keyed by (rid, channel epoch) so a
            # migration's drain + re-place opens a fresh span instead of
            # colliding with the one the drain closed
            self._rec.begin(PID_REQUESTS, "queue", self._qkey(arr.rid),
                            t, cat="queue", args={"queue": qid})
        for w in self.channels[qid].workers:
            self._wake(w, max(released, self._clock[w]))

    def _on_arrival(self, t: float, arr: Arrival) -> None:
        if arr.rid in self._arrivals:
            raise ValueError(f"duplicate rid {arr.rid}")
        if self._ft is not None:
            # overload shedding happens BEFORE acceptance: a shed
            # arrival is never registered, admitted, or partially
            # served — the never-accepted-then-dropped invariant
            outstanding = (len(self._arrivals) - len(self.completions)
                           - len(self._ft.failed))
            reason = self._ft.shed_reason(arr, t, outstanding)
            if reason is not None:
                self._ft.record_shed(arr.rid, reason, t)
                self.metrics.counter("fleet.shed", reason=reason).inc()
                if self._rec.enabled:
                    self._rec.instant(PID_FLEET, TID_ROUTER, "shed", t,
                                      cat="fault",
                                      args={"rid": arr.rid,
                                            "reason": reason,
                                            "priority": arr.priority})
                return
        self._arrivals[arr.rid] = arr
        if self._rec.enabled:
            self._rec.begin(PID_REQUESTS, "request", arr.rid, t,
                            args={"prompt_len": arr.prompt_len,
                                  "max_new": arr.max_new_tokens})
        self._place(t, arr)

    def _on_wake(self, t: float, w: int) -> None:
        self._scheduled[w] = False
        ft = self._ft
        if ft is not None:
            if ft.fenced(w):
                return                # dead: the wake is void
            if t < ft.stall_until[w]:
                # stalled: one deferred wake at the stall's end — no
                # steps, no heartbeat (a long stall gets fenced)
                self._wake(w, ft.stall_until[w])
                return
            # heartbeat + straggler telemetry: the wake-to-wake gap is
            # the fleet's "step time" stream, fed to the SAME rolling-
            # median mitigator the training stack uses
            ft.observe_gap(w, t)
            ft.beat(w, t)
        t = max(t, self._clock[w])
        worker = self.workers[w]
        chan = self.channels[self.plan.queue_of(w)]
        if self.roles is not None and self.plan.role_of(w) == "prefill":
            self._prefill_wake(t, w, worker, chan)
            return
        rec, tracing = self._rec, self._rec.enabled
        if tracing:
            # instant-event probes: page deferrals and graph captures
            # show up as counter jumps across this wake's admissions +
            # step
            pool = getattr(worker, "page_pool", None)
            defer0 = pool.deferrals if pool is not None else 0
            probe = getattr(worker, "compile_probe", None)
            comp0 = probe()[1] if probe is not None else 0
        while worker.capacity() > 0 and len(chan) > 0:
            arr, t = chan.pop(t, self.costs.t_dequeue_ns)
            if arr is None:       # a sibling drained it first
                break
            entry = self._handoff_payload.pop(arr.rid, None)
            if tracing:
                rec.end(PID_REQUESTS, "queue",
                        entry[1] if entry is not None
                        else self._qkey(arr.rid), t, cat="queue")
            t0 = t
            if entry is not None:
                # a KV payload landing: install the cache, no prefill
                t += worker.admit_handoff(arr, entry[0], t)
            elif ft is not None and ft.attempts.get(arr.rid, 0) > 0 \
                    and hasattr(worker, "admit_retry"):
                # crash-recovery re-admission: prompt + emitted prefix
                t += worker.admit_retry(arr, self._arrivals[arr.rid],
                                        ft.prefix_of(arr.rid)[1], t)
            else:
                t += worker.admit(arr, t)
            if tracing:
                rec.complete(PID_FLEET, TID_WORKER0 + w, "admit", t0,
                             t - t0, cat="admit", args={"rid": arr.rid})
        cost, done = worker.step(t)
        if ft is not None and done:
            done = self._splice_completions(done)
        if tracing:
            if pool is not None and pool.deferrals > defer0:
                rec.instant(PID_RESOURCES, TID_PAGES0 + w,
                            "page_deferral", t, cat="pages",
                            args={"count": pool.deferrals - defer0,
                                  "worker": w})
            if probe is not None:
                comp1 = probe()[1]
                if comp1 > comp0:
                    rec.instant(PID_FLEET, TID_WORKER0 + w, "jit_compile",
                                t, cat="execs",
                                args={"count": comp1 - comp0, "worker": w})
        if cost > 0.0:
            t_end = t + cost
            if tracing:
                rec.complete(PID_FLEET, TID_WORKER0 + w, "step", t, cost,
                             cat="step", args={"worker": w,
                                               "retired": len(done)})
                for c in done:
                    rec.end(PID_REQUESTS, "request", c.rid, t_end,
                            args={"worker": c.worker,
                                  "new_tokens": c.new_tokens})
            self.completions.extend(done)
            if self.on_complete is not None:
                for c in done:
                    for arr in self.on_complete(c) or ():
                        # chained work (a stream's next request) enters
                        # the fabric no earlier than the completion that
                        # released it
                        self._push(max(arr.t_ns, t_end), "arrival", arr)
            self._clock[w] = t_end
            self._wake(w, t_end)      # keep stepping while slots are live
        else:
            self._clock[w] = t        # idle: zero pending events

    # ----- prefill/decode disaggregation (DESIGN.md §17) ------------------
    def _prefill_wake(self, t: float, w: int, worker, chan) -> None:
        """Prefill-role wake: pop ONE arrival, run its prefill (the
        admit cost IS the forward pass — prefill workers never decode),
        and launch the KV payload toward the decode sub-fleet.  One
        arrival per wake keeps sibling prefill workers draining a shared
        channel in parallel instead of one worker hoarding a burst."""
        rec, tracing = self._rec, self._rec.enabled
        if len(chan) == 0:
            self._clock[w] = t
            return
        arr, t = chan.pop(t, self.costs.t_dequeue_ns)
        if arr is None:               # a sibling drained it first
            self._clock[w] = t
            return
        if tracing:
            rec.end(PID_REQUESTS, "queue", self._qkey(arr.rid), t,
                    cat="queue")
        ft = self._ft
        t0 = t
        if ft is not None and ft.attempts.get(arr.rid, 0) > 0 \
                and hasattr(worker, "admit_retry_prefill"):
            # crash-recovery redo: prompt + emitted prefix, so the KV
            # payload carries everything the dead decode worker held
            cost, h = worker.admit_retry_prefill(
                arr, self._arrivals[arr.rid], ft.prefix_of(arr.rid)[1], t)
        else:
            cost, h = worker.admit_prefill(arr, t)
        t += cost
        if tracing:
            rec.complete(PID_FLEET, TID_WORKER0 + w, "prefill", t0,
                         t - t0, cat="admit", args={"rid": arr.rid})
        self._launch_handoff(t, arr, h)
        self._clock[w] = t
        if len(chan) > 0:
            self._wake(w, t)

    def _launch_handoff(self, t: float, arr: Arrival, h: KVHandoff,
                        dst_queue: Optional[int] = None) -> None:
        """Ship one KV payload across the fabric: a ``handoff`` event
        lands after the size-proportional transfer cost.  ``dst_queue``
        pins the destination channel (live migration); None lets the
        decode placement policy choose on landing."""
        n = self._handoff_seq.get(arr.rid, 0) + 1
        self._handoff_seq[arr.rid] = n
        cost = (self.costs.t_handoff_base_ns
                + h.kv_tokens * self.costs.t_handoff_per_token_ns)
        self._handoffs += 1
        self._kv_tokens_moved += h.kv_tokens
        self._kv_bytes_moved += h.kv_bytes
        m = self.metrics
        m.counter("fleet.handoffs").inc()
        m.counter("fleet.kv_tokens_moved").inc(h.kv_tokens)
        m.counter("fleet.kv_bytes_moved").inc(h.kv_bytes)
        if self._rec.enabled:
            # keyed per launch (a session migrated repeatedly opens a
            # fresh span each time — equal-timestamp key reuse breaks
            # the async-span validator)
            self._rec.begin(PID_REQUESTS, "handoff", f"{arr.rid}h{n}", t,
                            cat="handoff",
                            args={"rid": arr.rid, "kv_tokens": h.kv_tokens,
                                  "kv_bytes": h.kv_bytes})
        self._push(t + cost, "handoff", (arr, h, n, dst_queue))

    def _on_handoff(self, t: float, data) -> None:
        arr, h, n, dst_queue = data
        if self._rec.enabled:
            self._rec.end(PID_REQUESTS, "handoff", f"{arr.rid}h{n}", t,
                          cat="handoff")
        self._place_handoff(t, arr, h, dst_queue)

    def _place_handoff(self, t: float, arr: Arrival, h: KVHandoff,
                       dst_queue: Optional[int] = None) -> None:
        """Land a KV payload on a decode channel (any channel on a
        co-located fleet): park the payload for the admitting worker,
        push the arrival, wake the group."""
        pool = (self.plan.decode_queues if self.roles is not None
                else list(range(len(self.channels))))
        eligible = self._eligible_channels()
        if eligible is not None:
            live = set(eligible)
            cands = [q for q in pool if q in live]
        else:
            cands = pool
        if not cands:
            # every decode worker is fenced: the cache has nowhere to
            # land and a re-prefill could never decode either — fail
            # definitively instead of stranding the payload
            self._fail_request(t, arr.rid, "no_decode_workers")
            return
        if dst_queue is not None:
            qid = (dst_queue if dst_queue in cands
                   else cands[dst_queue % len(cands)])
        else:
            depths = [len(c) for c in self.channels]
            loads = [self._channel_load(c) for c in self.channels]
            policy = self._decode_policy or self.policy
            qid = policy.choose(arr, depths, loads, cands)
            if qid not in set(cands):
                qid = cands[qid % len(cands)]
        skey = f"{self._qkey(arr.rid)}h{self._handoff_seq[arr.rid]}"
        self._handoff_payload[arr.rid] = (h, skey)
        released = self.channels[qid].push(t, arr, self.costs.t_enqueue_ns)
        if self._rec.enabled:
            self._rec.begin(PID_REQUESTS, "queue", skey, t, cat="queue",
                            args={"queue": qid, "handoff": True})
        for w in self.channels[qid].workers:
            self._wake(w, max(released, self._clock[w]))

    def _fail_request(self, t: float, rid: int, reason: str) -> None:
        """Terminal failure outside the retry machinery (no live
        prefill / decode sub-fleet left): close the ledgers so the
        report and the exactly-once client both see a definite end."""
        self._handoff_payload.pop(rid, None)
        if self._ft is not None and rid not in self._ft.failed:
            self._ft.failed.append(rid)
        self.metrics.counter("fleet.failed").inc()
        if self._rec.enabled:
            self._rec.instant(PID_FLEET, TID_ROUTER, "fail", t,
                              cat="fault",
                              args={"rid": rid, "reason": reason})
            self._rec.end(PID_REQUESTS, "request", rid, t,
                          args={"failed": True})

    def _on_migrate(self, t: float, data) -> None:
        """Scheduled decode→decode live migration: strip every live
        session off ``src`` and re-ship each as a KV handoff bound for
        ``dst``'s channel — no token dropped, no prefill redone (the
        channel-migration drain path, with the cache travelling along)."""
        src, dst = data
        ft = self._ft
        if ft is not None and (ft.fenced(src) or ft.fenced(dst)):
            return                 # a dead endpoint voids the migration
        self._migrations += 1
        self.metrics.counter("fleet.migrations").inc()
        tm = max(t, self._clock[src])
        export = getattr(self.workers[src], "export_sessions", None)
        handoffs = export() if export is not None else []
        if self._rec.enabled:
            self._rec.instant(PID_FLEET, TID_ROUTER, "migrate", tm,
                              cat="handoff",
                              args={"src": src, "dst": dst,
                                    "sessions": len(handoffs)})
        dstq = self.plan.queue_of(dst)
        for h in handoffs:
            self._launch_handoff(tm, self._arrivals[h.rid], h,
                                 dst_queue=dstq)
        self._wake(src, tm)

    # ----- chaos: fault injection + crash recovery (DESIGN.md §15) --------
    def _splice_completions(self, done: List[Completion]
                            ) -> List[Completion]:
        """FT post-processing of a step's completions: drop duplicates
        (defensive — the fail-stop fencing should make them impossible),
        splice a recovered request's pre-crash prefix back onto its
        continuation, and mark recoveries."""
        ft, out = self._ft, []
        for c in done:
            if c.rid in self._completed_rids:
                ft.duplicates += 1
                self.metrics.counter("fleet.duplicate_completions").inc()
                continue
            self._completed_rids.add(c.rid)
            emitted, toks = ft.prefix_of(c.rid)
            if emitted or toks:
                output = c.output
                if output is not None:
                    output = list(toks or []) + list(output)
                c = dataclasses.replace(
                    c, new_tokens=c.new_tokens + emitted, output=output)
            if ft.attempts.get(c.rid, 0) > 0:
                ft.note_completed(c.rid)
                self.metrics.counter("fleet.recovered").inc()
                if self._rec.enabled:
                    self._rec.instant(
                        PID_FLEET, TID_ROUTER, "recover", c.t_done_ns,
                        cat="fault",
                        args={"rid": c.rid,
                              "attempts": ft.attempts[c.rid]})
            out.append(c)
        return out

    def _on_fault(self, t: float, spec) -> None:
        """Apply one scheduled ``FaultSpec`` (the injector's event)."""
        ft = self._ft
        self.injector.fire(spec)
        self.metrics.counter("fleet.faults", kind=spec.kind).inc()
        if self._rec.enabled:
            self._rec.instant(PID_FLEET, TID_ROUTER, "fault", t,
                              cat="fault",
                              args={"kind": spec.kind,
                                    "target": spec.target,
                                    "duration_ns": spec.duration_ns})
        if spec.kind == "crash":
            self._kill_worker(t, spec.target)
        elif spec.kind == "stall":
            w = spec.target
            if not ft.fenced(w):
                ft.stall_until[w] = max(ft.stall_until[w],
                                        t + spec.duration_ns)
        elif spec.kind == "chan_stall":
            self.channels[spec.target % len(self.channels)].hold(
                t, spec.duration_ns)
        elif spec.kind == "page_pressure":
            pool = getattr(self.workers[spec.target], "page_pool", None)
            if pool is not None:
                seized = pool.seize(int(spec.frac * pool.free_pages))
                if seized:
                    self._push(t + spec.duration_ns, "restore",
                               (spec.target, seized))

    def _kill_worker(self, t: float, w: int) -> None:
        """Fail-stop at a step boundary: fence the worker (wakes void,
        no more heartbeats) and capture everything it was holding.  The
        residue stays ours until DETECTION — the recovery layer may not
        act on knowledge the failure detector does not have yet."""
        ft = self._ft
        if ft.fenced(w):
            return
        ft.mark_dead(w, t)
        kill = getattr(self.workers[w], "kill", None)
        lost = kill() if kill is not None else []
        if lost:
            self._lost.setdefault(w, []).extend(lost)

    def _worker_holds_work(self, w: int) -> bool:
        return (bool(self._lost.get(w))
                or len(self.channels[self.plan.queue_of(w)]) > 0
                or self.workers[w].n_active > 0)

    def _on_probe(self, t: float) -> None:
        """Heartbeat probe: refresh beats of genuinely idle workers
        (idle + empty channel = vacuously healthy; an idle fleet must
        not get fenced), declare overdue workers dead, and keep the
        probe chain alive while the run — or any undetected residue —
        is live."""
        ft = self._ft
        for w in range(len(self.workers)):
            if ft.is_detected(w):
                continue
            if not ft.fenced(w) and not self._worker_holds_work(w):
                ft.beat(w, t)
                continue
            if ft.overdue(w, t):
                self._detect_dead(t, w)
        if self._heap or self._needs_probe():
            self._push(t + ft.policy.heartbeat_ns, "probe", None)

    def _needs_probe(self) -> bool:
        """True while some fenced-but-undetected worker still holds
        work — the probe chain must outlive the last data event or
        that residue would never be recovered."""
        ft = self._ft
        return any(ft.fenced(w) and not ft.is_detected(w)
                   and self._worker_holds_work(w)
                   for w in range(len(self.workers)))

    def _detect_dead(self, t: float, w: int) -> None:
        """Declare worker ``w`` dead and hand every piece of its work
        to the retry machinery: residue captured at death, plus any
        arrivals stranded on a channel with no unfenced member left."""
        ft = self._ft
        if not ft.fenced(w):
            # a stall (or silent wedge) past the deadline is
            # indistinguishable from a crash: fence it NOW — if the
            # worker later "wakes", the fence voids it (fail-stop)
            self._kill_worker(t, w)
        lat = ft.mark_detected(w, t)
        self.metrics.counter("fleet.detections").inc()
        self.metrics.histogram("fleet.recovery_latency_ms").observe(
            lat / 1e6)
        if self._rec.enabled:
            self._rec.instant(PID_FLEET, TID_ROUTER, "detect", t,
                              cat="fault",
                              args={"worker": w, "latency_ns": lat})
        chan = self.channels[self.plan.queue_of(w)]
        if all(ft.fenced(x) for x in chan.workers):
            for arr in chan.drain():
                if self._rec.enabled:
                    self._rec.end(PID_REQUESTS, "queue",
                                  self._queue_span_key(arr.rid), t,
                                  cat="queue")
                # a KV payload stranded on the dead channel is lost with
                # it — but its emitted prefix survives in the LostWork,
                # so the re-prefill on a survivor resumes bit-exactly
                entry = self._handoff_payload.pop(arr.rid, None)
                lw = LostWork(rid=arr.rid)
                if entry is not None:
                    h0 = entry[0]
                    done = max(0, h0.pos
                               - self._arrivals[arr.rid].prompt_len)
                    if h0.emitted:
                        lw = LostWork(rid=arr.rid,
                                      emitted=len(h0.emitted),
                                      tokens=list(h0.emitted))
                    elif done:
                        lw = LostWork(rid=arr.rid, emitted=done)
                self._lost.setdefault(w, []).append(lw)
        for lw in self._lost.pop(w, []):
            ft.note_lost(lw)
            self._schedule_retry(t, lw.rid)

    def _schedule_retry(self, t: float, rid: int) -> None:
        ft = self._ft
        delay = ft.next_attempt(rid)
        if delay is None:
            self.metrics.counter("fleet.failed").inc()
            if self._rec.enabled:
                self._rec.instant(PID_FLEET, TID_ROUTER,
                                  "retry_exhausted", t, cat="fault",
                                  args={"rid": rid})
                self._rec.end(PID_REQUESTS, "request", rid, t,
                              args={"failed": True})
            return
        self.metrics.counter("fleet.retries").inc()
        self._push(t + delay, "retry", rid)

    def _on_retry(self, t: float, rid: int) -> None:
        """Re-place a lost request: same rid, arrival time NOW, prompt
        length inflated by the emitted prefix (re-prefill cost is
        real), token budget shrunk by it (the prefix is not decoded
        twice).  Latency still accrues from the ORIGINAL arrival."""
        ft = self._ft
        orig = self._arrivals[rid]
        emitted, _ = ft.prefix_of(rid)
        arr = dataclasses.replace(
            orig, t_ns=t, prompt_len=orig.prompt_len + emitted,
            max_new_tokens=max(1, orig.max_new_tokens - emitted))
        if self._rec.enabled:
            self._rec.instant(PID_FLEET, TID_ROUTER, "retry", t,
                              cat="fault",
                              args={"rid": rid,
                                    "attempt": ft.attempts.get(rid, 0),
                                    "emitted": emitted})
        self._place(t, arr)

    # ----- adaptation -----------------------------------------------------
    def _fleet_compiles(self) -> int:
        """Fleet-wide horizon graph captures, each exec group counted
        once (the worker probe returns its group's identity)."""
        seen, compiles = set(), 0
        for w in self.workers:
            probe = getattr(w, "compile_probe", None)
            if probe is None:
                continue             # duck-typed workers compile nothing
            key, count = probe()
            if key is None or key in seen:
                continue
            seen.add(key)
            compiles += count
        return compiles

    def _sync_metrics(self) -> None:
        """Publish the fleet's absolute resource counters into the
        registry — the metrics fabric (DESIGN.md §14).  ``set_total`` is
        idempotent, so syncing is safe at any cadence; every label set
        carries the resource axis it describes (the serving analogue of
        the paper's per-resource CTX/PD/CQ/QP counters)."""
        m = self.metrics
        for w, worker in enumerate(self.workers):
            st = worker.stats
            m.counter("worker.slot_steps", axis="slots",
                      worker=w).set_total(st["slot_steps"])
            m.counter("worker.busy_slot_steps", axis="slots",
                      worker=w).set_total(st["busy_slot_steps"])
            m.counter("worker.admitted", axis="slots",
                      worker=w).set_total(st["admitted"])
            eng = getattr(worker, "engine", None)
            if eng is not None:
                eng.publish_metrics(m, worker=w)
            else:
                pool = getattr(worker, "page_pool", None)
                if pool is not None:
                    pool.publish_metrics(m, axis="pages", worker=w)
        for c in self.channels:
            m.counter("channel.lock_wait_ns", axis="channels",
                      group=c.cid, epoch=self._chan_epoch).set_total(
                          c.stats["lock_wait_ns"])
            m.counter("channel.enqueued", axis="channels", group=c.cid,
                      epoch=self._chan_epoch).set_total(
                          c.stats["enqueued"])
            m.gauge("channel.peak_depth", axis="channels", group=c.cid,
                    epoch=self._chan_epoch).set(c.stats["peak_depth"])
        # fleet rollups: retired channels (pre-migration) fold into ONE
        # monotone total, and the dedup'd compile count covers shared
        # executable sets once
        m.counter("fleet.lock_wait_ns", axis="channels").set_total(
            self._lock_wait_retired
            + sum(c.stats["lock_wait_ns"] for c in self.channels))
        m.counter("exec.jit_compiles", axis="execs").set_total(
            self._fleet_compiles())

    def _ingest_completions(self) -> List[Completion]:
        """Feed completions not yet seen by the metrics fabric into the
        registry (tokens delivered + the streaming latency sketch); ->
        the freshly ingested slice."""
        fresh = self.completions[self._done_ingested:]
        self._done_ingested = len(self.completions)
        if fresh:
            m = self.metrics
            for c in fresh:
                lat_ms = (c.t_done_ns - self._arrivals[c.rid].t_ns) / 1e6
                m.counter("request.tokens",
                          worker=c.worker).inc(c.new_tokens)
                m.counter("fleet.completed").inc()
                m.histogram("request.latency_ms",
                            worker=c.worker).observe(lat_ms)
        return fresh

    def _window_stats(self, t: float) -> WindowStats:
        """Telemetry delta since the last adaptation window, read from
        the metrics registry (DESIGN.md §14): the fabric publishes its
        absolute counters, the registry window reports what accrued."""
        m, win = self.metrics, self._mwin
        self._sync_metrics()
        fresh = self._ingest_completions()
        d_slot = win.delta_total("worker.slot_steps")
        d_busy = win.delta_total("worker.busy_slot_steps")
        d_lock = win.delta("fleet.lock_wait_ns", axis="channels")
        d_compiles = win.delta("exec.jit_compiles", axis="execs")
        d_tokens = win.delta_total("request.tokens")
        # p99 and lock wait drive no pressure today — they ride along so
        # the window record matches what operators (and future policies)
        # see.  The window p99 is EXACT (obs.quantile over the window's
        # raw latencies); the registry's request.latency_ms sketch is the
        # streaming estimate for whole-run export.
        lat = [c.t_done_ns - self._arrivals[c.rid].t_ns for c in fresh]
        p99 = quantile(lat, 0.99) / 1e6
        for c in self.channels:
            m.gauge("channel.window_peak_depth", axis="channels",
                    group=c.cid, epoch=self._chan_epoch).set(
                        c.reset_window())
        depth = max((m.value("channel.window_peak_depth", axis="channels",
                             group=c.cid, epoch=self._chan_epoch)
                     / max(1, len(c.workers)) for c in self.channels),
                    default=0.0)
        page_p = 0.0
        for w, worker in enumerate(self.workers):
            if getattr(worker, "page_pool", None) is not None:
                page_p = max(page_p, m.value("pages.pressure",
                                             axis="pages", worker=w))
        if self._rec.enabled:
            for c in self.channels:
                self._rec.counter(PID_RESOURCES, TID_CHANNEL0 + c.cid,
                                  "queue_depth", t, {"depth": len(c)})
            for w, worker in enumerate(self.workers):
                pool = getattr(worker, "page_pool", None)
                if pool is not None:
                    self._rec.counter(PID_RESOURCES, TID_PAGES0 + w,
                                      "page_pressure", t,
                                      {"live_frac": pool.pressure()})
        win.roll()
        return WindowStats(
            occupancy=d_busy / d_slot if d_slot else 0.0,
            queue_depth=depth, lock_wait_ns=d_lock, p99_ms=p99,
            jit_compiles=max(0, int(d_compiles)),
            tokens=int(d_tokens),
            page_pressure=page_p)

    def _on_replan(self, t: float) -> None:
        self._n_windows += 1
        stats = self._window_stats(t)
        self.metrics.counter("fleet.windows").inc()
        if self._rec.enabled:
            self._rec.instant(PID_FLEET, TID_ROUTER, "window", t,
                              cat="adapt",
                              args={"window": self._n_windows,
                                    "occupancy": stats.occupancy,
                                    "queue_depth": stats.queue_depth,
                                    "page_pressure": stats.page_pressure})
        proposal = self.adapt.observe(stats)
        if proposal is not None:
            self.apply_vector(t, proposal)
        if self._heap:
            # keep sampling while the run is live (idle phases included:
            # they are exactly when demotion telemetry accrues); a drained
            # heap ends the run and the window chain with it
            self._push(t + self.adapt_window_ns, "replan", None)

    def apply_vector(self, t: float, new: SharingVector) -> None:
        """Execute one live migration at virtual time ``t`` — THE fleet
        transition path, shared by the automatic controller and
        ``ServeClient.replan``:

        * **channels**: rebuild the ``DispatchPlan`` and its channels,
          draining queued arrivals from the old set and re-placing them
          in arrival order (each re-placement pays the normal enqueue
          lock at ``t`` — migration is visible in the lock telemetry,
          never in token values);
        * **slots**: every worker's pool re-keys in place — in-flight
          requests keep their slots, only future admissions regroup;
        * **execs**: every engine worker re-keys its shared-executable
          group (compiles lazily on first use; in-flight work finishes
          on the old executable).
        """
        old, n = self.vector, len(self.workers)
        self._integrate_footprint(t)
        if self._rec.enabled:
            self._rec.instant(PID_FLEET, TID_ROUTER, "replan", t,
                              cat="adapt",
                              args={"from": old.label, "to": new.label,
                                    "slots": new.slots,
                                    "channels": new.channels,
                                    "execs": new.execs,
                                    "pages": new.pages})
        self.metrics.counter("fleet.transitions").inc()
        if new.channels != old.channels:
            pending = [a for c in self.channels for a in c.drain()]
            pending.sort(key=lambda a: (a.t_ns, a.rid))
            # final lock totals of the retiring channel set land in the
            # registry under their epoch before the labels freeze
            self._sync_metrics()
            if self._rec.enabled:
                for arr in pending:
                    self._rec.end(PID_REQUESTS, "queue",
                                  self._queue_span_key(arr.rid), t,
                                  cat="queue")
            self._lock_wait_retired += sum(
                c.stats["lock_wait_ns"] for c in self.channels)
            self.plan = self._build_plan(new.channels, n)
            self._chan_epoch += 1
            self.channels = [DispatchChannel(q, self.plan.workers_of(q),
                                             recorder=self._rec)
                             for q in range(self.plan.n_queues)]
            self.category = category_for_level(new.channels)
            if self._rec.enabled:
                for c in self.channels:
                    self._rec.name_track(PID_RESOURCES,
                                         TID_CHANNEL0 + c.cid,
                                         f"channel {c.cid}")
            for arr in pending:
                # a drained KV payload re-lands on the NEW decode
                # channel set; plain arrivals take the normal path
                entry = self._handoff_payload.pop(arr.rid, None)
                if entry is not None:
                    self._place_handoff(t, arr, entry[0])
                else:
                    self._place(t, arr)
        if new.slots != old.slots:
            for w in self.workers:
                w.regroup(slot_level=new.slots)
            # freed admission capacity (e.g. a drained group splitting)
            # must not strand queued work behind idle workers
            for w in range(n):
                self._wake(w, max(t, self._clock[w]))
        if new.execs != old.execs:
            for i, w in enumerate(self.workers):
                w.regroup(exec_group=new.exec_group_of(i, n))
        if new.pages != old.pages:
            # pure budget re-keying (PagePool.regroup): no page moves,
            # token values invariant — workers without a pool ignore it
            for w in self.workers:
                w.regroup(page_level=new.pages)
            for w in range(n):
                self._wake(w, max(t, self._clock[w]))
        self.vector = new
        self.transitions.append((t, new))

    def _integrate_footprint(self, t: float) -> None:
        if self.vector is not None and t > self._foot_t:
            n_slots = getattr(self.workers[0], "n_slots", 4)
            score = self.vector.footprint_score(len(self.workers), n_slots)
            self._foot_acc += score * (t - self._foot_t)
            self._foot_t = t

    def _mean_footprint(self, makespan: float) -> Optional[float]:
        if self.vector is None:
            return None
        n_slots = getattr(self.workers[0], "n_slots", 4)
        score = self.vector.footprint_score(len(self.workers), n_slots)
        horizon = max(makespan, self._foot_t)
        if horizon <= 0.0:
            return score
        self._integrate_footprint(horizon)
        return self._foot_acc / horizon

    # ----- run ------------------------------------------------------------
    def run(self, trace: List[Arrival]) -> FleetReport:
        for arr in trace:
            self._push(arr.t_ns, "arrival", arr)
        if self.adapt is not None and self._heap:
            self._push(self.adapt_window_ns, "replan", None)
        if self.injector is not None:
            for t, spec in self.injector.schedule():
                self._push(t, "fault", spec)
        if self._ft is not None and self._heap:
            self._push(self._ft.policy.heartbeat_ns, "probe", None)
        for t_mig, src, dst in self.migrations:
            self._push(t_mig, "migrate", (src, dst))
        while self._heap:
            t, _, kind, data = heapq.heappop(self._heap)
            self._events += 1
            if kind == "arrival":
                self._on_arrival(t, data)
            elif kind == "replan":
                self._on_replan(t)
            elif kind == "fault":
                self._on_fault(t, data)
            elif kind == "probe":
                self._on_probe(t)
            elif kind == "retry":
                self._on_retry(t, data)
            elif kind == "handoff":
                self._on_handoff(t, data)
            elif kind == "migrate":
                self._on_migrate(t, data)
            elif kind == "restore":
                w, pages = data
                pool = getattr(self.workers[w], "page_pool", None)
                if pool is not None:
                    pool.restore(pages)
                self._wake(w, max(t, self._clock[w]))
            else:
                self._on_wake(t, data)

        # final publish: the report below is a VIEW over the registry —
        # its occupancy and lock-wait numbers are read back from the
        # published counters, and the registry itself rides along on the
        # ``metrics`` field for any deeper query (or --metrics-out)
        self._sync_metrics()
        self._ingest_completions()
        m = self.metrics
        latency = {}
        for c in self.completions:
            arr = self._arrivals[c.rid]
            latency[c.rid] = c.t_done_ns - arr.t_ns
        makespan = max((c.t_done_ns for c in self.completions),
                       default=0.0)
        slot_steps = m.total("worker.slot_steps")
        busy = m.total("worker.busy_slot_steps")
        # derived from completions (not worker step counters) so it sums
        # exactly to total_new_tokens even when an engine's budget-
        # exhaustion path emits a final extra token
        per_worker = [0] * len(self.workers)
        for c in self.completions:
            per_worker[c.worker] += c.new_tokens
        pools = [p for p in (getattr(w, "page_pool", None)
                             for w in self.workers) if p is not None]
        page_frac = (sum(p.hwm for p in pools)
                     / max(1, sum(p.n_slots * p.max_pages for p in pools))
                     if pools else None)
        return FleetReport(
            category=self.category,
            placement=self.policy.name,
            n_workers=len(self.workers),
            n_arrivals=len(self._arrivals),
            completions=list(self.completions),
            latency_ns=latency,
            makespan_ns=makespan,
            total_new_tokens=sum(c.new_tokens for c in self.completions),
            per_worker_tokens=per_worker,
            occupancy=busy / slot_steps if slot_steps else 0.0,
            lock_wait_ns=m.value("fleet.lock_wait_ns", axis="channels"),
            peak_depths=[c.stats["peak_depth"] for c in self.channels],
            endpoint_usage=self.plan.endpoint_usage(),
            vector=self.vector,
            transitions=list(self.transitions),
            mean_footprint=self._mean_footprint(makespan),
            n_windows=self._n_windows,
            page_hwm_frac=page_frac,
            page_deferrals=sum(p.deferrals for p in pools),
            metrics=m,
            faults_injected=(self.injector.n_fired
                             if self.injector is not None else 0),
            detections=(self._ft.detections
                        if self._ft is not None else 0),
            retries=self._ft.retries if self._ft is not None else 0,
            recovered=(list(self._ft.recovered)
                       if self._ft is not None else []),
            failed=(list(self._ft.failed)
                    if self._ft is not None else []),
            shed=list(self._ft.shed) if self._ft is not None else [],
            recovery_latency_ns=(list(self._ft.latency_ns)
                                 if self._ft is not None else []),
            duplicate_completions=(self._ft.duplicates
                                   if self._ft is not None else 0),
            roles=self.roles,
            handoffs=self._handoffs,
            kv_tokens_moved=self._kv_tokens_moved,
            kv_bytes_moved=self._kv_bytes_moved,
            migrations=self._migrations,
        )


def build_sim_fleet(n_workers: int, sharing, *,
                    n_slots: int = 4, placement: str = "round_robin",
                    costs: FabricCosts = FabricCosts(),
                    adapt: Optional[Replanner] = None,
                    adapt_window_ns: float = 250_000.0,
                    page_size: int = 0, max_len: int = 512,
                    page_budget: Optional[int] = None,
                    obs: Optional[Observability] = None,
                    faults=None,
                    recovery: Optional[RecoveryPolicy] = None,
                    roles=None,
                    migrations: Optional[List] = None) -> Router:
    """The bench/test entrypoint: N virtual workers behind a router.

    ``sharing`` follows ``Router``: a ``Category`` (historical — dispatch
    sharing only, worker slots stay dedicated) or a
    ``SharingVector``/``EndpointPlan``, whose ``slots`` axis then also
    keys every worker's pool — the full off-diagonal plan space on the
    virtual fleet.  ``adapt`` attaches a live ``core.adapt.Replanner``
    sampled every ``adapt_window_ns`` of virtual time.  ``page_size > 0``
    gives every worker a virtual KV ``PagePool`` (budgeted by the
    vector's ``pages`` axis and ``page_budget``, admission deferring when
    dry) — the paged-serving bench path."""
    slot_level, pages_level = 1, 1
    if isinstance(sharing, EndpointPlan):
        if sharing.page_size and not page_size:
            page_size = sharing.page_size
        if sharing.page_budget is not None and page_budget is None:
            page_budget = sharing.page_budget
        max_len = sharing.max_len
        if roles is None:
            roles = sharing.role_split
        sharing = sharing.vector
    if isinstance(sharing, SharingVector):
        slot_level = sharing.slots
        pages_level = sharing.pages
    workers = [SimWorker(w, n_slots=n_slots, costs=costs,
                         slot_level=slot_level, pages_level=pages_level,
                         page_size=page_size, max_len=max_len,
                         page_budget=page_budget)
               for w in range(n_workers)]
    return Router(workers, sharing, placement=placement, costs=costs,
                  adapt=adapt, adapt_window_ns=adapt_window_ns, obs=obs,
                  faults=faults, recovery=recovery, roles=roles,
                  migrations=migrations)
