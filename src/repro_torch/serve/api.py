"""`serve.connect`: the serving entry point of the port (DESIGN.md §11).

    client = serve.connect(cfg, "shared_dynamic")          # on the card
    client = serve.connect(cfg, SharingVector(pages=4), device="cpu")
    client = serve.connect(cfg, Hints(latency_target_ms=80,
                                      burstiness=0.9),
                           plan_repository=PlanRepository("r.sqlite"))
    s = client.stream()                  # ordered lane
    s.submit(prompt_a); s.submit(prompt_b)
    client.submit(prompt_c)              # unordered
    tokens = client.run()                # {rid: [generated tokens]}

The client picks the executor from the plan: a fleet of continuous
engines behind the fabric router when ``plan.n_workers > 1`` (the
``fleet`` executor, in virtual time, with placement, prefill/decode
roles, fault injection and recovery, and scheduled live migrations), a
single ``ContinuousEngine`` otherwise, or the legacy ``wave`` executor
(a ``ServeEngine``, which cannot order streams).  Every engine of a
fleet runs on the client's device over one copy of the weights.

A ``Stream`` is an ordered lane: its requests start and finish in
submission order, while different streams and unordered submissions run
concurrently; in fleet mode a stream also carries its id as the fabric
session key, so session-affinity placement pins the lane to one channel
group.  ``connect(obs=...)`` records every run's spans and metrics;
``client.replan`` migrates the sharing vector live, and
``adaptive=True`` attaches a ``core.adapt.Replanner`` that does so from
each window's telemetry.  Fault injection, recovery and migrations
belong to the fleet and raise ``ValueError`` on a single-engine plan, as
in the reference.  ``Hints`` resolve through the planner
(``core.plan.resolve``), consulting a tuned-plan repository
(``tune.PlanRepository``) first when ``connect`` attaches one; the
adaptive controller jumps between that repository's frontier plans.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.core.adapt import Replanner, WindowStats
from repro_torch.core.plan import (EndpointPlan, Hints, SharingVector,
                                   as_plan)
from repro_torch.models.model import Model, resolve_device
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NOOP_OBS, PID_REQUESTS, Observability
from repro_torch.serve.engine import ContinuousEngine, Request, ServeEngine
from repro_torch.serve.fabric.faults import FaultPlan
from repro_torch.serve.fabric.placement import POLICIES
from repro_torch.serve.fabric.router import (Completion, EngineWorker,
                                             FabricCosts, FleetReport,
                                             Router)
from repro_torch.serve.fabric.traffic import Arrival
from repro_torch.serve.recovery import RecoveryPolicy

#: Plan fields a live ``replan`` may not change: they size caches,
#: captured shapes or the worker fleet itself, and moving them would mean
#: evicting in-flight requests.
STRUCTURAL_FIELDS = ("n_workers", "n_slots", "max_len", "decode_horizon",
                     "prefill_buckets", "use_ragged_kernel", "executor",
                     "page_size", "page_budget", "roles")

# fabric session keys for streams live above any plausible caller-supplied
# session id, so a stream's affinity key can never alias a user session
_STREAM_SESSION_BASE = 1 << 32


@dataclasses.dataclass
class _Pending:
    """One submitted request waiting for the next ``run()``."""

    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    eos_id: Optional[int]
    sid: Optional[int]                # stream id; None = unordered
    at_ns: float = 0.0                # virtual arrival time (fleet mode)
    session: int = -1                 # affinity key for unordered requests


class Stream:
    """An ordered lane of one ``ServeClient``: its requests complete in
    submission order.  Obtain one via ``client.stream()``."""

    def __init__(self, client: "ServeClient", sid: int,
                 name: Optional[str] = None):
        self.client = client
        self.sid = sid
        self.name = name or f"stream{sid}"
        self.rids: List[int] = []

    def submit(self, prompt, max_new_tokens: int = 16,
               eos_id: Optional[int] = None, at_ns: float = 0.0) -> int:
        return self.client.submit(prompt, max_new_tokens=max_new_tokens,
                                  eos_id=eos_id, stream=self, at_ns=at_ns)

    @property
    def outputs(self) -> List[Optional[List[int]]]:
        """This stream's generated tokens, in submission order."""
        return [self.client.results.get(r) for r in self.rids]

    def __repr__(self):
        return f"Stream({self.name!r}, sid={self.sid}, " \
               f"requests={len(self.rids)})"


class ServeClient:
    """A connected serving session over one resolved ``EndpointPlan``.
    Build via ``serve.connect``."""

    def __init__(self, cfg, params, plan: EndpointPlan, device=None,
                 obs: Optional[Observability] = None,
                 faults: Union[FaultPlan, str, None] = None,
                 recovery: Optional[RecoveryPolicy] = None,
                 plan_repository=None, migrations=None):
        if plan.placement not in POLICIES:
            raise ValueError(f"unknown placement {plan.placement!r}; "
                             f"one of {sorted(POLICIES)}")
        self.cfg = cfg
        self.plan = plan
        self.device = resolve_device(device)
        self.executor = plan.resolved_executor
        if (faults is not None or recovery is not None
                or migrations) and self.executor != "fleet":
            raise ValueError(
                "fault injection / crash recovery / live migration live "
                "on the fleet fabric (plan.n_workers > 1); this plan "
                f"resolved to the {self.executor!r} executor")
        #: tuned-plan store (DESIGN.md §16, duck-typed
        #: ``tune.PlanRepository``): consulted by hint re-resolution in
        #: ``replan`` and handed to the adaptive controller, whose
        #: transitions then jump to measured frontier plans
        self.plan_repository = plan_repository
        #: observability bundle (DESIGN.md §14): the no-op recorder and
        #: registry unless ``connect(..., obs=enabled_obs())``
        self.obs = obs if obs is not None else NOOP_OBS
        #: chaos fabric (DESIGN.md §15): a FaultPlan (or its string
        #: grammar) injected into every fleet run's router; ``recovery``
        #: tunes detection, backoff and shedding
        self.faults = faults
        self.recovery = recovery
        #: scheduled decode-to-decode live migrations (DESIGN.md §17):
        #: (t_ns, src_worker, dst_worker), drained on every fleet run
        self.migrations = list(migrations) if migrations else None
        self.results: Dict[int, List[int]] = {}
        #: exactly-once delivery cursor: tokens of ``results[rid]``
        #: already surfaced.  A completion replay appends only the tokens
        #: past the cursor: never double-delivered, never reordered.
        self._cursor: Dict[int, int] = {}
        #: replays that disagreed with tokens already delivered (first
        #: delivery wins; impossible under fail-stop, counted all the same)
        self.dedup_conflicts = 0
        self.report: Optional[FleetReport] = None   # last fleet report
        #: live migrations applied so far: (schedule key, vector): virtual
        #: ns in fleet mode, the engine's step count on the single engine,
        #: None for a manual ``replan``
        self.transitions: List = []
        self._pending: List[_Pending] = []
        self._requests: Dict[int, _Pending] = {}
        self._streams: List[Stream] = []
        self._next_rid = 0
        self._closed = False
        self.engine = None            # the single-executor engine
        self.workers: List[EngineWorker] = []
        if self.executor == "wave":
            self.engine = ServeEngine(cfg, params, plan, device=self.device)
        elif self.executor == "continuous":
            self.engine = ContinuousEngine(cfg, params, plan,
                                           device=self.device,
                                           exec_group=plan.exec_group_of(0))
        else:
            # one copy of the weights on the device for every worker; the
            # engines are built at the first run()
            self._weights = Model(cfg, self.device).prepare_params(params)

    # ----- submission -----------------------------------------------------
    def stream(self, name: Optional[str] = None) -> Stream:
        """A new ordered lane.  The wave engine cannot order (one static
        wave is the level-4 extreme), so streams need the continuous
        executor."""
        if self.executor == "wave":
            raise ValueError("ordered streams need the continuous or "
                             "fleet executor; the wave engine is one "
                             "unordered static wave")
        s = Stream(self, len(self._streams), name)
        self._streams.append(s)
        return s

    def submit(self, prompt, max_new_tokens: int = 16,
               eos_id: Optional[int] = None,
               stream: Union[Stream, int, None] = None,
               at_ns: float = 0.0, session: int = -1) -> int:
        """Queue one request; -> its rid.  ``stream`` orders it behind the
        stream's earlier requests; ``at_ns`` is its virtual arrival time
        in fleet mode (the single-engine executors are closed-loop and
        ignore it); ``session`` is a placement-affinity key for unordered
        requests (a stream carries its own)."""
        if self._closed:
            raise RuntimeError("client is closed")
        if isinstance(stream, Stream):
            if stream.client is not self:
                raise ValueError("stream belongs to a different client")
        elif stream is not None:
            stream = self._streams[stream]
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError("prompt must be a non-empty 1-D token array")
        if self.executor != "wave" and len(prompt) >= self.plan.max_len:
            # the wave engine instead cuts the decode budget at the cache
            # edge, a supported legacy mode
            raise ValueError(f"prompt of {len(prompt)} tokens cannot fit "
                             f"max_len={self.plan.max_len}")
        rid = self._next_rid
        self._next_rid += 1
        p = _Pending(rid=rid, prompt=prompt,
                     max_new_tokens=int(max_new_tokens), eos_id=eos_id,
                     sid=stream.sid if stream is not None else None,
                     at_ns=float(at_ns), session=int(session))
        self._pending.append(p)
        self._requests[rid] = p
        if stream is not None:
            stream.rids.append(rid)
        return rid

    def generate(self, prompts, max_new_tokens: int = 16) -> List[List[int]]:
        """Submit a batch of unordered prompts, run, and return their
        outputs in input order."""
        rids = [self.submit(p, max_new_tokens=max_new_tokens)
                for p in prompts]
        out = self.run()
        return [out[r] for r in rids]

    # ----- execution ------------------------------------------------------
    def run(self) -> Dict[int, List[int]]:
        """Serve everything queued since the last run; -> their
        ``{rid: [tokens]}`` (also merged into ``results``)."""
        if self._closed:
            raise RuntimeError("client is closed")
        batch, self._pending = self._pending, []
        if not batch:
            return {}
        if self.executor == "fleet":
            out = self._run_fleet(batch)
        elif self.executor == "wave":
            out = self._run_wave(batch)
        else:
            out = self._run_continuous(batch)
        missing = {p.rid for p in batch} - out.keys()
        if missing and self.report is not None:
            # shed and retry-exhausted requests are accounted losses (the
            # report names them); stream successors behind a dropped head
            # went back to the pending queue for the next run()
            missing -= ({rid for rid, _, _ in self.report.shed}
                        | set(self.report.failed)
                        | {p.rid for p in self._pending})
        if missing:
            raise RuntimeError(f"requests lost by the executor: {missing}")
        self.results.update(out)
        return out

    def _ingest(self, rid: int, tokens) -> List[int]:
        """Fold a completion's tokens into ``results[rid]`` through the
        exactly-once cursor: the overlap with what was delivered must
        agree (first delivery wins; a disagreement bumps
        ``dedup_conflicts`` and is dropped), and only the suffix past the
        cursor is appended.  Idempotent under replays."""
        tokens = [int(x) for x in tokens]
        got = self.results.setdefault(rid, [])
        cur = self._cursor.get(rid, len(got))
        overlap = min(cur, len(tokens))
        if tokens[:overlap] != got[:overlap]:
            self.dedup_conflicts += 1
            return got
        got.extend(tokens[cur:])
        self._cursor[rid] = len(got)
        return got

    # ----- fault-tolerance views (filled by fleet runs) --------------------
    @property
    def shed(self) -> List:
        """Requests refused before acceptance: (rid, reason, t_ns)."""
        return list(self.report.shed) if self.report is not None else []

    @property
    def failed(self) -> List[int]:
        """Requests that exhausted their retry budget."""
        return list(self.report.failed) if self.report is not None else []

    def _request(self, p: _Pending) -> Request:
        return Request(rid=p.rid, prompt=p.prompt,
                       max_new_tokens=p.max_new_tokens, eos_id=p.eos_id)

    def _split(self, batch):
        """-> (unordered pendings, {sid: deque of its pendings})."""
        unordered, streams = [], {}
        for p in batch:
            if p.sid is None:
                unordered.append(p)
            else:
                streams.setdefault(p.sid, deque()).append(p)
        return unordered, streams

    def _run_wave(self, batch) -> Dict[int, List[int]]:
        eng = self.engine
        for p in batch:
            eng.submit(self._request(p))
        rids = {p.rid for p in batch}
        eng.run()
        return {r.rid: list(r.output) for r in eng.done if r.rid in rids}

    def _run_continuous(self, batch) -> Dict[int, List[int]]:
        """Drive the engine's stepping hooks, releasing each stream's next
        request only once its predecessor retires: per-stream FIFO over
        the slot pool, cross-stream concurrency.  With ``plan.adaptive`` a
        ``Replanner`` samples the engine's own counters every window
        (windows sized in decode steps through the fabric cost model, so
        one knob paces both executors) and its proposals land through
        ``_apply_vector``, the path a manual ``replan`` takes.  The
        engine publishes its counters into the metrics registry (``obs``'
        or a private one) at the start, every window and the end of the
        run."""
        eng = self.engine
        unordered, streams = self._split(batch)
        inflight = {sid: None for sid in streams}
        for p in unordered:
            eng.submit(self._request(p))
        out: Dict[int, List[int]] = {}
        eng.start()
        eng._t0 = time.perf_counter()    # latency baseline per run()
        adapt = self._make_replanner() if self.plan.adaptive else None
        win_steps = max(1, int(self.plan.adapt_window_ns
                               // FabricCosts().t_step_base_ns))
        reg = (self.obs.metrics if self.obs.metrics.enabled
               else MetricsRegistry())
        eng.publish_metrics(reg, worker=0)
        win = reg.window()
        step_mark = eng.stats["decode_steps"]
        while True:
            for sid in sorted(streams):
                if inflight[sid] is None and streams[sid]:
                    p = streams[sid].popleft()
                    eng.submit(self._request(p))
                    inflight[sid] = p.rid
            if not eng.has_work:
                break
            eng.admit_waiting()
            for r in eng.step():
                out[r.rid] = list(r.output)
                sid = self._requests[r.rid].sid
                if sid is not None and inflight.get(sid) == r.rid:
                    inflight[sid] = None
            if adapt is not None and eng.stats["decode_steps"] \
                    - step_mark >= win_steps:
                step_mark = eng.stats["decode_steps"]
                eng.publish_metrics(reg, worker=0)
                d_slot = win.delta("engine.slot_steps", axis="slots",
                                   worker=0)
                d_busy = win.delta("engine.busy_slot_steps", axis="slots",
                                   worker=0)
                d_compiles = win.delta_total("engine.jit_compiles")
                win.roll()
                vec = adapt.observe(WindowStats(
                    occupancy=d_busy / d_slot if d_slot else 0.0,
                    queue_depth=float(len(eng.queue)),
                    jit_compiles=max(0, int(d_compiles)),
                    tokens=int(d_busy),
                    page_pressure=(eng.page_pool.pressure()
                                   if eng.paged else 0.0)))
                if vec is not None:
                    self._apply_vector(vec)
                    self.transitions.append((eng._step_no, vec))
        eng.publish_metrics(reg, worker=0)
        if self.obs.tracing:
            self._record_engine_spans(out)
        if adapt is not None and adapt.vector != self.plan.vector:
            self.plan = dataclasses.replace(self.plan, preset=None,
                                            vector=adapt.vector)
        return out

    def _record_engine_spans(self, out: Dict[int, List[int]]) -> None:
        """Request-lifecycle spans of one run, laid out after the fact on
        the engine's step counter times the fabric's decode-step cost:
        the virtual-ns axis fleet traces use (the wall clock never enters
        the trace)."""
        rec = self.obs.recorder
        base = FabricCosts().t_step_base_ns
        eng = self.engine
        for rid in sorted(out):
            a = eng.admit_steps.get(rid)
            r = eng.retire_steps.get(rid)
            if a is None or r is None:
                continue
            rec.begin(PID_REQUESTS, "request", rid, a * base,
                      args={"admit_step": a})
            rec.end(PID_REQUESTS, "request", rid, r * base,
                    args={"retire_step": r, "new_tokens": len(out[rid])})

    def _build_workers(self):
        plan = self.plan

        def request_fn(arrival: Arrival) -> Request:
            return self._request(self._requests[arrival.rid])

        self.workers = [
            EngineWorker(
                w,
                ContinuousEngine(self.cfg, self._weights, plan,
                                 device=self.device,
                                 exec_group=plan.exec_group_of(w)),
                request_fn=request_fn)
            for w in range(plan.n_workers)]

    def _run_fleet(self, batch) -> Dict[int, List[int]]:
        """One router pass over fresh channels (the engines persist, with
        their caches and graphs): unordered requests and stream heads
        enter at their arrival times; each completion of a stream request
        releases the stream's next through the router's ``on_complete``
        hook, per-stream FIFO mapped onto the channel groups."""
        if not self.workers:
            self._build_workers()
        unordered, waiting = self._split(batch)

        def arrival(p: _Pending, t_ns: float) -> Arrival:
            return Arrival(rid=p.rid, t_ns=t_ns,
                           prompt_len=len(p.prompt),
                           max_new_tokens=p.max_new_tokens,
                           session=(p.session if p.sid is None
                                    else _STREAM_SESSION_BASE + p.sid))

        trace = [arrival(p, p.at_ns) for p in unordered]
        for q in waiting.values():
            head = q.popleft()
            trace.append(arrival(head, head.at_ns))
        trace.sort(key=lambda a: (a.t_ns, a.rid))

        def on_complete(c: Completion):
            # stream tokens through the exactly-once cursor as they
            # complete (the final loop below replays idempotently)
            self._ingest(c.rid, c.output)
            sid = self._requests[c.rid].sid
            if sid is None or not waiting.get(sid):
                return ()
            nxt = waiting[sid].popleft()
            return [arrival(nxt, max(nxt.at_ns, c.t_done_ns))]

        adapt = self._make_replanner() if self.plan.adaptive else None
        router = Router(self.workers, self.plan,
                        placement=self.plan.placement,
                        on_complete=on_complete, adapt=adapt,
                        adapt_window_ns=self.plan.adapt_window_ns,
                        obs=self.obs, faults=self.faults,
                        recovery=self.recovery,
                        migrations=self.migrations)
        self.report = router.run(trace)
        if adapt is not None:
            self.transitions.extend(self.report.transitions)
            if router.vector != self.plan.vector:
                # the migrated vector persists: the next run's router
                # starts where this one ended
                self.plan = dataclasses.replace(self.plan, preset=None,
                                                vector=router.vector)
        # a shed or failed stream head never releases its successors:
        # they go back on the pending queue for a later run()
        for q in waiting.values():
            self._pending.extend(q)
        return {c.rid: list(self._ingest(c.rid, c.output))
                for c in self.report.completions}

    # ----- live re-planning -----------------------------------------------
    def _make_replanner(self) -> Replanner:
        """The controller for this client's plan.  If an
        ``adapt_budget`` forces the starting vector tighter than the plan
        asked for, the clamp lands on the live stack at once, so the
        controller and the engines never disagree."""
        plan = self.plan
        adapt = Replanner(plan.vector, n_workers=plan.n_workers,
                          n_slots=plan.n_slots, budget=plan.adapt_budget,
                          paged=plan.paged,
                          repository=self.plan_repository)
        if adapt.vector != plan.vector:
            self._apply_vector(adapt.vector)
            self.plan = dataclasses.replace(plan, preset=None,
                                            vector=adapt.vector)
        return adapt

    def _apply_vector(self, vec: SharingVector) -> None:
        """The client-side migration executor, where manual ``replan``
        and the adaptive controller both land.  The single engine
        re-keys its slot pool and page budgets in place and moves to the
        vector's exec group; a fleet re-keys every persistent worker the
        same way, and its channel axis re-keys when the next ``run()``
        builds its router from the updated plan (mid-run channel
        migration is ``Router.apply_vector``)."""
        if self.executor == "wave":
            raise ValueError("the wave executor cannot re-plan live; "
                             "adaptive plans need continuous or fleet")
        if self.executor == "continuous":
            self.engine.regroup(
                slot_level=vec.slots, exec_group=vec.exec_group_of(0, 1),
                page_level=(vec.pages if self.engine.paged else None))
        else:
            for w, worker in enumerate(self.workers):
                worker.regroup(
                    slot_level=vec.slots,
                    exec_group=vec.exec_group_of(w, self.plan.n_workers),
                    page_level=vec.pages)

    def replan(self, spec=None, **overrides) -> EndpointPlan:
        """Migrate this client to a new plan live, without dropping queued
        work or evicting in-flight state (DESIGN.md §12); -> the new plan.

        ``spec`` is an ``EndpointPlan``, ``Hints`` (re-resolved against
        this client's fleet shape and its plan repository), a
        ``SharingVector``, a preset name, or None with field overrides.
        Only the sharing vector and the placement may change: a spec that
        moves a structural field (``STRUCTURAL_FIELDS``) or flips the
        cache layout between contiguous and paged raises ``ValueError``.
        On a fleet the
        vector lands on every worker, and the next run's router keys its
        channels to it.  The tokens do not change."""
        if self._closed:
            raise RuntimeError("client is closed")
        plan = self.plan
        if isinstance(spec, EndpointPlan):
            new = as_plan(spec, **overrides)
        else:
            keep = {f: getattr(plan, f) for f in STRUCTURAL_FIELDS}
            keep.update(placement=plan.placement, adaptive=plan.adaptive,
                        adapt_window_ns=plan.adapt_window_ns,
                        adapt_budget=plan.adapt_budget)
            if isinstance(spec, Hints):
                # hints resolve their own placement and budget; the live
                # plan's values would override them
                if spec.session_ordering:
                    keep.pop("placement")
                if spec.footprint_budget is not None:
                    keep.pop("adapt_budget")
                keep.update(overrides)
                # the attached repository first, as connect does
                new = EndpointPlan.from_hints(
                    spec, repository=self.plan_repository, **keep)
            else:
                keep.update(overrides)
                new = as_plan(spec, **keep)
        for f in STRUCTURAL_FIELDS:
            if getattr(new, f) != getattr(plan, f):
                raise ValueError(
                    f"live replan cannot change {f} "
                    f"({getattr(plan, f)!r} -> {getattr(new, f)!r}); "
                    f"connect() a fresh client for structural changes")
        if new.placement not in POLICIES:
            raise ValueError(f"unknown placement {new.placement!r}; "
                             f"one of {sorted(POLICIES)}")
        if new.paged != plan.paged:
            # the pages level re-keys budgets live, but flipping the
            # physical layout resizes every cache leaf: structural
            raise ValueError(
                "live replan cannot switch the KV-cache layout "
                f"({'paged' if plan.paged else 'contiguous'} -> "
                f"{'paged' if new.paged else 'contiguous'}); "
                "connect() a fresh client with the paged plan instead")
        if new.vector != plan.vector:
            self._apply_vector(new.vector)
            self.transitions.append((None, new.vector))
        self.plan = new
        return new

    # ----- lifecycle ------------------------------------------------------

    def close(self):
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __repr__(self):
        v = self.plan.vector
        return (f"ServeClient(executor={self.executor!r}, "
                f"vector=(slots={v.slots}, channels={v.channels}, "
                f"execs={v.execs}, pages={v.pages}), "
                f"workers={self.plan.n_workers}, "
                f"slots={self.plan.n_slots}, device={self.device})")


def connect(cfg, plan: Union[EndpointPlan, Hints, SharingVector, str,
                             None] = None,
            *, params=None, seed: int = 0, device=None,
            obs: Optional[Observability] = None,
            faults: Union[FaultPlan, str, None] = None,
            recovery: Optional[RecoveryPolicy] = None,
            plan_repository=None, use_repository: bool = True,
            migrations=None, **overrides) -> ServeClient:
    """Connect a serving session: resolve ``plan`` (an ``EndpointPlan``,
    ``Hints``, ``SharingVector``, ``Category`` / preset name, or None;
    ``overrides`` set plan fields) and return a ``ServeClient``.

    ``device`` None means the card: RuntimeError when CUDA is absent.
    ``params`` is a tree of tensors in the reference's layout (see
    ``models.params.from_numpy``); None draws fresh weights with the
    port's own init from ``torch.Generator().manual_seed(seed)`` (torch's
    random stream, not the reference's).  ``obs`` (an
    ``obs.Observability``, e.g. ``obs.enabled_obs()``) records every
    run's spans and metrics.  ``faults`` (a ``FaultPlan`` or its
    ``"crash@4.5ms:w0,stall@2ms:w1:1ms"`` grammar) injects deterministic
    failures into every fleet run; ``recovery`` (a ``RecoveryPolicy``)
    tunes detection, retry backoff and overload shedding; ``migrations``
    schedules decode-to-decode live migrations, ``(t_ns, src_worker,
    dst_worker)`` triples drained at their virtual times.  All three
    need the fleet executor (``ValueError`` otherwise).
    ``roles="2P+2D"`` (a plan field or override) splits the fleet into
    prefill-only and decode-only workers, the KV handed off after each
    prefill; ``adaptive=True`` re-plans live from each window's
    telemetry.

    ``plan_repository`` (DESIGN.md §16) attaches a tuned-plan store
    (``tune.PlanRepository``): ``Hints`` resolution consults its stored
    Pareto-frontier plans before the analytic planner
    (``use_repository=False`` resolves analytically and keeps the store
    for the adaptive controller), and the adaptive controller jumps
    between its frontier plans instead of stepping one axis at a
    time."""
    device = resolve_device(device)
    if isinstance(plan, Hints) and plan_repository is not None:
        resolved = EndpointPlan.from_hints(
            plan, repository=plan_repository,
            use_repository=use_repository, **overrides)
    else:
        resolved = as_plan(plan, **overrides)
    if params is None:
        params = Model(cfg, device).init(
            torch.Generator().manual_seed(seed))
    return ServeClient(cfg, params, resolved, device=device, obs=obs,
                       faults=faults, recovery=recovery,
                       plan_repository=plan_repository,
                       migrations=migrations)
