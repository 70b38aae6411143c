"""`serve.connect`: the serving entry point of the port (DESIGN.md §11).

    client = serve.connect(cfg, "shared_dynamic")          # on the card
    client = serve.connect(cfg, SharingVector(pages=4), device="cpu")
    s = client.stream()                  # ordered lane
    s.submit(prompt_a); s.submit(prompt_b)
    client.submit(prompt_c)              # unordered
    tokens = client.run()                # {rid: [generated tokens]}

The client serves through one engine: the ``continuous`` executor (a
``ContinuousEngine``) or the legacy ``wave`` executor (a ``ServeEngine``,
which cannot order streams).  A ``Stream`` is an ordered lane: its
requests start and finish in submission order, while different streams
and unordered submissions run concurrently.  ``connect(obs=...)``
records every run's request spans and the engine's metrics;
``client.replan`` migrates the sharing vector live.  Fault injection,
recovery and migrations belong to the fleet and raise ``ValueError`` on
a single-engine plan, as in the reference.  The fleet executor, adaptive
re-planning, planner hints and the tuned-plan repository raise
``NotImplementedError``, each naming its slice.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.core.plan import EndpointPlan, SharingVector, as_plan
from repro_torch.models.model import Model, resolve_device
from repro_torch.obs.trace import NOOP_OBS, PID_REQUESTS, Observability
from repro_torch.serve.engine import ContinuousEngine, Request, ServeEngine
from repro_torch.serve.fabric.placement import POLICIES
from repro_torch.serve.fabric.router import FabricCosts

#: Plan fields a live ``replan`` may not change: they size caches,
#: captured shapes or the worker fleet itself, and moving them would mean
#: evicting in-flight requests.
STRUCTURAL_FIELDS = ("n_workers", "n_slots", "max_len", "decode_horizon",
                     "prefill_buckets", "use_ragged_kernel", "executor",
                     "page_size", "page_budget", "roles")


@dataclasses.dataclass
class _Pending:
    """One submitted request waiting for the next ``run()``."""

    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    eos_id: Optional[int]
    sid: Optional[int]                # stream id; None = unordered


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
               eos_id: Optional[int] = None) -> int:
        return self.client.submit(prompt, max_new_tokens=max_new_tokens,
                                  eos_id=eos_id, stream=self)

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
                 obs: Optional[Observability] = None, faults=None,
                 recovery=None, migrations=None):
        if plan.placement not in POLICIES:
            raise ValueError(f"unknown placement {plan.placement!r}; "
                             f"one of {sorted(POLICIES)}")
        self.cfg = cfg
        self.plan = plan
        self.executor = plan.resolved_executor
        if self.executor == "fleet":
            raise NotImplementedError(
                "the fleet executor (n_workers > 1, prefill/decode roles, "
                "faults, recovery, migrations) arrives with the fleet "
                "slice")
        if faults is not None or recovery is not None or migrations:
            raise ValueError(
                "fault injection / crash recovery / live migration live "
                "on the fleet fabric (plan.n_workers > 1); this plan "
                f"resolved to the {self.executor!r} executor")
        if plan.adaptive:
            raise NotImplementedError(
                "adaptive re-planning arrives with the adaptive slice")
        #: observability bundle (DESIGN.md §14): the no-op recorder and
        #: registry unless ``connect(..., obs=enabled_obs())``
        self.obs = obs if obs is not None else NOOP_OBS
        #: live migrations applied so far: (None, vector) per manual
        #: ``replan``
        self.transitions: List = []
        self.results: Dict[int, List[int]] = {}
        self._pending: List[_Pending] = []
        self._requests: Dict[int, _Pending] = {}
        self._streams: List[Stream] = []
        self._next_rid = 0
        self._closed = False
        if self.executor == "wave":
            self.engine = ServeEngine(cfg, params, plan, device=device)
        else:
            self.engine = ContinuousEngine(cfg, params, plan, device=device,
                                           exec_group=plan.exec_group_of(0))

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
               stream: Union[Stream, int, None] = None) -> int:
        """Queue one request; -> its rid.  ``stream`` orders it behind the
        stream's earlier requests."""
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
                     sid=stream.sid if stream is not None else None)
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
        if self.executor == "wave":
            out = self._run_wave(batch)
        else:
            out = self._run_continuous(batch)
        missing = {p.rid for p in batch} - out.keys()
        if missing:
            raise RuntimeError(f"requests lost by the executor: {missing}")
        self.results.update(out)
        return out

    def _request(self, p: _Pending) -> Request:
        return Request(rid=p.rid, prompt=p.prompt,
                       max_new_tokens=p.max_new_tokens, eos_id=p.eos_id)

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
        the slot pool, cross-stream concurrency.  With ``obs`` the engine
        publishes its counters at the start and the end of the run, and
        the run's request spans are recorded."""
        eng = self.engine
        streams: Dict[int, deque] = {}
        for p in batch:
            if p.sid is None:
                eng.submit(self._request(p))
            else:
                streams.setdefault(p.sid, deque()).append(p)
        inflight = {sid: None for sid in streams}
        out: Dict[int, List[int]] = {}
        eng.start()
        eng._t0 = time.perf_counter()    # latency baseline per run()
        metrics = self.obs.metrics
        if metrics.enabled:
            eng.publish_metrics(metrics, worker=0)
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
        if metrics.enabled:
            eng.publish_metrics(metrics, worker=0)
        if self.obs.tracing:
            self._record_engine_spans(out)
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

    # ----- live re-planning -----------------------------------------------
    def _apply_vector(self, vec: SharingVector) -> None:
        """Re-key the live engine to ``vec``: the slot pool and page
        budgets in place, the exec group id recorded (the engine keeps
        its horizon graphs, ``ContinuousEngine.regroup``)."""
        if self.executor == "wave":
            raise ValueError("the wave executor cannot re-plan live; "
                             "adaptive plans need continuous or fleet")
        self.engine.regroup(
            slot_level=vec.slots, exec_group=vec.exec_group_of(0, 1),
            page_level=(vec.pages if self.engine.paged else None))

    def replan(self, spec=None, **overrides) -> EndpointPlan:
        """Migrate this client to a new plan live, without dropping queued
        work or evicting in-flight state (DESIGN.md §12); -> the new plan.

        ``spec`` is an ``EndpointPlan``, a ``SharingVector``, a preset
        name, or None with field overrides.  Only the sharing vector and
        the placement may change: a spec that moves a structural field
        (``STRUCTURAL_FIELDS``) or flips the cache layout between
        contiguous and paged raises ``ValueError``.  ``Hints`` raise
        ``NotImplementedError`` until the planner slice, an adaptive plan
        until the adaptive slice.  The tokens do not change."""
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
        if new.adaptive:
            raise NotImplementedError(
                "adaptive re-planning arrives with the adaptive slice")
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
                f"slots={self.plan.n_slots}, "
                f"device={self.engine.device})")


def connect(cfg, plan: Union[EndpointPlan, SharingVector, str, None] = None,
            *, params=None, seed: int = 0, device=None,
            obs: Optional[Observability] = None, faults=None, recovery=None,
            plan_repository=None, migrations=None,
            **overrides) -> ServeClient:
    """Connect a serving session: resolve ``plan`` (an ``EndpointPlan``,
    ``SharingVector``, ``Category`` / preset name, or None; ``overrides``
    set plan fields) and return a ``ServeClient``.

    ``device`` None means the card: RuntimeError when CUDA is absent.
    ``params`` is a tree of tensors in the reference's layout (see
    ``models.params.from_numpy``); None draws fresh weights with the
    port's own init from ``torch.Generator().manual_seed(seed)`` (torch's
    random stream, not the reference's).  ``obs`` (an
    ``obs.Observability``, e.g. ``obs.enabled_obs()``) records every
    run's spans and metrics.  ``faults``, ``recovery`` and
    ``migrations`` need the fleet: ``ValueError`` on a single-engine
    plan, ``NotImplementedError`` on a fleet plan until the fleet slice.
    ``plan_repository`` raises ``NotImplementedError`` until the planner
    slice brings ``tune/``."""
    if plan_repository is not None:
        raise NotImplementedError(
            "connect(plan_repository=...) is not ported yet: the tuned-"
            "plan repository comes with the planner slice")
    device = resolve_device(device)
    resolved = as_plan(plan, **overrides)
    if params is None:
        params = Model(cfg, device).init(
            torch.Generator().manual_seed(seed))
    return ServeClient(cfg, params, resolved, device=device, obs=obs,
                       faults=faults, recovery=recovery,
                       migrations=migrations)
