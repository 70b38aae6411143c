"""`serve.connect`: the serving entry point of the port (DESIGN.md §11).

    client = serve.connect(cfg, "shared_dynamic")          # on the card
    client = serve.connect(cfg, SharingVector(pages=4), device="cpu")
    s = client.stream()                  # ordered lane
    s.submit(prompt_a); s.submit(prompt_b)
    client.submit(prompt_c)              # unordered
    tokens = client.run()                # {rid: [generated tokens]}

This slice serves through the single ``continuous`` executor.  A
``Stream`` is an ordered lane: its requests start and finish in
submission order, while different streams and unordered submissions run
concurrently.  The fleet, wave and adaptive executors, observability,
fault injection, live migration and prefill/decode roles raise
``NotImplementedError`` until their slice lands.
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
from repro_torch.serve.engine import ContinuousEngine, Request


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

    def __init__(self, cfg, params, plan: EndpointPlan, device=None):
        self.cfg = cfg
        self.plan = plan
        self.executor = plan.resolved_executor
        if self.executor != "continuous":
            raise NotImplementedError(
                f"the {self.executor!r} executor is not ported yet; this "
                f"slice serves through the single continuous engine")
        if plan.adaptive:
            raise NotImplementedError(
                "adaptive re-planning arrives with the adaptive slice")
        if plan.roles is not None:
            raise NotImplementedError(
                "prefill/decode roles arrive with the fleet slice")
        self.results: Dict[int, List[int]] = {}
        self._pending: List[_Pending] = []
        self._requests: Dict[int, _Pending] = {}
        self._streams: List[Stream] = []
        self._next_rid = 0
        self._closed = False
        self.engine = ContinuousEngine(cfg, params, plan, device=device)

    # ----- submission -----------------------------------------------------
    def stream(self, name: Optional[str] = None) -> Stream:
        """A new ordered lane."""
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
        if len(prompt) >= self.plan.max_len:
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
        out = self._run_continuous(batch)
        missing = {p.rid for p in batch} - out.keys()
        if missing:
            raise RuntimeError(f"requests lost by the executor: {missing}")
        self.results.update(out)
        return out

    def _request(self, p: _Pending) -> Request:
        return Request(rid=p.rid, prompt=p.prompt,
                       max_new_tokens=p.max_new_tokens, eos_id=p.eos_id)

    def _run_continuous(self, batch) -> Dict[int, List[int]]:
        """Drive the engine's stepping hooks, releasing each stream's next
        request only once its predecessor retires: per-stream FIFO over
        the slot pool, cross-stream concurrency."""
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
        return out

    # ----- lifecycle ------------------------------------------------------
    def replan(self, spec=None, **overrides):
        raise NotImplementedError(
            "live re-planning arrives with the adaptive slice")

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
            *, params=None, seed: int = 0, device=None, obs=None,
            faults=None, recovery=None, plan_repository=None,
            migrations=None, **overrides) -> ServeClient:
    """Connect a serving session: resolve ``plan`` (an ``EndpointPlan``,
    ``SharingVector``, ``Category`` / preset name, or None; ``overrides``
    set plan fields) and return a ``ServeClient``.

    ``device`` None means the card: RuntimeError when CUDA is absent.
    ``params`` is a tree of tensors in the reference's layout (see
    ``models.params.from_numpy``); None draws fresh weights with the
    port's own init from ``torch.Generator().manual_seed(seed)`` (torch's
    random stream, not the reference's).  ``obs``, ``faults``,
    ``recovery``, ``plan_repository`` and ``migrations`` belong to slices
    not ported yet and raise NotImplementedError."""
    for name, val in (("obs", obs), ("faults", faults),
                      ("recovery", recovery),
                      ("plan_repository", plan_repository),
                      ("migrations", migrations)):
        if val is not None:
            raise NotImplementedError(
                f"connect({name}=...) is not ported yet: it needs the "
                f"fleet / observability slice")
    device = resolve_device(device)
    resolved = as_plan(plan, **overrides)
    if params is None:
        params = Model(cfg, device).init(
            torch.Generator().manual_seed(seed))
    return ServeClient(cfg, params, resolved, device=device)
