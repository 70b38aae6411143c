"""Serving engines in PyTorch: static wave batching and continuous
batching over an endpoint-style slot pool.

``ServeEngine`` is the port of the reference's wave scheduler (DESIGN.md
§6.1): requests group into waves of equal prompt length, each wave
prefills batched into a fresh cache with one shared position and decodes
until every member finishes, one host argmax a step; nothing is admitted
mid-wave.

``ContinuousEngine`` is the port of ``repro.serve.engine.ContinuousEngine``
(DESIGN.md §6.2):
one persistent ``n_slots``-row KV cache holds every active request at its
own ragged length, a finished request frees its slot at once, and a
``SlotPool`` keyed by the plan's ``slots`` sharing level decides when a
queued request may take it.  The two host-batching layers are kept:

* **Fused decode horizon** (``decode_horizon=K``): K greedy decode steps
  run on the device per host sync (``Model.decode_horizon``) and the
  whole token trace drains in one transfer.  ``K=1`` is the per-step host
  loop, the oracle.
* **Bucketed batched prefill** (``prefill_buckets``): a round's
  admissions pad to a shared power-of-2 length and prefill as one batched
  call, then land in their slots with one scatter.  Models whose state
  padding would corrupt (RG-LRU blocks, rolling-window caches) admit each
  prompt alone at its exact length, and keep the contiguous cache even
  under a paged plan, as the reference does.

The reference's jitted executables (``SharedSteps``) have one
counterpart here, the horizon's: ``HorizonGraphs`` captures the fused
horizon as one ``torch.cuda.CUDAGraph`` per ``n_steps`` at first use, on
the engine's static buffers, and replays it as one launch per horizon;
``graph_count()`` counts those graphs.  A graph binds the addresses of
one engine's buffers, so what the engines of an exec group share is the
memory the captures draw on: one ``ExecGroup`` per (config, ragged
kernel, group id, device), the counterpart of ``SharedSteps``' key, owns
one graph memory pool that every engine of the group captures into.
Admission (prefill and scatter, the reference's jitted ``admit_packed``)
and the K=1 loop stay eager.  Cache scatters write in place, indexed by
the slot assignment the host already knows.

The execs axis' signal is the reference's: wherever the reference calls
one of its seven jitted executables, the engine records the key jit
caches that call under (the shapes and dtypes of the array arguments and
the static arguments, ``signature``) in its ``ExecGroup``, and
``compile_count()`` is the number of distinct keys, on the CPU as on the
card.

The engine's other entry points keep those addresses too: a KV handoff
(``prefill_only`` on one engine, a ``Request`` carrying the ``KVHandoff``
on another, DESIGN.md §17) lands through the same in-place scatters;
``export_session`` copies a live slot out into a batch-1 contiguous cache
and drains it in place, as ``evacuate`` drains every slot; ``regroup``
re-keys the slot and page pools and moves the engine's future captures
to another exec group's pool.  Where the reference rebuilt the
decode-state dict or the page table, the port writes the engine's
tensors in place, so a graph captured before any of them reads the
right values after.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.plan import Buckets, EndpointPlan
from repro_torch.kernels.flash_attention import ops as attention_ops
from repro_torch.kernels.rglru import ops as rglru_ops
from repro_torch.models.model import Model
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.serve.pages import PagePool, sentinel
from repro_torch.serve.slots import SlotPool


@dataclasses.dataclass
class KVHandoff:
    """One session's portable KV state (DESIGN.md §17): everything a
    decode engine needs to resume a stream another engine started.  The
    batch-1 contiguous cache (the layout of ``Model.init_cache(1,
    max_len)``, scalar ``idx``), the next token to feed (decided, not yet
    decoded), the resident cache position, the remaining budget and the
    tokens already emitted.  ``kv_tokens`` / ``kv_bytes`` price the
    transfer (the resident share of the cache's bytes).  Greedy decoding
    is a function of the context, so resuming from this state elsewhere
    gives the tokens the session would have had without moving."""

    rid: int
    cache: object                      # batch-1 contiguous cache | None
    next_tok: int
    pos: int
    remaining: int
    emitted: List[int] = dataclasses.field(default_factory=list)
    eos_id: int = -1
    kv_tokens: int = 0
    kv_bytes: int = 0


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (len,) int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    output: Optional[list] = None      # filled by the engine
    kv: Optional[KVHandoff] = None     # imported cache: admission merges
    #                                    it instead of running a prefill


def _cache_bytes(cache, tokens: int, max_len: int) -> int:
    """Bytes of the batch-1 ``cache`` that ``tokens`` of its ``max_len``
    positions fill: the size-proportional payload a handoff moves."""
    total = sum(leaf.numel() * leaf.element_size()
                for group in ("prefix", "body")
                for leaf in tree_leaves(cache["stack"][group]))
    return int(total * tokens / max(1, max_len))


def _leaf_pairs(full_stack, part_stack):
    """(dst, src, batch axis) for every cache leaf: prefix leaves carry
    the batch (or page) axis first, stacked body leaves second."""
    for group, axis in (("prefix", 0), ("body", 1)):
        for dst, src in zip(tree_leaves(full_stack[group]),
                            tree_leaves(part_stack[group])):
            yield dst, src, axis


def _scatter_slots(full, many, slots: Sequence[int],
                   lengths: Sequence[int]):
    """Row ``i`` of the batched prefill cache ``many`` lands in slot
    ``slots[i]`` of ``full``, in place (the reference rebuilt every leaf
    with ``jnp.where``), and that slot's position pins to
    ``lengths[i]``.  Every leaf lands whole along its batch axis: KV rows,
    rolling windows and recurrent state alike."""
    dev = full["idx"].device
    n = len(slots)
    s_idx = torch.as_tensor(slots, dtype=torch.long, device=dev)
    for dst, src, axis in _leaf_pairs(full["stack"], many["stack"]):
        if axis == 0:
            dst[s_idx] = src[:n]
        else:
            dst[:, s_idx] = src[:, :n]
    full["idx"][s_idx] = torch.as_tensor(lengths, dtype=torch.int32,
                                         device=dev)


def _scatter_slots_paged(full, many, slots: Sequence[int],
                         lengths: Sequence[int], pt: np.ndarray,
                         n_pages: int):
    """Paged variant of ``_scatter_slots``: row ``i`` of the contiguous
    prefill cache splits into pages and lands, in place, in the physical
    pages slot ``slots[i]`` maps in the host page table ``pt`` (pool of
    ``n_pages``).  The reference dropped sentinel entries with
    ``mode="drop"``; here the host leaves them out of the index lists.
    The admitted slots' table rows install in the device table."""
    dev = full["idx"].device
    max_pages = pt.shape[1]
    src_row, src_page, dst_page = [], [], []
    for row, slot in enumerate(slots):
        for j, page in enumerate(pt[slot]):
            if page < n_pages:
                src_row.append(row)
                src_page.append(j)
                dst_page.append(int(page))
    sr = torch.as_tensor(src_row, dtype=torch.long, device=dev)
    sp = torch.as_tensor(src_page, dtype=torch.long, device=dev)
    dp = torch.as_tensor(dst_page, dtype=torch.long, device=dev)
    for dst, src, axis in _leaf_pairs(full["stack"], many["stack"]):
        ps = dst.shape[axis + 1]
        shape = list(src.shape)
        shape[axis + 1:axis + 2] = [max_pages, ps]
        pages = src.reshape(shape)
        if axis == 0:
            dst[dp] = pages[sr, sp]
        else:
            dst[:, dp] = pages[:, sr, sp]
    s_idx = torch.as_tensor(slots, dtype=torch.long, device=dev)
    full["idx"][s_idx] = torch.as_tensor(lengths, dtype=torch.int32,
                                         device=dev)
    full["pt"][s_idx] = torch.as_tensor(pt[list(slots)], device=dev)


def auto_page_size(max_len: int, target: int = 0) -> int:
    """The largest divisor of ``max_len`` not exceeding ``target`` (auto
    target = ``max_len // 4`` clamped to [8, 64])."""
    if target <= 0:
        target = max(8, min(64, max_len // 4))
    for ps in range(min(target, max_len), 0, -1):
        if max_len % ps == 0:
            return ps
    return max_len


def pow2_buckets(max_len: int, lo: int = 8) -> Tuple[int, ...]:
    """Power-of-2 prompt-length buckets covering [1, max_len)."""
    out, b = [], lo
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return tuple(out)


#: the leaves of a horizon's token trace, each (K, B), as
#: ``Model.decode_horizon`` returns them
_TRACE = (("tok", torch.int32), ("live", torch.bool),
          ("bonus_tok", torch.int32), ("bonus", torch.bool),
          ("retired", torch.bool))
#: the kernel wrappers' launch counters: plain dicts counted in Python,
#: which a graph's replay does not touch
_LAUNCH_COUNTERS = (attention_ops.LAUNCHES, rglru_ops.LAUNCHES)
#: one capture stream per device, shared by every engine's graphs:
#: PyTorch keeps a cuBLAS workspace (32 MiB on an H100) for each stream
#: that ran a matmul until the process ends, so a stream per engine
#: would keep one per engine
_CAPTURE_STREAMS: Dict[int, torch.cuda.Stream] = {}


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    if index not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[index] = torch.cuda.Stream(index)
    return _CAPTURE_STREAMS[index]


def _launch_counts() -> List[Dict[str, int]]:
    return [dict(counter) for counter in _LAUNCH_COUNTERS]


def _set_launch_counts(counts: List[Dict[str, int]]) -> None:
    for counter, saved in zip(_LAUNCH_COUNTERS, counts):
        counter.update(saved)


#: the reference's jitted executables, ``SharedSteps``' fields: the
#: entries an exec group counts specializations of
ENTRIES = ("decode", "prefill", "merge", "admit_packed", "merge_paged",
           "admit_packed_paged", "horizon")
#: the entries the reference jits from module-level functions: jax keeps
#: one cache per function, so every exec group of the process shares
#: their specializations
PROCESS_WIDE = ("merge", "merge_paged")


def signature(tree):
    """The key jit caches an argument under: the tree's structure (dict
    keys, sequence kinds) with each array leaf's shape and dtype; any
    other leaf is a static argument and keys as itself."""
    if torch.is_tensor(tree) or isinstance(tree, np.ndarray):
        return tuple(tree.shape), str(tree.dtype).removeprefix("torch.")
    if isinstance(tree, dict):
        return tuple((k, signature(v)) for k, v in sorted(tree.items()))
    if isinstance(tree, (list, tuple)):
        return type(tree).__name__, tuple(signature(v) for v in tree)
    return tree


class ExecGroup:
    """The engines of one exec group (the ``execs`` axis of a
    ``SharingVector``): the port's counterpart of the reference's
    ``SharedSteps``, keyed as the reference keys it, by (config,
    ``use_ragged_kernel``, group id) and here the device.

    A horizon graph binds one engine's buffers, so the group cannot
    share the graphs themselves.  It shares the memory they run in: one
    CUDA graph memory pool (``torch.cuda.graph_pool_handle()``, made at
    the group's first capture) that every engine of the group captures
    its horizon graphs into, so at exec level 4 a fleet holds one pool of
    capture intermediates where level 1 holds one per engine.
    ``captures`` counts the graphs the group's engines captured.

    The group also keeps the counterpart of the reference's jit caches:
    ``specializations``, the ``(entry, key)`` pairs its engines ran (one
    per distinct key, as jit compiles once per key), ``merge`` and
    ``merge_paged`` in a set per device that every group shares, as
    jax's cache of a module-level function is.  ``compile_count()`` is
    the group's count; the fleet's compile telemetry counts each group
    once.

    Sharing the pool is safe under one invariant, which the serving
    stack keeps: the group's graphs replay one at a time, on one stream,
    and never overlap.  Every engine replays on the current stream, and
    every external ``step()`` ends in a host sync (the trace drain)
    before the fleet steps another engine.  A replay's outputs never
    live in the pool: ``HorizonGraphs.body`` copies the cache's ``idx``,
    the state and the trace into buffers allocated outside any capture,
    so only a capture's intermediates, dead once its replay ends, share
    the pool's memory.  A pool lives as long as the graphs captured into
    it, so an engine that moves to another group keeps its graphs
    valid."""

    def __init__(self, key: tuple):
        self.key = key
        self.captures = 0
        self.specializations: set = set()
        self._pool = None

    def _process_wide(self) -> set:
        return _PROCESS_SPECIALIZATIONS.setdefault(self.key[3], set())

    def _keys(self, entry: str) -> set:
        return self._process_wide() if entry in PROCESS_WIDE \
            else self.specializations

    def record(self, entry: str, *key) -> None:
        """One call of the reference's ``entry`` under jit key ``key``."""
        self._keys(entry).add((entry, key))

    def count(self, entry: str) -> int:
        """Specializations of one entry so far (its jit cache's size)."""
        return sum(e == entry for e, _ in self._keys(entry))

    def compile_count(self) -> int:
        """Specializations of the group's seven entries so far."""
        return len(self.specializations) + len(self._process_wide())

    def pool(self):
        """The group's graph memory pool (made at the first capture)."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool


#: every exec group of the process, by (config, use_ragged_kernel,
#: group id, device), as the reference caches ``_shared_steps``
_EXEC_GROUPS: Dict[tuple, ExecGroup] = {}
#: the process-wide entries' specializations, by device
_PROCESS_SPECIALIZATIONS: Dict[str, set] = {}


def clear_exec_groups() -> None:
    """Forget every exec group and every specialization (the
    counterpart of clearing jax's caches): engines made after this start
    counting from 0.  Engines that exist keep their groups."""
    _EXEC_GROUPS.clear()
    _PROCESS_SPECIALIZATIONS.clear()


def shared_exec_group(cfg: ArchConfig, use_ragged_kernel: bool,
                      group: int, device: torch.device) -> ExecGroup:
    """The process's ``ExecGroup`` for this key, made at first use."""
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (cfg, bool(use_ragged_kernel), int(group), str(device))
    if key not in _EXEC_GROUPS:
        _EXEC_GROUPS[key] = ExecGroup(key)
    return _EXEC_GROUPS[key]


class HorizonGraphs:
    """The fused decode horizon as executables: the port's counterpart of
    the reference's jitted ``SharedSteps.horizon``.

    ``body(n_steps)`` runs ``Model.decode_horizon`` eagerly on static
    buffers: it reads the engine's persistent cache and device state, and
    copies what the model hands back as new tensors (the cache's ``idx``,
    the state, the trace) into those same tensors and into one static
    (K, B) trace per leaf.  The engine's host-side writers (the admission
    scatters, ``_land``, ``_retire``) write the same tensors in place, so
    every address the body reads stays fixed for the engine's life.

    On a CUDA device a call captures the body once per ``n_steps`` (the
    engine's cut of the horizon, 1..K, so at most K graphs) at first use,
    as jit compiles at first use, and replays it: one launch for the whole
    horizon.  The body is warmed up once (kernel builds, library handles)
    on the device's capture stream, which every engine shares, at
    construction, when every slot is drained, so it writes nothing.
    Warm-up and capture leave the kernel launch counters as they were;
    each replay adds the launches its graph holds.  A failed warm-up or
    capture raises.  Each graph is captured into the memory pool of the
    engine's ``group`` at the time of the capture (an ``ExecGroup``,
    whose invariant the caller keeps), and counted there.  On the CPU
    nothing is captured and a call runs the body."""

    def __init__(self, model: Model, params, cache, state, *, horizon: int,
                 max_len: int, use_ragged_kernel: bool, group: ExecGroup):
        self.model = model
        self.params = params
        self.cache = cache
        self.state = state
        self.horizon = horizon
        self.max_len = max_len
        self.use_ragged_kernel = use_ragged_kernel
        self.group = group
        b, dev = state["tok"].shape[0], state["tok"].device
        self.trace = {name: torch.zeros((horizon, b), dtype=dt, device=dev)
                      for name, dt in _TRACE}
        #: n_steps -> (graph, the launch counts one replay adds)
        self.graphs: Dict[int, Tuple[torch.cuda.CUDAGraph,
                                     List[Dict[str, int]]]] = {}
        self._stream = None
        if dev.type == "cuda":
            self._stream = _capture_stream(dev)
            counts = _launch_counts()
            self._stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(self._stream):
                self.body(1)
            torch.cuda.current_stream(dev).wait_stream(self._stream)
            _set_launch_counts(counts)

    def body(self, n_steps: int):
        """One horizon of ``n_steps`` steps, eagerly, on the static
        buffers; -> the static trace."""
        cache, state, trace = self.model.decode_horizon(
            self.params, self.cache, self.state, horizon=self.horizon,
            max_len=self.max_len, use_ragged_kernel=self.use_ragged_kernel,
            n_steps=n_steps)
        self.cache["idx"].copy_(cache["idx"])
        for name, buf in self.state.items():
            buf.copy_(state[name])
        for name, buf in self.trace.items():
            buf.copy_(trace[name])
        return self.trace

    def _capture(self, n_steps: int):
        counts = _launch_counts()
        graph = torch.cuda.CUDAGraph()
        # no garbage collection during the capture: one could free another
        # engine's graphs (held by a dead reference cycle), and releasing
        # them while this stream captures invalidates the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.group.pool(),
                                  stream=self._stream):
                self.body(n_steps)
        finally:
            if collecting:
                gc.enable()
        self.group.captures += 1
        held = [{name: n - before[name] for name, n in after.items()}
                for after, before in zip(_launch_counts(), counts)]
        _set_launch_counts(counts)
        return graph, held

    def __call__(self, n_steps: int):
        """One horizon of ``n_steps`` steps: its graph's replay on the
        card (captured first if new), the body on the CPU; -> the static
        trace."""
        if self._stream is None:
            return self.body(n_steps)
        if n_steps not in self.graphs:
            self.graphs[n_steps] = self._capture(n_steps)
        graph, held = self.graphs[n_steps]
        graph.replay()
        for counter, add in zip(_LAUNCH_COUNTERS, held):
            for name, n in add.items():
                counter[name] += n
        return self.trace


class ServeEngine:
    """Static wave batching, the MPI+threads extreme of the slot pools:
    the port of the reference's ``ServeEngine`` (see the module
    docstring).

    A wave is up to ``n_slots`` queued requests of one prompt length, the
    largest such group first.  It prefills as one batch into a fresh
    cache with a scalar ``idx`` (every row at the same position), then
    decodes ``min(max_len - plen - 1, largest budget)`` steps at most,
    one host argmax a step; a finished row keeps decoding into a masked
    void, and a row still alive when the budget runs out gets its
    lookahead token.  On the card the prefill runs the flash kernel and
    each step the ragged decode kernel (``cur`` expanded per row); a
    rolling layer keeps plain decode attention.  No graph: the reference
    jits this step per shape but fuses no horizon here."""

    def __init__(self, cfg: ArchConfig, params, plan: EndpointPlan,
                 device=None):
        if cfg.input_mode != "tokens" or cfg.is_encdec:
            raise ValueError("the wave engine serves decoder-only token "
                             "models")
        self.cfg = cfg
        self.model = Model(cfg, device)
        self.device = self.model.device
        self.params = self.model.prepare_params(params)
        self.plan = plan
        self.n_slots = plan.n_slots
        self.max_len = plan.max_len
        # the reference's wave engine runs exec group 0's jitted prefill
        # and decode, without the ragged kernel
        self.group = shared_exec_group(cfg, False, 0, self.device)
        self._params_sig = signature(self.params)
        self.queue: deque = deque()
        self.done: List[Request] = []
        self.latency: Dict[int, float] = {}      # rid -> s from run() start
        self._t0 = 0.0

    def submit(self, req: Request):
        req.output = []
        self.queue.append(req)

    def _next_wave(self) -> List[Request]:
        """Up to n_slots queued requests sharing one prompt length."""
        if not self.queue:
            return []
        by_len: Dict[int, List[Request]] = {}
        for r in self.queue:
            by_len.setdefault(len(r.prompt), []).append(r)
        # largest group first (throughput)
        length = max(by_len, key=lambda n: len(by_len[n]))
        wave = by_len[length][: self.n_slots]
        taken = {id(r) for r in wave}
        self.queue = deque(r for r in self.queue if id(r) not in taken)
        return wave

    def _argmax(self, logits) -> np.ndarray:
        return logits.argmax(-1).to(torch.int32).cpu().numpy()  # one sync

    def _run_wave(self, wave: List[Request]):
        b = len(wave)
        plen = len(wave[0].prompt)
        prompts = torch.as_tensor(
            np.stack([np.asarray(r.prompt, np.int32) for r in wave]),
            device=self.device)
        cache = self.model.init_cache(b, self.max_len)
        self.group.record("prefill", self._params_sig, signature(prompts),
                          signature(cache))
        logits, cache = self.model.prefill(self.params, {"tokens": prompts},
                                           cache)
        next_tok = self._argmax(logits)
        remaining = np.array([r.max_new_tokens for r in wave], np.int64)
        alive = np.ones(b, bool)
        budget = min(self.max_len - plen - 1, int(max(remaining)))
        if budget > 0:                  # every row is alive at step 1
            self.group.record("decode", self._params_sig, signature(cache),
                              (b,))
        for _ in range(max(0, budget)):
            if not alive.any():
                break
            logits, cache = self.model.decode_step(
                self.params, cache, torch.as_tensor(next_tok,
                                                    device=self.device))
            produced = next_tok
            next_tok = self._argmax(logits)
            for i, r in enumerate(wave):
                if not alive[i]:
                    continue
                r.output.append(int(produced[i]))
                remaining[i] -= 1
                if remaining[i] <= 0 or (r.eos_id is not None
                                         and int(next_tok[i]) == r.eos_id):
                    alive[i] = False
        for i, r in enumerate(wave):
            if alive[i]:          # wave budget exhausted
                r.output.append(int(next_tok[i]))
        now = time.perf_counter() - self._t0
        for r in wave:
            self.latency[r.rid] = now
        self.done.extend(wave)

    def run(self) -> List[Request]:
        self._t0 = time.perf_counter()
        while self.queue:
            self._run_wave(self._next_wave())
        return self.done


class ContinuousEngine:
    """Continuous batching over an endpoint-style slot pool (see the
    module docstring), configured wholly by its ``EndpointPlan``: slots,
    max_len, horizon, buckets, the slot and page sharing levels.  Outputs
    are identical across every (decode_horizon, prefill_buckets) setting
    on eligible models."""

    def __init__(self, cfg: ArchConfig, params, plan: EndpointPlan,
                 device=None, exec_group: int = 0):
        n_slots, max_len = plan.n_slots, plan.max_len
        self.cfg = cfg
        self.model = Model(cfg, device)
        self.device = self.model.device
        self.params = self.model.prepare_params(params)
        self.n_slots = n_slots
        self.max_len = max_len
        self.pool = SlotPool(plan.vector.slots, n_slots)
        self.plan = plan
        self.decode_horizon = plan.decode_horizon
        self.queue: deque = deque()
        self.done: List[Request] = []
        self.latency: Dict[int, float] = {}      # rid -> s from run() start
        # deterministic schedule keys: the engine's token-step counter at
        # admission / retirement, and the order requests took slots
        self.admit_steps: Dict[int, int] = {}
        self.retire_steps: Dict[int, int] = {}
        self.admit_order: List[int] = []
        self.stats = {"decode_steps": 0, "decode_calls": 0,
                      "slot_steps": 0, "busy_slot_steps": 0,
                      "prefills": 0, "prefilled_requests": 0,
                      "host_syncs": 0, "regroups": 0}
        self.use_ragged_kernel = plan.use_ragged_kernel
        #: the exec group id this engine keys into (the plan's execs
        #: axis), and the group itself, whose graph memory pool this
        #: engine's captures draw on
        self.exec_group = exec_group
        self.group = shared_exec_group(cfg, self.use_ragged_kernel,
                                       exec_group, self.device)
        # the jit keys of the arguments every call shares: the weights
        # here, the persistent cache at start()
        self._params_sig = signature(self.params)
        self._cache_sig = None
        # ----- paged KV cache (plan-gated; DESIGN.md §13) ----------------
        self.page_pool: Optional[PagePool] = None
        self.page_size = 0
        self._pt = None                  # host page-table mirror (np)
        if plan.paged and self.model.supports_paged_cache:
            self.page_size = plan.page_size or auto_page_size(max_len)
            self.page_pool = PagePool(
                plan.vector.pages, n_slots, max_len // self.page_size,
                total_pages=plan.page_budget)
            self.stats["page_deferrals"] = 0
            self.stats["page_hwm"] = 0
        self.prefill_buckets = self._resolve_buckets(plan.prefill_buckets)
        self._t0 = 0.0
        self._started = False
        self._cache = None
        self._step_no = 0
        self._slot_req: List[Optional[Request]] = [None] * n_slots
        self._next_tok = None
        self._remaining = None
        self._pos = None
        self._eos_id = None
        self._has_eos = None
        self._dev_state = None     # device-resident state (fused mode)
        self._horizons: Optional[HorizonGraphs] = None    # fused mode

    def _resolve_buckets(self, buckets: Buckets) -> Tuple[int, ...]:
        """-> the active bucket set (empty tuple = exact-length prefill)."""
        auto = isinstance(buckets, str)
        if auto and buckets not in ("auto", "pow2"):
            raise ValueError(f"unknown prefill_buckets mode {buckets!r}")
        if not buckets:
            return ()
        if not self.model.supports_padded_prefill:
            if auto:
                return ()
            raise ValueError(
                f"{self.cfg.name}: bucketed prefill needs a pure-attention "
                f"stack without rolling-window caches")
        if auto:
            return pow2_buckets(self.max_len)
        out = tuple(sorted({min(int(b), self.max_len) for b in buckets}))
        if not all(b > 0 for b in out):
            raise ValueError(f"buckets must be positive, got {buckets}")
        return out

    def _bucket_of(self, length: int) -> int:
        for b in self.prefill_buckets:
            if b >= length:
                return b
        raise ValueError(f"prompt length {length} exceeds the largest "
                         f"bucket {self.prefill_buckets[-1]}")

    def compile_count(self) -> int:
        """Specializations of the engine's exec group so far, as the
        reference counts its jit caches: one per distinct key of each of
        the seven entries (``ExecGroup``), the same on the CPU and on the
        card.  The execs axis' signal: the adaptive controller diffs it
        per window."""
        return self.group.compile_count()

    def graph_count(self) -> int:
        """Horizon graphs this engine has captured: at most one per
        horizon length 1..K, 0 on the CPU (nothing is captured there) and
        at K=1."""
        return 0 if self._horizons is None else len(self._horizons.graphs)

    def _record_merge(self, one) -> None:
        """A batch-1 cache lands in a slot: the reference's jitted
        ``merge`` (``merge_paged`` on the paged layout)."""
        self.group.record("merge_paged" if self.page_pool is not None
                          else "merge", self._cache_sig, signature(one))

    def submit(self, req: Request):
        req.output = []
        if len(req.prompt) >= self.max_len:
            raise ValueError(
                f"prompt of {len(req.prompt)} tokens cannot fit max_len="
                f"{self.max_len}")
        self.queue.append(req)

    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    # ----- slot lifecycle -------------------------------------------------
    def _bind(self, slot: int, req: Request,
              first_tok: Optional[int] = None):
        """Host bookkeeping shared by both admission paths.  ``first_tok``
        is None in fused-horizon mode: the first token surfaces through
        the next horizon's trace."""
        self._slot_req[slot] = req
        if first_tok is not None:
            self._next_tok[slot] = first_tok
        self._remaining[slot] = req.max_new_tokens
        self._pos[slot] = len(req.prompt)
        self._eos_id[slot] = -1 if req.eos_id is None else req.eos_id
        self._has_eos[slot] = req.eos_id is not None
        self.admit_order.append(req.rid)
        self.admit_steps[req.rid] = self._step_no

    def _land(self, many, logits, batch: List[Tuple[int, Request]]):
        """Scatter a prefill's rows (row j = batch[j]) into their slots,
        then update the decode state and bind the requests."""
        slots = [slot for slot, _ in batch]
        lengths = [len(req.prompt) for _, req in batch]
        if self.page_pool is not None:
            _scatter_slots_paged(self._cache, many, slots, lengths,
                                 self._pt, self.page_pool.total_pages)
        else:
            _scatter_slots(self._cache, many, slots, lengths)
        first = logits.argmax(-1).to(torch.int32)[:len(batch)]
        if self._dev_state is not None:
            # the device state is updated in place (the reference rebuilt
            # it with .at[].set); no host sync: the first token surfaces
            # in the next horizon's trace
            s_idx = self._dev(np.asarray(slots, np.int64))
            st = self._dev_state
            st["tok"][s_idx] = first
            st["remaining"][s_idx] = self._dev(np.asarray(
                [r.max_new_tokens for _, r in batch], np.int32))
            st["finished"][s_idx] = False
            st["eos"][s_idx] = self._dev(np.asarray(
                [-1 if r.eos_id is None else r.eos_id for _, r in batch],
                np.int32))
            st["has_eos"][s_idx] = self._dev(np.asarray(
                [r.eos_id is not None for _, r in batch]))
            for slot, req in batch:
                self._bind(slot, req)
        else:
            first = first.cpu().numpy()                     # one sync
            for j, (slot, req) in enumerate(batch):
                self._bind(slot, req, int(first[j]))
            self.stats["host_syncs"] += 1

    def _admit(self, slot: int, req: Request):
        """Prefill ``req`` alone at its exact length and land it in
        ``slot``."""
        prompt = self._dev(np.asarray(req.prompt, np.int32)[None])
        one = self.model.init_cache(1, self.max_len)
        self.group.record("prefill", self._params_sig, signature(prompt),
                          signature(one))
        logits, one = self.model.prefill(self.params, {"tokens": prompt},
                                         one)
        self._record_merge(one)
        self._land(one, logits, [(slot, req)])
        self.stats["prefills"] += 1
        self.stats["prefilled_requests"] += 1

    def _admit_batch(self, batch: List[Tuple[int, Request]]):
        """Admit a round at once: every prompt pads to the round's length
        bucket and ONE fixed (n_slots)-row batched prefill runs.  Row and
        length padding are invisible (independent rows; causal
        attention), so outputs match the exact-length path."""
        n = self.n_slots
        bucket = self._bucket_of(max(len(r.prompt) for _, r in batch))
        toks = np.zeros((n, bucket), np.int32)
        last = np.zeros((n,), np.int32)
        for j, (_, req) in enumerate(batch):
            toks[j, :len(req.prompt)] = req.prompt
            last[j] = len(req.prompt) - 1
        self.group.record(
            "admit_packed_paged" if self.page_pool is not None
            else "admit_packed", self._params_sig, self._cache_sig,
            signature(toks), self.max_len)
        logits, many = self.model.prefill(
            self.params, {"tokens": self._dev(toks)},
            self.model.init_cache(n, self.max_len),
            last_index=self._dev(last))
        self._land(many, logits, batch)
        self.stats["prefills"] += 1
        self.stats["prefilled_requests"] += len(batch)

    def _retire(self, slot: int):
        req = self._slot_req[slot]
        self.latency[req.rid] = time.perf_counter() - self._t0
        self.retire_steps[req.rid] = self._step_no
        self.done.append(req)
        self._slot_req[slot] = None
        self._release_pages(slot)

    def _release_pages(self, slot: int):
        """Return the slot's pages AND sentinel its device table row, in
        place: a drained slot still rides the batched decode (horizon-1
        mode) and must not write into pages a new tenant now owns."""
        if self.page_pool is not None:
            self.page_pool.free(slot)
            self._pt[slot] = sentinel(self.page_pool.total_pages)
            self._cache["pt"][slot] = int(self._pt[slot, 0])

    def _drain(self, slots: Sequence[int]):
        """Free ``slots`` without retiring their requests (an export or an
        evacuation: no ``done`` or latency entry): pages go back to the
        pool, table rows and, in fused mode, the device rows drain, all in
        place."""
        for slot in slots:
            self._slot_req[slot] = None
            self._remaining[slot] = 0
            self._release_pages(slot)
        if slots and self._dev_state is not None:
            s_idx = self._dev(np.asarray(slots, np.int64))
            self._dev_state["finished"][s_idx] = True
            self._dev_state["remaining"][s_idx] = 0

    # ----- prefill/decode disaggregation (DESIGN.md §17) -----------------
    def prefill_only(self, req: Request) -> KVHandoff:
        """Prefill-role service: the batch-1 exact-length prefill, returned
        as the session's portable KV payload instead of binding a slot.
        Exact-length prefill gives the bucketed admission's tokens, so
        decoding the payload elsewhere serves the co-located tokens."""
        req.output = []
        if len(req.prompt) >= self.max_len:
            raise ValueError(
                f"prompt of {len(req.prompt)} tokens cannot fit max_len="
                f"{self.max_len}")
        prompt = self._dev(np.asarray(req.prompt, np.int32)[None])
        one = self.model.init_cache(1, self.max_len)
        self.group.record("prefill", self._params_sig, signature(prompt),
                          signature(one))
        logits, one = self.model.prefill(self.params, {"tokens": prompt},
                                         one)
        first = int(logits.argmax(-1)[0])                   # one sync
        self.stats["prefills"] += 1
        self.stats["prefilled_requests"] += 1
        self.stats["host_syncs"] += 1
        pos = len(req.prompt)
        return KVHandoff(
            rid=req.rid, cache=one, next_tok=first, pos=pos,
            remaining=max(1, req.max_new_tokens), emitted=[],
            eos_id=-1 if req.eos_id is None else req.eos_id,
            kv_tokens=pos, kv_bytes=_cache_bytes(one, pos, self.max_len))

    def _admit_handoff(self, slot: int, req: Request):
        """Land an imported KV payload in ``slot``: its cache merges where
        a prefill's would have (the in-place scatters), then the slot
        resumes at the payload's position, budget and next token.  No
        forward pass runs."""
        h = req.kv
        self._record_merge(h.cache)
        if self.page_pool is not None:
            _scatter_slots_paged(self._cache, h.cache, [slot], [h.pos],
                                 self._pt, self.page_pool.total_pages)
        else:
            _scatter_slots(self._cache, h.cache, [slot], [h.pos])
        req.output = list(h.emitted)
        self._bind(slot, req, h.next_tok)
        # _bind assumed a fresh prefill; the payload says where the
        # session stands, and the horizon's cut reads these two mirrors
        self._pos[slot] = h.pos
        self._remaining[slot] = h.remaining
        if self._dev_state is not None:
            st = self._dev_state
            st["tok"][slot] = h.next_tok
            st["remaining"][slot] = h.remaining
            st["finished"][slot] = False
            st["eos"][slot] = int(self._eos_id[slot])
            st["has_eos"][slot] = bool(self._has_eos[slot])

    def export_session(self, slot: int) -> KVHandoff:
        """Strip the live session in ``slot`` into a portable KV payload
        (live decode-to-decode migration): its cache leaves as a batch-1
        contiguous cache in the layout of ``Model.init_cache(1,
        max_len)``, copied out of the slot's row or gathered page by page
        (a sentinel entry clamps to the last physical page: garbage rows
        past ``pos``, which attention never reads), and the slot drains
        as an evacuation drains it.  In fused mode the next token and the
        budget live on the device: reading them is the export's one host
        sync."""
        req = self._slot_req[slot]
        if req is None:
            raise ValueError(f"slot {slot} holds no session")
        if self._dev_state is not None:
            st = self._dev_state
            tok, rem = torch.stack(
                [st["tok"][slot], st["remaining"][slot]]).tolist()
            self.stats["host_syncs"] += 1
        else:
            tok, rem = int(self._next_tok[slot]), int(self._remaining[slot])
        pos = int(self._pos[slot])
        if self.page_pool is not None:
            ids = self._dev(np.minimum(
                self._pt[slot], self.page_pool.total_pages - 1).astype(
                    np.int64))

            def gather(axis):
                def f(leaf):
                    pages = leaf.index_select(axis, ids)
                    shape = pages.shape
                    return pages.reshape(shape[:axis] + (1, self.max_len)
                                         + shape[axis + 2:])
                return f
        else:
            def gather(axis):
                return lambda leaf: leaf.narrow(axis, slot, 1).clone()
        stack = {group: tree_map(gather(axis), self._cache["stack"][group],
                                 torch.is_tensor)
                 for group, axis in (("prefix", 0), ("body", 1))}
        # a scalar idx, as init_cache(1, ...) has; the scatters set it
        # into one row of a per-slot cache
        one = {"stack": stack, "idx": self._cache["idx"][slot].clone()}
        self._drain([slot])
        return KVHandoff(
            rid=req.rid, cache=one, next_tok=tok, pos=pos, remaining=rem,
            emitted=list(req.output or []),
            eos_id=-1 if req.eos_id is None else req.eos_id,
            kv_tokens=pos, kv_bytes=_cache_bytes(one, pos, self.max_len))

    def export_sessions(self) -> List[KVHandoff]:
        """Every live slot leaves as a KV payload, in slot order; the
        admission queue stays: it holds no KV yet."""
        return [self.export_session(slot)
                for slot, req in enumerate(self._slot_req)
                if req is not None]

    def evacuate(self) -> Tuple[List[Request], List[Request]]:
        """Fail-stop teardown (DESIGN.md §15): pop every resident request,
        live slots and the queued backlog, without retiring any (no
        ``done`` or latency entry).  Pages return to the pool, table rows
        and device rows drain in place, and the engine stays steppable,
        its graphs with it.  -> ``(live, queued)``: the live requests
        carry their emitted prefix in ``output``."""
        live_slots = [slot for slot, req in enumerate(self._slot_req)
                      if req is not None]
        live = [self._slot_req[slot] for slot in live_slots]
        self._drain(live_slots)
        queued = list(self.queue)
        self.queue.clear()
        return live, queued

    # ----- observability and live re-planning ----------------------------
    def publish_metrics(self, registry, worker: int = 0) -> None:
        """Publish this engine's absolute counters into an
        ``obs.MetricsRegistry`` (DESIGN.md §14) under a ``worker`` label;
        ``set_total`` is idempotent, so any cadence is safe.
        ``engine.jit_compiles`` reads ``compile_count()``, the exec
        group's specializations, as the reference's does."""
        for name, axis in (("decode_steps", "execs"),
                           ("decode_calls", "execs"),
                           ("host_syncs", "execs"),
                           ("prefills", "execs"),
                           ("prefilled_requests", "execs"),
                           ("slot_steps", "slots"),
                           ("busy_slot_steps", "slots"),
                           ("regroups", "slots")):
            registry.counter(f"engine.{name}", axis=axis,
                             worker=worker).set_total(self.stats[name])
        registry.counter("engine.jit_compiles", axis="execs",
                         group=self.exec_group,
                         worker=worker).set_total(self.compile_count())
        registry.gauge("engine.queue_depth", axis="channels",
                       worker=worker).set(len(self.queue))
        if self.page_pool is not None:
            self.page_pool.publish_metrics(registry, axis="pages",
                                           worker=worker)

    def regroup(self, slot_level: Optional[int] = None,
                exec_group: Optional[int] = None,
                page_level: Optional[int] = None) -> bool:
        """Live migration (DESIGN.md §12): re-key the slot pool, the page
        budgets and the exec group without dropping queued or in-flight
        requests; -> True when anything changed.

        Slot and page regroups are admission and budget policy only
        (``SlotPool.regroup``, ``PagePool.regroup``): live slots keep
        decoding and every page mapping survives.  ``exec_group``
        moves the engine to that group (``ExecGroup``): the reference
        swaps the engine onto the group's shared executables; here its
        future specializations count in that group (``compile_count()``
        reads the new group's count) and its future captures go to the
        group's graph memory pool, while the graphs it has keep running
        from the pool they were captured in, so ``graph_count()`` does not
        move.  No path touches the cache or the decode state, so the
        tokens do not change."""
        changed = False
        if slot_level is not None and int(slot_level) != self.pool.level:
            self.pool.regroup(slot_level)
            changed = True
        if page_level is not None:
            if self.page_pool is None:
                if int(page_level) != 1:
                    raise ValueError(
                        "cannot regroup pages on a contiguous-layout "
                        "engine: the physical cache layout is structural "
                        "— connect with a paged plan (vector.pages > 1 "
                        "or page_size) first")
            elif int(page_level) != self.page_pool.level:
                self.page_pool.regroup(int(page_level))
                changed = True
        if exec_group is not None and int(exec_group) != self.exec_group:
            self.exec_group = int(exec_group)
            self.group = shared_exec_group(
                self.cfg, self.use_ragged_kernel, self.exec_group,
                self.device)
            if self._horizons is not None:
                self._horizons.group = self.group
            changed = True
        if changed:
            self.stats["regroups"] += 1
            # the plan follows the axes the engine owns; the execs level
            # is fleet-relative, so the client's plan keeps it
            self.plan = dataclasses.replace(
                self.plan, preset=None,
                vector=dataclasses.replace(
                    self.plan.vector, slots=self.pool.level,
                    pages=(self.page_pool.level
                           if self.page_pool is not None
                           else self.plan.vector.pages)))
        return changed

    # ----- external stepping ---------------------------------------------
    def start(self):
        """Allocate the persistent slot cache and reset per-slot state.
        Idempotent."""
        if self._started:
            return
        b = self.n_slots
        self._t0 = time.perf_counter()
        if self.page_pool is not None:
            self._cache = self.model.init_cache(
                b, self.max_len, per_slot=True, page_size=self.page_size,
                n_pages=self.page_pool.total_pages)
            self._pt = np.full(
                (b, self.max_len // self.page_size),
                sentinel(self.page_pool.total_pages), np.int32)
        else:
            self._cache = self.model.init_cache(b, self.max_len,
                                                per_slot=True)
        self._cache_sig = signature(self._cache)
        self._slot_req = [None] * b
        self._next_tok = np.zeros(b, np.int32)
        self._remaining = np.zeros(b, np.int32)
        self._pos = np.zeros(b, np.int64)
        self._eos_id = np.full(b, -1, np.int32)
        self._has_eos = np.zeros(b, bool)
        if self.decode_horizon > 1:
            # fused mode: the decode state lives on device between
            # horizons, in the static buffers the horizon graphs read;
            # every slot starts drained
            z = torch.zeros(b, dtype=torch.int32, device=self.device)
            self._dev_state = {
                "tok": z.clone(), "remaining": z.clone(),
                "finished": torch.ones(b, dtype=torch.bool,
                                       device=self.device),
                "eos": torch.full((b,), -1, dtype=torch.int32,
                                  device=self.device),
                "has_eos": torch.zeros(b, dtype=torch.bool,
                                       device=self.device),
            }
            self._horizons = HorizonGraphs(
                self.model, self.params, self._cache, self._dev_state,
                horizon=self.decode_horizon, max_len=self.max_len,
                use_ragged_kernel=self.use_ragged_kernel, group=self.group)
        self._started = True

    @property
    def paged(self) -> bool:
        return self.page_pool is not None

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self._slot_req)

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or self.n_active > 0

    def free_slots(self) -> List[int]:
        occupied = [r is not None for r in self._slot_req]
        return self.pool.admissible(occupied)

    def admissible_slots(self) -> List[int]:
        occupied = [r is not None for r in self._slot_req]
        return self.pool.admissible(occupied, queue_len=len(self.queue))

    def admit_waiting(self) -> int:
        """Admit queued requests into every admissible slot; -> count.
        With buckets active the round admits as one batched prefill;
        prompts longer than the largest bucket take the exact-length
        path."""
        self.start()
        batch: List[Tuple[int, Request]] = []
        for slot in self.admissible_slots():
            if not self.queue:
                break
            if self.page_pool is not None:
                # reserve the full worst-case page span up front; a dry
                # pool DEFERS in FIFO order
                req = self.queue[0]
                # a KV import's span is keyed on its resident cache
                # (possibly mid-decode), not on the prompt
                base = req.kv.pos if req.kv is not None else len(req.prompt)
                span = min(base + req.max_new_tokens, self.max_len)
                need = max(1, -(-span // self.page_size))
                if self.page_pool.alloc(slot, need) is None:
                    break
                self._pt[slot] = self.page_pool.table(slot)
            batch.append((slot, self.queue.popleft()))
        if self.page_pool is not None:
            self.stats["page_deferrals"] = self.page_pool.deferrals
            self.stats["page_hwm"] = self.page_pool.hwm
        if not batch:
            return 0
        kv_batch = [(s, r) for s, r in batch if r.kv is not None]
        for slot, req in kv_batch:      # cache merge, no forward pass
            self._admit_handoff(slot, req)
        n_admitted = len(batch)
        batch = [(s, r) for s, r in batch if r.kv is None]
        if self.prefill_buckets:
            cap = self.prefill_buckets[-1]
            fit = [(s, r) for s, r in batch if len(r.prompt) <= cap]
            if fit:
                self._admit_batch(fit)
            for slot, req in batch:
                if len(req.prompt) > cap:
                    self._admit(slot, req)
        else:
            for slot, req in batch:
                self._admit(slot, req)
        return n_admitted

    def step(self) -> List[Request]:
        """Decode ``decode_horizon`` steps over every live slot; ->
        requests retired.  Horizon 1 is the per-step host loop."""
        if self.decode_horizon > 1:
            return self._step_fused()
        active = [i for i, r in enumerate(self._slot_req) if r is not None]
        if not active:
            return []
        self.group.record("decode", self._params_sig, self._cache_sig,
                          (self.n_slots,))
        logits, self._cache = self.model.decode_step(
            self.params, self._cache, self._dev(self._next_tok),
            use_ragged_kernel=self.use_ragged_kernel)
        self.stats["decode_steps"] += 1
        self.stats["decode_calls"] += 1
        self.stats["host_syncs"] += 1
        self.stats["slot_steps"] += self.n_slots
        self.stats["busy_slot_steps"] += len(active)
        self._step_no += 1
        produced = self._next_tok.copy()
        nxt = logits.argmax(-1).to(torch.int32).cpu().numpy()
        self._pos += 1       # every row's cache index advanced
        retired: List[Request] = []
        for i in active:
            r = self._slot_req[i]
            r.output.append(int(produced[i]))
            self._remaining[i] -= 1
            finished = (self._remaining[i] <= 0
                        or (r.eos_id is not None
                            and int(nxt[i]) == r.eos_id))
            if not finished and self._pos[i] >= self.max_len - 1:
                r.output.append(int(nxt[i]))   # budget exhausted
                finished = True
            if finished:
                self._retire(i)
                retired.append(r)
        self._next_tok = nxt
        return retired

    def _horizon_steps(self) -> int:
        """Steps the next horizon can take at most: every live slot
        retires on its budget or at the cache edge by then (an EOS can
        only end it sooner).  Steps past the last live one would write
        nothing, so the horizon stops there."""
        need = 1
        for i, r in enumerate(self._slot_req):
            if r is not None:
                budget = max(1, int(self._remaining[i]))
                edge = max(1, self.max_len - 1 - int(self._pos[i]))
                need = max(need, min(budget, edge))
        return min(self.decode_horizon, need)

    def _run_horizon(self, n_steps: int):
        """One horizon of ``n_steps`` steps (its graph on the card); ->
        the static trace."""
        return self._horizons(n_steps)

    def _step_fused(self) -> List[Request]:
        """One fused horizon: up to K decode steps on device, one host
        drain of the token trace."""
        if self.n_active == 0:
            return []
        k = self.decode_horizon
        # the reference runs every horizon at its full K (static)
        self.group.record("horizon", self._params_sig, self._cache_sig, k,
                          self.max_len)
        trace = self._run_horizon(self._horizon_steps())
        # ONE blocking transfer drains the whole K-step trace
        packed = torch.stack([trace[n].to(torch.int32) for n, _ in _TRACE])
        tok, live, bonus_tok, bonus, retired_t = packed.cpu().numpy()
        live, bonus, retired_t = (live.astype(bool), bonus.astype(bool),
                                  retired_t.astype(bool))
        executed = int(live.any(axis=1).sum())
        self.stats["decode_steps"] += executed
        self.stats["decode_calls"] += 1
        self.stats["host_syncs"] += 1
        self.stats["slot_steps"] += executed * self.n_slots
        retired: List[Request] = []
        for s in range(k):
            row_live = live[s]
            if not row_live.any():
                break     # liveness is monotone within a horizon
            self._step_no += 1
            self.stats["busy_slot_steps"] += int(row_live.sum())
            for i in np.nonzero(row_live)[0]:
                r = self._slot_req[i]
                r.output.append(int(tok[s, i]))
                self._remaining[i] -= 1
                if bonus[s, i]:
                    r.output.append(int(bonus_tok[s, i]))
                if retired_t[s, i]:
                    self._retire(i)
                    retired.append(r)
        self._pos += executed    # every row's cache index advanced as one
        return retired

    def run(self) -> List[Request]:
        self.start()
        self._t0 = time.perf_counter()
        while self.has_work:
            self.admit_waiting()
            if not self.step():
                if self.n_active == 0:
                    break
        return self.done

    @property
    def occupancy(self) -> float:
        """Fraction of slot-steps that decoded a live request."""
        if not self.stats["slot_steps"]:
            return 0.0
        return self.stats["busy_slot_steps"] / self.stats["slot_steps"]
