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

The reference's jitted executables (``SharedSteps``) have two
counterparts here.  ``HorizonGraphs`` captures the fused horizon as one
``torch.cuda.CUDAGraph`` per ``n_steps`` at first use, on the engine's
static buffers, and replays it as one launch per horizon;
``graph_count()`` counts those graphs.  ``AdmissionGraphs`` does the same
for a bucketed admission round, the reference's ``admit_packed`` and
``admit_packed_paged``: one graph per prefill bucket holds the padded
batched prefill on a fresh cache, the scatter of its rows into their
slots (or pages), the argmax of the first tokens and, in fused mode, the
decode-state update; ``admission_graph_count()`` counts those.  A graph
binds the addresses of one engine's buffers, so what the engines of an
exec group share is the memory the captures draw on: one ``ExecGroup``
per (config, ragged kernel, group id, device), the counterpart of
``SharedSteps``' key, owns one graph memory pool that every engine of the
group captures into.  The exact-length admission (``_admit``),
``prefill_only``, KV handoff landings and the K=1 decode step stay
eager; their cache scatters write in place, indexed by the slot
assignment the host already knows.

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
from typing import Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.plan import Buckets, EndpointPlan, SharingVector
from repro_torch.kernels.flash_attention import ops as attention_ops
from repro_torch.kernels.rglru import ops as rglru_ops
from repro_torch.models.model import Model
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.serve.pages import PagePool, sentinel
from repro_torch.serve.slots import SlotPool, _coerce_level


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


def _scatter_slot(full, one, slot: int, length: int):
    """The batch-1 cache ``one`` lands in slot ``slot`` of ``full``, in
    place (the reference's ``_scatter_slot`` rebuilt every leaf), and that
    slot's position pins to ``length``.  Every leaf lands whole along its
    batch axis: KV rows, rolling windows and recurrent state alike.  A
    bucketed round's multi-row scatter is ``AdmissionGraphs.body``'s."""
    for dst, src, axis in _leaf_pairs(full["stack"], one["stack"]):
        if axis == 0:
            dst[slot] = src[0]
        else:
            dst[:, slot] = src[:, 0]
    full["idx"][slot] = length


def _scatter_slot_paged(full, one, slot: int, length: int,
                        pt_row: np.ndarray, n_pages: int):
    """Paged variant of ``_scatter_slot``: the batch-1 contiguous cache
    ``one`` splits into pages and lands, in place, in the physical pages
    of ``pt_row``, slot ``slot``'s row of the host page table (pool of
    ``n_pages``).  The reference dropped sentinel entries with
    ``mode="drop"``; here the host leaves them out of the index lists.
    The row installs in the device table."""
    dev = full["idx"].device
    max_pages = pt_row.shape[0]
    keep = np.flatnonzero(pt_row < n_pages)
    sp = torch.as_tensor(keep, dtype=torch.long, device=dev)
    dp = torch.as_tensor(pt_row[keep], dtype=torch.long, device=dev)
    for dst, src, axis in _leaf_pairs(full["stack"], one["stack"]):
        ps = dst.shape[axis + 1]
        shape = list(src.shape)
        shape[axis + 1:axis + 2] = [max_pages, ps]
        pages = src.reshape(shape)
        if axis == 0:
            dst[dp] = pages[0, sp]
        else:
            dst[:, dp] = pages[:, 0, sp]
    full["idx"][slot] = length
    full["pt"][slot] = torch.as_tensor(pt_row, device=dev)


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
#: which a graph's replay does not touch (``SHAPE_LAUNCHES`` gains a key
#: at a signature's first launch)
_LAUNCH_COUNTERS = (attention_ops.LAUNCHES, attention_ops.SHAPE_LAUNCHES,
                    rglru_ops.LAUNCHES, rglru_ops.SHAPE_LAUNCHES)
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


def _launch_counts() -> List[Dict[Hashable, int]]:
    return [dict(counter) for counter in _LAUNCH_COUNTERS]


def _set_launch_counts(counts: List[Dict[Hashable, int]]) -> None:
    for counter, saved in zip(_LAUNCH_COUNTERS, counts):
        counter.clear()
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

    A horizon or admission graph binds one engine's buffers, so the
    group cannot share the graphs themselves.  It shares the memory they
    run in: one CUDA graph memory pool (``torch.cuda.graph_pool_handle()``,
    made at the group's first capture) that every engine of the group
    captures its graphs into, so at exec level 4 a fleet holds one pool of
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
    before the fleet steps another engine (an admission round in fused
    mode does not sync, but the engine's next horizon follows it on the
    same stream).  A replay's outputs never live in the pool: each body
    writes what it produces (the cache and its ``idx`` and ``pt``, the
    state, the trace, the first tokens) into buffers allocated outside
    any capture, so only a capture's intermediates (an admission's
    prefill cache among them), dead once its replay ends, share the
    pool's memory.  A pool lives as long as the graphs captured into
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


def pool_bytes(groups) -> Optional[int]:
    """Bytes the card holds in the graph memory pools of ``groups``
    (segments of ``torch.cuda.memory_snapshot()`` by pool id); None when
    the snapshot names no pools."""
    ids = {tuple(g._pool) for g in groups if g._pool is not None}
    segments = torch.cuda.memory_snapshot()
    if not any("segment_pool_id" in seg for seg in segments):
        return None
    return sum(seg["total_size"] for seg in segments
               if tuple(seg.get("segment_pool_id", ())) in ids)


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
    """The process's ``ExecGroup`` for this key, made at first use.  On
    the card decode attention runs its CUDA kernel whatever
    ``use_ragged_kernel`` says, so the flag keys only CPU groups."""
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    ragged = bool(use_ragged_kernel) and device.type == "cpu"
    key = (cfg, ragged, int(group), str(device))
    if key not in _EXEC_GROUPS:
        _EXEC_GROUPS[key] = ExecGroup(key)
    return _EXEC_GROUPS[key]


class _Graphs:
    """One engine body as CUDA graphs, one per value of its static
    argument (a horizon's ``n_steps``, an admission's bucket), the
    bookkeeping ``HorizonGraphs`` and ``AdmissionGraphs`` share.

    On a CUDA device ``run(key)`` captures ``body(key)`` at the key's
    first use, as jit compiles at first use, and replays it.  The capture
    runs on the device's capture stream, which every engine shares, into
    the memory pool of the engine's ``group`` at the time of the capture
    (an ``ExecGroup``, whose invariant the caller keeps), and is counted
    there.  Warm-ups and captures leave the kernel launch counters as
    they were; each replay adds the launches its graph holds.  A failed
    warm-up, capture or replay raises.  On the CPU nothing is captured
    and ``run`` calls the body."""

    def __init__(self, device: torch.device, group: ExecGroup):
        self.group = group
        #: key -> (graph, the launch counts one replay adds)
        self.graphs: Dict[Hashable, Tuple[torch.cuda.CUDAGraph,
                                          List[Dict[Hashable, int]]]] = {}
        self._stream = _capture_stream(device) \
            if device.type == "cuda" else None

    def body(self, key):
        raise NotImplementedError

    def _warm_up(self, fn) -> None:
        """``fn()`` eagerly on the capture stream, after the current
        stream's work and before any later (kernel builds and library
        handles, which must not fall inside a capture); the launch
        counters stay as they were."""
        counts = _launch_counts()
        current = torch.cuda.current_stream(self._stream.device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            fn()
        current.wait_stream(self._stream)
        _set_launch_counts(counts)

    def _capture(self, key):
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
                self.body(key)
        finally:
            if collecting:
                gc.enable()
        self.group.captures += 1
        held = [{name: n - before.get(name, 0)
                 for name, n in after.items() if n != before.get(name, 0)}
                for after, before in zip(_launch_counts(), counts)]
        _set_launch_counts(counts)
        return graph, held

    def run(self, key):
        """``body(key)``: its graph's replay on the card (captured first
        if new), the body itself on the CPU."""
        if self._stream is None:
            self.body(key)
            return
        if key not in self.graphs:
            self.graphs[key] = self._capture(key)
        graph, held = self.graphs[key]
        graph.replay()
        for counter, add in zip(_LAUNCH_COUNTERS, held):
            for name, n in add.items():
                counter[name] = counter.get(name, 0) + n


class HorizonGraphs(_Graphs):
    """The fused decode horizon as executables: the port's counterpart of
    the reference's jitted ``SharedSteps.horizon``.

    ``body(n_steps)`` runs ``Model.decode_horizon`` eagerly on static
    buffers: it reads the engine's persistent cache and device state, and
    copies what the model hands back as new tensors (the cache's ``idx``,
    the state, the trace) into those same tensors and into one static
    (K, B) trace per leaf.  The engine's host-side writers (the admission
    rounds, ``_land``, ``_retire``) write the same tensors in place, so
    every address the body reads stays fixed for the engine's life.

    On a CUDA device a call captures the body once per ``n_steps`` (the
    engine's cut of the horizon, 1..K, so at most K graphs) at first use
    and replays it: one launch for the whole horizon (``_Graphs``).  The
    body is warmed up once at construction, when every slot is drained,
    so it writes nothing."""

    def __init__(self, model: Model, params, cache, state, *, horizon: int,
                 max_len: int, use_ragged_kernel: bool, group: ExecGroup):
        b, dev = state["tok"].shape[0], state["tok"].device
        super().__init__(dev, group)
        self.model = model
        self.params = params
        self.cache = cache
        self.state = state
        self.horizon = horizon
        self.max_len = max_len
        self.use_ragged_kernel = use_ragged_kernel
        self.trace = {name: torch.zeros((horizon, b), dtype=dt, device=dev)
                      for name, dt in _TRACE}
        if self._stream is not None:
            self._warm_up(lambda: self.body(1))

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

    def __call__(self, n_steps: int):
        """One horizon of ``n_steps`` steps: its graph's replay on the
        card, the body on the CPU; -> the static trace."""
        self.run(n_steps)
        return self.trace


#: the rows of ``AdmissionGraphs.rows``, one (n_slots,) int64 vector each:
#: the prefill's ``last_index`` per row, then each row's destination
#: slot and source row and the values it lands there (padding rows
#: repeat the round's first row in all of these), then, paged, the
#: source and destination of the one page pair a sentinel entry repeats
_ROWS = ("last", "slot", "src", "length", "remaining", "eos", "has_eos",
         "anchor_src", "anchor_page")


class AdmissionGraphs(_Graphs):
    """A bucketed admission round as executables: the port's counterpart
    of the reference's jitted ``admit_packed`` and ``admit_packed_paged``,
    one graph per prefill bucket.

    ``load(...)`` takes a round as the reference's ``admit_packed`` does
    (``(n_slots, bucket)`` tokens, ``last_index``, the row-major slot
    assignment with its ``valid`` mask, and each row's length, budget and
    EOS; paged, the host page table) and fills the static inputs with
    ``copy_``: the bucket's token buffer, one (9, n_slots) int64 block of
    per-row vectors (``_ROWS``) and, paged, a ``(n_slots, max_pages)``
    table.  ``body(bucket)`` is the round on those buffers: the prefill on
    a fresh ``init_cache(n_slots, max_len)``, every row of it landing in
    its slot of the engine's cache (or, paged, each page in the physical
    page its slot's table row names) in place, ``idx`` pinned to each
    length, the table installed whole, the argmax of each row's logits
    into the static ``first`` and, in fused mode, the five state tensors
    written in place.

    The graph has fixed shapes, where the reference masks the rows past
    the round (``_slot_mapping``, ``jnp.where``, ``mode="drop"``).  Here a
    padding row repeats the round's first row: its destination slot, its
    source row and every value it lands, so that it writes what that row
    writes, and the sentinel entries of a table row repeat the round's
    first page pair.  Repeated indices thus always carry equal values, and
    no slot or page outside the round is written.

    On the card the body is captured at the first round of each bucket,
    after a warm-up of that bucket's prefill alone (which writes no
    slot), and replayed after (``_Graphs``).  On the CPU it runs
    eagerly."""

    def __init__(self, model: Model, params, cache, state, *,
                 buckets: Sequence[int], max_len: int, n_pages: int,
                 group: ExecGroup):
        n, dev = cache["idx"].shape[0], cache["idx"].device
        super().__init__(dev, group)
        self.model = model
        self.params = params
        self.cache = cache
        self.state = state               # fused mode's, else None
        self.n_slots = n
        self.max_len = max_len
        self.n_pages = n_pages           # paged: the pool's pages, else 0
        self.tokens = {b: torch.zeros((n, b), dtype=torch.int32, device=dev)
                       for b in buckets}
        self.rows = torch.zeros((len(_ROWS), n), dtype=torch.int64,
                                device=dev)
        self.pt = (torch.zeros_like(cache["pt"]) if "pt" in cache
                   else None)
        self.first = torch.zeros(n, dtype=torch.int32, device=dev)

    def load(self, toks, last_index, slot_ids, valid, lengths, remaining,
             eos, has_eos, pt=None) -> int:
        """Fill the static inputs with one round (numpy arrays, as the
        reference's ``admit_packed`` takes them); -> its bucket."""
        n = self.n_slots
        bucket = toks.shape[1]
        if bucket not in self.tokens:
            raise ValueError(f"no admission bucket of {bucket} tokens "
                             f"({sorted(self.tokens)})")
        real = np.flatnonzero(valid)
        if real.size == 0:
            raise ValueError("an admission round needs a row")
        r0 = int(real[0])
        src = np.where(valid, np.arange(n), r0)
        block = np.zeros((len(_ROWS), n), np.int64)
        block[0] = last_index
        block[1] = np.asarray(slot_ids)[src]
        block[2] = src
        for i, values in enumerate((lengths, remaining, eos, has_eos), 3):
            block[i] = np.asarray(values)[src]
        if self.pt is not None:
            table = np.asarray(pt, np.int32)
            page = int(table[block[1, 0], 0])
            if page >= self.n_pages:
                raise ValueError(f"slot {block[1, 0]} holds no page")
            block[7] = r0 * table.shape[1]
            block[8] = page
            self.pt.copy_(torch.from_numpy(table))
        self.rows.copy_(torch.from_numpy(block))
        self.tokens[bucket].copy_(torch.from_numpy(
            np.ascontiguousarray(toks, np.int32)))
        return bucket

    def body(self, bucket: int):
        """The loaded round, eagerly, on the static buffers; -> the static
        ``first`` (each row's first token)."""
        n = self.n_slots
        last, slot, src, length, remaining, eos, has_eos, anchor_src, \
            anchor_page = self.rows
        logits, many = self.model.prefill(
            self.params, {"tokens": self.tokens[bucket]},
            self.model.init_cache(n, self.max_len), last_index=last)
        self.first.copy_(logits.argmax(-1))
        pairs = _leaf_pairs(self.cache["stack"], many["stack"])
        if self.pt is None:
            for dst, part, axis in pairs:
                dst.index_copy_(axis, slot, part.index_select(axis, src))
        else:
            mp = self.pt.shape[1]
            table = self.pt.index_select(0, slot).long()
            real = table < self.n_pages
            cols = torch.arange(mp, device=table.device)
            to = torch.where(real, table, anchor_page[:, None]).reshape(-1)
            fr = torch.where(real, src[:, None] * mp + cols,
                             anchor_src[:, None]).reshape(-1)
            for dst, part, axis in pairs:
                shape = part.shape
                pages = part.reshape(shape[:axis] + (n * mp,
                                                     dst.shape[axis + 1])
                                     + shape[axis + 2:])
                dst.index_copy_(axis, to, pages.index_select(axis, fr))
            self.cache["pt"].copy_(self.pt)
        self.cache["idx"].index_copy_(0, slot, length.to(torch.int32))
        if self.state is not None:
            st = self.state
            st["tok"].index_copy_(0, slot, self.first.index_select(0, src))
            st["remaining"].index_copy_(0, slot, remaining.to(torch.int32))
            st["finished"].index_fill_(0, slot, False)
            st["eos"].index_copy_(0, slot, eos.to(torch.int32))
            st["has_eos"].index_copy_(0, slot, has_eos.to(torch.bool))
        return self.first

    def _capture(self, bucket: int):
        self._warm_up(lambda: self.model.prefill(
            self.params, {"tokens": self.tokens[bucket]},
            self.model.init_cache(self.n_slots, self.max_len),
            last_index=self.rows[0]))
        return super()._capture(bucket)

    def __call__(self, bucket: int):
        """The loaded round: its bucket's graph replayed on the card, the
        body on the CPU; -> the static ``first``."""
        self.run(bucket)
        return self.first


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
    jits this step per shape but fuses no horizon here.

    ``plan`` rules ``n_slots`` and ``max_len``; without one the
    reference's keywords build its wave plan (slot level 4)."""

    def __init__(self, cfg: ArchConfig, params,
                 plan: Optional[EndpointPlan] = None, device=None,
                 exec_group: int = 0, *, n_slots: int = 4,
                 max_len: int = 512):
        if cfg.input_mode != "tokens" or cfg.is_encdec:
            raise ValueError("the wave engine serves decoder-only token "
                             "models")
        if plan is not None:
            n_slots, max_len = plan.n_slots, plan.max_len
        self.cfg = cfg
        self.model = Model(cfg, device)
        self.device = self.model.device
        self.params = self.model.prepare_params(params)
        self.plan = plan or EndpointPlan(
            vector=SharingVector(slots=4), n_slots=n_slots,
            max_len=max_len, executor="wave")
        self.n_slots = n_slots
        self.max_len = max_len
        # the reference's wave engine runs its exec group's jitted
        # prefill and decode, without the ragged kernel
        self.group = shared_exec_group(cfg, False, exec_group, self.device)
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
    on eligible models.

    Without a plan the reference's keywords configure the engine and
    build its plan; with one, the plan rules every knob it carries, and
    only ``slot_level`` (or ``pool``) overrides its slot level.
    ``category=`` and a ``Category`` passed as ``slot_level`` are the
    deprecated spellings of the level: each warns once."""

    def __init__(self, cfg: ArchConfig, params,
                 plan: Optional[EndpointPlan] = None, device=None,
                 exec_group: int = 0, *, n_slots: int = 4,
                 max_len: int = 512, category=None, slot_level=None,
                 pool: Optional[SlotPool] = None,
                 use_ragged_kernel: bool = False, decode_horizon: int = 1,
                 prefill_buckets: Buckets = "auto"):
        if cfg.input_mode != "tokens" or cfg.is_encdec:
            raise ValueError("the continuous engine serves decoder-only "
                             "token models")
        if category is not None:
            slot_level = _coerce_level(None, category, "ContinuousEngine")
        if plan is not None:
            n_slots, max_len = plan.n_slots, plan.max_len
            decode_horizon = plan.decode_horizon
            prefill_buckets = plan.prefill_buckets
            use_ragged_kernel = plan.use_ragged_kernel
            slot_level = plan.vector.slots if slot_level is None \
                else slot_level
        if decode_horizon < 1:
            raise ValueError(f"decode_horizon must be >= 1, "
                             f"got {decode_horizon}")
        self.cfg = cfg
        self.model = Model(cfg, device)
        self.device = self.model.device
        self.params = self.model.prepare_params(params)
        self.n_slots = n_slots
        self.max_len = max_len
        self.pool = pool or SlotPool(
            1 if slot_level is None else slot_level, n_slots)
        if self.pool.n_slots != n_slots:
            raise ValueError(f"the pool holds {self.pool.n_slots} slots, "
                             f"the engine {n_slots}")
        plan = self.plan = plan or EndpointPlan(
            vector=SharingVector(slots=self.pool.level), n_slots=n_slots,
            max_len=max_len, decode_horizon=decode_horizon,
            prefill_buckets=prefill_buckets,
            use_ragged_kernel=use_ragged_kernel, executor="continuous")
        self.decode_horizon = decode_horizon
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
        self._admissions: Optional[AdmissionGraphs] = None   # buckets

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

    def admission_graph_count(self) -> int:
        """Admission graphs this engine has captured: at most one per
        prefill bucket it admitted a round in, 0 on the CPU (nothing is
        captured there) and without buckets."""
        return 0 if self._admissions is None \
            else len(self._admissions.graphs)

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

    def _merge(self, one, slot: int, length: int):
        """Land the batch-1 cache ``one`` in ``slot`` (its pages, when
        paged) and pin the slot's position to ``length``: the reference's
        jitted ``merge`` (``merge_paged`` on the paged layout)."""
        self.group.record("merge_paged" if self.page_pool is not None
                          else "merge", self._cache_sig, signature(one))
        if self.page_pool is not None:
            _scatter_slot_paged(self._cache, one, slot, length,
                                self._pt[slot], self.page_pool.total_pages)
        else:
            _scatter_slot(self._cache, one, slot, length)

    def _land(self, one, logits, slot: int, req: Request):
        """Land an exact-length prefill in ``slot``, then update the
        decode state and bind the request."""
        self._merge(one, slot, len(req.prompt))
        first = logits[0].argmax(-1).to(torch.int32)
        if self._dev_state is not None:
            # the device state is updated in place (the reference rebuilt
            # it with .at[].set); no host sync: the first token surfaces
            # in the next horizon's trace
            st = self._dev_state
            st["tok"][slot] = first
            st["remaining"][slot] = req.max_new_tokens
            st["finished"][slot] = False
            st["eos"][slot] = -1 if req.eos_id is None else req.eos_id
            st["has_eos"][slot] = req.eos_id is not None
            self._bind(slot, req)
        else:
            self._bind(slot, req, int(first))               # one sync
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
        self._land(one, logits, slot, req)
        self.stats["prefills"] += 1
        self.stats["prefilled_requests"] += 1

    def _admit_batch(self, batch: List[Tuple[int, Request]]):
        """Admit a round at once: every prompt pads to the round's length
        bucket, and one admission round (``AdmissionGraphs``: on the card
        its bucket's graph) runs ONE fixed (n_slots)-row batched prefill,
        lands every row in its slot and, in fused mode, updates the
        device state without a host sync.  Row and length padding are
        invisible (independent rows; causal attention), so outputs match
        the exact-length path."""
        n = self.n_slots
        bucket = self._bucket_of(max(len(r.prompt) for _, r in batch))
        toks = np.zeros((n, bucket), np.int32)
        last = np.zeros((n,), np.int32)
        slot_ids = np.zeros((n,), np.int32)
        valid = np.zeros((n,), bool)
        lengths = np.zeros((n,), np.int32)
        remaining = np.zeros((n,), np.int32)
        eos = np.full((n,), -1, np.int32)
        has_eos = np.zeros((n,), bool)
        for j, (slot, req) in enumerate(batch):
            ln = len(req.prompt)
            toks[j, :ln] = req.prompt
            last[j] = ln - 1
            slot_ids[j] = slot
            valid[j] = True
            lengths[j] = ln
            remaining[j] = req.max_new_tokens
            eos[j] = -1 if req.eos_id is None else req.eos_id
            has_eos[j] = req.eos_id is not None
        self.group.record(
            "admit_packed_paged" if self.page_pool is not None
            else "admit_packed", self._params_sig, self._cache_sig,
            signature(toks), self.max_len)
        self._admissions.load(toks, last, slot_ids, valid, lengths,
                              remaining, eos, has_eos, self._pt)
        first = self._run_admission(bucket)
        if self._dev_state is not None:
            # the first tokens surface in the next horizon's trace
            for slot, req in batch:
                self._bind(slot, req)
        else:
            first = first[:len(batch)].cpu().numpy()        # one sync
            for j, (slot, req) in enumerate(batch):
                self._bind(slot, req, int(first[j]))
            self.stats["host_syncs"] += 1
        self.stats["prefills"] += 1
        self.stats["prefilled_requests"] += len(batch)

    def _run_admission(self, bucket: int):
        """The loaded admission round (its graph on the card); -> each
        row's first token (the static buffer)."""
        return self._admissions(bucket)

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
        self._merge(h.cache, slot, h.pos)
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
        from the pool they were captured in, so neither ``graph_count()``
        nor ``admission_graph_count()`` moves.  No path touches the cache or the decode state, so the
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
            for graphs in (self._horizons, self._admissions):
                if graphs is not None:
                    graphs.group = self.group
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
        if self.prefill_buckets:
            self._admissions = AdmissionGraphs(
                self.model, self.params, self._cache, self._dev_state,
                buckets=self.prefill_buckets, max_len=self.max_len,
                n_pages=(self.page_pool.total_pages
                         if self.page_pool is not None else 0),
                group=self.group)
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
        logits, cache = self.model.decode_step(
            self.params, self._cache, self._dev(self._next_tok),
            use_ragged_kernel=self.use_ragged_kernel)
        # the step writes the stack in place and hands back a new idx:
        # copy it into the engine's, whose address the admission graphs
        # hold
        self._cache["idx"].copy_(cache["idx"])
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
