"""Deterministic fixed-size KV-cache page allocator (DESIGN.md §13).

The paper's follow-up ("Lessons Learned on MPI+Threads Communication",
PAPERS.md) locates the sharing win in the LARGE, rarely-saturated
resources — registered memory regions and buffers — while the contended
scheduling resources stay partitioned.  The serving analogue: the KV
cache is by far the largest per-session reservation (``max_len`` rows
per slot today), yet most sessions use a fraction of it.  ``PagePool``
re-founds that reservation on fixed-size pages drawn from a shared
pool, budgeted per *page group* of slots by the fourth ``SharingVector``
axis:

* pages level 1 — every slot holds a dedicated full-length budget
  (``max_pages`` pages each): admission can never defer on memory, and
  the reachable state space is exactly the historical contiguous cache;
* level 2/3 — slots pool budgets in groups of ``level_group_size``;
* level 4 — one fleet-wide pool: maximal packing, admission defers
  (never corrupts) when the pool is dry.

Everything is host-side integer bookkeeping — NumPy tables, no jax —
and fully deterministic: the free list is a min-heap, ``alloc`` always
hands out the lowest-numbered free pages, so the same op sequence
always produces the same page tables (property-tested in
``tests/test_page_pool.py``).
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.endpoints import level_group_size

#: Page-table sentinel for "no page mapped": one past the last valid
#: page id, so device-side scatters drop it (``mode="drop"``) and
#: gathers clip to a real page whose garbage the length mask hides.
def sentinel(n_pages: int) -> int:
    return n_pages


class PagePool:
    """Free-list page allocator with per-group budgets over slots.

    Parameters:
      level: pages sharing level 1..4 (``SharingVector.pages``).
      n_slots: slots served by this pool (page groups partition these).
      max_pages: pages a single sequence can map (``max_len / page_size``).
      total_pages: pool capacity.  Defaults to the dedicated reservation
        ``n_slots * max_pages``; a tighter ``EndpointPlan.page_budget``
        shrinks it (that is the whole point of pooling).

    Invariants (the property-test contract):
      * conservation — ``len(free) + sum(live pages) == total_pages``;
      * no aliasing — live slots own pairwise-disjoint page sets;
      * determinism — identical op sequences yield identical tables;
      * OOM defers — a failed ``alloc`` returns None and mutates nothing;
      * ``regroup`` re-keys budgets only — every live mapping survives.
    """

    def __init__(self, level: int, n_slots: int, max_pages: int, *,
                 total_pages: Optional[int] = None):
        if not 1 <= int(level) <= 4:
            raise ValueError(f"pages level must be in 1..4, got {level!r}")
        if n_slots < 1 or max_pages < 1:
            raise ValueError("n_slots and max_pages must be >= 1")
        self.level = int(level)
        self.n_slots = int(n_slots)
        self.max_pages = int(max_pages)
        self.total_pages = int(total_pages if total_pages is not None
                               else n_slots * max_pages)
        if self.total_pages < 1:
            raise ValueError("total_pages must be >= 1")
        self._free: List[int] = list(range(self.total_pages))
        heapq.heapify(self._free)
        #: slot -> its page ids, in allocation order
        self._owned: Dict[int, List[int]] = {}
        #: pages withheld by an external pressure spike (chaos fabric) —
        #: neither free nor owned by a slot; ``restore`` returns them
        self._seized: List[int] = []
        self._seized_ever = False     # keeps the series once it exists
        self.deferrals = 0            # admission attempts the pool refused
        self.hwm = 0                  # high-water mark of live pages

    # ----- group structure ----------------------------------------------
    @property
    def group_size(self) -> int:
        return level_group_size(self.level, self.n_slots)

    def group_of(self, slot: int) -> int:
        return slot // self.group_size

    @property
    def groups(self) -> int:
        return -(-self.n_slots // self.group_size)

    def group_budget(self, group: int) -> int:
        """Pages group ``group`` may hold live: an even split of the pool
        over groups, by each group's slot share.  At level 1 with the
        default pool this is exactly ``max_pages`` per slot — dedicated
        reservation, admission can never defer."""
        lo = group * self.group_size
        slots_in = max(0, min(self.n_slots, lo + self.group_size) - lo)
        return (self.total_pages * slots_in) // self.n_slots

    def group_live(self, group: int) -> int:
        return sum(len(p) for s, p in self._owned.items()
                   if self.group_of(s) == group)

    # ----- accounting ----------------------------------------------------
    @property
    def live_pages(self) -> int:
        return sum(len(p) for p in self._owned.values())

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def pressure(self) -> float:
        """Unavailable-page fraction of the pool (live + seized) — the
        pool-pressure telemetry ``core.adapt.Replanner(paged=True)``
        promotes/demotes on; a chaos-fabric pressure spike registers
        here exactly like organic occupancy."""
        return (self.live_pages + len(self._seized)) / self.total_pages

    # ----- the allocator --------------------------------------------------
    def alloc(self, slot: int, n: int) -> Optional[List[int]]:
        """Reserve ``n`` pages for ``slot``; the lowest-numbered free
        pages, in heap order.  Returns None — state untouched — when the
        slot's group budget or the free list cannot cover the request
        (the caller DEFERS admission; nothing is ever partially
        granted).  A slot allocates once per residency."""
        if not 0 <= slot < self.n_slots:
            raise ValueError(f"slot {slot} out of range 0..{self.n_slots - 1}")
        if slot in self._owned:
            raise ValueError(f"slot {slot} already holds pages; "
                             f"free it before re-admitting")
        if not 1 <= n <= self.max_pages:
            raise ValueError(f"need 1..{self.max_pages} pages, got {n}")
        g = self.group_of(slot)
        if self.group_live(g) + n > self.group_budget(g) \
                or n > len(self._free):
            self.deferrals += 1
            return None
        pages = [heapq.heappop(self._free) for _ in range(n)]
        self._owned[slot] = pages
        self.hwm = max(self.hwm, self.live_pages)
        return list(pages)

    def free(self, slot: int) -> List[int]:
        """Return every page ``slot`` holds to the free list (retire /
        eviction path).  Freeing an empty slot is a no-op — retire paths
        race benignly with never-admitted slots."""
        pages = self._owned.pop(slot, [])
        for p in pages:
            heapq.heappush(self._free, p)
        return pages

    def pages_of(self, slot: int) -> List[int]:
        return list(self._owned.get(slot, []))

    # ----- external pressure (the chaos fabric's page_pressure fault) -----
    @property
    def seized_pages(self) -> int:
        return len(self._seized)

    def seize(self, n: int) -> List[int]:
        """Withhold up to ``n`` FREE pages from the pool (a co-tenant
        spike): the lowest-numbered free pages leave the free list but
        belong to no slot, so admissions defer against the shrunken
        pool while every live mapping is untouched.  -> the seized page
        ids (pass them back through :meth:`restore`)."""
        n = max(0, min(int(n), len(self._free)))
        taken = [heapq.heappop(self._free) for _ in range(n)]
        self._seized.extend(taken)
        if taken:
            self._seized_ever = True
        return taken

    def restore(self, pages: List[int]) -> None:
        """Return pages taken by :meth:`seize` to the free list."""
        for p in pages:
            self._seized.remove(p)
            heapq.heappush(self._free, p)

    def table(self, slot: int) -> np.ndarray:
        """The slot's dense page table: ``(max_pages,)`` int32, owned
        pages first (logical page j of the sequence lives in physical
        page ``table[j]``), sentinel-padded."""
        t = np.full((self.max_pages,), sentinel(self.total_pages),
                    np.int32)
        pages = self._owned.get(slot, [])
        t[:len(pages)] = pages
        return t

    # ----- observability --------------------------------------------------
    def publish_metrics(self, registry, **labels) -> None:
        """Publish this pool's counters into an ``obs.MetricsRegistry``
        under ``labels`` (callers pass ``axis="pages", worker=w`` — the
        paper-style per-resource counter convention, DESIGN.md §14)."""
        registry.counter("pages.deferrals", **labels).set_total(
            self.deferrals)
        registry.gauge("pages.hwm", **labels).set(self.hwm)
        registry.gauge("pages.live", **labels).set(self.live_pages)
        if self._seized or self._seized_ever:
            # fault-only series: fault-free runs keep today's exact
            # metric-series census (bit-identical exports)
            registry.gauge("pages.seized", **labels).set(
                len(self._seized))
        registry.gauge("pages.pressure", **labels).set(self.pressure())

    # ----- live migration -------------------------------------------------
    def regroup(self, level: int) -> "PagePool":
        """Re-key the budget groups to a new pages level IN PLACE (the
        ``SlotPool.regroup`` convention).  Pure accounting: no page
        moves, no mapping dropped — live allocations simply answer to
        the new group budgets from now on.  A shrink below what a group
        already holds only gates FUTURE allocs."""
        if not 1 <= int(level) <= 4:
            raise ValueError(f"pages level must be in 1..4, got {level!r}")
        self.level = int(level)
        return self
