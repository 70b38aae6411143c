"""Slot pools: the paper's sharing levels applied to KV-cache slots.

The serving translation of Section VI (DESIGN.md §3): a decode slot is the
communication-resource analogue — a dedicated slot per request is MPI
everywhere (level-1 sharing: peak throughput, peak footprint), one shared
wave is MPI+threads (level-4: all requests serialized behind one refill
barrier), and k-way-shared slot groups are the scalable middle that
recovers dedicated-level throughput at a fraction of the scheduling
freedom.

Since the plan redesign (DESIGN.md §11) the pool is keyed by a bare
Fig. 4b sharing **level** — the ``slots`` component of a
``core.plan.SharingVector`` — so slot sharing can differ from channel or
executable sharing.  Constructing one from a ``Category`` still works
(deprecated): the category collapses to its dominant level.

A group admits new requests only when EVERY slot in it has drained — the
slot-pool analogue of threads contending on a shared uUAR: the wider the
sharing, the longer a finished request's slot idles behind its
neighbours' stragglers.

Since the paged KV cache (DESIGN.md §13) the pool governs *scheduling*
admission only: cache MEMORY shares on its own ``pages`` axis through
``serve.pages.PagePool``, so a slot that is admissible here may still
defer on page budget — the memory analogue of a drained group.

This is the port's copy of ``repro.serve.slots``.
"""

from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import List, Optional, Sequence

from repro_torch.core.endpoints import (Category, EndpointModel,
                                        category_for_level, level_group_size,
                                        sharing_group_size)


def group_size_for(category: Category, n_slots: int) -> int:
    """Sharing level (Fig. 4b) -> admission group size.

    level 1 (dedicated paths)      -> 1 slot/group: continuous batching
    level 2 (pairs share a UAR)    -> 2 slots/group
    level 3 (static uUAR sharing)  -> 4 slots/group (the 4 static uUARs)
    level 4 (one shared QP)        -> all slots: static wave batching

    Delegates to ``core.endpoints.level_group_size`` — the same mapping
    that sizes the fleet dispatch groups (``core.channels.DispatchPlan``).
    """
    return sharing_group_size(category, n_slots)


def _coerce_level(level, category, owner: str) -> int:
    """Shared Category->level shim: explicit ``category=`` (or a Category
    passed where a level belongs) warns and collapses to its level."""
    if category is not None and level is not None:
        raise ValueError(f"{owner}: pass either a sharing level or the "
                         f"deprecated category=, not both")
    if category is None and isinstance(level, Category):
        category, level = level, None
    if category is not None:
        warnings.warn(
            f"{owner}(category=...) is deprecated; pass the Fig. 4b "
            f"sharing level (category.level) or an EndpointPlan preset "
            f"(core.plan.EndpointPlan.from_preset({category.value!r}))",
            DeprecationWarning, stacklevel=3)
        level = category.level
    return 1 if level is None else int(level)


@dataclasses.dataclass(frozen=True, init=False)
class SlotPool:
    """Admission policy over ``n_slots`` decode slots at one sharing
    level (the ``slots`` axis of a ``core.plan.SharingVector``)."""

    level: int
    n_slots: int

    def __init__(self, level=None, n_slots: int = 4, *, category=None):
        object.__setattr__(self, "level",
                           _coerce_level(level, category, "SlotPool"))
        object.__setattr__(self, "n_slots", int(n_slots))
        if not 1 <= self.level <= 4:
            raise ValueError(f"sharing level must be 1..4, "
                             f"got {self.level}")

    @property
    def category(self) -> Category:
        """The canonical diagonal ``Category`` at this pool's level (the
        historical report key)."""
        return category_for_level(self.level)

    # cached_property writes straight into the instance __dict__, which
    # sidesteps the frozen dataclass' __setattr__ guard — the pool stays
    # immutable to callers while ``groups`` (walked every admissible()
    # call, i.e. every engine step) is computed once per pool instead of
    # rebuilt as a fresh list-of-ranges each time
    @functools.cached_property
    def group_size(self) -> int:
        return min(level_group_size(self.level, self.n_slots),
                   self.n_slots)

    @functools.cached_property
    def groups(self) -> List[range]:
        g = self.group_size
        return [range(lo, min(lo + g, self.n_slots))
                for lo in range(0, self.n_slots, g)]

    def regroup(self, level: int) -> "SlotPool":
        """Live migration (DESIGN.md §12): re-key this pool to a new
        sharing level WITHOUT evicting in-flight slots.

        The pool is pure admission policy — occupancy lives with the
        caller — so regrouping only changes which future admissions are
        legal: occupied slots keep decoding, and the next
        ``admissible()`` call sees the new group structure.  The frozen
        dataclass is mutated deliberately (the pool's identity must
        survive: engines and fabric workers hold references to it), and
        the memoized ``group_size``/``groups`` entries are dropped from
        ``__dict__`` — ``cached_property`` wrote them there, and without
        the invalidation every later ``admissible()`` would silently
        keep the OLD level's grouping (``tests/test_adapt.py`` pins
        this).  Returns self for chaining.
        """
        level = int(level)
        if not 1 <= level <= 4:
            raise ValueError(f"sharing level must be 1..4, got {level}")
        if level == self.level:
            return self
        object.__setattr__(self, "level", level)
        for memo in ("group_size", "groups"):
            self.__dict__.pop(memo, None)
        return self

    def admissible(self, occupied: Sequence[bool],
                   queue_len: Optional[int] = None) -> List[int]:
        """Slots that may admit a queued request now: free slots whose
        whole group has drained (for group_size 1 that is simply every
        free slot — true continuous batching).

        ``queue_len`` bounds the answer to the number of requests actually
        waiting: with an empty wait queue the scan returns [] immediately
        instead of walking (and re-walking, every engine step) groups
        nothing will be admitted to."""
        if queue_len is not None and queue_len <= 0:
            return []
        out: List[int] = []
        for grp in self.groups:
            if not any(occupied[i] for i in grp):
                out.extend(grp)
                if queue_len is not None and len(out) >= queue_len:
                    return out[:queue_len]
        return out

    def endpoint_usage(self) -> dict:
        """Relative hardware footprint of the matching endpoint model
        (Table 1 numbers) — reported next to throughput so the bench shows
        both sides of the paper's tradeoff."""
        return EndpointModel.build(
            self.category, self.n_slots).relative_usage()
