"""Channels: how producers and workers map onto shared queues.

The port's own copy of ``repro.core.channels``.  ``DispatchPlan`` maps a
worker fleet onto dispatch queues (the serving fabric's realization of
the endpoint categories, DESIGN.md §9): a dedicated queue per worker is
MPI everywhere, one global queue MPI+threads, k-way-shared queue groups
the scalable middle.  ``ChannelPlan`` / ``plan_for`` map logical
producers onto collective channels (the reference's training-side
reading of the categories, which ``comm.engine.GradSyncEngine``
consumes).
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core.endpoints import (Category, EndpointModel,
                                  category_for_level, level_group_size)

# Default number of channel "lanes", mirroring the paper's 16-thread socket.
DEFAULT_LANES = 16


@dataclasses.dataclass(frozen=True)
class ChannelPlan:
    """How logical producers map onto collective channels.

    Attributes:
      category: the scalable-endpoint category this plan realizes.
      n_channels: independent collective streams (QP/uUAR analogue).
      per_producer: one channel per producer (ignore n_channels).
      double_buffered: 2xDynamic — two buffers per channel so bucket i+1
        packing overlaps bucket i's collective.
      serialize: shared-QP analogue — producers funnel into ONE fused
        collective (single dependency chain, no overlap).
      sync_stride: unsignaled-completion analogue — a dependency barrier is
        materialized only every ``sync_stride`` buckets.
      bucket_pad_bytes: BUF-alignment lesson (Section V-A): bucket segments
        are padded to this boundary so producers never share a lane tile.
    """

    category: Category
    n_channels: int
    per_producer: bool = False
    double_buffered: bool = False
    serialize: bool = False
    sync_stride: int = 1
    bucket_pad_bytes: int = 128

    def n_buckets(self, n_producers: int) -> int:
        if self.per_producer:
            return n_producers
        if self.serialize:
            return 1
        return max(1, min(self.n_channels, n_producers))

    def staging_buffers(self, n_producers: int) -> int:
        """Channel staging buffers held live (the uUAR-usage analogue)."""
        k = self.n_buckets(n_producers)
        return 2 * k if self.double_buffered else k


@dataclasses.dataclass(frozen=True)
class DispatchPlan:
    """How a worker fleet maps onto dispatch queues (the serving-fabric
    realization of the endpoint categories, DESIGN.md §9).

    A dispatch queue is the fleet-level analogue of a communication
    endpoint: a dedicated queue per worker is MPI everywhere (peak
    independence, peak footprint), one global queue funnelling every
    worker is MPI+threads, and k-way-shared queue groups — ``group_size``
    workers draining one queue — are the scalable middle.  Since the plan
    redesign (DESIGN.md §11) the plan is keyed by a bare Fig. 4b sharing
    **level** — the ``channels`` axis of a ``core.plan.SharingVector`` —
    via the same ``level_group_size`` that sizes the slot pools, so the
    fleet, the pools, and the endpoint model stay one abstraction; a
    ``Category`` is still accepted and collapses to its level.
    """

    level: object                     # int sharing level (Category ok)
    n_workers: int
    # the exact category the plan was built from, so endpoint_usage()
    # keeps pricing e.g. DYNAMIC's own Table-1 numbers, not the
    # canonical level-1 category's; excluded from equality (plans
    # compare by their sharing structure) but a real field so
    # dataclasses.replace preserves it
    source_category: object = dataclasses.field(
        default=None, compare=False, repr=False)

    def __post_init__(self):
        if isinstance(self.level, Category):
            object.__setattr__(self, "source_category", self.level)
            object.__setattr__(self, "level", self.level.level)
        if not 1 <= self.level <= 4:
            raise ValueError(f"sharing level must be 1..4, "
                             f"got {self.level!r}")
        if self.n_workers < 1:
            raise ValueError("a fleet needs at least one worker")

    @property
    def category(self) -> Category:
        """The category this plan was built from, else the canonical
        diagonal ``Category`` at its level."""
        return self.source_category or category_for_level(self.level)

    @property
    def group_size(self) -> int:
        return level_group_size(self.level, self.n_workers)

    @property
    def n_queues(self) -> int:
        return math.ceil(self.n_workers / self.group_size)

    def queue_of(self, worker: int) -> int:
        """Dispatch queue the given worker drains."""
        return worker // self.group_size

    def workers_of(self, queue: int) -> range:
        """Workers draining the given dispatch queue."""
        lo = queue * self.group_size
        return range(lo, min(lo + self.group_size, self.n_workers))

    def endpoint_usage(self) -> dict:
        """Aggregate endpoint footprint of the fleet relative to a
        dedicated-path-per-worker deployment (Table 1 numbers), reported
        next to throughput so the fabric bench shows both sides of the
        paper's tradeoff."""
        return EndpointModel.build(
            self.category, self.n_workers).relative_usage()


def plan_for(category: Category, *, lanes: int = DEFAULT_LANES,
             sync_stride: int = 1) -> ChannelPlan:
    """The six endpoint categories as channel plans (Section VI adapted)."""
    if category == Category.MPI_EVERYWHERE:
        # dedicated path per producer: max independence, max resource usage
        return ChannelPlan(category, n_channels=0, per_producer=True,
                           sync_stride=sync_stride)
    if category == Category.TWO_X_DYNAMIC:
        # k lanes, double-buffered: packing of bucket i+1 overlaps the
        # collective of bucket i — the paper's best performer
        return ChannelPlan(category, n_channels=lanes, double_buffered=True,
                           sync_stride=sync_stride)
    if category == Category.DYNAMIC:
        return ChannelPlan(category, n_channels=lanes,
                           sync_stride=sync_stride)
    if category == Category.SHARED_DYNAMIC:
        return ChannelPlan(category, n_channels=max(1, lanes // 2),
                           sync_stride=sync_stride)
    if category == Category.STATIC:
        return ChannelPlan(category, n_channels=max(1, lanes // 4),
                           sync_stride=sync_stride)
    if category == Category.MPI_THREADS:
        return ChannelPlan(category, n_channels=1, serialize=True,
                           sync_stride=sync_stride)
    raise ValueError(category)
