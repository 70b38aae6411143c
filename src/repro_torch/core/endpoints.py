"""Scalable communication endpoints: the paper's Section VI categories.

The port's own copy of ``repro.core.endpoints``: the six endpoint
categories with their dominant Fig. 4b sharing level, the level -> group
size mapping that sizes slot pools, page groups, dispatch queues and
sharing vectors, and ``EndpointModel``, the mlx5 resource accounting of
a category (``core/policy.py``, ``core/resources.py``) that prices a
fleet's dispatch plan (``core.channels.DispatchPlan.endpoint_usage``).
The sweep builders behind the paper's resource-sharing figures come with
the simulator slice.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional

from repro_torch.core import resources as R
from repro_torch.core.policy import MLX5Context


class Category(enum.Enum):
    """The six scalable-endpoint categories (paper Section VI)."""

    MPI_EVERYWHERE = "mpi_everywhere"    # CTX per thread, QP->low-lat uUAR
    TWO_X_DYNAMIC = "2x_dynamic"         # 1 CTX, 2T indep. TDs, use every other
    DYNAMIC = "dynamic"                  # 1 CTX, T independent TDs
    SHARED_DYNAMIC = "shared_dynamic"    # 1 CTX, T TDs, even/odd share UAR
    STATIC = "static"                    # 1 CTX, T QPs on static uUARs
    MPI_THREADS = "mpi_threads"          # 1 CTX, 1 QP shared by all threads

    @property
    def level(self) -> int:
        """Dominant thread-to-uUAR sharing level (Fig. 4b)."""
        return {
            Category.MPI_EVERYWHERE: 1,
            Category.TWO_X_DYNAMIC: 1,
            Category.DYNAMIC: 1,
            Category.SHARED_DYNAMIC: 2,
            Category.STATIC: 3,
            Category.MPI_THREADS: 4,
        }[self]


def level_group_size(level: int, n: int) -> int:
    """Sharing level (Fig. 4b) -> size of the group of ``n`` consumers that
    share one resource path: level 1 -> 1, level 2 -> 2, level 3 -> 4
    (the 4 static uUARs), level 4 -> all ``n``."""
    return min({1: 1, 2: 2, 3: 4, 4: n}[level], max(1, n))


def sharing_group_size(category: Category, n: int) -> int:
    """``level_group_size`` keyed by a category's dominant level."""
    return level_group_size(category.level, n)


# The canonical category at each sharing level: the diagonal of the
# per-resource plan space (``core.plan``).
CANONICAL_LEVEL_CATEGORY = {
    1: Category.MPI_EVERYWHERE,
    2: Category.SHARED_DYNAMIC,
    3: Category.STATIC,
    4: Category.MPI_THREADS,
}


def category_for_level(level: int) -> Category:
    """The canonical ``Category`` at a Fig. 4b sharing level."""
    try:
        return CANONICAL_LEVEL_CATEGORY[level]
    except KeyError:
        raise ValueError(f"sharing level must be 1..4, got {level!r}")


@dataclasses.dataclass(frozen=True)
class ThreadPath:
    """The communication path one thread drives."""

    thread: int
    qp: int                   # QP id (global across CTXs)
    ctx: int
    uuar_index: int           # uUAR index within its CTX
    uar_page: int             # UAR page within its CTX
    sharing_level: int        # 1-4 per Fig. 4(b)
    qp_lock: bool             # lock taken on ibv_post_send
    uuar_lock: bool           # lock for concurrent BlueFlame writes
    qp_shared_by: int = 1     # threads driving this QP
    cq: int = 0
    cq_shared_by: int = 1


@dataclasses.dataclass
class EndpointModel:
    """A concrete endpoint configuration for ``n_threads`` senders."""

    category: Optional[Category]
    n_threads: int
    paths: list
    usage: R.ResourceUsage
    label: str = ""

    def __post_init__(self):
        if not self.label:
            self.label = self.category.value if self.category else "custom"

    # ----- construction -------------------------------------------------
    @staticmethod
    def build(category: Category, n_threads: int,
              cq_share_ways: int = 1) -> "EndpointModel":
        """Build the endpoint model for a category.

        ``cq_share_ways`` optionally shares CQs between that many threads
        (the paper treats CQ sharing as orthogonal to the initiation
        interface — Section VI last note)."""
        t = n_threads
        paths: list[ThreadPath] = []

        if category == Category.MPI_EVERYWHERE:
            for i in range(t):
                ctx = MLX5Context()
                a = ctx.create_qp()            # -> a low-latency uUAR
                paths.append(ThreadPath(
                    thread=i, qp=i, ctx=i, uuar_index=a.uuar.index,
                    uar_page=a.uuar.uar_page, sharing_level=1,
                    qp_lock=True,              # lock exists though uncontended
                    uuar_lock=a.uuar.lock_required))
            usage = R.ResourceUsage(
                ctxs=t, uars=t * R.STATIC_UARS_PER_CTX,
                uuars=t * R.STATIC_UUARS_PER_CTX, uuars_used=t,
                qps=t, cqs=t, pds=t, mrs=t)

        elif category in (Category.TWO_X_DYNAMIC, Category.DYNAMIC,
                          Category.SHARED_DYNAMIC):
            sharing = (R.TDSharing.SHARED_UAR
                       if category == Category.SHARED_DYNAMIC
                       else R.TDSharing.MAX_INDEPENDENT)
            n_tds = 2 * t if category == Category.TWO_X_DYNAMIC else t
            ctx = MLX5Context(td_sharing=sharing)
            assignments = []
            for td_i in range(n_tds):
                td = ctx.create_td()
                assignments.append(ctx.create_qp(td=td))
            stride = 2 if category == Category.TWO_X_DYNAMIC else 1
            for i in range(t):
                a = assignments[i * stride]    # even TDs only for 2xDynamic
                paths.append(ThreadPath(
                    thread=i, qp=a.qp, ctx=0, uuar_index=a.uuar.index,
                    uar_page=a.uuar.uar_page,
                    sharing_level=ctx.sharing_level_of(a.qp),
                    qp_lock=not a.qp_lock_disabled,
                    uuar_lock=a.uuar.lock_required))
            usage = R.ResourceUsage(
                ctxs=1, uars=ctx.uar_pages, uuars=ctx.data_path_uuars,
                uuars_used=t,    # one uUAR actually driven per thread
                qps=n_tds, cqs=n_tds, pds=1, mrs=t, tds=n_tds,
                qps_active=t)

        elif category == Category.STATIC:
            ctx = MLX5Context()
            assignments = [ctx.create_qp() for _ in range(t)]
            for i, a in enumerate(assignments):
                paths.append(ThreadPath(
                    thread=i, qp=a.qp, ctx=0, uuar_index=a.uuar.index,
                    uar_page=a.uuar.uar_page,
                    sharing_level=ctx.sharing_level_of(a.qp),
                    qp_lock=True, uuar_lock=a.uuar.lock_required))
            usage = R.ResourceUsage(
                ctxs=1, uars=R.STATIC_UARS_PER_CTX,
                uuars=R.STATIC_UUARS_PER_CTX, uuars_used=ctx.uuars_used,
                qps=t, cqs=t, pds=1, mrs=t)

        elif category == Category.MPI_THREADS:
            ctx = MLX5Context()
            a = ctx.create_qp()
            for i in range(t):
                paths.append(ThreadPath(
                    thread=i, qp=0, ctx=0, uuar_index=a.uuar.index,
                    uar_page=a.uuar.uar_page, sharing_level=4,
                    qp_lock=True, uuar_lock=a.uuar.lock_required,
                    qp_shared_by=t, cq=0, cq_shared_by=t))
            usage = R.ResourceUsage(
                ctxs=1, uars=R.STATIC_UARS_PER_CTX,
                uuars=R.STATIC_UUARS_PER_CTX, uuars_used=1,
                qps=1, cqs=1, pds=1, mrs=1)
        else:  # pragma: no cover
            raise ValueError(category)

        if category != Category.MPI_THREADS:
            ways = max(1, min(cq_share_ways, t))
            n_cqs = math.ceil(t / ways)
            paths = [dataclasses.replace(
                p, cq=p.thread // ways,
                cq_shared_by=min(ways, t - (p.thread // ways) * ways))
                for p in paths]
            if ways > 1:
                usage = dataclasses.replace(usage, cqs=n_cqs)
        return EndpointModel(category=category, n_threads=t, paths=paths,
                             usage=usage)

    # ----- derived quantities -------------------------------------------
    def relative_usage(self) -> dict:
        """Hardware/memory usage relative to MPI everywhere — reproduces the
        paper's 31.25% / 18.75% / 12.5% / 6.25% figures."""
        base = EndpointModel.build(Category.MPI_EVERYWHERE, self.n_threads)
        return self.usage.scaled_by(base.usage)


def paper_categories() -> list:
    """Categories in the paper's performance order (Fig. 12)."""
    return [Category.TWO_X_DYNAMIC, Category.MPI_EVERYWHERE,
            Category.DYNAMIC, Category.SHARED_DYNAMIC, Category.STATIC,
            Category.MPI_THREADS]
