"""Scalable communication endpoints: the paper's Section VI categories.

The port's own copy of ``repro.core.endpoints``: the six endpoint
categories with their dominant Fig. 4b sharing level, the level -> group
size mapping that sizes slot pools, page groups, dispatch queues and
sharing vectors, and ``EndpointModel``, the mlx5 resource accounting of
a category (``core/policy.py``, ``core/resources.py``) that prices a
fleet's dispatch plan (``core.channels.DispatchPlan.endpoint_usage``).
The sweep builders (``build_ctx_shared``, ``build_qp_shared``,
``build_hybrid``, ``build_cq_shared``) make the models behind the paper's
resource-sharing figures, which the simulator (``core.ibsim``) runs.
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


# ---------------------------------------------------------------------------
# Sweep builders for the Section-V resource-sharing analysis (Figs 5-11).
# ---------------------------------------------------------------------------

def build_ctx_shared(n_threads: int, ctx_ways: int, *,
                     td_sharing: R.TDSharing = R.TDSharing.MAX_INDEPENDENT,
                     two_x: bool = False,
                     cq_share_ways: int = 1,
                     label: str = "") -> EndpointModel:
    """x-way CTX sharing (Fig. 7): groups of ``ctx_ways`` threads share one
    CTX, each thread driving its own TD-assigned QP.  ``two_x`` creates twice
    as many TDs and uses the even ones ("2xQPs"); ``td_sharing`` selects the
    proposed sharing attribute (1) or the stock even/odd policy (2)."""
    if n_threads % ctx_ways:
        raise ValueError("ctx_ways must divide n_threads")
    n_ctxs = n_threads // ctx_ways
    paths: list[ThreadPath] = []
    total_uars = total_uuars = 0
    tds_per_ctx = (2 if two_x else 1) * ctx_ways
    stride = 2 if two_x else 1
    for ctx_i in range(n_ctxs):
        ctx = MLX5Context(td_sharing=td_sharing)
        assignments = []
        for _ in range(tds_per_ctx):
            td = ctx.create_td()
            assignments.append(ctx.create_qp(td=td))
        for j in range(ctx_ways):
            a = assignments[j * stride]
            thread = ctx_i * ctx_ways + j
            paths.append(ThreadPath(
                thread=thread, qp=ctx_i * tds_per_ctx + a.qp, ctx=ctx_i,
                uuar_index=a.uuar.index, uar_page=a.uuar.uar_page,
                sharing_level=ctx.sharing_level_of(a.qp),
                qp_lock=not a.qp_lock_disabled,
                uuar_lock=a.uuar.lock_required, cq=j))
        total_uars += ctx.uar_pages
        total_uuars += ctx.data_path_uuars
    usage = R.ResourceUsage(
        ctxs=n_ctxs, uars=total_uars, uuars=total_uuars,
        uuars_used=n_threads, qps=n_ctxs * tds_per_ctx,
        cqs=n_ctxs * tds_per_ctx, pds=n_ctxs, mrs=n_threads,
        tds=n_ctxs * tds_per_ctx, qps_active=n_threads)
    model = EndpointModel(category=None, n_threads=n_threads, paths=paths,
                          usage=usage,
                          label=label or f"ctx_shared_{ctx_ways}way")
    if cq_share_ways > 1:
        model = _share_cqs(model, cq_share_ways)
    return model


def build_qp_shared(n_threads: int, qp_ways: int,
                    label: str = "") -> EndpointModel:
    """x-way QP sharing (Fig. 11): groups of ``qp_ways`` threads share one
    QP (and its CQ).  Unshared case (ways=1) uses independent TDs; shared
    QPs cannot live in a TD, so they fall on the static uUARs per the
    assignment policy."""
    if n_threads % qp_ways:
        raise ValueError("qp_ways must divide n_threads")
    if qp_ways == 1:
        m = build_ctx_shared(n_threads, n_threads)
        return dataclasses.replace(m, label=label or "qp_shared_1way")
    n_qps = n_threads // qp_ways
    ctx = MLX5Context()
    assignments = [ctx.create_qp() for _ in range(n_qps)]
    paths = []
    for i in range(n_threads):
        a = assignments[i // qp_ways]
        paths.append(ThreadPath(
            thread=i, qp=a.qp, ctx=0, uuar_index=a.uuar.index,
            uar_page=a.uuar.uar_page, sharing_level=4,
            qp_lock=True, uuar_lock=a.uuar.lock_required,
            qp_shared_by=qp_ways, cq=a.qp, cq_shared_by=qp_ways))
    usage = R.ResourceUsage(
        ctxs=1, uars=R.STATIC_UARS_PER_CTX, uuars=R.STATIC_UUARS_PER_CTX,
        uuars_used=ctx.uuars_used, qps=n_qps, cqs=n_qps, pds=1,
        mrs=n_threads)
    return EndpointModel(category=None, n_threads=n_threads, paths=paths,
                         usage=usage, label=label or f"qp_shared_{qp_ways}way")


def build_hybrid(n_ranks: int, threads_per_rank: int,
                 category: Category) -> EndpointModel:
    """Hybrid MPI+threads process/thread split (paper Section VII stencil):
    ``n_ranks`` independent processes (own CTX sets), each with
    ``threads_per_rank`` threads using ``category`` endpoints internally."""
    per_rank = [EndpointModel.build(category, threads_per_rank)
                for _ in range(n_ranks)]
    paths: list[ThreadPath] = []
    usage = None
    for r, m in enumerate(per_rank):
        ctx_off = max((p.ctx for p in paths), default=-1) + 1
        qp_off = max((p.qp for p in paths), default=-1) + 1
        for p in m.paths:
            paths.append(dataclasses.replace(
                p, thread=r * threads_per_rank + p.thread,
                ctx=p.ctx + ctx_off, qp=p.qp + qp_off))
        u = m.usage
        if usage is None:
            usage = u
        else:
            usage = R.ResourceUsage(
                ctxs=usage.ctxs + u.ctxs, uars=usage.uars + u.uars,
                uuars=usage.uuars + u.uuars,
                uuars_used=usage.uuars_used + u.uuars_used,
                qps=usage.qps + u.qps, cqs=usage.cqs + u.cqs,
                pds=usage.pds + u.pds, mrs=usage.mrs + u.mrs,
                tds=usage.tds + u.tds,
                qps_active=usage.qps_active + u.qps_active)
    return EndpointModel(
        category=category, n_threads=n_ranks * threads_per_rank,
        paths=paths, usage=usage,
        label=f"{category.value}_{n_ranks}x{threads_per_rank}")


def _share_cqs(model: EndpointModel, ways: int) -> EndpointModel:
    """Re-map CQs so groups of ``ways`` threads share one CQ (within their
    CTX), leaving the initiation interface untouched (Fig. 9)."""
    paths = [dataclasses.replace(
        p, cq=p.thread // ways, cq_shared_by=ways) for p in model.paths]
    usage = dataclasses.replace(
        model.usage, cqs=math.ceil(model.n_threads / ways))
    return dataclasses.replace(model, paths=paths, usage=usage,
                               label=f"{model.label}_cq{ways}way")


def build_cq_shared(n_threads: int, cq_ways: int) -> EndpointModel:
    """x-way CQ sharing over maximally independent initiation paths."""
    return _share_cqs(build_ctx_shared(n_threads, n_threads), cq_ways)
