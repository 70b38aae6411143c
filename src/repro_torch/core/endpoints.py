"""Endpoint categories and the Fig. 4b sharing-level mapping.

The port's own copy of the part of ``repro.core.endpoints`` that the
serving path reads: the six categories with their dominant sharing level,
and the level -> group-size mapping that sizes slot pools, page groups and
sharing vectors.  The mlx5 resource model (``EndpointModel``) comes with
a later slice.
"""

from __future__ import annotations

import enum


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
