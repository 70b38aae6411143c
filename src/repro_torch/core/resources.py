"""InfiniBand/mlx5 resource and memory accounting from the paper.

The port's own copy of the part of ``repro.core.resources`` that
``EndpointModel`` reads to price a fleet's dispatch plan (its Table-1
usage relative to MPI everywhere): the ConnectX-4 / mlx5 constants
(Sections II-A, III, App. A/B), the Table I object sizes, the proposed
TD ``sharing`` attribute and ``ResourceUsage``.

Terminology
-----------
CTX   device context; statically allocates 8 UAR pages (16 data-path
      uUARs) on creation.
UAR   user-access-region page; its first 2 uUARs are data-path uUARs.
uUAR  micro-UAR: the doorbell/BlueFlame slice a QP is bound to.
TD    thread domain (stock mlx5: even/odd TD pairs share a UAR page;
      patched ``sharing=1``: one page per TD).
QP / CQ / PD / MR   queue pair, completion queue, protection domain,
      memory region.
"""

from __future__ import annotations

import dataclasses
import enum

# --- Hardware constants (ConnectX-4 / mlx5, Sections II-A, III, App. A/B) ---
STATIC_UARS_PER_CTX = 8          # UAR pages statically allocated per CTX
DATA_PATH_UUARS_PER_UAR = 2      # first two uUARs of a UAR page are data-path
STATIC_UUARS_PER_CTX = STATIC_UARS_PER_CTX * DATA_PATH_UUARS_PER_UAR  # 16

# mlx5 default static-uUAR categorization (Appendix B).
DEFAULT_TOTAL_UUARS = STATIC_UUARS_PER_CTX          # MLX5_TOTAL_UUARS
DEFAULT_NUM_LOW_LAT_UUARS = 4                       # MLX5_NUM_LOW_LAT_UUARS

# --- Table I: bytes used by mlx5 Verbs resources ---
CTX_BYTES = 256 * 1024
PD_BYTES = 144
MR_BYTES = 144
QP_BYTES = 80 * 1024
CQ_BYTES = 9 * 1024


class TDSharing(enum.IntEnum):
    """Proposed ``sharing`` attribute for TD creation (Section V-B):
    1 = maximally independent (one UAR page per TD), 2 = stock mlx5
    behaviour (even/odd TD pairs share one UAR page)."""

    MAX_INDEPENDENT = 1
    SHARED_UAR = 2


@dataclasses.dataclass(frozen=True)
class ResourceUsage:
    """Communication-resource usage of an endpoint configuration."""

    ctxs: int
    uars: int                 # UAR pages allocated (static + dynamic)
    uuars: int                # data-path uUARs allocated
    uuars_used: int           # uUARs actually driven by some QP
    qps: int
    cqs: int
    pds: int
    mrs: int
    tds: int = 0
    qps_active: int = 0       # QPs actually driven (2xDynamic uses half)

    def __post_init__(self):
        if self.qps_active == 0:
            object.__setattr__(self, "qps_active", self.qps)

    @property
    def memory_bytes(self) -> int:
        """Total allocated memory (Table I accounting), all objects."""
        return (self.ctxs * CTX_BYTES + self.qps * QP_BYTES
                + self.cqs * CQ_BYTES + self.pds * PD_BYTES
                + self.mrs * MR_BYTES)

    def scaled_by(self, other: "ResourceUsage") -> dict:
        """Resource usage of ``self`` relative to ``other`` (e.g. vs
        MPI-everywhere), as fractions."""
        def frac(a, b):
            return a / b if b else float("inf")
        return {
            "uuars": frac(self.uuars, other.uuars),
            "uars": frac(self.uars, other.uars),
            "memory": frac(self.memory_bytes, other.memory_bytes),
        }


def dynamic_uars_for_tds(n_tds: int, sharing: TDSharing) -> int:
    """UAR pages dynamically allocated for ``n_tds`` thread domains."""
    if sharing == TDSharing.MAX_INDEPENDENT:
        return n_tds
    # stock mlx5: every even TD allocates a page; even/odd pairs share it.
    return (n_tds + 1) // 2
