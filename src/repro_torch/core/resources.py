"""Exact InfiniBand/mlx5 resource and memory accounting from the paper (the
port's own copy of ``repro.core.resources``).

Every constant below is taken from the paper (Sections II-A, III, V-B,
Appendix A/B) and its Table I. The accounting here is pure arithmetic and is
asserted against every number the paper states (tests/test_endpoints.py).

Terminology
-----------
CTX   device context — container of all IB resources; statically allocates
      8 UAR pages (= 16 data-path uUARs) on creation.
UAR   user-access-region page (4 KB) of the NIC address space; holds 4 uUARs
      of which the first 2 are data-path uUARs (the last 2 are used by the
      NIC itself — Appendix A).
uUAR  micro-UAR: the doorbell/BlueFlame slice a QP is bound to.
TD    thread domain: single-threaded-access hint; dynamically allocates UAR
      pages (stock mlx5: one page per *even* TD, even/odd pairs share the
      page; patched `sharing=1`: one page per TD, second uUAR wasted).
QP    queue pair (transmit queue).   CQ  completion queue.
PD    protection domain.             MR  memory region.
"""

from __future__ import annotations

import dataclasses
import enum

# --- Hardware constants (ConnectX-4 / mlx5, Sections II-A, III, App. A/B) ---
STATIC_UARS_PER_CTX = 8          # UAR pages statically allocated per CTX
DATA_PATH_UUARS_PER_UAR = 2      # first two uUARs of a UAR page are data-path
STATIC_UUARS_PER_CTX = STATIC_UARS_PER_CTX * DATA_PATH_UUARS_PER_UAR  # 16
UUARS_PER_UAR_TOTAL = 4          # incl. the two NIC-internal ones (App. A)
UAR_PAGE_BYTES = 4096
MAX_UAR_PAGES_NIC = 8192         # ConnectX-4 hardware limit (Section III)
MAX_DYNAMIC_UARS_PER_CTX = 512   # mlx5 limit (Appendix B)
# half of the dynamic UARs when each independent TD burns a full page:
MAX_INDEPENDENT_PATHS_PER_CTX = MAX_DYNAMIC_UARS_PER_CTX // 2  # 256 (Sec V-B)
MAX_INLINE_BYTES = 60            # max inlinable message size (Section V-A)

# mlx5 default static-uUAR categorization (Appendix B).
DEFAULT_TOTAL_UUARS = STATIC_UUARS_PER_CTX          # MLX5_TOTAL_UUARS
DEFAULT_NUM_LOW_LAT_UUARS = 4                       # MLX5_NUM_LOW_LAT_UUARS

# --- Table I: bytes used by mlx5 Verbs resources ---
CTX_BYTES = 256 * 1024
PD_BYTES = 144
MR_BYTES = 144
QP_BYTES = 80 * 1024
CQ_BYTES = 9 * 1024
# One endpoint = CTX + PD + MR + QP + CQ.  The paper's prose says "354 KB"
# but Table I's own total line reads 345K (256K+80K+9K+144+144) and the CTX
# share it quotes (74.2%) matches 345K — we use Table I.
ENDPOINT_BYTES = CTX_BYTES + PD_BYTES + MR_BYTES + QP_BYTES + CQ_BYTES


class TDSharing(enum.IntEnum):
    """Proposed ``sharing`` attribute for TD creation (Section V-B).

    The paper extends ``struct ibv_td_init_attr`` with a ``sharing`` level:
    1 = maximally independent (one UAR page per TD, second uUAR wasted),
    2 = stock mlx5 behaviour (even/odd TD pairs share one UAR page).
    """

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
    def uuars_wasted(self) -> int:
        return self.uuars - self.uuars_used

    @property
    def waste_fraction(self) -> float:
        """Fraction of allocated data-path uUARs that no QP drives."""
        return self.uuars_wasted / self.uuars if self.uuars else 0.0

    @property
    def memory_bytes(self) -> int:
        """Total allocated memory (Table I accounting), all objects."""
        return (self.ctxs * CTX_BYTES + self.qps * QP_BYTES
                + self.cqs * CQ_BYTES + self.pds * PD_BYTES
                + self.mrs * MR_BYTES)

    @property
    def memory_bytes_active(self) -> int:
        """Memory counting only *driven* QPs/CQs (the paper's Fig-12 prose
        accounting: 2xDynamic is quoted at 1.64 MB = 1 CTX + 16 QP/CQ)."""
        return (self.ctxs * CTX_BYTES + self.qps_active * (QP_BYTES + CQ_BYTES)
                + self.pds * PD_BYTES + self.mrs * MR_BYTES)

    @property
    def sw_memory_bytes(self) -> int:
        """QP+CQ circular-buffer memory only (the paper's Fig-3 right axis:
        89 KB/thread -> 1.39 MB at 16 threads)."""
        return self.qps * QP_BYTES + self.cqs * CQ_BYTES

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


def naive_td_per_ctx_usage(n_threads: int) -> ResourceUsage:
    """Section III / Figure 3 naive endpoints: one CTX per thread, each with
    one TD-assigned QP.  Each CTX = 8 static UARs + 1 dynamic (TD) = 9 UARs,
    18 data-path uUARs, of which exactly 1 is used -> ~94% waste."""
    uars = n_threads * (STATIC_UARS_PER_CTX + 1)
    uuars = n_threads * (STATIC_UUARS_PER_CTX + DATA_PATH_UUARS_PER_UAR)
    return ResourceUsage(
        ctxs=n_threads, uars=uars, uuars=uuars, uuars_used=n_threads,
        qps=n_threads, cqs=n_threads, pds=n_threads, mrs=n_threads,
        tds=n_threads)


def dynamic_uars_for_tds(n_tds: int, sharing: TDSharing) -> int:
    """UAR pages dynamically allocated for ``n_tds`` thread domains."""
    if sharing == TDSharing.MAX_INDEPENDENT:
        return n_tds
    # stock mlx5: every even TD allocates a page; even/odd pairs share it.
    return (n_tds + 1) // 2
