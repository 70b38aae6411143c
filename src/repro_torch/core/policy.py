"""mlx5's uUAR-to-QP assignment policy (paper Appendix B, Figure 16).

The port's own copy of ``repro.core.policy``, which ``EndpointModel``
builds on.

Models the ``mlx5_ib`` assignment of QPs and TDs to the statically and
dynamically allocated uUARs of a device context, including the
low/medium/high-latency categorization and the lock implications of each
mapping.  This is the policy the paper's resource-sharing levels (Fig. 4b)
fall out of, and the substrate for the endpoint categories in
``core/endpoints.py``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

from repro_torch.core import resources as R


class UUARClass(enum.Enum):
    HIGH_LATENCY = "high"      # uUAR0: atomic DoorBells only, no BlueFlame, no lock
    MEDIUM_LATENCY = "medium"  # multiple QPs, lock required for BlueFlame
    LOW_LATENCY = "low"        # single QP, lock disabled
    DYNAMIC = "dynamic"        # allocated by a TD; lock disabled (single-thread hint)


@dataclasses.dataclass
class UUAR:
    index: int                # global uUAR index within the CTX
    uar_page: int             # UAR page index within the CTX
    klass: UUARClass
    qps: list = dataclasses.field(default_factory=list)
    td: Optional[int] = None  # owning TD, for dynamic uUARs

    @property
    def lock_required(self) -> bool:
        """Lock on the uUAR for concurrent BlueFlame writes (Appendix B)."""
        if self.klass in (UUARClass.LOW_LATENCY, UUARClass.DYNAMIC,
                          UUARClass.HIGH_LATENCY):
            return False
        return True


@dataclasses.dataclass
class QPAssignment:
    qp: int
    uuar: UUAR
    td: Optional[int]
    qp_lock_disabled: bool    # paper's mlx5 optimization for TD-assigned QPs [8]


class MLX5Context:
    """A device context with the mlx5 uUAR-to-QP assignment policy.

    Parameters mirror the environment variables described in Appendix B:
    ``total_uuars`` = MLX5_TOTAL_UUARS, ``num_low_lat`` =
    MLX5_NUM_LOW_LAT_UUARS.  ``td_sharing`` is the paper's proposed
    ``sharing`` TD-creation attribute; ``disable_td_qp_lock`` is the paper's
    mlx5 optimization (pull request [8]) that elides the QP lock for
    TD-assigned QPs.
    """

    def __init__(self,
                 total_uuars: int = R.DEFAULT_TOTAL_UUARS,
                 num_low_lat: int = R.DEFAULT_NUM_LOW_LAT_UUARS,
                 td_sharing: R.TDSharing = R.TDSharing.SHARED_UAR,
                 disable_td_qp_lock: bool = True):
        if not 1 <= total_uuars:
            raise ValueError("total_uuars must be >= 1")
        if num_low_lat > total_uuars - 1:
            raise ValueError(
                "at most all-but-one static uUARs may be low latency")
        self.total_uuars = total_uuars
        self.num_low_lat = num_low_lat
        self.td_sharing = td_sharing
        self.disable_td_qp_lock = disable_td_qp_lock

        # Static uUARs.  uUAR0 is high latency; the *last* num_low_lat are
        # low latency (mlx5 default: uUAR12-15 of 16); the rest are medium.
        self.uuars: list[UUAR] = []
        for i in range(total_uuars):
            if i == 0:
                klass = UUARClass.HIGH_LATENCY
            elif i >= total_uuars - num_low_lat:
                klass = UUARClass.LOW_LATENCY
            else:
                klass = UUARClass.MEDIUM_LATENCY
            self.uuars.append(
                UUAR(index=i, uar_page=i // R.DATA_PATH_UUARS_PER_UAR,
                     klass=klass))
        self._static_uar_pages = (
            total_uuars + R.DATA_PATH_UUARS_PER_UAR - 1
        ) // R.DATA_PATH_UUARS_PER_UAR

        self._rr_medium = 0        # round-robin cursor over medium uUARs
        self._n_tds = 0
        self._n_qps = 0
        self.assignments: list[QPAssignment] = []

    # ----- TD handling -------------------------------------------------
    def create_td(self) -> int:
        """Create a thread domain; dynamically allocates UAR pages per the
        stock even/odd policy or the proposed ``sharing`` attribute."""
        td = self._n_tds
        self._n_tds += 1
        if self.td_sharing == R.TDSharing.MAX_INDEPENDENT or td % 2 == 0:
            # allocate a fresh UAR page holding two data-path uUARs
            page = self._static_uar_pages + R.dynamic_uars_for_tds(
                td, self.td_sharing)
            base = len(self.uuars)
            for j in range(R.DATA_PATH_UUARS_PER_UAR):
                self.uuars.append(UUAR(index=base + j, uar_page=page,
                                       klass=UUARClass.DYNAMIC))
        # bind the TD to its uUAR
        if self.td_sharing == R.TDSharing.MAX_INDEPENDENT:
            # first uUAR of the TD's own page; the second is wasted
            uuar = self.uuars[self._td_page_first_uuar(td)]
        else:
            # even TD -> first uUAR of the pair's page, odd TD -> second
            pair_first = self._td_page_first_uuar(td - (td % 2))
            uuar = self.uuars[pair_first + (td % 2)]
        uuar.td = td
        return td

    def _td_page_first_uuar(self, even_td: int) -> int:
        if self.td_sharing == R.TDSharing.MAX_INDEPENDENT:
            n_pages_before = even_td
        else:
            n_pages_before = even_td // 2
        return self.total_uuars + n_pages_before * R.DATA_PATH_UUARS_PER_UAR

    # ----- QP assignment (Appendix B, Fig. 16) -------------------------
    def create_qp(self, td: Optional[int] = None) -> QPAssignment:
        qp = self._n_qps
        self._n_qps += 1
        if td is not None:
            uuar = next(u for u in self.uuars if u.td == td)
            a = QPAssignment(qp=qp, uuar=uuar, td=td,
                             qp_lock_disabled=self.disable_td_qp_lock)
            uuar.qps.append(qp)
            self.assignments.append(a)
            return a

        low = [u for u in self.uuars if u.klass == UUARClass.LOW_LATENCY]
        medium = [u for u in self.uuars if u.klass == UUARClass.MEDIUM_LATENCY]
        free_low = next((u for u in low if not u.qps), None)
        if free_low is not None:
            uuar = free_low
        elif medium:
            uuar = medium[self._rr_medium % len(medium)]
            self._rr_medium += 1
        else:
            # all-but-one low latency: overflow QPs map to uUAR0 (high lat.)
            uuar = self.uuars[0]
        uuar.qps.append(qp)
        a = QPAssignment(qp=qp, uuar=uuar, td=None, qp_lock_disabled=False)
        self.assignments.append(a)
        return a

    # ----- accounting ---------------------------------------------------
    @property
    def uar_pages(self) -> int:
        return R.STATIC_UARS_PER_CTX + R.dynamic_uars_for_tds(
            self._n_tds, self.td_sharing)

    @property
    def data_path_uuars(self) -> int:
        # NOTE: allocated static uUARs are always the full 8 pages' worth,
        # even if MLX5_TOTAL_UUARS categorizes fewer (categorization does not
        # free pages).
        return (R.STATIC_UUARS_PER_CTX
                + R.dynamic_uars_for_tds(self._n_tds, self.td_sharing)
                * R.DATA_PATH_UUARS_PER_UAR)

    @property
    def uuars_used(self) -> int:
        return sum(1 for u in self.uuars if u.qps)

    def sharing_level_of(self, qp: int) -> int:
        """The thread-to-uUAR sharing level (1-4) of Figure 4(b) for a QP,
        assuming one independent thread drives each QP."""
        a = self.assignments[qp]
        if len(a.uuar.qps) > 1:
            return 3  # shared uUAR
        siblings = [u for u in self.uuars
                    if u.uar_page == a.uuar.uar_page and u is not a.uuar]
        if any(s.qps or s.td is not None for s in siblings):
            return 2  # shared UAR page
        return 1      # maximally independent
