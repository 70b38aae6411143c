"""Endpoint plans: per-resource sharing vectors, hints, and presets.

The port's own copy of ``repro.core.plan``: a ``SharingVector`` holds
independent Fig. 4b sharing levels for decode **slots**, dispatch
**channels**, compiled **execs** and KV **pages**; ``Hints`` + ``resolve``
are the deterministic planner mapping caller intent (latency target,
burstiness, session ordering, footprint and memory budgets) to a vector,
consulting a tuned plan repository first when one is given; an
``EndpointPlan`` is the resolved deployment ``serve.connect`` consumes.
``fit_budget`` is the one budget loop the planner and the live
controller (``core.adapt.Replanner``) clamp through.

Resolution is pure and deterministic: the same hints always produce the
same vector, the vector is monotone in the latency target (a tighter
target never raises any sharing level), and a footprint budget is
honored whenever any vector can honor it.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Optional, Tuple, Union

from repro_torch.core.endpoints import (Category, category_for_level,
                                        level_group_size)

#: The scheduling resource types, in the budget loop's bump order: when
#: a footprint budget forces more sharing, executables are shared first,
#: channels second, slots last.  ``pages`` is resolved on its own dial.
RESOURCES = ("execs", "channels", "slots")

#: All four sharing axes, what the paged-aware live controller
#: (``core.adapt.Replanner(paged=True)``) iterates.
PAGED_RESOURCES = RESOURCES + ("pages",)


def _check_level(name: str, level: int) -> int:
    if not isinstance(level, int) or isinstance(level, bool) \
            or not 1 <= level <= 4:
        raise ValueError(f"{name} sharing level must be an int in 1..4, "
                         f"got {level!r}")
    return level


@dataclasses.dataclass(frozen=True)
class SharingVector:
    """Independent Fig. 4b sharing levels per serving resource type.

    Attributes:
      slots: decode-slot admission groups (``serve.slots.SlotPool``).
      channels: dispatch-queue groups of a fleet.
      execs: compiled-executable / engine-state groups.
      pages: KV-cache page-pool groups (``serve.pages.PagePool``); level 1
        is a dedicated full-length budget per slot.
    """

    slots: int = 1
    channels: int = 1
    execs: int = 4
    pages: int = 1

    def __post_init__(self):
        for r in ("slots", "channels", "execs", "pages"):
            _check_level(r, getattr(self, r))

    @classmethod
    def diagonal(cls, level_or_category) -> "SharingVector":
        """The diagonal vector at one sharing level (pages stay at 1)."""
        level = (level_or_category.level
                 if isinstance(level_or_category, Category)
                 else level_or_category)
        _check_level("diagonal", level)
        return cls(slots=level, channels=level, execs=level)

    @property
    def is_diagonal(self) -> bool:
        return self.slots == self.channels == self.execs

    @property
    def label(self) -> str:
        """The compact ``s{slots}c{channels}e{execs}`` tag, with a ``p``
        suffix only when the page pool is shared."""
        base = f"s{self.slots}c{self.channels}e{self.execs}"
        return base if self.pages == 1 else f"{base}p{self.pages}"

    @property
    def category(self) -> Optional[Category]:
        """The canonical ``Category`` of a diagonal vector (None off the
        diagonal)."""
        return category_for_level(self.slots) if self.is_diagonal else None

    # ----- derived group structure --------------------------------------
    def group_size(self, resource: str, n: int) -> int:
        """Consumers per shared group for ``n`` units of ``resource``."""
        return level_group_size(getattr(self, resource), n)

    def exec_group_of(self, worker: int, n_workers: int) -> int:
        """Which exec group worker ``worker`` keys into: level 4 puts the
        whole fleet in group 0.  The engines of one group capture their
        horizon graphs into one memory pool (``serve.engine.ExecGroup``)."""
        return worker // self.group_size("execs", n_workers)

    # ----- footprint accounting -----------------------------------------
    def footprint(self, n_workers: int = 1, n_slots: int = 4) -> dict:
        """Fraction of the fully dedicated deployment's resources each
        type holds live: slot admission groups over slots, dispatch
        queues over workers, executable groups over workers (and page
        groups over slots when the pool is shared)."""
        n_workers = max(1, n_workers)
        n_slots = max(1, n_slots)
        slot_groups = math.ceil(n_slots / self.group_size("slots", n_slots))
        f = {
            "slots": slot_groups / n_slots,
            "channels": math.ceil(
                n_workers / self.group_size("channels", n_workers))
            / n_workers,
            "execs": math.ceil(
                n_workers / self.group_size("execs", n_workers))
            / n_workers,
        }
        if self.pages > 1:
            f["pages"] = math.ceil(
                n_slots / self.group_size("pages", n_slots)) / n_slots
        return f

    def footprint_score(self, n_workers: int = 1, n_slots: int = 4) -> float:
        """The mean of the per-resource fractions (what a footprint
        budget bounds)."""
        f = self.footprint(n_workers, n_slots)
        return sum(f.values()) / len(f)


@dataclasses.dataclass(frozen=True)
class Hints:
    """Caller intent, resolved by ``resolve`` into a ``SharingVector``.

    Attributes:
      latency_target_ms: p99-ish request latency the caller cares about;
        tighter targets resolve to more dedicated (lower) sharing levels.
        None = latency-indifferent.
      burstiness: 0..1; high burstiness (>= 0.5) bumps the channel level
        by one (shared dispatch channels pull stranded requests).
      session_ordering: requests of one session must start in order:
        resolves to session-affinity placement.
      footprint_budget: optional ceiling on
        ``SharingVector.footprint_score``; the planner raises sharing
        levels (execs, then channels, then slots) until the vector fits.
      compile_isolation: a private executable set per worker (exec
        level 1).
      memory_budget: optional ceiling on KV-cache reservation as a
        fraction of the fully dedicated (slot x max_len) footprint,
        resolved straight to a ``pages`` level (1.0 -> dedicated, <= 0.25
        -> one fleet-wide pool).
    """

    latency_target_ms: Optional[float] = None
    burstiness: float = 0.0
    session_ordering: bool = False
    footprint_budget: Optional[float] = None
    compile_isolation: bool = False
    memory_budget: Optional[float] = None

    def __post_init__(self):
        if not 0.0 <= self.burstiness <= 1.0:
            raise ValueError(f"burstiness must be in [0, 1], "
                             f"got {self.burstiness!r}")
        if self.latency_target_ms is not None \
                and self.latency_target_ms <= 0:
            raise ValueError("latency_target_ms must be positive")
        if self.footprint_budget is not None \
                and not 0.0 < self.footprint_budget:
            raise ValueError("footprint_budget must be positive")
        if self.memory_budget is not None \
                and not 0.0 < self.memory_budget <= 1.0:
            raise ValueError("memory_budget must be in (0, 1]")

    def resolve(self, *, n_workers: int = 1, n_slots: int = 4,
                repository=None,
                use_repository: bool = True) -> "SharingVector":
        """Module-level ``resolve`` as a method, the repository
        consultation included."""
        return resolve(self, n_workers=n_workers, n_slots=n_slots,
                       repository=repository,
                       use_repository=use_repository)


# latency target (ms) -> base sharing level: tighter targets buy more
# dedicated resources.  Monotone by construction.
_LATENCY_LEVELS: Tuple[Tuple[float, int], ...] = (
    (50.0, 1), (250.0, 2), (1000.0, 3))


def _latency_level(target_ms: Optional[float]) -> int:
    if target_ms is None:
        return 2          # the scalable middle: the paper's default pick
    for bound, level in _LATENCY_LEVELS:
        if target_ms < bound:
            return level
    return 4


# memory budget (fraction of dedicated KV reservation) -> pages level: a
# tighter budget never lowers the pages level.
_MEMORY_LEVELS: Tuple[Tuple[float, int], ...] = (
    (1.0, 1), (0.5, 2), (0.25, 3))


def _pages_level(memory_budget: Optional[float]) -> int:
    if memory_budget is None:
        return 1          # dedicated reservation: the contiguous cache
    for bound, level in _MEMORY_LEVELS:
        if memory_budget >= bound:
            return level
    return 4


def fit_budget(vec: SharingVector, budget: Optional[float], *,
               n_workers: int = 1, n_slots: int = 4) -> SharingVector:
    """Raise sharing levels (execs, then channels, then slots) until the
    vector's footprint fits ``budget`` or it is fully shared; the
    ``pages`` axis is carried through untouched."""
    if budget is None:
        return vec
    while vec.footprint_score(n_workers, n_slots) > budget:
        for r in RESOURCES:           # execs -> channels -> slots
            if getattr(vec, r) < 4:
                vec = dataclasses.replace(vec, **{r: getattr(vec, r) + 1})
                break
        else:
            break                     # fully shared: nothing left to give
    return vec


def resolve(hints: Hints, *, n_workers: int = 1, n_slots: int = 4,
            repository=None, use_repository: bool = True
            ) -> SharingVector:
    """Deterministically map intent to a ``SharingVector``.

    ``repository`` is an optional tuned-plan store: anything with
    ``resolve_hints(hints, n_workers=, n_slots=) ->
    Optional[SharingVector]``, canonically ``tune.PlanRepository``.  It
    is consulted first: a stored Pareto-frontier plan measured for this
    fleet size and satisfying the hints' constraints wins over the
    analytic mapping below.  A miss (or ``use_repository=False``) falls
    back to the analytic planner."""
    if repository is not None and use_repository:
        vec = repository.resolve_hints(hints, n_workers=n_workers,
                                       n_slots=n_slots)
        if vec is not None:
            return vec
    base = _latency_level(hints.latency_target_ms)
    channels = min(4, base + (1 if hints.burstiness >= 0.5 else 0))
    vec = SharingVector(slots=base, channels=channels,
                        execs=1 if hints.compile_isolation else 4,
                        pages=_pages_level(hints.memory_budget))
    return fit_budget(vec, hints.footprint_budget,
                      n_workers=n_workers, n_slots=n_slots)


Buckets = Union[None, str, Tuple[int, ...]]

_EXECUTORS = ("auto", "continuous", "wave", "fleet")

_ROLES_RE = re.compile(r"^\s*(\d+)\s*[Pp]\s*\+\s*(\d+)\s*[Dd]\s*$")


def parse_roles(spec) -> Optional[Tuple[int, int]]:
    """Parse a prefill/decode role split: ``"2P+2D"``, a
    ``(n_prefill, n_decode)`` pair, or None (co-located)."""
    if spec is None:
        return None
    if isinstance(spec, str):
        m = _ROLES_RE.match(spec)
        if m is None:
            raise ValueError(
                f"roles spec {spec!r} must look like '2P+2D'")
        split = (int(m.group(1)), int(m.group(2)))
    else:
        n_p, n_d = spec
        split = (int(n_p), int(n_d))
    if split[0] < 1 or split[1] < 1:
        raise ValueError("a role split needs at least one prefill and "
                         "one decode worker")
    return split


@dataclasses.dataclass(frozen=True)
class EndpointPlan:
    """A fully resolved serving deployment (``serve.connect`` consumes
    one and selects the executor).

    ``use_ragged_kernel`` is kept for plan compatibility.  On a CUDA
    device it has no effect: decode attention always runs the port's
    CUDA kernels.  On the CPU it picks the kernels' plain versions
    (True) or plain ``attention_decode`` (False), as in the reference."""

    vector: SharingVector = SharingVector()
    n_workers: int = 1
    n_slots: int = 4
    max_len: int = 512
    decode_horizon: int = 1
    prefill_buckets: Buckets = "auto"
    use_ragged_kernel: bool = False
    placement: str = "round_robin"
    executor: str = "auto"            # auto | continuous | wave | fleet
    preset: Optional[str] = None      # source Category value, if any
    page_size: int = 0                # tokens per page; 0 = auto
    page_budget: Optional[int] = None  # total pool pages; None = dedicated
    adaptive: bool = False
    adapt_window_ns: float = 250_000.0
    adapt_budget: Optional[float] = None
    roles: Optional[str] = None       # e.g. "2P+2D"; None = co-located

    def __post_init__(self):
        if isinstance(self.prefill_buckets, list):
            object.__setattr__(self, "prefill_buckets",
                               tuple(self.prefill_buckets))
        if self.n_workers < 1:
            raise ValueError("a plan needs at least one worker")
        if self.n_slots < 1:
            raise ValueError("a plan needs at least one slot")
        if self.decode_horizon < 1:
            raise ValueError("decode_horizon must be >= 1")
        if self.page_size < 0:
            raise ValueError("page_size must be >= 0 (0 = auto)")
        if self.page_size and self.max_len % self.page_size:
            raise ValueError(f"page_size must divide max_len "
                             f"({self.page_size} vs {self.max_len})")
        if self.page_budget is not None and self.page_budget < 1:
            raise ValueError("page_budget must be >= 1")
        if self.adapt_window_ns <= 0:
            raise ValueError("adapt_window_ns must be positive")
        if self.adaptive and self.executor == "wave":
            raise ValueError("the wave executor cannot re-plan live; "
                             "adaptive plans need continuous or fleet")
        if self.executor not in _EXECUTORS:
            raise ValueError(f"executor must be one of {_EXECUTORS}, "
                             f"got {self.executor!r}")
        if self.executor in ("wave", "continuous") and self.n_workers > 1:
            raise ValueError(f"the {self.executor} executor is "
                             f"single-worker; n_workers > 1 serves "
                             f"through the fleet")
        if self.executor == "fleet" and self.n_workers < 2:
            raise ValueError("the fleet executor needs n_workers >= 2")
        split = parse_roles(self.roles)
        if split is not None:
            n_p, n_d = split
            if n_p + n_d != self.n_workers:
                raise ValueError(
                    f"roles {n_p}P+{n_d}D need exactly {n_p + n_d} "
                    f"workers, plan has {self.n_workers}")
            if self.resolved_executor != "fleet":
                raise ValueError("a disaggregated plan serves through "
                                 "the fleet executor (n_workers >= 2)")

    @classmethod
    def from_category(cls, category: Category, **overrides) -> "EndpointPlan":
        """The named preset for a ``Category``: the diagonal vector at its
        level, remembering the category name."""
        return cls(vector=SharingVector.diagonal(category),
                   preset=category.value, **overrides)

    @classmethod
    def from_preset(cls, name: Union[str, Category],
                    **overrides) -> "EndpointPlan":
        category = name if isinstance(name, Category) else Category(name)
        return cls.from_category(category, **overrides)

    @classmethod
    def from_hints(cls, hints: Hints, *, repository=None,
                   use_repository: bool = True,
                   **overrides) -> "EndpointPlan":
        n_workers = overrides.get("n_workers", 1)
        n_slots = overrides.get("n_slots", 4)
        vec = resolve(hints, n_workers=n_workers, n_slots=n_slots,
                      repository=repository,
                      use_repository=use_repository)
        if hints.session_ordering:
            overrides.setdefault("placement", "session_affinity")
        if hints.footprint_budget is not None:
            # an adaptive run keeps honoring the ceiling the planner
            # resolved under (core.adapt.Replanner budget cap)
            overrides.setdefault("adapt_budget", hints.footprint_budget)
        return cls(vector=vec, **overrides)

    @property
    def category(self) -> Optional[Category]:
        """The remembered preset, else the canonical category of a
        diagonal vector, else None."""
        if self.preset is not None:
            return Category(self.preset)
        return self.vector.category

    @property
    def role_split(self) -> Optional[Tuple[int, int]]:
        """The parsed ``(n_prefill, n_decode)`` split, or None when the
        plan is co-located."""
        return parse_roles(self.roles)

    @property
    def paged(self) -> bool:
        """A shared page level or an explicit page size engages the paged
        KV-cache layout."""
        return self.vector.pages > 1 or self.page_size > 0

    @property
    def resolved_executor(self) -> str:
        if self.executor != "auto":
            return self.executor
        return "fleet" if self.n_workers > 1 else "continuous"

    def exec_group_of(self, worker: int) -> int:
        return self.vector.exec_group_of(worker, self.n_workers)

    def footprint(self) -> dict:
        return self.vector.footprint(self.n_workers, self.n_slots)

    def footprint_score(self) -> float:
        return self.vector.footprint_score(self.n_workers, self.n_slots)


#: The six paper categories as named presets: the diagonal of the plan
#: space.
PRESETS = {c.value: SharingVector.diagonal(c) for c in Category}


def as_plan(spec, **overrides) -> EndpointPlan:
    """Coerce anything plan-shaped into an ``EndpointPlan``:
    ``EndpointPlan`` (overrides applied) | ``Hints`` | ``SharingVector``
    | ``Category`` | preset name str | None (default plan)."""
    if spec is None:
        return EndpointPlan(**overrides)
    if isinstance(spec, EndpointPlan):
        return dataclasses.replace(spec, **overrides) if overrides else spec
    if isinstance(spec, Hints):
        return EndpointPlan.from_hints(spec, **overrides)
    if isinstance(spec, SharingVector):
        return EndpointPlan(vector=spec, **overrides)
    if isinstance(spec, Category):
        return EndpointPlan.from_category(spec, **overrides)
    if isinstance(spec, str):
        return EndpointPlan.from_preset(spec, **overrides)
    raise TypeError(f"cannot interpret {spec!r} as an EndpointPlan")


__all__ = [
    "RESOURCES", "PAGED_RESOURCES", "SharingVector", "Hints",
    "fit_budget", "resolve", "EndpointPlan", "PRESETS", "as_plan",
    "Buckets", "parse_roles",
]
