"""Placement policies: which dispatch channel admits a new arrival.

A policy sees only fabric-visible state — per-channel queue depths, the
aggregate in-flight load of each channel's worker group, and (when the
recovery layer or a role topology restricts routing) the candidate
channel ids in ``eligible`` — and returns a channel id.  Policies are
deterministic (ties break toward the lowest channel id) so a trace
replays identically.

``eligible`` semantics: ``None`` means every channel is a candidate (the
fault-free fast path — byte-identical to the pre-recovery fabric).  A
list restricts the candidates; a policy that ignores it (``RoundRobin``
keeps its blind rotation, deliberately, so fault-mode goldens stay
stable) relies on the Router's positional remap fallback.

Note the interaction with the dispatch category: under the fully shared
plan there is one channel and placement is moot; under dedicated
per-worker channels placement is the ONLY load balancer; the k-way-shared
middle needs placement only across groups while members self-balance by
pulling.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.serve.fabric.traffic import Arrival


def _least_loaded(depths: List[int], loads: List[float],
                  eligible: Optional[List[int]]) -> int:
    """Lowest (queue depth + group load) over the candidate channels,
    ties to the lowest channel id."""
    cands = range(len(depths)) if eligible is None else eligible
    return min(cands, key=lambda q: (depths[q] + loads[q], q))


class PlacementPolicy:
    """Base: choose a channel for an arrival."""

    name = "base"

    def choose(self, arrival: Arrival, depths: List[int],
               loads: List[int],
               eligible: Optional[List[int]] = None) -> int:
        raise NotImplementedError


class RoundRobin(PlacementPolicy):
    """Blind rotation over channels (the no-information baseline).

    Ignores ``eligible`` on purpose: the rotation counter advances once
    per arrival regardless of fencing, and the Router's positional remap
    folds the pick into the live set — the behaviour every fault-mode
    golden was recorded against."""

    name = "round_robin"

    def __init__(self):
        self._next = 0

    def choose(self, arrival, depths, loads, eligible=None):
        q = self._next % len(depths)
        self._next += 1
        return q


class LeastLoaded(PlacementPolicy):
    """Channel whose queue + worker group carries the least work."""

    name = "least_loaded"

    def choose(self, arrival, depths, loads, eligible=None):
        return _least_loaded(depths, loads, eligible)


class SessionAffinity(PlacementPolicy):
    """FIRST-SEEN sticky mapping of a session (prefix-cache key) to one
    channel, so repeat turns land where their KV prefix is warm;
    sessionless arrivals fall back to least-loaded.

    A session is pinned on its first turn (least-loaded over the
    then-eligible channels, ties to the lowest id) and every later turn
    returns the pin verbatim.  The pin moves ONLY when its channel
    leaves the candidate set — fenced by the recovery layer, or dropped
    by a channel-count replan — and then exactly once, to a new sticky
    home.  Sessions whose channel survives are never reshuffled (the old
    ``session % len(depths)`` map rehashed every live session whenever
    the channel count or the fenced set changed — precisely when warm
    prefixes matter most)."""

    name = "session_affinity"

    def __init__(self):
        self._pins: Dict[int, int] = {}

    def choose(self, arrival, depths, loads, eligible=None):
        if arrival.session < 0:
            return _least_loaded(depths, loads, eligible)
        cands = set(range(len(depths)) if eligible is None else eligible)
        pin = self._pins.get(arrival.session)
        if pin is not None and pin in cands:
            return pin
        pin = _least_loaded(depths, loads, sorted(cands))
        self._pins[arrival.session] = pin
        return pin


POLICIES = {p.name: p for p in (RoundRobin, LeastLoaded, SessionAffinity)}


def make_policy(name: str) -> PlacementPolicy:
    try:
        return POLICIES[name]()
    except KeyError:
        raise ValueError(
            f"unknown placement {name!r}; one of {sorted(POLICIES)}")
