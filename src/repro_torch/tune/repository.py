"""Persisted plan repository: tuned Pareto frontiers in SQLite
(the port's own copy of ``repro.tune.repository``).

The tuner's output has to outlive the process that paid for it — the
whole point of searching offline is that ``serve.connect`` can later
answer a ``Hints`` query from *measured* plans instead of the analytic
planner's priors.  The repository is one SQLite file (stdlib
``sqlite3``, no dependencies) keyed by **(traffic profile, model
config, fleet size)**: a stored answer is only ever returned for the
workload shape it was actually tuned against.

Schema (``plans`` table; DESIGN.md §16):

    traffic, model, n_workers, n_slots, rank   -- the key; rank is the
                                                  plan's position in the
                                                  deterministic frontier
                                                  order (0 = highest
                                                  throughput)
    plan                                       -- canonical JSON of the
                                                  full EndpointPlan
    tok_per_s, p99_ms, footprint               -- the objective columns
                                                  queries filter/rank on
    measurement                                -- canonical JSON of the
                                                  whole Measurement
                                                  (lossless round-trip)

Reproducibility contract: writing the same frontiers in the same order
into a FRESH file produces byte-identical SQLite files — no timestamps,
no randomness, no autoincrement rowids beyond the deterministic insert
order — so a committed ``repo.sqlite`` can be regression-gated like any
other golden artifact.

Consumers (both duck-typed — ``core`` never imports ``tune``):

* ``core.plan.resolve(hints, repository=...)`` calls
  ``resolve_hints``: the best stored frontier plan satisfying the
  hints' constraints, None on miss (analytic fallback);
* ``core.adapt.Replanner(repository=...)`` calls ``frontier_vectors``
  and jumps to the nearest stored frontier plan in the direction its
  hysteresis pressure fired, instead of stepping one axis at a time.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sqlite3
from typing import List, Optional, Tuple

from repro_torch.core.plan import EndpointPlan, SharingVector
from repro_torch.tune.evaluate import Measurement
from repro_torch.tune.pareto import FrontierPoint

SCHEMA_VERSION = 1

_SCHEMA = """\
CREATE TABLE IF NOT EXISTS meta (
    key TEXT PRIMARY KEY,
    value TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS plans (
    traffic   TEXT    NOT NULL,
    model     TEXT    NOT NULL,
    n_workers INTEGER NOT NULL,
    n_slots   INTEGER NOT NULL,
    rank      INTEGER NOT NULL,
    plan      TEXT    NOT NULL,
    tok_per_s REAL    NOT NULL,
    p99_ms    REAL    NOT NULL,
    footprint REAL    NOT NULL,
    measurement TEXT  NOT NULL,
    PRIMARY KEY (traffic, model, n_workers, n_slots, rank)
);
"""


# ----- canonical (de)serialization -----------------------------------------

def plan_to_json(plan: EndpointPlan) -> str:
    """Canonical JSON for an ``EndpointPlan``: sorted keys, no
    whitespace — one byte sequence per plan, the repository's
    reproducibility unit."""
    d = dataclasses.asdict(plan)
    if isinstance(d.get("prefill_buckets"), tuple):
        d["prefill_buckets"] = list(d["prefill_buckets"])
    return json.dumps(d, sort_keys=True, separators=(",", ":"))


def plan_from_json(text: str) -> EndpointPlan:
    d = json.loads(text)
    vec = SharingVector(**d.pop("vector"))
    if isinstance(d.get("prefill_buckets"), list):
        d["prefill_buckets"] = tuple(d["prefill_buckets"])
    return EndpointPlan(vector=vec, **d)


def measurement_to_json(m: Measurement) -> str:
    return json.dumps(dataclasses.asdict(m), sort_keys=True,
                      separators=(",", ":"))


def measurement_from_json(text: str) -> Measurement:
    return Measurement(**json.loads(text))


@dataclasses.dataclass(frozen=True)
class StoredPlan:
    """One repository row, fully rehydrated."""

    traffic: str
    model: str
    n_workers: int
    n_slots: int
    rank: int
    plan: EndpointPlan
    measurement: Measurement


class PlanRepository:
    """The SQLite-backed frontier store.  ``path`` may be a filesystem
    path or ``":memory:"``; ``fresh=True`` truncates an existing file
    first (the byte-reproducible write mode the tuner CLI uses)."""

    def __init__(self, path: str = ":memory:", *, fresh: bool = False):
        if fresh and path != ":memory:" and os.path.exists(path):
            os.remove(path)
        self.path = path
        self._con = sqlite3.connect(path)
        self._con.executescript(_SCHEMA)
        self._con.execute(
            "INSERT OR REPLACE INTO meta (key, value) VALUES (?, ?)",
            ("schema_version", str(SCHEMA_VERSION)))
        self._con.commit()

    # ----- lifecycle ------------------------------------------------------
    def close(self) -> None:
        self._con.close()

    def __enter__(self) -> "PlanRepository":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ----- writes ---------------------------------------------------------
    def store_front(self, front: List[FrontierPoint], *, traffic: str,
                    model: str = "sim") -> int:
        """Persist one tuned frontier under ``(traffic, model)``.  Each
        plan files under ITS OWN fleet size (a structural space's front
        may mix widths); within a fleet-size group, ``rank`` is the
        plan's position in the frontier's deterministic order.  The
        affected groups are replaced wholesale — re-running the same
        tune is idempotent.  -> rows written."""
        groups = sorted({(p.plan.n_workers, p.plan.n_slots)
                         for p in front})
        cur = self._con.cursor()
        for n_workers, n_slots in groups:
            cur.execute(
                "DELETE FROM plans WHERE traffic=? AND model=? "
                "AND n_workers=? AND n_slots=?",
                (traffic, model, n_workers, n_slots))
        ranks = {g: 0 for g in groups}
        written = 0
        for point in front:
            g = (point.plan.n_workers, point.plan.n_slots)
            cur.execute(
                "INSERT INTO plans (traffic, model, n_workers, n_slots, "
                "rank, plan, tok_per_s, p99_ms, footprint, measurement) "
                "VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
                (traffic, model, g[0], g[1], ranks[g],
                 plan_to_json(point.plan),
                 point.objectives[0], point.objectives[1],
                 point.objectives[2],
                 measurement_to_json(point.measurement)))
            ranks[g] += 1
            written += 1
        self._con.commit()
        return written

    # ----- reads ----------------------------------------------------------
    def _select(self, *, traffic: Optional[str] = None,
                model: Optional[str] = None,
                n_workers: Optional[int] = None,
                n_slots: Optional[int] = None) -> List[StoredPlan]:
        clauses, params = [], []
        for col, val in (("traffic", traffic), ("model", model),
                         ("n_workers", n_workers),
                         ("n_slots", n_slots)):
            if val is not None:
                clauses.append(f"{col}=?")
                params.append(val)
        where = (" WHERE " + " AND ".join(clauses)) if clauses else ""
        rows = self._con.execute(
            "SELECT traffic, model, n_workers, n_slots, rank, plan, "
            "measurement FROM plans" + where +
            " ORDER BY traffic, model, n_workers, n_slots, rank",
            params).fetchall()
        return [StoredPlan(traffic=r[0], model=r[1], n_workers=r[2],
                           n_slots=r[3], rank=r[4],
                           plan=plan_from_json(r[5]),
                           measurement=measurement_from_json(r[6]))
                for r in rows]

    def lookup(self, **filters) -> List[StoredPlan]:
        """Stored frontier rows matching the given key columns
        (``traffic``/``model``/``n_workers``/``n_slots``), in the one
        deterministic (key, rank) order."""
        return self._select(**filters)

    def keys(self) -> List[Tuple[str, str, int, int]]:
        return [tuple(r) for r in self._con.execute(
            "SELECT DISTINCT traffic, model, n_workers, n_slots "
            "FROM plans ORDER BY traffic, model, n_workers, n_slots")]

    def __len__(self) -> int:
        return self._con.execute(
            "SELECT COUNT(*) FROM plans").fetchone()[0]

    # ----- the planner-facing queries ------------------------------------
    def resolve_hints(self, hints, *, n_workers: int, n_slots: int,
                      traffic: Optional[str] = None,
                      model: Optional[str] = None
                      ) -> Optional[SharingVector]:
        """The ``core.plan.resolve`` consultation: the best measured
        frontier plan for this fleet size that satisfies the hints'
        hard constraints — footprint budget, latency target, compile
        isolation — ranked by measured throughput (ties: smaller
        footprint, then lower p99, then key order).  None on miss; the
        caller falls back to the analytic planner."""
        best_key, best_vec = None, None
        for sp in self._select(traffic=traffic, model=model,
                               n_workers=n_workers, n_slots=n_slots):
            m, vec = sp.measurement, sp.plan.vector
            if not m.feasible:
                continue
            if hints.footprint_budget is not None \
                    and m.footprint > hints.footprint_budget:
                continue
            if hints.latency_target_ms is not None \
                    and m.p99_ms > hints.latency_target_ms:
                continue
            if hints.compile_isolation and vec.execs != 1:
                continue
            key = (-m.tok_per_s, m.footprint, m.p99_ms,
                   sp.traffic, sp.model, sp.rank)
            if best_key is None or key < best_key:
                best_key, best_vec = key, vec
        return best_vec

    def frontier_vectors(self, *, n_workers: int, n_slots: int,
                         traffic: Optional[str] = None,
                         model: Optional[str] = None
                         ) -> List[SharingVector]:
        """The ``core.adapt.Replanner`` consultation: every distinct
        stored frontier vector for this fleet size, in the one
        deterministic (key, rank) order."""
        out, seen = [], set()
        for sp in self._select(traffic=traffic, model=model,
                               n_workers=n_workers, n_slots=n_slots):
            if not sp.measurement.feasible:
                continue
            vec = sp.plan.vector
            if vec not in seen:
                seen.add(vec)
                out.append(vec)
        return out


__all__ = ["SCHEMA_VERSION", "plan_to_json", "plan_from_json",
           "measurement_to_json", "measurement_from_json", "StoredPlan",
           "PlanRepository"]
