"""Trace-event schema + span-conservation validator (DESIGN.md §14).

Checks an exported Chrome trace document (``FlightRecorder.to_chrome``
output, or the JSON file ``--trace-out`` wrote) for the invariants the
flight recorder promises:

* **schema** — every event carries ``name``/``ph``/``pid``/``tid`` and
  a numeric ``ts``; ``ph`` is one of X/i/b/e/M/C; "X" spans carry a
  non-negative numeric ``dur``; "b"/"e" carry an ``id``; "i" carries a
  scope ``s``;
* **span conservation** — every async begin ("b") has exactly one
  matching end ("e") on the same (pid, cat, id, name), with
  ``e.ts >= b.ts`` (every arrival span has a matching retire);
* **track serialization** — "X" duration spans on one (pid, tid) track
  never overlap (worker virtual timelines are serial by construction).

CLI (CI runs this against the canonical bursty trace artifact):

  PYTHONPATH=src python -m repro_torch.obs.validate trace.json
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List

__all__ = ["validate_trace", "main"]

_PHASES = {"X", "i", "b", "e", "M", "C"}


def validate_trace(doc: dict) -> List[str]:
    """-> list of invariant-violation strings (empty == valid)."""
    problems: List[str] = []
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]

    open_async: Dict[tuple, int] = {}
    spans_by_track: Dict[tuple, List[tuple]] = {}

    for i, ev in enumerate(events):
        where = f"event[{i}]"
        if not isinstance(ev, dict):
            problems.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _PHASES:
            problems.append(f"{where}: bad ph {ph!r}")
            continue
        for field in ("name", "pid", "tid"):
            if field not in ev:
                problems.append(f"{where} ({ph} {ev.get('name')!r}): "
                                f"missing {field!r}")
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)):
            problems.append(f"{where} ({ph} {ev.get('name')!r}): "
                            f"non-numeric ts {ts!r}")
            continue
        if ph == "M":
            continue
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"{where} (X {ev.get('name')!r}): bad "
                                f"dur {dur!r}")
                continue
            spans_by_track.setdefault(
                (ev.get("pid"), ev.get("tid")), []).append(
                    (ts, ts + dur, ev.get("name")))
        elif ph == "i":
            if ev.get("s") not in ("t", "p", "g"):
                problems.append(f"{where} (i {ev.get('name')!r}): bad "
                                f"instant scope {ev.get('s')!r}")
        elif ph in ("b", "e"):
            if "id" not in ev:
                problems.append(f"{where} ({ph} {ev.get('name')!r}): "
                                f"async event missing id")
                continue
            key = (ev.get("pid"), ev.get("cat"), ev["id"], ev.get("name"))
            if ph == "b":
                if key in open_async:
                    problems.append(f"{where}: async begin {key!r} "
                                    f"while already open")
                open_async[key] = i
            else:
                if key not in open_async:
                    problems.append(f"{where}: async end {key!r} "
                                    f"without begin")
                else:
                    b_ts = events[open_async.pop(key)]["ts"]
                    if ts < b_ts:
                        problems.append(f"{where}: async end {key!r} at "
                                        f"ts {ts} before begin {b_ts}")

    for key, idx in sorted(open_async.items(), key=lambda kv: kv[1]):
        problems.append(f"async span never closed (no retire): {key!r}")

    eps = 1e-6  # one femto-second of slack against float /1e3 rounding
    for (pid, tid), spans in sorted(spans_by_track.items()):
        spans.sort()
        for (a0, a1, an), (b0, b1, bn) in zip(spans, spans[1:]):
            if b0 < a1 - eps:
                problems.append(
                    f"overlapping X spans on track ({pid},{tid}): "
                    f"{an!r} [{a0},{a1}] vs {bn!r} [{b0},{b1}]")
    return problems


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: python -m repro_torch.obs.validate trace.json",
              file=sys.stderr)
        return 2
    with open(argv[0]) as f:
        doc = json.load(f)
    problems = validate_trace(doc)
    n = len(doc.get("traceEvents", []))
    if problems:
        print(f"INVALID {argv[0]} ({n} events):")
        for p in problems:
            print(f"  {p}")
        return 1
    print(f"OK {argv[0]}: {n} events, schema + span-conservation + "
          f"track-serialization invariants hold")
    return 0


if __name__ == "__main__":
    sys.exit(main())
