#!/usr/bin/env python3
"""Find an open-loop cell's knee once: the highest rate the program
sustains with no growing backlog.

    python3 perfbench/sweep.py --workload granite-moe-1b-a400m.chat-rate \
        --rates 3,4,5,6 --seconds 51 --seeds 1,2

One process sets the cell up as ``run.py`` does (weights from the first
seed, the plan, the warm-up), then, for each seed (its weights copied in
place, its prompts), serves the cell's traffic at each rate in turn for
``--seconds``, emptying the engine between rates.  The backlog (requests
due and not yet admitted) is read at every turn of the loop; its median
over the tenth of the window around the midpoint and over the window's
last tenth stand for the backlog there.  For each rate and seed it prints
one JSON line: those two backlogs, the tokens a second, the 90th
percentiles of time to first token and of time per output token, and
whether the backlog grew.  The knee is the highest rate at which, and
below which, no seed's backlog grew; the cell's fixed rate is 0.8 times
that, written into ``cells/<workload>.json`` by hand.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

from perfbench import generator, run, spec  # noqa: E402
from perfbench.limits import load_weights  # noqa: E402


class SweepLoop(run.Loop):
    """The benchmark's loop, reading the backlog at every turn."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.backlogs = []

    def backlog(self, now: float) -> int:
        return len(self.eng.queue) + sum(t.due <= now for t in self.pending)

    def tick(self, now: float) -> None:
        self.backlogs.append(((now - self.t0) / (self.t_end - self.t0),
                              self.backlog(now)))

    def backlog_at(self, lo: float, hi: float) -> float:
        """The median backlog over the share ``[lo, hi)`` of the window."""
        got = [b for f, b in self.backlogs if lo <= f < hi]
        return statistics.median(got) if got else 0.0


def knee(rows) -> float:
    """The highest rate at which, and below which, no seed's backlog
    grew (None where the lowest rate's grew)."""
    best = None
    for rate in sorted({r["rate_per_s"] for r in rows}):
        if any(r["grew"] for r in rows if r["rate_per_s"] == rate):
            break
        best = rate
    return best


def sweep(cell: spec.Cell, seeds, rates, seconds: float, device):
    params = run.draw_weights(cell, seeds[0], device)
    client = run.connect(cell, params, device)
    eng = client.engine
    eng.start()
    run.warm_up(eng, cell, seeds[0])
    out = []
    for seed in seeds:
        load_weights(eng, cell, seed, device)
        for rate in rates:
            draws = generator.schedule(cell.mix, seconds, rate=rate)
            t0 = time.perf_counter()
            loop = SweepLoop(eng, cell, draws, run.nonneg(seed), t0,
                             seconds)
            loop.window()
            mid, end = loop.backlog_at(0.45, 0.55), loop.backlog_at(0.9, 1.0)
            due = loop.due_in_window()
            ttft = [(t.first - t.due) * 1e3 for t in due
                    if t.first is not None]
            done = [t for t in loop.finished() if t.done < loop.t_end
                    and t.seen >= 2]
            tpots = [run.tpot(t.first, t.last, t.seen) * 1e3 for t in done]
            row = {"seed": seed, "rate_per_s": rate, "due": len(due),
                   "first_tokens": len(ttft), "finished": len(done),
                   "backlog_mid": mid, "backlog_end": end, "grew": end > mid,
                   "out_tok_s": loop.window_tokens / seconds,
                   "ttft_p90_ms": run.percentile(ttft, 90) if ttft else None,
                   "tpot_p90_ms": (run.percentile(tpots, 90) if tpots
                                   else None),
                   "lateness_p50_ms": (run.percentile(loop.lateness, 50)
                                       * 1e3 if loop.lateness else None)}
            print(json.dumps(row), flush=True)
            out.append(row)
            eng.evacuate()
    k = knee(out)
    print(json.dumps({"knee_per_s": k,
                      "cell_rate_per_s": None if k is None else 0.8 * k}),
          flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--seeds", default="1")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep: needs a CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    sweep(cell, [int(s) for s in args.seeds.split(",")],
          [float(r) for r in args.rates.split(",")], args.seconds, "cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
