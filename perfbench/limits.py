#!/usr/bin/env python3
"""The readings a cell's limit is set from: the program's widest gap on a
dozen seeds or more, and the control's on three or more.

    python3 perfbench/limits.py --workload qwen2-0.5b.reason-batch \
        --seeds 11,12,13,14,15,16,17,18,19,20,21,22 --control 11,12,13 \
        --seconds 30

One process sets the cell up once (as ``run.py`` does) and, for each seed,
draws that seed's weights into the program's own weight tensors in place
(the engine and its graphs stay), serves a window of the cell's traffic
with the seed's prompts at the cell's load, and holds the run's sample of
served tokens against the reference (``check.served_gaps``: the widest and the mean gap); for
the control seeds it also reads the control, the reference in float8 in
the program's place (``check.control_gaps``), on the same sample.
``--fault`` serves with one of ``faults.FAULTS`` planted in the program,
for the readings of a broken program.  One JSON line a seed; the
benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

from perfbench import faults, generator, run, spec  # noqa: E402
from perfbench import weights  # noqa: E402


def load_weights(eng, cell: spec.Cell, seed: int, device) -> None:
    """The weights of ``seed``, copied into the engine's own tensors."""
    new = run.draw_weights(cell, seed, device)
    for (_, dst), (_, src) in zip(weights._walk(eng.params),
                                  weights._walk(new)):
        dst.copy_(src)


def readings(loop: run.Loop, cell: spec.Cell, seed: int, device,
             control: bool) -> dict:
    done = loop.finished()
    return dict(run.sample_gaps(loop, cell, seed, device, control),
                seed=seed, finished=len(done),
                wrong_lengths=sum(len(t.out) != t.max_new for t in done))


def serve_and_read(eng, cell: spec.Cell, seed: int, seconds: float, device,
                   control: bool) -> dict:
    draws = generator.schedule(cell.mix, seconds,
                               rate=float(cell.data.get("rate_per_s", 0.0)),
                               clients=int(cell.data.get("clients", 0)))
    loop = run.Loop(eng, cell, draws, run.nonneg(seed), time.perf_counter(),
                    seconds)
    loop.window()
    loop.drain()
    eng.evacuate()
    t = time.perf_counter()
    out = readings(loop, cell, seed, device, control)
    out["check_s"] = time.perf_counter() - t
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="")
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--fault", default="", choices=("",) + tuple(
        faults.FAULTS), help="serve with this fault planted (readings "
        "of a broken program)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("limits: needs a CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    control = {int(s) for s in args.control.split(",") if s}
    device = "cuda"
    # a fault goes in before the engine captures its graphs, which then
    # hold the broken body
    with faults.planted(args.fault) if args.fault \
            else contextlib.nullcontext():
        client = run.connect(cell, run.draw_weights(cell, seeds[0], device),
                             device)
        eng = client.engine
        eng.start()
        run.warm_up(eng, cell, seeds[0])
        for seed in seeds:
            load_weights(eng, cell, seed, device)
            out = serve_and_read(eng, cell, seed, args.seconds, device,
                                 seed in control)
            print(json.dumps(dict(out, fault=args.fault or None)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
