"""Adaptive re-planning tour (DESIGN.md §12): live SharingVector
migration under phase-shifting traffic.  The PyTorch counterpart of
``examples/serve_adaptive.py``: its fleets, trace and lines, through
``repro_torch`` only.

Part 1 replays the canonical phased trace (poisson → burst → idle →
burst) through an 8-worker virtual fleet three ways: frozen at the
dedicated diagonal, frozen at the shared diagonal, and ADAPTIVE — a
`core.adapt.Replanner` samples fabric telemetry every 100 virtual µs,
promotes resources toward dedicated the window a burst lands, and demotes
them lazily through the idle gap.  Virtual time is deterministic, so
these lines are the reference's, letter for letter.

Part 2 serves real tokens on the device through
`serve.connect(..., adaptive=True)` and then migrates the same client
MANUALLY with `client.replan` — both paths, one migration machinery,
token values invariant.

  PYTHONPATH=src python examples/serve_adaptive_torch.py
  PYTHONPATH=src python examples/serve_adaptive_torch.py --device cpu

Runs on the card unless ``--device cpu``; without CUDA it raises
RuntimeError before Part 1.
"""

import argparse

import numpy as np

from repro_torch import serve
from repro_torch.configs import get_smoke_config
from repro_torch.core.adapt import Replanner
from repro_torch.core.plan import SharingVector
from repro_torch.models.model import resolve_device
from repro_torch.serve.fabric import build_sim_fleet, canonical_phased_trace

MANUAL = SharingVector(slots=1, channels=3, execs=4)


def fmt(v: SharingVector) -> str:
    return v.label


def part1():
    """The frozen dedicated, frozen shared and adaptive virtual fleets."""
    trace, phases = canonical_phased_trace()
    busy = [p for p in phases if p.name != "idle"]
    print(f"trace: {len(trace)} requests over "
          f"{' -> '.join(p.name for p in phases)}, 8 workers x 4 slots\n")

    def phase_ms(rep):
        done = {c.rid: c.t_done_ns for c in rep.completions}
        return {p.name: (max(done[a.rid] for a in p.arrivals(trace))
                         - p.t_start_ns) / 1e6 for p in busy}

    for name, vector in [("frozen dedicated", SharingVector.diagonal(1)),
                         ("frozen shared", SharingVector.diagonal(4))]:
        rep = build_sim_fleet(8, vector).run(trace)
        ph = phase_ms(rep)
        print(f"{name:17s} ({fmt(vector)}): "
              f"{rep.tok_per_s:9,.0f} tok/s, "
              f"mean footprint {rep.mean_footprint * 100:5.1f}%, "
              + ", ".join(f"{k} {v:.2f}ms" for k, v in ph.items()))

    start = SharingVector.diagonal(2)
    adapt = Replanner(start, n_workers=8, n_slots=4)
    rep = build_sim_fleet(8, start, adapt=adapt,
                          adapt_window_ns=100_000.0).run(trace)
    ph = phase_ms(rep)
    print(f"{'ADAPTIVE':17s} (from {fmt(start)}): "
          f"{rep.tok_per_s:9,.0f} tok/s, "
          f"mean footprint {rep.mean_footprint * 100:5.1f}%, "
          + ", ".join(f"{k} {v:.2f}ms" for k, v in ph.items()))
    print(f"  {len(rep.transitions)} live migrations over "
          f"{rep.n_windows} telemetry windows:")
    print("  " + " -> ".join(
        f"{fmt(v)}@{t / 1e6:.2f}ms" for t, v in rep.transitions))
    print("\nthe adaptive fleet holds the dedicated diagonal's burst "
          "throughput at roughly the shared diagonal's footprint — the "
          "paper's dynamic categories, run as a live controller.\n")


def part2(cfg, device) -> dict:
    """Real tokens on ``device``: an adaptive 4-worker fleet (weights
    from ``connect``'s seed 0) serves 12 requests, then a manual
    ``replan`` to ``MANUAL`` and 4 more.  -> {"adaptive": {rid: [...]},
    "manual": {rid: [...]}, "transitions": the adaptive run's}."""
    client = serve.connect(cfg, SharingVector.diagonal(2), n_workers=4,
                           n_slots=2, max_len=64, adaptive=True,
                           adapt_window_ns=100_000.0, device=device)
    rng = np.random.default_rng(0)
    for i in range(12):
        client.submit(rng.integers(1, cfg.vocab, 8).astype(np.int32),
                      max_new_tokens=4, at_ns=0.0)
    out = client.run()
    transitions = list(client.report.transitions)
    print(f"real adaptive fleet: {len(out)} requests, "
          f"{client.report.n_windows} windows, "
          f"{len(transitions)} migrations, final vector "
          f"{fmt(client.plan.vector)}")

    before = client.plan.vector
    client.replan(MANUAL)
    for i in range(4):
        client.submit(rng.integers(1, cfg.vocab, 8).astype(np.int32),
                      max_new_tokens=4, at_ns=0.0)
    more = client.run()
    print(f"manual replan {fmt(before)} -> {fmt(MANUAL)}: served "
          f"{len(more)} more requests on the migrated fleet "
          f"(worker pools now level "
          f"{client.workers[0].engine.pool.level})")
    print(f"  sample outputs: {[more[r] for r in sorted(more)[:3]]}")
    return {"adaptive": out, "manual": more, "transitions": transitions}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    part1()
    return part2(get_smoke_config("qwen2-0.5b"), device)


if __name__ == "__main__":
    main()
