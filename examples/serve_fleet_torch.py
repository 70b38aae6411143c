"""Plan-space fleet tour (DESIGN.md §9, §11): one traffic burst, every
diagonal — and the off-diagonal plans no `Category` could name.  The
PyTorch counterpart of ``examples/serve_fleet.py``: its vectors, trace and
lines, through ``repro_torch`` only.

Part 1 runs the canonical deterministic bursty trace through an 8-worker
virtual-time fleet at each diagonal sharing level, then at off-diagonal
`SharingVector`s (dedicated slots + k-way-shared channels).  Virtual time
is deterministic, so these lines are the reference's, letter for letter.

Part 2 serves REAL tokens through the one facade: `serve.connect` with an
off-diagonal plan drives a fleet of continuous-batching engine workers on
the device, with an ordered `Stream` (per-stream FIFO) riding along.

  PYTHONPATH=src python examples/serve_fleet_torch.py
  PYTHONPATH=src python examples/serve_fleet_torch.py --device cpu

Runs on the card unless ``--device cpu``; without CUDA it raises
RuntimeError before Part 1.
"""

import argparse

import numpy as np

from repro_torch import serve
from repro_torch.configs import get_smoke_config
from repro_torch.core.plan import SharingVector
from repro_torch.models.model import resolve_device
from repro_torch.serve.fabric import build_sim_fleet, canonical_bursty_trace

VECTORS = (
    SharingVector.diagonal(1),              # the old Category diagonal...
    SharingVector.diagonal(2),
    SharingVector.diagonal(3),
    SharingVector.diagonal(4),
    SharingVector(slots=1, channels=3, execs=4),   # ...and beyond it
    SharingVector(slots=2, channels=4, execs=4),
)


def part1():
    """The virtual-time table of every vector in ``VECTORS``."""
    trace = canonical_bursty_trace()
    print(f"trace: {len(trace)} requests in bursts of 24, 8 workers x 4 "
          "slots\n")
    print(f"{'plan (slots/chan/exec)':22s} {'queues':>6s} {'tok/s':>9s} "
          f"{'p50ms':>7s} {'p99ms':>7s} {'occ':>5s} {'foot%':>6s}")
    for v in VECTORS:
        router = build_sim_fleet(8, v)
        rep = router.run(trace)
        tag = f"L{v.slots}/L{v.channels}/L{v.execs}" + \
            ("" if v.is_diagonal else "  (off-diag)")
        print(f"{tag:22s} {router.plan.n_queues:6d} "
              f"{rep.tok_per_s:9,.0f} "
              f"{rep.latency_percentile(0.5) / 1e6:7.2f} "
              f"{rep.latency_percentile(0.99) / 1e6:7.2f} "
              f"{rep.occupancy:5.2f} "
              f"{v.footprint_score(8, 4) * 100:5.1f}%")
    print("\nthe plan-space tradeoff: the off-diagonal points keep the "
          "dedicated diagonal's throughput at the shared diagonal's "
          "footprint — the paper's per-resource sharing result, "
          "unreachable while one scalar category drove every layer.\n")


def part2(cfg, device) -> dict:
    """Real tokens through a 4-worker fleet of continuous engines on
    ``device`` (weights from ``connect``'s seed 0), 9 requests and an
    ordered stream of 3.  -> {"outputs": {rid: [...]}, "report",
    "stream": the stream's outputs}."""
    client = serve.connect(
        cfg, SharingVector(slots=1, channels=3, execs=4),
        n_workers=4, n_slots=2, max_len=64, device=device)
    rng = np.random.default_rng(0)
    for i in range(9):
        client.submit(rng.integers(1, cfg.vocab, 8).astype(np.int32),
                      max_new_tokens=4, at_ns=float(i))
    s = client.stream()                     # an ordered lane rides along
    chained = [s.submit(rng.integers(1, cfg.vocab, 8).astype(np.int32),
                        max_new_tokens=3) for _ in range(3)]
    out = client.run()
    rep = client.report
    print(f"real fleet via {client!r}:")
    print(f"  {rep.n_completed} requests, {rep.total_new_tokens} real "
          f"tokens, {rep.tok_per_s:,.0f} virtual tok/s, "
          f"fairness {rep.fairness:.2f}")
    done_at = {c.rid: c.t_done_ns for c in rep.completions}
    print(f"  stream FIFO held: "
          f"{[round(done_at[r] / 1e3) for r in chained]} us completion "
          f"times, outputs {s.outputs}")
    print(f"  sample outputs: "
          f"{[out[r] for r in sorted(out)][:3]}")
    return {"outputs": out, "report": rep, "stream": s.outputs}


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
