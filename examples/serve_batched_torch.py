"""End-to-end serving driver over the port's `serve.connect` facade: the
same mixed-length request set through the wave executor and through
continuous batching at each slot-sharing preset, so the endpoint-category
tradeoff (DESIGN.md §3, §11) is visible from one command.  The PyTorch
counterpart of ``examples/serve_batched.py``: its configs, flags and
lines, through ``repro_torch`` only.

  PYTHONPATH=src python examples/serve_batched_torch.py [--arch qwen2-0.5b]
  PYTHONPATH=src python examples/serve_batched_torch.py --device cpu

Runs on the card unless ``--device cpu``; without CUDA it raises
RuntimeError.  Weights come from ``Model.init`` on a ``torch.Generator``
seeded 0 on the CPU, then placed on the device, so the card and the CPU
serve the same weights.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch import serve
from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.models.model import Model, resolve_device

PRESETS = ("mpi_everywhere", "shared_dynamic", "mpi_threads")
MAX_LEN = 160


def make_requests(cfg, n, seed=0):
    """(prompt, max_new_tokens, eos_id) triples, mixed lengths."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i, ln in enumerate(rng.choice([8, 16, 32], size=n)):
        reqs.append((
            rng.integers(1, cfg.vocab, ln).astype(np.int32),
            int(rng.integers(4, 12)),
            int(rng.integers(0, cfg.vocab)) if i % 3 == 0 else None))
    return reqs


def drive(client, reqs):
    rids = [client.submit(p, max_new_tokens=m, eos_id=e)
            for p, m, e in reqs]
    t0 = time.time()
    out = client.run()
    dt = time.time() - t0
    total = sum(len(out[r]) for r in rids)
    return {r: out[r] for r in rids}, total, dt


def run(cfg, device, n_requests=12, n_slots=4, params=None) -> dict:
    """The wave executor, then each of ``PRESETS``, on one set of weights
    (``params`` in the reference's layout, or None for ``Model.init``
    from seed 0) and ``make_requests(cfg, n_requests)``; prints the
    reference's lines.  -> {"wave" or preset: {"tokens": {rid: [...]},
    "total", "seconds", and for a preset "agree", "group",
    "occupancy"}}."""
    if params is None:
        params = Model(cfg, device).init(torch.Generator().manual_seed(0))
    rows = {}
    wave = serve.connect(cfg, None, params=params, executor="wave",
                         n_slots=n_slots, max_len=MAX_LEN, device=device)
    done, total, dt = drive(wave, make_requests(cfg, n_requests))
    print(f"wave           : {len(done)} requests / {total} tokens "
          f"in {dt:.2f}s ({total / dt:.1f} tok/s, {n_slots} slots)")
    rows["wave"] = dict(tokens=done, total=total, seconds=dt)
    baseline = done

    for preset in PRESETS:
        client = serve.connect(cfg, preset, params=params, n_slots=n_slots,
                               max_len=MAX_LEN, device=device)
        done, total, dt = drive(client, make_requests(cfg, n_requests))
        agree = sum(baseline[r] == toks for r, toks in done.items())
        eng = client.engine
        print(f"{preset:15s}: {len(done)} requests / {total} tokens "
              f"in {dt:.2f}s ({total / dt:.1f} tok/s, "
              f"group {eng.pool.group_size}, occupancy "
              f"{eng.occupancy:.2f}, {agree}/{len(done)} match wave)")
        rows[preset] = dict(tokens=done, total=total, seconds=dt,
                            agree=agree, group=eng.pool.group_size,
                            occupancy=eng.occupancy)

    for rid in sorted(done)[:6]:
        print(f"  req {rid:2d} -> {len(done[rid])} new: {done[rid][:8]}")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b",
                    choices=[a for a in ARCHS])
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    return run(get_smoke_config(args.arch), device, args.requests,
               args.slots)


if __name__ == "__main__":
    main()
