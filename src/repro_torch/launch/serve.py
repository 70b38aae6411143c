"""Single-engine serving launcher over the port's `serve.connect`.

  python -m repro_torch.launch.serve --arch qwen2-0.5b \
      --plan shared_dynamic --slots 8 --max-len 1024 --decode-horizon 8 \
      --requests 16 --prompt-len 256 --mixed-lengths --max-new 64

  # paged KV cache, smoke config, on the CPU (the kernels' plain versions)
  python -m repro_torch.launch.serve --arch qwen2-0.5b --smoke \
      --device cpu --pages 4 --max-len 64 --requests 8 --prompt-len 12

  # recurrentgemma (RG-LRU + local attention): exact-length admission and
  # a rolling cache, whatever the buckets and pages flags say
  python -m repro_torch.launch.serve --arch recurrentgemma-2b \
      --slots 8 --max-len 4096 --decode-horizon 8 --requests 8 \
      --prompt-len 1024 --mixed-lengths --max-new 64

  # the legacy wave engine; a Chrome/Perfetto trace and the metrics
  # registry of a continuous run
  python -m repro_torch.launch.serve --arch qwen2-0.5b --engine wave \
      --slots 8 --max-len 1024 --requests 16 --prompt-len 128
  python -m repro_torch.launch.serve --arch qwen2-0.5b \
      --decode-horizon 8 --trace-out trace.json --metrics-out metrics.json

Runs on the card unless ``--device cpu`` is given, and prints tokens per
second and the kernels' launch counts.  ``--engine`` defaults to the
continuous engine.  Fleets, hints, adaptive re-planning and faults
arrive with later slices.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.core.endpoints import Category
from repro_torch.core.plan import EndpointPlan, SharingVector
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.rglru import ops as rglru_ops
from repro_torch.obs import enabled_obs
from repro_torch.serve import connect


def parse_buckets(spec: str):
    """'auto'/'pow2' derive power-of-2 buckets, 'none'/'off' disable,
    else a comma list of lengths, e.g. '8,16,32'."""
    if spec in ("auto", "pow2"):
        return spec
    if spec in ("none", "off"):
        return None
    return tuple(int(tok) for tok in spec.split(",") if tok.strip())


def parse_vector(spec: str) -> SharingVector:
    """--plan as an explicit vector: 'slots=1,channels=3[,execs=4]'."""
    fields = {}
    for tok in spec.split(","):
        k, _, v = tok.partition("=")
        fields[k.strip()] = int(v)
    return SharingVector(**fields)


def build_plan(args, ap) -> EndpointPlan:
    if args.engine == "wave":
        if args.decode_horizon != 1:
            ap.error("--decode-horizon applies to the continuous engine")
        if parse_buckets(args.prefill_buckets) not in ("auto", "pow2",
                                                       None):
            ap.error("--prefill-buckets applies to the continuous engine")
        if args.pages > 1 or args.page_size or args.page_budget is not None:
            ap.error("the wave engine has no paged cache; drop the page "
                     "flags or use the continuous engine")
    knobs = dict(n_slots=args.slots, max_len=args.max_len,
                 decode_horizon=args.decode_horizon,
                 prefill_buckets=parse_buckets(args.prefill_buckets),
                 executor=args.engine)
    if args.page_size:
        knobs["page_size"] = args.page_size
    if args.page_budget is not None:
        knobs["page_budget"] = args.page_budget
    if not 1 <= args.pages <= 4:
        ap.error("--pages must be a sharing level in 1..4")
    try:
        if args.plan is None:
            plan = EndpointPlan.from_category(Category.MPI_EVERYWHERE,
                                              **knobs)
        elif args.plan in (c.value for c in Category):
            plan = EndpointPlan.from_preset(args.plan, **knobs)
        else:
            plan = EndpointPlan(vector=parse_vector(args.plan), **knobs)
    except (TypeError, ValueError) as e:
        ap.error(f"--plan must be a preset "
                 f"({', '.join(c.value for c in Category)}) or "
                 f"'slots=..,channels=..[,execs=..,pages=..]': {e}")
    if args.pages > 1:
        if plan.vector.pages not in (1, args.pages):
            ap.error(f"--pages {args.pages} conflicts with the plan's "
                     f"pages level {plan.vector.pages}")
        plan = dataclasses.replace(
            plan, vector=dataclasses.replace(plan.vector,
                                             pages=args.pages))
    return plan


def make_prompts(cfg, args):
    rng = np.random.default_rng(args.seed)
    prompts = []
    for _ in range(args.requests):
        plen = args.prompt_len
        if args.mixed_lengths:
            plen = int(rng.choice([max(1, plen // 2), plen, 2 * plen]))
        prompts.append(rng.integers(1, cfg.vocab, size=plen)
                       .astype(np.int32))
    return prompts


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b", choices=list(ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--plan", default=None,
                    help="endpoint plan: a preset (one of "
                         f"{[c.value for c in Category]}) or an explicit "
                         "vector 'slots=1,channels=3[,execs=4,pages=2]'")
    ap.add_argument("--engine", default="continuous",
                    choices=("wave", "continuous"),
                    help="single-engine scheduler (default continuous; "
                         "wave = static waves of equal prompt length)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--decode-horizon", type=int, default=1,
                    help="fused decode steps per host sync (1 = per-step "
                         "host loop, the oracle)")
    ap.add_argument("--prefill-buckets", default="auto",
                    help="'auto'/'pow2', 'none', or a comma list")
    ap.add_argument("--pages", type=int, default=1,
                    help="KV page-pool sharing level 1..4; > 1 engages "
                         "the paged cache layout")
    ap.add_argument("--page-size", type=int, default=0,
                    help="tokens per KV page (0 = auto); setting it also "
                         "engages the paged layout")
    ap.add_argument("--page-budget", type=int, default=None,
                    help="total pool pages (default: slots x max-len / "
                         "page-size)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--mixed-lengths", action="store_true",
                    help="draw prompt lengths from {1/2, 1, 2}x prompt-len")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome/Perfetto trace-event JSON of "
                         "the run (open at https://ui.perfetto.dev; "
                         "DESIGN.md §14)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the unified metrics registry "
                         "(counters/gauges/quantile sketches keyed by "
                         "resource axis/group/worker) as JSON")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    plan = build_plan(args, ap)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    obs = enabled_obs() if (args.trace_out or args.metrics_out) else None
    client = connect(cfg, plan, seed=args.seed, device=args.device,
                     use_ragged_kernel=True, obs=obs)
    for prompt in make_prompts(cfg, args):
        client.submit(prompt, max_new_tokens=args.max_new)
    engine = client.engine
    on_card = engine.device.type == "cuda"
    ops.reset_launch_counts()
    rglru_ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = client.run()
    if on_card:
        torch.cuda.synchronize(engine.device)
    dt = time.perf_counter() - t0
    n_tok = sum(len(toks) for toks in out.values())
    where = (torch.cuda.get_device_name(engine.device) if on_card
             else "cpu")
    print(f"served {len(out)} requests, {n_tok} tokens in {dt:.3f}s "
          f"({n_tok / dt:.1f} tok/s on {where}, includes prefill, "
          f"executor={client.executor})")
    if client.executor == "continuous":
        report_continuous(engine)
    print(f"kernel launches: {dict(ops.LAUNCHES, **rglru_ops.LAUNCHES)}"
          + ("" if on_card else " (CPU: plain versions, no launches)"))
    for rid in sorted(out)[:4]:
        print(f"  req {rid}: {out[rid]}")
    if args.trace_out:
        obs.recorder.dump(args.trace_out)
        print(f"trace: {len(obs.recorder.events)} events -> "
              f"{args.trace_out} (open at https://ui.perfetto.dev)")
    if args.metrics_out:
        obs.metrics.dump(args.metrics_out)
        print(f"metrics: {len(obs.metrics.names())} series -> "
              f"{args.metrics_out}")


def report_continuous(engine) -> None:
    print(f"slot pool: level {engine.pool.level} "
          f"(group size {engine.pool.group_size}), "
          f"occupancy {engine.occupancy:.2f}, "
          f"{engine.stats['decode_steps']} decode steps in "
          f"{engine.stats['decode_calls']} calls "
          f"(horizon {engine.decode_horizon}, "
          f"{engine.compile_count()} horizon graphs), "
          f"{engine.stats['prefills']} prefills for "
          f"{engine.stats['prefilled_requests']} requests "
          f"(buckets {list(engine.prefill_buckets) or 'off'})")
    if engine.paged:
        pool = engine.page_pool
        print(f"page pool: level {pool.level} (page size "
              f"{engine.page_size}, {pool.total_pages} pages), "
              f"hwm {pool.hwm} ({pool.hwm / pool.total_pages:.0%}), "
              f"{pool.deferrals} deferrals")


if __name__ == "__main__":
    main()
