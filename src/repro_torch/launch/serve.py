"""Serving launcher over the port's `serve.connect`: one engine, or a
fleet of engines behind the fabric router.

  python -m repro_torch.launch.serve --arch qwen2-0.5b \
      --plan shared_dynamic --slots 8 --max-len 1024 --decode-horizon 8 \
      --requests 16 --prompt-len 256 --mixed-lengths --max-new 64

  # paged KV cache, smoke config, on the CPU (the kernels' plain versions)
  python -m repro_torch.launch.serve --arch qwen2-0.5b --smoke \
      --device cpu --pages 4 --max-len 64 --requests 8 --prompt-len 12

  # recurrentgemma (RG-LRU + local attention): exact-length admission and
  # a rolling cache, whatever the buckets and pages flags say
  python -m repro_torch.launch.serve --arch recurrentgemma-2b \
      --engine continuous --slots 8 --max-len 4096 --decode-horizon 8 \
      --requests 8 --prompt-len 1024 --mixed-lengths --max-new 64

  # the MoE family (bucketed admission, paged caches) and xLSTM
  # (mLSTM / sLSTM cells: exact-length admission, no pages)
  python -m repro_torch.launch.serve --arch granite-moe-1b-a400m \
      --slots 8 --max-len 1024 --decode-horizon 8 --pages 4 \
      --requests 16 --prompt-len 256 --mixed-lengths --max-new 64
  python -m repro_torch.launch.serve --arch xlstm-1.3b --smoke \
      --device cpu --engine continuous --max-len 64 --requests 8 \
      --prompt-len 20 --decode-horizon 4 --mixed-lengths

  # the wave engine (the single engine's default); a Chrome/Perfetto
  # trace and the metrics registry of a continuous run
  python -m repro_torch.launch.serve --arch qwen2-0.5b \
      --slots 8 --max-len 1024 --requests 16 --prompt-len 128
  python -m repro_torch.launch.serve --arch qwen2-0.5b --engine continuous \
      --decode-horizon 8 --trace-out trace.json --metrics-out metrics.json

  # a fleet of 4 engines behind the router, in virtual time: bursty
  # traffic, prefill/decode roles, a crash, live re-planning
  python -m repro_torch.launch.serve --arch qwen2-0.5b --workers 4 \
      --plan shared_dynamic --traffic bursty --requests 32 \
      --slots 8 --max-len 1024 --decode-horizon 8 --prompt-len 256
  python -m repro_torch.launch.serve --smoke --device cpu --workers 4 \
      --roles 2P+2D --faults crash@0.6ms:w2 --max-len 64 --requests 16
  python -m repro_torch.launch.serve --smoke --device cpu --workers 4 \
      --plan shared_dynamic --adaptive --traffic phased --max-len 64

  # intent instead of resources: the planner resolves the vector
  python -m repro_torch.launch.serve --arch qwen2-0.5b --workers 4 \
      --hint latency_target_ms=80 --hint burstiness=0.9 --slots 8 \
      --max-len 1024 --decode-horizon 8 --requests 32 --prompt-len 256

Runs on the card unless ``--device cpu`` is given, and prints tokens per
second and the kernels' launch counts.  The flags resolve to the plan the
reference launcher builds, and it refuses what that one refuses.  A
single engine defaults to the wave executor, as there: ``--engine
continuous``, ``--plan``, ``--hint``, ``--adaptive`` or a page flag serve
through the continuous engine, and the wave engine refuses
``--decode-horizon`` and a bucket list.  ``--workers > 1`` serves
through the fleet; bare, its workers share one exec group.  ``--hint
k=v`` (repeatable) declares intent that the planner resolves
(``core.plan.resolve``); it excludes ``--plan``, and both exclude
``--category`` and ``--engine``.  ``--category`` is the deprecated
spelling of a diagonal preset and warns once.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
import warnings

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.core.endpoints import Category
from repro_torch.core.plan import EndpointPlan, Hints, SharingVector
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.rglru import ops as rglru_ops
from repro_torch.obs import enabled_obs
from repro_torch.serve import connect
from repro_torch.serve.fabric import (TRAFFIC_SHAPES, bursty_trace,
                                      phased_trace, poisson_trace,
                                      session_trace)
from repro_torch.serve.fabric.faults import _parse_time_ns
from repro_torch.serve.fabric.placement import POLICIES
from repro_torch.serve.recovery import RecoveryPolicy


def parse_migrations(items):
    """--migrate TIME:wSRC:wDST (repeatable) -> [(t_ns, src, dst)].
    Times use the fault grammar's units ('600us', '1.2ms', bare ns)."""
    out = []
    for item in items:
        try:
            t, src, dst = item.split(":")
            if not (src.startswith("w") and dst.startswith("w")):
                raise ValueError("workers spell as wN")
            out.append((_parse_time_ns(t), int(src[1:]), int(dst[1:])))
        except ValueError as e:
            raise ValueError(
                f"--migrate wants 'TIME:wSRC:wDST' (e.g. '600us:w2:w3'); "
                f"got {item!r}: {e}") from None
    return out


def make_trace(args):
    """Fleet traffic honoring the request-shape flags: prompts drawn from
    --prompt-len (or the {1/2, 1, 2}x mix), budgets up to --max-new."""
    p = args.prompt_len
    prompt_lens = (max(1, p // 2), p, 2 * p) if args.mixed_lengths else (p,)
    new_tokens = (max(1, args.max_new // 2), args.max_new)
    if args.traffic == "poisson":
        return poisson_trace(args.requests, prompt_lens=prompt_lens,
                             new_tokens=new_tokens, seed=args.seed)
    if args.traffic == "bursty":
        return bursty_trace(args.requests, prompt_lens=prompt_lens,
                            new_tokens=new_tokens, seed=args.seed)
    if args.traffic == "phased":
        return phased_trace(max(1, args.requests // 3),
                            prompt_lens=prompt_lens,
                            new_tokens=new_tokens, seed=args.seed)[0]
    return session_trace(max(1, args.requests // 4), 4,
                         prompt_lens=prompt_lens, new_tokens=new_tokens,
                         seed=args.seed)


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


_HINT_TYPES = {"latency_target_ms": float, "burstiness": float,
               "footprint_budget": float, "memory_budget": float,
               "session_ordering": lambda v: v.lower() in ("1", "true",
                                                           "yes", "on"),
               "compile_isolation": lambda v: v.lower() in ("1", "true",
                                                            "yes", "on")}


def parse_hints(items) -> Hints:
    """--hint k=v (repeatable) -> Hints."""
    fields = {}
    for item in items:
        k, _, v = item.partition("=")
        if k not in _HINT_TYPES:
            raise ValueError(f"unknown hint {k!r}; one of "
                             f"{sorted(_HINT_TYPES)}")
        fields[k] = _HINT_TYPES[k](v)
    return Hints(**fields)


def _implicit_wave(args) -> bool:
    """The historical single-engine default: one engine, no engine or
    the wave engine asked for, and none of --adaptive or the page flags
    (a wave engine cannot re-plan live or page its cache, so those keep
    the continuous executor)."""
    return (args.workers == 1 and (args.engine or "wave") == "wave"
            and not args.adaptive and args.pages <= 1
            and not args.page_size)


def build_plan(args, ap) -> EndpointPlan:
    """Resolve the flag surface, new (--plan / --hint) or legacy
    (--engine / --category), into one ``EndpointPlan``: the reference
    launcher's rules, field by field, and its refusals, word for word."""
    adaptive = args.adaptive
    knobs = dict(n_workers=args.workers, n_slots=args.slots,
                 max_len=args.max_len, decode_horizon=args.decode_horizon,
                 prefill_buckets=parse_buckets(args.prefill_buckets),
                 use_ragged_kernel=args.ragged_kernel,
                 adaptive=adaptive,
                 adapt_window_ns=args.adapt_window * 1e3)
    if args.roles:
        knobs["roles"] = args.roles
    pages = args.pages or 1
    page_size = args.page_size
    if pages < 1 or pages > 4:
        ap.error("--pages must be a sharing level in 1..4")
    if page_size:
        knobs["page_size"] = page_size
    if args.page_budget is not None:
        knobs["page_budget"] = args.page_budget

    def done(plan: EndpointPlan) -> EndpointPlan:
        """Land --pages on whichever vector the flags resolved (presets
        and the legacy flags predate the pages axis)."""
        if pages > 1:
            if plan.vector.pages not in (1, pages):
                ap.error(f"--pages {pages} conflicts with the plan's "
                         f"pages level {plan.vector.pages}")
            plan = dataclasses.replace(
                plan, vector=dataclasses.replace(plan.vector,
                                                 pages=pages))
        return plan
    if args.placement is not None:
        # only an explicit flag pins placement: hints may resolve their
        # own (session_ordering -> session_affinity)
        knobs["placement"] = args.placement
    if args.plan and args.hint:
        ap.error("--plan and --hint are exclusive: a plan IS resolved "
                 "hints")
    if (args.plan or args.hint) and args.category:
        ap.error("--category conflicts with --plan/--hint; the preset "
                 "spelling is --plan " + args.category)
    if (args.plan or args.hint) and args.engine is not None:
        ap.error(f"--engine {args.engine} conflicts with --plan/--hint "
                 f"(a plan resolves its own executor)")
    if args.engine == "wave" and adaptive:
        # the implicit wave default turns continuous under --adaptive,
        # but an explicit engine choice is never dropped silently
        ap.error("--engine wave cannot re-plan live; drop --adaptive or "
                 "use the continuous engine")
    if args.plan:
        if args.plan in (c.value for c in Category):
            return done(EndpointPlan.from_preset(args.plan, **knobs))
        try:
            return done(EndpointPlan(vector=parse_vector(args.plan),
                                     **knobs))
        except (TypeError, ValueError) as e:
            ap.error(f"--plan must be a preset "
                     f"({', '.join(c.value for c in Category)}) or "
                     f"'slots=..,channels=..[,execs=..,pages=..]': {e}")
    if args.hint:
        try:
            return done(EndpointPlan.from_hints(parse_hints(args.hint),
                                                **knobs))
        except ValueError as e:
            ap.error(str(e))
    # ----- the legacy flags ------------------------------------------------
    category = Category.MPI_EVERYWHERE
    if args.category is not None:
        warnings.warn(
            "--category is deprecated and now means the DIAGONAL preset: "
            "the level applies to slots, channels, AND executables (the "
            "pre-plan fleet shared only the dispatch queues — that "
            "spelling is --plan slots=1,channels=N).  Use --plan "
            "<preset|slots=..,channels=..> or --hint k=v",
            DeprecationWarning, stacklevel=2)
        category = Category(args.category)
    executor = "auto"
    if _implicit_wave(args):
        executor = "wave"
        knobs.update(decode_horizon=1, prefill_buckets="auto")
    if args.category is None and args.workers > 1:
        # the bare legacy fleet keeps the pre-plan sharing structure:
        # dedicated slots and queues, one exec group (the level-1
        # diagonal would give every worker its own); only an explicit
        # --category opts into the diagonal, and warns above
        return done(EndpointPlan(
            vector=SharingVector(slots=1, channels=1, execs=4),
            executor=executor, **knobs))
    return done(EndpointPlan.from_category(category, executor=executor,
                                           **knobs))


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
    ap.add_argument("--hint", action="append", default=[],
                    metavar="K=V",
                    help="intent for the planner (repeatable): "
                         "latency_target_ms=, burstiness=, "
                         "session_ordering=, footprint_budget=, "
                         "compile_isolation=, memory_budget=")
    ap.add_argument("--engine", default=None,
                    choices=("wave", "continuous"),
                    help="[legacy] single-engine scheduler (default "
                         "wave: static waves of equal prompt length); a "
                         "fleet (--workers > 1) is always continuous")
    ap.add_argument("--category", default=None,
                    choices=[c.value for c in Category],
                    help="[deprecated] diagonal sharing preset; use "
                         "--plan")
    ap.add_argument("--workers", type=int, default=1,
                    help="> 1 serves through the fabric router with this "
                         "many continuous-engine workers")
    ap.add_argument("--placement", default=None,
                    choices=sorted(POLICIES),
                    help="dispatch placement policy (default round_robin)")
    ap.add_argument("--traffic", default="bursty",
                    choices=sorted(TRAFFIC_SHAPES),
                    help="fleet traffic shape (arrival times, sessions)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--ragged-kernel", action="store_true",
                    help="plan.use_ragged_kernel: on the CPU, decode "
                         "attention through the kernels' plain versions "
                         "(on the card it always runs the CUDA kernels)")
    ap.add_argument("--decode-horizon", type=int, default=1,
                    help="fused decode steps per host sync (continuous "
                         "engine; 1 = per-step host loop, the oracle)")
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
    ap.add_argument("--adaptive", action="store_true",
                    help="live re-planning (DESIGN.md §12): a Replanner "
                         "samples per-resource telemetry every window "
                         "and migrates the SharingVector")
    ap.add_argument("--adapt-window", type=float, default=250.0,
                    metavar="US",
                    help="adaptation window in virtual microseconds (the "
                         "single engine converts it to decode steps "
                         "through the fabric cost model)")
    ap.add_argument("--roles", default=None, metavar="SPEC",
                    help="prefill/decode disaggregation: '2P+2D' splits "
                         "the fleet into prefill-only and decode-only "
                         "workers (must sum to --workers)")
    ap.add_argument("--migrate", action="append", default=[],
                    metavar="TIME:wSRC:wDST",
                    help="decode-to-decode live migration (repeatable): "
                         "at TIME (e.g. '600us') the source worker's live "
                         "sessions move to the destination as KV handoffs "
                         "(fleet only)")
    ap.add_argument("--faults", default=None, metavar="SPEC",
                    help="deterministic fault plan, comma-separated "
                         "'kind@time:target[:duration[:frac]]' with kinds "
                         "crash/stall/chan_stall/page_pressure, e.g. "
                         "'crash@4.5ms:w0,stall@2.2ms:w1:1ms' (fleet only)")
    ap.add_argument("--heartbeat-us", type=float, default=None,
                    help="failure-detector probe cadence in virtual us "
                         "(default 100)")
    ap.add_argument("--deadline-us", type=float, default=None,
                    help="heartbeat silence that declares a worker dead, "
                         "virtual us (default 400; must exceed the "
                         "largest healthy step)")
    ap.add_argument("--shed-capacity", type=int, default=None,
                    help="outstanding requests before the router sheds "
                         "new arrivals, lowest priority first (default 0 "
                         "= unlimited)")
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

    fleet = args.workers > 1
    if fleet and args.engine == "wave":
        ap.error("--workers > 1 serves through continuous-engine workers; "
                 "--engine wave only applies to a single engine")
    if _implicit_wave(args) and not (args.plan or args.hint
                                     or args.page_budget is not None):
        # the wave engine, asked for or implicit: its knobs are fixed
        if args.decode_horizon != 1:
            ap.error("--decode-horizon applies to the continuous engine")
        if parse_buckets(args.prefill_buckets) not in ("auto", "pow2",
                                                       None):
            # 'auto' (the default) and 'none' are both no-ops for the
            # wave engine; only an explicit bucket list is a misuse
            ap.error("--prefill-buckets applies to the continuous engine")
    pmax = args.prompt_len * (2 if args.mixed_lengths else 1)
    if fleet and pmax + args.max_new >= args.max_len:
        ap.error(f"longest prompt ({pmax}) + max-new ({args.max_new}) "
                 f"must fit max-len ({args.max_len}) in fleet mode")
    ft_knobs = (args.heartbeat_us, args.deadline_us, args.shed_capacity)
    if (args.faults or any(k is not None for k in ft_knobs)) and not fleet:
        ap.error("--faults and the recovery knobs need a fleet "
                 "(--workers > 1)")
    if (args.roles or args.migrate) and not fleet:
        ap.error("--roles and --migrate need a fleet (--workers > 1)")
    try:
        migrations = parse_migrations(args.migrate) or None
    except ValueError as e:
        ap.error(str(e))
    recovery = None
    if args.faults or any(k is not None for k in ft_knobs):
        kw = {}
        if args.heartbeat_us is not None:
            kw["heartbeat_ns"] = args.heartbeat_us * 1e3
        if args.deadline_us is not None:
            kw["deadline_ns"] = args.deadline_us * 1e3
        if args.shed_capacity is not None:
            kw["shed_capacity"] = args.shed_capacity
        recovery = RecoveryPolicy(**kw)
    plan = build_plan(args, ap)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    obs = enabled_obs() if (args.trace_out or args.metrics_out) else None
    client = connect(cfg, plan, seed=args.seed, device=args.device,
                     obs=obs, faults=args.faults, recovery=recovery,
                     migrations=migrations)
    if fleet:
        for a in make_trace(args):
            rng = np.random.default_rng(a.rid)
            client.submit(rng.integers(1, cfg.vocab, size=a.prompt_len)
                          .astype(np.int32),
                          max_new_tokens=a.max_new_tokens, at_ns=a.t_ns,
                          session=a.session)
    else:
        for prompt in make_prompts(cfg, args):
            client.submit(prompt, max_new_tokens=args.max_new)
    on_card = client.device.type == "cuda"
    ops.reset_launch_counts()
    rglru_ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = client.run()
    if on_card:
        torch.cuda.synchronize(client.device)
    dt = time.perf_counter() - t0
    n_tok = sum(len(toks) for toks in out.values())
    where = (torch.cuda.get_device_name(client.device) if on_card
             else "cpu")
    print(f"served {len(out)} requests, {n_tok} tokens in {dt:.3f}s "
          f"({n_tok / dt:.1f} tok/s on {where}, includes prefill, "
          f"executor={client.executor})")
    if client.executor == "continuous":
        report_continuous(client.engine)
        if client.plan.adaptive:
            path = " -> ".join(
                f"{vec.label}@step{step}"
                for step, vec in client.transitions) or "none"
            print(f"adaptive: {client.engine.stats['regroups']} regroups "
                  f"({path}); final vector {client.plan.vector.label}")
    elif client.executor == "fleet":
        report_fleet(client, args)
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


def report_fleet(client, args) -> None:
    rep = client.report
    v = client.plan.vector
    u = rep.endpoint_usage
    preset = f" preset={client.plan.preset}" if client.plan.preset else ""
    print(f"fleet: {rep.n_workers} workers, vector {v.label}{preset}, "
          f"placement={rep.placement}, traffic={args.traffic}")
    print(f"  {rep.n_completed}/{rep.n_arrivals} requests, "
          f"{rep.total_new_tokens} tokens in {rep.makespan_ns / 1e6:.2f} "
          f"virtual ms ({rep.tok_per_s:,.0f} virtual tok/s)")
    print(f"  p50={rep.latency_percentile(0.5) / 1e6:.2f}ms "
          f"p99={rep.latency_percentile(0.99) / 1e6:.2f}ms "
          f"occupancy={rep.occupancy:.2f} fairness={rep.fairness:.3f} "
          f"lock_wait={rep.lock_wait_ns:.0f}ns")
    foot = client.plan.footprint()
    print(f"  footprint: plan={client.plan.footprint_score() * 100:.1f}% "
          f"({'/'.join(foot)} "
          f"{'/'.join(f'{x * 100:.0f}%' for x in foot.values())}), "
          f"endpoint uuars={u['uuars'] * 100:.1f}% "
          f"memory={u['memory'] * 100:.1f}%")
    groups = {id(w.engine.group): w.engine.group for w in client.workers}
    print(f"  engines: {len(client.workers)} over {len(groups)} exec "
          f"groups, {sum(w.engine.graph_count() for w in client.workers)}"
          f" horizon graphs, "
          f"{sum(g.compile_count() for g in groups.values())} "
          f"specializations")
    if rep.roles is not None or rep.handoffs or rep.migrations:
        topo = (f"{rep.roles[0]}P+{rep.roles[1]}D"
                if rep.roles is not None else "co-located")
        print(f"  disagg: {topo}, {rep.handoffs} KV handoffs "
              f"({rep.kv_tokens_moved} tokens, "
              f"{rep.kv_bytes_moved:,} bytes), "
              f"{rep.migrations} live migrations")
    if rep.page_hwm_frac is not None:
        print(f"  pages: peak {rep.page_hwm_frac * 100:.1f}% of the "
              f"dedicated reservation, {rep.page_deferrals} deferrals")
    if rep.faults_injected or rep.detections or rep.retries or rep.shed:
        worst = (max(rep.recovery_latency_ns) / 1e6
                 if rep.recovery_latency_ns else 0.0)
        print(f"  chaos: {rep.faults_injected} faults, "
              f"{rep.detections} detections (worst {worst:.2f}ms), "
              f"{rep.retries} retries, {len(rep.recovered)} recovered, "
              f"{len(rep.failed)} failed, {rep.n_shed} shed, "
              f"{rep.duplicate_completions} duplicate completions")
    if client.plan.adaptive:
        path = " -> ".join(
            f"{vec.label}@{t / 1e6:.2f}ms"
            for t, vec in rep.transitions) or "none"
        print(f"  adaptive: {rep.n_windows} windows, "
              f"{len(rep.transitions)} migrations ({path}), "
              f"mean footprint {rep.mean_footprint * 100:.1f}%")


def report_continuous(engine) -> None:
    print(f"slot pool: level {engine.pool.level} "
          f"(group size {engine.pool.group_size}), "
          f"occupancy {engine.occupancy:.2f}, "
          f"{engine.stats['decode_steps']} decode steps in "
          f"{engine.stats['decode_calls']} calls "
          f"(horizon {engine.decode_horizon}, "
          f"{engine.graph_count()} horizon graphs, "
          f"{engine.compile_count()} specializations), "
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
