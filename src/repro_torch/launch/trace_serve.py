"""Where the card's time goes while the port serves: a profiled run.

    python -m repro_torch.launch.trace_serve --arch recurrentgemma-2b
    python -m repro_torch.launch.trace_serve --arch qwen2-0.5b \
        --max-len 1024 --prompt-lens 64,128,256,512,64,128,256,512
    python -m repro_torch.launch.trace_serve --arch qwen2-0.5b \
        --max-len 4096 --prompt-lens 1023,1024,1025,1500,2047,2049,3000,4000
    python -m repro_torch.launch.trace_serve --arch granite-moe-1b-a400m \
        --max-len 1024 --prompt-lens 64,128,256,512,64,128,256,512 --pages
    python -m repro_torch.launch.trace_serve --cell qwen2-0.5b:decode_32k

Draws full-width weights on the card (``torch.Generator`` seed 0), warms
the engine up (kernel builds, library handles) on two short requests,
then serves the prompts on a ``ContinuousEngine`` (the executor under
``connect``; 8 slots, decode horizon 8, a contiguous cache or with
``--pages`` a paged one of pages level 4, 104 new tokens per request)
and traces windows with ``torch.profiler``.  Admission, where the
engine admits in prefill buckets: a first round untraced, which captures
the graph of each bucket it uses (``AdmissionGraphs``); then, after
``evacuate`` and the same requests submitted again, one round with the
engine's admission runner swapped for the eager body (the round
launched op by op) and one round of graph replays, in the same slots
and buckets.  Without buckets (recurrentgemma-2b, xlstm-1.3b) the first
admission round is traced.  Then the first 4 fused horizons with the
engine's horizon runner swapped, here, for the eager body
(``Model.decode_horizon`` launched op by op, as before the horizon
graphs); and, after one horizon that captures the graph of 8 steps, the
next 4 horizons as the engine runs them, one graph replay each.  So the
eager and the graph windows are read in one process.  For each window
it prints the host seconds, the card's kernel time (the sum of every
kernel's own time: one stream, so no overlap), the share of the window
the card sat idle, and the kernels that took the most time, as one JSON
line per window; the admission graph window also carries the capture
round's host seconds and the bytes its captures added to the engine's
graph memory pool (which the warm-up engine, of the same exec group,
shares: a capture first reuses the blocks other graphs' captures
freed).  The 4 graph horizons after those are timed again
unprofiled (host seconds only, a last line): the profiler's tracing
costs time per kernel, which the graph's short gaps show.  The run
continues unprofiled to the end.

``--cell ARCH:CELL`` traces a decode cell of ``launch.shapes`` instead,
set up by ``cell_setup``, which ``chip_smoke.py`` phase 17 also uses:
``Model.decode_step`` (built by ``make_decode_step``) at the cell's
batch over a cache of the cell's length filled from a generator, ``idx``
at its last position, weights in the dry run's ``params_bf16`` dtypes;
one untimed step, a profiled window of 4 steps, then the same 4 steps
timed unprofiled.
Needs a CUDA device; the numbers are the card's, with its name and power
limit.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.core.plan import EndpointPlan, SharingVector
from repro_torch.launch.dryrun import bf16_params, rules_for
from repro_torch.launch.shapes import SHAPES
from repro_torch.launch.sharding import make_shard_fn
from repro_torch.launch.steps import make_decode_step
from repro_torch.models import Model
from repro_torch.models.layers import no_sharding
from repro_torch.models.params import tree_leaves
from repro_torch.serve.engine import ContinuousEngine, Request

#: recurrentgemma-2b's serving workload in ``chip_smoke.py``: four prompts
#: inside the window (2048), four that cross it while decoding, four past
DEFAULT_PROMPTS = (64, 300, 1000, 1500, 2000, 2000, 2030, 2040, 2100, 2500,
                   3000, 3500)


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


SLOTS = 8
DECODE_HORIZON = 8
#: new tokens per request: 13 horizons of 8, for the three decode
#: windows and the capture between the first two
MAX_NEW = 104
#: fused horizons traced in each decode window
DECODE_CALLS = 4
#: kernels listed per window
TOP = 8

#: the port's hand-written kernels, by a part of their device names; a
#: decode wrapper call runs its split kernel and the combine kernel both
#: decode libraries share, an RG-LRU scan call its two passes
PORT_KERNELS = ("rglru_chunk_reduce_kernel", "rglru_chunk_scan_kernel",
                "flash_attention_kernel", "ragged_split_kernel",
                "paged_split_kernel", "decode_combine_kernel")


def _window(name, prof, host_s, top):
    """Summary of one profiled window from ``key_averages()``: device-side
    kernel events only (the operators that launched them carry the same
    time again).  Raises when the kernels' time exceeds the window's: one
    stream runs one kernel at a time, so that would be a miscount."""
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in rows)
    if busy_us / 1e6 > host_s:
        raise RuntimeError(f"{name}: {busy_us / 1e6} s of kernel time in a "
                           f"{host_s} s window")
    rows.sort(key=lambda e: -e.self_device_time_total)
    port = {k: sum(e.self_device_time_total for e in rows if k in e.key)
            / 1e3 for k in PORT_KERNELS}
    return {
        "window": name, "host_s": host_s,
        "device_kernel_s": busy_us / 1e6,
        "device_idle_share": (1 - busy_us / 1e6 / host_s
                              if busy_us else None),
        "port_kernels_ms": port,
        "top_kernels": [{"name": e.key[:90],
                         "ms": e.self_device_time_total / 1e3,
                         "calls": e.count} for e in rows[:top]],
    }


def trace(eng, prompts, max_new: int = MAX_NEW,
          decode_calls: int = DECODE_CALLS, top: int = TOP):
    """Serve ``prompts`` on the fused-horizon engine ``eng``, tracing its
    admission and ``decode_calls`` horizons of the eager body, then,
    after one horizon that captures its graph, ``decode_calls`` graph
    replays, and timing ``decode_calls`` more replays unprofiled; -> the
    window summaries.

    With prefill buckets the first admission round, which captures the
    graph of each bucket it uses, runs untraced (its host seconds and the
    pool bytes its captures added are kept).  ``evacuate`` then empties
    the engine (its graphs stay) and the same requests, submitted again
    in the same order, take the same slots in the same buckets: one
    traced round of the eager body (the engine's admission runner
    swapped for ``AdmissionGraphs.body``), evacuated and submitted again,
    then one traced round of graph replays, which the run goes on from.
    Without buckets (exact-length admission, never captured) the first
    round is traced."""
    on_card = eng.device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(eng.device)

    def submit():
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=p, max_new_tokens=max_new))

    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)

    def admission_window(name):
        sync()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            admitted = eng.admit_waiting()
            sync()
            host = time.perf_counter() - t0
        win = _window(name, prof, host, top)
        win.update(prefills=admitted,
                   prompt_tokens=sum(len(p) for p in prompts[:admitted]))
        return win

    submit()
    eng.start()
    windows = []
    if eng._admissions is not None:
        sync()
        if on_card:
            # a capture empties the allocator's cache, which frees the pool
            # memory of dead graphs: free it first, so that the difference
            # is what these captures add
            gc.collect()
            torch.cuda.empty_cache()
        before = pool_bytes([eng.group]) if on_card else 0
        t0 = time.perf_counter()
        eng.admit_waiting()
        sync()
        capture_s = time.perf_counter() - t0
        after = pool_bytes([eng.group]) if on_card else 0
        pool = None if before is None or after is None else after - before
        eng.evacuate()
        submit()
        eng._run_admission = eng._admissions.body       # the eager body
        windows.append(admission_window("admission eager"))
        del eng._run_admission                          # the graphs
        eng.evacuate()
        submit()
        graph = admission_window("admission graph")
        graph.update(admission_graphs=eng.admission_graph_count(),
                     capture_round_s=capture_s,
                     capture_pool_bytes=pool)
        windows.append(graph)
    else:
        windows.append(admission_window("admission"))

    def decode_window(name):
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            steps0 = eng.stats["decode_steps"]
            for _ in range(decode_calls):
                eng.step()
            sync()
            host = time.perf_counter() - t0
        win = _window(name, prof, host, top)
        win.update(decode_steps=eng.stats["decode_steps"] - steps0,
                   batch=eng.n_slots)
        return win

    eng._run_horizon = eng._horizons.body        # the eager body
    eager = decode_window("decode eager")
    del eng._run_horizon                         # the engine's graphs
    t0 = time.perf_counter()
    eng.step()                                   # captures, then replays
    sync()
    capture_s = time.perf_counter() - t0
    graph = decode_window("decode graph")
    graph.update(graphs=eng.graph_count(), capture_horizon_s=capture_s)
    t0 = time.perf_counter()
    steps0 = eng.stats["decode_steps"]
    for _ in range(decode_calls):
        eng.step()
    sync()
    unprofiled = {"window": "decode graph unprofiled",
                  "host_s": time.perf_counter() - t0,
                  "decode_steps": eng.stats["decode_steps"] - steps0,
                  "batch": eng.n_slots}
    while eng.has_work:          # the rest, unprofiled
        eng.admit_waiting()
        if not eng.step() and eng.n_active == 0:
            break
    return windows + [eager, graph, unprofiled]


def cell_inputs(model: Model, cell, seed: int = 1):
    """The cache of a decode ``cell`` on the model's device, every
    floating leaf drawn from a ``torch.Generator`` seeded with ``seed``
    and ``idx`` at the cell's last position (each step reads every key),
    and the cell's tokens.  -> (cache, tokens)."""
    gen = torch.Generator(device=model.device).manual_seed(seed)
    cache = model.init_cache(cell.batch, max_len=cell.seq)
    for leaf in tree_leaves(cache["stack"], torch.is_tensor):
        leaf.normal_(generator=gen)
    cache["idx"].fill_(cell.seq - 1)
    tokens = torch.randint(0, model.cfg.vocab, (cell.batch,), generator=gen,
                           device=model.device, dtype=torch.int32)
    return cache, tokens


def cell_setup(arch: str, cell_name: str, mesh=None):
    """A decode cell of ``launch.shapes`` on the card: the model at full
    width and depth, weights drawn from ``torch.Generator`` seed 0 in the
    dry run's ``params_bf16`` dtypes, the step of ``make_decode_step``
    (with ``make_shard_fn`` of the cell's rules over ``mesh`` when one is
    given, else the identity hook: the same step on plain tensors), and
    ``cell_inputs``.  -> (model, params, step, cache, tokens)."""
    cell = SHAPES[cell_name]
    if cell.kind != "decode":
        raise ValueError(f"{cell_name}: a decode cell is stepped here")
    model = Model(get_config(arch), "cuda")
    params = bf16_params(model.init(
        torch.Generator(device="cuda").manual_seed(0)))
    shard_fn = no_sharding if mesh is None else make_shard_fn(
        rules_for(model)[0], mesh)
    step = make_decode_step(model, shard_fn=shard_fn)
    cache, tokens = cell_inputs(model, cell)
    return model, params, step, cache, tokens


def trace_cell(arch: str, cell_name: str, steps: int = DECODE_CALLS,
               top: int = TOP) -> list:
    """Profile ``steps`` decode steps of a decode cell (``cell_setup``),
    then time as many unprofiled; -> the two windows."""
    cell = SHAPES[cell_name]
    _, params, step, cache, tokens = cell_setup(arch, cell_name)
    step(params, cache, tokens)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(params, cache, tokens)
        torch.cuda.synchronize()
        host = time.perf_counter() - t0
    win = _window(f"{cell_name} decode steps", prof, host, top)
    win.update(decode_steps=steps, batch=cell.batch)
    t0 = time.perf_counter()
    for _ in range(steps):
        step(params, cache, tokens)
    torch.cuda.synchronize()
    return [win, {"window": f"{cell_name} decode steps unprofiled",
                  "host_s": time.perf_counter() - t0,
                  "decode_steps": steps, "batch": cell.batch}]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="recurrentgemma-2b",
                    choices=list(ARCHS))
    ap.add_argument("--prompt-lens", default=",".join(
        map(str, DEFAULT_PROMPTS)))
    ap.add_argument("--max-len", type=int, default=4096)
    ap.add_argument("--pages", action="store_true",
                    help="a paged cache (pages level 4)")
    ap.add_argument("--cell", default=None,
                    help="ARCH:CELL, a decode cell of launch.shapes")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("trace_serve measures the card: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = _card()
    if args.cell:
        arch, cell_name = args.cell.split(":")
        for win in trace_cell(arch, cell_name):
            win.update(arch=arch, card=card)
            print(json.dumps(win))
        return
    cfg = get_config(args.arch)
    params = Model(cfg, "cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    plan = EndpointPlan(vector=SharingVector(pages=4 if args.pages else 1),
                        n_slots=SLOTS, max_len=args.max_len,
                        decode_horizon=DECODE_HORIZON,
                        executor="continuous", use_ragged_kernel=True)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab, size=int(n)).astype(np.int32)
               for n in args.prompt_lens.split(",")]
    warm = ContinuousEngine(cfg, params, plan, device="cuda")
    trace(warm, [prompts[0][:16], prompts[0][:32]], 4, 1, 1)
    eng = ContinuousEngine(cfg, params, plan, device="cuda")
    windows = trace(eng, prompts)
    served = sum(len(r.output) for r in eng.done)
    print(f"{args.arch}: {len(eng.done)} requests, {served} tokens, "
          f"paged {eng.paged}; {card}")
    for win in windows:
        win.update(arch=args.arch, paged=eng.paged, card=card)
        print(json.dumps(win))


if __name__ == "__main__":
    main()
