"""Where the card's time goes while the port serves: a profiled run.

    python -m repro_torch.launch.trace_serve --arch recurrentgemma-2b
    python -m repro_torch.launch.trace_serve --arch qwen2-0.5b \
        --max-len 1024 --prompt-lens 64,128,256,512,64,128,256,512
    python -m repro_torch.launch.trace_serve --arch qwen2-0.5b \
        --max-len 4096 --prompt-lens 1023,1024,1025,1500,2047,2049,3000,4000

Draws full-width weights on the card (``torch.Generator`` seed 0), warms
the engine up (kernel builds, library handles) on two short requests,
then serves the prompts on a ``ContinuousEngine`` (the executor under
``connect``; 8 slots, decode horizon 8, contiguous cache, 104 new
tokens per request) and traces three windows with ``torch.profiler``:
the first admission round (one prefill per slot); the first 4 fused
horizons with the engine's horizon runner swapped, here, for the eager
body (``Model.decode_horizon`` launched op by op, as before the horizon
graphs); and, after one horizon that captures the graph of 8 steps, the
next 4 horizons as the engine runs them, one graph replay each.  So the
eager and the graph decode windows are read in one process.  For each
window it prints the host seconds, the card's kernel time (the sum of
every kernel's own time: one stream, so no overlap), the share of the
window the card sat idle, and the kernels that took the most time, as
one JSON line per window.  The 4 graph horizons after those are timed
again unprofiled (host seconds only, a fourth line): the profiler's
tracing costs time per kernel, which the graph's short gaps show.  The
run continues unprofiled to the end.
Needs a CUDA device; the numbers are the card's, with its name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.core.plan import EndpointPlan
from repro_torch.models import Model
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
    """Serve ``prompts`` on the fused-horizon engine ``eng``, tracing the
    first admission round, ``decode_calls`` horizons of the eager body,
    then, after one horizon that captures its graph, ``decode_calls``
    graph replays, and timing ``decode_calls`` more replays unprofiled;
    -> the four window summaries."""
    on_card = eng.device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(eng.device)

    for rid, p in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=p, max_new_tokens=max_new))
    eng.start()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    sync()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        admitted = eng.admit_waiting()
        sync()
        host = time.perf_counter() - t0
    admission = _window("admission", prof, host, top)
    admission.update(prefills=admitted,
                     prompt_tokens=sum(len(p) for p in prompts[:admitted]))

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
    return [admission, eager, graph, unprofiled]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="recurrentgemma-2b",
                    choices=list(ARCHS))
    ap.add_argument("--prompt-lens", default=",".join(
        map(str, DEFAULT_PROMPTS)))
    ap.add_argument("--max-len", type=int, default=4096)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("trace_serve measures the card: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = _card()
    cfg = get_config(args.arch)
    params = Model(cfg, "cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    plan = EndpointPlan(n_slots=SLOTS, max_len=args.max_len,
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
    print(f"{args.arch}: {len(eng.done)} requests, {served} tokens; "
          f"{card}")
    for win in windows:
        win.update(arch=args.arch, card=card)
        print(json.dumps(win))


if __name__ == "__main__":
    main()
