#!/usr/bin/env python3
"""Run one cell of the benchmark of ``repro_torch`` and print its result.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up draws the weights on the card from the seed, connects the program
(``repro_torch.serve.connect`` with the cell's plan) and warms up exactly
the shapes the cell's traffic uses: the decode horizon's graphs of every
length, and in a bucketed cell the admission graph of every bucket the
prompts can reach.  The window then opens with the first request due and
lasts ``--seconds``: the benchmark's own generator releases the requests
(a closed loop of clients, or an open loop at the cell's fixed rate) and
drives the engine as the program's own continuous loop does (``submit``,
``admit_waiting``, ``step``), timing each token when the host sees it.
After the window it waits (a minute at most) for the first token of every
request due in it, reads the card's memory peak, frees the program and
holds a sample of the served tokens against the plain fp32 reference.

``--trace 0`` reports the end-to-end metrics; ``--trace 1`` syncs after
every call, profiles the window's last ``profile_s`` seconds with
``torch.profiler`` and reports the per-layer metrics, each read from the
records by ``metrics/<metric>.py``.  The last line of standard output is
the result (JSON); the last lines of standard error are the numbers the
check compared, each beside its limit.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench import check, counts, devtrace, generator, spec  # noqa: E402
from perfbench import weights as weights_mod  # noqa: E402

#: top-level modules that may not be loaded in the process that prints
#: the result: JAX and the JAX package (names compared whole, so the
#: port's ``repro_torch`` is not one of them)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: how long after the window the run waits for a first token that was due
WAIT_S = 60.0
#: request ids of the warm-up start here, clear of the window's
WARM_RID = 1 << 30


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


# ----- end-to-end arithmetic ---------------------------------------------
def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0..100) of ``values``, linear between the
    two closest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("a percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def per_second(count: float, seconds: float) -> float:
    return count / seconds


def tpot(first: float, last: float, n_tokens: int) -> float:
    """Seconds per output token once decoding began."""
    return (last - first) / (n_tokens - 1)


def nonneg(seed: int) -> int:
    return int(seed) % (1 << 63)


# ----- the program, as a user sets it up ---------------------------------
def arch_config(cfg: dict):
    """The program's ``ArchConfig`` of a configuration file."""
    from repro_torch.configs.base import ArchConfig, MoEConfig
    a = dict(cfg["arch"])
    a["block_pattern"] = tuple(a["block_pattern"])
    if a.get("moe"):
        a["moe"] = MoEConfig(**a["moe"])
    return ArchConfig(**a)


def pow2_buckets(max_len: int, lo: int = 8) -> List[int]:
    """The plan's automatic prefill buckets: powers of 2 from ``lo`` below
    ``max_len``, then ``max_len``."""
    out, b = [], lo
    while b < max_len:
        out.append(b)
        b *= 2
    return out + [max_len]


def buckets_of(plan: dict) -> List[int]:
    pb = plan.get("prefill_buckets", "auto")
    if pb == "auto":
        return pow2_buckets(plan["max_len"])
    return sorted({min(int(b), plan["max_len"]) for b in pb})


def make_plan(plan: dict):
    from repro_torch.core.plan import EndpointPlan, SharingVector
    pb = plan.get("prefill_buckets", "auto")
    return EndpointPlan(
        vector=SharingVector(pages=int(plan.get("pages", 1))),
        n_slots=int(plan["n_slots"]), max_len=int(plan["max_len"]),
        decode_horizon=int(plan["decode_horizon"]),
        prefill_buckets=pb if pb == "auto" else tuple(pb),
        page_budget=plan.get("page_budget"), executor="continuous")


def connect(cell: spec.Cell, params, device):
    from repro_torch.serve import connect as program_connect
    client = program_connect(arch_config(cell.cfg), make_plan(
        cell.data["plan"]), params=params, device=device)
    return client


def draw_weights(cell: spec.Cell, seed: int, device):
    from repro_torch.models import Model
    abstract = Model(arch_config(cell.cfg), "meta").abstract_params()
    dtype = getattr(torch, cell.cfg["dtype"])
    return weights_mod.draw(abstract, seed, device, dtype)


# ----- requests and the loop ---------------------------------------------
@dataclasses.dataclass
class Tracked:
    """One request as the benchmark follows it (host clock, seconds)."""

    rid: int
    prompt_len: int
    max_new: int
    due: float
    submitted: float = math.nan
    first: Optional[float] = None
    last: Optional[float] = None
    done: Optional[float] = None
    seen: int = 0
    out: Optional[list] = None
    capacity_len: int = 0
    slot: int = -1
    req: object = None


class Loop:
    """Drives one engine with the benchmark's traffic (see the module
    docstring).  ``sync`` (the traced run) waits for the card after every
    call, so that each call's host time is its own; ``profile_from`` opens
    ``torch.profiler`` at that time, to close at the window's end."""

    def __init__(self, eng, cell: spec.Cell, draws, seed: int, t0: float,
                 seconds: float, sync: bool = False,
                 profile_from: Optional[float] = None):
        from repro_torch.serve.engine import Request
        self.Request = Request
        self.eng = eng
        self.cell = cell
        self.cfg = cell.cfg
        self.seed = seed
        self.vocab = cell.cfg["arch"]["vocab"]
        self.t0 = t0
        self.t_end = t0 + seconds
        self.sync = sync and eng.device.type == "cuda"
        self.profile_from = profile_from
        self.profile_s = float(cell.data["profile_s"])
        self.host_end = self.t_end        # host metrics: calls before this
        self.buckets = buckets_of(cell.data["plan"])
        self.layers = counts.layers(cell.cfg)
        closed = cell.mix["arrivals"] == "closed"
        self.closed = closed
        self.tracked: Dict[int, Tracked] = {}
        self.inflight: Dict[int, Tracked] = {}
        self.pending: List[Tracked] = []        # due, not yet submitted
        self.pool = []                          # a closed loop's next sizes
        for d in draws:
            if d.due is None:
                self.pool.append(d)
            else:
                self.pending.append(self._track(d, t0 + d.due))
        self.pending.sort(key=lambda t: (t.due, t.rid))
        self.window_tokens = 0
        self.lateness: List[float] = []
        self.calls = {"admit_calls": 0, "admitted": 0, "admit_max_s": 0.0,
                      "step_max_s": 0.0}
        # host time and work of the calls outside the profiled window
        self.admit_s = 0.0
        self.step_s = 0.0
        self.decode_steps = 0
        self.decode_flops = 0.0
        # the profiled window
        self.prof = None
        self.profiled = None                    # the stopped profiler
        self.prof_t = [0.0, 0.0]
        self.prof_steps = 0
        self.prof_rounds = 0
        self.decode_bound_s = 0.0
        self.flash_bound_s = 0.0

    def _track(self, d, due: float) -> Tracked:
        t = Tracked(rid=d.rid, prompt_len=d.prompt_len, max_new=d.max_new,
                    due=due)
        self.tracked[d.rid] = t
        return t

    def prompt(self, t: Tracked) -> np.ndarray:
        return generator.prompt_tokens(self.seed, t.rid, t.prompt_len,
                                       self.vocab)

    def _span(self, name: str):
        return (torch.profiler.record_function(name) if self.prof is not None
                else contextlib.nullcontext())

    def _sync(self):
        if self.sync:
            torch.cuda.synchronize()

    # ----- releasing requests ------------------------------------------
    def release(self, now: float, open_window: bool) -> None:
        while self.pending and self.pending[0].due <= now:
            t = self.pending.pop(0)
            t.req = self.Request(rid=t.rid, prompt=self.prompt(t),
                                 max_new_tokens=t.max_new)
            self.eng.submit(t.req)
            t.submitted = time.perf_counter()
            self.lateness.append(t.submitted - t.due)
            self.inflight[t.rid] = t
        if not open_window:
            self.pending.clear()

    def _next_client_request(self, now: float) -> None:
        if self.pool and now < self.t_end:
            self.pending.append(self._track(self.pool.pop(0), now))

    # ----- one admission call and one step -----------------------------
    def _round(self, rids: List[int], profiled: bool) -> None:
        lens = [self.tracked[r].prompt_len for r in rids]
        fit = [n for n in lens if self.buckets and n <= self.buckets[-1]]
        bucket = min((b for b in self.buckets if b >= max(fit)),
                     default=0) if fit else 0
        for r, n in zip(rids, lens):
            self.tracked[r].capacity_len = bucket if fit and n <= \
                self.buckets[-1] else n
        if profiled:
            self.prof_rounds += 1
            calls = ([fit] if fit else []) + [[n] for n in lens
                                              if not (fit and n <= self.
                                                      buckets[-1])]
            for call in calls:
                self.flash_bound_s += self.layers * counts.bound_s(
                    *counts.flash_call(self.cfg, call))

    def _slots(self, rids: List[int]) -> None:
        """The slot each request of a round landed in, read from the
        engine's slot table where it has one (the check's sample is drawn
        across slots)."""
        table = getattr(self.eng, "_slot_req", None) or ()
        where = {r.rid: s for s, r in enumerate(table) if r is not None}
        for r in rids:
            self.tracked[r].slot = where.get(r, -1)

    def iterate(self) -> None:
        eng = self.eng
        profiled = self.prof is not None
        n0 = len(eng.admit_order)
        ta = time.perf_counter()
        with self._span("bench.admit_waiting"):
            eng.admit_waiting()
        self._sync()
        tb = time.perf_counter()
        rids = eng.admit_order[n0:]
        if rids:
            self._round(rids, profiled)
            self._slots(rids)
        before = {r: t.seen for r, t in self.inflight.items()}
        steps0 = eng.stats["decode_steps"]
        with self._span("bench.step"):
            retired = eng.step()
        self._sync()
        tc = time.perf_counter()
        self._observe(tc, retired, before, profiled)
        if profiled:
            self.prof_steps += 1
        elif ta < self.host_end:
            self.admit_s += tb - ta
            self.step_s += tc - tb
            self.decode_steps += eng.stats["decode_steps"] - steps0
        if rids:
            c = self.calls
            c["admit_calls"] += 1
            c["admitted"] += len(rids)
            c["admit_max_s"] = max(c["admit_max_s"], tb - ta)
        self.calls["step_max_s"] = max(self.calls["step_max_s"], tc - tb)

    def _observe(self, now: float, retired, before, profiled: bool):
        by_step: Dict[int, List[int]] = {}
        contexts: List[int] = []
        for rid, t in self.inflight.items():
            n = len(t.req.output)
            s0 = before.get(rid, 0)
            if n <= s0:
                continue
            if t.seen == 0:
                t.first = now
            t.seen = n
            t.last = now
            if now < self.t_end:
                self.window_tokens += n - s0
            for i in range(n - s0):
                if s0 + i >= t.max_new:      # a cache-edge bonus token
                    break
                ctx = t.prompt_len + s0 + i + 1
                contexts.append(ctx)
                by_step.setdefault(i, []).append(ctx)
        if profiled:
            for ctxs in by_step.values():
                self.decode_bound_s += self.layers * counts.bound_s(
                    *counts.decode_attn_call(self.cfg, ctxs))
        elif now < self.host_end:
            self.decode_flops += counts.decode_flops(self.cfg, contexts)
        for req in retired:
            t = self.inflight.pop(req.rid, None)
            if t is None:
                continue
            t.done = now
            t.out = list(req.output)
            if self.closed:
                self._next_client_request(now)

    # ----- the phases --------------------------------------------------
    def window(self) -> None:
        """Until the window's end: release what is due, admit, step."""
        eng = self.eng
        while True:
            now = time.perf_counter()
            if now >= self.t_end:
                break
            self.tick(now)
            if self.profile_from is not None and self.prof is None \
                    and self.profiled is None and now >= self.profile_from:
                self._start_profile()
            elif self.prof is not None \
                    and now - self.prof_t[0] >= self.profile_s:
                self._stop_profile()
            self.release(now, True)
            if eng.has_work:
                self.iterate()
            else:
                nxt = self.pending[0].due if self.pending else self.t_end
                time.sleep(max(0.0, min(nxt, self.t_end)
                               - time.perf_counter()))
        if self.prof is not None:
            self._stop_profile()

    def tick(self, now: float) -> None:
        """Called at the top of every turn of the window (a hook)."""

    def drain(self) -> float:
        """After the window: step until every request due in it has shown
        its first token, ``WAIT_S`` at most; -> when the wait ended."""
        self.release(time.perf_counter(), False)
        limit = self.t_end + WAIT_S
        while any(t.first is None for t in self.due_in_window()) \
                and time.perf_counter() < limit and self.eng.has_work:
            self.iterate()
        return time.perf_counter()

    def _start_profile(self):
        now = time.perf_counter()
        self._sync_all()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.eng.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self._span_cm = torch.profiler.record_function(devtrace.WINDOW_SPAN)
        self._span_cm.__enter__()
        self.prof_t[0] = self.host_end = time.perf_counter()
        self.prof_costs = {"start_s": self.prof_t[0] - now}

    def _stop_profile(self):
        self._sync_all()
        self.prof_t[1] = time.perf_counter()
        self._span_cm.__exit__(None, None, None)
        self.prof.stop()
        self.prof_costs["stop_s"] = time.perf_counter() - self.prof_t[1]
        self.profiled, self.prof = self.prof, None

    def _sync_all(self):
        if self.eng.device.type == "cuda":
            torch.cuda.synchronize()

    # ----- results ------------------------------------------------------
    def due_in_window(self) -> List[Tracked]:
        return [t for t in self.tracked.values()
                if self.t0 <= t.due < self.t_end
                and not math.isnan(t.submitted)]

    def finished(self) -> List[Tracked]:
        return [t for t in self.tracked.values() if t.done is not None]


# ----- warm-up ------------------------------------------------------------
def warm_up(eng, cell: spec.Cell, seed: int) -> dict:
    """Run the shapes the cell's traffic will use, each once, so that
    nothing captures or builds in the window: a horizon of every length
    1..K (a request of that many tokens alone), and the admission round
    of every bucket the mix's prompts reach (bucketed cells), or prompts
    of the mix's shortest and longest length (exact-length cells)."""
    from repro_torch.serve.engine import Request
    plan = cell.data["plan"]
    k = int(plan["decode_horizon"])
    lo, hi = cell.mix["prompt"]["min"], cell.mix["prompt"]["max"]
    bk = buckets_of(plan)
    if bk:
        reach = [b for b in bk if b >= lo and (b == bk[0] or
                                               bk[bk.index(b) - 1] < hi)]
        lengths = [min(b, hi) for b in reach]
    else:
        lengths = [lo, hi]
    rng = np.random.default_rng([nonneg(seed), 3])
    vocab = cell.cfg["arch"]["vocab"]
    n_rounds = max(k, len(lengths))
    rid = WARM_RID
    for i in range(n_rounds):
        length = lengths[i % len(lengths)]
        eng.submit(Request(rid=rid, prompt=rng.integers(
            0, vocab, size=length).astype(np.int32),
            max_new_tokens=(i % k) + 1))
        rid += 1
        while eng.has_work:
            eng.admit_waiting()
            eng.step()
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    return {"rounds": n_rounds, "prompt_lengths": lengths,
            "horizon_graphs": eng.graph_count(),
            "admission_graphs": eng.admission_graph_count()}


# ----- one run ------------------------------------------------------------
def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_process: float = None):
    """One run of ``cell``; -> (the result, a dict of what else the run
    saw, the check's lines)."""
    t_process = T_PROCESS if t_process is None else t_process
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    data = cell.data
    marks = [time.perf_counter()]
    params = draw_weights(cell, seed, device)
    marks.append(time.perf_counter())
    client = connect(cell, params, device)
    eng = client.engine
    eng.start()
    marks.append(time.perf_counter())
    warm = warm_up(eng, cell, seed)
    if trace and on_card:
        # the profiler's first start loads and sets up its tracer, which
        # takes seconds: do it here, not inside the window
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]):
            torch.ones(1, device=device).add_(1)
            torch.cuda.synchronize()
    marks.append(time.perf_counter())
    warm["seconds"] = {"imports": marks[0] - t_process,
                       "weights": marks[1] - marks[0],
                       "connect": marks[2] - marks[1],
                       "warm_up": marks[3] - marks[2]}
    draws = generator.schedule(cell.mix, seconds,
                               rate=float(data.get("rate_per_s", 0.0)),
                               clients=int(data.get("clients", 0)))
    t0 = time.perf_counter()
    setup_s = t0 - t_process
    # the traced run profiles ``profile_s`` seconds that start 1.5 of
    # them before the window's end, so that a long call before them
    # cannot cut them short
    loop = Loop(eng, cell, draws, nonneg(seed), t0, seconds, sync=trace,
                profile_from=(t0 + seconds - 1.5 * float(data["profile_s"])
                              if trace else None))
    loop.window()
    t_wait = loop.drain()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    stats = dict(eng.stats)
    del client, eng, params
    loop.eng = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    due = loop.due_in_window()
    missing = [t for t in due if t.first is None]
    ttft = [((t.first if t.first is not None else t_wait) - t.due) * 1e3
            for t in due]
    done_in = [t for t in loop.finished() if t.done < loop.t_end
               and t.seen >= 2]
    tpots = [tpot(t.first, t.last, t.seen) * 1e3 for t in done_in]
    info = {
        "attempted": len(due), "ttft_samples": len(ttft),
        "tpot_samples": len(tpots), "window_tokens": loop.window_tokens,
        "finished": len(loop.finished()), "warm_up": warm,
        "lateness_ms": ({"p50": percentile(loop.lateness, 50) * 1e3,
                         "p99": percentile(loop.lateness, 99) * 1e3,
                         "max": max(loop.lateness) * 1e3}
                        if loop.lateness else None),
        "engine": stats, "calls": loop.calls,
    }
    metrics = {}
    if not trace:
        values = {
            "out_tok_s": per_second(loop.window_tokens, seconds),
            "ttft_p90_ms": percentile(ttft, 90) if ttft else None,
            "tpot_p90_ms": percentile(tpots, 90) if tpots else None,
            "mem_gib": peak / 2 ** 30,
            "setup_s": setup_s,
        }
        for m in cell.end_to_end:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": int(cell.entry["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": False, "attempted": len(due),
              "failed": len(missing), "metrics": metrics, "device": dev}
    if trace:
        records = trace_records(loop, cell, seconds)
        for m in cell.per_layer:
            value = spec.reader(m["name"])(records)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        prof = records["profile"]
        if prof is not None:
            dev["busy_s"] = prof["busy_s"]
            dev["window_s"] = prof["window_s"]
            result["breakdown"] = {"device_ops": prof["top"],
                                   "idle_gaps": prof["idle_gaps"]}
        info["profile"] = {k: v for k, v in (prof or {}).items()
                           if k not in ("kernels", "top", "idle_gaps")}

    t_check = time.perf_counter()
    readings, limits = judge(loop, cell, seed, device)
    info["check_s"] = time.perf_counter() - t_check
    info["drain_s"] = t_wait - loop.t_end
    result["correct"] = check.verdict(readings, limits)
    info["readings"] = readings
    result["checks"] = {k: {"value": readings[k], "limit": limits[k]}
                        for k in limits}
    lines = [f"check {k} {readings[k]!r} limit {limits[k]!r}"
             for k in limits]
    return result, info, lines


def trace_records(loop: Loop, cell: spec.Cell, seconds: float) -> dict:
    """What the per-layer readers read: host times and work of the calls
    outside the profiled window, and the profiled window's kernels with
    the bounds of the work it held."""
    prof = None
    p = loop.profiled
    if p is not None:
        t_parse = time.perf_counter()
        host = loop.prof_t[1] - loop.prof_t[0]
        prof = dict(devtrace.window(p), **devtrace.timeline(p),
                    host_s=host, steps=loop.prof_steps,
                    rounds=loop.prof_rounds,
                    decode_bound_s=loop.decode_bound_s,
                    flash_bound_s=loop.flash_bound_s)
        prof["idle_share"] = (1 - prof["busy_s"] / prof["window_s"]
                              if prof["window_s"] > 0 else None)
        prof.update(loop.prof_costs,
                    parse_s=time.perf_counter() - t_parse)
    host_s = loop.host_end - loop.t0
    return {"cfg": cell.cfg, "host_s": host_s, "admit_s": loop.admit_s,
            "step_s": loop.step_s, "decode_steps": loop.decode_steps,
            "decode_flops": loop.decode_flops, "profile": prof}


def sample_gaps(loop: Loop, cell: spec.Cell, seed: int, device: str,
                control: bool = False) -> dict:
    """The served tokens of the run's sample against the reference (and,
    with ``control``, the control's on the same positions): the widest
    and the mean gap of each, and the sample's size."""
    from perfbench.reference.dense import strict_fp32
    strict_fp32()
    picks = check.sample([{"rid": t.rid, "prompt_len": t.prompt_len,
                           "n_out": len(t.out), "slot": t.slot}
                          for t in loop.finished()],
                         int(cell.data["sample"]), seed,
                         int(cell.data["plan"]["n_slots"]))
    prog, ctl = [0.0, 0.0, 0], [0.0, 0.0, 0]
    if picks:
        model = spec.reference_model(cell.cfg["family"])
        w = draw_weights(cell, seed, device)
        ref = check.Ref(model, cell.cfg, w, device)
        low = check.Ref(model, cell.cfg, w, device, quant="fp8") \
            if control else None
        for p in picks:
            t = loop.tracked[p["rid"]]
            ctx = {"prompt_len": t.prompt_len,
                   "capacity_len": t.capacity_len or t.prompt_len}
            prompt = loop.prompt(t)
            _fold(prog, check.served_gaps(ref, prompt, t.out, ctx))
            if low is not None:
                _fold(ctl, check.control_gaps(ref, low, prompt, t.out, ctx))
    out = {"max_gap": prog[0], "mean_gap": prog[1] / max(1, prog[2]),
           "sampled": len(picks), "sampled_tokens": prog[2]}
    if control:
        out.update(control_max_gap=ctl[0],
                   control_mean_gap=ctl[1] / max(1, ctl[2]))
    return out


def _fold(acc, gaps) -> None:
    acc[0] = max(acc[0], gaps[0])
    acc[1] += gaps[1]
    acc[2] += gaps[2]


def judge(loop: Loop, cell: spec.Cell, seed: int, device: str):
    """The numbers ``correct`` compares, and their limits."""
    due = loop.due_in_window()
    gaps = sample_gaps(loop, cell, seed, device)
    # a run that finished nothing has nothing to compare: not correct
    readings = {"max_gap": gaps["max_gap"], "mean_gap": gaps["mean_gap"],
                "wrong_lengths": float(sum(len(t.out) != t.max_new
                                           for t in loop.finished())),
                "missing_first_tokens": float(sum(t.first is None
                                                  for t in due)),
                "nothing_finished": float(not gaps["sampled"])}
    # the gaps a cell compares, and their limits, are the cell's data
    # (a gap whose control reading does not clear it is not compared)
    limits = {k: float(v) for k, v in cell.data["limits"].items()}
    limits.update(wrong_lengths=0.0, missing_first_tokens=0.0,
                  nothing_finished=0.0)
    return readings, limits


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # the program under test: without it there is nothing to measure
    import repro_torch  # noqa: F401
    cell = spec.load_cell(args.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, info, lines = run_cell(cell, args.seed, args.seconds,
                                   bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"perfbench: the process loaded {found}: the benchmark "
              f"measures the port alone", file=sys.stderr)
        return 3
    print("info " + json.dumps(info), file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
