"""Reading a ``torch.profiler`` window of the card.

``window`` is a frozen copy of the per-kernel half of the program's
window arithmetic (``repro_torch.launch.trace_serve._window``): the
device-side events of ``key_averages()``, each kernel's self time, and
the kernels that took the most time; the roofline readers read it.
``timeline`` alone gives the busy time: it reads the events' intervals
inside the benchmark's span around the profiled window, their union (so
no interval counts twice and none outside the window counts), and the
stretches in which nothing ran, each put down to what the host was doing
then (the benchmark's own span around the call, and the innermost
operation the profiler saw running).
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

#: the port's hand-written kernels, by a part of their device names; a
#: decode wrapper call runs its split kernel and the combine kernel both
#: decode libraries share
DECODE_KERNELS = ("ragged_split_kernel", "paged_split_kernel",
                  "decode_combine_kernel")
FLASH_KERNELS = ("flash_attention_kernel",)
#: the benchmark's spans around its calls into the program
SPAN_PREFIX = "bench."
#: the benchmark's span around the whole profiled window
WINDOW_SPAN = "bench.window"
#: gaps shorter than this are launch latency, not idleness worth naming
MIN_GAP_US = 5.0


def _is_device(e) -> bool:
    """A device operation: a kernel, copy or set.  The device timeline
    also carries the benchmark's own spans (user annotations, named
    ``bench.*``), which span whole calls and are left out."""
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not _name(e).startswith(SPAN_PREFIX))


def _name(e) -> str:
    return getattr(e, "key", None) or e.name


def window(prof, top: int = 10) -> dict:
    """-> ``kernels`` ({name: seconds}, every device operation) and
    ``top`` ([name, seconds] of the ``top`` longest), from
    ``key_averages()``."""
    rows = [e for e in prof.key_averages()
            if _is_device(e) and e.self_device_time_total > 0]
    rows.sort(key=lambda e: -e.self_device_time_total)
    kernels: Dict[str, float] = defaultdict(float)
    for e in rows:
        kernels[e.key] += e.self_device_time_total / 1e6
    return {"kernels": dict(kernels),
            "top": [[e.key[:120], e.self_device_time_total / 1e6]
                    for e in rows[:top]]}


def seconds_of(kernels: Dict[str, float], parts) -> float:
    """Seconds of the kernels whose names hold one of ``parts``."""
    return sum(s for name, s in kernels.items()
               if any(p in name for p in parts))


def _innermost(t, events, keys):
    """The latest-starting of ``events`` (sorted (start, end, name)) that
    covers ``t``: nested events start later than their parents."""
    i = bisect.bisect_right(keys, t) - 1
    for j in range(i, max(-1, i - 4000), -1):
        s, e, name = events[j]
        if s <= t < e:
            return name
    return None


def timeline(prof, span: str = WINDOW_SPAN, top: int = 10) -> dict:
    """The device's timeline inside the benchmark's ``span`` (the profiled
    window, as the profiler's clock has it): ``window_s``, ``busy_s`` (the
    union of the device operations' intervals in it) and ``idle_gaps``:
    the stretches in which nothing ran on the device, summed by what the
    host was doing when each began, ``[label, seconds]``, longest first.
    A label is the benchmark's span then (``bench.step`` ...;
    ``bench.loop`` between its calls) and the innermost host operation
    running."""
    dev: List[Tuple[float, float]] = []
    host: List[Tuple[float, float, str]] = []
    lo = hi = None
    for e in prof.events():
        tr = e.time_range
        if _is_device(e):
            dev.append((tr.start, tr.end))
        else:
            host.append((tr.start, tr.end, e.name))
            if e.name == span:
                lo, hi = tr.start, tr.end
    if lo is None:
        return {"window_s": 0.0, "busy_s": 0.0, "idle_gaps": []}
    dev = sorted((max(s, lo), min(e, hi)) for s, e in dev
                 if e > lo and s < hi)
    busy = 0.0
    gaps = []
    cursor = lo
    for s, e in dev:
        if s > cursor:
            gaps.append((cursor, s))
        if e > cursor:
            busy += e - max(s, cursor)
            cursor = e
    if hi > cursor:
        gaps.append((cursor, hi))
    host.sort()
    starts = [h[0] for h in host]
    spans = [h for h in host if h[2].startswith(SPAN_PREFIX)
             and h[2] != span]
    span_starts = [h[0] for h in spans]
    totals: Dict[str, float] = defaultdict(float)
    for s, e in gaps:
        if e - s < MIN_GAP_US:
            continue
        t = s + 1e-3
        where = _innermost(t, spans, span_starts) or "bench.loop"
        op = _innermost(t, host, starts)
        label = where if op in (None, where, span) else f"{where} > {op}"
        totals[label] += (e - s) / 1e6
    return {"window_s": (hi - lo) / 1e6, "busy_s": busy / 1e6,
            "idle_gaps": [[k[:120], v] for k, v in sorted(
                totals.items(), key=lambda kv: -kv[1])[:top]]}
