#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases (any failure exits non-zero, without the final result line):

1. the card's name and power limit (``nvidia-smi``);
2. build the four kernels (two decode-attention kernels, the prefill
   flash-attention kernel and the RG-LRU scan) from their packages'
   ``csrc/`` under ``src/repro_torch/kernels`` with nvcc for sm_90a, one
   nvcc each, all started together, timed, with ptxas' register and
   spill report for each instantiation and, for the flash kernel, its
   shared memory and its count of tensor-core (``HMMA``) instructions
   from ``cuobjdump -sass``: each body must be found at all four head_dim
   templates, the bf16 body must have some at each, and none may spill;
   each decode library must hold its five split instantiations (the SIMT
   body in fp32 and bf16 with 16-byte and element loads, the bf16
   tensor-core body at dh up to 64) and its two combine
   instantiations, none spilling; the RG-LRU library both passes of its
   chunked scan at the four (a, x) dtype pairs, none spilling;
3. each decode kernel against its plain PyTorch version on the card, at
   qwen2-0.5b's decode heads (Hkv=2, G=7, dh=64) over a cache of 1024
   and one of 4096 keys, fp32 and bf16 (bf16 also row by row), softcap 0
   and 30, edge lengths, lengths on both sides of the split kernel's
   chunk edges and the long prompts' lengths, and for the paged kernel a
   fragmented page table with sentinels over a tight pool, contiguous =
   paged bit for bit at both caches; then the
   RG-LRU scan against its plain version at T in {1, 7, 2048, 3001}, C in
   {64, 2560}, fp32 and bf16, with ``a`` near 0.999 so the carry grows,
   and on strided views, two calls equal bit for bit; then the flash
   kernel against its plain version over the reference's sweep (dh 8 to
   256, G 1 to 10, windows 0, 16, 64 and 2048, non-causal with Sk != Sq,
   softcap 10), at the lengths 1, 7,
   1023, 1024, 1500 and 3001, at lengths on both sides of the tensor-core
   body's tiles (15 to 129), a window ending mid-tile, and on strided
   views, fp32 and bf16 (bf16 held to its limit per case and per row);
4. qwen2-0.5b at full width (24 layers, random weights from
   ``torch.Generator`` seed 0) served through ``repro_torch.serve.connect``
   with a contiguous and with a paged (pages=4) cache: 16 requests, every
   one must return its tokens, each decode kernel's launch count must
   equal layers x executed decode steps of its run and the flash
   kernel's layers x prefills (on the card, here and in every later
   serving phase, each fused horizon replays the engine's CUDA graph of
   its length, which counts the launches it holds); then, contiguous, 8
   of the prompts with budgets of 1 to 64 tokens on one ordered stream,
   served with the engine's cut of each horizon at the last live step
   and without it (every horizon runs K steps): the same tokens, and
   steps launched against executed;
5. qwen2-0.5b at full width with long prompts (1023 to 4000 tokens, pow2
   buckets, max_len 4096): 8 requests of 32 tokens at once, contiguous
   and paged, which must agree on every token, with the flash kernel
   launched layers x prefills; then the same prompts one at a time on
   one stream, so each prefills alone in its bucket (1024, 2048, 4096);
6. the fused horizon as CUDA graphs against the eager body (the engine's
   horizon runner swapped for ``Model.decode_horizon`` launched op by
   op): qwen2-0.5b contiguous and paged on phase 4's prompts and
   recurrentgemma-2b on all of phase 8's, once each way; the tokens must
   agree, every one, the decode kernel launch layers x steps launched in
   both modes, each engine capture 1 to K graphs and a second run on it
   capture none; decode tok/s, max_memory_allocated and the graph count
   of both modes are printed;
7. the qwen2-0.5b smoke config at fp32 served on the card (kernels,
   horizon graphs) and on the CPU (plain versions, chunked attention for
   the round with a 1100-token prompt): the tokens must agree;
8. recurrentgemma-2b at full width (26 layers: 18 RG-LRU blocks and 8
   local-attention blocks with window 2048, random weights from a
   ``torch.Generator`` seed 0) served through ``connect``: 8 slots,
   max_len 4096, horizon 8, 12 requests of 64 new tokens with prompts
   from 64 to 3500 tokens (four prefill past the window, four cross
   position 2048 while decoding, four stay inside it); every request
   must return its 64 tokens, the RG-LRU kernel must launch 18 times and
   the flash kernel 8 times per prefill, and the decode kernels never
   (rolling layers take plain decode attention, as in the reference);
9. the recurrentgemma smoke config at fp32 served on the card and on the
   CPU, prompts past its window of 16: the tokens must agree;
10. qwen2-0.5b at full width on phase 4's weights (bf16, 8 slots,
   max_len 1024, horizon 8) through the rest of the serving surface:
   the wave executor on 8 prompts of 128 and 8 of 512 tokens (every
   request its 64 tokens; flash launched 48 and ragged decode 3072
   times; its agreement with the continuous engine printed, not gated:
   other GEMM shapes in bf16); prefill/decode disaggregation
   (``prefill_only`` on one engine, the payloads decoded on another)
   contiguous and paged, equal on every token to a co-located engine at
   exact-length admission, with ``kv_tokens`` and ``kv_bytes`` checked;
   live migration after 2 horizons (``export_sessions``, contiguous to
   contiguous, paged to paged, paged to contiguous), equal on every
   token to the uninterrupted run, the source's pages all free;
   ``evacuate`` with 8 live and 8 queued requests (prefixes, pages,
   graphs), then 8 fresh requests equal to a fresh engine's with no new
   capture; ``connect(obs=enabled_obs())`` (the trace validates, one
   span per request, the engine counters equal ``stats`` and
   ``compile_count()``, one graph);
   ``replan`` between two runs (one regroup, the graphs kept, one
   transition); times export and handoff admission per session against
   the copy bound (garbage collected before, none during);
11. the fleet at full width: qwen2-0.5b on phase 4's weights, 4 workers
   of 8 slots (max_len 1024, horizon 8) behind the fabric router, phase
   4's 16 prompts and 16 more from the same range in two bursts (64 new
   tokens each).  At fp32, each run's tokens must equal a single
   continuous engine's on the same prompts, every one: diag1, then on
   the same engines diag4 and adaptive diag2 (``replan``), diag4 paged
   (page size 64), 2P+2D, a crash of worker 0 mid-decode (recovered by
   re-prefilling prompt + emitted prefix on a survivor) and a scheduled
   migration w1 -> w2; each run's kernel launches must equal what its
   engines' prefills and launched horizon steps account for, no engine
   may capture more than K graphs, and every engine must serve from the
   one weight copy on the card.  In bf16, the fleet at exec level 4
   (one graph memory pool for the fleet) and at exec level 1 (one per
   engine): wall time, tok/s (tokens over the run's host time, captures
   included, then a second run without), graphs captured, peak memory
   and the graph pools' bytes, beside a single engine on the same
   prompts;
12. per kernel: its error against the plain version at the main path's
   shapes (the decode kernels at phase 4's and phase 5's caches, 1024 and
   4096 keys; the flash kernel at both models' prefill shapes and at
   qwen2-0.5b's batched admission of 8 x 4096 rows; held to the
   tolerance, bf16 attention also row by row, each row's error scaled by
   its own max |plain|; the RG-LRU scan at (1, T, 2560) fp32 for T 2048
   and 3500), time per call (the decode kernels and the RG-LRU scan also
   replayed in a CUDA graph, without the host's dispatch), its bound, the
   plain version's time and, for attention,
   ``scaled_dot_product_attention``'s (a yardstick the port never calls;
   no PyTorch call computes a linear recurrence), as one JSON line;
13. the planner at full width: qwen2-0.5b on phase 4's weights, 8 workers
   of 4 slots (the committed plan repository's fleet), max_len 1024,
   horizon 8, phase 11's 32 requests.  At fp32 each run's tokens must
   equal a single engine's on the same prompts, every one, with its
   launch gates and at most K graphs an engine:
   ``Hints(latency_target_ms=80, burstiness=0.9)`` resolved
   analytically, an explicit ``EndpointPlan`` of the vector it resolves
   to, ``Hints()`` through a copy of
   ``benchmarks/baselines/plan_repo.sqlite`` (the vector must be one of
   its frontier vectors), and that with ``adaptive=True`` (its
   transitions printed, and how many were repository jumps).  Then the
   smoke config at fp32, 4 workers of 4 slots, ``Hints(burstiness=0.9)``
   on a repository of the port's tuner, adaptive: the card's tokens and
   ``FleetReport`` (every field, ``exec.jit_compiles`` and the
   transitions included) must equal the CPU's.  In bf16 the tuned plan
   against the analytic one: tok/s over host time (a first and a second
   run), graphs per engine, specializations per exec group, graph pool
   bytes and ``max_memory_reserved``.

The last line is ``{"ok": true, "device": {...}}``.  The script imports
torch, numpy and ``repro_torch`` (from ``src/``), nothing of JAX.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import re
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

MEM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
FP32_FLOPS_PER_S = 67e12        # H100 SXM fp32, outside the tensor cores
BF16_FLOPS_PER_S = 989e12       # H100 SXM bf16, dense tensor cores
FP32_TOL = 5e-5
#: bf16 limit per case, times max|plain output|: between 2 and 4 bf16 ulps
#: of the largest output.  Kernel and plain version both accumulate in
#: fp32 and round once to bf16, so they differ by about one ulp; the
#: flash kernel's tensor-core P V also rounds P to bf16, which
#: ``tests/test_torch_flash.py`` emulates within this limit.
BF16_REL_TOL = 4 * 2.0 ** -8
B, HKV, G, DH, SMAX = 8, 2, 7, 64, 1024
N_REQUESTS, MAX_NEW, N_SLOTS, HORIZON = 16, 64, 8, 8
#: recurrentgemma-2b's phase: cache length and prompt lengths
RG_MAX_LEN = 4096
RG_PROMPTS = (64, 300, 1000, 1500, 2000, 2000, 2030, 2040, 2100, 2500,
              3000, 3500)
#: qwen2-0.5b's long-prompt phase: cache length, prompt lengths (on both
#: sides of 1024 and of the pow2 buckets), new tokens per request
LONG_MAX_LEN = 4096
LONG_PROMPTS = (1023, 1024, 1025, 1500, 2047, 2049, 3000, 4000)
LONG_MAX_NEW = 32
#: RG-LRU scan limit in fp32, times max(1, max|plain output|): the kernel
#: repeats the plain version's operations in its order
RGLRU_FP32_REL_TOL = 1e-5

KERNELS = {
    "ragged_decode": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "ragged_decode.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:132",
    },
    "paged_decode": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "paged_decode.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:227",
    },
    "flash_attention": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:279",
    },
    "rglru_scan": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/rglru/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru/kernel.py:44",
    },
}


def log(msg: str) -> None:
    print(msg, flush=True)


# ----- phase 1 ---------------------------------------------------------------

def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# ----- phase 2 ---------------------------------------------------------------

def _ptxas_report(log_text: str) -> dict:
    """ptxas -v output -> {entry function: {"registers", "stack_frame",
    "spill_stores", "spill_loads"}}."""
    report, fn = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            report[fn] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            report[fn].update(spill_stores=int(m.group(1)),
                              spill_loads=int(m.group(2)))
        m = re.search(r"(\d+) bytes stack frame", line)
        if m and fn:
            report[fn]["stack_frame"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            report[fn]["registers"] = int(m.group(1))
    return report


def _hmma_counts(library: str) -> dict:
    """{function: HMMA (tensor-core) instructions} in a library's SASS."""
    from repro_torch.kernels import build
    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", library],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn and "HMMA" in line:
            counts[fn] += 1
    return counts


#: the decode libraries' split-kernel instantiations: (dtype, elements
#: per load, DHC): the SIMT body (DHC 0) with 16-byte and with element
#: loads, and the bf16 tensor-core body at dh up to 64
DECODE_SPLITS = {("fp32", 4, 0), ("fp32", 1, 0), ("bf16", 8, 0),
                 ("bf16", 1, 0), ("bf16", 8, 64)}
_MANGLED_DTYPES = {"f": "fp32", "13__nv_bfloat16": "bf16"}


def _decode_build_gate(name: str, item: dict, lib) -> None:
    """Print each split and combine instantiation's registers, spills and
    shared memory; fail on a spill or a missing instantiation."""
    lib.decode_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.decode_smem_bytes.restype = ctypes.c_longlong
    kind = name.split("_")[0]
    splits, combines, faults = set(), set(), []
    for fn, r in sorted(_ptxas_report(item["ptxas"]).items()):
        m = re.search(rf"{kind}_split_kernelI(f|13__nv_bfloat16)Li(\d+)ELi"
                      rf"(\d+)E", fn)
        c = re.search(r"decode_combine_kernelI(f|13__nv_bfloat16)E", fn)
        if m:
            key = (_MANGLED_DTYPES[m.group(1)], int(m.group(2)),
                   int(m.group(3)))
            splits.add(key)
            what = (f"split {key[0]}, tensor cores, dh <= {key[2]}" if key[2]
                    else f"split {key[0]}, {key[1]} element(s) a load")
        elif c:
            combines.add(_MANGLED_DTYPES[c.group(1)])
            what = f"combine {_MANGLED_DTYPES[c.group(1)]}"
        else:
            continue
        log(f"    {name} {what}: {r.get('registers')} registers, "
            f"{r.get('stack_frame')} bytes of stack, spill stores "
            f"{r.get('spill_stores')} / loads {r.get('spill_loads')} bytes")
        if r.get("spill_stores") != 0 or r.get("spill_loads") != 0:
            faults.append(f"{what} spills")
    log(f"    dynamic shared memory per split block at dh={DH}: "
        f"{lib.decode_smem_bytes(DH, 0, 1)} bytes (fp32), "
        f"{lib.decode_smem_bytes(DH, 1, 1)} bytes (bf16, tensor cores)")
    if splits != DECODE_SPLITS:
        faults.append(f"split instantiations missing: "
                      f"{sorted(DECODE_SPLITS - splits)}")
    if combines != {"fp32", "bf16"}:
        faults.append(f"combine instantiations found: {sorted(combines)}")
    if faults:
        raise AssertionError(f"{name} build: {faults}")


def _rglru_build_gate(item: dict) -> None:
    """Print each pass's instantiations' registers and spills; fail on a
    spill or unless both passes have all four (a, x) dtype pairs."""
    found, faults = {"reduce": 0, "scan": 0}, []
    for fn, r in sorted(_ptxas_report(item["ptxas"]).items()):
        m = re.search(r"rglru_chunk_(reduce|scan)_kernelI(\w+?)EEv", fn)
        if not m:
            continue
        found[m.group(1)] += 1
        log(f"    rglru_scan pass {m.group(1)} <{m.group(2)}>: "
            f"{r.get('registers')} registers, {r.get('stack_frame')} bytes "
            f"of stack, spill stores {r.get('spill_stores')} / loads "
            f"{r.get('spill_loads')} bytes")
        if r.get("spill_stores") != 0 or r.get("spill_loads") != 0:
            faults.append(f"pass {m.group(1)} <{m.group(2)}> spills")
    if found != {"reduce": 4, "scan": 4}:
        faults.append(f"instantiations per pass {found}, expected 4 each")
    if faults:
        raise AssertionError(f"rglru_scan build: {faults}")


def build_kernels():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    info = build.build()
    log(f"built {len(info)} kernels in {time.perf_counter() - t0:.1f}s "
        f"(nvcc {' '.join(build.ARCH_FLAGS)})")
    for name, item in info.items():
        log(f"  {name}: {item['seconds']:.1f}s -> {item['path']}")
        lib = build.load(name)
        if name in ("ragged_decode", "paged_decode"):
            _decode_build_gate(name, item, lib)
            continue
        if name == "rglru_scan":
            _rglru_build_gate(item)
            continue
        # the flash library: one line per instantiation, with its
        # tensor-core instructions
        lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int,
                                                   ctypes.c_int]
        lib.flash_attention_smem_bytes.restype = ctypes.c_longlong
        hmma = _hmma_counts(item["path"])
        found, faults = {"simt": [], "mma": []}, []
        for fn, r in sorted(_ptxas_report(item["ptxas"]).items()):
            m = re.search(r"flash_attention_kernel_(simt|mma)I\w*?Li(\d+)E",
                          fn)
            if not m:
                continue
            body, cap = m.group(1), int(m.group(2))
            dtype = 1 if body == "mma" else 0
            log(f"    flash_attention {body} dh<={cap} "
                f"({'bf16' if dtype else 'fp32'}): {r.get('registers')} "
                f"registers, spill stores {r.get('spill_stores')} / loads "
                f"{r.get('spill_loads')} bytes, "
                f"{lib.flash_attention_smem_bytes(cap, dtype)} bytes of "
                f"shared memory per block, {hmma.get(fn, 0)} HMMA "
                f"instructions")
            found[body].append(cap)
            if body == "mma" and not hmma.get(fn):
                faults.append(f"the bf16 body at dh<={cap} has no "
                              f"tensor-core (HMMA) instruction")
            if r.get("spill_stores") != 0:
                faults.append(f"the {body} body at dh<={cap} spills "
                              f"{r.get('spill_stores')} bytes")
        log(f"    flash_attention library: {sum(hmma.values())} HMMA "
            f"instructions in all")
        for body in found:
            if sorted(found[body]) != [32, 64, 128, 256]:
                faults.append(f"{body} instantiations found at dh<= "
                              f"{sorted(found[body])}, expected 32, 64, "
                              f"128 and 256")
        if faults:
            raise AssertionError(f"flash_attention build: {faults}")


# ----- phase 3 ---------------------------------------------------------------

def tolerance(expect) -> float:
    """The limit on max |kernel - plain| for plain output ``expect``."""
    import torch
    if expect.dtype == torch.bfloat16:
        return BF16_REL_TOL * expect.float().abs().max().item()
    return FP32_TOL


def row_error(out, expect) -> float:
    """The largest, over rows (the head_dim values of one query and head),
    of a row's max |kernel - plain| over its own max |plain|.  A bf16
    attention kernel is held to ``BF16_REL_TOL`` on this too: rows that
    average over thousands of keys are far smaller than the first causal
    rows, which set the per-case limit."""
    err = (out.float() - expect.float()).abs().amax(-1)
    top = expect.float().abs().amax(-1)
    return (err / top.clamp_min(1e-30)).max().item()


def _rand(gen, shape, dtype):
    import torch
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _paged_table(gen, cur, max_pages, ps, n_pages):
    """Each row maps just the pages its length needs, drawn scrambled from
    one permutation of a pool smaller than B * max_pages; rows past the
    table (retired) map nothing.  Unmapped entries hold the sentinel N."""
    import torch
    perm = torch.randperm(n_pages, generator=gen, device="cuda")
    pt = torch.full((len(cur), max_pages), n_pages, dtype=torch.int32,
                    device="cuda")
    at = 0
    for b, c in enumerate(cur):
        if c >= max_pages * ps:
            continue
        m = c // ps + 1
        pt[b, :m] = perm[at:at + m].int()
        at += m
    assert at <= n_pages
    return pt


#: check_kernels' shapes: (Smax, lengths); the edges of the short cache,
#: both sides of the decode kernels' first chunk edges, and qwen2-0.5b's
#: long-prompt lengths (1039 to 4016 mid-decode) up to a retired row
DECODE_CHECKED = (
    (SMAX, (0, SMAX - 1, SMAX, 5000, 1, 63, 64, 700, 127, 128, 129, 255)),
    (LONG_MAX_LEN, (127, 128, 129, 1039, 2047, 2048, 3000, 4016, 4095,
                    5000)),
)


def check_kernels() -> None:
    import torch
    from repro_torch.kernels.flash_attention import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    ps = 64
    bad = []
    for smax, cur_list in DECODE_CHECKED:
        b = len(cur_list)
        cur = torch.tensor(cur_list, dtype=torch.int32, device="cuda")
        max_pages = smax // ps
        # tight: only the pages the live rows need, and two spare
        n_pages = sum(c // ps + 1 for c in cur_list if c < smax) + 2
        pt = _paged_table(gen, cur_list, max_pages, ps, n_pages)
        chunk, n_split = ops.decode_splits(smax)
        log(f"decode kernels at Smax {smax} ({n_split} splits of {chunk} "
            f"keys), lengths {list(cur_list)}:")
        for dtype in (torch.float32, torch.bfloat16):
            for softcap in (0.0, 30.0):
                q = _rand(gen, (b, 1, HKV * G, DH), dtype)
                k = _rand(gen, (b, smax, HKV, DH), dtype)
                v = _rand(gen, (b, smax, HKV, DH), dtype)
                kp = _rand(gen, (n_pages, ps, HKV, DH), dtype)
                vp = _rand(gen, (n_pages, ps, HKV, DH), dtype)
                for name, out, expect in (
                        ("ragged_decode",
                         ops.flash_decode_attention(q, k, v, cur,
                                                    softcap=softcap),
                         ref.ragged_decode_ref(q, k, v, cur,
                                               softcap=softcap)),
                        ("paged_decode",
                         ops.paged_flash_decode_attention(
                             q, kp, vp, pt, cur, softcap=softcap),
                         ref.paged_decode_ref(q, kp, vp, pt, cur,
                                              softcap=softcap))):
                    torch.cuda.synchronize()
                    err = (out.float() - expect.float()).abs().max().item()
                    tol = tolerance(expect)
                    rows = row_error(out, expect) \
                        if dtype == torch.bfloat16 else 0.0
                    log(f"  {name:13s} {dtype} softcap={softcap}: max abs "
                        f"err {err:.3e} (tolerance {tol:.3e})"
                        + (f", row-scaled err {rows:.4f} (limit "
                           f"{BF16_REL_TOL:.4f})" if rows else "")
                        + (f"; {n_pages}-page pool, fragmented table with "
                           f"sentinels" if name == "paged_decode" else ""))
                    if not (err <= tol and rows <= BF16_REL_TOL):
                        bad.append((name, smax, str(dtype), softcap, err,
                                    rows))
                # the same cache, contiguous and scattered over pages: both
                # kernels cut and walk keys the same way, so outputs are
                # equal
                perm = torch.randperm(b * max_pages, generator=gen,
                                      device="cuda")
                pages = torch.empty((b * max_pages, ps, HKV, DH),
                                    dtype=dtype, device="cuda")
                pages[perm] = k.reshape(b * max_pages, ps, HKV, DH)
                vpages = torch.empty_like(pages)
                vpages[perm] = v.reshape(b * max_pages, ps, HKV, DH)
                table = perm.reshape(b, max_pages).int()
                a = ops.flash_decode_attention(q, k, v, cur, softcap=softcap)
                c = ops.paged_flash_decode_attention(q, pages, vpages, table,
                                                     cur, softcap=softcap)
                same = torch.equal(a, c)
                log(f"  contiguous == paged on the same cache: {same}")
                if not same:
                    bad.append(("paged == contiguous", smax, str(dtype),
                                softcap, None, None))
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{bad}")


def rglru_tolerance(expect) -> float:
    import torch
    top = expect.float().abs().max().item()
    if expect.dtype == torch.bfloat16:
        return BF16_REL_TOL * top
    return RGLRU_FP32_REL_TOL * max(1.0, top)


def _rglru_inputs(gen, b, t, c, dtype):
    """a = 1 - 0.001 * U(0, 1), near 0.999, so the carry grows to about
    1000 times x; x standard normal."""
    import torch
    u = torch.rand((b, t, c), generator=gen, device="cuda")
    return (1.0 - 1e-3 * u).to(dtype), _rand(gen, (b, t, c), dtype)


def check_rglru() -> None:
    import torch
    from repro_torch.kernels.rglru import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(2)
    bad = []
    cases = [(dtype, t, c) for dtype in (torch.float32, torch.bfloat16)
             for c in (64, 2560) for t in (1, 7, 2048, 3001)]
    for dtype, t, c in cases + [("strided", 300, 2560)]:
        if dtype == "strided":
            a, x = _rglru_inputs(gen, 2, t, c, torch.float32)
            # a transposed view and every other channel of a wider tensor
            a_in = a.transpose(1, 2).contiguous().transpose(1, 2)
            x_in = torch.stack([x, -x], dim=-1).flatten(-2)[..., ::2]
        else:
            a, x = _rglru_inputs(gen, 2, t, c, dtype)
            a_in, x_in = a, x
        out = ops.rglru_scan(a_in, x_in)
        again = ops.rglru_scan(a_in, x_in)
        torch.cuda.synchronize()
        expect = ref.rglru_scan_ref(a, x)
        err = (out.float() - expect.float()).abs().max().item()
        tol = rglru_tolerance(expect)
        chunk, n_chunks = ops.scan_chunks(2, t, c)
        log(f"rglru_scan {dtype} B=2 T={t} C={c} ({n_chunks} chunks of "
            f"{chunk}): max abs err {err:.3e} (tolerance {tol:.3e}; max "
            f"|plain| {expect.float().abs().max().item():.1f})")
        if not err <= tol:
            bad.append((str(dtype), t, c, err))
        if not torch.equal(out, again):
            bad.append((str(dtype), t, c, "two calls differ"))
    if bad:
        raise AssertionError(f"rglru_scan disagrees with its plain version: "
                             f"{bad}")


#: the flash kernel's sweep: (B, Sq, Sk, Hq, Hkv, dh, causal, window,
#: softcap); the reference's test shapes, then qwen2-0.5b's heads (G=7,
#: dh 64) and recurrentgemma-2b's (G=10, dh 256, window 2048) at the
#: main paths' lengths, and at lengths on both sides of the tensor-core
#: body's tiles (64 keys; 128 query rows at dh 64, 64 at dh 256)
FLASH_CASES = [
    (1, 128, 128, 2, 2, 16, True, 0, 0.0),
    (2, 128, 128, 4, 2, 32, True, 0, 0.0),
    (1, 256, 256, 6, 2, 64, True, 0, 0.0),
    (2, 64, 64, 5, 1, 16, True, 0, 0.0),
    (1, 128, 128, 8, 8, 8, True, 0, 0.0),
    (1, 128, 128, 2, 1, 16, True, 16, 0.0),
    (1, 128, 128, 2, 1, 16, True, 64, 0.0),
    (1, 64, 128, 2, 2, 16, False, 0, 0.0),
    (1, 128, 128, 2, 2, 16, True, 0, 10.0),
    (1, 1, 1, 14, 2, 64, True, 0, 0.0),
    (2, 7, 7, 14, 2, 64, True, 0, 0.0),
    (1, 1023, 1023, 14, 2, 64, True, 0, 0.0),
    (2, 1024, 1024, 14, 2, 64, True, 0, 0.0),
    (1, 1500, 1500, 14, 2, 64, True, 0, 0.0),
    (1, 3001, 3001, 14, 2, 64, True, 0, 0.0),
    (1, 7, 7, 10, 1, 256, True, 2048, 0.0),
    (1, 1500, 1500, 10, 1, 256, True, 2048, 0.0),
    (1, 3001, 3001, 10, 1, 256, True, 2048, 0.0),
    (1, 200, 333, 10, 1, 256, False, 0, 0.0),
    *[(1, n, n, 14, 2, 64, True, 0, 0.0)
      for n in (15, 16, 17, 63, 65, 127, 128, 129)],
    *[(1, n, n, 10, 1, 256, True, 2048, 0.0)
      for n in (15, 16, 17, 63, 65, 127, 128, 129)],
    (1, 300, 300, 10, 1, 256, True, 100, 0.0),     # window ends mid-tile
    (2, 100, 257, 14, 2, 64, False, 0, 0.0),       # full, Sk != Sq
    (1, 257, 100, 14, 2, 64, False, 0, 0.0),
]


def check_flash() -> None:
    import torch
    from repro_torch.kernels.flash_attention import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(4)
    worst, bad = {}, []
    cases = [(dt, c) for dt in (torch.float32, torch.bfloat16)
             for c in FLASH_CASES]
    cases += [("strided", (1, 1500, 1500, 14, 2, 64, True, 0, 0.0)),
              ("strided", (1, 3001, 3001, 10, 1, 256, True, 2048, 0.0))]
    for dtype, (b, sq, sk, hq, hkv, dh, causal, window, softcap) in cases:
        kw = dict(causal=causal, window=window, softcap=softcap)
        if dtype == "strided":
            # q, k and v as views of one fused projection's output
            qkv = _rand(gen, (b, sq, hq + 2 * hkv, dh), torch.bfloat16)
            q, k, v = qkv.split((hq, hkv, hkv), dim=2)
            out = ops.flash_attention(q, k, v, **kw)
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        else:
            q = _rand(gen, (b, sq, hq, dh), dtype)
            k = _rand(gen, (b, sk, hkv, dh), dtype)
            v = _rand(gen, (b, sk, hkv, dh), dtype)
            out = ops.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        expect = ref.flash_attention_ref(q, k, v, **kw)
        err = (out.float() - expect.float()).abs().max().item()
        tol = tolerance(expect)
        rows = row_error(out, expect) if out.dtype == torch.bfloat16 else 0.0
        key = ("strided " if dtype == "strided" else "") + \
            ("bf16" if out.dtype == torch.bfloat16 else "fp32")
        e0, r0 = worst.get(key, (0.0, 0.0))
        worst[key] = max(e0, err), max(r0, rows)
        if not (err <= tol and rows <= BF16_REL_TOL) or \
                out.shape != q.shape:
            bad.append((str(dtype), b, sq, sk, hq, hkv, dh, causal, window,
                        softcap, err, tol, rows))
    for key, (err, rows) in worst.items():
        log(f"flash_attention {key}: largest max abs err {err:.3e} over "
            f"the sweep" + (f", largest row-scaled err {rows:.4f}"
                            if "bf16" in key else ""))
    log(f"flash_attention: {len(cases)} cases (fp32 limit {FP32_TOL}, "
        f"bf16 limit {BF16_REL_TOL:.4f} x max|plain| per case and per row)")
    if bad:
        raise AssertionError(f"flash_attention disagrees with its plain "
                             f"version: {bad}")


# ----- phase 4 ---------------------------------------------------------------

def _prompts(vocab, seed=0):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=int(rng.integers(64, 513)))
            .astype(np.int32) for _ in range(N_REQUESTS)]


def _plan(pages: bool, max_len: int = SMAX):
    from repro_torch.core.plan import EndpointPlan, SharingVector
    return EndpointPlan(vector=SharingVector(pages=4 if pages else 1),
                        n_slots=N_SLOTS, max_len=max_len,
                        decode_horizon=HORIZON, executor="continuous",
                        use_ragged_kernel=True)


def reset_counts() -> None:
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.rglru import ops as rglru_ops
    ops.reset_launch_counts()
    rglru_ops.reset_launch_counts()


def read_counts() -> dict:
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.rglru import ops as rglru_ops
    return dict(ops.LAUNCHES, **rglru_ops.LAUNCHES)


def fresh_peak() -> float:
    """Collect what earlier runs left in reference cycles (an engine that
    served one stream lives until a collection, with its weights and
    caches) and restart the card's peak-memory count; -> GiB live now."""
    import gc
    import torch
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated() / 2 ** 30


def _timed_steps(eng):
    """Wrap ``eng.step`` to add each call's host seconds (each ends in
    the horizon's host sync) to the returned one-item list; ``del
    eng.step`` undoes it."""
    import torch
    seconds, step = [0.0], eng.step
    on_card = eng.device.type == "cuda"

    def timed():
        if on_card:
            torch.cuda.synchronize()
        t = time.perf_counter()
        retired = step()
        seconds[0] += time.perf_counter() - t
        return retired

    eng.step = timed
    return seconds


def serve_once(cfg, params, prompts, pages: bool, device: str,
               max_new=None, capped: bool = True, one_stream: bool = False,
               max_len: int = SMAX, eager: bool = False, horizons=None):
    """Serve ``prompts`` through ``connect``, each asking for ``max_new[i]``
    tokens (default MAX_NEW), all at once or (``one_stream``) in order on
    one stream, each released when its predecessor retires; -> (outputs
    in prompt order, engine, launch counts of this run, decode seconds,
    wall seconds).  ``capped=False`` lets every horizon run all K steps,
    so steps after the last live slot are launched (and write nothing)
    instead of cut by the engine.  ``eager`` swaps the engine's horizon
    runner (on the card, its CUDA graphs) for the eager body,
    ``Model.decode_horizon`` launched op by op on the same buffers.
    ``horizons``, a list, receives the steps of each horizon launched."""
    import torch
    from repro_torch.serve import connect
    max_new = max_new or [MAX_NEW] * len(prompts)
    client = connect(cfg, _plan(pages, max_len), params=params,
                     device=device)
    stream = client.stream() if one_stream else None
    rids = [client.submit(p, max_new_tokens=n, stream=stream)
            for p, n in zip(prompts, max_new)]
    eng = client.engine
    if not capped:
        eng._horizon_steps = lambda: eng.decode_horizon
    run_horizon = eng._run_horizon
    if eager:
        def run_horizon(n):
            return eng._horizons.body(n)

    def counted_horizon(n):
        if horizons is not None:
            horizons.append(n)
        return run_horizon(n)

    eng._run_horizon = counted_horizon
    decode_s = _timed_steps(eng)
    reset_counts()
    t0 = time.perf_counter()
    out = client.run()
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    del eng.step      # the wrappers refer back to the engine: free them now
    del eng._run_horizon
    eng.__dict__.pop("_horizon_steps", None)
    return [out[r] for r in rids], eng, counts, decode_s[0], wall


def serve_full_width(card: str):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = get_config("qwen2-0.5b")
    t0 = time.perf_counter()
    params = Model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    log(f"qwen2-0.5b: {Model(cfg, 'cpu').n_params() / 1e6:.1f}M params, "
        f"{cfg.n_layers} layers, d_model {cfg.d_model}, vocab {cfg.vocab}, "
        f"drawn in {time.perf_counter() - t0:.1f}s")
    prompts = _prompts(cfg.vocab)
    runs, bad = {}, []
    for pages in (False, True):
        name = "paged_decode" if pages else "ragged_decode"
        fresh_peak()
        outs, eng, counts, dec_s, wall = serve_once(cfg, params, prompts,
                                                    pages, "cuda")
        steps = eng.stats["decode_steps"]
        expect = {k: 0 for k in counts}
        expect[name] = cfg.n_layers * steps
        expect["flash_attention"] = cfg.n_layers * eng.stats["prefills"]
        layout = "paged (pages=4, page size %d)" % eng.page_size \
            if pages else "contiguous"
        ok_tokens = all(len(o) == MAX_NEW and all(0 <= t < cfg.vocab
                                                  for t in o)
                        for o in outs)
        tok = eng.stats["busy_slot_steps"]
        log(f"serve {layout}: {len(outs)} requests, "
            f"{sum(map(len, outs))} tokens, {steps} decode steps in "
            f"{eng.stats['decode_calls']} horizons "
            f"({eng.graph_count()} graphs), {wall:.2f}s wall; "
            f"launches {counts} (expected {expect})")
        log(f"  decode {tok / dec_s:.1f} tok/s ({tok} tokens in "
            f"{dec_s:.3f}s, batch {N_SLOTS}, horizon {HORIZON}); "
            f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
            f"on {card}")
        if not ok_tokens:
            bad.append(f"{layout}: a request came back without its "
                       f"{MAX_NEW} tokens")
        if counts != expect:
            bad.append(f"{layout}: launches {counts} != {expect}")
        runs[name] = {"outs": outs, "launches": counts[name],
                      "tok_s": tok / dec_s}
        del eng
    a, c = runs["ragged_decode"]["outs"], runs["paged_decode"]["outs"]
    same = sum(x == y for p, q in zip(a, c) for x, y in zip(p, q))
    total = sum(len(p) for p in a)
    log(f"contiguous vs paged: {same}/{total} tokens agree "
        f"({same / total:.4f})")
    if bad:
        raise AssertionError("; ".join(bad))
    return runs, prompts, cfg, params


def horizon_cap(cfg, params, prompts, card: str) -> None:
    """The engine's cut of each horizon where every live slot's budget
    runs out, against horizons that always run K steps and rely on the
    on-device "any live" flag alone: full width, contiguous cache, one
    user's session (one ordered stream: one request in flight, so each
    request's last horizon runs past its end unless cut) of 8 of the
    prompts with budgets of 1 to MAX_NEW tokens, run in the order cut,
    uncut, uncut, cut.  Both must serve the same tokens; the cut runs
    launch the kernel exactly layers x executed steps."""
    import numpy as np
    prompts = prompts[:N_SLOTS]
    max_new = [int(n) for n in
               np.random.default_rng(2).integers(1, MAX_NEW + 1,
                                                 len(prompts))]
    total = {True: [0, 0, 0.0, 0], False: [0, 0, 0.0, 0]}
    outs, bad = {}, []
    for capped in (True, False, False, True):
        out, eng, counts, dec_s, _ = serve_once(
            cfg, params, prompts, False, "cuda", max_new, capped,
            one_stream=True)
        executed = eng.stats["decode_steps"]
        launched = counts["ragged_decode"] // cfg.n_layers
        tok = eng.stats["busy_slot_steps"]
        for i, x in enumerate((executed, launched, dec_s, tok)):
            total[capped][i] += x
        log(f"horizon {'cut' if capped else 'uncut'}: {executed} steps "
            f"executed, {launched} launched, {tok} tokens in "
            f"{dec_s:.3f}s decode ({tok / dec_s:.1f} tok/s)")
        if outs.setdefault(capped, out) != out or any(
                len(o) != n for o, n in zip(out, max_new)):
            bad.append(f"{'cut' if capped else 'uncut'}: tokens")
        if capped and counts["ragged_decode"] != cfg.n_layers * executed:
            bad.append(f"cut: {counts['ragged_decode']} launches for "
                       f"{executed} steps")
        del eng
    if outs[True] != outs[False]:
        bad.append("cut and uncut horizons serve different tokens")
    for capped in (True, False):
        executed, launched, dec_s, tok = total[capped]
        log(f"horizon {'cut' if capped else 'uncut'}, two runs: "
            f"{launched} steps launched for {executed} executed, "
            f"{dec_s:.3f}s decode, {tok / dec_s:.1f} tok/s; on {card}")
    if bad:
        raise AssertionError("; ".join(bad))


# ----- phase 5 ---------------------------------------------------------------

def serve_long_prompts(cfg, params, card: str):
    """Full-width qwen2-0.5b on prompts of 1023 to 4000 tokens: all 8 at
    once (one admission round, one batched prefill in the bucket of the
    longest), contiguous and paged, then one at a time on one stream
    (each prefills alone in its own bucket).  Every prefill's attention
    runs the flash kernel, every decode step a decode kernel."""
    import numpy as np
    import torch
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, cfg.vocab, size=n).astype(np.int32)
               for n in LONG_PROMPTS]
    max_new = [LONG_MAX_NEW] * len(prompts)
    runs, bad = {}, []
    for name, pages, one_stream in (("contiguous", False, False),
                                    ("paged", True, False),
                                    ("one stream", False, True)):
        live = fresh_peak()
        outs, eng, counts, dec_s, wall = serve_once(
            cfg, params, prompts, pages, "cuda", max_new,
            one_stream=one_stream, max_len=LONG_MAX_LEN)
        prefills, steps = eng.stats["prefills"], eng.stats["decode_steps"]
        expect = {k: 0 for k in counts}
        expect["paged_decode" if pages else "ragged_decode"] = \
            cfg.n_layers * steps
        expect["flash_attention"] = cfg.n_layers * prefills
        tok = eng.stats["busy_slot_steps"]
        log(f"long prompts {name} (buckets {list(eng.prefill_buckets)}): "
            f"{len(outs)} requests, {sum(map(len, outs))} tokens, "
            f"{prefills} prefills, {steps} decode steps "
            f"({eng.graph_count()} graphs); launches {counts} "
            f"(expected {expect})")
        log(f"  wall {wall:.2f}s, decode {tok / dec_s:.1f} tok/s ({tok} "
            f"tokens in {dec_s:.3f}s); max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({live:.2f} "
            f"GiB live before the run); on {card}")
        if not all(len(o) == LONG_MAX_NEW and all(0 <= t < cfg.vocab
                                                  for t in o) for o in outs):
            bad.append(f"{name}: a request came back without its "
                       f"{LONG_MAX_NEW} tokens")
        if counts != expect:
            bad.append(f"{name}: launches {counts} != {expect}")
        runs[name] = {"outs": outs, "launches": counts["flash_attention"],
                      "decode_launches": counts["paged_decode" if pages
                                                else "ragged_decode"],
                      "tok_s": tok / dec_s}
        del eng
    total = sum(map(len, runs["contiguous"]["outs"]))
    for other in ("paged", "one stream"):
        same = sum(x == y for p, q in zip(runs["contiguous"]["outs"],
                                          runs[other]["outs"])
                   for x, y in zip(p, q))
        log(f"contiguous vs {other}: {same}/{total} tokens agree")
    if runs["contiguous"]["outs"] != runs["paged"]["outs"]:
        bad.append("contiguous and paged serve different tokens")
    if bad:
        raise AssertionError("; ".join(bad))
    return runs


# ----- phase 6 ---------------------------------------------------------------

def _expected_launches(cfg, eng, launched: int, prefills=None) -> dict:
    """Each prefill launches the flash kernel in every attention layer and
    the RG-LRU scan in every RG-LRU layer; each decode step launched, the
    decode kernel in every layer of a stack that can page (a rolling
    window takes plain decode attention, as in the reference).
    ``prefills`` defaults to every prefill the engine ran."""
    n_rglru = sum(k == "rglru" for k in cfg.pattern_for(cfg.n_layers))
    if prefills is None:
        prefills = eng.stats["prefills"]
    expect = {"ragged_decode": 0, "paged_decode": 0,
              "flash_attention": (cfg.n_layers - n_rglru) * prefills,
              "rglru_scan": n_rglru * prefills}
    if eng.model.supports_paged_cache:
        expect["paged_decode" if eng.paged else "ragged_decode"] = \
            cfg.n_layers * launched
    return expect


def graph_vs_eager(prompts, cfg, params, card: str) -> dict:
    """The fused horizon as CUDA graphs against the eager body, at full
    width: qwen2-0.5b contiguous and paged on phase 4's prompts, and
    recurrentgemma-2b on all of phase 8's prompts.  Each serves once as
    the engine runs (each horizon a graph replay, captured at its first
    length), then once with the engine's horizon runner swapped for the
    eager body.  Gates: the same tokens, every one; in both modes the
    decode kernel launched layers x steps launched; 1 to K graphs in the
    graph mode, and a second run of the same requests on the same engine
    that captures nothing and serves the same tokens.  Prints decode
    tok/s (the graph mode's first run includes its captures, the second
    run none), max_memory_allocated of both modes and the graph count.
    -> {case: {mode: tok/s}}."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serve.engine import Request

    def recurrentgemma():
        rg_cfg = get_config("recurrentgemma-2b")
        return rg_cfg, Model(rg_cfg, "cuda").init(
            torch.Generator(device="cuda").manual_seed(0))

    cases = (("qwen2-0.5b contiguous", lambda: (cfg, params), prompts,
              False, SMAX),
             ("qwen2-0.5b paged", lambda: (cfg, params), prompts, True,
              SMAX),
             ("recurrentgemma-2b", recurrentgemma, None, False, RG_MAX_LEN))
    rates, bad = {}, []
    for name, weights, pr, pages, max_len in cases:
        c, p = weights()
        pr = pr or _rg_prompts(c.vocab, RG_PROMPTS, seed=3)
        outs, rates[name] = {}, {}
        for mode in ("graph", "eager"):
            live = fresh_peak()
            horizons = []
            outs[mode], eng, counts, dec_s, _ = serve_once(
                c, p, pr, pages, "cuda", max_len=max_len,
                eager=mode == "eager", horizons=horizons)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            expect = _expected_launches(c, eng, sum(horizons))
            tok = eng.stats["busy_slot_steps"]
            graphs = eng.graph_count()
            rates[name][mode] = tok / dec_s
            log(f"{name} {mode}: decode {tok / dec_s:.1f} tok/s ({tok} "
                f"tokens in {dec_s:.3f}s, {len(horizons)} horizons, "
                f"{sum(horizons)} steps launched, "
                f"{eng.stats['decode_steps']} executed); "
                f"max_memory_allocated {peak:.2f} GiB ({live:.2f} GiB live "
                f"before the run); {graphs} graphs (lengths "
                f"{sorted(set(horizons))}); launches {counts} (expected "
                f"{expect}); on {card}")
            if counts != expect:
                bad.append(f"{name} {mode}: launches {counts} != {expect}")
            if mode == "graph":
                if not 1 <= graphs <= HORIZON:
                    bad.append(f"{name}: {graphs} graphs, not 1 to "
                               f"{HORIZON}")
                # the same requests again on the same engine: the same
                # horizon lengths, so no capture
                n_done, tok0 = len(eng.done), tok
                for i, prompt in enumerate(pr):
                    eng.submit(Request(rid=len(pr) + i, prompt=prompt,
                                       max_new_tokens=MAX_NEW))
                seconds = _timed_steps(eng)
                again = [r.output for r in sorted(eng.run()[n_done:],
                                                  key=lambda r: r.rid)]
                del eng.step
                tok = eng.stats["busy_slot_steps"] - tok0
                rates[name]["graph, no capture"] = tok / seconds[0]
                log(f"  a second run on the same engine: decode "
                    f"{tok / seconds[0]:.1f} tok/s ({tok} tokens in "
                    f"{seconds[0]:.3f}s), {eng.graph_count()} graphs, "
                    f"tokens equal to the first run's: {again == outs[mode]}")
                if eng.graph_count() != graphs or again != outs[mode]:
                    bad.append(f"{name}: the second run captured or served "
                               f"other tokens")
            del eng
        same = sum(x == y for a, b in zip(outs["graph"], outs["eager"])
                   for x, y in zip(a, b))
        total = sum(map(len, outs["eager"]))
        log(f"{name}: graph vs eager {same}/{total} tokens agree; decode "
            f"{rates[name]['graph'] / rates[name]['eager']:.2f}x the eager "
            f"tok/s with the captures, "
            f"{rates[name]['graph, no capture'] / rates[name]['eager']:.2f}x "
            f"without; on {card}")
        if outs["graph"] != outs["eager"]:
            bad.append(f"{name}: graph and eager serve different tokens")
        del p
    if bad:
        raise AssertionError("; ".join(bad))
    return rates


# ----- phase 7 ---------------------------------------------------------------

def smoke_card_vs_cpu() -> None:
    """The smoke config at fp32 on the card and on the CPU; the first
    round holds a prompt of 1100 tokens (bucket 2048), so the CPU runs
    chunked attention where the card runs the flash kernel."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_smoke_config("qwen2-0.5b"),
                              compute_dtype="float32")
    params = Model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    prompts = _prompts(cfg.vocab, seed=1)
    prompts[0] = np.random.default_rng(1).integers(
        1, cfg.vocab, size=1100).astype(np.int32)
    bad = []
    for pages in (False, True):
        card, eng, counts, _, _ = serve_once(cfg, params, prompts, pages,
                                             "cuda", max_len=2048)
        cpu, _, cpu_counts, _, _ = serve_once(cfg, params, prompts, pages,
                                              "cpu", max_len=2048)
        same = sum(x == y for p, q in zip(card, cpu) for x, y in zip(p, q))
        total = sum(len(p) for p in cpu)
        log(f"smoke fp32 {'paged' if pages else 'contiguous'} (prompts "
            f"{min(map(len, prompts))} to {max(map(len, prompts))}): card "
            f"(kernels, launches {counts}) vs CPU (plain versions, "
            f"launches {cpu_counts}): {same}/{total} tokens agree")
        if card != cpu or sum(cpu_counts.values()) or counts[
                "flash_attention"] != cfg.n_layers * eng.stats["prefills"]:
            bad.append("paged" if pages else "contiguous")
    if bad:
        raise AssertionError(f"card and CPU tokens differ or the flash "
                             f"kernel did not run: {bad}")


# ----- phase 8 ---------------------------------------------------------------

def _rg_prompts(vocab, lengths, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=n).astype(np.int32)
            for n in lengths]


def serve_recurrentgemma(card: str):
    """Full-width recurrentgemma-2b through connect: exact-length
    admission, rolling caches, 18 RG-LRU and 8 flash-attention prefills
    per request on the kernels, no decode-kernel launch."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = get_config("recurrentgemma-2b")
    n_rglru = sum(k == "rglru" for k in cfg.pattern_for(cfg.n_layers))
    n_attn = cfg.n_layers - n_rglru
    t0 = time.perf_counter()
    params = Model(cfg, "cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    log(f"recurrentgemma-2b: {Model(cfg, 'cpu').n_params() / 1e6:.1f}M "
        f"params, {cfg.n_layers} layers ({n_rglru} RG-LRU, "
        f"{cfg.n_layers - n_rglru} local attention, window "
        f"{cfg.attn_window}), d_model {cfg.d_model}, lru {cfg.lru_width}, "
        f"vocab {cfg.vocab}, drawn on the card in "
        f"{time.perf_counter() - t0:.1f}s")
    prompts = _rg_prompts(cfg.vocab, RG_PROMPTS, seed=3)
    fresh_peak()
    outs, eng, counts, dec_s, wall = serve_once(
        cfg, params, prompts, False, "cuda", max_len=RG_MAX_LEN)
    prefills = eng.stats["prefills"]
    steps = eng.stats["decode_steps"]
    expect = {k: 0 for k in counts}
    expect["rglru_scan"] = n_rglru * prefills
    expect["flash_attention"] = n_attn * prefills
    tok = eng.stats["busy_slot_steps"]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"serve recurrentgemma-2b (contiguous rolling cache, buckets "
        f"{list(eng.prefill_buckets) or 'off'}, paged {eng.paged}): "
        f"{len(outs)} requests, {sum(map(len, outs))} tokens, {prefills} "
        f"prefills, {steps} decode steps in {eng.stats['decode_calls']} "
        f"horizons ({eng.graph_count()} graphs); launches {counts} "
        f"(expected {expect}; decode-attention "
        f"kernels {counts['ragged_decode'] + counts['paged_decode']})")
    log(f"  decode {tok / dec_s:.1f} tok/s ({tok} tokens in {dec_s:.3f}s, "
        f"batch {N_SLOTS}, horizon {HORIZON}); wall {wall:.2f}s; "
        f"max_memory_allocated {peak:.2f} GiB; on {card}")
    bad = []
    if not all(len(o) == MAX_NEW and all(0 <= t < cfg.vocab for t in o)
               for o in outs):
        bad.append(f"a request came back without its {MAX_NEW} tokens")
    if counts != expect or prefills != len(prompts):
        bad.append(f"launches {counts} != {expect} ({prefills} prefills)")
    # the served model's logits on the shortest prompt: finite, full vocab
    model = eng.model
    one = model.init_cache(1, RG_MAX_LEN)
    logits, _ = model.prefill(
        eng.params, {"tokens": torch.as_tensor(prompts[0][None],
                                               device="cuda")}, one)
    finite = bool(torch.isfinite(logits).all())
    log(f"  prefill logits on the {len(prompts[0])}-token prompt: shape "
        f"{tuple(logits.shape)}, finite {finite}, max |logit| "
        f"{logits.abs().max().item():.3f}")
    if not finite or logits.shape != (1, cfg.vocab):
        bad.append("prefill logits not finite or of the wrong shape")
    del eng, model, one, params
    if bad:
        raise AssertionError("; ".join(bad))
    return {"launches": counts["rglru_scan"], "tok_s": tok / dec_s,
            "wall": wall, "prefills": prefills,
            "flash_launches": counts["flash_attention"]}


# ----- phase 9 ---------------------------------------------------------------

def smoke_recurrentgemma_card_vs_cpu() -> None:
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_smoke_config("recurrentgemma-2b"),
                              compute_dtype="float32")
    params = Model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    lengths = np.random.default_rng(4).integers(4, 48, size=12)
    prompts = _rg_prompts(cfg.vocab, [int(n) for n in lengths], seed=5)
    card, eng, counts, _, _ = serve_once(cfg, params, prompts, False,
                                         "cuda", max_new=[16] * 12,
                                         max_len=64)
    cpu, _, cpu_counts, _, _ = serve_once(cfg, params, prompts, False,
                                          "cpu", max_new=[16] * 12,
                                          max_len=64)
    same = sum(x == y for p, q in zip(card, cpu) for x, y in zip(p, q))
    total = sum(len(p) for p in cpu)
    log(f"recurrentgemma smoke fp32 (window {cfg.attn_window}, prompts "
        f"{sorted(int(n) for n in lengths)}): card (launches {counts}) vs "
        f"CPU (plain versions, launches {cpu_counts}): {same}/{total} "
        f"tokens agree")
    n_rglru = sum(k == "rglru" for k in cfg.pattern_for(cfg.n_layers))
    prefills = eng.stats["prefills"]
    if card != cpu or sum(cpu_counts.values()) or \
            counts["rglru_scan"] != n_rglru * prefills or \
            counts["flash_attention"] != (cfg.n_layers - n_rglru) * prefills:
        raise AssertionError("recurrentgemma smoke: card and CPU differ or "
                             "the RG-LRU or flash kernel did not run")


# ----- phase 10 --------------------------------------------------------------

#: the wave phase's prompt lengths: two waves of N_SLOTS
WAVE_PROMPTS = (128,) * N_SLOTS + (512,) * N_SLOTS


def _sync() -> None:
    import torch
    torch.cuda.synchronize()


def _timed_ms(fn):
    """-> (fn's result, its ms on a synchronised host clock).  Garbage
    collection runs first and is off inside: a collection there would
    free earlier engines (their graphs and caches) on this clock."""
    import gc
    gc.collect()
    _sync()
    gc.disable()
    try:
        t = time.perf_counter()
        result = fn()
        _sync()
        return result, (time.perf_counter() - t) * 1e3
    finally:
        gc.enable()


def _engine(cfg, weights, pages: bool, **plan_fields):
    """A continuous engine on the card over phase 4's plan (contiguous or
    paged level 4), with ``plan_fields`` replaced."""
    from repro_torch.serve.engine import ContinuousEngine
    plan = dataclasses.replace(_plan(pages), **plan_fields)
    return ContinuousEngine(cfg, weights, plan, device="cuda")


def _requests(prompts, rid0: int = 0, handoffs=None):
    """One request of MAX_NEW tokens per prompt, rids from ``rid0``; with
    ``handoffs`` each carries its KV payload and the payload's rid."""
    from repro_torch.serve.engine import Request
    handoffs = handoffs or [None] * len(prompts)
    return [Request(rid=rid0 + i if h is None else h.rid, prompt=p,
                    max_new_tokens=MAX_NEW, kv=h)
            for i, (p, h) in enumerate(zip(prompts, handoffs))]


def _serve(eng, requests) -> dict:
    """Submit ``requests`` to ``eng`` and run it; -> {rid: tokens} of the
    requests this run retired."""
    for r in requests:
        eng.submit(r)
    n_done = len(eng.done)
    return {r.rid: list(r.output) for r in eng.run()[n_done:]}


def _agree(a: dict, b: dict):
    """-> (tokens equal at the same place, tokens of ``a``)."""
    same = sum(x == y for rid in a for x, y in zip(a[rid], b.get(rid, [])))
    return same, sum(map(len, a.values()))


def _wave_vs_continuous(cfg, weights, card, bad) -> dict:
    """The wave executor through ``connect``: 16 requests of 64 tokens,
    8 prompts of 128 and 8 of 512 tokens (two waves of 8), then the
    continuous engine on the same prompts."""
    import numpy as np
    import torch
    from repro_torch.serve import connect
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, cfg.vocab, size=n).astype(np.int32)
               for n in WAVE_PROMPTS]
    fresh_peak()
    client = connect(cfg, executor="wave", n_slots=N_SLOTS, max_len=SMAX,
                     params=weights)
    rids = [client.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
    model, prefill_s = client.engine.model, [0.0]
    prefill = model.prefill

    def timed_prefill(*args, **kw):
        _sync()
        t = time.perf_counter()
        result = prefill(*args, **kw)
        _sync()
        prefill_s[0] += time.perf_counter() - t
        return result

    model.prefill = timed_prefill
    reset_counts()
    t0 = time.perf_counter()
    out = client.run()
    _sync()
    wall = time.perf_counter() - t0
    counts = read_counts()
    del model.prefill
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    wave = {r: out[r] for r in rids}
    n_tok = sum(map(len, wave.values()))
    dec_s = wall - prefill_s[0]
    expect = {k: 0 for k in counts}
    expect["flash_attention"] = 2 * cfg.n_layers
    expect["ragged_decode"] = 2 * MAX_NEW * cfg.n_layers
    log(f"wave: {len(wave)} requests ({N_SLOTS} x {WAVE_PROMPTS[0]} and "
        f"{N_SLOTS} x {WAVE_PROMPTS[-1]} tokens), {n_tok} tokens in "
        f"{wall:.3f}s ({n_tok / wall:.1f} tok/s with prefill); decode "
        f"{n_tok / dec_s:.1f} tok/s ({dec_s:.3f}s, prefill {prefill_s[0]:.3f}"
        f"s); max_memory_allocated {peak:.2f} GiB; launches {counts} "
        f"(expected {expect}); on {card}")
    if any(len(t) != MAX_NEW or not all(0 <= x < cfg.vocab for x in t)
           for t in wave.values()):
        bad.append(f"wave: a request came back without its {MAX_NEW} "
                   f"tokens")
    if counts != expect:
        bad.append(f"wave: launches {counts} != {expect}")
    outs, eng, _, cont_s, _ = serve_once(cfg, weights, prompts, False,
                                         "cuda")
    tok = eng.stats["busy_slot_steps"]
    same, total = _agree(wave, {r: o for r, o in zip(rids, outs)})
    log(f"  continuous on the same prompts: decode {tok / cont_s:.1f} "
        f"tok/s ({eng.graph_count()} graphs, capture included); wave "
        f"vs continuous {same}/{total} tokens agree ({same / total:.4f}, "
        f"bf16: other GEMM shapes, not gated); on {card}")
    return {"wave_tok_s": n_tok / dec_s, "continuous_tok_s": tok / cont_s,
            "agree": same / total}


def _disaggregation(cfg, weights, prompts, card, bad) -> dict:
    """Engine P prefills (``prefill_only``), engine D admits the payloads
    and decodes, against one co-located engine, all at exact-length
    admission (the same GEMM shapes), contiguous and paged."""
    from repro_torch.serve.engine import _cache_bytes
    admit_ms = {}
    for pages in (False, True):
        layout = "paged" if pages else "contiguous"
        prefill = _engine(cfg, weights, pages, prefill_buckets=None)
        handoffs = [prefill.prefill_only(r) for r in _requests(prompts)]
        full = _cache_bytes(handoffs[0].cache, SMAX, SMAX)
        for h, p in zip(handoffs, prompts):
            if h.kv_tokens != len(p) or h.kv_bytes != _cache_bytes(
                    h.cache, h.pos, SMAX) or h.kv_bytes != int(
                    full * len(p) / SMAX):
                bad.append(f"{layout} handoff {h.rid}: kv_tokens "
                           f"{h.kv_tokens}, kv_bytes {h.kv_bytes}")
        decode = _engine(cfg, weights, pages, prefill_buckets=None)
        decode.start()
        for r in _requests(prompts, handoffs=handoffs):
            decode.submit(r)
        _, ms = _timed_ms(decode.admit_waiting)
        admit_ms[layout] = ms / len(prompts)
        reset_counts()
        got = _serve(decode, [])
        counts = read_counts()
        colocated = _serve(_engine(cfg, weights, pages,
                                   prefill_buckets=None), _requests(prompts))
        same, total = _agree(got, colocated)
        name = "paged_decode" if pages else "ragged_decode"
        log(f"disaggregated {layout}: {len(handoffs)} payloads of "
            f"{min(h.kv_bytes for h in handoffs)} to "
            f"{max(h.kv_bytes for h in handoffs)} bytes ({full} a full "
            f"session); handoff admission {admit_ms[layout]:.4f} ms a "
            f"session; decode launches {counts[name]} in "
            f"{decode.stats['decode_steps']} steps, flash "
            f"{counts['flash_attention']} ({decode.graph_count()} "
            f"graphs); vs co-located {same}/{total} tokens agree; on {card}")
        if got != colocated:
            bad.append(f"disaggregated {layout} != co-located")
        if counts["flash_attention"] or counts[name] != \
                cfg.n_layers * decode.stats["decode_steps"]:
            bad.append(f"disaggregated {layout}: launches {counts}")
    return {"admit_ms": admit_ms, "full_bytes": full}


def _migration(cfg, weights, prompts, card, bad) -> dict:
    """Engine A serves 2 horizons and exports every session; engine B
    admits the payloads and finishes; against the uninterrupted run of
    A's plan, for contiguous to contiguous, paged to paged and paged to
    contiguous."""
    export_ms = {}
    whole = {pages: _serve(_engine(cfg, weights, pages), _requests(prompts))
             for pages in (False, True)}
    for src, dst in ((False, False), (True, True), (True, False)):
        pair = (f"{'paged' if src else 'contiguous'} -> "
                f"{'paged' if dst else 'contiguous'}")
        a = _engine(cfg, weights, src)
        for r in _requests(prompts):
            a.submit(r)
        a.start()
        a.admit_waiting()
        a.step()
        a.step()
        handoffs, ms = _timed_ms(a.export_sessions)
        export_ms[pair] = ms / len(handoffs)
        b = _engine(cfg, weights, dst)
        got = _serve(b, _requests([prompts[h.rid] for h in handoffs],
                                  handoffs=handoffs))
        same, total = _agree(got, whole[src])
        freed = a.page_pool is None or (a.page_pool.live_pages == 0 and
                                        a.page_pool.free_pages ==
                                        a.page_pool.total_pages)
        log(f"migration {pair}: {len(handoffs)} sessions exported after "
            f"{a.stats['decode_steps']} steps ({export_ms[pair]:.4f} ms a "
            f"session, {a.stats['host_syncs']} host syncs on A); vs "
            f"uninterrupted {same}/{total} tokens agree; A's pages all "
            f"free {freed}; graphs A {a.graph_count()}, B "
            f"{b.graph_count()}; on {card}")
        if got != whole[src] or len(handoffs) != len(prompts) or not freed:
            bad.append(f"migration {pair}: tokens, sessions or pages")
    return {"export_ms": export_ms}


def _evacuation(cfg, weights, prompts, paged_outs, card, bad) -> None:
    """An engine on phase 4's paged plan with 8 live and 8 queued
    requests evacuates after 2 horizons, then serves 8 fresh requests."""
    eng = _engine(cfg, weights, True)
    for r in _requests(prompts):
        eng.submit(r)
    eng.start()
    eng.admit_waiting()
    eng.step()
    eng.step()
    graphs = eng.graph_count()
    live, queued = eng.evacuate()
    prefix_ok = all(r.output == paged_outs[r.rid][:len(r.output)]
                    and len(r.output) == 2 * HORIZON for r in live)
    pool = eng.page_pool
    emitted = sorted({len(r.output) for r in live})
    log(f"evacuation: {len(live)} live (emitted {emitted} tokens, equal "
        f"to phase 4's prefixes {prefix_ok}), {len(queued)} queued "
        f"(emitted {sorted({len(r.output) for r in queued})}); "
        f"pages live {pool.live_pages}, free {pool.free_pages} of "
        f"{pool.total_pages}; graphs {graphs}")
    if len(live) != N_SLOTS or not prefix_ok or len(queued) != \
            len(prompts) - N_SLOTS or any(r.output for r in queued) or \
            pool.live_pages or pool.free_pages != pool.total_pages or \
            eng.n_active or eng.queue:
        bad.append("evacuation: live, queued or pages")
    fresh = prompts[:N_SLOTS]
    again = _serve(eng, _requests(fresh, rid0=100))
    expect = _serve(_engine(cfg, weights, True), _requests(fresh, rid0=100))
    same, total = _agree(again, expect)
    log(f"  re-served {len(again)} fresh requests: {same}/{total} tokens "
        f"equal a fresh engine's; graphs {graphs} -> "
        f"{eng.graph_count()}; on {card}")
    if again != expect or eng.graph_count() != graphs:
        bad.append("evacuation: the re-served tokens or a new capture")


def _obs_run(cfg, weights, prompts, card, bad) -> None:
    """``connect(..., obs=enabled_obs())`` on phase 4's contiguous plan:
    the trace validates, one request span per request, the registry's
    engine counters equal ``engine.stats``."""
    from repro_torch.obs import enabled_obs, validate_trace
    from repro_torch.serve import connect
    obs = enabled_obs()
    client = connect(cfg, _plan(False), params=weights, obs=obs)
    client.generate(prompts, MAX_NEW)
    eng = client.engine
    trace = obs.recorder.to_chrome()
    problems = validate_trace(trace)
    spans = sum(e["ph"] == "b" and e["name"] == "request"
                for e in trace["traceEvents"])
    reg = obs.metrics
    wrong = {name: reg.total(name) for name in reg.names()
             if name.startswith("engine.") and name[7:] in eng.stats
             and reg.total(name) != eng.stats[name[7:]]}
    compiles = reg.total("engine.jit_compiles")
    log(f"obs: {len(trace['traceEvents'])} trace events, {spans} request "
        f"spans for {len(prompts)} requests, validate_trace problems "
        f"{problems}; {len(reg.names())} metric series, engine counters "
        f"unequal to stats {wrong}; engine.jit_compiles {compiles}, "
        f"compile_count() {eng.compile_count()}, graphs "
        f"{eng.graph_count()}; on {card}")
    if problems or spans != len(prompts) or wrong or \
            compiles != eng.compile_count() or eng.graph_count() != 1:
        bad.append("obs: trace, spans or counters")


def _regroup(cfg, weights, prompts, card, bad) -> None:
    """Two runs of a client on phase 4's paged plan with ``replan``
    between them (slot level 1 -> 2, page level 4 -> 2), against the same
    two runs without it."""
    from repro_torch.core.plan import SharingVector
    from repro_torch.serve import connect
    seconds = {}
    for replan in (True, False):
        client = connect(cfg, _plan(True), params=weights)
        client.generate(prompts[:N_SLOTS], MAX_NEW)
        eng = client.engine
        graphs = dict(eng._horizons.graphs)
        if replan:
            client.replan(SharingVector(slots=2, pages=2))
        seconds[replan] = client.generate(prompts[N_SLOTS:], MAX_NEW)
        if replan:
            ok = (eng.stats["regroups"] == 1 and len(client.transitions) == 1
                  and eng._horizons.graphs == graphs
                  and eng.pool.level == 2 and eng.page_pool.level == 2)
            log(f"regroup: stats regroups {eng.stats['regroups']}, "
                f"transitions {client.transitions}, slot level "
                f"{eng.pool.level}, page level {eng.page_pool.level}, "
                f"graphs kept {eng._horizons.graphs == graphs} "
                f"({eng.graph_count()})")
            if not ok:
                bad.append("regroup: stats, transitions, levels or graphs")
    same, total = _agree(dict(enumerate(seconds[True])),
                         dict(enumerate(seconds[False])))
    log(f"  second run after replan vs without: {same}/{total} tokens "
        f"agree (bf16, not gated); on {card}")


def serve_surface(runs, prompts, cfg, params, card: str) -> dict:
    """Full-width qwen2-0.5b, bf16, 8 slots, max_len 1024, horizon 8, on
    phase 4's weights (one copy on the card for every engine here): the
    wave executor, prefill/decode disaggregation, live migration,
    evacuation, the observability layer and a live regroup.  -> times."""
    from repro_torch.models import Model
    weights = Model(cfg, "cuda").prepare_params(params)
    bad = []
    result = _wave_vs_continuous(cfg, weights, card, bad)
    first = prompts[:N_SLOTS]
    result.update(_disaggregation(cfg, weights, first, card, bad))
    result.update(_migration(cfg, weights, first, card, bad))
    _evacuation(cfg, weights, prompts, runs["paged_decode"]["outs"], card,
                bad)
    _obs_run(cfg, weights, prompts, card, bad)
    _regroup(cfg, weights, prompts, card, bad)
    bound_ms = result["full_bytes"] / MEM_BYTES_PER_S * 1e3
    log(f"per session: export {result['export_ms']} ms, handoff admission "
        f"{result['admit_ms']} ms, against a copy bound of "
        f"{bound_ms * 1e3:.2f} us ({result['full_bytes']} bytes at "
        f"{MEM_BYTES_PER_S / 1e12:.2f} TB/s); on {card}")
    if bad:
        raise AssertionError("; ".join(bad))
    return result


# ----- phase 11 --------------------------------------------------------------

#: the fleet phase: workers, the second burst's virtual arrival time, and
#: the virtual time of the crash and of the migration (mid-decode of the
#: first burst, whose admission and first horizon take about 0.8 ms)
FLEET_WORKERS = 4
FLEET_BURST2_NS = 1_000_000.0
FLEET_EVENT_NS = 600_000.0
#: heartbeat silence that declares a worker dead in the crash run: above
#: the largest healthy wake (an admission round of 8 prompts of up to 512
#: tokens, 1.3 ms, then a horizon of 8 steps at batch 8, 0.62 ms, in the
#: fabric's virtual cost model), so only the crashed worker is fenced
FLEET_DEADLINE_NS = 3_000_000.0


def _fleet_prompts(vocab, first):
    """Phase 4's 16 prompts at t = 0 and 16 more from the same range (64
    to 512 tokens) one burst later; -> [(prompt, virtual arrival ns)]."""
    return ([(p, 0.0) for p in first]
            + [(p, FLEET_BURST2_NS) for p in _prompts(vocab, seed=8)])


def _fleet(cfg, weights, device, vector, **kw):
    """A fleet client of FLEET_WORKERS workers on phase 4's plan (8
    slots, max_len 1024, horizon 8) with ``vector`` (paged when its pages
    level is above 1, page size 64)."""
    from repro_torch.serve import connect
    plan = dataclasses.replace(_plan(vector.pages > 1), vector=vector,
                               n_workers=FLEET_WORKERS, executor="auto")
    return connect(cfg, plan, params=weights, device=device, **kw)


class _CaptureClock:
    """Within the block, time every horizon graph capture (its
    ``torch.cuda.graph`` context included: synchronize, collection,
    ``empty_cache``); ``seconds`` and ``count`` after."""

    def __enter__(self):
        from repro_torch.serve.engine import HorizonGraphs
        self.seconds, self.count = 0.0, 0
        self._capture = capture = HorizonGraphs._capture

        def timed(graphs, n_steps):
            t = time.perf_counter()
            try:
                return capture(graphs, n_steps)
            finally:
                self.seconds += time.perf_counter() - t
                self.count += 1

        HorizonGraphs._capture = timed
        return self

    def __exit__(self, *exc):
        from repro_torch.serve.engine import HorizonGraphs
        HorizonGraphs._capture = self._capture
        return False


def _fleet_run(client, prompts_at):
    """Serve ``prompts_at`` through the fleet client; -> (outputs in
    prompt order, launch counts of the run, the launches its engines'
    prefills and launched horizon steps account for, host seconds, host
    seconds inside the workers' ``step`` calls: admission rounds and
    horizons, each horizon ending in its host sync)."""
    import torch
    from repro_torch.serve.engine import ContinuousEngine
    from repro_torch.serve.fabric import EngineWorker
    cfg = client.cfg
    launched, run_horizon = {}, ContinuousEngine._run_horizon
    step_s, worker_step = [0.0], EngineWorker.step

    def counted(eng, n_steps):
        launched[id(eng)] = launched.get(id(eng), 0) + n_steps
        return run_horizon(eng, n_steps)

    def timed_step(worker, t_ns):
        t = time.perf_counter()
        try:
            return worker_step(worker, t_ns)
        finally:
            step_s[0] += time.perf_counter() - t

    prefills = {id(w.engine): w.engine.stats["prefills"]
                for w in client.workers}
    rids = [client.submit(p, max_new_tokens=MAX_NEW, at_ns=t)
            for p, t in prompts_at]
    on_card = client.device.type == "cuda"
    ContinuousEngine._run_horizon = counted
    EngineWorker.step = timed_step
    try:
        reset_counts()
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = client.run()
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
    finally:
        ContinuousEngine._run_horizon = run_horizon
        EngineWorker.step = worker_step
    expect = {name: 0 for name in counts}
    for w in client.workers:
        eng = w.engine
        one = _expected_launches(
            cfg, eng, launched.get(id(eng), 0),
            eng.stats["prefills"] - prefills.get(id(eng), 0))
        for name, n in one.items():
            expect[name] += n
    return [out.get(r) for r in rids], counts, expect, wall, step_s[0]


def _pool_bytes(groups):
    """Bytes the card holds in the graph memory pools of ``groups``
    (segments of ``torch.cuda.memory_snapshot()`` by pool id); None when
    the snapshot names no pools."""
    import torch
    ids = {tuple(g._pool) for g in groups if g._pool is not None}
    segments = torch.cuda.memory_snapshot()
    if not any("segment_pool_id" in seg for seg in segments):
        return None
    return sum(seg["total_size"] for seg in segments
               if tuple(seg.get("segment_pool_id", ())) in ids)


def _fleet_fp32(cfg32, w32, prompts_at, device, card, bad) -> dict:
    """The fp32 runs, each gated on tokens equal to a single continuous
    engine on the same prompts, on its launch counts, and on at most K
    graphs per engine.  One client serves diag1, then (``replan``) diag4,
    then (``replan``) adaptive diag2 on the same engines; each other run
    connects its own."""
    from repro_torch.core.plan import SharingVector
    from repro_torch.models.params import tree_leaves
    from repro_torch.serve import connect
    from repro_torch.serve.recovery import RecoveryPolicy
    prompts = [p for p, _ in prompts_at]
    single = {}
    for pages in (False, True):
        client = connect(cfg32, _plan(pages), params=w32, device=device)
        single[pages] = client.generate(prompts, MAX_NEW)
    diag = SharingVector.diagonal
    reused = _fleet(cfg32, w32, device, diag(1))
    runs = (
        ("diag1", lambda: reused, None),
        ("diag4 (replan)", lambda: reused, diag(4)),
        ("adaptive diag2 (replan)", lambda: reused, "adaptive"),
        ("diag4 paged", lambda: _fleet(
            cfg32, w32, device, dataclasses.replace(diag(4), pages=4)),
         None),
        ("2P+2D", lambda: _fleet(cfg32, w32, device, diag(2),
                                 roles="2P+2D"), None),
        ("crash w0", lambda: _fleet(
            cfg32, w32, device, diag(2),
            faults=f"crash@{FLEET_EVENT_NS / 1e3:g}us:w0",
            recovery=RecoveryPolicy(deadline_ns=FLEET_DEADLINE_NS)), None),
        ("migration w1 -> w2", lambda: _fleet(
            cfg32, w32, device, diag(1),
            migrations=[(FLEET_EVENT_NS, 1, 2)]), None))
    walls = {}
    for name, make, replan in runs:
        client = make()
        if replan == "adaptive":
            client.replan(diag(2), adaptive=True, adapt_window_ns=1e5)
        elif replan is not None:
            client.replan(replan)
        outs, counts, expect, wall, _ = _fleet_run(client, prompts_at)
        walls[name] = wall
        rep = client.report
        paged = client.plan.paged
        same = sum(x == y for a, b in zip(outs, single[paged])
                   for x, y in zip(a or [], b))
        total = sum(map(len, single[paged]))
        graphs = [w.engine.graph_count() for w in client.workers]
        log(f"fleet fp32 {name}: {rep.n_completed}/{len(prompts)} requests, "
            f"vector {client.plan.vector.label}, {same}/{total} tokens "
            f"equal the single engine's ({'paged' if paged else 'contiguous'}"
            f"); {rep.total_new_tokens} tokens in {rep.makespan_ns / 1e6:.2f} "
            f"virtual ms, {wall:.2f}s host; graphs per engine {graphs}; "
            f"handoffs {rep.handoffs}, migrations {rep.migrations}, "
            f"detections {rep.detections}, recovered {len(rep.recovered)}, "
            f"failed {len(rep.failed)}, shed {rep.n_shed}, windows "
            f"{rep.n_windows}, transitions {len(rep.transitions)}; launches "
            f"{counts} (expected {expect}); on {card}")
        if outs != single[paged]:
            bad.append(f"fleet {name}: tokens differ from the single engine")
        if counts != expect:
            bad.append(f"fleet {name}: launches {counts} != {expect}")
        if max(graphs) > HORIZON:
            bad.append(f"fleet {name}: an engine captured {max(graphs)} "
                       f"graphs, more than K = {HORIZON}")
        if any(w.engine.device.type != client.device.type
               for w in client.workers):
            bad.append(f"fleet {name}: an engine is off the client's device")
        leaves = [tree_leaves(w.engine.params) for w in client.workers]
        if any(len(x) != len(leaves[0]) or any(
                a.data_ptr() != b.data_ptr() for a, b in zip(x, leaves[0]))
               for x in leaves):
            bad.append(f"fleet {name}: more than one weight copy")
        checks = {"2P+2D": rep.handoffs == len(prompts),
                  "crash w0": (rep.detections == 1 and bool(rep.recovered)
                               and not rep.failed and not rep.shed),
                  "migration w1 -> w2": rep.migrations == 1,
                  "adaptive diag2 (replan)": rep.n_windows > 0}
        if not checks.get(name, True):
            bad.append(f"fleet {name}: report {rep.handoffs} handoffs, "
                       f"{rep.detections} detections, {rep.migrations} "
                       f"migrations, {rep.n_windows} windows")
    return walls


def _fleet_bf16(cfg, weights, prompts_at, card, bad) -> dict:
    """bf16 at diag4 and at exec level 1 (slots and channels at 4): wall
    time, decode tok/s (tokens over the run's host time), captures, peak
    memory and the graph pools' bytes; a second run on the same fleet
    (no capture); and a single engine on the same prompts."""
    import gc
    import torch
    from repro_torch.core.plan import SharingVector
    from repro_torch.serve import connect
    result = {}
    for execs in (1, 4):
        gc.collect()
        torch.cuda.empty_cache()
        live = fresh_peak()
        client = _fleet(cfg, weights, "cuda",
                        SharingVector(slots=4, channels=4, execs=execs))
        for attempt in range(2):
            with _CaptureClock() as clock:
                outs, _, _, wall, step_s = _fleet_run(client, prompts_at)
            groups = {id(w.engine.group): w.engine.group
                      for w in client.workers}
            graphs = [w.engine.graph_count() for w in client.workers]
            tok = sum(map(len, outs))
            if max(graphs) > HORIZON or (attempt and clock.count):
                bad.append(f"fleet bf16 execs={execs}: graphs per engine "
                           f"{graphs}, {clock.count} captured in run "
                           f"{attempt + 1}")
            if attempt == 0:
                pools = _pool_bytes(groups.values())
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                reserved = torch.cuda.max_memory_reserved() / 2 ** 30
                result[execs] = {"tok_s": tok / wall, "wall": wall,
                                 "captures": clock.count,
                                 "capture_s": clock.seconds, "peak": peak,
                                 "reserved": reserved, "pools": pools,
                                 "groups": len(groups)}
                log(f"fleet bf16 execs={execs} ({len(groups)} exec groups): "
                    f"{tok} tokens in {wall:.2f}s host, {tok / wall:.1f} "
                    f"tok/s (captures included); {clock.count} graphs "
                    f"captured in {clock.seconds:.2f}s (graphs per engine "
                    f"{graphs}; exec.jit_compiles "
                    f"{client.report.metrics.total('exec.jit_compiles'):.0f}"
                    f", the specializations of the groups in this "
                    f"process); "
                    f"max_memory_allocated {peak:.2f} GiB, "
                    f"max_memory_reserved {reserved:.2f} GiB ({live:.2f} "
                    f"GiB live before); graph pools "
                    + (f"{pools / 2 ** 20:.1f} MiB" if pools is not None
                       else "not measured") + f"; on {card}")
            else:
                result[execs]["tok_s_again"] = tok / wall
                result[execs]["step_share"] = step_s / wall
                log(f"  second run on the same fleet: {tok / wall:.1f} "
                    f"tok/s, {clock.count} graphs captured; {wall:.3f}s "
                    f"host, {step_s:.3f}s of it in the workers' steps "
                    f"(admissions and horizons), {wall - step_s:.3f}s in "
                    f"the router and the client; on {card}")
        del client
    gc.collect()
    single = connect(cfg, _plan(False), params=weights, device="cuda")
    prompts = [p for p, _ in prompts_at]
    for attempt in range(2):
        _sync()
        with _CaptureClock() as clock:
            t0 = time.perf_counter()
            outs = single.generate(prompts, MAX_NEW)
            _sync()
            wall = time.perf_counter() - t0
        result.setdefault("single", []).append(sum(map(len, outs)) / wall)
        log(f"single engine bf16 on the same 32 prompts, run {attempt + 1}: "
            f"{sum(map(len, outs))} tokens in {wall:.2f}s host, "
            f"{result['single'][-1]:.1f} tok/s; {clock.count} graphs "
            f"captured in {clock.seconds:.2f}s; on {card}")
    return result


def serve_fleet(cfg, params, first_prompts, card: str,
                device: str = "cuda") -> dict:
    """The fleet at full width: qwen2-0.5b on phase 4's weights, 4 workers
    of 8 slots, max_len 1024, horizon 8, 32 requests of 64 tokens in two
    bursts.  fp32 runs are gated on tokens, launches, graphs and one
    weight copy; bf16 runs report the fleet's tok/s, captures and memory
    at exec levels 1 and 4 against a single engine.  -> the bf16
    numbers."""
    from repro_torch.models import Model
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    w32 = Model(cfg32, device).prepare_params(params)
    prompts_at = _fleet_prompts(cfg.vocab, first_prompts)
    bad = []
    walls = _fleet_fp32(cfg32, w32, prompts_at, device, card, bad)
    del w32
    result = {"fp32_walls": walls}
    if device == "cuda":
        weights = Model(cfg, device).prepare_params(params)
        result.update(_fleet_bf16(cfg, weights, prompts_at, card, bad))
    if bad:
        raise AssertionError("; ".join(bad))
    return result


# ----- phase 12 --------------------------------------------------------------

def _time_ms(fn, n_layers, iters=10):
    """Mean ms per call over ``iters`` sweeps of ``n_layers`` calls, each
    on its own layer's inputs (the decode step's working set, not one
    cache left in L2)."""
    import torch
    for layer in range(n_layers):
        fn(layer)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        for layer in range(n_layers):
            fn(layer)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * n_layers)


def _time_graph_ms(fn, n_layers, iters=10, warmup=1):
    """Mean ms per call of one sweep of ``n_layers`` calls captured in a
    CUDA graph and replayed ``iters`` times after ``warmup`` untimed
    replays: the card's time for the calls without the host's dispatch of
    each."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for layer in range(n_layers):
            fn(layer)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for layer in range(n_layers):
            fn(layer)
    for _ in range(warmup):
        graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * n_layers)


def _decode_case(shape, smax, cur_list, launches, n_layers=24):
    """Both decode kernels at one cache shape: bf16, B rows at lengths
    ``cur_list``, one cache per layer (contiguous, and the same values
    scattered over scrambled pages of 64); each checked layer by layer
    against its plain version (per case and per row), then timed eagerly
    and as a CUDA graph beside its plain version and SDPA.  -> {kernel:
    case dict}."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    b = len(cur_list)
    gen = torch.Generator(device="cuda").manual_seed(smax)
    dt = torch.bfloat16
    cur = torch.tensor(cur_list, dtype=torch.int32, device="cuda")
    q = _rand(gen, (b, 1, HKV * G, DH), dt)
    caches = [(_rand(gen, (b, smax, HKV, DH), dt),
               _rand(gen, (b, smax, HKV, DH), dt)) for _ in range(n_layers)]
    ps = 64
    max_pages = smax // ps
    perm = torch.randperm(b * max_pages, generator=gen, device="cuda")
    table = perm.reshape(b, max_pages).int()
    paged = []
    for k, v in caches:
        kp, vp = torch.empty_like(k), torch.empty_like(v)
        kp.view(b * max_pages, ps, HKV, DH)[perm] = \
            k.reshape(b * max_pages, ps, HKV, DH)
        vp.view(b * max_pages, ps, HKV, DH)[perm] = \
            v.reshape(b * max_pages, ps, HKV, DH)
        paged.append((kp.view(b * max_pages, ps, HKV, DH),
                      vp.view(b * max_pages, ps, HKV, DH)))
    mask = (torch.arange(smax, device="cuda")[None, :]
            <= cur[:, None])[:, None, None, :]
    qs = q.transpose(1, 2)                         # (B, Hq, 1, dh)

    def sdpa(k, v):
        return F.scaled_dot_product_attention(
            qs, k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
            enable_gqa=True)

    n_keys = sum(min(c, smax - 1) + 1 for c in cur_list)
    elt = q.element_size()
    kv_bytes = 2 * n_keys * HKV * DH * elt
    io_bytes = 2 * q.numel() * elt + cur.numel() * 4
    flops = 4 * n_keys * HKV * G * DH
    chunk, n_split = ops.decode_splits(smax)
    cases = {}
    for name in ("ragged_decode", "paged_decode"):
        if name == "ragged_decode":
            def kern(i):
                return ops.flash_decode_attention(q, *caches[i], cur)

            def plain(i):
                return ref.ragged_decode_ref(q, *caches[i], cur)
            extra = 0
        else:
            def kern(i):
                return ops.paged_flash_decode_attention(q, *paged[i], table,
                                                        cur)

            def plain(i):
                return ref.paged_decode_ref(q, *paged[i], table, cur)
            extra = table.numel() * 4
        err, tol, rows, bad = 0.0, float("inf"), 0.0, []
        for i in range(n_layers):
            expect, out = plain(i), kern(i)
            e = (out.float() - expect.float()).abs().max().item()
            r = row_error(out, expect)
            err, tol, rows = max(err, e), min(tol, tolerance(expect)), \
                max(rows, r)
            if not (e <= tolerance(expect) and r <= BF16_REL_TOL):
                bad.append((i, e, tolerance(expect), r))
        if bad:
            raise AssertionError(f"{name} at {shape} disagrees with its "
                                 f"plain version (layer, err, tolerance, "
                                 f"row-scaled err): {bad}")
        lib_err = (sdpa(*caches[0]).transpose(1, 2).float()
                   - plain(0).float()).abs().max().item()
        ms = _time_ms(kern, n_layers)
        graph_ms = _time_graph_ms(kern, n_layers)
        plain_ms = _time_ms(plain, n_layers)
        lib_ms = _time_ms(lambda i: sdpa(*caches[i]), n_layers)
        lib_graph_ms = _time_graph_ms(lambda i: sdpa(*caches[i]), n_layers)
        t_bytes = (kv_bytes + io_bytes + extra) / MEM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOPS_PER_S * 1e3
        case = dict(shape=shape, launches=launches[name], max_abs_err=err,
                    max_row_rel_err=rows, ms=ms, graph_ms=graph_ms,
                    plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                    library_ms=lib_ms, library_graph_ms=lib_graph_ms)
        cases[name] = case
        log(f"{name} at {shape}: {ms * 1e3:.2f} us/call eager, "
            f"{graph_ms * 1e3:.2f} us/call in a CUDA graph ({n_split} "
            f"splits of {chunk} keys), bound {case['bound_ms'] * 1e3:.2f} us "
            f"({case['bound_by']}: {kv_bytes / 1e6:.2f} MB of K/V), plain "
            f"{plain_ms * 1e3:.1f} us, SDPA {lib_ms * 1e3:.1f} us eager, "
            f"{lib_graph_ms * 1e3:.1f} us in a graph (on the contiguous "
            f"cache; max abs err vs plain "
            f"{lib_err:.3e}), max abs err {err:.3e} (tolerance {tol:.3e} or "
            f"more), row-scaled err {rows:.4f} (limit {BF16_REL_TOL:.4f}); "
            f"launches on the main path {launches[name]}; cur {cur_list}")
    del caches, paged
    return cases


def time_kernels(runs, lengths, long_runs):
    """Both decode kernels at the main path's two cache shapes, bf16, B=8,
    one cache per layer of the 24: phase 4's (Smax 1024, cur = prompt
    length + MAX_NEW // 2) and phase 5's (Smax 4096, cur = long prompt +
    LONG_MAX_NEW // 2).  Each entry's own numbers are the first shape's;
    ``cases`` holds both."""
    timed = _decode_case(
        f"B={B}, Smax={SMAX}, Hkv={HKV}, G={G}, dh={DH} bf16", SMAX,
        [n + MAX_NEW // 2 for n in lengths[:B]],
        {k: runs[k]["launches"] for k in ("ragged_decode", "paged_decode")})
    long = _decode_case(
        f"B={len(LONG_PROMPTS)}, Smax={LONG_MAX_LEN}, Hkv={HKV}, G={G}, "
        f"dh={DH} bf16", LONG_MAX_LEN,
        [n + LONG_MAX_NEW // 2 for n in LONG_PROMPTS],
        {"ragged_decode": long_runs["contiguous"]["decode_launches"],
         "paged_decode": long_runs["paged"]["decode_launches"]})
    entries = []
    for name in ("ragged_decode", "paged_decode"):
        top = {k: v for k, v in timed[name].items()
               if k not in ("shape", "max_row_rel_err", "graph_ms",
                            "library_graph_ms")}
        entries.append(dict(name=name, **KERNELS[name], **top,
                            cases=[timed[name], long[name]]))
    return entries


#: the RG-LRU scan's timed prompt lengths (B = 1, C = 2560, fp32): the
#: middle of recurrentgemma-2b's prompts and its longest
RGLRU_TIMED = (2048, 3500)


def _rglru_case(t, launches):
    """The RG-LRU scan at (1, T, 2560) fp32, the gates' a and x of one
    prompt of T tokens, one input per RG-LRU layer of the 18 (the
    prefill's working set): each checked against the plain version, then
    timed eagerly and replayed in a CUDA graph beside the plain version."""
    import torch
    from repro_torch.kernels.rglru import ops, ref
    n_layers, c = 18, 2560
    gen = torch.Generator(device="cuda").manual_seed(t)
    inputs = [_rglru_inputs(gen, 1, t, c, torch.float32)
              for _ in range(n_layers)]
    err, tol = 0.0, float("inf")
    for a, x in inputs:
        expect = ref.rglru_scan_ref(a, x)
        e = (ops.rglru_scan(a, x).float() - expect).abs().max().item()
        err, tol = max(err, e), min(tol, rglru_tolerance(expect))
        if not e <= rglru_tolerance(expect):
            raise AssertionError(f"rglru_scan at T={t}, C={c}: err {e} > "
                                 f"{rglru_tolerance(expect)}")
    ms = _time_ms(lambda i: ops.rglru_scan(*inputs[i]), n_layers)
    # 100 untimed replays first: on an H100 the first window after the
    # phases before this one read about 10% above the windows after it
    graph_ms = _time_graph_ms(lambda i: ops.rglru_scan(*inputs[i]),
                              n_layers, iters=50, warmup=100)
    plain_ms = _time_ms(lambda i: ref.rglru_scan_ref(*inputs[i]), n_layers,
                        iters=1)
    io_bytes = 3 * t * c * 4
    t_bytes = io_bytes / MEM_BYTES_PER_S * 1e3
    t_ops = 2 * t * c / FP32_FLOPS_PER_S * 1e3
    chunk, n_chunks = ops.scan_chunks(1, t, c)
    case = dict(shape=f"B=1, T={t}, C={c} fp32", launches=launches,
                max_abs_err=err, ms=ms, graph_ms=graph_ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None, bytes=io_bytes, chunk_len=chunk,
                n_chunks=n_chunks)
    log(f"rglru_scan at (1, {t}, {c}) fp32: {ms * 1e3:.2f} us/call eager, "
        f"{graph_ms * 1e3:.2f} us/call in a CUDA graph ({n_chunks} chunks "
        f"of {chunk}, {-(-c // ops.SCAN_THREADS) * n_chunks} blocks in pass "
        f"2), bound "
        f"{case['bound_ms'] * 1e3:.2f} us ({case['bound_by']}: "
        f"{io_bytes / 1e6:.1f} MB), plain {plain_ms:.1f} ms, max abs err "
        f"{err:.3e} (tolerance {tol:.3e} or more); launches on the main "
        f"path {launches}; no PyTorch call computes a linear recurrence "
        f"(library: null)")
    return case


def time_rglru(launches: int):
    """The RG-LRU scan at each of ``RGLRU_TIMED``'s lengths.  The entry's
    own numbers are the first length's; ``cases`` holds both."""
    cases = [_rglru_case(t, launches) for t in RGLRU_TIMED]
    top = {k: v for k, v in cases[0].items()
           if k in ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms")}
    return dict(name="rglru_scan", **KERNELS["rglru_scan"], **top,
                cases=cases)


#: the flash kernel's timed shapes, bf16, causal: (path, B, S, Hq, Hkv,
#: dh, window); qwen2-0.5b's long prompt prefilled alone (one stream) and
#: its batched admission of 8 rows of 4096, recurrentgemma-2b's longest
#: prompt
FLASH_TIMED = (("qwen2-0.5b", 1, 4096, 14, 2, 64, 0),
               ("qwen2-0.5b admission", 8, 4096, 14, 2, 64, 0),
               ("recurrentgemma-2b", 1, 3500, 10, 1, 256, 2048))


def time_flash(launches: dict):
    """The flash kernel at each main path's prefill shape (``FLASH_TIMED``,
    four inputs in turn), against its plain version and
    ``scaled_dot_product_attention`` (``is_causal``, or a boolean mask
    for the window).  ``launches``: the kernel's count on each path's
    main-path run.  The entry's own numbers are the first shape's;
    ``cases`` holds every shape's."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(5)
    dt, n_inputs = torch.bfloat16, 4
    cases = []
    for model, b, s, hq, hkv, dh, window in FLASH_TIMED:
        inputs = [(_rand(gen, (b, s, hq, dh), dt),
                   _rand(gen, (b, s, hkv, dh), dt),
                   _rand(gen, (b, s, hkv, dh), dt)) for _ in range(n_inputs)]
        kw = dict(causal=True, window=window)
        pos = torch.arange(s, device="cuda")
        allowed = (pos[None, :] <= pos[:, None]) & \
            (pos[None, :] > pos[:, None] - window)

        def kern(i):
            return ops.flash_attention(*inputs[i], **kw)

        def plain(i):
            return ref.flash_attention_ref(*inputs[i], **kw)

        def sdpa(i):
            q, k, v = (t.transpose(1, 2) for t in inputs[i])
            return F.scaled_dot_product_attention(
                q, k, v, attn_mask=allowed if window else None,
                is_causal=not window, enable_gqa=True).transpose(1, 2)

        err, tol, rows = 0.0, float("inf"), 0.0
        for i in range(n_inputs):
            expect, out = plain(i), kern(i)
            e = (out.float() - expect.float()).abs().max().item()
            r = row_error(out, expect)
            err, tol = max(err, e), min(tol, tolerance(expect))
            rows = max(rows, r)
            if not (e <= tolerance(expect) and r <= BF16_REL_TOL):
                raise AssertionError(f"flash_attention at {model}'s shape: "
                                     f"err {e} (limit {tolerance(expect)}), "
                                     f"row-scaled err {r} (limit "
                                     f"{BF16_REL_TOL})")
            del expect, out
        lib_err = (sdpa(0).float() - plain(0).float()).abs().max().item()
        ms = _time_ms(kern, n_inputs)
        plain_ms = _time_ms(plain, n_inputs, iters=2)
        lib_ms = _time_ms(sdpa, n_inputs)
        pairs = b * sum(min(t + 1, window) if window else t + 1
                        for t in range(s))
        flops = 4 * pairs * dh * hq
        io_bytes = 2 * b * (s * hq * dh + s * hkv * dh) * dt.itemsize
        t_bytes = io_bytes / MEM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS_PER_S * 1e3
        case = dict(model=model, shape=f"({b}, {s}, {hq}/{hkv}, {dh}) causal"
                    f"{f' window {window}' if window else ''} bf16",
                    launches=launches[model], max_abs_err=err,
                    max_row_rel_err=rows, ms=ms,
                    plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                    library_ms=lib_ms)
        cases.append(case)
        log(f"flash_attention at {case['shape']} ({model}): {ms * 1e3:.1f} "
            f"us/call, bound {case['bound_ms'] * 1e3:.1f} us "
            f"({case['bound_by']}: {flops / 1e9:.2f} GFLOP over "
            f"{pairs} unmasked pairs at the bf16 tensor-core peak; "
            f"{flops / FP32_FLOPS_PER_S * 1e6:.0f} us at the fp32 FMA peak; "
            f"{io_bytes / 1e6:.1f} MB), plain {plain_ms * 1e3:.1f} us, SDPA "
            f"{lib_ms * 1e3:.1f} us (max abs err vs plain {lib_err:.3e}), "
            f"max abs err {err:.3e} (tolerance {tol:.3e} or more), "
            f"row-scaled err {rows:.4f} (limit {BF16_REL_TOL:.4f}); "
            f"launches on the main path {launches[model]}")
        del inputs
    top = {k: v for k, v in cases[0].items()
           if k not in ("model", "shape", "max_row_rel_err")}
    return dict(name="flash_attention", **KERNELS["flash_attention"], **top,
                cases=cases)


# ----- phase 13 --------------------------------------------------------------

#: the planner phase's fleet: the committed plan repository's key
#: (canonical_bursty, sim, 8 workers, 4 slots)
PLAN_WORKERS, PLAN_SLOTS = 8, 4
COMMITTED_REPO = ROOT / "benchmarks" / "baselines" / "plan_repo.sqlite"
#: the hints resolved analytically (no repository)
ANALYTIC_HINTS = {"latency_target_ms": 80.0, "burstiness": 0.9}


def _planned(cfg, weights, device, spec, **kw):
    """A fleet client of PLAN_WORKERS workers of PLAN_SLOTS slots
    (max_len 1024, horizon 8) connected with ``spec``: ``Hints``, an
    ``EndpointPlan`` or a vector."""
    from repro_torch.serve import connect
    return connect(cfg, spec, params=weights, device=device,
                   n_workers=PLAN_WORKERS, n_slots=PLAN_SLOTS,
                   max_len=SMAX, decode_horizon=HORIZON,
                   use_ragged_kernel=True, **kw)


def _repository_copy(directory):
    """A copy of the committed plan repository in ``directory``, opened
    (opening a repository writes to it: never the committed file)."""
    import shutil
    from repro_torch.tune import PlanRepository
    path = Path(directory) / "plan_repo.sqlite"
    shutil.copyfile(COMMITTED_REPO, path)
    return PlanRepository(str(path))


def _jumps(start, transitions) -> int:
    """Transitions that move more than one level or one axis at once:
    the adaptive controller's jumps to a repository's frontier plans."""
    path = [dataclasses.astuple(start)] + [dataclasses.astuple(v)
                                           for _, v in transitions]
    return sum(sum(abs(a - b) for a, b in zip(u, v)) > 1
               for u, v in zip(path, path[1:]))


def _planner_fp32(cfg32, w32, prompts_at, directory, card, bad):
    """The fp32 runs, each gated on tokens equal to a single continuous
    engine's on the same prompts, on its launch counts and on at most K
    graphs an engine; each fleet's engines start from cleared exec
    groups, so its specializations are its own.  -> (the analytic
    vector, the tuned one)."""
    from repro_torch.core.plan import EndpointPlan, Hints, resolve
    from repro_torch.serve import connect
    from repro_torch.serve.engine import clear_exec_groups
    prompts = [p for p, _ in prompts_at]
    single = {}
    analytic = resolve(Hints(**ANALYTIC_HINTS), n_workers=PLAN_WORKERS,
                       n_slots=PLAN_SLOTS)
    repo = _repository_copy(directory)
    stored = repo.frontier_vectors(n_workers=PLAN_WORKERS,
                                   n_slots=PLAN_SLOTS)
    runs = (
        ("hints, analytic", Hints(**ANALYTIC_HINTS), {}),
        ("explicit plan of that vector", EndpointPlan(vector=analytic), {}),
        ("hints, repository", Hints(), {"plan_repository": repo}),
        ("hints, repository, adaptive", Hints(),
         {"plan_repository": repo, "adaptive": True,
          "adapt_window_ns": 1e5}))
    tuned = None
    for name, spec, kw in runs:
        client = _planned(cfg32, w32, "cuda", spec, **kw)
        start = client.plan.vector
        paged = client.plan.paged
        if paged not in single:
            single[paged] = connect(cfg32, _plan(paged), params=w32,
                                    device="cuda").generate(prompts,
                                                            MAX_NEW)
        clear_exec_groups()           # the workers are built at run()
        outs, counts, expect, wall, _ = _fleet_run(client, prompts_at)
        rep = client.report
        same = sum(x == y for a, b in zip(outs, single[paged])
                   for x, y in zip(a or [], b))
        total = sum(map(len, single[paged]))
        graphs = [w.engine.graph_count() for w in client.workers]
        groups = {id(w.engine.group): w.engine.group
                  for w in client.workers}
        path = " -> ".join(f"{v.label}@{t / 1e6:.2f}ms"
                           for t, v in rep.transitions) or "none"
        log(f"planner fp32 {name}: vector {start.label} "
            f"({'paged' if paged else 'contiguous'}), "
            f"{rep.n_completed}/{len(prompts)} requests, {same}/{total} "
            f"tokens equal the single engine's; {wall:.2f}s host; graphs "
            f"per engine {graphs}, specializations per exec group "
            f"{[g.compile_count() for g in groups.values()]}; windows "
            f"{rep.n_windows}, transitions {len(rep.transitions)} ({path}), "
            f"{_jumps(start, rep.transitions)} of them repository jumps; "
            f"launches {counts} (expected {expect}); on {card}")
        used = ["flash_attention",
                "paged_decode" if paged else "ragged_decode"]
        if outs != single[paged]:
            bad.append(f"planner {name}: tokens differ from the single "
                       f"engine")
        if counts != expect or not all(counts[k] > 0 for k in used):
            bad.append(f"planner {name}: launches {counts} != {expect}")
        if max(graphs) > HORIZON:
            bad.append(f"planner {name}: an engine captured {max(graphs)} "
                       f"graphs, more than K = {HORIZON}")
        checks = {
            "hints, analytic": start == analytic,
            "explicit plan of that vector": start == analytic,
            "hints, repository": start in stored,
            "hints, repository, adaptive": (start in stored
                                            and rep.n_windows > 0)}
        if not checks[name]:
            bad.append(f"planner {name}: vector {start.label} (analytic "
                       f"{analytic.label}, stored "
                       f"{[v.label for v in stored]})")
        if name == "hints, repository":
            tuned = start
    repo.close()
    return analytic, tuned


def _planner_smoke_card_vs_cpu(directory, card, bad) -> None:
    """The smoke config at fp32, 4 workers of 4 slots (max_len 64,
    horizon 8), connected with ``Hints(burstiness=0.9)``, a repository
    of the port's tuner for that fleet (``tiny``, ``grid``, 20 evals,
    seed 0) and ``adaptive=True``, on the first burst of the canonical
    bursty trace; the card's tokens and ``FleetReport`` (every field, the
    transitions and the compile series included) must equal the CPU's.
    Each run starts from cleared exec groups."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.plan import Hints
    from repro_torch.models import Model
    from repro_torch.serve import connect
    from repro_torch.serve.engine import clear_exec_groups
    from repro_torch.serve.fabric import canonical_bursty_trace
    from repro_torch.tune import PlanRepository, space_by_name, tune
    cfg = dataclasses.replace(get_smoke_config("qwen2-0.5b"),
                              compute_dtype="float32")
    params = Model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    arrivals = canonical_bursty_trace()[:24]
    front = tune(space_by_name("tiny"), driver="grid", budget_evals=20,
                 seed=0).front
    seen = {}
    for device in ("cpu", "cuda"):
        clear_exec_groups()
        repo = PlanRepository(str(Path(directory) / f"{device}.sqlite"),
                              fresh=True)
        repo.store_front(front, traffic="canonical_bursty")
        client = connect(cfg, Hints(burstiness=0.9), params=params,
                         device=device, plan_repository=repo,
                         adaptive=True, adapt_window_ns=1e5, n_workers=4,
                         n_slots=4, max_len=64, decode_horizon=8)
        start = client.plan.vector
        for a in arrivals:
            prompt = np.random.default_rng(a.rid).integers(
                1, cfg.vocab, size=a.prompt_len).astype(np.int32)
            client.submit(prompt, max_new_tokens=a.max_new_tokens,
                          at_ns=a.t_ns, session=a.session)
        reset_counts()
        out = client.run()
        counts = read_counts()
        rep = client.report
        fields = {}
        for f in dataclasses.fields(rep):
            v = getattr(rep, f.name)
            if v is None:
                pass
            elif f.name == "metrics":
                v = json.dumps(v.to_json(), sort_keys=True)
            elif f.name == "category":
                v = v.value
            elif f.name == "vector":
                v = dataclasses.astuple(v)
            elif f.name == "completions":
                v = [dataclasses.astuple(c) for c in v]
            elif f.name == "transitions":
                v = [(t, dataclasses.astuple(vec)) for t, vec in v]
            fields[f.name] = v
        seen[device] = (out, fields, counts, start, rep)
        repo.close()
    cpu, gpu = seen["cpu"], seen["cuda"]
    differ = sorted(k for k in cpu[1] if cpu[1][k] != gpu[1][k])
    rep = gpu[4]
    log(f"planner smoke fp32, card vs CPU: vector {gpu[3].label}, "
        f"{sum(map(len, gpu[0].values()))} tokens, equal "
        f"{gpu[0] == cpu[0]}; FleetReport fields that differ {differ}; "
        f"exec.jit_compiles {rep.metrics.total('exec.jit_compiles'):.0f} "
        f"(CPU {cpu[4].metrics.total('exec.jit_compiles'):.0f}); "
        f"{len(rep.transitions)} transitions, "
        f"{_jumps(gpu[3], rep.transitions)} repository jumps; launches "
        f"{gpu[2]} (CPU {cpu[2]}); on {card}")
    if gpu[0] != cpu[0] or differ or sum(cpu[2].values()) \
            or not gpu[2]["ragged_decode"] or not rep.transitions:
        bad.append("planner smoke: the card's tokens or report differ from "
                   "the CPU's, or the kernels did not run")


def _planner_bf16(cfg, weights, prompts_at, plans, card, bad) -> dict:
    """bf16, the tuned plan against the analytic one: tok/s over host
    time (first run with captures, then a second), graphs per engine,
    specializations per exec group (from cleared exec groups), graph pool
    bytes and ``max_memory_reserved``."""
    import gc
    import torch
    from repro_torch.core.plan import EndpointPlan
    from repro_torch.serve.engine import clear_exec_groups
    result = {}
    for name, vector in plans.items():
        gc.collect()
        torch.cuda.empty_cache()
        clear_exec_groups()
        live = fresh_peak()
        client = _planned(cfg, weights, "cuda", EndpointPlan(vector=vector))
        for attempt in range(2):
            with _CaptureClock() as clock:
                outs, counts, expect, wall, _ = _fleet_run(client,
                                                           prompts_at)
            tok = sum(map(len, outs))
            groups = {id(w.engine.group): w.engine.group
                      for w in client.workers}
            graphs = [w.engine.graph_count() for w in client.workers]
            compiles = [g.compile_count() for g in groups.values()]
            if counts != expect or max(graphs) > HORIZON \
                    or (attempt and clock.count):
                bad.append(f"planner bf16 {name}: launches {counts} != "
                           f"{expect} or graphs {graphs}")
            if attempt == 0:
                pools = _pool_bytes(groups.values())
                reserved = torch.cuda.max_memory_reserved() / 2 ** 30
                result[name] = {"tok_s": tok / wall, "graphs": graphs,
                                "compiles": compiles, "pools": pools,
                                "reserved": reserved}
                log(f"planner bf16 {name} ({vector.label}, {len(groups)} "
                    f"exec groups): {tok} tokens in {wall:.2f}s host, "
                    f"{tok / wall:.1f} tok/s (captures included); graphs "
                    f"per engine {graphs} ({clock.count} captured in "
                    f"{clock.seconds:.2f}s); specializations per exec group "
                    f"{compiles}; graph pools "
                    + (f"{pools / 2 ** 20:.1f} MiB" if pools is not None
                       else "not measured")
                    + f"; max_memory_reserved {reserved:.2f} GiB ({live:.2f}"
                    f" GiB live before); on {card}")
            else:
                result[name]["tok_s_again"] = tok / wall
                log(f"  second run: {tok / wall:.1f} tok/s, {clock.count} "
                    f"graphs captured, specializations per exec group "
                    f"{compiles}; on {card}")
        del client
    return result


def serve_planner(cfg, params, first_prompts, card: str) -> dict:
    """The planner at full width: qwen2-0.5b on phase 4's weights, 8
    workers of 4 slots (the committed repository's fleet), max_len 1024,
    horizon 8, phase 11's 32 requests of 64 tokens in two bursts.  fp32
    runs of analytic and repository-resolved ``Hints`` (and the explicit
    plan of the analytic vector, and the adaptive fleet) are gated on
    tokens, launches and graphs; the smoke config's adaptive fleet must
    report on the card what it reports on the CPU; bf16 runs report the
    tuned plan against the analytic one.  -> the bf16 numbers."""
    import tempfile
    from repro_torch.models import Model
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    prompts_at = _fleet_prompts(cfg.vocab, first_prompts)
    bad = []
    with tempfile.TemporaryDirectory() as directory:
        w32 = Model(cfg32, "cuda").prepare_params(params)
        analytic, tuned = _planner_fp32(cfg32, w32, prompts_at, directory,
                                        card, bad)
        del w32
        _planner_smoke_card_vs_cpu(directory, card, bad)
    result = {}
    if tuned is not None:
        weights = Model(cfg, "cuda").prepare_params(params)
        result = _planner_bf16(cfg, weights, prompts_at,
                               {"tuned": tuned, "analytic": analytic},
                               card, bad)
    if bad:
        raise AssertionError("; ".join(bad))
    return result


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failed = []

    def phase(name, fn, *args):
        log(f"--- {name}")
        t0 = time.perf_counter()
        try:
            result = fn(*args)
        except Exception:
            traceback.print_exc()
            log(f"--- {name}: FAILED after {time.perf_counter() - t0:.1f}s")
            failed.append(name)
            return None
        log(f"--- {name}: ok in {time.perf_counter() - t0:.1f}s")
        return result

    card = phase("card", card_line)
    if card is None:
        return 1
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    phase("build", build_kernels)
    if failed:
        log(f"FAILED phases: {failed}")
        return 1
    phase("kernels vs plain versions", check_kernels)
    phase("rglru_scan vs plain version", check_rglru)
    phase("flash_attention vs plain version", check_flash)
    long = rates = None
    served = phase("serve qwen2-0.5b at full width", serve_full_width, card)
    if served is not None:
        phase("horizon cut vs uncut", horizon_cap, *served[2:], served[1],
              card)
        long = phase("serve qwen2-0.5b long prompts at full width",
                     serve_long_prompts, *served[2:], card)
        rates = phase("fused horizon: graph vs eager", graph_vs_eager,
                      *served[1:], card)
    phase("smoke config at fp32: card vs CPU", smoke_card_vs_cpu)
    rg = phase("serve recurrentgemma-2b at full width",
               serve_recurrentgemma, card)
    phase("recurrentgemma smoke config at fp32: card vs CPU",
          smoke_recurrentgemma_card_vs_cpu)
    surface = fleet = None
    if served is not None:
        surface = phase("serve qwen2-0.5b: wave, handoff, migration, "
                        "evacuation, obs at full width", serve_surface,
                        *served, card)
        fleet = phase("serve qwen2-0.5b through a fleet of 4 at full width",
                      serve_fleet, served[2], served[3], served[1], card)
    kernels = rg_kernel = flash = None
    if served is not None and long is not None:
        runs, prompts = served[:2]
        kernels = phase("decode kernel timing", time_kernels, runs,
                        [len(p) for p in prompts], long)
    if long is not None and rg is not None:
        flash = phase("flash_attention timing", time_flash, {
            "qwen2-0.5b": long["one stream"]["launches"],
            "qwen2-0.5b admission": long["contiguous"]["launches"],
            "recurrentgemma-2b": rg["flash_launches"]})
    if rg is not None:
        rg_kernel = phase("rglru_scan timing", time_rglru, rg["launches"])
    planner = None
    if served is not None:
        planner = phase("the planner at full width: hints, a tuned plan "
                        "repository, adaptive", serve_planner, served[2],
                        served[3], served[1], card)
    if failed or kernels is None or rg_kernel is None or flash is None \
            or surface is None or fleet is None or planner is None:
        log(f"FAILED phases: {failed}")
        return 1
    log(f"decode tok/s: qwen2-0.5b contiguous "
        f"{served[0]['ragged_decode']['tok_s']:.1f}, paged "
        f"{served[0]['paged_decode']['tok_s']:.1f}, long prompts contiguous "
        f"{long['contiguous']['tok_s']:.1f}, paged "
        f"{long['paged']['tok_s']:.1f}; recurrentgemma-2b "
        f"{rg['tok_s']:.1f}; on {card}")
    if rates is not None:
        log("decode tok/s, horizon graphs (first run, captures included; "
            "second run) vs eager body: " + "; ".join(
                f"{name} {r['graph']:.1f}, {r['graph, no capture']:.1f} vs "
                f"{r['eager']:.1f}" for name, r in rates.items())
            + f"; on {card}")
    log(f"decode tok/s, wave vs continuous (graphs, capture included) "
        f"on the wave phase's prompts: {surface['wave_tok_s']:.1f} vs "
        f"{surface['continuous_tok_s']:.1f}; on {card}")
    log(f"fleet bf16, tok/s over host time (first run with captures, "
        f"second run): exec level 4 {fleet[4]['tok_s']:.1f}, "
        f"{fleet[4]['tok_s_again']:.1f}; exec level 1 "
        f"{fleet[1]['tok_s']:.1f}, {fleet[1]['tok_s_again']:.1f}; single "
        f"engine {fleet['single'][0]:.1f}, {fleet['single'][1]:.1f}; on "
        f"{card}")
    log("planner bf16, tok/s over host time (first run with captures, "
        "second run): " + "; ".join(
            f"{name} {r['tok_s']:.1f}, {r['tok_s_again']:.1f}"
            for name, r in planner.items()) + f"; on {card}")
    print(json.dumps({"kernels": kernels + [flash, rg_kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
