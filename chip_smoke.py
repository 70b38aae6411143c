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
   instantiations, none spilling;
3. each decode kernel against its plain PyTorch version on the card, at
   qwen2-0.5b's decode heads (Hkv=2, G=7, dh=64) over a cache of 1024
   and one of 4096 keys, fp32 and bf16 (bf16 also row by row), softcap 0
   and 30, edge lengths, lengths on both sides of the split kernel's
   chunk edges and the long prompts' lengths, and for the paged kernel a
   fragmented page table with sentinels over a tight pool, contiguous =
   paged bit for bit at both caches; then the
   RG-LRU scan against its plain version at T in {1, 7, 2048, 3001}, C in
   {64, 2560}, fp32 and bf16, with ``a`` near 0.999 so the carry grows,
   and on strided views; then the flash kernel against its plain version
   over the reference's sweep (dh 8 to 256, G 1 to 10, windows 0, 16, 64
   and 2048, non-causal with Sk != Sq, softcap 10), at the lengths 1, 7,
   1023, 1024, 1500 and 3001, at lengths on both sides of the tensor-core
   body's tiles (15 to 129), a window ending mid-tile, and on strided
   views, fp32 and bf16 (bf16 held to its limit per case and per row);
4. qwen2-0.5b at full width (24 layers, random weights from
   ``torch.Generator`` seed 0) served through ``repro_torch.serve.connect``
   with a contiguous and with a paged (pages=4) cache: 16 requests, every
   one must return its tokens, each decode kernel's launch count must
   equal layers x executed decode steps of its run and the flash
   kernel's layers x prefills; then, contiguous, 8 of the prompts with
   budgets of 1 to 64 tokens on one ordered stream, served
   with the engine's cut of each horizon at the last live step and
   without it (every horizon runs K steps): the same tokens, and steps
   launched against executed;
5. qwen2-0.5b at full width with long prompts (1023 to 4000 tokens, pow2
   buckets, max_len 4096): 8 requests of 32 tokens at once, contiguous
   and paged, which must agree on every token, with the flash kernel
   launched layers x prefills; then the same prompts one at a time on
   one stream, so each prefills alone in its bucket (1024, 2048, 4096);
6. the qwen2-0.5b smoke config at fp32 served on the card (kernels) and
   on the CPU (plain versions, chunked attention for the round with a
   1100-token prompt): the tokens must agree;
7. recurrentgemma-2b at full width (26 layers: 18 RG-LRU blocks and 8
   local-attention blocks with window 2048, random weights from a
   ``torch.Generator`` seed 0) served through ``connect``: 8 slots,
   max_len 4096, horizon 8, 12 requests of 64 new tokens with prompts
   from 64 to 3500 tokens (four prefill past the window, four cross
   position 2048 while decoding, four stay inside it); every request
   must return its 64 tokens, the RG-LRU kernel must launch 18 times and
   the flash kernel 8 times per prefill, and the decode kernels never
   (rolling layers take plain decode attention, as in the reference);
8. the recurrentgemma smoke config at fp32 served on the card and on the
   CPU, prompts past its window of 16: the tokens must agree;
9. per kernel: its error against the plain version at the main path's
   shapes (the decode kernels at phase 4's and phase 5's caches, 1024 and
   4096 keys; the flash kernel at both models' prefill shapes and at
   qwen2-0.5b's batched admission of 8 x 4096 rows; held to the
   tolerance, bf16 attention also row by row, each row's error scaled by
   its own max |plain|), time per call (the decode kernels also replayed
   in a CUDA graph, without the host's dispatch), its bound, the plain
   version's time and, for attention,
   ``scaled_dot_product_attention``'s (a yardstick the port never calls;
   no PyTorch call computes a linear recurrence), as one JSON line.

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
        if name != "flash_attention":
            for fn, r in _ptxas_report(item["ptxas"]).items():
                log(f"    {fn[:60]}: {r}")
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
        torch.cuda.synchronize()
        expect = ref.rglru_scan_ref(a, x)
        err = (out.float() - expect.float()).abs().max().item()
        tol = rglru_tolerance(expect)
        log(f"rglru_scan {dtype} B=2 T={t} C={c}: max abs err {err:.3e} "
            f"(tolerance {tol:.3e}; max |plain| "
            f"{expect.float().abs().max().item():.1f})")
        if not err <= tol:
            bad.append((str(dtype), t, c, err))
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


def serve_once(cfg, params, prompts, pages: bool, device: str,
               max_new=None, capped: bool = True, one_stream: bool = False,
               max_len: int = SMAX):
    """Serve ``prompts`` through ``connect``, each asking for ``max_new[i]``
    tokens (default MAX_NEW), all at once or (``one_stream``) in order on
    one stream, each released when its predecessor retires; -> (outputs
    in prompt order, engine, launch counts of this run, decode seconds,
    wall seconds).  ``capped=False`` lets every horizon run all K steps,
    so steps after the last live slot are launched (and write nothing)
    instead of cut by the engine."""
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
    on_card = eng.device.type == "cuda"
    decode_s = [0.0]
    step = eng.step

    def timed_step():
        if on_card:
            torch.cuda.synchronize()
        t = time.perf_counter()
        retired = step()          # ends in the horizon's host sync
        decode_s[0] += time.perf_counter() - t
        return retired

    eng.step = timed_step
    reset_counts()
    t0 = time.perf_counter()
    out = client.run()
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    del eng.step      # the wrappers refer back to the engine: free them now
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
            f"{eng.stats['decode_calls']} horizons, {wall:.2f}s wall; "
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
            f"{prefills} prefills, {steps} decode steps; launches {counts} "
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


# ----- phase 7 ---------------------------------------------------------------

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
        f"horizons; launches {counts} (expected {expect}; decode-attention "
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


# ----- phase 8 ---------------------------------------------------------------

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


# ----- phase 9 ---------------------------------------------------------------

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


def _time_graph_ms(fn, n_layers, iters=10):
    """Mean ms per call of one sweep of ``n_layers`` calls captured in a
    CUDA graph and replayed ``iters`` times: the card's time for the calls
    without the host's dispatch of each."""
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


def time_rglru(launches: int):
    """The RG-LRU scan at the main path's shapes: (1, T=2048, C=2560)
    fp32, the gates' a and x of one prompt of 2048 tokens, one input per
    RG-LRU layer of the 18 (the prefill's working set)."""
    import torch
    from repro_torch.kernels.rglru import ops, ref
    n_layers, t, c = 18, 2048, 2560
    gen = torch.Generator(device="cuda").manual_seed(3)
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
    plain_ms = _time_ms(lambda i: ref.rglru_scan_ref(*inputs[i]), n_layers,
                        iters=1)
    elems = t * c
    t_bytes = 3 * elems * 4 / MEM_BYTES_PER_S * 1e3
    t_ops = 2 * elems / FP32_FLOPS_PER_S * 1e3
    entry = dict(name="rglru_scan", **KERNELS["rglru_scan"],
                 launches=launches, max_abs_err=err, ms=ms,
                 plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                 bound_by="bytes" if t_bytes >= t_ops else "operations",
                 library_ms=None)
    log(f"rglru_scan: {ms * 1e3:.1f} us/call, bound "
        f"{entry['bound_ms'] * 1e3:.2f} us ({entry['bound_by']}: "
        f"{3 * elems * 4 / 1e6:.1f} MB), plain {plain_ms:.1f} ms, "
        f"max abs err {err:.3e} (tolerance {tol:.3e} or more); "
        f"launches on the main path {launches}; no PyTorch call computes "
        f"a linear recurrence (library: null)")
    return entry


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
    long = None
    served = phase("serve qwen2-0.5b at full width", serve_full_width, card)
    if served is not None:
        phase("horizon cut vs uncut", horizon_cap, *served[2:], served[1],
              card)
        long = phase("serve qwen2-0.5b long prompts at full width",
                     serve_long_prompts, *served[2:], card)
    phase("smoke config at fp32: card vs CPU", smoke_card_vs_cpu)
    rg = phase("serve recurrentgemma-2b at full width",
               serve_recurrentgemma, card)
    phase("recurrentgemma smoke config at fp32: card vs CPU",
          smoke_recurrentgemma_card_vs_cpu)
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
    if failed or kernels is None or rg_kernel is None or flash is None:
        log(f"FAILED phases: {failed}")
        return 1
    log(f"decode tok/s: qwen2-0.5b contiguous "
        f"{served[0]['ragged_decode']['tok_s']:.1f}, paged "
        f"{served[0]['paged_decode']['tok_s']:.1f}, long prompts contiguous "
        f"{long['contiguous']['tok_s']:.1f}, paged "
        f"{long['paged']['tok_s']:.1f}; recurrentgemma-2b "
        f"{rg['tok_s']:.1f}; on {card}")
    print(json.dumps({"kernels": kernels + [flash, rg_kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
