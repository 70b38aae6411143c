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
   from ``cuobjdump -sass``: each body (the SIMT body in fp32 and in bf16,
   the tensor-core body in bf16) must be found at all four head_dim
   templates, the tensor-core body must have some at each, and none may
   spill;
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
   paged bit for bit at both caches, and at granite-moe-1b-a400m's
   heads (Hkv 8, G 2, dh 64) and deepseek-moe-16b's (Hkv 16, G 1, dh 128,
   where bf16 takes the SIMT body); then the
   RG-LRU scan against its plain version at T in {1, 7, 2048, 3001}, C in
   {64, 2560}, fp32 and bf16, with ``a`` near 0.999 so the carry grows,
   and on strided views, two calls equal bit for bit; then the flash
   kernel against its plain version over the reference's sweep (dh 8 to
   256, G 1 to 10, windows 0, 16, 64 and 2048, non-causal with Sk != Sq,
   softcap 10), at the lengths 1, 7,
   1023, 1024, 1500 and 3001, at lengths on both sides of the tensor-core
   body's tiles (15 to 129), a window ending mid-tile, and on strided
   views, fp32 and bf16 (bf16 held to its limit per case and per row),
   and at granite's and deepseek's batched admission (8 x 512);
4. qwen2-0.5b at full width (24 layers, random weights from
   ``torch.Generator`` seed 0) served through ``repro_torch.serve.connect``
   with a contiguous and with a paged (pages=4) cache: 16 requests, every
   one must return its tokens, each decode kernel's launch count must
   equal layers x executed decode steps of its run and the flash
   kernel's layers x prefills (on the card, here and in every later
   serving phase, each fused horizon replays the engine's CUDA graph of
   its length and each bucketed admission round the engine's graph of
   its bucket, and a replay counts the launches its capture held; the
   engine must hold one admission graph per bucket used, each captured
   at its bucket's first round, whose seconds and pool bytes are
   printed beside the later rounds'); then, contiguous, 8
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
   of both modes are printed.  Then bucketed admission as CUDA graphs
   (one per prefill bucket) against the eager body (the engine's
   admission runner swapped for the round launched op by op), in bf16
   on six paths, contiguous and paged each: qwen2-0.5b's short prompts
   (phase 4's runs), its long prompts twice over (16 requests, so that
   a second round of 8 replays the first's graph) and
   granite-moe-1b-a400m at full width and depth on phase 14's prompts;
   the tokens must agree, every one, the launches of both modes must be
   what their prefills and horizons account for, and each graph run
   must hold one admission graph per bucket used; each round's seconds
   are printed;
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

14. (run before 12, whose JSON line takes its kernel cases) the MoE and
   xLSTM families, random weights from ``torch.Generator`` seed 0 drawn
   on the card: granite-moe-1b-a400m at full width and depth (24
   layers, 32 experts top-8, 1.33B parameters; 8 slots, max_len 1024,
   horizon 8, phase 4's 16 prompt lengths, 64 new tokens), bf16
   contiguous (then a second run on the same engine) and paged, equal on
   every token, and at fp32 through graphs and the eager body, equal on
   every token; deepseek-moe-16b at full width cut to its first 4
   layers (dense layer 0, then 3 MoE layers of 2 shared + 64 routed
   experts, top-6), 8 requests of 32 tokens, contiguous = paged in
   bf16; xlstm-1.3b at full width cut to its first 8 of 48 layers (one
   period of its 7:1 pattern: 7 mLSTM and 1 sLSTM layer; at full depth
   its three runs took most of this phase and left phase 18 no room) on
   prompts of 64 to 960 tokens (the per-token scan, the chunkwise core
   at 512 and 768, the bf16 stream without chunking at 960), exact-length admission, 32 new tokens, bf16, then fp32 graphs
   = eager body, no kernel launch; every run gated on each request's
   tokens and on its launches (ragged or paged = layers x steps
   launched, flash = attention layers x prefills); tok/s,
   ``graph_count()``, ``compile_count()``, ``max_memory_allocated`` and
   ``max_memory_reserved`` printed.  Then the three smoke configs at
   fp32, card = CPU on every token (MoE contiguous and paged), and the
   decode pair and the flash kernel at granite's and deepseek's decode
   caches and admission shapes, checked against their plain versions
   and timed beside SDPA (added to phase 12's cases).
15. training: the RG-LRU scan's gradients against its plain version;
   qwen2-0.5b at full width (20 steps, a resume after a failure, the six
   ddp categories on a one-process NCCL group) and recurrentgemma-2b;
   one fp32 train step card = CPU on six smoke configs.
16. (run before 12, whose JSON line takes its kernel cases) the
   encoder-decoder and embeddings-input paths, random weights from
   ``torch.Generator`` seed 0 drawn on the card: seamless-m4t-large-v2
   at full width and depth (24 + 24 layers, 1.37B parameters) prefills
   8 rows over 4096 encoder frames and 8 prompt tokens, then 64 greedy
   steps, bf16 (flash launched 72 times a prefill: encoder, decoder
   self- and cross-attention; ragged decode 48 times a step: self and
   cross); at fp32 over 512 frames, its prefill + decode chain equals one
   full forward within ``CHAIN_REL_TOL``; then 3 train steps of (8, 512)
   tokens over as many frames.  qwen2-vl-72b at full width cut to 8 of
   its 80 layers (8.27B parameters) prefills 8 rows of 1024 embedding
   positions (a 24 x 24 image grid, then text, M-RoPE), then 32 steps
   fed embeddings on a contiguous and on a paged cache (pages of 64):
   logits equal bit for bit, flash 8 a prefill, ragged or paged 8 a
   step.  Prefill ms, decode tok/s and memory printed.  Both smoke
   configs at fp32 card = CPU (tokens, logits, launches).  The wrappers
   count every launch by (kernel, dtype, shape) at the launch
   (``ops.SHAPE_LAUNCHES``); each key these runs launched, bf16 and
   fp32, gets a case at that signature, checked against the plain
   version and timed beside SDPA, its ``launches`` the key's count
   (added to phase 12's cases); the phase fails if a key has no passing
   case.
17. (last) the dry run ``python -m repro_torch.launch.dryrun --all
   --mesh both`` in a subprocess (its fake process group cannot share a
   process with NCCL) with a worker on every core, after phase 16 and
   alone, so that no timed phase shares the host with it: every arch x
   cell x mesh on meta tensors, 64 ok and 16 skipped, none failed; its
   seconds, slowest cells, the roofline table with the H100's constants
   and ``auto_accum`` of each train cell printed.  Then, over a (1, 1)
   ("data", "model") mesh of a one-process NCCL group, steps built by
   ``make_decode_step`` with ``make_shard_fn`` installed (an identity
   here: the step's tensors are plain, not DTensors), set up by
   ``trace_serve.cell_setup``, weights from seed 0 in the dry run's
   ``params_bf16`` dtypes: qwen2-0.5b
   ``decode_32k`` at full width and depth (128 rows, a 32768-key bf16
   cache filled from a generator, ``idx`` 32767, so every step reads
   every key of every row), one untimed step and the median of 8, gated
   on finite logits, 24 ragged launches a step and the dry run's
   ``argument_bytes`` on the one-card mesh equal to the bytes handed to
   the step; recurrentgemma-2b ``long_500k`` (one row at position 524287
   of its rolling caches), gated on finite logits and no launch.  ms a
   step beside the roofline's terms; then each launched key held against
   its plain version (phase 16's mechanism, added to phase 12's cases).
18. (run after 15 and before 16, whose per-key check holds its keys) the
   six examples, ``examples/<name>_torch.py``: each ``main`` at its own
   defaults on the card (smoke configs; the two multi-rank scripts on a
   one-process NCCL group of their own), then serve_batched's body at
   fp32 on the qwen2-0.5b smoke config (the three presets' tokens must
   equal the wave's, every request), at qwen2-0.5b's full width in bf16
   (K = 1: ``Model.decode_step`` eagerly) and with ``--arch
   recurrentgemma-2b`` (the RG-LRU kernel), and quickstart's and
   train_endpoint_categories' bodies at smollm-360m's full width (20
   steps, and 5 a category: the defaults' 60 and 20 are mostly 4.3 GB
   checkpoints).  Gates: no script raises; the three categories' final
   losses bit for bit equal; the stencil's gathered grid = a plain single-tensor stencil on
   the card within ``STENCIL_REL_TOL``, with 2 halo messages per rank
   and step; ragged_decode, flash_attention and rglru_scan each
   launched.  Each run's wall seconds, serve_batched's tok/s, the median
   ms of a K = 1 decode step of qwen2-0.5b (4 slots) and of a train step
   of smollm-360m at (8, 64) printed; every (kernel, dtype, shape)
   key the runs launched (``SHAPE_LAUNCHES`` of both ops modules) joins
   phase 16's per-key check.
19. (run after 18 and before 16, whose per-key check holds its keys) the
   reference's legacy serving surface at qwen2-0.5b's full width, bf16:
   the bare launcher (``repro_torch.launch.serve.main([])``: 8 requests
   of 16 tokens, 12 new, 4 slots, max_len 256) must serve through the
   wave executor with no DeprecationWarning, every request its 12
   tokens, flash launched layers x waves and ragged decode layers x
   waves x 12; ``--category shared_dynamic --workers 4 --engine
   continuous`` must warn exactly once and serve its 8 requests through
   the fleet, both attention kernels launched; the legacy
   ``ContinuousEngine(cfg, w, n_slots=4, max_len=256,
   category=Category.STATIC)`` (one warning) must serve the launcher's
   prompts at mixed lengths with the tokens of the engine built from
   ``EndpointPlan.from_preset("static")``, every one.  Each run's wall
   seconds and the bare run's tok/s printed; every (kernel, dtype,
   shape) key the runs launched joins phase 16's per-key check.

The last line is ``{"ok": true, "device": {...}}``.  The script imports
torch, numpy and ``repro_torch`` (from ``src/``), nothing of JAX.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import os
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
        # the bodies by the C launcher's dtype code: the SIMT body in fp32
        # and in bf16 (what the tensor cores cannot take), the mma body
        found, faults = {"simt": [], "mma": [], "simt bf16": []}, []
        for fn, r in sorted(_ptxas_report(item["ptxas"]).items()):
            m = re.search(
                r"flash_attention_kernel_(simt|mma)I(\w*?)Li(\d+)E", fn)
            if not m:
                continue
            body, cap = m.group(1), int(m.group(3))
            if body == "simt" and "bfloat16" in m.group(2):
                body = "simt bf16"
            dtype = list(found).index(body)
            log(f"    flash_attention {body} dh<={cap} "
                f"({'fp32' if dtype == 0 else 'bf16'}): "
                f"{r.get('registers')} "
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


#: check_kernels' shapes: (Smax, (Hkv, G, dh), lengths); the edges of the
#: short cache, both sides of the decode kernels' first chunk edges, and
#: qwen2-0.5b's long-prompt lengths (1039 to 4016 mid-decode) up to a
#: retired row; then granite-moe-1b-a400m's heads (8 / 2, dh 64) and
#: deepseek-moe-16b's (16 / 1, dh 128: the bf16 SIMT body) at batch 8
DECODE_CHECKED = (
    (SMAX, (HKV, G, DH),
     (0, SMAX - 1, SMAX, 5000, 1, 63, 64, 700, 127, 128, 129, 255)),
    (LONG_MAX_LEN, (HKV, G, DH),
     (127, 128, 129, 1039, 2047, 2048, 3000, 4016, 4095, 5000)),
    (SMAX, (8, 2, 64), (0, 63, 64, 129, 300, 544, 1023, 5000)),
    (SMAX, (16, 1, 128), (0, 63, 64, 129, 300, 544, 1023, 5000)),
)


def check_kernels() -> None:
    import torch
    from repro_torch.kernels.flash_attention import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    ps = 64
    bad = []
    for smax, (hkv, g, dh), cur_list in DECODE_CHECKED:
        b = len(cur_list)
        cur = torch.tensor(cur_list, dtype=torch.int32, device="cuda")
        max_pages = smax // ps
        # tight: only the pages the live rows need, and two spare
        n_pages = sum(c // ps + 1 for c in cur_list if c < smax) + 2
        pt = _paged_table(gen, cur_list, max_pages, ps, n_pages)
        chunk, n_split = ops.decode_splits(smax)
        log(f"decode kernels at Smax {smax}, Hkv {hkv}, G {g}, dh {dh} "
            f"({n_split} splits of {chunk} keys), lengths {list(cur_list)}:")
        for dtype in (torch.float32, torch.bfloat16):
            for softcap in (0.0, 30.0):
                q = _rand(gen, (b, 1, hkv * g, dh), dtype)
                k = _rand(gen, (b, smax, hkv, dh), dtype)
                v = _rand(gen, (b, smax, hkv, dh), dtype)
                kp = _rand(gen, (n_pages, ps, hkv, dh), dtype)
                vp = _rand(gen, (n_pages, ps, hkv, dh), dtype)
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
                        bad.append((name, smax, hkv, g, dh, str(dtype),
                                    softcap, err, rows))
                # the same cache, contiguous and scattered over pages: both
                # kernels cut and walk keys the same way, so outputs are
                # equal
                perm = torch.randperm(b * max_pages, generator=gen,
                                      device="cuda")
                pages = torch.empty((b * max_pages, ps, hkv, dh),
                                    dtype=dtype, device="cuda")
                pages[perm] = k.reshape(b * max_pages, ps, hkv, dh)
                vpages = torch.empty_like(pages)
                vpages[perm] = v.reshape(b * max_pages, ps, hkv, dh)
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
    (8, 512, 512, 16, 8, 64, True, 0, 0.0),        # granite's admission
    (8, 512, 512, 16, 16, 128, True, 0, 0.0),      # deepseek's admission
    # smollm-360m's smoke heads (dh 20: bf16 on the SIMT body)
    (2, 40, 40, 3, 1, 20, True, 0, 0.0),
    (1, 300, 300, 3, 1, 20, True, 0, 0.0),
    (2, 65, 100, 3, 1, 12, False, 0, 0.0),
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
               max_len: int = SMAX, eager: bool = False, horizons=None,
               eager_admission: bool = False, rounds=None):
    """Serve ``prompts`` through ``connect``, each asking for ``max_new[i]``
    tokens (default MAX_NEW), all at once or (``one_stream``) in order on
    one stream, each released when its predecessor retires; -> (outputs
    in prompt order, engine, launch counts of this run, decode seconds,
    wall seconds).  ``capped=False`` lets every horizon run all K steps,
    so steps after the last live slot are launched (and write nothing)
    instead of cut by the engine.  ``eager`` swaps the engine's horizon
    runner (on the card, its CUDA graphs) for the eager body,
    ``Model.decode_horizon`` launched op by op on the same buffers;
    ``eager_admission`` swaps its admission runner (on the card, one CUDA
    graph per prefill bucket) for the eager body, the round launched op
    by op on the same buffers.  ``horizons``, a list, receives the steps
    of each horizon launched; ``rounds``, a list, a dict per bucketed
    admission round: its bucket, host seconds (the card synchronized
    before and after), whether it captured its bucket's graph and, if
    so, the bytes the engine's graph pool grew by."""
    import torch
    from repro_torch.serve import connect
    from repro_torch.serve.engine import pool_bytes
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
    run_admission = eng._run_admission
    if eager_admission:
        def run_admission(bucket):
            return eng._admissions.body(bucket)

    def timed_admission(bucket):
        if rounds is None:
            return run_admission(bucket)
        on_card = eng.device.type == "cuda"
        capture = on_card and not eager_admission and \
            bucket not in eng._admissions.graphs
        if on_card:
            torch.cuda.synchronize()
        if capture:
            # a capture empties the allocator's cache, which frees the pool
            # memory of dead graphs: free it first, so that the difference
            # is what this capture adds
            import gc
            gc.collect()
            torch.cuda.empty_cache()
        pool = (pool_bytes([eng.group]) or 0) if capture else 0
        t = time.perf_counter()
        first = run_admission(bucket)
        if on_card:
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        after = pool_bytes([eng.group]) if capture else None
        rounds.append({"bucket": bucket, "s": seconds, "capture": capture,
                       "pool_bytes": None if after is None
                       else after - pool})
        return first

    eng._run_admission = timed_admission
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
    del eng._run_admission
    eng.__dict__.pop("_horizon_steps", None)
    return [out[r] for r in rids], eng, counts, decode_s[0], wall


def _mean_s(rounds, capture: bool) -> float:
    """Mean seconds of the rounds that did (not) capture; nan if none."""
    s = [r["s"] for r in rounds if r["capture"] == capture]
    return sum(s) / len(s) if s else float("nan")


def admission_rounds(name, eng, rounds, bad, eager: bool = False) -> str:
    """A line on a run's bucketed admission rounds (``serve_once``'s
    ``rounds``), gating the engine's admission graphs: one per bucket
    used on the card (none for the eager body), each bucket captured at
    its first round only."""
    buckets = sorted({r["bucket"] for r in rounds})
    graphs = eng.admission_graph_count()
    captured = [r["bucket"] for r in rounds if r["capture"]]
    expect = [] if eager else buckets
    if graphs != len(expect) or sorted(captured) != expect:
        bad.append(f"{name}: {graphs} admission graphs, captures in "
                   f"{captured}, for buckets {buckets}")
    later = [r["s"] for r in rounds if not r["capture"]]
    first = ", ".join(
        f"{r['bucket']}: {r['s']:.4f} s"
        + (f" (pool +{r['pool_bytes'] / 2 ** 20:.1f} MiB)"
           if r["pool_bytes"] is not None else "")
        for r in rounds if r["capture"])
    return (f"admission {'eager body' if eager else 'graphs'}: "
            f"{len(rounds)} rounds in buckets {buckets}, {graphs} graphs"
            + (f"; capture rounds {first}" if first else "")
            + (f"; {'' if eager else 'replay '}rounds {len(later)}, "
               f"{sum(later):.4f} s, mean {sum(later) / len(later):.4f} s"
               if later else ""))


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
        rounds = []
        outs, eng, counts, dec_s, wall = serve_once(cfg, params, prompts,
                                                    pages, "cuda",
                                                    rounds=rounds)
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
        log("  " + admission_rounds(f"serve {layout}", eng, rounds, bad))
        if not ok_tokens:
            bad.append(f"{layout}: a request came back without its "
                       f"{MAX_NEW} tokens")
        if counts != expect:
            bad.append(f"{layout}: launches {counts} != {expect}")
        runs[name] = {"outs": outs, "launches": counts[name],
                      "tok_s": tok / dec_s, "rounds": rounds}
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

def _long_prompts(vocab):
    import numpy as np
    rng = np.random.default_rng(6)
    return [rng.integers(1, vocab, size=n).astype(np.int32)
            for n in LONG_PROMPTS]


def serve_long_prompts(cfg, params, card: str):
    """Full-width qwen2-0.5b on prompts of 1023 to 4000 tokens: all 8 at
    once (one admission round, one batched prefill in the bucket of the
    longest), contiguous and paged, then one at a time on one stream
    (each prefills alone in its own bucket).  Every prefill's attention
    runs the flash kernel, every decode step a decode kernel."""
    import numpy as np
    import torch
    prompts = _long_prompts(cfg.vocab)
    max_new = [LONG_MAX_NEW] * len(prompts)
    runs, bad = {}, []
    for name, pages, one_stream in (("contiguous", False, False),
                                    ("paged", True, False),
                                    ("one stream", False, True)):
        live = fresh_peak()
        rounds = []
        outs, eng, counts, dec_s, wall = serve_once(
            cfg, params, prompts, pages, "cuda", max_new,
            one_stream=one_stream, max_len=LONG_MAX_LEN, rounds=rounds)
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
        log("  " + admission_rounds(f"long prompts {name}", eng, rounds,
                                    bad))
        if not all(len(o) == LONG_MAX_NEW and all(0 <= t < cfg.vocab
                                                  for t in o) for o in outs):
            bad.append(f"{name}: a request came back without its "
                       f"{LONG_MAX_NEW} tokens")
        if counts != expect:
            bad.append(f"{name}: launches {counts} != {expect}")
        runs[name] = {"outs": outs, "launches": counts["flash_attention"],
                      "decode_launches": counts["paged_decode" if pages
                                                else "ragged_decode"],
                      "tok_s": tok / dec_s, "rounds": rounds}
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
    window takes plain decode attention, as in the reference; an xLSTM
    stack has no attention and launches no kernel).  ``prefills``
    defaults to every prefill the engine ran."""
    kinds = cfg.pattern_for(cfg.n_layers)
    n_rglru = sum(k == "rglru" for k in kinds)
    n_attn = sum(k in ("attn", "attn_local") for k in kinds)
    if prefills is None:
        prefills = eng.stats["prefills"]
    expect = {"ragged_decode": 0, "paged_decode": 0,
              "flash_attention": n_attn * prefills,
              "rglru_scan": n_rglru * prefills}
    if eng.model.supports_paged_cache:
        expect["paged_decode" if eng.paged else "ragged_decode"] = \
            cfg.n_layers * launched
    return expect


def _second_run(name, eng, prompts, max_new, first, bad) -> float:
    """The same requests again on the same graph engine: the same horizon
    lengths, so no capture; the tokens must be ``first``.  -> decode
    tok/s."""
    from repro_torch.serve.engine import Request
    graphs, n_done = eng.graph_count(), len(eng.done)
    tok0 = eng.stats["busy_slot_steps"]
    for i, (prompt, n) in enumerate(zip(prompts, max_new)):
        eng.submit(Request(rid=len(prompts) + i, prompt=prompt,
                           max_new_tokens=n))
    seconds = _timed_steps(eng)
    again = [r.output for r in sorted(eng.run()[n_done:],
                                      key=lambda r: r.rid)]
    del eng.step
    tok = eng.stats["busy_slot_steps"] - tok0
    log(f"  a second run on the same engine: decode "
        f"{tok / seconds[0]:.1f} tok/s ({tok} tokens in "
        f"{seconds[0]:.3f}s), {eng.graph_count()} graphs, "
        f"tokens equal to the first run's: {again == first}")
    if eng.graph_count() != graphs or again != first:
        bad.append(f"{name}: the second run captured or served other "
                   f"tokens")
    return tok / seconds[0]


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
                rates[name]["graph, no capture"] = _second_run(
                    name, eng, pr, [MAX_NEW] * len(pr), outs[mode], bad)
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


def admission_vs_eager(runs, prompts, cfg, params, card: str) -> dict:
    """Bucketed admission as CUDA graphs against the eager body, at full
    width, on six paths, contiguous and paged each: qwen2-0.5b's short
    prompts, whose graph runs are phase 4's; qwen2-0.5b's long prompts
    (phase 5's, each twice: 16 requests, so the second round of 8, in
    the same bucket, replays the graph the first captured); and
    granite-moe-1b-a400m at full width and depth in bf16 on phase 14's
    prompts.  Each path also serves with the engine's admission runner
    swapped for the eager body (the horizons still replay their graphs).
    Gates: the same tokens, every one; both modes' launches (flash =
    attention layers x prefills: a replay adds the launches its capture
    held); one admission graph per bucket used in graph mode, none in
    eager mode.  Prints each run's admission rounds: seconds of the
    rounds that captured (warm-up, capture and replay) and the pool bytes
    they added, and the later rounds' seconds.  -> {path: {mode:
    rounds}}."""
    from repro_torch.configs import get_config
    granite = get_config("granite-moe-1b-a400m")
    long_prompts = _long_prompts(cfg.vocab) * 2
    g_prompts = _prompts(granite.vocab, seed=9)[:N_REQUESTS]
    g_params = _family_weights(granite, card)
    cases = (
        ("qwen2-0.5b short contiguous", cfg, params, prompts, False, SMAX,
         MAX_NEW, runs["ragged_decode"]),
        ("qwen2-0.5b short paged", cfg, params, prompts, True, SMAX,
         MAX_NEW, runs["paged_decode"]),
        ("qwen2-0.5b long contiguous", cfg, params, long_prompts, False,
         LONG_MAX_LEN, LONG_MAX_NEW, None),
        ("qwen2-0.5b long paged", cfg, params, long_prompts, True,
         LONG_MAX_LEN, LONG_MAX_NEW, None),
        ("granite-moe-1b-a400m bf16 contiguous", granite, g_params,
         g_prompts, False, SMAX, MAX_NEW, None),
        ("granite-moe-1b-a400m bf16 paged", granite, g_params, g_prompts,
         True, SMAX, MAX_NEW, None))
    bad, out = [], {}
    for name, c, p, pr, pages, max_len, max_new, graph in cases:
        outs, out[name] = {}, {}
        if graph is not None:
            outs["graph"], out[name]["graph"] = graph["outs"], \
                graph["rounds"]
        for mode in ("graph", "eager"):
            if mode in outs:
                continue
            fresh_peak()
            horizons, rounds = [], []
            outs[mode], eng, counts, dec_s, _ = serve_once(
                c, p, pr, pages, "cuda", max_new=[max_new] * len(pr),
                max_len=max_len, horizons=horizons,
                eager_admission=mode == "eager", rounds=rounds)
            expect = _expected_launches(c, eng, sum(horizons))
            log(f"{name} {mode}: {eng.stats['prefills']} prefills, "
                f"decode {eng.stats['busy_slot_steps'] / dec_s:.1f} tok/s; "
                f"launches {counts} (expected {expect}); "
                + admission_rounds(f"{name} {mode}", eng, rounds, bad,
                                   eager=mode == "eager") + f"; on {card}")
            if counts != expect:
                bad.append(f"{name} {mode}: launches {counts} != {expect}")
            out[name][mode] = rounds
            del eng
        _gate_equal(f"{name}: admission graphs vs eager body",
                    outs["graph"], outs["eager"], card, bad)
    del g_params
    if bad:
        raise AssertionError("; ".join(bad))
    return out


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
    from repro_torch.serve.engine import pool_bytes
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
                pools = pool_bytes(groups.values())
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


def _decode_case(shape, smax, cur_list, launches, n_layers=24,
                 heads=(HKV, G, DH),
                 names=("ragged_decode", "paged_decode"),
                 dtype="bfloat16", ps=64):
    """The decode kernels ``names`` (both by default) at one cache shape:
    ``dtype``, B rows at lengths ``cur_list``, ``heads`` = (Hkv, G, dh),
    one cache per layer (contiguous, and for the paged kernel the same
    values scattered over scrambled pages of ``ps``); each checked layer
    by layer against its plain version (per case, and per row in bf16),
    then timed eagerly and as a CUDA graph beside its plain version and
    SDPA.  -> {kernel: case dict}."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    hkv, g, dh = heads
    b = len(cur_list)
    gen = torch.Generator(device="cuda").manual_seed(smax)
    dt = getattr(torch, dtype)
    cur = torch.tensor(cur_list, dtype=torch.int32, device="cuda")
    q = _rand(gen, (b, 1, hkv * g, dh), dt)
    caches = [(_rand(gen, (b, smax, hkv, dh), dt),
               _rand(gen, (b, smax, hkv, dh), dt)) for _ in range(n_layers)]
    max_pages = smax // ps
    perm = torch.randperm(b * max_pages, generator=gen, device="cuda")
    table = perm.reshape(b, max_pages).int()
    paged = []
    for k, v in caches if "paged_decode" in names else ():
        kp, vp = torch.empty_like(k), torch.empty_like(v)
        kp.view(b * max_pages, ps, hkv, dh)[perm] = \
            k.reshape(b * max_pages, ps, hkv, dh)
        vp.view(b * max_pages, ps, hkv, dh)[perm] = \
            v.reshape(b * max_pages, ps, hkv, dh)
        paged.append((kp.view(b * max_pages, ps, hkv, dh),
                      vp.view(b * max_pages, ps, hkv, dh)))
    mask = (torch.arange(smax, device="cuda")[None, :]
            <= cur[:, None])[:, None, None, :]
    qs = q.transpose(1, 2)                         # (B, Hq, 1, dh)

    def sdpa(k, v):
        return F.scaled_dot_product_attention(
            qs, k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
            enable_gqa=True)

    n_keys = sum(min(c, smax - 1) + 1 for c in cur_list)
    elt = q.element_size()
    kv_bytes = 2 * n_keys * hkv * dh * elt
    io_bytes = 2 * q.numel() * elt + cur.numel() * 4
    flops = 4 * n_keys * hkv * g * dh
    chunk, n_split = ops.decode_splits(smax)
    cases = {}
    for name in names:
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
            r = row_error(out, expect) if dt == torch.bfloat16 else 0.0
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


def _flash_case(gen, model, b, s, hq, hkv, dh, window, launches,
                n_inputs=4, causal=True, sk=None, dtype="bfloat16"):
    """The flash kernel at one prefill shape, ``dtype``, ``s`` queries
    over ``sk`` keys (default ``s``), causal or not, ``n_inputs`` inputs
    in turn: checked against its plain version (per case, and per row in
    bf16), timed beside it and ``scaled_dot_product_attention``
    (``is_causal``, or a boolean mask for the window).  -> case dict."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    dt = getattr(torch, dtype)
    bf16 = dt == torch.bfloat16
    sk = sk or s
    inputs = [(_rand(gen, (b, s, hq, dh), dt),
               _rand(gen, (b, sk, hkv, dh), dt),
               _rand(gen, (b, sk, hkv, dh), dt)) for _ in range(n_inputs)]
    kw = dict(causal=causal, window=window)
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
            is_causal=causal and not window, enable_gqa=True).transpose(1, 2)

    err, tol, rows = 0.0, float("inf"), 0.0
    for i in range(n_inputs):
        expect, out = plain(i), kern(i)
        e = (out.float() - expect.float()).abs().max().item()
        r = row_error(out, expect) if bf16 else 0.0
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
    if causal:
        pairs = b * sum(min(t + 1, window) if window else t + 1
                        for t in range(s))
    else:
        pairs = b * s * sk
    flops = 4 * pairs * dh * hq
    io_bytes = 2 * b * (s * hq * dh + sk * hkv * dh) * dt.itemsize
    t_bytes = io_bytes / MEM_BYTES_PER_S * 1e3
    # bf16 runs the tensor-core body, fp32 the SIMT one
    peak = "bf16 tensor-core" if bf16 else "fp32 FMA"
    t_ops = flops / (BF16_FLOPS_PER_S if bf16 else FP32_FLOPS_PER_S) * 1e3
    span = f"{s}" if sk == s else f"{s} -> {sk}"
    case = dict(model=model, shape=f"({b}, {span}, {hq}/{hkv}, {dh}) "
                f"{'causal' if causal else 'non-causal'}"
                f"{f' window {window}' if window else ''} "
                f"{'bf16' if bf16 else 'fp32'}",
                launches=launches, max_abs_err=err, max_row_rel_err=rows,
                ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=lib_ms)
    log(f"flash_attention at {case['shape']} ({model}): {ms * 1e3:.1f} "
        f"us/call, bound {case['bound_ms'] * 1e3:.1f} us "
        f"({case['bound_by']}: {flops / 1e9:.2f} GFLOP over "
        f"{pairs} unmasked pairs at the {peak} peak; "
        f"{flops / FP32_FLOPS_PER_S * 1e6:.0f} us at the fp32 FMA peak; "
        f"{io_bytes / 1e6:.1f} MB), plain {plain_ms * 1e3:.1f} us, SDPA "
        f"{lib_ms * 1e3:.1f} us (max abs err vs plain {lib_err:.3e}), "
        f"max abs err {err:.3e} (tolerance {tol:.3e} or more), "
        f"row-scaled err {rows:.4f} (limit {BF16_REL_TOL:.4f}); "
        f"launches on the main path {launches}")
    return case


def time_flash(launches: dict):
    """The flash kernel at each main path's prefill shape (``FLASH_TIMED``,
    four inputs in turn), against its plain version and
    ``scaled_dot_product_attention``.  ``launches``: the kernel's count
    on each path's main-path run.  The entry's own numbers are the first
    shape's; ``cases`` holds every shape's."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(5)
    cases = [_flash_case(gen, model, b, s, hq, hkv, dh, window,
                         launches[model])
             for model, b, s, hq, hkv, dh, window in FLASH_TIMED]
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
    from repro_torch.serve.engine import clear_exec_groups, pool_bytes
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
                pools = pool_bytes(groups.values())
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


# ----- phase 14 --------------------------------------------------------------

#: deepseek-moe-16b at full width, cut to its first 4 layers: the dense
#: layer 0 (d_ff 10944), then 3 MoE layers (2 shared + 64 routed
#: experts, top-6, d_expert 1408)
DEEPSEEK_LAYERS = 4
FAMILY_REQUESTS, FAMILY_MAX_NEW = 8, 32
#: xlstm-1.3b's prompts: the per-token scan below 512 tokens (the fp32
#: stream), the chunkwise core at 512 and 768 (the bf16 stream), and 960
#: on the bf16 stream without chunking (960 + 32 < max_len 1024)
XLSTM_PROMPTS = (64, 100, 200, 300, 450, 512, 768, 960)
#: xlstm-1.3b at full width, cut to its first 8 layers: one period of its
#: 7:1 pattern (7 mLSTM, then 1 sLSTM layer)
XLSTM_LAYERS = 8


def _family_run(name, cfg, params, prompts, pages, max_new, card, bad,
                eager=False):
    """One ``serve_once`` of ``cfg`` on the card (graph replays, or the
    eager body), gated on every request's tokens and on the launches its
    prefills and launched horizon steps account for; -> a dict of the
    run (outputs, engine, launch counts, decode tok/s, peak GiB)."""
    import torch
    live = fresh_peak()
    horizons = []
    outs, eng, counts, dec_s, wall = serve_once(
        cfg, params, prompts, pages, "cuda", max_new=max_new, eager=eager,
        horizons=horizons)
    expect = _expected_launches(cfg, eng, sum(horizons))
    tok = eng.stats["busy_slot_steps"]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    reserved = torch.cuda.max_memory_reserved() / 2 ** 30
    log(f"{name}: {len(outs)} requests, {sum(map(len, outs))} tokens, "
        f"{eng.stats['prefills']} prefills (buckets "
        f"{list(eng.prefill_buckets) or 'off'}, paged {eng.paged}), "
        f"{eng.stats['decode_steps']} decode steps, {sum(horizons)} "
        f"launched; decode {tok / dec_s:.1f} tok/s ({tok} tokens in "
        f"{dec_s:.3f}s; first run, captures included), wall {wall:.2f}s; "
        f"graph_count() {eng.graph_count()}, compile_count() "
        f"{eng.compile_count()}; max_memory_allocated {peak:.2f} GiB, "
        f"max_memory_reserved {reserved:.2f} GiB ({live:.2f} GiB live "
        f"before); launches {counts} (expected {expect}); on {card}")
    if not all(len(o) == n and all(0 <= t < cfg.vocab for t in o)
               for o, n in zip(outs, max_new)):
        bad.append(f"{name}: a request came back without its tokens")
    if counts != expect:
        bad.append(f"{name}: launches {counts} != {expect}")
    if not eager and not 1 <= eng.graph_count() <= HORIZON:
        bad.append(f"{name}: {eng.graph_count()} graphs")
    return dict(outs=outs, eng=eng, counts=counts, tok_s=tok / dec_s,
                peak=peak, reserved=reserved)


def _gate_equal(what, a, b, card, bad) -> None:
    same = sum(x == y for p, q in zip(a, b) for x, y in zip(p, q))
    total = sum(map(len, a))
    log(f"{what}: {same}/{total} tokens agree; on {card}")
    if a != b:
        bad.append(f"{what}: tokens differ")


def _family_weights(cfg, card):
    """Full-width weights drawn on the card from ``torch.Generator``
    seed 0 (fp32)."""
    import torch
    from repro_torch.models import Model
    t0 = time.perf_counter()
    model = Model(cfg, "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    log(f"{cfg.name}: {model.n_params() / 1e6:.1f}M params, "
        f"{cfg.n_layers} layers, d_model {cfg.d_model}, vocab {cfg.vocab}, "
        f"drawn on the card in {time.perf_counter() - t0:.1f}s")
    return params


def _serve_moe(cfg, n_requests, max_new, card, bad, fp32_graph_vs_eager):
    """bf16 contiguous (then a second run on the same engine) and paged,
    equal on every token; with ``fp32_graph_vs_eager`` the fp32 weights
    through graphs and through the eager body, equal on every token.
    -> the runs' numbers."""
    params = _family_weights(cfg, card)
    prompts = _prompts(cfg.vocab, seed=9)[:n_requests]
    budgets = [max_new] * len(prompts)
    runs = {"lengths": [len(p) for p in prompts]}
    for pages in (False, True):
        name = f"{cfg.name} bf16 {'paged' if pages else 'contiguous'}"
        run = _family_run(name, cfg, params, prompts, pages, budgets, card,
                          bad)
        if not pages:
            run["tok_s_again"] = _second_run(name, run["eng"], prompts,
                                             budgets, run["outs"], bad)
        del run["eng"]
        runs["paged" if pages else "contiguous"] = run
    _gate_equal(f"{cfg.name} bf16 contiguous vs paged",
                runs["contiguous"]["outs"], runs["paged"]["outs"], card, bad)
    if fp32_graph_vs_eager:
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        for eager in (False, True):
            run = _family_run(f"{cfg.name} fp32 "
                              f"{'eager body' if eager else 'graphs'}",
                              cfg32, params, prompts, False, budgets, card,
                              bad, eager=eager)
            del run["eng"]
            runs["fp32 eager" if eager else "fp32 graphs"] = run
        _gate_equal(f"{cfg.name} fp32 graphs vs eager body",
                    runs["fp32 graphs"]["outs"], runs["fp32 eager"]["outs"],
                    card, bad)
    del params
    return runs


def _serve_xlstm(card, bad):
    """xlstm-1.3b at full width cut to XLSTM_LAYERS layers: exact-length
    admission of the 8 prompts (per-token scan, chunkwise core, the bf16
    switch), 32 new tokens each; bf16 through graphs, then fp32 through
    graphs and the eager body, equal on every token.  No kernel launches:
    the stack has no attention."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("xlstm-1.3b"),
                              n_layers=XLSTM_LAYERS)
    log(f"xlstm-1.3b: full width, cut to its first {XLSTM_LAYERS} of 48 "
        f"layers (7 mLSTM, then 1 sLSTM)")
    params = _family_weights(cfg, card)
    prompts = _rg_prompts(cfg.vocab, XLSTM_PROMPTS, seed=10)
    budgets = [FAMILY_MAX_NEW] * len(prompts)
    runs = {}
    for name, c, eager in (
            ("bf16", cfg, False),
            ("fp32 graphs", dataclasses.replace(cfg,
                                                compute_dtype="float32"),
             False),
            ("fp32 eager", dataclasses.replace(cfg,
                                               compute_dtype="float32"),
             True)):
        run = _family_run(f"xlstm-1.3b {name}", c, params, prompts, False,
                          budgets, card, bad, eager=eager)
        if run["eng"].prefill_buckets or run["eng"].paged or \
                sum(run["counts"].values()):
            bad.append(f"xlstm-1.3b {name}: buckets, pages or launches")
        del run["eng"]
        runs[name] = run
    _gate_equal("xlstm-1.3b fp32 graphs vs eager body",
                runs["fp32 graphs"]["outs"], runs["fp32 eager"]["outs"],
                card, bad)
    del params
    return runs


def _family_smoke_card_vs_cpu(card, bad) -> None:
    """The three smoke configs at fp32 on the card (kernels, graphs) and
    on the CPU (plain versions): 12 prompts of 4 to 47 tokens, 16 new
    each, max_len 64; the MoE ones contiguous and paged."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Model
    for arch in ("granite-moe-1b-a400m", "deepseek-moe-16b", "xlstm-1.3b"):
        cfg = dataclasses.replace(get_smoke_config(arch),
                                  compute_dtype="float32")
        params = Model(cfg, "cpu").init(torch.Generator().manual_seed(0))
        lengths = np.random.default_rng(11).integers(4, 48, size=12)
        prompts = _rg_prompts(cfg.vocab, [int(n) for n in lengths], seed=12)
        for pages in ((False, True) if cfg.moe else (False,)):
            card_out, eng, counts, _, _ = serve_once(
                cfg, params, prompts, pages, "cuda", max_new=[16] * 12,
                max_len=64)
            cpu, _, cpu_counts, _, _ = serve_once(
                cfg, params, prompts, pages, "cpu", max_new=[16] * 12,
                max_len=64)
            name = f"{arch} smoke fp32 {'paged' if pages else 'contiguous'}"
            _gate_equal(f"{name}: card (launches {counts}) vs CPU (plain "
                        f"versions, launches {cpu_counts})", card_out, cpu,
                        card, bad)
            if sum(cpu_counts.values()) or counts["flash_attention"] != \
                    _expected_launches(cfg, eng, 0)["flash_attention"]:
                bad.append(f"{name}: launch counts")
            del eng


def serve_moe_xlstm(card: str) -> dict:
    """Phase 14: the MoE and xLSTM families at full width (see the
    module docstring), the smoke configs card against CPU, and the
    attention kernels at the new heads (granite's and deepseek's decode
    caches and batched admissions), each checked against its plain
    version and timed.  -> the runs' numbers and the kernel cases."""
    from repro_torch.configs import get_config
    import torch
    bad = []
    granite = _serve_moe(get_config("granite-moe-1b-a400m"), N_REQUESTS,
                         MAX_NEW, card, bad, fp32_graph_vs_eager=True)
    cut = dataclasses.replace(get_config("deepseek-moe-16b"),
                              n_layers=DEEPSEEK_LAYERS)
    log(f"deepseek-moe-16b: full width, cut to its first "
        f"{DEEPSEEK_LAYERS} of 28 layers (dense layer 0, then "
        f"{DEEPSEEK_LAYERS - 1} MoE layers)")
    deepseek = _serve_moe(cut, FAMILY_REQUESTS, FAMILY_MAX_NEW, card, bad,
                          fp32_graph_vs_eager=False)
    xlstm = _serve_xlstm(card, bad)
    _family_smoke_card_vs_cpu(card, bad)
    if bad:
        raise AssertionError("; ".join(bad))
    decode, flash = {}, []
    gen = torch.Generator(device="cuda").manual_seed(14)
    for model, runs, max_new, n_layers, heads in (
            ("granite-moe-1b-a400m", granite, MAX_NEW, 24, (8, 2, 64)),
            ("deepseek-moe-16b", deepseek, FAMILY_MAX_NEW, DEEPSEEK_LAYERS,
             (16, 1, 128))):
        lengths = runs["lengths"][:B]
        launches = {"ragged_decode": runs["contiguous"]["counts"][
                        "ragged_decode"],
                    "paged_decode": runs["paged"]["counts"]["paged_decode"]}
        decode[model] = _decode_case(
            f"B={B}, Smax={SMAX}, Hkv={heads[0]}, G={heads[1]}, "
            f"dh={heads[2]} bf16 ({model})", SMAX,
            [n + max_new // 2 for n in lengths], launches,
            n_layers=n_layers, heads=heads)
        # the first admission round: B prompts padded to their bucket
        bucket = 8
        while bucket < max(lengths):
            bucket *= 2
        hq = heads[0] * heads[1]
        flash.append(_flash_case(
            gen, model, B, bucket, hq, heads[0], heads[2], 0,
            runs["contiguous"]["counts"]["flash_attention"]))
    return {"granite": granite, "deepseek": deepseek, "xlstm": xlstm,
            "decode": decode, "flash": flash}


# ----- phase 15 --------------------------------------------------------------

#: the training phase: sequence length and global batch of every
#: full-width train step, qwen2-0.5b's steps, the step at which the
#: resume run fails, the ddp runs' steps, recurrentgemma-2b's steps
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 512, 8, 20
FAIL_AT, DDP_STEPS, RG_TRAIN_STEPS = 13, 3, 5
#: the scan backward's checked shapes (recurrentgemma's lru width)
SCAN_GRAD_SHAPES = ((1, 2048, 2560), (8, 512, 2560))
#: the smoke configs whose fp32 train step must be the CPU's
TRAIN_SMOKE_ARCHS = ("qwen2-0.5b", "recurrentgemma-2b",
                     "granite-moe-1b-a400m", "xlstm-1.3b",
                     "seamless-m4t-large-v2", "qwen2-vl-72b")
#: checkpoints of the training runs (removed after each run)
TRAIN_DIR = ROOT / "build" / "train"


def _local_store():
    """A one-process group's store, listening on a localhost port of its
    own choosing (a probed free port could be taken before the store
    binds it)."""
    import torch.distributed as dist
    return dist.TCPStore("localhost", 0, world_size=1, is_master=True)


def _free_card() -> None:
    """Drop what earlier phases left (engines in reference cycles, exec
    groups and their graph pools, the allocator's cached blocks)."""
    import gc
    import torch
    from repro_torch.serve.engine import clear_exec_groups
    gc.collect()
    clear_exec_groups()
    torch.cuda.empty_cache()


def _leaves(tree):
    import torch
    from repro_torch.models.params import tree_leaves
    return tree_leaves(tree, torch.is_tensor)


def _trees_equal(a, b) -> bool:
    import torch
    return all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))


def _finite(*values) -> bool:
    import math
    return all(math.isfinite(float(v)) for v in values)


def _memory() -> str:
    import torch
    gib = 2 ** 30
    return (f"max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB, reserved "
            f"{torch.cuda.max_memory_reserved() / gib:.2f} GiB")


def _plain_scan_backward(a, h, g):
    """The scan's backward through the plain version (``ref.py``)."""
    import torch.nn.functional as F
    from repro_torch.kernels.rglru.ref import rglru_scan_ref
    a_rev = F.pad(a.flip(1)[:, :-1], (0, 0, 1, 0))
    d = rglru_scan_ref(a_rev, g.float().flip(1)).flip(1)
    return d * F.pad(h[:, :-1].float(), (0, 0, 1, 0)), d


def check_scan_grad(card: str) -> dict:
    """The RG-LRU Function's gradients (da, dx) on the card against torch
    autograd through ``ref.py`` at ``SCAN_GRAD_SHAPES``, fp32 and bf16 x
    (a fp32), within the kernel's limits (``rglru_tolerance`` of the
    case's plain output: 1e-5 of max(1, max|plain|) in fp32, 4 bf16 ulps
    of max|plain| in bf16); then the backward call (``ops.scan_backward``,
    one kernel launch) at (8, 512, 2560) fp32, one input per RG-LRU layer
    of the 18, timed eagerly and in a CUDA graph beside its plain
    version.  -> the backward's entry of the ``kernels`` line."""
    import torch
    from repro_torch.kernels.rglru import ops, ref
    err = 0.0
    for b, t, c in SCAN_GRAD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device="cuda").manual_seed(b * t)
            a, x = _rglru_inputs(gen, b, t, c, torch.float32)
            x = x.to(dtype)
            g = _rand(gen, (b, t, c), dtype)
            a1, x1 = a.clone().requires_grad_(), x.clone().requires_grad_()
            got = torch.autograd.grad(ops.rglru_scan(a1, x1), (a1, x1), g)
            a2, x2 = a.clone().requires_grad_(), x.clone().requires_grad_()
            want = torch.autograd.grad(ref.rglru_scan_ref(a2, x2), (a2, x2),
                                       g)
            for name, gv, wv in zip(("da", "dx"), got, want):
                e = (gv.float() - wv.float()).abs().max().item()
                tol = rglru_tolerance(wv.to(dtype))
                if not e <= tol:
                    raise AssertionError(
                        f"scan gradient {name} at ({b}, {t}, {c}) {dtype}: "
                        f"err {e} > {tol}")
                if dtype == torch.float32 and (b, t) == (8, 512):
                    err = max(err, e)
            log(f"scan gradients at ({b}, {t}, {c}) x {dtype}: da, dx "
                f"within the kernel's limits")
    n_layers, (b, t, c) = 18, SCAN_GRAD_SHAPES[1]
    gen = torch.Generator(device="cuda").manual_seed(15)
    inputs = []
    for _ in range(n_layers):
        a, x = _rglru_inputs(gen, b, t, c, torch.float32)
        inputs.append((a, ref.rglru_scan_ref(a, x), _rand(gen, (b, t, c),
                                                            torch.float32)))
    ms = _time_ms(lambda i: ops.scan_backward(*inputs[i], torch.float32),
                  n_layers)
    graph_ms = _time_graph_ms(
        lambda i: ops.scan_backward(*inputs[i], torch.float32), n_layers,
        iters=20, warmup=20)
    plain_ms = _time_ms(lambda i: _plain_scan_backward(*inputs[i]),
                        n_layers, iters=1)
    n = b * t * c
    io_bytes = n * 4 * 5            # a, h, g read; da, dx written
    t_bytes = io_bytes / MEM_BYTES_PER_S * 1e3
    t_ops = 3 * n / FP32_FLOPS_PER_S * 1e3
    entry = dict(shape=f"B={b}, T={t}, C={c} fp32", max_abs_err=err, ms=ms,
                 graph_ms=graph_ms, plain_ms=plain_ms,
                 bound_ms=max(t_bytes, t_ops),
                 bound_by="bytes" if t_bytes >= t_ops else "operations",
                 library_ms=None, bytes=io_bytes)
    log(f"rglru_scan backward at ({b}, {t}, {c}) fp32: {ms * 1e3:.2f} "
        f"us/call eager, {graph_ms * 1e3:.2f} us/call in a CUDA graph, "
        f"bound {entry['bound_ms'] * 1e3:.2f} us ({entry['bound_by']}: "
        f"{io_bytes / 1e6:.1f} MB), plain {plain_ms:.1f} ms, max abs err "
        f"{err:.3e}; on {card}")
    return entry


def _train_config(name: str, **kw):
    from repro_torch.train.loop import TrainConfig
    fields = dict(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                  n_steps=TRAIN_STEPS, checkpoint_every=10, log_every=5,
                  remat=True, checkpoint_dir=str(TRAIN_DIR / name),
                  device="cuda")
    fields.update(kw)
    return TrainConfig(**fields)


def train_qwen2(card: str) -> dict:
    """qwen2-0.5b at full width and depth from seed 0 (fp32 leaves, bf16
    compute, remat): ``Trainer`` for 20 steps of (8, 512), checkpoints
    every 10, then a second run that fails at step 13, restores step 10
    and must end with the first run's params bit for bit, with one
    restart.  Both run under ``torch.use_deterministic_algorithms``
    (switched off after them), so the timed run is the deterministic
    one.  Gates: loss and grad norm finite at every logged step, the last
    logged loss below the first, no flash launch (training runs the
    reference's attention)."""
    import shutil
    import statistics
    import torch
    from repro_torch.configs import get_config
    from repro_torch.runtime import TransientWorkerFailure
    from repro_torch.train.loop import Trainer
    cfg = get_config("qwen2-0.5b")
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    _free_card()
    torch.use_deterministic_algorithms(True)
    try:
        stamps = []

        def clock(step):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

        first = Trainer(cfg, _train_config("qwen2_a"))
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        logs = first.train(failure_injector=clock)
        counts = read_counts()
        memory = _memory()
        first.opt_state = None
        fired = []

        def chaos(step):
            if step == FAIL_AT and not fired:
                fired.append(step)
                raise TransientWorkerFailure("injected")

        second = Trainer(cfg, _train_config("qwen2_b"))
        second.train(failure_injector=chaos)
        same = _trees_equal(first.params, second.params)
        restarts = second.supervisor.restarts
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    ms = statistics.median(step_ms[2:])
    tok_s = TRAIN_BATCH * TRAIN_SEQ / ms * 1e3
    log(f"qwen2-0.5b train ({cfg.n_layers} layers, {TRAIN_STEPS} steps of "
        f"({TRAIN_BATCH}, {TRAIN_SEQ}), deterministic): losses "
        + ", ".join(f"{m['step']}: {m['loss']:.4f}" for m in logs)
        + f"; grad norms " + ", ".join(f"{m['grad_norm']:.3f}" for m in logs)
        + f"; {ms:.1f} ms a step (median after step 2; steps "
        + ", ".join(f"{x:.1f}" for x in step_ms) + f"), {tok_s:.0f} "
        f"tokens/s, {memory}; launches {counts}; resume after a failure "
        f"at step {FAIL_AT}: restarts {restarts}, params equal {same}; "
        f"on {card}")
    bad = [m["step"] for m in logs
           if not _finite(m["loss"], m["grad_norm"])]
    if bad or not logs[-1]["loss"] < logs[0]["loss"]:
        raise AssertionError(f"qwen2-0.5b training: non-finite at steps "
                             f"{bad} or the loss did not fall")
    if counts["flash_attention"]:
        raise AssertionError("training launched the flash kernel")
    if not (fired and restarts == 1 and same):
        raise AssertionError(f"resume after a failure: fired {fired}, "
                             f"restarts {restarts}, params equal {same}")
    return dict(ms=ms, tok_s=tok_s, memory=memory,
                first_loss=logs[0]["loss"], last_loss=logs[-1]["loss"])


def ddp_qwen2(card: str) -> dict:
    """qwen2-0.5b at full width in ``ddp`` mode on a one-process NCCL
    group, deterministic: for each of the six categories, 3 steps of
    ``make_ddp_train_step`` from seed 0 must end with the params of 3
    steps of ``make_train_step`` (jit mode) bit for bit, and each step
    must issue as many collectives as its bucket plan has (bucket, dtype)
    buffers; then ``Int8Compressor`` for 3 steps with a finite loss."""
    import torch
    import torch.distributed as dist
    from repro_torch.comm.compression import Int8Compressor
    from repro_torch.configs import get_config
    from repro_torch.core.endpoints import Category
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch.steps import make_ddp_train_step, make_train_step
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    cfg = get_config("qwen2-0.5b")
    model = Model(cfg, "cuda")
    opt = AdamW(learning_rate=cosine_schedule(3e-4, 20, DDP_STEPS))
    data = SyntheticLMData(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                           global_batch=TRAIN_BATCH)
    _free_card()
    dist.init_process_group("nccl", store=_local_store(), world_size=1,
                            rank=0)
    torch.use_deterministic_algorithms(True)

    def run(step, ddp, comp=()):
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        state, losses, times = opt.init(params), [], []
        for i in range(DDP_STEPS):
            batch = {k: torch.from_numpy(v).cuda()
                     for k, v in data.batch_at(i).items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if ddp:
                params, state, m, comp = step(params, state, batch, comp)
            else:
                params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
            times.append((time.perf_counter() - t0) * 1e3)
        return params, losses, times

    rows, bad = {}, []
    try:
        ref_params, ref_losses, ref_ms = run(make_train_step(model, opt),
                                             False)
        for cat in Category:
            step, engine = make_ddp_train_step(model, opt, category=cat)
            params, losses, ms = run(step, True)
            buffers = engine.make_plan(params).n_buffers
            same = _trees_equal(params, ref_params)
            rows[cat.value] = dict(collectives=engine.last_collectives,
                                   buffers=buffers, bytes=engine.last_bytes,
                                   equal=same, ms=ms[-1])
            if not same or engine.last_collectives != buffers \
                    or losses != ref_losses:
                bad.append(cat.value)
            del params
        step, engine = make_ddp_train_step(model, opt,
                                           category=Category.DYNAMIC,
                                           compressor=Int8Compressor())
        shapes = model.init(torch.Generator(device="cuda").manual_seed(0))
        comp = engine.init_compressor_state(shapes)
        del shapes
        _, int8_losses, int8_ms = run(step, True, comp)
    finally:
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()
    log("qwen2-0.5b ddp (one-process NCCL group, deterministic, "
        f"{DDP_STEPS} steps of ({TRAIN_BATCH}, {TRAIN_SEQ})): jit losses "
        f"{ref_losses}, last step {ref_ms[-1]:.1f} ms; " + "; ".join(
            f"{name} {r['collectives']} collectives a step (plan buffers "
            f"{r['buffers']}), {r['bytes'] / 1e9:.3f} GB, last step "
            f"{r['ms']:.1f} ms, equal to jit {r['equal']}"
            for name, r in rows.items())
        + f"; int8 losses {int8_losses}, last step {int8_ms[-1]:.1f} ms; "
        f"on {card}")
    if bad:
        raise AssertionError(f"ddp differs from jit or its collectives from "
                             f"its plan: {bad}")
    if not _finite(*int8_losses):
        raise AssertionError(f"int8 ddp loss not finite: {int8_losses}")
    return dict(rows=rows, jit_ms=ref_ms[-1], int8_losses=int8_losses)


def train_recurrentgemma(card: str) -> dict:
    """recurrentgemma-2b at full width and depth from seed 0 (fp32
    leaves, bf16 compute, remat): 5 steps of ``make_train_step`` at
    (8, 512).  Gates: finite loss and grad norm; ``rglru_scan`` launched
    as often as the remat structure says (``remat_forward_counts``: each
    RG-LRU layer's forward runs, plus its backward's reverse-time call,
    per step), the backward's calls counted apart (``scan_backward``: one
    per RG-LRU layer and step); no flash launch."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.kernels.rglru import ops as rglru_ops
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import remat_forward_counts
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    cfg = get_config("recurrentgemma-2b")
    model = Model(cfg, "cuda")
    plan = model.plan
    descs = list(plan.prefix) + list(plan.period) * plan.n_periods
    per_step = [n + 1 for n, d in zip(remat_forward_counts(plan), descs)
                if d.kind == "rglru"]
    expected = RG_TRAIN_STEPS * sum(per_step)
    expected_backward = RG_TRAIN_STEPS * len(per_step)
    _free_card()
    opt = AdamW(learning_rate=cosine_schedule(3e-4, 20, RG_TRAIN_STEPS))
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    state = opt.init(params)
    step = make_train_step(model, opt, remat=True)
    data = SyntheticLMData(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                           global_batch=TRAIN_BATCH)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, norms, step_ms = [], [], []
    for i in range(RG_TRAIN_STEPS):
        batch = {k: torch.from_numpy(v).cuda()
                 for k, v in data.batch_at(i).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts = read_counts()
    backward = rglru_ops.BACKWARD_LAUNCHES["scan_backward"]
    memory = _memory()
    del params, state
    _free_card()
    ms = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    log(f"recurrentgemma-2b train ({cfg.n_layers} layers, "
        f"{len(per_step)} RG-LRU, {RG_TRAIN_STEPS} steps of ({TRAIN_BATCH}, "
        f"{TRAIN_SEQ})): losses {losses}, grad norms {norms}; steps "
        + ", ".join(f"{x:.1f}" for x in step_ms) + f" ms ({ms:.1f} median "
        f"after the first), {TRAIN_BATCH * TRAIN_SEQ / ms * 1e3:.0f} "
        f"tokens/s, {memory}; rglru_scan launches {counts['rglru_scan']} "
        f"(expected {expected}: {RG_TRAIN_STEPS} steps x {per_step}), of "
        f"them scan_backward {backward} (expected {expected_backward}), "
        f"flash {counts['flash_attention']}; on {card}")
    if not _finite(*losses, *norms):
        raise AssertionError("recurrentgemma-2b training: non-finite loss "
                             "or grad norm")
    if counts["rglru_scan"] != expected or counts["flash_attention"] \
            or backward != expected_backward:
        raise AssertionError(f"recurrentgemma-2b training launches "
                             f"{counts}, scan_backward {backward}, expected "
                             f"rglru_scan {expected}, scan_backward "
                             f"{expected_backward}")
    return dict(ms=ms, memory=memory, launches=counts["rglru_scan"],
                backward_launches=backward)


def train_smoke_card_vs_cpu(card: str) -> None:
    """One train step's loss and gradients (``value_and_grad``) at fp32
    on the smoke configs of ``TRAIN_SMOKE_ARCHS``, (2, 32) batches of
    ``_smoke_inputs`` and labels, card against CPU: the loss within 1e-5
    relative, each gradient leaf within 1e-4 of its largest CPU
    magnitude, floored at 1e-3 of the model's largest (a gradient that is
    exactly zero, as the sLSTM input-gate bias's, holds rounding noise of
    about 1e-9 on both devices)."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models.model import Model
    from repro_torch.models.params import tree_map
    bad = []
    for arch in TRAIN_SMOKE_ARCHS:
        cfg = dataclasses.replace(get_smoke_config(arch),
                                  compute_dtype="float32")
        params = Model(cfg, "cpu").init(torch.Generator().manual_seed(0))
        gen = torch.Generator().manual_seed(1)
        batch, _ = _smoke_inputs(cfg, 2, 32, gen)
        batch["labels"] = torch.randint(0, cfg.vocab, (2, 32), generator=gen)
        out = {}
        for dev in ("cpu", "cuda"):
            out[dev] = value_and_grad(
                Model(cfg, dev),
                tree_map(lambda t: t.to(dev), params, torch.is_tensor),
                {k: v.to(dev) for k, v in batch.items()})
        (l_cpu, _), g_cpu = out["cpu"]
        (l_card, _), g_card = out["cuda"]
        g_cpu, g_card = _leaves(g_cpu), _leaves(g_card)
        floor = 1e-3 * max(g.abs().max().item() for g in g_cpu)
        worst = max((a.cpu() - b).abs().max().item()
                    / max(b.abs().max().item(), floor)
                    for a, b in zip(g_card, g_cpu))
        loss_err = abs(l_card.item() - l_cpu.item()) / abs(l_cpu.item())
        log(f"{arch} smoke fp32 train step: loss card {l_card.item():.6f} "
            f"CPU {l_cpu.item():.6f} (rel {loss_err:.2e}), worst gradient "
            f"leaf {worst:.2e} of its scale")
        if not (loss_err <= 1e-5 and worst <= 1e-4):
            bad.append(arch)
    if bad:
        raise AssertionError(f"card and CPU train steps differ: {bad}")


# ----- phase 16 --------------------------------------------------------------

#: seamless-m4t-large-v2's phase: rows, encoder frames (the reference's
#: encoder length for enc-dec decode cells, ``ENC_STUB_LEN`` in
#: ``repro/launch/shapes.py``), decoder prompt
#: tokens, greedy steps, the decoder cache's length; the fp32 chain's
#: frames, rows, prompt and tokens in all; training steps of (TRAIN_BATCH,
#: TRAIN_SEQ) tokens over as many frames
ENC_ROWS, ENC_LEN, DEC_PROMPT, ENC_STEPS, DEC_MAX_LEN = 8, 4096, 8, 64, 128
CHAIN_ENC_LEN, CHAIN_ROWS, CHAIN_PROMPT, CHAIN_TOTAL = 512, 2, 8, 16
ENC_TRAIN_STEPS = 3
#: qwen2-vl-72b's phase: the layers kept of its 80 (the full depth's 144 GB
#: of bf16 weights exceed the card), rows, the image grid's side, embedding
#: positions a row (576 patches, then text), decode steps, page size, the
#: cache's length (a multiple of the page size)
VL_LAYERS, VL_ROWS, VL_GRID, VL_LEN, VL_STEPS = 8, 8, 24, 1024, 32
VL_PAGE, VL_MAX_LEN = 64, 1088
#: the chains' limit against the full forward (phase 16) and the CPU
#: (smoke configs), times max |reference logit|: fp32 throughout, the
#: kernels and plain attention sum in other orders
CHAIN_REL_TOL = 1e-4
#: the smoke configs' card = CPU check: rows, positions (and encoder
#: frames) a row, cache length
SMOKE_ROWS, SMOKE_FRAMES, SMOKE_MAX_LEN = 4, 24, 40

def _vision_positions(rows, grid, length, device):
    """(rows, length, 3) M-RoPE positions: the image's grid x grid patches
    at (0, row, column), then text at (p, p, p) from p = grid on."""
    import torch
    n = grid * grid
    patch = torch.arange(n, device=device)
    image = torch.stack([torch.zeros_like(patch), patch // grid,
                         patch % grid], -1)
    p = grid + torch.arange(length - n, device=device)
    pos = torch.cat([image, torch.stack([p, p, p], -1)])
    return pos.expand(rows, length, 3).int().contiguous()


def _attn_layers(cfg) -> int:
    """Attention layers one prefill runs: the encoder's, the decoder's
    self-attention and, in an enc-dec model, its cross-attention."""
    return cfg.n_enc_layers + cfg.n_layers * (2 if cfg.is_encdec else 1)


def read_shape_counts() -> dict:
    """The kernels' launches since the last ``reset_counts()``, by
    (kernel, dtype, shape): both ops modules' ``SHAPE_LAUNCHES``."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.rglru import ops as rglru_ops
    return {**ops.SHAPE_LAUNCHES, **rglru_ops.SHAPE_LAUNCHES}


def _collect(launched: dict, label: str, cross=None,
             full_rows: bool = False) -> None:
    """Add the launches by shape since the last reset to ``launched``
    ({key: [count, set of the runs that launched it, whether every
    launch read every row at its full length]}).  ``cross`` is the run's
    (cross cache length, self cache length) in an enc-dec model: a decode
    key at the cross length read the cross cache, every row at its full
    length; the two lengths must differ, or the keys could not tell them
    apart.  ``full_rows``: every decode launch of the run read whole
    rows (phase 17's cells)."""
    if cross is not None and cross[0] == cross[1]:
        raise AssertionError(f"{label}: cross and self caches of one "
                             f"length {cross[0]}")
    for key, n in read_shape_counts().items():
        decode = key[0] in ("ragged_decode", "paged_decode")
        full = decode and (full_rows or (
            cross is not None and key[2][1] == cross[0]))
        entry = launched.setdefault(key, [0, set(), True])
        entry[0] += n
        entry[1].add(label)
        entry[2] = entry[2] and full


def _warm_up(prefill, *decodes) -> float:
    """Run ``prefill()`` once before the measured prefill, then each of
    ``decodes`` once on the (logits, cache) it made: the shapes' first
    calls (cuBLAS's choices, the allocator's first blocks, which the
    measured calls reuse) for the prefill and for one decode step per
    cache kind, so that no timed run pays them.  Drops what they made;
    -> the prefill's ms."""
    _sync()
    t0 = time.perf_counter()
    out = prefill()
    _sync()
    ms = (time.perf_counter() - t0) * 1e3
    for decode in decodes:
        decode(*out)
    _sync()
    return ms


def _serve_seamless(model, weights, card, bad, launched) -> dict:
    """Prefill of ENC_ROWS rows over ENC_LEN frames and DEC_PROMPT
    tokens, then ENC_STEPS greedy steps, bf16, timed after an untimed
    prefill and decode step (``_warm_up``): flash launched for every
    attention layer of the prefill, ragged decode for the decoder's
    self- and cross-attention at every step."""
    import torch
    cfg = model.cfg
    gen = torch.Generator(device="cuda").manual_seed(16)
    frames = _rand(gen, (ENC_ROWS, ENC_LEN, cfg.d_model), torch.bfloat16)
    tokens = torch.randint(1, cfg.vocab, (ENC_ROWS, DEC_PROMPT),
                           generator=gen, device="cuda")
    inputs = {"enc_embeds": frames, "tokens": tokens}
    cold_ms = _warm_up(
        lambda: model.prefill(weights, inputs, model.init_cache(
            ENC_ROWS, DEC_MAX_LEN, enc_len=ENC_LEN)),
        lambda logits, cache: model.decode_step(
            weights, cache, tokens=logits.argmax(-1).int()))
    live = fresh_peak()
    cache = model.init_cache(ENC_ROWS, DEC_MAX_LEN, enc_len=ENC_LEN)
    reset_counts()
    _sync()
    t0 = time.perf_counter()
    logits, cache = model.prefill(weights, inputs, cache)
    _sync()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    after_prefill = read_counts()
    toks = []
    t0 = time.perf_counter()
    for _ in range(ENC_STEPS):
        tok = logits.argmax(-1).int()
        toks.append(tok)
        logits, cache = model.decode_step(weights, cache, tokens=tok)
    _sync()
    decode_s = time.perf_counter() - t0
    counts = read_counts()
    _collect(launched, "seamless-m4t-large-v2 bf16",
             cross=(ENC_LEN, DEC_MAX_LEN))
    toks = torch.stack(toks)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    reserved = torch.cuda.max_memory_reserved() / 2 ** 30
    flash = _attn_layers(cfg)
    ragged = 2 * cfg.n_layers * ENC_STEPS
    tok_s = ENC_ROWS * ENC_STEPS / decode_s
    del cache
    log(f"seamless-m4t-large-v2 bf16 ({cfg.n_enc_layers} + {cfg.n_layers} "
        f"layers): prefill of {ENC_ROWS} rows over {ENC_LEN} frames and "
        f"{DEC_PROMPT} tokens {prefill_ms:.1f} ms (the shapes' first call "
        f"{cold_ms:.1f} ms; launches {after_prefill}, flash expected "
        f"{flash}); {ENC_STEPS} greedy steps, decode "
        f"{tok_s:.1f} tok/s ({decode_s * 1e3 / ENC_STEPS:.2f} ms a step; "
        f"launches {counts}, ragged expected {ragged}); "
        f"max_memory_allocated {peak:.2f} GiB, max_memory_reserved "
        f"{reserved:.2f} GiB ({live:.2f} GiB live before); on {card}")
    if after_prefill["flash_attention"] != flash or sum(
            after_prefill.values()) != flash:
        bad.append(f"seamless prefill launches {after_prefill}")
    if counts["ragged_decode"] != ragged or counts["paged_decode"] or \
            counts["flash_attention"] != flash:
        bad.append(f"seamless decode launches {counts}")
    if not (bool(torch.isfinite(logits).all()) and
            bool(((toks >= 0) & (toks < cfg.vocab)).all())):
        bad.append("seamless: non-finite logits or tokens out of range")
    return dict(prefill_ms=prefill_ms, cold_ms=cold_ms, tok_s=tok_s,
                peak=peak, reserved=reserved)


def _seamless_chain_fp32(cfg, params, card, bad, launched) -> None:
    """fp32, CHAIN_ROWS rows over CHAIN_ENC_LEN frames: a prefill of
    CHAIN_PROMPT tokens and decode steps over the rest of CHAIN_TOTAL
    (the kernels) give the logits of one full forward over all of them
    (mode "train": plain attention), within CHAIN_REL_TOL of its largest
    logit: the reference's ``test_decode_matches_forward``."""
    import torch
    from repro_torch.models import Model
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    model = Model(cfg32, "cuda")
    w32 = model.prepare_params(params)
    gen = torch.Generator(device="cuda").manual_seed(17)
    frames = _rand(gen, (CHAIN_ROWS, CHAIN_ENC_LEN, cfg.d_model),
                   torch.float32)
    tokens = torch.randint(1, cfg.vocab, (CHAIN_ROWS, CHAIN_TOTAL),
                           generator=gen, device="cuda")
    with torch.no_grad():
        h, _, _ = model.forward(w32, {"enc_embeds": frames, "tokens": tokens},
                                mode="train")
        full = model._logits(w32, h)
    reset_counts()
    cache = model.init_cache(CHAIN_ROWS, CHAIN_TOTAL + 2,
                             enc_len=CHAIN_ENC_LEN)
    logits, cache = model.prefill(
        w32, {"enc_embeds": frames, "tokens": tokens[:, :CHAIN_PROMPT]},
        cache)
    chain = [logits]
    for t in range(CHAIN_PROMPT, CHAIN_TOTAL - 1):
        logits, cache = model.decode_step(w32, cache, tokens=tokens[:, t])
        chain.append(logits)
    counts = read_counts()
    _collect(launched, "seamless-m4t-large-v2 fp32 chain",
             cross=(CHAIN_ENC_LEN, CHAIN_TOTAL + 2))
    expect = full[:, CHAIN_PROMPT - 1:CHAIN_TOTAL - 1]
    err = (torch.stack(chain, 1) - expect).abs().max().item()
    limit = CHAIN_REL_TOL * expect.abs().max().item()
    log(f"seamless-m4t-large-v2 fp32 chain ({CHAIN_ROWS} rows, "
        f"{CHAIN_ENC_LEN} frames, prefill {CHAIN_PROMPT} tokens, "
        f"{CHAIN_TOTAL - 1 - CHAIN_PROMPT} steps) vs one full forward: max "
        f"abs err {err:.3e} (limit {limit:.3e}); launches {counts}; on "
        f"{card}")
    if not err <= limit or counts["flash_attention"] != _attn_layers(cfg):
        bad.append(f"seamless fp32 chain: err {err} > {limit} or "
                   f"launches {counts}")


def _train_seamless(model, params, card, bad) -> dict:
    """ENC_TRAIN_STEPS steps of ``make_train_step`` (remat, AdamW) at
    (TRAIN_BATCH, TRAIN_SEQ) decoder tokens over as many frames, bf16
    compute, fp32 leaves: finite losses and grad norms, no kernel
    launch (training takes the plain attention)."""
    import torch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    cfg = model.cfg
    gen = torch.Generator(device="cuda").manual_seed(18)
    batch = {"enc_embeds": _rand(gen, (TRAIN_BATCH, TRAIN_SEQ, cfg.d_model),
                                 torch.bfloat16)}
    for key in ("tokens", "labels"):
        batch[key] = torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ),
                                   generator=gen, device="cuda")
    opt = AdamW(learning_rate=cosine_schedule(3e-4, 20, ENC_TRAIN_STEPS))
    state = opt.init(params)
    step = make_train_step(model, opt, remat=True)
    fresh_peak()
    reset_counts()
    losses, norms, step_ms = [], [], []
    for _ in range(ENC_TRAIN_STEPS):
        _sync()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts = read_counts()
    memory = _memory()
    del state
    log(f"seamless-m4t-large-v2 train ({ENC_TRAIN_STEPS} steps of "
        f"({TRAIN_BATCH}, {TRAIN_SEQ}) tokens over as many frames): losses "
        f"{losses}, grad norms {norms}; steps "
        + ", ".join(f"{x:.1f}" for x in step_ms) + f" ms; {memory}; "
        f"launches {counts}; on {card}")
    if not _finite(*losses, *norms) or sum(counts.values()):
        bad.append(f"seamless training: losses {losses}, launches {counts}")
    return dict(ms=min(step_ms[1:]), step_ms=step_ms, memory=memory)


def _pages_of(model, cache, gen):
    """A paged copy of the prefilled per-slot ``cache``: its rows split
    into pages of VL_PAGE scattered over one scrambled permutation of the
    pool, with the page table that maps them back."""
    import torch
    rows = cache["idx"].shape[0]
    max_pages = VL_MAX_LEN // VL_PAGE
    paged = model.init_cache(rows, VL_MAX_LEN, per_slot=True,
                             page_size=VL_PAGE, n_pages=rows * max_pages)
    perm = torch.randperm(rows * max_pages, generator=gen, device="cuda")
    for src, dst in zip(cache["stack"]["body"], paged["stack"]["body"]):
        for name in ("k", "v"):
            s = src["attn"][name]
            dst["attn"][name][:, perm] = s.reshape(
                s.shape[0], rows * max_pages, VL_PAGE, *s.shape[3:])
    paged["pt"] = perm.reshape(rows, max_pages).int()
    paged["idx"] = cache["idx"].clone()
    return paged


def _serve_qwen2_vl(card, bad, launched) -> dict:
    """qwen2-vl-72b at full width, cut to VL_LAYERS layers, bf16: a
    prefill of VL_ROWS rows of VL_LEN embedding positions (the image grid
    then text, M-RoPE), then VL_STEPS steps fed embeddings on the
    contiguous cache and on a paged copy of it, timed after an untimed
    prefill and one untimed step on each (``_warm_up``): every step's
    logits equal bit for bit, flash launched once a layer in the prefill,
    ragged (or paged) decode once a layer a step."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_config("qwen2-vl-72b"),
                              n_layers=VL_LAYERS)
    log(f"qwen2-vl-72b: full width, cut to {VL_LAYERS} of 80 layers")
    model = Model(cfg, "cuda")
    params = _family_weights(cfg, card)
    weights = model.prepare_params(params)
    del params
    _free_card()
    gen = torch.Generator(device="cuda").manual_seed(19)
    embeds = _rand(gen, (VL_ROWS, VL_LEN, cfg.d_model), torch.bfloat16)
    steps = _rand(gen, (VL_STEPS, VL_ROWS, cfg.d_model), torch.bfloat16)
    pos = _vision_positions(VL_ROWS, VL_GRID, VL_LEN, "cuda")
    inputs = {"embeds": embeds, "positions": pos}
    warm_gen = torch.Generator(device="cuda").manual_seed(21)
    cold_ms = _warm_up(
        lambda: model.prefill(weights, inputs, model.init_cache(
            VL_ROWS, VL_MAX_LEN, per_slot=True)),
        lambda _, cache: model.decode_step(
            weights, _pages_of(model, cache, warm_gen), embeds=steps[0]),
        lambda _, cache: model.decode_step(weights, cache, embeds=steps[0]))
    live = fresh_peak()
    cache = model.init_cache(VL_ROWS, VL_MAX_LEN, per_slot=True)
    reset_counts()
    _sync()
    t0 = time.perf_counter()
    _, cache = model.prefill(weights, inputs, cache)
    _sync()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_counts = read_counts()
    _collect(launched, "qwen2-vl-72b bf16 prefill")
    runs = {}
    for name, c in (("paged", _pages_of(model, cache, gen)),
                    ("contiguous", cache)):
        reset_counts()
        outs = []
        _sync()
        t0 = time.perf_counter()
        for e in steps:
            logits, c = model.decode_step(weights, c, embeds=e)
            outs.append(logits)
        _sync()
        decode_s = time.perf_counter() - t0
        runs[name] = dict(outs=outs, counts=read_counts(),
                          tok_s=VL_ROWS * VL_STEPS / decode_s)
        _collect(launched, f"qwen2-vl-72b bf16 {name}")
        del c
    del cache
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    reserved = torch.cuda.max_memory_reserved() / 2 ** 30
    diff = max((a - b).abs().max().item() for a, b in zip(
        runs["contiguous"]["outs"], runs["paged"]["outs"]))
    same = all(torch.equal(a, b) for a, b in zip(
        runs["contiguous"]["outs"], runs["paged"]["outs"]))
    finite = all(bool(torch.isfinite(x).all())
                 for x in runs["contiguous"]["outs"])
    expect = cfg.n_layers * VL_STEPS
    log(f"qwen2-vl-72b bf16 ({cfg.n_layers} layers, "
        f"{model.n_params() / 1e9:.2f}B parameters): prefill of {VL_ROWS} "
        f"rows of {VL_LEN} positions ({VL_GRID} x {VL_GRID} patches, then "
        f"text) {prefill_ms:.1f} ms (the shapes' first call {cold_ms:.1f} "
        f"ms; launches {prefill_counts}); "
        f"{VL_STEPS} steps fed embeddings: contiguous "
        f"{runs['contiguous']['tok_s']:.1f} tok/s (launches "
        f"{runs['contiguous']['counts']}), paged (pages of {VL_PAGE}) "
        f"{runs['paged']['tok_s']:.1f} tok/s (launches "
        f"{runs['paged']['counts']}); expected {expect} a run; logits "
        f"equal bit for bit {same} (max abs diff {diff:.3e}); "
        f"max_memory_allocated {peak:.2f} GiB, max_memory_reserved "
        f"{reserved:.2f} GiB ({live:.2f} GiB live before); on {card}")
    if prefill_counts["flash_attention"] != cfg.n_layers or \
            sum(prefill_counts.values()) != cfg.n_layers:
        bad.append(f"qwen2-vl prefill launches {prefill_counts}")
    if runs["contiguous"]["counts"] != dict(
            prefill_counts, flash_attention=0, ragged_decode=expect) or \
            runs["paged"]["counts"] != dict(
                prefill_counts, flash_attention=0, paged_decode=expect):
        bad.append(f"qwen2-vl decode launches "
                   f"{[r['counts'] for r in runs.values()]}")
    if not (same and finite):
        bad.append(f"qwen2-vl: contiguous and paged logits differ "
                   f"({diff}) or are not finite")
    del weights
    _free_card()
    return dict(prefill_ms=prefill_ms, cold_ms=cold_ms, peak=peak,
                reserved=reserved,
                tok_s={k: r["tok_s"] for k, r in runs.items()})


def _smoke_inputs(cfg, rows, length, gen):
    """A CPU batch of the smoke config's kind: ``length`` tokens, over
    ``enc_embeds`` of ``length`` frames (enc-dec), or ``embeds`` with a 4
    x 4 image grid's positions (embeddings input); and the decode steps'
    embeddings (embeddings input, else None)."""
    import torch
    if cfg.is_encdec:
        return {"enc_embeds": torch.randn((rows, length, cfg.d_model),
                                          generator=gen),
                "tokens": torch.randint(1, cfg.vocab, (rows, length),
                                        generator=gen)}, None
    if cfg.input_mode == "embeddings":
        grid = 4
        return ({"embeds": torch.randn((rows, length, cfg.d_model),
                                       generator=gen),
                 "positions": _vision_positions(rows, grid, length, "cpu")},
                torch.randn((8, rows, cfg.d_model), generator=gen))
    return {"tokens": torch.randint(1, cfg.vocab, (rows, length),
                                    generator=gen)}, None


def _encdec_embeds_smoke_card_vs_cpu(card, bad, launched) -> None:
    """Phase 7's check for the two smoke configs at fp32: a prefill of 4
    rows of 24 positions, then 8 decode steps (greedy tokens fed back, or
    the steps' embeddings), on the card (kernels) and on the CPU (plain
    versions): the same greedy tokens and logits within CHAIN_REL_TOL of
    the CPU's largest, flash launched once an attention layer per
    prefill and ragged decode once a decoder attention per step."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Model
    from repro_torch.models.params import tree_map
    for arch in ("seamless-m4t-large-v2", "qwen2-vl-72b"):
        cfg = dataclasses.replace(get_smoke_config(arch),
                                  compute_dtype="float32")
        params = Model(cfg, "cpu").init(torch.Generator().manual_seed(0))
        batch, steps = _smoke_inputs(cfg, SMOKE_ROWS, SMOKE_FRAMES,
                                     torch.Generator().manual_seed(2))
        out = {}
        for dev in ("cpu", "cuda"):
            model = Model(cfg, dev)
            w = tree_map(lambda t: t.to(dev), params, torch.is_tensor)
            reset_counts()
            logits, cache = model.prefill(
                w, {k: v.to(dev) for k, v in batch.items()},
                model.init_cache(SMOKE_ROWS, SMOKE_MAX_LEN,
                                 enc_len=SMOKE_FRAMES))
            chain, toks = [logits.cpu()], []
            for i in range(8):
                if steps is None:
                    tok = logits.argmax(-1).int()
                    toks.append(tok.cpu())
                    logits, cache = model.decode_step(w, cache, tokens=tok)
                else:
                    logits, cache = model.decode_step(
                        w, cache, embeds=steps[i].to(dev))
                    toks.append(logits.argmax(-1).cpu())
                chain.append(logits.cpu())
            out[dev] = (torch.stack(chain), torch.stack(toks),
                        read_counts())
        _collect(launched, f"{arch} smoke fp32",
                 cross=((SMOKE_FRAMES, SMOKE_MAX_LEN) if cfg.is_encdec
                        else None))
        (l_cpu, t_cpu, c_cpu), (l_card, t_card, c_card) = \
            out["cpu"], out["cuda"]
        err = (l_card - l_cpu).abs().max().item()
        limit = CHAIN_REL_TOL * l_cpu.abs().max().item()
        decoder_attn = cfg.n_layers * (2 if cfg.is_encdec else 1)
        expect = dict(c_cpu, flash_attention=_attn_layers(cfg),
                      ragged_decode=8 * decoder_attn)
        log(f"{arch} smoke fp32, prefill + 8 steps: card (launches "
            f"{c_card}) vs CPU (launches {c_cpu}): tokens equal "
            f"{torch.equal(t_card, t_cpu)}, max abs logit err {err:.3e} "
            f"(limit {limit:.3e}); on {card}")
        if not (torch.equal(t_card, t_cpu) and err <= limit) or \
                sum(c_cpu.values()) or c_card != expect:
            bad.append(f"{arch} smoke: card vs CPU")


#: caches per decode case and inputs per flash case of phase 16's shapes
#: (a decode case walks one cache per input, as a step walks its layers),
#: and the most bytes a decode case's caches may hold together (phase
#: 17's key, 2 GiB of K and V a cache, walks 8)
SHAPE_CASE_CACHES, SHAPE_CASE_INPUTS = 24, 4
SHAPE_CASE_BYTES = 16 * 2 ** 30


def _rglru_shape_case(gen, shape, dtype, launches, runs):
    """The RG-LRU scan at one launched (B, T, C) and dtype (a's, or
    "a's/x's"): SHAPE_CASE_INPUTS inputs from ``_rglru_inputs``, each
    against the plain version, then timed eagerly beside it."""
    import torch
    from repro_torch.kernels.rglru import ops, ref
    b, t, c = shape
    a_dt, x_dt = (getattr(torch, d) for d in (dtype.split("/") * 2)[:2])
    inputs = []
    for _ in range(SHAPE_CASE_INPUTS):
        a, x = _rglru_inputs(gen, b, t, c, torch.float32)
        inputs.append((a.to(a_dt), x.to(x_dt)))
    err, tol = 0.0, float("inf")
    for a, x in inputs:
        expect = ref.rglru_scan_ref(a, x)
        e = (ops.rglru_scan(a, x).float() - expect.float()).abs().max().item()
        err, tol = max(err, e), min(tol, rglru_tolerance(expect))
        if not e <= rglru_tolerance(expect):
            raise AssertionError(f"rglru_scan at {shape} {dtype}: err {e} "
                                 f"> {rglru_tolerance(expect)}")
    ms = _time_ms(lambda i: ops.rglru_scan(*inputs[i]), len(inputs))
    plain_ms = _time_ms(lambda i: ref.rglru_scan_ref(*inputs[i]),
                        len(inputs), iters=2)
    io_bytes = b * t * c * (a_dt.itemsize + 2 * x_dt.itemsize)
    t_bytes = io_bytes / MEM_BYTES_PER_S * 1e3
    t_ops = 2 * b * t * c / FP32_FLOPS_PER_S * 1e3
    case = dict(shape=f"B={b}, T={t}, C={c} {dtype} ({runs})",
                launches=launches, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None)
    log(f"rglru_scan at {case['shape']}: {ms * 1e3:.2f} us/call, bound "
        f"{case['bound_ms'] * 1e3:.3f} us ({case['bound_by']}), plain "
        f"{plain_ms * 1e3:.1f} us, max abs err {err:.3e} (tolerance "
        f"{tol:.3e} or more); launches {launches}; library: null")
    return case


def _shape_case(key, launches, runs, cross, gen):
    """The case of one (kernel, dtype, shape) key that phase 16's runs
    launched ``launches`` times: the kernel at that signature against its
    plain version, timed beside it and SDPA (``_flash_case``,
    ``_decode_case``).  A decode key that only ever read a cross cache
    (``cross``, from ``_collect``) runs every row at its full length;
    any other runs its rows at lengths spread over the capacity, the
    last row full.  Every launch the case makes must be at ``key``
    itself.  -> case dict."""
    name, dtype, shape = key
    reset_counts()
    if name == "rglru_scan":
        case = _rglru_shape_case(gen, shape, dtype, launches, runs)
    elif name == "flash_attention":
        b, sq, sk, hq, hkv, dh, causal, window, softcap = shape
        if softcap:
            raise AssertionError(f"no case for softcap {softcap}: {key}")
        case = _flash_case(gen, runs, b, sq, hq, hkv, dh, window, launches,
                           n_inputs=SHAPE_CASE_INPUTS, causal=causal,
                           sk=sk, dtype=dtype)
    else:
        b, capacity, hkv, g, dh, ps, softcap = shape
        if softcap:
            raise AssertionError(f"no case for softcap {softcap}: {key}")
        cur = ([capacity - 1] * b if cross else
               [capacity * (r + 1) // b - 1 for r in range(b)])
        label = (f"B={b}, Smax={capacity}, Hkv={hkv}, G={g}, dh={dh}"
                 f"{f', pages of {ps}' if ps else ''} {dtype} ({runs})")
        per_cache = 2 * b * capacity * hkv * dh * (
            4 if dtype == "float32" else 2)
        n_caches = min(SHAPE_CASE_CACHES,
                       max(2, SHAPE_CASE_BYTES // per_cache))
        case = _decode_case(label, capacity, cur, {name: launches},
                            n_layers=n_caches, heads=(hkv, g, dh),
                            names=(name,), dtype=dtype, ps=ps or 64)[name]
    ran = read_shape_counts()
    if set(ran) != {key}:
        raise AssertionError(f"the case of {key} launched {ran}")
    return dict(case, key=[name, dtype, list(shape)])


def serve_encdec_embeds(card: str, earlier=None) -> dict:
    """Phase 16: seamless-m4t-large-v2 at full width and depth (serve,
    the fp32 chain, train), qwen2-vl-72b at full width cut to VL_LAYERS
    layers (contiguous and paged), the smoke configs card = CPU; then one
    case per (kernel, dtype, shape) key those runs and the ``earlier``
    phases' (``_collect``'s dict: phase 18's examples and phase 19's
    legacy surface) launched, each
    checked against its plain version and timed beside SDPA, its
    ``launches`` the key's count.  -> the runs' numbers and the cases for
    phase 12's line."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    bad = []
    launched = {key: [n, set(runs), full]
                for key, (n, runs, full) in (earlier or {}).items()}
    _free_card()
    cfg = get_config("seamless-m4t-large-v2")
    model = Model(cfg, "cuda")
    params = _family_weights(cfg, card)
    weights = model.prepare_params(params)
    seamless = _serve_seamless(model, weights, card, bad, launched)
    del weights
    _free_card()
    _seamless_chain_fp32(cfg, params, card, bad, launched)
    _free_card()
    seamless["train"] = _train_seamless(model, params, card, bad)
    del params
    _free_card()
    vl = _serve_qwen2_vl(card, bad, launched)
    _encdec_embeds_smoke_card_vs_cpu(card, bad, launched)
    if bad:
        raise AssertionError("; ".join(bad))
    gen = torch.Generator(device="cuda").manual_seed(20)
    cases, missing = [], []
    for key in sorted(launched, key=repr):
        n, runs, cross = launched[key]
        try:
            cases.append((key[0], _shape_case(
                key, n, ", ".join(sorted(runs)), cross, gen)))
        except Exception:
            traceback.print_exc()
            missing.append(key)
        _free_card()
    n_bf16 = sum(k[1] == "bfloat16" for k in launched)
    log(f"phases 16, 18 and 19 launched {len(launched)} (kernel, dtype, "
        f"shape) keys ({n_bf16} bf16, {len(launched) - n_bf16} fp32); held "
        f"against their plain versions: {len(cases)}; without a passing "
        f"case: {missing}")
    if missing:
        raise AssertionError(f"keys launched without a passing case: "
                             f"{missing}")
    return {"seamless": seamless, "qwen2-vl": vl, "cases": cases}


# ----- phase 18 --------------------------------------------------------------

#: the six examples (``examples/<name>_torch.py``), each run through its
#: ``main`` at its own defaults
EXAMPLES = ("quickstart", "serve_batched", "serve_fleet", "serve_adaptive",
            "train_endpoint_categories", "stencil_endpoints")
#: the stencil's limit against the plain single-tensor stencil, times
#: max(1, max |plain|): fp32, the same sums in the same order
STENCIL_REL_TOL = 1e-5
#: the full-width (smollm-360m) runs of quickstart's body (steps, with a
#: checkpoint at the last: 4.3 GB each) and of the categories' ddp body
#: (steps a category): the defaults' 60 and 20 took 75 s each on a slow
#: host, most of it in checkpoints
FULL_QUICK_STEPS, FULL_DDP_STEPS = 20, 5


def _example(name: str):
    """``examples/<name>_torch.py`` loaded as a module."""
    import importlib.util
    path = ROOT / "examples" / f"{name}_torch.py"
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _plain_stencil(grid, steps: int):
    """The periodic 5-point stencil on one tensor, rolled on both axes."""
    for _ in range(steps):
        lap = (grid.roll(1, 0) + grid.roll(-1, 0) + grid.roll(1, 1)
               + grid.roll(-1, 1) - 4 * grid)
        grid = grid + 0.1 * lap
    return grid


def _k1_step_ms(cfg, params, rows: int = 4, max_len: int = 160,
                prompt: int = 16, steps: int = 20) -> float:
    """The median ms of ``Model.decode_step`` alone, eagerly over a
    per-slot cache of ``rows`` slots, then the argmax read by the host
    (one sync a step), after one untimed step: the call that
    ``ContinuousEngine.step`` makes at K = 1, timed outside the engine
    (no admission, no slot bookkeeping)."""
    import statistics
    import torch
    from repro_torch.models import Model
    model = Model(cfg, "cuda")
    weights = model.prepare_params(params)
    gen = torch.Generator(device="cuda").manual_seed(29)
    toks = torch.randint(1, cfg.vocab, (rows, prompt), generator=gen,
                         device="cuda", dtype=torch.int32)
    cache = model.init_cache(rows, max_len, per_slot=True)
    logits, cache = model.prefill(weights, {"tokens": toks}, cache)
    tok = logits.argmax(-1).int()
    times = []
    for _ in range(steps + 1):
        _sync()
        t0 = time.perf_counter()
        logits, cache = model.decode_step(weights, cache, tokens=tok)
        tok = logits.argmax(-1).int()
        tok.cpu()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[1:])


def _rates(rows: dict) -> str:
    """serve_batched's rows as "name tok/s" pairs."""
    return ", ".join(f"{name} {r['total'] / r['seconds']:.1f}"
                     for name, r in rows.items())


def _train_step_ms(cfg, steps: int = 10) -> float:
    """The median ms of a train step at quickstart's shape ((8, 64) tokens
    a step, its learning rate and warm-up; ``make_train_step`` on seed 0,
    the first two steps left out), with no checkpoint."""
    import statistics
    import torch
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    model = Model(cfg, "cuda")
    opt = AdamW(learning_rate=cosine_schedule(2e-3, 10, steps))
    data = SyntheticLMData(vocab=cfg.vocab, seq_len=64, global_batch=8)
    step = make_train_step(model, opt, remat=True)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    state, times = opt.init(params), []
    for i in range(steps):
        batch = {k: torch.from_numpy(v).cuda()
                 for k, v in data.batch_at(i).items()}
        _sync()
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, batch)
        float(metrics["loss"])
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[2:])


def run_examples(card: str) -> dict:
    """Phase 18 (after 15, before 16, whose per-key check takes its
    keys): each example's ``main`` at its defaults on the card, then
    serve_batched's body at fp32 on the smoke config (the three presets'
    tokens must equal the wave's), at qwen2-0.5b's full width (bf16) and
    with ``--arch recurrentgemma-2b`` (the RG-LRU kernel), and
    quickstart's and train_endpoint_categories' bodies at smollm-360m's
    full width (FULL_QUICK_STEPS steps; FULL_DDP_STEPS a category);
    besides, a K = 1 decode step of qwen2-0.5b and a train step of
    smollm-360m timed alone.  Gates: no script raises; the categories'
    losses bit for bit equal; the stencil = ``_plain_stencil`` on the card within
    STENCIL_REL_TOL, with 2 halo messages per rank and step; each of
    ragged_decode, flash_attention and rglru_scan launched.  Each run's
    counts start at 0 and are read after it.  -> {"launched": keys by
    ``_collect``, "launches": the runs' summed counts, "seconds": each
    run's wall, and the rates}."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch.train import join_group
    from repro_torch.models import Model
    if dist.is_initialized():
        # the scripts join their own group (phase 15 destroys its one)
        dist.destroy_process_group()
    ex = {name: _example(name) for name in EXAMPLES}
    launched, launches, seconds, bad = {}, {}, {}, []

    def run(label, fn, *args):
        _free_card()
        reset_counts()
        _sync()
        t0 = time.perf_counter()
        out = fn(*args)
        _sync()
        seconds[label] = time.perf_counter() - t0
        _collect(launched, label)
        for name, n in read_counts().items():
            launches[name] = launches.get(name, 0) + n
        log(f"example {label}: {seconds[label]:.2f} s wall, launches "
            f"{read_counts()}; on {card}")
        return out

    out = {name: run(f"{name} (defaults)", ex[name].main, [])
           for name in EXAMPLES}
    if len(set(out["train_endpoint_categories"].values())) != 1:
        bad.append(f"categories' losses differ: "
                   f"{out['train_endpoint_categories']}")
    sten = out["stencil_endpoints"]
    plain = _plain_stencil(ex["stencil_endpoints"].initial_grid().cuda(),
                           ex["stencil_endpoints"].STEPS)
    sten_err = (sten["grid"] - plain).abs().max().item()
    sten_tol = STENCIL_REL_TOL * max(1.0, plain.abs().max().item())
    log(f"stencil on {sten['ranks']} rank(s): max abs err vs the plain "
        f"stencil on the card {sten_err:.3e} (limit {sten_tol:.3e}), "
        f"{sten['messages_per_step']} halo messages per rank and step")
    if not sten_err <= sten_tol or sten["messages_per_step"] != 2:
        bad.append(f"stencil: err {sten_err} (limit {sten_tol}), "
                   f"{sten['messages_per_step']} messages a step")

    batched = ex["serve_batched"]
    cfg32 = dataclasses.replace(get_smoke_config("qwen2-0.5b"),
                                compute_dtype="float32")
    fp32 = run("serve_batched qwen2-0.5b smoke fp32", batched.run, cfg32,
               "cuda")
    differ = {p: len(r["tokens"]) - r["agree"] for p, r in fp32.items()
              if p != "wave" and r["agree"] != len(r["tokens"])}
    if differ:
        bad.append(f"serve_batched fp32: presets differ from the wave "
                   f"(requests): {differ}")
    # the body's own weights (seed 0 on the CPU), drawn here so that the
    # K = 1 step can be timed on them too
    qwen2 = get_config("qwen2-0.5b")
    params = Model(qwen2, "cuda").init(torch.Generator().manual_seed(0))
    full = run("serve_batched qwen2-0.5b full width bf16", batched.run,
               qwen2, "cuda", 12, 4, params)
    step_ms = _k1_step_ms(qwen2, params)
    del params
    rg = run("serve_batched --arch recurrentgemma-2b", batched.main,
             ["--arch", "recurrentgemma-2b"])
    smollm = get_config("smollm-360m")
    quick = run("quickstart smollm-360m full width", ex["quickstart"].run,
                smollm, "cuda", FULL_QUICK_STEPS, FULL_QUICK_STEPS)
    if not (_finite(*quick["losses"]) and len(quick["tokens"]) == 8):
        bad.append(f"quickstart at full width: losses {quick['losses']}, "
                   f"tokens {quick['tokens']}")
    quick_ms = _train_step_ms(smollm)
    join_group("cuda")
    try:
        cats = run("train_endpoint_categories smollm-360m full width",
                   ex["train_endpoint_categories"].run, smollm, "cuda",
                   FULL_DDP_STEPS)
    finally:
        dist.destroy_process_group()
    if len(set(cats.values())) != 1:
        bad.append(f"categories' losses differ at full width: {cats}")
    missing = [k for k in ("ragged_decode", "flash_attention", "rglru_scan")
               if not launches.get(k)]
    if missing:
        bad.append(f"not launched by the examples: {missing}")
    log(f"phase 18: serve_batched tok/s (4 slots, K = 1, "
        f"{len(full['wave']['tokens'])} requests): smoke bf16 "
        f"{_rates(out['serve_batched'])}; smoke fp32 {_rates(fp32)}; "
        f"qwen2-0.5b full width bf16 {_rates(full)}, {step_ms:.2f} ms a "
        f"K = 1 decode step (4 slots, Model.decode_step alone, outside "
        f"the engine, + the host's argmax); "
        f"recurrentgemma-2b smoke {_rates(rg)}; smollm-360m full width: "
        f"quickstart {quick['train_seconds']:.2f} s for "
        f"{FULL_QUICK_STEPS} steps (2 checkpoints included), loss "
        f"{quick['losses'][0]:.4f} -> {quick['losses'][-1]:.4f}, "
        f"{quick_ms:.1f} ms a train step; categories' final losses {cats}; "
        f"launches {launches}; {len(launched)} keys; on {card}")
    if bad:
        raise AssertionError("; ".join(bad))
    return dict(launched=launched, launches=launches, seconds=seconds,
                full=full, step_ms=step_ms, quick_ms=quick_ms)


# ----- phase 19 --------------------------------------------------------------

#: the deprecated launch: the --category spelling of a diagonal fleet
LEGACY_FLEET = ("--category", "shared_dynamic", "--workers", "4",
                "--engine", "continuous")
#: the legacy engine's keywords (the reference launcher's defaults), and
#: the slot level of its category (STATIC)
LEGACY_SLOTS, LEGACY_MAX_LEN = 4, 256


def _launch(argv) -> tuple:
    """``repro_torch.launch.serve.main(argv)`` on the card, its stdout
    captured (then logged); -> (stdout, DeprecationWarnings raised)."""
    import contextlib
    import io
    import warnings
    from repro_torch.launch import serve as launcher
    buf = io.StringIO()
    with warnings.catch_warnings(record=True) as rec, \
            contextlib.redirect_stdout(buf):
        warnings.simplefilter("always")
        launcher.main(list(argv))
    out = buf.getvalue()
    for line in out.splitlines():
        log(f"  | {line}")
    return out, [str(w.message) for w in rec
                 if issubclass(w.category, DeprecationWarning)]


def _legacy_engines(card, bad, launched, launches) -> dict:
    """The legacy ``ContinuousEngine(cfg, w, n_slots=4, max_len=256,
    category=Category.STATIC)`` (one DeprecationWarning) against the
    engine built from its new spelling, ``EndpointPlan.from_preset(
    "static")``, on the same full-width weights (seed 0) and the
    launcher's prompts at mixed lengths: equal tokens, every one."""
    import argparse
    import warnings
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.endpoints import Category
    from repro_torch.core.plan import EndpointPlan
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models import Model
    from repro_torch.serve.engine import ContinuousEngine, Request
    cfg = get_config("qwen2-0.5b")
    params = Model(cfg, "cuda").init(torch.Generator().manual_seed(0))
    prompts = make_prompts(cfg, argparse.Namespace(
        seed=0, requests=8, prompt_len=16, mixed_lengths=True))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        legacy = ContinuousEngine(cfg, params, n_slots=LEGACY_SLOTS,
                                  max_len=LEGACY_MAX_LEN,
                                  category=Category.STATIC)
    deps = [w for w in rec if issubclass(w.category, DeprecationWarning)]
    planned = ContinuousEngine(cfg, params, EndpointPlan.from_preset(
        "static", n_slots=LEGACY_SLOTS, max_len=LEGACY_MAX_LEN,
        executor="continuous"), device="cuda")
    outs, seconds = {}, {}
    for label, eng in (("legacy", legacy), ("plan", planned)):
        for rid, prompt in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=12))
        reset_counts()
        _sync()
        t0 = time.perf_counter()
        outs[label] = {r.rid: list(r.output) for r in eng.run()}
        _sync()
        seconds[label] = time.perf_counter() - t0
        _collect(launched, f"legacy engine ({label})")
        for name, n in read_counts().items():
            launches[name] = launches.get(name, 0) + n
        log(f"ContinuousEngine {label}: pool level {eng.pool.level}, "
            f"{seconds[label]:.2f} s, launches {read_counts()}; on {card}")
    differ = [rid for rid in outs["plan"]
              if outs["legacy"].get(rid) != outs["plan"][rid]]
    log(f"legacy ContinuousEngine(category=STATIC) vs "
        f"EndpointPlan.from_preset('static'): {len(deps)} "
        f"DeprecationWarning, {len(outs['legacy'])} requests, "
        f"{sum(map(len, outs['legacy'].values()))} tokens, requests that "
        f"differ {differ}")
    if len(deps) != 1:
        bad.append(f"legacy engine: {len(deps)} DeprecationWarnings")
    if differ or len(outs["legacy"]) != len(prompts) \
            or any(len(t) != 12 for t in outs["legacy"].values()):
        bad.append(f"legacy engine vs plan-built engine: requests {differ} "
                   f"differ")
    if legacy.plan.vector.slots != 3 or legacy.pool.level != 3:
        bad.append(f"legacy engine's slot level {legacy.pool.level}")
    return seconds


def serve_legacy(card: str) -> dict:
    """Phase 19 (after 18, before 16, whose per-key check takes its
    keys): the reference's legacy serving surface at qwen2-0.5b's full
    width in bf16.  The bare launcher (``main([])``: 8 requests of 16
    tokens, 12 new, 4 slots, max_len 256) must serve through the wave
    executor with no DeprecationWarning, every request its 12 tokens,
    flash launched layers x waves and ragged decode layers x waves x 12;
    the deprecated fleet launch (LEGACY_FLEET) must warn exactly once and
    serve every request through the fleet, both attention kernels
    launched; then ``_legacy_engines``.  Each run's counts start at 0
    (the launcher resets them before its run) and are read after it.
    -> {"launched": keys by ``_collect``, "launches": the runs' summed
    counts, "seconds", "tok_s": the bare run's}."""
    import re
    from repro_torch.configs import get_config
    launched, launches, seconds, bad = {}, {}, {}, []
    layers = get_config("qwen2-0.5b").n_layers

    def run(label, argv):
        _free_card()
        reset_counts()
        t0 = time.perf_counter()
        out, deps = _launch(argv)
        seconds[label] = time.perf_counter() - t0
        _collect(launched, label)
        for name, n in read_counts().items():
            launches[name] = launches.get(name, 0) + n
        log(f"launch {label}: {seconds[label]:.2f} s wall (weights "
            f"included), {len(deps)} DeprecationWarning, launches "
            f"{read_counts()}; on {card}")
        return out, deps, read_counts()

    out, deps, counts = run("bare", [])
    rate = re.search(r"served 8 requests, 96 tokens in [0-9.]+s "
                     r"\(([0-9.]+) tok/s", out)
    want = {"flash_attention": layers * 2, "ragged_decode": layers * 2 * 12}
    if "executor=wave" not in out or rate is None or deps \
            or any(counts[k] != n for k, n in want.items()):
        bad.append(f"bare launch: wave {'executor=wave' in out}, "
                   f"served {rate is not None}, {len(deps)} warnings, "
                   f"launches {counts} (expected {want})")
    out, deps, counts = run("--category fleet", LEGACY_FLEET)
    if len(deps) != 1 or "executor=fleet" not in out \
            or "8/8 requests" not in out or "preset=shared_dynamic" \
            not in out or not counts["flash_attention"] \
            or not counts["ragged_decode"]:
        bad.append(f"--category fleet: {len(deps)} warnings, launches "
                   f"{counts}")
    _free_card()
    engines = _legacy_engines(card, bad, launched, launches)
    seconds.update({f"engine {k}": v for k, v in engines.items()})
    if bad:
        raise AssertionError("; ".join(bad))
    return dict(launched=launched, launches=launches, seconds=seconds,
                tok_s=float(rate.group(1)))


# ----- phase 17 --------------------------------------------------------------

#: the dry run's sweep: a subprocess (its fake process group cannot
#: share a process with NCCL) with a worker on every core, run alone at
#: phase 17's start.  Its records and log, the records it must hold (10
#: archs x 4 cells x 2 meshes; long_500k applies to the two
#: sub-quadratic archs), the seconds it may take
DRYRUN_DIR = ROOT / "build" / "dryrun"
DRYRUN_LOG = ROOT / "build" / "dryrun.log"
DRYRUN_OK, DRYRUN_SKIPPED = 64, 16
DRYRUN_TIMEOUT_S = 480
#: timed decode steps of each cell stepped on the card (after one
#: untimed step)
CELL_STEPS = 8


def run_dryrun():
    """Run the sweep to its end (or DRYRUN_TIMEOUT_S); -> (exit code,
    seconds waited).  The process leads its own session, which is ended
    afterwards, so that no worker outlives it."""
    import shutil
    import signal
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    DRYRUN_DIR.parent.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    t0 = time.perf_counter()
    with open(DRYRUN_LOG, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
             "--mesh", "both", "--jobs", "0", "--out", str(DRYRUN_DIR)],
            cwd=ROOT, env=env, stdout=out, stderr=subprocess.STDOUT,
            start_new_session=True)
    try:
        proc.wait(timeout=DRYRUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        raise AssertionError(f"the dry run had not ended after "
                             f"{DRYRUN_TIMEOUT_S} s (log: {DRYRUN_LOG})")
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
    return proc.returncode, time.perf_counter() - t0


def dryrun_sweep() -> dict:
    """Phase 17's first part: run the sweep (``run_dryrun``), gate its
    counts, print its seconds, the slowest cells, the roofline table with
    the H100's constants and ``auto_accum`` of each train cell.  -> the
    summary."""
    from repro_torch.launch import roofline
    code, waited = run_dryrun()
    with open(DRYRUN_DIR / "summary.json") as f:
        summary = json.load(f)
    s, cells = summary["summary"], summary["cells"]
    log(f"dry run: {s['ok']} ok, {s['skipped']} skipped, {s['failed']} "
        f"failed of {s['total']} (arch x cell x mesh), {s['seconds']} s on "
        f"{s['jobs']} worker processes, alone; {waited:.1f} s with the "
        f"process's start")
    slow = sorted((c for c in cells if "seconds" in c),
                  key=lambda c: -c["seconds"])
    log("dry run, where the time went (s a cell, slowest first): " + ", ".join(
        f"{c['arch']}|{c['shape']}|{c['mesh_name']} {c['seconds']}"
        for c in slow[:10]) + f"; the other {len(slow) - 10} cells "
        f"{sum(c['seconds'] for c in slow[10:]):.1f} s together")
    for c in cells:
        if c.get("status") == "failed":
            log(f"dry run FAILED {c['arch']}|{c['shape']}|"
                f"{c['mesh_name']}: {c['error']}\n{c.get('traceback', '')}")
    log(f"roofline (H100: {roofline.PEAK_FLOPS:.3e} bf16 FLOP/s, "
        f"{roofline.HBM_BW:.3e} B/s HBM, {roofline.LINK_BW:.3e} B/s "
        f"NVLink a direction, {roofline.HBM_BYTES} B a card):")
    for mesh in ("single", "multi"):
        log(f"mesh {mesh}:\n" + roofline.markdown_table(
            roofline.load_rows(str(DRYRUN_DIR), mesh)))
    log("auto_accum of the train cells: " + ", ".join(
        f"{c['arch']}|{c['mesh_name']} {c['accum_steps']}"
        for c in cells if c.get("kind") == "train"))
    if (s["ok"], s["skipped"], s["failed"]) != (DRYRUN_OK, DRYRUN_SKIPPED,
                                                0) or code:
        raise AssertionError(f"dry run: {s} (exit {code}); expected "
                             f"{DRYRUN_OK} ok, {DRYRUN_SKIPPED} skipped, "
                             f"none failed")
    return s


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _dtypes(tree) -> str:
    return "/".join(sorted({str(t.dtype).removeprefix("torch.")
                            for t in _leaves(tree)}))


def _cell_steps(step, params, cache, inputs):
    """One untimed step, then CELL_STEPS timed ones, each ending in a
    sync, all on the same cache dict (its ``idx`` stays where it was
    set: each step is the cell's).  -> (median ms, last logits)."""
    import statistics
    logits, _ = step(params, cache, inputs)
    _sync()
    times = []
    for _ in range(CELL_STEPS):
        t = time.perf_counter()
        logits, _ = step(params, cache, inputs)
        _sync()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times), logits


def _cell_setup(arch, shape, mesh):
    """The cell's record on the one-card mesh (``lower_cell`` with
    ``params_bf16``), and the cell on the card as
    ``trace_serve.cell_setup`` sets it up over ``mesh``: its model,
    weights from seed 0 in the record's dtypes, its decode step, the
    cache of the cell's shape filled from a generator with ``idx`` at its
    last position, and its tokens."""
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.launch.shapes import SHAPES
    from repro_torch.launch.trace_serve import cell_setup
    rec = lower_cell(arch, shape, mesh, params_bf16=True)
    t0 = time.perf_counter()
    model, params, step, cache, tokens = cell_setup(arch, shape, mesh)
    _free_card()
    log(f"{arch}: {model.n_params() / 1e6:.1f}M params, {model.cfg.n_layers} "
        f"layers, weights and cache drawn on the card in "
        f"{time.perf_counter() - t0:.1f}s; the step's make_shard_fn is an "
        f"identity here (plain tensors, not DTensors)")
    return model.cfg, SHAPES[shape], rec, params, step, cache, tokens


def _decode_32k(mesh, card, bad, launched) -> dict:
    """qwen2-0.5b's decode_32k at the cell's shape: 128 rows over 32768
    keys, every row whole, 24 ragged launches a step."""
    import torch
    from repro_torch.launch.roofline import (HBM_BW, analyze_record,
                                             read_bytes)
    cfg, cell, rec, params, step, cache, tokens = _cell_setup(
        "qwen2-0.5b", "decode_32k", mesh)
    handed = _bytes(params) + _bytes(cache) + _bytes(tokens)
    args = rec["memory"]["argument_bytes"]
    log(f"qwen2-0.5b decode_32k: the step is handed {handed} B (params "
        f"{_bytes(params)} B {_dtypes(params)}, cache {_bytes(cache)} B "
        f"{_dtypes(cache)}, tokens {_bytes(tokens)} B int32); the dry run's "
        f"argument_bytes on the one-card mesh {args} B: equal "
        f"{handed == args}")
    if handed != args:
        bad.append(f"decode_32k: argument bytes {handed} on the card, "
                   f"{args} in the dry run")
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    ms, logits = _cell_steps(step, params, cache, tokens)
    counts = read_counts()
    _collect(launched, "qwen2-0.5b decode_32k", full_rows=True)
    finite = bool(torch.isfinite(logits).all())
    want = dict.fromkeys(counts, 0)
    want["ragged_decode"] = cfg.n_layers * (CELL_STEPS + 1)
    row = analyze_record(dict(rec, status="ok", mesh_name="one card"))
    read_ms = read_bytes(rec) / HBM_BW * 1e3
    out = dict(ms=ms, tok_s=cell.batch / ms * 1e3, compute_ms=row.compute_s
               * 1e3, memory_ms=row.memory_s * 1e3, read_ms=read_ms,
               memory=_memory(), launches=counts)
    log(f"qwen2-0.5b decode_32k (B {cell.batch}, {cell.seq} keys a row, "
        f"bf16): {ms:.3f} ms a step (median of {CELL_STEPS}), "
        f"{out['tok_s']:.1f} tok/s; roofline on one card: compute "
        f"{out['compute_ms']:.3f} ms, memory {out['memory_ms']:.3f} ms "
        f"(arguments + outputs, the donated cache counted twice), read-only "
        f"bound {read_ms:.3f} ms ({args / 1e9:.2f} GB at {HBM_BW:.3e} B/s); "
        f"{out['memory']}; logits finite {finite}; launches {counts}; on "
        f"{card}")
    if not finite or counts != want:
        bad.append(f"decode_32k: finite {finite}, launches {counts}, "
                   f"expected {want}")
    return out


def _long_500k(mesh, card, bad) -> dict:
    """recurrentgemma-2b's long_500k: one row at position 524287 of
    rolling window caches; no kernel launch (rolling local attention
    takes plain decode attention, as the reference's does)."""
    import torch
    from repro_torch.launch.roofline import HBM_BW, analyze_record
    cfg, cell, rec, params, step, cache, tokens = _cell_setup(
        "recurrentgemma-2b", "long_500k", mesh)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    ms, logits = _cell_steps(step, params, cache, tokens)
    counts = read_counts()
    finite = bool(torch.isfinite(logits).all())
    row = analyze_record(dict(rec, status="ok", mesh_name="one card"))
    weights = _bytes(params)
    out = dict(ms=ms, compute_ms=row.compute_s * 1e3,
               memory_ms=row.memory_s * 1e3,
               weight_ms=weights / HBM_BW * 1e3, memory=_memory(),
               cache_bytes=_bytes(cache), launches=counts)
    log(f"recurrentgemma-2b long_500k (B 1 at position {cell.seq - 1}, "
        f"cache {out['cache_bytes'] / 2 ** 20:.1f} MiB, weights "
        f"{_dtypes(params)}): {ms:.3f} ms a step (median of {CELL_STEPS}); "
        f"roofline on one card: compute {out['compute_ms']:.4f} ms, memory "
        f"{out['memory_ms']:.3f} ms, weight-read bound "
        f"{out['weight_ms']:.3f} ms ({weights / 1e9:.2f} GB); "
        f"{out['memory']}; logits finite {finite}; launches {counts}; on "
        f"{card}")
    if not finite or any(counts.values()):
        bad.append(f"long_500k: finite {finite}, launches {counts}")
    return out


def serve_cells(card: str) -> dict:
    """Phase 17: the dry run's sweep (``dryrun_sweep``), then two cells
    stepped at their full shape on the card over a (1, 1) ("data",
    "model") mesh of a one-process NCCL group, each step built by
    ``make_decode_step`` with ``make_shard_fn`` installed (an identity on
    these plain tensors): qwen2-0.5b
    ``decode_32k`` and recurrentgemma-2b ``long_500k``; then a case for
    each (kernel, dtype, shape) key they launched, held against its plain
    version (phase 16's mechanism).  -> numbers and cases."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    summary = dryrun_sweep()
    _free_card()
    props = torch.cuda.get_device_properties(0)
    from repro_torch.launch.roofline import HBM_BYTES
    log(f"the card's total_memory {props.total_memory} B; the roofline's "
        f"HBM_BYTES {HBM_BYTES} B: equal {props.total_memory == HBM_BYTES}")
    bad, launched = [], {}
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=_local_store(), world_size=1,
                            rank=0)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cuda")
        decode = _decode_32k(mesh, card, bad, launched)
        _free_card()
        long = _long_500k(mesh, card, bad)
        _free_card()
    finally:
        dist.destroy_process_group()
    if bad:
        raise AssertionError("; ".join(bad))
    gen = torch.Generator(device="cuda").manual_seed(21)
    cases = []
    for key in sorted(launched, key=repr):
        n, runs, full = launched[key]
        cases.append((key[0], _shape_case(key, n, ", ".join(sorted(runs)),
                                          full, gen)))
        _free_card()
    log(f"phase 17 launched {len(launched)} (kernel, dtype, shape) keys, "
        f"each held against its plain version: "
        f"{[c['key'] for _, c in cases]}")
    return {"dryrun": summary, "decode_32k": decode, "long_500k": long,
            "cases": cases}


def main() -> int:
    started = time.perf_counter()
    # the deterministic phases' cuBLAS needs this before the first CUDA call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    long = rates = admission = None
    served = phase("serve qwen2-0.5b at full width", serve_full_width, card)
    if served is not None:
        phase("horizon cut vs uncut", horizon_cap, *served[2:], served[1],
              card)
        long = phase("serve qwen2-0.5b long prompts at full width",
                     serve_long_prompts, *served[2:], card)
        rates = phase("fused horizon: graph vs eager", graph_vs_eager,
                      *served[1:], card)
        admission = phase("bucketed admission: graphs vs eager body",
                          admission_vs_eager, *served, card)
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
    family = phase("the MoE and xLSTM families at full width: "
                   "granite-moe-1b-a400m, deepseek-moe-16b (4 layers), "
                   "xlstm-1.3b", serve_moe_xlstm, card)
    scan_grad = phase("rglru_scan gradients vs plain version",
                      check_scan_grad, card)
    trained = phase("train qwen2-0.5b at full width: 20 steps, resume "
                    "after a failure", train_qwen2, card)
    ddp = phase("train qwen2-0.5b in ddp mode: six categories, int8",
                ddp_qwen2, card)
    rg_trained = phase("train recurrentgemma-2b at full width",
                       train_recurrentgemma, card)
    phase("smoke configs' train step at fp32: card vs CPU",
          train_smoke_card_vs_cpu, card)
    examples = phase("the six examples through the port (phase 18)",
                     run_examples, card)
    legacy = phase("the legacy serving surface at full width: the bare "
                   "launcher, --category, ContinuousEngine(category=) "
                   "(phase 19)", serve_legacy, card)
    earlier = {}
    for done in (examples, legacy):
        for key, (n, runs, full) in (done or {}).get("launched",
                                                     {}).items():
            entry = earlier.setdefault(key, [0, set(), True])
            entry[0] += n
            entry[1] |= runs
            entry[2] = entry[2] and full
    encdec = phase("encoder-decoder and embeddings input at full width: "
                   "seamless-m4t-large-v2, qwen2-vl-72b (8 layers)",
                   serve_encdec_embeds, card, earlier)
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
    cells = phase("the dry run (every arch x cell x mesh) and two cells "
                  "on the card: qwen2-0.5b decode_32k, recurrentgemma-2b "
                  "long_500k", serve_cells, card)
    if failed or kernels is None or rg_kernel is None or flash is None \
            or surface is None or fleet is None or planner is None \
            or family is None or scan_grad is None or trained is None \
            or ddp is None or rg_trained is None or encdec is None \
            or cells is None or examples is None or legacy is None:
        log(f"FAILED phases: {failed}")
        return 1
    # the kernels at phase 14's shapes and at every key phases 16, 18 and
    # 19 launched join their entries' cases; each entry also carries its
    # launches on phase 18's path (the examples) and phase 19's (the
    # legacy surface)
    for entry in kernels:
        entry["cases"] += [family["decode"][m][entry["name"]]
                           for m in family["decode"]]
    flash["cases"] += family["flash"]
    for entry in kernels + [flash, rg_kernel]:
        entry["cases"] += [case for name, case in
                           encdec["cases"] + cells["cases"]
                           if name == entry["name"]]
        entry["examples_launches"] = examples["launches"].get(
            entry["name"], 0)
        entry["legacy_launches"] = legacy["launches"].get(entry["name"], 0)
    # the scan's backward call: its launches on the training path
    rg_kernel["backward"] = dict(
        scan_grad, launches=rg_trained["backward_launches"])
    rg_kernel["train_launches"] = rg_trained["launches"]
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
    if admission is not None:
        log("admission s a round after the captures, graphs vs eager body "
            "(mean over rounds): " + "; ".join(
                f"{name} {_mean_s(r['graph'], False):.4f} vs "
                f"{_mean_s(r['eager'], False):.4f}"
                for name, r in admission.items()) + f"; on {card}")
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
    log("phase 14, decode tok/s (first run with captures; second run): "
        + "; ".join(
            f"{m} {name} {r['tok_s']:.1f}"
            + (f", {r['tok_s_again']:.1f}" if "tok_s_again" in r else "")
            for m in ("granite", "deepseek", "xlstm")
            for name, r in family[m].items() if name != "lengths")
        + f"; on {card}")
    log(f"phase 15, training: qwen2-0.5b {trained['ms']:.1f} ms a step, "
        f"{trained['tok_s']:.0f} tokens/s, {trained['memory']}, loss "
        f"{trained['first_loss']:.4f} -> {trained['last_loss']:.4f}; ddp "
        f"collectives a step " + ", ".join(
            f"{name} {r['collectives']}" for name, r in ddp["rows"].items())
        + f"; recurrentgemma-2b {rg_trained['ms']:.1f} ms a step, "
        f"{rg_trained['memory']}; on {card}")
    sm, vl = encdec["seamless"], encdec["qwen2-vl"]
    log(f"phase 16: seamless-m4t-large-v2 prefill {sm['prefill_ms']:.1f} "
        f"ms (first call {sm['cold_ms']:.1f}), decode {sm['tok_s']:.1f} "
        f"tok/s, "
        f"{sm['peak']:.2f} GiB; train {sm['train']['ms']:.1f} ms a step, "
        f"{sm['train']['memory']}; qwen2-vl-72b (8 layers) prefill "
        f"{vl['prefill_ms']:.1f} ms (first call {vl['cold_ms']:.1f}), decode "
        f"contiguous "
        f"{vl['tok_s']['contiguous']:.1f}, paged {vl['tok_s']['paged']:.1f} "
        f"tok/s, {vl['peak']:.2f} GiB; on {card}")
    log("phase 18, wall s: " + "; ".join(
        f"{name} {sec:.2f}" for name, sec in examples["seconds"].items())
        + f"; qwen2-0.5b full width serve_batched tok/s (4 slots, K = 1) "
        f"{_rates(examples['full'])}; {examples['step_ms']:.2f} ms a K = 1 "
        f"decode step; smollm-360m "
        f"{examples['quick_ms']:.1f} ms a train step; on {card}")
    log("phase 19, wall s (weights included): " + "; ".join(
        f"{name} {sec:.2f}" for name, sec in legacy["seconds"].items())
        + f"; the bare launcher (wave, 4 slots, 8 x 16 tokens, 12 new) "
        f"{legacy['tok_s']:.1f} tok/s; launches {legacy['launches']}; on "
        f"{card}")
    dec, lng = cells["decode_32k"], cells["long_500k"]
    log(f"phase 17: dry run {cells['dryrun']['ok']} ok, "
        f"{cells['dryrun']['skipped']} skipped in "
        f"{cells['dryrun']['seconds']} s; qwen2-0.5b decode_32k "
        f"{dec['ms']:.3f} ms a step, {dec['tok_s']:.1f} tok/s (roofline "
        f"compute {dec['compute_ms']:.3f} ms, memory {dec['memory_ms']:.3f} "
        f"ms, read-only {dec['read_ms']:.3f} ms), {dec['memory']}; "
        f"recurrentgemma-2b long_500k {lng['ms']:.3f} ms a step (weight "
        f"read {lng['weight_ms']:.3f} ms); script "
        f"{time.perf_counter() - started:.0f} s; on {card}")
    print(json.dumps({"kernels": kernels + [flash, rg_kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
