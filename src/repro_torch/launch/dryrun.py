"""Production-scale dry run: every (arch x shape x mesh) cell run on the
meta device (the port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell on a forced 512-device host
mesh.  The port has no compiler to ask, so ``lower_cell`` runs the
cell's step, built by the port's own step builders with
``make_shard_fn`` installed (an identity on these plain tensors), on meta
tensors (shapes, no storage) under
an op counter (``launch/op_analysis.py``), over a ``DeviceMesh`` of the
production shape.  The mesh's ranks belong to an in-process ``fake``
process group (``torch.testing._internal.distributed.fake_pg``), which
holds any number of ranks and moves no data; a dry run joins it inside
its own functions only, so importing this module sets nothing and joins
nothing.

Each record keeps the reference's keys:
  * ``memory.argument_bytes`` is exact: one card's shards of the
    parameters, optimizer state, batch and cache, from their specs;
    ``output_bytes`` and ``alias_bytes`` follow the reference's
    donations (a train step donates parameters and optimizer state, a
    prefill or decode step the cache); ``temp_bytes`` is the peak of
    live bytes allocated during the meta run of one microbatch at one
    card's batch rows.  That run computes with the whole parameter tree
    (the port has no partitioner), so its activations are full width
    and a train run holds the whole gradient tree: for a model sharded
    over "model" or "data", ``temp_bytes`` is an upper bound.
  * ``cost.flops_global`` is the FLOPs of the whole batch: the counted
    microbatch times (batch / rows run) times ``accum_steps`` (every op
    of these models is per row).  ``cost.flops_per_device`` is
    ``flops_global / n_chips``, the ideal partition.
    ``cost.bytes_per_device`` is the counter's no-fusion bound of one
    card's rows: the microbatch times ``accum_steps``, plus the
    optimizer step once.  ``cost_xla_loop_unaware`` holds the counts of
    one microbatch alone (the reference's XLA counted a loop body once).
  * ``collectives``: a train cell's gradient sync as the ``comm/``
    bucket plan schedules it over one card's gradient shards (one
    all-reduce per bucket and dtype; ``by_category`` for every endpoint
    category); ``source`` says so.  The reference's tensor-parallel
    collectives come from XLA's SPMD partitioner, which the port does not
    have: prefill and decode cells count none.
  * ``lower_s`` is the meta run's seconds; ``compile_s`` is 0 (nothing
    compiles).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \
      --shape decode_32k --mesh single
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback

import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.launch.mesh import (axis_names, axis_sizes, data_axes,
                                     make_production_mesh, mesh_axis_size)
from repro_torch.launch.op_analysis import OpCounter, bucket_plan_collectives
from repro_torch.launch.shapes import (SHAPES, batch_specs, cache_specs,
                                       cell_applicable, decode_token_specs)
from repro_torch.launch.sharding import (RULE_PRESETS, NamedSharding,
                                         PartitionSpec, Sharded,
                                         fsdp_tp_rules, is_sharded,
                                         make_shard_fn, shard_struct)
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models.model import Model
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.models.transformer import _remat_group
from repro_torch.optim.adamw import AdamW

FSDP_THRESHOLD = 5e9      # params above this use fsdp_tp rules
ACT_RESIDUAL_TARGET = 4 * 2 ** 30   # aim <= ~4 GiB of layer-input residuals
MESHES = {"single": 256, "multi": 512}


def auto_accum(cfg, cell, mesh, rules=None) -> int:
    """Gradient-accumulation factor: bound per-device activation residuals
    (n_layers x B_dev x S x d_model bf16) to ~4 GiB.  Sequence-parallel
    rule sets already divide residuals by the model-axis size."""
    if cell.kind != "train":
        return 1
    dp = mesh_axis_size(mesh, data_axes(mesh))
    bdev = max(1, cell.batch // dp)
    n_layers = cfg.n_layers + cfg.n_enc_layers    # enc-dec counts both
    g = _remat_group(n_layers)
    eff_layers = n_layers // g + g if g > 1 else n_layers
    if cfg.is_encdec:
        eff_layers *= 3       # cross-attention K/V + encoder memory
    # x2: the reference budgets an fp32 copy of the saved bf16 stack
    resid = 2 * eff_layers * bdev * cell.seq * cfg.d_model * 2
    if cfg.moe is not None:
        resid *= 2     # dispatch/combine intermediates scale with tokens
    if rules and rules.get("seq"):
        resid /= axis_sizes(mesh).get("model", 1)
    accum = 1
    while (resid / accum > ACT_RESIDUAL_TARGET and accum * 2 <= bdev
           and bdev % (accum * 2) == 0):
        accum *= 2
    return accum


def bf16_params(params):
    """``params`` in the dtypes of ``lower_cell(..., params_bf16=True)``:
    every fp32 leaf of rank 2 or more in bf16 (live mixed-precision
    weights), the others (norm scales, biases) as they are."""
    return tree_map(lambda p: p.to(torch.bfloat16)
                    if p.dtype == torch.float32 and p.dim() >= 2 else p,
                    params, torch.is_tensor)


def rules_for(model: Model, preset: str = "auto"):
    if preset == "auto":
        preset = "fsdp_tp" if model.n_params() > FSDP_THRESHOLD else "tp"
    return RULE_PRESETS[preset](), preset


def _opt_specs(model: Model, mesh, rules, params_sds, preset: str = "",
               master_fp32: bool = False):
    """-> (AdamW, its state as a tree of Sharded): the moments (and the
    fp32 master) take the parameters' specs, or ZeRO-1's (fsdp_tp) under
    ``tp_zero1`` or a master copy; the step count is replicated."""
    opt = AdamW(master_fp32=master_fp32)
    abstract = opt.init(tree_map(lambda s: s.tensor, params_sds, is_sharded))
    axes = model.param_axes()
    opt_rules = rules
    if preset == "tp_zero1" or master_fp32:
        opt_rules = fsdp_tp_rules()
    out = {"mu": shard_struct(opt_rules, mesh, abstract["mu"], axes),
           "nu": shard_struct(opt_rules, mesh, abstract["nu"], axes),
           "count": Sharded(abstract["count"],
                            NamedSharding(mesh, PartitionSpec()))}
    if master_fp32:
        out["master"] = shard_struct(opt_rules, mesh, abstract["master"],
                                     axes)
    return opt, out


def _local_bytes(tree) -> int:
    return sum(s.local_bytes for s in tree_leaves(tree, is_sharded))


def _rows(sds: Sharded) -> int:
    """One card's rows of a batch-major tensor."""
    return sds.sharding.shard_shape(sds.tensor.shape)[0]


def _run_tensors(tree, rows: int = 0, lead: int = 0):
    """Meta tensors to run: each leaf's global shape with its batch dim
    (dim ``lead``; 0, or 1 under a stacked body) cut to ``rows``, or as
    it is with ``rows`` 0."""
    def one(s):
        shape = list(s.tensor.shape)
        if rows and len(shape) > lead:
            shape[lead] = rows
        return torch.empty(shape, dtype=s.tensor.dtype, device="meta")
    return tree_map(one, tree, is_sharded)


def _cache_for_run(cache_sds, rows: int):
    """The cache at ``rows`` rows: the batch dim is 0 of each prefix
    leaf, 1 of each stacked body leaf, and ``idx`` stays a scalar."""
    out = {"idx": torch.empty((), dtype=torch.int32, device="meta")}
    out["stack"] = {
        "prefix": [_run_tensors(c, rows, 0)
                   for c in cache_sds["stack"]["prefix"]],
        "body": [_run_tensors(c, rows, 1)
                 for c in cache_sds["stack"]["body"]]}
    return out


class _MeteredOpt:
    """An optimizer whose ``step`` keeps apart the bytes ``counter``
    counts during it (``bytes``), so that a train cell counts the step
    once, not per microbatch."""

    def __init__(self, opt, counter: OpCounter):
        self.opt, self.counter, self.bytes = opt, counter, 0.0

    def step(self, *args):
        before = self.counter.bytes_accessed
        out = self.opt.step(*args)
        self.bytes += self.counter.bytes_accessed - before
        return out


def _scalar_bytes(metrics: dict) -> int:
    return sum(v.numel() * v.element_size() for v in metrics.values())


def lower_cell(arch: str, shape_name: str, mesh, rules_preset: str = "auto",
               accum_override: int = 0, cast_params_once: bool = False,
               params_bf16: bool = False) -> dict:
    """-> the record of one cell (module docstring): its step built by
    ``launch.steps`` with ``make_shard_fn(rules, mesh)``, run on meta
    tensors of one card's rows under an ``OpCounter``.  Those tensors are
    plain, not DTensors, so the installed ``shard_fn`` returns each as it
    is: it shapes neither the counts nor the step, and the sharding enters
    the record only through the specs (``argument_bytes``, rows run)."""
    cfg = get_config(arch)
    cell = SHAPES[shape_name]
    model = Model(cfg, device="meta")
    rules, preset = rules_for(model, rules_preset)
    shard_fn = make_shard_fn(rules, mesh)
    params_sds = shard_struct(rules, mesh, model.abstract_params(),
                              model.param_axes())
    if params_bf16:
        # mixed precision: live params bf16, fp32 master in opt state
        params_sds = tree_map(
            lambda s: Sharded(bf16_params(s.tensor), s.sharding),
            params_sds, is_sharded)
    params = _run_tensors(params_sds)
    accum = accum_override or auto_accum(cfg, cell, mesh, rules)
    counter = OpCounter()
    opt_bytes, out_extra = 0.0, 0
    t0 = time.time()
    if cell.kind == "train":
        opt, opt_sds = _opt_specs(model, mesh, rules, params_sds, preset,
                                  master_fp32=params_bf16)
        batch_sds = batch_specs(cfg, cell, mesh, rules)
        rows = _rows(next(iter(batch_sds.values())))
        micro = rows // accum
        metered = _MeteredOpt(opt, counter)
        step = make_train_step(model, metered, shard_fn=shard_fn,
                               accum_steps=1,
                               cast_params_once=cast_params_once)
        state = _run_tensors(opt_sds)
        batch = _run_tensors(batch_sds, micro)
        with counter:
            _, _, metrics = step(params, state, batch)
        opt_bytes = metered.bytes
        state_bytes = _local_bytes(params_sds) + _local_bytes(opt_sds)
        args_bytes = state_bytes + _local_bytes(batch_sds)
        alias = state_bytes
        out_extra = _scalar_bytes(metrics)
    elif cell.kind == "prefill":
        batch_sds = batch_specs(cfg, cell, mesh, rules)
        cache_sds = cache_specs(model, cell, mesh)
        micro = _rows(next(iter(batch_sds.values())))
        step = make_prefill_step(model, shard_fn=shard_fn)
        batch = _run_tensors(batch_sds, micro)
        cache = _cache_for_run(cache_sds, micro)
        with counter:
            logits, _ = step(params, batch, cache)
        args_bytes = (_local_bytes(params_sds) + _local_bytes(batch_sds)
                      + _local_bytes(cache_sds))
        alias = _local_bytes(cache_sds)
        out_extra = logits.numel() * logits.element_size()
    else:
        cache_sds = cache_specs(model, cell, mesh)
        tok_sds = next(iter(decode_token_specs(cfg, cell, mesh).values()))
        micro = _rows(tok_sds)
        step = make_decode_step(model, shard_fn=shard_fn)
        cache = _cache_for_run(cache_sds, micro)
        tokens = _run_tensors(tok_sds, micro)
        with counter:
            logits, _ = step(params, cache, tokens)
        args_bytes = (_local_bytes(params_sds) + _local_bytes(cache_sds)
                      + tok_sds.local_bytes)
        alias = _local_bytes(cache_sds)
        out_extra = logits.numel() * logits.element_size()
    t_run = time.time() - t0

    sizes = axis_sizes(mesh)
    n_chips = math.prod(sizes.values())
    output_bytes = alias + out_extra
    flops_run = counter.flops
    # every op is per row: the whole batch is batch / micro such runs
    flops_global = flops_run * cell.batch / micro
    bytes_dev = (counter.bytes_accessed - opt_bytes) * accum + opt_bytes
    if cell.kind == "train":
        grads = tree_map(lambda s: s.local(), params_sds, is_sharded)
        coll = bucket_plan_collectives(grads)
        from repro_torch.core.endpoints import Category
        by_cat = {}
        for cat in Category:
            c = bucket_plan_collectives(grads, cat)
            by_cat[cat.value] = {"total_count": c.collective_total_count,
                                 "total_bytes": c.collective_total_bytes}
        collectives = {"counts": coll.collective_counts,
                       "bytes": coll.collective_bytes,
                       "total_bytes": coll.collective_total_bytes,
                       "total_count": coll.collective_total_count,
                       "source": "bucket_plan", "by_category": by_cat}
    else:
        collectives = {"counts": {}, "bytes": {}, "total_bytes": 0.0,
                       "total_count": 0.0, "source": "none"}
    return {
        "arch": arch, "shape": shape_name, "kind": cell.kind,
        "mesh": {a: sizes[a] for a in axis_names(mesh)},
        "n_chips": n_chips,
        "rules": preset,
        "accum_steps": accum,
        "n_params": model.n_params(),
        "rows_run": micro,
        "n_ops": counter.n_ops,
        "lower_s": round(t_run, 2), "compile_s": 0.0,
        "memory": {
            "argument_bytes": args_bytes,
            "output_bytes": output_bytes,
            "temp_bytes": counter.peak_bytes,
            "alias_bytes": alias,
            "peak_live_bytes": (args_bytes + output_bytes
                                + counter.peak_bytes - alias),
        },
        "cost": {"flops_per_device": flops_global / n_chips,
                 "flops_global": flops_global,
                 "bytes_per_device": bytes_dev},
        "cost_xla_loop_unaware": {"flops_per_device": flops_run,
                                  "bytes_per_device":
                                      counter.bytes_accessed},
        "collectives": collectives,
    }


# --------------------------------------------------------------------------
# The fake process group and the sweep
# --------------------------------------------------------------------------

def production_mesh(mesh_name: str):
    """The production mesh ``mesh_name`` ("single" or "multi") over a
    ``fake`` process group of its size, joined (or rejoined at another
    size) in this process."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    world = MESHES[mesh_name]
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run needs a fake process group; "
                               "this process joined another")
        if dist.get_world_size() != world:
            dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    return make_production_mesh(multi_pod=mesh_name == "multi",
                                device_type="cpu")


def run_one(arch: str, shape_name: str, mesh_name: str,
            rules_preset: str = "auto") -> dict:
    """One cell's record: skipped, ok or failed (with the traceback)."""
    t0 = time.time()
    cfg = get_config(arch)
    ok, reason = cell_applicable(cfg, SHAPES[shape_name])
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh_name": mesh_name,
                "status": "skipped", "reason": reason}
    try:
        rec = lower_cell(arch, shape_name, production_mesh(mesh_name),
                         rules_preset)
        rec["status"] = "ok"
        rec["mesh_name"] = mesh_name
    except Exception as e:      # noqa: BLE001 -- record and move on
        rec = {"arch": arch, "shape": shape_name, "mesh_name": mesh_name,
               "status": "failed", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
    rec["seconds"] = round(time.time() - t0, 2)
    return rec


def _run_task(task):
    torch.set_num_threads(1)
    return run_one(*task)


def _line(rec: dict) -> str:
    tag = f"{rec['arch']}|{rec['shape']}|{rec['mesh_name']}"
    if rec["status"] == "skipped":
        return f"[skip] {tag}: {rec['reason']}"
    if rec["status"] == "failed":
        return f"[FAIL] {tag}: {rec['error']}"
    m = rec["memory"]
    return (f"[ ok ] {tag}: run={rec['lower_s']}s ops={rec['n_ops']} "
            f"args={m['argument_bytes'] / 2**30:.2f}GiB "
            f"temp={m['temp_bytes'] / 2**30:.2f}GiB "
            f"flops/dev={rec['cost']['flops_per_device']:.3e} "
            f"accum={rec['accum_steps']} "
            f"coll={rec['collectives']['total_count']:.0f}ops/"
            f"{rec['collectives']['total_bytes'] / 2**20:.1f}MiB")


def run_cells(archs, shapes, meshes, out_dir: str,
              rules_preset: str = "auto", verbose: bool = True,
              jobs: int = 1) -> list:
    """Every (mesh, arch, shape) cell, each record written to
    ``out_dir/<arch>_<shape>_<mesh>.json`` and all of them to
    ``summary.json``.  ``jobs`` > 1 runs the cells in that many worker
    processes (spawned; each joins its own fake group)."""
    os.makedirs(out_dir, exist_ok=True)
    tasks = [(arch, shape, mesh_name, rules_preset)
             for mesh_name in meshes for arch in archs for shape in shapes]
    t0 = time.time()
    if jobs > 1:
        # the longest runs first: a sub-quadratic arch's recurrence steps
        # through every position of a train or prefill cell
        order = sorted(range(len(tasks)), key=lambda i: (
            not get_config(tasks[i][0]).sub_quadratic,
            SHAPES[tasks[i][1]].kind == "decode", i))
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor, as_completed
        with ProcessPoolExecutor(jobs, mp_context=mp.get_context("spawn")) \
                as pool:
            futures = {pool.submit(_run_task, tasks[i]): i for i in order}
            results = [None] * len(tasks)
            for fut in as_completed(futures):
                rec = results[futures[fut]] = fut.result()
                if verbose:
                    print(_line(rec), flush=True)
    else:
        results = []
        for task in tasks:
            rec = run_one(*task)
            results.append(rec)
            if verbose:
                print(_line(rec), flush=True)
    for rec in results:
        path = os.path.join(out_dir, f"{rec['arch']}_{rec['shape']}_"
                                     f"{rec['mesh_name']}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    summary = {
        "total": len(results),
        "ok": sum(r.get("status") == "ok" for r in results),
        "skipped": sum(r.get("status") == "skipped" for r in results),
        "failed": sum(r.get("status") == "failed" for r in results),
        "seconds": round(time.time() - t0, 2),
        "jobs": jobs,
    }
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump({"summary": summary, "cells": results}, f, indent=1)
    print("SUMMARY:", summary, flush=True)
    if verbose:
        slow = sorted((r for r in results if "seconds" in r),
                      key=lambda r: -r["seconds"])[:8]
        print("slowest cells (s): " + ", ".join(
            f"{r['arch']}|{r['shape']}|{r['mesh_name']} {r['seconds']}"
            for r in slow), flush=True)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ARCHS))
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--rules", default="auto",
                    choices=["auto", "tp", "fsdp_tp"])
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes (0: one per CPU core this "
                         "process may run on)")
    args = ap.parse_args(argv)

    archs = list(ARCHS) if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    jobs = args.jobs or len(os.sched_getaffinity(0))
    results = run_cells(archs, shapes, meshes, args.out, args.rules,
                        jobs=jobs)
    if any(r.get("status") == "failed" for r in results):
        sys.exit(1)


if __name__ == "__main__":
    main()
