"""Cells at the program's smoke sizes, for the CPU tests: the same files'
shapes, with the sizes of ``repro_torch.configs`` ``SMOKE`` and a plan
and traffic small enough for a CPU run of a second or two."""

from __future__ import annotations

import copy
import dataclasses

from perfbench import spec

#: the smoke configurations' sizes (``repro_torch.configs`` ``SMOKE``)
ARCH = {
    "qwen2-0.5b": {
        "name": "qwen2-0.5b-smoke", "family": "dense", "n_layers": 2,
        "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "d_ff": 128,
        "vocab": 128, "d_head": 16, "block_pattern": ["attn"],
        "norm": "rmsnorm", "act": "swiglu", "pos": "rope",
        "rope_theta": 1e6, "qkv_bias": True, "tie_embeddings": True},
    "granite-moe-1b-a400m": {
        "name": "granite-moe-1b-a400m-smoke", "family": "moe",
        "n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
        "d_ff": 32, "vocab": 128, "d_head": 16, "block_pattern": ["attn"],
        "norm": "rmsnorm", "act": "swiglu", "pos": "rope",
        "rope_theta": 1e4, "qkv_bias": False, "tie_embeddings": True,
        "moe": {"n_routed": 8, "top_k": 2, "d_expert": 32, "n_shared": 0,
                "capacity_factor": 1.25}},
}

PLAN = {
    "qwen2-0.5b.reason-batch": {"n_slots": 4, "max_len": 128,
                                "decode_horizon": 4, "prefill_buckets": [],
                                "pages": 4, "page_budget": None},
    "granite-moe-1b-a400m.chat-rate": {"n_slots": 4, "max_len": 128,
                                       "decode_horizon": 4,
                                       "prefill_buckets": "auto"},
}

MIX = {
    "reason-batch": {"prompt": {"median": 20, "sigma": 0.6, "min": 8,
                                "max": 48},
                     "output": {"median": 10, "sigma": 0.5, "min": 4,
                                "max": 20}, "stagger_s": 0.1},
    "chat-rate": {"prompt": {"median": 16, "sigma": 1.0, "min": 4,
                             "max": 64},
                  "output": {"median": 8, "sigma": 0.8, "min": 2,
                             "max": 20}},
}


def smoke_cell(workload: str, dtype: str = "float32") -> spec.Cell:
    """``workload``'s cell with every size cut to the smoke scale."""
    cell = spec.load_cell(workload)
    cfg = copy.deepcopy(cell.cfg)
    cfg["arch"] = dict(ARCH[cell.entry["config"]], compute_dtype=dtype)
    cfg["dtype"] = dtype
    mix = dict(cell.mix, **MIX[cell.entry["traffic"]])
    data = dict(cell.data, plan=PLAN[workload], sample=1000)
    if "clients" in data:
        data["clients"] = 4
    if "rate_per_s" in data:
        data["rate_per_s"] = 8.0
    return dataclasses.replace(cell, cfg=cfg, mix=mix, data=data)


class one_thread:
    """Torch on one thread while inside: the CPU runs of these cells time
    their own traffic, and parallel test workers would otherwise each take
    every core."""

    def __enter__(self):
        import torch
        self.n = torch.get_num_threads()
        torch.set_num_threads(1)

    def __exit__(self, *exc):
        import torch
        torch.set_num_threads(self.n)
