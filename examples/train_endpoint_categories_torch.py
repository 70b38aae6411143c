"""The paper's technique as a first-class training feature: the same DDP
run under each scalable-endpoint category — identical losses (the schedule
changes, the math does not), different collective schedules.  The PyTorch
counterpart of ``examples/train_endpoint_categories.py``: its config,
categories and lines, through ``repro_torch`` only.

The reference forces 4 host devices.  This script runs as many ranks as
its process group holds, one card a rank: it joins the group the way the
port's training launcher does (``launch.train.join_group``): torchrun's
environment if set, else a one-process group (NCCL on the card, gloo on
the CPU).  Its mesh is every rank on one "data" axis.

  PYTHONPATH=src python examples/train_endpoint_categories_torch.py
  PYTHONPATH=src python examples/train_endpoint_categories_torch.py \\
      --device cpu
  PYTHONPATH=src torchrun --nproc-per-node 4 \\
      examples/train_endpoint_categories_torch.py

Runs on the card unless ``--device cpu``; without CUDA it raises
RuntimeError.  On the card it runs with
``torch.use_deterministic_algorithms`` on, so that the three runs do the
same arithmetic in the same order.
"""

import argparse
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke_config
from repro_torch.core.endpoints import Category
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.train import join_group
from repro_torch.models.model import resolve_device
from repro_torch.train.loop import TrainConfig, Trainer

CATEGORIES = (Category.MPI_EVERYWHERE, Category.TWO_X_DYNAMIC,
              Category.MPI_THREADS)


def run(cfg, device, n_steps=20) -> dict:
    """The same ddp run under each of ``CATEGORIES`` over a "data" mesh of
    every rank of the joined process group; prints each final loss
    (rank 0).  -> {category value: final loss}."""
    device = torch.device(device)
    n = dist.get_world_size()
    mesh = make_mesh((n,), ("data",), device_type=device.type)
    rank0 = dist.get_rank() == 0
    if rank0:
        print(f"ranks: {n} in the process group (one a card; the "
              f"reference forces 4 host devices)")
    final = {}
    deterministic = torch.are_deterministic_algorithms_enabled()
    if device.type == "cuda":
        # deterministic cuBLAS reads this
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(device.type == "cuda" or
                                       deterministic)
    try:
        for cat in CATEGORIES:
            with tempfile.TemporaryDirectory() as d:
                tc = TrainConfig(seq_len=64, global_batch=8,
                                 n_steps=n_steps, checkpoint_dir=d,
                                 checkpoint_every=100, log_every=5,
                                 mode="ddp", endpoint_category=cat,
                                 mesh=mesh, device=str(device))
                logs = Trainer(cfg, tc).train()
            final[cat.value] = logs[-1]["loss"]
            if rank0:
                print(f"{cat.value:16s} final loss {logs[-1]['loss']:.5f}")
    finally:
        torch.use_deterministic_algorithms(deterministic)
    vals = list(final.values())
    if rank0:
        # bit for bit: the categories change the schedule, not the sums
        print("identical across categories:",
              all(v == vals[0] for v in vals))
    return final


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = join_group(str(resolve_device(args.device)))
    try:
        return run(get_smoke_config("smollm-360m"), device)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
