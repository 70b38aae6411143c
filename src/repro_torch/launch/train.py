"""Training launcher (the port of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
      --steps 20 --batch 8 --seq 512 --mode ddp --endpoint mpi_threads

Runs on the card unless ``--device cpu``.  ``--mode ddp`` runs the
data-parallel step whose gradient sync the scalable-endpoints engine
schedules (``--endpoint`` picks the category).  It joins the process
group that ``torchrun``'s environment names (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``; each rank on card ``LOCAL_RANK``), or
else forms a one-process group on a free localhost port: NCCL on the
card, gloo on the CPU; its mesh is every rank on one "data" axis
(``launch.mesh.make_mesh``), whose group the gradient sync runs over.
``--mode jit`` runs the single-process step.
"""

from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.core.endpoints import Category
from repro_torch.launch.mesh import make_mesh
from repro_torch.train.loop import TrainConfig, Trainer


def join_group(device: str) -> str:
    """Initialize the default process group for ``--mode ddp``; -> the
    device this rank trains on."""
    backend = "nccl" if device.startswith("cuda") else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if backend == "nccl":
            device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
            torch.cuda.set_device(device)
        dist.init_process_group(backend, init_method="env://")
    else:
        # the store listens on a localhost port of its own choosing, so
        # no probed port is freed for another socket to take first
        store = dist.TCPStore("localhost", 0, world_size=1, is_master=True)
        dist.init_process_group(backend, store=store, world_size=1, rank=0)
    return device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=list(ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mode", default="jit", choices=["jit", "ddp"])
    ap.add_argument("--endpoint", default="2x_dynamic",
                    choices=[c.value for c in Category])
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--metrics", default="metrics.jsonl")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    device = args.device
    mesh = None
    if args.mode == "ddp":
        device = join_group(device)
        mesh = make_mesh((dist.get_world_size(),), ("data",),
                         device_type=torch.device(device).type)
    try:
        tc = TrainConfig(
            seq_len=args.seq, global_batch=args.batch, n_steps=args.steps,
            peak_lr=args.lr, checkpoint_dir=args.ckpt_dir,
            checkpoint_every=args.ckpt_every, mode=args.mode,
            endpoint_category=Category(args.endpoint), mesh=mesh,
            device=device)
        trainer = Trainer(cfg, tc)
        logs = trainer.train()
        trainer.save_metrics(args.metrics)
        print(f"final: {logs[-1]}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
