"""The paper's 5-point stencil (Section VII) over ``torch.distributed``: a
row-sharded grid whose halo rows move between ranks each step, with the
halo traffic scheduled per scalable-endpoint category and costed by the
alpha-beta model.  The PyTorch counterpart of
``examples/stencil_endpoints.py``: its grid, steps and lines, through
``repro_torch`` only.

The reference forces 8 host devices.  This script runs as many ranks as
its process group holds, one card a rank, joined the way the port's
training launcher joins it (``launch.train.join_group``): torchrun's
environment if set, else a one-process group (NCCL on the card, gloo on
the CPU).

Each step sends every rank's last row to rank + 1 and its first row to
rank - 1 (periodic): the paper's 2 halo messages per rank (Fig. 13).
They travel in one ``all_to_all_single`` a step whose split sizes carry
exactly those rows, empty for every other peer, so the exchange goes
through ``torch.distributed`` at every group size, 1 included, where
both neighbours are the rank itself (torch's point-to-point calls refuse
a peer equal to the caller).

  PYTHONPATH=src python examples/stencil_endpoints_torch.py
  PYTHONPATH=src python examples/stencil_endpoints_torch.py --device cpu
  PYTHONPATH=src torchrun --nproc-per-node 4 \\
      examples/stencil_endpoints_torch.py

Runs on the card unless ``--device cpu``; without CUDA it raises
RuntimeError.
"""

import argparse

import torch
import torch.distributed as dist

from repro_torch.comm.costs import estimate_sync_time
from repro_torch.core.channels import plan_for
from repro_torch.core.endpoints import Category
from repro_torch.launch.train import join_group
from repro_torch.models.model import resolve_device

GRID = 512
STEPS = 5
#: the reference's alpha-beta constants (its TPU v5e ICI link, bytes/s,
#: and latency a collective step, s), so the table is the reference's
REF_ICI_LINK_BW = 50e9
REF_ICI_ALPHA = 1e-6


def initial_grid() -> torch.Tensor:
    """The (GRID, GRID) fp32 start grid: standard normal from a
    ``torch.Generator`` seeded 0, on the CPU (the same on every rank)."""
    gen = torch.Generator().manual_seed(0)
    return torch.randn((GRID, GRID), generator=gen)


def halo_exchange(tile):
    """Send ``tile``'s last row to rank + 1 and its first row to rank - 1
    (mod the group's size) in one ``all_to_all_single``; -> (up, down,
    messages): the row above the tile (rank - 1's last), the row below it
    (rank + 1's first), each (1, cols), and the halo rows the collective
    carried for this rank: the rows its input splits sent, which must
    equal the rows its output splits received."""
    n, r = dist.get_world_size(), dist.get_rank()
    nxt, prv = (r + 1) % n, (r - 1) % n
    # (peer, kind, row); the input holds each peer's rows together, peers
    # in rank order, and within a peer a last row before a first row
    sends = sorted([(nxt, 0, tile[-1:]), (prv, 1, tile[:1])],
                   key=lambda m: m[:2])
    recvs = sorted([(prv, 0), (nxt, 1)])
    send = torch.cat([row for _, _, row in sends])
    out_splits = [sum(p == q for q, _ in recvs) for p in range(n)]
    in_splits = [sum(p == q for q, _, _ in sends) for p in range(n)]
    if sum(out_splits) != sum(in_splits):
        raise AssertionError(f"halo rows sent {in_splits} and received "
                             f"{out_splits} differ")
    recv = torch.empty((sum(out_splits), send.shape[1]), dtype=send.dtype,
                       device=send.device)
    dist.all_to_all_single(recv, send, output_split_sizes=out_splits,
                           input_split_sizes=in_splits)
    up = recv[recvs.index((prv, 0))][None]
    down = recv[recvs.index((nxt, 1))][None]
    return up, down, sum(in_splits)


def stencil_step(tile, up, down):
    """One explicit step of the periodic 5-point Laplacian on a row tile
    with its halo rows."""
    padded = torch.cat([up, tile, down])
    lap = (padded[:-2] + padded[2:]
           + torch.roll(tile, 1, 1) + torch.roll(tile, -1, 1) - 4 * tile)
    return tile + 0.1 * lap


def cost_table(n: int) -> list:
    """-> [(category, estimated seconds at the reference's ICI constants,
    channels)] of the halo exchange over ``n`` ranks, per endpoint
    category."""
    halo_bytes = GRID * 4 * 2               # two rows
    rows = []
    for cat in Category:
        plan = plan_for(cat, lanes=n)
        cost = estimate_sync_time([halo_bytes] * n, plan, axis_size=n,
                                  link_bw=REF_ICI_LINK_BW,
                                  alpha=REF_ICI_ALPHA)
        rows.append((cat, cost.seconds, plan.n_buckets(n)))
    return rows


def run(device, grid=None, steps=STEPS) -> dict:
    """The stencil over the joined process group: ``grid`` ((GRID, GRID),
    ``initial_grid()`` if None) row-sharded over the ranks, ``steps``
    steps with a halo exchange each, gathered back; prints the reference's
    lines (rank 0).  -> {"grid": the result on ``device``, "ranks",
    "messages_per_step": halo rows the collective carried for this rank
    a step}."""
    n, r = dist.get_world_size(), dist.get_rank()
    grid = initial_grid() if grid is None else grid
    if grid.shape[0] % n:
        raise ValueError(f"{grid.shape[0]} rows do not split over {n} ranks")
    rows = grid.shape[0] // n
    tile = grid[r * rows:(r + 1) * rows].to(device, torch.float32)
    messages = 0
    for _ in range(steps):
        up, down, sent = halo_exchange(tile)
        messages += sent
        tile = stencil_step(tile, up, down)
    parts = [torch.empty_like(tile) for _ in range(n)]
    dist.all_gather(parts, tile)
    out = torch.cat(parts)
    total = float(out.sum())
    if r == 0:
        print(f"stencil on {n} ranks, grid {grid.shape[0]}^2, {steps} "
              f"steps: sum={total:.3f}")
        print(f"halo messages per rank and step: {messages // steps} "
              f"through torch.distributed: the rows that one "
              f"all_to_all_single a step carried, by its split sizes (the "
              f"reference counted collective-permutes in its HLO; 2 per "
              f"step = the paper's 2 halo messages per rank)")
    return {"grid": out, "ranks": n, "messages_per_step": messages / steps}


def print_cost_table(n: int) -> list:
    """Print ``cost_table(n)`` (rank 0); -> its rows."""
    rows = cost_table(n)
    if dist.get_rank() == 0:
        print("\nhalo-exchange scheduling per endpoint category "
              "(alpha-beta ICI model):")
        print(f"  (est: the reference's ICI constants, "
              f"{REF_ICI_LINK_BW / 1e9:.0f} GB/s a link and "
              f"{REF_ICI_ALPHA * 1e6:.0f} us a step; a model, not a "
              f"measurement)")
        for cat, seconds, channels in rows:
            print(f"  {cat.value:16s} est={seconds * 1e6:8.2f}us  "
                  f"channels={channels}")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = join_group(str(resolve_device(args.device)))
    try:
        result = run(device)
        result["costs"] = print_cost_table(result["ranks"])
        return result
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
