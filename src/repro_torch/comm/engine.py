"""GradSyncEngine: the paper's scalable endpoints applied to gradient
synchronization (the port of ``repro.comm.engine``, over a
``torch.distributed`` process group).

Each endpoint category becomes a collective schedule for the
data-parallel gradient reduction:

  MPI everywhere  -> one all-reduce per gradient tensor (max independence:
                     many small collectives, alpha-dominated)
  2xDynamic       -> k byte-balanced buckets, double-buffered channels
  Dynamic         -> k byte-balanced buckets, one collective each
  Shared Dynamic  -> k/2 buckets
  Static          -> k/4 buckets
  MPI+threads     -> ONE fused all-reduce for everything (min resources,
                     fully serialized behind a single dependency)

There is one ``all_reduce`` per (bucket, dtype) flat buffer.  Channelled
categories issue them asynchronously and wait for all at the end;
``sync_stride`` q > 1 (the Unsignaled analogue) makes every q-th bucket
wait for the one before it, bounding the buffers in flight.  All
categories give the same sums; they differ in the collectives issued,
which the engine counts per call (``last_collectives``,
``last_bytes``): that count is the category's resource use.  The engine
needs an initialized process group and raises without one.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.distributed as dist

from repro_torch.comm.bucketing import (BucketPlan, make_bucket_plan,
                                        pack_buckets, unpack_buckets)
from repro_torch.comm.compression import NoCompressor
from repro_torch.core.channels import ChannelPlan, plan_for
from repro_torch.core.endpoints import Category
from repro_torch.models.params import tree_leaves


class GradSyncEngine:
    """Bucketed gradient all-reduce per the endpoint category.

        engine = GradSyncEngine(Category.TWO_X_DYNAMIC)   # default group
        synced, comp_state = engine(grads, comp_state)
    """

    def __init__(self, category_or_plan: Union[Category, ChannelPlan],
                 group: Optional[dist.ProcessGroup] = None,
                 lanes: int = 16, sync_stride: int = 1,
                 compressor=None, mean: bool = True):
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "GradSyncEngine needs an initialized torch.distributed "
                "process group (init_process_group first)")
        if isinstance(category_or_plan, Category):
            self.plan = plan_for(category_or_plan, lanes=lanes,
                                 sync_stride=sync_stride)
        else:
            self.plan = category_or_plan
        self.group = group
        self.compressor = compressor or NoCompressor()
        self.mean = mean
        self.last_collectives = 0
        self.last_bytes = 0

    # -- static planning (shapes only) -----------------------------------
    def make_plan(self, grads_tree) -> BucketPlan:
        return make_bucket_plan(grads_tree, self.plan)

    def init_compressor_state(self, grads_tree):
        if isinstance(self.compressor, NoCompressor):
            return ()
        bplan = self.make_plan(grads_tree)
        device = tree_leaves(grads_tree, torch.is_tensor)[0].device
        return [{name: torch.zeros(total, dtype=torch.float32,
                                   device=device)
                 for name, (total, _) in b.items()}
                for b in bplan.buckets]

    def world_size(self) -> int:
        return dist.get_world_size(self.group)

    # -- the collective schedule -----------------------------------------
    def _all_reduce(self, x, op=dist.ReduceOp.SUM, async_op=False):
        self.last_collectives += 1
        self.last_bytes += x.numel() * x.element_size()
        return dist.all_reduce(x, op=op, group=self.group,
                               async_op=async_op)

    def _psum(self, x):
        self._all_reduce(x)
        return x

    def _pmax(self, x):
        x = x.clone()
        self._all_reduce(x, op=dist.ReduceOp.MAX)
        return x

    def __call__(self, grads, compressor_state=()):
        self.last_collectives = 0
        self.last_bytes = 0
        bplan = self.make_plan(grads)
        packed = pack_buckets(grads, bplan)
        compressed = not isinstance(self.compressor, NoCompressor)
        overlap = not (compressed or self.plan.serialize)

        new_state, reduced, pending, prev = [], [], [], None
        for bi, per_dtype in enumerate(packed):
            out_b, st_b = {}, {}
            # Unsignaled analogue: every sync_stride-th bucket waits for
            # the bucket before it, so at most q buckets are in flight
            if (prev is not None and self.plan.sync_stride > 1
                    and bi % self.plan.sync_stride == 0):
                for work in prev:
                    work.wait()
            prev = []
            for name, flat in per_dtype.items():
                if compressed:
                    out, st_b[name] = self.compressor.reduce(
                        flat, compressor_state[bi][name], self._psum,
                        self._pmax)
                else:
                    out = flat
                    work = self._all_reduce(out, async_op=overlap)
                    if overlap:
                        prev.append(work)
                        pending.append(work)
                out_b[name] = out
            reduced.append(out_b)
            new_state.append(st_b)
        for work in pending:
            work.wait()

        if self.mean:
            inv = 1.0 / self.world_size()
            reduced = [{n: a * torch.tensor(inv, dtype=a.dtype,
                                            device=a.device)
                        for n, a in b.items()} for b in reduced]
        synced = unpack_buckets(reduced, bplan)
        return (synced, new_state) if compressed else (synced, ())


def sync_gradients(grads, category: Category,
                   group: Optional[dist.ProcessGroup] = None, **kw):
    """One-shot functional wrapper: ``grads`` all-reduced (the mean, by
    default) over ``group`` (None: the default group) under
    ``category``'s schedule."""
    out, _ = GradSyncEngine(category, group=group, **kw)(grads)
    return out
