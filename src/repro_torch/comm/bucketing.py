"""Gradient bucketing, the Postlist analogue (the port of
``repro.comm.bucketing``).

Partitions a gradient tree into ``k`` byte-balanced buckets and packs
each bucket into one flat tensor per dtype, so one collective moves a
whole bucket (one "doorbell" for many "WQEs").  Bucket segments are
padded to a 128-byte lane boundary: the paper's BUF-alignment lesson
(Section V-A), producers never share a lane tile.

The plan is computed from shapes and dtypes alone, and equals the
reference's for the same tree: leaves numbered in ``jax.tree.flatten``
order (dict keys sorted), the same greedy assignment, offsets and
padding, dtypes named as numpy names them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import torch
import torch.nn.functional as F

from repro_torch.core.channels import ChannelPlan
from repro_torch.models.params import tree_flatten, tree_unflatten


def _is_leaf(x) -> bool:
    return torch.is_tensor(x)


def dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype ("float32", "bfloat16", ...)."""
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class _Segment:
    leaf: int                # leaf index in the flattened tree
    shape: tuple
    dtype: torch.dtype
    offset: int              # element offset into the (bucket, dtype) buffer
    padded_size: int


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    treedef: Any
    n_leaves: int
    # per bucket: dtype name -> (total elements, segments), insertion-ordered
    buckets: tuple
    leaf_bucket: tuple        # leaf index -> bucket index

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    @property
    def n_buffers(self) -> int:
        """(bucket, dtype) flat buffers: one collective each."""
        return sum(len(b) for b in self.buckets)

    def bucket_bytes(self) -> list:
        out = []
        for b in self.buckets:
            total = 0
            for n_elems, segs in b.values():
                total += n_elems * segs[0].dtype.itemsize
            out.append(total)
        return out


def _padded_elems(shape, dtype: torch.dtype, pad_bytes: int) -> int:
    n = math.prod(shape) if shape else 1
    lane = max(1, pad_bytes // dtype.itemsize)
    return -(-n // lane) * lane


def make_bucket_plan(tree, plan: ChannelPlan) -> BucketPlan:
    """Greedy byte-balanced partition of ``tree``'s leaves (anything with
    ``shape`` and a torch ``dtype``) into the plan's bucket count.
    Deterministic: leaves taken by (size desc, leaf index)."""
    leaves, treedef = tree_flatten(tree, _is_leaf)
    shapes = [(i, tuple(l.shape), l.dtype) for i, l in enumerate(leaves)]
    n_buckets = plan.n_buckets(len(leaves))

    sizes = [(math.prod(s) or 1) * d.itemsize for _, s, d in shapes]
    order = sorted(range(len(leaves)), key=lambda i: (-sizes[i], i))
    load = [0] * n_buckets
    leaf_bucket = [0] * len(leaves)
    for i in order:
        b = min(range(n_buckets), key=lambda j: (load[j], j))
        leaf_bucket[i] = b
        load[b] += sizes[i]

    buckets = []
    for b in range(n_buckets):
        per_dtype: dict = {}
        for i, shape, dtype in shapes:
            if leaf_bucket[i] != b:
                continue
            name = dtype_name(dtype)
            total, segs = per_dtype.get(name, (0, []))
            padded = _padded_elems(shape, dtype, plan.bucket_pad_bytes)
            segs = segs + [_Segment(leaf=i, shape=shape, dtype=dtype,
                                    offset=total, padded_size=padded)]
            per_dtype[name] = (total + padded, segs)
        buckets.append(per_dtype)
    return BucketPlan(treedef=treedef, n_leaves=len(leaves),
                      buckets=tuple(buckets), leaf_bucket=tuple(leaf_bucket))


def pack_buckets(tree, plan: BucketPlan) -> list:
    """-> list over buckets of {dtype name: flat tensor}, each a fresh
    buffer (a collective may reduce it in place)."""
    leaves = tree_flatten(tree, _is_leaf)[0]
    out = []
    for per_dtype in plan.buckets:
        packed = {}
        for name, (total, segs) in per_dtype.items():
            parts = []
            for s in segs:
                flat = leaves[s.leaf].reshape(-1)
                if s.padded_size != flat.numel():
                    flat = F.pad(flat, (0, s.padded_size - flat.numel()))
                parts.append(flat)
            packed[name] = torch.cat(parts)
        out.append(packed)
    return out


def unpack_buckets(packed: Sequence, plan: BucketPlan):
    """Inverse of :func:`pack_buckets` (each leaf a view of its buffer)."""
    leaves = [None] * plan.n_leaves
    for per_dtype, packed_b in zip(plan.buckets, packed):
        for name, (total, segs) in per_dtype.items():
            flat = packed_b[name]
            for s in segs:
                n = math.prod(s.shape) if s.shape else 1
                leaves[s.leaf] = flat[s.offset:s.offset + n].reshape(
                    s.shape)
    return tree_unflatten(plan.treedef, leaves)
