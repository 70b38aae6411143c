"""Logical-axis sharding rules with divisibility fallback (the port of
``repro.launch.sharding``).

A rule set maps logical axis names (from ``ParamSpec.axes``) to mesh
axes.  ``spec_for`` drops any mesh axis that does not divide the
dimension (the dimension replicates instead of failing) and never assigns
one mesh axis twice within a spec, so one rule set serves every
architecture.  A spec is a :class:`PartitionSpec`, entry for entry the
reference's ``jax.sharding.PartitionSpec``: per tensor dimension ``None``,
one mesh axis, or a tuple of them (major to minor), trailing ``None``s
dropped.  ``placements`` turns it into ``torch.distributed.tensor``
placements over a ``DeviceMesh``.

Rule presets:
  tp      : tensor-parallel weights over "model", everything else
            replicated (small models; the data-parallel gradient sync is
            the endpoint engine's)
  fsdp_tp : additionally shards the "embed" dimension over "data"
            (ZeRO-3-style parameter and optimizer sharding; 72B/16B
            configs)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence

from repro_torch.launch.mesh import axis_names, axis_sizes, data_axes
from repro_torch.models.params import tree_map

Rules = dict


class PartitionSpec(tuple):
    """Per tensor dimension: None (replicated), a mesh axis name, or a
    tuple of names (the dimension split over them, major to minor)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"



def tp_rules() -> Rules:
    return {
        "q_heads": ("model",), "kv_heads": ("model",), "mlp": ("model",),
        "vocab": ("model",), "expert": ("model",), "lru": ("model",),
        "heads_x": ("model",),
        "embed": (), "lru_in": (), "conv": (), "layers": (),
        "qkv_block": (), "qkv_block_in": (), "head_dim": (),
        "head_rec": (), "head_rec_in": (),
    }


def fsdp_tp_rules() -> Rules:
    r = tp_rules()
    r["embed"] = ("data",)
    return r


def fsdp_tp_sp_rules() -> Rules:
    """fsdp_tp + a sequence-parallel residual stream (Korthikanti et
    al.): the stream's seq dimension over "model"."""
    r = fsdp_tp_rules()
    r["seq"] = ("model",)
    return r


def dp_only_rules() -> Rules:
    """Pure data parallelism over every mesh axis: each parameter
    replicated, the batch over (pod, data, model)."""
    r = {k: () for k in tp_rules()}
    r["batch"] = ("pod", "data", "model")
    return r


def tp_zero1_rules() -> Rules:
    """TP weights + ZeRO-1: the optimizer moments are sharded over "data"
    too (``dryrun._opt_specs``); the parameters stay resident."""
    return tp_rules()


RULE_PRESETS = {"tp": tp_rules, "fsdp_tp": fsdp_tp_rules,
                "fsdp_tp_sp": fsdp_tp_sp_rules, "dp_only": dp_only_rules,
                "tp_zero1": tp_zero1_rules}


def spec_for(rules: Rules, mesh, shape: Sequence[int],
             axes: Sequence[str]) -> PartitionSpec:
    """PartitionSpec for one tensor given its logical axes."""
    names, sizes = axis_names(mesh), axis_sizes(mesh)
    used = set()
    parts = []
    for dim, ax in zip(shape, axes):
        assigned = []
        for mesh_ax in rules.get(ax, ()):
            if mesh_ax not in names or mesh_ax in used:
                continue
            cur = math.prod(sizes[a] for a in assigned)
            if dim % (cur * sizes[mesh_ax]) == 0:
                assigned.append(mesh_ax)
                used.add(mesh_ax)
        if not assigned:
            parts.append(None)
        elif len(assigned) == 1:
            parts.append(assigned[0])
        else:
            parts.append(tuple(assigned))
    while parts and parts[-1] is None:
        parts.pop()
    return PartitionSpec(*parts)


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_shape(shape: Sequence[int], spec: PartitionSpec, mesh) -> tuple:
    """One rank's shard of a tensor of ``shape`` under ``spec`` (every
    split divides: ``spec_for`` assigns no other)."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        n = math.prod(sizes[a] for a in _entry_axes(entry))
        if out[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"over {entry} ({n})")
        out[d] //= n
    return tuple(out)


def placements(spec: PartitionSpec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on
    each mesh dimension that tensor dimension d uses, ``Replicate()`` on
    the others.  A dimension split over several mesh axes takes them in
    the mesh's order, major to minor, as the reference's spec does; a
    spec that lists them in another order raises ValueError."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        where = [names.index(a) for a in axes]
        if where != sorted(where):
            raise ValueError(f"spec {spec}: dim {d} takes mesh axes "
                             f"{axes} out of the mesh's order {names}")
        for i in where:
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``'s counterpart)."""
    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)

    def shard_shape(self, shape: Sequence[int]) -> tuple:
        return local_shape(shape, self.spec, self.mesh)


def is_sharding(x) -> bool:
    return isinstance(x, NamedSharding)


@dataclasses.dataclass(frozen=True)
class Sharded:
    """A meta tensor (the global shape and dtype) with its sharding:
    ``jax.ShapeDtypeStruct`` with a sharding attached."""
    tensor: Any
    sharding: NamedSharding

    @property
    def spec(self) -> PartitionSpec:
        return self.sharding.spec

    def local(self):
        """A meta tensor of one rank's shard."""
        import torch
        return torch.empty(self.sharding.shard_shape(self.tensor.shape),
                           dtype=self.tensor.dtype, device="meta")

    @property
    def local_bytes(self) -> int:
        shape = self.sharding.shard_shape(self.tensor.shape)
        return math.prod(shape) * self.tensor.element_size()


def is_sharded(x) -> bool:
    return isinstance(x, Sharded)


def param_shardings(rules: Rules, mesh, abstract_params, axes_tree):
    """The tree of :class:`NamedSharding` of every parameter."""
    import torch
    return tree_map(
        lambda leaf, axes: NamedSharding(
            mesh, spec_for(rules, mesh, leaf.shape, axes)),
        abstract_params, torch.is_tensor, axes_tree)


def shard_struct(rules: Rules, mesh, abstract_params, axes_tree):
    """-> the tree of :class:`Sharded`: each meta leaf with the sharding
    the rules give it."""
    import torch
    return tree_map(
        lambda leaf, axes: Sharded(leaf, NamedSharding(
            mesh, spec_for(rules, mesh, leaf.shape, axes))),
        abstract_params, torch.is_tensor, axes_tree)


# --------------------------------------------------------------------------
# Activation shardings
# --------------------------------------------------------------------------

def batch_spec(mesh, batch_size: int, *extra,
               rules: Optional[Rules] = None) -> PartitionSpec:
    """Shard the batch dim over the data axes (with divisibility check).
    A rule set may widen the batch axes (dp_only uses the model axis
    too)."""
    names, sizes = axis_names(mesh), axis_sizes(mesh)
    axes = [a for a in (rules or {}).get("batch", data_axes(mesh))
            if a in names]
    cur = 1
    keep = []
    for a in axes:
        if batch_size % (cur * sizes[a]) == 0:
            keep.append(a)
            cur *= sizes[a]
    first = tuple(keep) if len(keep) > 1 else (keep[0] if keep else None)
    return PartitionSpec(first, *extra)


def kv_cache_spec(mesh, batch: int, heads: int,
                  head_dim: int) -> PartitionSpec:
    """(B, S, Hkv, dh): shard heads over model when divisible, else shard
    head_dim (head-dim-sharded attention), else replicate."""
    msize = axis_sizes(mesh).get("model", 1)
    bspec = batch_spec(mesh, batch)
    b_axes = bspec[0] if len(bspec) else None
    if heads % msize == 0:
        return PartitionSpec(b_axes, None, "model", None)
    if head_dim % msize == 0:
        return PartitionSpec(b_axes, None, None, "model")
    return PartitionSpec(b_axes)


def make_shard_fn(rules: Rules, mesh):
    """-> shard_fn(tensor, *logical_axes): a DTensor is redistributed to
    the placements its logical axes give under the activation rules; a
    plain tensor comes back as the same object (no kernel, no copy).  A
    ``None`` axis name is an anonymous, never-sharded dimension."""
    from torch.distributed.tensor import DTensor
    act_rules = dict(rules)
    act_rules.setdefault("expert_cap", ("data",))
    act_rules.setdefault("batch", data_axes(mesh))
    act_rules.setdefault("seq", ())
    # the flat (expert * capacity) dispatch dim stays unsharded, as the
    # reference keeps it (its scatter partitioner re-materialized the
    # updates when it was model-sharded)
    act_rules.setdefault("expert_flat", ())

    def shard_fn(a, *logical):
        if not isinstance(a, DTensor):
            return a
        logical = tuple(l if l is not None else f"_anon{i}"
                        for i, l in enumerate(logical))
        spec = spec_for(act_rules, mesh, a.shape, logical)
        return a.redistribute(mesh, placements(spec, mesh))
    return shard_fn
