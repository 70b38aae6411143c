"""Parameter specs and the weight bridge to the JAX reference.

A parameter is declared once as a :class:`ParamSpec` (shape, initializer,
logical axis names), in the same tree as ``repro.models.params``: nested
dicts and lists, scanned body layers stacked on a leading ``layers`` axis.

* ``materialize(specs, generator, device)`` draws every leaf with the
  reference's init distributions from a ``torch.Generator``.  The stream
  is torch's, not JAX's: parity tests move JAX's own weights across with
  ``from_numpy`` instead.
* ``abstract`` / ``axes_tree`` give every leaf as a meta tensor (shape
  and dtype, no storage) and its logical axis names, for the sharding
  rules and the dry run.
* ``from_numpy`` / ``to_numpy`` convert a tree of numpy arrays (what
  ``jax.device_get`` returns for the reference's params) to tensors and
  back, bit-exact on every leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    axes: tuple                     # logical axis names; len == rank
    init: str = "fan_in"            # fan_in | zeros | ones | normal |
    #                                 lambda_rglru
    dtype: Any = torch.float32
    scale: Optional[float] = None   # stddev override for normal inits
    fan_in: Optional[int] = None    # override for fan_in init
    keep_fp32: bool = False         # read in fp32 at every compute dtype

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map(f: Callable, tree, is_leaf: Callable = lambda x: False,
             *rest):
    """Map ``f`` over the leaves of a tree of dicts / lists / tuples.
    With ``rest`` trees of the same structure, ``f`` takes the leaf of
    each at that place as well."""
    if is_leaf(tree):
        return f(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(f, v, is_leaf, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(f, v, is_leaf, *r)
                          for v, *r in zip(tree, *rest))
    return f(tree, *rest)


def tree_leaves(tree, is_leaf: Callable = lambda x: False) -> list:
    """Leaves in the order ``jax.tree.leaves`` yields them (dict keys
    sorted, sequences in order)."""
    if is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in tree_leaves(tree[k], is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v, is_leaf)]
    return [tree]


def tree_flatten(tree, is_leaf: Callable = lambda x: False):
    """-> (leaves in ``tree_leaves`` order, treedef).  The treedef is the
    tree with each leaf replaced by its index in that order;
    :func:`tree_unflatten` puts leaves back in its places."""
    leaves = []

    def walk(node):
        if is_leaf(node) or not isinstance(node, (dict, list, tuple)):
            leaves.append(node)
            return _LeafIndex(len(leaves) - 1)
        if isinstance(node, dict):
            walked = {k: walk(node[k]) for k in sorted(node)}
            return {k: walked[k] for k in node}
        return type(node)(walk(v) for v in node)

    return leaves, walk(tree)


@dataclasses.dataclass(frozen=True)
class _LeafIndex:
    i: int


def tree_unflatten(treedef, leaves):
    """Inverse of :func:`tree_flatten`."""
    return tree_map(lambda ix: leaves[ix.i], treedef,
                    lambda x: isinstance(x, _LeafIndex))


def stack_specs(tree, n: int, axis_name: str = "layers"):
    """Add a leading stacking dimension (the scanned body layers)."""
    return tree_map(
        lambda s: dataclasses.replace(s, shape=(n,) + s.shape,
                                      axes=(axis_name,) + s.axes),
        tree, is_spec)


def _init_one(spec: ParamSpec, generator: torch.Generator):
    dev = generator.device
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=dev)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=dev)
    if spec.init == "lambda_rglru":
        # RG-LRU Lambda: a in [0.9, 0.999] -> softplus^-1 of -log(u)/2
        # (Griffin's initialization range)
        u = 0.9 ** 2 + (0.999 ** 2 - 0.9 ** 2) * torch.rand(
            spec.shape, generator=generator, dtype=torch.float32,
            device=dev)
        val = torch.log(torch.exp(-torch.log(u) / 2) - 1.0)
        return val.to(spec.dtype)
    if spec.init == "normal":
        std = spec.scale if spec.scale is not None else 0.02
    elif spec.init == "fan_in":
        # stacked specs: fan-in excludes the leading stack dims
        rank = len(spec.shape)
        fan_in = spec.fan_in or (
            spec.shape[-2] if rank >= 2 else spec.shape[-1])
        std = spec.scale if spec.scale is not None else fan_in ** -0.5
    else:
        raise NotImplementedError(
            f"init {spec.init!r} belongs to a block kind of a later slice")
    return std * torch.randn(spec.shape, generator=generator,
                             dtype=spec.dtype, device=dev)


def materialize(spec_tree, generator: torch.Generator, device):
    """Draw every leaf from ``generator`` (on the generator's device) and
    place it on ``device``.  Leaves draw in ``tree_leaves`` order."""
    drawn = {id(s): _init_one(s, generator).to(device)
             for s in tree_leaves(spec_tree, is_spec)}
    return tree_map(lambda s: drawn[id(s)], spec_tree, is_spec)


def abstract(spec_tree):
    """Meta tensors of every spec's shape and dtype: the tree's shapes
    with no storage (``jax.ShapeDtypeStruct``'s counterpart)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), spec_tree, is_spec)


def axes_tree(spec_tree):
    """Every spec's logical axis names, in the tree's layout."""
    return tree_map(lambda s: s.axes, spec_tree, is_spec)


def n_params(spec_tree) -> int:
    return sum(int(np.prod(s.shape))
               for s in tree_leaves(spec_tree, is_spec))


def _leaf_from_numpy(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # numpy has no native bf16: reinterpret the 16-bit payload
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        # bf16 -> fp32 is exact; numpy has no native bf16
        t = t.float()
    return t.numpy().copy()


def from_numpy(tree):
    """Tree of numpy arrays -> tree of CPU tensors, bit-exact per leaf."""
    return tree_map(_leaf_from_numpy, tree,
                    lambda x: isinstance(x, np.ndarray) or np.isscalar(x))


def to_numpy(tree):
    """Tree of tensors -> tree of numpy arrays, bit-exact per leaf (bf16
    leaves come back as their exact fp32 values)."""
    return tree_map(_leaf_to_numpy, tree, torch.is_tensor)
