"""Weights from the seed: drawn by the benchmark on the device, in the
tree layout the program takes (``connect(params=...)``), in the dtype the
configuration serves in.

Shapes come from the program's abstract tree (meta tensors, no storage);
the values are the benchmark's own.  Each leaf is one call of
``torch.randn`` on a generator on the device, straight in the served
dtype, then scaled in place: no fp32 copy of the model is ever made.
Leaves are drawn in sorted path order, so the same seed gives the same
tree, and the reference draws it again rather than reading the program's.

Scales: a matrix ``fan_in ** -0.5`` (the attention projections by
``d_model``, the output projection by ``heads x d_head``, FFN and expert
matrices by their input width, the router by ``d_model``); the token
table ``d_model ** -0.5``, so the tied head's logits have unit spread;
norm scales ``1 + 0.1 N``; attention biases ``0.1 N``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def _walk(tree, path=()) -> List[Tuple[tuple, object]]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _walk(tree[k],
                                                            path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [leaf for i, v in enumerate(tree)
                for leaf in _walk(v, path + (i,))]
    return [(path, tree)]


def _rebuild(tree, values: Dict[tuple, torch.Tensor], path=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, values, path + (i,))
                          for i, v in enumerate(tree))
    return values[path]


def _rule(path: tuple, shape: tuple) -> Tuple[str, float]:
    """-> (kind, scale) of the leaf at ``path``: ``normal`` (scale x N),
    ``one_plus`` (1 + scale x N)."""
    name = path[-1]
    if name == "scale":
        return "one_plus", 0.1
    if name in ("bq", "bk", "bv", "bias"):
        return "normal", 0.1
    if name == "tok":
        return "normal", shape[-1] ** -0.5
    if name in ("wq", "wk", "wv"):
        return "normal", shape[-3] ** -0.5
    if name == "wo":
        return "normal", (shape[-3] * shape[-2]) ** -0.5
    if name in ("w_gate", "w_up", "w_down", "router", "head"):
        return "normal", shape[-2] ** -0.5
    raise KeyError(f"no drawing rule for leaf {'/'.join(map(str, path))}")


def draw(abstract_tree, seed: int, device, dtype: torch.dtype):
    """The weights of ``seed``: a tree shaped like ``abstract_tree`` (meta
    tensors), every leaf on ``device`` in ``dtype``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    values = {}
    for path, leaf in _walk(abstract_tree):
        kind, scale = _rule(path, tuple(leaf.shape))
        t = torch.randn(tuple(leaf.shape), generator=gen, device=device,
                        dtype=dtype)
        t.mul_(scale)
        if kind == "one_plus":
            t.add_(1.0)
        values[path] = t
    return _rebuild(abstract_tree, values)
