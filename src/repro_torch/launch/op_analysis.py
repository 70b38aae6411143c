"""Cost analysis of a step run on meta tensors (the port's counterpart of
``repro.launch.hlo_analysis``, which walks XLA's HLO; the port has no
HLO, so it counts the ops PyTorch dispatches).

``OpCounter`` is a ``TorchDispatchMode``.  Over everything run inside it
it counts:

  * matmul FLOPs, with ``torch.utils.flop_counter``'s formulas (mm,
    addmm, bmm, baddbmm, convolution, SDPA; what ``FlopCounterMode``
    counts);
  * bytes accessed: the inputs and outputs of every op that is not a
    view, each op alone -- the no-fusion upper bound;
  * the peak of live bytes allocated inside the run (the step's
    temporaries, activations kept for the backward, gradients).

On the meta device many elementwise ops run a Python reference for
their shapes (hundreds of microseconds each), and the port's time and
chunk loops run them thousands of times at one signature.  The counter
memoizes each op's output shapes, strides and dtypes by its signature
(every tensor argument's shape, strides, dtype and device, and every
other argument's value): a repeated call makes empty meta tensors of
those shapes instead of running the shape function again.  A meta
kernel's output depends on nothing else, so the outputs are the same.
In-place ops are checked the first time and return their target after;
views and ops with ``out=`` always run.

Collectives are not seen here: ``bucket_plan_collectives`` takes the
gradient sync's schedule from the ``comm/`` bucket plan.  The result type
keeps ``HLOCosts``' fields, so a dry-run record keeps the reference's
keys.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

_MISS = object()
#: ops that only allocate (no bytes move)
_NO_TRAFFIC = {torch.ops.aten.empty.memory_format,
               torch.ops.aten.empty_strided.default,
               torch.ops.aten.empty_like.default}


@dataclasses.dataclass
class OpCosts:
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_counts: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    collective_bytes: Dict[str, float] = dataclasses.field(
        default_factory=dict)

    @property
    def collective_total_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    @property
    def collective_total_count(self) -> float:
        return sum(self.collective_counts.values())


def _sig(args) -> tuple:
    """A hashable signature of a sequence of arguments: each tensor's
    shape, strides, dtype and whether it is a meta tensor, each other
    argument itself (TypeError if one is not hashable)."""
    out = []
    for x in args:
        if isinstance(x, torch.Tensor):
            out.append((x.shape, x.stride(), x.dtype, x.is_meta))
        elif isinstance(x, (list, tuple)):
            out.append(_sig(x))
        else:
            hash(x)
            out.append(x)
    return tuple(out)


def _tensors(x) -> list:
    """The tensors of ``x`` (a tensor, or a list / tuple of arguments,
    each a tensor or a list / tuple of tensors)."""
    if isinstance(x, torch.Tensor):
        return [x]
    out = []
    for v in x:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            out.extend(t for t in v if isinstance(t, torch.Tensor))
    return out


def _nbytes(tensors) -> int:
    n = 0
    for t in tensors:
        n += t.numel() * t.element_size()
    return n


class OpCounter(TorchDispatchMode):
    """Count FLOPs (``flops``), bytes (``bytes_accessed``), ops
    (``n_ops``) and the live-bytes peak (``peak_bytes``) of what runs
    inside (module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.n_ops = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._memo = {}
        self._info = {}
        self._refs = {}

    # ----- per-op classification (cached per overload) ---------------------
    def _info_of(self, func, composite: bool = True) -> tuple:
        """-> (kind, FLOP formula or None, whether it moves bytes); kind
        is composite (decompose it), out (an out= variant), inplace, view
        or fresh (new storage)."""
        info = self._info.get(func)
        if info is not None:
            return info
        schema = func._schema
        formula = flop_registry.get(func._overloadpacket)
        if composite and formula is None and \
                torch._C._dispatch_has_kernel_for_dispatch_key(
                    func.name(),
                    torch._C.DispatchKey.CompositeImplicitAutograd):
            kind = "composite"
        else:
            writes = any(a.alias_info is not None and a.alias_info.is_write
                         for a in schema.arguments)
            aliased = any(r.alias_info is not None for r in schema.returns)
            if writes and any(a.kwarg_only and a.alias_info is not None
                              for a in schema.arguments):
                kind = "out"
            elif writes:
                kind = "inplace"
            elif aliased:
                kind = "view"
            else:
                kind = "fresh"
        info = self._info[func] = (kind, formula,
                                   kind != "view" and func not in _NO_TRAFFIC)
        return info

    # ----- live bytes ----------------------------------------------------
    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = id(st)
            if key in self._refs:
                continue
            n = st.nbytes()
            self.live_bytes += n
            if self.live_bytes > self.peak_bytes:
                self.peak_bytes = self.live_bytes
            self._refs[key] = weakref.ref(
                st, lambda _, key=key, n=n: self._free(key, n))

    def _free(self, key, n) -> None:
        self._refs.pop(key, None)
        self.live_bytes -= n

    # ----- dispatch --------------------------------------------------------
    def _run(self, func, kind, args, kwargs):
        if kind == "view" or kind == "out":
            return func(*args, **kwargs)
        try:
            key = (func, _sig(args),
                   _sig(kwargs.items()) if kwargs else ())
        except TypeError:
            return func(*args, **kwargs)
        hit = self._memo.get(key, _MISS)
        if hit is not _MISS:
            if kind == "inplace":
                return args[0]
            return _rebuild(hit)
        out = func(*args, **kwargs)
        if kind == "inplace":
            if out is args[0] and args[0].is_meta:
                self._memo[key] = True
        else:
            meta = _describe(out)
            if meta is not None:
                self._memo[key] = meta
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kind, formula, traffic = self._info_of(func)
        if kind == "composite":
            # an op with a decomposition: count what it decomposes to
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
            del self._info[func]
            kind, formula, traffic = self._info_of(func, composite=False)
        out = self._run(func, kind, args, kwargs)
        self.n_ops += 1
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if traffic:
            self.bytes_accessed += _nbytes(_tensors(args)) + _nbytes(
                _tensors(out) if isinstance(out, (torch.Tensor, tuple, list))
                else ())
            if kwargs:
                self.bytes_accessed += _nbytes(_tensors(kwargs.values()))
        if kind == "fresh" and isinstance(out, (torch.Tensor, tuple, list)):
            self._track(out)
        return out


def _describe(out):
    """-> a rebuildable description of ``out`` (a meta tensor or a tuple
    / list of them), or None for anything else (a tensor with data is
    never replayed)."""
    if isinstance(out, torch.Tensor):
        if out.device.type != "meta":
            return None
        return ("T", tuple(out.shape), out.stride(), out.dtype, out.device)
    if isinstance(out, (tuple, list)) and out and all(
            isinstance(t, torch.Tensor) for t in out):
        parts = tuple(_describe(t) for t in out)
        return None if None in parts else (type(out), parts)
    return None


def _rebuild(meta):
    if meta[0] == "T":
        _, shape, stride, dtype, device = meta
        return torch.empty_strided(shape, stride, dtype=dtype, device=device)
    kind, parts = meta
    return kind(_rebuild(p) for p in parts)


def bucket_plan_collectives(grads_tree, category=None,
                            lanes: int = 16) -> OpCosts:
    """The gradient sync's collectives for one step: the ``comm/``
    bucket plan of ``grads_tree`` (one card's gradient shards, meta
    tensors are enough) under the endpoint ``category`` (the trainer's
    default, 2xDynamic, when None): one all-reduce per (bucket, dtype)
    flat buffer, its bytes the buffer's (the result-shape convention)."""
    from repro_torch.comm.bucketing import make_bucket_plan
    from repro_torch.core.channels import plan_for
    from repro_torch.core.endpoints import Category
    plan = make_bucket_plan(grads_tree, plan_for(
        category or Category.TWO_X_DYNAMIC, lanes=lanes))
    costs = OpCosts()
    for per_dtype in plan.buckets:
        for total, segs in per_dtype.values():
            costs.collective_counts["all-reduce"] = \
                costs.collective_counts.get("all-reduce", 0) + 1
            costs.collective_bytes["all-reduce"] = \
                costs.collective_bytes.get("all-reduce", 0) \
                + total * segs[0].dtype.itemsize
    return costs
