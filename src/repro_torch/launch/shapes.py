"""The four shape cells and per-(arch x cell) input specs (the port of
``repro.launch.shapes``).

Every spec is a :class:`~repro_torch.launch.sharding.Sharded`: a meta
tensor of the global shape and dtype (no storage) with the sharding the
rules give it, so the dry run sizes every argument without allocating.
``decode_*`` / ``long_*`` describe one decode step with a KV cache of the
cell's context length; ``long_500k`` applies only to sub-quadratic
architectures.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import axis_sizes
from repro_torch.launch.sharding import (NamedSharding, PartitionSpec as P,
                                         Sharded, batch_spec, kv_cache_spec)
from repro_torch.models.layers import compute_dtype
from repro_torch.models.model import Model
from repro_torch.models.params import tree_map

ENC_STUB_LEN = 4096      # encoder memory length for enc-dec decode cells


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str            # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}


def cell_applicable(cfg: ArchConfig, cell: ShapeCell) -> tuple:
    """-> (applicable, reason)."""
    if cell.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention architecture: 500k dense-attention "
                       "decode has no algorithmic support (designed skip, "
                       "DESIGN.md §4)")
    return True, ""


def _sds(shape, dtype, mesh, spec: P) -> Sharded:
    return Sharded(torch.empty(shape, dtype=dtype, device="meta"),
                   NamedSharding(mesh, spec))


def batch_specs(cfg: ArchConfig, cell: ShapeCell, mesh, rules=None) -> dict:
    """Model inputs of a cell (training / prefill)."""
    b, s = cell.batch, cell.seq
    bs = batch_spec(mesh, b, rules=rules)
    bax = bs[0] if len(bs) else None
    i32, cd = torch.int32, compute_dtype(cfg)
    out = {}
    if cfg.is_encdec:
        enc_s = s if cell.kind == "train" else min(s, ENC_STUB_LEN)
        out["enc_embeds"] = _sds((b, enc_s, cfg.d_model), cd, mesh,
                                 P(bax, None, None))
        out["tokens"] = _sds((b, s), i32, mesh, P(bax, None))
    elif cfg.input_mode == "embeddings":
        out["embeds"] = _sds((b, s, cfg.d_model), cd, mesh,
                             P(bax, None, None))
        if cfg.pos == "mrope":
            out["positions"] = _sds((b, s, 3), i32, mesh,
                                    P(bax, None, None))
    else:
        out["tokens"] = _sds((b, s), i32, mesh, P(bax, None))
    if cell.kind == "train":
        out["labels"] = _sds((b, s), i32, mesh, P(bax, None))
    return out


def _cache_spec_for(path_keys, leaf, cfg: ArchConfig, mesh,
                    batch: int) -> P:
    """Sharding for one cache leaf, identified by its key path."""
    stacked = "body" in path_keys          # leading n_periods dim
    lead = (None,) if stacked else ()
    shape = leaf.shape[1:] if stacked else leaf.shape
    name = path_keys[-1]
    msize = axis_sizes(mesh).get("model", 1)
    bs = batch_spec(mesh, batch)
    bax = bs[0] if len(bs) else None

    if name in ("k", "v"):
        spec = kv_cache_spec(mesh, batch, shape[2], shape[3])
        return P(*lead, *spec)
    # recurrent states: shard the (last) channel-ish dim over model if it
    # divides; batch over data
    parts = [bax] + [None] * (len(shape) - 1)
    for di in range(len(shape) - 1, 0, -1):
        if shape[di] % msize == 0:
            parts[di] = "model"
            break
    return P(*lead, *parts)


def _with_paths(tree, path=()):
    """The tree with each tensor leaf replaced by (key path, leaf); keys
    are strings, list positions their decimal index (as the reference's
    ``tree_map_with_path`` keys print)."""
    if torch.is_tensor(tree):
        return (path, tree)
    if isinstance(tree, dict):
        return {k: _with_paths(v, path + (str(k),)) for k, v in tree.items()}
    return type(tree)(_with_paths(v, path + (str(i),))
                      for i, v in enumerate(tree))


def cache_specs(model: Model, cell: ShapeCell, mesh) -> dict:
    """The decode cache of a cell: ``model.init_cache`` built on the meta
    device, each leaf with the spec of its key path."""
    cfg = model.cfg
    b = cell.batch
    enc_len = ENC_STUB_LEN if cfg.is_encdec else 0
    abstract = Model(cfg, device="meta").init_cache(b, max_len=cell.seq,
                                                    enc_len=enc_len)

    def one(pair):
        keys, leaf = pair
        if keys[-1] == "idx":
            return Sharded(leaf, NamedSharding(mesh, P()))
        return Sharded(leaf, NamedSharding(
            mesh, _cache_spec_for(keys, leaf, cfg, mesh, b)))

    return tree_map(one, _with_paths(abstract),
                    lambda x: isinstance(x, tuple) and len(x) == 2
                    and torch.is_tensor(x[1]))


def decode_token_specs(cfg: ArchConfig, cell: ShapeCell, mesh) -> dict:
    b = cell.batch
    bs = batch_spec(mesh, b)
    bax = bs[0] if len(bs) else None
    if cfg.input_mode == "embeddings" and not cfg.is_encdec:
        return {"embeds": _sds((b, cfg.d_model), compute_dtype(cfg), mesh,
                               P(bax, None))}
    return {"tokens": _sds((b,), torch.int32, mesh, P(bax))}
