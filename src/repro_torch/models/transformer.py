"""Block stack: layer planning, attention, RG-LRU and xLSTM blocks, dense
and MoE FFNs, caches.

``LayerPlan`` splits the per-layer block descriptors into an unrolled
prefix and a periodic body exactly as ``repro.models.transformer`` does,
so parameter and cache trees have the same layout (body leaves stacked on
a leading ``layers`` axis).  Eager PyTorch has no scan to trace: the body
is a Python loop over that axis, and each layer works on views of the
stacked tensors.

KV caches are updated IN PLACE (the reference rebuilt them functionally):
the prefill writes the prompt rows, and a decode step writes exactly one
row per batch row, through views, so the stacked cache itself changes.
Sliding-window layers of sub-quadratic models keep a ROLLING cache of
``min(max_len, window)`` rows, position ``t`` at row ``t % window``, as
the reference does; RG-LRU and xLSTM blocks keep their conv and fp32
state, written in place too.  An enc-dec decoder's cross-attention
caches hold the encoder's k and v, written whole by the prefill and read
by every decode step.

In train mode (no cache) the stack is differentiable and, with
``remat``, checkpointed as the reference's is (``apply_stack``); the MoE
blocks' auxiliary losses come back summed beside the output.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention.ops import (
    flash_decode_attention, paged_flash_decode_attention)
from repro_torch.models.attention import (attention_decode,
                                          attention_decode_paged,
                                          attn_specs, kernel_route,
                                          project_kv, project_out,
                                          project_q)
from repro_torch.models.layers import (apply_ffn, apply_norm, apply_rope,
                                       compute_dtype, ffn_specs, no_sharding,
                                       norm_specs)
from repro_torch.models.moe import apply_moe, moe_specs
from repro_torch.models.params import stack_specs, tree_map
from repro_torch.models.recurrent import (apply_rglru_block,
                                          init_rglru_cache, rglru_specs)
from repro_torch.models.xlstm import (apply_mlstm_block, apply_slstm_block,
                                      init_mlstm_cache, init_slstm_cache,
                                      mlstm_specs, slstm_specs)

ATTN_KINDS = ("attn", "attn_local")


@dataclasses.dataclass(frozen=True)
class LayerDesc:
    kind: str                 # attn | attn_local | rglru | mlstm | slstm
    ffn: str                  # dense | dense0 | moe | none
    cross: bool = False       # decoder cross-attention (enc-dec)


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    prefix: tuple             # LayerDescs unrolled before the periodic body
    period: tuple             # LayerDescs of one period
    n_periods: int

    @property
    def n_layers(self):
        return len(self.prefix) + len(self.period) * self.n_periods


def _descriptors(cfg: ArchConfig, n_layers: int, cross: bool) -> list:
    pattern = cfg.pattern_for(n_layers)
    descs = []
    for i, kind in enumerate(pattern):
        if kind in ("mlstm", "slstm"):
            ffn = "none"
        elif cfg.moe is not None:
            ffn = "moe" if i >= cfg.moe.first_moe_layer else "dense0"
        else:
            ffn = "dense"
        descs.append(LayerDesc(kind=kind, ffn=ffn, cross=cross))
    return descs


def make_plan(cfg: ArchConfig, n_layers: Optional[int] = None,
              cross: bool = False) -> LayerPlan:
    """The (prefix, period) split with the fewest distinct layers."""
    descs = _descriptors(cfg, n_layers or cfg.n_layers, cross)
    best = None
    for prefix_len in range(len(descs)):
        rest = descs[prefix_len:]
        if not rest:
            break
        for p in range(1, len(rest) + 1):
            if len(rest) % p:
                continue
            if all(rest[i] == rest[i % p] for i in range(len(rest))):
                cand = LayerPlan(prefix=tuple(descs[:prefix_len]),
                                 period=tuple(rest[:p]),
                                 n_periods=len(rest) // p)
                cost = prefix_len + p
                if best is None or cost < best[0]:
                    best = (cost, cand)
                break
    assert best is not None
    return best[1]


# --------------------------------------------------------------------------
# Per-block specs / apply
# --------------------------------------------------------------------------

#: the recurrent blocks by kind (also their param and cache keys): specs,
#: apply (updates its cache in place and takes ``step_active``), cache
_RECURRENT = {
    "rglru": (rglru_specs, apply_rglru_block, init_rglru_cache),
    "mlstm": (mlstm_specs, apply_mlstm_block, init_mlstm_cache),
    "slstm": (slstm_specs, apply_slstm_block, init_slstm_cache),
}


def block_specs(cfg: ArchConfig, desc: LayerDesc):
    s = {"norm1": norm_specs(cfg)}
    if desc.kind in ATTN_KINDS:
        s["attn"] = attn_specs(cfg)
    else:
        s[desc.kind] = _RECURRENT[desc.kind][0](cfg)
    if desc.cross:
        s["norm_cross"] = norm_specs(cfg)
        s["cross"] = attn_specs(cfg, cross=True)
    if desc.ffn != "none":
        s["norm2"] = norm_specs(cfg)
        if desc.ffn == "moe":
            s["moe"] = moe_specs(cfg)
        else:        # dense; dense0 is the MoE stack's dense layer 0
            s["ffn"] = ffn_specs(cfg, d_ff=(cfg.moe.dense_d_ff or cfg.d_ff)
                                 if desc.ffn == "dense0" else None)
    return s


@dataclasses.dataclass
class BlockCtx:
    """Context threaded through every block of one forward call."""
    cfg: ArchConfig
    mode: str                         # train | prefill | decode
    positions: Any                    # (B,S) or (B,S,3)
    attn_fn: Any
    causal: bool = True
    enc_out: Any = None               # (B, Se, d) encoder memory for
    #                                   cross-attention (enc-dec)
    shard_fn: Any = no_sharding       # (tensor, *logical axes) -> tensor
    decode_idx: Any = None            # (B,) or scalar int32 cache index
    window_cache: bool = False        # rolling window KV cache
    ragged_kernel: bool = False       # CPU: decode via the kernels' plain
    #                                   versions (CUDA always uses kernels)
    decode_write_mask: Any = None     # (B,) bool: rows allowed to write
    page_table: Any = None            # (B, max_pages) int32; None =
    #                                   contiguous cache
    step_active: Any = None           # 0-d bool: off for a decode step
    #                                   the reference's horizon would not
    #                                   run (recurrent state stays)


def _attn_cache_write(cache, k_new, v_new, idx, write_mask=None,
                      window: int = 0):
    """Write one decode step's k/v into a contiguous cache, in place.

    The reference rebuilt the whole cache with ``jnp.where`` every step;
    here only row ``[b, slot[b]]`` is written, where ``slot = idx``, or
    ``idx % window`` for a rolling cache (``window > 0``: every row wraps,
    retired rows past max_len too).  Rows whose slot lies past the buffer
    (retired slots) or whose ``write_mask`` is off write their own current
    value back, so nothing changes for them and the step needs no host
    sync to find them."""
    smax = cache["k"].shape[1]
    slot = idx % window if window > 0 else idx
    if idx.dim() == 0:
        # one shared position: the reference's dynamic_update_slice clamps
        pos = slot.clamp(0, smax - 1).long().reshape(1)
        cache["k"].index_copy_(1, pos, k_new)
        cache["v"].index_copy_(1, pos, v_new)
        return
    rows = torch.arange(idx.shape[0], device=idx.device)
    ok = (slot >= 0) & (slot < smax)
    if write_mask is not None:
        ok &= write_mask
    pos = slot.clamp(0, smax - 1).long()
    for name, new in (("k", k_new), ("v", v_new)):
        buf = cache[name]
        buf[rows, pos] = torch.where(ok[:, None, None], new[:, 0],
                                     buf[rows, pos])


def _attn_cache_write_paged(cache, k_new, v_new, idx, page_table,
                            write_mask=None):
    """Write one decode step's k/v into a PAGED cache, in place.

    Row b lands at flat row ``pt[b, idx[b]//ps] * ps + idx[b] % ps`` of
    the (N*ps, Hkv, dh) pool.  The reference sent rows that must not
    write (past max_len, write_mask off, sentinel page) out of bounds and
    let ``mode="drop"`` discard them; torch has no drop mode, so each such
    row instead repeats the target and value of one fixed row (the first
    row that writes, else row 0, which then writes back its own current
    value).  Duplicate indices then carry identical values, and live rows
    never alias (they own disjoint pages), so the result is deterministic
    and needs no host sync."""
    n, ps = cache["k"].shape[0], cache["k"].shape[1]
    max_pages = page_table.shape[1]
    logical = (idx // ps).clamp(0, max_pages - 1).long()
    phys = page_table.gather(1, logical[:, None])[:, 0]
    ok = (idx >= 0) & (idx < max_pages * ps) & (phys >= 0) & (phys < n)
    if write_mask is not None:
        ok &= write_mask
    flat = phys.clamp(0, n - 1).long() * ps + (idx % ps).long()
    r0 = ok.int().argmax().reshape(1)   # 1-d: a 0-d index would sync
    tgt = torch.where(ok, flat, flat[r0])
    for name, new in (("k", k_new), ("v", v_new)):
        buf = cache[name].view((n * ps,) + tuple(cache[name].shape[2:]))
        val = torch.where(ok[:, None, None], new[:, 0], buf[flat])
        buf[tgt] = torch.where(ok[:, None, None], val, val[r0])


def _rolling_valid(smax: int, idx):
    """Decode mask of a rolling cache: before the buffer wraps, rows past
    ``idx`` are empty; once ``idx >= smax`` every row holds one of the
    last ``smax`` positions.  (Smax,) for a scalar ``idx``, else (B,
    Smax)."""
    j = torch.arange(smax, device=idx.device)
    if idx.dim() == 1:
        return (j[None, :] <= idx[:, None]) | (idx[:, None] >= smax)
    return (j <= idx) | (idx >= smax)


def _prefill_rolling(buf, new, window: int):
    """Land a prompt's k (or v) rows in a rolling buffer, in place: for
    ``s >= window`` the last ``window`` positions, rolled so position
    ``t`` sits at row ``t % window``; otherwise the prompt padded with
    zeros."""
    s = new.shape[1]
    if s >= window:
        idx0 = s - window
        buf.copy_(torch.roll(new[:, idx0:], idx0 % window, dims=1))
    else:
        buf[:, :s] = new
        buf[:, s:] = 0


def _self_attention(p, h, ctx: BlockCtx, window: int, cache):
    cfg = ctx.cfg
    q = project_q(p, h, cfg)
    k, v = project_kv(p, h, cfg)
    if cfg.pos != "none":
        q = apply_rope(q, ctx.positions, cfg)
        k = apply_rope(k, ctx.positions, cfg)
    on_card = kernel_route(h.device)

    if ctx.mode == "decode" and ctx.page_table is not None:
        _attn_cache_write_paged(cache, k, v, ctx.decode_idx, ctx.page_table,
                                write_mask=ctx.decode_write_mask)
        idx = ctx.decode_idx
        if on_card or ctx.ragged_kernel:
            out = paged_flash_decode_attention(
                q, cache["k"], cache["v"], ctx.page_table, idx.int(),
                softcap=cfg.attn_logit_softcap)
        else:
            ps = cache["k"].shape[1]
            out = attention_decode_paged(
                q, cache["k"], cache["v"], ctx.page_table, idx,
                page_size=ps, max_len=ctx.page_table.shape[1] * ps,
                softcap=cfg.attn_logit_softcap)
    elif ctx.mode == "decode":
        idx = ctx.decode_idx
        rolling = ctx.window_cache and window > 0
        _attn_cache_write(cache, k, v, idx,
                          write_mask=ctx.decode_write_mask,
                          window=window if rolling else 0)
        if rolling:
            # the reference's routing: rolling layers take plain decode
            # attention under the rolling mask, never the ragged kernel
            out = attention_decode(
                q, cache["k"], cache["v"], idx,
                valid_mask=_rolling_valid(cache["k"].shape[1], idx),
                softcap=cfg.attn_logit_softcap)
        elif window == 0 and (on_card or (ctx.ragged_kernel
                                          and idx.dim() == 1)):
            cur = idx.int().expand(q.shape[0]).contiguous()
            out = flash_decode_attention(q, cache["k"], cache["v"], cur,
                                         softcap=cfg.attn_logit_softcap)
        else:
            out = attention_decode(q, cache["k"], cache["v"], idx,
                                   window=window,
                                   softcap=cfg.attn_logit_softcap)
    else:
        out = ctx.attn_fn(q, k, v, causal=ctx.causal, window=window,
                          softcap=cfg.attn_logit_softcap)
        if ctx.mode == "prefill" and cache is not None:
            if ctx.window_cache and window > 0:
                _prefill_rolling(cache["k"], k, window)
                _prefill_rolling(cache["v"], v, window)
            else:
                # in place: the prompt rows of the (possibly longer) buffer
                s = k.shape[1]
                cache["k"][:, :s] = k
                cache["v"][:, :s] = v
    return project_out(p, out, h.dtype)


def _cross_attention(p, h, ctx: BlockCtx, cache):
    """Decoder cross-attention over the encoder's memory: no qkv bias, no
    RoPE, no mask.  In train and prefill k and v are projected from
    ``ctx.enc_out`` and attended non-causally (``ctx.attn_fn``: the flash
    kernel on the card); the prefill also writes them into the cross
    cache, in place (its length is the encoder's: ``fit_cross_cache``).
    A decode step attends over the whole cross cache, as the reference's
    ``attention_decode(q, k, v, Se - 1)`` does: on the card (or on the
    CPU with ``ragged_kernel``) through the ragged decode kernel with
    every row's length ``Se - 1``."""
    q = project_q(p, h, ctx.cfg)
    if ctx.mode != "decode":
        k, v = project_kv(p, ctx.enc_out, ctx.cfg)
        out = ctx.attn_fn(q, k, v, causal=False, window=0, softcap=0.0)
        if ctx.mode == "prefill" and cache is not None:
            cache["k"].copy_(k)
            cache["v"].copy_(v)
        return project_out(p, out, h.dtype)
    k, v = cache["k"], cache["v"]
    last = k.shape[1] - 1
    if kernel_route(h.device) or ctx.ragged_kernel:
        cur = torch.full((q.shape[0],), last, dtype=torch.int32,
                         device=q.device)
        out = flash_decode_attention(q, k, v, cur)
    else:
        out = attention_decode(q, k, v, last)
    return project_out(p, out, h.dtype)


def apply_block(p, x, desc: LayerDesc, ctx: BlockCtx, cache=None):
    """One block (attention or a recurrent cell, then cross-attention in
    an enc-dec decoder, then its FFN: dense, MoE or none); -> (x, aux):
    ``aux`` the MoE FFN's auxiliary loss (fp32 0-d), None for the other
    FFNs.  ``cache`` (the block's ``{"attn": {"k", "v"}}``, or ``{kind:
    state}`` for a recurrent block, and ``{"cross": {"k", "v"}}`` beside
    either) is updated in place."""
    cfg = ctx.cfg
    h = apply_norm(p["norm1"], x, cfg.norm)
    key = "attn" if desc.kind in ATTN_KINDS else desc.kind
    sub = cache[key] if cache is not None else None
    if desc.kind in ATTN_KINDS:
        window = cfg.attn_window if desc.kind == "attn_local" else 0
        x = x + _self_attention(p["attn"], h, ctx, window, sub)
    else:
        x = x + _RECURRENT[desc.kind][1](p[desc.kind], h, cfg, sub,
                                         step_active=ctx.step_active)
    if desc.cross:
        hc = apply_norm(p["norm_cross"], x, cfg.norm)
        x = x + _cross_attention(p["cross"], hc, ctx,
                                 cache["cross"] if cache is not None
                                 else None)
    if desc.ffn == "none":
        return x, None
    h2 = apply_norm(p["norm2"], x, cfg.norm)
    if desc.ffn == "moe":
        out, aux = apply_moe(p["moe"], h2, cfg, shard_fn=ctx.shard_fn)
        return x + out, aux
    return x + apply_ffn(p["ffn"], h2, cfg.act), None


# --------------------------------------------------------------------------
# Stack: prefix (unrolled) + body (a loop over the stacked layers axis)
# --------------------------------------------------------------------------

def stack_specs_tree(cfg: ArchConfig, plan: LayerPlan):
    prefix = [block_specs(cfg, d) for d in plan.prefix]
    period = [block_specs(cfg, d) for d in plan.period]
    body = [stack_specs(s, plan.n_periods) for s in period]
    return {"prefix": prefix, "body": body}


def init_stack_cache(cfg: ArchConfig, plan: LayerPlan, batch: int,
                     max_len: int, enc_len: int = 0,
                     window_cache: bool = False, page_size: int = 0,
                     n_pages: int = 0, device=None):
    """Zeroed cache for the whole stack.  ``window_cache`` sizes the
    rolling caches of sliding-window layers at ``min(max_len, window)``.
    ``page_size > 0`` selects the paged layout: each attention layer's
    k/v become ``(n_pages, page_size, Hkv, dh)`` physical pages with no
    batch axis.  Cross-attention layers add ``"cross"`` k/v of
    ``(batch, enc_len, Hkv, dh)``."""
    dt = compute_dtype(cfg)

    def kv(shape, lead):
        return {"k": torch.zeros(lead + shape, dtype=dt, device=device),
                "v": torch.zeros(lead + shape, dtype=dt, device=device)}

    def one(desc: LayerDesc, lead=()):
        if desc.kind not in ATTN_KINDS:
            c = {desc.kind: _RECURRENT[desc.kind][2](cfg, batch, lead,
                                                     device)}
        else:
            window = cfg.attn_window if desc.kind == "attn_local" else 0
            if page_size > 0:
                assert not (window_cache and window), \
                    "paged cache excludes rolling-window layers"
                shape = (n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
            else:
                s = min(max_len, window) if (window_cache and window) \
                    else max_len
                shape = (batch, s, cfg.n_kv_heads, cfg.head_dim)
            c = {"attn": kv(shape, lead)}
        if desc.cross:
            c["cross"] = kv((batch, enc_len, cfg.n_kv_heads, cfg.head_dim),
                            lead)
        return c

    return {"prefix": [one(d) for d in plan.prefix],
            "body": [one(d, (plan.n_periods,)) for d in plan.period]}


def fit_cross_cache(stack, enc_len: int) -> None:
    """Give every cross-attention cache of ``stack`` the encoder's length,
    in place: a leaf of another length (``init_cache`` was given another
    ``enc_len``) is replaced by zeros of ``enc_len`` rows, as the
    reference's prefill replaces the leaf with the encoder's k and v."""
    for group in ("prefix", "body"):
        for block in stack[group]:
            cross = block.get("cross")
            if cross is None:
                continue
            axis = 1 if group == "prefix" else 2
            for name, leaf in cross.items():
                if leaf.shape[axis] != enc_len:
                    shape = list(leaf.shape)
                    shape[axis] = enc_len
                    cross[name] = leaf.new_zeros(shape)


def _layer(tree, i: int):
    """Views of layer ``i`` of a stacked body tree."""
    return tree_map(lambda a: a[i], tree, torch.is_tensor)


def _remat_group(n_periods: int) -> int:
    """Largest divisor of n_periods not exceeding sqrt(n_periods) (1
    below 4 periods): the periods one outer checkpoint holds."""
    if n_periods < 4:
        return 1
    best = 1
    d = 1
    while d * d <= n_periods:
        if n_periods % d == 0:
            best = d
        d += 1
    return best


def _add_aux(total, aux):
    if aux is None:
        return total
    return aux if total is None else total + aux


def _checkpointed(fn):
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def apply_stack(params, x, cfg: ArchConfig, plan: LayerPlan, ctx: BlockCtx,
                cache=None, remat: bool = False):
    """-> (x, aux_sum): ``aux_sum`` the MoE blocks' auxiliary losses summed
    (fp32 0-d), None when no block has one.  The cache (same tree as
    ``init_stack_cache``) is updated in place.

    With ``remat`` in train mode the stack checkpoints as the reference
    does: each prefix block; each period, and within a period of more
    than one block each block (nested); and, from 4 periods on, groups of
    ``_remat_group(n_periods)`` periods under one more checkpoint.  The
    backward then keeps only checkpoint inputs and recomputes the rest
    (``remat_forward_counts`` says how often each block runs).

    The residual stream goes through ``ctx.shard_fn(x, "batch", "seq",
    None)`` on entry and after every block, as the reference constrains
    it (batch over the data axes; seq over "model" under sequence
    parallelism)."""
    train_remat = remat and ctx.mode == "train"
    aux = None
    shard_fn = ctx.shard_fn

    def block(p, desc, c):
        def run(xx):
            xx, a = apply_block(p, xx, desc, ctx, c)
            return shard_fn(xx, "batch", "seq", None), a
        return run

    x = shard_fn(x, "batch", "seq", None)

    for i, desc in enumerate(plan.prefix):
        c = cache["prefix"][i] if cache is not None else None
        fn = block(params["prefix"][i], desc, c)
        if train_remat:
            fn = _checkpointed(fn)
        x, a = fn(x)
        aux = _add_aux(aux, a)

    def period(xx, layer):
        total = None
        for pos, desc in enumerate(plan.period):
            c = (_layer(cache["body"][pos], layer) if cache is not None
                 else None)
            fn = block(_layer(params["body"][pos], layer), desc, c)
            if train_remat and len(plan.period) > 1:
                fn = _checkpointed(fn)
            xx, a = fn(xx)
            total = _add_aux(total, a)
        return xx, total

    if not train_remat:
        for layer in range(plan.n_periods):
            x, a = period(x, layer)
            aux = _add_aux(aux, a)
        return x, aux
    group = _remat_group(plan.n_periods)

    def periods(xx, first):
        total = None
        for layer in range(first, first + group):
            xx, a = _checkpointed(period)(xx, layer)
            total = _add_aux(total, a)
        return xx, total

    for first in range(0, plan.n_periods, group):
        if group > 1:
            x, a = _checkpointed(periods)(x, first)
        else:
            x, a = periods(x, first)
        aux = _add_aux(aux, a)
    return x, aux


def remat_forward_counts(plan: LayerPlan, remat: bool = True) -> list:
    """How many times each layer's forward runs in one training step of
    ``apply_stack`` (layer order): 1, plus one recompute per checkpoint
    that encloses the layer and is recomputed as far as the layer.

    The checkpoints are non-reentrant with early stop (torch's default):
    a checkpoint's recompute stops once it has rebuilt every tensor it
    saved, the last being the inputs of its last child checkpoint, so the
    last child of a region does not run in that region's recompute; a
    block's own checkpoint reruns the whole block.  The RG-LRU scan of a
    block is called this many times forward plus once backward."""
    n_body = len(plan.period) * plan.n_periods
    if not remat:
        return [1] * (len(plan.prefix) + n_body)
    counts = [2] * len(plan.prefix)
    group = _remat_group(plan.n_periods)
    nested = len(plan.period) > 1
    for layer in range(plan.n_periods):
        last_in_group = layer % group == group - 1
        for pos in range(len(plan.period)):
            n = 2                                   # forward, own recompute
            if nested and pos < len(plan.period) - 1:
                n += 1                              # the period's recompute
            if group > 1 and not last_in_group:
                n += 1                              # the group's recompute
            counts.append(n)
    return counts
