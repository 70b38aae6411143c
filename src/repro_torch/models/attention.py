"""GQA attention in plain PyTorch: reference, chunked (streaming softmax)
and cached decode paths, mirroring ``repro.models.attention``.

On the card, prefill attention runs the flash kernel
(``kernels.flash_attention.ops.flash_attention``, the port of
``flash_attention_bhsd``) at every length; on the CPU it keeps the
reference's choice of ``attention_reference`` or ``attention_chunked``
(``select_attention``), which stay as the CPU path and the oracles.
Training takes the reference's choice on both devices, differentiably
(``attention_chunked`` checkpoints each kv step, as the reference does).
Decode attention on the card goes through the decode kernel wrappers in
``kernels.flash_attention.ops``; ``attention_decode`` and
``attention_decode_paged`` are the model-side oracles they are held to.
"""

from __future__ import annotations

from functools import partial

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import ref
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.params import ParamSpec

NEG_INF = -1e30


def attn_specs(cfg: ArchConfig, cross: bool = False):
    d, dh = cfg.d_model, cfg.head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    specs = {
        "wq": ParamSpec((d, hq, dh), ("embed", "q_heads", "head_dim"),
                        fan_in=d),
        "wk": ParamSpec((d, hkv, dh), ("embed", "kv_heads", "head_dim"),
                        fan_in=d),
        "wv": ParamSpec((d, hkv, dh), ("embed", "kv_heads", "head_dim"),
                        fan_in=d),
        "wo": ParamSpec((hq, dh, d), ("q_heads", "head_dim", "embed"),
                        fan_in=hq * dh),
    }
    if cfg.qkv_bias and not cross:
        specs["bq"] = ParamSpec((hq, dh), ("q_heads", "head_dim"),
                                init="zeros")
        specs["bk"] = ParamSpec((hkv, dh), ("kv_heads", "head_dim"),
                                init="zeros")
        specs["bv"] = ParamSpec((hkv, dh), ("kv_heads", "head_dim"),
                                init="zeros")
    return specs


def _proj(x, w):
    """einsum("bsd,dhk->bshk") as one matmul."""
    d, h, k = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * k)).unflatten(-1, (h, k))


def project_q(p, x, cfg: ArchConfig):
    q = _proj(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
    return q


def project_kv(p, x, cfg: ArchConfig):
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if "bk" in p:
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return k, v


def project_out(p, out, dtype):
    """einsum("bshk,hkd->bsd") as one matmul."""
    h, k, d = p["wo"].shape
    return out.flatten(-2) @ p["wo"].to(dtype).reshape(h * k, d)


def _softcap(s, cap: float):
    return torch.tanh(s / cap) * cap if cap > 0 else s


def _valid(q_pos, k_pos, causal: bool, window: int):
    valid = torch.ones(q_pos.shape[-1:] + k_pos.shape[-1:],
                       dtype=torch.bool, device=q_pos.device)
    if causal:
        valid &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        valid &= k_pos[None, :] > q_pos[:, None] - window
    return valid


def attention_reference(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, q_offset: int = 0):
    """Full-score attention.  q: (B,Sq,Hq,dh); k/v: (B,Sk,Hkv,dh)."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qh = q.reshape(b, sq, hkv, g, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qh.float(), k.float()) \
        * dh ** -0.5
    s = _softcap(s, softcap)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    k_pos = torch.arange(sk, device=q.device)
    bias = torch.zeros((sq, sk), dtype=torch.float32, device=q.device)
    bias = bias.masked_fill(~_valid(q_pos, k_pos, causal, window), NEG_INF)
    p = torch.softmax(s + bias, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(b, sq, hq, dh).to(q.dtype)


def _kv_step(acc, m, l, q_i, k_j, v_j, q_pos, k_pos, *, causal, window,
             softcap):
    """One kv block of the streaming softmax: -> (acc, m, l)."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", q_i, k_j.float())
    s = _softcap(s, softcap)
    s = s.masked_fill(~_valid(q_pos, k_pos, causal, window), NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(-1)
    acc = acc * alpha[..., None] + torch.einsum(
        "bhgqk,bkhd->bhgqd", p, v_j.float())
    return acc, m_new, l


def attention_chunked(q, k, v, *, causal: bool = True, window: int = 0,
                      softcap: float = 0.0, q_block: int = 512,
                      kv_block: int = 1024, q_offset: int = 0,
                      skip_future_blocks: bool = False):
    """Streaming-softmax attention over (q_block, kv_block) tiles; never
    holds more than (B, Hq, q_block, kv_block) scores.  With
    ``skip_future_blocks`` only the causally reachable kv prefix of each
    q block is visited.

    The reference asserts ``q_block | Sq`` and ``kv_block | Sk``; here the
    last q and kv blocks may be short, so an exact-length prefill of any
    prompt length runs (where the blocks divide, the tiles and their sums
    are the reference's)."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    q_block = min(q_block, sq)
    kv_block = min(kv_block, sk)
    nq, nk = -(-sq // q_block), -(-sk // kv_block)
    scale = dh ** -0.5
    # the reference checkpoints every kv step: a backward recomputes the
    # step's (q_block, kv_block) scores instead of keeping them
    differentiable = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    outs = []
    for qi in range(nq):
        q0, q1 = qi * q_block, min((qi + 1) * q_block, sq)
        q_i = q[:, q0:q1].reshape(b, q1 - q0, hkv, g, dh).float() * scale
        q_pos = q_offset + torch.arange(q0, q1, device=q.device)
        acc = torch.zeros((b, hkv, g, q1 - q0, dh), dtype=torch.float32,
                          device=q.device)
        m = torch.full((b, hkv, g, q1 - q0), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        n_kv = nk
        if skip_future_blocks and causal and q_offset == 0:
            n_kv = min(nk, (qi * q_block + q_block + kv_block - 1)
                       // kv_block)
        for kj in range(n_kv):
            k0, k1 = kj * kv_block, min((kj + 1) * kv_block, sk)
            step_args = (acc, m, l, q_i, k[:, k0:k1], v[:, k0:k1], q_pos,
                         torch.arange(k0, k1, device=q.device))
            if differentiable:
                acc, m, l = checkpoint(_kv_step, *step_args, causal=causal,
                                       window=window, softcap=softcap,
                                       use_reentrant=False)
            else:
                acc, m, l = _kv_step(*step_args, causal=causal,
                                     window=window, softcap=softcap)
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, q1 - q0, hq, dh))
    return torch.cat(outs, dim=1).to(q.dtype)


def attention_decode(q, k_cache, v_cache, cur_index, *, window: int = 0,
                     softcap: float = 0.0, valid_mask=None):
    """Single-token decode vs a cache.  q: (B,1,Hq,dh); k_cache/v_cache:
    (B,Smax,Hkv,dh); cur_index: scalar — the position being written
    (attends to [0, cur_index]) — or (B,) per-slot positions.
    ``valid_mask`` (Smax,) or (B,Smax) overrides the index mask."""
    b, _, hq, dh = q.shape
    smax, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    qh = q.reshape(b, hkv, g, dh).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qh, k_cache.float())
    s = _softcap(s * dh ** -0.5, softcap)
    if valid_mask is None:
        k_pos = torch.arange(smax, device=q.device)
        idx = torch.as_tensor(cur_index, device=q.device)
        if idx.dim() == 1:
            valid = k_pos[None, :] <= idx[:, None]
            if window > 0:
                valid &= k_pos[None, :] > idx[:, None] - window
        else:
            valid = k_pos <= idx
            if window > 0:
                valid &= k_pos > idx - window
    else:
        valid = valid_mask
    vb = valid[:, None, None, :] if valid.dim() == 2 \
        else valid[None, None, None, :]
    s = s.masked_fill(~vb, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return out.reshape(b, 1, hq, dh).to(q.dtype)


def gather_pages(pages, page_table, page_size: int, max_len: int):
    """Contiguous (B, max_len, Hkv, dh) view of a paged cache; sentinel
    entries (== N) clip to the last real page, whose rows sit past every
    sequence's valid length.  The paged kernel's plain version gathers
    the same way; ``page_size`` and ``max_len`` follow from the shapes."""
    assert page_table.shape[1] * page_size == max_len, (page_size, max_len)
    return ref.gather_pages(pages, page_table)


def attention_decode_paged(q, k_pages, v_pages, page_table, cur_index, *,
                           page_size: int, max_len: int,
                           softcap: float = 0.0):
    """Single-token decode vs a paged cache: gather the slot's pages
    into the contiguous layout and defer to ``attention_decode``."""
    kg = gather_pages(k_pages, page_table, page_size, max_len)
    vg = gather_pages(v_pages, page_table, page_size, max_len)
    return attention_decode(q, kg, vg, cur_index, softcap=softcap)


def kernel_route(device: torch.device) -> bool:
    """Whether attention on ``device`` takes the card's route, the kernel
    wrappers: CUDA tensors launch the kernels, and meta tensors (shapes
    only: the dry run of a cell on the card) go the same way, to the
    wrappers' plain versions."""
    return device.type in ("cuda", "meta")


def select_attention(cfg: ArchConfig, seq_len: int,
                     skip_future: bool = False, on_card: bool = False):
    """With ``on_card``, the flash kernel's wrapper at every length;
    otherwise as the reference picks: chunked attention for long
    sequences, the full-score reference for short ones.  Training passes
    ``on_card=False`` on both devices: the reference never trains
    through its kernel, and the flash kernel is forward only."""
    if on_card:
        return flash_attention
    if seq_len >= 1024:
        return partial(attention_chunked,
                       q_block=min(512, seq_len),
                       kv_block=min(1024, seq_len),
                       skip_future_blocks=skip_future)
    return attention_reference
