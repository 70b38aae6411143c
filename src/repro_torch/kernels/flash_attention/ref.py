"""Plain PyTorch versions of the attention kernels.

Same functions as the CUDA kernels in ``csrc/``, in the same (B, S, H,
dh) layouts.  The decode versions follow the kernels' order of scaling:
q is scaled by ``dh**-0.5`` before the dot product (the model-side oracle
``attention_decode`` scales the scores instead; the two agree to fp32
rounding).  ``flash_attention_ref`` is ``repro``'s ``attention_ref``
(``repro/kernels/flash_attention/ref.py``), which scales the scores.
The CPU tests run these, and ``chip_smoke.py`` holds the kernels against
them on the card.  Nothing on the card's main path calls them.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def ragged_decode_ref(q, k_cache, v_cache, cur_index, *,
                      softcap: float = 0.0):
    """q: (B, 1, Hq, dh); k/v: (B, Smax, Hkv, dh); cur_index: (B,) int —
    row b attends to cache positions [0, cur_index[b]] (all of them when
    cur_index[b] >= Smax).  Query head h uses kv head h // G.
    -> (B, 1, Hq, dh) in q's dtype."""
    b, _, hq, dh = q.shape
    smax, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    qh = q.reshape(b, hkv, g, dh).float() * dh ** -0.5
    s = torch.einsum("bhgd,bkhd->bhgk", qh, k_cache.float())
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    k_pos = torch.arange(smax, device=q.device)
    valid = k_pos[None, :] <= cur_index.to(q.device)[:, None].long()
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return out.reshape(b, 1, hq, dh).to(q.dtype)


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0):
    """q: (B, Sq, Hq, dh); k/v: (B, Sk, Hkv, dh) -> (B, Sq, Hq, dh) in q's
    dtype.  Query head h uses kv head h // G; key j is visible to query i
    when ``j <= i`` (causal) and ``j > i - window`` (window > 0); fp32
    scores, softmax and product."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    qh = q.reshape(b, sq, hkv, hq // hkv, dh).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qh, k.float()) * dh ** -0.5
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    valid = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        valid &= k_pos <= q_pos
    if window > 0:
        valid &= k_pos > q_pos - window
    p = torch.softmax(s.masked_fill(~valid, NEG_INF), dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(b, sq, hq, dh).to(q.dtype)


def gather_pages(pages, page_table):
    """(N, ps, Hkv, dh) physical pages -> (B, max_pages * ps, Hkv, dh)
    contiguous view; sentinel entries (== N) clip to the last real page."""
    n, ps = pages.shape[0], pages.shape[1]
    pt = page_table.long().clamp(0, n - 1)
    g = pages[pt]                       # (B, max_pages, ps, Hkv, dh)
    b, max_pages = page_table.shape
    return g.reshape((b, max_pages * ps) + tuple(pages.shape[2:]))


def paged_decode_ref(q, k_pages, v_pages, page_table, cur_index, *,
                     softcap: float = 0.0):
    """q: (B, 1, Hq, dh); k/v pages: (N, ps, Hkv, dh); page_table:
    (B, max_pages) int — logical page j of row b is physical page
    ``page_table[b, j]`` (sentinel N clips to N-1); cur_index: (B,).
    -> (B, 1, Hq, dh) in q's dtype."""
    kg = gather_pages(k_pages, page_table)
    vg = gather_pages(v_pages, page_table)
    return ragged_decode_ref(q, kg, vg, cur_index, softcap=softcap)
