"""Attention kernel wrappers: (B, S, H, dh) layouts.

``flash_attention`` (prefill), ``flash_decode_attention`` and
``paged_flash_decode_attention`` keep the reference's names and
signatures (``repro.kernels.flash_attention.ops``, without
``interpret``).  For a CUDA tensor each builds (at first use) and
launches its hand-written CUDA kernel on the current stream, or raises:
there is no fallback.  For a CPU tensor each runs its plain PyTorch
version (``ref.py``).  Each wrapper counts its kernel launches in
``LAUNCHES``: one per wrapper call, though a decode call is two CUDA
launches (the split pass and the combine pass).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import (flash_attention_ref,
                                                     paged_decode_ref,
                                                     ragged_decode_ref)

#: kernel launches since the last ``reset_launch_counts()``; plain-version
#: calls on CPU tensors do not count
LAUNCHES = {"ragged_decode": 0, "paged_decode": 0, "flash_attention": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_DH = 256         # the largest head_dim of every attention kernel
#: keys of a row that one split block of a decode kernel owns
DECODE_CHUNK = 128


def decode_splits(capacity: int):
    """-> (keys per split, splits) of a decode call over a cache of
    ``capacity`` keys a row (Smax, or max_pages * page_size).  Only the
    capacity decides, never a row's length, so the grid needs no host
    sync and a CUDA graph can capture the launch; chunk boundaries depend
    on the key index alone, so both decode kernels sum every key in the
    same order."""
    return DECODE_CHUNK, max(1, -(-capacity // DECODE_CHUNK))


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_common(q, k, v, cur_index, name):
    if q.device.type != "cuda":
        raise RuntimeError(f"{name}: tensors on {q.device} have no kernel; "
                           f"the plain version serves only CPU tensors")
    for t, what in ((k, "k"), (v, "v"), (cur_index, "cur_index")):
        if t.device != q.device:
            raise ValueError(f"{name}: {what} on {t.device}, q on "
                             f"{q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {q.dtype} not supported "
                        f"(float32, bfloat16)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q/k/v dtypes differ ({q.dtype}, "
                        f"{k.dtype}, {v.dtype})")
    if q.dim() != 4 or q.shape[1] != 1 or not q.is_contiguous():
        raise ValueError(f"{name}: q must be a contiguous (B, 1, Hq, dh) "
                         f"tensor, got {tuple(q.shape)}")
    if k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: k/v shapes {tuple(k.shape)} / "
                         f"{tuple(v.shape)}")
    if k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError(f"{name}: k/v head_dim must be contiguous")
    b, _, hq, dh = q.shape
    hkv = k.shape[2]
    if k.shape[3] != dh or hq % hkv:
        raise ValueError(f"{name}: q {tuple(q.shape)} vs k "
                         f"{tuple(k.shape)}")
    if not 0 < dh <= _MAX_DH:
        raise ValueError(f"{name}: needs 0 < dh <= {_MAX_DH}, got {dh}")
    if cur_index.shape != (b,) or cur_index.dtype != torch.int32 \
            or not cur_index.is_contiguous():
        raise ValueError(f"{name}: cur_index must be a contiguous ({b},) "
                         f"int32 tensor")
    return b, hq // hkv, hkv, dh


def _decode_launch_args(q, k, v, capacity):
    """The arguments every decode launch shares: the output, the fp32
    workspace of the split partials, k's and v's strides over their first
    three dimensions (0 for a dimension of size 1, which is never stepped
    over), the chunk, the split count and whether q, K and V allow
    16-byte loads (then bf16 with dh <= 64 runs on the tensor cores)."""
    b, _, hq, dh = q.shape
    chunk, n_split = decode_splits(capacity)
    ws = torch.empty(b * hq * n_split * (dh + 2), dtype=torch.float32,
                     device=q.device)
    strides = [s if n > 1 else 0 for t in (k, v)
               for n, s in zip(t.shape[:3], t.stride()[:3])]
    vec = 16 // q.element_size()
    wide = dh % vec == 0 and all(s % vec == 0 for s in strides) and \
        all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    return torch.empty_like(q), ws, strides, chunk, n_split, int(wide)


def flash_decode_attention(q, k_cache, v_cache, cur_index, *,
                           softcap: float = 0.0):
    """Ragged-length decode attention over a contiguous per-slot cache.

    q: (B, 1, Hq, dh); k_cache/v_cache: (B, Smax, Hkv, dh); cur_index:
    (B,) int32 — row b attends to positions [0, cur_index[b]].
    -> (B, 1, Hq, dh) in q's dtype."""
    if q.device.type == "cpu":
        return ragged_decode_ref(q, k_cache, v_cache, cur_index,
                                 softcap=softcap)
    b, g, hkv, dh = _check_common(q, k_cache, v_cache, cur_index,
                                  "ragged_decode")
    lib = build.load("ragged_decode")
    smax = k_cache.shape[1]
    out, ws, strides, chunk, n_split, wide = _decode_launch_args(
        q, k_cache, v_cache, smax)
    with torch.cuda.device(q.device):       # the launch uses the current device
        code = lib.ragged_decode(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            cur_index.data_ptr(), out.data_ptr(), ws.data_ptr(), b, hkv, g,
            dh, smax, *strides, dh ** -0.5, float(softcap), chunk, n_split,
            wide, _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, "ragged_decode", code)
    LAUNCHES["ragged_decode"] += 1
    return out


def paged_flash_decode_attention(q, k_pages, v_pages, page_table,
                                 cur_index, *, softcap: float = 0.0):
    """Page-table decode attention over a paged KV cache.

    q: (B, 1, Hq, dh); k_pages/v_pages: (N, page_size, Hkv, dh) physical
    pages; page_table: (B, max_pages) int32 — logical page j of row b is
    physical page ``page_table[b, j]`` (sentinel N = unmapped, clipped to
    N-1); cur_index: (B,) int32.  -> (B, 1, Hq, dh)."""
    if q.device.type == "cpu":
        return paged_decode_ref(q, k_pages, v_pages, page_table, cur_index,
                                softcap=softcap)
    b, g, hkv, dh = _check_common(q, k_pages, v_pages, cur_index,
                                  "paged_decode")
    if page_table.device != q.device or page_table.dtype != torch.int32 \
            or page_table.dim() != 2 or page_table.shape[0] != b \
            or not page_table.is_contiguous():
        raise ValueError("paged_decode: page_table must be a contiguous "
                         f"({b}, max_pages) int32 tensor on {q.device}")
    lib = build.load("paged_decode")
    n_pages, ps = k_pages.shape[:2]
    max_pages = page_table.shape[1]
    out, ws, strides, chunk, n_split, wide = _decode_launch_args(
        q, k_pages, v_pages, max_pages * ps)
    with torch.cuda.device(q.device):       # the launch uses the current device
        code = lib.paged_decode(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), cur_index.data_ptr(), out.data_ptr(),
            ws.data_ptr(), b, hkv, g, dh, ps, n_pages, max_pages, *strides,
            dh ** -0.5, float(softcap), chunk, n_split, wide,
            _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, "paged_decode", code)
    LAUNCHES["paged_decode"] += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, q_block: int = 512,
                    kv_block: int = 1024):
    """Prefill attention.  q: (B, Sq, Hq, dh); k/v: (B, Sk, Hkv, dh) ->
    (B, Sq, Hq, dh) in q's dtype, contiguous.  Any Sq, Sk >= 1; q, k and
    v may be strided views with a contiguous head_dim (in bf16, which runs
    on the tensor cores, with dh and every stride a multiple of 8 and
    16-byte aligned data: the views of a fused projection are).
    ``q_block`` and ``kv_block`` are the reference's tiling; the result
    does not depend on them, and the kernel keeps its own tiles.  Forward
    only: on the card an input that requires grad raises."""
    del q_block, kv_block
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: tensors on {q.device} have no "
                           f"kernel; the plain version serves only CPU "
                           f"tensors")
    for t, what in ((k, "k"), (v, "v")):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {what} on {t.device}, q on "
                             f"{q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: dtype {q.dtype} not supported "
                        f"(float32, bfloat16)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q/k/v dtypes differ ({q.dtype}, "
                        f"{k.dtype}, {v.dtype})")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise RuntimeError("flash_attention: the kernel is forward only; an "
                           "input requires grad")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != dh or hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} vs k "
                         f"{tuple(k.shape)}")
    if not (0 < dh <= _MAX_DH and sq > 0 and sk > 0 and b * hq > 0):
        raise ValueError(f"flash_attention: needs 0 < dh <= {_MAX_DH}, "
                         f"Sq, Sk > 0 and B*Hq > 0; q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_attention: q/k/v head_dim must be "
                         "contiguous")
    # a dimension of size 1 is never stepped over: its stride is 0 here
    strides = [s if n > 1 else 0 for t in (q, k, v)
               for n, s in zip(t.shape[:3], t.stride()[:3])]
    if q.dtype == torch.bfloat16 and (
            dh % 8 or any(s % 8 for s in strides)
            or any(t.data_ptr() % 16 for t in (q, k, v))):
        raise ValueError("flash_attention: the bf16 kernel copies rows in "
                         "16-byte pieces; it needs dh % 8 == 0, strides "
                         "that are multiples of 8 and 16-byte aligned "
                         f"q/k/v (dh {dh}, strides {strides})")
    lib = build.load("flash_attention")
    out = torch.empty((b, sq, hq, dh), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):       # the launch uses the current device
        code = lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
            sk, hq, hkv, dh, *strides, dh ** -0.5, float(softcap),
            int(bool(causal)), int(window), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, "flash_attention", code)
    LAUNCHES["flash_attention"] += 1
    return out
