"""The decode kernels' split-KV algorithm, emulated in plain PyTorch on the
CPU, against the kernels' plain versions and the JAX reference.

The CUDA decode kernels (``csrc/decode_common.cuh``) cut each row's live
keys into chunks of ``ops.decode_splits(capacity)[0]`` keys, reduce each
chunk to an fp32 partial (m, l, acc) under the reference's finite -1e30
mask, and merge a row's partials in split order.  ``split_emulation``
below repeats that algorithm chunk by chunk (not the lanes and warps
inside a chunk), so these tests hold the algorithm, its chunk edges and
its empty and retired rows where a CPU can run them; the kernels
themselves are held to the plain versions on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).

Inputs come from numpy with a seed.  Tolerance: ``FP32_TOL`` = 5e-5
absolute, as on the card: the same fp32 arithmetic as the plain versions,
summed in another order; the reference's Pallas kernels run with
``interpret=True``, as its own kernel tests run them.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import (flash_decode_attention,
                                               paged_flash_decode_attention)
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (NEG_INF, gather_pages,
                                                     paged_decode_ref,
                                                     ragged_decode_ref)

FP32_TOL = 5e-5
CHUNK = ops.decode_splits(1)[0]


def split_emulation(q, k, v, cur, *, softcap=0.0):
    """q: (B, 1, Hq, dh); k/v: (B, S, Hkv, dh); cur: (B,) -> (B, 1, Hq,
    dh) in q's dtype.  Row b's keys [0, n_keys) (n_keys = min(cur, S-1) +
    1, 0 for cur < 0) are cut at multiples of the chunk; each live chunk
    gives (m, l, acc) over its keys with positions past n_keys masked to
    -1e30; the partials merge in split order; out = acc / max(l, 1e-30)."""
    b, _, hq, dh = q.shape
    cap, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    chunk, n_split = ops.decode_splits(cap)
    qh = q.reshape(b, hkv, g, dh).float() * dh ** -0.5
    out = torch.zeros((b, hkv, g, dh))
    for row in range(b):
        c = int(cur[row])
        n_keys = 0 if c < 0 else min(c, cap - 1) + 1
        n_live = -(-n_keys // chunk)
        assert n_live <= n_split
        parts = []
        for s in range(n_live):
            c0, c1 = s * chunk, min((s + 1) * chunk, cap)
            sc = torch.einsum("hgd,nhd->hgn", qh[row], k[row, c0:c1].float())
            if softcap > 0:
                sc = torch.tanh(sc / softcap) * softcap
            sc = sc.masked_fill(torch.arange(c0, c1) >= n_keys, NEG_INF)
            m = sc.amax(-1)
            p = torch.exp(sc - m[..., None])
            parts.append((m, p.sum(-1), torch.einsum(
                "hgn,nhd->hgd", p, v[row, c0:c1].float())))
        lsum, acc = torch.zeros((hkv, g)), torch.zeros((hkv, g, dh))
        if parts:
            top = torch.stack([m for m, _, _ in parts]).amax(0)
            for m, part_l, part_acc in parts:
                w = torch.exp(m - top)
                lsum = lsum + part_l * w
                acc = acc + part_acc * w[..., None]
        out[row] = acc / lsum.clamp_min(1e-30)[..., None]
    return out.reshape(b, 1, hq, dh).to(q.dtype)


def paged_split_emulation(q, k_pages, v_pages, page_table, cur, *,
                          softcap=0.0):
    """The same algorithm over a paged cache: key t of row b read from
    page ``page_table[b, t // ps]`` (sentinels clipped to N-1)."""
    return split_emulation(q, gather_pages(k_pages, page_table),
                           gather_pages(v_pages, page_table), cur,
                           softcap=softcap)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


#: lengths (cur) of the B rows: empty prefix of one key, both sides of
#: the first and second chunk edges, the last position, retired slots
def _lengths(smax):
    return [0, CHUNK - 1, CHUNK, CHUNK + 1, 2 * CHUNK - 1, smax - 1, smax,
            5000]


def _close(out, expect):
    expect = torch.from_numpy(np.array(expect))
    assert (out - expect).abs().max().item() <= FP32_TOL


def test_decode_splits_reads_only_the_capacity():
    assert list(inspect.signature(ops.decode_splits).parameters) == \
        ["capacity"]
    for cap in (1, CHUNK - 1, CHUNK, CHUNK + 1, 1024, 4096):
        chunk, n_split = ops.decode_splits(cap)
        assert chunk == CHUNK
        assert (n_split - 1) * chunk < cap <= n_split * chunk
    # qwen2-0.5b's caches: at least 64 blocks at Smax 1024 and 256 at
    # 4096 over its B * Hkv = 16 (row, kv head) pairs
    assert 16 * ops.decode_splits(1024)[1] >= 64
    assert 16 * ops.decode_splits(4096)[1] >= 256


@pytest.mark.parametrize("g", [1, 3, 7])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_ragged_split_matches_plain_and_pallas(g, softcap):
    b, hkv, dh, smax = 8, 2, 16, 4 * CHUNK
    rng = np.random.default_rng(10 * g + int(softcap))
    q = _rand(rng, b, 1, hkv * g, dh)
    k, v = _rand(rng, b, smax, hkv, dh), _rand(rng, b, smax, hkv, dh)
    cur = np.asarray(_lengths(smax), np.int32)
    args = [torch.from_numpy(a) for a in (q, k, v, cur)]
    out = split_emulation(*args, softcap=softcap)
    assert out.shape == (b, 1, hkv * g, dh) and torch.isfinite(out).all()
    _close(out, ragged_decode_ref(*args, softcap=softcap))
    _close(out, flash_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(cur),
        softcap=softcap, interpret=True))


def test_ragged_split_at_qwen2_width():
    """G = 7, dh = 64, one row ending on each side of several chunk edges
    of a longer cache."""
    b, hkv, g, dh, smax = 4, 2, 7, 64, 8 * CHUNK
    rng = np.random.default_rng(3)
    q = _rand(rng, b, 1, hkv * g, dh)
    k, v = _rand(rng, b, smax, hkv, dh), _rand(rng, b, smax, hkv, dh)
    cur = np.asarray([3 * CHUNK - 1, 5 * CHUNK, 6 * CHUNK + 1, smax - 2],
                     np.int32)
    args = [torch.from_numpy(a) for a in (q, k, v, cur)]
    out = split_emulation(*args)
    _close(out, ragged_decode_ref(*args))
    _close(out, flash_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(cur),
        interpret=True))


def test_a_row_with_no_keys_gives_zeros():
    """cur < 0 (no live key): no partial, so 0 / max(0, 1e-30) = 0, as
    the reference kernel gives (it skips every block of such a row)."""
    rng = np.random.default_rng(4)
    q, k = _rand(rng, 2, 1, 4, 16), _rand(rng, 2, CHUNK, 2, 16)
    cur = np.asarray([-1, 5], np.int32)
    out = split_emulation(*(torch.from_numpy(a) for a in (q, k, k, cur)))
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    _close(out, flash_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(k), jnp.asarray(cur),
        kv_block=CHUNK, interpret=True))


def _paged_case(seed, ps, g, max_len, hkv=2, dh=16):
    """A tight pool: each live row maps just the pages its length needs,
    drawn scrambled from one permutation; retired rows (cur >= max_len)
    map nothing, so their whole table is the sentinel N."""
    rng = np.random.default_rng(seed)
    cur = np.asarray(_lengths(max_len), np.int32)
    b, max_pages = len(cur), max_len // ps
    mapped = [0 if c >= max_len else c // ps + 1 for c in cur]
    n_pages = sum(mapped)
    perm = rng.permutation(n_pages)
    pt = np.full((b, max_pages), n_pages, np.int32)
    at = 0
    for row, m in enumerate(mapped):
        pt[row, :m] = perm[at:at + m]
        at += m
    q = _rand(rng, b, 1, hkv * g, dh)
    kp = _rand(rng, n_pages, ps, hkv, dh)
    vp = _rand(rng, n_pages, ps, hkv, dh)
    return q, kp, vp, pt, cur


@pytest.mark.parametrize("ps", [8, 16, 64])
@pytest.mark.parametrize("g,softcap", [(1, 0.0), (3, 30.0), (7, 0.0)])
def test_paged_split_matches_plain_and_pallas(ps, g, softcap):
    q, kp, vp, pt, cur = _paged_case(ps + g, ps, g, 2 * CHUNK + 64)
    args = [torch.from_numpy(a) for a in (q, kp, vp, pt, cur)]
    out = paged_split_emulation(*args, softcap=softcap)
    assert torch.isfinite(out).all()
    _close(out, paged_decode_ref(*args, softcap=softcap))
    _close(out, paged_flash_decode_attention(
        *(jnp.asarray(a) for a in (q, kp, vp, pt, cur)), softcap=softcap,
        interpret=True))


@pytest.mark.parametrize("ps", [8, 16, 64])
def test_paged_split_equals_contiguous_bit_for_bit(ps):
    """The same cache, contiguous and scattered over scrambled pages: the
    chunks are cut by key index alone, so the outputs are identical."""
    rng = np.random.default_rng(ps)
    b, hkv, g, dh, smax = 8, 2, 7, 16, 4 * CHUNK
    q = torch.from_numpy(_rand(rng, b, 1, hkv * g, dh))
    k = torch.from_numpy(_rand(rng, b, smax, hkv, dh))
    v = torch.from_numpy(_rand(rng, b, smax, hkv, dh))
    cur = torch.tensor(_lengths(smax), dtype=torch.int32)
    n = b * smax // ps
    perm = torch.from_numpy(rng.permutation(n))
    kp, vp = torch.empty((n, ps, hkv, dh)), torch.empty((n, ps, hkv, dh))
    kp[perm], vp[perm] = k.reshape(n, ps, hkv, dh), v.reshape(n, ps, hkv, dh)
    table = perm.reshape(b, smax // ps).int()
    assert torch.equal(split_emulation(q, k, v, cur),
                       paged_split_emulation(q, kp, vp, table, cur))


@pytest.mark.parametrize("dtype,dh,offset,wide", [
    (torch.bfloat16, 64, 0, 1),     # 8 bf16 = 16 bytes
    (torch.bfloat16, 16, 0, 1),
    (torch.bfloat16, 20, 0, 0),     # dh % 8
    (torch.float32, 20, 0, 1),      # 4 fp32 = 16 bytes
    (torch.float32, 64, 1, 0),      # data 4 bytes off 16-byte alignment
])
def test_wrapper_picks_the_load_width_from_shapes(dtype, dh, offset, wide):
    """The wrapper asks for 16-byte loads only where dh, every stride and
    the K/V data allow them; the workspace holds one (m, l, acc[dh])
    partial per (row, query head, split)."""
    b, hq, hkv, smax = 2, 6, 2, 300
    q = torch.zeros((b, 1, hq, dh), dtype=dtype)
    flat = torch.zeros(b * smax * hkv * dh + offset, dtype=dtype)
    k = flat[offset:].view(b, smax, hkv, dh)
    out, ws, strides, chunk, n_split, got = ops._decode_launch_args(
        q, k, k, smax)
    assert got == wide
    assert (chunk, n_split) == ops.decode_splits(smax) == (CHUNK, 3)
    assert strides == [smax * hkv * dh, hkv * dh, dh] * 2
    assert ws.dtype == torch.float32 and ws.numel() == \
        b * hq * n_split * (dh + 2)
    assert out.shape == q.shape and out.dtype == dtype
