"""The port's attention functions and the decode kernels' plain versions
against the JAX reference, on the same numpy inputs (fp32, CPU).

The reference's Pallas kernels run in interpret mode, as its own kernel
tests run them.  Tolerance 3e-5 throughout, the reference's own
kernel-vs-oracle tolerance: the kernels scale q before the dot product
and the oracle scales the scores, and softmax sums run in other orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import (flash_decode_attention,
                                               paged_flash_decode_attention)
from repro.models import attention as jattn
from repro_torch.kernels.flash_attention.ref import (paged_decode_ref,
                                                     ragged_decode_ref)
from repro_torch.models import attention as tattn

TOL = 3e-5


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=tol, atol=tol)


def _qkv(seed, b, sq, sk, hq, hkv, dh):
    rng = np.random.default_rng(seed)
    return _rand(rng, b, sq, hq, dh), _rand(rng, b, sk, hkv, dh), \
        _rand(rng, b, sk, hkv, dh)


def _both(fn_t, fn_j, *arrays, **kw):
    out_t = fn_t(*[torch.from_numpy(a) for a in arrays], **kw)
    out_j = fn_j(*[jnp.asarray(a) for a in arrays], **kw)
    return out_t, out_j


# ---------------- projections ----------------

def test_projections_with_qkv_bias():
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config("qwen2-0.5b")
    rng = np.random.default_rng(0)
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": _rand(rng, d, hq, dh), "wk": _rand(rng, d, hkv, dh),
         "wv": _rand(rng, d, hkv, dh), "bq": _rand(rng, hq, dh),
         "bk": _rand(rng, hkv, dh), "bv": _rand(rng, hkv, dh),
         "wo": _rand(rng, hq, dh, d)}
    x = _rand(rng, 2, 5, d)
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    _close(tattn.project_q(pt, torch.from_numpy(x), cfg),
           jattn.project_q(pj, jnp.asarray(x), cfg), 1e-4)
    for a, b in zip(tattn.project_kv(pt, torch.from_numpy(x), cfg),
                    jattn.project_kv(pj, jnp.asarray(x), cfg)):
        _close(a, b, 1e-4)
    o = _rand(rng, 2, 5, hq, dh)
    _close(tattn.project_out(pt, torch.from_numpy(o), torch.float32),
           jnp.einsum("bshk,hkd->bsd", jnp.asarray(o), pj["wo"]), 1e-4)


# ---------------- prefill attention ----------------

@pytest.mark.parametrize("causal,window,softcap,q_offset", [
    (True, 0, 0.0, 0), (True, 8, 0.0, 0), (False, 0, 0.0, 0),
    (True, 0, 10.0, 0), (True, 0, 0.0, 16),
])
def test_attention_reference(causal, window, softcap, q_offset):
    q, k, v = _qkv(1, 2, 16, 32 if q_offset else 16, 6, 2, 16)
    kw = dict(causal=causal, window=window, softcap=softcap,
              q_offset=q_offset)
    _close(*_both(tattn.attention_reference, jattn.attention_reference,
                  q, k, v, **kw))


@pytest.mark.parametrize("window,skip", [(0, False), (0, True), (16, False)])
def test_attention_chunked(window, skip):
    q, k, v = _qkv(2, 1, 64, 64, 4, 2, 16)
    kw = dict(causal=True, window=window, q_block=16, kv_block=32,
              skip_future_blocks=skip)
    _close(*_both(tattn.attention_chunked, jattn.attention_chunked,
                  q, k, v, **kw))


@pytest.mark.parametrize("window,skip", [(0, True), (16, True),
                                         (0, False)])
def test_attention_chunked_takes_short_tail_blocks(window, skip):
    """Blocks that do not divide the length (the reference asserts they
    do): the port's short last q and kv blocks give the reference's
    full-score attention.  Exact-length prefill meets such lengths."""
    q, k, v = _qkv(3, 1, 75, 75, 4, 2, 16)
    out_t = tattn.attention_chunked(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, window=window, q_block=16, kv_block=32,
        skip_future_blocks=skip)
    _close(out_t, jattn.attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window))
    with pytest.raises(AssertionError):
        jattn.attention_chunked(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), q_block=16, kv_block=32)


def test_select_attention():
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config("qwen2-0.5b")
    assert tattn.select_attention(cfg, 512) is tattn.attention_reference
    fn = tattn.select_attention(cfg, 2048, skip_future=True)
    assert fn.func is tattn.attention_chunked
    assert fn.keywords == dict(q_block=512, kv_block=1024,
                               skip_future_blocks=True)


# ---------------- decode attention (model-side oracles) ----------------

@pytest.mark.parametrize("idx,window,softcap", [
    (np.int32(9), 0, 0.0), (np.array([0, 5, 31], np.int32), 0, 0.0),
    (np.array([3, 20, 31], np.int32), 8, 0.0),
    (np.array([1, 7, 30], np.int32), 0, 5.0),
])
def test_attention_decode(idx, window, softcap):
    q, k, v = _qkv(3, 3, 1, 32, 6, 2, 16)
    out_t = tattn.attention_decode(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.as_tensor(idx), window=window, softcap=softcap)
    out_j = jattn.attention_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(idx),
        window=window, softcap=softcap)
    _close(out_t, out_j)


def test_attention_decode_valid_mask():
    q, k, v = _qkv(4, 2, 1, 16, 4, 2, 8)
    mask = np.random.default_rng(4).random((2, 16)) < 0.6
    mask[:, 0] = True
    out_t = tattn.attention_decode(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.tensor(15), valid_mask=torch.from_numpy(mask))
    out_j = jattn.attention_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(15),
        valid_mask=jnp.asarray(mask))
    _close(out_t, out_j)


def _paged_tables(rng, b, max_pages, n_pages, mapped):
    """Disjoint scrambled page tables, sentinel-padded (as in the
    reference's kernel tests)."""
    perm = rng.permutation(n_pages)
    pt = np.full((b, max_pages), n_pages, np.int32)
    at = 0
    for i, m in enumerate(mapped):
        pt[i, :m] = perm[at:at + m]
        at += m
    return pt


def _paged_inputs(seed, b, max_len, ps, hq, hkv, dh, n_pages=None,
                  idx=None):
    rng = np.random.default_rng(seed)
    max_pages = max_len // ps
    n_pages = n_pages or b * max_pages
    q = _rand(rng, b, 1, hq, dh)
    kp = _rand(rng, n_pages, ps, hkv, dh)
    vp = _rand(rng, n_pages, ps, hkv, dh)
    if idx is None:
        idx = rng.integers(0, max_len, b)
    idx = np.asarray(idx, np.int32)
    mapped = [-(-(int(i) + 1) // ps) for i in idx]
    pt = _paged_tables(rng, b, max_pages, n_pages, mapped)
    return q, kp, vp, pt, idx


def test_gather_pages_and_paged_oracle():
    q, kp, vp, pt, idx = _paged_inputs(5, 3, 64, 16, 4, 2, 16,
                                       idx=[0, 17, 63])
    g_t = tattn.gather_pages(torch.from_numpy(kp), torch.from_numpy(pt),
                             16, 64)
    g_j = jattn.gather_pages(jnp.asarray(kp), jnp.asarray(pt), 16, 64)
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))
    out_t, out_j = _both(
        lambda *a: tattn.attention_decode_paged(*a, page_size=16,
                                                max_len=64),
        lambda *a: jattn.attention_decode_paged(*a, page_size=16,
                                                max_len=64),
        q, kp, vp, pt, idx)
    _close(out_t, out_j)


# ---------------- kernels' plain versions vs the Pallas kernels ----------

def _ragged_case(b, smax, hq, hkv, dh, kb, softcap=0.0, seed=0, idx=None):
    q, k, v = _qkv(seed, b, 1, smax, hq, hkv, dh)
    if idx is None:
        idx = np.random.default_rng(seed + 100).integers(0, smax, b)
    idx = np.asarray(idx, np.int32)
    out_t = ragged_decode_ref(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), torch.from_numpy(idx),
                              softcap=softcap)
    out_j = flash_decode_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(idx),
                                   softcap=softcap, kv_block=kb,
                                   interpret=True)
    _close(out_t, out_j)


@pytest.mark.parametrize("b,smax,hq,hkv,dh,kb", [
    (3, 128, 4, 2, 16, 32), (2, 256, 6, 2, 32, 64), (4, 64, 5, 1, 16, 64),
    (1, 128, 8, 8, 8, 128),
    (2, 64, 6, 2, 16, 32),      # G = 3
    (2, 64, 14, 2, 16, 64),     # G = 7, qwen2-0.5b's grouping
])
def test_ragged_decode_ref_matches_pallas(b, smax, hq, hkv, dh, kb):
    _ragged_case(b, smax, hq, hkv, dh, kb)


def test_ragged_decode_ref_softcap():
    _ragged_case(2, 128, 4, 2, 16, 32, softcap=10.0)


def test_ragged_decode_ref_edge_lengths():
    """idx 0, Smax-1, and past Smax (a retired slot attends to all)."""
    _ragged_case(4, 64, 6, 2, 16, 64, idx=[0, 63, 64, 200])


def test_ragged_decode_ref_matches_model_oracle():
    q, k, v = _qkv(6, 3, 1, 32, 14, 2, 8)
    idx = np.array([0, 13, 31], np.int32)
    out_t = ragged_decode_ref(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), torch.from_numpy(idx))
    oracle = tattn.attention_decode(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(idx))
    np.testing.assert_allclose(out_t.numpy(), oracle.numpy(), rtol=TOL,
                               atol=TOL)


def _paged_case(b, max_len, ps, hq, hkv, dh, softcap=0.0, seed=0,
                n_pages=None, idx=None):
    q, kp, vp, pt, idx = _paged_inputs(seed, b, max_len, ps, hq, hkv, dh,
                                       n_pages, idx)
    out_t = paged_decode_ref(torch.from_numpy(q), torch.from_numpy(kp),
                             torch.from_numpy(vp), torch.from_numpy(pt),
                             torch.from_numpy(idx), softcap=softcap)
    out_j = paged_flash_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pt),
        jnp.asarray(idx), softcap=softcap, interpret=True)
    _close(out_t, out_j)


@pytest.mark.parametrize("b,max_len,ps,hq,hkv,dh", [
    (3, 64, 16, 4, 2, 16), (2, 128, 32, 6, 2, 32), (4, 64, 8, 5, 1, 16),
    (1, 64, 64, 8, 8, 8),
    (2, 64, 16, 14, 2, 16),     # G = 7
])
def test_paged_decode_ref_matches_pallas(b, max_len, ps, hq, hkv, dh):
    _paged_case(b, max_len, ps, hq, hkv, dh)


def test_paged_decode_ref_softcap():
    _paged_case(2, 64, 16, 4, 2, 16, softcap=10.0)


def test_paged_decode_ref_edge_lengths():
    _paged_case(4, 64, 16, 6, 2, 16, idx=[0, 15, 16, 63])


def test_paged_decode_ref_tight_pool():
    _paged_case(4, 64, 8, 4, 2, 16, n_pages=14, idx=[7, 20, 1, 15])


@pytest.mark.parametrize("ps", [8, 16, 32])
def test_paged_decode_ref_page_size_sweep(ps):
    _paged_case(2, 64, ps, 4, 2, 16, seed=ps)


def test_paged_decode_ref_fragmentation_invariance():
    """The same logical cache through an identity and a scrambled table
    gives identical outputs."""
    b, max_len, ps, hq, hkv, dh = 2, 64, 16, 4, 2, 16
    n = b * (max_len // ps)
    rng = np.random.default_rng(7)
    q = torch.from_numpy(_rand(rng, b, 1, hq, dh))
    kp = torch.from_numpy(_rand(rng, n, ps, hkv, dh))
    vp = torch.from_numpy(_rand(rng, n, ps, hkv, dh))
    idx = torch.tensor([30, 63], dtype=torch.int32)
    pt_id = torch.arange(n, dtype=torch.int32).reshape(b, max_len // ps)
    perm = torch.from_numpy(rng.permutation(n))
    inv = torch.argsort(perm)
    a = paged_decode_ref(q, kp, vp, pt_id, idx)
    c = paged_decode_ref(q, kp[inv], vp[inv], perm[pt_id.long()].int(), idx)
    assert torch.equal(a, c)
