"""The RG-LRU kernel's chunked two-pass scan, emulated in plain PyTorch on
the CPU, against the kernel's plain version and the JAX reference.

The CUDA kernel (``csrc/rglru_scan.cu``) cuts T into chunks of
``ops.scan_chunks(B, T, C)[0]`` steps.  Pass 1 scans every chunk but the
last from zero and keeps its product of ``a`` and its end state; pass 2
folds ``carry = A_j carry + H_j`` over the chunks before its own, in
chunk order, then walks its chunk from that carry.  ``chunk_emulation``
below repeats that algorithm chunk by chunk in fp32 with the kernel's
roundings (each product and sum rounded on its own; channels and threads
are independent), so these tests hold the algorithm, its chunk edges and
its reassociated carries where a CPU can run them; the kernel itself is
held to the plain version on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``).

Inputs come from numpy with a seed.  Limits are the card's, unchanged:
fp32 ``FP32_REL_TOL`` * max(1, max |plain|) (``chip_smoke.py``
``RGLRU_FP32_REL_TOL``), bf16 ``BF16_REL_TOL`` * max |plain|.  The
reference's Pallas kernel runs with ``interpret=True`` at T that its time
blocks divide, as its own kernel tests run it; its ``associative_scan``
oracle at any T.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru.ops import rglru_scan as jax_rglru_scan
from repro.kernels.rglru.ref import rglru_scan_ref as jax_rglru_ref
from repro_torch.kernels.rglru import ops, ref

FP32_REL_TOL = 1e-5
BF16_REL_TOL = 4 * 2.0 ** -8


def chunk_emulation(a, x, chunk_len):
    """a, x: (B, T, C) -> h in x's dtype, by the kernel's two passes over
    chunks of ``chunk_len`` steps (the last may be shorter)."""
    af, xf = a.float(), x.float()
    b, t, c = xf.shape
    n_chunks = -(-t // chunk_len)
    prods, states = [], []
    for k in range(n_chunks - 1):                   # pass 1
        h, p = torch.zeros((b, c)), torch.ones((b, c))
        for s in range(k * chunk_len, (k + 1) * chunk_len):
            h = af[:, s] * h + xf[:, s]
            p = p * af[:, s]
        prods.append(p)
        states.append(h)
    out = torch.empty_like(xf)
    for k in range(n_chunks):                       # pass 2
        carry = torch.zeros((b, c))
        for j in range(k):
            carry = prods[j] * carry + states[j]
        for s in range(k * chunk_len, min(t, (k + 1) * chunk_len)):
            carry = af[:, s] * carry + xf[:, s]
            out[:, s] = carry
    return out.to(x.dtype)


def _inputs(b, t, c, seed, near_one=False):
    """a from a sigmoid of normals, or near 0.999 (1 - 0.001 * U(0, 1)),
    as ``chip_smoke.py`` draws it, so the carry grows to about 1000 times
    x; x standard normal."""
    rng = np.random.default_rng(seed)
    if near_one:
        a = 1.0 - 1e-3 * rng.random((b, t, c))
    else:
        a = 1.0 / (1.0 + np.exp(-rng.standard_normal((b, t, c))))
    x = rng.standard_normal((b, t, c))
    return a.astype(np.float32), x.astype(np.float32)


def _limit(expect):
    top = expect.float().abs().max().item()
    if expect.dtype == torch.bfloat16:
        return BF16_REL_TOL * top
    return FP32_REL_TOL * max(1.0, top)


def _close(out, expect):
    expect = torch.as_tensor(np.array(expect, np.float32)).to(out.dtype)
    err = (out.float() - expect.float()).abs().max().item()
    assert err <= _limit(expect), (err, _limit(expect))


def _t_block(t):
    """The largest time block of at most 256 steps that divides T."""
    return max(d for d in range(1, min(t, 256) + 1) if t % d == 0)


def test_scan_chunks_reads_only_the_shape():
    assert list(inspect.signature(ops.scan_chunks).parameters) == \
        ["b", "t", "c"]
    for b, t, c in [(1, 1, 2560), (1, 7, 2560), (2, 300, 2560),
                    (1, 2048, 2560), (1, 2049, 2560), (1, 3500, 2560),
                    (2, 3001, 64), (1, 2040, 64), (3, 4096, 96),
                    (8, 2048, 2560), (1, 100000, 8), (65535, 2050, 2560)]:
        chunk, n = ops.scan_chunks(b, t, c)
        assert 1 <= n <= min(ops.MAX_CHUNKS, t), (b, t, c)
        assert chunk >= ops.MIN_CHUNK
        assert (n - 1) * chunk < t <= n * chunk
        assert n == 1 or chunk % ops.SCAN_UNROLL == 0


@pytest.mark.parametrize("t", [2048, 3500])
def test_scan_chunks_fills_the_card_at_recurrentgemma_prefill(t):
    """recurrentgemma-2b admits one prompt at a time: B = 1, C = 2560,
    20 channel tiles; the chunks give at least 4 blocks per SM of 132."""
    chunk, n = ops.scan_chunks(1, t, 2560)
    assert 20 * n >= 4 * 132
    assert n > 1 and chunk % ops.SCAN_UNROLL == 0


@pytest.mark.parametrize("t", [1, 7, 16])
def test_scan_chunks_one_chunk_at_short_t(t):
    assert ops.scan_chunks(1, t, 2560)[1] == 1
    assert ops.scan_chunks(4, t, 64)[1] == 1


def test_one_chunk_is_the_plain_version_bit_for_bit():
    """n_chunks = 1: pass 2 alone from a zero carry, which is the plain
    version's loop."""
    a, x = _inputs(2, 13, 40, seed=0)
    at, xt = torch.as_tensor(a), torch.as_tensor(x)
    assert torch.equal(chunk_emulation(at, xt, 16),
                       ref.rglru_scan_ref(at, xt))


#: (T, number of chunks under the plan at B = 2, C = 40): one step, T
#: below, at and past one chunk of 16, T that is no multiple of it, the
#: 64-chunk cap, and just past the cap (chunks of 32)
PLAN_CASES = [(1, 1), (9, 1), (16, 1), (17, 2), (100, 7), (1024, 64),
              (1025, 33)]


@pytest.mark.parametrize("t,n_chunks", PLAN_CASES)
def test_chunked_scan_matches_plain_and_pallas(t, n_chunks):
    b, c = 2, 40
    chunk, n = ops.scan_chunks(b, t, c)
    assert n == n_chunks
    a, x = _inputs(b, t, c, seed=t)
    at, xt = torch.as_tensor(a), torch.as_tensor(x)
    out = chunk_emulation(at, xt, chunk)
    assert out.shape == (b, t, c) and torch.isfinite(out).all()
    _close(out, ref.rglru_scan_ref(at, xt))
    _close(out, jax_rglru_ref(jnp.asarray(a), jnp.asarray(x)))
    _close(out, jax_rglru_scan(jnp.asarray(a), jnp.asarray(x),
                               t_block=_t_block(t), c_block=c,
                               interpret=True))


@pytest.mark.parametrize("b,c", [(1, 2560), (2, 2560), (8, 2560)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_chunked_scan_near_one_at_t3001(b, c, dtype):
    """a near 0.999 at T = 3001, the chunks of the card's plan at (B, T,
    C) (48, 96 and 416 steps), run over 24 channels so the CPU stays
    fast: the reassociated carries stay within the unchanged limits."""
    t = 3001
    chunk, n = ops.scan_chunks(b, t, c)
    a, x = _inputs(2, t, 24, seed=c + b, near_one=True)
    at, xt = torch.as_tensor(a).to(dtype), torch.as_tensor(x).to(dtype)
    out = chunk_emulation(at, xt, chunk)
    expect = ref.rglru_scan_ref(at, xt)
    assert n > 1 and out.dtype == dtype
    assert expect.float().abs().max().item() > 10.0     # the carry grew
    err = (out.float() - expect.float()).abs().max().item()
    assert err <= _limit(expect), (chunk, err, _limit(expect))
    if dtype == torch.float32:
        _close(out, jax_rglru_ref(jnp.asarray(a), jnp.asarray(x)))


def test_mixed_dtypes():
    """bf16 a with fp32 x reads both as fp32 and writes fp32."""
    a, x = _inputs(2, 70, 12, seed=5)
    abf, xt = torch.as_tensor(a).bfloat16(), torch.as_tensor(x)
    out = chunk_emulation(abf, xt, 16)
    assert out.dtype == torch.float32
    _close(out, ref.rglru_scan_ref(abf, xt))
