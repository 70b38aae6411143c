"""The prefill flash-attention kernel's plain version and wrapper (CPU
tensors) against the JAX reference, on the same numpy inputs.

The reference's Pallas kernel runs in interpret mode, as its own kernel
tests run it, on the shapes of ``tests/test_kernels.py``.  Tolerances are
the reference's own: 3e-5 in fp32 (the kernel scales q before the dot
product, the oracle scales the scores, and softmax sums run in other
orders) and 2.5e-2 in bf16 (both round the output once to bf16 from an
fp32 sum).  Lengths the Pallas kernel cannot take (its blocks must divide
Sq and Sk) are held to ``attention_ref``.  The model-level cases run the
qwen2-0.5b smoke config at fp32 through the port and a live ``repro``
prefill on the same weights: logits within 1e-4, caches within 1e-5, as
in ``test_torch_model.py``.
"""

import dataclasses
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels.flash_attention import ops as jops
from repro.kernels.flash_attention.ref import attention_ref
from repro.models.model import Model as JModel
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (NEG_INF,
                                                     flash_attention_ref)
from repro_torch.models import attention as tattn
from repro_torch.models.model import Model
from repro_torch.models.params import from_numpy

FP32_TOL = 3e-5
BF16_TOL = 2.5e-2
LOGIT_ATOL = 1e-4
CACHE_ATOL = 1e-5


def _qkv(seed, b, sq, sk, hq, hkv, dh):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, sq, hq, dh), (b, sk, hkv, dh),
                           (b, sk, hkv, dh)))


def _torch(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _err(t, j):
    return float(np.max(np.abs(t.float().numpy()
                               - np.asarray(j, np.float32))))


def _pallas_case(b, sq, sk, hq, hkv, dh, causal=True, window=0,
                 softcap=0.0, dtype="float32", qb=64, kb=64, seed=0):
    """Plain version and wrapper (CPU) vs the Pallas kernel in interpret
    mode on the same inputs; -> the wrapper's output."""
    arrays = _qkv(seed, b, sq, sk, hq, hkv, dh)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" \
        else (jnp.float32, torch.float32)
    kw = dict(causal=causal, window=window, softcap=softcap)
    out_j = jops.flash_attention(*[jnp.asarray(a).astype(jdt)
                                   for a in arrays], q_block=qb,
                                 kv_block=kb, interpret=True, **kw)
    q, k, v = _torch(arrays, tdt)
    plain = flash_attention_ref(q, k, v, **kw)
    wrapped = ops.flash_attention(q, k, v, q_block=qb, kv_block=kb, **kw)
    tol = BF16_TOL if dtype == "bfloat16" else FP32_TOL
    assert plain.dtype == tdt and plain.shape == q.shape
    assert torch.equal(wrapped, plain)
    assert _err(plain, out_j) < tol
    return wrapped


# ----- against the Pallas kernel (tests/test_kernels.py's sweeps) -------------

@pytest.mark.parametrize("b,sq,hq,hkv,dh", [
    (1, 128, 2, 2, 16), (2, 128, 4, 2, 32), (1, 256, 6, 2, 64),
    (2, 64, 5, 1, 16), (1, 128, 8, 8, 8),
    (1, 128, 14, 2, 64),        # qwen2-0.5b's heads
])
def test_flash_shapes_match_pallas(b, sq, hq, hkv, dh):
    _pallas_case(b, sq, sq, hq, hkv, dh)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_dtypes_match_pallas(dtype):
    _pallas_case(1, 128, 128, 4, 2, 32, dtype=dtype)


@pytest.mark.parametrize("window", [16, 64])
def test_flash_local_window_matches_pallas(window):
    _pallas_case(1, 128, 128, 2, 1, 16, window=window)


def test_flash_non_causal_matches_pallas():
    _pallas_case(1, 64, 128, 2, 2, 16, causal=False)


def test_flash_softcap_matches_pallas():
    _pallas_case(1, 128, 128, 2, 2, 16, softcap=10.0)


def test_flash_recurrentgemma_heads_match_pallas():
    """G = 10 query heads on one kv head, windowed, as recurrentgemma's
    local attention (narrower head_dim)."""
    _pallas_case(1, 128, 128, 10, 1, 32, window=48)


@pytest.mark.parametrize("qb,kb", [(32, 32), (32, 64), (32, 128),
                                   (64, 32), (64, 128)])
def test_flash_block_shape_invariance(qb, kb):
    """The output does not depend on q_block / kv_block, and matches the
    Pallas kernel at each tiling."""
    out = _pallas_case(1, 128, 128, 2, 2, 16, qb=qb, kb=kb, seed=qb + kb)
    q, k, v = _torch(_qkv(qb + kb, 1, 128, 128, 2, 2, 16))
    assert torch.equal(out, ops.flash_attention(q, k, v))


# ----- lengths the Pallas kernel cannot take -----------------------------------

@pytest.mark.parametrize("sq,window", [(1, 0), (7, 0), (1500, 0),
                                       (1500, 64)])
def test_flash_ref_matches_attention_ref_at_any_length(sq, window):
    b, hq, hkv, dh = 1, 4, 2, 16
    q, k, v = _qkv(sq, b, sq, sq, hq, hkv, dh)
    heads = [np.ascontiguousarray(a.transpose(0, 2, 1, 3)).reshape(
        -1, sq, dh) for a in (q, k, v)]
    expect = np.asarray(attention_ref(*map(jnp.asarray, heads),
                                      window=window))
    expect = expect.reshape(b, hq, sq, dh).transpose(0, 2, 1, 3)
    out = ops.flash_attention(*_torch((q, k, v)), window=window)
    assert _err(out, expect) < FP32_TOL


# ----- the port's plain versions agree with each other ------------------------

@pytest.mark.parametrize("sq,sk,causal,window,softcap", [
    (100, 100, True, 0, 0.0), (1030, 1030, True, 0, 0.0),
    (300, 300, True, 32, 0.0), (77, 77, True, 0, 10.0),
    (50, 90, False, 0, 0.0), (64, 64, False, 16, 5.0),
])
def test_plain_versions_agree(sq, sk, causal, window, softcap):
    q, k, v = _torch(_qkv(sq + sk, 2, sq, sk, 6, 2, 16))
    kw = dict(causal=causal, window=window, softcap=softcap)
    out = flash_attention_ref(q, k, v, **kw)
    torch.testing.assert_close(out, tattn.attention_reference(q, k, v, **kw),
                               rtol=0, atol=FP32_TOL)
    torch.testing.assert_close(
        out, tattn.attention_chunked(q, k, v, q_block=64, kv_block=128,
                                     skip_future_blocks=causal, **kw),
        rtol=0, atol=FP32_TOL)


def test_wrapper_on_cpu_runs_the_plain_version_uncounted():
    q, k, v = _torch(_qkv(3, 2, 20, 20, 6, 3, 8))
    ops.reset_launch_counts()
    assert torch.equal(ops.flash_attention(q, k, v, window=5, softcap=3.0),
                       flash_attention_ref(q, k, v, window=5, softcap=3.0))
    assert ops.LAUNCHES["flash_attention"] == 0
    assert ops.SHAPE_LAUNCHES == {}


# ----- the bf16 kernel's rounding, emulated --------------------------------

def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CHIP_SMOKE = _load_chip_smoke()


def tensor_core_emulation(q, k, v, *, causal=True, window=0, softcap=0.0,
                          kv_tile=64, round_p=True):
    """The bf16 kernel's arithmetic in plain torch: kv tiles of 64 keys,
    the online softmax in fp32 in the reference's order (m_new, p, alpha,
    l, acc) with the finite -1e30 mask, l summed from fp32 p, P rounded to
    bf16 before P V (``round_p``; the tensor cores multiply bf16 and sum
    in fp32), division by max(l, 1e-30) at the end and the output rounded
    once to q's dtype."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    qh = q.float().reshape(b, sq, hkv, hq // hkv, dh)
    m = torch.full((b, hkv, hq // hkv, sq), NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros(m.shape + (dh,))
    q_pos = torch.arange(sq)[:, None]
    for k0 in range(0, sk, kv_tile):
        kt, vt = k[:, k0:k0 + kv_tile].float(), v[:, k0:k0 + kv_tile].float()
        s = torch.einsum("bqhgd,bkhd->bhgqk", qh, kt) * dh ** -0.5
        if softcap > 0:
            s = torch.tanh(s / softcap) * softcap
        k_pos = torch.arange(k0, k0 + kt.shape[1])[None, :]
        valid = torch.ones((sq, kt.shape[1]), dtype=torch.bool)
        if causal:
            valid &= k_pos <= q_pos
        if window > 0:
            valid &= k_pos > q_pos - window
        s = s.masked_fill(~valid, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        if round_p:
            p = p.bfloat16().float()
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p,
                                                    vt)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dh).to(q.dtype)


#: every bf16 case of chip_smoke's flash sweep small enough for the CPU,
#: then the two main paths' heads at 1024 and 1500 tokens
EMULATED_CASES = [c for c in CHIP_SMOKE.FLASH_CASES
                  if c[1] * c[2] <= 1024 * 1024] + [
    (1, n, n, 14, 2, 64, True, 0, 0.0) for n in (1024, 1500)] + [
    (1, n, n, 10, 1, 256, True, 2048, 0.0) for n in (1024, 1500)]


@pytest.mark.parametrize("b,sq,sk,hq,hkv,dh,causal,window,softcap",
                         EMULATED_CASES)
def test_tensor_core_rounding_within_the_card_limit(b, sq, sk, hq, hkv, dh,
                                                    causal, window, softcap):
    """The card holds the bf16 kernel to BF16_REL_TOL * max|plain| of
    ``flash_attention_ref``, per case and per row (each row's error over
    its own max |plain|); the kernel's tensor-core P V rounds P to
    bf16, which the oracle does not.  The emulation of that rounding stays
    inside the limit on chip_smoke's inputs (standard normal, rounded to
    bf16), and without the rounding (fp32 inputs) it is the oracle within
    the reference's fp32 tolerance."""
    arrays = _qkv(sq * 7 + dh, b, sq, sk, hq, hkv, dh)
    kw = dict(causal=causal, window=window, softcap=softcap)
    q, k, v = _torch(arrays, torch.bfloat16)
    plain = flash_attention_ref(q, k, v, **kw)
    emulated = tensor_core_emulation(q, k, v, **kw)
    assert emulated.dtype == torch.bfloat16 and emulated.shape == q.shape
    limit = CHIP_SMOKE.BF16_REL_TOL * plain.float().abs().max().item()
    assert (emulated.float() - plain.float()).abs().max().item() <= limit
    assert CHIP_SMOKE.row_error(emulated, plain) <= CHIP_SMOKE.BF16_REL_TOL
    q, k, v = _torch(arrays)
    torch.testing.assert_close(
        tensor_core_emulation(q, k, v, round_p=False, **kw),
        flash_attention_ref(q, k, v, **kw), rtol=0, atol=FP32_TOL)


# ----- routing ---------------------------------------------------------------

@pytest.mark.parametrize("seq_len", [1023, 1024])
def test_select_attention_by_device(seq_len):
    """On the card the kernel's wrapper at every length; on the CPU the
    reference's rule (full scores below 1024, chunked from 1024)."""
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config("qwen2-0.5b")
    assert tattn.select_attention(cfg, seq_len, True, True) \
        is ops.flash_attention
    cpu = tattn.select_attention(cfg, seq_len, True, False)
    if seq_len < 1024:
        assert cpu is tattn.attention_reference
    else:
        assert cpu.func is tattn.attention_chunked


# ----- model level: long prompts against a live repro prefill -----------------

@functools.lru_cache(maxsize=None)
def _qwen2_pair():
    jcfg = dataclasses.replace(jax_smoke_config("qwen2-0.5b"),
                               compute_dtype="float32")
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(ArchConfig(**dataclasses.asdict(jcfg)), device="cpu")
    return jm, jp, tm, tm.prepare_params(from_numpy(jax.device_get(jp)))


@pytest.mark.parametrize("length", [1024, 1500])
def test_long_prompt_prefill_matches_repro(length):
    """The port prefills the prompt at its exact length (chunked attention
    with short tail blocks on the CPU, the kernel on the card).
    ``repro``'s chunked attention needs its blocks to divide the length,
    so it prefills the prompt padded to the next multiple of 1024 with
    ``last_index``, its own bucketed-prefill path (causal attention hides
    the trailing pad)."""
    jm, jp, tm, tp = _qwen2_pair()
    toks = np.random.default_rng(length).integers(
        1, jm.cfg.vocab, (1, length)).astype(np.int32)
    padded = -(-length // 1024) * 1024
    jtoks = np.zeros((1, padded), np.int32)
    jtoks[:, :length] = toks
    j_logits, jc = jm.prefill(jp, {"tokens": jnp.asarray(jtoks)},
                              jm.init_cache(1, padded),
                              last_index=jnp.asarray([length - 1]))
    t_logits, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                              tm.init_cache(1, padded))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               rtol=0, atol=LOGIT_ATOL)
    t_layers = tc["stack"]["body"][0]["attn"]
    j_layers = jax.device_get(jc["stack"]["body"][0]["attn"])
    for name in ("k", "v"):
        np.testing.assert_allclose(
            t_layers[name][:, :, :length].numpy(),
            np.asarray(j_layers[name])[:, :, :length], rtol=0,
            atol=CACHE_ATOL)
