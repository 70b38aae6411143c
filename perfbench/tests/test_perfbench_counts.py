"""The roofline counts against hand-computed operations and bytes."""

import pytest

from perfbench import counts, spec

QWEN = spec.load_cell("qwen2-0.5b.reason-batch").cfg
GRANITE = spec.load_cell("granite-moe-1b-a400m.chat-rate").cfg


def test_active_params_hand_counted():
    # qwen2-0.5b: q, k, v, o (+ biases), SwiGLU, x 24, then the tied head
    attn = 896 * 14 * 64 + 2 * 896 * 2 * 64 + 14 * 64 * 896 \
        + 14 * 64 + 2 * 2 * 64
    ffn = 3 * 896 * 4864
    assert counts.active_params(QWEN) == 24 * (attn + ffn) + 896 * 151936
    assert counts.active_params(QWEN) == 493_988_864
    # granite-moe-1b-a400m: the router and 8 of 32 experts a token
    attn = 1024 * 1024 + 2 * 1024 * 512 + 1024 * 1024
    moe = 1024 * 32 + 8 * 3 * 1024 * 512
    assert counts.active_params(GRANITE) == \
        24 * (attn + moe) + 1024 * 49155 == 428_608_512


def test_decode_call_hand_computed():
    # two rows attending 100 and 300 keys; 14 query heads, 2 kv heads,
    # d_head 64, bf16
    ops, nbytes = counts.decode_attn_call(QWEN, [100, 300])
    assert ops == 4 * 400 * 14 * 64 == 1_433_600
    assert nbytes == 2 * (2 * 400 * 2 * 64 + 2 * 2 * 14 * 64) == 211_968
    # memory-bound by far: G = 7 operations a byte's worth
    assert counts.bound_s(ops, nbytes) == nbytes / counts.PEAK_BYTES


def test_flash_call_hand_computed():
    # prompts of 3 and 5 tokens: 6 + 15 causal pairs
    ops, nbytes = counts.flash_call(QWEN, [3, 5])
    assert ops == 4 * 21 * 14 * 64 == 75_264
    assert nbytes == 2 * 8 * (2 * 14 * 64 + 2 * 2 * 64) == 32_768
    # a long prompt turns compute-bound
    ops, nbytes = counts.flash_call(QWEN, [4096])
    assert counts.bound_s(ops, nbytes) == ops / counts.PEAK_FLOPS


def test_decode_flops_hand_computed():
    got = counts.decode_flops(GRANITE, [10, 20])
    want = 2 * 2 * 428_608_512 + 4 * 16 * 64 * 24 * 30
    assert got == pytest.approx(want)
    assert counts.decode_flops(GRANITE, []) == 0


def test_peaks():
    assert counts.PEAK_FLOPS == 989e12 and counts.PEAK_BYTES == 3.35e12
