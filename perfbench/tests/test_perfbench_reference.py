"""Each plain reference agrees with the port at the smoke sizes on the CPU
(fp32): the prompt's last logits and a greedy decode chain through the
port's cache equal the reference's full forward pass; the MoE reference's
capacity rule is the port's, at the bucket a prefill padded to."""

import numpy as np
import pytest
import torch

from perfbench import generator, run, spec, weights
from perfbench.reference.dense import fp8_round, strict_fp32
from perfbench.reference.moe import capacity
from perfbench.tests.smoke_cells import smoke_cell

WORKLOADS = ["qwen2-0.5b.reason-batch", "granite-moe-1b-a400m.chat-rate"]


def _setup(workload, seed=3):
    strict_fp32()
    cell = smoke_cell(workload)
    cfg = cell.cfg
    from repro_torch.models import Model
    model = Model(run.arch_config(cfg), "cpu")
    w = weights.draw(model.abstract_params(), seed, "cpu", torch.float32)
    ref = spec.reference_model(cfg["family"])(cfg, w)
    return cfg, model, w, ref


def _ref_logits(ref, seq, start, ctx=None):
    return torch.cat([lg for _, lg in ref.logits(
        torch.as_tensor(seq), start, ctx)])


@pytest.mark.parametrize("workload", WORKLOADS)
def test_prefill_then_decode_equal_the_reference(workload):
    cfg, model, w, ref = _setup(workload)
    params = model.prepare_params(w)
    prompt = generator.prompt_tokens(5, 0, 19, cfg["arch"]["vocab"])
    n_new = 12
    cache = model.init_cache(1, 64)
    with torch.no_grad():
        logits, cache = model.prefill(
            params, {"tokens": torch.as_tensor(prompt[None])}, cache)
        got = [logits[0]]
        tok = logits.argmax(-1).to(torch.int32)
        toks = [int(tok)]
        for _ in range(n_new - 1):
            logits, cache = model.decode_step(params, cache, tokens=tok)
            got.append(logits[0])
            tok = logits.argmax(-1).to(torch.int32)
            toks.append(int(tok))
        seq = np.concatenate([prompt, np.asarray(toks[:-1], np.int32)])
        want = _ref_logits(ref, seq, len(prompt) - 1,
                           {"prompt_len": len(prompt),
                            "capacity_len": len(prompt)})
    got = torch.stack(got)
    assert got.shape == want.shape
    assert torch.allclose(got, want, atol=2e-4, rtol=1e-4), \
        (got - want).abs().max()


def _skewed(w):
    """Every token's embedding nearly the same: every token routes alike,
    so the experts it picks overflow their capacity."""
    tok = w["embed"]["tok"]
    w["embed"]["tok"] = tok[:1] + 0.01 * torch.randn(
        tok.shape, generator=torch.Generator().manual_seed(0))
    return w


def test_moe_capacity_is_the_ports_at_the_padded_bucket():
    cfg, model, w, _ = _setup("granite-moe-1b-a400m.chat-rate")
    w = _skewed(w)
    ref_cls = spec.reference_model(cfg["family"])
    ref = ref_cls(cfg, w)
    params = model.prepare_params(w)
    prompt = generator.prompt_tokens(9, 1, 40, cfg["arch"]["vocab"])
    bucket = 64
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :len(prompt)] = prompt
    with torch.no_grad():
        logits, _ = model.prefill(
            params, {"tokens": torch.as_tensor(toks)},
            model.init_cache(1, 128),
            last_index=torch.tensor([len(prompt) - 1]))
        at_bucket = _ref_logits(ref, prompt, len(prompt) - 1,
                                {"prompt_len": len(prompt),
                                 "capacity_len": bucket})[0]
        exact = _ref_logits(ref, prompt, len(prompt) - 1,
                            {"prompt_len": len(prompt),
                             "capacity_len": len(prompt)})[0]
        dropless = _ref_logits(ref, prompt, len(prompt) - 1, None)[0]
    assert torch.allclose(logits[0], at_bucket, atol=2e-4, rtol=1e-4)
    # the rule matters at these sizes: another capacity, or none, reads
    # other logits
    assert (logits[0] - exact).abs().max() > 1e-3
    assert (logits[0] - dropless).abs().max() > 1e-3


def test_capacity_hand_worked():
    # granite: 32 experts, top 8, factor 1.25
    assert capacity(1, 8, 1.25, 32) == 8
    assert capacity(1024, 8, 1.25, 32) == 320
    assert capacity(100, 8, 1.25, 32) == 32      # int(31.25) = 31 -> 32
    assert capacity(64, 2, 1.25, 8) == 24


def test_reference_reads_weights_it_was_given():
    """The reference is the model of its weight tree: other weights, other
    logits (it derives nothing from the program)."""
    cfg, _, w, ref = _setup("qwen2-0.5b.reason-batch", seed=1)
    _, _, w2, ref2 = _setup("qwen2-0.5b.reason-batch", seed=2)
    seq = generator.prompt_tokens(1, 1, 12, cfg["arch"]["vocab"])
    a = _ref_logits(ref, seq, 0)
    b = _ref_logits(ref2, seq, 0)
    assert (a - b).abs().max() > 0.1


def test_fp8_rounding():
    x = torch.tensor([0.0, 1.0, -3.0, 448.0, 1e-3])
    y = fp8_round(x)
    assert y[0] == 0 and y[3] == 448.0
    assert torch.allclose(y, x, rtol=0.07, atol=1e-3)
    # three mantissa bits: 1 + 1/16 is not kept
    assert fp8_round(torch.tensor([1.0 + 1 / 16, 448.0]))[0] != 1 + 1 / 16
