"""Embeddings input (qwen2-vl-72b's smoke config: the caller's patch and
text embeddings instead of a token table, M-RoPE over (t, h, w), an
untied LM head) against the JAX reference, live, on the reference's own
weights (CPU).

Inputs come from numpy seeds: 2 rows of a 3 x 3 image grid (t fixed, h
and w the patch's row and column) followed by 5 text positions, where
all three position streams advance together; then 8 decode steps fed
embeddings.  Tolerances as in ``test_torch_encdec``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import steps as jsteps
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models.layers import head_matrix
from repro_torch.models.params import tree_leaves
from test_torch_encdec import (BF16_REL, GRAD_FLOOR, LOGIT_ATOL,
                               CaptureGrads, assert_caches_close,
                               assert_checkpoints_cross, assert_logits_close,
                               assert_loss_and_grads_match, jbatch,
                               make_pair, tbatch)
from test_torch_encdec import one_torch_thread  # noqa: F401 (autouse)

ARCH = "qwen2-vl-72b"
B, GRID, TEXT, STEPS = 2, 3, 5, 8
PLEN = GRID * GRID + TEXT
MAX_LEN = 32
PAGE = 8


def vision_positions(b=B, grid=GRID, text=TEXT):
    """(b, grid² + text, 3) M-RoPE positions: the image's patches at
    (0, row, column), then text at (p, p, p) from p = grid on."""
    rows, cols = np.divmod(np.arange(grid * grid), grid)
    image = np.stack([np.zeros_like(rows), rows, cols], -1)
    p = grid + np.arange(text)
    pos = np.concatenate([image, np.stack([p, p, p], -1)])
    return np.broadcast_to(pos, (b,) + pos.shape).astype(np.int32).copy()


def _batch(cfg, seed=0, s=PLEN, positions=True):
    rng = np.random.default_rng(seed)
    batch = {"embeds": rng.standard_normal((B, s, cfg.d_model)).astype(
        np.float32)}
    if positions:
        batch["positions"] = vision_positions()
    return batch


def _step_embeds(cfg, seed=1, steps=STEPS):
    return np.random.default_rng(seed).standard_normal(
        (steps, B, cfg.d_model)).astype(np.float32)


@pytest.fixture(scope="module")
def fp32():
    """The fp32 pair and the reference's run: prefill of the vision
    batch into a per-slot cache, then ``STEPS`` steps fed embeddings
    (logits after each, the cache at the end)."""
    jm, jp, tm, tp, tp32 = make_pair(ARCH)
    batch, steps = _batch(jm.cfg), _step_embeds(jm.cfg)
    logits, cache = jax.jit(jm.prefill)(
        jp, jbatch(batch), jm.init_cache(B, MAX_LEN, per_slot=True))
    prefill = (logits, cache)
    step = jax.jit(jm.decode_step)
    chain = []
    for e in steps:
        logits, cache = step(jp, cache, embeds=jnp.asarray(e))
        chain.append(np.asarray(logits))
    return dict(jm=jm, jp=jp, tm=tm, tp=tp, tp32=tp32, batch=batch,
                steps=steps, prefill=prefill, chain=chain, cache=cache)


@pytest.mark.parametrize("positions", [True, False])
def test_forward_in_train_mode_matches_reference(fp32, positions):
    """Hidden states with the image grid's M-RoPE positions, and with
    the default positions (every stream 0..S-1)."""
    batch = _batch(fp32["jm"].cfg, seed=2, positions=positions)
    jh, _, _ = fp32["jm"].forward(fp32["jp"], jbatch(batch), mode="train")
    th, _, _ = fp32["tm"].forward(fp32["tp"], tbatch(batch), mode="train")
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0,
                               atol=1e-5)


def test_positions_reach_the_rotary_streams(fp32):
    """The grid's positions give other logits than the default ones: the
    h and w streams rotate their own sections."""
    tm, tp = fp32["tm"], fp32["tp"]
    grid = tbatch(fp32["batch"])
    flat = {"embeds": grid["embeds"]}
    a, _ = tm.prefill(tp, grid, tm.init_cache(B, MAX_LEN))
    b, _ = tm.prefill(tp, flat, tm.init_cache(B, MAX_LEN))
    assert (a - b).abs().max().item() > 1e-3


def test_prefill_logits_and_every_cache_leaf(fp32):
    tm = fp32["tm"]
    logits, cache = tm.prefill(fp32["tp"], tbatch(fp32["batch"]),
                               tm.init_cache(B, MAX_LEN, per_slot=True))
    jl, jc = fp32["prefill"]
    assert_logits_close(logits, jl)
    assert_caches_close(cache, jc)


def _port_chain(fp32, cache, **kw):
    tm, tp = fp32["tm"], fp32["tp"]
    out = []
    for e in fp32["steps"]:
        logits, cache = tm.decode_step(tp, cache, embeds=torch.from_numpy(e),
                                       **kw)
        out.append(logits)
    return out, cache


@pytest.mark.parametrize("ragged", [False, True])
def test_decode_chain_matches_reference(fp32, ragged):
    """Eight steps fed embeddings at positions ``idx`` on all three
    streams: logits within 1e-4 and the same greedy token at every
    step, every cache leaf at the end; ``ragged`` through the decode
    kernel's plain version against the reference's
    ``attention_decode``."""
    tm = fp32["tm"]
    _, cache = tm.prefill(fp32["tp"], tbatch(fp32["batch"]),
                          tm.init_cache(B, MAX_LEN, per_slot=True))
    chain, cache = _port_chain(fp32, cache, use_ragged_kernel=ragged)
    for t, j in zip(chain, fp32["chain"]):
        assert_logits_close(t, j)
        np.testing.assert_array_equal(t.numpy().argmax(-1), j.argmax(-1))
    assert_caches_close(cache, fp32["cache"])


def _paged_copy(cache, gen):
    """The contiguous per-slot ``cache`` scattered over scrambled pages
    of ``PAGE`` rows with a page table, in the paged layout."""
    max_pages = MAX_LEN // PAGE
    perm = torch.randperm(B * max_pages, generator=gen)
    paged = {"idx": cache["idx"].clone(),
             "pt": perm.reshape(B, max_pages).int()}

    def pages(leaf):                      # (L, B, S, H, dh) body leaf
        split = leaf.reshape(leaf.shape[0], B * max_pages, PAGE,
                             *leaf.shape[3:])
        out = torch.empty_like(split)
        out[:, perm] = split
        return out

    paged["stack"] = {"prefix": [], "body": [
        {"attn": {k: pages(v) for k, v in blk["attn"].items()}}
        for blk in cache["stack"]["body"]]}
    return paged


def test_paged_decode_equals_contiguous(fp32):
    """The prefilled cache copied onto scrambled pages: eight steps
    through the paged kernel's plain version give the contiguous
    kernel's plain version's logits (1e-6), and the paged and the
    contiguous chains both give the reference's within 1e-4 (the paged
    one also through ``attention_decode_paged``)."""
    tm = fp32["tm"]
    _, cache = tm.prefill(fp32["tp"], tbatch(fp32["batch"]),
                          tm.init_cache(B, MAX_LEN, per_slot=True))
    paged = [_paged_copy(cache, torch.Generator().manual_seed(seed))
             for seed in (0, 1)]
    contiguous, _ = _port_chain(fp32, cache, use_ragged_kernel=True)
    kernel, _ = _port_chain(fp32, paged[0], use_ragged_kernel=True)
    plain, _ = _port_chain(fp32, paged[1])
    for c, k, p, j in zip(contiguous, kernel, plain, fp32["chain"]):
        np.testing.assert_allclose(k.numpy(), c.numpy(), rtol=0, atol=1e-6)
        assert_logits_close(k, j)
        assert_logits_close(p, j)


def test_decode_chain_reproduces_the_full_forward(fp32):
    """Prefill of 6 positions and decode steps over the rest, default
    positions, give the logits of one full forward over all 14."""
    tm, tp = fp32["tm"], fp32["tp"]
    total = 14
    embeds = torch.from_numpy(_batch(tm.cfg, seed=5, s=total,
                                     positions=False)["embeds"])
    h, _, _ = tm.forward(tp, {"embeds": embeds}, mode="train")
    ref = (h @ head_matrix(tp["embed"], tm.cfg)).float()
    logits, cache = tm.prefill(tp, {"embeds": embeds[:, :6]},
                               tm.init_cache(B, total + 2))
    chain = [logits]
    for t in range(6, total - 1):
        logits, cache = tm.decode_step(tp, cache, embeds=embeds[:, t])
        chain.append(logits)
    for i, lg in enumerate(chain):
        np.testing.assert_allclose(lg.numpy(), ref[:, 5 + i].numpy(),
                                   rtol=0, atol=LOGIT_ATOL)


def test_bf16_decode_chain_within_stated_tolerance():
    jm, jp, tm, tp, _ = make_pair(ARCH, "bfloat16")
    batch, steps = _batch(jm.cfg, seed=6), _step_embeds(jm.cfg, seed=7)
    jl, jc = jax.jit(jm.prefill)(jp, jbatch(batch), jm.init_cache(B, MAX_LEN))
    tl, tc = tm.prefill(tp, tbatch(batch), tm.init_cache(B, MAX_LEN))
    step = jax.jit(jm.decode_step)
    for e in list(steps) + [None]:
        j = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), j, rtol=0,
                                   atol=BF16_REL * np.abs(j).max())
        if e is None:
            break
        jl, jc = step(jp, jc, embeds=jnp.asarray(e, jnp.bfloat16))
        tl, tc = tm.decode_step(tp, tc, embeds=torch.from_numpy(e).to(
            torch.bfloat16))


@pytest.mark.parametrize("remat", [True, False])
def test_loss_fn_value_and_every_grad_match_reference(fp32, remat):
    batch = dict(fp32["batch"], labels=np.random.default_rng(8).integers(
        0, fp32["tm"].cfg.vocab, (B, PLEN)).astype(np.int32))
    assert_loss_and_grads_match(fp32["jm"], fp32["jp"], fp32["tm"],
                                fp32["tp32"], batch, remat)


def test_train_step_splits_embeds_batches(fp32):
    """``make_train_step`` with two microbatches of an embeddings batch
    (embeddings and M-RoPE positions split with the labels): the
    gradients of one step on the whole batch, within 1e-5 of each leaf's
    largest gradient (floored as in ``test_torch_encdec``)."""
    labels = np.random.default_rng(9).integers(
        0, fp32["tm"].cfg.vocab, (B, PLEN)).astype(np.int32)
    batch = tbatch(dict(fp32["batch"], labels=labels))
    out = []
    for accum in (1, 2):
        opt = CaptureGrads()
        make_train_step(fp32["tm"], opt, accum_steps=accum)(
            fp32["tp32"], None, batch)
        out.append(tree_leaves(opt.grads, torch.is_tensor))
    floor = GRAD_FLOOR * max(g.abs().max().item() for g in out[0])
    for a, b in zip(*out):
        assert (a - b).abs().max().item() <= 1e-5 * max(
            b.abs().max().item(), floor)


def test_step_builders_take_embeddings(fp32):
    """``make_prefill_step`` then ``make_decode_step``'s embeddings
    branch against repro's builders."""
    jm, jp, tm, tp = fp32["jm"], fp32["jp"], fp32["tm"], fp32["tp"]
    jl, jc = jsteps.make_prefill_step(jm)(jp, jbatch(fp32["batch"]),
                                          jm.init_cache(B, MAX_LEN))
    tl, tc = make_prefill_step(tm)(tp, tbatch(fp32["batch"]),
                                   tm.init_cache(B, MAX_LEN))
    assert_logits_close(tl, jl)
    e = fp32["steps"][0]
    jl, _ = jsteps.make_decode_step(jm)(jp, jc, jnp.asarray(e))
    tl, _ = make_decode_step(tm)(tp, tc, torch.from_numpy(e))
    assert_logits_close(tl, jl)


def test_checkpoints_cross_the_packages(fp32, tmp_path):
    assert_checkpoints_cross(tmp_path, fp32["jp"], fp32["tp32"])


def test_fused_horizon_refuses_embeddings_input(fp32):
    with pytest.raises(ValueError, match="token models"):
        fp32["tm"].decode_horizon(fp32["tp"], {}, {}, horizon=2,
                                  max_len=MAX_LEN)
