"""The encoder-decoder path (seamless-m4t-large-v2's smoke config: a
bidirectional encoder over frame embeddings, a decoder with
cross-attention) against the JAX reference, live, on the reference's own
weights (CPU).

Inputs come from numpy seeds: 2 rows of 12 encoder frames, decoder
prompts of 6 tokens, then 8 greedy decode steps.  Tolerances, as in
``test_torch_model`` and ``test_torch_train_model``: at fp32 logits
within atol 1e-4, cache leaves within 1e-5, greedy tokens exact; at bf16
logits within 2e-2 of the largest logit (both frameworks round every
activation to 8 mantissa bits, at different points); the loss within
1e-5 relative and every gradient leaf within 1e-4 of its own largest
magnitude, floored at 1e-3 of the model's largest gradient.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import CheckpointManager as JCheckpoint
from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch import steps as jsteps
from repro.models.model import Model as JModel
from repro.optim.adamw import AdamW as JAdamW
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step, value_and_grad)
from repro_torch.models import model as model_module
from repro_torch.models import transformer
from repro_torch.models.attention import attention_reference
from repro_torch.models.layers import head_matrix
from repro_torch.models.model import Model
from repro_torch.models.params import (from_numpy, to_numpy, tree_leaves,
                                       tree_map)
from test_torch_model import port_config

ARCH = "seamless-m4t-large-v2"
LOGIT_ATOL = 1e-4
CACHE_ATOL = 1e-5
BF16_REL = 2e-2
LOSS_REL_TOL = 1e-5
GRAD_REL_TOL = 1e-4
GRAD_FLOOR = 1e-3
B, SE, PLEN, STEPS = 2, 12, 6, 8
MAX_LEN = PLEN + STEPS + 2


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Smoke-size tensors gain nothing from intra-op threads, and beside
    other test workers those threads oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_pair(arch, dtype="float32"):
    """(JAX model, JAX params, port model, port params on the CPU in the
    compute dtype, port fp32 params) of one smoke config."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), compute_dtype=dtype)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(port_config(jcfg), device="cpu")
    fp32 = from_numpy(jax.device_get(jp))
    return jm, jp, tm, tm.prepare_params(fp32), fp32


def jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def np_leaves(tree):
    if any(torch.is_tensor(x) for x in tree_leaves(tree, torch.is_tensor)):
        tree = to_numpy(tree)
    return [np.asarray(a, np.float32) for a in jax.tree.leaves(tree)]


def assert_caches_close(tcache, jcache, atol=CACHE_ATOL):
    t, j = np_leaves(tcache["stack"]), np_leaves(jcache["stack"])
    assert [a.shape for a in t] == [b.shape for b in j]
    for a, b in zip(t, j):
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)
    np.testing.assert_array_equal(tcache["idx"].numpy(),
                                  np.asarray(jcache["idx"]))


def assert_logits_close(t, j, atol=LOGIT_ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=atol)


def assert_loss_and_grads_match(jm, jp, tm, tp32, batch, remat):
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss_fn(p, b, remat=remat), has_aux=True))(
        jp, jbatch(batch))
    (loss, metrics), grads = value_and_grad(tm, tp32, tbatch(batch),
                                            remat=remat)
    assert sorted(metrics) == sorted(jmet)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmet[k]),
                                   rtol=LOSS_REL_TOL, err_msg=k)
    tg = [g.numpy() for g in tree_leaves(grads, torch.is_tensor)]
    jg = [np.asarray(g, np.float32) for g in jax.tree.leaves(jgrads)]
    assert [g.shape for g in tg] == [g.shape for g in jg]
    floor = GRAD_FLOOR * max(float(np.abs(g).max()) for g in jg)
    for i, (a, b) in enumerate(zip(tg, jg)):
        scale = max(float(np.abs(b).max()), floor)
        err = float(np.abs(a - b).max())
        assert err <= GRAD_REL_TOL * scale, (remat, i, err, scale)


def assert_checkpoints_cross(tmp_path, jp, tp32):
    """A {"params", "opt_state"} tree written by either package's
    CheckpointManager restores in the other's bit for bit."""
    jstate = {"params": jp, "opt_state": JAdamW().init(jp)}
    state = from_numpy(jax.device_get(jstate))
    JCheckpoint(str(tmp_path / "ref")).save(5, jstate)
    like = tree_map(torch.zeros_like, state, torch.is_tensor)
    step, out = CheckpointManager(str(tmp_path / "ref")).restore_latest(like)
    assert step == 5
    for a, b in zip(tree_leaves(out, torch.is_tensor),
                    tree_leaves(state, torch.is_tensor)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    CheckpointManager(str(tmp_path / "port")).save(3, state)
    back = JCheckpoint(str(tmp_path / "port")).restore(3, jstate)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _batch(cfg, seed=0, plen=PLEN, se=SE):
    rng = np.random.default_rng(seed)
    return {"enc_embeds": rng.standard_normal(
                (B, se, cfg.d_model)).astype(np.float32),
            "tokens": rng.integers(1, cfg.vocab, (B, plen)).astype(np.int32)}


@pytest.fixture(scope="module")
def fp32():
    """The fp32 pair and the reference's run: prefill into a cache of
    ``enc_len = SE``, then ``STEPS`` greedy decode steps (logits and
    caches after the prefill and the last step)."""
    jm, jp, tm, tp, tp32 = make_pair(ARCH)
    batch = _batch(jm.cfg)
    logits, cache = jax.jit(jm.prefill)(
        jp, jbatch(batch), jm.init_cache(B, MAX_LEN, enc_len=SE))
    prefill = (logits, cache)
    step = jax.jit(jm.decode_step)
    chain, toks = [], []
    for _ in range(STEPS):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        logits, cache = step(jp, cache, tokens=tok)
        toks.append(np.asarray(tok))
        chain.append(np.asarray(logits))
    return dict(jm=jm, jp=jp, tm=tm, tp=tp, tp32=tp32, batch=batch,
                prefill=prefill, toks=toks, chain=chain, cache=cache)


def test_forward_in_train_mode_matches_reference(fp32):
    """Encoder and decoder, no cache: the final hidden states."""
    jh, _, _ = fp32["jm"].forward(fp32["jp"], jbatch(fp32["batch"]),
                                  mode="train")
    th, _, _ = fp32["tm"].forward(fp32["tp"], tbatch(fp32["batch"]),
                                  mode="train")
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0,
                               atol=CACHE_ATOL)


def test_prefill_logits_and_every_cache_leaf(fp32):
    """Self-attention k/v (the prompt rows) and the cross caches (the
    encoder's projected k/v, all SE rows) of every layer, and idx."""
    tm = fp32["tm"]
    logits, cache = tm.prefill(fp32["tp"], tbatch(fp32["batch"]),
                               tm.init_cache(B, MAX_LEN, enc_len=SE))
    jl, jc = fp32["prefill"]
    assert_logits_close(logits, jl)
    assert_caches_close(cache, jc)
    cross = cache["stack"]["body"][0]["cross"]["k"]
    assert tuple(cross.shape) == (tm.cfg.n_layers, B, SE,
                                  tm.cfg.n_kv_heads, tm.cfg.head_dim)
    assert cross.abs().amin(dim=(0, 1, 3, 4)).gt(0).all()


@pytest.mark.parametrize("ragged", [False, True])
def test_greedy_decode_chain_matches_reference(fp32, ragged):
    """Eight greedy steps: the port's own argmax fed back gives the
    reference's tokens exactly, logits within 1e-4 at every step, and
    every cache leaf at the end.  ``ragged``: self- and cross-attention
    through the decode kernels' plain versions (the card's route),
    against the reference's ``attention_decode``."""
    tm, tp = fp32["tm"], fp32["tp"]
    logits, cache = tm.prefill(tp, tbatch(fp32["batch"]),
                               tm.init_cache(B, MAX_LEN, enc_len=SE))
    toks = []
    for j in fp32["chain"]:
        tok = logits.argmax(-1).int()
        toks.append(tok.numpy())
        logits, cache = tm.decode_step(tp, cache, tokens=tok,
                                       use_ragged_kernel=ragged)
        assert_logits_close(logits, j)
    np.testing.assert_array_equal(np.stack(toks), np.stack(fp32["toks"]))
    assert_caches_close(cache, fp32["cache"])


def test_decode_chain_reproduces_the_full_forward(fp32):
    """The reference's strongest cache check: prefill of 6 tokens and
    decode steps over the rest give the logits of one full forward over
    all 14 (fp32, atol 1e-4)."""
    tm, tp = fp32["tm"], fp32["tp"]
    total = PLEN + STEPS
    rng = np.random.default_rng(3)
    tokens = rng.integers(1, tm.cfg.vocab, (B, total)).astype(np.int32)
    full = dict(tbatch(fp32["batch"]), tokens=torch.from_numpy(tokens))
    h, _, _ = tm.forward(tp, full, mode="train")
    ref = (h @ head_matrix(tp["embed"], tm.cfg)).float()
    logits, cache = tm.prefill(tp, dict(full, tokens=full["tokens"][:, :PLEN]),
                               tm.init_cache(B, total + 2, enc_len=SE))
    chain = [logits]
    for t in range(PLEN, total - 1):
        logits, cache = tm.decode_step(tp, cache, tokens=full["tokens"][:, t])
        chain.append(logits)
    for i, lg in enumerate(chain):
        np.testing.assert_allclose(lg.numpy(), ref[:, PLEN - 1 + i].numpy(),
                                   rtol=0, atol=LOGIT_ATOL)


def test_bf16_decode_chain_within_stated_tolerance():
    """bf16 compute: prefill and eight steps fed the reference's greedy
    tokens, logits within 2e-2 of the largest logit at every step."""
    jm, jp, tm, tp, _ = make_pair(ARCH, "bfloat16")
    batch = _batch(jm.cfg, seed=1)
    jl, jc = jax.jit(jm.prefill)(jp, jbatch(batch),
                                 jm.init_cache(B, MAX_LEN, enc_len=SE))
    tl, tc = tm.prefill(tp, tbatch(batch),
                        tm.init_cache(B, MAX_LEN, enc_len=SE))
    step = jax.jit(jm.decode_step)
    for _ in range(STEPS + 1):
        j = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), j, rtol=0,
                                   atol=BF16_REL * np.abs(j).max())
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jc = step(jp, jc, tokens=jnp.asarray(tok))
        tl, tc = tm.decode_step(tp, tc, tokens=torch.from_numpy(tok))


@pytest.mark.parametrize("enc_len", [5, 20])
def test_cross_cache_takes_the_encoders_length(fp32, enc_len):
    """A cache built for another encoder length: the reference's prefill
    replaces each cross leaf with the encoder's SE rows, and so does the
    port's; the leaves and the next step's logits agree."""
    jm, jp, tm, tp = fp32["jm"], fp32["jp"], fp32["tm"], fp32["tp"]
    batch = fp32["batch"]
    jl, jc = jax.jit(jm.prefill)(jp, jbatch(batch),
                                 jm.init_cache(B, MAX_LEN, enc_len=enc_len))
    cache = tm.init_cache(B, MAX_LEN, enc_len=enc_len)
    tl, tc = tm.prefill(tp, tbatch(batch), cache)
    assert tc["stack"]["body"][0]["cross"]["v"].shape[2] == SE
    assert_caches_close(tc, jc)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    jl, jc = jm.decode_step(jp, jc, tokens=jnp.asarray(tok))
    tl, tc = tm.decode_step(tp, tc, tokens=torch.from_numpy(tok))
    assert_logits_close(tl, jl)


@pytest.mark.parametrize("remat", [True, False])
def test_loss_fn_value_and_every_grad_match_reference(fp32, remat):
    batch = dict(fp32["batch"], labels=np.random.default_rng(4).integers(
        0, fp32["tm"].cfg.vocab, (B, PLEN)).astype(np.int32))
    assert_loss_and_grads_match(fp32["jm"], fp32["jp"], fp32["tm"],
                                fp32["tp32"], batch, remat)


def test_encoder_checkpoints_in_training_whatever_remat_says(fp32,
                                                             monkeypatch):
    """The reference's encoder runs ``apply_stack`` with its default
    ``remat=True`` inside every ``loss_fn``: with ``remat=False`` the
    port still checkpoints the encoder's periods (one per layer of the
    smoke config's 2), and nothing of the decoder."""
    calls = []
    real = transformer.checkpoint

    def counting(fn, *args, **kw):
        calls.append(fn)
        return real(fn, *args, **kw)

    monkeypatch.setattr(transformer, "checkpoint", counting)
    batch = dict(fp32["batch"], labels=fp32["batch"]["tokens"])
    value_and_grad(fp32["tm"], fp32["tp32"], tbatch(batch), remat=False)
    assert len(calls) == fp32["tm"].cfg.n_enc_layers
    calls.clear()
    value_and_grad(fp32["tm"], fp32["tp32"], tbatch(batch), remat=True)
    assert len(calls) == (fp32["tm"].cfg.n_enc_layers
                          + fp32["tm"].cfg.n_layers)


class CaptureGrads:
    """Stands in for the optimizer: keeps the step's gradients."""

    def step(self, grads, state, params):
        self.grads = grads
        return params, state, torch.zeros(())


def test_train_step_splits_enc_embeds_batches(fp32):
    """``make_train_step`` with two microbatches of an enc-dec batch (the
    frames split with the tokens): the gradients of one step on the whole
    batch, within 1e-5 of each leaf's largest gradient (floored as
    above)."""
    batch = tbatch(dict(fp32["batch"], labels=fp32["batch"]["tokens"]))
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


def test_step_builders_match_reference(fp32):
    """``make_prefill_step`` then ``make_decode_step`` (the token branch)
    against repro's builders."""
    jm, jp, tm, tp = fp32["jm"], fp32["jp"], fp32["tm"], fp32["tp"]
    batch = fp32["batch"]
    jl, jc = jsteps.make_prefill_step(jm)(
        jp, jbatch(batch), jm.init_cache(B, MAX_LEN, enc_len=SE))
    tl, tc = make_prefill_step(tm)(tp, tbatch(batch),
                                   tm.init_cache(B, MAX_LEN, enc_len=SE))
    assert_logits_close(tl, jl)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    jl, _ = jsteps.make_decode_step(jm)(jp, jc, jnp.asarray(tok))
    tl, _ = make_decode_step(tm)(tp, tc, torch.from_numpy(tok))
    assert_logits_close(tl, jl)


def test_checkpoints_cross_the_packages(fp32, tmp_path):
    assert_checkpoints_cross(tmp_path, fp32["jp"], fp32["tp32"])


def test_fused_horizon_refuses_encdec(fp32):
    with pytest.raises(ValueError, match="token models"):
        fp32["tm"].decode_horizon(fp32["tp"], {}, {}, horizon=2,
                                  max_len=MAX_LEN)


def test_encoder_length_past_the_references_chunk_limit(fp32, monkeypatch):
    """A limit of the reference, kept apart from the port: from 1024
    frames on the encoder takes ``attention_chunked``, which asserts that
    512 divides Se; at Se 1500 repro's prefill raises AssertionError,
    while the port's chunked attention takes a short tail block.  Its
    prefill logits and cross caches equal the same prefill's with every
    attention forced to the full-score ``attention_reference``."""
    batch = _batch(fp32["jm"].cfg, seed=9, plen=4, se=1500)
    with pytest.raises(AssertionError):
        fp32["jm"].prefill(fp32["jp"], jbatch(batch),
                           fp32["jm"].init_cache(B, 8, enc_len=1500))
    tm, tp = fp32["tm"], fp32["tp"]
    chunked = tm.prefill(tp, tbatch(batch), tm.init_cache(B, 8, enc_len=1500))
    monkeypatch.setattr(model_module, "select_attention",
                        lambda *a, **k: attention_reference)
    plain = tm.prefill(tp, tbatch(batch), tm.init_cache(B, 8, enc_len=1500))
    assert chunked[1]["stack"]["body"][0]["cross"]["k"].shape[2] == 1500
    assert_logits_close(chunked[0], plain[0].numpy())
    for layer, ref_layer in zip(chunked[1]["stack"]["body"],
                                plain[1]["stack"]["body"]):
        for name in ("k", "v"):
            np.testing.assert_allclose(layer["cross"][name].numpy(),
                                       ref_layer["cross"][name].numpy(),
                                       atol=CACHE_ATOL)
