"""``Model.loss_fn`` and its gradients against ``jax.value_and_grad`` of
repro's, live, on the reference's own weights (CPU, smoke configs,
(2, 32) batches), remat on and off: qwen2-0.5b (dense attention, qkv
bias), granite-moe-1b-a400m (MoE, with ``moe_aux``) and xlstm-1.3b
(mLSTM and sLSTM); recurrentgemma-2b has a file of its own
(``test_torch_train_recurrent.py``).  Also the train step's gradient
accumulation.

Tolerances at fp32: the loss within 1e-5 relative; every gradient leaf
within 1e-4 of its own largest magnitude, with a floor of 1e-3 of the
model's largest gradient: a leaf whose exact gradient is zero (the
sLSTM input-gate bias, which the stabiliser cancels) holds rounding
noise of about 1e-9 in both packages, and the floor keeps that from
counting as a mismatch.  At bf16 the loss is held to 1e-2 relative: both
frameworks round every activation to 8 mantissa bits, at different
points.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.model import Model as JModel
from repro_torch.launch.steps import make_train_step, value_and_grad
from repro_torch.models.model import Model
from repro_torch.models.params import from_numpy, tree_leaves
from test_torch_model import port_config

LOSS_REL_TOL = 1e-5
GRAD_REL_TOL = 1e-4
GRAD_FLOOR = 1e-3
BF16_LOSS_REL_TOL = 1e-2
ARCHS = ["qwen2-0.5b", "granite-moe-1b-a400m", "xlstm-1.3b"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The smoke-size tensors gain nothing from torch's intra-op threads,
    and beside other test workers those threads oversubscribe the cores
    (a step of many small ops then runs tens of times slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def pair(arch, dtype="float32"):
    """(JAX model, JAX params, port model, port fp32 params, batch)."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), compute_dtype=dtype)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(port_config(jcfg), device="cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, jcfg.vocab, (2, 32)).astype(np.int32),
             "labels": rng.integers(0, jcfg.vocab, (2, 32)).astype(np.int32)}
    return jm, jp, tm, from_numpy(jax.device_get(jp)), batch


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def assert_loss_and_grads_match(arch, remat):
    jm, jp, tm, tp, batch = pair(arch)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss_fn(p, b, remat=remat), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    (loss, metrics), grads = value_and_grad(tm, tp, torch_batch(batch),
                                            remat=remat)
    assert sorted(metrics) == sorted(jmet)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmet[k]),
                                   rtol=LOSS_REL_TOL, err_msg=k)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_REL_TOL)
    tg = [g.numpy() for g in tree_leaves(grads, torch.is_tensor)]
    jg = [np.asarray(g, np.float32) for g in jax.tree.leaves(jgrads)]
    assert [g.shape for g in tg] == [g.shape for g in jg]
    floor = GRAD_FLOOR * max(float(np.abs(g).max()) for g in jg)
    for i, (a, b) in enumerate(zip(tg, jg)):
        scale = max(float(np.abs(b).max()), floor)
        err = float(np.abs(a - b).max())
        assert err <= GRAD_REL_TOL * scale, (arch, remat, i, err, scale)


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_value_and_every_grad_match_reference(arch, remat):
    assert_loss_and_grads_match(arch, remat)


def test_moe_loss_carries_the_aux_term():
    _, _, tm, tp, batch = pair("granite-moe-1b-a400m")
    loss, m = tm.loss_fn(tp, torch_batch(batch))
    assert float(m["moe_aux"]) > 0
    expect = m["nll"] + tm.cfg.moe.aux_loss_coef * m["moe_aux"]
    assert torch.equal(loss, expect)


@pytest.mark.parametrize("cast_params_once", [False, True])
def test_bf16_loss_within_stated_tolerance(cast_params_once):
    """bf16 compute, the weights cast at each use or once up front (every
    fp32 leaf of rank >= 2, the gates' too, as the reference does)."""
    jm, jp, tm, tp, batch = pair("qwen2-0.5b", "bfloat16")
    jloss, _ = jax.jit(lambda p, b: jm.loss_fn(
        p, b, cast_params_once=cast_params_once))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        loss, _ = tm.loss_fn(tp, torch_batch(batch),
                             cast_params_once=cast_params_once)
    np.testing.assert_allclose(float(loss), float(jloss),
                               rtol=BF16_LOSS_REL_TOL)


class _CaptureGrads:
    """Stands in for the optimizer: keeps the step's gradients."""

    def step(self, grads, state, params):
        self.grads = grads
        return params, state, torch.zeros(())


def test_train_step_accumulation_equals_one_step():
    """``accum_steps=2`` (two microbatches, fp32 accumulation, the mean)
    gives the gradients and metrics of ``accum_steps=1`` on the whole
    batch within fp32 rounding (1e-5 of each leaf's largest gradient,
    floored as above)."""
    _, _, tm, tp, batch = pair("qwen2-0.5b")
    out = []
    for accum in (1, 2):
        opt = _CaptureGrads()
        step = make_train_step(tm, opt, accum_steps=accum)
        _, _, metrics = step(tp, None, torch_batch(batch))
        out.append((tree_leaves(opt.grads, torch.is_tensor), metrics))
    (g1, m1), (g2, m2) = out
    # the reference averages every metric over the microbatches, the
    # token count too
    assert float(m2.pop("n_tokens")) == float(m1.pop("n_tokens")) / 2
    for k in m1:
        np.testing.assert_allclose(float(m2[k]), float(m1[k]), rtol=1e-5,
                                   err_msg=k)
    floor = GRAD_FLOOR * max(float(g.abs().max()) for g in g1)
    for a, b in zip(g1, g2):
        assert b.dtype == torch.float32
        scale = max(float(a.abs().max()), floor)
        assert float((a - b).abs().max()) <= 1e-5 * scale
