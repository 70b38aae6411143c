"""The prefill and decode step builders of ``launch/steps.py`` against
repro's, live, on the CPU: qwen2-0.5b's smoke config at fp32 on the
reference's own weights, prefill of 2 rows into a per-slot cache under
both kv-block schedules (``skip_future``), then two decode steps.

Tolerances, as in ``test_torch_model.py``: logits within 1e-4, every
cache leaf within 1e-5 (sums run in other orders), positions exact.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch import steps as jsteps
from repro.models.model import Model as JModel
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models.model import Model
from repro_torch.models.params import from_numpy
from test_torch_model import LOGIT_ATOL, _assert_caches_close, port_config


@functools.lru_cache(maxsize=None)
def pair():
    """(JAX model, JAX params, port model, port params) of qwen2's smoke
    config at fp32."""
    jcfg = dataclasses.replace(jax_smoke_config("qwen2-0.5b"),
                               compute_dtype="float32")
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, Model(port_config(jcfg), device="cpu"), from_numpy(
        jax.device_get(jp))


@pytest.mark.parametrize("skip_future", [False, True])
def test_prefill_and_decode_steps_match_reference(skip_future):
    """Logits and every cache leaf after the prefill step and after each
    of two decode steps fed the reference's greedy tokens."""
    jm, jp, tm, tp = pair()
    toks = np.random.default_rng(0).integers(1, 128, (2, 12)).astype(
        np.int32)
    j_logits, jc = jsteps.make_prefill_step(jm, skip_future=skip_future)(
        jp, {"tokens": jnp.asarray(toks)}, jm.init_cache(2, 16, per_slot=True))
    t_logits, tc = make_prefill_step(tm, skip_future=skip_future)(
        tp, {"tokens": torch.from_numpy(toks)},
        tm.init_cache(2, 16, per_slot=True))
    j_decode, t_decode = jsteps.make_decode_step(jm), make_decode_step(tm)
    for step in range(3):
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                                   rtol=0, atol=LOGIT_ATOL)
        _assert_caches_close(tc, jc)
        if step == 2:
            break
        nxt = np.asarray(j_logits).argmax(-1).astype(np.int32)
        j_logits, jc = j_decode(jp, jc, jnp.asarray(nxt))
        t_logits, tc = t_decode(tp, tc, torch.from_numpy(nxt))
