"""The port's shared layers against the JAX reference's, on the same numpy
inputs at fp32 (CPU): norms, RoPE (full, partial, M-RoPE), the dense FFNs,
the embedding lookup and the tied head.  Tolerance atol 1e-6: the same
fp32 arithmetic in both frameworks, up to the order of matmul sums."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import layers as jl
from repro_torch.configs import get_smoke_config
from repro_torch.models import layers as tl

ATOL = 1e-6


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                               atol=atol)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm(kind):
    rng = np.random.default_rng(0)
    x = _rand(rng, 2, 5, 48, scale=3.0) + 0.5
    p = {"scale": _rand(rng, 48) + 1.0, "bias": _rand(rng, 48)}
    if kind == "rmsnorm":
        del p["bias"]
    out_t = tl.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                          torch.from_numpy(x), kind)
    out_j = jl.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(x), kind)
    _close(out_t, out_j)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "stablelm-1.6b",
                                  "qwen2-vl-72b"],
                         ids=["full", "partial", "mrope"])
def test_apply_rope(arch):
    """Full rotation (theta 1e6), stablelm's 25% partial rotation, and
    qwen2-vl's sectioned M-RoPE with three position streams."""
    jcfg = dataclasses.replace(jax_smoke_config(arch),
                               compute_dtype="float32")
    tcfg = get_smoke_config(arch)
    rng = np.random.default_rng(1)
    b, s, h, dh = 2, 7, 3, tcfg.head_dim
    x = _rand(rng, b, s, h, dh)
    shape = (b, s, 3) if tcfg.pos == "mrope" else (b, s)
    pos = rng.integers(0, 5000, size=shape).astype(np.int32)
    out_t = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), tcfg)
    out_j = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), jcfg)
    _close(out_t, out_j, atol=2e-6)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_apply_ffn(act):
    rng = np.random.default_rng(2)
    d, f = 24, 40
    p = {"w_gate": _rand(rng, d, f, scale=d ** -0.5),
         "w_up": _rand(rng, d, f, scale=d ** -0.5),
         "w_down": _rand(rng, f, d, scale=f ** -0.5)}
    if act == "gelu":
        del p["w_gate"]
    x = _rand(rng, 2, 3, d)
    out_t = tl.apply_ffn({k: torch.from_numpy(v) for k, v in p.items()},
                         torch.from_numpy(x), act)
    out_j = jl.apply_ffn({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), act)
    _close(out_t, out_j)


def test_embed_tokens_and_tied_head():
    tcfg = get_smoke_config("qwen2-0.5b")
    jcfg = jax_smoke_config("qwen2-0.5b")
    rng = np.random.default_rng(3)
    p = {"tok": _rand(rng, tcfg.vocab, tcfg.d_model, scale=0.02)}
    toks = rng.integers(0, tcfg.vocab, size=(2, 9)).astype(np.int32)
    emb_t = tl.embed_tokens({"tok": torch.from_numpy(p["tok"])},
                            torch.from_numpy(toks).long(), tcfg)
    emb_j = jl.embed_tokens({"tok": jnp.asarray(p["tok"])},
                            jnp.asarray(toks), jcfg)
    assert emb_t.dtype == torch.bfloat16
    np.testing.assert_array_equal(emb_t.float().numpy(),
                                  np.asarray(emb_j.astype(jnp.float32)))
    head_t = tl.head_matrix({"tok": torch.from_numpy(p["tok"])}, tcfg)
    head_j = jl.head_matrix({"tok": jnp.asarray(p["tok"])}, jcfg)
    np.testing.assert_array_equal(head_t.numpy(), np.asarray(head_j))


def test_untied_head():
    tcfg = dataclasses.replace(get_smoke_config("qwen2-0.5b"),
                               tie_embeddings=False)
    head = torch.ones(tcfg.d_model, tcfg.vocab)
    assert tl.head_matrix({"tok": None, "head": head}, tcfg) is head
    assert set(tl.embed_specs(tcfg)) == {"tok", "head"}
