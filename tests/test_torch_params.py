"""The weight bridge and the port's parameter specs against the JAX
reference: the same spec tree (shapes, axes, inits), a bit-exact round
trip of the reference's own weights, and the port's own init drawing the
reference's distributions."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import params as jparams_mod
from repro.models.model import Model as JModel
from repro.serve.engine import ContinuousEngine as JContinuous
from repro.serve.engine import ServeEngine as JWave
from repro_torch import serve as tserve
from repro_torch.configs import ARCHS as ALL_ARCHS
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.plan import EndpointPlan, SharingVector
from repro_torch.models import params as P
from repro_torch.models.model import Model
from repro_torch.serve.engine import ContinuousEngine, ServeEngine

ARCHS = ["qwen2-0.5b", "smollm-360m", "recurrentgemma-2b",
         "granite-moe-1b-a400m", "deepseek-moe-16b", "xlstm-1.3b",
         "stablelm-1.6b", "internlm2-1.8b", "seamless-m4t-large-v2",
         "qwen2-vl-72b"]
#: the configs the serving engines refuse, in the reference as here
NOT_SERVED = ["seamless-m4t-large-v2", "qwen2-vl-72b"]


def _flat_specs(tree, is_leaf):
    return [(s.shape, s.axes, s.init, s.scale, s.fan_in)
            for s in P.tree_leaves(tree, is_leaf)]


def _assert_same_spec_tree(jcfg, tcfg):
    jmodel, tmodel = JModel(jcfg), Model(tcfg, device="cpu")
    jspecs, tspecs = jmodel.param_specs(), tmodel.param_specs()
    jflat = [(s.shape, s.axes, s.init, s.scale, s.fan_in)
             for s in jax.tree.leaves(jspecs, is_leaf=jparams_mod.is_spec)]
    assert _flat_specs(tspecs, P.is_spec) == jflat
    assert jax.tree.structure(
        jax.tree.map(lambda s: 0, jspecs, is_leaf=jparams_mod.is_spec)) \
        == jax.tree.structure(P.tree_map(lambda s: 0, tspecs, P.is_spec))
    assert tmodel.n_params() == jmodel.n_params()


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_tree_matches_reference(arch):
    _assert_same_spec_tree(jax_smoke_config(arch), get_smoke_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_round_trip_is_bit_exact(arch):
    """The reference's PRNGKey(0) weights -> tensors -> numpy, equal bit
    for bit on every leaf, with the tree layout kept."""
    jp = jax.device_get(JModel(jax_smoke_config(arch)).init(
        jax.random.PRNGKey(0)))
    tp = P.from_numpy(jp)
    back = P.to_numpy(tp)
    j_leaves = jax.tree.leaves(jp)
    t_leaves = P.tree_leaves(tp, torch.is_tensor)
    b_leaves = P.tree_leaves(back, lambda x: isinstance(x, np.ndarray))
    assert len(j_leaves) == len(t_leaves) == len(b_leaves)
    for j, t, b in zip(j_leaves, t_leaves, b_leaves):
        assert t.dtype == torch.float32 and tuple(t.shape) == j.shape
        np.testing.assert_array_equal(
            t.numpy().view(np.uint32), np.asarray(j).view(np.uint32))
        np.testing.assert_array_equal(b.view(np.uint32),
                                      np.asarray(j).view(np.uint32))


def test_bridge_bf16_leaves_are_bit_exact():
    a = jnp.asarray(np.random.default_rng(0).standard_normal((4, 5)),
                    jnp.bfloat16)
    t = P.from_numpy({"w": [np.asarray(a)]})["w"][0]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(a.astype(jnp.float32)))
    np.testing.assert_array_equal(P.to_numpy({"w": t})["w"],
                                  np.asarray(a.astype(jnp.float32)))


def test_own_init_shapes_and_distributions():
    """Seeded torch.Generator draws with the reference's per-leaf std:
    fan_in^-0.5 for projections (stacked axes excluded), 0.02 for the
    embedding, zeros for biases, ones for norm scales."""
    cfg = dataclasses.replace(get_smoke_config("qwen2-0.5b"), d_model=128,
                              d_ff=256, vocab=512)
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    specs = model.param_specs()
    for spec, leaf in zip(P.tree_leaves(specs, P.is_spec),
                          P.tree_leaves(params, torch.is_tensor)):
        assert tuple(leaf.shape) == spec.shape and leaf.dtype == torch.float32
        if spec.init == "zeros":
            assert not leaf.any()
        elif spec.init == "ones":
            assert (leaf == 1).all()
        else:
            fan_in = spec.fan_in or spec.shape[-2]
            std = 0.02 if spec.init == "normal" else fan_in ** -0.5
            assert abs(leaf.std().item() / std - 1) < 0.1, spec
            assert abs(leaf.mean().item()) < 0.1 * std, spec
    again = model.init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(
        P.tree_leaves(params, torch.is_tensor),
        P.tree_leaves(again, torch.is_tensor)))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_every_full_config_builds_with_the_reference_spec_tree(arch):
    """Each of the ten published configs builds in the port (encoder-
    decoder and embeddings input included), with repro's spec tree,
    shapes and parameter count."""
    _assert_same_spec_tree(jax_config(arch), get_config(arch))


@pytest.mark.parametrize("arch", NOT_SERVED)
def test_engines_and_connect_refuse_encdec_and_embeddings_input(arch):
    """repro's wave and continuous engines assert on an enc-dec or an
    embeddings-input model, and so ``connect`` with either executor;
    the port's raise ValueError in the same places."""
    jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
    plan = EndpointPlan(vector=SharingVector(slots=4), n_slots=2,
                        max_len=32)
    for engine in (ServeEngine, ContinuousEngine):
        with pytest.raises(ValueError, match="decoder-only token models"):
            engine(tcfg, None, plan, device="cpu")
    for engine in (JWave, JContinuous):
        with pytest.raises(AssertionError):
            engine(jcfg, None)
    for executor in ("wave", "continuous"):
        with pytest.raises(ValueError, match="decoder-only token models"):
            tserve.connect(tcfg, None, executor=executor, n_slots=2,
                           max_len=32, device="cpu")
        with pytest.raises(AssertionError):
            jserve.connect(jcfg, None, executor=executor, n_slots=2,
                           max_len=32)


def test_lambda_rglru_init_draws_griffins_range():
    """Lambda = softplus^-1(-log(u)/2), u ~ U[0.9^2, 0.999^2]: the decay
    a = exp(-softplus(Lambda)) at r = 1/8 lies in [0.9, 0.999]; the port
    draws it from its torch.Generator, fp32, reproducibly."""
    spec = P.ParamSpec((4096,), ("lru",), init="lambda_rglru")
    lam = P.materialize({"lam": spec}, torch.Generator().manual_seed(0),
                        "cpu")["lam"]
    assert lam.dtype == torch.float32
    a = torch.exp(-torch.nn.functional.softplus(lam.double()))
    assert 0.9 - 1e-9 <= a.min().item() and a.max().item() <= 0.999 + 1e-9
    assert a.min().item() < 0.91 and a.max().item() > 0.998
    again = P.materialize({"lam": spec}, torch.Generator().manual_seed(0),
                          "cpu")["lam"]
    assert torch.equal(lam, again)


def test_tree_map_over_several_trees():
    """With more trees of the same structure, ``f`` takes the leaf of each
    at every place (what ``Model.prepare_params`` maps specs and weights
    with); the first tree's containers and key order are kept."""
    specs = {"b": [1, (2, 3)], "a": {"x": 4}}
    vals = {"a": {"x": 40}, "b": [10, (20, 30)]}
    out = P.tree_map(lambda s, v: s + v, specs, lambda x: False, vals)
    assert out == {"b": [11, (22, 33)], "a": {"x": 44}}
    assert list(out) == ["b", "a"] and isinstance(out["b"][1], tuple)


def test_prepare_params_keeps_fp32_only_where_the_spec_says():
    """At bf16 compute every leaf is bf16 on the device, except leaves
    whose spec says ``keep_fp32``: those keep their fp32 values bit for
    bit."""
    cfg = dataclasses.replace(get_smoke_config("recurrentgemma-2b"),
                              compute_dtype="bfloat16")
    m = Model(cfg, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    prepared = m.prepare_params(params)
    specs = P.tree_leaves(m.param_specs(), P.is_spec)
    before = P.tree_leaves(params, torch.is_tensor)
    after = P.tree_leaves(prepared, torch.is_tensor)
    assert len(specs) == len(before) == len(after)
    # five gate leaves in each of two prefix blocks and the stacked body
    assert sum(s.keep_fp32 for s in specs) == 5 * 3
    for spec, a, b in zip(specs, before, after):
        if spec.keep_fp32:
            assert b.dtype == torch.float32 and torch.equal(a, b)
        else:
            assert b.dtype == torch.bfloat16
