"""The port's Model serving methods against the JAX reference's, live, on
the reference's own weights (CPU).

Two smoke configs cover the GQA groupings: qwen2-0.5b (G=2, d_head=16,
qkv bias) and smollm-360m (G=3, d_head=20).  At fp32 compute, logits
agree within atol 1e-4 (matmul sums run in other orders), caches within
1e-5, and greedy traces exactly.  At bf16 compute both frameworks round
every activation to 8 mantissa bits but at different points (XLA fuses
and re-associates; torch rounds after each op), so bf16 logits (qwen2-0.5b)
are held to 2e-2 of the largest logit: a few bf16 ulps after two layers.
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
from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.models.model import Model
from repro_torch.models.params import (from_numpy, to_numpy, tree_leaves,
                                       tree_map)

ARCHS = ["qwen2-0.5b", "smollm-360m"]
#: every decoder-only token model with an attention stack: the dense ones
#: (stablelm: partial rotary; internlm2) and the MoE ones (granite: top-2
#: of 8, tied embeddings; deepseek: a dense layer 0, 2 shared experts)
ATTN_ARCHS = ARCHS + ["stablelm-1.6b", "internlm2-1.8b",
                      "granite-moe-1b-a400m", "deepseek-moe-16b"]
#: the configs this file's model-level tests add for the MoE and xLSTM
#: slice (and the two dense configs that had none)
SERVED = ["granite-moe-1b-a400m", "deepseek-moe-16b", "xlstm-1.3b",
          "stablelm-1.6b", "internlm2-1.8b"]
LOGIT_ATOL = 1e-4
CACHE_ATOL = 1e-5


def port_config(jcfg) -> ArchConfig:
    """The port's ArchConfig of a reference config: ``asdict`` turns the
    nested ``MoEConfig`` into a dict, which is rebuilt here."""
    fields = dataclasses.asdict(jcfg)
    if fields["moe"] is not None:
        fields["moe"] = MoEConfig(**fields["moe"])
    return ArchConfig(**fields)


@functools.lru_cache(maxsize=None)
def _pair(arch, dtype="float32"):
    """(JAX model, JAX params, port model, port params) on one config."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), compute_dtype=dtype)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(port_config(jcfg), device="cpu")
    return jm, jp, tm, tm.prepare_params(from_numpy(jax.device_get(jp)))


def _np_leaves(tree):
    if isinstance(tree, dict) and any(torch.is_tensor(v) for v in
                                      tree_leaves(tree, torch.is_tensor)):
        tree = to_numpy(tree)
    return [np.asarray(a, np.float32) for a in jax.tree.leaves(tree)]


def _assert_caches_close(tcache, jcache):
    t = _np_leaves(tcache["stack"])
    j = _np_leaves(jcache["stack"])
    assert len(t) == len(j)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a, b, rtol=0, atol=CACHE_ATOL)
    np.testing.assert_array_equal(tcache["idx"].numpy(),
                                  np.asarray(jcache["idx"]))


def _random_caches(jm, tm, b, max_len, seed, **paged):
    """The same random k/v contents in a JAX and a port cache."""
    jc = jm.init_cache(b, max_len, per_slot=True, **paged)
    tc = tm.init_cache(b, max_len, per_slot=True, **paged)
    rng = np.random.default_rng(seed)
    filled = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        jax.device_get(jc["stack"]))
    jc["stack"] = jax.tree.map(jnp.asarray, filled)
    tc["stack"] = from_numpy(filled)
    return jc, tc


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_prefill_with_last_index(arch):
    """A padded batch with per-row last_index: logits and the filled
    cache match, and each row equals its exact-length prefill (not for
    MoE: capacity is per padded row, so padding can drop a real token's
    expert, in the reference as here; ``test_torch_engine`` pins it)."""
    jm, jp, tm, tp = _pair(arch)
    rng = np.random.default_rng(0)
    lengths = np.array([3, 11, 16], np.int32)
    toks = np.zeros((3, 16), np.int32)
    for i, n in enumerate(lengths):
        toks[i, :n] = rng.integers(1, 128, n)
    last = lengths - 1
    j_logits, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                              jm.init_cache(3, 32),
                              last_index=jnp.asarray(last))
    t_logits, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                              tm.init_cache(3, 32),
                              last_index=torch.from_numpy(last))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               rtol=0, atol=LOGIT_ATOL)
    _assert_caches_close(tc, jc)
    if tm.cfg.moe is not None:
        return
    solo, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks[1:2, :11])},
                         tm.init_cache(1, 32))
    np.testing.assert_allclose(solo.numpy(), t_logits[1:2].numpy(),
                               rtol=0, atol=LOGIT_ATOL)


@pytest.mark.parametrize("ragged", [False, True], ids=["oracle", "kernel"])
@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_decode_step_contiguous(arch, ragged):
    """Rows at idx 0, mid-cache and the last position (max_len-1), one
    row past the buffer (a retired slot), and one row's write masked
    off: logits, every cache row and idx match."""
    jm, jp, tm, tp = _pair(arch)
    jc, tc = _random_caches(jm, tm, 5, 32, seed=1)
    idx = np.array([0, 13, 31, 40, 7], np.int32)
    mask = np.array([True, True, True, True, False])
    jc["idx"] = jnp.asarray(idx)
    tc["idx"] = torch.from_numpy(idx)
    toks = np.array([5, 9, 1, 77, 3], np.int32)
    j_logits, jc = jm.decode_step(jp, jc, tokens=jnp.asarray(toks),
                                  use_ragged_kernel=ragged,
                                  write_mask=jnp.asarray(mask))
    t_logits, tc = tm.decode_step(tp, tc, torch.from_numpy(toks),
                                  use_ragged_kernel=ragged,
                                  write_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               rtol=0, atol=LOGIT_ATOL)
    _assert_caches_close(tc, jc)


@pytest.mark.parametrize("ragged", [False, True], ids=["oracle", "kernel"])
@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_decode_step_paged(arch, ragged):
    """Scrambled page tables with sentinels: rows writing into their own
    pages (at idx 0 and at the table's last position), a retired row
    with an all-sentinel table, and a masked-off row."""
    jm, jp, tm, tp = _pair(arch)
    ps, max_len, n_pages = 8, 32, 11
    jc, tc = _random_caches(jm, tm, 4, max_len, seed=2, page_size=ps,
                            n_pages=n_pages)
    pt = np.full((4, max_len // ps), n_pages, np.int32)
    pt[0, :1] = [6]
    pt[1, :4] = [2, 9, 0, 4]
    pt[3, :2] = [10, 1]
    idx = np.array([0, 31, 45, 12], np.int32)
    mask = np.array([True, True, True, False])
    for c, conv in ((jc, jnp.asarray), (tc, torch.from_numpy)):
        c["pt"], c["idx"] = conv(pt), conv(idx)
    toks = np.array([5, 9, 1, 77], np.int32)
    j_logits, jc = jm.decode_step(jp, jc, tokens=jnp.asarray(toks),
                                  use_ragged_kernel=ragged,
                                  write_mask=jnp.asarray(mask))
    t_logits, tc = tm.decode_step(tp, tc, torch.from_numpy(toks),
                                  use_ragged_kernel=ragged,
                                  write_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               rtol=0, atol=LOGIT_ATOL)
    _assert_caches_close(tc, jc)


def _horizon_inputs(jm, jp, tm, tp, remaining):
    rng = np.random.default_rng(4)
    lengths = np.array([5, 21, 9], np.int32)
    toks = np.zeros((3, 24), np.int32)
    for i, n in enumerate(lengths):
        toks[i, :n] = rng.integers(1, 128, n)
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                       jm.init_cache(3, 24, per_slot=True),
                       last_index=jnp.asarray(lengths - 1))
    _, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                       tm.init_cache(3, 24, per_slot=True),
                       last_index=torch.from_numpy(lengths - 1))
    jc["idx"], tc["idx"] = jnp.asarray(lengths), torch.from_numpy(lengths)
    state = {"tok": np.array([3, 8, 60], np.int32),
             "remaining": np.asarray(remaining, np.int32),
             "finished": np.array([False, False, True]),
             "eos": np.array([-1, 42, -1], np.int32),
             "has_eos": np.array([False, True, False])}
    return (jc, {k: jnp.asarray(v) for k, v in state.items()},
            tc, {k: torch.from_numpy(v) for k, v in state.items()})


@pytest.mark.parametrize("arch,horizon,remaining", [
    ("qwen2-0.5b", 1, [3, 9, 0]), ("qwen2-0.5b", 4, [3, 9, 0]),
    ("qwen2-0.5b", 4, [1, 2, 0]), ("smollm-360m", 4, [3, 9, 0]),
    ("granite-moe-1b-a400m", 4, [3, 9, 0]),
    ("deepseek-moe-16b", 4, [1, 2, 0]), ("xlstm-1.3b", 4, [3, 9, 0]),
    ("xlstm-1.3b", 4, [1, 2, 0])],
    ids=["qwen2-K1", "qwen2-K4",
         "qwen2-K4-early-exit", "smollm-K4", "granite-K4",
         "deepseek-K4-early-exit", "xlstm-K4", "xlstm-K4-early-exit"])
def test_decode_horizon(arch, horizon, remaining):
    """Traces (tokens, liveness, bonus tokens at the cache edge — row 1
    reaches the edge of max_len=24 — and retirements), the carried state and the
    cache match; with every budget spent before K, the steps the
    reference never ran leave all-dead trace rows and idx unmoved."""
    jm, jp, tm, tp = _pair(arch)
    jc, js, tc, ts = _horizon_inputs(jm, jp, tm, tp, remaining)
    jc, js, jtrace = jm.decode_horizon(jp, jc, js, horizon=horizon,
                                       max_len=24)
    tc, ts, ttrace = tm.decode_horizon(tp, tc, ts, horizon=horizon,
                                       max_len=24)
    for name in jtrace:
        np.testing.assert_array_equal(ttrace[name].numpy(),
                                      np.asarray(jtrace[name]), name)
    for name in js:
        np.testing.assert_array_equal(ts[name].numpy(),
                                      np.asarray(js[name]), name)
    _assert_caches_close(tc, jc)
    if remaining == [1, 2, 0]:
        assert not ttrace["live"][2:].any()
        np.testing.assert_array_equal(tc["idx"].numpy(), [7, 23, 11])


def test_decode_horizon_n_steps_stops_early():
    """n_steps cuts the loop where the budgets are spent: the result
    equals the full K-step horizon's."""
    jm, jp, tm, tp = _pair("qwen2-0.5b")
    _, _, tc, ts = _horizon_inputs(jm, jp, tm, tp, [2, 3, 0])
    stack = tree_map(torch.clone, tc["stack"], torch.is_tensor)
    full = tm.decode_horizon(tp, {**tc, "stack": stack}, dict(ts),
                             horizon=8, max_len=24)
    cut = tm.decode_horizon(tp, tc, dict(ts), horizon=8, max_len=24,
                            n_steps=3)
    for a, b in zip(tree_leaves(full, torch.is_tensor),
                    tree_leaves(cut, torch.is_tensor)):
        assert torch.equal(a, b)


def test_bf16_logits_within_stated_tolerance():
    """bf16 compute: prefill and one decode step, logits within 2e-2 of
    the largest logit (see the module docstring)."""
    jm, jp, tm, tp = _pair("qwen2-0.5b", "bfloat16")
    toks = np.random.default_rng(5).integers(1, 128, (2, 12)).astype(
        np.int32)
    j_logits, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                              jm.init_cache(2, 16, per_slot=True))
    t_logits, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                              tm.init_cache(2, 16, per_slot=True))
    nxt = np.array([7, 9], np.int32)
    j2, _ = jm.decode_step(jp, jc, tokens=jnp.asarray(nxt))
    t2, _ = tm.decode_step(tp, tc, torch.from_numpy(nxt))
    for t, j in ((t_logits, j_logits), (t2, j2)):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=2e-2 * np.abs(j).max())


@pytest.mark.parametrize("arch", SERVED)
def test_prefill_then_decode_matches_reference(arch):
    """Exact-length prefill of 3 rows into a per-slot cache, then three
    decode steps at the rows' own positions: logits, every cache leaf
    (attention k/v, or the xLSTM conv and cell states) and idx after
    every call."""
    jm, jp, tm, tp = _pair(arch)
    toks = np.random.default_rng(6).integers(1, 128, (3, 12)).astype(
        np.int32)
    j_logits, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                              jm.init_cache(3, 24, per_slot=True))
    t_logits, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                              tm.init_cache(3, 24, per_slot=True))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               rtol=0, atol=LOGIT_ATOL)
    _assert_caches_close(tc, jc)
    nxt = np.asarray(j_logits).argmax(-1).astype(np.int32)
    for _ in range(3):
        j_logits, jc = jm.decode_step(jp, jc, tokens=jnp.asarray(nxt))
        t_logits, tc = tm.decode_step(tp, tc, torch.from_numpy(nxt))
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                                   rtol=0, atol=LOGIT_ATOL)
        _assert_caches_close(tc, jc)
        np.testing.assert_array_equal(t_logits.numpy().argmax(-1),
                                      np.asarray(j_logits).argmax(-1))
        nxt = np.asarray(j_logits).argmax(-1).astype(np.int32)


@pytest.mark.parametrize("arch,rel", [("granite-moe-1b-a400m", 2e-2),
                                      ("xlstm-1.3b", 6e-2)])
def test_bf16_moe_and_xlstm_logits_within_stated_tolerance(arch, rel):
    """bf16 compute on the MoE and xLSTM stacks: prefill and one decode
    step, logits within ``rel`` of the largest logit.  The MoE stack
    takes the dense stacks' 2e-2; the xLSTM stack the recurrent stacks'
    6e-2 (``test_torch_recurrent``): its four cells round in bf16 at other
    points, and at prefill the reference's bf16 logits lie 6.0e-2 of the
    largest logit from its fp32 ones, the port's 5.3e-2, and the two
    2.05e-2 apart."""
    jm, jp, tm, tp = _pair(arch, "bfloat16")
    toks = np.random.default_rng(7).integers(1, 128, (2, 12)).astype(
        np.int32)
    j_logits, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                              jm.init_cache(2, 16, per_slot=True))
    t_logits, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                              tm.init_cache(2, 16, per_slot=True))
    nxt = np.array([7, 9], np.int32)
    j2, _ = jm.decode_step(jp, jc, tokens=jnp.asarray(nxt))
    t2, _ = tm.decode_step(tp, tc, torch.from_numpy(nxt))
    for t, j in ((t_logits, j_logits), (t2, j2)):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=rel * np.abs(j).max())


@pytest.mark.parametrize("arch", SERVED)
def test_param_tree_and_serving_flags_match_reference(arch):
    """The reference's weights fill the port's spec tree leaf for leaf
    (deepseek's dense layer 0 in the prefix), n_params() is equal, and
    the serving flags agree: MoE pads and pages, xLSTM neither."""
    jm, jp, tm, tp = _pair(arch)
    assert [tuple(a.shape) for a in tree_leaves(tp, torch.is_tensor)] == \
        [a.shape for a in jax.tree.leaves(jp)]
    assert tm.n_params() == jm.n_params()

    def descs(plan):
        return ([(d.kind, d.ffn) for d in plan.prefix],
                [(d.kind, d.ffn) for d in plan.period], plan.n_periods)
    assert descs(tm.plan) == descs(jm.plan)
    assert tm.supports_padded_prefill == jm.supports_padded_prefill \
        == (arch != "xlstm-1.3b")
    assert tm.supports_paged_cache == jm.supports_paged_cache \
        == (arch != "xlstm-1.3b")
    if arch == "deepseek-moe-16b":
        assert descs(tm.plan)[0] == [("attn", "dense0")]
        assert tp["decoder"]["prefix"][0]["ffn"]["w_up"].shape[1] == \
            tm.cfg.moe.dense_d_ff


def test_model_resolves_device():
    from repro_torch.configs import get_smoke_config
    assert Model(get_smoke_config("qwen2-0.5b"), device="cpu").device \
        == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Model(get_smoke_config("qwen2-0.5b"))
