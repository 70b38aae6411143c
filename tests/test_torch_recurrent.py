"""The port's RG-LRU block and rolling-window attention cache against the
JAX reference's, live, on the reference's own weights (CPU).

The recurrentgemma smoke config (5 layers: RG-LRU, RG-LRU, local
attention with window 16, RG-LRU, RG-LRU; lru width 64) at fp32 compute:
block outputs and fp32 states agree within 1e-5 (the reference's scan is
an associative tree, the port's a sequential loop), model logits within
1e-4 and caches within 1e-5, as for the dense path.

At bf16 compute both frameworks round activations at other points, so
model logits are held to 6e-2 of the largest logit (five layers, a few
bf16 ulps; measured up to 3.8e-2 over 16 decode steps).  The RG-LRU
gates run in fp32 from fp32 weights in both, so the first block's fp32
state after a bf16 prefill, whose input is the same bf16 embedding on
both sides, is held to 1e-5: rounding the gate weights to bf16 moves it
by about 1e-3.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import recurrent as jrec
from repro.models import transformer as jtr
from repro.models.attention import select_attention as jselect
from repro.models.model import Model as JModel
from repro_torch.configs.base import ArchConfig
from repro_torch.models import recurrent as trec
from repro_torch.models import transformer as ttr
from repro_torch.models.attention import select_attention as tselect
from repro_torch.models.model import Model
from repro_torch.models.params import (from_numpy, to_numpy,
                                       tree_leaves)

ARCH = "recurrentgemma-2b"
TOL = 1e-5
LOGIT_ATOL = 1e-4
BF16_LOGIT_REL = 6e-2


@functools.lru_cache(maxsize=None)
def _pair(dtype="float32"):
    """(JAX model, JAX params, port model, port params) on the smoke
    config."""
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), compute_dtype=dtype)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(ArchConfig(**dataclasses.asdict(jcfg)), device="cpu")
    return jm, jp, tm, tm.prepare_params(from_numpy(jax.device_get(jp)))


def _block_params(layer=0):
    """The first prefix RG-LRU block's params: JAX's fp32 leaves, and the
    port's prepared ones."""
    _, jp, _, tp = _pair()
    return (jp["decoder"]["prefix"][layer]["rglru"],
            tp["decoder"]["prefix"][layer]["rglru"])


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(t, j, tol=TOL):
    if torch.is_tensor(t):
        t = t.float().numpy()
    np.testing.assert_allclose(np.asarray(t, np.float32),
                               np.asarray(j, np.float32), rtol=0, atol=tol)


def _state(c):
    return {k: v.clone() for k, v in c.items()}


# ----- RG-LRU pieces ---------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d(with_state):
    u, kern = _rand((2, 9, 12), 0), _rand((4, 12), 1)
    state = _rand((2, 3, 12), 2) if with_state else None
    j_out, j_state = jrec.causal_conv1d(
        jnp.asarray(u), jnp.asarray(kern),
        None if state is None else jnp.asarray(state))
    t_out, t_state = trec.causal_conv1d(
        torch.as_tensor(u), torch.as_tensor(kern),
        None if state is None else torch.as_tensor(state))
    _close(t_out, j_out, 0)
    _close(t_state, j_state, 0)


def test_gates_scan_with_carry_and_step():
    jpb, tpb = _block_params()
    u, h0 = _rand((2, 11, 64), 3), _rand((2, 64), 4)
    j_a, j_x = jrec._rglru_gates(jpb, jnp.asarray(u))
    t_a, t_x = trec._rglru_gates(tpb, torch.as_tensor(u))
    _close(t_a, j_a)
    _close(t_x, j_x)
    _close(trec.rglru_scan(tpb, torch.as_tensor(u), torch.as_tensor(h0)),
           jrec.rglru_scan(jpb, jnp.asarray(u), jnp.asarray(h0)))
    j_h, j_f = jrec.rglru_step(jpb, jnp.asarray(u[:, 0]), jnp.asarray(h0))
    t_h, t_f = trec.rglru_step(tpb, torch.as_tensor(u[:, 0]),
                               torch.as_tensor(h0))
    _close(t_h, j_h)
    _close(t_f, j_f)
    assert t_f.dtype == torch.float32


@pytest.mark.parametrize("branch", ["no_cache", "decode", "prefill_state"])
def test_apply_rglru_block_branches(branch):
    """The three branches: from zero without a cache, a single-token step
    and a prefill that captures the state, each from a non-zero state
    where a cache is given; the port updates the cache in place."""
    jpb, tpb = _block_params()
    _, _, tm, _ = _pair()
    cfg, jcfg = tm.cfg, _pair()[0].cfg
    t = 1 if branch == "decode" else 10
    x = _rand((2, t, cfg.d_model), 5)
    if branch == "no_cache":
        j_out, j_cache = jrec.apply_rglru_block(jpb, jnp.asarray(x), jcfg)
        t_out = trec.apply_rglru_block(tpb, torch.as_tensor(x), cfg)
        assert j_cache is None
    else:
        conv, h = _rand((2, 3, 64), 6), _rand((2, 64), 7)
        j_out, j_cache = jrec.apply_rglru_block(
            jpb, jnp.asarray(x), jcfg,
            {"conv": jnp.asarray(conv), "h": jnp.asarray(h)})
        t_cache = {"conv": torch.as_tensor(conv), "h": torch.as_tensor(h)}
        t_out = trec.apply_rglru_block(tpb, torch.as_tensor(x), cfg,
                                       t_cache)
        _close(t_cache["conv"], j_cache["conv"])
        _close(t_cache["h"], j_cache["h"])
    _close(t_out, j_out)


def test_block_prefill_then_decode_matches_full():
    """Splitting a sequence into a stateful prefill and single steps gives
    the full forward's outputs (the reference's own test, on the port)."""
    _, tpb = _block_params()
    cfg = _pair()[2].cfg
    x = torch.as_tensor(_rand((2, 12, cfg.d_model), 8))
    full = trec.apply_rglru_block(tpb, x, cfg)
    cache = trec.init_rglru_cache(cfg, 2)
    pre = trec.apply_rglru_block(tpb, x[:, :8], cfg, cache)
    torch.testing.assert_close(pre, full[:, :8], rtol=2e-4, atol=2e-4)
    for t in range(8, 12):
        out = trec.apply_rglru_block(tpb, x[:, t:t + 1], cfg, cache)
        torch.testing.assert_close(out[:, 0], full[:, t], rtol=5e-4,
                                   atol=5e-4)


def test_inactive_step_leaves_the_state():
    """A horizon step the reference would not run (``step_active`` off)
    changes neither the conv state nor h."""
    _, tpb = _block_params()
    cfg = _pair()[2].cfg
    cache = {"conv": torch.as_tensor(_rand((2, 3, 64), 9)),
             "h": torch.as_tensor(_rand((2, 64), 10))}
    before = _state(cache)
    x = torch.as_tensor(_rand((2, 1, cfg.d_model), 11))
    trec.apply_rglru_block(tpb, x, cfg, cache,
                           step_active=torch.tensor(False))
    assert all(torch.equal(cache[k], before[k]) for k in cache)
    trec.apply_rglru_block(tpb, x, cfg, cache,
                           step_active=torch.tensor(True))
    assert not torch.equal(cache["h"], before["h"])


def test_cache_layout_and_fp32_leaves():
    """The stack cache has the reference's tree, shapes and dtypes (window
    layers at min(max_len, window), fp32 h), and the prepared params keep
    the gate leaves in fp32 at bf16 compute."""
    jm, _, tm, tp = _pair("bfloat16")
    for max_len in (12, 40):
        jl = jax.tree.leaves(jm.init_cache(3, max_len, per_slot=True)
                             ["stack"])
        tl = tree_leaves(tm.init_cache(3, max_len, per_slot=True)["stack"])
        assert [a.shape for a in jl] == [tuple(a.shape) for a in tl]
        assert [str(a.dtype) for a in jl] == [
            str(a.dtype).removeprefix("torch.") for a in tl]
    blk = tp["decoder"]["prefix"][0]["rglru"]
    # the leaves the reference's _rglru_gates reads with .astype(float32)
    fp32 = {"w_input_gate", "b_input_gate", "w_rec_gate", "b_rec_gate",
            "lam"}
    assert {k for k, s in trec.rglru_specs(tm.cfg).items()
            if s.keep_fp32} == fp32
    for name, leaf in blk.items():
        want = torch.float32 if name in fp32 else torch.bfloat16
        assert leaf.dtype == want, name


# ----- rolling-window attention ----------------------------------------------

def _attn_ctx(mod, cfg, mode, positions, s, idx=None, write_mask=None):
    select = jselect if mod is jtr else tselect
    return mod.BlockCtx(cfg=cfg, mode=mode, positions=positions,
                        attn_fn=select(cfg, s), decode_idx=idx,
                        window_cache=True, decode_write_mask=write_mask)


def _local_attn_params():
    _, jp, _, tp = _pair()
    return (jp["decoder"]["prefix"][2]["attn"],
            tp["decoder"]["prefix"][2]["attn"])


@pytest.mark.parametrize("s", [9, 16, 21, 40])
def test_rolling_prefill_tail(s):
    """s < window pads, s == window keeps all, s > window keeps the last
    window positions rolled to row t % window; the attention output uses
    the window mask."""
    jm, _, tm, _ = _pair()
    jpa, tpa = _local_attn_params()
    window = tm.cfg.attn_window
    h = _rand((2, s, tm.cfg.d_model), s)
    pos = np.tile(np.arange(s, dtype=np.int32), (2, 1))
    j_out, j_cache = jtr._self_attention(
        jpa, jnp.asarray(h), _attn_ctx(jtr, jm.cfg, "prefill",
                                       jnp.asarray(pos), s), window,
        None)
    shape = (2, window, tm.cfg.n_kv_heads, tm.cfg.head_dim)
    t_cache = {"k": torch.full(shape, 7.0), "v": torch.full(shape, 7.0)}
    t_out = ttr._self_attention(
        tpa, torch.as_tensor(h), _attn_ctx(ttr, tm.cfg, "prefill",
                                           torch.as_tensor(pos), s),
        window, t_cache)
    _close(t_out, j_out)
    _close(t_cache["k"], j_cache["k"])
    _close(t_cache["v"], j_cache["v"])


@pytest.mark.parametrize("per_slot", [True, False])
def test_rolling_decode_write_and_mask(per_slot):
    """One decode step on a full rolling cache with per-slot indices that
    cross the window (before it fills, at the wrap, past it, and retired
    past max_len) and a write mask: the written rows and the output match
    the reference's."""
    jm, _, tm, _ = _pair()
    jpa, tpa = _local_attn_params()
    window = tm.cfg.attn_window
    b = 5
    idx = np.array([3, 15, 16, 37, 70], np.int32) if per_slot \
        else np.array(37, np.int32)
    mask = np.array([True, True, False, True, True])
    h = _rand((b, 1, tm.cfg.d_model), 12)
    k, v = (_rand((b, window, tm.cfg.n_kv_heads, tm.cfg.head_dim), i)
            for i in (13, 14))
    pos = (idx[:, None] if per_slot
           else np.full((b, 1), idx)).astype(np.int32)
    j_out, j_cache = jtr._self_attention(
        jpa, jnp.asarray(h),
        _attn_ctx(jtr, jm.cfg, "decode", jnp.asarray(pos), 1,
                  jnp.asarray(idx), jnp.asarray(mask)),
        window, {"k": jnp.asarray(k), "v": jnp.asarray(v)})
    t_cache = {"k": torch.as_tensor(k), "v": torch.as_tensor(v)}
    t_out = ttr._self_attention(
        tpa, torch.as_tensor(h),
        _attn_ctx(ttr, tm.cfg, "decode", torch.as_tensor(pos), 1,
                  torch.as_tensor(idx), torch.as_tensor(mask)),
        window, t_cache)
    # rows differ by O(1) if a write lands elsewhere; the written rows
    # themselves are projections, equal to fp32 rounding
    _close(t_out, j_out)
    _close(t_cache["k"], j_cache["k"])
    _close(t_cache["v"], j_cache["v"])


# ----- the whole model -------------------------------------------------------

def _prefill_rows(m, params, toks_rows, max_len, torch_side):
    """Per-slot cache with each row prefilled alone at its exact length
    (the engine's admission), as the reference's _scatter_slot does."""
    if torch_side:
        from repro_torch.serve.engine import _scatter_slot
        cache = m.init_cache(len(toks_rows), max_len, per_slot=True)
        firsts = []
        for slot, toks in enumerate(toks_rows):
            one = m.init_cache(1, max_len)
            logits, one = m.prefill(params,
                                    {"tokens": torch.as_tensor(toks[None])},
                                    one)
            _scatter_slot(cache, one, slot, len(toks))
            firsts.append(logits[0].numpy())
        return cache, np.stack(firsts)
    from repro.serve.engine import _scatter_slot
    cache = m.init_cache(len(toks_rows), max_len, per_slot=True)
    firsts = []
    prefill = jax.jit(m.prefill)
    for slot, toks in enumerate(toks_rows):
        logits, one = prefill(params, {"tokens": jnp.asarray(toks[None])},
                              m.init_cache(1, max_len))
        cache = jax.jit(_scatter_slot)(cache, one, slot)
        firsts.append(np.asarray(logits[0]))
    return cache, np.stack(firsts)


def _decode_both(dtype, lengths, steps, max_len=64):
    """Greedy decode of rows prefilled at ``lengths`` on both sides, each
    fed the reference's tokens; -> per-step (JAX logits, port logits) and
    the final caches."""
    jm, jp, tm, tp = _pair(dtype)
    rng = np.random.default_rng(sum(lengths))
    rows = [rng.integers(1, 128, size=n).astype(np.int32) for n in lengths]
    jc, jl = _prefill_rows(jm, jp, rows, max_len, False)
    tc, tl = _prefill_rows(tm, tp, rows, max_len, True)
    pairs = [(jl, tl)]
    decode = jax.jit(jm.decode_step)
    for _ in range(steps):
        tok = jl.argmax(-1).astype(np.int32)
        jl, jc = decode(jp, jc, jnp.asarray(tok))
        tl, tc = tm.decode_step(tp, tc, torch.as_tensor(tok))
        jl, tl = np.asarray(jl), tl.float().numpy()
        pairs.append((jl, tl))
    return pairs, jc, tc


def test_model_decode_across_the_window_matches_reference():
    """fp32: rows prefilled below, at and past the window decode across
    position 16 and 32; logits every step and the final caches (rolling
    k/v rows, conv and fp32 states) match."""
    pairs, jc, tc = _decode_both("float32", [5, 16, 23, 40], 20)
    for jl, tl in pairs:
        np.testing.assert_allclose(tl, jl, rtol=0, atol=LOGIT_ATOL)
        assert (tl.argmax(-1) == jl.argmax(-1)).all()
    for a, b in zip(jax.tree.leaves(jax.device_get(jc["stack"])),
                    jax.tree.leaves(to_numpy(tc["stack"]))):
        np.testing.assert_allclose(b, np.asarray(a, np.float32), rtol=0,
                                   atol=TOL)
    np.testing.assert_array_equal(tc["idx"].numpy(), np.asarray(jc["idx"]))


@pytest.mark.parametrize("budgets", [(6, 0, 3), (1, 0, 2)],
                         ids=["rows_finish_mid_horizon", "all_finish_early"])
def test_horizon_state_matches_reference(budgets):
    """One fused horizon of 4 steps from a per-slot cache: a finished
    row's recurrent state advances with the batch while any row is live
    (the reference puts no write mask on it), its rolling k/v rows do
    not, and once every row has finished (the reference's loop exits)
    nothing changes: caches, idx, state and trace match."""
    jm, jp, tm, tp = _pair()
    rng = np.random.default_rng(21)
    rows = [rng.integers(1, 128, size=n).astype(np.int32)
            for n in (14, 18, 30)]
    jc, jl = _prefill_rows(jm, jp, rows, 64, False)
    tc, _ = _prefill_rows(tm, tp, rows, 64, True)
    first = jl.argmax(-1).astype(np.int32)
    state = {"tok": first, "remaining": np.array(budgets, np.int32),
             "finished": np.array([b == 0 for b in budgets]),
             "eos": np.full(3, -1, np.int32), "has_eos": np.zeros(3, bool)}
    jc, js, jt = jax.jit(
        lambda p, c, st: jm.decode_horizon(p, c, st, horizon=4,
                                           max_len=64))(
        jp, jc, {k: jnp.asarray(v) for k, v in state.items()})
    tc, ts, tt = tm.decode_horizon(
        tp, tc, {k: torch.as_tensor(v) for k, v in state.items()},
        horizon=4, max_len=64)
    for a, b in zip(jax.tree.leaves(jax.device_get(jc["stack"])),
                    jax.tree.leaves(to_numpy(tc["stack"]))):
        np.testing.assert_allclose(b, np.asarray(a, np.float32), rtol=0,
                                   atol=TOL)
    np.testing.assert_array_equal(tc["idx"].numpy(), np.asarray(jc["idx"]))
    for name in js:
        np.testing.assert_array_equal(ts[name].numpy(),
                                      np.asarray(js[name]))
    for name in jt:
        np.testing.assert_array_equal(tt[name].numpy(),
                                      np.asarray(jt[name]))


def test_bf16_logits_match_reference():
    """bf16 compute: logits within 6e-2 of the largest logit through a
    prefill and 16 decode steps across the window."""
    pairs, _, _ = _decode_both("bfloat16", [9, 23, 40], 16)
    for jl, tl in pairs:
        err = np.abs(tl - jl).max()
        assert err <= BF16_LOGIT_REL * np.abs(jl).max(), err


def test_bf16_block_keeps_fp32_gates():
    """bf16 compute, the first RG-LRU block with the model's prepared
    params on a bf16 input: its fp32 state within 1e-5 of the reference's
    (run op by op: XLA's fusions would keep some bf16 intermediates in
    fp32, the port rounds after every op as eager JAX does), its output
    within one bf16 ulp of the largest output."""
    jm, jp, tm, tp = _pair("bfloat16")
    x = _rand((3, 40, tm.cfg.d_model), 15)
    j_out, j_cache = jrec.apply_rglru_block(
        jp["decoder"]["prefix"][0]["rglru"], jnp.asarray(x, jnp.bfloat16),
        jm.cfg, jrec.init_rglru_cache(jm.cfg, 3))
    t_cache = trec.init_rglru_cache(tm.cfg, 3)
    t_out = trec.apply_rglru_block(
        tp["decoder"]["prefix"][0]["rglru"],
        torch.as_tensor(x).bfloat16(), tm.cfg, t_cache)
    _close(t_cache["h"], j_cache["h"])
    _close(t_out, j_out, 2.0 ** -8 * np.abs(np.asarray(j_out,
                                                        np.float32)).max())
