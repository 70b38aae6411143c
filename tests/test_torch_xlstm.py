"""The port's xLSTM blocks (mLSTM, sLSTM) against the JAX reference's,
live, on the reference's own weights (CPU).

The xlstm-1.3b smoke config (4 layers: mLSTM, mLSTM, mLSTM, sLSTM;
d_model 64, 2 heads, q/k/v blocks of 4).  At fp32 every comparison holds
to 1e-5 of max(1, the reference's largest value): the mLSTM cores (the
per-token scan and the chunkwise core, 512 tokens, whose outputs reach
36) and the sLSTM scan on outputs and states; the mLSTM block at 100
tokens (the fp32 stream, per-token scan), 512 (the compute-dtype stream,
chunkwise) and 960 (the compute-dtype stream without chunking), from
zero and from a cache another prefill left.  At bf16 the block's output
is held to 2e-2 of its largest value, as the port's bf16 logits are.  A
decode step with ``step_active`` off leaves every state leaf, values and
addresses, as it was.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import xlstm as jx
from repro.core.plan import EndpointPlan as JPlan
from repro.core.plan import SharingVector as JVector
from repro.models.model import Model as JModel
from repro.serve.engine import ContinuousEngine as JEngine
from repro.serve.engine import Request as JRequest
from repro_torch.core.plan import EndpointPlan as TPlan
from repro_torch.core.plan import SharingVector as TVector
from repro_torch.models import xlstm as tx
from repro_torch.models.model import Model
from repro_torch.models.params import (from_numpy, to_numpy, tree_leaves,
                                       tree_map)
from repro_torch.serve.engine import ContinuousEngine as TEngine
from repro_torch.serve.engine import Request as TRequest
from tests.test_torch_engine import _plan as eng_plan
from tests.test_torch_engine import connect_family, family_specs, served
from tests.test_torch_model import port_config

ARCH = "xlstm-1.3b"
TOL = 1e-5
BF16_REL = 2e-2


@functools.lru_cache(maxsize=None)
def _pair(dtype="float32"):
    """(JAX cfg, port cfg, JAX params, port prepared params)."""
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), compute_dtype=dtype)
    jp = jax.device_get(JModel(jcfg).init(jax.random.PRNGKey(0)))
    tm = Model(port_config(jcfg), device="cpu")
    return jcfg, tm.cfg, jp, tm.prepare_params(from_numpy(jp))


def _blocks(kind, dtype="float32"):
    """The first body layer's ``kind`` block params: JAX's, the port's."""
    _, _, jp, tp = _pair(dtype)
    pos = 0 if kind == "mlstm" else 3
    return (jax.tree.map(lambda a: a[0], jp["decoder"]["body"][pos][kind]),
            tree_map(lambda a: a[0], tp["decoder"]["body"][pos][kind],
                     torch.is_tensor))


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _close(t, j, tol=TOL):
    """|t - j| <= tol * max(1, max |j|): the cell state grows with the
    memory, and sums over 512 steps run in other orders."""
    if torch.is_tensor(t):
        t = t.float().numpy()
    j = np.asarray(j, np.float32)
    np.testing.assert_allclose(np.asarray(t, np.float32), j, rtol=0,
                               atol=tol * max(1.0, np.abs(j).max()))


def _core_inputs(t, seed, b=2, nh=2, dh=16):
    q, k, v = (_rand((b, t, nh, dh), seed + i) for i in range(3))
    k *= dh ** -0.5
    ig = _rand((b, t, nh), seed + 3)
    fg = _rand((b, t, nh), seed + 4) + 3.0
    return q, k, v, ig, fg


def _state(seed, b=2, nh=2, dh=16):
    return (_rand((b, nh, dh, dh), seed, 0.1), _rand((b, nh, dh), seed + 1,
                                                      0.1),
            _rand((b, nh), seed + 2))


@pytest.mark.parametrize("core", ["_mlstm_scan", "_mlstm_chunkwise"])
@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_cores_match_reference(core, with_state):
    inputs = _core_inputs(512, 10)
    kw_j = kw_t = {}
    if with_state:
        c0, n0, m0 = _state(20)
        kw_j = dict(c0=jnp.asarray(c0), n0=jnp.asarray(n0),
                    m0=jnp.asarray(m0))
        kw_t = dict(c0=torch.from_numpy(c0), n0=torch.from_numpy(n0),
                    m0=torch.from_numpy(m0))
    j_h, j_state = getattr(jx, core)(*map(jnp.asarray, inputs), **kw_j)
    t_h, t_state = getattr(tx, core)(*map(torch.from_numpy, inputs), **kw_t)
    _close(t_h, j_h)
    for t, j in zip(t_state, j_state):
        _close(t, j)


def test_chunkwise_equals_scan():
    inputs = tuple(map(torch.from_numpy, _core_inputs(512, 30)))
    h_s, st_s = tx._mlstm_scan(*inputs)
    h_c, st_c = tx._mlstm_chunkwise(*inputs)
    _close(h_c, h_s.numpy())
    for a, b in zip(st_c, st_s):
        _close(a, b.numpy())


def _j_cache(cache):
    return {k: jnp.asarray(to_numpy({k: v})[k]) if torch.is_tensor(v)
            else v for k, v in cache.items()}


@pytest.mark.parametrize("t", [100, 512, 960])
@pytest.mark.parametrize("with_cache", [False, True])
def test_mlstm_block_matches_reference(t, with_cache):
    """From zero without a cache, and from the state a 37-token prefill
    left (the port's cache updated in place)."""
    jcfg, tcfg, _, _ = _pair()
    jpb, tpb = _blocks("mlstm")
    x = _rand((2, t, tcfg.d_model), t)
    if not with_cache:
        j_out, _ = jx.apply_mlstm_block(jpb, jnp.asarray(x), jcfg)
        t_out = tx.apply_mlstm_block(tpb, torch.from_numpy(x), tcfg)
        _close(t_out, j_out)
        return
    x0 = _rand((2, 37, tcfg.d_model), 1)
    _, j_cache = jx.apply_mlstm_block(jpb, jnp.asarray(x0), jcfg,
                                      jx.init_mlstm_cache(jcfg, 2))
    t_cache = tx.init_mlstm_cache(tcfg, 2)
    tx.apply_mlstm_block(tpb, torch.from_numpy(x0), tcfg, t_cache)
    ptrs = {k: v.data_ptr() for k, v in t_cache.items()}
    j_out, j_cache = jx.apply_mlstm_block(jpb, jnp.asarray(x), jcfg,
                                          j_cache)
    t_out = tx.apply_mlstm_block(tpb, torch.from_numpy(x), tcfg, t_cache)
    _close(t_out, j_out)
    for name in ("conv", "c", "n", "m"):
        _close(t_cache[name], j_cache[name])
        assert t_cache[name].data_ptr() == ptrs[name]


@pytest.mark.parametrize("t", [100, 512, 960])
def test_mlstm_block_bf16_within_stated_tolerance(t):
    """bf16 compute: the fp32 stream below 512 tokens, the bf16 stream
    from 512 (chunkwise at 512, per-token at 960)."""
    jcfg, tcfg, _, _ = _pair("bfloat16")
    jpb, tpb = _blocks("mlstm", "bfloat16")
    x = _rand((1, t, tcfg.d_model), t + 1)
    j_out, _ = jax.jit(lambda p, a: jx.apply_mlstm_block(p, a, jcfg))(
        jpb, jnp.asarray(x, jnp.bfloat16))
    t_out = tx.apply_mlstm_block(tpb, torch.from_numpy(x).bfloat16(), tcfg)
    assert t_out.dtype == torch.bfloat16
    j = np.asarray(j_out.astype(jnp.float32))
    np.testing.assert_allclose(t_out.float().numpy(), j, rtol=0,
                               atol=BF16_REL * np.abs(j).max())


def test_slstm_scan_and_block_match_reference():
    jcfg, tcfg, _, _ = _pair()
    jpb, tpb = _blocks("slstm")
    x = _rand((2, 40, tcfg.d_model), 7)
    c, n, h = (_rand((2, tcfg.d_model), 8 + i, 0.5) for i in range(3))
    n = np.abs(n) + 0.5
    m = _rand((2, tcfg.n_xlstm_heads), 11)
    state = (c, n, h, m)
    j_hs, j_state = jx._slstm_scan(jpb, jnp.asarray(x),
                                   tuple(map(jnp.asarray, state)))
    t_hs, t_state = tx._slstm_scan(tpb, torch.from_numpy(x),
                                   tuple(map(torch.from_numpy, state)))
    _close(t_hs, j_hs)
    for t, j in zip(t_state, j_state):
        _close(t, j)
    j_cache = dict(zip(("c", "n", "h", "m"), map(jnp.asarray, state)))
    t_cache = dict(zip(("c", "n", "h", "m"), map(torch.from_numpy, state)))
    j_out, j_cache = jx.apply_slstm_block(jpb, jnp.asarray(x), jcfg,
                                          j_cache)
    t_out = tx.apply_slstm_block(tpb, torch.from_numpy(x), tcfg, t_cache)
    _close(t_out, j_out)
    for name in t_cache:
        _close(t_cache[name], j_cache[name])
    j_out, _ = jx.apply_slstm_block(jpb, jnp.asarray(x), jcfg)
    _close(tx.apply_slstm_block(tpb, torch.from_numpy(x), tcfg), j_out)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_inactive_step_leaves_the_state(kind):
    """A decode step with step_active off writes nothing: every state
    leaf keeps its values and its address; on, the step equals the
    reference's."""
    jcfg, tcfg, _, _ = _pair()
    jpb, tpb = _blocks(kind)
    init = tx.init_mlstm_cache if kind == "mlstm" else tx.init_slstm_cache
    apply = tx.apply_mlstm_block if kind == "mlstm" else tx.apply_slstm_block
    japply = jx.apply_mlstm_block if kind == "mlstm" \
        else jx.apply_slstm_block
    cache = init(tcfg, 3)
    apply(tpb, torch.from_numpy(_rand((3, 9, tcfg.d_model), 12)), tcfg,
          cache)
    before = {k: v.clone() for k, v in cache.items()}
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    x = torch.from_numpy(_rand((3, 1, tcfg.d_model), 13))
    apply(tpb, x, tcfg, cache, step_active=torch.tensor(False))
    for name, v in cache.items():
        assert torch.equal(v, before[name]) and v.data_ptr() == ptrs[name]
    j_out, j_cache = japply(jpb, jnp.asarray(x.numpy()), jcfg,
                            _j_cache(before))
    t_out = apply(tpb, x, tcfg, cache, step_active=torch.tensor(True))
    _close(t_out, j_out)
    for name, v in cache.items():
        _close(v, j_cache[name])
        assert v.data_ptr() == ptrs[name]
        assert not torch.equal(v, before[name]) or name == "m"


def test_cache_layout_and_fp32_leaves():
    """The stack cache has the reference's leaves (shapes; m at -1e30),
    the cell state in fp32 at bf16 compute, and the weights the
    reference reads in fp32 stay fp32 after prepare_params."""
    jcfg, tcfg, _, tp = _pair("bfloat16")
    jc = JModel(jcfg).init_cache(3, 16, per_slot=True)
    tc = Model(tcfg, device="cpu").init_cache(3, 16, per_slot=True)
    j_leaves = jax.tree.leaves(jc["stack"])
    t_leaves = [a for a in jax.tree.leaves(
        tree_map(lambda a: a, tc["stack"], torch.is_tensor))]
    assert len(j_leaves) == len(t_leaves)
    for j, t in zip(j_leaves, t_leaves):
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype)
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j, np.float32))
    m = tp["decoder"]["body"][0]["mlstm"]
    s = tp["decoder"]["body"][3]["slstm"]
    for leaf in (m["wq"], m["w_igate"], m["b_fgate"], m["gn_scale"],
                 s["w_z"], s["r_i"], s["b_f"], s["gn_scale"]):
        assert leaf.dtype == torch.float32
    for leaf in (m["w_up"], m["w_down"], m["conv"], m["skip"], s["w_out"]):
        assert leaf.dtype == torch.bfloat16


# ----- serving: connect, KV handoff, export ----------------------------------

def _engine(side, horizon):
    jcfg, tcfg, jparams, tparams = served(ARCH)
    if side == "repro":
        return JEngine(jcfg, jparams, plan=eng_plan(JPlan, JVector, horizon,
                                                    False))
    return TEngine(tcfg, tparams, plan=eng_plan(TPlan, TVector, horizon,
                                                False), device="cpu")


def _requests(side, rids, handoffs=None):
    req_cls = JRequest if side == "repro" else TRequest
    specs = family_specs()
    handoffs = handoffs or {}
    return [req_cls(rid=r, prompt=specs[r][0], max_new_tokens=specs[r][1],
                    eos_id=specs[r][2], kv=handoffs.get(r)) for r in rids]


def _payload_leaves(side, h):
    stack = h.cache["stack"]
    if side == "repro":
        return [np.asarray(a) for a in jax.tree.leaves(
            jax.device_get(stack))]
    return [np.asarray(a) for a in jax.tree.leaves(to_numpy(stack))]


@pytest.mark.parametrize("horizon", [1, 8])
def test_connect_matches_reference(horizon):
    """Exact-length admission (the reference's rule for recurrent
    stacks: no buckets, no pages whatever the plan says), the per-step
    loop and the fused horizon: tokens and compile_count() equal the
    reference's."""
    got, t_count, eng = connect_family("port", ARCH, horizon, pages=True)
    expect, j_count, j_eng = connect_family("repro", ARCH, horizon,
                                            pages=True)
    assert got == expect
    assert t_count == j_count
    assert not eng.paged and eng.prefill_buckets == ()
    assert eng.stats["prefills"] == j_eng.stats["prefills"] == len(
        family_specs())


def test_kv_handoff_lands_the_cell_state():
    """prefill_only on one engine, the payloads admitted by another: the
    payload's leaves (conv, C (1, H, dh, dh), n (1, H, dh), m (1, H), and
    the sLSTM's c / n / h (1, d)) equal the reference's, and the decode
    engine's tokens equal the reference's disaggregated run; its cache
    keeps every address."""
    rids = [0, 1, 3, 8]
    out, payloads = {}, {}
    for side in ("repro", "port"):
        pre, dec = _engine(side, 4), _engine(side, 4)
        dec.start()
        if side == "port":
            ptrs = [a.data_ptr() for a in tree_leaves(dec._cache["stack"],
                                                      torch.is_tensor)]
        hs = {r.rid: pre.prefill_only(r) for r in _requests(side, rids)}
        payloads[side] = [hs[r] for r in rids]
        for r in _requests(side, rids, handoffs=hs):
            dec.submit(r)
        out[side] = {r.rid: list(r.output) for r in dec.run()}
    assert out["port"] == out["repro"]
    assert ptrs == [a.data_ptr() for a in tree_leaves(dec._cache["stack"],
                                                      torch.is_tensor)]
    for t, j in zip(payloads["port"], payloads["repro"]):
        assert (t.pos, t.next_tok, t.kv_tokens, t.kv_bytes) == \
            (j.pos, j.next_tok, j.kv_tokens, j.kv_bytes)
        tl, jl = _payload_leaves("port", t), _payload_leaves("repro", j)
        assert [a.shape for a in tl] == [a.shape for a in jl]
        for a, b in zip(tl, jl):
            _close(a, b)
    m = payloads["port"][0].cache["stack"]["body"][0]["mlstm"]
    assert m["c"].shape[1:] == (1, 2, 64, 64) and m["m"].shape[1:] == (1, 2)


def test_export_session_resumes_on_a_second_engine():
    """Sessions exported after two admission rounds and horizons resume
    on a fresh engine with the uninterrupted tokens and the reference's;
    the payloads' cell states equal the reference's."""
    out, payloads = {}, {}
    for side in ("repro", "port"):
        a = _engine(side, 4)
        for r in _requests(side, range(len(family_specs()))):
            a.submit(r)
        a.start()
        for _ in range(2):
            a.admit_waiting()
            a.step()
        hs = a.export_sessions()
        assert hs and a.n_active == 0
        queued = [r.rid for r in a.queue]
        a.queue.clear()
        b = _engine(side, 4)
        for r in _requests(side, [h.rid for h in hs],
                           handoffs={h.rid: h for h in hs}):
            b.submit(r)
        for r in _requests(side, queued):
            b.submit(r)
        out[side] = {**{r.rid: list(r.output) for r in a.done},
                     **{r.rid: list(r.output) for r in b.run()}}
        payloads[side] = hs
    assert out["port"] == out["repro"]
    assert out["port"] == connect_family("port", ARCH, 4)[0]
    assert any(h.emitted for h in payloads["port"])
    for t, j in zip(payloads["port"], payloads["repro"]):
        assert (t.rid, t.pos, t.next_tok, t.remaining, t.emitted) == \
            (j.rid, j.pos, j.next_tok, j.remaining, j.emitted)
        for x, y in zip(_payload_leaves("port", t),
                        _payload_leaves("repro", j)):
            _close(x, y)
