"""The port's ContinuousEngine on recurrentgemma against the JAX
reference's, live, on the same weights and requests (CPU, fp32 compute).

The recurrentgemma smoke config mixes RG-LRU blocks with one local
attention layer of window 16, so the engine admits at exact length
(buckets off), keeps a contiguous rolling cache (paging off), and carries
recurrent state per slot.  Prompts run below, at and past the window and
decode across it; one reaches the cache edge.  At fp32 greedy decoding
is exact between the two frameworks on these weights: tokens, admission
order, admission steps and retirement steps must be equal, for the
per-step oracle (K=1) and the fused horizon (K=4).
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.plan import EndpointPlan as JPlan
from repro.core.plan import SharingVector as JVector
from repro.models.model import Model as JModel
from repro.serve.engine import ContinuousEngine as JEngine
from repro.serve.engine import Request as JRequest
from repro_torch import serve as tserve
from repro_torch.configs.base import ArchConfig
from repro_torch.core.plan import EndpointPlan as TPlan
from repro_torch.core.plan import SharingVector as TVector
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rglru import ops as rglru_ops
from repro_torch.models.params import from_numpy
from repro_torch.serve.engine import ContinuousEngine as TEngine
from repro_torch.serve.engine import Request as TRequest

N_SLOTS, MAX_LEN = 3, 48


@functools.lru_cache(maxsize=None)
def _served():
    """(JAX cfg, port cfg, JAX params, port params) at fp32 compute."""
    jcfg = dataclasses.replace(jax_smoke_config("recurrentgemma-2b"),
                               compute_dtype="float32")
    tcfg = ArchConfig(**dataclasses.asdict(jcfg))
    jparams = JModel(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, tcfg, jparams, from_numpy(jax.device_get(jparams))


def _specs():
    """Ten requests: prompts of 5 to 30 tokens (window 16), budgets up to
    24 so rows cross positions 16 and 32 while decoding, one EOS id, and
    a prompt of 40 that reaches the cache edge (bonus token).  Few
    distinct lengths: the reference compiles one prefill per length."""
    rng = np.random.default_rng(11)
    out = []
    for i, n in enumerate((5, 20, 12, 30, 16, 20, 5, 30, 12)):
        prompt = rng.integers(1, 128, size=n).astype(np.int32)
        eos = int(rng.integers(0, 128)) if i == 3 else None
        out.append((prompt, int(rng.integers(1, 25)), eos))
    out.append((np.arange(1, 41, dtype=np.int32), 20, None))
    return out


def _plan(cls, vec_cls, horizon, pages=False):
    return cls(vector=vec_cls(pages=4 if pages else 1), n_slots=N_SLOTS,
               max_len=MAX_LEN, decode_horizon=horizon,
               executor="continuous")


def _run(engine):
    req_cls = TRequest if isinstance(engine, TEngine) else JRequest
    for rid, (prompt, max_new, eos) in enumerate(_specs()):
        engine.submit(req_cls(rid=rid, prompt=prompt,
                              max_new_tokens=max_new, eos_id=eos))
    done = {r.rid: list(r.output) for r in engine.run()}
    return (done, engine.admit_order, engine.admit_steps,
            engine.retire_steps)


@functools.lru_cache(maxsize=None)
def _reference(horizon):
    jcfg, _, jparams, _ = _served()
    eng = JEngine(jcfg, jparams, plan=_plan(JPlan, JVector, horizon))
    return _run(eng), eng.stats


@pytest.mark.parametrize("horizon", [1, 4])
def test_engine_matches_reference(horizon):
    _, tcfg, _, tparams = _served()
    eng = TEngine(tcfg, tparams, plan=_plan(TPlan, TVector, horizon),
                  device="cpu")
    got = _run(eng)
    expect, jstats = _reference(horizon)
    assert got[0] == expect[0]                       # tokens
    assert got[1] == expect[1]                       # admission order
    assert got[2] == expect[2]                       # admission steps
    assert got[3] == expect[3]                       # retirement steps
    for key in ("decode_steps", "decode_calls", "prefills",
                "prefilled_requests", "slot_steps", "busy_slot_steps"):
        assert eng.stats[key] == jstats[key], key
    assert eng.prefill_buckets == ()
    assert eng.stats["prefills"] == len(_specs())


def test_paging_and_buckets_switch_off_as_in_the_reference():
    """A paged plan quietly keeps the contiguous rolling cache and the
    tokens do not change; explicit buckets are refused."""
    _, tcfg, _, tparams = _served()
    eng = TEngine(tcfg, tparams, plan=_plan(TPlan, TVector, 4, pages=True),
                  device="cpu")
    assert not eng.paged and eng.page_pool is None
    assert _run(eng)[0] == _reference(4)[0][0]
    with pytest.raises(ValueError):
        TEngine(tcfg, tparams, device="cpu",
                plan=dataclasses.replace(_plan(TPlan, TVector, 1),
                                         prefill_buckets=(8, 16)))


def test_connect_serves_recurrentgemma_without_kernel_launches_on_cpu():
    """Through connect() on the CPU: the reference's tokens, and the
    plain versions run (no launch is counted)."""
    jcfg, tcfg, jparams, tparams = _served()
    prompts = [p for p, _, _ in _specs()[:4]]
    expect = JEngine(jcfg, jparams, plan=_plan(JPlan, JVector, 4))
    for rid, p in enumerate(prompts):
        expect.submit(JRequest(rid=rid, prompt=p, max_new_tokens=6))
    expect = {r.rid: list(r.output) for r in expect.run()}
    client = tserve.connect(tcfg, _plan(TPlan, TVector, 4), params=tparams,
                            device="cpu")
    fa_ops.reset_launch_counts()
    rglru_ops.reset_launch_counts()
    assert client.generate(prompts, max_new_tokens=6) == [
        expect[r] for r in range(len(prompts))]
    assert sum(fa_ops.LAUNCHES.values()) + sum(
        rglru_ops.LAUNCHES.values()) == 0


def test_trace_serve_windows_on_the_cpu():
    """The profiling tool's windows run on any device (on the CPU there
    are no kernel events, so no idle share, and no graph is captured) and
    the engine still serves every request."""
    from repro_torch.launch import trace_serve
    _, tcfg, _, tparams = _served()
    eng = TEngine(tcfg, tparams, plan=_plan(TPlan, TVector, 4),
                  device="cpu")
    prompts = [p for p, _, _ in _specs()[:5]]
    admission, decode, graph, unprofiled = trace_serve.trace(
        eng, prompts, 6, 2, 3)
    assert admission["prefills"] == N_SLOTS
    assert admission["prompt_tokens"] == sum(map(len, prompts[:N_SLOTS]))
    # budgets of 6: a horizon of 4, then one cut at the last live step,
    # both in the eager body's window; the first round is then drained
    assert decode["decode_steps"] == 6 and decode["batch"] == N_SLOTS
    assert graph["decode_steps"] == unprofiled["decode_steps"] == 0
    assert graph["graphs"] == eng.compile_count() == 0
    assert admission["device_idle_share"] is None
    assert sorted(len(r.output) for r in eng.done) == [6] * 5
