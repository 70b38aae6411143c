"""The port's ContinuousEngine and connect() against the JAX reference's,
live, on the same weights and requests (CPU, fp32 compute).

At fp32 greedy decoding is exact between the two frameworks on these
weights, so tokens, admission order, admission steps and retirement steps
must be equal, for the per-step oracle (K=1) and the fused horizon (K=8),
on the contiguous cache and on a paged cache with a shared, tight page
pool (pages level 4) that defers admissions.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest

from repro import serve as jserve
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
from repro_torch.models.params import from_numpy
from repro_torch.serve.engine import ContinuousEngine as TEngine
from repro_torch.serve.engine import Request as TRequest

N_SLOTS, MAX_LEN = 3, 48


@functools.lru_cache(maxsize=None)
def _served():
    """(JAX cfg, port cfg, JAX params, port params) at fp32 compute."""
    jcfg = dataclasses.replace(jax_smoke_config("qwen2-0.5b"),
                               compute_dtype="float32")
    tcfg = ArchConfig(**dataclasses.asdict(jcfg))
    jparams = JModel(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, tcfg, jparams, from_numpy(jax.device_get(jparams))


def _specs():
    """A dozen mixed requests: ragged prompts and budgets, two EOS ids,
    and one long prompt that reaches the cache edge (bonus token)."""
    rng = np.random.default_rng(3)
    out = []
    for i in range(11):
        prompt = rng.integers(1, 100, size=int(rng.integers(2, 20)))
        eos = int(rng.integers(0, 128)) if i in (2, 7) else None
        out.append((prompt.astype(np.int32), int(rng.integers(1, 9)), eos))
    out.append((np.arange(1, 41, dtype=np.int32), 20, None))
    return out


def _plan(cls, vec_cls, horizon, pages):
    kw = dict(n_slots=N_SLOTS, max_len=MAX_LEN, decode_horizon=horizon,
              executor="continuous")
    if pages:
        # shared pool of 8 pages of 12 tokens: fewer than 3 slots x 4
        # pages, so admissions defer on the pool
        return cls(vector=vec_cls(pages=4), page_budget=8, **kw)
    return cls(vector=vec_cls(), **kw)


def _run(engine):
    for rid, (prompt, max_new, eos) in enumerate(_specs()):
        req_cls = TRequest if isinstance(engine, TEngine) else JRequest
        engine.submit(req_cls(rid=rid, prompt=prompt,
                              max_new_tokens=max_new, eos_id=eos))
    done = {r.rid: list(r.output) for r in engine.run()}
    return (done, engine.admit_order, engine.admit_steps,
            engine.retire_steps)


@functools.lru_cache(maxsize=None)
def _reference(horizon, pages):
    jcfg, _, jparams, _ = _served()
    eng = JEngine(jcfg, jparams, plan=_plan(JPlan, JVector, horizon, pages))
    return _run(eng), eng.stats


@pytest.mark.parametrize("pages", [False, True], ids=["contiguous", "pages4"])
@pytest.mark.parametrize("horizon", [1, 8])
def test_engine_matches_reference(horizon, pages):
    _, tcfg, _, tparams = _served()
    plan = _plan(TPlan, TVector, horizon, pages)
    eng = TEngine(tcfg, tparams, plan=plan, device="cpu")
    got = _run(eng)
    (expect, jstats) = _reference(horizon, pages)
    assert got[0] == expect[0]                       # tokens
    assert got[1] == expect[1]                       # admission order
    assert got[2] == expect[2]                       # admission steps
    assert got[3] == expect[3]                       # retirement steps
    assert eng.paged == pages
    for key in ("decode_steps", "decode_calls", "prefills",
                "prefilled_requests", "slot_steps", "busy_slot_steps"):
        assert eng.stats[key] == jstats[key], key
    if pages:
        assert eng.stats["page_deferrals"] == jstats["page_deferrals"] > 0
        assert eng.stats["page_hwm"] == jstats["page_hwm"]


def test_plain_decode_versions_serve_the_same_tokens():
    """use_ragged_kernel on the CPU routes decode attention through the
    kernels' plain versions (the card always runs the kernels): the
    tokens do not change."""
    _, tcfg, _, tparams = _served()
    for pages in (False, True):
        plan = dataclasses.replace(_plan(TPlan, TVector, 8, pages),
                                   use_ragged_kernel=True)
        got = _run(TEngine(tcfg, tparams, plan=plan, device="cpu"))
        assert got[0] == _reference(8, pages)[0][0], pages


def test_exact_length_admission_matches_buckets():
    """prefill_buckets=None admits each prompt alone at its exact length;
    the tokens equal the bucketed path's."""
    _, tcfg, _, tparams = _served()
    plan = dataclasses.replace(_plan(TPlan, TVector, 8, True),
                               prefill_buckets=None)
    eng = TEngine(tcfg, tparams, plan=plan, device="cpu")
    got = _run(eng)
    assert got[0] == _reference(8, True)[0][0]
    assert eng.stats["prefills"] == eng.stats["prefilled_requests"] == 12


@pytest.mark.parametrize("horizon", [1, 8])
def test_connect_streams_match_reference(horizon):
    """Two ordered streams plus unordered requests through connect():
    same tokens per request, and each stream's requests retire in
    submission order."""
    jcfg, tcfg, jparams, tparams = _served()
    clients = (jserve.connect(jcfg, "shared_dynamic", params=jparams,
                              n_slots=N_SLOTS, max_len=MAX_LEN,
                              decode_horizon=horizon),
               tserve.connect(tcfg, "shared_dynamic", params=tparams,
                              n_slots=N_SLOTS, max_len=MAX_LEN,
                              decode_horizon=horizon, device="cpu"))
    outs = []
    for client in clients:
        streams = [client.stream("a"), client.stream("b")]
        for i, (prompt, max_new, _) in enumerate(_specs()[:9]):
            if i % 3 == 2:
                client.submit(prompt, max_new_tokens=max_new)
            else:
                streams[i % 3].submit(prompt, max_new_tokens=max_new)
        outs.append((client.run(), [s.rids for s in streams],
                     client.engine.retire_steps))
    (j_out, j_rids, j_retire), (t_out, t_rids, t_retire) = outs
    assert t_out == j_out and t_rids == j_rids and t_retire == j_retire
    for rids in t_rids:
        steps = [t_retire[r] for r in rids]
        assert steps == sorted(steps)


def test_generate_returns_outputs_in_input_order():
    _, tcfg, _, tparams = _served()
    client = tserve.connect(tcfg, params=tparams, n_slots=2, max_len=32,
                            device="cpu")
    prompts = [p for p, _, _ in _specs()[:4]]
    out = client.generate(prompts, max_new_tokens=3)
    assert [len(o) for o in out] == [3, 3, 3, 3]
    solo = tserve.connect(tcfg, params=tparams, n_slots=1, max_len=32,
                          device="cpu")
    assert solo.generate(prompts[1:2], max_new_tokens=3) == out[1:2]


def test_unported_executors_raise():
    """Only the tuned-plan repository still raises NotImplementedError
    (the planner slice); the fleet executor and adaptive re-planning
    serve; faults on a single-engine plan are the caller's error
    (ValueError), as in the reference, and the wave executor serves."""
    _, tcfg, _, tparams = _served()
    fleet = tserve.connect(tcfg, params=tparams, n_workers=2, device="cpu")
    assert fleet.executor == "fleet" and fleet.engine is None
    assert fleet.generate([np.arange(1, 5, dtype=np.int32)], 2)[0]
    assert len(fleet.workers) == 2
    adaptive = tserve.connect(tcfg, params=tparams, adaptive=True,
                              device="cpu")
    assert adaptive.executor == "continuous" and adaptive.plan.adaptive
    with pytest.raises(NotImplementedError, match="planner slice"):
        tserve.connect(tcfg, params=tparams, device="cpu",
                       plan_repository=object())
    with pytest.raises(ValueError, match="fleet"):
        tserve.connect(tcfg, params=tparams, device="cpu", faults="x")
    wave = tserve.connect(tcfg, params=tparams, executor="wave",
                          device="cpu")
    assert wave.executor == "wave"
