"""KV handoff, session export and evacuation: the port's
``ContinuousEngine`` against the JAX reference's, live, on the same
weights and requests (CPU, fp32 compute: greedy tokens exact).

* ``prefill_only``'s ``KVHandoff`` carries the reference's fields (pos,
  next token, remaining budget, emitted tokens, kv_tokens, kv_bytes) and
  a cache equal to the reference's within 1e-5 absolute + 1e-4 relative
  (fp32, two frameworks);
* prefill on one engine and decode on another (disaggregated) serves the
  tokens of one engine that does both (co-located), which are the
  reference's, contiguous and paged (a tight shared pool whose deferrals
  key on the payload's position), at K 1 and 4;
* ``export_session`` mid-stream and resumption on a second engine, in
  all four contiguous / paged pairings at K 1 and 4, equal the
  uninterrupted run and the reference's own migration, payloads and
  host syncs included; the source's pages all return;
* ``evacuate``'s live and queued lists, their emitted prefixes and the
  page pool afterwards equal the reference's;
* recurrentgemma's RG-LRU state and rolling window cache travel with an
  exported session (prompts and decode past the window of 16).
"""

import dataclasses

import jax
import numpy as np
import pytest

from repro.core.plan import EndpointPlan as JPlan
from repro.core.plan import SharingVector as JVector
from repro.serve.engine import ContinuousEngine as JEngine
from repro.serve.engine import Request as JRequest
from repro.serve.engine import _cache_bytes as j_cache_bytes
from repro_torch.core.plan import EndpointPlan as TPlan
from repro_torch.core.plan import SharingVector as TVector
from repro_torch.models.params import to_numpy, tree_leaves
from repro_torch.serve.engine import ContinuousEngine as TEngine
from repro_torch.serve.engine import Request as TRequest
from repro_torch.serve.engine import _cache_bytes as t_cache_bytes
from tests import test_torch_engine as qwen2
from tests import test_torch_recurrent_engine as rgemma

SIDES = {"repro": (JEngine, JRequest, JPlan, JVector),
         "port": (TEngine, TRequest, TPlan, TVector)}
FIELDS = ("rid", "next_tok", "pos", "remaining", "emitted", "eos_id",
          "kv_tokens", "kv_bytes")


def _module(arch):
    return qwen2 if arch == "qwen2-0.5b" else rgemma


def _engine(side, arch, pages, horizon):
    """An engine of ``side`` ("repro" or "port") on ``arch``'s smoke
    config at fp32 and the parity tests' plan (pages: level 4 with a
    tight budget of 8 pages on qwen2; recurrentgemma stays contiguous)."""
    eng_cls, _, plan_cls, vec_cls = SIDES[side]
    mod = _module(arch)
    jcfg, tcfg, jparams, tparams = mod._served()
    plan = mod._plan(plan_cls, vec_cls, horizon, pages)
    if side == "repro":
        return eng_cls(jcfg, jparams, plan=plan)
    return eng_cls(tcfg, tparams, plan=plan, device="cpu")


def _requests(side, arch, rids=None, handoffs=None):
    """The arch's parity specs as requests of ``side``; ``rids`` picks
    some; ``handoffs`` ({rid: KVHandoff}) attaches payloads."""
    req_cls = SIDES[side][1]
    specs = _module(arch)._specs()
    rids = range(len(specs)) if rids is None else rids
    handoffs = handoffs or {}
    return [req_cls(rid=rid, prompt=specs[rid][0],
                    max_new_tokens=specs[rid][1], eos_id=specs[rid][2],
                    kv=handoffs.get(rid)) for rid in rids]


def _outputs(requests):
    return {r.rid: list(r.output) for r in requests}


def _fields(h):
    return {f: getattr(h, f) for f in FIELDS}


def _uninterrupted(arch, pages, horizon):
    if arch == "qwen2-0.5b":
        return qwen2._reference(horizon, pages)[0][0]
    return rgemma._reference(horizon)[0][0]


def _cache_arrays(side, cache):
    """Every leaf of a batch-1 cache's stack as numpy, in leaf order."""
    if side == "repro":
        return [np.asarray(a) for a in jax.tree.leaves(
            jax.device_get(cache["stack"]))]
    return [np.asarray(a) for a in tree_leaves(to_numpy(cache["stack"]))]


# ----- prefill_only ----------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2-0.5b", "recurrentgemma-2b"])
def test_handoff_fields_match_reference(arch):
    payloads = {}
    for side in SIDES:
        eng = _engine(side, arch, False, 4)
        last = len(_module(arch)._specs()) - 1     # reaches the cache edge
        payloads[side] = [eng.prefill_only(r) for r in
                          _requests(side, arch, rids=[0, 3, last])]
        assert eng.stats["prefills"] == eng.stats["host_syncs"] == 3
    for j, t in zip(payloads["repro"], payloads["port"]):
        assert _fields(t) == _fields(j)
        assert t.kv_tokens == t.pos and t.emitted == []
        assert t.kv_bytes == t_cache_bytes(t.cache, t.pos, qwen2.MAX_LEN)
        assert j.kv_bytes == j_cache_bytes(j.cache, j.pos, qwen2.MAX_LEN)
        assert t.cache["idx"].dim() == 0 and int(t.cache["idx"]) == t.pos
        jl, tl = _cache_arrays("repro", j.cache), _cache_arrays("port",
                                                                t.cache)
        assert [a.shape for a in tl] == [a.shape for a in jl]
        assert [a.dtype for a in tl] == [a.dtype for a in jl]
        for a, b in zip(tl, jl):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


# ----- disaggregation --------------------------------------------------------

def _disaggregated(side, arch, pages, horizon):
    """Prefill every request on one engine, decode the payloads on
    another; -> (tokens, payloads, the decode engine)."""
    prefill = _engine(side, arch, pages, horizon)
    handoffs = {r.rid: prefill.prefill_only(r)
                for r in _requests(side, arch)}
    decode = _engine(side, arch, pages, horizon)
    for r in _requests(side, arch, handoffs=handoffs):
        decode.submit(r)
    return _outputs(decode.run()), handoffs, decode


DISAGG_CASES = [("qwen2-0.5b", False, 1), ("qwen2-0.5b", False, 4),
                ("qwen2-0.5b", True, 1), ("qwen2-0.5b", True, 4),
                ("recurrentgemma-2b", False, 4)]


@pytest.mark.parametrize("arch,pages,horizon", DISAGG_CASES)
def test_disaggregated_equals_colocated_and_reference(arch, pages, horizon):
    j_out, j_h, j_dec = _disaggregated("repro", arch, pages, horizon)
    t_out, t_h, t_dec = _disaggregated("port", arch, pages, horizon)
    colocated = _engine("port", arch, pages, horizon)
    for r in _requests("port", arch):
        colocated.submit(r)
    assert t_out == j_out
    assert t_out == _outputs(colocated.run())
    assert t_out == _uninterrupted(arch, pages, horizon)
    assert {rid: _fields(h) for rid, h in t_h.items()} == \
        {rid: _fields(h) for rid, h in j_h.items()}
    assert t_dec.stats["prefills"] == 0 and t_dec.admit_order == \
        j_dec.admit_order
    assert t_dec.admit_steps == j_dec.admit_steps
    assert t_dec.retire_steps == j_dec.retire_steps
    if t_dec.paged:
        assert t_dec.stats["page_deferrals"] == \
            j_dec.stats["page_deferrals"]
        assert t_dec.page_pool.live_pages == 0


# ----- live migration --------------------------------------------------------

def _migrated(side, arch, src, dst, horizon):
    """Engine A runs two admission rounds and horizons, exports every
    live session; engine B admits the payloads and A's queue and
    finishes.  -> (tokens, payloads, A)."""
    a = _engine(side, arch, src, horizon)
    for r in _requests(side, arch):
        a.submit(r)
    a.start()
    for _ in range(2):
        a.admit_waiting()
        a.step()
    handoffs = a.export_sessions()
    assert handoffs and a.n_active == 0
    queued = [r.rid for r in a.queue]
    a.queue.clear()
    b = _engine(side, arch, dst, horizon)
    for r in _requests(side, arch, rids=[h.rid for h in handoffs],
                       handoffs={h.rid: h for h in handoffs}):
        b.submit(r)
    for r in _requests(side, arch, rids=queued):
        b.submit(r)
    return {**_outputs(a.done), **_outputs(b.run())}, handoffs, a


PAIRS = [(False, False), (False, True), (True, False), (True, True)]


@pytest.mark.parametrize("src,dst", PAIRS,
                         ids=["contig-contig", "contig-paged",
                              "paged-contig", "paged-paged"])
@pytest.mark.parametrize("horizon", [1, 4])
def test_export_mid_stream_resumes_on_a_second_engine(src, dst, horizon):
    arch = "qwen2-0.5b"
    j_out, j_h, j_a = _migrated("repro", arch, src, dst, horizon)
    t_out, t_h, t_a = _migrated("port", arch, src, dst, horizon)
    assert t_out == j_out == _uninterrupted(arch, src, horizon)
    assert [_fields(h) for h in t_h] == [_fields(h) for h in j_h]
    assert any(h.emitted for h in t_h)
    assert t_a.stats["host_syncs"] == j_a.stats["host_syncs"]
    for h in t_h:
        assert h.cache["idx"].dim() == 0 and int(h.cache["idx"]) == h.pos
        assert h.cache["stack"]["body"][0]["attn"]["k"].shape[1:3] == \
            (1, qwen2.MAX_LEN)
    if src:
        pool = t_a.page_pool
        assert pool.live_pages == 0 and pool.free_pages == pool.total_pages
        assert (t_a._cache["pt"] == pool.total_pages).all()


def test_recurrent_state_and_rolling_cache_travel():
    """recurrentgemma sessions exported after prompts of up to 30 tokens
    and decode across position 16 (the window) resume on a second
    engine with the uninterrupted tokens and the reference's."""
    arch = "recurrentgemma-2b"
    j_out, j_h, _ = _migrated("repro", arch, False, False, 4)
    t_out, t_h, t_a = _migrated("port", arch, False, False, 4)
    assert t_out == j_out == _uninterrupted(arch, False, 4)
    assert [_fields(h) for h in t_h] == [_fields(h) for h in j_h]
    assert any(h.pos > 16 for h in t_h)
    leaves = {k for h in t_h for group in ("prefix", "body")
              for blk in h.cache["stack"][group] for k in blk}
    assert leaves == {"attn", "rglru"}
    for h, j in zip(t_h, j_h):
        for a, b in zip(_cache_arrays("port", h.cache),
                        _cache_arrays("repro", j.cache)):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


# ----- evacuation ------------------------------------------------------------

def _evacuated(side, pages, horizon):
    eng = _engine(side, "qwen2-0.5b", pages, horizon)
    for r in _requests(side, "qwen2-0.5b"):
        eng.submit(r)
    eng.start()
    for _ in range(2):
        eng.admit_waiting()
        eng.step()
    live, queued = eng.evacuate()
    pool = eng.page_pool
    return (_outputs(live), [r.rid for r in queued], _outputs(queued),
            eng.n_active, len(eng.queue), len(eng.done),
            None if pool is None else (pool.live_pages, pool.free_pages,
                                       pool.total_pages)), eng


@pytest.mark.parametrize("pages", [False, True], ids=["contiguous", "pages4"])
@pytest.mark.parametrize("horizon", [1, 4])
def test_evacuate_matches_reference(pages, horizon):
    expect, _ = _evacuated("repro", pages, horizon)
    got, eng = _evacuated("port", pages, horizon)
    assert got == expect
    live, queued_rids, queued, n_active, n_queue, _, pool = got
    assert live and queued_rids and not any(queued.values())
    assert n_active == n_queue == 0
    if pages:
        assert pool[0] == 0 and pool[1] == pool[2]
    # the engine stays steppable: it serves new work afterwards
    whole = _uninterrupted("qwen2-0.5b", pages, horizon)
    n_done = len(eng.done)
    for r in _requests("port", "qwen2-0.5b", rids=[0, 1, 2]):
        eng.submit(dataclasses.replace(r, rid=100 + r.rid))
    again = _outputs(eng.run()[n_done:])
    assert again == {100 + rid: whole[rid] for rid in (0, 1, 2)}
