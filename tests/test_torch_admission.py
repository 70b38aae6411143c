"""The port's admission round against the reference's jitted one, live, on
the CPU at fp32.

``serve.engine.AdmissionGraphs.body`` is what the card captures per
prefill bucket (on the CPU it runs uncaptured on the same static
buffers).  On the qwen2-0.5b and granite-moe-1b-a400m smoke configs,
with the reference's own weights, each case loads one round into it and
runs the reference's ``_shared_steps(cfg, False).admit_packed`` (or
``admit_packed_paged``) on the same numpy inputs: a cache of 4 slots,
every float leaf, ``idx``, the page table and the five decode-state
tensors drawn at random, so that a write where none belongs shows.
Rounds of 1, 2 and 4 rows in the smallest bucket (8 of 8, 16 and 32);
paged, a fragmented table over a tight pool of 10 pages (4 slots of up
to 4 pages) whose rows end in sentinels.  After the round:

* ``idx``, ``pt``, the first tokens and the five state tensors equal the
  reference's;
* every float cache leaf is within ``ATOL`` (1e-5, as
  ``test_torch_moe.py``) of the reference's;
* every slot (contiguous) or page (paged) outside the round is
  bit-unchanged;
* the body without a state (K = 1) lands the same cache and first
  tokens.

Then one engine per config through ``connect`` (qwen2-0.5b paged at K
4, granite contiguous at K 1): the tokens equal the reference's
``ContinuousEngine`` exactly, and every static buffer (the horizon's
and the admission's) keeps its ``data_ptr()`` through every admission
round and decode call.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from repro.serve import engine as j_engine
from repro_torch.models import Model
from repro_torch.models.params import from_numpy, tree_leaves
from repro_torch.serve import engine as t_engine
from tests import test_torch_engine as engine_tests
from tests.test_torch_graphs import _addresses

ARCHS = ["qwen2-0.5b", "granite-moe-1b-a400m"]
ATOL = 1e-5
N_SLOTS, MAX_LEN, PAGE_SIZE, N_PAGES = 4, 32, 8, 10
BUCKETS = (8, 16, 32)

#: name -> (slot, prompt length) of each row, in the smallest bucket
#: (each bucket is a jax compile); the rows take slots out of order
ROUNDS = {
    "one row": ((2, 5),),
    "two rows": ((3, 8), (0, 3)),
    "every slot": ((1, 6), (3, 8), (0, 1), (2, 7)),
}


@functools.lru_cache(maxsize=None)
def _models(arch):
    jcfg, tcfg, jparams, tparams = engine_tests.served(arch)
    steps = j_engine._shared_steps(jcfg, False)
    return steps, Model(tcfg, "cpu"), jparams, tparams


def _table(rng, round_slots):
    """A fragmented page table over the tight pool: slots in a random
    order take 0 to 4 distinct pages each (a slot of the round at least
    one, and enough left for the round's later slots), the rest of each
    row the sentinel."""
    pages = [int(p) for p in rng.permutation(N_PAGES)]
    table = np.full((N_SLOTS, MAX_LEN // PAGE_SIZE), N_PAGES, np.int32)
    order = [int(s) for s in rng.permutation(N_SLOTS)]
    for i, slot in enumerate(order):
        later = sum(s in round_slots for s in order[i + 1:])
        want = int(rng.integers(int(slot in round_slots), 5))
        for j in range(min(want, len(pages) - later)):
            table[slot, j] = pages.pop()
    return table


def _inputs(arch, paged, rows, bucket, seed):
    """The cache (numpy tree), state and the round, drawn from ``seed``."""
    steps, _, _, _ = _models(arch)
    rng = np.random.default_rng(seed)
    cache = steps.model.init_cache(
        N_SLOTS, MAX_LEN, per_slot=True,
        page_size=PAGE_SIZE if paged else 0, n_pages=N_PAGES)
    cache = jax.tree.map(np.asarray, jax.device_get(cache))
    for group in ("prefix", "body"):
        cache["stack"][group] = jax.tree.map(
            lambda a: rng.standard_normal(a.shape).astype(a.dtype),
            cache["stack"][group])
    cache["idx"] = rng.integers(0, MAX_LEN, N_SLOTS).astype(np.int32)
    slots = [s for s, _ in rows]
    if paged:
        cache["pt"] = _table(rng, slots)
    state = {"tok": rng.integers(0, 128, N_SLOTS).astype(np.int32),
             "remaining": rng.integers(0, 9, N_SLOTS).astype(np.int32),
             "finished": rng.random(N_SLOTS) < 0.5,
             "eos": rng.integers(-1, 128, N_SLOTS).astype(np.int32),
             "has_eos": rng.random(N_SLOTS) < 0.5}
    n = N_SLOTS
    toks = np.zeros((n, bucket), np.int32)
    last = np.zeros(n, np.int32)
    slot_ids = np.zeros(n, np.int32)
    valid = np.zeros(n, bool)
    lengths = np.zeros(n, np.int32)
    remaining = np.zeros(n, np.int32)
    eos = np.full(n, -1, np.int32)
    has_eos = np.zeros(n, bool)
    for j, (slot, ln) in enumerate(rows):
        toks[j, :ln] = rng.integers(1, 128, ln)
        last[j] = ln - 1
        slot_ids[j] = slot
        valid[j] = True
        lengths[j] = ln
        remaining[j] = rng.integers(1, 9)
        eos[j] = rng.integers(0, 128) if j % 2 else -1
        has_eos[j] = bool(j % 2)
    round_ = (toks, last, slot_ids, valid, lengths, remaining, eos, has_eos)
    return cache, state, round_


def _reference(arch, paged, cache, state, round_):
    steps, _, jparams, _ = _models(arch)
    args = [jax.numpy.asarray(a) for a in round_]
    if paged:
        out = steps.admit_packed_paged(jparams, cache, state, *args,
                                       jax.numpy.asarray(cache["pt"]),
                                       MAX_LEN)
    else:
        out = steps.admit_packed(jparams, cache, state, *args, MAX_LEN)
    return jax.tree.map(np.asarray, jax.device_get(out))


def _port(arch, paged, cache, state, round_, with_state=True):
    _, model, _, tparams = _models(arch)
    tcache = from_numpy(jax.tree.map(np.array, cache))
    tstate = from_numpy(state) if with_state else None
    graphs = t_engine.AdmissionGraphs(
        model, tparams, tcache, tstate, buckets=BUCKETS, max_len=MAX_LEN,
        n_pages=N_PAGES if paged else 0,
        group=t_engine.ExecGroup(("test",)))
    bucket = graphs.load(*round_, cache.get("pt"))
    first = graphs.body(bucket).clone()
    return tcache, tstate, first


def _written(cache, paged, slots):
    """-> the boolean mask, over a leaf's batch (contiguous) or page
    (paged) axis, of what the round may write."""
    if paged:
        pages = {int(p) for s in slots for p in cache["pt"][s]
                 if p < N_PAGES}
        size = N_PAGES
    else:
        pages, size = set(slots), N_SLOTS
    return np.array([i in pages for i in range(size)])


@pytest.mark.parametrize("name", sorted(ROUNDS))
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_body_matches_the_reference_round(arch, paged, name):
    rows = ROUNDS[name]
    cache, state, round_ = _inputs(arch, paged, rows, BUCKETS[0],
                                   seed=len(rows))
    before = [np.array(a) for a in jax.tree.leaves(
        [cache["stack"]["prefix"], cache["stack"]["body"]])]
    j_cache, j_state = _reference(arch, paged, cache, state, round_)
    t_cache, t_state, first = _port(arch, paged, cache, state, round_)
    slots = [s for s, _ in rows]
    assert np.array_equal(t_cache["idx"].numpy(), j_cache["idx"])
    if paged:
        assert (cache["pt"][slots] == N_PAGES).any()      # sentinels
        assert np.array_equal(t_cache["pt"].numpy(), j_cache["pt"])
    for key, value in j_state.items():
        assert np.array_equal(t_state[key].numpy(), value), key
    assert [int(first[j]) for j in range(len(rows))] == \
        [int(j_state["tok"][s]) for s in slots]
    written = _written(cache, paged, slots)
    got = [t.numpy() for t in tree_leaves(
        [t_cache["stack"]["prefix"], t_cache["stack"]["body"]])]
    expect = jax.tree.leaves([j_cache["stack"]["prefix"],
                              j_cache["stack"]["body"]])
    n_prefix = len(jax.tree.leaves(cache["stack"]["prefix"]))
    assert len(got) == len(expect) == len(before) > 0
    for i, (g, e, b) in enumerate(zip(got, expect, before)):
        np.testing.assert_allclose(g, e, rtol=0, atol=ATOL)
        axis = 0 if i < n_prefix else 1
        keep = np.take(g, np.flatnonzero(~written), axis=axis)
        assert np.array_equal(keep, np.take(b, np.flatnonzero(~written),
                                            axis=axis)), i
    # K = 1: no state; the same cache and first tokens
    k1_cache, _, k1_first = _port(arch, paged, cache, state, round_,
                                  with_state=False)
    assert torch.equal(k1_first, first)
    for a, b in zip(tree_leaves(k1_cache), tree_leaves(t_cache)):
        assert torch.equal(a, b)


def test_load_refuses_an_empty_round_and_an_unknown_bucket():
    cache, state, round_ = _inputs("qwen2-0.5b", False, ((1, 3),), 16, 0)
    _, model, _, tparams = _models("qwen2-0.5b")
    graphs = t_engine.AdmissionGraphs(
        model, tparams, from_numpy(cache), None, buckets=(16,),
        max_len=MAX_LEN, n_pages=0, group=t_engine.ExecGroup(("test",)))
    empty = list(round_)
    empty[3] = np.zeros(N_SLOTS, bool)
    with pytest.raises(ValueError, match="needs a row"):
        graphs.load(*empty)
    other = list(round_)
    other[0] = np.zeros((N_SLOTS, 8), np.int32)
    with pytest.raises(ValueError, match="bucket"):
        graphs.load(*other)


@pytest.mark.parametrize("arch,horizon,paged", [
    ("qwen2-0.5b", 4, True), ("granite-moe-1b-a400m", 1, False)],
    ids=["qwen2-K4-paged", "granite-K1-contiguous"])
def test_engine_serves_the_reference_with_fixed_buffers(arch, horizon,
                                                        paged):
    """The smoke config through ``connect`` (3 slots, max_len 48; paged,
    a tight shared pool of 8 pages): after every admission round and
    every decode call each static buffer sits where it was at
    ``start()``, and the tokens equal the reference's.  No graph is
    captured on the CPU."""
    expect, _, _ = engine_tests.connect_family("repro", arch, horizon,
                                               paged)
    _, tcfg, _, tparams = engine_tests.served(arch)
    plan = engine_tests._plan(engine_tests.TPlan, engine_tests.TVector,
                              horizon, paged)
    engine_tests.clear_caches("port")
    client = engine_tests.tserve.connect(tcfg, plan, params=tparams,
                                         device="cpu")
    eng = client.engine
    eng.start()
    fixed = _addresses(eng)
    assert any(k.startswith("admission.tokens") for k in fixed)
    calls = []

    def checked(method):
        def call(*args, **kw):
            out = method(*args, **kw)
            calls.append(method.__name__)
            assert _addresses(eng) == fixed, method.__name__
            return out
        return call

    eng.admit_waiting = checked(eng.admit_waiting)
    eng.step = checked(eng.step)
    for prompt, max_new, eos in engine_tests.family_specs():
        client.submit(prompt, max_new_tokens=max_new, eos_id=eos)
    got = client.run()
    assert got == expect
    assert eng.stats["prefills"] >= 2 and "step" in calls
    assert eng.admission_graph_count() == eng.graph_count() == 0


def test_trace_serve_admission_windows_on_the_cpu():
    """The profiling tool on an engine that admits in buckets: an
    untraced round (which would capture), then the same requests again
    through the eager body and through the admission runner, each a
    window; the run that goes on from the second serves every request
    the tokens of a plain run.  On the CPU there are no kernel events and
    nothing is captured."""
    from repro_torch.launch import trace_serve
    _, tcfg, _, tparams = engine_tests.served("qwen2-0.5b")
    plan = engine_tests._plan(engine_tests.TPlan, engine_tests.TVector, 4,
                              False)
    prompts = [p for p, _, _ in engine_tests.family_specs()[:5]]
    plain = engine_tests.tserve.connect(tcfg, plan, params=tparams,
                                        device="cpu")
    expect = plain.generate(prompts, max_new_tokens=6)
    eng = t_engine.ContinuousEngine(tcfg, tparams, plan, device="cpu")
    windows = trace_serve.trace(eng, prompts, 6, 2, 3)
    assert [w["window"] for w in windows] == [
        "admission eager", "admission graph", "decode eager",
        "decode graph", "decode graph unprofiled"]
    eager, graph = windows[:2]
    n = engine_tests.N_SLOTS
    assert eager["prefills"] == graph["prefills"] == n
    assert eager["prompt_tokens"] == sum(map(len, prompts[:n]))
    assert graph["admission_graphs"] == eng.admission_graph_count() == 0
    assert graph["capture_pool_bytes"] == 0
    assert eager["device_idle_share"] is None
    assert [r.output for r in sorted(eng.done, key=lambda r: r.rid)] == \
        expect
