"""The execs axis' signal against the reference's, live: the port's
``compile_count()`` counts what the reference's does, the jit
specializations of the exec group's seven executables.

A scripted session runs on both packages, each from cleared caches
(``jax.clear_caches()`` and ``_shared_steps_cached.cache_clear()`` on
the reference's side, ``clear_exec_groups()`` on the port's).  It drives
engines of one exec group through qwen2-0.5b's smoke config, contiguous
and paged: bucketed admission at several buckets, horizons at K 1, 2 and
4, exact-length admission, ``prefill_only`` and KV handoff admission,
``export_session`` into a second engine, the wave engine and
recurrentgemma-2b's exact-length prefills.  After every call, each
entry's count in the port (``ExecGroup.count``) equals the reference's
``_cache_size()`` of that executable, and ``compile_count()`` equals the
reference's.  The counts are the same on the CPU and on the card.
"""

import jax
import numpy as np

from repro.core.plan import EndpointPlan as JPlan
from repro.core.plan import SharingVector as JVector
from repro.serve import engine as jengine
from repro_torch.core.plan import EndpointPlan as TPlan
from repro_torch.core.plan import SharingVector as TVector
from repro_torch.serve import engine as tengine
from repro_torch.serve.fabric.router import EngineWorker
from tests import test_torch_engine as qwen2
from tests import test_torch_recurrent_engine as rgemma

MAX_LEN = 48


class Side:
    """One package's engines, plans and counts."""

    def __init__(self, name: str):
        self.name = name
        self.ref = name == "repro"
        self.eng_mod = jengine if self.ref else tengine
        self.plan_cls, self.vec_cls = ((JPlan, JVector) if self.ref
                                       else (TPlan, TVector))

    def clear(self):
        if self.ref:
            jax.clear_caches()
            jengine._shared_steps_cached.cache_clear()
        else:
            tengine.clear_exec_groups()

    def plan(self, executor="continuous", **kw):
        kw.setdefault("n_slots", 3)
        pages = kw.pop("pages", 1)
        return self.plan_cls(vector=self.vec_cls(pages=pages),
                             max_len=MAX_LEN, executor=executor, **kw)

    def engine(self, served, **kw):
        jcfg, tcfg, jparams, tparams = served()
        if self.ref:
            return jengine.ContinuousEngine(jcfg, jparams,
                                            plan=self.plan(**kw))
        return tengine.ContinuousEngine(tcfg, tparams, self.plan(**kw),
                                        device="cpu")

    def wave(self, served):
        jcfg, tcfg, jparams, tparams = served()
        if self.ref:
            return jengine.ServeEngine(jcfg, jparams,
                                       plan=self.plan("wave", n_slots=2))
        return tengine.ServeEngine(tcfg, tparams, self.plan("wave",
                                                            n_slots=2),
                                   device="cpu")

    def request(self, rid, prompt, max_new):
        return self.eng_mod.Request(rid=rid, prompt=prompt,
                                    max_new_tokens=max_new)

    def counts(self, eng, cfg_served=None, ragged=None) -> dict:
        """Each entry's specializations in ``eng``'s exec group."""
        if self.ref:
            steps = getattr(eng, "_steps", None) or jengine._shared_steps(
                cfg_served()[0], False, 0)
            out = {e: getattr(steps, e)._cache_size()
                   for e in tengine.ENTRIES}
        else:
            out = {e: eng.group.count(e) for e in tengine.ENTRIES}
        if hasattr(eng, "compile_count"):
            out["compile_count"] = eng.compile_count()
        return out


def _prompts(seed: int, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 100, size=n).astype(np.int32) for n in lengths]


def _drive(side, eng, log, label):
    """Admit and step ``eng`` to the end, logging counts after each
    call."""
    while eng.has_work:
        eng.admit_waiting()
        log.append((label, "admit", side.counts(eng)))
        retired = eng.step()
        log.append((label, "step", side.counts(eng)))
        if not retired and eng.n_active == 0:
            break


def session(side: Side) -> list:
    side.clear()
    log = []
    # bucketed admission at buckets 8, 16, 32 and 48, the per-step loop
    lengths = (3, 12, 20, 40, 7, 30)
    for k, pages in ((1, 1), (4, 1), (2, 4), (4, 4)):
        eng = side.engine(qwen2._served, decode_horizon=k, pages=pages,
                          page_budget=8 if pages > 1 else None)
        for rid, p in enumerate(_prompts(k + pages, lengths)):
            eng.submit(side.request(rid, p, 5))
        _drive(side, eng, log, f"buckets K{k} p{pages}")
    # exact-length admission: a prefill per length, then a merge
    for pages in (1, 4):
        eng = side.engine(qwen2._served, decode_horizon=1, pages=pages,
                          prefill_buckets=None)
        for rid, p in enumerate(_prompts(5, (4, 9, 4, 13))):
            eng.submit(side.request(rid, p, 3))
        _drive(side, eng, log, f"exact p{pages}")
    # prefill_only on one engine, the handoffs admitted by two more
    prefill = side.engine(qwen2._served, decode_horizon=1,
                          prefill_buckets=None)
    for pages, k in ((1, 2), (4, 4)):
        decode = side.engine(qwen2._served, decode_horizon=k, pages=pages)
        for rid, p in enumerate(_prompts(7 + pages, (6, 11))):
            req = side.request(rid, p, 4)
            req.kv = prefill.prefill_only(side.request(rid, p, 4))
            log.append((f"handoff p{pages}", "prefill_only",
                        side.counts(prefill)))
            decode.submit(req)
        _drive(side, decode, log, f"handoff p{pages}")
    # export_session mid-stream, resumed on a second engine
    for pages in (1, 4):
        a = side.engine(qwen2._served, decode_horizon=2, pages=pages)
        prompts = _prompts(11, (5, 15))
        for rid, p in enumerate(prompts):
            a.submit(side.request(rid, p, 6))
        a.admit_waiting()
        a.step()
        b = side.engine(qwen2._served, decode_horizon=1, pages=pages)
        for h in a.export_sessions():
            req = side.request(h.rid, prompts[h.rid], h.remaining)
            req.kv = h
            b.submit(req)
        log.append((f"export p{pages}", "export", side.counts(a)))
        _drive(side, b, log, f"export p{pages}")
    # the wave engine: exec group 0's prefill and decode, no ragged kernel
    wave = side.wave(qwen2._served)
    for rid, p in enumerate(_prompts(13, (6, 6, 9))):
        wave.submit(side.request(rid, p, 3))
    wave.run()
    log.append(("wave", "run", side.counts(wave, qwen2._served)))
    # recurrentgemma: exact-length prefills at every length
    for k in (1, 4):
        eng = side.engine(rgemma._served, decode_horizon=k)
        for rid, p in enumerate(_prompts(17, (5, 20, 12, 5))):
            eng.submit(side.request(rid, p, 6))
        _drive(side, eng, log, f"recurrentgemma K{k}")
    return log


def test_compile_counts_match_the_reference_after_every_call():
    expect = session(Side("repro"))
    got = session(Side("port"))
    assert [(a, b) for a, b, _ in got] == [(a, b) for a, b, _ in expect]
    for (label, call, g), (_, _, e) in zip(got, expect):
        assert g == e, (label, call)
    # every entry ran: the session reaches all seven
    assert all(any(c[e] for _, _, c in expect) for e in tengine.ENTRIES)


def test_probe_counts_each_group_and_graphs_are_apart():
    """``compile_probe()`` is (the group's identity, its count), one key
    for the engines of a group; ``graph_count()`` counts captured graphs
    (none on the CPU) apart from the specializations."""
    side = Side("port")
    side.clear()
    a, b = (side.engine(qwen2._served, decode_horizon=4) for _ in range(2))
    c = tengine.ContinuousEngine(*qwen2._served()[1::2], side.plan(
        decode_horizon=4), device="cpu", exec_group=1)
    for eng in (a, c):
        for rid, p in enumerate(_prompts(19, (5, 9))):
            eng.submit(side.request(rid, p, 3))
        eng.run()
    probes = [EngineWorker(w, eng).compile_probe()
              for w, eng in enumerate((a, b, c))]
    assert probes[0] == probes[1] == (id(a.group), a.compile_count())
    assert probes[2] == (id(c.group), c.compile_count())
    assert probes[0][0] != probes[2][0]
    # admit_packed at bucket 16 and the horizon at K 4, in each group
    assert a.compile_count() == c.compile_count() == 2
    assert a.graph_count() == b.graph_count() == c.graph_count() == 0
    # a regroup moves the count to the new group's, graphs stay
    assert b.regroup(exec_group=1)
    assert b.compile_count() == c.compile_count()
    assert b.graph_count() == 0
