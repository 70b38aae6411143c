"""The fused horizon's static buffers, on the CPU.

On the card ``ContinuousEngine`` replays each fused horizon as a captured
CUDA graph (``serve.engine.HorizonGraphs``), which reads and writes fixed
addresses.  On the CPU the same body runs uncaptured on the same static
buffers.  These tests drive the engine through ``start``, admission
rounds, horizons, retirements and re-admissions on the qwen2-0.5b and
recurrentgemma-2b smoke configs, contiguous and paged (recurrentgemma
keeps its contiguous rolling cache under a paged plan), at K in {2, 4},
and hold it to what capture depends on and to the reference:

* every cache leaf, ``idx``, ``pt``, each device-state tensor and each
  leaf of the static trace keeps its ``data_ptr()`` throughout;
* the tokens, admission order, admission steps and retirement steps equal
  a live ``repro`` run at fp32 (the ``_reference`` helpers of
  ``test_torch_engine.py`` and ``test_torch_recurrent_engine.py``);
* ``graph_count()`` is 0 (nothing is captured on the CPU) and the
  kernels' launch counters are untouched.

The engine's other writers are held to the same addresses: KV handoff
admission, a live ``regroup``, ``export_session`` and ``evacuate``, after
which the engine serves the reference's tokens again.  So are the fleet
router's writers (``EngineWorker.admit``, crash retries that re-prefill
prompt + emitted prefix, KV handoff landings, ``kill`` -> ``evacuate``,
``export_sessions`` for a scheduled migration, ``regroup`` from the
adaptive controller), checked on every engine of a 4-worker fleet after
each call, co-located and 2P+2D.

Graph capture and replay themselves run on the card only
(``test_torch_gpu.py``, ``chip_smoke.py``).
"""

import pytest

from repro_torch.core.plan import EndpointPlan as TPlan
from repro_torch.core.plan import SharingVector as TVector
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rglru import ops as rglru_ops
from repro_torch.models.params import tree_leaves
from repro_torch.serve.engine import ContinuousEngine as TEngine
from repro_torch.serve.engine import Request as TRequest
from repro_torch.serve.fabric import EngineWorker
from tests import test_torch_engine as qwen2
from tests import test_torch_fleet as fleet
from tests import test_torch_recurrent_engine as rgemma


def _addresses(eng):
    """{buffer name: data_ptr()} of every static buffer the horizon body
    reads or writes."""
    cache = eng._cache
    out = {f"stack[{i}]": t.data_ptr()
           for i, t in enumerate(tree_leaves(cache["stack"]))}
    out["idx"] = cache["idx"].data_ptr()
    if "pt" in cache:
        out["pt"] = cache["pt"].data_ptr()
    out.update({f"state.{k}": t.data_ptr()
                for k, t in eng._dev_state.items()})
    out.update({f"trace.{k}": t.data_ptr()
                for k, t in eng._horizons.trace.items()})
    return out


def _reference(arch, horizon, pages):
    if arch == "qwen2-0.5b":
        return qwen2._reference(horizon, pages)
    return rgemma._reference(horizon)


def _engine(arch, horizon, pages):
    if arch == "qwen2-0.5b":
        _, tcfg, _, tparams = qwen2._served()
        return TEngine(tcfg, tparams, device="cpu",
                       plan=qwen2._plan(TPlan, TVector, horizon, pages)), \
            qwen2._specs()
    _, tcfg, _, tparams = rgemma._served()
    return TEngine(tcfg, tparams, device="cpu",
                   plan=rgemma._plan(TPlan, TVector, horizon, pages)), \
        rgemma._specs()


@pytest.mark.parametrize("pages", [False, True], ids=["contiguous", "pages4"])
@pytest.mark.parametrize("horizon", [2, 4])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "recurrentgemma-2b"])
def test_horizon_body_keeps_its_buffers_and_serves_the_reference(
        arch, horizon, pages):
    eng, specs = _engine(arch, horizon, pages)
    for rid, (prompt, max_new, eos) in enumerate(specs):
        eng.submit(TRequest(rid=rid, prompt=prompt, max_new_tokens=max_new,
                            eos_id=eos))
    launches = (dict(fa_ops.LAUNCHES), dict(rglru_ops.LAUNCHES))
    eng.start()
    fixed = _addresses(eng)
    retired = 0
    while eng.has_work:                 # ContinuousEngine.run's loop
        eng.admit_waiting()
        assert _addresses(eng) == fixed, "admission moved a buffer"
        done = eng.step()
        retired += len(done)
        assert _addresses(eng) == fixed, "a horizon moved a buffer"
        if not done and eng.n_active == 0:
            break
    assert eng.paged == (pages and arch == "qwen2-0.5b")
    assert retired == len(specs)
    assert len(eng.admit_order) > eng.n_slots     # slots were re-admitted
    got = ({r.rid: list(r.output) for r in eng.done}, eng.admit_order,
           eng.admit_steps, eng.retire_steps)
    expect, jstats = _reference(arch, horizon, pages)
    assert got[0] == expect[0]                       # tokens
    assert got[1] == expect[1]                       # admission order
    assert got[2] == expect[2]                       # admission steps
    assert got[3] == expect[3]                       # retirement steps
    for key in ("decode_steps", "decode_calls", "slot_steps",
                "busy_slot_steps"):
        assert eng.stats[key] == jstats[key], key
    assert eng.graph_count() == 0
    assert (fa_ops.LAUNCHES, rglru_ops.LAUNCHES) == launches


@pytest.mark.parametrize("pages", [False, True], ids=["contiguous", "pages4"])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "recurrentgemma-2b"])
def test_handoff_export_evacuate_and_regroup_keep_the_buffers(arch, pages):
    """The engine's other writers keep every static buffer where it is:
    KV handoffs (half the requests arrive as ``prefill_only`` payloads
    from a second engine), a live regroup of slots, pages and exec
    group, ``export_session`` of a live slot and ``evacuate``.  The same
    engine then serves every request afresh with the tokens of a live
    ``repro`` run; nothing is captured on the CPU."""
    eng, specs = _engine(arch, 4, pages)
    prefill, _ = _engine(arch, 4, pages)
    requests = [TRequest(rid=rid, prompt=prompt, max_new_tokens=max_new,
                         eos_id=eos)
                for rid, (prompt, max_new, eos) in enumerate(specs)]
    for req in requests[: len(requests) // 2]:
        req.kv = prefill.prefill_only(req)
    for req in requests:
        eng.submit(req)
    eng.start()
    fixed = _addresses(eng)

    def admit_and_step():
        eng.admit_waiting()
        assert _addresses(eng) == fixed, "admission moved a buffer"
        eng.step()
        assert _addresses(eng) == fixed, "a horizon moved a buffer"

    admit_and_step()
    assert eng.regroup(slot_level=2, exec_group=1,
                       page_level=2 if eng.paged else None)
    assert _addresses(eng) == fixed, "regroup moved a buffer"
    admit_and_step()
    while not (eng.n_active and eng.queue):
        admit_and_step()
    slot = next(s for s, r in enumerate(eng._slot_req) if r is not None)
    handoff = eng.export_session(slot)
    assert _addresses(eng) == fixed, "export_session moved a buffer"
    assert handoff.cache["idx"].dim() == 0
    assert bool(eng._dev_state["finished"][slot])
    live, queued = eng.evacuate()
    assert _addresses(eng) == fixed, "evacuate moved a buffer"
    assert queued and eng.n_active == 0
    assert bool(eng._dev_state["finished"].all())
    if eng.paged:
        assert eng.page_pool.live_pages == 0
        assert (eng._cache["pt"] == eng.page_pool.total_pages).all()
    n_done = len(eng.done)
    for rid, (prompt, max_new, eos) in enumerate(specs):
        eng.submit(TRequest(rid=rid, prompt=prompt, max_new_tokens=max_new,
                            eos_id=eos))
    again = {r.rid: list(r.output) for r in eng.run()[n_done:]}
    assert _addresses(eng) == fixed
    assert again == _reference(arch, 4, pages)[0][0]
    assert eng.graph_count() == 0 and eng.stats["regroups"] == 1


#: the router's writers into an engine, as ``EngineWorker`` methods
_FLEET_WRITERS = ("admit", "admit_retry", "admit_prefill",
                  "admit_retry_prefill", "admit_handoff", "export_sessions",
                  "kill", "regroup", "step")

#: co-located: worker 0 dies holding live sessions (they re-prefill
#: prompt + prefix on a survivor) and worker 1's sessions migrate to
#: worker 3; adaptive: the controller regroups every engine; 2P+2D:
#: decode worker 2 dies, its sessions re-prefill on a prefill worker and
#: land again as KV handoffs.  (Faults and the adaptive controller are
#: not combined: the reference's event loop does not end with both, its
#: probe and window chains re-arming each other.)
_FLEET_RUNS = {
    "colocated": dict(faults="crash@0.6ms:w0",
                      recovery=(("deadline_ns", 600_000.0),),
                      migrations=((150_000.0, 1, 3),)),
    "adaptive": dict(adaptive=True, adapt_window_ns=100_000.0),
    "2P+2D": dict(roles="2P+2D", faults="crash@0.7ms:w2",
                  recovery=(("deadline_ns", 600_000.0),)),
}


@pytest.mark.parametrize("run", sorted(_FLEET_RUNS))
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "recurrentgemma-2b"])
def test_fleet_writers_keep_every_engines_buffers(arch, run, monkeypatch):
    """A fleet of 4 engines at K 4 on the first burst of the canonical
    trace: after every call the router makes into an engine, every
    engine's static buffers sit where they were at ``start()``; the
    tokens equal the reference's fault-free co-located fleet."""
    fixed = {}
    calls = {}

    def checked(name):
        method = getattr(EngineWorker, name)

        def call(self, *args, **kw):
            if not fixed:
                for w in self_fleet:
                    fixed[w.wid] = _addresses(w.engine)
            result = method(self, *args, **kw)
            calls[name] = calls.get(name, 0) + 1
            for w in self_fleet:
                assert _addresses(w.engine) == fixed[w.wid], \
                    f"{name} on worker {self.wid} moved worker {w.wid}'s"
            return result
        return call

    self_fleet = []
    build = fleet.tserve.ServeClient._build_workers

    def build_and_keep(client):
        build(client)
        self_fleet.extend(client.workers)

    monkeypatch.setattr(fleet.tserve.ServeClient, "_build_workers",
                        build_and_keep)
    for name in _FLEET_WRITERS:
        monkeypatch.setattr(EngineWorker, name, checked(name))
    got, client = fleet.serve("port", (2, 2, 2, 1), 4, arch=arch,
                              **_FLEET_RUNS[run])
    expect, _ = fleet.reference((2, 2, 2, 1), 4, arch=arch)
    assert got == expect
    rep = client.report
    if run == "adaptive":
        assert rep.transitions and calls.get("regroup", 0) > 0
    else:
        assert rep.detections == 1 and rep.recovered and not rep.failed
        assert calls.get("kill") == 1
    if run == "colocated":
        assert rep.migrations == 1 and calls.get("export_sessions") == 1
        assert calls.get("admit_retry", 0) > 0
        assert calls.get("admit_handoff", 0) > 0
    if run == "2P+2D":
        assert calls.get("admit_handoff", 0) > 24
        assert calls.get("admit_retry_prefill", 0) > 0
    assert all(w.engine.graph_count() == 0 for w in self_fleet)
