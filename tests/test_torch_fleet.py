"""The port's engine fleet against the reference's, live: the golden-trace
scenarios of the fleet on qwen2-0.5b's smoke config at fp32 compute
(CPU; greedy tokens exact), served through ``connect(...,
n_workers=4)`` on both packages with the same weights and requests.

The workload is the golden suite's: the first burst of
``canonical_bursty_trace()`` (24 simultaneous requests), prompts drawn
from ``default_rng(rid)``, 4 slots a worker, max_len 64.  Here, for
K in {1, 8} x {diag1, diag4} and paged p4 at 4 workers, every token
equals the reference's and so does every field of the ``FleetReport``:
completions with their worker and ``t_done_ns``, latencies, tok/s,
p50/p99, occupancy, lock wait, peak depths, endpoint usage, page
telemetry.  The metrics registry's export is equal too, the compile
series ``exec.jit_compiles`` and ``engine.jit_compiles`` included: both
packages count the jit specializations of each exec group, and every
client starts from cleared caches (``clear_caches``).  The other
scenarios (roles, faults, migrations, streams, adaptive, recurrentgemma)
are in ``test_torch_fleet_*.py`` and use the helpers here.
"""

import dataclasses
import functools
import json

import jax
import numpy as np
import pytest

from repro import serve as jserve
from repro.core.plan import SharingVector as JVector
from repro.serve import engine as j_engine
from repro.serve.fabric import canonical_bursty_trace, canonical_faulted_trace
from repro.serve.recovery import RecoveryPolicy as JPolicy
from repro_torch import serve as tserve
from repro_torch.core.plan import SharingVector as TVector
from repro_torch.serve import engine as t_engine
from repro_torch.serve.recovery import RecoveryPolicy as TPolicy
from tests import test_torch_engine as qwen2
from tests import test_torch_recurrent_engine as rgemma
from tests.test_torch_fabric import report_dict

MAX_LEN, N_SLOTS, N_WORKERS = 64, 4, 4
#: the served models' (JAX cfg, port cfg, JAX params, port params), fp32
SERVED = {"qwen2-0.5b": qwen2._served,
          "recurrentgemma-2b": rgemma._served}


@functools.lru_cache(maxsize=None)
def trace(name: str = "bursty") -> tuple:
    """The first burst of the canonical bursty (or faulted) trace."""
    full = {"bursty": canonical_bursty_trace,
            "faulted": canonical_faulted_trace}[name]()
    out = tuple(full[:24])
    assert all(a.prompt_len + a.max_new_tokens < MAX_LEN for a in out)
    return out


def prompt_of(vocab: int, arrival) -> np.ndarray:
    """The golden suite's prompt of an arrival, keyed by its rid."""
    rng = np.random.default_rng(arrival.rid)
    return rng.integers(1, vocab, size=arrival.prompt_len).astype(np.int32)


def clear_caches(side: str) -> None:
    """Forget the side's exec groups and their specializations, so that a
    client's compile counts start from 0 whatever ran before it in the
    process: jax's caches and the reference's shared steps, or the
    port's exec groups."""
    if side == "repro":
        jax.clear_caches()
        j_engine._shared_steps_cached.cache_clear()
    else:
        t_engine.clear_exec_groups()


def connect(side: str, arch: str, levels: tuple, **kw):
    """A client of either package on the served weights, from cleared
    caches; ``levels`` is the sharing vector (slots, channels, execs,
    pages), ``recovery`` the ``RecoveryPolicy`` fields as (name, value)
    pairs."""
    jcfg, tcfg, jparams, tparams = SERVED[arch]()
    clear_caches(side)
    kw = dict(kw)
    if "recovery" in kw:
        kw["recovery"] = (JPolicy if side == "repro" else TPolicy)(
            **dict(kw["recovery"]))
    if side == "repro":
        return jserve.connect(jcfg, JVector(*levels), params=jparams, **kw)
    return tserve.connect(tcfg, TVector(*levels), params=tparams,
                          device="cpu", **kw)


def submit(client, arch: str, trace_name: str = "bursty") -> None:
    vocab = SERVED[arch]()[0].vocab
    for a in trace(trace_name):
        client.submit(prompt_of(vocab, a), max_new_tokens=a.max_new_tokens,
                      at_ns=a.t_ns, session=a.session)


def serve(side: str, levels: tuple, k: int, *, arch: str = "qwen2-0.5b",
          trace_name: str = "bursty", n_workers: int = N_WORKERS, **kw):
    """One run of the trace on a fresh fleet; -> ({rid: tokens}, client)."""
    client = connect(side, arch, levels, n_workers=n_workers,
                     n_slots=N_SLOTS, max_len=MAX_LEN, decode_horizon=k,
                     **kw)
    submit(client, arch, trace_name)
    out = client.run()
    return {rid: list(map(int, t)) for rid, t in out.items()}, client


@functools.lru_cache(maxsize=None)
def reference(levels: tuple, k: int, **kw):
    """``serve`` on the reference, cached per module (``kw`` must be
    hashable).  The run started from cleared caches and its report holds
    the counts read during it, so a cached run's counts are a fresh
    run's."""
    return serve("repro", levels, k, **kw)


def metrics_json(rep, skip=()) -> dict:
    data = rep.metrics.to_json()
    data["metrics"] = {n: rows for n, rows in data["metrics"].items()
                       if n not in skip}
    return json.loads(json.dumps(data, sort_keys=True))


def assert_reports_equal(got, expect, skip=(), skip_series=()) -> None:
    """Every field of two ``FleetReport``s equal but ``skip``; the
    metrics export equal but for ``skip_series``."""
    a, b = report_dict(got), report_dict(expect)
    for field in b:
        if field != "metrics" and field not in skip:
            assert a[field] == b[field], field
    assert metrics_json(got, skip_series) == metrics_json(expect,
                                                          skip_series)


DIAG1, DIAG4 = (1, 1, 1, 1), (4, 4, 4, 1)
PAGED_P4 = (1, 1, 4, 4)


@pytest.mark.parametrize("levels", [DIAG1, DIAG4], ids=["diag1", "diag4"])
@pytest.mark.parametrize("k", [1, 8])
def test_fleet_matches_reference(k, levels):
    expect, j_client = reference(levels, k)
    got, t_client = serve("port", levels, k)
    assert got == expect
    assert len(got) == 24 and all(got.values())
    assert t_client.executor == "fleet" == j_client.executor
    assert_reports_equal(t_client.report, j_client.report)
    assert t_client.report.metrics.total("exec.jit_compiles") == \
        j_client.report.metrics.total("exec.jit_compiles") > 0
    assert [w.engine.exec_group for w in t_client.workers] == \
        [w.engine.exec_group for w in j_client.workers]
    for tw, jw in zip(t_client.workers, j_client.workers):
        assert tw.stats == jw.stats
        for key in ("decode_steps", "decode_calls", "prefills",
                    "prefilled_requests", "slot_steps", "busy_slot_steps",
                    "host_syncs"):
            assert tw.engine.stats[key] == jw.engine.stats[key], key


def test_paged_fleet_matches_reference():
    expect, j_client = reference(PAGED_P4, 8, page_size=16)
    got, t_client = serve("port", PAGED_P4, 8, page_size=16)
    assert got == expect
    assert t_client.plan.paged
    assert all(w.engine.page_pool.level == 4 for w in t_client.workers)
    assert_reports_equal(t_client.report, j_client.report)
    assert t_client.report.page_hwm_frac is not None


def test_fleet_weights_are_one_copy():
    """Every engine of a fleet serves from the client's one prepared copy
    of the weights: the same tensors, leaf by leaf."""
    from repro_torch.models.params import tree_leaves
    _, t_client = serve("port", DIAG1, 8)
    first = tree_leaves(t_client.workers[0].engine.params)
    assert first
    for w in t_client.workers[1:]:
        leaves = tree_leaves(w.engine.params)
        assert len(leaves) == len(first)
        assert all(a is b for a, b in zip(leaves, first))


def test_second_run_reuses_the_workers():
    """The engines persist across a client's runs, as in the reference:
    a second run of the same trace (new rids) serves the same tokens on
    the same workers."""
    got, client = serve("port", DIAG4, 8)
    workers = list(client.workers)
    submit(client, "qwen2-0.5b")
    again = client.run()
    assert client.workers == workers
    assert [again[r + 24] for r in sorted(got)] == \
        [got[r] for r in sorted(got)]
