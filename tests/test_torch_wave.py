"""The port's wave ``ServeEngine`` and the ``wave`` executor of
``connect`` against the JAX reference's, live, on the same weights and
requests (CPU, fp32 compute: greedy tokens exact between the two).

The counterparts of ``tests/test_serve_engine.py`` (batched = solo, mixed
prompt lengths grouped into waves, EOS, the max_len budget, determinism)
and of the wave half of ``tests/test_serve_api.py`` (the wave executor,
its stream refusal, the cache-edge truncation of a prompt of max_len)
and ``tests/test_serve_continuous.py`` (wave = continuous at three
sharing levels), on qwen2-0.5b's and recurrentgemma-2b's smoke configs.
Each case holds the port's tokens equal to a live ``repro`` run's.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro import serve as jserve
from repro.core.endpoints import Category as JCategory
from repro.serve.engine import ContinuousEngine as JContinuous
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JWave
from repro_torch import serve as tserve
from repro_torch.core.plan import EndpointPlan as TPlan
from repro_torch.core.plan import SharingVector as TVector
from repro_torch.serve.engine import ContinuousEngine as TContinuous
from repro_torch.serve.engine import Request as TRequest
from repro_torch.serve.engine import ServeEngine as TWave
from tests import test_torch_engine as qwen2
from tests import test_torch_recurrent_engine as rgemma

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["qwen2-0.5b", "recurrentgemma-2b"]


def _served(arch):
    """(JAX cfg, port cfg, JAX params, port params) at fp32 compute."""
    return (qwen2 if arch == "qwen2-0.5b" else rgemma)._served()


def _engines(arch, n_slots, max_len):
    """(reference wave engine, port wave engine) on the same weights."""
    jcfg, tcfg, jparams, tparams = _served(arch)
    plan = TPlan(vector=TVector(slots=4), n_slots=n_slots, max_len=max_len,
                 executor="wave")
    return (JWave(jcfg, jparams, n_slots=n_slots, max_len=max_len),
            TWave(tcfg, tparams, plan, device="cpu"))


def _serve(engines, specs):
    """Submit ``specs`` ((prompt, max_new, eos) by rid) to both engines,
    run both; -> their (rid, tokens) lists in completion order."""
    outs = []
    for eng in engines:
        cls = TRequest if isinstance(eng, TWave) else JRequest
        for rid, (prompt, max_new, eos) in enumerate(specs):
            eng.submit(cls(rid=rid, prompt=prompt, max_new_tokens=max_new,
                           eos_id=eos))
        outs.append([(r.rid, list(r.output)) for r in eng.run()])
    return outs


def _prompt(n, start=1):
    return np.arange(start, start + n, dtype=np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_batched_equals_solo(arch):
    specs = [(_prompt(8), 6, None)] * 4
    expect, got = _serve(_engines(arch, 4, 64), specs)
    assert got == expect
    _, solo = _serve(_engines(arch, 1, 64), specs[:1])
    assert all(out == solo[0][1] for _, out in got)


@pytest.mark.parametrize("arch", ARCHS)
def test_mixed_lengths_grouped_into_waves(arch):
    """Three prompts of 8 tokens and two of 20 make two waves, the
    larger group first; completion order and tokens equal the
    reference's."""
    specs = ([(_prompt(8, 1 + i), 4, None) for i in range(3)]
             + [(_prompt(20, 3 + i), 4, None) for i in range(2)])
    expect, got = _serve(_engines(arch, 4, 64), specs)
    assert got == expect
    assert [rid for rid, _ in got] == [0, 1, 2, 3, 4]
    assert all(len(out) == 4 for _, out in got)


@pytest.mark.parametrize("arch", ARCHS)
def test_eos_stops_early(arch):
    _, full = _serve(_engines(arch, 1, 64), [(_prompt(8), 8, None)])
    eos = full[0][1][3]             # EOS at the 4th generated token
    expect, got = _serve(_engines(arch, 1, 64), [(_prompt(8), 8, eos)])
    assert got == expect
    out = got[0][1]
    assert len(out) < len(full[0][1]) and out == full[0][1][:len(out)]


@pytest.mark.parametrize("arch", ARCHS)
def test_max_len_budget_truncates_at_the_cache_edge(arch):
    """A budget past the cache stops at max_len - plen - 1 steps, the
    lookahead token appended; a prompt of max_len decodes nothing and
    returns its one lookahead token."""
    specs = [(_prompt(8), 100, None), (_prompt(9, 2), 3, None)]
    expect, got = _serve(_engines(arch, 2, 16), specs)
    assert got == expect
    assert len(got[0][1]) <= 16 - 8
    expect, got = _serve(_engines(arch, 1, 16), [(_prompt(16), 8, None)])
    assert got == expect and len(got[0][1]) == 1


def test_greedy_deterministic():
    outs = [_serve(_engines("qwen2-0.5b", 2, 64),
                   [(_prompt(8), 5, None)])[1] for _ in range(2)]
    assert outs[0] == outs[1]


@pytest.mark.parametrize("level", [JCategory.MPI_EVERYWHERE.level,
                                   JCategory.SHARED_DYNAMIC.level,
                                   JCategory.MPI_THREADS.level])
def test_wave_and_continuous_equivalent(level):
    """The same requests serve the same tokens under wave scheduling and
    under continuous batching at every slot sharing level, in the port
    and in the reference."""
    jcfg, tcfg, jparams, tparams = _served("qwen2-0.5b")
    specs = [(_prompt(ln, 1 + i), new, None) for i, (ln, new) in enumerate(
        [(8, 5), (16, 4), (8, 7), (12, 3), (16, 6), (8, 4)])]
    expect, got = _serve(_engines("qwen2-0.5b", 2, 64), specs)
    assert got == expect
    plan = TPlan(vector=TVector(slots=level), n_slots=2, max_len=64,
                 executor="continuous")
    engines = (JContinuous(jcfg, jparams, n_slots=2, max_len=64,
                           slot_level=level),
               TContinuous(tcfg, tparams, plan, device="cpu"))
    for eng, cls in zip(engines, (JRequest, TRequest)):
        for rid, (prompt, max_new, eos) in enumerate(specs):
            eng.submit(cls(rid=rid, prompt=prompt, max_new_tokens=max_new))
    j_done, t_done = ({r.rid: list(r.output) for r in eng.run()}
                      for eng in engines)
    assert t_done == j_done == dict(got)


@pytest.mark.parametrize("arch", ARCHS)
def test_wave_executor_matches_reference(arch):
    """``connect(executor="wave")``: the same tokens as ``repro``'s wave
    client, a prompt of max_len let through (cut at the cache edge) and
    ordered streams refused."""
    jcfg, tcfg, jparams, tparams = _served(arch)
    clients = (jserve.connect(jcfg, None, params=jparams, executor="wave",
                              n_slots=2, max_len=32),
               tserve.connect(tcfg, None, params=tparams, executor="wave",
                              n_slots=2, max_len=32, device="cpu"))
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, 100, size=n).astype(np.int32)
               for n in (5, 12, 5, 32, 12)]
    outs = []
    for client in clients:
        rids = [client.submit(p, max_new_tokens=4) for p in prompts]
        out = client.run()
        outs.append([out[r] for r in rids])
        with pytest.raises(ValueError):
            client.stream()
    assert outs[1] == outs[0]
    assert len(outs[1][3]) == 1           # the 32-token prompt
    assert clients[1].executor == "wave"
    assert isinstance(clients[1].engine, TWave)


def test_launcher_serves_through_the_wave_engine():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", "--engine", "wave", "--max-len", "64",
         "--requests", "4", "--prompt-len", "8", "--max-new", "4",
         "--mixed-lengths"],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "executor=wave" in res.stdout
    assert "served 4 requests" in res.stdout
