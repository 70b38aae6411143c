"""The reference's legacy serving surface in the port, held against live
``repro``: the launcher's plan resolution (the single engine's wave
default, ``--category``, ``--engine``, ``--ragged-kernel``, the wave
engine's refusals), the engines' keyword constructors, the deprecation
shims of ``tests/test_deprecations.py``, ``SlotPool.endpoint_usage`` and
the kernel packages' exports.

Each case builds the reference's object and the port's in the same
test.  The launcher cases run each package's ``main`` with its
``build_plan`` captured through ``monkeypatch`` (nothing in ``repro``
changes): the two plans must be equal by ``dataclasses.asdict``, or both
launchers must refuse with the same words, and the two runs must raise
as many ``DeprecationWarning``s.
"""

import argparse
import dataclasses
import functools
import itertools
import os
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.launch.serve as j_launch
import repro_torch.launch.serve as t_launch
from repro.configs import get_smoke_config as j_smoke_config
from repro.core.endpoints import Category as JCategory
from repro.core.plan import EndpointPlan as JPlan
from repro.core.plan import SharingVector as JVector
from repro.kernels import flash_attention as j_flash
from repro.kernels import rglru as j_rglru
from repro.models.model import Model as JModel
from repro.serve.engine import ContinuousEngine as JContinuous
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JWave
from repro.serve.fabric.router import SimWorker as JSimWorker
from repro.serve.slots import SlotPool as JSlotPool
from repro_torch.configs import get_smoke_config as t_smoke_config
from repro_torch.core.endpoints import Category as TCategory
from repro_torch.core.plan import EndpointPlan as TPlan
from repro_torch.core.plan import SharingVector as TVector
from repro_torch.models import Model as TModel
from repro_torch.serve.engine import ContinuousEngine as TContinuous
from repro_torch.serve.engine import Request as TRequest
from repro_torch.serve.engine import ServeEngine as TWave
from repro_torch.serve.engine import shared_exec_group
from repro_torch.serve.fabric.router import SimWorker as TSimWorker
from repro_torch.serve.slots import SlotPool as TSlotPool
from tests import test_torch_engine as qwen2

ROOT = Path(__file__).resolve().parents[1]


# ----- the launcher's plan resolution --------------------------------------

class _Refused(Exception):
    pass


class _Resolved(Exception):
    pass


def _error(self, message):
    raise _Refused(message)


def _resolve(module, argv, monkeypatch):
    """Run ``module.main(argv)`` up to its ``build_plan``: -> (the plan as
    a dict, or the refusal's words, and the DeprecationWarnings raised)."""
    real = module.build_plan
    got = {}

    def capture(args, ap):
        got["plan"] = real(args, ap)
        raise _Resolved

    monkeypatch.setattr(module, "build_plan", capture)
    monkeypatch.setattr(argparse.ArgumentParser, "error", _error)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        try:
            module.main(argv)
        except _Resolved:
            out = ("plan", dataclasses.asdict(got["plan"]))
        except _Refused as e:
            out = ("refused", str(e))
    monkeypatch.undo()
    return out, sum(issubclass(w.category, DeprecationWarning) for w in rec)


#: the grid: --category x --workers x --engine x one more flag (the
#: legacy spellings, and the flags that pick or refuse an executor)
CATEGORIES = [None, "static", "mpi_threads"]
WORKERS = [1, 4]
ENGINES = [None, "wave", "continuous"]
EXTRAS = {"none": [], "pages4": ["--pages", "4"], "adaptive": ["--adaptive"],
          "horizon4": ["--decode-horizon", "4"],
          "plan": ["--plan", "dynamic"],
          "hint": ["--hint", "burstiness=0.9"],
          "ragged": ["--ragged-kernel"],
          "buckets": ["--prefill-buckets", "8,16"]}
GRID = list(itertools.product(CATEGORIES, WORKERS, ENGINES, EXTRAS))


def _argv(category, workers, engine, extra):
    argv = ["--smoke", "--workers", str(workers)] + EXTRAS[extra]
    if category is not None:
        argv += ["--category", category]
    if engine is not None:
        argv += ["--engine", engine]
    return argv


@pytest.mark.parametrize(
    "category,workers,engine,extra", GRID,
    ids=[f"{c}-w{w}-{e}-{x}" for c, w, e, x in GRID])
def test_launcher_resolves_the_reference_plan(category, workers, engine,
                                              extra, monkeypatch):
    argv = _argv(category, workers, engine, extra)
    expect = _resolve(j_launch, argv, monkeypatch)
    got = _resolve(t_launch, argv + ["--device", "cpu"], monkeypatch)
    assert got == expect


def test_launcher_bare_single_engine_is_the_wave_plan(monkeypatch):
    (kind, plan), deps = _resolve(t_launch, ["--device", "cpu"],
                                  monkeypatch)
    assert kind == "plan" and deps == 0
    assert plan == dataclasses.asdict(TPlan.from_category(
        TCategory.MPI_EVERYWHERE, executor="wave", n_slots=4, max_len=256,
        decode_horizon=1, prefill_buckets="auto"))


def test_launcher_bare_fleet_shares_one_exec_group(monkeypatch):
    (kind, plan), deps = _resolve(t_launch, ["--workers", "4"], monkeypatch)
    assert kind == "plan" and deps == 0
    plan = TPlan(**dict(plan, vector=TVector(**plan["vector"])))
    assert plan.vector == TVector(slots=1, channels=1, execs=4)
    assert plan.resolved_executor == "fleet"
    assert {plan.exec_group_of(w) for w in range(4)} == {0}


def test_launcher_ragged_kernel_lands_in_the_plan(monkeypatch):
    for argv, ragged in ((["--engine", "continuous"], False),
                         (["--engine", "continuous", "--ragged-kernel"],
                          True)):
        (kind, plan), _ = _resolve(t_launch, argv, monkeypatch)
        assert kind == "plan" and plan["use_ragged_kernel"] is ragged


def test_bare_launcher_serves_through_the_wave_engine():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "served 8 requests, 96 tokens" in res.stdout
    assert "executor=wave" in res.stdout
    assert "DeprecationWarning" not in res.stderr


# ----- the deprecation shims and the keyword constructors ------------------

def _legacy_args(**overrides):
    """``tests/test_deprecations.py``'s hand-built Namespace, with every
    field of the launcher's parser that ``build_plan`` reads."""
    ns = argparse.Namespace(
        plan=None, hint=[], engine=None, category=None, workers=1,
        slots=4, max_len=128, decode_horizon=1, prefill_buckets="auto",
        ragged_kernel=False, placement=None, adaptive=False,
        adapt_window=250.0, roles=None, pages=1, page_size=0,
        page_budget=None)
    vars(ns).update(overrides)
    return ns


def _plain(value):
    """Dataclasses (plans, vectors) as dicts, through tuples, so that the
    two packages' objects compare."""
    if dataclasses.is_dataclass(value):
        return dataclasses.asdict(value)
    if isinstance(value, (tuple, list)):
        return type(value)(_plain(v) for v in value)
    return value


@functools.lru_cache(maxsize=None)
def _served(side):
    """(cfg, weights) of the qwen2-0.5b smoke config at fp32, each
    package's on the same numbers."""
    jcfg, tcfg, jparams, tparams = qwen2._served()
    return (jcfg, jparams) if side == "repro" else (tcfg, tparams)


def _engine_kw(side, **kw):
    if side == "port":
        kw["device"] = "cpu"
    return kw


def _pool_shim(side, Cat):
    Pool = JSlotPool if side == "repro" else TSlotPool
    old = Pool(category=Cat.STATIC, n_slots=8)
    new = Pool(Cat.STATIC.level, n_slots=8)
    return old, new, lambda p: (p.level, p.n_slots,
                                [list(g) for g in p.groups])


def _engine_shim(side, Cat):
    Engine = JContinuous if side == "repro" else TContinuous
    cfg, params = _served(side)
    old = Engine(cfg, params, **_engine_kw(
        side, n_slots=3, max_len=64, category=Cat.SHARED_DYNAMIC))
    new = Engine(cfg, params, **_engine_kw(
        side, n_slots=3, max_len=64, slot_level=Cat.SHARED_DYNAMIC.level))
    return old, new, lambda e: (e.plan.vector, e.pool.level,
                                e.pool.n_slots, e.n_slots, e.max_len)


def _engine_positional_category_shim(side, Cat):
    Engine = JContinuous if side == "repro" else TContinuous
    cfg, params = _served(side)
    old = Engine(cfg, params, **_engine_kw(
        side, n_slots=2, max_len=64, slot_level=Cat.STATIC))
    new = Engine(cfg, params, **_engine_kw(
        side, n_slots=2, max_len=64, slot_level=Cat.STATIC.level))
    return old, new, lambda e: (e.plan.vector, e.pool.level,
                                e.pool.n_slots, e.n_slots, e.max_len)


def _sim_worker_shim(side, Cat):
    Worker = JSimWorker if side == "repro" else TSimWorker
    old = Worker(0, n_slots=4, slot_category=Cat.MPI_THREADS)
    new = Worker(0, n_slots=4, slot_level=Cat.MPI_THREADS.level)
    return old, new, lambda w: (w.pool.level, w.pool.n_slots)


def _launch_category_shim(side, Cat):
    launch = j_launch if side == "repro" else t_launch
    ap = argparse.ArgumentParser()
    old = launch.build_plan(_legacy_args(category="shared_dynamic",
                                         workers=4, engine="continuous"), ap)
    new = launch.build_plan(_legacy_args(plan="shared_dynamic", workers=4),
                            ap)
    return old, new, lambda p: p


SHIMS = {
    "SlotPool(category=)": _pool_shim,
    "ContinuousEngine(category=)": _engine_shim,
    "ContinuousEngine(slot_level=Category)":
        _engine_positional_category_shim,
    "SimWorker(slot_category=)": _sim_worker_shim,
    "launch --category": _launch_category_shim,
}


def _deprecations(fn, *args):
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = fn(*args)
    return out, [str(w.message) for w in rec
                 if issubclass(w.category, DeprecationWarning)]


@pytest.mark.parametrize("name", sorted(SHIMS))
def test_shim_warns_once_and_translates_as_the_reference(name):
    (j_old, j_new, j_extract), j_deps = _deprecations(
        SHIMS[name], "repro", JCategory)
    (t_old, t_new, t_extract), t_deps = _deprecations(
        SHIMS[name], "port", TCategory)
    assert len(t_deps) == 1 and t_deps == j_deps
    assert _plain(t_extract(t_old)) == _plain(t_extract(t_new))
    assert _plain(t_extract(t_old)) == _plain(j_extract(j_old))


def test_new_spellings_never_warn():
    def build():
        TSlotPool(3, n_slots=8)
        cfg, params = _served("port")
        TContinuous(cfg, params, n_slots=3, max_len=64, slot_level=2,
                    device="cpu")
        TContinuous(cfg, params, TPlan(vector=TVector(slots=2), n_slots=3,
                                       max_len=64), device="cpu")
        TWave(cfg, params, n_slots=2, max_len=64, device="cpu")
        TSimWorker(0, n_slots=4, slot_level=4)
        t_launch.build_plan(_legacy_args(plan="shared_dynamic", workers=4),
                            argparse.ArgumentParser())
        t_launch.build_plan(_legacy_args(), argparse.ArgumentParser())
        t_launch.build_plan(_legacy_args(workers=4),
                            argparse.ArgumentParser())
    assert _deprecations(build)[1] == []


@pytest.mark.parametrize("kw", [
    dict(),
    dict(n_slots=2, max_len=32),
    dict(decode_horizon=4, prefill_buckets=None),
    dict(prefill_buckets=(8, 16), use_ragged_kernel=True, slot_level=2),
    dict(n_slots=4, slot_level=4, decode_horizon=8)],
    ids=["defaults", "slots", "horizon", "buckets", "level4"])
def test_continuous_keywords_build_the_reference_plan(kw):
    j_cfg, j_params = _served("repro")
    t_cfg, t_params = _served("port")
    j = JContinuous(j_cfg, j_params, **kw)
    t = TContinuous(t_cfg, t_params, device="cpu", **kw)
    assert _plain(t.plan) == _plain(j.plan)
    assert (t.pool.level, t.pool.n_slots, t.n_slots, t.max_len,
            t.decode_horizon, t.use_ragged_kernel, t.prefill_buckets) == \
        (j.pool.level, j.pool.n_slots, j.n_slots, j.max_len,
         j.decode_horizon, j.use_ragged_kernel, j.prefill_buckets)


def test_continuous_plan_rules_its_knobs_and_slot_level_overrides():
    """With a plan, every knob it carries wins over the keywords, and
    ``slot_level`` (or a pool) re-keys only the slot pool, as in the
    reference."""
    j_cfg, j_params = _served("repro")
    t_cfg, t_params = _served("port")
    fields = dict(n_slots=3, max_len=48, decode_horizon=4,
                  prefill_buckets=None, executor="continuous")
    for extra in (dict(), dict(slot_level=4), dict(slot_level=2)):
        kw = dict(n_slots=8, max_len=512, decode_horizon=2, **extra)
        j = JContinuous(j_cfg, j_params, plan=JPlan(vector=JVector(slots=3),
                                                    **fields), **kw)
        t = TContinuous(t_cfg, t_params, TPlan(vector=TVector(slots=3),
                                               **fields), "cpu", **kw)
        assert _plain(t.plan) == _plain(j.plan)
        assert (t.pool.level, t.n_slots, t.max_len, t.decode_horizon,
                t.prefill_buckets) == (j.pool.level, j.n_slots, j.max_len,
                                       j.decode_horizon, j.prefill_buckets)
    pool = TSlotPool(2, 3)
    t = TContinuous(t_cfg, t_params, TPlan(vector=TVector(slots=3),
                                           **fields), "cpu", pool=pool)
    assert t.pool is pool


def test_ragged_flag_keys_only_cpu_exec_groups():
    """On the card decode attention runs its CUDA kernel whatever
    ``use_ragged_kernel`` says, so both values share one exec group (one
    set of captures and one graph pool); on the CPU the flag picks the
    decode path and keys its own group."""
    t_cfg, _ = _served("port")
    cpu, card = torch.device("cpu"), torch.device("cuda", 0)
    assert shared_exec_group(t_cfg, True, 0, card) is \
        shared_exec_group(t_cfg, False, 0, card)
    assert shared_exec_group(t_cfg, True, 0, cpu) is not \
        shared_exec_group(t_cfg, False, 0, cpu)


def test_continuous_keywords_refuse_what_the_reference_refuses():
    j_cfg, j_params = _served("repro")
    t_cfg, t_params = _served("port")
    with pytest.raises(ValueError) as j:
        JContinuous(j_cfg, j_params, decode_horizon=0)
    with pytest.raises(ValueError) as t:
        TContinuous(t_cfg, t_params, decode_horizon=0, device="cpu")
    assert str(t.value) == str(j.value)
    with pytest.raises(ValueError) as j:
        JContinuous(j_cfg, j_params, slot_level=5)
    with pytest.raises(ValueError) as t:
        TContinuous(t_cfg, t_params, slot_level=5, device="cpu")
    assert str(t.value) == str(j.value)
    with pytest.raises(ValueError):
        TContinuous(t_cfg, t_params, n_slots=4, pool=TSlotPool(1, 2),
                    device="cpu")


@pytest.mark.parametrize("kw", [dict(), dict(n_slots=2, max_len=64)],
                         ids=["defaults", "slots"])
def test_wave_keywords_build_the_reference_plan(kw):
    j_cfg, j_params = _served("repro")
    t_cfg, t_params = _served("port")
    j = JWave(j_cfg, j_params, **kw)
    t = TWave(t_cfg, t_params, device="cpu", **kw)
    assert _plain(t.plan) == _plain(j.plan)
    assert (t.n_slots, t.max_len) == (j.n_slots, j.max_len)
    new = TWave(t_cfg, t_params, TPlan(
        vector=TVector(slots=4), n_slots=t.n_slots, max_len=t.max_len,
        executor="wave"), device="cpu")
    assert new.plan == t.plan


def _serve(engine, Request):
    for rid, (prompt, max_new, eos) in enumerate(qwen2._specs()):
        engine.submit(Request(rid=rid, prompt=prompt,
                              max_new_tokens=max_new, eos_id=eos))
    return {r.rid: list(r.output) for r in engine.run()}


def test_legacy_continuous_engine_serves_the_reference_tokens():
    """``ContinuousEngine(..., category=SHARED_DYNAMIC, decode_horizon=4)``
    in both packages on the same fp32 weights and requests: the same
    tokens, admission order and steps; the port's legacy engine equals
    its plan-built engine too."""
    j_cfg, j_params = _served("repro")
    t_cfg, t_params = _served("port")
    kw = dict(n_slots=qwen2.N_SLOTS, max_len=qwen2.MAX_LEN,
              decode_horizon=4)
    with pytest.deprecated_call():
        j = JContinuous(j_cfg, j_params, category=JCategory.SHARED_DYNAMIC,
                        **kw)
    with pytest.deprecated_call():
        t = TContinuous(t_cfg, t_params, category=TCategory.SHARED_DYNAMIC,
                        device="cpu", **kw)
    expect, got = _serve(j, JRequest), _serve(t, TRequest)
    assert got == expect
    assert (t.admit_order, t.admit_steps, t.retire_steps) == \
        (j.admit_order, j.admit_steps, j.retire_steps)
    planned = TContinuous(t_cfg, t_params, t.plan, device="cpu")
    assert _serve(planned, TRequest) == got


def test_wave_keywords_serve_the_reference_tokens():
    j_cfg, j_params = _served("repro")
    t_cfg, t_params = _served("port")
    specs = [(np.arange(1 + i, 9 + i, dtype=np.int32), 5, None)
             for i in range(3)]
    outs = []
    for Engine, Request, kw, cfg, params in (
            (JWave, JRequest, {}, j_cfg, j_params),
            (TWave, TRequest, {"device": "cpu"}, t_cfg, t_params)):
        eng = Engine(cfg, params, n_slots=2, max_len=32, **kw)
        for rid, (prompt, max_new, eos) in enumerate(specs):
            eng.submit(Request(rid=rid, prompt=prompt,
                               max_new_tokens=max_new, eos_id=eos))
        outs.append([(r.rid, list(r.output)) for r in eng.run()])
    assert outs[1] == outs[0]


# ----- SlotPool.endpoint_usage and the kernel packages ---------------------

@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("category", [c.value for c in TCategory])
def test_endpoint_usage_equals_the_reference(category, n):
    level = TCategory(category).level
    got = TSlotPool(level, n).endpoint_usage()
    assert got == JSlotPool(level, n).endpoint_usage()
    assert set(got) >= {"uuars", "memory"}


def test_kernel_packages_export_the_reference_names():
    from repro_torch.kernels import flash_attention as t_flash
    from repro_torch.kernels import rglru as t_rglru
    from repro_torch.kernels.flash_attention import ops as t_flash_ops
    from repro_torch.kernels.rglru import ops as t_rglru_ops
    assert t_flash.__all__ == j_flash.__all__
    assert t_rglru.__all__ == j_rglru.__all__
    for name in t_flash.__all__:
        assert getattr(t_flash, name) is getattr(t_flash_ops, name)
    assert t_rglru.rglru_scan is t_rglru_ops.rglru_scan


def test_exported_kernels_equal_the_reference_on_the_cpu():
    """The exported names on CPU tensors (the kernels' plain versions)
    against the reference's exports (the Pallas kernels, interpreted)."""
    import torch
    from repro_torch.kernels import flash_attention as t_flash
    from repro_torch.kernels import rglru as t_rglru
    rng = np.random.default_rng(17)

    def pair(*shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return x, torch.from_numpy(x)

    (q, tq), (k, tk), (v, tv) = pair(2, 24, 4, 16), pair(2, 24, 2, 16), \
        pair(2, 24, 2, 16)
    np.testing.assert_allclose(
        t_flash.flash_attention(tq, tk, tv).numpy(),
        np.asarray(j_flash.flash_attention(q, k, v, q_block=8, kv_block=8)),
        rtol=0, atol=5e-5)
    cur = np.array([3, 23], np.int32)
    np.testing.assert_allclose(
        t_flash.flash_decode_attention(tq[:, :1], tk, tv,
                                       torch.from_numpy(cur)).numpy(),
        np.asarray(j_flash.flash_decode_attention(q[:, :1], k, v, cur,
                                                  kv_block=8)),
        rtol=0, atol=5e-5)
    a = rng.uniform(0.5, 1.0, (2, 40, 16)).astype(np.float32)
    (x, tx) = pair(2, 40, 16)
    np.testing.assert_allclose(
        t_rglru.rglru_scan(torch.from_numpy(a), tx).numpy(),
        np.asarray(j_rglru.rglru_scan(a, x, t_block=8, c_block=16)),
        rtol=0, atol=5e-5)


def test_importing_the_kernel_packages_builds_nothing():
    code = (
        "import repro_torch.kernels.build as build\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError('built at import')\n"
        "build.build = refuse\n"
        "from repro_torch.kernels.flash_attention import flash_attention, "
        "flash_decode_attention\n"
        "from repro_torch.kernels.rglru import rglru_scan\n"
        "import repro_torch.serve, repro_torch.launch.serve\n"
        "assert build._loaded == {}, build._loaded\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
