"""The port's dry run against the JAX reference (CPU).

* ``auto_accum`` and ``rules_for`` equal to the reference's for every
  arch, both production meshes and every preset.
* The op counter's matmul FLOPs of the step builders' prefill and decode
  steps, run on meta tensors, within 2% of ``repro.launch.hlo_analysis``
  on the reference's jitted step (one CPU device), on the qwen2-0.5b and
  granite-moe-1b-a400m smoke configs (both are equal).  The train step is
  pinned: the port counts one more head product, ``2 B S d V``, because
  its chunked loss recomputes each chunk's logits in the backward
  (``models/losses.py``, a checkpoint per chunk), which XLA's
  rematerialization does not.
* The distinct (shape, logical axes) pairs ``shard_fn`` receives in
  ``loss_fn``, ``prefill`` and ``decode_step`` equal the reference's
  (a recording ``shard_fn`` on both sides; the reference traced with
  ``jax.eval_shape``) on the qwen2 and granite smoke configs.
* ``loss_fn`` (and its gradients), ``prefill`` and ``decode_step`` with
  a non-identity ``shard_fn`` (each activation made a DTensor on a
  one-rank (1, 1) gloo mesh, redistributed by ``make_shard_fn``, and
  brought back) equal their unhooked results bit for bit at fp32.
* A dry run in a subprocess on ``fake`` process groups: qwen2-0.5b
  ``decode_32k`` on both production meshes (n_chips 256 and 512; the
  multi mesh's argument bytes at most the single's; the single's equal
  to the local shard bytes the reference's specs give), a train cell cut
  to 32 x 256 (records' keys, the bucket-plan collectives, FLOPs scaled
  from the rows run) and smollm-360m ``long_500k`` skipped.

Tolerances: exact, except the FLOPs (2%, and the train step's pinned
difference exact).
"""

import dataclasses
import json
import math
import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import ARCHS, get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.launch import dryrun as jdryrun
from repro.launch import shapes as jshapes
from repro.launch import sharding as jsharding
from repro.launch import steps as jsteps
from repro.launch.hlo_analysis import analyze
from repro.models.model import Model as JModel
from repro.optim.adamw import AdamW as JAdamW
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import dryrun, sharding
from repro_torch.launch.op_analysis import OpCounter
from repro_torch.launch.shapes import SHAPES
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step, value_and_grad)
from repro_torch.models.model import Model
from repro_torch.models.params import from_numpy, tree_leaves
from repro_torch.optim.adamw import AdamW

ROOT = os.path.join(os.path.dirname(__file__), "..")


class FakeMesh:
    """The reference tests' stand-in for a mesh: axis names and sizes."""

    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {"single": FakeMesh({"data": 16, "model": 16}),
          "multi": FakeMesh({"pod": 2, "data": 16, "model": 16})}


@pytest.mark.parametrize("arch", ARCHS)
def test_auto_accum_and_rules_match_the_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert dryrun.rules_for(Model(cfg, device="meta"))[1] == \
        jdryrun.rules_for(JModel(jcfg))[1]
    for mesh in MESHES.values():
        for name, cell in SHAPES.items():
            for preset in (None,) + tuple(sharding.RULE_PRESETS):
                rules = sharding.RULE_PRESETS[preset]() if preset else None
                jrules = jsharding.RULE_PRESETS[preset]() if preset else None
                assert dryrun.auto_accum(cfg, cell, mesh, rules) == \
                    jdryrun.auto_accum(jcfg, jshapes.SHAPES[name], mesh,
                                       jrules), (name, preset, mesh.shape)


# --------------------------------------------------------------------------
# FLOPs against the reference's HLO walker
# --------------------------------------------------------------------------

B, S, MAX_LEN = 2, 64, 128


def _j_flops(jm, kind):
    """The HLO walker's FLOPs of the reference's jitted step."""
    jp = jm.abstract_params()
    tok = jax.ShapeDtypeStruct((B, S), jnp.int32)
    cache = jax.eval_shape(lambda: jm.init_cache(B, max_len=MAX_LEN))
    if kind == "prefill":
        lowered = jax.jit(jsteps.make_prefill_step(jm)).lower(
            jp, {"tokens": tok}, cache)
    elif kind == "decode":
        lowered = jax.jit(jsteps.make_decode_step(jm)).lower(
            jp, cache, jax.ShapeDtypeStruct((B,), jnp.int32))
    else:
        opt = JAdamW()
        lowered = jax.jit(jsteps.make_train_step(jm, opt)).lower(
            jp, jax.eval_shape(opt.init, jp), {"tokens": tok, "labels": tok})
    return analyze(lowered.compile().as_text()).flops


def _t_flops(tm, kind):
    """The op counter's FLOPs of the port's step on meta tensors."""
    params = tm.abstract_params()
    tok = torch.empty((B, S), dtype=torch.int32, device="meta")
    with OpCounter() as counter:
        if kind == "prefill":
            make_prefill_step(tm)(params, {"tokens": tok},
                                  tm.init_cache(B, MAX_LEN))
        elif kind == "decode":
            make_decode_step(tm)(params, tm.init_cache(B, MAX_LEN),
                                 torch.empty((B,), dtype=torch.int32,
                                             device="meta"))
        else:
            opt = AdamW()
            make_train_step(tm, opt)(params, opt.init(params),
                                     {"tokens": tok, "labels": tok})
    return counter.flops


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "granite-moe-1b-a400m"])
def test_matmul_flops_match_the_hlo_walker(arch):
    jm = JModel(jget_smoke(arch))
    tm = Model(get_smoke_config(arch), device="meta")
    for kind in ("prefill", "decode"):
        want, got = _j_flops(jm, kind), _t_flops(tm, kind)
        assert want > 0 and abs(got - want) <= 0.02 * want, (kind, got, want)
    if arch == "qwen2-0.5b":
        cfg = get_smoke_config(arch)
        recomputed_head = 2 * B * S * cfg.d_model * cfg.vocab
        assert _t_flops(tm, "train") == _j_flops(jm, "train") \
            + recomputed_head


# --------------------------------------------------------------------------
# The shard_fn hooks
# --------------------------------------------------------------------------

def _recorder(seen):
    def shard_fn(a, *names):
        seen.add((tuple(a.shape), names))
        return a
    return shard_fn


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "granite-moe-1b-a400m"])
def test_shard_fn_sees_the_references_shapes_and_axes(arch):
    jm = JModel(jget_smoke(arch))
    tm = Model(get_smoke_config(arch), device="meta")
    jp = jm.abstract_params()
    tp = tm.abstract_params()
    tok = torch.empty((B, S), dtype=torch.int32, device="meta")
    jtok = jax.ShapeDtypeStruct((B, S), jnp.int32)
    for entry in ("loss_fn", "prefill", "decode_step"):
        want, got = set(), set()
        jf, tf = _recorder(want), _recorder(got)
        if entry == "loss_fn":
            jax.eval_shape(lambda p, b: jm.loss_fn(p, b, shard_fn=jf),
                           jp, {"tokens": jtok, "labels": jtok})
            tm.loss_fn(tp, {"tokens": tok, "labels": tok}, shard_fn=tf)
        elif entry == "prefill":
            jax.eval_shape(lambda p, b: jm.prefill(
                p, b, jm.init_cache(B, MAX_LEN), shard_fn=jf),
                jp, {"tokens": jtok})
            tm.prefill(tp, {"tokens": tok}, tm.init_cache(B, MAX_LEN),
                       shard_fn=tf)
        else:
            jax.eval_shape(lambda p, t: jm.decode_step(
                p, jm.init_cache(B, MAX_LEN), tokens=t, shard_fn=jf),
                jp, jax.ShapeDtypeStruct((B,), jnp.int32))
            tm.decode_step(tp, tm.init_cache(B, MAX_LEN),
                           tokens=torch.empty((B,), dtype=torch.int32,
                                              device="meta"),
                           shard_fn=tf)
        assert want and got == want, (entry, got ^ want)
    if arch == "granite-moe-1b-a400m":
        assert any("expert" in names for _, names in got)


@pytest.fixture(scope="module")
def one_rank_mesh():
    """A (1, 1) ("data", "model") mesh over a one-process gloo group
    (joined here unless a group is already up, and left as found)."""
    from repro_torch.launch.mesh import make_mesh
    joined = not dist.is_initialized()
    if joined:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        dist.init_process_group("gloo",
                                init_method=f"tcp://localhost:{port}",
                                world_size=1, rank=0)
    yield make_mesh((1, 1), ("data", "model"), device_type="cpu")
    if joined:
        dist.destroy_process_group()


def _bits_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(
        tree_leaves(a, torch.is_tensor), tree_leaves(b, torch.is_tensor)))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "granite-moe-1b-a400m"])
def test_hooked_steps_equal_the_unhooked_bit_for_bit(arch, one_rank_mesh):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = one_rank_mesh
    inner = sharding.make_shard_fn(sharding.fsdp_tp_sp_rules(), mesh)
    placed = []

    def shard_fn(a, *names):
        d = DTensor.from_local(a, mesh, [Replicate(), Replicate()])
        out = inner(d, *names)
        placed.append(out.placements)
        return out.to_local()

    cfg = dataclasses.replace(get_smoke_config(arch),
                              compute_dtype="float32")
    jm = JModel(dataclasses.replace(jget_smoke(arch),
                                    compute_dtype="float32"))
    params = from_numpy(jax.device_get(jm.init(jax.random.PRNGKey(0))))
    tm = Model(cfg, device="cpu")
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (B, 12),
                                        dtype=np.int32))
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
    plain = value_and_grad(tm, params, batch)
    hooked = value_and_grad(tm, params, batch, shard_fn=shard_fn)
    assert _bits_equal(plain, hooked)
    runs = []
    for fn in (None, shard_fn):
        kw = {} if fn is None else {"shard_fn": fn}
        cache = tm.init_cache(B, 32)
        logits, cache = tm.prefill(params, {"tokens": tok}, cache, **kw)
        steps = [logits]
        nxt = logits.argmax(-1).int()
        for _ in range(3):
            logits, cache = tm.decode_step(params, cache, tokens=nxt, **kw)
            steps.append(logits)
            nxt = logits.argmax(-1).int()
        runs.append((steps, cache))
    assert _bits_equal(runs[0], runs[1])
    assert any(isinstance(p, Shard) for ps in placed for p in ps)


# --------------------------------------------------------------------------
# The dry run on fake process groups
# --------------------------------------------------------------------------

DRYRUN_SCRIPT = textwrap.dedent("""
    import json, sys, tempfile
    import torch.distributed as dist
    from repro_torch.launch import dryrun, shapes
    out = {}
    for mesh in ("single", "multi"):
        out[mesh] = dryrun.run_one("qwen2-0.5b", "decode_32k", mesh)
    # the train cell at a shape a test can run (the production one is
    # 256 x 4096); the dict is the one lower_cell reads
    shapes.SHAPES["train_4k"] = shapes.ShapeCell("train_4k", "train",
                                                 256, 32)
    out["train"] = dryrun.run_one("qwen2-0.5b", "train_4k", "single")
    assert dist.get_backend() == "fake"
    with tempfile.TemporaryDirectory() as d:
        res = dryrun.run_cells(["smollm-360m"], ["long_500k"], ["single"],
                               d, verbose=False)
        out["skip"] = res[0]
        out["summary"] = json.load(open(d + "/summary.json"))["summary"]
    print("RECORDS " + json.dumps(out))
""")

#: the keys of the reference's record (``repro/launch/dryrun.py``)
REFERENCE_KEYS = {"arch", "shape", "kind", "mesh", "n_chips", "rules",
                  "accum_steps", "n_params", "lower_s", "compile_s",
                  "memory", "cost", "cost_xla_loop_unaware", "collectives",
                  "status", "mesh_name"}


def _local_bytes(shape, dtype_size, spec, mesh) -> int:
    n = math.prod(shape)
    for entry in spec:
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        n //= math.prod(mesh.shape[a] for a in axes)
    return n * dtype_size


def _reference_decode_argument_bytes(monkeypatch, mesh) -> int:
    """The local shard bytes of qwen2-0.5b's decode_32k arguments under
    the reference's own specs: fp32 parameters (tp rules), the cache,
    the tokens."""
    cfg = jget_config("qwen2-0.5b")
    model = JModel(cfg)
    rules = jsharding.tp_rules()
    total = 0
    for leaf, axes in zip(
            jax.tree.leaves(model.abstract_params()),
            jax.tree.leaves(model.param_axes(),
                            is_leaf=lambda x: isinstance(x, tuple))):
        spec = jsharding.spec_for(rules, mesh, leaf.shape, axes)
        total += _local_bytes(leaf.shape, 4, spec, mesh)
    monkeypatch.setattr(jshapes, "_sds", lambda shape, dtype, m, spec: (
        tuple(shape), jnp.dtype(dtype).itemsize, spec))
    cell = jshapes.SHAPES["decode_32k"]
    leaves = jax.tree.leaves(
        [jshapes.cache_specs(model, cell, mesh),
         jshapes.decode_token_specs(cfg, cell, mesh)],
        is_leaf=lambda x: isinstance(x, tuple) and len(x) == 3
        and isinstance(x[0], tuple))
    for shape, size, spec in leaves:
        total += _local_bytes(shape, size, spec, mesh)
    return total


def test_dry_run_on_fake_groups(monkeypatch):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run([sys.executable, "-c", DRYRUN_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    line = next(l for l in res.stdout.splitlines()
                if l.startswith("RECORDS "))
    recs = json.loads(line[len("RECORDS "):])
    single, multi, train = recs["single"], recs["multi"], recs["train"]
    for rec in (single, multi, train):
        assert rec["status"] == "ok", rec.get("traceback")
        assert REFERENCE_KEYS <= set(rec)
    assert single["n_chips"] == 256 and multi["n_chips"] == 512
    assert single["mesh"] == {"data": 16, "model": 16}
    assert multi["memory"]["argument_bytes"] <= \
        single["memory"]["argument_bytes"]
    assert single["memory"]["argument_bytes"] == \
        _reference_decode_argument_bytes(monkeypatch, MESHES["single"])
    assert single["memory"]["alias_bytes"] > 0
    assert single["cost"]["flops_per_device"] > 0
    assert single["cost"]["flops_global"] == \
        single["cost"]["flops_per_device"] * 256
    # decode: 8 rows a card run, the whole batch 16 times that
    assert single["rows_run"] == 8 and multi["rows_run"] == 4
    assert single["cost"]["flops_global"] == \
        16 * single["cost_xla_loop_unaware"]["flops_per_device"]
    assert single["collectives"]["total_count"] == 0
    # the train cell: 32 rows over 16 data ranks, the bucket plan's sync
    assert train["kind"] == "train" and train["rows_run"] == 2
    assert train["collectives"]["source"] == "bucket_plan"
    assert train["collectives"]["total_count"] > 0
    assert set(train["collectives"]["by_category"]) == {
        "mpi_everywhere", "2x_dynamic", "dynamic", "shared_dynamic",
        "static", "mpi_threads"}
    assert train["collectives"]["by_category"]["mpi_threads"][
        "total_count"] == 1
    assert train["cost"]["flops_global"] == 16 * train["accum_steps"] \
        * train["cost_xla_loop_unaware"]["flops_per_device"]
    assert train["memory"]["alias_bytes"] < train["memory"]["argument_bytes"]
    assert recs["skip"]["status"] == "skipped"
    assert recs["summary"]["skipped"] == 1 and recs["summary"]["ok"] == 0
