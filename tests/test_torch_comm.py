"""The gradient-sync side of the port against the JAX reference (CPU):
bucket plans (every category, hypothesis-drawn trees), pack / unpack,
``Int8Compressor.reduce``, ``GradSyncEngine`` in a one-process gloo
group against repro's under ``shard_map`` on the one-device CPU mesh,
``estimate_sync_time``, and a two-process gloo group (a subprocess with
a timeout) where every category gives the same mean and ``ddp`` mode
equals ``jit`` mode on the whole batch.

Tolerances: plans and costs exact; the engine's sums exact in one
process (a one-member all-reduce and a mean by 1.0); the int8 reduce
within 1e-6 of the largest value (the same fp32 ops); across two
processes, the mean within 1e-6 of the largest gradient, and the ddp
run's losses within 1e-5 relative and parameters within 1e-6 of jit's
after 3 steps (two half-batch gradients averaged vs one whole-batch
gradient: the same sums in another order).  That run's AdamW has
``eps = 1``: with the default 1e-8, Adam's first steps divide each
element by its own magnitude, so an element whose gradient is rounding
noise moves by a whole learning rate, either way, in either run; a
large eps keeps the update smooth in the gradient, so the comparison
measures the sync.
"""

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
from hypothesis import given, settings, strategies as st
from jax.sharding import PartitionSpec as P

from repro.comm.bucketing import make_bucket_plan as jmake_bucket_plan
from repro.comm.compression import Int8Compressor as JInt8
from repro.comm.costs import ICI_ALPHA, ICI_LINK_BW
from repro.comm.costs import estimate_sync_time as jestimate
from repro.comm.engine import GradSyncEngine as JEngine
from repro.compat import shard_map
from repro.core.channels import plan_for as jplan_for
from repro.core.endpoints import Category as JCategory
from repro.launch.mesh import make_mesh
from repro_torch.comm.bucketing import (make_bucket_plan, pack_buckets,
                                        unpack_buckets)
from repro_torch.comm.compression import Int8Compressor
from repro_torch.comm.costs import estimate_sync_time
from repro_torch.comm.engine import GradSyncEngine
from repro_torch.core.channels import plan_for
from repro_torch.core.endpoints import Category

DTYPES = {"float32": (np.float32, torch.float32),
          "float16": (np.float16, torch.float16),
          "int32": (np.int32, torch.int32)}


def _trees(seed, n_leaves, dtypes=tuple(DTYPES)):
    """The same random tree as numpy arrays and as tensors."""
    rng = np.random.default_rng(seed)
    arrays = {}
    for i in range(n_leaves):
        shape = tuple(int(d) for d in rng.integers(1, 9,
                                                   size=rng.integers(0, 3)))
        name = dtypes[int(rng.integers(len(dtypes)))]
        arrays[f"leaf{i}"] = np.asarray(10 * rng.standard_normal(shape),
                                        dtype=DTYPES[name][0])
    return arrays, {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}


def _plan_summary(bplan, name_of):
    return [{name: (total, [(s.leaf, tuple(s.shape), s.offset,
                             s.padded_size, name_of(s.dtype))
                            for s in segs])
             for name, (total, segs) in b.items()} for b in bplan.buckets]


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 10_000), n_leaves=st.integers(1, 40),
       cat=st.sampled_from(list(Category)))
def test_bucket_plan_equals_reference(seed, n_leaves, cat):
    arrays, tensors = _trees(seed, n_leaves)
    jplan = jmake_bucket_plan(jax.tree.map(jnp.asarray, arrays),
                              jplan_for(JCategory(cat.value)))
    plan = make_bucket_plan(tensors, plan_for(cat))
    assert plan.leaf_bucket == jplan.leaf_bucket
    assert plan.n_leaves == jplan.n_leaves
    assert plan.bucket_bytes() == jplan.bucket_bytes()
    assert _plan_summary(plan, lambda d: str(d).removeprefix("torch.")) \
        == _plan_summary(jplan, lambda d: np.dtype(d).name)
    packed = pack_buckets(tensors, plan)
    out = unpack_buckets(packed, plan)
    for k in tensors:
        assert torch.equal(out[k], tensors[k])


def test_int8_reduce_equals_reference():
    rng = np.random.default_rng(7)
    flat = rng.standard_normal(1000).astype(np.float32)
    residual = 0.01 * rng.standard_normal(1000).astype(np.float32)
    ident = lambda x: x     # noqa: E731 — one participant
    jout, jres = JInt8().reduce(jnp.asarray(flat), jnp.asarray(residual),
                                ident, ident)
    out, res = Int8Compressor().reduce(torch.from_numpy(flat),
                                       torch.from_numpy(residual), ident,
                                       ident)
    for a, b in ((out, jout), (res, jres)):
        b = np.asarray(b)
        assert float(np.abs(a.numpy() - b).max()) <= \
            1e-6 * float(np.abs(b).max())


@pytest.mark.parametrize("cat", list(Category))
def test_estimate_sync_time_equals_reference(cat):
    rng = np.random.default_rng(0)
    for n in (1, 3, 16, 40):
        sizes = [float(s) for s in rng.integers(1000, 10 ** 7, n)]
        for axis in (1, 2, 8, 256):
            got = estimate_sync_time(sizes, plan_for(cat), axis,
                                     link_bw=ICI_LINK_BW, alpha=ICI_ALPHA)
            want = jestimate(sizes, jplan_for(JCategory(cat.value)), axis)
            assert got.seconds == want.seconds
            assert got.alpha_seconds == want.alpha_seconds
            assert got.beta_seconds == want.beta_seconds
            assert got.n_collectives == want.n_collectives


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_engine_refuses_to_run_without_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        GradSyncEngine(Category.DYNAMIC)


@pytest.fixture(scope="module")
def one_process_group():
    dist.init_process_group("gloo",
                            init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("compressed", [False, True])
def test_engine_equals_reference_under_shard_map(one_process_group,
                                                 compressed):
    """Every category in a one-process gloo group against repro's engine
    under ``shard_map`` on the one-device mesh; the collectives issued
    per call equal the bucket plan's (bucket, dtype) buffers (twice that
    with int8: a max, then the sum)."""
    arrays, tensors = _trees(3, 12, dtypes=("float32", "float16"))
    mesh = make_mesh((1,), ("data",))
    for cat in Category:
        comp = Int8Compressor() if compressed else None
        eng = GradSyncEngine(cat, compressor=comp)
        state = eng.init_compressor_state(tensors)
        out, new_state = eng(tensors, state)
        n_buffers = eng.make_plan(tensors).n_buffers
        assert eng.last_collectives == n_buffers * (2 if compressed else 1)

        jeng = JEngine(JCategory(cat.value), axis_names=("data",),
                       compressor=JInt8() if compressed else None)
        jtree = jax.tree.map(jnp.asarray, arrays)
        jstate = jeng.init_compressor_state(jtree)
        jout, jnew = jax.jit(shard_map(jeng, mesh=mesh, in_specs=(P(), P()),
                                       out_specs=(P(), P())))(jtree, jstate)
        for k in arrays:
            a = out[k].float().numpy()
            b = np.asarray(jout[k], np.float32)
            if compressed:
                assert float(np.abs(a - b).max()) <= \
                    1e-6 * float(np.abs(b).max()), (cat, k)
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"{cat} {k}")
        if compressed:
            for b_new, jb_new in zip(new_state, jnew):
                for name in b_new:
                    np.testing.assert_allclose(
                        b_new[name].numpy(), np.asarray(jb_new[name]),
                        rtol=0, atol=1e-6)


TWO_PROCESS_SCRIPT = textwrap.dedent("""
    import dataclasses, sys
    import torch, torch.distributed as dist
    from repro_torch.comm.engine import GradSyncEngine
    from repro_torch.comm.compression import Int8Compressor
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.endpoints import Category
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch.steps import make_ddp_train_step, make_train_step
    from repro_torch.models.model import Model
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim.adamw import AdamW, cosine_schedule

    rank, port = int(sys.argv[1]), int(sys.argv[2])
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)

    def grads(r):
        g = torch.Generator().manual_seed(100 + r)
        return {f"g{i}": torch.randn((17 + i, 13), generator=g)
                for i in range(20)}

    mine, a, b = grads(rank), grads(0), grads(1)
    top = max(float((a[k] + b[k]).abs().max()) for k in a)
    for cat in Category:
        eng = GradSyncEngine(cat)
        out, _ = eng(mine)
        assert eng.last_collectives == eng.make_plan(mine).n_buffers
        for k in mine:
            err = float((out[k] - (a[k] + b[k]) * 0.5).abs().max())
            assert err <= 1e-6 * top, (cat, k, err)
    eng = GradSyncEngine(Category.DYNAMIC, compressor=Int8Compressor())
    out, state = eng(mine, eng.init_compressor_state(mine))
    for k in mine:
        assert torch.isfinite(out[k]).all()

    # ddp mode (each rank its 2 rows, the engine's mean) against jit mode
    # on all 4 rows, 3 steps of the dense smoke config at fp32
    cfg = dataclasses.replace(get_smoke_config("smollm-360m"),
                              compute_dtype="float32")
    model = Model(cfg, device="cpu")
    data = SyntheticLMData(vocab=cfg.vocab, seq_len=16, global_batch=4)
    opt = AdamW(learning_rate=cosine_schedule(1e-3, 1, 3), eps=1.0)
    ddp_step, _ = make_ddp_train_step(model, opt,
                                      category=Category.SHARED_DYNAMIC)
    jit_step = make_train_step(model, opt)
    runs = []
    for mode in ("ddp", "jit"):
        params = model.init(torch.Generator().manual_seed(0))
        state, losses = opt.init(params), []
        for step in range(3):
            batch = {k: torch.from_numpy(v)
                     for k, v in data.batch_at(step).items()}
            if mode == "ddp":
                params, state, m, _ = ddp_step(params, state, batch, ())
            else:
                params, state, m = jit_step(params, state, batch)
            losses.append(float(m["loss"]))
        runs.append((params, losses))
    (p_d, l_d), (p_j, l_j) = runs
    for a, b in zip(l_d, l_j):
        assert abs(a - b) <= 1e-5 * abs(b), (l_d, l_j)
    worst = max(float((x - y).abs().max()) for x, y in zip(
        tree_leaves(p_d, torch.is_tensor), tree_leaves(p_j, torch.is_tensor)))
    assert worst <= 1e-6, worst
    dist.destroy_process_group()
    print("OK", rank, worst)
""")


def test_two_process_gloo_group():
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src"),
         os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, "-c", TWO_PROCESS_SCRIPT, str(rank), str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for rank in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, out + err
        assert "OK" in out
