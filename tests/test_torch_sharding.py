"""The port's sharding rules, shape cells and meshes against the JAX
reference (CPU, shapes only), and the rules on real DTensors in a 4-rank
gloo group.

* ``spec_for`` of every parameter of all ten configs under all five
  presets, on the reference tests' fake (16, 16) and (2, 16, 16) meshes:
  equal, entry for entry, to ``repro.launch.sharding.spec_for``'s
  ``PartitionSpec``; ``batch_spec``, ``kv_cache_spec`` and every decode
  cache leaf's spec (``repro.launch.shapes._cache_spec_for``) the same.
* ``SHAPES`` and ``cell_applicable`` equal for every (arch, cell).
* A 4-rank gloo group (a subprocess per rank, with a timeout) on a (2, 2)
  ("data", "model") mesh: each rank's shard of every qwen2-0.5b smoke
  parameter under ``tp`` and ``fsdp_tp`` has the shape the spec gives,
  and ``full_tensor()`` equals the leaf; ``make_shard_fn`` redistributes
  a DTensor activation to its spec's placements and leaves a plain
  tensor as the same object; ``sync_gradients`` equals
  ``GradSyncEngine`` in every category; ``restore(..., shardings=)``
  gives back DTensors equal to the saved tree.

Tolerances: all exact (specs, shapes, and fp32 values moved, never
summed in another order: the mean of four ranks is compared with the
same engine's mean).
"""

import os
import socket
import subprocess
import sys
import textwrap

import jax
import pytest
import torch

from repro.configs import ARCHS, get_config as jget_config
from repro.launch import shapes as jshapes
from repro.launch import sharding as jsharding
from repro.models.model import Model as JModel
from repro_torch.configs import get_config
from repro_torch.launch import shapes, sharding
from repro_torch.launch.mesh import data_axes, mesh_axis_size
from repro_torch.models.model import Model
from repro_torch.models.params import tree_leaves


class FakeMesh:
    """The reference tests' stand-in for a mesh: axis names and sizes."""

    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {"single": FakeMesh({"data": 16, "model": 16}),
          "multi": FakeMesh({"pod": 2, "data": 16, "model": 16})}
PRESETS = tuple(sharding.RULE_PRESETS)


def _entries(spec) -> tuple:
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e
                 for e in spec)


def test_presets_and_shapes_are_the_references():
    assert tuple(sharding.RULE_PRESETS) == tuple(jsharding.RULE_PRESETS)
    for name in PRESETS:
        assert sharding.RULE_PRESETS[name]() == \
            jsharding.RULE_PRESETS[name]()
    assert shapes.ENC_STUB_LEN == jshapes.ENC_STUB_LEN
    assert {k: vars(v) for k, v in shapes.SHAPES.items()} == \
        {k: vars(v) for k, v in jshapes.SHAPES.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_cell_applicability_matches_the_reference(arch):
    for name in shapes.SHAPES:
        assert shapes.cell_applicable(get_config(arch),
                                      shapes.SHAPES[name]) == \
            jshapes.cell_applicable(jget_config(arch), jshapes.SHAPES[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_for_every_leaf_matches_the_reference(arch):
    jm = JModel(jget_config(arch))
    j_leaves = jax.tree.leaves(jm.abstract_params())
    j_axes = jax.tree.leaves(jm.param_axes(),
                             is_leaf=lambda x: isinstance(x, tuple))
    tm = Model(get_config(arch), device="meta")
    t_leaves = tree_leaves(tm.abstract_params(), torch.is_tensor)
    t_axes = tree_leaves(tm.param_axes(), lambda x: isinstance(x, tuple))
    assert [tuple(a.shape) for a in t_leaves] == \
        [tuple(a.shape) for a in j_leaves]
    assert t_axes == j_axes
    assert all(a.device.type == "meta" for a in t_leaves)
    for preset in PRESETS:
        rules, jrules = (sharding.RULE_PRESETS[preset](),
                         jsharding.RULE_PRESETS[preset]())
        for mesh in MESHES.values():
            for leaf, axes in zip(t_leaves, t_axes):
                got = sharding.spec_for(rules, mesh, leaf.shape, axes)
                want = jsharding.spec_for(jrules, mesh, leaf.shape, axes)
                assert _entries(got) == _entries(want), \
                    (preset, mesh.shape, leaf.shape, axes)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_and_kv_cache_specs_match_the_reference(mesh_name):
    mesh = MESHES[mesh_name]
    for batch in (1, 2, 8, 16, 32, 64, 128, 256, 512, 3, 48):
        for preset in (None,) + PRESETS:
            rules = sharding.RULE_PRESETS[preset]() if preset else None
            jrules = jsharding.RULE_PRESETS[preset]() if preset else None
            assert _entries(sharding.batch_spec(mesh, batch, None,
                                                rules=rules)) == \
                _entries(jsharding.batch_spec(mesh, batch, None,
                                              rules=jrules))
        for heads, dh in ((16, 64), (8, 128), (5, 60), (2, 64), (1, 256),
                          (32, 80)):
            assert _entries(sharding.kv_cache_spec(mesh, batch, heads, dh)) \
                == _entries(jsharding.kv_cache_spec(mesh, batch, heads, dh))
    assert data_axes(mesh) == jsharding.data_axes(mesh)
    assert mesh_axis_size(mesh, data_axes(mesh)) == \
        (32 if mesh_name == "multi" else 16)


def _described(shape, dtype, mesh, spec):
    """What the reference's ``_sds`` is given: shape, dtype, spec."""
    return (tuple(shape), str(jax.numpy.dtype(dtype)), _entries(spec))


def _ours(tree) -> list:
    return [(tuple(s.tensor.shape),
             str(s.tensor.dtype).removeprefix("torch."), _entries(s.spec))
            for s in tree_leaves(tree, sharding.is_sharded)]


def _theirs(tree) -> list:
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, tuple)
                           and len(x) == 3 and isinstance(x[0], tuple))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_leaf_specs_match_the_reference(arch, monkeypatch):
    """Every cache leaf of the decode cells and of prefill_32k: the
    reference's ``cache_specs`` (its ``_sds`` recording what it would
    build, since the fake mesh has no devices) leaf for leaf."""
    monkeypatch.setattr(jshapes, "_sds", _described)
    for cell_name in ("decode_32k", "long_500k", "prefill_32k"):
        cell = shapes.SHAPES[cell_name]
        if not shapes.cell_applicable(get_config(arch), cell)[0]:
            continue
        for mesh in MESHES.values():
            got = _ours(shapes.cache_specs(
                Model(get_config(arch), device="meta"), cell, mesh))
            want = _theirs(jshapes.cache_specs(
                JModel(jget_config(arch)), jshapes.SHAPES[cell_name], mesh))
            assert got == want, (cell_name, mesh.shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_the_reference(arch, monkeypatch):
    """batch_specs (every preset) and decode_token_specs: keys, shapes,
    dtypes and specs."""
    monkeypatch.setattr(jshapes, "_sds", _described)
    cfg, jcfg = get_config(arch), jget_config(arch)
    for mesh in MESHES.values():
        for cell_name, cell in shapes.SHAPES.items():
            jcell = jshapes.SHAPES[cell_name]
            got = shapes.decode_token_specs(cfg, cell, mesh)
            want = jshapes.decode_token_specs(jcfg, jcell, mesh)
            assert {k: _ours(v)[0] for k, v in got.items()} == want
            for preset in PRESETS:
                got = shapes.batch_specs(
                    cfg, cell, mesh, sharding.RULE_PRESETS[preset]())
                want = jshapes.batch_specs(
                    jcfg, jcell, mesh, jsharding.RULE_PRESETS[preset]())
                assert {k: _ours(v)[0] for k, v in got.items()} == want, \
                    (cell_name, preset)


# --------------------------------------------------------------------------
# Four gloo ranks on a (2, 2) mesh
# --------------------------------------------------------------------------

FOUR_RANK_SCRIPT = textwrap.dedent("""
    import sys, tempfile
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, distribute_tensor
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.comm.engine import GradSyncEngine, sync_gradients
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.endpoints import Category
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import Model
    from repro_torch.models.params import tree_leaves, tree_map

    rank, port, ckdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=4, rank=rank)
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    assert sharding.axis_sizes(mesh) == {"data": 2, "model": 2}
    model = Model(get_smoke_config("qwen2-0.5b"), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    leaves = tree_leaves(params, torch.is_tensor)
    for preset in ("tp", "fsdp_tp"):
        rules = sharding.RULE_PRESETS[preset]()
        shards = sharding.param_shardings(rules, mesh,
                                          model.abstract_params(),
                                          model.param_axes())
        n_split = 0
        for leaf, sh in zip(leaves, tree_leaves(shards,
                                                sharding.is_sharding)):
            d = distribute_tensor(leaf, mesh, sh.placements)
            assert tuple(d.to_local().shape) == sh.shard_shape(leaf.shape), \\
                (preset, leaf.shape, sh.spec, d.to_local().shape)
            assert torch.equal(d.full_tensor(), leaf)
            n_split += tuple(d.to_local().shape) != tuple(leaf.shape)
        assert n_split > 0, preset

    # make_shard_fn: a DTensor activation to its spec's placements
    shard_fn = sharding.make_shard_fn(sharding.fsdp_tp_sp_rules(), mesh)
    x = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
    plain = torch.zeros(3)
    assert shard_fn(plain, "batch", None) is plain
    dx = distribute_tensor(x, mesh, sharding.placements(
        sharding.PartitionSpec(), mesh))
    y = shard_fn(dx, "batch", "seq", None)
    assert y.placements == sharding.placements(
        sharding.PartitionSpec("data", "model"), mesh), y.placements
    assert tuple(y.to_local().shape) == (2, 3, 8)
    assert torch.equal(y.full_tensor(), x)

    # sync_gradients = GradSyncEngine, every category
    gen = torch.Generator().manual_seed(rank)
    grads = {"a": torch.randn(7, 5, generator=gen),
             "b": [torch.randn(33, generator=gen),
                   torch.randn(2, 3, 4, generator=gen)]}
    for cat in Category:
        want, _ = GradSyncEngine(cat)(tree_map(torch.clone, grads,
                                               torch.is_tensor))
        got = sync_gradients(tree_map(torch.clone, grads, torch.is_tensor),
                             cat)
        for a, b in zip(tree_leaves(got, torch.is_tensor),
                        tree_leaves(want, torch.is_tensor)):
            assert torch.equal(a, b), cat

    # a checkpoint restored onto the mesh as DTensors
    ck = CheckpointManager(ckdir)
    if rank == 0:
        ck.save(3, params)
    dist.barrier()
    shards = sharding.param_shardings(sharding.tp_rules(), mesh,
                                      model.abstract_params(),
                                      model.param_axes())
    back = ck.restore(3, params, shardings=shards)
    for leaf, got in zip(leaves, tree_leaves(back, torch.is_tensor)):
        assert isinstance(got, DTensor)
        assert torch.equal(got.full_tensor(), leaf)
    step, back = ck.restore_latest(params, shardings=shards)
    assert step == 3 and isinstance(tree_leaves(back, torch.is_tensor)[0],
                                    DTensor)
    dist.barrier()
    dist.destroy_process_group()
    print("OK", rank)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_four_rank_gloo_mesh(tmp_path):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src"),
         os.environ.get("PYTHONPATH", "")]), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", FOUR_RANK_SCRIPT, str(rank), str(port),
         str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for rank in range(4)]
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
        assert p.returncode == 0, out + err[-4000:]
        assert "OK" in out
