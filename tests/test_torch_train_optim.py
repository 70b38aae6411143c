"""AdamW and its schedule, the synthetic data and the checkpoint manager
of the port against the JAX reference (CPU).

AdamW runs 5 steps on the same tree and gradients in both packages
(clip on and off; ``master_fp32`` with bf16 params): parameters and
moments within 1e-6 of their largest magnitude (the same fp32 ops; XLA
may fuse some into fused multiply-adds).  Data batches are equal as
arrays; checkpoints restore bit for bit, also across the packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import CheckpointManager as JCheckpoint
from repro.configs import get_smoke_config as jax_smoke_config
from repro.data.pipeline import SyntheticLMData as JData
from repro.models.model import Model as JModel
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.adamw import cosine_schedule as jcosine
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.data.pipeline import SyntheticLMData, make_batch_iterator
from repro_torch.configs import get_smoke_config
from repro_torch.models.params import from_numpy, tree_leaves, tree_map
from repro_torch.optim.adamw import AdamW, cosine_schedule

REL_TOL = 1e-6


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((8, 5)).astype(np.float32),
            "blk": [{"b": rng.standard_normal(3).astype(np.float32)},
                    {"a": rng.standard_normal((2, 4)).astype(np.float32)}]}


def _close(port, ref, what):
    a = np.asarray(port, np.float32)
    b = np.asarray(ref, np.float32)
    scale = max(float(np.abs(b).max()), 1e-30)
    assert float(np.abs(a - b).max()) <= REL_TOL * scale, what


def test_cosine_schedule_matches_reference():
    for args in ((3e-4, 20, 100), (1e-2, 0, 10), (1.0, 5, 5)):
        lr, jlr = cosine_schedule(*args), jcosine(*args)
        for step in range(0, 120, 3):
            np.testing.assert_allclose(
                float(lr(torch.tensor(step, dtype=torch.int32))),
                float(jlr(jnp.asarray(step, jnp.int32))), rtol=1e-6)


@pytest.mark.parametrize("clip_norm", [1.0, 0.0])
@pytest.mark.parametrize("master_fp32", [False, True])
def test_adamw_steps_match_reference(clip_norm, master_fp32):
    kw = dict(learning_rate=None, clip_norm=clip_norm,
              master_fp32=master_fp32)
    opt = AdamW(**dict(kw, learning_rate=cosine_schedule(1e-2, 2, 5)))
    jopt = JAdamW(**dict(kw, learning_rate=jcosine(1e-2, 2, 5)))
    p0 = _tree(0)
    dt, jdt = ((torch.bfloat16, jnp.bfloat16) if master_fp32
               else (torch.float32, jnp.float32))
    # a copy: the port updates in place, and jnp.asarray may share p0
    params = tree_map(lambda a: torch.from_numpy(a.copy()).to(dt), p0,
                      lambda x: isinstance(x, np.ndarray))
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jdt), p0)
    state, jstate = opt.init(params), jopt.init(jparams)
    for step in range(5):
        g = jax.tree.map(lambda a: 3.0 * a, _tree(100 + step))
        grads = from_numpy(g)
        params, state, gnorm = opt.step(grads, state, params)
        jparams, jstate, jgnorm = jopt.step(jax.tree.map(jnp.asarray, g),
                                            jstate, jparams)
        _close(float(gnorm), float(jgnorm), "grad norm")
    assert int(state["count"]) == int(jstate["count"]) == 5
    for name in ("mu", "nu") + (("master",) if master_fp32 else ()):
        for a, b in zip(tree_leaves(state[name], torch.is_tensor),
                        jax.tree.leaves(jstate[name])):
            _close(a.numpy(), b, name)
    for a, b in zip(tree_leaves(params, torch.is_tensor),
                    jax.tree.leaves(jparams)):
        assert a.dtype == dt
        _close(a.float().numpy(), np.asarray(b, np.float32), "params")


def test_adamw_update_then_apply_equals_step():
    opt = AdamW(learning_rate=cosine_schedule(1e-2, 1, 4))
    p = from_numpy(_tree(1))
    grads = from_numpy(_tree(2))
    p_a = tree_map(torch.clone, p, torch.is_tensor)
    s_a = opt.init(p_a)
    updates, s_a, g_a = opt.update(grads, s_a, p_a)
    p_a = opt.apply(p_a, updates)
    p_b = tree_map(torch.clone, p, torch.is_tensor)
    p_b, s_b, g_b = opt.step(grads, opt.init(p_b), p_b)
    assert torch.equal(g_a, g_b)
    for a, b in zip(tree_leaves(p_a, torch.is_tensor),
                    tree_leaves(p_b, torch.is_tensor)):
        assert torch.equal(a, b)


def test_synthetic_batches_equal_reference():
    for kw in (dict(vocab=128, seq_len=32, global_batch=4, seed=0),
               dict(vocab=151936, seq_len=512, global_batch=8, seed=3),
               dict(vocab=500, seq_len=70, global_batch=6, seed=1,
                    n_hosts=3, host_id=2)):
        data, jdata = SyntheticLMData(**kw), JData(**kw)
        for step in (0, 1, 13):
            a, b = data.batch_at(step), jdata.batch_at(step)
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
    it = make_batch_iterator(get_smoke_config("qwen2-0.5b"), 32, 4,
                             start_step=5)
    np.testing.assert_array_equal(
        next(it)["tokens"],
        JData(vocab=128, seq_len=32, global_batch=4).batch_at(5)["tokens"])


# ----- checkpoints: the reference's tests/test_checkpoint.py cases ----------

def _ckpt_tree(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((17, 5), generator=gen),
            "b": {"w": torch.randn(8, generator=gen).to(torch.bfloat16),
                  "n": torch.tensor(7, dtype=torch.int32)}}


def _assert_tree_equal(x, y):
    xs, ys = tree_leaves(x, torch.is_tensor), tree_leaves(y, torch.is_tensor)
    assert len(xs) == len(ys)
    for a, b in zip(xs, ys):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_roundtrip(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    t = _ckpt_tree()
    cm.save(10, t)
    assert cm.latest_step() == 10
    _assert_tree_equal(t, cm.restore(10, t))


def test_checkpoint_async_roundtrip(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    t = _ckpt_tree(1)
    cm.save_async(5, t)
    # the snapshot was taken before save_async returned
    t_saved = tree_map(torch.clone, t, torch.is_tensor)
    t["a"].add_(1.0)
    cm.wait()
    _assert_tree_equal(t_saved, cm.restore(5, t))


def test_incomplete_checkpoint_ignored(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    t = _ckpt_tree()
    cm.save(10, t)
    broken = tmp_path / "step_00000020"
    broken.mkdir()
    (broken / "leaf_0.npy").write_bytes(b"garbage")
    assert cm.latest_step() == 10
    step, out = cm.restore_latest(t)
    assert step == 10
    _assert_tree_equal(t, out)


def test_checkpoint_pruning(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    t = _ckpt_tree()
    for s in (1, 2, 3, 4):
        cm.save(s, t)
    assert cm.all_steps() == [3, 4]


def test_checkpoint_shape_mismatch_raises(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, {"a": torch.zeros(4)})
    with pytest.raises(ValueError):
        cm.restore(1, {"a": torch.zeros(5)})


def test_checkpoint_dtype_preserved(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    t = _ckpt_tree()
    cm.save(1, t)
    out = cm.restore(1, t)
    assert out["b"]["w"].dtype == torch.bfloat16
    assert out["b"]["n"].dtype == torch.int32


def _train_state_pair():
    """repro's {"params", "opt_state"} of the qwen2 smoke config after
    init, and the same tree in the port's tensors."""
    jcfg = jax_smoke_config("qwen2-0.5b")
    jp = JModel(jcfg).init(jax.random.PRNGKey(0))
    jstate = {"params": jp, "opt_state": JAdamW().init(jp)}
    jstate["opt_state"]["mu"] = jax.tree.map(lambda a: a + 0.5,
                                             jstate["opt_state"]["mu"])
    jstate["params"]["final_norm"]["scale"] = jstate["params"][
        "final_norm"]["scale"].astype(jnp.bfloat16)
    return jstate, from_numpy(jax.device_get(jstate))


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    """A checkpoint that repro's CheckpointManager writes restores into
    the port's tree equal to ``from_numpy`` of the same state (the leaf
    numbering sorts dict keys in both; bf16 travels as uint16)."""
    jstate, expect = _train_state_pair()
    JCheckpoint(str(tmp_path)).save(7, jstate)
    like = tree_map(torch.zeros_like, expect, torch.is_tensor)
    step, out = CheckpointManager(str(tmp_path)).restore_latest(like)
    assert step == 7
    _assert_tree_equal(expect, out)


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    jstate, state = _train_state_pair()
    CheckpointManager(str(tmp_path)).save(3, state)
    out = JCheckpoint(str(tmp_path)).restore(3, jstate)
    for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(jstate)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
