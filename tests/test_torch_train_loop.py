"""The port's training loop on the CPU: the loss falls, a resume after a
``TransientWorkerFailure`` ends bit for bit where an uninterrupted run
does, the supervisor's restart budget and the heartbeat, the Trainer
against repro's Trainer from the same initial weights, and the launcher
in both modes.

Trainer vs repro's Trainer (fp32 smollm-360m smoke config, 5 steps,
warmup 2, peak learning rate 1e-3): every parameter within 2e-5 of its
leaf's largest magnitude.  The gradients agree to about 1e-6; AdamW's
first steps divide each element's update by its own gradient's
magnitude, which turns that into differences of a few 1e-6 in the
parameters.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.train.loop import TrainConfig as JTrainConfig
from repro.train.loop import Trainer as JTrainer
from repro_torch.configs import get_smoke_config
from repro_torch.launch import train as launcher
from repro_torch.models.params import from_numpy, tree_leaves
from repro_torch.runtime import (Heartbeat, StragglerMitigator, Supervisor,
                                 TransientWorkerFailure)
from repro_torch.train.loop import TrainConfig, Trainer

PARAM_REL_TOL = 2e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The smoke-size tensors gain nothing from torch's intra-op threads,
    and beside other test workers those threads oversubscribe the cores
    (a step of many small ops then runs tens of times slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tc(directory, **kw):
    base = dict(seq_len=32, global_batch=4, n_steps=20,
                checkpoint_dir=str(directory), checkpoint_every=5,
                log_every=5, peak_lr=1e-3, warmup_steps=5, device="cpu")
    base.update(kw)
    return TrainConfig(**base)


def test_loss_decreases(tmp_path):
    tr = Trainer(get_smoke_config("smollm-360m"),
                 _tc(tmp_path / "a", n_steps=40))
    logs = tr.train()
    assert logs[-1]["loss"] < logs[0]["loss"]
    assert [m["step"] for m in logs] == [0, 5, 10, 15, 20, 25, 30, 35, 39]


def test_failure_resume_bitwise_equals_uninterrupted(tmp_path):
    """A run that fails at step 13 and restores the step-10 checkpoint
    ends with exactly the params of an uninterrupted run (the data is a
    pure function of the step)."""
    cfg = get_smoke_config("qwen2-0.5b")
    tr_a = Trainer(cfg, _tc(tmp_path / "a"))
    tr_a.train()
    tr_b = Trainer(cfg, _tc(tmp_path / "b"))
    fired = []

    def chaos(step):
        if step == 13 and not fired:
            fired.append(1)
            raise TransientWorkerFailure("sim")

    tr_b.train(failure_injector=chaos)
    assert fired and tr_b.supervisor.restarts == 1
    assert tr_a.supervisor.restarts == 0
    for a, b in zip(tree_leaves(tr_a.params, torch.is_tensor),
                    tree_leaves(tr_b.params, torch.is_tensor)):
        assert torch.equal(a, b)
    assert tr_b.ckpt.all_steps() == [10, 15, 20]


def test_supervisor_gives_up_after_max_restarts():
    calls = {"n": 0}

    def step_fn(step):
        raise TransientWorkerFailure("always")

    def restore():
        calls["n"] += 1
        return 0

    sup = Supervisor(step_fn, restore, max_restarts=3)
    with pytest.raises(TransientWorkerFailure):
        sup.run(0, 10)
    assert calls["n"] == 3 and sup.restarts == 4


def test_supervisor_budget_counts_consecutive_failures():
    """A completed step resets the budget: failures spread over the run
    never exhaust it."""
    failed = set()

    def step_fn(step):
        if step % 2 == 0 and step not in failed:
            failed.add(step)
            raise TransientWorkerFailure("flap")

    sup = Supervisor(step_fn, lambda: max(failed), max_restarts=1)
    sup.run(0, 10)
    assert sup.restarts == 5


def test_supervisor_propagates_real_bugs():
    def step_fn(step):
        raise ValueError("logic bug")

    sup = Supervisor(step_fn, lambda: 0, max_restarts=3)
    with pytest.raises(ValueError):
        sup.run(0, 10)


def test_supervisor_feeds_straggler_and_heartbeat(tmp_path):
    path = str(tmp_path / "hb.json")
    hb = Heartbeat(path, interval_s=0.0)
    sm = StragglerMitigator(window=8)
    Supervisor(lambda step: {}, lambda: 0, straggler=sm, heartbeat=hb).run(
        0, 6)
    assert len(sm.times) == 6
    with open(path) as f:
        assert json.load(f)["step"] == 5
    assert Heartbeat.is_alive(path, timeout_s=60.0)
    assert not Heartbeat.is_alive(path, timeout_s=-1.0)
    assert not Heartbeat.is_alive(str(tmp_path / "none"), timeout_s=60.0)


def test_heartbeat_respects_its_interval(tmp_path):
    path = str(tmp_path / "hb.json")
    hb = Heartbeat(path, interval_s=3600.0)
    hb.beat(1)
    hb.beat(2)                     # within the interval: not written
    with open(path) as f:
        assert json.load(f)["step"] == 1


def test_trainer_matches_reference_trainer_from_its_weights(tmp_path):
    jcfg = dataclasses.replace(jax_smoke_config("smollm-360m"),
                               compute_dtype="float32")
    kw = dict(seq_len=32, global_batch=4, n_steps=5, checkpoint_every=100,
              log_every=1, peak_lr=1e-3, warmup_steps=2)
    jtr = JTrainer(jcfg, JTrainConfig(checkpoint_dir=str(tmp_path / "j"),
                                      **kw))
    tr = Trainer(dataclasses.replace(get_smoke_config("smollm-360m"),
                                     compute_dtype="float32"),
                 TrainConfig(checkpoint_dir=str(tmp_path / "t"),
                             device="cpu", **kw))
    tr.params = from_numpy(jax.device_get(jtr.params))
    tr.opt_state = tr.opt.init(tr.params)
    jlogs, logs = jtr.train(), tr.train()
    for jm, m in zip(jlogs, logs):
        assert jm["step"] == m["step"]
        np.testing.assert_allclose(m["loss"], jm["loss"], rtol=1e-5)
    for a, b in zip(tree_leaves(tr.params, torch.is_tensor),
                    jax.tree.leaves(jtr.params)):
        b = np.asarray(b)
        assert float(np.abs(a.numpy() - b).max()) <= \
            PARAM_REL_TOL * float(np.abs(b).max())


@pytest.mark.parametrize("mode", ["jit", "ddp"])
def test_launcher_writes_metrics(tmp_path, mode, capsys):
    metrics = tmp_path / "m.jsonl"
    launcher.main(["--arch", "qwen2-0.5b", "--smoke", "--device", "cpu",
                   "--steps", "3", "--batch", "2", "--seq", "16",
                   "--mode", mode, "--endpoint", "mpi_threads",
                   "--ckpt-dir", str(tmp_path / "c"), "--ckpt-every", "2",
                   "--metrics", str(metrics)])
    rows = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert [r["step"] for r in rows] == [0, 2]
    assert all(np.isfinite(r["loss"]) for r in rows)
    assert "final:" in capsys.readouterr().out
    assert not torch.distributed.is_initialized()
