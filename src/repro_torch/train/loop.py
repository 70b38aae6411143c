"""Training loop: step + data + checkpoints + fault tolerance (the port of
``repro.train.loop``).

Two step flavors:
  * ``jit``: the single-process step (``launch.steps.make_train_step``),
    with ``make_shard_fn(rules, mesh)`` installed when the config names
    a mesh and rules;
  * ``ddp``: the data-parallel step whose gradient sync the
    scalable-endpoints engine schedules by ``endpoint_category``, over
    the mesh's "data" group, or the default ``torch.distributed`` process
    group without a mesh (either must be initialized: ``launch.train``
    forms it and its mesh).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Optional

import torch

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.core.endpoints import Category
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.launch.steps import make_ddp_train_step, make_train_step
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.runtime.fault_tolerance import StragglerMitigator, Supervisor


@dataclasses.dataclass
class TrainConfig:
    seq_len: int = 512
    global_batch: int = 8
    n_steps: int = 100
    peak_lr: float = 3e-4
    warmup_steps: int = 20
    checkpoint_dir: str = "checkpoints"
    checkpoint_every: int = 50
    log_every: int = 10
    seed: int = 0
    mode: str = "jit"            # jit | ddp
    endpoint_category: Category = Category.TWO_X_DYNAMIC
    mesh: Optional[Any] = None   # a DeviceMesh (launch.mesh.make_mesh)
    rules: Optional[dict] = None  # jit mode: sharding rules over the mesh
    remat: bool = True
    accum_steps: int = 1
    device: Optional[str] = None  # None: the card


class Trainer:
    def __init__(self, cfg: ArchConfig, tc: TrainConfig):
        self.cfg = cfg
        self.tc = tc
        self.model = Model(cfg, device=tc.device)
        self.opt = AdamW(learning_rate=cosine_schedule(
            tc.peak_lr, tc.warmup_steps, tc.n_steps))
        self.data = SyntheticLMData(vocab=cfg.vocab, seq_len=tc.seq_len,
                                    global_batch=tc.global_batch,
                                    seed=tc.seed)
        self.ckpt = CheckpointManager(tc.checkpoint_dir)
        self.metrics_log = []
        self._init_state()
        self.comp_state = ()

        if tc.mode == "ddp":
            group = (tc.mesh.get_group("data") if tc.mesh is not None
                     else None)
            self._step, self.engine = make_ddp_train_step(
                self.model, self.opt, group=group,
                category=tc.endpoint_category)
        elif tc.mode == "jit":
            shard_fn = None
            if tc.mesh is not None and tc.rules is not None:
                from repro_torch.launch.sharding import make_shard_fn
                shard_fn = make_shard_fn(tc.rules, tc.mesh)
            self._step = make_train_step(self.model, self.opt,
                                         shard_fn=shard_fn, remat=tc.remat,
                                         accum_steps=tc.accum_steps)
        else:
            raise ValueError(f"mode {tc.mode!r}: jit or ddp")

    def _init_state(self):
        """Fresh weights from a ``torch.Generator`` seeded with ``seed``
        (on the model's device), and a fresh optimizer state."""
        gen = torch.Generator(device=self.model.device)
        gen.manual_seed(self.tc.seed)
        self.params = self.model.init(gen)
        self.opt_state = self.opt.init(self.params)

    # ------------------------------------------------------------------
    def _train_state(self):
        return {"params": self.params, "opt_state": self.opt_state}

    def _one_step(self, step: int):
        batch = {k: torch.from_numpy(v).to(self.model.device)
                 for k, v in self.data.batch_at(step).items()}
        if self.tc.mode == "ddp":
            self.params, self.opt_state, metrics, self.comp_state = \
                self._step(self.params, self.opt_state, batch,
                           self.comp_state)
        else:
            self.params, self.opt_state, metrics = self._step(
                self.params, self.opt_state, batch)
        if (step + 1) % self.tc.checkpoint_every == 0:
            self.ckpt.save_async(step + 1, self._train_state())
        if step % self.tc.log_every == 0 or step == self.tc.n_steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            self.metrics_log.append(m)
        return metrics

    def _restore(self) -> int:
        """Restore the latest complete checkpoint; -> the step to resume
        at (0, from fresh weights, when there is none)."""
        self.ckpt.wait()
        step, state = self.ckpt.restore_latest(self._train_state())
        if step is None:
            self._init_state()
            return 0
        self.params = state["params"]
        self.opt_state = state["opt_state"]
        return step

    def train(self, failure_injector: Optional[Callable] = None,
              straggler: Optional[StragglerMitigator] = None) -> list:
        """Run to n_steps under the supervisor.  ``failure_injector(step)``
        may raise TransientWorkerFailure (tests, chaos runs)."""

        def step_fn(step):
            if failure_injector is not None:
                failure_injector(step)
            return self._one_step(step)

        self.supervisor = Supervisor(step_fn, self._restore,
                                     straggler=straggler)
        self.supervisor.run(0, self.tc.n_steps)
        self.ckpt.wait()
        self.ckpt.save(self.tc.n_steps, self._train_state())
        return self.metrics_log

    def save_metrics(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            for m in self.metrics_log:
                f.write(json.dumps(m) + "\n")
