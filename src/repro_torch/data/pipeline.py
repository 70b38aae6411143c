"""Deterministic synthetic LM data pipeline (the port's copy of
``repro.data.pipeline``, numpy only: its batches equal the reference's).

Affine-progression token streams with per-sequence structure, so the LM
loss actually decreases, generated per (seed, step, host): the iterator
is a pure function of the step index, so a resume from a checkpoint
replays the same batches with no data state to save.  Hosts take
disjoint slices of the global batch by ``host_id``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass
class SyntheticLMData:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0

    def __post_init__(self):
        if self.global_batch % self.n_hosts:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split over {self.n_hosts} hosts")
        self.host_batch = self.global_batch // self.n_hosts

    def batch_at(self, step: int) -> dict:
        """Host-local slice of the global batch for ``step``:
        ``{"tokens", "labels"}``, (host_batch, seq_len) int32 each."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))
        b, s = self.host_batch, self.seq_len
        a = rng.integers(1, 8, size=(b, 1), dtype=np.int64)
        c = rng.integers(0, self.vocab, size=(b, 1), dtype=np.int64)
        t0 = rng.integers(0, self.vocab, size=(b, 1), dtype=np.int64)
        idx = np.arange(s + 1, dtype=np.int64)[None, :]
        # the next token is a learnable function of the current one
        toks = (t0 + a * idx + c * (idx // 64)) % self.vocab
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def iterator(self, start_step: int = 0) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


def make_batch_iterator(cfg: ArchConfig, seq_len: int, global_batch: int,
                        seed: int = 0, start_step: int = 0,
                        n_hosts: int = 1, host_id: int = 0):
    data = SyntheticLMData(vocab=cfg.vocab, seq_len=seq_len,
                           global_batch=global_batch, seed=seed,
                           n_hosts=n_hosts, host_id=host_id)
    return data.iterator(start_step)
