"""recurrentgemma-2b's training path on the CPU: ``loss_fn`` and every
gradient against ``jax.value_and_grad`` of repro's (smoke config,
(2, 32), remat on and off; tolerances as in
``test_torch_train_model.py``), and the remat structure's count of
RG-LRU scan calls per train step (``remat_forward_counts``: forward,
recomputes and the backward's reverse-time call) against the calls the
step makes, at the smoke config's depth and at the full config's 26
layers (the nested period and group checkpoints) on narrow widths.
"""

import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.rglru import ops
from repro_torch.launch.steps import value_and_grad
from repro_torch.models.model import Model
from repro_torch.models.transformer import remat_forward_counts
from test_torch_train_model import (assert_loss_and_grads_match,  # noqa
                                    one_torch_thread)


@pytest.mark.parametrize("remat", [True, False])
def test_loss_fn_value_and_every_grad_match_reference(remat):
    assert_loss_and_grads_match("recurrentgemma-2b", remat)


def expected_scan_calls(model: Model, remat: bool) -> int:
    """Scan calls of one train step: each RG-LRU layer's forward runs
    (``remat_forward_counts``) plus its one backward call."""
    plan = model.plan
    descs = list(plan.prefix) + list(plan.period) * plan.n_periods
    return sum(n + 1 for n, d in zip(remat_forward_counts(plan, remat),
                                     descs) if d.kind == "rglru")


@pytest.mark.parametrize("n_layers", [5, 26])
@pytest.mark.parametrize("remat", [True, False])
def test_scan_calls_per_step_follow_the_remat_structure(n_layers, remat,
                                                        monkeypatch):
    full = get_config("recurrentgemma-2b")
    cfg = dataclasses.replace(full, n_layers=n_layers, d_model=32,
                              n_heads=2, n_kv_heads=1, d_head=16, d_ff=64,
                              vocab=64, lru_width=32, attn_window=16,
                              compute_dtype="float32")
    model = Model(cfg, device="cpu")
    calls = []
    scan = ops._scan
    monkeypatch.setattr(ops, "_scan", lambda a, x, **kw: calls.append(1)
                        or scan(a, x, **kw))
    params = model.init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (2, 16), generator=gen)
             for k in ("tokens", "labels")}
    value_and_grad(model, params, batch, remat=remat)
    assert len(calls) == expected_scan_calls(model, remat)
    if n_layers == 26:
        # 18 RG-LRU layers: 2 prefix blocks (3 calls each) and 16 in 8
        # periods of (local attention, RG-LRU, RG-LRU) grouped in pairs
        assert len(calls) == (70 if remat else 36)
