"""RG-LRU recurrent block (Griffin / RecurrentGemma).

Block: x -> [W_x -> causal depthwise conv -> RG-LRU] * gelu(W_gate x) -> W_out.
RG-LRU:  r_t = sigma(W_r u + b_r)          (recurrence gate)
         i_t = sigma(W_i u + b_i)          (input gate)
         log a_t = -c * softplus(Lambda) * r_t          (c = 8)
         h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

The port of ``repro.models.recurrent``, op for op.  The gates run in fp32
from fp32 weights (their specs say ``keep_fp32``: ``Model.prepare_params``
leaves them in fp32 whatever the compute dtype, as the reference reads
them from its fp32 params).  The reference ran the recurrence as an
``associative_scan``; here every scan over T goes through the RG-LRU
kernel's wrapper (``kernels.rglru.ops.rglru_scan``: the CUDA kernel on
the card, its sequential plain version on the CPU; differentiable, its
backward one more call of the same kernel in reverse time), and decode
keeps an O(d) fp32 carry.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.rglru.ops import rglru_scan as _scan_kernel
from repro_torch.models.layers import compute_dtype
from repro_torch.models.params import ParamSpec

RGLRU_C = 8.0


def rglru_specs(cfg: ArchConfig):
    d = cfg.d_model
    lru = cfg.lru_width or d
    w = cfg.conv1d_width
    return {
        "w_x": ParamSpec((d, lru), ("embed", "lru")),
        "w_gate_branch": ParamSpec((d, lru), ("embed", "lru")),
        "conv": ParamSpec((w, lru), ("conv", "lru"), init="normal",
                          scale=0.1),
        # the gates' leaves: read in fp32 at every compute dtype
        "w_input_gate": ParamSpec((lru, lru), ("lru", "lru_in"),
                                  keep_fp32=True),
        "b_input_gate": ParamSpec((lru,), ("lru",), init="zeros",
                                  keep_fp32=True),
        "w_rec_gate": ParamSpec((lru, lru), ("lru", "lru_in"),
                                keep_fp32=True),
        "b_rec_gate": ParamSpec((lru,), ("lru",), init="zeros",
                                keep_fp32=True),
        "lam": ParamSpec((lru,), ("lru",), init="lambda_rglru",
                         keep_fp32=True),
        "w_out": ParamSpec((lru, d), ("lru", "embed")),
    }


def causal_conv1d(u, kernel, state=None):
    """Depthwise causal conv.  u: (B, T, C); kernel: (W, C).
    ``state``: (B, W-1, C) carry for decode; -> (out, new_state)."""
    w = kernel.shape[0]
    if state is None:
        pad = torch.zeros((u.shape[0], w - 1, u.shape[2]), dtype=u.dtype,
                          device=u.device)
    else:
        pad = state.to(u.dtype)
    full = torch.cat([pad, u], dim=1)
    t = u.shape[1]
    out = sum(full[:, i:i + t] * kernel[i].to(u.dtype) for i in range(w))
    new_state = full[:, -(w - 1):] if w > 1 else None
    return out, new_state


def _rglru_gates(p, u):
    """-> (a, x_in), both fp32 (B, T, lru)."""
    uf = u.float()
    r = torch.sigmoid(uf @ p["w_rec_gate"].float() + p["b_rec_gate"].float())
    i = torch.sigmoid(uf @ p["w_input_gate"].float()
                      + p["b_input_gate"].float())
    lam = p["lam"].float()
    softplus = torch.logaddexp(lam, torch.zeros_like(lam))
    log_a = -RGLRU_C * softplus * r
    a = torch.exp(log_a)
    # sqrt(1 - a^2) with a = exp(log_a); clamp for numerical safety
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, beta * i * uf


def _scan(a, x_in, h0=None):
    """The recurrence over T from ``h0`` (None = zeros) -> fp32 h_all.
    The carry folds into the first step (``h_1 = a_1 h_0 + x_1``), so the
    kernel, which starts from zero as the TPU kernel does, computes it.
    ``x_in`` is the gates' own fresh tensor: the fold updates its first
    step in place.  No backward saves ``x_in`` (its product saves its
    factors, the scan saves ``a`` and its output), so the write is safe
    under autograd."""
    if h0 is not None:
        x_in[:, 0] += a[:, 0] * h0.float()
    return _scan_kernel(a, x_in)


def rglru_scan(p, u, h0=None):
    """u: (B, T, lru) -> h: (B, T, lru) in u's dtype."""
    a, x_in = _rglru_gates(p, u)
    return _scan(a, x_in, h0).to(u.dtype)


def rglru_step(p, u_t, h_prev):
    """Single decode step.  u_t: (B, lru); h_prev: (B, lru) fp32.
    -> (h in u_t's dtype, h fp32)."""
    a, x_in = _rglru_gates(p, u_t[:, None, :])
    h = a[:, 0] * h_prev + x_in[:, 0]
    return h.to(u_t.dtype), h


def apply_rglru_block(p, x, cfg: ArchConfig, cache=None, step_active=None):
    """x: (B, T, d).  cache: None (train/prefill from zero) or
    ``{"conv": (B, W-1, lru), "h": (B, lru) fp32}``, updated in place: a
    single-token step when T == 1, else a prefill that captures the state.
    ``step_active`` (0-d bool tensor) off leaves a decode step's state as
    it was (a step the reference's early-exiting horizon would not run).
    -> out (B, T, d)."""
    dt = x.dtype
    lru_in = x @ p["w_x"].to(dt)
    gate = F.gelu((x @ p["w_gate_branch"].to(dt)).float(),
                  approximate="tanh").to(dt)
    if cache is None:
        u, _ = causal_conv1d(lru_in, p["conv"])
        h = rglru_scan(p, u)
    elif x.shape[1] == 1:
        u, conv_state = causal_conv1d(lru_in, p["conv"], cache["conv"])
        h_t, h_f32 = rglru_step(p, u[:, 0], cache["h"])
        h = h_t[:, None, :]
        if step_active is not None:
            conv_state = torch.where(step_active, conv_state, cache["conv"])
            h_f32 = torch.where(step_active, h_f32, cache["h"])
        cache["conv"].copy_(conv_state)
        cache["h"].copy_(h_f32)
    else:
        # prefill with state capture
        u, conv_state = causal_conv1d(lru_in, p["conv"], cache["conv"])
        a, x_in = _rglru_gates(p, u)
        h_all = _scan(a, x_in, cache["h"])
        h = h_all.to(dt)
        cache["conv"].copy_(conv_state)
        cache["h"].copy_(h_all[:, -1])
    return (h * gate) @ p["w_out"].to(dt)


def init_rglru_cache(cfg: ArchConfig, batch: int, lead=(), device=None):
    """Zeroed state: ``conv`` in the compute dtype, ``h`` in fp32.
    ``lead`` prepends stacking dims (the scanned body's layers axis)."""
    lru = cfg.lru_width or cfg.d_model
    lead = tuple(lead)
    return {"conv": torch.zeros(lead + (batch, cfg.conv1d_width - 1, lru),
                                dtype=compute_dtype(cfg), device=device),
            "h": torch.zeros(lead + (batch, lru), dtype=torch.float32,
                             device=device)}
