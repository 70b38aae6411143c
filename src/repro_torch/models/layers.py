"""Shared layers: norms, rotary embeddings, FFN, embeddings.

Each function mirrors its counterpart in ``repro.models.layers`` op for
op: fp32 row statistics for the norms, fp32 rotary angles computed as
fp32 positions times fp32 frequencies, and every weight cast to the
activation dtype before use (a no-op when the model already holds a
compute-dtype copy).  The norm is a ``torch.autograd.Function`` with the
reference's custom VJP (``_norm_core``): its backward keeps only x and
the (B, S, 1) fp32 row statistics.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.params import ParamSpec

def no_sharding(a, *logical_axes):
    """The default ``shard_fn`` hook: the tensor itself (no sharding
    constraint; ``launch.sharding.make_shard_fn`` builds the other)."""
    return a


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------

NORM_EPS = 1e-6


def norm_specs(cfg: ArchConfig, d: Optional[int] = None):
    d = d or cfg.d_model
    if cfg.norm == "rmsnorm":
        return {"scale": ParamSpec((d,), ("embed",), init="ones")}
    return {"scale": ParamSpec((d,), ("embed",), init="ones"),
            "bias": ParamSpec((d,), ("embed",), init="zeros")}


def _row_stats(x, kind):
    xf = x.float()
    if kind == "rmsnorm":
        var = xf.square().mean(-1, keepdim=True)
        return None, torch.rsqrt(var + NORM_EPS)
    mean = xf.mean(-1, keepdim=True)
    var = xf.square().mean(-1, keepdim=True) - mean.square()
    return mean, torch.rsqrt(var + NORM_EPS)


def _norm_forward(x, scale, bias, kind, mean, inv):
    dt = x.dtype
    if kind == "rmsnorm":
        return x * inv.to(dt) * scale.to(dt)
    xhat = (x - mean.to(dt)) * inv.to(dt)
    return xhat * scale.to(dt) + bias.to(dt)


class _Norm(torch.autograd.Function):
    """rmsnorm / layernorm with the reference's backward
    (``repro.models.layers._norm_bwd``), in terms of x (x.dtype) and the
    fp32 row statistics only:

      rms:  dx = inv*g - x * inv^3/N * sum(g*x);        g = dy*scale
      ln :  dx = inv*(g - mean(g) - xhat*mean(g*xhat))
    """

    @staticmethod
    def forward(ctx, x, scale, bias, kind):
        mean, inv = _row_stats(x, kind)
        ctx.kind = kind
        ctx.save_for_backward(x, scale, bias, mean, inv)
        return _norm_forward(x, scale, bias, kind, mean, inv)

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias, mean, inv = ctx.saved_tensors
        n = x.shape[-1]
        lead = tuple(range(dy.dim() - 1))
        g = dy * scale.to(dy.dtype)
        if ctx.kind == "rmsnorm":
            s = (g * x).float().sum(-1, keepdim=True)
            coef = (inv ** 3 / n) * s
            dx = (g * inv.to(g.dtype) - x * coef.to(g.dtype)).to(x.dtype)
            xhat_scaled = x * inv.to(x.dtype)
            dscale = (dy * xhat_scaled).float().sum(lead).to(scale.dtype)
            return dx, dscale, None, None
        xhat = (x - mean.to(x.dtype)) * inv.to(x.dtype)
        gm = g.float().mean(-1, keepdim=True)
        gxm = (g * xhat).float().mean(-1, keepdim=True)
        dx = ((g - gm.to(g.dtype) - xhat * gxm.to(g.dtype))
              * inv.to(g.dtype)).to(x.dtype)
        dscale = (dy * xhat).float().sum(lead).to(scale.dtype)
        dbias = dy.float().sum(lead).to(scale.dtype)
        return dx, dscale, dbias, None


def apply_norm(p, x, kind: str):
    """rmsnorm / layernorm with fp32 row statistics, applied in x.dtype.
    Differentiable through :class:`_Norm`; with grad mode off (serving)
    the same forward runs and saves nothing."""
    return _Norm.apply(x, p["scale"], p.get("bias"), kind)


def rms_group_norm(x, scale, n_groups: int):
    """Head-wise group RMS norm (the xLSTM cells): statistics, the
    normalised values and the scale in fp32, cast back to x.dtype."""
    b, s, d = x.shape
    xf = x.float().reshape(b, s, n_groups, d // n_groups)
    var = xf.square().mean(-1, keepdim=True)
    out = (xf * torch.rsqrt(var + NORM_EPS)).reshape(b, s, d)
    return (out * scale.float()).to(x.dtype)


# --------------------------------------------------------------------------
# Rotary position embeddings (RoPE / partial RoPE / M-RoPE)
# --------------------------------------------------------------------------

def _freqs(theta: float, idx: torch.Tensor, dim: int) -> torch.Tensor:
    """theta ** (-idx / dim) in fp32 (idx an fp32 arange).  The base is
    filled on the device: a host-to-device copy would sync the stream in
    every layer of every decode step."""
    return torch.pow(torch.full((), theta, dtype=torch.float32,
                                device=idx.device), -idx / dim)


def _rope_angles(positions, dim: int, theta: float):
    """positions (...,) -> cos/sin (..., dim/2), fp32."""
    idx = torch.arange(0, dim, 2, dtype=torch.float32,
                       device=positions.device)
    ang = positions[..., None].float() * _freqs(theta, idx, dim)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, positions, cfg: ArchConfig):
    """x: (B, S, H, Dh); positions: (B, S) or (B, S, 3) for M-RoPE."""
    dh = x.shape[-1]
    rot = int(dh * cfg.rope_fraction)
    rot -= rot % 2
    x_rot, x_pass = x[..., :rot], x[..., rot:]

    if cfg.pos == "mrope":
        # the rotary half-dims split into (t, h, w) sections, each rotated
        # by its own position stream
        sections = cfg.mrope_sections or (rot // 2,)
        assert sum(sections) == rot // 2, (sections, rot)
        cos_parts, sin_parts = [], []
        for si, sec in enumerate(sections):
            pos = positions[..., si]
            idx = torch.arange(sum(sections[:si]) * 2,
                               sum(sections[:si + 1]) * 2, 2,
                               device=x.device).float()
            ang = pos[..., None].float() * _freqs(cfg.rope_theta, idx, rot)
            cos_parts.append(torch.cos(ang))
            sin_parts.append(torch.sin(ang))
        cos = torch.cat(cos_parts, -1)[:, :, None, :]
        sin = torch.cat(sin_parts, -1)[:, :, None, :]
    else:
        cos, sin = _rope_angles(positions, rot, cfg.rope_theta)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]

    x1, x2 = x_rot.float().chunk(2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                        dim=-1).to(x.dtype)
    return torch.cat([rotated, x_pass], dim=-1) if rot < dh else rotated


# --------------------------------------------------------------------------
# FFN (dense)
# --------------------------------------------------------------------------

def ffn_specs(cfg: ArchConfig, d_ff: Optional[int] = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act in ("swiglu", "geglu"):
        return {"w_gate": ParamSpec((d, f), ("embed", "mlp")),
                "w_up": ParamSpec((d, f), ("embed", "mlp")),
                "w_down": ParamSpec((f, d), ("mlp", "embed"))}
    return {"w_up": ParamSpec((d, f), ("embed", "mlp")),
            "w_down": ParamSpec((f, d), ("mlp", "embed"))}


def apply_ffn(p, x, act: str):
    dt = x.dtype
    if act in ("swiglu", "geglu"):
        gate = x @ p["w_gate"].to(dt)
        up = x @ p["w_up"].to(dt)
        h = (F.silu(gate) if act == "swiglu"
             else F.gelu(gate, approximate="tanh")) * up
    else:
        h = F.gelu(x @ p["w_up"].to(dt), approximate="tanh")
    return h @ p["w_down"].to(dt)


# --------------------------------------------------------------------------
# Embeddings / LM head
# --------------------------------------------------------------------------

def embed_specs(cfg: ArchConfig):
    out = {"tok": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                            init="normal", scale=0.02)}
    if not cfg.tie_embeddings:
        out["head"] = ParamSpec((cfg.d_model, cfg.vocab),
                                ("embed", "vocab"))
    return out


def compute_dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def embed_tokens(p, tokens, cfg: ArchConfig):
    return p["tok"][tokens].to(compute_dtype(cfg))


def head_matrix(p, cfg: ArchConfig):
    """(d_model, vocab) projection, tied or untied."""
    if cfg.tie_embeddings:
        return p["tok"].T
    return p["head"]
