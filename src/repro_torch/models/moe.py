"""Fine-grained mixture-of-experts FFN (DeepSeekMoE / Granite-MoE style),
forward only.

The port of ``repro.models.moe``, row for row.  Shared experts (always
on) run as a dense GLU FFN; routed experts use top-k token-choice routing
with a capacity per batch row and sort-based dispatch: each row's
(token, choice) pairs sort by expert id (stable), the first ``cap`` of
each expert keep a slot of the row's ``(E * cap, d)`` buffer, the rest
drop.  No token pools across rows, so a request's output never depends
on its batch neighbours (continuous batching relies on it).  The
auxiliary load-balance loss ``E * sum_e f_e * p_e`` comes back beside
the output, as in the reference; serving discards it.

Two places differ in mechanism, not in value, so that the card's fp32
tokens equal the CPU's and a CUDA graph's replay equals the eager body:

* the dispatch buffer is written with a plain indexed store (kept slots
  are unique; dropped pairs go to one dump row that is sliced off), where
  the reference scatter-added with ``mode="drop"``;
* the combine gathers each token's k contributions back to ``(b, s, k)``
  and sums them in the reference's scatter order (slot order: expert id
  ascending), one add at a time in the compute dtype, where an
  ``index_add_`` on the card would accumulate in no fixed order.

Every shape follows from ``s``, ``E``, ``cap`` and ``top_k``, and no op
reads a value back to the host, so a decode step captures into a graph.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.models.layers import apply_ffn, ffn_specs, no_sharding
from repro_torch.models.params import ParamSpec


def moe_specs(cfg: ArchConfig):
    mo = cfg.moe
    d, fe = cfg.d_model, mo.d_expert
    specs = {
        "router": ParamSpec((d, mo.n_routed), ("embed", "expert"),
                            init="normal", scale=0.02),
        "w_gate": ParamSpec((mo.n_routed, d, fe), ("expert", "embed", "mlp")),
        "w_up": ParamSpec((mo.n_routed, d, fe), ("expert", "embed", "mlp")),
        "w_down": ParamSpec((mo.n_routed, fe, d), ("expert", "mlp", "embed")),
    }
    if mo.n_shared:
        specs["shared"] = ffn_specs(cfg, d_ff=mo.n_shared * fe)
    return specs


def _capacity(n_tokens: int, mo: MoEConfig) -> int:
    c = int(n_tokens * mo.top_k * mo.capacity_factor / mo.n_routed)
    return max(8, -(-c // 8) * 8)   # round up to 8


def _route(p, x, mo: MoEConfig):
    """-> (probs (..., E) fp32, gates (..., k) renormalised, expert ids
    (..., k)); the router's product in x's dtype, softmax in fp32."""
    logits = (x @ p["router"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, mo.top_k, dim=-1)
    return probs, gate_vals / gate_vals.sum(-1, keepdim=True), expert_idx


def _aux_loss(probs, expert_idx, mo: MoEConfig, n_tokens: int):
    """E * sum_e f_e * p_e; counts compared against every expert id (no
    scatter, no data-dependent shape)."""
    e = mo.n_routed
    frac_prob = probs.reshape(-1, e).mean(0)
    ids = torch.arange(e, device=probs.device)
    counts = (expert_idx.reshape(-1, 1) == ids).float().sum(0)
    frac_tokens = counts / (n_tokens * mo.top_k)
    return e * (frac_tokens * frac_prob).sum()


def _experts(p, buf, act: str):
    """(b, E, cap, d) -> (b, E, cap, d): every expert's FFN on its slots
    (batched products over the expert axis)."""
    dt = buf.dtype
    if act in ("swiglu", "geglu"):
        gate = torch.einsum("becd,edf->becf", buf, p["w_gate"].to(dt))
        up = torch.einsum("becd,edf->becf", buf, p["w_up"].to(dt))
        h = (F.silu(gate) if act == "swiglu"
             else F.gelu(gate, approximate="tanh")) * up
    else:
        h = F.gelu(torch.einsum("becd,edf->becf", buf, p["w_up"].to(dt)),
                   approximate="tanh")
    return torch.einsum("becf,efd->becd", h, p["w_down"].to(dt))


def apply_moe(p, x, cfg: ArchConfig, shard_fn=no_sharding):
    """x: (B, S, d) -> (out (B, S, d), aux_loss fp32 0-d).  Capacity is
    per row: ``cap = _capacity(S, moe)``, overflow drops.
    ``shard_fn(tensor, *logical_axes)`` constrains the dispatch buffers
    where the reference's does, at the reference's shapes (identity by
    default)."""
    mo = cfg.moe
    b, s, d = x.shape
    dt = x.dtype
    dev = x.device
    e, k = mo.n_routed, mo.top_k
    n = s * k

    probs, gate_vals, expert_idx = _route(p, x, mo)
    aux = _aux_loss(probs, expert_idx, mo, b * s)

    # --- per-row sort-based dispatch with capacity ---
    cap = _capacity(s, mo)
    flat_expert = expert_idx.reshape(b, n)
    order = torch.argsort(flat_expert, dim=-1, stable=True)      # (b, n)
    sorted_expert = flat_expert.gather(1, order)
    first_of = torch.searchsorted(
        sorted_expert, torch.arange(e, device=dev).expand(b, e).contiguous(),
        side="left")                                             # (b, E)
    pos_in_expert = (torch.arange(n, device=dev)[None]
                     - first_of.gather(1, sorted_expert))
    keep = pos_in_expert < cap
    slot = torch.where(keep, sorted_expert * cap + pos_in_expert, 0)
    tok_of_slot = order // k                                     # (b, n)
    gate_of_slot = gate_vals.reshape(b, n).gather(1, order)

    rows = torch.arange(b, device=dev)[:, None]
    # kept slots are unique; dropped pairs land in the dump row e * cap
    gathered = shard_fn(x.gather(1, tok_of_slot[..., None].expand(b, n, d)),
                        "batch", None, None)
    buf = torch.zeros((b, e * cap + 1, d), dtype=dt, device=dev)
    buf[rows, torch.where(keep, slot, e * cap)] = gathered
    buf = shard_fn(buf[:, :e * cap], "batch", "expert_flat", None)
    buf = shard_fn(buf.reshape(b, e, cap, d), "batch", "expert", None, None)
    expert_out = shard_fn(_experts(p, buf, cfg.act),
                          "batch", "expert", None, None)

    # --- combine: each slot's weighted output, back to token order ---
    flat_out = shard_fn(expert_out.reshape(b, e * cap, d),
                        "batch", "expert_flat", None)
    weight = keep.to(dt)
    slot_vals = shard_fn(
        flat_out.gather(1, slot[..., None].expand(b, n, d))
        * (weight * gate_of_slot.to(dt))[..., None], "batch", None, None)
    # slot j of the row holds flat pair order[j]: invert, then take each
    # token's k pairs in slot order (expert id ascending)
    inv = torch.empty_like(order).scatter_(
        1, order, torch.arange(n, device=dev).expand(b, n).contiguous())
    by_expert = torch.argsort(expert_idx, dim=-1)                # (b, s, k)
    src = inv.reshape(b, s, k).gather(2, by_expert).reshape(b, n)
    contrib = slot_vals.gather(1, src[..., None].expand(b, n, d)).reshape(
        b, s, k, d)
    combined = torch.zeros((b, s, d), dtype=dt, device=dev)
    for i in range(k):
        combined = combined + contrib[:, :, i]
    combined = shard_fn(combined, "batch", None, None)

    if mo.n_shared:
        combined = combined + apply_ffn(p["shared"], x, cfg.act)
    return combined, aux


def apply_moe_reference(p, x, cfg: ArchConfig):
    """Dense oracle: every token through every expert, weighted by the
    (capacity-free) top-k gates.  O(T * E * d * f): tests only."""
    mo = cfg.moe
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    dt = x.dtype
    probs, gate_vals, expert_idx = _route(p, xt, mo)
    dense_gates = torch.zeros_like(probs).scatter(1, expert_idx, gate_vals)

    def one_expert(wg, wu, wd):
        if cfg.act in ("swiglu", "geglu"):
            g = xt @ wg.to(dt)
            h = (F.silu(g) if cfg.act == "swiglu"
                 else F.gelu(g, approximate="tanh")) * (xt @ wu.to(dt))
        else:
            h = F.gelu(xt @ wu.to(dt), approximate="tanh")
        return h @ wd.to(dt)

    outs = torch.stack([one_expert(*w) for w in zip(
        p["w_gate"], p["w_up"], p["w_down"])])                   # (E, T, d)
    combined = torch.einsum("te,etd->td", dense_gates.to(dt), outs)
    if mo.n_shared:
        combined = combined + apply_ffn(p["shared"], xt, cfg.act)
    aux = _aux_loss(probs, expert_idx, mo, b * s)
    return combined.reshape(b, s, d), aux
