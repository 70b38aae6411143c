"""Plain reference of a decoder with a routed-expert FFN (the ``moe``
family: granite-moe-1b-a400m).

The dense reference with its FFN replaced: a router product and a softmax
in fp32, the ``top_k`` experts of each token with their gates renormalised
to sum to 1, each expert a SwiGLU FFN, the outputs summed by gate.

The configuration keeps a capacity per sequence where the published
layer is dropless, and the reference keeps the same rule (``PERF.md``
records the departure).  A prompt is routed as the program's prefill saw
it: ``capacity = max(8, 8 * ceil(int(C * top_k * capacity_factor / E) /
8))`` for a prefill over ``C`` positions (the bucket its admission round
padded to, or its own length), and a token's choices, taken in order of
(position, rank), keep a place in an expert only while that expert has
fewer than ``capacity`` earlier ones; padding past the prompt comes later
and never takes a place.  A decoded token is routed alone (a step of one
position: capacity 8 for at most one choice an expert), so it never
drops.  Shared experts, where a configuration has them, always run.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference.dense import Dense


def capacity(c: int, top_k: int, factor: float, n_experts: int) -> int:
    """Places an expert has in a prefill of ``c`` positions."""
    n = int(c * top_k * factor / n_experts)
    return max(8, 8 * math.ceil(n / 8))


class MoE(Dense):
    def ffn(self, p, h: torch.Tensor, ctx) -> torch.Tensor:
        mo = self.arch["moe"]
        e_n, k = mo["n_routed"], mo["top_k"]
        m = p["moe"]
        t = h.shape[0]
        probs = torch.softmax(self.mm(h, m["router"]), -1)
        gates, ids = torch.topk(probs, k, dim=-1)              # (T, k)
        gates = gates / gates.sum(-1, keepdim=True)
        keep = torch.ones((t, k), dtype=torch.bool, device=h.device)
        prompt_len = ctx["prompt_len"] if ctx else 0
        if prompt_len:
            cap = capacity(ctx["capacity_len"], k,
                           float(mo.get("capacity_factor", 1.25)), e_n)
            flat = ids[:prompt_len].reshape(-1)                 # (L * k,)
            onehot = torch.nn.functional.one_hot(flat, e_n)
            before = (onehot.cumsum(0) - onehot).gather(1, flat[:, None])
            keep[:prompt_len] = (before[:, 0] < cap).view(prompt_len, k)
        weight = torch.where(keep, gates, torch.zeros_like(gates))
        out = torch.zeros_like(h)
        for e in range(e_n):
            rows, slot = torch.nonzero(ids == e, as_tuple=True)
            if rows.numel() == 0:
                continue
            x = h[rows]
            y = self.mm(torch.nn.functional.silu(self.mm(x, m["w_gate"][e]))
                        * self.mm(x, m["w_up"][e]), m["w_down"][e])
            out.index_add_(0, rows, y * weight[rows, slot][:, None])
        if mo.get("n_shared"):
            out = out + Dense.ffn(self, {"ffn": m["shared"]}, h, ctx)
        return out


#: the family's reference class, which the benchmark finds by this name
MODEL = MoE
