"""Plain reference of a dense decoder (the ``dense`` family: qwen2-0.5b).

Written from the published architecture, in fp32 with TF32 off, one
sequence at a time, with no cache, no kernel and no batching: token
table, then per layer RMSNorm, GQA self-attention with rotary positions
(rotate-half, ``theta ** (-2i / d_head)``) and optional q/k/v biases, a
residual add, RMSNorm, a SwiGLU FFN and a residual add; a final RMSNorm
and the tied head.  It reads the weights in the tree layout the
benchmark draws them in, and imports nothing of the program.

``quant="fp8"`` is the control: every weight matrix and every input of a
weight product rounded through float8 e4m3 (a per-tensor scale, amax to
448), the rest as above.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import torch

#: float8 e4m3's largest finite value
FP8_MAX = 448.0
#: queries whose scores one attention block holds at a time
Q_BLOCK = 1024
#: positions whose logits one head product holds at a time
HEAD_BLOCK = 512


def strict_fp32() -> None:
    """fp32 products in fp32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded through float8 e4m3 with one scale for the tensor."""
    amax = x.abs().amax().clamp(min=1e-30)
    s = amax / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class Dense:
    """The reference model of one configuration (its ``arch`` sizes) over
    one weight tree."""

    def __init__(self, cfg: dict, weights, quant: Optional[str] = None):
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown precision {quant!r}")
        self.arch = cfg["arch"]
        self.eps = float(cfg["norm_eps"])
        self.w = weights
        self.quant = quant
        a = self.arch
        self.d = a["d_model"]
        self.hq, self.hkv = a["n_heads"], a["n_kv_heads"]
        self.dh = a.get("d_head") or self.d // self.hq
        self.theta = float(a["rope_theta"])
        dec = weights["decoder"]
        self.prefix, self.period = dec["prefix"], dec["body"]

    # ----- pieces ---------------------------------------------------------
    def f32(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(torch.float32)

    def weight(self, t: torch.Tensor) -> torch.Tensor:
        w = self.f32(t)
        return fp8_round(w) if self.quant == "fp8" else w

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x @ w`` for a weight ``w``: both through fp8 in the control."""
        if self.quant == "fp8":
            x = fp8_round(x)
        return x @ self.weight(w)

    def layer(self, i: int):
        """Layer ``i``'s weights: the unrolled prefix, then the stacked
        periods."""
        if i < len(self.prefix):
            return self.prefix[i]
        j = i - len(self.prefix)
        block = self.period[j % len(self.period)]
        k = j // len(self.period)
        return _index(block, k)

    def rmsnorm(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps)
        return x * inv * self.f32(scale)

    def rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """x (T, H, dh), positions (T,): rotate-half rotary embedding, the
        angles in fp64."""
        half = self.dh // 2
        inv = self.theta ** (-torch.arange(0, self.dh, 2, dtype=torch.float64,
                                           device=x.device) / self.dh)
        ang = pos.to(torch.float64)[:, None] * inv[None, :]
        cos = torch.cos(ang).to(torch.float32)[:, None, :]
        sin = torch.sin(ang).to(torch.float32)[:, None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    def attention(self, p, h: torch.Tensor, pos: torch.Tensor):
        t = h.shape[0]
        d, hq, hkv, dh = self.d, self.hq, self.hkv, self.dh
        q = self.mm(h, p["wq"].reshape(d, hq * dh)).view(t, hq, dh)
        k = self.mm(h, p["wk"].reshape(d, hkv * dh)).view(t, hkv, dh)
        v = self.mm(h, p["wv"].reshape(d, hkv * dh)).view(t, hkv, dh)
        if "bq" in p:
            q = q + self.f32(p["bq"])
            k = k + self.f32(p["bk"])
            v = v + self.f32(p["bv"])
        q, k = self.rope(q, pos), self.rope(k, pos)
        g = hq // hkv
        kh = k.permute(1, 0, 2)                               # (hkv, T, dh)
        vh = v.permute(1, 0, 2)
        out = torch.empty((t, hq, dh), dtype=torch.float32, device=h.device)
        for q0 in range(0, t, Q_BLOCK):
            q1 = min(t, q0 + Q_BLOCK)
            qb = q[q0:q1].view(q1 - q0, hkv, g, dh).permute(1, 2, 0, 3)
            s = torch.einsum("hgqd,hkd->hgqk", qb, kh[:, :q1]) * dh ** -0.5
            qi = torch.arange(q0, q1, device=h.device)[:, None]
            ki = torch.arange(q1, device=h.device)[None, :]
            s = s.masked_fill(ki > qi, float("-inf"))
            o = torch.einsum("hgqk,hkd->hgqd", torch.softmax(s, -1),
                             vh[:, :q1])
            out[q0:q1] = o.permute(2, 0, 1, 3).reshape(q1 - q0, hq, dh)
        return self.mm(out.reshape(t, hq * dh), p["wo"].reshape(hq * dh, d))

    def ffn(self, p, h: torch.Tensor, ctx) -> torch.Tensor:
        f = p["ffn"]
        gate = self.mm(h, f["w_gate"])
        up = self.mm(h, f["w_up"])
        return self.mm(torch.nn.functional.silu(gate) * up, f["w_down"])

    # ----- the model ------------------------------------------------------
    def hidden(self, tokens: torch.Tensor, ctx=None) -> torch.Tensor:
        """Final-norm hidden states (T, d) of one sequence at positions
        ``0..T-1``.  ``ctx`` is what a family's FFN needs to know of how
        the program saw the sequence (the MoE's capacity)."""
        tokens = tokens.long()
        pos = torch.arange(tokens.shape[0], device=tokens.device)
        x = self.f32(self.w["embed"]["tok"][tokens])
        for i in range(self.arch["n_layers"]):
            p = self.layer(i)
            x = x + self.attention(p["attn"],
                                   self.rmsnorm(x, p["norm1"]["scale"]), pos)
            x = x + self.ffn(p, self.rmsnorm(x, p["norm2"]["scale"]), ctx)
        return self.rmsnorm(x, self.w["final_norm"]["scale"])

    def head(self) -> torch.Tensor:
        e = self.w["embed"]
        return e["tok"].T if self.arch.get("tie_embeddings") else e["head"]

    def logits(self, tokens: torch.Tensor, start: int,
               ctx=None) -> Iterator[Tuple[int, torch.Tensor]]:
        """The fp32 logits at positions ``start..T-1``, in blocks: ->
        ``(first position, (n, vocab))`` pairs."""
        h = self.hidden(tokens, ctx)
        head = self.head()
        for p0 in range(start, h.shape[0], HEAD_BLOCK):
            p1 = min(h.shape[0], p0 + HEAD_BLOCK)
            yield p0, self.mm(h[p0:p1], head)


def _index(tree, k: int):
    if isinstance(tree, dict):
        return {name: _index(v, k) for name, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_index(v, k) for v in tree)
    return tree[k]


#: the family's reference class, which the benchmark finds by this name
MODEL = Dense
