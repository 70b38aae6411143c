"""The yardstick's arithmetic: the card's peaks, and the operations and
bytes that served traffic needs, counted from the configuration's sizes
and the requests' real lengths (padding and dead rows never count).

Peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity):
989 TFLOP/s in bf16, 3.35 TB/s of HBM3, at the 700 W limit.
"""

from __future__ import annotations

from typing import Iterable, Sequence

#: peak bf16 dense tensor-core rate of one H100 SXM, FLOP/s
PEAK_FLOPS = 989e12
#: peak HBM3 bandwidth of one H100 SXM, bytes/s
PEAK_BYTES = 3.35e12
#: bytes of one element in the compute dtypes the configurations state
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def _arch(cfg: dict) -> dict:
    return cfg["arch"]


def head_dim(cfg: dict) -> int:
    a = _arch(cfg)
    return a.get("d_head") or a["d_model"] // a["n_heads"]


def active_params(cfg: dict) -> int:
    """Parameters one token's decode multiplies by, outside the embedding
    lookup and with the output head: per layer the attention projections
    (and their biases), the dense FFN or the router and ``top_k`` experts;
    then the head (``d_model x vocab``).  Norm scales are left out (no
    multiply-add)."""
    a = _arch(cfg)
    d, hq, hkv, dh = a["d_model"], a["n_heads"], a["n_kv_heads"], \
        head_dim(cfg)
    attn = d * hq * dh + 2 * d * hkv * dh + hq * dh * d
    if a.get("qkv_bias"):
        attn += hq * dh + 2 * hkv * dh
    moe = a.get("moe")
    gated = a.get("act", "swiglu") in ("swiglu", "geglu")
    if moe:
        per_expert = (3 if gated else 2) * d * moe["d_expert"]
        ffn = d * moe["n_routed"] + moe["top_k"] * per_expert \
            + (3 if gated else 2) * d * moe["d_expert"] * moe.get(
                "n_shared", 0)
    else:
        ffn = (3 if gated else 2) * d * a["d_ff"]
    return a["n_layers"] * (attn + ffn) + d * a["vocab"]


def decode_flops(cfg: dict, contexts: Iterable[int]) -> float:
    """Model FLOPs of decoding one token in each row whose context (keys
    attended, the new one included) is in ``contexts``: ``2 x`` the active
    parameters, plus attention's ``4 x context x heads x d_head`` in every
    layer."""
    a = _arch(cfg)
    per_token = 2.0 * active_params(cfg)
    per_key = 4.0 * a["n_heads"] * head_dim(cfg) * a["n_layers"]
    n = 0
    keys = 0
    for c in contexts:
        n += 1
        keys += c
    return n * per_token + per_key * keys


def decode_attn_call(cfg: dict, contexts: Sequence[int]):
    """-> (ops, bytes) of one layer's decode attention over rows of these
    contexts: QK and PV (``4 x context x d_head`` a query head), and K and
    V read once (``2 x context x kv_heads x d_head`` elements) with each
    row's query read and output written."""
    a = _arch(cfg)
    dh, hq, hkv = head_dim(cfg), a["n_heads"], a["n_kv_heads"]
    eb = DTYPE_BYTES[cfg["dtype"]]
    keys = sum(contexts)
    ops = 4.0 * keys * hq * dh
    nbytes = eb * (2.0 * keys * hkv * dh + 2.0 * len(contexts) * hq * dh)
    return ops, nbytes


def flash_call(cfg: dict, lengths: Sequence[int]):
    """-> (ops, bytes) of one layer's causal prefill attention over rows
    of these real prompt lengths: ``4 x d_head`` per (query, key) pair a
    query head, ``L (L + 1) / 2`` pairs a row; q, k and v read once and
    the output written once."""
    a = _arch(cfg)
    dh, hq, hkv = head_dim(cfg), a["n_heads"], a["n_kv_heads"]
    eb = DTYPE_BYTES[cfg["dtype"]]
    pairs = sum(n * (n + 1) // 2 for n in lengths)
    toks = sum(lengths)
    ops = 4.0 * pairs * hq * dh
    nbytes = eb * toks * (2.0 * hq * dh + 2.0 * hkv * dh)
    return ops, nbytes


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the compute and
    the memory bound."""
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def layers(cfg: dict) -> int:
    return _arch(cfg)["n_layers"]
