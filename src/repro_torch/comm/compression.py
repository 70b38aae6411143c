"""Gradient compression with error feedback (the port of
``repro.comm.compression``).

Int8 quantization with a per-bucket scale and local error-feedback
residuals (the 1-bit SGD / EF-SGD lineage).  The sum runs in int32 (no
overflow for <= 2^23 participants) and is dequantized by the shared
scale; the residual keeps each participant's quantization error local.
The reduce functions (a sum and a max over the participants) are passed
in, as in the reference.
"""

from __future__ import annotations

import dataclasses

import torch


class NoCompressor:
    """Identity compressor (default)."""

    def init_state(self, packed_shapes):
        return ()

    def reduce(self, flat, state, psum_fn):
        return psum_fn(flat), state


@dataclasses.dataclass(frozen=True)
class Int8Compressor:
    """reduce(x) = dequant(psum(quant(x + residual))); the new residual is
    the local quantization error.  The scale is the local absmax, maxed
    over the participants so every one uses the same scale (required for
    an exact integer sum)."""

    bits: int = 8

    def init_state(self, flat_shape_dtypes):
        return [torch.zeros(s, dtype=torch.float32) for s, _ in
                flat_shape_dtypes]

    def reduce(self, flat, residual, psum_fn, pmax_fn):
        x = flat.float() + residual
        qmax = 2.0 ** (self.bits - 1) - 1
        scale = pmax_fn(x.abs().max()) / qmax
        scale = torch.clamp(scale, min=1e-30)
        q = torch.clamp(torch.round(x / scale), -qmax, qmax).to(torch.int8)
        new_residual = x - q.float() * scale
        summed = psum_fn(q.to(torch.int32))
        out = (summed.float() * scale).to(flat.dtype)
        return out, new_residual
