"""RG-LRU scan kernel wrapper.

``rglru_scan(a, x)`` keeps the reference's name and its (B, T, C)
layout (``repro.kernels.rglru.ops``).  For a CUDA tensor it builds (at
first use) and launches the hand-written CUDA kernel on the current
stream, or raises: there is no fallback.  The kernel is a chunked
two-pass scan: T is cut into chunks by ``scan_chunks``, pass 1 reduces
each chunk to its product of ``a`` and its end state, pass 2 folds the
chunks before each into its carry and walks it.  For a CPU tensor it runs
the plain PyTorch version (``ref.py``), and so for a meta tensor (shapes
with no data: the dry run).  Launches are counted in
``LAUNCHES``: one per kernel call, though a call is two CUDA launches;
``SHAPE_LAUNCHES`` counts the same launches by the signature each ran
at.

Under grad mode, with an input that requires grad, the scan runs as an
``autograd.Function`` (``_ScanFn``): the gradient of ``h_t = a_t
h_{t-1} + x_t`` is the same recurrence in reverse time, ``d_t = g_t +
a_{t+1} d_{t+1}``, with ``dx = d`` and ``da_t = d_t h_{t-1}`` (``h_0 =
0``), so the backward is one more call of the same kernel (counted in
``LAUNCHES`` like any other, and in ``BACKWARD_LAUNCHES`` too) on
time-reversed copies of ``a`` (shifted by one step) and of the output
gradient.  On CPU tensors both directions run ``ref.py``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.rglru.ref import rglru_scan_ref

#: kernel launches since the last ``reset_launch_counts()``; plain-version
#: calls on CPU and meta tensors do not count
LAUNCHES = {"rglru_scan": 0}
#: of those, the launches made by ``scan_backward``
BACKWARD_LAUNCHES = {"scan_backward": 0}
#: the same launches keyed by ("rglru_scan", dtype, (B, T, C)): dtype is
#: a's, or "a's/x's" where they differ
SHAPE_LAUNCHES: Dict[Tuple[str, str, tuple], int] = {}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the H100's SMs, and the blocks per SM the chunk plan aims for
N_SMS = 132
BLOCKS_PER_SM = 8
#: channels a block of the kernel owns, and the steps each thread loads
#: ahead of its carry (``kThreads``, ``kUnroll`` in ``csrc/rglru_scan.cu``)
SCAN_THREADS = 128
SCAN_UNROLL = 16
#: the shortest chunk, and the most chunks, so that pass 2's fold of the
#: chunks before its own stays short
MIN_CHUNK = 16
MAX_CHUNKS = 64


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, BACKWARD_LAUNCHES):
        for name in counts:
            counts[name] = 0
    SHAPE_LAUNCHES.clear()


def scan_chunks(b: int, t: int, c: int):
    """-> (chunk_len, n_chunks) of a scan over (B, T, C): T cut into
    ``n_chunks`` chunks of ``chunk_len`` steps (the last may be shorter),
    enough that the grid of (channel tiles of ``SCAN_THREADS``) x n_chunks
    x B holds about ``BLOCKS_PER_SM`` blocks per SM.  ``chunk_len`` is at
    least ``MIN_CHUNK`` and a multiple of ``SCAN_UNROLL``; ``n_chunks`` at
    most ``MAX_CHUNKS``.  The shape alone decides, so a launch needs no
    host sync and a CUDA graph can capture it.  One chunk (short T, or a
    grid full without chunks) runs pass 2 alone from a zero carry."""
    tiles = -(-c // SCAN_THREADS) * b
    want = min(MAX_CHUNKS, -(-N_SMS * BLOCKS_PER_SM // tiles))
    if want == 1:
        return max(t, MIN_CHUNK), 1
    chunk = max(MIN_CHUNK, t // want // SCAN_UNROLL * SCAN_UNROLL)
    if -(-t // chunk) > MAX_CHUNKS:
        chunk = -(-t // (MAX_CHUNKS * SCAN_UNROLL)) * SCAN_UNROLL
    return chunk, -(-t // chunk)


def rglru_scan(a, x):
    """a, x: (B, T, C) -> h with ``h_t = a_t * h_{t-1} + x_t``, ``h_0 = 0``,
    an fp32 carry, in x's dtype.  Any strides and any T; a and x may
    differ in dtype (float32 or bfloat16).  Differentiable in a and x."""
    if torch.is_grad_enabled() and (a.requires_grad or x.requires_grad):
        return _ScanFn.apply(a, x)
    return _scan(a, x)


class _ScanFn(torch.autograd.Function):
    """The scan with its reverse-time backward (module docstring).  Saves
    a and h; the backward's recurrence runs in fp32 (its ``g`` cast up),
    dx comes back in x's dtype and da in a's."""

    @staticmethod
    def forward(ctx, a, x):
        h = _scan(a, x)
        ctx.x_dtype = x.dtype
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        return scan_backward(a, h, g, ctx.x_dtype)


def scan_backward(a, h, g, x_dtype):
    """The scan's gradients: -> (da in a's dtype, dx in ``x_dtype``) of
    ``h = rglru_scan(a, x)`` under the output gradient ``g``.  One kernel
    call: ``d_t = g_t + a_{t+1} d_{t+1}`` runs forward over the reversed
    time axis, in fp32."""
    # reversed in time, step t' = T-1-t carries a_{t+1}: the first
    # reversed step (t = T-1) has no successor, so its factor is 0
    a_rev = F.pad(a.flip(1)[:, :-1], (0, 0, 1, 0))
    d = _scan(a_rev, g.float().flip(1), backward=True).flip(1)
    h_prev = F.pad(h[:, :-1].float(), (0, 0, 1, 0))
    return (d * h_prev).to(a.dtype), d.to(x_dtype)


def _scan(a, x, backward: bool = False):
    """One call of the kernel (CUDA tensors) or of its plain version (CPU
    or meta tensors); ``backward`` marks ``scan_backward``'s call for its count."""
    if a.device.type == x.device.type and a.device.type in ("cpu", "meta"):
        return rglru_scan_ref(a, x)
    if a.device.type != "cuda" or x.device != a.device:
        raise RuntimeError(f"rglru_scan: a on {a.device}, x on {x.device}: "
                           f"the kernel needs both on one CUDA device; the "
                           f"plain version serves only CPU and meta "
                           f"tensors")
    if a.dtype not in _DTYPES or x.dtype not in _DTYPES:
        raise TypeError(f"rglru_scan: dtypes {a.dtype}, {x.dtype} not "
                        f"supported (float32, bfloat16)")
    if a.dim() != 3 or a.shape != x.shape:
        raise ValueError(f"rglru_scan: a {tuple(a.shape)} and x "
                         f"{tuple(x.shape)} must be one (B, T, C) shape")
    b, t, c = x.shape
    if not (0 < b <= 65535 and t > 0 and c > 0):
        raise ValueError(f"rglru_scan: shape {tuple(x.shape)} needs "
                         f"0 < B <= 65535, T > 0, C > 0")
    lib = build.load("rglru_scan")
    chunk, n_chunks = scan_chunks(b, t, c)
    out = torch.empty((b, t, c), dtype=x.dtype, device=x.device)
    # pass 1's products and end states of every chunk but the last
    scratch = torch.empty((2, b, n_chunks - 1, c), dtype=torch.float32,
                          device=x.device)
    with torch.cuda.device(x.device):   # the launch uses the current device
        code = lib.rglru_scan(
            a.data_ptr(), x.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            b, t, c, chunk, n_chunks, *a.stride(), *x.stride(),
            *out.stride(), _DTYPES[a.dtype], _DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, "rglru_scan", code)
    LAUNCHES["rglru_scan"] += 1
    dtypes = [str(v.dtype).removeprefix("torch.") for v in (a, x)]
    key = ("rglru_scan", dtypes[0] if dtypes[0] == dtypes[1]
           else "/".join(dtypes), (b, t, c))
    SHAPE_LAUNCHES[key] = SHAPE_LAUNCHES.get(key, 0) + 1
    if backward:
        BACKWARD_LAUNCHES["scan_backward"] += 1
    return out
