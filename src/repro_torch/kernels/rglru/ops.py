"""RG-LRU scan kernel wrapper.

``rglru_scan(a, x)`` keeps the reference's name and its (B, T, C)
layout (``repro.kernels.rglru.ops``).  For a CUDA tensor it builds (at
first use) and launches the hand-written CUDA kernel on the current
stream, or raises: there is no fallback.  For a CPU tensor it runs the
plain PyTorch version (``ref.py``).  Launches are counted in
``LAUNCHES``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rglru.ref import rglru_scan_ref

#: kernel launches since the last ``reset_launch_counts()``; plain-version
#: calls on CPU tensors do not count
LAUNCHES = {"rglru_scan": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def rglru_scan(a, x):
    """a, x: (B, T, C) -> h with ``h_t = a_t * h_{t-1} + x_t``, ``h_0 = 0``,
    an fp32 carry, in x's dtype.  Any strides and any T; a and x may
    differ in dtype (float32 or bfloat16)."""
    if a.device.type == "cpu" and x.device.type == "cpu":
        return rglru_scan_ref(a, x)
    if a.device.type != "cuda" or x.device != a.device:
        raise RuntimeError(f"rglru_scan: a on {a.device}, x on {x.device}: "
                           f"the kernel needs both on one CUDA device; the "
                           f"plain version serves only CPU tensors")
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
    out = torch.empty((b, t, c), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):   # the launch uses the current device
        code = lib.rglru_scan(
            a.data_ptr(), x.data_ptr(), out.data_ptr(), b, t, c,
            *a.stride(), *x.stride(), *out.stride(), _DTYPES[a.dtype],
            _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, "rglru_scan", code)
    LAUNCHES["rglru_scan"] += 1
    return out
