"""Plain PyTorch version of the RG-LRU scan kernel.

The same function as ``csrc/rglru_scan.cu``: ``h_t = a_t * h_{t-1} + x_t``
over axis 1 from ``h_0 = 0``, an fp32 carry stepped sequentially, each
step one product and one sum rounded separately, as the kernel does.
The CPU tests run it, and ``chip_smoke.py`` holds the kernel against it
on the card.  Nothing on the card's main path calls it.
"""

from __future__ import annotations

import torch


def rglru_scan_ref(a, x):
    """a, x: (B, T, C), float32 or bfloat16 -> h: (B, T, C) in x's
    dtype."""
    af, xf = a.float(), x.float()
    out = torch.empty_like(xf)
    h = torch.zeros_like(xf[:, 0])
    for t in range(xf.shape[1]):
        h = af[:, t] * h + xf[:, t]
        out[:, t] = h
    return out.to(x.dtype)
