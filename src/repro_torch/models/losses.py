"""Chunked softmax cross-entropy: the full (B, S, vocab) logits tensor is
never kept for the backward.  The head product and the logsumexp run per
sequence chunk under ``torch.utils.checkpoint``, so only the chunk's
inputs are saved and the backward recomputes its logits (the port of
``repro.models.losses``, whose chunks run under ``jax.checkpoint``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _chunk_loss(h_chunk, labels_chunk, mask_chunk, head):
    """h: (B, C, d); labels: (B, C); head: (d, V) -> (sum nll, sum mask)."""
    logits = (h_chunk @ head.to(h_chunk.dtype)).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels_chunk[..., None].long())[..., 0]
    nll = (lse - gold) * mask_chunk
    return nll.sum(), mask_chunk.sum()


def chunked_softmax_xent(hidden, head, labels, *, mask=None,
                         chunk: int = 512):
    """-> (mean_nll, n_tokens), both fp32 0-d.  hidden: (B, S, d); head:
    (d, V); labels: (B, S) int; mask: (B, S) float or None (all valid).
    When ``chunk`` does not divide S the sequence is padded with masked
    positions, as the reference does."""
    b, s, d = hidden.shape
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    chunk = min(chunk, s)
    if s % chunk:
        pad = chunk - s % chunk
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
        s += pad
    differentiable = torch.is_grad_enabled() and (
        hidden.requires_grad or head.requires_grad)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s, chunk):
        args = (hidden[:, c0:c0 + chunk], labels[:, c0:c0 + chunk],
                mask[:, c0:c0 + chunk], head)
        if differentiable:
            l, n = checkpoint(_chunk_loss, *args, use_reentrant=False)
        else:
            l, n = _chunk_loss(*args)
        total = total + l
        count = count + n
    return total / torch.clamp(count, min=1.0), count
