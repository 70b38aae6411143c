"""What decides ``correct``: the served tokens against the plain reference.

For a sample of the requests a run finished (drawn from the seed, with
the longest among them), the reference runs once over each prompt and its
served tokens and reads, at every served position, the gap by which the
served token's logit lies below the reference's best there.  Two numbers
of the sample are compared with the cell's limits: the widest gap and the
mean gap over every served position.  Greedy decoding serves the
reference's best up to rounding, so a sound run reads small gaps; a token
altered where it is produced, a step that left its state unchanged or a
row left out reads the gap of an arbitrary token (the widest gap), and a
lower precision moves many tokens a little (the mean gap).

The control puts the reference in the program's place at the precision
below the configuration's (float8 linear layers for bfloat16) and reads,
at the same positions, the gaps of the tokens the control puts first.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch


def sample(done: Sequence[dict], n: int, seed: int,
           n_slots: int = 0) -> List[dict]:
    """``n`` finished requests (all of them where fewer): the one with the
    longest sequence, then one drawn from the seed in each of ``min(n,
    n_slots)`` groups of neighbouring slots (a request's ``slot``; -1 where
    it is not known) that the longest is not in, then others drawn from
    the seed.  So a fault confined to some slots shows in every run whose
    sample reaches them: with one group a slot, in every run."""
    if len(done) <= n:
        return list(done)
    order = sorted(done, key=lambda r: r["rid"])
    longest = max(order, key=lambda r: (r["prompt_len"] + r["n_out"],
                                        -r["rid"]))
    rest = [r for r in order if r is not longest]
    rng = np.random.default_rng([int(seed) % (1 << 63), 2])
    groups = min(n, n_slots)
    members: Dict[int, List[int]] = {}
    for i, r in enumerate(rest):
        if 0 <= r.get("slot", -1) < n_slots:
            members.setdefault(r["slot"] * groups // n_slots, []).append(i)
    taken = set()
    if 0 <= longest.get("slot", -1) < n_slots:
        members.pop(longest["slot"] * groups // n_slots, None)
    for g in sorted(members)[:n - 1]:
        taken.add(members[g][int(rng.integers(len(members[g])))])
    left = [i for i in range(len(rest)) if i not in taken]
    extra = rng.choice(len(left), size=n - 1 - len(taken), replace=False)
    taken.update(left[i] for i in extra)
    return [longest] + [rest[i] for i in sorted(taken)]


def _sequence(prompt: np.ndarray, served: Sequence[int], device):
    """The tokens the reference runs over: the prompt, then every served
    token but the last (each served token is read at the position before
    it)."""
    seq = np.concatenate([np.asarray(prompt, np.int64),
                          np.asarray(served[:-1], np.int64)])
    return torch.as_tensor(seq, device=device)


@torch.no_grad()
def served_gaps(ref, prompt, served: Sequence[int], ctx=None):
    """One request's served tokens against the reference: -> (widest gap,
    sum of gaps, positions), a gap being the reference's best logit minus
    the served token's at that position."""
    seq = _sequence(prompt, served, ref.device)
    want = torch.as_tensor(np.asarray(served, np.int64), device=ref.device)
    return _gaps(ref, seq, len(prompt) - 1, want, ctx)


@torch.no_grad()
def control_gaps(ref, control, prompt, served: Sequence[int], ctx=None):
    """The control's reading on one request, as ``served_gaps`` reads the
    program's: at each served position, the reference's best logit minus
    that of the token the control puts first."""
    seq = _sequence(prompt, served, ref.device)
    first = len(prompt) - 1
    picks = torch.cat([lg.argmax(-1) for _, lg in
                       control.model.logits(seq, first, ctx)])
    return _gaps(ref, seq, first, picks, ctx)


def _gaps(ref, seq, first: int, tokens, ctx=None):
    worst, total, n = 0.0, 0.0, 0
    for p0, lg in ref.model.logits(seq, first, ctx):
        tgt = tokens[p0 - first:p0 - first + lg.shape[0]]
        gap = lg.amax(-1) - lg.gather(1, tgt[:, None])[:, 0]
        worst = max(worst, float(gap.max()))
        total += float(gap.sum())
        n += gap.shape[0]
    return worst, total, n


class Ref:
    """A reference model with the device it runs on."""

    def __init__(self, model_cls, cfg: dict, weights, device,
                 quant=None):
        self.model = model_cls(cfg, weights, quant=quant)
        self.device = torch.device(device)


def verdict(readings: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every reading at or under its limit."""
    return all(readings[k] <= limits[k] for k in limits)
