"""The one traffic generator: a mix's parameters in, requests out.

A mix (``traffic/<mix>.json``) gives the prompt and output lengths as
clipped lognormals (``median``, ``sigma``, ``min``, ``max``) and the
arrival kind: ``closed`` (clients that each wait for their answer) or
``poisson`` (an open loop of independent users at the cell's rate).

Every seed serves the same schedule: the same sizes in the same order,
due at the same times.  The sizes are the distribution's quantiles at
``(i + 0.5) / n`` and the gaps between arrivals the exponential's, put in
one fixed shuffled order (``ORDER``).  A closed loop issues them in waves
of one request a client, each wave the whole set; an open loop deals its
quantiles round-robin into blocks of about the mix's ``block_s`` seconds,
so that each stretch of the window holds about the same work.  In a
window of tens of requests a client, which request meets which neighbour
moves the work a window holds (the tokens it completes, the contexts it
decodes at) by more than two runs of one order differ, so the order is
not the seed's.  The seed draws what a request holds: its prompt's
tokens, from ``(seed, rid)``, uniform over the vocabulary, so that a
request's prompt can be made again without the rest.
"""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import List

import numpy as np

#: lengths drawn for a closed loop, as many as this many requests per
#: client could need; a client takes the next length of one shared list
POOL_PER_CLIENT = 16
#: the one fixed order of every schedule's sizes and gaps
ORDER = 20241019


def lognormal_quantiles(n: int, median: float, sigma: float, lo: int,
                        hi: int) -> List[int]:
    """The ``n`` lengths at the lognormal's quantiles ``(i + 0.5) / n``,
    rounded and clipped to ``[lo, hi]``, in ascending order."""
    nd = NormalDist()
    return [min(hi, max(lo, int(round(
        median * math.exp(sigma * nd.inv_cdf((i + 0.5) / n))))))
        for i in range(n)]


def exponential_quantiles(n: int, rate: float) -> List[float]:
    """The ``n`` gaps at the exponential's quantiles ``(i + 0.5) / n`` for
    ``rate`` arrivals a second, in ascending order."""
    return [-math.log(1.0 - (i + 0.5) / n) / rate for i in range(n)]


@dataclasses.dataclass
class Draw:
    """One request as the generator made it: when it is due (seconds from
    the window's start; None for a closed loop's later requests, due when
    their client's answer arrives), its client (-1: the closed loop's
    next free client takes it), and its sizes."""

    rid: int
    due: float
    client: int
    prompt_len: int
    max_new: int


def _lengths(mix: dict, key: str, n: int) -> List[int]:
    d = mix[key]
    return lognormal_quantiles(n, d["median"], d["sigma"], d["min"],
                               d["max"])


def _n_blocks(n: int, rate: float, mix: dict) -> int:
    """Blocks of about ``block_s`` seconds of arrivals in ``n`` (1 when the
    mix names no block)."""
    per = rate * float(mix.get("block_s", 0.0))
    return max(1, int(round(n / per))) if per >= 1 else 1


def _dealt(values: List, blocks: int, rng) -> List:
    """``values`` (ascending quantiles) dealt round-robin into ``blocks``
    consecutive blocks, each shuffled: every block holds a spread of the
    whole distribution, so each stretch of the window holds about the same
    work."""
    parts = [list(values[j::blocks]) for j in range(blocks)]
    for part in parts:
        rng.shuffle(part)
    return [v for part in parts for v in part]


def schedule(mix: dict, seconds: float, *, rate: float = 0.0,
             clients: int = 0) -> List[Draw]:
    """The requests of one window of ``seconds``, the same for every seed.

    ``closed``: ``clients`` first requests due evenly over the mix's
    ``stagger_s``, then each client's next request due when its previous
    answer is complete (``due`` None); the list holds enough for
    ``POOL_PER_CLIENT`` requests a client.  ``poisson``: ``rate`` requests
    a second, the first due at 0 and the last before ``seconds``."""
    rng = np.random.default_rng(ORDER)
    kind = mix["arrivals"]
    if kind == "closed":
        if clients < 1:
            raise ValueError("a closed loop needs clients")
        n = clients * POOL_PER_CLIENT
        stagger = float(mix["stagger_s"])
        dues = [i * stagger / clients for i in range(clients)] \
            + [None] * (n - clients)
    elif kind == "poisson":
        if rate <= 0:
            raise ValueError("an open loop needs a positive rate")
        n_gaps = max(1, int(math.ceil(rate * seconds)))
        blocks = _n_blocks(n_gaps, rate, mix)
        dues, t = [], 0.0
        for g in [0.0] + _dealt(exponential_quantiles(n_gaps, rate),
                                blocks, rng):
            t += g
            if t >= seconds:
                break
            dues.append(t)
        n = len(dues)
    else:
        raise ValueError(f"unknown arrival kind {kind!r}")
    prompts, outputs = [], []
    if kind == "closed":
        # a closed loop issues its lengths in waves of one per client,
        # each the whole set of quantiles: every wave holds the same work
        for _ in range(n // clients):
            for out, key in ((prompts, "prompt"), (outputs, "output")):
                part = _lengths(mix, key, clients)
                rng.shuffle(part)
                out.extend(part)
    else:
        blocks = _n_blocks(n, rate, mix)
        prompts = _dealt(_lengths(mix, "prompt", n), blocks, rng)
        outputs = _dealt(_lengths(mix, "output", n), blocks, rng)
    return [Draw(rid=i, due=dues[i],
                 client=(i if kind == "poisson" or i < clients else -1),
                 prompt_len=prompts[i], max_new=outputs[i])
            for i in range(n)]


def prompt_tokens(seed: int, rid: int, length: int, vocab: int) -> np.ndarray:
    """Request ``rid``'s prompt: ``length`` token ids uniform over
    ``vocab``, from ``(seed, rid)`` alone."""
    rng = np.random.default_rng([int(seed), 1, int(rid)])
    return rng.integers(0, vocab, size=length, dtype=np.int64).astype(
        np.int32)
