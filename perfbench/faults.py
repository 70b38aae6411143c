"""Faults planted under the timed path, for the tests that show a broken
program comes out not correct and for readings at a cell's size
(``limits.py --fault``): each wraps one method of the program's ``Model``
and breaks what it returns, the program's files untouched."""

from __future__ import annotations

import contextlib

import torch


def state_unchanged(orig):
    """A decode horizon that hands back the cache's position as it was
    given: the next horizon writes its keys and values over this one's,
    so the context the model sees stops growing while the engine counts
    the tokens out as usual."""
    def horizon(self, params, cache, state, **kw):
        idx = cache["idx"].clone()
        new_cache, new_state, trace = orig(self, params, cache, state, **kw)
        new_cache["idx"].copy_(idx)
        return dict(new_cache, idx=new_cache["idx"]), new_state, trace
    return horizon


def half_batch(orig):
    """Decode steps that leave out the first half of the batch (the slots
    the engine fills first): its rows get the mean of the other half's
    logits."""
    def step(self, *a, **kw):
        logits, cache = orig(self, *a, **kw)
        b = logits.shape[0]
        if b > 1:
            h = b // 2
            mean = logits[h:].mean(0, keepdim=True)
            logits = torch.cat([mean.expand(h, -1), logits[h:]])
        return logits, cache
    return step


def token_altered(orig):
    """Decode steps whose first row's logits are rolled by one: the token
    that row produces is altered."""
    def step(self, *a, **kw):
        logits, cache = orig(self, *a, **kw)
        logits = logits.clone()
        logits[0] = logits[0].roll(1)
        return logits, cache
    return step


def first_token_altered(orig):
    """Prefills whose logits are rolled by one: every first token is
    altered where the prefill produces it."""
    def prefill(self, *a, **kw):
        logits, cache = orig(self, *a, **kw)
        return logits.roll(1, dims=-1), cache
    return prefill


#: fault -> (the ``Model`` method it wraps, the wrapper)
FAULTS = {
    "state_unchanged": ("decode_horizon", state_unchanged),
    "half_batch": ("decode_step", half_batch),
    "token_altered": ("decode_step", token_altered),
    "first_token_altered": ("prefill", first_token_altered),
}


@contextlib.contextmanager
def planted(fault: str):
    """``fault`` planted in the program's ``Model`` while inside."""
    from repro_torch.models.model import Model
    name, make = FAULTS[fault]
    orig = getattr(Model, name)
    setattr(Model, name, make(orig))
    try:
        yield
    finally:
        setattr(Model, name, orig)
