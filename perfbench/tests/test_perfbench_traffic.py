"""The traffic generator: one schedule for every seed, inside its clipped
ranges; the seed draws the prompts' tokens."""

import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from perfbench import generator

HERE = Path(__file__).resolve().parents[1]
MIXES = {p.stem: json.loads(p.read_text())
         for p in sorted((HERE / "traffic").glob("*.json"))}
SEEDS = (0, 7, 2 ** 31 + 11, 2 ** 33 + 5)


def _schedule(mix, seconds=30.0):
    if mix["arrivals"] == "closed":
        return generator.schedule(mix, seconds, clients=64)
    return generator.schedule(mix, seconds, rate=5.0)


@pytest.mark.parametrize("name", sorted(MIXES))
def test_deterministic_by_seed(name):
    """The schedule is made again alike; a seed's prompts are made again
    alike, and another seed's differ."""
    mix = MIXES[name]
    assert _schedule(mix) == _schedule(mix)
    vocab = 151936
    for d in _schedule(mix)[:8]:
        for seed in SEEDS:
            a = generator.prompt_tokens(seed, d.rid, d.prompt_len, vocab)
            assert np.array_equal(a, generator.prompt_tokens(
                seed, d.rid, d.prompt_len, vocab))
        assert not np.array_equal(
            generator.prompt_tokens(1, d.rid, d.prompt_len, vocab),
            generator.prompt_tokens(2, d.rid, d.prompt_len, vocab))


@pytest.mark.parametrize("name", sorted(MIXES))
def test_lengths_in_their_ranges(name):
    mix = MIXES[name]
    for d in _schedule(mix):
        assert mix["prompt"]["min"] <= d.prompt_len <= mix["prompt"]["max"]
        assert mix["output"]["min"] <= d.max_new <= mix["output"]["max"]


@pytest.mark.parametrize("name", sorted(MIXES))
def test_same_work_for_every_seed(name):
    """The schedule takes no seed: its sizes and dues are the quantiles of
    the mix's distributions, in one fixed order that is not sorted."""
    mix = MIXES[name]
    draws = _schedule(mix)
    n = 64 if mix["arrivals"] == "closed" else len(draws)
    want = Counter(generator.lognormal_quantiles(
        n, mix["prompt"]["median"], mix["prompt"]["sigma"],
        mix["prompt"]["min"], mix["prompt"]["max"]))
    assert Counter(d.prompt_len for d in draws[:n]) == want
    lens = [d.max_new for d in draws[:n]]
    assert lens != sorted(lens)


def test_closed_loop_waves_hold_the_whole_set():
    mix = MIXES["reason-batch"]
    draws = _schedule(mix)
    want = Counter(generator.lognormal_quantiles(
        64, **{k: mix["output"][k] for k in ("median", "sigma")},
        lo=mix["output"]["min"], hi=mix["output"]["max"]))
    for w in range(0, len(draws), 64):
        assert Counter(d.max_new for d in draws[w:w + 64]) == want
    firsts = draws[:64]
    assert [d.due for d in firsts] == [i * mix["stagger_s"] / 64
                                       for i in range(64)]
    assert [d.client for d in firsts] == list(range(64))
    assert all(d.due is None and d.client == -1 for d in draws[64:])


def test_open_loop_arrivals_span_the_window():
    mix = MIXES["chat-rate"]
    for seconds, rate in ((30.0, 5.0), (51.0, 4.0)):
        draws = generator.schedule(mix, seconds, rate=rate)
        dues = [d.due for d in draws]
        assert dues[0] == 0.0 and dues == sorted(dues)
        assert dues[-1] < seconds
        assert abs(len(draws) - rate * seconds) <= 1


def test_open_loop_blocks_hold_the_same_work():
    """Each block of about ``block_s`` seconds holds a spread of the whole
    distribution of gaps, so it lasts about ``block_s`` seconds."""
    mix = MIXES["chat-rate"]
    n_gaps = 4 * 40
    blocks = generator._n_blocks(n_gaps, 4.0, mix)
    assert blocks == round(n_gaps / (4.0 * mix["block_s"]))
    dues = [d.due for d in generator.schedule(mix, 40.0, rate=4.0)]
    edges = [0] + [len(range(j, n_gaps, blocks)) for j in range(blocks)]
    starts = [dues[sum(edges[:k + 1])] for k in range(blocks)]
    for k in range(1, blocks):
        assert starts[k] - starts[k - 1] == pytest.approx(
            mix["block_s"], rel=0.1)
    dealt = generator._dealt(list(range(10)), 3, np.random.default_rng(0))
    assert sorted(dealt[:4]) == [0, 3, 6, 9]
    assert sorted(dealt[4:7]) == [1, 4, 7] and sorted(dealt[7:]) == [2, 5, 8]


def test_quantiles_hand_worked():
    # median 100, sigma 0 -> every quantile is the median
    assert generator.lognormal_quantiles(4, 100, 0.0, 1, 1000) == [100] * 4
    # the exponential's median gap is ln 2 / rate
    gaps = generator.exponential_quantiles(1, 2.0)
    assert gaps == pytest.approx([np.log(2) / 2.0])
    # clipping at both ends
    q = generator.lognormal_quantiles(100, 100, 3.0, 10, 500)
    assert min(q) == 10 and max(q) == 500 and q == sorted(q)


def test_prompts_depend_on_seed_and_rid_only():
    a = generator.prompt_tokens(5, 9, 40, 128)
    assert np.array_equal(a, generator.prompt_tokens(5, 9, 40, 128))
    assert not np.array_equal(a, generator.prompt_tokens(5, 10, 40, 128))
    assert a.dtype == np.int32 and a.min() >= 0 and a.max() < 128
    big = generator.prompt_tokens(2 ** 31 + 17, 0, 8, 151936)
    assert big.max() < 151936
