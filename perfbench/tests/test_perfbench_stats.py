"""The end-to-end arithmetic of ``run.py`` against hand-worked cases, and
the per-layer readers against hand-made records."""

import numpy as np
import pytest

from perfbench import counts, run, spec


def test_percentile_hand_worked():
    assert run.percentile([5.0], 90) == 5.0
    # ten values 1..10: p90 sits 0.1 of the way from 9 to 10
    assert run.percentile(range(1, 11), 90) == pytest.approx(9.1)
    assert run.percentile([3, 1, 2], 50) == 2
    assert run.percentile([0, 10], 25) == pytest.approx(2.5)
    with pytest.raises(ValueError):
        run.percentile([], 90)


@pytest.mark.parametrize("q", [0, 10, 50, 90, 99, 100])
def test_percentile_matches_numpy_linear(q):
    xs = np.random.default_rng(q).lognormal(size=137)
    assert run.percentile(xs.tolist(), q) == pytest.approx(
        float(np.percentile(xs, q)))


def test_rate_and_time_per_token():
    assert run.per_second(4500, 30.0) == 150.0
    # 9 tokens after the first over 0.72 s: 80 ms a token
    assert run.tpot(10.0, 10.72, 10) == pytest.approx(0.08)


def test_buckets_as_the_plan_makes_them():
    assert run.pow2_buckets(2048) == [8, 16, 32, 64, 128, 256, 512, 1024,
                                      2048]
    assert run.pow2_buckets(100) == [8, 16, 32, 64, 100]
    assert run.buckets_of({"max_len": 64, "prefill_buckets": []}) == []
    assert run.buckets_of({"max_len": 64,
                           "prefill_buckets": [100, 16]}) == [16, 64]


def test_buckets_equal_the_programs():
    from repro_torch.serve.engine import pow2_buckets
    for n in (64, 100, 2048, 8192):
        assert run.pow2_buckets(n) == list(pow2_buckets(n))


def _records(**kw):
    rec = {"cfg": None, "host_s": 10.0, "admit_s": 1.5, "step_s": 6.0,
           "decode_steps": 1000, "decode_flops": 2.967e15,
           "profile": {"busy_s": 1.6, "idle_share": 0.2, "host_s": 2.0,
                       "kernels": {"ragged_split_kernel<x>": 0.3,
                                   "decode_combine_kernel": 0.1,
                                   "flash_attention_kernel_bf16": 0.05,
                                   "gemm": 1.15},
                       "decode_bound_s": 0.2, "flash_bound_s": 0.01}}
    rec.update(kw)
    return rec


@pytest.mark.parametrize("name,want", [
    ("idle_share.batch", 20.0), ("idle_share.rate", 20.0),
    ("admit_share.batch", 15.0), ("admit_share.rate", 15.0),
    ("decode_step_ms", 6.0),
    ("decode_mfu", 100 * 2.967e15 / (6.0 * counts.PEAK_FLOPS)),
    ("decode_attn_roofline", 50.0), ("flash_roofline", 20.0)])
def test_readers_hand_worked(name, want):
    assert spec.reader(name)(_records()) == pytest.approx(want)


@pytest.mark.parametrize("name", ["idle_share.batch", "decode_attn_roofline",
                                  "flash_roofline"])
def test_readers_say_nothing_without_a_profile(name):
    assert spec.reader(name)(_records(profile=None)) is None


def test_readers_say_nothing_without_work():
    rec = _records(decode_steps=0, step_s=0.0, decode_flops=0.0)
    assert spec.reader("decode_step_ms")(rec) is None
    assert spec.reader("decode_mfu")(rec) is None
    prof = dict(_records()["profile"], flash_bound_s=0.0,
                kernels={"gemm": 1.0})
    assert spec.reader("flash_roofline")(_records(profile=prof)) is None
    assert spec.reader("decode_attn_roofline")(_records(profile=prof)) \
        is None


@pytest.mark.parametrize("n_slots,n", [(64, 32), (32, 32), (8, 3)])
def test_sample_reaches_every_group_of_slots(n_slots, n):
    """The longest request, then one in each group of neighbouring slots:
    with ``n`` at least the slots, every slot is in every run's sample."""
    from perfbench import check
    done = [{"rid": i, "prompt_len": 10 + (i * 7) % 13, "n_out": 5,
             "slot": (i * 5) % n_slots} for i in range(4 * n_slots)]
    groups = min(n, n_slots)
    for seed in (0, 1, 2 ** 31 + 5):
        picks = check.sample(done, n, seed, n_slots)
        assert len(picks) == n == len({p["rid"] for p in picks})
        assert picks[0] == max(done, key=lambda r: (r["prompt_len"]
                                                    + r["n_out"], -r["rid"]))
        assert {p["slot"] * groups // n_slots for p in picks} == \
            set(range(groups))
        assert picks == check.sample(done, n, seed, n_slots)
    # slots not known: drawn from the seed alone
    bare = [dict(r, slot=-1) for r in done]
    assert len(check.sample(bare, n, 3, n_slots)) == n
    assert check.sample(done[:n], n, 3, n_slots) == done[:n]


def test_knee_is_the_highest_rate_sustained_at_and_below():
    from perfbench import sweep
    rows = [{"rate_per_s": r, "grew": g} for r, g in (
        (3.0, False), (3.0, False), (4.0, False), (4.0, False),
        (5.0, False), (5.0, True), (6.0, False), (7.0, True))]
    # 5/s grew on one seed: the knee is 4 even though 6/s did not grow
    assert sweep.knee(rows) == 4.0
    assert sweep.knee(rows[:4]) == 4.0
    assert sweep.knee([{"rate_per_s": 2.0, "grew": True}]) is None


def test_sweep_backlog_is_a_median_over_a_share_of_the_window():
    from perfbench import sweep
    loop = sweep.SweepLoop.__new__(sweep.SweepLoop)
    loop.backlogs = [(0.46, 1), (0.5, 9), (0.54, 2), (0.95, 4), (0.99, 6)]
    assert loop.backlog_at(0.45, 0.55) == 2
    assert loop.backlog_at(0.9, 1.0) == 5
    assert loop.backlog_at(0.0, 0.1) == 0.0
