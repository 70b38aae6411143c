"""A whole run at the smoke sizes on the CPU (the look for a chip left
out): sound, it comes out correct; with the timed path broken underneath,
once for each fault a one-chip serving cell can have, ``correct`` comes
out false.  (The exchange between chips does not exist on one chip.)"""

import time

import pytest
import torch

from perfbench import run
from perfbench.faults import FAULTS, planted
from perfbench.tests.smoke_cells import one_thread, smoke_cell

WORKLOADS = ["qwen2-0.5b.reason-batch", "granite-moe-1b-a400m.chat-rate"]
SEED = 2 ** 31 + 101
#: the checks that compare served tokens with the reference
GAPS = {"max_gap", "mean_gap"}


def _run(workload, seconds=3.0):
    torch.manual_seed(0)
    with one_thread():
        return run.run_cell(smoke_cell(workload), SEED, seconds, False,
                            device="cpu", t_process=time.perf_counter())


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(workload):
    result, info, lines = _run(workload)
    assert result["correct"], lines
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {"out_tok_s", "ttft_p90_ms",
                                      "tpot_p90_ms", "mem_gib", "setup_s"}
    assert list(result)[-1] == "checks"
    assert info["finished"] > 0
    assert lines[0].startswith("check m")


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", WORKLOADS)
def test_fault_is_not_correct(workload, fault):
    """The run completes (no exception), finishes requests, and a gap over
    its limit fails it."""
    with planted(fault):
        result, info, lines = _run(workload)
    checks = result["checks"]
    failed = {k for k, c in checks.items() if c["value"] > c["limit"]}
    assert failed & GAPS, lines
    assert info["finished"] > 0, lines
    assert not result["correct"], lines
