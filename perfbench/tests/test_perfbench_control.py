"""The control comes out as not correct.

On the card, at each cell's own size: the program serves a window on
three seeds, and the reference in float8 put in its place (the control)
reads a wider gap than the cell's limit on every seed, while the program
reads under it.  On the CPU, at the smoke sizes: the control reads wider
than the program on the same positions."""

import pytest
import torch

from perfbench import check, limits, run, spec
from perfbench.tests.smoke_cells import one_thread, smoke_cell

WORKLOADS = ["qwen2-0.5b.reason-batch", "granite-moe-1b-a400m.chat-rate"]
SEEDS = (2 ** 31 + 901, 2 ** 31 + 902, 2 ** 31 + 903)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU "
                    "mode")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_at_the_cells_size(cuda, workload):
    cell = spec.load_cell(workload)
    limit = cell.data["limits"]
    client = run.connect(cell, run.draw_weights(cell, SEEDS[0], cuda), cuda)
    eng = client.engine
    eng.start()
    run.warm_up(eng, cell, SEEDS[0])
    for seed in SEEDS:
        limits.load_weights(eng, cell, seed, cuda)
        got = limits.serve_and_read(eng, cell, seed, 20.0, cuda, True)
        assert got["sampled"] > 0
        for name, value in limit.items():
            assert got[name] <= value, got
        # the control fails one of the cell's numbers on every seed
        assert any(got["control_" + name] > value
                   for name, value in limit.items()), got


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_reads_wider_than_the_program_on_the_cpu(workload):
    cell = smoke_cell(workload)
    torch.manual_seed(0)
    with one_thread():
        client = run.connect(cell, run.draw_weights(cell, 5, "cpu"), "cpu")
        eng = client.engine
        eng.start()
        run.warm_up(eng, cell, 5)
        got = limits.serve_and_read(eng, cell, 5, 3.0, "cpu", True)
    assert got["sampled"] > 0
    assert got["control_max_gap"] > got["max_gap"] + 1e-3, got
    assert got["control_mean_gap"] > got["mean_gap"], got


def test_control_gap_reads_the_controls_first_choice():
    """On a hand-made pair: the control's first choices lie 0.5 and 3.0
    below the reference's best."""
    class Fixed:
        def __init__(self, rows):
            self.rows = rows

        def logits(self, seq, start, ctx=None):
            yield start, self.rows

    ref = check.Ref.__new__(check.Ref)
    ref.model = Fixed(torch.tensor([[0.0, 2.0, 1.5], [3.0, 0.0, 0.0]]))
    ref.device = torch.device("cpu")
    ctl = check.Ref.__new__(check.Ref)
    ctl.model = Fixed(torch.tensor([[0.0, 1.0, 2.0], [0.0, 1.0, 0.0]]))
    ctl.device = ref.device
    prompt = [7]
    served = [1, 0]
    assert check.served_gaps(ref, prompt, served) == (0.0, 0.0, 2)
    worst, total, n = check.control_gaps(ref, ctl, prompt, served)
    assert worst == pytest.approx(3.0) and total == pytest.approx(3.5)
    assert check.served_gaps(ref, prompt, [2, 1])[0] == pytest.approx(3.0)
