"""The six ``examples/*_torch.py`` scripts (CPU) against the reference's
``examples/*.py`` and plain numpy.

* ``serve_batched``: at fp32 on the reference's weights (bridged through
  ``models.params.from_numpy``), the wave and the three presets give
  exactly the tokens of the reference script's ``drive`` on
  ``repro.serve.connect``, on its ``make_requests(cfg, 4)``.
* ``serve_fleet``, ``serve_adaptive``: Part 1 prints the reference
  script's lines letter for letter (virtual time is deterministic); the
  reference script runs in this process up to its Part 2, which it never
  starts.  Part 2's adaptive and manually re-planned tokens equal a
  frozen fleet's.
* ``stencil_endpoints``: on a one-process gloo group here and on 2 gloo
  ranks in subprocesses, the gathered grid equals a plain numpy periodic
  5-point stencil within ``STENCIL_TOL`` (fp32, the same sums in the
  same order), with 2 halo messages per rank and step; the cost table
  equals ``repro.comm.costs.estimate_sync_time`` over
  ``repro.core.channels.plan_for`` at 1, 2 and 8 ranks.
* ``train_endpoint_categories``: at 2 gloo ranks, 3 steps a category,
  the three final losses are bit for bit equal.
* ``quickstart``: 6 steps give a finite loss curve, then 8 tokens served
  from the trained weights.
* Each script as users run it, ``--device cpu``, in a subprocess: exit 0
  and the reference's line headings.

``stencil_endpoints.py`` and ``train_endpoint_categories.py`` set
XLA_FLAGS at import, so they are never imported here.  Subprocesses run
with one intra-op thread each, started together.
"""

import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import serve as jserve
from repro.comm.costs import estimate_sync_time as jestimate
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.channels import plan_for as jplan_for
from repro.core.endpoints import Category as JCategory
from repro.models.model import Model as JModel
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ArchConfig
from repro_torch.core.plan import SharingVector
from repro_torch.models.params import from_numpy
from repro_torch.serve import connect
from test_torch_isolation import EXAMPLES
from test_torch_isolation import load_example as _port

ROOT = Path(__file__).resolve().parents[1]
#: the stencil's limit against plain numpy, times max(1, max |numpy|)
STENCIL_TOL = 1e-5
#: each script's reference line headings, as users see them
HEADINGS = {
    "quickstart": ("loss curve:", "prompt tail:"),
    "serve_batched": ("wave           :", "mpi_everywhere :",
                      "shared_dynamic :", "mpi_threads    :", "  req  0 ->"),
    "serve_fleet": ("trace: 96 requests in bursts of 24",
                    "plan (slots/chan/exec)", "the plan-space tradeoff",
                    "real fleet via", "  stream FIFO held:",
                    "  sample outputs:"),
    "serve_adaptive": ("trace: 144 requests over", "frozen dedicated ",
                       "frozen shared ", "ADAPTIVE ",
                       "real adaptive fleet:", "manual replan ",
                       "  sample outputs:"),
    "train_endpoint_categories": ("mpi_everywhere   final loss",
                                  "2x_dynamic       final loss",
                                  "mpi_threads      final loss",
                                  "identical across categories: True"),
    "stencil_endpoints": ("stencil on 1 ranks, grid 512^2, 5 steps: sum=",
                          "halo messages per rank and step: 2",
                          "halo-exchange scheduling per endpoint category "
                          "(alpha-beta ICI model):", "  mpi_threads "),
}


def _reference(name: str):
    """A reference script that sets no XLA_FLAGS at import."""
    assert name not in ("stencil_endpoints", "train_endpoint_categories")
    spec = importlib.util.spec_from_file_location(
        f"{name}_reference", ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(**extra):
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="1", **extra)


def _communicate(procs, timeout=240):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


@contextlib.contextmanager
def _one_process_group():
    dist.init_process_group("gloo",
                            init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _numpy_stencil(grid: np.ndarray, steps: int) -> np.ndarray:
    for _ in range(steps):
        lap = (np.roll(grid, 1, 0) + np.roll(grid, -1, 0)
               + np.roll(grid, 1, 1) + np.roll(grid, -1, 1) - 4 * grid)
        grid = grid + np.float32(0.1) * lap
    return grid


def _grid(seed=0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (512, 512)).astype(np.float32)


# ----- every script as users run it ------------------------------------------

@pytest.fixture(scope="module")
def as_run():
    """Each script at its defaults with ``--device cpu``, all started
    together; -> {name: (returncode, stdout, stderr)}."""
    names = list(EXAMPLES)
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / f"{n}_torch.py"),
         "--device", "cpu"], cwd=ROOT, env=_env(), text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE) for n in names]
    outs = _communicate(procs)
    return {n: (p.returncode, *o) for n, p, o in zip(names, procs, outs)}


@pytest.mark.parametrize("name", EXAMPLES)
def test_script_runs_on_the_cpu_when_asked(as_run, name):
    rc, out, err = as_run[name]
    assert rc == 0, out + err
    lines = out.splitlines()
    for heading in HEADINGS[name]:
        assert any(line.startswith(heading) for line in lines), \
            (heading, out)


# ----- serve_batched ---------------------------------------------------------

@pytest.fixture(scope="module")
def batched():
    """(reference tokens, port rows) of the wave and the three presets at
    fp32 on the reference's weights, on ``make_requests(cfg, 4)``."""
    ref = _reference("serve_batched")
    port = _port("serve_batched")
    jcfg = dataclasses.replace(jax_smoke_config("qwen2-0.5b"),
                               compute_dtype="float32")
    tcfg = ArchConfig(**dataclasses.asdict(jcfg))
    jparams = JModel(jcfg).init(jax.random.PRNGKey(0))
    reqs = ref.make_requests(jcfg, 4)
    want = {"wave": ref.drive(jserve.connect(
        jcfg, None, params=jparams, executor="wave", n_slots=4,
        max_len=port.MAX_LEN), reqs)[0]}
    for preset in port.PRESETS:
        want[preset] = ref.drive(jserve.connect(
            jcfg, preset, params=jparams, n_slots=4,
            max_len=port.MAX_LEN), reqs)[0]
    with contextlib.redirect_stdout(io.StringIO()):
        got = port.run(tcfg, "cpu", n_requests=4, n_slots=4,
                       params=from_numpy(jax.device_get(jparams)))
    return ref, port, want, got


def test_serve_batched_requests_are_the_reference_script_s(batched):
    ref, port, _, _ = batched
    cfg = get_smoke_config("qwen2-0.5b")
    for (p0, m0, e0), (p1, m1, e1) in zip(ref.make_requests(cfg, 12),
                                          port.make_requests(cfg, 12)):
        assert np.array_equal(p0, p1) and p0.dtype == p1.dtype
        assert (m0, e0) == (m1, e1)


@pytest.mark.parametrize("executor", ["wave", "mpi_everywhere",
                                      "shared_dynamic", "mpi_threads"])
def test_serve_batched_tokens_equal_the_reference_at_fp32(batched,
                                                          executor):
    _, _, want, got = batched
    assert got[executor]["tokens"] == want[executor]
    assert got[executor]["total"] == sum(map(len, want[executor].values()))
    if executor != "wave":
        assert got[executor]["agree"] == len(want[executor])


# ----- serve_fleet and serve_adaptive ----------------------------------------

class _Part2(Exception):
    """Raised where the reference script starts its Part 2."""


def _reference_part1(name: str) -> str:
    ref = _reference(name)

    def stop(*args, **kwargs):
        raise _Part2

    ref.get_smoke_config = stop
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(_Part2):
        ref.main()
    return buf.getvalue()


@pytest.mark.parametrize("name", ["serve_fleet", "serve_adaptive"])
def test_part1_prints_the_reference_lines(name):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _port(name).part1()
    want = _reference_part1(name)
    assert buf.getvalue() == want
    assert want.count("\n") >= 8


def _submit_all(client, prompts, max_new):
    for p in prompts:
        client.submit(p, max_new_tokens=max_new, at_ns=0.0)
    return client.run()


def test_serve_adaptive_tokens_equal_a_frozen_fleet_s():
    """Part 2's adaptive run and its run after the manual replan serve the
    tokens a fleet frozen at each vector serves (fp32, the same weights
    from ``connect``'s seed 0)."""
    port = _port("serve_adaptive")
    cfg = dataclasses.replace(get_smoke_config("qwen2-0.5b"),
                              compute_dtype="float32")
    with contextlib.redirect_stdout(io.StringIO()):
        got = port.part2(cfg, "cpu")
    assert got["transitions"]
    rng = np.random.default_rng(0)
    first = [rng.integers(1, cfg.vocab, 8).astype(np.int32)
             for _ in range(12)]
    more = [rng.integers(1, cfg.vocab, 8).astype(np.int32)
            for _ in range(4)]
    kw = dict(n_workers=4, n_slots=2, max_len=64, device="cpu")
    frozen = _submit_all(connect(cfg, SharingVector.diagonal(2), **kw),
                         first, 4)
    assert [got["adaptive"][r] for r in sorted(got["adaptive"])] == \
        [frozen[r] for r in sorted(frozen)]
    frozen = _submit_all(connect(cfg, port.MANUAL, **kw), more, 4)
    assert [got["manual"][r] for r in sorted(got["manual"])] == \
        [frozen[r] for r in sorted(frozen)]


def test_serve_fleet_stream_holds_its_order():
    port = _port("serve_fleet")
    with contextlib.redirect_stdout(io.StringIO()):
        got = port.part2(get_smoke_config("qwen2-0.5b"), "cpu")
    rep = got["report"]
    assert rep.n_completed == 12 and len(got["outputs"]) == 12
    assert [len(t) for t in got["stream"]] == [3, 3, 3]


# ----- stencil_endpoints -----------------------------------------------------

def _assert_stencil(out: np.ndarray, grid: np.ndarray, steps: int):
    want = _numpy_stencil(grid, steps)
    assert out.shape == want.shape and out.dtype == np.float32
    limit = STENCIL_TOL * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(out - want).max()) <= limit


def test_stencil_one_process_group_matches_numpy():
    port = _port("stencil_endpoints")
    grid = _grid()
    with _one_process_group(), contextlib.redirect_stdout(io.StringIO()):
        got = port.run("cpu", grid=torch.from_numpy(grid))
    assert got["ranks"] == 1
    assert got["messages_per_step"] == 2
    _assert_stencil(got["grid"].numpy(), grid, port.STEPS)


@pytest.mark.parametrize("n", [1, 2, 8])
def test_stencil_cost_table_is_the_reference_s(n):
    port = _port("stencil_endpoints")
    rows = port.cost_table(n)
    assert [cat.value for cat, *_ in rows] == [c.value for c in JCategory]
    halo = port.GRID * 4 * 2
    for cat, ici, channels in rows:
        plan = jplan_for(JCategory(cat.value), lanes=n)
        want = jestimate([halo] * n, plan, axis_size=n)
        assert ici == want.seconds and channels == plan.n_buckets(n)
    buf = io.StringIO()
    with _one_process_group(), contextlib.redirect_stdout(buf):
        port.print_cost_table(n)
    lines = buf.getvalue().splitlines()
    for cat in JCategory:
        plan = jplan_for(cat, lanes=n)
        cost = jestimate([halo] * n, plan, axis_size=n)
        line = (f"  {cat.value:16s} est={cost.seconds * 1e6:8.2f}us  "
                f"channels={plan.n_buckets(n)}")
        assert any(x.startswith(line) for x in lines), (line, lines)


TWO_RANKS = textwrap.dedent("""
    import importlib.util, json, sys
    import numpy as np, torch, torch.distributed as dist
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import join_group

    def load(name):
        spec = importlib.util.spec_from_file_location(
            name, f"{sys.argv[1]}/examples/{name}.py")
        m = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(m)
        return m

    stencil = load("stencil_endpoints_torch")
    train = load("train_endpoint_categories_torch")
    device = join_group("cpu")              # torchrun's environment
    grid = torch.from_numpy(np.load(sys.argv[2]))
    out = stencil.run(device, grid=grid)
    losses = train.run(get_smoke_config("smollm-360m"), device, n_steps=3)
    if dist.get_rank() == 0:
        np.save(sys.argv[3], out["grid"].numpy())
    print("RESULT", json.dumps(dict(
        rank=dist.get_rank(), ranks=out["ranks"], losses=losses,
        messages=out["messages_per_step"])))
    dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The stencil and 3 training steps a category on 2 gloo ranks, joined
    from torchrun's environment variables; -> (per-rank results, start
    grid, rank 0's gathered grid)."""
    tmp = tmp_path_factory.mktemp("two_ranks")
    grid = _grid(1)
    np.save(tmp / "in.npy", grid)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", TWO_RANKS, str(ROOT), str(tmp / "in.npy"),
         str(tmp / "out.npy")], cwd=tmp, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env=_env(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                 MASTER_ADDR="localhost", MASTER_PORT=str(port)))
        for rank in (0, 1)]
    outs = _communicate(procs)
    results = []
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, out + err
        [line] = [x for x in out.splitlines() if x.startswith("RESULT ")]
        results.append(json.loads(line.removeprefix("RESULT ")))
    return results, grid, np.load(tmp / "out.npy")


def test_stencil_two_ranks_match_numpy(two_ranks):
    results, grid, out = two_ranks
    assert [r["ranks"] for r in results] == [2, 2]
    assert all(r["messages"] == 2 for r in results)
    _assert_stencil(out, grid, 5)


def test_train_categories_bit_equal_on_two_ranks(two_ranks):
    results, _, _ = two_ranks
    for r in results:
        losses = list(r["losses"].values())
        assert list(r["losses"]) == ["mpi_everywhere", "2x_dynamic",
                                     "mpi_threads"]
        assert all(np.isfinite(losses)) and len(set(losses)) == 1
    assert results[0]["losses"] == results[1]["losses"]


# ----- quickstart ------------------------------------------------------------

def test_quickstart_trains_then_serves_the_trained_weights():
    port = _port("quickstart")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = port.run(get_smoke_config("smollm-360m"), "cpu", n_steps=6)
    assert len(got["losses"]) == 2
    assert all(np.isfinite(got["losses"]))
    assert len(got["tokens"]) == 8
    assert all(0 <= t < 128 for t in got["tokens"])
    assert "loss curve:" in buf.getvalue()
