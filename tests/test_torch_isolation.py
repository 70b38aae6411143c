"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package, entry points refuse to carry on without
a card unless asked for the CPU (or the meta device, by name), and the
kernel wrappers route only CPU tensors to their plain versions and meta
tensors to shape-only operators."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


#: the examples' counterparts, ``examples/<name>_torch.py``: each runs
#: through ``repro_torch`` alone
EXAMPLES = ("quickstart", "serve_batched", "serve_fleet", "serve_adaptive",
            "train_endpoint_categories", "stencil_endpoints")


def example_path(name: str) -> Path:
    return ROOT / "examples" / f"{name}_torch.py"


def load_example(name: str):
    """``examples/<name>_torch.py`` loaded as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(f"{name}_torch",
                                                  example_path(name))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _port_files():
    return (sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + [example_path(name) for name in EXAMPLES])


def test_no_forbidden_import_in_sources():
    """AST scan of every module of the port and of chip_smoke.py."""
    offenders = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.relative_to(ROOT)}: {n}" for n in names
                          if _forbidden(n)]
    assert not offenders, offenders


def test_importing_every_module_loads_no_jax_or_repro():
    modules = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__") for p in PKG.rglob("*.py"))
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert len(modules) >= 25
    # the planner slice's modules are in the scan
    assert {"repro_torch.tune", "repro_torch.tune.space",
            "repro_torch.tune.pareto", "repro_torch.tune.evaluate",
            "repro_torch.tune.search", "repro_torch.tune.repository",
            "repro_torch.launch.tune", "repro_torch.core.ibsim.costmodel",
            "repro_torch.core.ibsim.engine",
            "repro_torch.core.ibsim.benchmark"} <= set(modules)
    # the launch/ analysis tools are in the scan
    assert {"repro_torch.launch.shapes", "repro_torch.launch.sharding",
            "repro_torch.launch.mesh", "repro_torch.launch.roofline",
            "repro_torch.launch.op_analysis",
            "repro_torch.launch.dryrun"} <= set(modules)


def test_importing_the_dry_run_joins_no_process_group():
    """Unlike the reference's dryrun (which sets XLA_FLAGS at import),
    importing the port's sets nothing and joins no group: its fake group
    is joined only inside its own functions."""
    code = (
        "import os\n"
        "env = dict(os.environ)\n"
        "import torch.distributed as dist\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.mesh\n"
        "import repro_torch.launch.sharding, repro_torch.launch.shapes\n"
        "assert not dist.is_initialized()\n"
        "assert dict(os.environ) == env\n"
        "print('OK')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "OK" in res.stdout


def test_wrappers_take_the_plain_versions_for_meta_tensors():
    """A meta tensor (the dry run) launches nothing: the attention
    wrappers call their meta operators and the scan its plain version,
    each giving the kernel's output shape and dtype."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.rglru import ops as rglru_ops
    meta = dict(device="meta")
    q = torch.empty((2, 1, 6, 8), dtype=torch.bfloat16, **meta)
    k = torch.empty((2, 16, 2, 8), dtype=torch.bfloat16, **meta)
    cur = torch.empty((2,), dtype=torch.int32, **meta)
    pt = torch.empty((2, 2), dtype=torch.int32, **meta)
    ops.reset_launch_counts()
    rglru_ops.reset_launch_counts()
    out = ops.flash_decode_attention(q, k, k, cur)
    assert out.shape == q.shape and out.is_meta and out.dtype == q.dtype
    pages = torch.empty((4, 8, 2, 8), dtype=torch.bfloat16, **meta)
    assert ops.paged_flash_decode_attention(q, pages, pages, pt,
                                            cur).shape == q.shape
    qs = torch.empty((2, 5, 6, 8), dtype=torch.bfloat16, **meta)
    assert ops.flash_attention(qs, k, k).shape == qs.shape
    a = torch.empty((2, 9, 5), **meta)
    assert rglru_ops.rglru_scan(a, a).is_meta
    assert not any(ops.LAUNCHES.values()) and not ops.SHAPE_LAUNCHES
    assert not any(rglru_ops.LAUNCHES.values())


@pytest.mark.parametrize("case", ["prefill", "decode", "paged"])
def test_meta_operators_count_the_plain_flops_and_hold_no_scores(case):
    """On meta tensors an attention wrapper counts the FLOPs its plain
    version's products count, and holds only what the card's kernel
    holds: its output (and a decode call's split workspace), never the
    plain version's scores or fp32 copies."""
    from repro_torch.kernels.flash_attention import ops, ref
    from repro_torch.launch.op_analysis import OpCounter
    meta = dict(device="meta", dtype=torch.bfloat16)
    b, hq, hkv, dh = 2, 6, 2, 16
    cur = torch.empty((b,), dtype=torch.int32, device="meta")
    if case == "prefill":
        q = torch.empty((b, 64, hq, dh), **meta)
        k = torch.empty((b, 64, hkv, dh), **meta)
        args = (q, k, k)
        wrapper, plain, held = ops.flash_attention, ref.flash_attention_ref, 0
    else:
        q = torch.empty((b, 1, hq, dh), **meta)
        if case == "decode":
            k = torch.empty((b, 256, hkv, dh), **meta)
            args = (q, k, k, cur)
            wrapper, plain = ops.flash_decode_attention, ref.ragged_decode_ref
            capacity = 256
        else:
            k = torch.empty((8, 32, hkv, dh), **meta)
            table = torch.empty((b, 8), dtype=torch.int32, device="meta")
            args = (q, k, k, table, cur)
            wrapper, plain = (ops.paged_flash_decode_attention,
                              ref.paged_decode_ref)
            capacity = 8 * 32
        held = b * hq * ops.decode_splits(capacity)[1] * (dh + 2) * 4
    with OpCounter() as kernel:
        out = wrapper(*args)
    with OpCounter() as reference:
        plain(*args)
    assert kernel.flops == reference.flops == ops.attention_flops(
        b, hq, q.shape[1], capacity if case != "prefill" else 64, dh)
    assert kernel.peak_bytes == held + out.numel() * out.element_size()
    assert reference.peak_bytes > 4 * kernel.peak_bytes


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve as launcher
    from repro_torch.serve import connect
    cfg = get_smoke_config("qwen2-0.5b")
    with pytest.raises(RuntimeError, match="CUDA"):
        connect(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        launcher.main(["--smoke", "--requests", "1"])
    assert connect(cfg, device="cpu").engine.device.type == "cpu"


@pytest.fixture(scope="module")
def examples_without_a_card():
    """Each example script run as users run it, without ``--device cpu``
    and with CUDA hidden, all started together; -> {name: (returncode,
    stdout, stderr)}."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    procs = {f"{name}_torch": subprocess.Popen(
        [sys.executable, str(example_path(name))], cwd=ROOT, env=env,
        text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for name in EXAMPLES}
    out = {}
    try:
        for name, p in procs.items():
            stdout, stderr = p.communicate(timeout=120)
            out[name] = (p.returncode, stdout, stderr)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


@pytest.mark.parametrize("name", [f"{name}_torch" for name in EXAMPLES])
def test_example_needs_a_card_unless_asked_for_the_cpu(
        examples_without_a_card, name):
    """Without CUDA and without ``--device cpu`` each example raises the
    port's RuntimeError before it prints anything: no CPU fallback."""
    rc, out, err = examples_without_a_card[name]
    assert rc != 0
    assert "RuntimeError: CUDA is not available" in err, err
    assert out == ""


def test_launcher_serves_on_the_cpu_when_asked(capsys):
    from repro_torch.launch import serve as launcher
    launcher.main(["--smoke", "--device", "cpu", "--pages", "4",
                   "--max-len", "32", "--requests", "3", "--prompt-len",
                   "6", "--max-new", "3", "--decode-horizon", "4",
                   "--mixed-lengths"])
    out = capsys.readouterr().out
    assert "served 3 requests, 9 tokens" in out
    assert "page pool: level 4" in out
    assert ("kernel launches: {'ragged_decode': 0, 'paged_decode': 0, "
            "'flash_attention': 0, 'rglru_scan': 0}") in out


def test_wrappers_route_cpu_tensors_to_the_plain_versions():
    from repro_torch.kernels.flash_attention import ops, ref
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((2, 1, 6, 8), generator=gen)
    k = torch.randn((2, 16, 2, 8), generator=gen)
    cur = torch.tensor([3, 20], dtype=torch.int32)
    pt = torch.tensor([[0, 1], [3, 2]], dtype=torch.int32)
    ops.reset_launch_counts()
    assert torch.equal(ops.flash_decode_attention(q, k, k, cur),
                       ref.ragged_decode_ref(q, k, k, cur))
    pages = k.reshape(4, 8, 2, 8)
    assert torch.equal(
        ops.paged_flash_decode_attention(q, pages, pages, pt, cur),
        ref.paged_decode_ref(q, pages, pages, pt, cur))
    assert ops.LAUNCHES == {"ragged_decode": 0, "paged_decode": 0,
                            "flash_attention": 0}
    assert ops.SHAPE_LAUNCHES == {}


def test_launcher_serves_recurrentgemma_on_the_cpu_when_asked(capsys):
    from repro_torch.launch import serve as launcher
    launcher.main(["--arch", "recurrentgemma-2b", "--smoke", "--device",
                   "cpu", "--pages", "4", "--max-len", "48", "--requests",
                   "3", "--prompt-len", "12", "--max-new", "4",
                   "--decode-horizon", "4", "--mixed-lengths"])
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out
    assert "buckets off" in out and "page pool" not in out
    assert ("kernel launches: {'ragged_decode': 0, 'paged_decode': 0, "
            "'flash_attention': 0, 'rglru_scan': 0}") in out


def test_rglru_wrapper_routes_cpu_tensors_to_the_plain_version():
    from repro_torch.kernels.rglru import ops, ref
    gen = torch.Generator().manual_seed(1)
    a = torch.rand((2, 9, 5), generator=gen)
    x = torch.randn((2, 9, 5), generator=gen)
    ops.reset_launch_counts()
    assert torch.equal(ops.rglru_scan(a, x), ref.rglru_scan_ref(a, x))
    assert ops.LAUNCHES == {"rglru_scan": 0}


def test_kernel_sources_are_found_per_package():
    """Every kernel's source sits in its own package's csrc/, and the
    library name hashes it; nothing is compiled on import."""
    from repro_torch.kernels import build
    assert set(build.PACKAGES) == set(build.SIGNATURES)
    for name in build.PACKAGES:
        src = build.csrc(name) / f"{name}.cu"
        assert src.is_file(), src
        assert src.parent.parent.name == build.PACKAGES[name]
        assert src.read_text().count(f'extern "C" int {name}(') == 1
        assert build._library_path(name).name.startswith(f"lib{name}-")
    assert build.csrc("rglru_scan").parent.name == "rglru"
    assert not build._loaded


def test_chip_smoke_refuses_without_a_card_or_the_repo(tmp_path):
    """Here (no CUDA) and alone in a directory, chip_smoke.py exits
    non-zero and prints no result line."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    for script in (ROOT / "chip_smoke.py", alone):
        res = subprocess.run([sys.executable, str(script)],
                             cwd=script.parent, capture_output=True,
                             text=True, timeout=120)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
