"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package, entry points refuse to carry on without
a card unless asked for the CPU, and the kernel wrappers route only CPU
tensors to their plain versions."""

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


def _port_files():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


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
