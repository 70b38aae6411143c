"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel lives in a package under ``kernels/`` and its source is that
package's ``csrc/<name>.cu``.  Each compiles on its own into a shared
library with a plain C interface (``nvcc -gencode
arch=compute_90a,code=sm_90a -shared``), at first use, into
``build/kernels/`` at the root of the checkout.  The library's file name
carries a hash of its sources (the ``.cu`` and its package's ``.cuh``
headers), so an edited kernel is always rebuilt and a current one is
loaded without compiling.  Every library exports ``kernel_error_string``.
Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
#: kernel name -> its package under ``kernels/`` (the source is
#: ``<package>/csrc/<name>.cu``)
PACKAGES = {
    "ragged_decode": "flash_attention",
    "paged_decode": "flash_attention",
    "flash_attention": "flash_attention",
    "rglru_scan": "rglru",
}
#: kernel name -> C entry point's argument types (see its source)
SIGNATURES = {
    "ragged_decode": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                      _L, _L, _L, _L, _L, _L, _F, _F, _I, _I, _I, _I, _P],
    "paged_decode": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                     _L, _L, _L, _L, _L, _L, _F, _F, _I, _I, _I, _I, _P],
    "flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                        _L, _L, _L, _L, _L, _L, _L, _L, _L, _F, _F,
                        _I, _I, _I, _P],
    "rglru_scan": [_P, _P, _P, _I, _I, _I, _L, _L, _L, _L, _L, _L,
                   _L, _L, _L, _I, _I, _P],
}

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def csrc(name: str) -> Path:
    """The ``csrc/`` directory of kernel ``name``'s package."""
    return KERNELS_DIR / PACKAGES[name] / "csrc"


def _library_path(name: str) -> Path:
    src = csrc(name)
    h = hashlib.sha256()
    for f in sorted(src.glob("*.cuh")) + [src / f"{name}.cu"]:
        h.update(f.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _command(name: str, out: Path) -> list:
    return [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(out),
            str(csrc(name) / f"{name}.cu")]


def build(names: Sequence[str] = tuple(SIGNATURES)) -> Dict[str, dict]:
    """Compile every kernel in ``names`` that has no current library, one
    nvcc process per source, all started together.  -> per kernel
    ``{"path", "seconds", "ptxas", "cached"}``; raises RuntimeError with
    the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, info = {}, {}
    for name in names:
        out = _library_path(name)
        if out.exists():
            info[name] = {"path": str(out), "seconds": 0.0, "ptxas": "",
                          "cached": True}
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        procs[name] = (subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), time.perf_counter(),
            tmp, out)
    failed = []
    for name, (proc, t0, tmp, out) in procs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode}) ---\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        tmp.replace(out)
        info[name] = {"path": str(out), "seconds": secs, "ptxas": log,
                      "cached": False}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return info


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it first if its
    current library is missing."""
    lib = _loaded.get(name)
    if lib is None:
        path = build([name])[name]["path"]
        lib = ctypes.CDLL(path)
        fn = getattr(lib, name)
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = lib.kernel_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                           f"{code} ({msg})")
