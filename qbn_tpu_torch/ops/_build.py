"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` has a plain `extern "C"` interface and includes no
PyTorch header, so nvcc compiles it in seconds. The shared library goes to
`qbn_tpu_torch/_build/` (listed in .gitignore) at first use in a process
and is rebuilt when its source or a shared header (`csrc/*.cuh`) is
newer. Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}
# the compiler's report (registers, spills) of each build, by source name
BUILD_LOGS: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build(name: str, force: bool = False) -> Path:
    """Compile csrc/<name>.cu into _build/lib<name>.so if it is missing or
    older than its source or a header (or `force`); returns its path."""
    src = CSRC_DIR / f"{name}.cu"
    lib = BUILD_DIR / f"lib{name}.so"
    newest = max(p.stat().st_mtime
                 for p in [src, *CSRC_DIR.glob("*.cuh")])
    if not force and lib.exists() and lib.stat().st_mtime >= newest:
        return lib
    BUILD_DIR.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)],
            capture_output=True, text=True)
        BUILD_LOGS[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src} ({proc.returncode}):\n"
                f"{BUILD_LOGS[name]}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def build_all(names, force: bool = False) -> dict:
    """Build several sources at once, one nvcc each, all started together;
    returns {name: library path}."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        futures = {n: pool.submit(build, n, force) for n in names}
        return {n: f.result() for n, f in futures.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built at first use."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build(name)))
    return _LIBS[name]
