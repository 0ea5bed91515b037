"""Build and load the port's hand-written kernels from the repo's sources.

CUDA C++ sources under ``kernels/csrc/`` are compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded with
``ctypes``.  That route needs neither ninja nor PyTorch's headers, so a build
takes seconds instead of the minutes ``torch.utils.cpp_extension.load``
spends compiling against ``torch/extension.h``.

Everything is built at first use into ``build/osga_torch_kernels/`` at the
root of the checkout, under a name keyed by a hash of the sources and the
compiler flags, so an edited source always rebuilds and an unchanged one is
reused.  Triton kernels JIT-compile at their first launch; their cache is
pointed at the same directory.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parents[1] / "build" / "osga_torch_kernels"

NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-lineinfo",
    "-Xptxas=-v",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

# loaded libraries by name: a process-wide cache of dlopen'ed handles
_LOADED: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found on PATH or under /usr/local/cuda/bin")


def _source_key(sources) -> str:
    h = hashlib.sha256()
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build_cuda_library(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` (if not already built) and return the .so path.

    The compiler's ``-Xptxas -v`` report (registers, shared memory, spills)
    is kept beside the library as ``<lib>.log``.
    """
    sources = [CSRC_DIR / f"{name}.cu"]
    key = _source_key(sources)
    so_path = BUILD_DIR / f"lib{name}_{key}.so"
    if so_path.exists():
        return so_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
    Path(str(so_path) + ".log").write_text(log)
    # atomic publish: a concurrent build sees either no file or a whole one
    os.replace(tmp, so_path)
    return so_path


def load_cuda_library(name: str) -> ctypes.CDLL:
    """Build (once per source hash) and dlopen ``csrc/<name>.cu``."""
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(str(build_cuda_library(name)))
    return _LOADED[name]


def import_triton():
    """Import triton with its compile cache under the build directory.

    Called inside each launcher, never at module import: hosts without a
    GPU have no triton, and the CPU tests import every module.
    """
    cache = BUILD_DIR / "triton"
    cache.mkdir(parents=True, exist_ok=True)
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache))
    import triton
    import triton.language as tl

    return triton, tl


class LaunchCounter:
    """Counts the launches of one kernel; each wrapper owns one."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def add(self) -> None:
        self.count += 1

    def reset(self) -> None:
        self.count = 0
