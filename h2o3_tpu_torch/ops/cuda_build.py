"""Build-at-first-use of the port's CUDA kernels, and their launch counts.

Each ``h2o3_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain C interface,
``h2o3_tpu_torch/_build/lib<name>_<hash>.so`` (the directory is listed in
``.gitignore``); the hash covers the source and the flags, so an edited
source builds anew. Libraries are loaded with ``ctypes``. Nothing is built
or loaded at import time: the first launch of a kernel builds its library,
and ``build`` starts one ``nvcc`` per source at once for a caller that
wants every kernel ready up front.

``LAUNCHES`` counts each kernel's launches; only a wrapper adds to it,
right after it launched its kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

#: the kernels of the port, by source name under csrc/
KERNELS = ("hist_nodematmul", "hist_sorted", "hist_factorized")

#: launches of each kernel, counted by its wrapper where it launches
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

#: nvcc's output (ptxas register and shared-memory report) of each build
BUILD_LOGS: Dict[str, str] = {}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def source(name: str) -> Path:
    return CSRC / f"{name}.cu"


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` goes (content-hashed)."""
    src = source(name).read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: cannot build the port's CUDA kernels")
    return nvcc


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile the named kernels (default: all) that are not built yet,
    one ``nvcc`` process per source, all started together. Raises with
    nvcc's output if any build fails."""
    names = list(KERNELS if names is None else names)
    outs = {n: library_path(n) for n in names}
    todo = [n for n in names if not outs[n].exists()]
    if not todo:
        return outs
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    try:
        for n in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            procs[n] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, str(source(n))],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for n, (tmp, proc) in procs.items():
            BUILD_LOGS[n] = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}) building "
                              f"{source(n)}:\n{BUILD_LOGS[n]}")
            else:
                os.replace(tmp, outs[n])
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for tmp, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return outs


def load_library(name: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """Build (at first use) and load the library of ``csrc/<name>.cu``;
    ``bind`` sets its functions' argument and result types once."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            bind(lib)
            _libs[name] = lib
    return lib


def check_tensor(kernel: str, name: str, t, dtype, shape: tuple, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` — what a kernel's C interface takes."""
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{kernel}: {name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(
            f"{kernel}: {name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")
