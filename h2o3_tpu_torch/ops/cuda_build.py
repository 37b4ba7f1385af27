"""Build-at-first-use of the port's CUDA kernels, and their launch counts.

Each ``h2o3_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain C interface,
``h2o3_tpu_torch/_build/lib<name>_<hash>.so`` (the directory is listed in
``.gitignore``); the hash covers the source, the headers beside it
(``csrc/*.cuh``) and the flags, so an edited source or header builds
anew. Libraries are loaded with ``ctypes``. Nothing is built or loaded at
import time: the first launch of a kernel builds its library,
and ``build`` starts one ``nvcc`` per source at once for a caller that
wants every kernel ready up front.

``LAUNCHES`` counts each kernel's launches; only a wrapper adds to it,
right after it launched its kernel.

``HIST_DTYPES`` are the kernels' operand modes (``hist_operand.cuh``):
``"f32"`` reads g, h and the count weight as they are, ``"bf16"`` rounds
each to bf16 first, as the JAX package's ``_resolve_hist_dtype``
(``h2o3_tpu/ops/pallas_histogram.py:438``) does on its own chip;
``round_operand`` is that rounding for the plain versions.
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

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

#: the kernels of the port, by source name under csrc/
KERNELS = ("hist_nodematmul", "hist_sorted", "hist_factorized")

#: the kernels' operand modes: float32 values, or values rounded to bf16
HIST_DTYPES = ("f32", "bf16")

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
    """Where the library of ``csrc/<name>.cu`` goes (hashed over its
    source, the headers in ``csrc/`` and the flags)."""
    sha = hashlib.sha1(source(name).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        sha.update(header.name.encode() + header.read_bytes())
    sha.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{sha.hexdigest()[:12]}.so"


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


def check_hist_dtype(dtype: str) -> str:
    """``dtype`` if it is one of ``HIST_DTYPES``, else ValueError with the
    JAX package's wording (``pallas_histogram.py:450``)."""
    if dtype not in HIST_DTYPES:
        raise ValueError(f"hist dtype must be 'f32' or 'bf16', got {dtype!r}")
    return dtype


def round_operand(v: torch.Tensor, dtype: str) -> torch.Tensor:
    """``v`` as a kernel in operand mode ``dtype`` reads it: for ``"bf16"``
    its float32 value rounded to bf16 (to nearest even) and widened back to
    float32, as the JAX package casts its float32 operands; for ``"f32"``
    ``v`` itself."""
    if check_hist_dtype(dtype) == "bf16":
        return v.float().to(torch.bfloat16).float()
    return v
