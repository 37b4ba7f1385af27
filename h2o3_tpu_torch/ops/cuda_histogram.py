"""The node-matmul histogram kernel for Hopper: build, binding and wrapper.

Replaces the TPU kernel ``_nm_kernel`` (``h2o3_tpu/ops/pallas_histogram.py:94``,
via ``_build_histogram_nodematmul`` :162): the [K, F, B1, 3] histogram of
(Σg, Σh, Σw) per (node, feature, bin) for every node of one tree level in
one pass. The CUDA source is ``h2o3_tpu_torch/csrc/hist_nodematmul.cu``; its
header says what bounds it on the card and how its design keeps the result
deterministic.

- ``hist_nodematmul`` is the wrapper: on a CUDA tensor it launches the
  kernel (or raises), on a CPU tensor it computes the plain version.
- ``hist_nodematmul_reference`` is the plain PyTorch version: an
  ``index_add_`` over the flat (node, feature, bin) index, accumulated in
  float64 and rounded once to float32. The CPU tests hold it against the
  JAX package, and ``chip_smoke.py`` holds the kernel against it.
- The shared library is built from the source with ``nvcc`` on first use
  (``ops/cuda_build.py``) and loaded with ``ctypes``. Nothing is built or
  imported at module import time.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple

import torch

from h2o3_tpu_torch.ops.cuda_build import (
    LAUNCHES,
    check_tensor,
    load_library as _load,
    reset_launch_counts,
)

__all__ = ["LAUNCHES", "reset_launch_counts", "load_library", "launch_plan",
           "row_chunks", "load_chunked_library", "launch_chunked",
           "hist_nodematmul", "hist_nodematmul_reference"]

#: most warps (one per feature) in one block
_MAX_WARPS_PER_BLOCK = 8
#: shared memory a block may use on Hopper (227 KB opt-in limit)
_SMEM_LIMIT = 232_448
#: longest row chunk one warp sums in float before the float64 reduce
_MAX_CHUNK_ROWS = 32_768
#: shortest row chunk worth a warp of its own
_MIN_CHUNK_ROWS = 1_024
#: (feature, chunk) warps wanted per call: 16 for each of the card's 132 SMs
_TARGET_WARPS = 132 * 16


def _smem_bytes(n_nodes: int, n_bins1: int, warps_per_block: int) -> int:
    """Dynamic shared memory of one block (smem_bytes in the CUDA source):
    per warp a [K, 3, B1] histogram and a [3, 32] lane scratch."""
    return 4 * warps_per_block * (n_nodes * 3 * n_bins1 + 3 * 32)


def launch_plan(n_rows: int, n_feat: int, n_nodes: int,
                n_bins1: int) -> Tuple[int, int, int]:
    """(warps per block, chunk rows, chunks) for one call.

    The row chunks are a function of (rows, features) alone, so the float
    summation order — and the result — is the same on every run and every
    card, and does not change with the node count: a level padded to more
    nodes gives bit-identical cells. Raises ValueError when one warp's
    [K, 3, B1] histogram does not fit in shared memory."""
    per_warp = _smem_bytes(n_nodes, n_bins1, 1)
    if per_warp > _SMEM_LIMIT:
        raise ValueError(
            f"hist_nodematmul: {n_nodes} nodes x {n_bins1} bins do not fit "
            f"one block's shared memory ({_SMEM_LIMIT} bytes)")
    wpb = max(1, min(n_feat, _MAX_WARPS_PER_BLOCK, _SMEM_LIMIT // per_warp))
    return (wpb, *row_chunks(n_rows, n_feat))


def row_chunks(n_rows: int, n_feat: int) -> Tuple[int, int]:
    """(chunk rows, chunks): the row chunks one warp each sums in float
    before the float64 reduce, a function of (rows, features) alone. The
    factorized kernel cuts rows the same way."""
    n_chunks = max(-(-n_rows // _MAX_CHUNK_ROWS),
                   min(-(-n_rows // _MIN_CHUNK_ROWS), -(-_TARGET_WARPS // n_feat)))
    n_chunks = max(1, n_chunks)
    chunk_rows = -(-n_rows // n_chunks)
    chunk_rows = -(-chunk_rows // 32) * 32
    return chunk_rows, -(-n_rows // chunk_rows)


def load_chunked_library(kernel: str) -> ctypes.CDLL:
    """Build (at first use) and load the library of a row-chunked histogram
    kernel: ``<kernel>_launch`` and ``<kernel>_error_string``, the C
    interface the node-matmul and factorized kernels share."""
    def bind(lib: ctypes.CDLL) -> None:
        p, i = ctypes.c_void_p, ctypes.c_int
        launch = getattr(lib, f"{kernel}_launch")
        launch.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, p]
        launch.restype = i
        errs = getattr(lib, f"{kernel}_error_string")
        errs.argtypes = [i]
        errs.restype = ctypes.c_char_p

    return _load(kernel, bind)


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    return load_chunked_library("hist_nodematmul")


def hist_nodematmul_reference(
    bins_fm: torch.Tensor, nodes: torch.Tensor, g: torch.Tensor,
    h: torch.Tensor, n_nodes: int, n_bins1: int,
    rw: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch histogram [K, F, B1, 3] float32 of (Σg, Σh, Σw).

    bins_fm: [F, N] int bin codes (feature-major); nodes: [N] int (-1 =
    inactive row); g, h: [N] float; rw: optional [N] count weight. An
    ``index_add_`` per channel over the flat (node, feature, bin) index,
    in float64 so the float32 result is the correctly rounded sum."""
    n_feat, n = bins_fm.shape
    dev = bins_fm.device
    valid = nodes >= 0
    node = torch.where(valid, nodes, 0).long()
    flat = ((node[None, :] * n_feat
             + torch.arange(n_feat, device=dev)[:, None]) * n_bins1
            + bins_fm.long()).reshape(-1)
    w = valid.double()
    cw = w if rw is None else w * rw.double()
    size = n_nodes * n_feat * n_bins1
    out = torch.zeros(3, size, dtype=torch.float64, device=dev)
    for c, v in enumerate((g.double() * w, h.double() * w, cw)):
        out[c].index_add_(0, flat, v.expand(n_feat, n).reshape(-1))
    return out.reshape(3, n_nodes, n_feat, n_bins1).permute(1, 2, 3, 0) \
        .float().contiguous()


def launch_chunked(
    kernel: str, plan: Callable[[int, int, int, int], Tuple[int, int, int]],
    slab_cells: int, bins_fm: torch.Tensor, nodes: torch.Tensor,
    g: torch.Tensor, h: torch.Tensor, n_nodes: int, n_bins1: int,
    rw: Optional[torch.Tensor],
) -> torch.Tensor:
    """Launch a row-chunked histogram kernel on CUDA tensors: check the
    level's inputs (bins_fm [F, N] int32, nodes [N] int32, g/h/rw [N]
    float32, all contiguous on one card), allocate the [K, F, B1, 3] output
    and the [chunks, F, slab_cells] float32 partials, launch on the current
    stream, raise on a launch error, and count the launch.
    ``plan(rows, features, nodes, bins)`` gives (warps per block, chunk
    rows, chunks)."""
    if bins_fm.device.type != "cuda":
        raise ValueError(f"{kernel}: unsupported device {bins_fm.device}")
    dev = bins_fm.device
    if bins_fm.dim() != 2:
        raise ValueError(f"{kernel}: bins_fm must be [F, N]")
    n_feat, n = bins_fm.shape
    check_tensor(kernel, "bins_fm", bins_fm, torch.int32, (n_feat, n), dev)
    for name, t, dtype in (("nodes", nodes, torch.int32), ("g", g, torch.float32),
                           ("h", h, torch.float32), ("rw", rw, torch.float32)):
        if t is not None:
            check_tensor(kernel, name, t, dtype, (n,), dev)
    if n_nodes < 1 or n_bins1 < 1:
        raise ValueError(f"{kernel}: n_nodes and n_bins1 must be >= 1")
    out = torch.empty((n_nodes, n_feat, n_bins1, 3), dtype=torch.float32, device=dev)
    if n == 0 or n_feat == 0:
        return out.zero_()
    wpb, chunk_rows, n_chunks = plan(n, n_feat, n_nodes, n_bins1)
    partial = torch.empty((n_chunks, n_feat, slab_cells), dtype=torch.float32, device=dev)
    lib = load_chunked_library(kernel)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, f"{kernel}_launch")(
            bins_fm.data_ptr(), nodes.data_ptr(), g.data_ptr(), h.data_ptr(),
            None if rw is None else rw.data_ptr(), partial.data_ptr(),
            out.data_ptr(), n, n_feat, n_nodes, n_bins1, wpb, chunk_rows,
            n_chunks, stream,
        )
    if err != 0:
        msg = getattr(lib, f"{kernel}_error_string")(err).decode()
        raise RuntimeError(f"{kernel} launch failed: {msg} (cuda error {err})")
    LAUNCHES[kernel] += 1
    return out


def hist_nodematmul(
    bins_fm: torch.Tensor, nodes: torch.Tensor, g: torch.Tensor,
    h: torch.Tensor, n_nodes: int, n_bins1: int,
    rw: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Histogram [K, F, B1, 3] float32 of (Σg, Σh, Σw) per (node, feature,
    bin) over the rows whose node is >= 0. Bin codes lie in [0, n_bins1)
    and nodes in [-1, n_nodes), as the booster makes them.

    On a CUDA tensor: launches the kernel on the current stream (bins_fm
    [F, N] int32, nodes [N] int32, g/h/rw [N] float32, all contiguous on one
    card) and raises on anything else or on a launch error. On a CPU
    tensor: the plain version, ``hist_nodematmul_reference``."""
    if bins_fm.device.type == "cpu":
        return hist_nodematmul_reference(bins_fm, nodes, g, h, n_nodes, n_bins1, rw=rw)
    # partials [chunks, F, K, 3, B1]
    return launch_chunked("hist_nodematmul", launch_plan, n_nodes * 3 * n_bins1,
                          bins_fm, nodes, g, h, n_nodes, n_bins1, rw)
