"""The factorized (hi/lo) histogram kernel for Hopper: launch plan, binding
and wrapper.

Replaces the TPU kernel ``_fact_kernel`` (``h2o3_tpu/ops/pallas_histogram.py:243``,
via ``_build_histogram_factorized`` :285): the [K, F, B1, 3] histogram of
(Σg, Σh, Σw) per (node, feature, bin), with each bin split as
``hi * 16 + lo`` and accumulated in the TPU kernel's [HI, K, C, 16] slab
layout, then permuted back and cut to B1 bins. The JAX package sends a level
to it when its padded node count K satisfies K·4 <= the factorized limit
(``H2O3_TPU_HIST_FACT_MAX_KC``, 0 by default); the port takes that limit as
the explicit ``fact_max_kc`` argument of ``ops/histogram.build_histogram``.
The CUDA source is ``h2o3_tpu_torch/csrc/hist_factorized.cu``; its header
says what bounds it on the card and how its design keeps the result
deterministic.

- ``hist_factorized`` is the wrapper: on a CUDA tensor it launches the
  kernel (or raises), on a CPU tensor it computes the plain version.
- ``hist_factorized_reference`` is the plain PyTorch version, computed the
  factorized way: an ``index_add_`` per channel into the flat [F, HI, K, 3,
  16] slab index, in float64, then the permute and slice back to [K, F, B1,
  3], rounded once to float32. The CPU tests hold it against the JAX
  package, and ``chip_smoke.py`` holds the kernel against it.
- Both take ``dtype``, the operand mode: ``"bf16"`` rounds g, h and the
  count weight to bf16 before they are added (``cuda_build.round_operand``).
- ``launch_plan`` raises ``ValueError`` for a level whose slab does not fit
  one block's shared memory; it never falls back to another kernel. The
  largest node count it takes is 71 at 257 bins (a 3,264-byte slab per
  node) and 604 at 21 bins; ``fits`` says which levels it takes, and the
  dispatch sends a level it cannot hold to the node-matmul kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from h2o3_tpu_torch.ops.cuda_build import LAUNCHES, check_hist_dtype, round_operand
from h2o3_tpu_torch.ops.cuda_histogram import (
    launch_chunked,
    load_chunked_library,
    row_chunks,
)

__all__ = ["LAUNCHES", "FACT_LO", "n_hi", "fits", "launch_plan", "load_library",
           "hist_factorized", "hist_factorized_reference"]

#: the low part of a bin code (``_FACT_LO``): bin = hi * FACT_LO + lo
FACT_LO = 16
#: most warps (one per feature) in one block
_MAX_WARPS_PER_BLOCK = 8
#: shared memory a block may use on Hopper (227 KB opt-in limit)
_SMEM_LIMIT = 232_448


def n_hi(n_bins1: int) -> int:
    """HI = ceil(B1 / 16): the slab rows (17 at 257 bins)."""
    return -(-n_bins1 // FACT_LO)


def _smem_bytes(n_nodes: int, n_bins1: int, warps_per_block: int) -> int:
    """Dynamic shared memory of one block (smem_bytes in the CUDA source):
    per warp a [HI, K, 3, 16] slab and a [3, 32] lane scratch."""
    return 4 * warps_per_block * (n_hi(n_bins1) * n_nodes * 3 * FACT_LO + 3 * 32)


def fits(n_nodes: int, n_bins1: int) -> bool:
    """Whether one warp's [HI, K, 3, 16] slab fits a block's shared memory:
    the levels ``launch_plan`` takes."""
    return _smem_bytes(n_nodes, n_bins1, 1) <= _SMEM_LIMIT


def launch_plan(n_rows: int, n_feat: int, n_nodes: int,
                n_bins1: int) -> Tuple[int, int, int]:
    """(warps per block, chunk rows, chunks) for one call.

    The row chunks are the node-matmul kernel's (``row_chunks``), a
    function of (rows, features) alone: the float summation order does not
    change with the node count, and a cell sums the same rows in the same
    order as in ``hist_nodematmul``. Raises ValueError when one warp's
    slab does not fit in shared memory."""
    per_warp = _smem_bytes(n_nodes, n_bins1, 1)
    if not fits(n_nodes, n_bins1):
        raise ValueError(
            f"hist_factorized: {n_nodes} nodes x {n_bins1} bins "
            f"({per_warp} bytes of [HI, K, 3, {FACT_LO}] slab) do not fit one "
            f"block's shared memory ({_SMEM_LIMIT} bytes)")
    wpb = max(1, min(n_feat, _MAX_WARPS_PER_BLOCK, _SMEM_LIMIT // per_warp))
    return (wpb, *row_chunks(n_rows, n_feat))


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    return load_chunked_library("hist_factorized", 8)


def hist_factorized_reference(
    bins_fm: torch.Tensor, nodes: torch.Tensor, g: torch.Tensor,
    h: torch.Tensor, n_nodes: int, n_bins1: int,
    rw: Optional[torch.Tensor] = None, dtype: str = "f32",
) -> torch.Tensor:
    """Plain PyTorch histogram [K, F, B1, 3] float32 of (Σg, Σh, Σw),
    computed through the factorized slab.

    bins_fm: [F, N] int bin codes (feature-major); nodes: [N] int (-1 =
    inactive row); g, h: [N] float; rw: optional [N] count weight; dtype:
    the operand mode (``"bf16"`` rounds g, h and rw to bf16 first). Each
    channel's masked values are added (float64 ``index_add_``) at the flat
    slab index (f, hi, k, c, lo) of [F, HI, K, 3, 16]; the slab is then
    permuted to [K, F, HI·16, 3] and cut to B1 bins, as the JAX package
    transposes the kernel's [HI, (k, c, lo)] output."""
    g, h = round_operand(g, dtype), round_operand(h, dtype)
    rw = None if rw is None else round_operand(rw, dtype)
    n_feat, n = bins_fm.shape
    dev = bins_fm.device
    hi_n = n_hi(n_bins1)
    valid = nodes >= 0
    node = torch.where(valid, nodes, 0).long()
    codes = bins_fm.long()
    feat = torch.arange(n_feat, device=dev)[:, None]
    # flat slab index of channel 0; channel c adds c * 16
    flat = ((((feat * hi_n + codes // FACT_LO) * n_nodes + node[None, :]) * 3)
            * FACT_LO + codes % FACT_LO).reshape(-1)
    w = valid.double()
    cw = w if rw is None else w * rw.double()
    slab = torch.zeros(n_feat * hi_n * n_nodes * 3 * FACT_LO,
                       dtype=torch.float64, device=dev)
    for c, v in enumerate((g.double() * w, h.double() * w, cw)):
        slab.index_add_(0, flat + c * FACT_LO, v.expand(n_feat, n).reshape(-1))
    out = slab.reshape(n_feat, hi_n, n_nodes, 3, FACT_LO).permute(2, 0, 1, 4, 3)
    return out.reshape(n_nodes, n_feat, hi_n * FACT_LO, 3)[:, :, :n_bins1] \
        .float().contiguous()


def hist_factorized(
    bins_fm: torch.Tensor, nodes: torch.Tensor, g: torch.Tensor,
    h: torch.Tensor, n_nodes: int, n_bins1: int,
    rw: Optional[torch.Tensor] = None, dtype: str = "f32",
) -> torch.Tensor:
    """Histogram [K, F, B1, 3] float32 of (Σg, Σh, Σw) per (node, feature,
    bin) over the rows whose node is >= 0. Bin codes lie in [0, n_bins1)
    and nodes in [-1, n_nodes), as the booster makes them. dtype: the
    operand mode, ``"f32"`` or ``"bf16"`` (g, h and rw rounded to bf16,
    summed in float); any other value raises ValueError.

    On a CUDA tensor: launches the kernel's instantiation for ``dtype`` on
    the current stream (bins_fm [F, N] int32, nodes [N] int32, g/h/rw [N]
    float32, all contiguous on one card) and raises on anything else, on a
    level whose slab does not fit shared memory, or on a launch error. On a
    CPU tensor: the plain version, ``hist_factorized_reference``."""
    check_hist_dtype(dtype)
    if bins_fm.device.type == "cpu":
        return hist_factorized_reference(bins_fm, nodes, g, h, n_nodes, n_bins1,
                                         rw=rw, dtype=dtype)
    # partials [chunks, F, HI, K, 3, 16]
    return launch_chunked("hist_factorized", launch_plan,
                          n_hi(n_bins1) * n_nodes * 3 * FACT_LO,
                          bins_fm, nodes, g, h, n_nodes, n_bins1, rw,
                          extra=(int(dtype == "bf16"),))
