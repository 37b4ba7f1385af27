"""The factorized (hi/lo) histogram kernel for Hopper: launch plan, binding
and wrapper.

Replaces the TPU kernel ``_fact_kernel`` (``h2o3_tpu/ops/pallas_histogram.py:243``,
via ``_build_histogram_factorized`` :285): the [K, F, B1, 3] histogram of
(Σg, Σh, Σw) per (node, feature, bin), which the TPU kernel accumulates in
an [HI, K, C, 16] slab with each bin split as ``hi * 16 + lo``. The JAX
package sends a level to it when its padded node count K satisfies K·4 <=
the factorized limit (``H2O3_TPU_HIST_FACT_MAX_KC``, 0 by default); the port
takes that limit as the explicit ``fact_max_kc`` argument of
``ops/histogram.build_histogram``. The CUDA source is
``h2o3_tpu_torch/csrc/hist_factorized.cu``; its header describes its two
pass-1 kernels (a direct one whose warps read their own rows into the TPU
kernel's [HI, K, 3, 16] slab, and a staged one whose block stages its row
chunk once and packs the active rows), what bounds them on the card, and
how both keep the node-matmul kernel's float order.

- ``hist_factorized`` is the wrapper: on a CUDA tensor it launches the
  kernel (or raises), on a CPU tensor it computes the plain version.
- ``hist_factorized_reference`` is the plain PyTorch version, computed the
  factorized way: an ``index_add_`` per channel into the flat [F, HI, K, 3,
  16] slab index, in float64, then the permute and slice back to [K, F, B1,
  3], rounded once to float32. The CPU tests hold it against the JAX
  package, and ``chip_smoke.py`` holds the kernel against it. The kernel's
  bits are those of ``cuda_histogram.hist_chunked_ordered_reference``.
- Both take ``dtype``, the operand mode: ``"bf16"`` rounds g, h and the
  count weight to bf16 before they are added (``cuda_build.round_operand``).
- ``launch_plan`` picks the pass-1 kernel and its blocks, and raises
  ``ValueError`` for a level ``fits`` refuses; it never falls back to
  another kernel. ``fits`` takes the levels whose TPU-layout slab (one
  warp's [HI, K, 3, 16] floats and a [3, 32] lane scratch, 3,264 bytes a
  node at 257 bins) fits a block's shared memory: up to 71 nodes at 257
  bins and 604 at 21, the levels the factorized kernel has always taken.
  The dispatch sends a level it refuses to the node-matmul kernel.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from h2o3_tpu_torch.ops.cuda_build import LAUNCHES, check_hist_dtype, round_operand
from h2o3_tpu_torch.ops.cuda_histogram import (
    launch_chunked,
    load_chunked_library,
    row_chunks,
)

__all__ = ["LAUNCHES", "FACT_LO", "FactPlan", "n_hi", "fits",
           "launch_plan", "load_library", "hist_factorized",
           "hist_factorized_reference"]

#: the low part of a bin code (``_FACT_LO``): bin = hi * FACT_LO + lo
FACT_LO = 16
#: most features a block takes, one warp each (kMaxGroup); a block of the
#: direct kernel takes one
_MAX_GROUP = 8
#: the direct kernel's lane scratch, 32-bit words a warp
_SCRATCH_WORDS = 3 * 32
#: the staged kernel's ring of stages (kStages) and the rows a stage
#: holds, the most first
_STAGES = 4
_STAGE_ROWS = (256, 128, 64, 32)
#: shared memory a block may use on Hopper (227 KB opt-in limit)
_SMEM_LIMIT = 232_448
#: shared memory of one SM, what the card keeps of it for each block, and
#: the most blocks an SM holds
_SM_SMEM = 233_472
_BLOCK_RESERVED = 1_024
_SM_BLOCKS = 32
#: the direct kernel takes a level while an SM holds more than this many of
#: its warps; with fewer, its (feature, chunk) walks take a third round of
#: the SMs at 28 features x 2M rows, and the staged kernel takes the level
_DIRECT_MIN_WARPS = 8


class FactPlan(NamedTuple):
    """One call's launch: ``group`` features a block (one warp each), the
    row chunks (``row_chunks``), and for the staged kernel (``staged`` 1)
    ``stage_rows`` rows a stage."""

    group: int
    chunk_rows: int
    n_chunks: int
    stage_rows: int
    staged: int


def n_hi(n_bins1: int) -> int:
    """HI = ceil(B1 / 16): the TPU slab's rows (17 at 257 bins)."""
    return -(-n_bins1 // FACT_LO)


def _words16(words: int) -> int:
    return -(-words // 4) * 4


def _smem_bytes(n_nodes: int, n_bins1: int, group: int, rows: int = 0,
                staged: bool = False) -> int:
    """Dynamic shared memory of one block (smem_bytes in the CUDA source):
    the direct kernel's warps' [HI, K, 3, 16] slabs and [3, 32] lane
    scratch, or the staged kernel's consumers' [K, 3, B1] histograms and
    its ring of stages (node, g, h, rw, the group's codes, the packed row
    list and the pack table)."""
    if not staged:
        return 4 * group * (n_hi(n_bins1) * n_nodes * 3 * FACT_LO + _SCRATCH_WORDS)
    hist = _words16(n_nodes * 3 * n_bins1)
    stage = _words16((4 + group) * rows + rows // 2 + rows // 32 + 2)
    return 4 * (group * hist + _STAGES * stage)


def fits(n_nodes: int, n_bins1: int) -> bool:
    """Whether the kernel takes a level: one direct warp's slab and lane
    scratch fit a block's shared memory (the levels the factorized kernel
    has always taken)."""
    return _smem_bytes(n_nodes, n_bins1, 1) <= _SMEM_LIMIT


def _spread(n_feat: int, most: int) -> int:
    """Features a block: at most ``most``, spread evenly over the fewest
    blocks (7 a block at 28 features and 8 at most)."""
    blocks = -(-n_feat // min(most, n_feat))
    return -(-n_feat // blocks)


def launch_plan(n_rows: int, n_feat: int, n_nodes: int, n_bins1: int) -> FactPlan:
    """The launch of one call.

    The row chunks are the node-matmul kernel's (``row_chunks``), a
    function of (rows, features) alone: a cell sums the same rows in the
    same order as in ``hist_nodematmul``, whichever pass-1 kernel runs. The
    direct kernel (one feature a block, its warp reading its own rows)
    takes a level while an SM holds more than 8 of its blocks; a wider one
    (from 8 nodes at 257 bins, 64 at 21) goes to the staged kernel, with as
    many features a block as fit, up to 8, spread evenly over the fewest
    blocks, and the largest stages that let it hold them. Raises ValueError
    on a level ``fits`` refuses."""
    if not fits(n_nodes, n_bins1):
        raise ValueError(
            f"hist_factorized: {n_nodes} nodes x {n_bins1} bins do not fit one "
            f"block's shared memory ({_SMEM_LIMIT} bytes)")
    chunk_rows, n_chunks = row_chunks(n_rows, n_feat)
    per_sm = min(_SM_BLOCKS,
                 _SM_SMEM // (_smem_bytes(n_nodes, n_bins1, 1) + _BLOCK_RESERVED))
    # the staged kernel: per stage size, the features a block holds; the
    # most, then the largest stages
    staged = max(
        ((_spread(n_feat, max(w for w in range(1, _MAX_GROUP + 1)
                              if _smem_bytes(n_nodes, n_bins1, w, rows, True)
                              <= _SMEM_LIMIT)), rows)
         for rows in _STAGE_ROWS
         if _smem_bytes(n_nodes, n_bins1, 1, rows, True) <= _SMEM_LIMIT),
        default=None)
    if per_sm > _DIRECT_MIN_WARPS or staged is None:
        return FactPlan(1, chunk_rows, n_chunks, 0, 0)
    group, rows = staged
    return FactPlan(group, chunk_rows, n_chunks, rows, 1)


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    return load_chunked_library("hist_factorized", 10)


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
    level ``fits`` refuses, or on a launch error. On a CPU tensor: the
    plain version, ``hist_factorized_reference``."""
    check_hist_dtype(dtype)
    if bins_fm.device.type == "cpu":
        return hist_factorized_reference(bins_fm, nodes, g, h, n_nodes, n_bins1,
                                         rw=rw, dtype=dtype)
    # partials [chunks, F, HI * K * 3 * 16]: one slab a (chunk, feature)
    return launch_chunked("hist_factorized", launch_plan,
                          n_hi(n_bins1) * n_nodes * 3 * FACT_LO,
                          bins_fm, nodes, g, h, n_nodes, n_bins1, rw,
                          extra=(int(dtype == "bf16"),))
