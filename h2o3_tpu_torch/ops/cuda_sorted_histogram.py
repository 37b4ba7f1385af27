"""The sorted per-node histogram kernel for Hopper: prep, binding and wrapper.

Replaces the TPU kernel ``_hist_kernel`` (``h2o3_tpu/ops/pallas_histogram.py:353``,
prep ``_prep_padded`` :388, launched from the sorted branch of
``_build_histogram_pallas_jit`` :510-543): the [K, F, B1, 3] histogram of
(Σg, Σh, Σw) per (node, feature, bin) for the wide levels of a tree, those
whose padded node count times 4 channels exceeds 512 (DRF's levels 8-11 at
its default depth 12). The CUDA source is
``h2o3_tpu_torch/csrc/hist_sorted.cu``; its header says what bounds it on
the card and how its design keeps the result deterministic.

- ``sorted_prep`` is the prep, plain PyTorch on the tensors' device (the
  counterpart of the XLA code around the Pallas body): a stable sort of row
  ids by node with inactive rows sent to the dummy node K, each node's
  segment offset, and each node's first tile (segments cut into tiles of
  at most ``TILE_ROWS`` rows, at least one tile per node).
- ``hist_sorted`` is the wrapper: on a CUDA tensor it runs the prep and
  launches the kernel (or raises), on a CPU tensor it computes the plain
  version.
- ``hist_sorted_reference`` is the plain version: the same prep, then an
  ``index_add_`` over the sorted layout in float64, rounded once to
  float32. The CPU tests hold it against the JAX package, and
  ``chip_smoke.py`` holds the kernel against it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from h2o3_tpu_torch.ops.cuda_build import LAUNCHES, check_tensor, load_library as _load

#: longest run of one node's rows one warp sums in float before the
#: float64 reduce over the node's tiles
TILE_ROWS = 4096
#: most warps (one per feature) in one block
_MAX_WARPS_PER_BLOCK = 8
#: shared memory a block may use on Hopper (227 KB opt-in limit)
_SMEM_LIMIT = 232_448


class SortedLayout(NamedTuple):
    """Rows sorted by node, as ``sorted_prep`` lays them out.

    order: [N] int32 row ids, stable-sorted by node, inactive rows last;
    seg_off: [K + 1] int32, node k's rows are order[seg_off[k]:seg_off[k+1]]
    (seg_off[K] = active rows); tile_off: [K + 1] int32, node k owns tiles
    tile_off[k] .. tile_off[k+1]-1 (tile_off[K] = tiles used)."""

    order: torch.Tensor
    seg_off: torch.Tensor
    tile_off: torch.Tensor

    @property
    def counts(self) -> torch.Tensor:
        """Active rows per node, [K]."""
        return self.seg_off[1:] - self.seg_off[:-1]


def sorted_prep(nodes: torch.Tensor, n_nodes: int,
                tile_rows: int = TILE_ROWS) -> SortedLayout:
    """Sort rows by node on ``nodes``' device. A node outside [0, n_nodes)
    (-1 marks an inactive row) goes to the dummy node n_nodes, after every
    real node, and is in no segment."""
    dev = nodes.device
    nd = torch.where((nodes >= 0) & (nodes < n_nodes), nodes,
                     n_nodes).to(torch.int32)
    nd_sorted, order = torch.sort(nd, stable=True)
    seg_off = torch.searchsorted(
        nd_sorted, torch.arange(n_nodes + 1, dtype=torch.int32, device=dev)
    ).to(torch.int32)
    counts = seg_off[1:] - seg_off[:-1]
    tiles = torch.clamp((counts + tile_rows - 1) // tile_rows, min=1)
    tile_off = torch.zeros(n_nodes + 1, dtype=torch.int32, device=dev)
    tile_off[1:] = torch.cumsum(tiles, 0)
    return SortedLayout(order.to(torch.int32), seg_off, tile_off)


def launch_plan(n_rows: int, n_feat: int, n_bins1: int,
                tile_rows: int = TILE_ROWS) -> Tuple[int, int]:
    """(warps per block, tiles to launch) for one call. The tiles launched
    bound the tiles used: every node owns max(1, ceil(rows / tile_rows))
    tiles, at most n_nodes + n_rows // tile_rows in all; the wrapper adds
    n_nodes. Raises ValueError when one block's shared memory does not fit."""
    wpb = max(1, min(n_feat, _MAX_WARPS_PER_BLOCK))
    if _smem_bytes(n_bins1, wpb) > _SMEM_LIMIT:
        raise ValueError(
            f"hist_sorted: {n_bins1} bins do not fit one block's shared memory")
    return wpb, n_rows // tile_rows


def _smem_bytes(n_bins1: int, warps_per_block: int) -> int:
    """Dynamic shared memory of one block (smem_bytes in the CUDA source):
    per warp a [3, B1] histogram and a [3, 32] lane scratch."""
    return 4 * warps_per_block * (3 * n_bins1 + 3 * 32)


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hist_sorted_launch.argtypes = [p, p, p, p, p, p, p, p, p,
                                       i, i, i, i, i, i, i, p]
    lib.hist_sorted_launch.restype = i
    lib.hist_sorted_error_string.argtypes = [i]
    lib.hist_sorted_error_string.restype = ctypes.c_char_p


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    return _load("hist_sorted", _bind)


def hist_sorted_reference(
    bins_fm: torch.Tensor, nodes: torch.Tensor, g: torch.Tensor,
    h: torch.Tensor, n_nodes: int, n_bins1: int,
    rw: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch histogram [K, F, B1, 3] float32 of (Σg, Σh, Σw).

    The kernel's prep (``sorted_prep``), then one ``index_add_`` per
    channel over the flat (node, feature, bin) index of the rows in sorted
    order, in float64 so the float32 result is the correctly rounded sum.
    Inactive rows (and rows of nodes outside [0, n_nodes)) add nothing."""
    n_feat, n = bins_fm.shape
    dev = bins_fm.device
    rows = sorted_prep(nodes, n_nodes).order.long()
    node = nodes[rows].long()
    valid = (node >= 0) & (node < n_nodes)
    node = torch.where(valid, node, 0)
    flat = ((node[None, :] * n_feat
             + torch.arange(n_feat, device=dev)[:, None]) * n_bins1
            + bins_fm[:, rows].long()).reshape(-1)
    w = valid.double()
    cw = w if rw is None else w * rw[rows].double()
    out = torch.zeros(3, n_nodes * n_feat * n_bins1, dtype=torch.float64, device=dev)
    for c, v in enumerate((g[rows].double() * w, h[rows].double() * w, cw)):
        out[c].index_add_(0, flat, v.expand(n_feat, n).reshape(-1))
    return out.reshape(3, n_nodes, n_feat, n_bins1).permute(1, 2, 3, 0) \
        .float().contiguous()


def _check(name, t, dtype, shape, device) -> None:
    check_tensor("hist_sorted", name, t, dtype, shape, device)


def hist_sorted(
    bins_fm: torch.Tensor, nodes: torch.Tensor, g: torch.Tensor,
    h: torch.Tensor, n_nodes: int, n_bins1: int,
    rw: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Histogram [K, F, B1, 3] float32 of (Σg, Σh, Σw) per (node, feature,
    bin) over the rows whose node lies in [0, n_nodes). Bin codes lie in
    [0, n_bins1), as the booster makes them.

    On a CUDA tensor: runs the prep and launches the kernel on the current
    stream (bins_fm [F, N] int32, nodes [N] int32, g/h/rw [N] float32, all
    contiguous on one card) and raises on anything else or on a launch
    error. On a CPU tensor: the plain version, ``hist_sorted_reference``."""
    if bins_fm.device.type == "cpu":
        return hist_sorted_reference(bins_fm, nodes, g, h, n_nodes, n_bins1, rw=rw)
    if bins_fm.device.type != "cuda":
        raise ValueError(f"hist_sorted: unsupported device {bins_fm.device}")
    dev = bins_fm.device
    if bins_fm.dim() != 2:
        raise ValueError("hist_sorted: bins_fm must be [F, N]")
    n_feat, n = bins_fm.shape
    _check("bins_fm", bins_fm, torch.int32, (n_feat, n), dev)
    _check("nodes", nodes, torch.int32, (n,), dev)
    _check("g", g, torch.float32, (n,), dev)
    _check("h", h, torch.float32, (n,), dev)
    if rw is not None:
        _check("rw", rw, torch.float32, (n,), dev)
    if n_nodes < 1 or n_bins1 < 1:
        raise ValueError("hist_sorted: n_nodes and n_bins1 must be >= 1")
    out = torch.empty((n_nodes, n_feat, n_bins1, 3), dtype=torch.float32, device=dev)
    if n == 0 or n_feat == 0:
        return out.zero_()
    wpb, extra_tiles = launch_plan(n, n_feat, n_bins1)
    n_tiles = n_nodes + extra_tiles
    layout = sorted_prep(nodes, n_nodes)
    partial = torch.empty((n_tiles, n_feat, 3, n_bins1), dtype=torch.float32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.hist_sorted_launch(
            bins_fm.data_ptr(), layout.order.data_ptr(), layout.seg_off.data_ptr(),
            layout.tile_off.data_ptr(), g.data_ptr(), h.data_ptr(),
            None if rw is None else rw.data_ptr(), partial.data_ptr(),
            out.data_ptr(), n, n_feat, n_nodes, n_bins1, wpb, TILE_ROWS,
            n_tiles, stream,
        )
    if err != 0:
        msg = lib.hist_sorted_error_string(err).decode()
        raise RuntimeError(f"hist_sorted launch failed: {msg} (cuda error {err})")
    LAUNCHES["hist_sorted"] += 1
    return out
