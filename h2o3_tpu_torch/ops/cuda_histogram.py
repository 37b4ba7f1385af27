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
- ``hist_chunked_ordered_reference`` is the plain version that keeps the
  float order this kernel and the factorized kernel share, so it gives
  their bits: a bit oracle for the tests and ``chip_smoke.py``, never on
  the main path.
- Both take ``dtype``, the operand mode (``cuda_build.HIST_DTYPES``):
  ``"bf16"`` rounds g, h and the count weight to bf16 before they are
  added, as the JAX package's bf16 mode does; the kernel has an
  instantiation for each mode.
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
    check_hist_dtype,
    check_tensor,
    load_library as _load,
    reset_launch_counts,
    round_operand,
)

__all__ = ["LAUNCHES", "MAX_NODES", "reset_launch_counts", "load_library",
           "launch_plan", "cell_tiles", "warp_tile", "row_chunks",
           "load_chunked_library", "launch_chunked",
           "hist_nodematmul", "hist_nodematmul_reference",
           "hist_chunked_ordered_reference"]

#: most warps in one block
_MAX_WARPS_PER_BLOCK = 8
#: shared memory a block may use on Hopper (227 KB opt-in limit)
_SMEM_LIMIT = 232_448
#: longest row chunk one warp sums in float before the float64 reduce
_MAX_CHUNK_ROWS = 32_768
#: shortest row chunk worth a warp of its own
_MIN_CHUNK_ROWS = 1_024
#: (feature, chunk) warps wanted per call: 16 for each of the card's 132 SMs
_TARGET_WARPS = 132 * 16
#: rows a block of the tile kernel stages per step (kGroupRows in the source)
_GROUP_ROWS = 512
#: 32-bit words of one warp's pack in the tile kernel: 32 rows of (cell
#: and batch, g, h, w)
_PACK_WORDS = 4 * 32
#: shared memory of one SM, and what the card keeps of it for each block:
#: two blocks share an SM when each takes at most _HALF_SM bytes
_SM_SMEM = 233_472
_HALF_SM = _SM_SMEM // 2 - 1_024
#: most (node, bin) cells of a level served one tile per feature by the
#: warp kernel: eight warps' [K, 3, B1] histograms and [3, 32] scratch fill
#: a block's shared memory (2,389 cells), or half an SM's (1,173)
_WHOLE_CELLS = (_SMEM_LIMIT // (4 * _MAX_WARPS_PER_BLOCK) - 3 * 32) // 3
_WHOLE_CELLS_HALF = (_HALF_SM // (4 * _MAX_WARPS_PER_BLOCK) - 3 * 32) // 3
#: most nodes one call builds: every level the dispatch sends (at most 64,
#: the JAX package's K·4 <= 512 on its 8/64/512 ladder) and a build padded
#: past one by hand; levels of 128 nodes and more are the sorted kernel's
MAX_NODES = 127


def _staged_features(warps_per_block: int, tiles: int) -> int:
    """Features whose bin codes one block of the tile kernel stages
    (staged_features in the CUDA source): the slots of ``warps_per_block``
    consecutive warps span at most this many features when each feature
    has ``tiles`` tiles."""
    return min(warps_per_block, (warps_per_block - 1) // tiles + 2)


def _stage_words(n_staged: int) -> int:
    """32-bit words of one staging buffer (stage_words in the CUDA source):
    node, g, h, rw, then the bin codes of each staged feature."""
    return _GROUP_ROWS * (4 + n_staged)


def _block_bytes(node_tile: int, bin_tile: int, tiles: int,
                 warps_per_block: int) -> int:
    """Dynamic shared memory of one block (smem_bytes in the CUDA source).
    One tile per feature: each warp's [K, 3, B1] histogram and [3, 32] lane
    scratch. More: each warp's pack and [node_tile, 3, bin_tile] tile, and
    two staging buffers."""
    tile = node_tile * 3 * bin_tile
    if tiles == 1:
        return 4 * warps_per_block * (tile + 3 * 32)
    return 4 * (warps_per_block * (_PACK_WORDS + tile)
                + 2 * _stage_words(_staged_features(warps_per_block, tiles)))


def _tile_count(n_nodes: int, n_bins1: int, node_tile: int, bin_tile: int) -> int:
    """Tiles of one feature's histogram."""
    return -(-n_nodes // node_tile) * -(-n_bins1 // bin_tile)


def _fewest_tiles(n_nodes: int, n_bins1: int, budget: int) -> Tuple[int, int]:
    """(node_tile, bin_tile) of the fewest tiles (at least 2) whose block of
    eight warps takes at most ``budget`` bytes: equal node ranges, or where
    one node's bins do not fit, one node's equal bin ranges."""
    w = _MAX_WARPS_PER_BLOCK
    for parts in range(2, n_nodes + 1):
        kt = -(-n_nodes // parts)
        if _block_bytes(kt, n_bins1, _tile_count(n_nodes, n_bins1, kt, n_bins1),
                        w) <= budget:
            return kt, n_bins1
    parts = 2
    while True:
        bt = -(-n_bins1 // parts)
        if _block_bytes(1, bt, _tile_count(n_nodes, n_bins1, 1, bt), w) <= budget:
            return 1, bt
        parts += 1


def cell_tiles(n_nodes: int, n_bins1: int) -> Tuple[int, int]:
    """(node_tile, bin_tile): the nodes and bins of one warp's tile of a
    feature's [K, 3, B1] histogram, a function of (K, B1) alone.

    Every tile's warp walks all of its feature's rows, so fewer tiles mean
    less work; but the walks are latency-bound, and two blocks on an SM
    (16 warps) run more than twice as fast as one. So a level whose whole
    histogram lets two blocks of the warp kernel share an SM (at most 1,173
    cells: the root, 4 nodes at 257 bins, 32 at 21) is one tile per
    feature; a wider one takes the fewest tiles that let two blocks of the
    tile kernel share an SM, unless that is more than twice the tiles of
    one block an SM (one tile per feature up to 2,389 cells). Raises
    ValueError outside the kernel's domain: 1 to ``MAX_NODES`` nodes, any
    bin count."""
    if not 1 <= n_nodes <= MAX_NODES or n_bins1 < 1:
        raise ValueError(
            f"hist_nodematmul: serves 1 to {MAX_NODES} nodes and >= 1 bins, "
            f"got {n_nodes} nodes x {n_bins1} bins (wider levels are the "
            f"sorted kernel's)")
    if n_nodes * n_bins1 <= _WHOLE_CELLS_HALF:
        return n_nodes, n_bins1
    one = ((n_nodes, n_bins1) if n_nodes * n_bins1 <= _WHOLE_CELLS
           else _fewest_tiles(n_nodes, n_bins1, _SMEM_LIMIT))
    two = _fewest_tiles(n_nodes, n_bins1, _HALF_SM)
    if _tile_count(n_nodes, n_bins1, *two) <= 2 * _tile_count(n_nodes, n_bins1, *one):
        return two
    return one


def _tiles(n_nodes: int, n_bins1: int) -> Tuple[int, int, int]:
    """(node_tile, bin_tile, tiles per feature)."""
    kt, bt = cell_tiles(n_nodes, n_bins1)
    return kt, bt, _tile_count(n_nodes, n_bins1, kt, bt)


def warp_tile(slot: int, n_nodes: int,
              n_bins1: int) -> Tuple[int, range, range]:
    """(feature, nodes, bins) of the cells that slot ``slot`` owns
    (warp_tile in the CUDA source): warp w of block x takes slot x ·
    warps per block + w, a slot is (feature, tile) with the tiles of one
    feature consecutive, and a tile's bin ranges vary fastest."""
    kt, bt, tiles = _tiles(n_nodes, n_bins1)
    f, i = divmod(slot, tiles)
    bin_tiles = -(-n_bins1 // bt)
    k0, b0 = i // bin_tiles * kt, i % bin_tiles * bt
    return f, range(k0, min(n_nodes, k0 + kt)), range(b0, min(n_bins1, b0 + bt))


def _smem_bytes(n_nodes: int, n_bins1: int, warps_per_block: int) -> int:
    """Dynamic shared memory of one block of ``warps_per_block`` warps for
    a level of (K, B1) (smem_bytes in the CUDA source)."""
    return _block_bytes(*_tiles(n_nodes, n_bins1), warps_per_block)


def launch_plan(n_rows: int, n_feat: int, n_nodes: int,
                n_bins1: int) -> Tuple[int, int, int]:
    """(warps per block, chunk rows, chunks) for one call.

    The row chunks are a function of (rows, features) alone, so the float
    summation order — and the result — is the same on every run and every
    card, and does not change with the node count or the tiling: a level
    padded to more nodes gives bit-identical cells. A block has up to 8
    warps, one per (feature, tile) slot (``warp_tile``), and its shared
    memory fits by construction. Raises ValueError outside the kernel's
    domain (``cell_tiles``): every level of at most 64 nodes that the
    dispatch sends fits, at any bin count."""
    tiles = _tiles(n_nodes, n_bins1)[2]
    return (min(_MAX_WARPS_PER_BLOCK, max(1, n_feat * tiles)),
            *row_chunks(n_rows, n_feat))


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


def load_chunked_library(kernel: str, n_ints: int) -> ctypes.CDLL:
    """Build (at first use) and load the library of a row-chunked histogram
    kernel: ``<kernel>_launch`` and ``<kernel>_error_string``, the C
    interface the node-matmul and factorized kernels share: seven pointers,
    ``n_ints`` ints (seven of both kernels', the rest of each kernel's
    plan: the node-matmul kernel's tile, the factorized kernel's stage rows
    and pass-1 kernel; the operand mode last), the stream."""
    def bind(lib: ctypes.CDLL) -> None:
        p, i = ctypes.c_void_p, ctypes.c_int
        launch = getattr(lib, f"{kernel}_launch")
        launch.argtypes = [p] * 7 + [i] * n_ints + [p]
        launch.restype = i
        errs = getattr(lib, f"{kernel}_error_string")
        errs.argtypes = [i]
        errs.restype = ctypes.c_char_p

    return _load(kernel, bind)


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    return load_chunked_library("hist_nodematmul", 10)


def hist_nodematmul_reference(
    bins_fm: torch.Tensor, nodes: torch.Tensor, g: torch.Tensor,
    h: torch.Tensor, n_nodes: int, n_bins1: int,
    rw: Optional[torch.Tensor] = None, dtype: str = "f32",
) -> torch.Tensor:
    """Plain PyTorch histogram [K, F, B1, 3] float32 of (Σg, Σh, Σw).

    bins_fm: [F, N] int bin codes (feature-major); nodes: [N] int (-1 =
    inactive row); g, h: [N] float; rw: optional [N] count weight; dtype:
    the operand mode (``"bf16"`` rounds g, h and rw to bf16 first). An
    ``index_add_`` per channel over the flat (node, feature, bin) index,
    in float64 so the float32 result is the correctly rounded sum."""
    g, h = round_operand(g, dtype), round_operand(h, dtype)
    rw = None if rw is None else round_operand(rw, dtype)
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


def hist_chunked_ordered_reference(
    bins_fm: torch.Tensor, nodes: torch.Tensor, g: torch.Tensor,
    h: torch.Tensor, n_nodes: int, n_bins1: int,
    rw: Optional[torch.Tensor] = None, dtype: str = "f32",
) -> torch.Tensor:
    """Plain PyTorch histogram [K, F, B1, 3] float32 in the float order of
    the node-matmul and factorized kernels, so it gives their bits.

    The order: the rows are cut into the chunks of ``row_chunks``; in a
    chunk, each aligned 32-row batch's rows of a (node, bin) cell are
    summed from 0 in row order in float32, and the batch sums are added to
    the cell's chunk partial in row order in float32; the chunk partials
    are added in float64 in chunk order and rounded once. Here each step is
    one scatter that adds at most once to any cell: lane by lane, then
    batch by batch, then chunk by chunk. A row counts when its node lies in
    [0, n_nodes) and its code in [0, n_bins1), as in the kernels. The values
    are g, h and rw in operand mode ``dtype``."""
    g, h = round_operand(g, dtype), round_operand(h, dtype)
    rw = None if rw is None else round_operand(rw, dtype)
    n_feat, n = bins_fm.shape
    dev = bins_fm.device
    chunk_rows, n_chunks = row_chunks(n, n_feat)
    n_batch = -(-n // 32)
    pad = n_batch * 32 - n
    node = torch.nn.functional.pad(nodes.long(), (0, pad), value=-1).view(n_batch, 32)
    codes = torch.nn.functional.pad(bins_fm.long(), (0, pad)).view(n_feat, n_batch, 32)
    live = (node >= 0) & (node < n_nodes) & (codes >= 0) & (codes < n_bins1)
    key = torch.where(live, node * n_bins1 + codes, -1)      # [F, NB, 32]
    w = torch.ones_like(g) if rw is None else rw
    vals = torch.stack([torch.nn.functional.pad(v.float(), (0, pad)) for v in (g, h, w)])
    vals = vals.view(3, 1, n_batch, 32)
    # batch sums: each lane adds into its lowest peer's slot, lane by lane
    sums = torch.zeros(3, n_feat, n_batch, 32, dtype=torch.float32, device=dev)
    leaders = torch.empty_like(key)
    for lane in range(32):
        same = key[..., :lane + 1] == key[..., lane:lane + 1]
        leader = same.int().argmax(-1, keepdim=True)          # [F, NB, 1]
        leaders[..., lane:lane + 1] = leader
        idx = leader[None].expand(3, -1, -1, -1)
        sums.scatter_(3, idx, sums.gather(3, idx) + vals[..., lane:lane + 1])
    # each live leader's sum into its chunk's cell, batch by batch
    f_i, b_i, l_i = torch.nonzero(live & (leaders == torch.arange(32, device=dev)),
                                  as_tuple=True)
    per_chunk = chunk_rows // 32
    in_chunk = b_i % per_chunk
    order = torch.argsort(in_chunk, stable=True)
    f_i, b_i, l_i = f_i[order], b_i[order], l_i[order]
    cell = ((b_i // per_chunk) * n_feat + f_i) * (n_nodes * n_bins1) + key[f_i, b_i, l_i]
    add = sums[:, f_i, b_i, l_i]
    partial = torch.zeros(3, n_chunks * n_feat * n_nodes * n_bins1,
                          dtype=torch.float32, device=dev)
    start = 0
    for cnt in torch.bincount(in_chunk, minlength=per_chunk).tolist():
        c = cell[start:start + cnt]
        partial[:, c] = partial[:, c] + add[:, start:start + cnt]
        start += cnt
    # the chunk partials in chunk order, in float64
    partial = partial.view(3, n_chunks, n_feat * n_nodes * n_bins1)
    out = torch.zeros(3, n_feat * n_nodes * n_bins1, dtype=torch.float64, device=dev)
    for c in range(n_chunks):
        out += partial[:, c].double()
    return out.view(3, n_feat, n_nodes, n_bins1).permute(2, 1, 3, 0) \
        .float().contiguous()


def launch_chunked(
    kernel: str, plan: Callable[[int, int, int, int], Tuple[int, int, int]],
    slab_cells: int, bins_fm: torch.Tensor, nodes: torch.Tensor,
    g: torch.Tensor, h: torch.Tensor, n_nodes: int, n_bins1: int,
    rw: Optional[torch.Tensor], extra: Tuple[int, ...] = (),
) -> torch.Tensor:
    """Launch a row-chunked histogram kernel on CUDA tensors: check the
    level's inputs (bins_fm [F, N] int32, nodes [N] int32, g/h/rw [N]
    float32, all contiguous on one card), allocate the [K, F, B1, 3] output
    and the [chunks, F, slab_cells] float32 partials, launch on the current
    stream, raise on a launch error, and count the launch.
    ``plan(rows, features, nodes, bins)`` gives (warps per block, chunk
    rows, chunks) and any more ints of the kernel's plan, which follow the
    chunks in the launch; then come the ``extra`` ints."""
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
    wpb, chunk_rows, n_chunks, *plan_extra = plan(n, n_feat, n_nodes, n_bins1)
    partial = torch.empty((n_chunks, n_feat, slab_cells), dtype=torch.float32, device=dev)
    lib = load_chunked_library(kernel, 7 + len(plan_extra) + len(extra))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, f"{kernel}_launch")(
            bins_fm.data_ptr(), nodes.data_ptr(), g.data_ptr(), h.data_ptr(),
            None if rw is None else rw.data_ptr(), partial.data_ptr(),
            out.data_ptr(), n, n_feat, n_nodes, n_bins1, wpb, chunk_rows,
            n_chunks, *plan_extra, *extra, stream,
        )
    if err != 0:
        msg = getattr(lib, f"{kernel}_error_string")(err).decode()
        raise RuntimeError(f"{kernel} launch failed: {msg} (cuda error {err})")
    LAUNCHES[kernel] += 1
    return out


def hist_nodematmul(
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
    float32, all contiguous on one card) and raises on anything else, on
    more than ``MAX_NODES`` nodes, or on a launch error. On a CPU tensor:
    the plain version, ``hist_nodematmul_reference``."""
    check_hist_dtype(dtype)
    if bins_fm.device.type == "cpu":
        return hist_nodematmul_reference(bins_fm, nodes, g, h, n_nodes, n_bins1,
                                         rw=rw, dtype=dtype)
    # partials [chunks, F, K, 3, B1]; each warp writes its tile's cells
    return launch_chunked("hist_nodematmul", launch_plan, n_nodes * 3 * n_bins1,
                          bins_fm, nodes, g, h, n_nodes, n_bins1, rw,
                          extra=(*cell_tiles(n_nodes, n_bins1), int(dtype == "bf16")))
