"""The sorted per-node histogram kernel for Hopper: prep, binding and wrapper.

Replaces the TPU kernel ``_hist_kernel`` (``h2o3_tpu/ops/pallas_histogram.py:353``,
prep ``_prep_padded`` :388, launched from the sorted branch of
``_build_histogram_pallas_jit`` :510-543): the [K, F, B1, 3] histogram of
(Σg, Σh, Σw) per (node, feature, bin) for the wide levels of a tree, those
whose padded node count times 4 channels exceeds 512 (DRF's levels 8-11 at
its default depth 12). The CUDA source is
``h2o3_tpu_torch/csrc/hist_sorted.cu``; its header says what bounds it on
the card, what each pass reads, and why its bits are those of the kernel
before the gather pass.

- ``row_major_codes`` makes ``codes_rm``, a row-major copy of the codes in
  the narrowest unsigned type that holds them (``code_dtype``), rows padded
  to 16 bytes; a fit on the card makes it once, at its first sorted level
  (``ops/histogram.FitCache``).
- ``sorted_prep`` sorts rows by node: a stable sort of row ids with
  inactive rows sent to the dummy node K, each node's segment offset, and
  each node's first tile (segments cut into tiles of at most ``TILE_ROWS``
  rows, at least one tile per node). On the card a key kernel, PyTorch's
  sort and an offsets kernel pair; ``sorted_prep_reference`` is its plain
  twin.
- ``gather_rows`` gathers the active rows' codes and values into node
  order once (the gather kernel; ``gather_rows_reference`` is its twin).
- ``hist_sorted`` is the wrapper: on a CUDA tensor it runs the prep, the
  gather and both passes (or raises), on a CPU tensor it computes the plain
  version.
- ``hist_sorted_reference`` is the plain version: the same prep, then an
  ``index_add_`` over the sorted layout in float64, rounded once to
  float32. The CPU tests hold it against the JAX package, and
  ``chip_smoke.py`` holds the kernel against it.
- ``hist_sorted_ordered_reference`` is the plain version that keeps the
  kernel's float order and so its bits: the bit oracle of the tests and
  ``chip_smoke.py``.
- Each takes ``dtype``, the operand mode: with ``"bf16"`` the gather writes
  g, h and the count weight rounded to bf16 (``cuda_build.round_operand``),
  where the JAX package's prep casts them, and pass 1 sums them unchanged.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from h2o3_tpu_torch.ops.cuda_build import (
    LAUNCHES,
    check_hist_dtype,
    check_tensor,
    load_library as _load,
    round_operand,
)

#: longest run of one node's rows one warp sums in float before the
#: float64 reduce over the node's tiles
TILE_ROWS = 4096
#: most warps (one per feature) in one block
_MAX_WARPS_PER_BLOCK = 8
#: shared memory a block may use on Hopper (227 KB opt-in limit)
_SMEM_LIMIT = 232_448


class SortedLayout(NamedTuple):
    """Rows sorted by node, as ``sorted_prep`` lays them out.

    order: [N] int64 row ids, stable-sorted by node, inactive rows last;
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


def sorted_prep_reference(nodes: torch.Tensor, n_nodes: int,
                          tile_rows: int = TILE_ROWS) -> SortedLayout:
    """Plain PyTorch prep on ``nodes``' device. A node outside
    [0, n_nodes) (-1 marks an inactive row) goes to the dummy node n_nodes,
    after every real node, and is in no segment."""
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
    return SortedLayout(order, seg_off, tile_off)


def sorted_prep(nodes: torch.Tensor, n_nodes: int,
                tile_rows: int = TILE_ROWS) -> SortedLayout:
    """Sort rows by node: ``sorted_prep_reference``'s layout. On a CUDA
    tensor (nodes [N] int32, contiguous) a key kernel, PyTorch's stable
    sort and an offsets kernel pair, three host launches where the plain
    version makes some twenty; on a CPU tensor the plain version."""
    if nodes.device.type == "cpu":
        return sorted_prep_reference(nodes, n_nodes, tile_rows)
    n = nodes.shape[0]
    dev = nodes.device
    # int16 keys where they hold the dummy node: half the sort's passes
    keys = torch.empty(n, device=dev, dtype=torch.int16
                       if n_nodes < 1 << 15 else torch.int32)
    seg_off = torch.empty(n_nodes + 1, dtype=torch.int32, device=dev)
    tile_off = torch.empty_like(seg_off)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _raise_on(lib, lib.hist_sorted_keys(nodes.data_ptr(), keys.data_ptr(),
                                            keys.element_size(), n, n_nodes, stream))
        keys_sorted, order = torch.sort(keys, stable=True)
        _raise_on(lib, lib.hist_sorted_offsets(
            keys_sorted.data_ptr(), keys.element_size(), seg_off.data_ptr(),
            tile_off.data_ptr(), n, n_nodes, tile_rows, stream))
    return SortedLayout(order, seg_off, tile_off)


def launch_plan(n_rows: int, n_feat: int, n_bins1: int,
                tile_rows: int = TILE_ROWS) -> Tuple[int, int]:
    """(warps per block, tiles to launch) for one call. The tiles launched
    bound the tiles used: every node owns max(1, ceil(rows / tile_rows))
    tiles, at most n_nodes + n_rows // tile_rows in all; the wrapper adds
    n_nodes. Warps hold lane masks up to 14,504 bins (``lane_masks``).
    Raises ValueError when one warp's shared memory does not fit a block
    (past 19,338 bins)."""
    wpb = max(1, min(n_feat, _MAX_WARPS_PER_BLOCK))
    while wpb > 1 and _smem_bytes(n_bins1, wpb) > _SMEM_LIMIT:
        wpb -= 1  # wide bins: fewer warps a block
    if _smem_bytes(n_bins1, wpb) > _SMEM_LIMIT:
        raise ValueError(
            f"hist_sorted: {n_bins1} bins do not fit one block's shared memory")
    return wpb, n_rows // tile_rows


def lane_masks(n_bins1: int) -> bool:
    """Whether pass 1 finds a batch's peers from [B1] lane masks in shared
    memory, which must fit beside one warp's sums (up to 14,504 bins), else
    with ``__match_any_sync``: the same peers, so the same bits."""
    return 4 * (4 * n_bins1 + 3 * 32) <= _SMEM_LIMIT


def _smem_bytes(n_bins1: int, warps_per_block: int) -> int:
    """Dynamic shared memory of one block (smem_bytes in the CUDA source):
    per warp a [3, B1] histogram, a [3, 32] lane scratch and, with
    ``lane_masks``, [B1] lane masks."""
    return 4 * warps_per_block * ((4 if lane_masks(n_bins1) else 3) * n_bins1
                                  + 3 * 32)


def code_dtype(n_bins1: int) -> torch.dtype:
    """The narrowest unsigned type that holds codes 0 .. n_bins1 - 1:
    uint8 up to 256 codes, uint16 up to 65,536. Raises ValueError past
    that: no level that wide fits pass 1's shared memory."""
    if n_bins1 <= 1 << 8:
        return torch.uint8
    if n_bins1 <= 1 << 16:
        return torch.uint16
    raise ValueError(f"hist_sorted: {n_bins1} codes do not fit 2 bytes, and no "
                     "level that wide fits the kernel's shared memory")


def row_elems(n_feat: int, n_bins1: int) -> int:
    """Codes in one row of ``codes_rm``: F, padded to whole 16 bytes."""
    per = 16 // code_dtype(n_bins1).itemsize
    return max(1, -(-n_feat // per)) * per


def row_major_codes(bins_fm: torch.Tensor, n_bins1: int) -> torch.Tensor:
    """``codes_rm`` [N, row_elems(F, n_bins1)] of ``code_dtype(n_bins1)``:
    row r holds bins_fm[:, r], zero-padded to whole 16 bytes, on bins_fm's
    device. The gather reads a row with 16-byte loads (one 32-byte sector a
    row at 28 features and 1 byte). A code outside [0, n_bins1), no row to
    the kernel, stays outside it: it becomes n_bins1 or the type's largest
    value (the cast of -1). At 256 or 65,536 codes the type holds no value
    outside the range, and such a code raises ValueError."""
    n_feat, n = bins_fm.shape
    dtype = code_dtype(n_bins1)
    if n_bins1 == 1 << 8 * dtype.itemsize:
        if not bool(((bins_fm >= 0) & (bins_fm < n_bins1)).all()):
            raise ValueError(f"row_major_codes: a code outside [0, {n_bins1}) has "
                             f"no value outside that range in {dtype}")
    else:
        bins_fm = bins_fm.clamp(-1, n_bins1)
    out = torch.zeros((n, row_elems(n_feat, n_bins1)), dtype=dtype,
                      device=bins_fm.device)
    out[:, :n_feat] = bins_fm.T
    return out


class SortedRows(NamedTuple):
    """The active rows' codes and values in sorted order, as the gather
    writes them: codes [F, N] (``code_dtype``), g, h, w [N] float32 (w is
    None without a count weight), the values rounded to bf16 in the bf16
    operand mode. Positions past seg_off[K] are not written."""

    codes: torch.Tensor
    g: torch.Tensor
    h: torch.Tensor
    w: Optional[torch.Tensor]


def gather_rows_reference(codes_rm: torch.Tensor, layout: SortedLayout,
                          g: torch.Tensor, h: torch.Tensor,
                          rw: Optional[torch.Tensor], n_feat: int,
                          dtype: str = "f32") -> SortedRows:
    """Plain PyTorch twin of the gather kernel (positions past the active
    rows are zero here)."""
    n = g.shape[0]
    rows = layout.order[:int(layout.seg_off[-1])]
    codes = torch.zeros((n_feat, n), dtype=codes_rm.dtype, device=g.device)
    # indexed as int16 where uint16 has no CUDA indexing: the same bits
    as_int = torch.int16 if codes_rm.dtype == torch.uint16 else codes_rm.dtype
    codes.view(as_int)[:, :rows.numel()] = codes_rm.view(as_int)[rows, :n_feat].T

    def put(v):
        v = round_operand(v, dtype)
        out = torch.zeros_like(v)
        out[:rows.numel()] = v[rows]
        return out

    return SortedRows(codes, put(g), put(h), None if rw is None else put(rw))


def gather_rows(codes_rm: torch.Tensor, layout: SortedLayout, g: torch.Tensor,
                h: torch.Tensor, rw: Optional[torch.Tensor], n_feat: int,
                dtype: str = "f32") -> SortedRows:
    """Gather the active rows into node order, their values in operand mode
    ``dtype``: the gather kernel's instantiation for it on a CUDA tensor
    (the caller has validated the inputs), the plain twin on a CPU tensor."""
    check_hist_dtype(dtype)
    if g.device.type == "cpu":
        return gather_rows_reference(codes_rm, layout, g, h, rw, n_feat, dtype)
    n = g.shape[0]
    rows = SortedRows(
        torch.empty((n_feat, n), dtype=codes_rm.dtype, device=g.device),
        torch.empty_like(g), torch.empty_like(g),
        None if rw is None else torch.empty_like(g))
    lib = load_library()
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        _raise_on(lib, lib.hist_sorted_gather(
            codes_rm.data_ptr(), codes_rm.element_size(), codes_rm.shape[1],
            layout.order.data_ptr(), layout.seg_off.data_ptr(), g.data_ptr(),
            h.data_ptr(), _ptr(rw), rows.codes.data_ptr(), rows.g.data_ptr(),
            rows.h.data_ptr(), _ptr(rows.w), n, n_feat, layout.seg_off.numel() - 1,
            int(dtype == "bf16"), stream))
    return rows


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _raise_on(lib: ctypes.CDLL, err: int) -> None:
    if err != 0:
        msg = lib.hist_sorted_error_string(err).decode()
        raise RuntimeError(f"hist_sorted launch failed: {msg} (cuda error {err})")


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hist_sorted_keys.argtypes = [p, p, i, i, i, p]
    lib.hist_sorted_keys.restype = i
    lib.hist_sorted_offsets.argtypes = [p, i, p, p, i, i, i, p]
    lib.hist_sorted_offsets.restype = i
    lib.hist_sorted_gather.argtypes = [p, i, i, p, p, p, p, p, p, p, p, p,
                                       i, i, i, i, p]
    lib.hist_sorted_gather.restype = i
    lib.hist_sorted_launch.argtypes = [p, i, p, p, p, p, p, p, p,
                                       i, i, i, i, i, i, i, i, p]
    lib.hist_sorted_launch.restype = i
    lib.hist_sorted_error_string.argtypes = [i]
    lib.hist_sorted_error_string.restype = ctypes.c_char_p


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    return _load("hist_sorted", _bind)


def hist_sorted_reference(
    bins_fm: torch.Tensor, nodes: torch.Tensor, g: torch.Tensor,
    h: torch.Tensor, n_nodes: int, n_bins1: int,
    rw: Optional[torch.Tensor] = None, dtype: str = "f32",
) -> torch.Tensor:
    """Plain PyTorch histogram [K, F, B1, 3] float32 of (Σg, Σh, Σw).

    The kernel's prep (``sorted_prep``), then one ``index_add_`` per
    channel over the flat (node, feature, bin) index of the rows in sorted
    order, in float64 so the float32 result is the correctly rounded sum,
    of g, h and rw in operand mode ``dtype``. Inactive rows (and rows of
    nodes outside [0, n_nodes)) add nothing."""
    g, h = round_operand(g, dtype), round_operand(h, dtype)
    rw = None if rw is None else round_operand(rw, dtype)
    n_feat, n = bins_fm.shape
    dev = bins_fm.device
    rows = sorted_prep_reference(nodes, n_nodes).order
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


def hist_sorted_ordered_reference(
    bins_fm: torch.Tensor, nodes: torch.Tensor, g: torch.Tensor,
    h: torch.Tensor, n_nodes: int, n_bins1: int,
    rw: Optional[torch.Tensor] = None, tile_rows: int = TILE_ROWS,
    dtype: str = "f32",
) -> torch.Tensor:
    """Plain PyTorch histogram [K, F, B1, 3] float32 with the kernel's own
    float order, so it gives the kernel's bits: a bit oracle for tests and
    ``chip_smoke.py``, never on the main path.

    The kernel's order: each node's sorted rows are cut into tiles of at
    most ``tile_rows`` rows (``sorted_prep``), each tile into 32-row batches
    counted from its first row, one row per lane. In a batch, the lanes
    whose codes agree sum their values from 0 in lane order (float32); the
    batch sums go into the tile's [F, 3, B1] partial in batch order
    (float32); a node's tile partials are added in tile order in float64
    and rounded once. Here each step is one scatter that adds at most once
    to any cell: lane by lane, then batch by batch, then tile by tile. A
    code outside [0, n_bins1) counts as no row, as in the kernel. The values
    are g, h and rw in operand mode ``dtype``, as the gather writes them."""
    g, h = round_operand(g, dtype), round_operand(h, dtype)
    rw = None if rw is None else round_operand(rw, dtype)
    n_feat, n = bins_fm.shape
    dev = bins_fm.device
    lay = sorted_prep_reference(nodes, n_nodes, tile_rows)
    tile_off = lay.tile_off.long()
    n_tiles = int(tile_off[-1])
    tiles = torch.arange(n_tiles, device=dev)
    # each tile's node and rows [begin, end) in sorted order
    tnode = torch.searchsorted(tile_off, tiles, right=True) - 1
    seg_off = lay.seg_off.long()
    begin = seg_off[tnode] + (tiles - tile_off[tnode]) * tile_rows
    end = torch.minimum(seg_off[tnode + 1], begin + tile_rows)
    # every 32-row batch: its tile, its index in the tile, its positions
    n_batch = (end - begin + 31) // 32
    btile = torch.repeat_interleave(tiles, n_batch)
    first = torch.cumsum(n_batch, 0) - n_batch
    bidx = torch.arange(btile.numel(), device=dev) - first[btile]
    pos = (begin[btile] + 32 * bidx)[:, None] + torch.arange(32, device=dev)
    in_tile = pos < end[btile][:, None]                       # [NB, 32]
    rows = lay.order[torch.where(in_tile, pos, 0)]
    codes = bins_fm[:, rows].long()                           # [F, NB, 32]
    live = in_tile & (codes >= 0) & (codes < n_bins1)
    key = torch.where(live, codes, -1)
    w = torch.ones_like(g) if rw is None else rw
    vals = torch.stack([v[rows] for v in (g, h, w)])          # [3, NB, 32]
    vals = vals[:, None].expand(3, n_feat, *rows.shape)
    # batch sums: each lane adds into its lowest peer's slot (the lane that
    # __match_any_sync's peer mask starts with), lane by lane
    sums = torch.zeros(3, n_feat, *rows.shape, dtype=torch.float32, device=dev)
    leaders = torch.empty_like(key)
    for lane in range(32):
        same = key[..., :lane + 1] == key[..., lane:lane + 1]
        leader = same.int().argmax(-1, keepdim=True)          # [F, NB, 1]
        leaders[..., lane:lane + 1] = leader
        idx = leader[None].expand(3, -1, -1, -1)
        sums.scatter_(3, idx, sums.gather(3, idx) + vals[..., lane:lane + 1])
    # each live leader's sum into its tile's cell, batch by batch
    is_leader = live & (leaders == torch.arange(32, device=dev))
    partial = torch.zeros(3, n_tiles * n_feat * n_bins1, dtype=torch.float32,
                          device=dev)
    feat = torch.arange(n_feat, device=dev)[:, None, None]
    cell = (btile[None, :, None] * n_feat + feat) * n_bins1 + key
    for b in range(int(n_batch.max())):
        sel = is_leader & (bidx == b)[None, :, None]
        c = cell[sel]
        partial[:, c] = partial[:, c] + sums[:, sel]
    partial = partial.reshape(3, n_tiles, n_feat, n_bins1)
    # a node's tile partials in tile order, in float64
    out = torch.zeros(3, n_nodes, n_feat, n_bins1, dtype=torch.float64, device=dev)
    n_node_tiles = tile_off[1:] - tile_off[:-1]
    for j in range(int(n_node_tiles.max()) if n_nodes else 0):
        ks = torch.nonzero(n_node_tiles > j)[:, 0]
        out[:, ks] += partial[:, tile_off[ks] + j].double()
    return out.permute(1, 2, 3, 0).float().contiguous()


def _check(name, t, dtype, shape, device) -> None:
    check_tensor("hist_sorted", name, t, dtype, shape, device)


def hist_sorted(
    bins_fm: torch.Tensor, nodes: torch.Tensor, g: torch.Tensor,
    h: torch.Tensor, n_nodes: int, n_bins1: int,
    rw: Optional[torch.Tensor] = None, codes_rm: Optional[torch.Tensor] = None,
    dtype: str = "f32",
) -> torch.Tensor:
    """Histogram [K, F, B1, 3] float32 of (Σg, Σh, Σw) per (node, feature,
    bin) over the rows whose node lies in [0, n_nodes). Bin codes lie in
    [0, n_bins1), as the booster makes them; on the card (and in
    ``hist_sorted_ordered_reference``) a code outside that range adds
    nothing. dtype: the operand mode, ``"f32"`` or ``"bf16"`` (the gather
    writes g, h and rw rounded to bf16); any other value raises ValueError.

    ``codes_rm``: the row-major copy of the codes (``row_major_codes``) the
    gather reads; a fit on the card makes it once and passes it to every
    sorted level. Without it, the call makes its own. A given one must have the type, shape and
    device ``row_major_codes`` gives, else this raises (on any device).

    On a CUDA tensor: runs the prep, the gather and both passes on the
    current stream (bins_fm [F, N] int32, nodes [N] int32, g/h/rw [N]
    float32, all contiguous on one card) and raises on anything else or on
    a launch error. On a CPU tensor: the plain version,
    ``hist_sorted_reference``."""
    check_hist_dtype(dtype)
    if bins_fm.dim() != 2:
        raise ValueError("hist_sorted: bins_fm must be [F, N]")
    if codes_rm is not None:
        _check("codes_rm", codes_rm, code_dtype(n_bins1),
               (bins_fm.shape[1], row_elems(bins_fm.shape[0], n_bins1)),
               bins_fm.device)
    if bins_fm.device.type == "cpu":
        return hist_sorted_reference(bins_fm, nodes, g, h, n_nodes, n_bins1,
                                     rw=rw, dtype=dtype)
    if bins_fm.device.type != "cuda":
        raise ValueError(f"hist_sorted: unsupported device {bins_fm.device}")
    dev = bins_fm.device
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
    if codes_rm is None:
        codes_rm = row_major_codes(bins_fm, n_bins1)
    layout = sorted_prep(nodes, n_nodes)
    rows = gather_rows(codes_rm, layout, g, h, rw, n_feat, dtype)
    partial = torch.empty((n_tiles, n_feat, 3, n_bins1), dtype=torch.float32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _raise_on(lib, lib.hist_sorted_launch(
            rows.codes.data_ptr(), rows.codes.element_size(),
            layout.seg_off.data_ptr(), layout.tile_off.data_ptr(),
            rows.g.data_ptr(), rows.h.data_ptr(), _ptr(rows.w),
            partial.data_ptr(), out.data_ptr(), n, n_feat, n_nodes, n_bins1,
            wpb, TILE_ROWS, n_tiles, int(lane_masks(n_bins1)), stream))
    LAUNCHES["hist_sorted"] += 1
    return out
