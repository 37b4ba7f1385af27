"""The PyTorch port's CUDA histogram kernels against their plain versions.

The node-matmul kernel (``hist_nodematmul``), the sorted per-node kernel
(``hist_sorted``) and the factorized kernel (``hist_factorized``) have no
CPU mode: the ``cuda``-marked tests skip without a card.
This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_kernels.py

The launch-plan arithmetic around the kernels (shared-memory fit, row
chunks that ignore the node count, the node-matmul kernel's tiles, each
cell owned by one warp, the sorted kernel's tile bound, the factorized
kernel's node limit and its choice of pass-1 kernel) and the sorted
kernel's plain prep are plain Python and run everywhere; its prep and
gather kernels are held to their plain twins on the card, and the
node-matmul and factorized kernels to the plain version that keeps their
float order (``hist_chunked_ordered_reference``), bit for bit. The card
test also holds the Rapids device paths (``rapids/dist.py``: sort,
searchsorted, group aggregation) to their host paths and the fused emits
that fuse on the card to numpy.
Each kernel is held in both operand modes (``"f32"`` and ``"bf16"``, the
values rounded to bf16 before they are summed), each case named in its
assertion. Tolerance on the card: rtol 1e-5 / atol 1e-4 on Σg/Σh in either
mode (the plain version sums the same values in float64, the kernel in
float32 per chunk); counts exact where they are integers.
"""

import numpy as np
import pytest
import torch

from h2o3_tpu_torch.ops import cuda_build
from h2o3_tpu_torch.ops import cuda_factorized_histogram as cf
from h2o3_tpu_torch.ops import cuda_histogram as ch
from h2o3_tpu_torch.ops import cuda_sorted_histogram as cs

RTOL, ATOL = 1e-5, 1e-4


def _mk(n, f, k, b1, seed, frac_inactive=0.0, empty_node=None, weighted=False):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, b1, size=(n, f)).astype(np.int32)
    nodes = rng.integers(0, k, size=n).astype(np.int32)
    if empty_node is not None:
        nodes[nodes == empty_node] = (empty_node + 1) % k
    if frac_inactive:
        nodes[rng.random(n) < frac_inactive] = -1
    g = rng.normal(size=n).astype(np.float32)
    h = rng.random(n).astype(np.float32) + 0.1
    rw = rng.integers(1, 4, size=n).astype(np.float32) if weighted else None
    return bins, nodes, g, h, rw


@pytest.mark.parametrize("n_bins1,k", [(257, 16), (257, 64), (21, 8), (21, 64), (9, 1)])
def test_launch_plan_fits_and_is_node_independent(n_bins1, k):
    wpb, chunk_rows, n_chunks = ch.launch_plan(2_000_000, 28, k, n_bins1)
    assert 1 <= wpb <= 8 and ch._smem_bytes(k, n_bins1, wpb) <= ch._SMEM_LIMIT
    assert chunk_rows % 32 == 0 and chunk_rows <= ch._MAX_CHUNK_ROWS
    assert (n_chunks - 1) * chunk_rows < 2_000_000 <= n_chunks * chunk_rows
    # the row chunks (and so the float sum order) ignore the node count
    assert ch.launch_plan(2_000_000, 28, 1, n_bins1)[1:] == (chunk_rows, n_chunks)


@pytest.mark.parametrize("n_bins1", [2, 21, 257, 303, 513, 605, 1025, 1209, 4097])
def test_launch_plan_tiles_every_level_up_to_64_nodes(n_bins1):
    # every level the dispatch sends (1 to 64 nodes) at any bin count: the
    # plan returns, a block's shared memory fits, and each (node, bin) cell
    # of a feature (its 3 channels together) belongs to exactly one warp
    n_feat = 3
    for k in range(1, 65):
        wpb, chunk_rows, n_chunks = ch.launch_plan(2_000_000, n_feat, k, n_bins1)
        assert 1 <= wpb <= 8
        assert ch._smem_bytes(k, n_bins1, wpb) <= ch._SMEM_LIMIT
        assert (chunk_rows, n_chunks) == ch.row_chunks(2_000_000, n_feat)
        node_tile, bin_tile = ch.cell_tiles(k, n_bins1)
        tiles = -(-k // node_tile) * -(-n_bins1 // bin_tile)
        owners = np.zeros((n_feat, k, n_bins1), dtype=np.int64)
        for block in range(-(-n_feat * tiles // wpb)):
            for warp in range(wpb):
                slot = block * wpb + warp
                if slot >= n_feat * tiles:  # an idle warp of the last block
                    continue
                f, nodes, bins = ch.warp_tile(slot, k, n_bins1)
                assert len(nodes) and len(bins)
                owners[f, nodes.start:nodes.stop, bins.start:bins.stop] += 1
        assert np.all(owners == 1), (k, n_bins1)


@pytest.mark.parametrize("n_bins1", [2, 21, 257])
def test_sorted_launch_plan_fits_any_node_count(n_bins1):
    wpb, extra = cs.launch_plan(2_000_000, 28, n_bins1)
    assert wpb == 8 and cs._smem_bytes(n_bins1, wpb) <= 48 * 1024
    assert extra == 2_000_000 // cs.TILE_ROWS
    assert cs.launch_plan(1000, 3, n_bins1) == (3, 1000 // cs.TILE_ROWS)


def test_every_kernel_has_a_source_and_a_count():
    for name in cuda_build.KERNELS:
        assert cuda_build.source(name).exists(), name
        assert cuda_build.library_path(name).name.startswith(f"lib{name}_")
    assert set(cuda_build.LAUNCHES) == set(cuda_build.KERNELS)
    assert {"hist_nodematmul", "hist_sorted", "hist_factorized"} <= set(
        cuda_build.KERNELS)
    assert ch.LAUNCHES is cuda_build.LAUNCHES is cs.LAUNCHES is cf.LAUNCHES
    # the node-matmul plan rejects what does not fit
    with pytest.raises(ValueError):
        ch.launch_plan(1000, 4, 128, 257)

    # the sorted plan: a block's warps each hold [3, B1] sums and [B1]
    # lane masks: past what eight fit, the plan takes fewer warps a block,
    # down to one; past what one warp's masks fit, the warp finds peers
    # with __match_any_sync and holds [3, B1] sums alone (the layout before
    # lane masks), up to 19,338 bins at any feature count; then it raises
    assert cs.launch_plan(2_000_000, 28, 1792)[0] == 8
    for n_bins1 in (1793, 2389, 5000, 14_504, 14_505, 19_338):
        assert cs.launch_plan(2_000_000, 1, n_bins1)[0] == 1
        wpb, _ = cs.launch_plan(2_000_000, 28, n_bins1)
        assert 1 <= wpb < 8 and cs._smem_bytes(n_bins1, wpb) <= cs._SMEM_LIMIT
        assert cs._smem_bytes(n_bins1, wpb + 1) > cs._SMEM_LIMIT
        assert cs.lane_masks(n_bins1) == (n_bins1 <= 14_504)
        assert cs._smem_bytes(n_bins1, 1) == 4 * (
            (4 if n_bins1 <= 14_504 else 3) * n_bins1 + 96)
    for n_feat in (1, 28):
        with pytest.raises(ValueError, match="shared memory"):
            cs.launch_plan(2_000_000, n_feat, 19_339)

    # one node holds most rows, many are empty: the tiles used never
    # exceed the tiles launched (n_nodes + n_rows // tile_rows)
    rng = np.random.default_rng(5)
    for k in (1, 128, 1024, 2048):
        nodes = np.where(rng.random(50_000) < 0.7, 0,
                         rng.integers(-1, k, 50_000)).astype(np.int32)
        layout = cs.sorted_prep(torch.from_numpy(nodes), k, tile_rows=512)
        _, extra = cs.launch_plan(50_000, 4, 21, tile_rows=512)
        assert int(layout.tile_off[-1]) <= k + extra
        assert torch.all(layout.tile_off[1:] > layout.tile_off[:-1])


@pytest.mark.parametrize("n_bins1", [257, 21])
@pytest.mark.parametrize("k", range(1, 17))
def test_factorized_launch_plan_fits_and_shares_the_row_chunks(k, n_bins1):
    plan = cf.launch_plan(2_000_000, 28, k, n_bins1)
    assert 1 <= plan.group <= 8
    assert plan.stage_rows % 32 == 0 and plan.stage_rows <= 256
    assert (plan.stage_rows > 0) == bool(plan.staged)
    assert cf._smem_bytes(k, n_bins1, plan.group, plan.stage_rows,
                          bool(plan.staged)) <= cf._SMEM_LIMIT
    # the features spread evenly over the fewest blocks: one fewer feature
    # a block would take one more block
    blocks = -(-28 // plan.group)
    assert plan.group == 1 or -(-28 // (plan.group - 1)) > blocks
    # the node-matmul kernel's chunks: the same rows summed in the same
    # order
    assert plan[1:3] == ch.launch_plan(2_000_000, 28, k, n_bins1)[1:]
    # the staged kernel where an SM holds at most 8 blocks of the direct
    # one, a feature each (from 8 nodes at 257 bins), with 7 features a
    # block at 28 features
    assert plan.staged == (n_bins1 == 257 and k >= 8)
    if not plan.staged:
        assert plan.group == 1
    elif k == 8:
        assert plan.group == 7
    assert cf.fits(k, n_bins1)
    assert cf.n_hi(n_bins1) * cf.FACT_LO >= n_bins1 > (cf.n_hi(n_bins1) - 1) * cf.FACT_LO


@pytest.mark.parametrize("n_bins1,k_max", [(257, 71), (21, 604)])
def test_factorized_launch_plan_raises_beyond_shared_memory(n_bins1, k_max):
    # fits takes the levels whose TPU-layout slab fits (71 nodes at 257
    # bins, 604 at 21), and the plan takes every one of them, with fewer
    # features a block as the level widens, down to one
    assert cf.fits(k_max, n_bins1) and not cf.fits(k_max + 1, n_bins1)
    assert cf.launch_plan(1000, 4, k_max, n_bins1).group == 1
    for k in range(1, k_max + 1):
        plan = cf.launch_plan(2_000_000, 28, k, n_bins1)
        assert cf._smem_bytes(k, n_bins1, plan.group, plan.stage_rows,
                              bool(plan.staged)) <= cf._SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        cf.launch_plan(1000, 4, k_max + 1, n_bins1)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _weight(rw, dtype):
    """The count weight of a card check: _mk's integer weights in f32, and
    in bf16 fractional ones, which bf16 rounds."""
    return rw if rw is None or dtype == "f32" else (rw * 0.37).astype(np.float32)


def _on(dev, bins, nodes, g, h, k, b1, rw):
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return ((t(np.ascontiguousarray(bins.T)), t(nodes), t(g), t(h), k, b1),
            None if rw is None else t(rw))


#: (kernel, rows, features, nodes, bins, count weight, seed) of the card
#: checks against the plain versions: the levels the fits give each kernel,
#: B1's levels whose cells it tiles across warps (64 x 303, 16 x 1,209),
#: and B3 at every level the fits give it (1, 2, 4, 5 and 8 nodes at 257
#: bins, 8 and 16 at 21, the root at 9) and at B1's tiled levels (16, 40
#: and 64 nodes at 257 bins)
CARD_CASES = [
    ("hist_nodematmul", 100_000, 28, 64, 257, False, 100_000),
    ("hist_nodematmul", 70_001, 11, 8, 21, True, 70_001),
    ("hist_nodematmul", 60_000, 5, 64, 303, False, 60_303),
    ("hist_nodematmul", 50_001, 4, 16, 1209, True, 51_210),
    ("hist_sorted", 100_000, 28, 1024, 21, False, 101_024),
    ("hist_sorted", 70_001, 11, 300, 257, True, 70_301),
    ("hist_sorted", 50_000, 5, 64, 21, False, 50_064),
    ("hist_factorized", 100_000, 28, 8, 257, False, 100_008),
    ("hist_factorized", 70_001, 11, 5, 257, True, 70_006),
    ("hist_factorized", 50_000, 5, 16, 21, False, 50_016),
    ("hist_factorized", 30_000, 3, 1, 9, True, 30_001),
    ("hist_factorized", 40_000, 28, 1, 257, True, 40_001),
    ("hist_factorized", 40_000, 28, 2, 257, False, 40_002),
    ("hist_factorized", 40_003, 28, 4, 257, False, 40_004),
    ("hist_factorized", 50_000, 28, 8, 21, True, 50_008),
    ("hist_factorized", 40_000, 6, 96, 21, False, 40_096),  # staged at 21 bins
    ("hist_factorized", 60_000, 5, 16, 257, False, 60_016),
    ("hist_factorized", 50_001, 3, 64, 257, True, 50_065),
    ("hist_factorized", 40_000, 9, 40, 257, False, 40_040),
]

KERNELS = {"hist_nodematmul": (ch.hist_nodematmul, ch.hist_nodematmul_reference),
           "hist_sorted": (cs.hist_sorted, cs.hist_sorted_reference),
           "hist_factorized": (cf.hist_factorized, cf.hist_factorized_reference)}


@pytest.mark.cuda
def test_kernels_match_their_plain_versions_on_card():
    dev = _card()
    _check_plain_versions(dev)
    _check_sorted_bits_prep_and_gather(dev)
    _check_rapids_device_paths(dev)


def _check_plain_versions(dev):
    """Every kernel x operand mode: two calls bit-identical, counts exact
    (unweighted in bf16, where the weight is fractional), an empty node
    exactly zero, Σg/Σh at the tolerance; B1's build for 3 more nodes the
    same bits; B2 the bits of its ordered plain version, and near B1 where
    B1 serves the level; B3 the bits of B1 (same row chunks, same order in
    a cell) and of their ordered plain version, and so at 60% inactive
    rows; and every bf16 output differs from the f32 one."""
    # B1 tiles B3's last three levels' cells across warps
    assert all(ch.cell_tiles(k, b1) != (k, b1) for _, _, _, k, b1, _, _ in CARD_CASES[-3:])
    for kernel, n, f, k, b1, weighted, seed in CARD_CASES:
        wrapper, reference = KERNELS[kernel]
        bins, nodes, g, h, rw = _mk(n, f, k, b1, seed=seed, frac_inactive=0.3,
                                    empty_node=1 if k > 2 else None,
                                    weighted=weighted)
        empty = [1] if k > 2 else []
        if kernel == "hist_sorted":  # a run of empty nodes mid-range
            nodes[(nodes >= k // 3) & (nodes < k // 3 + 5)] = -1
            empty += list(range(k // 3, k // 3 + 5))
        f32 = None
        for dtype in cuda_build.HIST_DTYPES:
            name = f"{kernel} {dtype} N={n} F={f} K={k} B1={b1}{' rw' if weighted else ''}"
            args, rwt = _on(dev, bins, nodes, g, h, k, b1, _weight(rw, dtype))
            a = wrapper(*args, rw=rwt, dtype=dtype)
            ref = reference(*args, rw=rwt, dtype=dtype)
            assert torch.equal(a, wrapper(*args, rw=rwt, dtype=dtype)), name
            if dtype == "f32" or rw is None:
                assert torch.equal(a[..., 2], ref[..., 2]), name
            assert torch.all(a[empty] == 0), name
            torch.testing.assert_close(a, ref, rtol=RTOL, atol=ATOL, msg=name)
            if kernel == "hist_nodematmul":
                wide = wrapper(*args[:4], k + 3, b1, rw=rwt, dtype=dtype)
                assert torch.equal(a, wide[:k]), name
            if kernel == "hist_sorted":
                assert torch.equal(a, cs.hist_sorted_ordered_reference(
                    *args, rw=rwt, dtype=dtype)), name
                if k <= 64:  # the node-matmul kernel serves this level too
                    nm = ch.hist_nodematmul(*args, rw=rwt, dtype=dtype)
                    assert torch.equal(a[..., 2], nm[..., 2]), name
                    torch.testing.assert_close(a, nm, rtol=RTOL, atol=ATOL, msg=name)
            if kernel == "hist_factorized":
                _check_factorized_bits(dev, a, args, rwt, dtype, name)
            if f32 is None:
                f32 = a
            else:
                assert not torch.equal(a, f32), f"{name}: the same as f32"


def _check_factorized_bits(dev, out, args, rw, dtype, name):
    """B3's output, from the pass-1 kernel its plan picks (the cases hold
    both), is the bits of B1 and of their ordered plain version; and so at
    60% inactive rows, where a pack takes two batches or more."""
    bins_fm, nodes, g, h, k, b1 = args
    ordered = ch.hist_chunked_ordered_reference(*args, rw=rw, dtype=dtype)
    assert torch.equal(out, ordered), f"{name}: not the ordered bits"
    assert torch.equal(ch.hist_nodematmul(*args, rw=rw, dtype=dtype), ordered), name
    gen = torch.Generator(device=dev).manual_seed(k * b1)
    nodes = torch.where(torch.rand(nodes.shape, generator=gen, device=dev) < 0.43,
                        -1, nodes)
    args = (bins_fm, nodes, g, h, k, b1)
    sparse = cf.hist_factorized(*args, rw=rw, dtype=dtype)
    assert torch.equal(sparse, ch.hist_chunked_ordered_reference(*args, rw=rw, dtype=dtype)), \
        f"{name} at 60% inactive: not the ordered bits"
    assert torch.equal(sparse, ch.hist_nodematmul(*args, rw=rw, dtype=dtype)), name


def _check_sorted_bits_prep_and_gather(dev):
    """B2's output is the bits of the plain version that walks its tiles,
    batches and lanes, in both operand modes, at 21 and 257 bins, with and
    without row weights: at 1,024 nodes (one tile each) and at 5 nodes of
    ~14,000 rows (four tiles each, a float64 reduce over them); and past
    14,504 bins, where pass 1 finds peers with __match_any_sync, up to the
    widest level (19,338 bins at one feature), and at 14,504 with lane
    masks. Its prep and gather kernels equal their plain twins: uint8 and
    uint16 codes (21 and 257 bins); skewed, empty and out-of-range nodes;
    tiles of 512 and 4,096 rows; int16 sort keys below 32,768 nodes, int32
    above; the gather's values as they are and rounded to bf16."""
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    narrow = [(100_000, 28, 1024), (100_003, 9, 5)]
    wide = [(100_000, 1, 1024), (100_003, 2, 5)]
    for n_bins1, weighted, shapes in [
            (21, False, narrow), (21, True, narrow), (257, False, narrow),
            (257, True, narrow), (19_338, False, wide), (19_338, True, wide),
            (14_505, False, wide), (14_504, True, wide)]:
        for n, f, k in shapes:
            bins, nodes, g, h, rw = _mk(n, f, k, n_bins1, seed=n + k + n_bins1,
                                        frac_inactive=0.3, empty_node=1,
                                        weighted=weighted)
            if shapes is wide:  # peers in most batches, and the top bin
                bins[::2] %= 7
                bins[::5] = n_bins1 - 1
            for dtype in cuda_build.HIST_DTYPES:
                args, rwt = _on(dev, bins, nodes, g, h, k, n_bins1, _weight(rw, dtype))
                assert torch.equal(
                    cs.hist_sorted(*args, rw=rwt, dtype=dtype),
                    cs.hist_sorted_ordered_reference(*args, rw=rwt, dtype=dtype)), \
                    f"ordered bits {dtype} B1={n_bins1} rw={weighted} N={n} F={f} K={k}"
    n, f = 60_001, 13
    for n_bins1 in (21, 257):
        rng = np.random.default_rng(n_bins1)
        for k in (1, 7, 1024, 3000, 40_000):
            nodes = np.where(rng.random(n) < 0.5, k // 2,
                             rng.integers(-1, k + 3, n)).astype(np.int32)
            bins = rng.integers(0, n_bins1, size=(f, n)).astype(np.int32)
            for tile_rows in (512, cs.TILE_ROWS):
                got = cs.sorted_prep(t(nodes), k, tile_rows)
                want = cs.sorted_prep_reference(t(nodes), k, tile_rows)
                for a, b in zip(got, want):
                    assert torch.equal(a, b), f"prep B1={n_bins1} K={k} tiles of {tile_rows}"
            codes_rm = cs.row_major_codes(t(bins), n_bins1)
            assert torch.equal(codes_rm[:, :f].long(), t(bins).T.long())
            g, h, rw = (t(rng.random(n).astype(np.float32)) for _ in range(3))
            m = int(got.seg_off[-1])
            for w in (None, rw):
                for dtype in cuda_build.HIST_DTYPES:
                    name = f"gather {dtype} B1={n_bins1} K={k} rw={w is not None}"
                    a = cs.gather_rows(codes_rm, got, g, h, w, f, dtype)
                    b = cs.gather_rows_reference(codes_rm, got, g, h, w, f, dtype)
                    assert torch.equal(a.codes[:, :m].long(), b.codes[:, :m].long()), name
                    for x, y in ((a.g, b.g), (a.h, b.h), (a.w, b.w)):
                        assert (x is None) == (y is None), name
                        assert x is None or torch.equal(x[:m], y[:m]), name


def _check_rapids_device_paths(dev):
    """The Rapids device paths (``rapids/dist.py``) on the card against
    their host paths: the stable sort and the LSD multi-key sort equal
    numpy's stable ``argsort`` and ``lexsort`` (NaN first, -0 tied with +0,
    ties in row order, descending keys), ``searchsorted`` both sides equal
    numpy's, and the group aggregation equals itself on CPU tensors and its
    float64 numpy reading: counts, min and max exact, sums at 1e-12. And
    every fusible prim's emit (``rapids/prims``) that fuses on the card
    gives numpy's bits on the special values and 200,000 wide ones; a
    region fused on the card feeding ``which`` and ``h2o.impute`` by group
    gives a CPU session's bits."""
    from h2o3_tpu_torch.frame.frame import ColType, Column, Frame
    from h2o3_tpu_torch.rapids import dist
    from h2o3_tpu_torch.rapids.prims import FUSIBLE, PRIMS
    from h2o3_tpu_torch.rapids.runtime import Val

    rng = np.random.default_rng(17)
    n = 300_001
    x = rng.integers(-50, 50, n) * 0.25
    x[rng.random(n) < 0.02] = np.nan
    x[rng.random(n) < 0.02] = -0.0
    x[::1001] = np.inf
    y = rng.normal(size=n)
    for asc in (True, False):
        keys = dist.encode_f64(x, ascending=asc)
        assert np.array_equal(dist.device_argsort_u64(keys, dev),
                              np.argsort(keys, kind="stable")), asc
    lex = [dist.encode_f64(y), dist.encode_f64(x, ascending=False)]
    assert np.array_equal(dist.device_lexsort(lex, dev), np.lexsort(lex))
    table = np.sort(rng.integers(0, 1 << 62, 200_000).astype(np.uint64))
    q = rng.integers(0, 1 << 62, 100_001).astype(np.uint64)
    q[:5000] = table[:5000]
    lo, hi = dist.device_searchsorted_both(table, q, dev)
    assert np.array_equal(lo, np.searchsorted(table, q, "left"))
    assert np.array_equal(hi, np.searchsorted(table, q, "right"))
    assert np.array_equal(dist.device_searchsorted(table, q, "right", dev), hi)
    codes = rng.integers(0, 700, n)
    card = dist.device_group_aggregate(codes, x, 701, dev)
    again = dist.device_group_aggregate(codes, x, 701, dev)
    cpu = dist.device_group_aggregate(codes, x, 701, "cpu")
    ok = ~np.isnan(x)
    v32 = x.astype(np.float32).astype(np.float64)
    want_sum = np.bincount(codes[ok], weights=v32[ok], minlength=701)
    for k in card:
        assert np.array_equal(card[k], again[k]), k  # two calls, the same bits
    for k in ("count", "min", "max", "nacnt"):
        assert np.array_equal(card[k], cpu[k], equal_nan=True), k
    assert np.array_equal(card["count"], np.bincount(codes[ok], minlength=701))
    np.testing.assert_allclose(card["sum"], want_sum, rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(card["sum"], cpu["sum"], rtol=1e-12, atol=1e-9)
    assert card["min"][700] == np.inf and card["count"][700] == 0
    # the emits of the fusible prims, on the card, against numpy
    a = np.array([1.5, -2.5, np.nan, np.inf, -np.inf, 0.0, -0.0, 3.0, -3.0, 7.25,
                  -7.25, 2.0, 1e300, -1e-300, 5.0, -5.5, -1.0, 0.5, -0.25, 9.0])
    b = np.array([2.0, -3.0, 1.0, 2.0, 2.0, -0.0, 0.0, -2.0, np.nan, np.inf,
                  -np.inf, 0.5, 1e-300, 1e300, -5.0, 5.5, np.inf, -0.0, 4.0, -9.0])
    w = rng.uniform(-10, 10, (2, 200_000)) * 10.0 ** rng.uniform(-15, 15, (2, 200_000))
    w[:, ::7] = np.round(w[:, ::7])
    w[1, ::3] = rng.integers(-5, 6, w[1, ::3].size)
    a, b = np.concatenate([a, w[0]]), np.concatenate([b, w[1]])
    ta, tb = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    frame = lambda v: Val.frame(Frame([Column("a", v, ColType.NUM)]))  # noqa: E731
    checked = 0
    for name, spec in FUSIBLE.items():
        if spec.kind not in ("binop", "uniop", "ifelse") or "cuda" not in spec.devices:
            continue
        args = {"binop": (a, b), "uniop": (a,), "ifelse": (a, b, a * 2)}[spec.kind]
        targs = {"binop": (ta, tb), "uniop": (ta,), "ifelse": (ta, tb, ta * 2)}[spec.kind]
        got = spec.emit(*targs).cpu().numpy()
        want = PRIMS[name](None, [frame(v) for v in args]).value.col(0).data
        bad = (got.view(np.uint64) != want.view(np.uint64)) & ~(np.isnan(got) & np.isnan(want))
        assert not bad.any(), (name, a[bad][:3], b[bad][:3])
        checked += 1
    assert checked >= 30
    # host prims fed by a region fused on the card: which, and impute by
    # group, the same bits as from a CPU session
    from h2o3_tpu_torch.rapids import Session, exec_rapids, fusion

    g = rng.integers(0, 40, n).astype(np.int32)
    g[::53] = -1
    fr = Frame([Column("x", x, ColType.NUM), Column("y", y, ColType.NUM),
                Column("g", g, ColType.CAT, [f"g{i}" for i in range(40)])])
    card_s, cpu_s = Session(device=dev), Session(device="cpu")
    for sess in (card_s, cpu_s):
        sess.assign("card_prims", fr)
    try:
        for expr in ("(which (& (> (cols_py card_prims 0) 0) (< (cols_py card_prims 1) 0.5)))",
                     "(h2o.impute (cbind (ifelse (> (cols_py card_prims 1) 1) NaN "
                     '(* (cols_py card_prims 0) 2)) (cols_py card_prims 2)) 0 "median" '
                     '"interpolate" [1] _ _)'):
            fused0 = fusion.COUNTS["fused"]
            on_card = exec_rapids(expr, card_s).value
            assert fusion.COUNTS["fused"] > fused0, expr
            on_cpu = exec_rapids(expr, cpu_s).value
            assert on_card.names == on_cpu.names, expr
            for c, h in zip(on_card.columns, on_cpu.columns):
                assert c.type == h.type and c.domain == h.domain, expr
                assert np.array_equal(c.data, h.data, equal_nan=True), (expr, c.name)
    finally:
        card_s.remove("card_prims")
        cpu_s.remove("card_prims")
