"""Parity: the PyTorch port's histogram (h2o3_tpu_torch.ops) vs the JAX package.

The port's CPU histograms are the plain versions of its CUDA kernels:
``hist_nodematmul_reference`` (an ``index_add_`` accumulated in float64) and
``hist_sorted_reference`` (the sorted kernel's prep, then an ``index_add_``
over the sorted layout). They are held here to the JAX scatter oracle
``_shard_histogram`` and to the Pallas kernels run in interpret mode with
f32 operands (node-matmul, and the sorted tile-per-node kernel), over the
shape matrix of ``tests/test_pallas_histogram.py`` and, for the sorted
kernel, wider levels. The sorted prep (row order and per-node counts) is
held to ``_prep_padded``'s ``jnp.argsort(nd, stable=True)`` and
``jnp.bincount``. Tolerance: the f32 tolerance that file uses (rtol 1e-5,
atol 1e-4) — the packages add the same float32 values in different orders;
counts are exact.

The factorized kernel's plain version (``hist_factorized_reference``, an
``index_add_`` into the kernel's [F, HI, K, 3, 16] slab, permuted back and
cut to B1 bins) is held to the scatter oracle and to the factorized Pallas
kernel in interpret mode, at 257 bins too, where HI·16 = 272 exceeds B1.

The node-matmul and factorized kernels' ordered plain version
(``hist_chunked_ordered_reference``: their row chunks, 32-row batches and
lanes, so it gives their bits on the card) is held bit for bit to a
scalar-loop reading of the factorized kernel's staged pass (stages, packs
of whole batches, leaders), in both operand modes, and to the Pallas
kernel and the scatter oracle at the tolerance below.

The sorted kernel's ordered plain version (``hist_sorted_ordered_reference``,
the kernel's own float order: tiles, 32-row batches, lanes) is held bit for
bit to a scalar-loop reading of the kernel's algorithm, and to the plain
version and the JAX package at the tolerance above. Its row-major copy of
the codes (``row_major_codes``), the gather's plain twin, the wrapper's
checks of that copy and its path from the fit to the sorted kernel alone
are held here too.

The bf16 operand mode (``dtype="bf16"``: g, h and the count weight rounded
to bf16, summed in float; the JAX package's default on its own chip) of
each plain version is held to the matching Pallas kernel in interpret mode
with ``dtype="bf16"``, with inactive rows, empty nodes and a fractional
count weight, at the f32 tolerance above (both sum the same rounded values;
counts exact without a weight), and must differ from the f32 output. Its
rounding is the JAX package's cast, bit for bit, and the dispatch hands the
mode to whichever version builds a level.

Binning: ``make_bins`` and the host ``apply_bins`` are the JAX package's,
and the fit's device binning ``apply_bins_device`` (CPU tensors here) gives
the same codes bit for bit, on float64 and float32 frames and on values
binning can get wrong (NaN, +-inf against +inf-padded edges, -0.0, values
next to an edge, an all-NaN column, no rows, no features).

Fits through the device frame cache: a repeat fit on an unmutated frame
hits and hands its levels the cached ``FitCache``, with equal trees; a
mutated column, ``DKV.remove`` of the frame's key or a cleared cache makes
the next fit miss; a DRF fit with GBM's bins and seed shares GBM's entry.
The cache itself is driven through one sequence beside the JAX package's
``DeviceFrameCache`` (LRU order, budget, an oversized newest entry,
``set_max_bytes``, ``grow_entry``, ``invalidate_frame``, ``clear``, the
device in the key): the same hits, misses and surviving keys.

The kernels themselves run only on the card: see ``tests/test_torch_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h2o3_tpu.ops.histogram import (
    _shard_histogram,
    _shard_node_totals,
    apply_bins as jax_apply_bins,
    make_bins as jax_make_bins,
    pad_nodes as jax_pad_nodes,
)
from h2o3_tpu.ops.pallas_histogram import build_histogram_pallas
from h2o3_tpu_torch.ops import cuda_build
from h2o3_tpu_torch.ops import cuda_factorized_histogram as cf
from h2o3_tpu_torch.ops import cuda_histogram as ch
from h2o3_tpu_torch.ops import cuda_sorted_histogram as cs
from h2o3_tpu_torch.ops.histogram import (
    apply_bins,
    apply_bins_device,
    build_histogram,
    make_bins,
    node_totals,
    pad_nodes,
)

torch.set_num_threads(1)

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


def _port(bins, nodes, g, h, k, b1, rw=None):
    t = torch.from_numpy
    return build_histogram(
        t(np.ascontiguousarray(bins.T)), t(nodes), t(g), t(h), k, b1,
        rw=None if rw is None else t(rw)).numpy()


def _jax_both(bins, nodes, g, h, k, b1, row_tile, rw=None):
    scatter = np.asarray(_shard_histogram(bins, nodes, g, h, k, b1, rw=rw))
    pallas = np.asarray(build_histogram_pallas(
        bins, nodes, g, h, k, b1, row_tile=row_tile, interpret=True,
        kernel="nodematmul", rw=rw, dtype="f32"))
    return scatter, pallas


def _assert_hist_close(got, want):
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., 2], want[..., 2])  # counts exact
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _bf16_weight(rw):
    """A fractional count weight, which bf16 rounds (_mk's are integers)."""
    return None if rw is None else (rw * 0.37).astype(np.float32)


def _assert_bf16_matches_jax(port, kernel, bins, nodes, g, h, k, b1, row_tile,
                             rw=None):
    """The port's plain version ``port`` in the bf16 operand mode against
    the JAX package's Pallas ``kernel`` in interpret mode with
    ``dtype="bf16"``: the f32 tolerance, counts exact without a weight; and
    apart from the f32 output on the same inputs. Returns the bf16 output."""
    t = torch.from_numpy
    args = (t(np.ascontiguousarray(bins.T)), t(nodes), t(g), t(h), k, b1)
    rwt = None if rw is None else t(rw)
    got = port(*args, rw=rwt, dtype="bf16").numpy()
    want = np.asarray(build_histogram_pallas(
        bins, nodes, g, h, k, b1, row_tile=row_tile, interpret=True,
        kernel=kernel, rw=rw, dtype="bf16"))
    assert got.shape == want.shape
    if rw is None:
        np.testing.assert_array_equal(got[..., 2], want[..., 2])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert not np.allclose(got, port(*args, rw=rwt).numpy(), rtol=RTOL, atol=ATOL)
    return got


@pytest.mark.parametrize(
    "n,f,k,b1,row_tile",
    [
        (1000, 5, 4, 17, 128),
        (513, 3, 1, 9, 256),      # single node, non-divisible rows
        (2048, 7, 8, 33, 512),
        (900, 11, 4, 17, 128),    # features not a multiple of the 8-wide block
    ],
)
def test_plain_matches_jax(n, f, k, b1, row_tile):
    bins, nodes, g, h, _ = _mk(n, f, k, b1, seed=n)
    got = _port(bins, nodes, g, h, k, b1)
    scatter, pallas = _jax_both(bins, nodes, g, h, k, b1, row_tile)
    assert got.shape == (k, f, b1, 3)
    _assert_hist_close(got, scatter)
    _assert_hist_close(got, pallas)


@pytest.mark.parametrize("weighted", [False, True])
def test_inactive_rows_empty_nodes_and_count_weight(weighted):
    bins, nodes, g, h, rw = _mk(
        1500, 4, 6, 13, seed=7, frac_inactive=0.3, empty_node=2, weighted=weighted)
    got = _port(bins, nodes, g, h, 6, 13, rw=rw)
    scatter, pallas = _jax_both(bins, nodes, g, h, 6, 13, 128, rw=rw)
    assert np.all(got[2] == 0)  # the empty node is exactly zero
    _assert_hist_close(got, scatter)
    _assert_hist_close(got, pallas)
    # the bf16 operand mode, and the dispatch's plain version honours it
    rw = _bf16_weight(rw)
    bf16 = _assert_bf16_matches_jax(ch.hist_nodematmul_reference, "nodematmul",
                                    bins, nodes, g, h, 6, 13, 128, rw=rw)
    assert np.all(bf16[2] == 0)
    t = torch.from_numpy
    np.testing.assert_array_equal(bf16, build_histogram(
        t(np.ascontiguousarray(bins.T)), t(nodes), t(g), t(h), 6, 13,
        rw=None if rw is None else t(rw), impl="plain", dtype="bf16").numpy())


def test_padded_node_bucket_is_bit_identical():
    # 5 nodes pad to the 8-bucket; 40 to the 64-bucket: slicing the real
    # nodes back out must equal the unpadded build bit for bit
    for k in (5, 40):
        assert pad_nodes(k) != k
        bins, nodes, g, h, rw = _mk(1200, 4, k, 9, seed=k, frac_inactive=0.1,
                                    weighted=True)
        t = torch.from_numpy
        args = (t(np.ascontiguousarray(bins.T)), t(nodes), t(g), t(h))
        padded = ch.hist_nodematmul_reference(*args, pad_nodes(k), 9, rw=t(rw))
        unpadded = build_histogram(*args, k, 9, rw=t(rw))
        assert torch.equal(padded[:k], unpadded)
        assert torch.all(padded[k:] == 0)
        tot_pad = node_totals(t(nodes), t(g), t(h), pad_nodes(k), rw=t(rw))[:k]
        assert torch.equal(tot_pad, node_totals(t(nodes), t(g), t(h), k, rw=t(rw)))

    # the node-count ladder is the JAX package's
    for k in range(1, 700):
        assert pad_nodes(k) == jax_pad_nodes(k)

    # the wrapper on CPU tensors is the plain version
    bins, nodes, g, h, rw = _mk(777, 6, 5, 11, seed=11, frac_inactive=0.2,
                                weighted=True)
    args = (torch.from_numpy(np.ascontiguousarray(bins.T)), torch.from_numpy(nodes),
            torch.from_numpy(g), torch.from_numpy(h), 5, 11)
    before = dict(ch.LAUNCHES)
    a = ch.hist_nodematmul(*args, rw=torch.from_numpy(rw))
    b = ch.hist_nodematmul_reference(*args, rw=torch.from_numpy(rw))
    assert torch.equal(a, b)
    assert ch.LAUNCHES == before  # the plain version launches nothing
    # counts are exact integers
    bins, nodes, g, h, _ = _mk(700, 2, 3, 5, seed=3)
    counts = _port(bins, nodes, g, h, 3, 5)[..., 2]
    np.testing.assert_array_equal(counts, np.round(counts))
    assert counts.sum() == 700 * 2


@pytest.mark.parametrize("weighted", [False, True])
def test_node_totals_match_jax(weighted):
    _, nodes, g, h, rw = _mk(1100, 1, 7, 3, seed=5, frac_inactive=0.25,
                             weighted=weighted)
    t = torch.from_numpy
    got = node_totals(t(nodes), t(g), t(h), 7,
                      rw=None if rw is None else t(rw)).numpy()
    want = np.asarray(_shard_node_totals(nodes, g, h, 7, rw=rw))
    np.testing.assert_array_equal(got[:, 2], want[:, 2])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _adversarial_bins_frame(n, f, nbins, seed):
    """A float32 frame of the values binning can get wrong, with its edges:
    5% NaN, +-inf, -0.0 beside 0.0, values set to an edge rounded to
    float32 and to that value's float32 neighbours, a 3-value column (edges
    padded with +inf) and an all-NaN column (edges ``arange``)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f + 3))
    X[:, f] = rng.integers(0, 3, n)  # 3 values: midpoint edges, +inf pad
    X[:, f + 1] = 0.0  # with -0.0 below
    X[:, f + 2] = np.nan  # all NaN
    X[:, :f][rng.random((n, f)) < 0.05] = np.nan
    # edges of the float64 data, so most lie between two float32 values
    edges = make_bins(X, nbins, seed=seed)
    X = X.astype(np.float32)
    m = max(n // 8, 1)
    for j in range(f + 2):
        X[rng.integers(0, n, 3), j] = np.inf
        X[rng.integers(0, n, 3), j] = -np.inf
        X[rng.integers(0, n, 3), j] = -0.0
        finite = edges[j][np.isfinite(edges[j])]
        if finite.size:
            e = rng.choice(finite, m).astype(np.float32)
            X[rng.integers(0, n, m), j] = e  # equal to an edge (in float32)
            X[rng.integers(0, n, m), j] = np.nextafter(e, np.float32(np.inf))
            X[rng.integers(0, n, m), j] = np.nextafter(e, np.float32(-np.inf))
    return X, edges


@pytest.mark.parametrize("n,f,nbins", [(5000, 6, 256), (3000, 4, 20), (8, 400, 16)])
def test_bins_bit_identical(n, f, nbins):
    rng = np.random.default_rng(n + f)
    X = rng.normal(size=(n, f))
    X[rng.random((n, f)) < 0.1] = np.nan
    X[:, 0] = np.round(X[:, 0])  # low cardinality: midpoint edges
    edges = make_bins(X, nbins, seed=3)
    np.testing.assert_array_equal(edges, jax_make_bins(X, nbins, seed=3))
    codes = apply_bins(X, edges)
    np.testing.assert_array_equal(codes, jax_apply_bins(X, edges))
    assert codes.dtype == np.int32 and codes.max() <= nbins
    # the fit's device binning (on CPU tensors here) gives the same codes,
    # feature-major, for float64 X and for the fit's float32 X
    for x in (X, X.astype(np.float32)):
        got = apply_bins_device(x, edges, "cpu")
        assert got.dtype == torch.int32 and got.shape == (f, n), x.dtype
        np.testing.assert_array_equal(got.numpy(), jax_apply_bins(x, edges).T,
                                      err_msg=f"device binning, {x.dtype} X")
    # and on the values binning can get wrong: NaN, +-inf against +inf
    # padded edges, -0.0 against a 0.0 edge, values equal to an edge or one
    # float32 step off it, an all-NaN column; a float32 search would move
    # codes next to an edge, so the float64 search must be what runs
    Xa, ea = _adversarial_bins_frame(n, f, nbins, seed=n + f)
    want = jax_apply_bins(Xa, ea)
    np.testing.assert_array_equal(apply_bins(Xa, ea), want, err_msg="host copy, adversarial")
    got = apply_bins_device(Xa, ea, "cpu").numpy()
    np.testing.assert_array_equal(got, want.T, err_msg="device binning, adversarial")
    assert (got[f + 2] == nbins).all(), "all-NaN column: the NA code"
    np.testing.assert_array_equal(got[np.isposinf(Xa).T], nbins - 1, err_msg="+inf code")
    np.testing.assert_array_equal(got[np.isneginf(Xa).T], 0, err_msg="-inf code")
    f32_search = torch.searchsorted(torch.from_numpy(ea).float(),
                                    torch.from_numpy(np.ascontiguousarray(Xa.T)),
                                    right=True).numpy()
    ok = ~np.isnan(Xa.T)
    assert (f32_search[ok] != want.T[ok]).any(), "no value the float32 search moves"
    # no rows, and no features
    assert apply_bins_device(Xa[:0], ea, "cpu").shape == (f + 3, 0)
    assert apply_bins_device(Xa[:, :0], ea[:0], "cpu").shape == (0, n)


# ---------------------------------------------------------------------------
# the sorted per-node kernel's plain version and prep (B2)

SORTED_SHAPES = [
    (1000, 5, 4, 17, 128),
    (513, 3, 1, 9, 256),      # single node, non-divisible rows
    (2048, 7, 8, 33, 512),
    (900, 11, 4, 17, 128),    # features not a multiple of the 8-wide block
    (3000, 4, 130, 9, 128),   # wider than the node-matmul kernel serves
    (2500, 3, 300, 21, 64),   # K not a power of two, many empty nodes
]


def _sorted_port(bins, nodes, g, h, k, b1, rw=None):
    t = torch.from_numpy
    return cs.hist_sorted_reference(
        t(np.ascontiguousarray(bins.T)), t(nodes), t(g), t(h), k, b1,
        rw=None if rw is None else t(rw)).numpy()


def _jax_sorted(bins, nodes, g, h, k, b1, row_tile, rw=None):
    scatter = np.asarray(_shard_histogram(bins, nodes, g, h, k, b1, rw=rw))
    pallas = np.asarray(build_histogram_pallas(
        bins, nodes, g, h, k, b1, row_tile=row_tile, interpret=True,
        kernel="sorted", rw=rw, dtype="f32"))
    return scatter, pallas


@pytest.mark.parametrize("n,f,k,b1,row_tile", SORTED_SHAPES)
def test_sorted_plain_matches_jax(n, f, k, b1, row_tile):
    bins, nodes, g, h, _ = _mk(n, f, k, b1, seed=n + k)
    got = _sorted_port(bins, nodes, g, h, k, b1)
    scatter, pallas = _jax_sorted(bins, nodes, g, h, k, b1, row_tile)
    assert got.shape == (k, f, b1, 3)
    _assert_hist_close(got, scatter)
    _assert_hist_close(got, pallas)


@pytest.mark.parametrize("weighted", [False, True])
def test_sorted_inactive_rows_empty_nodes_and_count_weight(weighted):
    k = 200
    bins, nodes, g, h, rw = _mk(
        4000, 5, k, 13, seed=17, frac_inactive=0.3, empty_node=100, weighted=weighted)
    nodes[(nodes >= 40) & (nodes < 60)] = -1  # a run of empty nodes mid-range
    got = _sorted_port(bins, nodes, g, h, k, 13, rw=rw)
    scatter, pallas = _jax_sorted(bins, nodes, g, h, k, 13, 128, rw=rw)
    assert np.all(got[100] == 0) and np.all(got[40:60] == 0)
    np.testing.assert_array_equal(got[..., 2], np.round(got[..., 2]))
    _assert_hist_close(got, scatter)
    _assert_hist_close(got, pallas)
    # the bf16 operand mode; the ordered plain version sums the same
    # rounded values in the kernel's order
    rw = _bf16_weight(rw)
    bf16 = _assert_bf16_matches_jax(cs.hist_sorted_reference, "sorted",
                                    bins, nodes, g, h, k, 13, 128, rw=rw)
    assert np.all(bf16[100] == 0) and np.all(bf16[40:60] == 0)
    t = torch.from_numpy
    ordered = cs.hist_sorted_ordered_reference(
        t(np.ascontiguousarray(bins.T)), t(nodes), t(g), t(h), k, 13,
        rw=None if rw is None else t(rw), tile_rows=128, dtype="bf16").numpy()
    if rw is None:
        np.testing.assert_array_equal(ordered[..., 2], bf16[..., 2])
    np.testing.assert_allclose(ordered, bf16, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k,frac_inactive", [(1, 0.0), (7, 0.3), (300, 0.5), (2048, 0.1)])
def test_sorted_prep_matches_jax_prep(k, frac_inactive):
    _, nodes, _, _, _ = _mk(5000, 1, k, 2, seed=k, frac_inactive=frac_inactive)
    layout = cs.sorted_prep(torch.from_numpy(nodes), k, tile_rows=64)
    nd = jnp.where(nodes >= 0, nodes, k)
    np.testing.assert_array_equal(layout.order.numpy(),
                                  np.asarray(jnp.argsort(nd, stable=True)))
    counts = np.asarray(jnp.bincount(nd, length=k + 1)[:k])
    np.testing.assert_array_equal(layout.counts.numpy(), counts)
    assert layout.seg_off[0] == 0 and layout.seg_off[-1] == counts.sum()
    tiles = np.maximum(-(-counts // 64), 1)
    np.testing.assert_array_equal(layout.tile_off.numpy(),
                                  np.concatenate([[0], np.cumsum(tiles)]))
    _, extra = cs.launch_plan(5000, 1, 2, tile_rows=64)
    assert layout.tile_off[-1] <= k + extra


def test_sorted_wrapper_on_cpu_tensors_is_the_plain_version():
    bins, nodes, g, h, rw = _mk(900, 6, 150, 11, seed=12, frac_inactive=0.2,
                                weighted=True)
    t = torch.from_numpy
    args = (t(np.ascontiguousarray(bins.T)), t(nodes), t(g), t(h), 150, 11)
    before = dict(ch.LAUNCHES)
    a = cs.hist_sorted(*args, rw=t(rw))
    assert torch.equal(a, cs.hist_sorted_reference(*args, rw=t(rw)))
    assert ch.LAUNCHES == before  # the plain version launches nothing
    # the two plain versions compute the same function
    b = ch.hist_nodematmul_reference(*args, rw=t(rw))
    assert torch.equal(a[..., 2], b[..., 2])
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    # the wrapper checks the row-major codes it is handed
    bins, nodes, g, h, _ = _mk(300, 5, 130, 21, seed=3, frac_inactive=0.2)
    args = (t(np.ascontiguousarray(bins.T)), t(nodes), t(g), t(h), 130, 21)
    good = cs.row_major_codes(args[0], 21)
    assert good.shape == (300, 16) and good.dtype == torch.uint8
    assert torch.equal(cs.hist_sorted(*args, codes_rm=good), cs.hist_sorted(*args))
    with pytest.raises(TypeError, match="codes_rm"):
        cs.hist_sorted(*args, codes_rm=good.to(torch.int32))
    with pytest.raises(TypeError, match="codes_rm"):
        cs.hist_sorted(*args, codes_rm=cs.row_major_codes(args[0], 257))
    with pytest.raises(ValueError, match="codes_rm has shape"):
        cs.hist_sorted(*args, codes_rm=good[:-1])
    with pytest.raises(ValueError, match="codes_rm has shape"):
        cs.hist_sorted(*args, codes_rm=good[:, :8].contiguous())
    with pytest.raises(ValueError, match="codes_rm must be contiguous"):
        cs.hist_sorted(*args, codes_rm=torch.zeros(16, 300, dtype=torch.uint8).T)
    with pytest.raises(ValueError, match="codes_rm is on meta"):
        cs.hist_sorted(*args, codes_rm=good.to("meta"))
    # the prep treats out-of-range nodes as inactive
    nodes = torch.tensor([2, -1, 5, 0, 2, 9, 1], dtype=torch.int32)
    layout = cs.sorted_prep(nodes, 3)
    assert layout.order.tolist()[:4] == [3, 6, 0, 4]
    assert layout.counts.tolist() == [1, 1, 2]
    # the factorized kernel's wrapper on CPU tensors is its plain version
    bins, nodes, g, h, rw = _mk(800, 6, 5, 257, seed=13, frac_inactive=0.2,
                                weighted=True)
    t = torch.from_numpy
    args = (t(np.ascontiguousarray(bins.T)), t(nodes), t(g), t(h), 5, 257)
    before = dict(ch.LAUNCHES)
    a = cf.hist_factorized(*args, rw=t(rw))
    assert torch.equal(a, cf.hist_factorized_reference(*args, rw=t(rw)))
    assert ch.LAUNCHES == before  # the plain version launches nothing
    # the factorized and the direct plain versions compute the same function
    b = ch.hist_nodematmul_reference(*args, rw=t(rw))
    assert torch.equal(a[..., 2], b[..., 2])
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def _kernel_by_loops(bins_fm, nodes, g, h, k, b1, rw, tile_rows):
    """The sorted kernel's algorithm read as scalar loops in float32: per
    tile and feature, 32-row batches from the tile's first row; a batch's
    lanes with one code sum from 0 in lane order at the lowest such lane,
    which adds the sum into the tile's cell; tile partials in float64."""
    lay = cs.sorted_prep(torch.from_numpy(nodes), k, tile_rows)
    order, seg, toff = lay.order.numpy(), lay.seg_off.numpy(), lay.tile_off.numpy()
    f32 = np.float32
    part = np.zeros((toff[-1], bins_fm.shape[0], 3, b1), np.float32)
    for node in range(k):
        for t in range(toff[node], toff[node + 1]):
            begin = seg[node] + (t - toff[node]) * tile_rows
            end = min(seg[node + 1], begin + tile_rows)
            for f in range(bins_fm.shape[0]):
                for i0 in range(begin, end, 32):
                    rows = [order[i] for i in range(i0, min(i0 + 32, end))]
                    codes = [int(bins_fm[f, r]) for r in rows]
                    for lane, c in enumerate(codes):
                        if not 0 <= c < b1 or codes.index(c) != lane:
                            continue  # no row, or not its code's first lane
                        s = [f32(0)] * 3
                        for r, c2 in zip(rows, codes):
                            if c2 == c:
                                v = (g[r], h[r], f32(1) if rw is None else rw[r])
                                s = [f32(a + b) for a, b in zip(s, v)]
                        for ch_ in range(3):
                            part[t, f, ch_, c] = f32(part[t, f, ch_, c] + s[ch_])
    out = np.zeros((k, bins_fm.shape[0], b1, 3), np.float32)
    for node in range(k):
        acc = np.zeros(part.shape[1:], np.float64)
        for t in range(toff[node], toff[node + 1]):
            acc = acc + part[t].astype(np.float64)
        out[node] = acc.astype(np.float32).transpose(0, 2, 1)
    return out


@pytest.mark.parametrize("weighted", [False, True])
def test_sorted_ordered_plain_is_the_kernel_read_as_loops(weighted):
    # multi-tile nodes (tiles of 64 rows), an empty node, out-of-range nodes,
    # an out-of-range code, and few codes so one batch repeats each many times
    k, b1 = 6, 5
    bins, nodes, g, h, rw = _mk(900, 3, k, b1, seed=23, frac_inactive=0.2,
                                empty_node=3, weighted=weighted)
    nodes[::37] = k + 2
    bins_fm = np.ascontiguousarray(bins.T)
    bins_fm[1, ::11] = b1 + 1
    t = torch.from_numpy
    got = cs.hist_sorted_ordered_reference(
        t(bins_fm), t(nodes), t(g), t(h), k, b1,
        rw=None if rw is None else t(rw), tile_rows=64).numpy()
    want = _kernel_by_loops(bins_fm, nodes, g, h, k, b1, rw, 64)
    assert np.all(np.bincount(nodes[(nodes >= 0) & (nodes < k)])[[0, 1, 2, 4, 5]] > 64)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert np.all(got[3] == 0)


@pytest.mark.parametrize("n,f,k,b1,row_tile", SORTED_SHAPES)
def test_sorted_ordered_plain_matches_plain_and_jax(n, f, k, b1, row_tile):
    bins, nodes, g, h, rw = _mk(n, f, k, b1, seed=n + k + 1, frac_inactive=0.3,
                                weighted=k % 2 == 0)
    t = torch.from_numpy
    args = (t(np.ascontiguousarray(bins.T)), t(nodes), t(g), t(h), k, b1)
    rwt = None if rw is None else t(rw)
    got = cs.hist_sorted_ordered_reference(*args, rw=rwt, tile_rows=128).numpy()
    _assert_hist_close(got, cs.hist_sorted_reference(*args, rw=rwt).numpy())
    scatter, pallas = _jax_sorted(bins, nodes, g, h, k, b1, row_tile, rw=rw)
    _assert_hist_close(got, scatter)
    _assert_hist_close(got, pallas)


@pytest.mark.parametrize("n_bins1,dtype,per_16_bytes", [
    (256, torch.uint8, 16), (257, torch.uint16, 8),
    (65_536, torch.uint16, 8), (65_537, None, None)])
def test_row_major_codes_width_padding_and_values(n_bins1, dtype, per_16_bytes):
    # the narrowest unsigned type that holds codes 0 .. n_bins1 - 1 (the NA
    # code included), rows padded to whole 16 bytes, the values of bins_fm.T;
    # past 2 bytes no level fits the kernel, and the copy raises
    rng = np.random.default_rng(n_bins1)
    if dtype is None:
        with pytest.raises(ValueError, match="2 bytes"):
            cs.code_dtype(n_bins1)
        with pytest.raises(ValueError, match="2 bytes"):
            cs.row_major_codes(torch.zeros(3, 5, dtype=torch.int32), n_bins1)
        return
    assert cs.code_dtype(n_bins1) == dtype
    # a code outside [0, n_bins1) stays outside it (no row to the kernel)
    # where the type has room, and raises where it has none
    top = torch.iinfo(dtype).max
    bad = torch.tensor([[3, -1, n_bins1, n_bins1 + 256, n_bins1 - 1]],
                       dtype=torch.int32)
    if top >= n_bins1:
        assert cs.row_major_codes(bad, n_bins1)[:, 0].tolist() == \
            [3, top, n_bins1, n_bins1, n_bins1 - 1]
    else:
        with pytest.raises(ValueError, match="outside"):
            cs.row_major_codes(bad, n_bins1)
        assert cs.row_major_codes(bad[:, ::4], n_bins1)[:, 0].tolist() == \
            [3, n_bins1 - 1]
    for f in (1, 3, 17, 28):
        bins_fm = torch.from_numpy(
            rng.integers(0, n_bins1, size=(f, 50)).astype(np.int32))
        bins_fm[:, 0] = n_bins1 - 1
        codes = cs.row_major_codes(bins_fm, n_bins1)
        assert codes.dtype == dtype and codes.is_contiguous()
        assert codes.shape == (50, -(-f // per_16_bytes) * per_16_bytes)
        assert codes.shape[1] * codes.element_size() % 16 == 0
        assert cs.row_elems(f, n_bins1) == codes.shape[1]
        assert torch.equal(codes[:, :f].long(), bins_fm.T.long())
        assert torch.all(codes[:, f:].long() == 0)


@pytest.mark.parametrize("weighted", [False, True])
def test_gather_twin_is_plain_indexing(weighted):
    k = 9
    bins, nodes, g, h, rw = _mk(700, 5, k, 257, seed=31, frac_inactive=0.3,
                                weighted=weighted)
    nodes[::13] = k + 1  # out of range: inactive
    t = torch.from_numpy
    bins_fm = t(np.ascontiguousarray(bins.T))
    lay = cs.sorted_prep(t(nodes), k)
    rows = cs.gather_rows(cs.row_major_codes(bins_fm, 257), lay, t(g), t(h),
                          None if rw is None else t(rw), 5)
    m = int(lay.seg_off[-1])
    assert m == np.sum((nodes >= 0) & (nodes < k))
    order = lay.order[:m].long()
    assert rows.codes.dtype == torch.uint16 and rows.codes.shape == (5, 700)
    assert torch.equal(rows.codes[:, :m].long(), bins_fm[:, order].long())
    assert torch.equal(rows.g[:m], t(g)[order])
    assert torch.equal(rows.h[:m], t(h)[order])
    if rw is None:
        assert rows.w is None
    else:
        assert torch.equal(rows.w[:m], t(rw)[order])


@pytest.mark.parametrize("max_depth,subtract,sorted_levels", [
    (9, True, 1), (8, False, 1), (8, True, 0), (7, False, 0)])
def test_fit_makes_codes_rm_once_for_its_sorted_levels(
        monkeypatch, max_depth, subtract, sorted_levels):
    # a fit makes one FitCache and hands it to every level; only sorted
    # levels (D-1 here, half of it with subtraction) ask it for codes_rm,
    # which it makes at the first ask and only off the CPU
    from h2o3_tpu_torch.models.tree import booster as pb
    from h2o3_tpu_torch.ops import histogram as hmod

    made, caches, seen = [], [], []
    make = hmod.row_major_codes
    monkeypatch.setattr(hmod, "row_major_codes",
                        lambda *a: made.append(make(*a)) or made[-1])
    real_build = pb.build_histogram
    monkeypatch.setattr(pb, "build_histogram",
                        lambda *a, **kw: caches.append(kw["cache"]) or real_build(*a, **kw))
    real = hmod.hist_sorted
    monkeypatch.setattr(hmod, "hist_sorted",
                        lambda *a, **kw: seen.append(kw["codes_rm"]) or real(*a, **kw))
    rng = np.random.default_rng(3)
    X = rng.normal(size=(3000, 4))
    y = X[:, 0] + rng.normal(size=3000)
    p = pb.TreeParams(ntrees=2, max_depth=max_depth, nbins=20, seed=1)
    pb.train_boosted(X, "gaussian", y, 1, np.zeros(1), p, device="cpu",
                     hist_impl="kernel", subtract=subtract)
    assert caches and all(c is caches[0] for c in caches)
    assert isinstance(caches[0], hmod.FitCache)
    # on the CPU the sorted levels take the plain version: nothing is made
    assert len(seen) == 2 * sorted_levels and seen.count(None) == len(seen)
    assert made == []
    # off the CPU the cache makes the copy at the first ask, once
    cache = hmod.FitCache(torch.zeros(4, 3000, dtype=torch.int32, device="meta"), 21)
    assert made == [] and cache.codes_rm() is cache.codes_rm() is made[0]
    assert made[0].shape == (3000, 16) and made[0].dtype == torch.uint8
    # the plain histogram asks for nothing
    made.clear()
    pb.train_boosted(X, "gaussian", y, 1, np.zeros(1), p, device="cpu",
                     hist_impl="plain", subtract=subtract)
    assert made == []

    _check_fits_through_the_frame_cache(monkeypatch, X, y, caches, max_depth, subtract)
    _check_cache_protocol_matches_jax()


def _check_fits_through_the_frame_cache(monkeypatch, X, y, caches, max_depth, subtract):
    """Builder fits keep their FitCache in the device frame cache: a repeat
    fit on the unmutated frame hits and hands its levels the cached
    FitCache, with equal trees; so does a DRF fit with the same bins and
    seed; a mutated column, DKV.remove of the frame's key or a cleared
    cache makes the next fit miss, with equal trees."""
    import h2o3_tpu_torch as ht
    from h2o3_tpu_torch.frame import devcache
    from h2o3_tpu_torch.keyed import DKV as PDKV

    fresh = devcache.DeviceFrameCache()
    monkeypatch.setattr(devcache, "DEVCACHE", fresh)
    fr = ht.Frame.from_dict({**{f"x{j}": X[:, j] for j in range(4)}, "y": y})
    fr.key = PDKV.put(PDKV.make_key("frame"), fr)
    kw = dict(response_column="y", ntrees=2, max_depth=max_depth, nbins=20, seed=1,
              tree_subtract=subtract, hist_impl="kernel", device="cpu")

    def fit(case, builder, hits, misses):
        caches.clear()
        m = builder(**kw).train(fr)
        assert caches and all(c is caches[0] for c in caches), case
        got = fresh.stats()["kinds"]["tree_bins"]
        assert (got["hits"], got["misses"]) == (hits, misses), (case, got)
        assert caches[0].bins_fm is fresh._entries[next(reversed(fresh._entries))].value.bins_fm, case
        return m, caches[0]

    first, cache = fit("first fit", ht.GBM, 0, 1)
    again, cache_again = fit("repeat fit", ht.GBM, 1, 1)
    assert cache_again is cache, "the repeat fit is not handed the cached FitCache"
    drf, cache_drf = fit("DRF with GBM's bins and seed", ht.DRF, 2, 1)
    assert cache_drf is cache, "the DRF fit does not share GBM's entry"
    fr.col("x1").invalidate_rollups()
    mutated, cache_mutated = fit("after a mutated column", ht.GBM, 2, 2)
    assert cache_mutated is not cache
    PDKV.remove(fr.key)
    assert len(fresh) == 0, "DKV.remove left the frame's entries"
    removed, _ = fit("after DKV.remove", ht.GBM, 2, 3)
    fresh.clear()
    cleared, _ = fit("after clear", ht.GBM, 2, 4)
    for name, m in (("repeat", again), ("mutated", mutated), ("removed", removed),
                    ("cleared", cleared)):
        for f in ("feat", "split_bin", "default_left", "is_split", "leaf"):
            np.testing.assert_array_equal(
                np.stack(getattr(first.booster.trees_per_class[0], f)),
                np.stack(getattr(m.booster.trees_per_class[0], f)), err_msg=f"{name} {f}")


def _check_cache_protocol_matches_jax():
    """One sequence of lookups through the port's DeviceFrameCache and the
    JAX package's: after each step the same builds (misses, in order), the
    same surviving keys in LRU order and the same bytes."""
    from h2o3_tpu.frame.devcache import DeviceFrameCache as JDeviceFrameCache
    from h2o3_tpu_torch.frame import devcache

    port, ref = devcache.DeviceFrameCache(max_bytes=100), JDeviceFrameCache(max_bytes=100)
    built = {"port": [], "jax": []}
    gets = 0

    def get(key, nbytes, frame_key=None):
        nonlocal gets
        gets += 1
        for name, cache, make in (
                ("port", port, lambda: torch.zeros(nbytes, dtype=torch.uint8)),
                ("jax", ref, lambda: np.zeros(nbytes, dtype=np.uint8))):
            cache.get_or_put(key, lambda: built[name].append(key) or make(),
                             frame_key=frame_key, kind="tree_bins")

    def check(step, keys):
        assert built["port"] == built["jax"], step
        assert list(port._entries) == list(ref._entries) == keys, step
        assert port.stats()["bytes"] == ref.stats()["bytes"], step
        counts = port.stats()["kinds"]["tree_bins"]
        assert (counts["misses"], counts["hits"]) == (
            len(built["port"]), gets - len(built["port"])), step

    def key(name, device="cpu"):
        return devcache.cache_key("tree_bins", ("frame", 10, ((name, 1),)), ("e", 20), device)

    A, B, C, D, E, F, G = (key(c) for c in "ABCDEFG")
    get(A, 40, "fa")
    get(B, 40)
    check("two entries", [A, B])
    get(A, 40)
    check("a hit moves A last", [B, A])
    get(C, 40)
    check("over budget: the least recently used goes", [A, C])
    get(B, 40)
    check("B again is a miss", [C, B])
    get(D, 500)
    check("an oversized newest entry stays alone", [D])
    for cache in (port, ref):
        cache.set_max_bytes(1000)
    get(E, 10)
    for cache in (port, ref):
        cache.set_max_bytes(20)
    check("set_max_bytes shrinks", [E])
    for cache in (port, ref):
        cache.grow_entry(E, 15)
        cache.grow_entry(A, 15)  # evicted: no-op
    check("grow_entry on the only entry", [E])
    get(F, 5, "fa")
    get(G, 5, "fb")
    check("growth counted", [F, G])
    assert port.invalidate_frame("fa") == ref.invalidate_frame("fa") == 1
    check("invalidate_frame", [G])
    cpu, meta = key("H"), key("H", "meta")
    assert cpu != meta, "the device is not in the key"
    get(cpu, 5)
    get(meta, 5)
    get(cpu, 5)
    check("the device in the key", [G, meta, cpu])
    for cache in (port, ref):
        cache.clear()
    check("clear", [])
    n_built, before = [], devcache.DEVCACHE.stats()
    for _ in range(2):  # no token: built every time, never kept or counted
        devcache.cached("tree_bins", None, None, "cpu", lambda: n_built.append(1))
    assert len(n_built) == 2 and devcache.DEVCACHE.stats() == before


def test_dispatch_takes_the_sorted_kernel_beyond_64_padded_nodes(monkeypatch):
    from h2o3_tpu_torch.ops import histogram as hmod

    calls = []
    monkeypatch.setattr(hmod, "hist_sorted",
                        lambda *a, **kw: calls.append(("sorted", a[4])) or "s")
    monkeypatch.setattr(hmod, "hist_nodematmul",
                        lambda *a, **kw: calls.append(("nodematmul", a[4])) or "n")
    z = torch.zeros(1, 4, dtype=torch.int32)
    for k in (1, 8, 64, 65, 128, 512, 1024):
        hmod.build_histogram(z, z[0], z[0].float(), z[0].float(), k, 3, impl="kernel")
    assert calls == [("nodematmul", 1), ("nodematmul", 8), ("nodematmul", 64),
                     ("sorted", 65), ("sorted", 128), ("sorted", 512),
                     ("sorted", 1024)]

    # only a level that goes to the sorted kernel asks the fit's cache for
    # its row-major codes, and hands them to that kernel alone
    calls = []
    for name in ("hist_factorized", "hist_nodematmul", "hist_sorted"):
        monkeypatch.setattr(
            hmod, name, lambda *a, _n=name[5:], **kw:
            calls.append((_n, a[4], kw.get("codes_rm", "absent"))) or _n)
    z = torch.zeros(1, 4, dtype=torch.int32)
    codes_rm = cs.row_major_codes(z, 3)

    class Cache:
        asked = 0

        def codes_rm(self):
            self.asked += 1
            return codes_rm

    cache = Cache()
    for k in (1, 8, 64, 65, 512):
        hmod.build_histogram(z, z[0], z[0].float(), z[0].float(), k, 3,
                             impl="kernel", fact_max_kc=32, cache=cache)
    assert calls == [("factorized", 1, "absent"), ("factorized", 8, "absent"),
                     ("nodematmul", 64, "absent"), ("sorted", 65, codes_rm),
                     ("sorted", 512, codes_rm)]
    assert cache.asked == 2
    calls.clear()
    hmod.build_histogram(z, z[0], z[0].float(), z[0].float(), 65, 3, impl="kernel")
    assert calls == [("sorted", 65, None)]  # no cache: the kernel makes its own


# ---------------------------------------------------------------------------
# the factorized kernel's plain version (B3)

FACT_SHAPES = [
    (1000, 5, 4, 17, 128),
    (513, 3, 1, 9, 256),      # single node, non-divisible rows
    (2048, 7, 8, 33, 512),
    (900, 11, 4, 17, 128),    # features not a multiple of the 8-wide block
    (2000, 5, 2, 257, 512),   # 257 bins: HI = 17, slab cells 257..271 cut
]


def _fact_port(bins, nodes, g, h, k, b1, rw=None):
    t = torch.from_numpy
    return cf.hist_factorized_reference(
        t(np.ascontiguousarray(bins.T)), t(nodes), t(g), t(h), k, b1,
        rw=None if rw is None else t(rw)).numpy()


def _jax_fact(bins, nodes, g, h, k, b1, row_tile, rw=None):
    scatter = np.asarray(_shard_histogram(bins, nodes, g, h, k, b1, rw=rw))
    pallas = np.asarray(build_histogram_pallas(
        bins, nodes, g, h, k, b1, row_tile=row_tile, interpret=True,
        kernel="factorized", rw=rw, dtype="f32"))
    return scatter, pallas


def _ordered(bins, nodes, g, h, k, b1, rw=None, dtype="f32"):
    t = torch.from_numpy
    return ch.hist_chunked_ordered_reference(
        t(np.ascontiguousarray(bins.T)), t(nodes), t(g), t(h), k, b1,
        rw=None if rw is None else t(rw), dtype=dtype).numpy()


def _fact_kernel_by_loops(bins_fm, nodes, g, h, k, b1, rw, stage_rows, dtype):
    """The factorized kernel's algorithm read as scalar loops in float32:
    the row chunks of ``row_chunks``, each walked in stages of
    ``stage_rows`` rows; a stage's active rows (0 <= node < k) in row order,
    cut into packs of whole 32-row batches with at most 32 active rows; per
    feature and pack, the lanes of one (node, bin) cell led by the lowest,
    which walks them in lane order, sums each batch's values from 0 and
    adds each batch's sum into the cell in turn; then the chunk partials in
    float64, in chunk order. Values in operand mode ``dtype``."""
    def operand(v):
        return cuda_build.round_operand(torch.from_numpy(v), dtype).numpy()

    f32 = np.float32
    g, h = operand(g), operand(h)
    w = np.ones_like(g) if rw is None else operand(rw)
    n_feat, n = bins_fm.shape
    chunk_rows, n_chunks = ch.row_chunks(n, n_feat)
    part = np.zeros((n_chunks, n_feat, k, b1, 3), np.float32)
    for c in range(n_chunks):
        end = min(n, (c + 1) * chunk_rows)
        for r0 in range(c * chunk_rows, end, stage_rows):
            stop = min(end, r0 + stage_rows)
            packs = [[]]
            for b0 in range(r0, stop, 32):
                batch = [r for r in range(b0, min(b0 + 32, stop)) if 0 <= nodes[r] < k]
                if len(packs[-1]) + len(batch) > 32:
                    packs.append([])
                packs[-1] += batch
            for f in range(n_feat):
                for pack in packs:
                    cells = [(nodes[r], bins_fm[f, r]) for r in pack]
                    for lane, (nd, code) in enumerate(cells):
                        if not 0 <= code < b1 or cells.index((nd, code)) != lane:
                            continue  # no row, or not its cell's first lane
                        acc = [f32(x) for x in part[c, f, nd, code]]
                        s, batch = [f32(0)] * 3, pack[lane] // 32
                        for r, cell in zip(pack[lane:], cells[lane:]):
                            if cell != (nd, code):
                                continue
                            if r // 32 != batch:  # the next batch of this cell
                                acc = [f32(a + b) for a, b in zip(acc, s)]
                                s, batch = [f32(0)] * 3, r // 32
                            s = [f32(a + b) for a, b in zip(s, (g[r], h[r], w[r]))]
                        part[c, f, nd, code] = [f32(a + b) for a, b in zip(acc, s)]
    out = np.zeros(part.shape[1:], np.float64)
    for c in range(n_chunks):
        out = out + part[c].astype(np.float64)
    return out.astype(np.float32).transpose(1, 0, 2, 3)


@pytest.mark.parametrize("n,f,k,b1,row_tile", FACT_SHAPES)
def test_factorized_plain_matches_jax(n, f, k, b1, row_tile):
    bins, nodes, g, h, _ = _mk(n, f, k, b1, seed=n + b1)
    got = _fact_port(bins, nodes, g, h, k, b1)
    scatter, pallas = _jax_fact(bins, nodes, g, h, k, b1, row_tile)
    assert got.shape == (k, f, b1, 3)
    _assert_hist_close(got, scatter)
    _assert_hist_close(got, pallas)
    if b1 == 257:  # the NA code 256 is slab cell (hi 16, lo 0)
        assert got[..., 256, 2].sum() == np.sum(bins == 256)
    # the kernels' float order (the bit oracle of B1 and B3) computes the
    # same function
    ordered = _ordered(bins, nodes, g, h, k, b1)
    _assert_hist_close(ordered, pallas)
    _assert_hist_close(ordered, scatter)


@pytest.mark.parametrize("weighted,b1", [(False, 13), (True, 13), (True, 257)])
def test_factorized_inactive_rows_empty_nodes_and_count_weight(weighted, b1):
    bins, nodes, g, h, rw = _mk(
        1500, 4, 6, b1, seed=19, frac_inactive=0.3, empty_node=2, weighted=weighted)
    got = _fact_port(bins, nodes, g, h, 6, b1, rw=rw)
    scatter, pallas = _jax_fact(bins, nodes, g, h, 6, b1, 128, rw=rw)
    assert np.all(got[2] == 0)  # the empty node is exactly zero
    np.testing.assert_array_equal(got[..., 2], np.round(got[..., 2]))
    _assert_hist_close(got, scatter)
    _assert_hist_close(got, pallas)
    # the bf16 operand mode
    bf16 = _assert_bf16_matches_jax(cf.hist_factorized_reference, "factorized",
                                    bins, nodes, g, h, 6, b1, 128,
                                    rw=_bf16_weight(rw))
    assert np.all(bf16[2] == 0)
    # the kernels' ordered plain version: the kernel read as loops, bit for
    # bit, in both modes, here (30% inactive: a pack is mostly one batch)
    # and at 70% inactive (packs of two batches and more) with an
    # out-of-range node and code; and the Pallas kernel at the tolerance
    sparse = nodes.copy()
    sparse[np.random.default_rng(5).random(sparse.size) < 0.57] = -1
    sparse[::41] = 7
    odd = bins.copy()
    odd[::13, 1] = b1 + 2
    for nd, bn in ((nodes, bins), (sparse, odd)):
        bins_fm = np.ascontiguousarray(bn.T)
        for dtype, w in (("f32", rw), ("bf16", _bf16_weight(rw))):
            got = _ordered(bn, nd, g, h, 6, b1, rw=w, dtype=dtype)
            want = _fact_kernel_by_loops(bins_fm, nd, g, h, 6, b1, w, 64, dtype)
            np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    _assert_hist_close(_ordered(bins, nodes, g, h, 6, b1, rw=rw), pallas)
    bf16_ordered = _assert_bf16_matches_jax(ch.hist_chunked_ordered_reference,
                                            "factorized", bins, nodes, g, h, 6, b1,
                                            128, rw=_bf16_weight(rw))
    assert np.all(bf16_ordered[2] == 0)


@pytest.mark.parametrize("fact_max_kc,want", [
    (0, ["nodematmul"] * 4 + ["sorted"] * 2),
    (32, ["factorized"] * 2 + ["nodematmul"] * 2 + ["sorted"] * 2),
    (256, ["factorized"] * 4 + ["sorted"] * 2),
])
def test_dispatch_takes_the_factorized_kernel_up_to_fact_max_kc(
        monkeypatch, fact_max_kc, want):
    from h2o3_tpu_torch.ops import histogram as hmod

    calls = []
    for name in ("hist_factorized", "hist_nodematmul", "hist_sorted"):
        monkeypatch.setattr(
            hmod, name,
            lambda *a, _n=name[5:], **kw: calls.append((_n, a[4])) or _n)
    z = torch.zeros(1, 4, dtype=torch.int32)
    ks = (1, 8, 9, 64, 65, 512)
    for k in ks:
        hmod.build_histogram(z, z[0], z[0].float(), z[0].float(), k, 3,
                             impl="kernel", fact_max_kc=fact_max_kc)
    assert calls == list(zip(want, ks))
    # the plain version builds every level whatever the limit
    calls.clear()
    hmod.build_histogram(z, z[0], z[0].float(), z[0].float(), 1, 3,
                         impl="plain", fact_max_kc=fact_max_kc)
    assert calls == []


def test_dispatch_hands_the_operand_mode_to_every_kernel(monkeypatch):
    # whichever version builds a level gets build_histogram's dtype, in
    # both modes; a mode outside HIST_DTYPES raises before any is called
    from h2o3_tpu_torch.ops import histogram as hmod

    calls = []
    for name in ("hist_factorized", "hist_nodematmul", "hist_sorted",
                 "hist_nodematmul_reference"):
        monkeypatch.setattr(
            hmod, name,
            lambda *a, _n=name[5:], **kw: calls.append((_n, a[4], kw["dtype"])) or _n)
    z = torch.zeros(1, 4, dtype=torch.int32)
    for dtype in cuda_build.HIST_DTYPES:
        calls.clear()
        for k, impl in ((1, "kernel"), (16, "kernel"), (65, "kernel"), (65, "plain")):
            hmod.build_histogram(z, z[0], z[0].float(), z[0].float(), k, 3,
                                 impl=impl, fact_max_kc=32, dtype=dtype)
        assert calls == [("factorized", 1, dtype), ("nodematmul", 16, dtype),
                         ("sorted", 65, dtype), ("nodematmul_reference", 65, dtype)]
    calls.clear()
    with pytest.raises(ValueError, match="hist dtype must be 'f32' or 'bf16'"):
        hmod.build_histogram(z, z[0], z[0].float(), z[0].float(), 1, 3,
                             impl="kernel", dtype="float32")
    assert calls == []

    # what the factorized kernel cannot hold goes to the node-matmul
    # kernel: at 2,417 bins one node's [HI, 1, 3, 16] slab is 29,184 bytes:
    # the factorized kernel holds 7 nodes, not 8, so fact_max_kc=32 sends
    # the 8-node level to the node-matmul kernel (the same sum order, the
    # same bits) instead of a launch plan that raises
    calls = []
    for name in ("hist_factorized", "hist_nodematmul", "hist_sorted"):
        monkeypatch.setattr(
            hmod, name,
            lambda *a, _n=name[5:], **kw: calls.append((_n, a[4])) or _n)
    z = torch.zeros(1, 4, dtype=torch.int32)
    ks = (1, 7, 8, 9, 64, 65)
    for k in ks:
        hmod.build_histogram(z, z[0], z[0].float(), z[0].float(), k, 2417,
                             impl="kernel", fact_max_kc=32)
    assert calls == list(zip(["factorized", "factorized", "nodematmul",
                              "nodematmul", "nodematmul", "sorted"], ks))
    assert cf.fits(7, 2417) and not cf.fits(8, 2417)
    with pytest.raises(ValueError, match="shared memory"):
        cf.launch_plan(1000, 4, 8, 2417)
    ch.launch_plan(1000, 4, 8, 2417)  # the node-matmul kernel takes it

    # the bf16 operand mode rounds each float32 value to nearest even, as
    # the JAX package's astype(bfloat16) does: ties (1 + 2^-8 goes down to
    # 1, 1 + 3·2^-8 up to 1 + 2^-6), subnormals, the largest floats, signed
    # zeros; a float64 value is rounded through float32, as the JAX package
    # casts g, h and the weight to float32 first; f32 leaves a value as it is
    rng = np.random.default_rng(41)
    v = np.concatenate([
        np.float32([1 + 2**-8, 1 + 3 * 2**-8, -(1 + 2**-8), 2**-140, -2**-133,
                    3.4e38, -3.4e38, 0.0, -0.0, 1.0, 3.0]),
        rng.normal(size=500).astype(np.float32),
        (rng.normal(size=500) * 1e-30).astype(np.float32)])
    got = cuda_build.round_operand(torch.from_numpy(v), "bf16")
    want = np.asarray(jnp.asarray(v).astype(jnp.bfloat16).astype(jnp.float32))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    assert got[0] == 1.0 and got[1] == 1 + 2**-6
    v64 = np.float64([1 + 2**-8 + 2**-30, -(1 + 2**-8 + 2**-30)])
    got = cuda_build.round_operand(torch.from_numpy(v64), "bf16").numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jnp.asarray(v64, jnp.float32).astype(jnp.bfloat16).astype(jnp.float32)))
    assert got[0] == 1.0  # 1 + 2^-8 in float32: a tie, to even
    t = torch.from_numpy(v)
    assert cuda_build.round_operand(t, "f32") is t
    # every plain version in bf16: a float64 sum of the rounded values (the
    # count of an unweighted row stays 1)
    bins, nodes, g, h, rw = _mk(3000, 5, 8, 17, seed=43, frac_inactive=0.3,
                                empty_node=4, weighted=True)
    rw = _bf16_weight(rw)

    def r(a):
        return cuda_build.round_operand(torch.from_numpy(a), "bf16").double().numpy()

    args = (torch.from_numpy(np.ascontiguousarray(bins.T)), torch.from_numpy(nodes),
            torch.from_numpy(g), torch.from_numpy(h), 8, 17)
    for w in (None, rw):
        want = np.zeros((8, 5, 17, 3))
        act = nodes >= 0
        for f in range(5):
            for c, val in enumerate((r(g), r(h), np.ones(3000) if w is None else r(w))):
                np.add.at(want[:, f, :, c], (nodes[act], bins[act, f]), val[act])
        for plain in (ch.hist_nodematmul_reference, cs.hist_sorted_reference,
                      cs.hist_sorted_ordered_reference, cf.hist_factorized_reference):
            got = plain(*args, rw=None if w is None else torch.from_numpy(w),
                        dtype="bf16").numpy()
            if w is None:
                np.testing.assert_array_equal(got[..., 2], want[..., 2])
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
