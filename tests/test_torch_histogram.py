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
from h2o3_tpu_torch.ops import cuda_factorized_histogram as cf
from h2o3_tpu_torch.ops import cuda_histogram as ch
from h2o3_tpu_torch.ops import cuda_sorted_histogram as cs
from h2o3_tpu_torch.ops.histogram import (
    apply_bins,
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


def test_counts_are_exact_integers():
    bins, nodes, g, h, _ = _mk(700, 2, 3, 5, seed=3)
    counts = _port(bins, nodes, g, h, 3, 5)[..., 2]
    np.testing.assert_array_equal(counts, np.round(counts))
    assert counts.sum() == 700 * 2


def test_wrapper_on_cpu_tensors_is_the_plain_version():
    bins, nodes, g, h, rw = _mk(777, 6, 5, 11, seed=11, frac_inactive=0.2,
                                weighted=True)
    args = (torch.from_numpy(np.ascontiguousarray(bins.T)), torch.from_numpy(nodes),
            torch.from_numpy(g), torch.from_numpy(h), 5, 11)
    before = dict(ch.LAUNCHES)
    a = ch.hist_nodematmul(*args, rw=torch.from_numpy(rw))
    b = ch.hist_nodematmul_reference(*args, rw=torch.from_numpy(rw))
    assert torch.equal(a, b)
    assert ch.LAUNCHES == before  # the plain version launches nothing


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


def test_pad_nodes_ladder_matches_jax():
    for k in range(1, 700):
        assert pad_nodes(k) == jax_pad_nodes(k)


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


def test_sorted_prep_treats_out_of_range_nodes_as_inactive():
    nodes = torch.tensor([2, -1, 5, 0, 2, 9, 1], dtype=torch.int32)
    layout = cs.sorted_prep(nodes, 3)
    assert layout.order.tolist()[:4] == [3, 6, 0, 4]
    assert layout.counts.tolist() == [1, 1, 2]


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


def test_factorized_wrapper_on_cpu_tensors_is_the_plain_version():
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


def test_dispatch_sends_what_the_factorized_kernel_cannot_hold_to_nodematmul(
        monkeypatch):
    # at 2,417 bins one node's [HI, 1, 3, 16] slab is 29,184 bytes: the
    # factorized kernel holds 7 nodes, not 8, so fact_max_kc=32 sends the
    # 8-node level to the node-matmul kernel (the same sum order, the same
    # bits) instead of a launch plan that raises
    from h2o3_tpu_torch.ops import histogram as hmod

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
