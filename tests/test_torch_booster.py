"""Parity: the PyTorch port's booster pieces vs the JAX package on the CPU.

``grad_hess_device`` on fixed targets (every objective family's is held
in ``tests/test_torch_glm.py``'s ``test_grad_hess_matches_jax``),
``_split_search`` (with and without the subtraction flow's child stats,
with a per-feature and a per-node feature mask, and in monotone mode), the
ensemble scorer
``_predict_stacked``, the booster loop with row/column sampling and mtries
(the JAX random streams, reproduced by ``util/jrandom.py``), with monotone
constraints, and continued from a checkpoint (``resume_from``), and the
parameters that are not ported yet, which must raise
``NotImplementedError`` rather than fall back.

Tolerances: float32 elementwise math in two frameworks (rtol 1e-6 for
g/h); split decisions are compared exactly on inputs whose best gains are
well separated, and gains/leaf values at rtol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from h2o3_tpu.models.tree import booster as jb
from h2o3_tpu_torch import use_device
from h2o3_tpu_torch.models.tree import booster as tb

torch.set_num_threads(1)


def _random_hist(rng, k, f, b1):
    """A level histogram with integer counts, consistent totals across
    features (every row lands in one bin of every feature), and one node
    too small to split."""
    n = 400 * k
    nodes = rng.integers(0, k, size=n)
    nodes[nodes == k - 1] = 0
    nodes[: 3] = k - 1  # a 3-row node: min_rows blocks every split
    bins = rng.integers(0, b1, size=(n, f))
    g = rng.normal(size=n) + 0.8 * (bins[:, 0] > b1 // 2)  # feature 0 splits
    h = rng.random(n) + 0.2
    hist = np.zeros((k, f, b1, 3), np.float32)
    for j in range(f):
        np.add.at(hist, (nodes, j, bins[:, j]), np.stack([g, h, np.ones(n)], 1))
    return hist


@pytest.mark.parametrize("child_stats", [False, True])
@pytest.mark.parametrize("lam,alpha,gamma,min_rows", [
    (1.0, 0.0, 0.0, 1.0), (0.0, 0.0, 0.0, 10.0), (2.0, 0.3, 0.1, 5.0)])
def test_split_search_matches_jax(child_stats, lam, alpha, gamma, min_rows):
    rng = np.random.default_rng(int(lam * 10 + min_rows))
    k, f, b1 = 4, 5, 17
    hist = _random_hist(rng, k, f, b1)
    mask = np.ones(f, bool)
    mask[3] = False
    want = jb._split_search(
        jnp.asarray(hist), jnp.float32(lam), jnp.float32(alpha),
        jnp.float32(gamma), jnp.float32(0.1), jnp.asarray(mask),
        min_rows=min_rows, n_bins1=b1, child_stats=child_stats)
    got = tb._split_search(
        torch.from_numpy(hist), lam, alpha, gamma, 0.1, torch.from_numpy(mask),
        min_rows=min_rows, n_bins1=b1, child_stats=child_stats)
    assert len(got) == len(want)
    feat, bin_, dl, gain = (np.asarray(w) for w in want[:4])
    np.testing.assert_array_equal(got[0].numpy(), feat)
    np.testing.assert_array_equal(got[1].numpy(), bin_)
    np.testing.assert_array_equal(got[2].numpy(), dl)
    if min_rows > 3:  # the 3-row node has no allowed split
        assert np.isneginf(gain[-1]) and np.isneginf(got[3][-1].item())
    np.testing.assert_allclose(got[3].numpy(), gain, rtol=1e-5, atol=1e-6)
    for g_, w_ in zip(got[4:], want[4:]):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("child_stats", [False, True])
def test_split_search_monotone_matches_jax(child_stats):
    # feature 0 carries the signal (g rises with the bin, so the unconstrained
    # best split has wl > wr): +1 on it masks those candidates, -1 on feature
    # 1 masks the other direction; node bounds clip the leaf values
    rng = np.random.default_rng(12)
    k, f, b1 = 4, 5, 17
    hist = _random_hist(rng, k, f, b1)
    cons = np.array([1, -1, 0, 1, 0], np.int32)
    lo = np.array([-np.inf, -0.05, -np.inf, 0.01], np.float32)
    hi = np.array([np.inf, 0.02, 0.0, np.inf], np.float32)
    mask = np.ones(f, bool)
    want = jb._split_search(
        jnp.asarray(hist), jnp.float32(1.0), jnp.float32(0.0), jnp.float32(0.0),
        jnp.float32(0.3), jnp.asarray(mask), min_rows=1.0, n_bins1=b1,
        constraints=jnp.asarray(cons), node_lo=jnp.asarray(lo),
        node_hi=jnp.asarray(hi), child_stats=child_stats)
    got = tb._split_search(
        torch.from_numpy(hist), 1.0, 0.0, 0.0, 0.3, torch.from_numpy(mask),
        min_rows=1.0, n_bins1=b1, child_stats=child_stats,
        constraints=torch.from_numpy(cons), node_lo=torch.from_numpy(lo),
        node_hi=torch.from_numpy(hi))
    assert len(got) == len(want) == 8
    for name, g_, w_ in zip(("feat", "bin", "dl"), got[:3], want[:3]):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_), err_msg=name)
    for g_, w_ in zip(got[3:], want[3:]):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=1e-5, atol=1e-6)
    leaf = got[4].numpy() / 0.3
    assert np.all(leaf >= lo - 1e-7) and np.all(leaf <= hi + 1e-7)
    # a chosen split on a constrained feature respects its direction
    for j in range(k):
        c = cons[got[0][j].item()]
        if np.isfinite(got[3][j].item()) and c:
            assert c * (got[6][j].item() - got[5][j].item()) >= 0


SAMPLED = [
    ("gaussian", dict(sample_rate=0.7), 1),
    ("gaussian", dict(col_sample_rate_per_tree=0.6), 1),
    ("gaussian", dict(mtries=2, sample_rate=0.632), 1),
    ("gaussian", dict(mtries=12), 1),  # more than F: JAX keeps every feature
    ("multinomial", dict(sample_rate=0.5, col_sample_rate_per_tree=0.75, mtries=2), 3),
]


@pytest.mark.parametrize("objective,sampling,C", SAMPLED)
def test_sampled_booster_matches_jax(objective, sampling, C):
    # the JAX booster draws its row mask at the padded row count of the
    # 8-device CPU mesh (1003 -> 1008 rows): the port draws at 1003
    rng = np.random.default_rng(C + len(sampling))
    n, F = 1003, 7
    X = rng.normal(size=(n, F)).astype(np.float32)
    if objective == "multinomial":
        y = (X[:, 0] > 0).astype(np.float64) + (X[:, 1] > 0.3)
        f0 = np.zeros(C)
    else:
        y = 2 * X[:, 0] - X[:, 1] + X[:, 2] * X[:, 3] + 0.1 * rng.normal(size=n)
        f0 = np.array([float(y.mean())])
    p = jb.TreeParams(ntrees=4, max_depth=4, nbins=16, seed=2**31 + 3, **sampling)
    jens = jb.train_boosted(X, objective, y, C, f0, p)
    with use_device("cpu"):
        pens = tb.train_boosted(X, objective, y, C, f0,
                                tb.TreeParams(**vars(p)), subtract=False)
    for jt, pt in zip(jens.trees_per_class, pens.trees_per_class):
        for f in ("feat", "split_bin", "default_left", "is_split"):
            np.testing.assert_array_equal(np.stack(getattr(jt, f)),
                                          np.stack(getattr(pt, f)), err_msg=f)
        np.testing.assert_allclose(np.stack(jt.leaf), np.stack(pt.leaf),
                                   rtol=1e-4, atol=1e-5)
    if "col_sample_rate_per_tree" in sampling:
        used = set(np.concatenate([t[s] for t, s in zip(
            pens.trees_per_class[0].feat, pens.trees_per_class[0].is_split)]).tolist())
        assert used and len(used) < F  # some features were left out


def test_predict_stacked_matches_jax():
    rng = np.random.default_rng(9)
    depth, b1, n, f, T = 3, 9, 600, 4, 5
    M = 2 ** (depth + 1) - 1
    bins = rng.integers(0, b1, size=(n, f)).astype(np.int32)
    feat = rng.integers(0, f, size=(T, M)).astype(np.int32)
    split_bin = rng.integers(0, b1 - 1, size=(T, M)).astype(np.int32)
    default_left = rng.random((T, M)) < 0.5
    is_split = rng.random((T, M)) < 0.7
    leaf = rng.normal(size=(T, M)).astype(np.float32)
    want = jb._predict_stacked(
        jnp.asarray(bins), jnp.asarray(feat), jnp.asarray(split_bin),
        jnp.asarray(default_left), jnp.asarray(is_split), jnp.asarray(leaf),
        max_depth=depth, n_bins1_arr=jnp.int32(b1))
    t = torch.from_numpy
    got = tb._predict_stacked(
        t(np.ascontiguousarray(bins.T)), t(feat), t(split_bin), t(default_left),
        t(is_split), t(leaf), max_depth=depth, n_bins1=b1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    # the fixed-target objective's gradient and hessian
    y = np.arange(12, dtype=np.float32).reshape(6, 2)
    g, h = tb.grad_hess_device("fixed", torch.from_numpy(y), torch.zeros(6, 2))
    np.testing.assert_array_equal(g.numpy(), -y)
    np.testing.assert_array_equal(h.numpy(), np.ones_like(y))

    # DRF's mtries: a [K, F] mask, one feature subset per node
    rng = np.random.default_rng(4)
    k, f, b1 = 6, 5, 11
    hist = _random_hist(rng, k, f, b1)
    mask = rng.random((k, f)) < 0.5
    mask[:, 2] = True
    mask[1] = False  # a node with no feature: no split
    want = jb._split_search(
        jnp.asarray(hist), jnp.float32(0.0), jnp.float32(0.0), jnp.float32(0.0),
        jnp.float32(1.0), jnp.asarray(mask), min_rows=1.0, n_bins1=b1,
        child_stats=True)
    got = tb._split_search(
        torch.from_numpy(hist), 0.0, 0.0, 0.0, 1.0, torch.from_numpy(mask),
        min_rows=1.0, n_bins1=b1, child_stats=True)
    for name, g_, w_ in zip(("feat", "bin", "dl"), got[:3], want[:3]):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_), err_msg=name)
    assert np.isneginf(got[3][1].item()) and np.isneginf(np.asarray(want[3])[1])
    for g_, w_ in zip(got[3:], want[3:]):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=1e-5, atol=1e-6)


class _DistX(np.ndarray):
    is_dist_hist = True


@pytest.mark.parametrize("change,item", [
    (dict(dist=True), "A10"),
])
def test_unported_parameters_raise(change, item):
    X = np.random.default_rng(0).normal(size=(50, 2)).astype(np.float32)
    if change.get("dist"):
        X = X.view(_DistX)
    kw = {k: v for k, v in change.items() if k not in ("params", "dist")}
    p = tb.TreeParams(ntrees=1, max_depth=2, nbins=8, **change.get("params", {}))
    with use_device("cpu"), pytest.raises(NotImplementedError, match=item):
        tb.train_boosted(X, "gaussian", X[:, 0], 1, np.zeros(1), p, **kw)
    # the custom objective raises too (udf.py, ROADMAP A11)
    with pytest.raises(NotImplementedError, match="A11"):
        tb.grad_hess_device("custom:mine", torch.zeros(3), torch.zeros(3, 1))


def _regression(n, F, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    X[rng.random(n) < 0.05, 3] = np.nan
    y = 2 * X[:, 0] - X[:, 1] + np.sin(3 * X[:, 2]) + 0.2 * rng.normal(size=n)
    return X, y


def _assert_ensembles_equal(jens, pens):
    for jt, pt in zip(jens.trees_per_class, pens.trees_per_class):
        assert jt.ntrees == pt.ntrees
        for f in ("feat", "split_bin", "default_left", "is_split"):
            np.testing.assert_array_equal(np.stack(getattr(jt, f)),
                                          np.stack(getattr(pt, f)), err_msg=f)
        np.testing.assert_allclose(np.stack(jt.leaf), np.stack(pt.leaf),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("subtract", [False, True])
def test_monotone_booster_matches_jax(subtract, monkeypatch):
    # the constrained features carry signal against their direction, so
    # the constraints mask splits and clip leaves; the port runs the
    # kernel dispatch (plain versions on the CPU) with the factorized limit
    monkeypatch.setenv("H2O3_TPU_TREE_SUBTRACT", "1" if subtract else "0")
    X, y = _regression(1200, 5, seed=3)
    mono = np.array([-1, 1, 1, 0, 0], np.int32)
    f0 = np.array([float(y.mean())])
    p = jb.TreeParams(ntrees=3, max_depth=3, nbins=16, learn_rate=0.5, seed=4)
    jens = jb.train_boosted(X, "gaussian", y, 1, f0, p, monotone=mono)
    with use_device("cpu"):
        pens = tb.train_boosted(X, "gaussian", y, 1, f0, tb.TreeParams(**vars(p)),
                                monotone=mono, subtract=subtract,
                                hist_impl="kernel", hist_fact_max_kc=32)
    _assert_ensembles_equal(jens, pens)
    # the margin does not rise with x0 nor fall with x1 or x2, on any row
    rows = X[:100]
    for j, c in ((0, -1), (1, 1), (2, 1)):
        sweep = np.linspace(-2.5, 2.5, 15, dtype=np.float32)
        margins = []
        for v in sweep:
            Xs = rows.copy()
            Xs[:, j] = v
            margins.append(pens.predict_margin(Xs)[:, 0])
        steps = c * np.diff(np.stack(margins), axis=0)
        assert np.all(steps >= 0), (j, steps.min())


@pytest.mark.parametrize("objective,C,sampling", [
    ("gaussian", 1, dict(sample_rate=0.7, col_sample_rate_per_tree=0.6)),
    ("multinomial", 3, dict()),
])
def test_resume_matches_jax(objective, C, sampling):
    # 2 trees, then 2 more from the checkpoint, in both packages: the
    # continued trees and the random streams keyed by absolute tree index
    X, y = _regression(1000, 5, seed=8)
    if objective == "multinomial":
        y = (X[:, 0] > 0).astype(np.float64) + (X[:, 1] > 0.3)
        f0 = np.zeros(C)
    else:
        f0 = np.array([float(y.mean())])
    p = jb.TreeParams(ntrees=2, max_depth=3, nbins=16, seed=11, **sampling)
    j1 = jb.train_boosted(X, objective, y, C, f0, p)
    j2 = jb.train_boosted(X, objective, y, C, f0, p, resume_from=j1)
    with use_device("cpu"):
        tp = tb.TreeParams(**vars(p))
        p1 = tb.train_boosted(X, objective, y, C, f0, tp, subtract=False)
        p2 = tb.train_boosted(X, objective, y, C, f0, tp, resume_from=p1,
                              subtract=False)
    assert p2.nclasses_trees == C and p2.trees_per_class[0].ntrees == 4
    _assert_ensembles_equal(j2, p2)
    np.testing.assert_array_equal(p2.trees_per_class[0].edges,
                                  p1.trees_per_class[0].edges)
    with use_device("cpu"), pytest.raises(ValueError, match="nbins"):
        tb.train_boosted(X, objective, y, C, f0, tb.TreeParams(**{**vars(p), "nbins": 8}),
                         resume_from=p1)
