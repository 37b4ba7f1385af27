"""End-to-end parity of the PyTorch port's slices: XGBoost, GBM and DRF
``train`` -> ``predict`` -> ``model_performance`` in both packages on the
same Frame data, on the CPU.

DRF always samples rows (``sample_rate`` 0.632) and features per node
(``mtries``), and XGBoost/GBM sample with ``sample_rate`` and
``col_sample_rate_per_tree``: the port draws from the JAX random streams
(``util/jrandom.py``), so the sampled fits must give the same trees. The
DRF cases are deep enough that some levels are wider than 64 padded nodes
(depth 9 with subtraction, 8 without), the levels the sorted per-node
kernel serves on the card; one of them takes the kernels' plain versions
through the kernel dispatch (``hist_impl="kernel"`` on the CPU).

Both packages run the same level flow: histogram subtraction is pinned on
the port side (``tree_subtract``) and on the JAX side
(``H2O3_TPU_TREE_SUBTRACT``). The fixtures carry strong signal on few
features, so the best split gains are well separated and tree arrays must
be equal; leaf values and predictions agree at rtol 1e-4 / atol 1e-5 (the
packages add float32 histograms in different orders) and metrics within
1e-6. Also: an ensemble trained by the JAX package, carried across as
numpy arrays (``h2o3_tpu_torch.convert.ensemble_from_numpy``), scores
held-out rows as the JAX package does.
"""

import numpy as np
import pytest
import torch

from h2o3_tpu import Frame as JFrame
from h2o3_tpu.keyed import DKV as JDKV
from h2o3_tpu.models.tree import DRF as JDRF, GBM as JGBM, XGBoost as JXGBoost
from h2o3_tpu.models.tree import booster as jb
from h2o3_tpu.models.tree.common import init_margin as j_init_margin
import h2o3_tpu_torch as ht
from h2o3_tpu_torch.convert import ensemble_from_numpy

torch.set_num_threads(1)

BUILDERS = {"xgboost": (ht.XGBoost, JXGBoost), "gbm": (ht.GBM, JGBM),
            "drf": (ht.DRF, JDRF)}


def _data(dist, n, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4))
    X[rng.random(n) < 0.05, 3] = np.nan  # exercise the NA bucket
    d = {f"x{j}": X[:, j] for j in range(4)}
    if dist == "gaussian":
        d["y"] = 3 * X[:, 0] + 2 * (X[:, 1] > 0) + X[:, 2] + 0.3 * rng.normal(size=n)
    elif dist == "bernoulli":
        logit = 3 * X[:, 0] - 2 * X[:, 1]
        d["y"] = np.where(rng.random(n) < 1 / (1 + np.exp(-logit)), "yes", "no")
    else:
        score = np.stack([2 * X[:, 0], 2 * X[:, 1], -X[:, 0] - X[:, 1]], 1)
        score += 0.3 * rng.normal(size=score.shape)
        d["y"] = np.array(["a", "b", "c"])[score.argmax(1)]
    d["w"] = rng.integers(1, 4, size=n).astype(np.float64)
    d["off"] = 0.5 * rng.normal(size=n)
    return d


def _assert_trees_equal(jmodel, pmodel):
    jtrees = jmodel.booster.trees_per_class
    ptrees = pmodel.booster.trees_per_class
    assert len(jtrees) == len(ptrees)
    for jt, pt in zip(jtrees, ptrees):
        np.testing.assert_array_equal(jt.edges, pt.edges)
        assert jt.ntrees == pt.ntrees
        for f in ("feat", "split_bin", "default_left", "is_split"):
            np.testing.assert_array_equal(
                np.stack(getattr(jt, f)), np.stack(getattr(pt, f)), err_msg=f)
        np.testing.assert_allclose(np.stack(jt.leaf), np.stack(pt.leaf),
                                   rtol=1e-4, atol=1e-5)


def _assert_metrics_close(jm, pm):
    assert type(jm).__name__ == type(pm).__name__
    for name in ("auc", "logloss", "mse", "rmse", "mae", "r2",
                 "mean_residual_deviance", "mean_per_class_error"):
        if hasattr(jm, name):
            a, b = getattr(jm, name), getattr(pm, name)
            assert abs(a - b) <= 1e-6, (name, a, b)
    assert jm.nobs == pm.nobs


CASES = [
    (algo, dist, subtract, None)
    for algo in ("xgboost", "gbm")
    for dist in ("gaussian", "bernoulli", "multinomial")
    for subtract in (False, True)
] + [
    ("xgboost", "bernoulli", True, "weights"),
    ("gbm", "gaussian", False, "offset"),
    # DRF at its defaults but for depth and trees: sample_rate 0.632, mtries
    ("drf", "gaussian", False, None),
    ("drf", "bernoulli", True, None),
    ("drf", "multinomial", True, None),
    ("drf", "bernoulli", False, "weights"),
    # GBM and XGBoost with row and per-tree column sampling
    ("gbm", "bernoulli", True, "sampled"),
    ("xgboost", "gaussian", False, "sampled"),
]


@pytest.mark.parametrize("algo,dist,subtract,aux", CASES)
def test_fit_predict_score_match_jax(algo, dist, subtract, aux, monkeypatch):
    monkeypatch.setenv("H2O3_TPU_TREE_SUBTRACT", "1" if subtract else "0")
    d = _data(dist, 2500, seed=len(dist) + (7 if aux else 0))
    holdout = _data(dist, 700, seed=99)
    ignored = [c for c in ("w", "off") if not (
        (aux == "weights" and c == "w") or (aux == "offset" and c == "off"))]
    kw = dict(response_column="y", ntrees=3, max_depth=3, seed=5,
              ignored_columns=ignored)
    if aux == "weights":
        kw["weights_column"] = "w"
    if aux == "offset":
        kw["offset_column"] = "off"
    if aux == "sampled":
        kw.update(sample_rate=0.7, col_sample_rate_per_tree=0.6)
    port_kw = {}
    if algo == "drf":
        # levels wider than 64 padded nodes: depth 9 with subtraction (the
        # level-8 half build has 128 nodes), 8 without (level 7 has 128)
        kw.update(ntrees=2, max_depth=9 if subtract else 8)
        if dist == "bernoulli" and subtract:
            port_kw["hist_impl"] = "kernel"
    pcls, jcls = BUILDERS[algo]

    jfr, jho = JFrame.from_dict(d), JFrame.from_dict(holdout)
    jmodel = jcls(**kw).train(jfr)
    try:
        jpred = jmodel.predict(jho)
        jperf = jmodel.model_performance(jho)
    finally:
        JDKV.remove(jmodel.key)

    pfr, pho = ht.Frame.from_dict(d), ht.Frame.from_dict(holdout)
    with ht.use_device("cpu"):
        pmodel = pcls(tree_subtract=subtract, **kw, **port_kw).train(pfr)
        ppred = pmodel.predict(pho)
        pperf = pmodel.model_performance(pho)

    assert pmodel.device == torch.device("cpu")
    _assert_trees_equal(jmodel, pmodel)
    assert jpred.names == ppred.names
    for name in jpred.names:
        a, b = jpred.col(name).data, ppred.col(name).data
        if jpred.col(name).domain is not None:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=name)
    _assert_metrics_close(jmodel.training_metrics, pmodel.training_metrics)
    _assert_metrics_close(jperf, pperf)


def test_ensemble_carried_across_scores_like_jax():
    rng = np.random.default_rng(21)
    n, F = 2000, 5
    X = rng.normal(size=(n, F)).astype(np.float32)
    X[rng.random((n, F)) < 0.05] = np.nan
    y = (np.nan_to_num(X[:, 0]) > 0).astype(np.float64) + (np.nan_to_num(X[:, 1]) > 0.5)
    p = jb.TreeParams(ntrees=4, max_depth=3, nbins=16, seed=2)
    f0 = j_init_margin("multinomial", y, 3)
    jens = jb.train_boosted(X, "multinomial", y, 3, f0, p)
    d = {
        "edges": jens.trees_per_class[0].edges,
        "init_margin": jens.init_margin,
        "max_depth": jens.trees_per_class[0].max_depth,
        "n_bins1": jens.trees_per_class[0].n_bins1,
        "average": jens.average,
    }
    for field in ("feat", "split_bin", "default_left", "is_split", "leaf"):
        d[field] = [np.stack(getattr(t, field)) for t in jens.trees_per_class]
    pens = ensemble_from_numpy(d, device="cpu")

    Xh = rng.normal(size=(500, F)).astype(np.float32)
    Xh[rng.random((500, F)) < 0.05] = np.nan
    np.testing.assert_allclose(pens.predict_margin(Xh), jens.predict_margin(Xh),
                               rtol=1e-5, atol=1e-6)


def test_drf_ensemble_carried_across_scores_like_jax():
    # a JAX-trained forest (averaged, fixed indicator targets, sampled)
    # through ensemble_from_numpy(average=True)
    rng = np.random.default_rng(23)
    n, F, C = 1500, 6, 3
    X = rng.normal(size=(n, F)).astype(np.float32)
    X[rng.random((n, F)) < 0.05] = np.nan
    cls = (np.nan_to_num(X[:, 0]) > 0).astype(np.int64) + (np.nan_to_num(X[:, 1]) > 0.5)
    targets = np.eye(C)[cls]
    p = jb.TreeParams(ntrees=3, max_depth=6, nbins=20, learn_rate=1.0,
                      reg_lambda=0.0, sample_rate=0.632, mtries=2, seed=9)
    jens = jb.train_boosted(X, "fixed", targets, C, np.zeros(C), p, average=True)
    d = {
        "edges": jens.trees_per_class[0].edges,
        "init_margin": jens.init_margin,
        "max_depth": p.max_depth,
        "n_bins1": p.nbins + 1,
        "average": jens.average,
    }
    for field in ("feat", "split_bin", "default_left", "is_split", "leaf"):
        d[field] = [np.stack(getattr(t, field)) for t in jens.trees_per_class]
    pens = ensemble_from_numpy(d, device="cpu")
    assert pens.average
    Xh = rng.normal(size=(400, F)).astype(np.float32)
    Xh[rng.random((400, F)) < 0.05] = np.nan
    np.testing.assert_allclose(pens.predict_margin(Xh), jens.predict_margin(Xh),
                               rtol=1e-5, atol=1e-6)


def test_drf_checkpoint_raises():
    d = _data("gaussian", 200, seed=3)
    with ht.use_device("cpu"), pytest.raises(NotImplementedError, match="A4"):
        ht.DRF(response_column="y", ntrees=1, checkpoint="drf_0").train(
            ht.Frame.from_dict(d))


def test_ensemble_from_numpy_rejects_bad_shapes():
    d = {"edges": np.zeros((2, 6)), "init_margin": np.zeros(1), "max_depth": 2,
         "n_bins1": 8, "feat": [np.zeros((1, 5))], "split_bin": [np.zeros((1, 7))],
         "default_left": [np.zeros((1, 7))], "is_split": [np.zeros((1, 7))],
         "leaf": [np.zeros((1, 7))]}
    with pytest.raises(ValueError, match="feat"):
        ensemble_from_numpy(d, device="cpu")


def test_early_stopping_matches_jax():
    # stopping_rounds scores the training margin every tree on the host
    # (ScoreKeeper.stopEarly): both packages must stop at the same tree
    d = _data("gaussian", 2000, seed=31)
    kw = dict(response_column="y", ntrees=40, max_depth=2, learn_rate=0.5,
              seed=5, ignored_columns=["w", "off"], stopping_rounds=2,
              stopping_tolerance=0.05)
    jmodel = JGBM(**kw).train(JFrame.from_dict(d))
    JDKV.remove(jmodel.key)
    with ht.use_device("cpu"):
        pmodel = ht.GBM(tree_subtract=False, **kw).train(ht.Frame.from_dict(d))
    assert pmodel.ntrees_built == jmodel.ntrees_built < 40
    _assert_trees_equal(jmodel, pmodel)
    np.testing.assert_allclose(
        [h["score"] for h in pmodel.scoring_history],
        [h["score"] for h in jmodel.scoring_history], rtol=1e-5)
