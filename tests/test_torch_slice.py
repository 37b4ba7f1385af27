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
1e-6. A model with one tree set per class refuses ``predict_contributions``
with the JAX package's error. (Ensembles carried across as numpy arrays,
and the rest of the scoring surface, are held in ``test_torch_surface.py``.)

GBM and XGBoost with ``monotone_constraints``, and GBM, XGBoost and DRF
continued from a checkpoint (k trees, then k more), give the JAX package's
trees, and the checkpoint's validation errors are the JAX package's. One
case is the path ``chip_smoke.py`` drives on the card: XGBoost with monotone
constraints, subtraction and the factorized limit, then continued.

Fits in the bf16 operand mode (``hist_dtype="bf16"``) through the kernel
dispatch are held to the JAX package with its Pallas kernels in interpret
mode and ``H2O3_TPU_HIST_DTYPE=bf16``, its default on its own chip: XGBoost
(B1 levels), DRF deep enough for a sorted level (B2) and monotone XGBoost
with the factorized limit (B3), each with equal trees and predictions at the
tolerance above, and predictions apart from the same fit's in f32. An
invalid ``hist_dtype`` raises the JAX package's error.

Cross-validation: four of the fit cases also cross-validate, with
``modulo``, ``stratified`` and ``random`` folds (``nfolds=3``) and a
``fold_column``, on classifier and regression responses: the CV metrics
within 1e-6, the holdout predictions at the tolerance above and each fold
model's trees equal to the JAX package's; the ``nfolds=1`` and "both
``nfolds`` and ``fold_column``" errors are the JAX package's. A DRF
classifier cross-validates in the body of one DRF case, at depth 4 (the
same checks): the case's own depth-8 fit is not cross-validated, because on
two thirds of the rows its fold fits meet the ties of ROADMAP C2 on the
NA-bearing feature, where the two packages keep different splits of equal
gain; at depth 4 the fixture has no such tie.

Row sharding over a process group (``parallel/mesh.py``), in the body of
``test_early_stopping_matches_jax``: gloo ranks on the CPU
(``tests/torch_mesh_ranks.py``) at world sizes 2 and 3, with rows that
neither divides, fit XGBoost with ``sample_rate=0.7`` in both subtraction
modes, DRF with ``mtries``, the monotone case with
``hist_fact_max_kc=32`` (``train_boosted``) and the early-stopping GBM
(the builder, sharded because the group is live). Each is held to the
JAX package's ``train_boosted`` on the 8-device mesh and to the port with
no group: equal tree structure, leaf values and margins at rtol 1e-5 /
atol 1e-6, every rank the same bits, the same stopping tree; the merged
root histogram's counts exact and its sums at rtol 1e-5 / atol 1e-4 of
the one-device build; a grid whose wall-clock budget runs out on one
rank's clock stopping at the same cell on every rank; a repeat
``distributed_initialize`` benign, wrong arguments raising with them in
the message, and a collective that one rank never joins raising at its
group's timeout.
"""

import contextlib

import numpy as np
import pytest
import torch

from h2o3_tpu import Frame as JFrame
from h2o3_tpu.keyed import DKV as JDKV
from h2o3_tpu.models.tree import DRF as JDRF, GBM as JGBM, XGBoost as JXGBoost
from h2o3_tpu.models.tree import booster as jb
from h2o3_tpu.ops.pallas_histogram import _resolve_hist_dtype
from h2o3_tpu.models.tree.common import tree_matrix as j_tree_matrix
from h2o3_tpu.ops.histogram import apply_bins as j_apply_bins
import h2o3_tpu_torch as ht
from h2o3_tpu_torch.models.tree.common import tree_matrix as p_tree_matrix
from h2o3_tpu_torch.ops.histogram import build_histogram
from h2o3_tpu_torch.keyed import DKV as PDKV
from h2o3_tpu_torch.models.tree.common import init_margin as p_init_margin
import torch_mesh_ranks as ranks

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


#: cases that also cross-validate, and their fold assignment: classifier
#: and regression cases, each scheme once
CV_CASES = {
    ("xgboost", "gaussian", False, None): "modulo",
    ("gbm", "bernoulli", True, None): "stratified",
    ("xgboost", "multinomial", True, None): "random",
    ("gbm", "gaussian", False, "offset"): "fold_column",
}


def _assert_cv_matches_jax(jmodel, pmodel):
    """Cross-validation metrics within 1e-6, holdout predictions at rtol
    1e-4 / atol 1e-5, and each fold model's trees equal."""
    _assert_metrics_close(jmodel.cross_validation_metrics,
                          pmodel.cross_validation_metrics)
    np.testing.assert_allclose(pmodel.cv_holdout_predictions,
                               jmodel.cv_holdout_predictions, rtol=1e-4, atol=1e-5,
                               err_msg="cv holdout predictions")
    assert len(jmodel.cv_models) == len(pmodel.cv_models) == 3
    for jm, pm in zip(jmodel.cv_models, pmodel.cv_models):
        _assert_trees_equal(jm, pm)


def _cv_errors(cls, frame, **kw):
    """The messages of the CV parameter errors a builder raises."""
    out = []
    for bad in (dict(nfolds=1), dict(nfolds=2, fold_column="fold")):
        with pytest.raises(ValueError) as e:
            cls(**kw, **bad).train(frame)
        out.append(str(e.value))
    return out


@pytest.mark.parametrize("algo,dist,subtract,aux", CASES)
def test_fit_predict_score_match_jax(algo, dist, subtract, aux, monkeypatch):
    monkeypatch.setenv("H2O3_TPU_TREE_SUBTRACT", "1" if subtract else "0")
    d = _data(dist, 2500, seed=len(dist) + (7 if aux else 0))
    holdout = _data(dist, 700, seed=99)
    ignored = [c for c in ("w", "off") if not (
        (aux == "weights" and c == "w") or (aux == "offset" and c == "off"))]
    cv = CV_CASES.get((algo, dist, subtract, aux))
    cv_kw = {}
    if cv == "fold_column":
        d["fold"] = np.random.default_rng(3).integers(0, 3, 2500).astype(np.float64)
        ignored.append("fold")
        cv_kw = dict(fold_column="fold", keep_cross_validation_predictions=True)
    elif cv:
        cv_kw = dict(nfolds=3, fold_assignment=cv, keep_cross_validation_predictions=True)
    kw = dict(response_column="y", ntrees=3, max_depth=3, seed=5,
              ignored_columns=ignored, **cv_kw)
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
        for m in [jmodel] + list(getattr(jmodel, "cv_models", [])):
            JDKV.remove(m.key)

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
    if cv:
        _assert_cv_matches_jax(jmodel, pmodel)
    if cv == "fold_column":
        kw.pop("fold_column")
        with ht.use_device("cpu"):
            assert _cv_errors(pcls, pfr, **kw) == _cv_errors(jcls, jfr, **kw)
    if dist == "multinomial":
        # one tree set per class: no TreeSHAP, with the JAX package's error
        with pytest.raises(ValueError) as jerr:
            jmodel.predict_contributions(jho)
        with ht.use_device("cpu"), pytest.raises(ValueError) as perr:
            pmodel.predict_contributions(pho)
        assert str(perr.value) == str(jerr.value)
    if (algo, dist, aux) == ("drf", "bernoulli", None):
        # DRF cross-validation (ROADMAP C2's port-side check) at depth 4,
        # where the fixture has no mirror-image tie
        cv_kw = dict(kw, max_depth=4, nfolds=3, fold_assignment="modulo",
                     keep_cross_validation_predictions=True)
        jcv = jcls(**cv_kw).train(jfr)
        for m in [jcv] + jcv.cv_models:
            JDKV.remove(m.key)
        with ht.use_device("cpu"):
            pcv = pcls(tree_subtract=subtract, **cv_kw, **port_kw).train(pfr)
        _assert_trees_equal(jcv, pcv)
        _assert_cv_matches_jax(jcv, pcv)


MONO_CASES = [
    (algo, dist, subtract)
    for algo in ("xgboost", "gbm")
    for dist in ("gaussian", "bernoulli")
    for subtract in (False, True)
]


def _mono_data(dist, n, seed):
    # x0 and x1 move y against the constraints of the test, so they bind
    d = _data(dist, n, seed)
    rng = np.random.default_rng(seed + 1)
    x = np.nan_to_num(np.stack([d[f"x{j}"] for j in range(4)], 1))
    signal = 2 * x[:, 0] + 2 * np.sin(3 * x[:, 1]) - x[:, 2]
    if dist == "gaussian":
        d["y"] = signal + 0.3 * rng.normal(size=n)
    else:
        d["y"] = np.where(rng.random(n) < 1 / (1 + np.exp(-signal)), "yes", "no")
    return d


@pytest.mark.parametrize("algo,dist,subtract", MONO_CASES)
def test_monotone_fit_matches_jax(algo, dist, subtract, monkeypatch):
    monkeypatch.setenv("H2O3_TPU_TREE_SUBTRACT", "1" if subtract else "0")
    d = _mono_data(dist, 2500, seed=len(dist) + subtract)
    holdout = _mono_data(dist, 700, seed=98)
    kw = dict(response_column="y", ntrees=3, max_depth=3, seed=6,
              ignored_columns=["w", "off"],
              monotone_constraints={"x0": -1, "x1": 1, "x2": -1})
    pcls, jcls = BUILDERS[algo]
    jmodel = jcls(**kw).train(JFrame.from_dict(d))
    try:
        jpred = jmodel.predict(JFrame.from_dict(holdout))
        jperf = jmodel.model_performance(JFrame.from_dict(holdout))
    finally:
        JDKV.remove(jmodel.key)
    pho = ht.Frame.from_dict(holdout)
    with ht.use_device("cpu"):
        pmodel = pcls(tree_subtract=subtract, **kw).train(ht.Frame.from_dict(d))
        ppred = pmodel.predict(pho)
        pperf = pmodel.model_performance(pho)
    _assert_trees_equal(jmodel, pmodel)
    for name in jpred.names:
        a, b = jpred.col(name).data, ppred.col(name).data
        if jpred.col(name).domain is not None:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=name)
    _assert_metrics_close(jmodel.training_metrics, pmodel.training_metrics)
    _assert_metrics_close(jperf, pperf)
    # exact monotonicity: x0 swept up never raises a row's margin, x1 never
    # lowers it
    X = np.stack([holdout[f"x{j}"] for j in range(4)], 1)[:200].astype(np.float32)
    for j, c in ((0, -1), (1, 1)):
        margins = []
        for v in np.linspace(-3, 3, 20):
            Xs = X.copy()
            Xs[:, j] = v
            margins.append(pmodel.booster.predict_margin(Xs)[:, 0])
        assert np.all(c * np.diff(np.stack(margins), axis=0) >= 0), j


CHECKPOINT_CASES = [
    ("gbm", "gaussian", False, {}),
    ("xgboost", "bernoulli", False, dict(sample_rate=0.7)),
    ("drf", "bernoulli", True, {}),
    ("drf", "multinomial", False, {}),
    # the card's new path: monotone, subtraction, the factorized limit
    ("xgboost", "bernoulli", True, dict(
        monotone_constraints={"x2": 1, "x3": -1}, hist_fact_max_kc=32)),
]


@pytest.mark.parametrize("algo,dist,subtract,extra", CHECKPOINT_CASES)
def test_checkpoint_continue_matches_jax(algo, dist, subtract, extra, monkeypatch):
    monkeypatch.setenv("H2O3_TPU_TREE_SUBTRACT", "1" if subtract else "0")
    d = _data(dist, 2500, seed=40 + len(algo))
    extra = dict(extra)
    port_kw = {"tree_subtract": subtract}
    if "hist_fact_max_kc" in extra:
        port_kw.update(hist_impl="kernel", hist_fact_max_kc=extra.pop("hist_fact_max_kc"))
    kw = dict(response_column="y", ntrees=2, max_depth=3, seed=7,
              ignored_columns=["w", "off"], **extra)
    pcls, jcls = BUILDERS[algo]
    jfr = JFrame.from_dict(d)
    j1 = jcls(**kw).train(jfr)
    try:
        j2 = jcls(**{**kw, "ntrees": 4, "checkpoint": j1.key}).train(jfr)
        JDKV.remove(j2.key)
    finally:
        JDKV.remove(j1.key)
    pfr = ht.Frame.from_dict(d)
    with ht.use_device("cpu"):
        p1 = pcls(**kw, **port_kw).train(pfr)
        p2 = pcls(**{**kw, "ntrees": 4, "checkpoint": p1.key}, **port_kw).train(pfr)
    assert p1.ntrees_built == 2 and p2.ntrees_built == 4
    _assert_trees_equal(j2, p2)
    _assert_metrics_close(j2.training_metrics, p2.training_metrics)
    if algo == "drf":
        # a forest's trees do not see the margin: continued = one 4-tree fit
        with ht.use_device("cpu"):
            single = pcls(**{**kw, "ntrees": 4}, **port_kw).train(pfr)
        _assert_trees_equal(single, p2)


def _continue_error(pkg, prior_kw, prior_data, algo, kw, data, key=None):
    """The ValueError message of continuing a GBM (fit with ``prior_kw`` on
    ``prior_data``; or the model under ``key``) as ``algo`` with ``kw`` on
    ``data``, in the JAX package (pkg 0) or the port (pkg 1); the checkpoint
    key reads KEY."""
    frame = (JFrame, ht.Frame)[pkg].from_dict
    ctx = ht.use_device("cpu") if pkg else contextlib.nullcontext()
    side = 1 - pkg  # BUILDERS holds (port, JAX) pairs
    with ctx:
        if prior_kw is not None:
            key = BUILDERS["gbm"][side](**prior_kw).train(frame(prior_data)).key
        with pytest.raises(ValueError) as err:
            BUILDERS[algo][side](checkpoint=key, **kw).train(frame(data))
    if prior_kw is not None and pkg == 0:
        JDKV.remove(key)
    return str(err.value).replace(key, "KEY")


_BASE = dict(response_column="y", ntrees=2, max_depth=2, seed=3,
             ignored_columns=["w", "off"])
CHECKPOINT_ERRORS = {
    "ntrees_not_above": ("gbm", dict(_BASE), "bernoulli"),
    "max_depth": ("gbm", dict(_BASE, ntrees=3, max_depth=3), "bernoulli"),
    "nbins": ("gbm", dict(_BASE, ntrees=3, nbins=16), "bernoulli"),
    "algo": ("xgboost", dict(_BASE, ntrees=3, nbins=20), "bernoulli"),
    "features": ("gbm", dict(_BASE, ntrees=3, ignored_columns=["w", "off", "x3"]),
                 "bernoulli"),
    "classes": ("gbm", dict(_BASE, ntrees=3), "multinomial"),
}


@pytest.mark.parametrize("case", sorted(CHECKPOINT_ERRORS) + ["not_a_tree_model"])
def test_checkpoint_errors_match_jax(case):
    prior_data = _data("bernoulli", 300, seed=5)
    if case == "not_a_tree_model":
        JDKV.put("not_a_tree", object())
        PDKV.put("not_a_tree", object())
        try:
            msgs = [_continue_error(pkg, None, None, "gbm", dict(_BASE, ntrees=3),
                                    prior_data, key="not_a_tree") for pkg in (0, 1)]
        finally:
            JDKV.remove("not_a_tree")
            PDKV.remove("not_a_tree")
        assert msgs[0] == msgs[1] == "checkpoint model 'KEY' is not a tree model"
        return
    algo, kw, dist = CHECKPOINT_ERRORS[case]
    data = _data(dist, 300, seed=5)
    msgs = [_continue_error(pkg, _BASE, prior_data, algo, kw, data) for pkg in (0, 1)]
    assert msgs[0] == msgs[1], msgs
    want = {"ntrees_not_above": "must exceed", "max_depth": "max_depth=2",
            "nbins": "nbins=20", "algo": "cannot continue it as 'xgboost'",
            "features": "4 tree features", "classes": "class count"}[case]
    assert want in msgs[1]


def _mesh_cases():
    """``train_boosted`` cases of the sharded fits: XGBoost sampled in both
    subtraction modes, DRF with mtries, monotone with the factorized
    limit; 2,500 rows (not a multiple of 2 or 3)."""
    def xy(dist, seed):
        d = _data(dist, 2500, seed)
        X = np.stack([d[f"x{j}"] for j in range(4)], 1).astype(np.float32)
        return X, (d["y"] == "yes").astype(np.float64) if dist == "bernoulli" else d["y"]

    X, y = xy("bernoulli", 7)
    base = dict(X=X, y=y, objective="bernoulli", n_class_trees=1,
                init_margin=p_init_margin("bernoulli", y, 1))
    xgb = dict(ntrees=3, max_depth=3, nbins=256, sample_rate=0.7, seed=5)
    Xg, yg = xy("gaussian", 8)
    return {
        "xgboost": dict(base, kw=dict(params=xgb, subtract=False)),
        "xgboost_subtract": dict(base, kw=dict(params=xgb, subtract=True)),
        "drf": dict(base, X=Xg, objective="fixed", y=yg[:, None], init_margin=np.zeros(1),
                    kw=dict(params=dict(ntrees=2, max_depth=8, nbins=20, learn_rate=1.0,
                                        reg_lambda=0.0, sample_rate=0.632, mtries=1,
                                        seed=5),
                            average=True, subtract=False)),
        "monotone": dict(base, kw=dict(params=dict(ntrees=3, max_depth=3, nbins=256, seed=5),
                                       subtract=True, monotone=np.array([0, 0, 1, -1]),
                                       hist_fact_max_kc=32, hist_impl="kernel")),
    }


def _jax_boosted(case, mesh, monkeypatch):
    monkeypatch.setenv("H2O3_TPU_TREE_SUBTRACT", "1" if case["kw"]["subtract"] else "0")
    kw = case["kw"]
    return jb.train_boosted(
        case["X"], case["objective"], case["y"], case["n_class_trees"],
        case["init_margin"], jb.TreeParams(**kw["params"]), mesh=mesh,
        average=kw.get("average", False), monotone=kw.get("monotone"))


def _assert_same_fit(want, got, what):
    """Tree structure equal; leaf values and margins at rtol 1e-5 / atol 1e-6."""
    (wt, wm), (gt, gm) = want, got
    for f in ("feat", "split_bin", "default_left", "is_split"):
        for a, b in zip(wt[f], gt[f], strict=True):
            np.testing.assert_array_equal(a, b, err_msg=f"{what}: {f}")
    for a, b in zip(wt["leaf"], gt["leaf"], strict=True):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6, err_msg=f"{what}: leaf")
    np.testing.assert_allclose(gm, wm, rtol=1e-5, atol=1e-6, err_msg=f"{what}: margin")


def test_early_stopping_matches_jax(mesh, tmp_path, monkeypatch):
    # stopping_rounds scores the training margin every tree on the host
    # (ScoreKeeper.stopEarly): both packages must stop at the same tree
    d = _data("gaussian", 2000, seed=31)
    kw = dict(response_column="y", ntrees=40, max_depth=2, learn_rate=0.5,
              seed=5, ignored_columns=["w", "off"], stopping_rounds=2,
              stopping_tolerance=0.05)
    # the sharded fits run in gloo ranks at world sizes 2 and 3 meanwhile
    cases = _mesh_cases()
    runs = {}
    for w in (2, 3):
        (tmp_path / f"w{w}").mkdir()
        runs[w] = ranks.start_ranks(ranks.boost_body, w, tmp_path / f"w{w}", cases, (d, kw))
    gbm_X = np.stack([d[f"x{j}"] for j in range(4)], 1)
    jmodel = JGBM(**kw).train(JFrame.from_dict(d))
    JDKV.remove(jmodel.key)
    with ht.use_device("cpu"):
        pmodel = ht.GBM(tree_subtract=False, **kw).train(ht.Frame.from_dict(d))
    assert pmodel.ntrees_built == jmodel.ntrees_built < 40
    _assert_trees_equal(jmodel, pmodel)
    np.testing.assert_allclose(
        [h["score"] for h in pmodel.scoring_history],
        [h["score"] for h in jmodel.scoring_history], rtol=1e-5)

    # an invalid hist dtype and a checkpoint naming no model raise the JAX
    # package's errors
    with pytest.raises(ValueError) as jerr:
        _resolve_hist_dtype("f16")
    want = "hist dtype must be 'f32' or 'bf16', got 'f16'"
    assert str(jerr.value) == want
    z = torch.zeros(2, 5, dtype=torch.int32)
    for impl in ("plain", "kernel"):
        with pytest.raises(ValueError) as err:
            build_histogram(z, z[0], z[0].float(), z[0].float(), 2, 3, impl=impl,
                            dtype="f16")
        assert str(err.value) == want
    d = _data("bernoulli", 200, seed=4)
    for algo in BUILDERS:
        with ht.use_device("cpu"), pytest.raises(ValueError) as err:
            BUILDERS[algo][0](response_column="y", ntrees=1, max_depth=2,
                              ignored_columns=["w", "off"],
                              hist_dtype="f16").train(ht.Frame.from_dict(d))
        assert str(err.value) == want, algo

    # a checkpoint key that names no model: the JAX package's error
    d = _data("gaussian", 200, seed=3)
    kw = dict(response_column="y", ntrees=2, checkpoint="drf_0",
              ignored_columns=["w", "off"])
    with pytest.raises(ValueError) as jerr:
        JDRF(**kw).train(JFrame.from_dict(d))
    with ht.use_device("cpu"), pytest.raises(ValueError) as perr:
        ht.DRF(**kw).train(ht.Frame.from_dict(d))
    assert str(perr.value) == str(jerr.value) == "checkpoint model 'drf_0' not found"

    # -- row sharding (ROADMAP A12): the JAX package on its 8-device mesh,
    # the port with no group, and the port's gloo ranks at world sizes 2, 3
    want = {}
    for name, case in cases.items():
        jfit = _jax_boosted(case, mesh, monkeypatch)
        want[name] = (ranks.trees_of(jfit), jfit.predict_margin(case["X"]))
        one = ranks.fit_boosted(case)
        _assert_same_fit(want[name], (ranks.trees_of(one), one.predict_margin(case["X"])),
                         f"{name} with no group")
    root = ranks.root_histogram(cases["xgboost"])
    jtrees = ranks.trees_of(jmodel.booster)
    jpred = jmodel.booster.predict_margin(gbm_X)
    # wrong arguments raise with them in the message (a process with no group)
    msgs = ranks.init_failures(str(tmp_path))
    assert not torch.distributed.is_initialized()
    assert msgs[0].startswith("RuntimeError: torch.distributed.init_process_group(") and \
        "rank=5" in msgs[0] and "world_size=2" in msgs[0], msgs[0]
    assert msgs[1].startswith("ValueError: ") and "no_size" in msgs[1], msgs[1]
    assert msgs[2].startswith("TypeError: ") and "color='blue'" in msgs[2], msgs[2]
    for w, run in runs.items():
        out = ranks.join_ranks(run)
        assert [o["rank"] for o in out] == list(range(w)) and out[0]["size"] == w
        for name in cases:
            _assert_same_fit(want[name], out[0][name], f"{name} at world size {w}")
        for o in out[1:]:  # every rank the same bits
            for name in cases:
                for f in out[0][name][0]:
                    for a, b in zip(out[0][name][0][f], o[name][0][f]):
                        assert np.array_equal(a, b), (w, name, f)
                assert np.array_equal(out[0][name][1], o[name][1]), (w, name)
            assert np.array_equal(o["root_hist"], out[0]["root_hist"])
            assert bits_equal_tree(o["gbm"], out[0]["gbm"]), w
        for o in out:
            ntrees, trees, scores, pred = o["gbm"]
            assert ntrees == jmodel.ntrees_built, (w, ntrees)
            _assert_same_fit((jtrees, jpred), (trees, pred), f"early-stopping GBM at {w}")
            np.testing.assert_allclose(scores, [h["score"] for h in jmodel.scoring_history],
                                       rtol=1e-5)
            np.testing.assert_array_equal(o["root_hist"][..., 2], root[..., 2])
            np.testing.assert_allclose(o["root_hist"], root, rtol=1e-5, atol=1e-4)
            assert o["collectives"] > 0
            # the budget ran out on the last rank's clock: all stop together
            assert o["grid_cells"] == 1, (w, o["grid_cells"])
            assert o["dl_epochs"] == 1, (w, o["dl_epochs"])
        # the rank left out of a collective's group raised at its timeout
        elapsed, err = out[0]["timeout"]
        assert 1.5 <= elapsed < 30 and "imed out" in err, (elapsed, err)


def bits_equal_tree(a, b) -> bool:
    """Two nested results (tuples, lists, dicts, arrays) with equal bits."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(bits_equal_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(bits_equal_tree(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    return a == b


def _row_leaves(model, frame, tree_matrix):
    """Each row's leaf value in each tree [trees, N], by walking the tree
    arrays over the frame's bin codes in numpy."""
    X = tree_matrix(model.data_info, frame, encoding=model.tree_encoding)
    rows = np.arange(len(X))
    out = []
    for trees in model.booster.trees_per_class:
        bins = j_apply_bins(X, trees.edges)
        for t in range(trees.ntrees):
            feat, split_bin, default_left, is_split, leaf = (
                np.asarray(getattr(trees, f)[t]) for f in
                ("feat", "split_bin", "default_left", "is_split", "leaf"))
            idx = np.zeros(len(X), dtype=np.int64)
            for _ in range(trees.max_depth):
                b = bins[rows, feat[idx]]
                left = np.where(b >= trees.n_bins1 - 1, default_left[idx],
                                b <= split_bin[idx])
                idx = np.where(is_split[idx], 2 * idx + np.where(left, 1, 2), idx)
            out.append(leaf[idx])
    return np.stack(out)


def test_mirror_image_ties_give_the_same_leaves_and_predictions(monkeypatch):
    # ROADMAP C2: DRF on three N(0,1) features and a 4-level categorical
    # with 5% NA. Two splits of one node are mirror images (the same
    # partition, children swapped, NA on the other side); their gains are
    # equal in exact arithmetic, and the packages round them differently
    # (the JAX package sums 8 shards, the port once in float64), so they
    # pick different ones and the tree arrays differ. Every row still lands
    # on the same leaf value in every tree, and scores the same.
    monkeypatch.setenv("H2O3_TPU_TREE_SUBTRACT", "0")
    d = _data("gaussian", 1500, seed=0)
    del d["w"], d["off"]
    x3 = d["x3"]  # N(0,1) with 5% NaN: its quartiles become the levels
    levels = np.array(["a", "b", "c", "d"], dtype=object)[
        np.digitize(np.nan_to_num(x3), [-0.67, 0.0, 0.67])]
    levels[np.isnan(x3)] = None
    d["x3"] = levels
    kw = dict(response_column="y", ntrees=3, max_depth=3, seed=5)
    splits = ("feat", "split_bin", "default_left")
    jfr = JFrame.from_dict(d)
    jmodel = JDRF(**kw).train(jfr)
    try:
        jtrees = [np.stack(getattr(jmodel.booster.trees_per_class[0], f))
                  for f in splits]
        jleaves = _row_leaves(jmodel, jfr, j_tree_matrix)
        jpred = jmodel.predict(jfr).col("predict").data
    finally:
        JDKV.remove(jmodel.key)
    pfr = ht.Frame.from_dict(d)
    with ht.use_device("cpu"):
        pmodel = ht.DRF(tree_subtract=False, **kw).train(pfr)
        pleaves = _row_leaves(pmodel, pfr, p_tree_matrix)
        ppred = pmodel.predict(pfr).col("predict").data
    ptrees = [np.stack(getattr(pmodel.booster.trees_per_class[0], f)) for f in splits]
    # the fixture shows the tie (tree 1, node 5, which holds codes 2, 3 and
    # NA: bin 3 with NA right in the JAX package, bin 0 with NA left in the
    # port) ...
    assert any(not np.array_equal(a, b) for a, b in zip(jtrees, ptrees))
    # ... and no row's leaf value or prediction does
    np.testing.assert_allclose(pleaves, jleaves, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ppred, jpred, rtol=1e-4, atol=1e-5)


def test_wide_levels_at_512_bins_and_depth_8_match_jax(monkeypatch):
    # ROADMAP C1: XGBoost at nbins=512 and depth 8 builds levels of up to 64
    # nodes at 513 bins, more than one warp's [K, 3, B1] histogram held in
    # shared memory before the node-matmul kernel tiled its cells. Through
    # the kernel dispatch on CPU tensors (the kernels' plain versions); the
    # launch plan tests in test_torch_kernels.py cover the card.
    # At this depth a node holds a few rows, and splits that cut its rows
    # the same way (thresholds on either side of an empty bin, or on other
    # features) tie exactly; the packages round the equal gains differently
    # and may keep different thresholds (ROADMAP C2). That moves held-out
    # rows that fall between them, never a training row: the predictions
    # are compared on the training frame.
    monkeypatch.setenv("H2O3_TPU_TREE_SUBTRACT", "1")
    d = _data("gaussian", 1500, seed=17)
    kw = dict(response_column="y", ntrees=3, max_depth=8, nbins=512, seed=3,
              ignored_columns=["w", "off"])
    jfr = JFrame.from_dict(d)
    jmodel = JXGBoost(**kw).train(jfr)
    try:
        jpred = jmodel.predict(jfr).col("predict").data
    finally:
        JDKV.remove(jmodel.key)
    pfr = ht.Frame.from_dict(d)
    with ht.use_device("cpu"):
        pmodel = ht.XGBoost(tree_subtract=True, hist_impl="kernel", **kw).train(pfr)
        ppred = pmodel.predict(pfr).col("predict").data
    assert pmodel.booster.trees_per_class[0].n_bins1 == 513
    np.testing.assert_allclose(ppred, jpred, rtol=1e-4, atol=1e-5)


BF16_CASES = {
    # levels of up to 4 nodes, on B1
    "xgboost": ("xgboost", "bernoulli", {}),
    # the level-8 half build of 128 nodes pads to 512: the sorted kernel (B2)
    "drf": ("drf", "gaussian", dict(ntrees=2, max_depth=9)),
    # levels padded to 8 nodes with K·4 <= 32: the factorized kernel (B3)
    "monotone": ("xgboost", "gaussian", dict(
        monotone_constraints={"x0": -1, "x1": 1, "x2": -1}, hist_fact_max_kc=32)),
}


@pytest.mark.parametrize("case", sorted(BF16_CASES))
def test_bf16_fit_matches_jax_pallas_bf16(case, monkeypatch):
    algo, dist, extra = BF16_CASES[case]
    extra = dict(extra)
    fact = extra.pop("hist_fact_max_kc", 0)
    monkeypatch.setenv("H2O3_TPU_TREE_SUBTRACT", "1")
    monkeypatch.setenv("H2O3_TPU_HIST_IMPL", "pallas")
    monkeypatch.setenv("H2O3_TPU_HIST_DTYPE", "bf16")
    monkeypatch.setenv("H2O3_TPU_HIST_FACT_MAX_KC", str(fact))
    make = _mono_data if "monotone_constraints" in extra else _data
    d = make(dist, 2000, seed=60 + len(case))
    holdout = make(dist, 500, seed=97)
    kw = dict(response_column="y", ntrees=3, max_depth=3, seed=8,
              ignored_columns=["w", "off"])
    kw.update(extra)
    pcls, jcls = BUILDERS[algo]
    # the booster's compiled block reads the histogram env vars when traced
    jb._make_block_fn.cache_clear()
    try:
        jmodel = jcls(**kw).train(JFrame.from_dict(d))
        try:
            jpred = jmodel.predict(JFrame.from_dict(holdout))
        finally:
            JDKV.remove(jmodel.key)
    finally:
        jb._make_block_fn.cache_clear()
    pho = ht.Frame.from_dict(holdout)
    port_kw = dict(tree_subtract=True, hist_impl="kernel", hist_fact_max_kc=fact, **kw)
    with ht.use_device("cpu"):
        pfr = ht.Frame.from_dict(d)
        pmodel = pcls(hist_dtype="bf16", **port_kw).train(pfr)
        ppred = pmodel.predict(pho)
        f32pred = pcls(**port_kw).train(pfr).predict(pho)
    _assert_trees_equal(jmodel, pmodel)
    moved = False
    for name in jpred.names:
        a, b = jpred.col(name).data, ppred.col(name).data
        if jpred.col(name).domain is not None:
            np.testing.assert_array_equal(a, b, err_msg=name)
            continue
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=name)
        moved |= not np.allclose(f32pred.col(name).data, b, rtol=1e-4, atol=1e-5)
    assert moved, "the bf16 fit predicts what the f32 fit predicts"
