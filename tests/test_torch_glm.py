"""Parity: the PyTorch port's GLM (``h2o3_tpu_torch/models/glm.py``) and its
design matrix against the JAX package, on the CPU.

Both packages fit the same ``np.random.default_rng`` frame: numerics with
NAs, a constant column (its sd is 0, as MNIST's border pixels'), a
categorical with NAs, weights, an offset and one response per family; a
scoring frame adds an unseen level and NAs. Held to the JAX package:

- ``expand_matrix`` (float32 and float64, both ``missing_values_handling``
  values, on the training and the scoring frame), ``response_vector`` and
  ``destandardize_coefs``: ``np.array_equal``;
- every family (gaussian, binomial, quasibinomial, poisson, gamma, tweedie,
  multinomial, ordinal) by IRLSM (ridge and, with ``alpha > 0``, ADMM),
  with lambda search (validation deviance), weights and offset, no
  intercept, ``skip`` rows, p-values and ``nfolds=3``: coefficients,
  lambda paths, deviances, AIC, p-values and metrics within rtol 1e-4 /
  atol 1e-6, predictions on the scoring frame too, iteration counts equal,
  and each path entry's count of nonzero coefficients equal but at
  lambda_max, where the largest coefficient sits on ADMM's soft threshold
  by construction and rounding decides whether it leaves zero (one apart
  at most);
- L-BFGS (binomial, gaussian, poisson, gamma, tweedie, multinomial and the
  ordinal family's solver) within rtol 1e-3 / atol 1e-3 and iteration
  counts within 2 (``LBFGS_TOL``), the labels and the metrics that count
  rows on either side of a cut (``CONTINUOUS`` keeps the others) left out:
  the objective and its gradient are float32 on both sides,
  summed over 8 shards there and once here, and L-BFGS-B stops where that
  float32 rounding stops its line search, so the two stop at points up to
  5e-4 apart in a coefficient (the multinomial case; the JAX package's own
  tests hold its L-BFGS to its IRLSM at atol 5e-3,
  ``tests/test_glm.py:293``);
- the JAX package's ``ValueError``s for the same inputs;
- a JAX model carried across by ``convert.glm_from_numpy`` scores within
  1e-6; the MOJO payload of the carried model equals the JAX model's, and
  so does the C POJO source; the port's own fit round-trips through
  ``save_model``/``load_model`` and scores through the port's ``genmodel``.

The tier-1 run's collected test count is held fixed (ROADMAP C4), so these
checks run in the body of ``test_grad_hess_matches_jax``, moved here from
``tests/test_torch_booster.py`` with its own check unchanged: each
booster objective's case also fits the GLMs of the family with that
objective's link and variance (``GLM_CASES``; the robust objectives huber,
laplace and quantile have no GLM family and fit none).
"""

import contextlib
import dataclasses
import zipfile

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from h2o3_tpu import Frame as JFrame
from h2o3_tpu.keyed import DKV as JDKV
from h2o3_tpu.models import data_info as jdi
from h2o3_tpu.models.framework import Job as JJob
from h2o3_tpu.models.glm import GLM as JGLM
from h2o3_tpu.models.mojo_export import _payload as j_payload
from h2o3_tpu.models.pojo import pojo_source as j_pojo_source
from h2o3_tpu.models.tree import booster as jb
import h2o3_tpu_torch as ht
from h2o3_tpu_torch.convert import glm_from_numpy
from h2o3_tpu_torch.genmodel import load_mojo as p_load_mojo
from h2o3_tpu_torch.models import data_info as pdi
from h2o3_tpu_torch.models import persist as ppersist
from h2o3_tpu_torch.models.mojo_export import _payload as p_payload
from h2o3_tpu_torch.models.pojo import pojo_source as p_pojo_source
from h2o3_tpu_torch.models.tree import booster as tb

torch.set_num_threads(1)

OBJECTIVES = [
    "gaussian", "bernoulli", "multinomial", "poisson", "gamma", "tweedie:1.5",
    "huber:0.7", "laplace", "quantile:0.3",
]

IRLSM_TOL = dict(rtol=1e-4, atol=1e-6)
LBFGS_TOL = dict(rtol=1e-3, atol=1e-3)
LBFGS_ITERS = 2

_Y = ["yg", "yb", "yp", "ygam", "yt", "ym", "yo"]


def _data(n, seed, unseen=False):
    rng = np.random.default_rng(seed)
    x1 = rng.normal(size=n)
    x2 = 3 + 2 * rng.normal(size=n)
    lv = np.array(["a", "b", "c", "d"] + (["zz"] if unseen else []))
    c = np.array(lv[rng.integers(0, len(lv), n)], dtype=object)
    c[rng.random(n) < 0.05] = None
    eta = 0.6 * x1 - 0.25 * (x2 - 3) + np.select([c == "b", c == "c"], [0.5, -0.4], 0.0)
    off = 0.1 * rng.normal(size=n)
    d = {
        "x1": np.where(rng.random(n) < 0.05, np.nan, x1),
        "x2": x2,
        "const": np.full(n, 2.5),
        "c": c,
        "w": rng.integers(1, 4, n).astype(np.float64),
        "off": off,
        "yg": eta + 0.5 * rng.normal(size=n),
        "yb": np.array(np.where(rng.random(n) < 1 / (1 + np.exp(-eta)), "yes", "no"),
                       dtype=object),
        "yp": rng.poisson(np.exp(0.5 * eta)).astype(np.float64),
        "ygam": rng.gamma(2.0, np.exp(0.3 * eta) / 2.0),
        "yt": np.where(rng.random(n) < 0.3, 0.0, rng.gamma(1.5, np.exp(0.3 * eta))),
    }
    u = eta[:, None] * np.array([1.0, -0.5, 0.0]) + rng.gumbel(size=(n, 3))
    d["ym"] = np.array(np.array(["m0", "m1", "m2"])[u.argmax(1)], dtype=object)
    z = eta + rng.logistic(size=n)
    d["yo"] = np.array(np.where(z < -0.5, "a_lo", np.where(z < 0.8, "b_mid", "c_hi")),
                       dtype=object)
    return d


def _kw(y, **kw):
    ignored = [c for c in _Y + ["w", "off"] if c != y
               and c != kw.get("weights_column") and c != kw.get("offset_column")]
    return dict(response_column=y, ignored_columns=ignored, **kw)


# (name, GLM kwargs, fit with the validation frame)
GLM_CASES = {
    "gaussian": [
        ("ridge", _kw("yg", family="gaussian", lambda_=1e-2, alpha=0.0), False),
        ("lambda_search_admm", _kw("yg", family="gaussian", lambda_search=True,
                                   nlambdas=6, alpha=0.5), True),
        ("skip_no_intercept_raw", _kw("yg", family="gaussian", intercept=False,
                                      standardize=False,
                                      missing_values_handling="skip"), False),
        ("lbfgs", _kw("yg", family="gaussian", solver="lbfgs", lambda_=1e-3,
                      alpha=0.0), False),
    ],
    "bernoulli": [
        ("weights_offset_p_values", _kw("yb", family="binomial", weights_column="w",
                                        offset_column="off", compute_p_values=True),
         False),
        ("cv3", _kw("yb", family="binomial", nfolds=3, seed=7,
                    keep_cross_validation_predictions=True), False),
        ("quasibinomial", _kw("yb", family="quasibinomial", compute_p_values=True),
         False),
        ("lbfgs", _kw("yb", family="binomial", solver="lbfgs", lambda_=1e-3,
                      alpha=0.0), False),
    ],
    "multinomial": [
        # lambda 1e-2: at 1e-3 the cyclic per-class IRLS needs 33 slow
        # iterations, which carry the float32 Gram's rounding (8 shard sums
        # there, one here) to 4e-4 of the smallest coefficient
        ("ridge", _kw("ym", family="multinomial", lambda_=1e-2, alpha=0.0), False),
        ("lambda_search", _kw("ym", family="multinomial", lambda_search=True,
                              nlambdas=4, alpha=0.5), True),
        ("lbfgs", _kw("ym", family="multinomial", solver="lbfgs", lambda_=1e-3,
                      alpha=0.0), False),
        ("ordinal", _kw("yo", family="ordinal", lambda_=1e-3, alpha=0.0), False),
    ],
    "poisson": [
        ("p_values", _kw("yp", family="poisson", compute_p_values=True), False),
        ("lbfgs", _kw("yp", family="poisson", solver="lbfgs"), False),
    ],
    "gamma": [
        ("offset", _kw("ygam", family="gamma", offset_column="off"), False),
        ("lbfgs", _kw("ygam", family="gamma", solver="lbfgs", lambda_=1e-3,
                      alpha=0.0), False),
    ],
    "tweedie:1.5": [
        ("power_1_5", _kw("yt", family="tweedie", tweedie_variance_power=1.5), False),
        ("lbfgs", _kw("yt", family="tweedie", solver="lbfgs",
                      tweedie_variance_power=1.5), False),
    ],
}


@contextlib.contextmanager
def _jax_keys_removed():
    before = set(JDKV.keys())
    try:
        yield
    finally:
        for k in set(JDKV.keys()) - before:
            if not isinstance(JDKV.peek(k), JJob):
                JDKV.remove(k)


def _is_lbfgs(kw):
    return kw.get("solver") == "lbfgs" or kw.get("family") == "ordinal"


#: the metrics that move continuously with the predictions
CONTINUOUS = ("auc", "pr_auc", "gini", "logloss", "mse", "rmse", "mae", "rmsle",
              "mean_residual_deviance", "r2", "nobs")


def _metric_values(m, continuous_only):
    return {k: np.asarray(v, dtype=np.float64) for k, v in vars(m).items()
            if isinstance(v, (float, int, np.floating, np.integer, np.ndarray))
            and (k in CONTINUOUS or not continuous_only)}


def _assert_glm_equal(jm, pm, tol, name):
    # labels, threshold tables and class errors count rows on either side of
    # a cut: held where the predictions agree to 1e-4 (IRLSM), while
    # L-BFGS's looser agreement moves rows across near ties
    continuous_only = tol is LBFGS_TOL
    assert sorted(pm.coefficients) == sorted(jm.coefficients), name
    keys = sorted(jm.coefficients)
    np.testing.assert_allclose([pm.coefficients[k] for k in keys],
                               [jm.coefficients[k] for k in keys], **tol, err_msg=name)
    for attr in ("beta_std", "beta_multi", "ordinal_thresholds"):
        a, b = getattr(jm, attr), getattr(pm, attr)
        assert (a is None) == (b is None), (name, attr)
        if a is not None:
            np.testing.assert_allclose(b, a, **tol, err_msg=f"{name} {attr}")
    for attr in ("residual_deviance", "null_deviance", "aic", "dispersion", "lambda_best"):
        a, b = getattr(jm, attr), getattr(pm, attr)
        if a is None or (isinstance(a, float) and np.isnan(a)):
            assert b is None or np.isnan(b), (name, attr)
        else:
            np.testing.assert_allclose(b, a, **tol, err_msg=f"{name} {attr}")
    for attr in ("p_values", "std_errors"):
        a, b = getattr(jm, attr), getattr(pm, attr)
        assert (a is None) == (b is None), (name, attr)
        if a is not None:
            assert sorted(a) == sorted(b)
            np.testing.assert_allclose([b[k] for k in sorted(a)], [a[k] for k in sorted(a)],
                                       **tol, err_msg=f"{name} {attr}")
    if jm.lambda_path is not None:
        assert len(pm.lambda_path) == len(jm.lambda_path)
        for i, (je, pe) in enumerate(zip(jm.lambda_path, pm.lambda_path)):
            assert sorted(je) == sorted(pe)
            # lambda_max puts the largest coefficient on the soft threshold
            # by construction: rounding decides whether it leaves zero there
            assert abs(je["nonzeros"] - pe["nonzeros"]) <= (i == 0), name
            keys = sorted(set(je) - {"nonzeros"})
            np.testing.assert_allclose([pe[k] for k in keys], [je[k] for k in keys],
                                       **tol, err_msg=f"{name} lambda path")
    else:
        assert pm.lambda_path is None
    for which in ("training_metrics", "validation_metrics", "cross_validation_metrics"):
        jmet, pmet = getattr(jm, which, None), getattr(pm, which, None)
        assert (jmet is None) == (pmet is None), (name, which)
        if jmet is not None:
            jv = _metric_values(jmet, continuous_only)
            pv = _metric_values(pmet, continuous_only)
            assert sorted(jv) == sorted(pv), (name, which)
            for k in jv:
                np.testing.assert_allclose(pv[k], jv[k], **tol, err_msg=f"{name} {which} {k}")


def _check_design_matrix(d, score):
    # the expansion, the response and the destandardization, bit for bit
    for mvh in ("mean_imputation", "skip"):
        for std in (True, False):
            jfr, pfr = JFrame.from_dict(d), ht.Frame.from_dict(d)
            args = dict(y="yb", ignored=["yg", "w", "off"], standardize=std,
                        missing_values_handling=mvh)
            jinfo = jdi.build_data_info(jfr, **args)
            pinfo = pdi.build_data_info(pfr, **args)
            assert dataclasses.asdict(pinfo) == dataclasses.asdict(jinfo)
            assert pinfo.num_sds["const"] == jinfo.num_sds["const"] == 1.0
            for frame_d in (d, score):
                for dtype in (np.float32, np.float64):
                    jX, jskip = jdi.expand_matrix(jinfo, JFrame.from_dict(frame_d), dtype)
                    pX, pskip = pdi.expand_matrix(pinfo, ht.Frame.from_dict(frame_d), dtype)
                    assert pX.dtype == jX.dtype == dtype
                    np.testing.assert_array_equal(pX, jX)
                    np.testing.assert_array_equal(pskip, jskip)
                np.testing.assert_array_equal(
                    pdi.response_vector(pinfo, ht.Frame.from_dict(frame_d)),
                    jdi.response_vector(jinfo, JFrame.from_dict(frame_d)))
            beta = np.random.default_rng(1).normal(size=len(pinfo.coef_names))
            jb_, ji = jdi.destandardize_coefs(jinfo, beta, 0.3)
            pb_, pi = pdi.destandardize_coefs(pinfo, beta, 0.3)
            np.testing.assert_array_equal(pb_, jb_)
            assert pi == ji
    # the scoring frame's unseen level is an NA: imputed, or its row skipped
    X, skip = pdi.expand_matrix(pinfo, ht.Frame.from_dict(score))
    unseen = np.array([v == "zz" for v in score["c"]])
    assert unseen.any() and skip[unseen].all()


def _check_errors(d):
    # the JAX package's ValueErrors, for the same inputs
    cases = [
        dict(family="gaussian", response_column="nope"),
        dict(family="bogus", response_column="yg"),
        dict(family="gaussian", response_column="yg", solver="newton"),
        dict(family="gaussian", response_column="yg", alpha=1.5),
        dict(family="gaussian", response_column="yg", lambda_=-1.0),
        dict(family="gaussian", response_column="yg", lambda_=0.1, compute_p_values=True),
        dict(family="multinomial", response_column="ym", compute_p_values=True),
        dict(family="gaussian", response_column="yg", solver="lbfgs", lambda_=0.1, alpha=0.5),
        dict(family="gaussian", response_column="yg", solver="lbfgs", link="log"),
        dict(family="multinomial", response_column="ym", offset_column="off"),
        dict(family="ordinal", response_column="yo", lambda_search=True),
        dict(family="ordinal", response_column="yo", solver="irlsm"),
        dict(family="ordinal", response_column="yo", lambda_=0.1, alpha=0.5),
        dict(family="gaussian", response_column="yg", lambda_search=True, nlambdas=0),
        dict(family="gaussian", response_column="yg", nfolds=1),
        dict(family="gaussian", response_column="yg", checkpoint="glm_0"),
    ]
    for kw in cases:
        with pytest.raises(ValueError) as jerr, _jax_keys_removed():
            JGLM(**kw).train(JFrame.from_dict(d))
        with ht.use_device("cpu"), pytest.raises(ValueError) as perr:
            ht.GLM(**kw).train(ht.Frame.from_dict(d))
        assert str(perr.value) == str(jerr.value), kw


def _check_carried_across_and_export(jm, pm, score, name, tmp_path):
    jfr, pfr = JFrame.from_dict(score), ht.Frame.from_dict(score)
    arrays = {k: getattr(jm, k) for k in ("beta_std", "beta_multi", "ordinal_thresholds")
              if getattr(jm, k) is not None}
    arrays["coefficients"] = jm.coefficients
    carried = glm_from_numpy(arrays, dataclasses.asdict(jm.data_info),
                             dataclasses.asdict(jm.params), device="cpu")
    np.testing.assert_allclose(carried._predict_raw(pfr), jm._predict_raw(jfr),
                               rtol=0, atol=1e-6, err_msg=name)
    jmeta, jarr = j_payload(jm)
    pmeta, parr = p_payload(carried)
    assert pmeta == jmeta, name
    assert sorted(parr) == sorted(jarr)
    for k in jarr:
        np.testing.assert_array_equal(parr[k], jarr[k], err_msg=f"{name} {k}")
    if jm.params.offset_column:
        return
    try:
        jsrc = j_pojo_source(jm)
    except ValueError as e:
        with pytest.raises(ValueError) as perr:
            p_pojo_source(carried)
        assert str(perr.value) == str(e), name
    else:
        psrc = p_pojo_source(carried).replace(carried.key, jm.key)
        assert psrc == jsrc, name
    # the port's own fit: persisted and loaded, and through its genmodel
    path = ppersist.save_model(pm, tmp_path / f"{name}.bin")
    loaded = ppersist.load_model(path, register=False, device="cpu")
    np.testing.assert_array_equal(loaded._predict_raw(pfr), pm._predict_raw(pfr))
    mojo = pm.download_mojo(str(tmp_path / f"{name}.zip"))
    with zipfile.ZipFile(mojo) as z:
        assert "arrays.npz" in z.namelist()
    cols = {c: score[c] for c in score if c not in ("yg", "yb", "yp", "ygam", "yt", "ym", "yo")}
    np.testing.assert_allclose(p_load_mojo(mojo).score(cols), pm._predict_raw(pfr),
                               rtol=1e-10, atol=1e-12, err_msg=name)


def _check_glm_family(objective, tmp_path):
    d, score = _data(400, seed=11), _data(150, seed=12, unseen=True)
    valid = _data(200, seed=13)
    if objective == "gaussian":
        _check_design_matrix(d, score)
        _check_errors(d)
    for name, kw, with_valid in GLM_CASES[objective]:
        name = f"{objective}:{name}"
        with _jax_keys_removed():
            jv = JFrame.from_dict(valid) if with_valid else None
            jm = JGLM(**kw).train(JFrame.from_dict(d), jv)
            pv = ht.Frame.from_dict(valid) if with_valid else None
            with ht.use_device("cpu"):
                pm = ht.GLM(**kw).train(ht.Frame.from_dict(d), pv)
            lbfgs = _is_lbfgs(kw)
            tol = LBFGS_TOL if lbfgs else IRLSM_TOL
            if lbfgs:
                assert abs(pm.iterations - jm.iterations) <= LBFGS_ITERS, name
            else:
                assert pm.iterations == jm.iterations, name
            _assert_glm_equal(jm, pm, tol, name)
            jp = jm.predict(JFrame.from_dict(score))
            pp = pm.predict(ht.Frame.from_dict(score))
            assert pp.names == jp.names
            for col in jp.names[int(lbfgs and pm.is_classifier):]:
                np.testing.assert_allclose(pp.col(col).numeric_view(), jp.col(col).numeric_view(),
                                           **tol, err_msg=f"{name} {col}")
            if kw.get("nfolds"):
                assert len(pm.cv_models) == len(jm.cv_models) == 3
                for jc, pc in zip(jm.cv_models, pm.cv_models):
                    _assert_glm_equal(jc, pc, tol, f"{name} fold")
                np.testing.assert_allclose(pm.cv_holdout_predictions,
                                           jm.cv_holdout_predictions, **tol)
            _check_carried_across_and_export(jm, pm, score, name.replace(":", "_"), tmp_path)


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_grad_hess_matches_jax(objective, tmp_path):
    rng = np.random.default_rng(len(objective))
    n = 500
    C = 3 if objective == "multinomial" else 1
    margin = rng.normal(size=(n, C)).astype(np.float32)
    if objective == "multinomial":
        y = rng.integers(0, C, size=n).astype(np.float32)
    elif objective == "bernoulli":
        y = rng.integers(0, 2, size=n).astype(np.float32)
    elif objective.partition(":")[0] in ("poisson", "gamma", "tweedie"):
        y = rng.gamma(2.0, size=n).astype(np.float32) + 0.01
    else:
        y = rng.normal(size=n).astype(np.float32)
    gj, hj = jb.grad_hess_device(objective, jnp.asarray(y), jnp.asarray(margin))
    gt, ht_ = tb.grad_hess_device(objective, torch.from_numpy(y), torch.from_numpy(margin))
    assert gt.shape == (n, C) and ht_.shape == (n, C)
    assert gt.dtype == torch.float32 and ht_.dtype == torch.float32
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ht_.numpy(), np.asarray(hj), rtol=1e-6, atol=1e-6)

    if objective in GLM_CASES:
        _check_glm_family(objective, tmp_path)
