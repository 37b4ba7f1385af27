"""Parity: the PyTorch port's GAM, CoxPH, PSVM and Word2Vec
(``h2o3_tpu_torch/models/``) against the JAX package, on the CPU.

Each test builds its data from ``np.random.default_rng`` in numpy, fits
the JAX builder and the port's builder on the same data, and holds:

- GAM, for every ``bs`` (cubic regression, thin-plate, I-spline,
  M-spline), a two-predictor thin-plate smoother, gaussian and binomial,
  weights, the ADMM path and the non-negative I-spline: the specs and the
  design bit for bit (host numpy in both), equal iterations, coefficients
  rtol 1e-4 / atol 1e-6 times the largest coefficient's size (at least
  1: the JAX package forms the Gram in float32, the port accumulates it
  in float64 on the same float32 design, so a small coefficient beside
  one of size 2 carries a few 1e-6 of the JAX package's rounding). A
  one-predictor thin-plate smoother (bs=1 on one column) makes a design
  of condition number about 2e4, whose float32 Gram decides the JAX
  package's coefficients only to about 0.3; against the JAX package it
  is held on its specs, design, iterations and deviance (rtol 1e-3), and
  its coefficients are held against a plain float64 numpy solve of the
  same penalized least squares (rtol 1e-6 / atol 1e-8 times the largest
  coefficient's size). The
  C POJO of a carried JAX model is the JAX package's text; the port's
  own POJO, compiled with gcc where the host has it, scores as the
  port's ``predict`` (rtol 1e-10) and as the JAX model's compiled POJO
  (rtol 1e-5);
- CoxPH with ties, for efron, breslow, left truncation and weights:
  coefficients rtol 1e-4, standard errors rtol 1e-3, log-likelihoods
  rtol 1e-5, concordance atol 1e-6, and the statistics summed in many row
  chunks equal to one chunk's within float32 rounding. Iterations are not
  compared: each package stops when two float32 log-likelihoods in a row
  are bit-equal, which past convergence is a matter of rounding (over
  eight seeds of these cases the JAX package took 4-11 iterations where
  the port took 4-8); both must stop before ``max_iterations``;
- PSVM: the ICF factor rtol 1e-10 (atol 1e-12), the dual alphas atol
  1e-5, the support sets equal where no alpha lies within 1e-5 of
  ``sv_threshold``, rho and the decision function atol 1e-4;
- Word2Vec: the vocabulary and each epoch's pairs equal, the vectors rtol
  1e-4 / atol 1e-5 after 3 epochs, the epoch losses rtol 1e-5,
  ``find_synonyms``' order and ``transform`` in both modes.

Each test also carries the JAX model across with its
``convert.*_from_numpy`` (the carried model scores as the JAX model
does), checks that the MOJO export raises the JAX package's
``ValueError``, round-trips the port's model through
``save_model``/``load_model`` with the same bits, looks the algorithm up
in ``algo_map`` and checks that the JAX package's ``ValueError``s come for
the same bad parameters.
"""

import contextlib
import ctypes
import dataclasses
import shutil
import subprocess

import numpy as np
import pytest
import torch

from h2o3_tpu import Frame as JFrame
from h2o3_tpu.frame.frame import ColType as JColType, Column as JColumn
from h2o3_tpu.keyed import DKV as JDKV
from h2o3_tpu.models import psvm as jpsvm, word2vec as jword2vec
from h2o3_tpu.models.coxph import CoxPH as JCoxPH
from h2o3_tpu.models.data_info import expand_matrix as j_expand_matrix
from h2o3_tpu.models.framework import Job as JJob
from h2o3_tpu.models.gam import GAM as JGAM
from h2o3_tpu.models.mojo_export import _payload as j_payload
from h2o3_tpu.models.pojo import pojo_source as j_pojo_source
from h2o3_tpu.models.psvm import PSVM as JPSVM
from h2o3_tpu.models.word2vec import Word2Vec as JWord2Vec
import h2o3_tpu_torch as ht
from h2o3_tpu_torch import convert
from h2o3_tpu_torch.api.registry import algo_map
from h2o3_tpu_torch.frame.frame import ColType, Column
from h2o3_tpu_torch.models import coxph as pcoxph, psvm as ppsvm, word2vec as pword2vec
from h2o3_tpu_torch.models import persist as ppersist
from h2o3_tpu_torch.models.mojo_export import _payload as p_payload
from h2o3_tpu_torch.models.pojo import pojo_source as p_pojo_source

torch.set_num_threads(1)


@contextlib.contextmanager
def _jax_keys_removed():
    before = set(JDKV.keys())
    try:
        yield
    finally:
        for k in set(JDKV.keys()) - before:
            if not isinstance(JDKV.peek(k), JJob):
                JDKV.remove(k)


def _fit_both(jbuilder, pbuilder, d, **kw):
    jm = jbuilder(**kw).train(JFrame.from_dict(d))
    pm = pbuilder(device="cpu", **kw).train(ht.Frame.from_dict(d))
    return jm, pm


def _check_errors(jbuilder, pbuilder, jframe, pframe, cases):
    for kw in cases:
        with pytest.raises(ValueError) as jerr:
            jbuilder(**kw).train(jframe)
        with pytest.raises(ValueError) as perr:
            pbuilder(device="cpu", **kw).train(pframe)
        assert str(perr.value) == str(jerr.value), kw


def _check_common(jm, pm, carried, algo, score, tmp_path):
    """The MOJO refusal of both packages, the ``algo_map`` entry and a
    save/load round trip with the same scores (``score(model)``) and bytes."""
    with pytest.raises(ValueError) as jerr:
        j_payload(jm)
    with pytest.raises(ValueError) as perr:
        p_payload(carried)
    assert str(perr.value) == str(jerr.value)
    builder, params = algo_map()[algo]
    assert builder.__module__ == f"h2o3_tpu_torch.models.{type(pm).__module__.split('.')[-1]}"
    assert builder(params()).algo_name == algo and type(pm.params) is params
    path = ppersist.save_model(pm, tmp_path / f"{algo}.bin")
    loaded = ppersist.load_model(path, register=False, device="cpu")
    assert type(loaded) is type(pm) and loaded.device == torch.device("cpu")
    for a, b in zip(score(loaded), score(pm)):
        np.testing.assert_array_equal(a, b, err_msg=algo)
    assert ppersist.dumps_model(loaded) == ppersist.dumps_model(pm), algo


def _compile(src, tmp_path, name):
    c_path, so_path = tmp_path / f"{name}.c", tmp_path / f"{name}.so"
    c_path.write_text(src)
    proc = subprocess.run(["gcc", "-O2", "-shared", "-fPIC", "-o", str(so_path),
                           str(c_path), "-lm"], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(so_path))
    lib.score.argtypes = [ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double)]
    return lib


def _pojo_scores(lib, rows, n_out=3):
    out = np.zeros((rows.shape[0], n_out))
    buf = np.zeros(n_out)
    for i in range(rows.shape[0]):
        row = np.ascontiguousarray(rows[i], dtype=np.float64)
        lib.score(row.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                  buf.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        out[i] = buf
    return out


# -- GAM -----------------------------------------------------------------------


def _gam_data(n, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 5))
    f = (np.sin(1.5 * X[:, 0]) + 0.5 * X[:, 1] ** 2 - 0.3 * X[:, 2] * X[:, 3]
         + 0.4 * np.tanh(2 * X[:, 4]))
    d = {"c": np.array(["a", "b", "c"], dtype=object)[rng.integers(0, 3, n)],
         "w": rng.uniform(0.5, 2.0, n),
         "yg": f + 0.3 * rng.normal(size=n),
         "yb": np.array(np.where(f + 0.5 * rng.normal(size=n) > 0.3, "p", "n"), dtype=object)}
    X[rng.random((n, 5)) < 0.02] = np.nan
    d.update({f"x{j}": X[:, j] for j in range(5)})
    return d


GAM_CASES = [
    dict(family="gaussian", response_column="yg", gam_columns=["x0"],
         ignored_columns=["yb", "w"]),
    dict(family="gaussian", response_column="yg", gam_columns=["x1", "x4"], bs=[3, 3],
         weights_column="w", ignored_columns=["yb"]),
    dict(family="binomial", response_column="yb", gam_columns=["x0", ["x1", "x2"], "x4"],
         bs=[0, 1, 2], num_knots=[8, 12, 8], ignored_columns=["yg", "w"]),
    dict(family="gaussian", response_column="yg", gam_columns=["x0", "x4"], bs=[0, 2],
         lambda_=0.05, alpha=0.5, ignored_columns=["yb", "w"]),
    dict(family="binomial", response_column="yb", gam_columns=["x0", "x1"], lambda_=1e-3,
         alpha=1.0, scale=[0.5, 2.0], ignored_columns=["yg", "w"]),
    # one-predictor thin-plate: held on specs, design, iterations, deviance
    dict(family="gaussian", response_column="yg", gam_columns=["x1"], bs=1,
         ignored_columns=["yb", "w"]),
]


def _gam_plain_gaussian(pm, d):
    """A gaussian GAM's coefficients by plain float64 numpy: IRLSM with the
    identity link is one penalized least-squares solve, here on the port's
    training design as the device holds it (float32 values), with the
    smoothing penalty and the 1e-10 diagonal jitter of ``_solve_ridge``."""
    fr = ht.Frame.from_dict(d)
    X = pm._design(fr)
    y = d[pm.params.response_column]
    keep = ~(np.isnan(y) | np.isnan(X).any(axis=1))
    X = np.concatenate([X[keep], np.ones((int(keep.sum()), 1))], axis=1)
    X = X.astype(np.float32).astype(np.float64)
    y = y[keep]
    pen = np.zeros((X.shape[1], X.shape[1]))
    off = len(pm.data_info.coef_names)
    for s in pm.specs:
        k = s.penalty.shape[0]
        pen[off: off + k, off: off + k] = s.penalty
        off += k
    A = (X.T @ X + pen) / len(y) + 1e-10 * np.eye(X.shape[1])
    return np.linalg.solve(A, X.T @ y / len(y))


def _specs_equal(a, b):
    assert [type(s).__name__ for s in a] == [type(s).__name__ for s in b]
    for sa, sb in zip(a, b):
        da, db = dataclasses.asdict(sa), dataclasses.asdict(sb)
        assert sorted(da) == sorted(db)
        for k in da:
            np.testing.assert_array_equal(np.asarray(db[k]), np.asarray(da[k]), err_msg=k)


def test_gam_matches_jax(tmp_path):
    d, score = _gam_data(400, seed=11), _gam_data(150, seed=12)
    with _jax_keys_removed():
        jfr, pfr = JFrame.from_dict(score), ht.Frame.from_dict(score)
        for i, kw in enumerate(GAM_CASES):
            jm, pm = _fit_both(JGAM, ht.GAM, d, **kw)
            _specs_equal(jm.specs, pm.specs)
            np.testing.assert_array_equal(pm._design(pfr), jm._design(jfr))
            assert pm.iterations == jm.iterations, kw
            assert list(pm.coefficients) == list(jm.coefficients)
            if kw.get("bs") == 1:
                np.testing.assert_allclose(pm.residual_deviance, jm.residual_deviance,
                                           rtol=1e-3)
                scale = max(1.0, float(np.abs(pm.beta).max()))
                np.testing.assert_allclose(pm.beta, _gam_plain_gaussian(pm, d), rtol=1e-6,
                                           atol=1e-8 * scale)
            else:
                scale = max(1.0, float(np.abs(jm.beta).max()))
                np.testing.assert_allclose(pm.beta, jm.beta, rtol=1e-4, atol=1e-6 * scale,
                                           err_msg=str(kw))
                np.testing.assert_allclose(
                    [pm.residual_deviance, pm.null_deviance, pm.aic],
                    [jm.residual_deviance, jm.null_deviance, jm.aic], rtol=1e-5)
                np.testing.assert_allclose(pm._predict_raw(pfr), jm._predict_raw(jfr),
                                           rtol=1e-4, atol=1e-5)
            for s in pm.specs:
                if s.kind == 2:  # the monotone block stays non-negative
                    assert s.nonneg
            carried = convert.gam_from_numpy(
                {"beta": jm.beta, "specs": [dataclasses.asdict(s) for s in jm.specs]},
                dataclasses.asdict(jm.data_info), dataclasses.asdict(jm.params),
                device="cpu")
            np.testing.assert_array_equal(carried._predict_raw(pfr), jm._predict_raw(jfr))
            assert carried.coefficients == jm.coefficients
            if all(s.kind == 0 for s in jm.specs):
                psrc = p_pojo_source(carried).replace(carried.key, jm.key)
                assert psrc == j_pojo_source(jm)
                if shutil.which("gcc") is not None:
                    _gam_pojo_scores(jm, pm, score, jfr, pfr, tmp_path, i)
            else:
                with pytest.raises(ValueError, match="cubic-regression"):
                    p_pojo_source(pm)
        _check_common(jm, pm, carried, "gam", lambda m: [m._predict_raw(pfr), m.beta],
                      tmp_path)
        with pytest.raises(ValueError, match="beta"):
            convert.gam_from_numpy(
                {"beta": jm.beta[:-1], "specs": [dataclasses.asdict(s) for s in jm.specs]},
                dataclasses.asdict(jm.data_info), dataclasses.asdict(jm.params),
                device="cpu")
        jd, pd_ = JFrame.from_dict(d), ht.Frame.from_dict(d)
        _check_errors(JGAM, ht.GAM, jd, pd_, [
            dict(response_column="yg"),
            dict(response_column="yg", gam_columns=[["x1", "x2"]], bs=0),
            dict(response_column="yg", gam_columns=[["x1", "x2"]], bs=1, knots=[[0.0, 1.0]]),
            dict(response_column="yg", gam_columns=["x0", "x1"], num_knots=[5]),
            dict(response_column="yg", gam_columns=["x0"], knots=[[0.0, 1.0]]),
            dict(response_column="yg", gam_columns=[["x1", "x2"]], bs=1, num_knots=4),
            dict(response_column="yg", gam_columns=["x0"], offset_column="x1"),
        ])


def _gam_pojo_scores(jm, pm, score, jfr, pfr, tmp_path, i):
    """The port's C POJO scores rows inside the knot range as the port's
    predict does, and as the JAX model's own POJO does."""
    ok = np.ones(len(score["x0"]), dtype=bool)
    for s in pm.specs:
        x = score[s.column]
        ok &= ~np.isnan(x) & (x >= s.knots[0]) & (x <= s.knots[-1])
    cols = [s.column for s in pm.specs]

    def rows(m, X):
        return np.concatenate([X, np.stack([score[c] for c in cols], 1)], 1)[ok]

    Xp = pm._design(pfr)[:, : len(pm.data_info.coef_names)]
    Xj, _ = j_expand_matrix(jm.data_info, jfr, dtype=np.float64)
    got = _pojo_scores(_compile(p_pojo_source(pm), tmp_path, f"gam_p{i}"), rows(pm, Xp))
    twin = _pojo_scores(_compile(j_pojo_source(jm), tmp_path, f"gam_j{i}"), rows(jm, Xj))
    want = pm._predict_raw(pfr)[ok]
    if pm.nclasses == 2:
        np.testing.assert_allclose(got[:, 1:], want, rtol=1e-10)
        np.testing.assert_allclose(got[:, 1:], twin[:, 1:], rtol=1e-5)
    else:
        np.testing.assert_allclose(got[:, 0], want, rtol=1e-10)
        np.testing.assert_allclose(got[:, 0], twin[:, 0], rtol=1e-5, atol=1e-6)


# -- CoxPH ---------------------------------------------------------------------


def _cox_data(n, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 3))
    cat = rng.integers(0, 3, n)
    eta = X @ np.array([0.8, -0.5, 0.2]) + np.array([0.0, 0.4, -0.3])[cat]
    t = rng.exponential(1.0 / np.exp(eta))
    cens = rng.exponential(2.0, size=n)
    d = {f"x{j}": X[:, j] for j in range(3)}
    d["c"] = np.array(["u", "v", "w"], dtype=object)[cat]
    d["time"] = np.round(np.minimum(t, cens), 1)  # ties
    d["event"] = (t <= cens).astype(np.float64)
    d["start"] = np.where(rng.random(n) < 0.5, rng.uniform(0, 0.3, n), 0.0)
    d["w"] = rng.uniform(0.5, 2.0, n)
    return d


COX_CASES = [
    dict(ties="efron"),
    dict(ties="breslow"),
    dict(ties="efron", start_column="start"),
    dict(ties="breslow", weights_column="w"),
    dict(ties="efron", start_column="start", weights_column="w"),
]


def test_coxph_matches_jax(tmp_path, monkeypatch):
    d, big = _cox_data(500, seed=21), _cox_data(4_500, seed=22)
    base = dict(response_column="event", stop_column="time")
    with _jax_keys_removed():
        pfr, jfr = ht.Frame.from_dict(d), JFrame.from_dict(d)
        for i, extra in enumerate(COX_CASES + [dict(ties="efron", data=big)]):
            data = extra.pop("data", d)
            kw = dict(base, ignored_columns=[c for c in ("start", "w") if c not in
                                             extra.values()], **extra)
            jm, pm = _fit_both(JCoxPH, ht.CoxPH, data, **kw)
            # both stopped by their criterion, not by max_iterations
            assert pm.iterations < pm.params.max_iterations, kw
            assert jm.iterations < jm.params.max_iterations, kw
            assert pm.n_events == jm.n_events
            assert list(pm.coefficients) == list(jm.coefficients)
            np.testing.assert_array_equal(pm.feature_means, jm.feature_means)
            np.testing.assert_allclose(pm.beta, jm.beta, rtol=1e-4, atol=1e-7, err_msg=str(kw))
            np.testing.assert_allclose(list(pm.std_errors.values()),
                                       list(jm.std_errors.values()), rtol=1e-3)
            np.testing.assert_allclose([pm.loglik, pm.loglik_null],
                                       [jm.loglik, jm.loglik_null], rtol=1e-5)
            np.testing.assert_allclose(pm.concordance, jm.concordance, atol=1e-6)
            if data is d:
                np.testing.assert_allclose(pm._predict_raw(pfr), jm._predict_raw(jfr),
                                           rtol=1e-4, atol=1e-6)
            carried = convert.coxph_from_numpy(
                {"beta": jm.beta, "feature_means": jm.feature_means},
                dataclasses.asdict(jm.data_info), dataclasses.asdict(jm.params), device="cpu")
            np.testing.assert_array_equal(carried._predict_raw(pfr), jm._predict_raw(jfr))
            assert carried.coefficients == jm.coefficients

        # many row chunks (each of a few rows; segments cut across chunks)
        # give one chunk's statistics: nothing the size of [N, P, P] is made
        for extra in COX_CASES[:3]:
            kw = dict(base, ignored_columns=["w"] + (["start"] if "start_column" not in extra
                                                     else []), **extra)
            one = ht.CoxPH(device="cpu", **kw).train(pfr)
            monkeypatch.setattr(pcoxph, "_CHUNK_BYTES", 4 * 200)
            many = ht.CoxPH(device="cpu", **kw).train(pfr)
            monkeypatch.undo()
            np.testing.assert_allclose(many.beta, one.beta, rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(many.loglik, one.loglik, rtol=1e-6)
        _check_common(jm, pm, carried, "coxph", lambda m: [m._predict_raw(pfr), m.beta],
                      tmp_path)
        with pytest.raises(ValueError, match="feature_means"):
            convert.coxph_from_numpy(
                {"beta": jm.beta, "feature_means": jm.feature_means[:2]},
                dataclasses.asdict(jm.data_info), dataclasses.asdict(jm.params), device="cpu")
        _check_errors(JCoxPH, ht.CoxPH, jfr, pfr, [
            dict(response_column="event"),
            dict(stop_column="time"),
            dict(response_column="event", stop_column="time", ties="exact"),
            dict(response_column="event", stop_column="time", offset_column="x0"),
            dict(response_column="event", stop_column="time", nfolds=1),
        ])


# -- PSVM ----------------------------------------------------------------------


def _psvm_data(n, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 3))
    c = rng.integers(0, 3, n)
    y = X[:, 0] * X[:, 1] + 0.4 * (c == 1) + 0.3 * rng.normal(size=n) > 0
    d = {f"x{j}": X[:, j] for j in range(3)}
    d["c"] = np.array(["r", "s", "t"], dtype=object)[c]
    d["y"] = np.array(np.where(y, "yes", "no"), dtype=object)
    d["y3"] = np.array(np.array(["a", "b", "c"])[c], dtype=object)
    return d


PSVM_CASES = [
    dict(),
    dict(gamma=0.5, hyper_param=2.0, positive_weight=2.0),
    dict(rank_ratio=0.2, max_iterations=100, sv_threshold=1e-3),
]


def test_psvm_matches_jax(tmp_path, monkeypatch):
    d, score = _psvm_data(300, seed=31), _psvm_data(120, seed=32)
    seen = {"icf": [], "alpha": []}

    def spy(mod, name, key, to_np):
        orig = getattr(mod, name)

        def f(*a, **k):
            out = orig(*a, **k)
            seen[key].append(to_np(out))
            return out
        monkeypatch.setattr(mod, name, f)

    spy(jpsvm, "_icf", "icf", np.asarray)
    spy(ppsvm, "_icf", "icf", lambda t: t.numpy())
    spy(jpsvm, "_solve_box_qp", "alpha", np.asarray)
    spy(ppsvm, "_solve_box_qp", "alpha", lambda t: t.numpy())
    with _jax_keys_removed():
        jfr, pfr = JFrame.from_dict(score), ht.Frame.from_dict(score)
        for kw in PSVM_CASES:
            kw = dict(response_column="y", ignored_columns=["y3"], **kw)
            seen["icf"].clear()
            seen["alpha"].clear()
            jm, pm = _fit_both(JPSVM, ht.PSVM, d, **kw)
            (jH, pH), (ja, pa) = seen["icf"], seen["alpha"]
            np.testing.assert_allclose(pH, jH, rtol=1e-10, atol=1e-12)
            np.testing.assert_allclose(pa, ja, rtol=0, atol=1e-5)
            thr = jm.params.sv_threshold
            if not np.any(np.abs(ja - thr) < 1e-5):
                np.testing.assert_array_equal(pm.support_vectors, jm.support_vectors)
                assert (pm.svs_count, pm.bounded_svs_count, pm.rank_) == (
                    jm.svs_count, jm.bounded_svs_count, jm.rank_)
                np.testing.assert_allclose(pm.alpha_y, jm.alpha_y, atol=1e-5)
            assert pm.gamma_ == jm.gamma_
            np.testing.assert_allclose(pm.rho, jm.rho, atol=1e-4)
            np.testing.assert_allclose(pm.decision_function(pfr), jm.decision_function(jfr),
                                       atol=1e-4)
            assert abs(pm.training_metrics.auc - jm.training_metrics.auc) < 1e-4
            carried = convert.psvm_from_numpy(
                {"support_vectors": jm.support_vectors, "alpha_y": jm.alpha_y,
                 "rho": jm.rho, "gamma_": jm.gamma_},
                dataclasses.asdict(jm.data_info), dataclasses.asdict(jm.params), device="cpu")
            np.testing.assert_allclose(carried._predict_raw(pfr), jm._predict_raw(jfr),
                                       rtol=1e-12, atol=1e-12)
        # scoring in row chunks of a few rows gives one chunk's scores
        whole = pm.decision_function(pfr)
        monkeypatch.setattr(ppsvm, "_SCORE_CHUNK_BYTES", 8 * 7 * pm.support_vectors.shape[0])
        np.testing.assert_allclose(pm.decision_function(pfr), whole, rtol=1e-12, atol=1e-12)
        _check_common(jm, pm, carried, "psvm", lambda m: [m._predict_raw(pfr)], tmp_path)
        with pytest.raises(ValueError, match="alpha_y"):
            convert.psvm_from_numpy(
                {"support_vectors": jm.support_vectors, "alpha_y": jm.alpha_y[1:],
                 "rho": jm.rho, "gamma_": jm.gamma_},
                dataclasses.asdict(jm.data_info), dataclasses.asdict(jm.params), device="cpu")
        _check_errors(JPSVM, ht.PSVM, JFrame.from_dict(d), ht.Frame.from_dict(d), [
            dict(response_column="y", kernel_type="linear"),
            dict(response_column="y3", ignored_columns=["y"]),
            dict(response_column="y", weights_column="x0"),
        ])


# -- Word2Vec ------------------------------------------------------------------


def _corpus(n_sent, seed, vocab=120):
    """Zipf-distributed words in two topics, NA between sentences."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab + 1) ** 1.1
    p /= p.sum()
    toks = []
    for _ in range(n_sent):
        topic = rng.integers(0, 2)
        ids = rng.choice(vocab, size=rng.integers(8, 16), p=p)
        toks += [f"{'ab'[topic]}{k}" if k % 3 else f"w{k}" for k in ids] + [None]
    return np.array(toks, dtype=object)


def test_word2vec_matches_jax(tmp_path, monkeypatch):
    toks, score = _corpus(300, seed=41), _corpus(40, seed=42)
    kw = dict(vec_size=16, window_size=3, epochs=3, min_word_freq=2, negative_samples=4,
              batch_size=256, init_learning_rate=0.5, seed=7)
    pairs = {"j": [], "p": []}

    def spy(mod, key):
        orig = mod._make_pairs

        def f(*a, **k):
            out = orig(*a, **k)
            pairs[key].append(out)
            return out
        monkeypatch.setattr(mod, "_make_pairs", f)

    spy(jword2vec, "j")
    spy(pword2vec, "p")
    with _jax_keys_removed():
        jm = JWord2Vec(**kw).train(JFrame([JColumn("words", toks, JColType.STR)]))
        pm = ht.Word2Vec(device="cpu", **kw).train(
            ht.Frame([Column("words", toks, ColType.STR)]))
        assert pm.words == jm.words and pm.vocab == jm.vocab
        assert len(pairs["p"]) == len(pairs["j"]) == kw["epochs"]
        for (jc, jx), (pc, px) in zip(pairs["j"], pairs["p"]):
            np.testing.assert_array_equal(pc, jc)
            np.testing.assert_array_equal(px, jx)
        assert pm.epochs_run == jm.epochs_run
        np.testing.assert_allclose(pm.vectors, jm.vectors, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(pm.losses, jm.losses, rtol=1e-5)
        for word in (pm.words[0], pm.words[len(pm.words) // 2]):
            assert list(pm.find_synonyms(word, 5)) == list(jm.find_synonyms(word, 5))
        assert pm.find_synonyms("never-seen") == {} and pm.word_vector("never-seen") is None
        # a categorical column of the same words
        jcat = JFrame([JColumn("words", score, JColType.STR).as_factor()])
        pcat = ht.Frame([Column("words", score, ColType.STR).as_factor()])
        for mode in ("none", "average"):
            jt, pt = jm.transform(jcat, mode), pm.transform(pcat, mode)
            assert pt.names == jt.names and pt.nrows == jt.nrows
            for c in jt.names:
                np.testing.assert_allclose(pt.col(c).data, jt.col(c).data, rtol=1e-4,
                                           atol=1e-5)
        carried = convert.word2vec_from_numpy(
            {"vectors": jm.vectors, "words": jm.words}, dataclasses.asdict(jm.data_info),
            dataclasses.asdict(jm.params), device="cpu")
        assert carried.find_synonyms(jm.words[1], 5) == jm.find_synonyms(jm.words[1], 5)
        for mode in ("none", "average"):
            jt, ct = jm.transform(jcat, mode), carried.transform(pcat, mode)
            for c in jt.names:
                np.testing.assert_array_equal(ct.col(c).data, jt.col(c).data)
        _check_common(jm, pm, carried, "word2vec",
                      lambda m: [m.vectors, m.transform(pcat, "average").col("V1").data],
                      tmp_path)
        with pytest.raises(ValueError, match="vectors"):
            convert.word2vec_from_numpy(
                {"vectors": jm.vectors[:-1], "words": jm.words},
                dataclasses.asdict(jm.data_info), dataclasses.asdict(jm.params),
                device="cpu")
        two = {"a": np.arange(4.0), "b": np.arange(4.0)}
        for jf, pf, kwe in (
                (JFrame.from_dict(two), ht.Frame.from_dict(two), {}),
                (JFrame.from_dict({"a": np.arange(4.0)}), ht.Frame.from_dict({"a": np.arange(4.0)}),
                 {}),
                (JFrame([JColumn("words", toks, JColType.STR)]),
                 ht.Frame([Column("words", toks, ColType.STR)]), dict(min_word_freq=10_000)),
                (JFrame([JColumn("words", toks, JColType.STR)]),
                 ht.Frame([Column("words", toks, ColType.STR)]), dict(weights_column="w"))):
            _check_errors(JWord2Vec, ht.Word2Vec, jf, pf, [kwe])
