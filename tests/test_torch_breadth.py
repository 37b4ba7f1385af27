"""Parity: the PyTorch port's KMeans, PCA and SVD, GLRM, NaiveBayes,
IsolationForest and ExtendedIsolationForest (``h2o3_tpu_torch/models/``)
against the JAX package, on the CPU.

Each test builds its frames from ``np.random.default_rng`` in numpy, fits
the JAX builder and the port's builder on the same data, and holds:

- NaiveBayes: the tables, the predictions and the metrics bit for bit
  (both packages build and score in host numpy);
- KMeans on well-separated blobs, for each init and ``estimate_k``: equal
  iterations and sizes, centers rtol 1e-5 / atol 1e-6 (the Lloyd step is
  float32 on the device, summed over 8 shards there and once here);
- PCA for each ``transform``, and SVD: eigenvalues rtol 1e-5, eigenvectors
  rtol 1e-4 on the components whose eigenvalues are well separated;
- IsolationForest: equal tree arrays (host numpy on the same draws) and
  equal scores (the walk compares and gathers, and both sum the trees in
  one float32 order and scale by the reciprocal of the tree count);
- ExtendedIsolationForest at extension levels 0 and D - 1: equal tree
  arrays, ``mean_length`` rtol 1e-5;
- GLRM on every loss and regularizer at a ``max_iterations`` that neither
  package stops before: X and Y rtol 1e-4; one quadratic fit run to
  convergence: the objective and XY rtol 1e-3 and iterations within 2
  (stopping on a float32 objective can stop a step apart).

Each test also carries the JAX model across with its ``convert.*_from_numpy``
(the carried model scores as the JAX model does), holds the MOJO payload's
arrays and ``meta`` to the JAX package's (or the same ``ValueError`` where
the JAX package has no MOJO), round-trips the port's model through
``save_model``/``load_model`` with the same bits, scores its MOJO through the
port's ``genmodel``, and checks that the JAX package's ``ValueError``s come
for the same bad parameters.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from h2o3_tpu import Frame as JFrame
from h2o3_tpu.keyed import DKV as JDKV
from h2o3_tpu.models.ext_isolation_forest import ExtendedIsolationForest as JEIF
from h2o3_tpu.models.framework import Job as JJob
from h2o3_tpu.models.glrm import GLRM as JGLRM
from h2o3_tpu.models.isolation_forest import IsolationForest as JIF
from h2o3_tpu.models.kmeans import KMeans as JKMeans
from h2o3_tpu.models.mojo_export import _payload as j_payload
from h2o3_tpu.models.naive_bayes import NaiveBayes as JNB
from h2o3_tpu.models.pca import PCA as JPCA, SVD as JSVD
import h2o3_tpu_torch as ht
from h2o3_tpu_torch import convert
from h2o3_tpu_torch.genmodel import load_mojo as p_load_mojo
from h2o3_tpu_torch.models import persist as ppersist
from h2o3_tpu_torch.models.mojo_export import _payload as p_payload

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


def _check_errors(jbuilder, pbuilder, d, cases):
    for kw in cases:
        with pytest.raises(ValueError) as jerr:
            jbuilder(**kw).train(JFrame.from_dict(d))
        with pytest.raises(ValueError) as perr:
            pbuilder(device="cpu", **kw).train(ht.Frame.from_dict(d))
        assert str(perr.value) == str(jerr.value), kw


def _check_payload(jm, carried, name):
    """The carried model's MOJO payload is the JAX model's, or both raise."""
    try:
        jmeta, jarr = j_payload(jm)
    except ValueError as e:
        with pytest.raises(ValueError) as perr:
            p_payload(carried)
        assert str(perr.value) == str(e).replace("h2o3_tpu.", "h2o3_tpu_torch."), name
        return
    pmeta, parr = p_payload(carried)
    assert pmeta == jmeta, name
    assert sorted(parr) == sorted(jarr), name
    for k in jarr:
        assert parr[k].dtype == jarr[k].dtype, (name, k)
        np.testing.assert_array_equal(parr[k], jarr[k], err_msg=f"{name} {k}")


def _check_persist(pm, score, name, tmp_path):
    """save_model/load_model keep the bits: the same scores and bytes."""
    path = ppersist.save_model(pm, tmp_path / f"{name}.bin")
    loaded = ppersist.load_model(path, register=False, device="cpu")
    assert type(loaded) is type(pm) and loaded.device == torch.device("cpu")
    for a, b in zip(score(loaded), score(pm)):
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert ppersist.dumps_model(loaded) == ppersist.dumps_model(pm), name


def _check_mojo(pm, d, pfr, name, tmp_path, rtol=1e-6, atol=0.0):
    mojo = pm.download_mojo(str(tmp_path / f"{name}.zip"))
    cols = {c: d[c] for c in pm.data_info.predictor_names}
    np.testing.assert_allclose(p_load_mojo(mojo).score(cols), pm._predict_raw(pfr),
                               rtol=rtol, atol=atol, err_msg=name)


def _metric_values(m):
    out = {}
    for k, v in vars(m).items():
        if isinstance(v, (float, int, np.floating, np.integer, np.ndarray, list)):
            out[k] = np.asarray(v, dtype=object if isinstance(v, list) else None)
    if hasattr(m, "cm"):
        out["cm"] = m.cm.table
    return out


# -- NaiveBayes ----------------------------------------------------------------


def _nb_data(n, seed, unseen=False):
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, 3, n)
    x1 = rng.normal(size=n) + 0.8 * cls
    lv = np.array(["a", "b", "c", "d"] + (["zz"] if unseen else []))
    c = np.array(lv[(rng.integers(0, len(lv), n) + cls) % len(lv)], dtype=object)
    c[rng.random(n) < 0.05] = None
    x3 = np.where(cls == 2, 1.5, rng.normal(size=n))  # class 2: zero spread
    return {
        "x1": np.where(rng.random(n) < 0.05, np.nan, x1),
        "x2": 3 + 2 * rng.normal(size=n) - cls,
        "x3": x3,
        "c": c,
        "yb": np.array(np.where(cls == 0, "no", "yes"), dtype=object),
        "ym": np.array(np.array(["m0", "m1", "m2"])[cls], dtype=object),
    }


def test_naive_bayes_matches_jax(tmp_path):
    d, score = _nb_data(400, seed=1), _nb_data(150, seed=2, unseen=True)
    cases = [
        dict(response_column="yb", ignored_columns=["ym"]),
        dict(response_column="ym", ignored_columns=["yb"], laplace=1.0),
        dict(response_column="ym", ignored_columns=["yb"], laplace=0.5, min_sdev=0.2,
             eps_sdev=0.1),
    ]
    with _jax_keys_removed():
        jfr, pfr = JFrame.from_dict(score), ht.Frame.from_dict(score)
        for i, kw in enumerate(cases):
            jm, pm = _fit_both(JNB, ht.NaiveBayes, d, **kw)
            np.testing.assert_array_equal(pm.priors, jm.priors)
            for table in ("num_mean", "num_sd", "cat_probs"):
                j, p = getattr(jm, table), getattr(pm, table)
                assert sorted(p) == sorted(j), table
                for name in j:
                    np.testing.assert_array_equal(p[name], j[name], err_msg=f"{table} {name}")
            np.testing.assert_array_equal(pm._predict_raw(pfr), jm._predict_raw(jfr))
            jp, pp = jm.predict(jfr), pm.predict(pfr)
            assert pp.names == jp.names
            for col in jp.names:
                np.testing.assert_array_equal(pp.col(col).data, jp.col(col).data)
            for jmet, pmet in ((jm.training_metrics, pm.training_metrics),
                               (jm.model_performance(jfr), pm.model_performance(pfr))):
                assert type(pmet).__name__ == type(jmet).__name__
                jv, pv = _metric_values(jmet), _metric_values(pmet)
                assert sorted(pv) == sorted(jv)
                for k in jv:
                    np.testing.assert_array_equal(pv[k], jv[k], err_msg=f"{kw} {k}")

            carried = convert.naive_bayes_from_numpy(
                {"priors": jm.priors, "num_mean": jm.num_mean, "num_sd": jm.num_sd,
                 "cat_probs": jm.cat_probs},
                dataclasses.asdict(jm.data_info), dataclasses.asdict(jm.params),
                device="cpu")
            np.testing.assert_array_equal(carried._predict_raw(pfr), jm._predict_raw(jfr))
            _check_payload(jm, carried, f"nb{i}")
            _check_persist(pm, lambda m: [m._predict_raw(pfr)], f"nb{i}", tmp_path)
            _check_mojo(pm, score, pfr, f"nb{i}", tmp_path)
        with pytest.raises(ValueError, match="priors"):
            convert.naive_bayes_from_numpy(
                {"priors": jm.priors[:2], "num_mean": jm.num_mean, "num_sd": jm.num_sd,
                 "cat_probs": jm.cat_probs},
                dataclasses.asdict(jm.data_info), dataclasses.asdict(jm.params),
                device="cpu")
        _check_errors(JNB, ht.NaiveBayes, d, [
            dict(response_column="x1"),  # a numeric response
            dict(response_column="nope"),
            dict(response_column="yb", nfolds=1),
            dict(response_column="yb", weights_column="x2"),
        ])


# -- KMeans --------------------------------------------------------------------


def _blobs(n, seed, unseen=False):
    rng = np.random.default_rng(seed)
    centers = np.array([[0, 0, 0, 0], [8, 8, 0, 0], [0, 8, 8, 0], [8, 0, 8, 8]], float)
    lab = rng.integers(0, 4, n)
    X = centers[lab] + rng.normal(size=(n, 4)) * np.array([1.0, 0.8, 1.2, 0.9])
    X[rng.random((n, 4)) < 0.03] = np.nan
    lv = np.array(["u", "v", "w"] + (["zz"] if unseen else []))
    c = np.array(lv[np.where(rng.random(n) < 0.8, lab % 3, rng.integers(0, len(lv), n))],
                 dtype=object)
    d = {f"x{j}": X[:, j] for j in range(4)}
    d["c"] = c
    return d


def test_kmeans_matches_jax(tmp_path):
    d, score = _blobs(500, seed=3), _blobs(120, seed=4, unseen=True)
    cases = [
        dict(k=4, init="plus_plus", seed=1),
        dict(k=4, init="random", seed=2),
        dict(k=4, init="furthest", seed=3),
        dict(k=3, init="plus_plus", seed=4, standardize=False, max_iterations=3),
        dict(k=6, estimate_k=True, seed=5),
    ]
    with _jax_keys_removed():
        jfr, pfr = JFrame.from_dict(score), ht.Frame.from_dict(score)
        for i, kw in enumerate(cases):
            jm, pm = _fit_both(JKMeans, ht.KMeans, d, **kw)
            assert pm.iterations == jm.iterations, kw
            np.testing.assert_array_equal(pm.size, jm.size)
            for name in ("centers_std", "centers", "withinss"):
                np.testing.assert_allclose(getattr(pm, name), getattr(jm, name),
                                           rtol=1e-5, atol=1e-6, err_msg=f"{kw} {name}")
            assert pm.totss == jm.totss  # host numpy in both
            np.testing.assert_allclose([pm.tot_withinss, pm.betweenss],
                                       [jm.tot_withinss, jm.betweenss], rtol=1e-5)
            assert sorted(pm.model_performance(pfr)) == sorted(jm.model_performance(jfr))
            np.testing.assert_array_equal(pm.predict(pfr).col("predict").data,
                                          jm.predict(jfr).col("predict").data)

            carried = convert.kmeans_from_numpy(
                {"centers_std": jm.centers_std, "centers": jm.centers, "size": jm.size,
                 "withinss": jm.withinss, "totss": jm.totss},
                dataclasses.asdict(jm.data_info), dataclasses.asdict(jm.params),
                device="cpu")
            np.testing.assert_array_equal(carried._predict_raw(pfr), jm._predict_raw(jfr))
            assert carried.betweenss == jm.betweenss
            _check_payload(jm, carried, f"kmeans{i}")
            _check_persist(pm, lambda m: [m._predict_raw(pfr), m.centers_std],
                           f"kmeans{i}", tmp_path)
            _check_mojo(pm, score, pfr, f"kmeans{i}", tmp_path)
        assert pm.centers_std.shape[0] == jm.centers_std.shape[0] > 1  # estimate_k
        with pytest.raises(ValueError, match="centers"):
            convert.kmeans_from_numpy(
                {"centers_std": jm.centers_std, "centers": jm.centers[:, :2],
                 "size": jm.size, "withinss": jm.withinss},
                dataclasses.asdict(jm.data_info), dataclasses.asdict(jm.params),
                device="cpu")
        _check_errors(JKMeans, ht.KMeans, d, [
            dict(k=0), dict(k=2, nfolds=1), dict(k=2, weights_column="x0"),
            dict(k=2, checkpoint="km_0"),
        ])


# -- PCA and SVD ---------------------------------------------------------------


def _pca_data(n, seed, unseen=False):
    rng = np.random.default_rng(seed)
    Z = rng.normal(size=(n, 5)) * np.array([6.0, 3.0, 1.5, 0.7, 0.3])
    Q, _ = np.linalg.qr(np.random.default_rng(99).normal(size=(5, 5)))
    X = Z @ Q + np.array([1.0, -2.0, 0.5, 10.0, 3.0])
    X[:, 3] *= 4.0
    X[rng.random((n, 5)) < 0.02] = np.nan
    lv = np.array(["a", "b", "c"] + (["zz"] if unseen else []))
    c = np.array(lv[np.where(Z[:, 0] > 2, 0, np.where(Z[:, 1] > 1, 1, 2))], dtype=object)
    if unseen:
        c[::7] = "zz"
    d = {f"x{j}": X[:, j] for j in range(5)}
    d["c"] = c
    return d


def _separated(ev, rel_gap=0.05):
    """Components whose eigenvalue is apart from its neighbours'."""
    ev = np.asarray(ev)
    keep = []
    for i, e in enumerate(ev):
        gaps = [abs(e - ev[j]) / max(abs(e), 1e-12) for j in (i - 1, i + 1)
                if 0 <= j < len(ev)]
        if all(g > rel_gap for g in gaps) and e > 1e-6:
            keep.append(i)
    return keep


def test_pca_and_svd_match_jax(tmp_path):
    d, score = _pca_data(400, seed=5), _pca_data(100, seed=6, unseen=True)
    cases = [(JPCA, ht.PCA, dict(k=4, transform=t)) for t in
             ("none", "standardize", "demean", "descale")]
    cases += [(JPCA, ht.PCA, dict(k=5, transform="demean", use_all_factor_levels=True)),
              (JSVD, ht.SVD, dict(nv=3, transform="demean")),
              (JSVD, ht.SVD, dict(nv=2, k=3, transform="standardize"))]
    with _jax_keys_removed():
        jfr, pfr = JFrame.from_dict(score), ht.Frame.from_dict(score)
        for i, (jb, pb, kw) in enumerate(cases):
            jm, pm = _fit_both(jb, pb, d, **kw)
            assert type(pm).__name__ == type(jm).__name__
            np.testing.assert_allclose(pm.std_deviation ** 2, jm.std_deviation ** 2,
                                       rtol=1e-5, err_msg=str(kw))
            np.testing.assert_allclose(pm.pve, jm.pve, rtol=1e-5)
            np.testing.assert_allclose(pm.cum_pve, jm.cum_pve, rtol=1e-5)
            for name in ("transform_sub", "transform_mul"):
                j, p = getattr(jm, name), getattr(pm, name)
                assert (j is None) == (p is None), name
                if j is not None:
                    np.testing.assert_array_equal(p, j)  # host numpy in both
            sep = _separated(jm.std_deviation ** 2)
            assert len(sep) >= 2, jm.std_deviation
            np.testing.assert_allclose(pm.eigenvectors[:, sep], jm.eigenvectors[:, sep],
                                       rtol=1e-4, atol=1e-5, err_msg=str(kw))
            np.testing.assert_allclose(pm._predict_raw(pfr)[:, sep],
                                       jm._predict_raw(jfr)[:, sep], rtol=1e-4, atol=1e-4)
            assert pm.predict(pfr).names == jm.predict(jfr).names
            if jb is JSVD:
                np.testing.assert_allclose(pm.d, jm.d, rtol=1e-5)
                np.testing.assert_array_equal(pm.v, pm.eigenvectors)

            arrays = {k: getattr(jm, k) for k in (
                "eigenvectors", "transform_sub", "transform_mul", "std_deviation", "pve")}
            if jb is JSVD:
                arrays.update(d=jm.d, v=jm.v)
            carried = convert.pca_from_numpy(
                arrays, dataclasses.asdict(jm.data_info), dataclasses.asdict(jm.params),
                device="cpu")
            assert type(carried).__name__ == type(jm).__name__
            np.testing.assert_array_equal(carried._predict_raw(pfr), jm._predict_raw(jfr))
            np.testing.assert_array_equal(carried.cum_pve, jm.cum_pve)
            _check_payload(jm, carried, f"pca{i}")
            _check_persist(pm, lambda m: [m._predict_raw(pfr), m.eigenvectors],
                           f"pca{i}", tmp_path)
            _check_mojo(pm, score, pfr, f"pca{i}", tmp_path, atol=1e-5)
        with pytest.raises(ValueError, match="eigenvectors"):
            convert.pca_from_numpy(
                dict(arrays, eigenvectors=jm.eigenvectors[1:]),
                dataclasses.asdict(jm.data_info), dataclasses.asdict(jm.params),
                device="cpu")
        for jb, pb in ((JPCA, ht.PCA), (JSVD, ht.SVD)):
            _check_errors(jb, pb, d, [dict(nfolds=1), dict(weights_column="x0"),
                                      dict(max_runtime_secs=5.0)])


# -- IsolationForest -----------------------------------------------------------


def _iso_data(n, seed, unseen=False):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4))
    X[: n // 20] *= 6.0  # the anomalies
    X[rng.random((n, 4)) < 0.04] = np.nan
    lv = np.array(["p", "q", "r"] + (["zz"] if unseen else []))
    c = np.array(lv[rng.integers(0, len(lv), n)], dtype=object)
    c[rng.random(n) < 0.05] = None
    d = {f"x{j}": X[:, j] for j in range(4)}
    d["c"] = c
    d["const"] = np.full(n, 2.0)
    return d


def test_isolation_forest_matches_jax(tmp_path):
    d, score = _iso_data(600, seed=7), _iso_data(200, seed=8, unseen=True)
    cases = [dict(ntrees=12, seed=1), dict(ntrees=8, seed=2, mtries=2, max_depth=5),
             dict(ntrees=6, seed=3, sample_size=1000, max_depth=6)]
    with _jax_keys_removed():
        jfr, pfr = JFrame.from_dict(score), ht.Frame.from_dict(score)
        for i, kw in enumerate(cases):
            jm, pm = _fit_both(JIF, ht.IsolationForest, d, **kw)
            for a, b in zip(pm.trees, jm.trees):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            assert pm._cn == jm._cn
            np.testing.assert_array_equal(pm._predict_raw(pfr), jm._predict_raw(jfr))
            np.testing.assert_array_equal(pm.predict(pfr).col("anomaly_score").data,
                                          jm.predict(jfr).col("anomaly_score").data)
            for k in ("mean_score", "max_score"):
                np.testing.assert_allclose(pm.training_metrics[k], jm.training_metrics[k],
                                           rtol=1e-6)
            np.testing.assert_allclose([pm.min_path_total, pm.max_path_total],
                                       [jm.min_path_total, jm.max_path_total], rtol=1e-6)

            feat, thresh, is_split, path_len = jm.trees
            carried = convert.isolation_forest_from_numpy(
                {"feat": feat, "thresh": thresh, "is_split": is_split,
                 "path_len": path_len, "c_norm": jm._cn,
                 "min_path_total": jm.min_path_total, "max_path_total": jm.max_path_total},
                dataclasses.asdict(jm.data_info), dataclasses.asdict(jm.params),
                device="cpu")
            np.testing.assert_array_equal(carried._predict_raw(pfr), pm._predict_raw(pfr))
            np.testing.assert_array_equal(carried._predict_raw(pfr), jm._predict_raw(jfr))
            _check_payload(jm, carried, f"iso{i}")
            _check_persist(pm, lambda m: [m._predict_raw(pfr), *m.trees], f"iso{i}",
                           tmp_path)
            _check_mojo(pm, score, pfr, f"iso{i}", tmp_path)
        with pytest.raises(ValueError, match="path_len"):
            convert.isolation_forest_from_numpy(
                {"feat": feat, "thresh": thresh, "is_split": is_split,
                 "path_len": path_len[:, :-1], "c_norm": jm._cn},
                dataclasses.asdict(jm.data_info), dataclasses.asdict(jm.params),
                device="cpu")
        _check_errors(JIF, ht.IsolationForest, d, [
            dict(nfolds=1), dict(weights_column="x0"), dict(stopping_rounds=2)])


# -- ExtendedIsolationForest ---------------------------------------------------


def test_ext_isolation_forest_matches_jax(tmp_path):
    d, score = _iso_data(500, seed=9), _iso_data(150, seed=10, unseen=True)
    dims = 4 + 2 + 1  # x0-x3, c one-hot without its first level, const
    cases = [dict(ntrees=10, sample_size=64, extension_level=0, seed=1),
             dict(ntrees=10, sample_size=64, extension_level=dims - 1, seed=2),
             dict(ntrees=5, sample_size=1000, extension_level=2, seed=3)]
    with _jax_keys_removed():
        jfr, pfr = JFrame.from_dict(score), ht.Frame.from_dict(score)
        for i, kw in enumerate(cases):
            jm, pm = _fit_both(JEIF, ht.ExtendedIsolationForest, d, **kw)
            assert (pm.depth, pm.sample_size) == (jm.depth, jm.sample_size)
            assert pm.normals.shape[2] == dims
            for name in ("normals", "offsets", "is_split", "correction"):
                a, b = getattr(pm, name), getattr(jm, name)
                assert a.dtype == b.dtype, name
                np.testing.assert_array_equal(a, b, err_msg=name)
            jp, pp = jm.predict(jfr), pm.predict(pfr)
            assert pp.names == jp.names == ["anomaly_score", "mean_length"]
            for col in jp.names:
                np.testing.assert_allclose(pp.col(col).data, jp.col(col).data, rtol=1e-5,
                                           err_msg=f"{kw} {col}")
            np.testing.assert_allclose(pm._predict_raw(pfr), jm._predict_raw(jfr), rtol=1e-5)
            assert pm.training_metrics is jm.training_metrics is None

            arrays = {k: getattr(jm, k) for k in (
                "normals", "offsets", "is_split", "correction", "depth", "sample_size")}
            carried = convert.ext_isolation_forest_from_numpy(
                arrays, dataclasses.asdict(jm.data_info), dataclasses.asdict(jm.params),
                device="cpu")
            np.testing.assert_allclose(carried.predict(pfr).col("mean_length").data,
                                       jp.col("mean_length").data, rtol=1e-5)
            _check_payload(jm, carried, f"eif{i}")
            _check_persist(pm, lambda m: [m.predict(pfr).col("mean_length").data,
                                          m.normals], f"eif{i}", tmp_path)
        with pytest.raises(ValueError, match="normals"):
            convert.ext_isolation_forest_from_numpy(
                dict(arrays, normals=jm.normals[:, :, 1:]),
                dataclasses.asdict(jm.data_info), dataclasses.asdict(jm.params),
                device="cpu")
        _check_errors(JEIF, ht.ExtendedIsolationForest, d, [
            dict(extension_level=dims), dict(extension_level=-1), dict(nfolds=1),
            dict(ignored_columns=list(d))])


# -- GLRM ----------------------------------------------------------------------


def _glrm_data(n, seed, kind):
    rng = np.random.default_rng(seed)
    U, V = rng.normal(size=(n, 2)), rng.normal(size=(2, 5))
    if kind == "poisson":
        X = rng.poisson(np.exp(0.4 * U @ V)).astype(float)
    elif kind == "logistic":
        X = (rng.random((n, 5)) < 1 / (1 + np.exp(-(U @ V)))).astype(float)
    else:
        X = U @ V + 0.3 * rng.normal(size=(n, 5))
        if kind == "positive":
            X = np.abs(X)
    X[rng.random((n, 5)) < 0.05] = np.nan
    d = {f"x{j}": X[:, j] for j in range(5)}
    if kind == "continuous":
        level = (U[:, 0] > 0).astype(int) + (U[:, 1] > 0.5)
        c = np.array(np.array(["a", "b", "c"])[level], dtype=object)
        c[rng.random(n) < 0.05] = None
        d["c"] = c
    return d


GLRM_CASES = [
    # (data kind, parameters): every loss, every regularizer on both sides
    ("continuous", dict(loss="quadratic")),
    ("continuous", dict(loss="quadratic", regularization_x="l2", regularization_y="l2",
                        gamma_x=0.5, gamma_y=0.2, recover_svd=True)),
    ("continuous", dict(loss="quadratic", regularization_x="l1", gamma_x=0.3,
                        transform="standardize")),
    ("continuous", dict(loss="absolute")),
    ("continuous", dict(loss="huber", regularization_x="l1", regularization_y="l2",
                        gamma_x=0.2, gamma_y=0.1)),
    ("positive", dict(loss="quadratic", regularization_x="non_negative",
                      regularization_y="non_negative", init="random")),
    ("poisson", dict(loss="poisson", regularization_y="l1", gamma_y=0.05)),
    ("logistic", dict(loss="logistic")),
]


def test_glrm_matches_jax(tmp_path):
    with _jax_keys_removed():
        for i, (kind, case) in enumerate(GLRM_CASES):
            d, score = _glrm_data(150, 11 + i, kind), _glrm_data(40, 31 + i, kind)
            jfr, pfr = JFrame.from_dict(score), ht.Frame.from_dict(score)
            kw = dict(k=2, max_iterations=3, seed=7 + i, **case)
            jm, pm = _fit_both(JGLRM, ht.GLRM, d, **kw)
            # neither stops before its last iteration
            assert pm.iterations == jm.iterations == kw["max_iterations"], (kw, jm.iterations)
            for name in ("archetypes", "x_factors"):
                np.testing.assert_allclose(getattr(pm, name), getattr(jm, name),
                                           rtol=1e-4, atol=1e-5, err_msg=f"{kw} {name}")
            np.testing.assert_allclose(pm.objective, jm.objective, rtol=1e-4)
            np.testing.assert_allclose(pm.step_size, jm.step_size, rtol=1e-12)
            if kw.get("recover_svd"):
                np.testing.assert_allclose(pm.singular_vals, jm.singular_vals, rtol=1e-4)
            for what in ("reconstruct", "transform_frame"):
                jf, pf = getattr(jm, what)(jfr), getattr(pm, what)(pfr)
                assert pf.names == jf.names
                for col in jf.names:
                    np.testing.assert_allclose(pf.col(col).data, jf.col(col).data,
                                               rtol=1e-4, atol=1e-4, err_msg=f"{kw} {col}")

            carried = convert.glrm_from_numpy(
                {"archetypes": jm.archetypes, "x_factors": jm.x_factors,
                 "objective": jm.objective},
                dataclasses.asdict(jm.data_info), dataclasses.asdict(jm.params),
                device="cpu")
            np.testing.assert_allclose(carried._predict_raw(pfr), jm._predict_raw(jfr),
                                       rtol=1e-5, atol=1e-5)
            _check_payload(jm, carried, f"glrm{i}")
            _check_persist(pm, lambda m: [m._predict_raw(pfr), m.x_factors], f"glrm{i}",
                           tmp_path)

        # one fit to convergence: stopping on a float32 objective can stop
        # a step apart
        d = _glrm_data(200, 6, "positive")
        jm, pm = _fit_both(JGLRM, ht.GLRM, d, k=2, max_iterations=200, seed=1)
        assert 3 < jm.iterations < 200 and abs(pm.iterations - jm.iterations) <= 2
        np.testing.assert_allclose(pm.objective, jm.objective, rtol=1e-3)
        np.testing.assert_allclose(pm.x_factors @ pm.archetypes,
                                   jm.x_factors @ jm.archetypes, rtol=1e-3, atol=1e-3)
        with pytest.raises(ValueError, match="archetypes"):
            convert.glrm_from_numpy(
                {"archetypes": jm.archetypes[:, 1:]}, dataclasses.asdict(jm.data_info),
                dataclasses.asdict(jm.params), device="cpu")
        _check_errors(JGLRM, ht.GLRM, d, [
            dict(loss="bogus"), dict(regularization_x="bogus"),
            dict(regularization_y="l3"), dict(nfolds=1), dict(offset_column="x0")])
