"""Parity: the PyTorch port's reference-format MOJO
(``h2o3_tpu_torch/models/mojo_ref.py``) against the JAX package's
(``h2o3_tpu/models/mojo_ref.py``), on the CPU.

For every writer (GBM binomial, multinomial and poisson, DRF binomial and
regression, GLM binomial, multinomial and gamma with a categorical, GAM
with cubic-regression smoothers, KMeans, the isolation forest, Word2Vec,
DeepLearning, the target encoder, PCA with a categorical, CoxPH and the
stacked ensemble) a model is fitted by the JAX package on numpy data made
from a seed, carried across by ``convert.*_from_numpy`` (the same arrays in
a port model, with the JAX model's key, which the stacked ensemble writes
into its members' paths) and written by both packages' ``write_mojo``:

- the archives hold the same members in the same order, each with the
  same bytes, ``model.ini`` (a sub-model's too) once its ``uuid`` line is
  masked: every writer puts a fresh ``uuid4`` there, and the zip headers
  carry the time of the call, so the zip bytes themselves are not
  compared;
- each package's ``read_mojo`` decodes the other's archive, and ``score0``
  (``gam_score0``, ``te_transform``, the word vectors) gives equal values;
- the port's own fit of the same configuration, written by the port and
  read back by the port, scores as its ``_predict_raw`` at the tolerance
  the JAX package's tests hold its own writers to (1e-8 for the GLM, 1e-6
  for GAM, CoxPH and the ensemble, 1e-4 / 1e-5 for trees, DeepLearning and
  PCA; the cluster assignment exactly).

The second test holds the refusals (offset column, ordinal GLM,
autoencoder, categorical KMeans, an unsupported algorithm, thin-plate and
standardized GAMs) to the JAX package's messages, the pipeline MOJO
(``write_pipeline_mojo``: members, decoding and scores, and its missing
alias refusal), and the Java double spelling and vocabulary escapes,
which round-trip and equal the JAX package's text.
"""

import contextlib
import dataclasses
import re
import zipfile

import numpy as np
import pytest
import torch

from h2o3_tpu import Frame as JFrame
from h2o3_tpu.frame.frame import ColType as JColType, Column as JColumn
from h2o3_tpu.keyed import DKV as JDKV
from h2o3_tpu.models import mojo_ref as jref
from h2o3_tpu.models.coxph import CoxPH as JCoxPH
from h2o3_tpu.models.deeplearning import DeepLearning as JDeepLearning
from h2o3_tpu.models.framework import Job as JJob
from h2o3_tpu.models.gam import GAM as JGAM
from h2o3_tpu.models.glm import GLM as JGLM
from h2o3_tpu.models.isolation_forest import IsolationForest as JIsolationForest
from h2o3_tpu.models.kmeans import KMeans as JKMeans
from h2o3_tpu.models.naive_bayes import NaiveBayes as JNaiveBayes
from h2o3_tpu.models.pca import PCA as JPCA
from h2o3_tpu.models.stacked_ensemble import StackedEnsemble as JStackedEnsemble
from h2o3_tpu.models.target_encoder import TargetEncoder as JTargetEncoder
from h2o3_tpu.models.tree.drf import DRF as JDRF
from h2o3_tpu.models.tree.gbm import GBM as JGBM
from h2o3_tpu.models.word2vec import Word2Vec as JWord2Vec
import h2o3_tpu_torch as ht
from h2o3_tpu_torch import convert
from h2o3_tpu_torch.frame.frame import ColType, Column
from h2o3_tpu_torch.models import mojo_ref as pref
from h2o3_tpu_torch.models.data_info import DataInfo
from h2o3_tpu_torch.models.tree.common import tree_matrix

torch.set_num_threads(1)

_UUID = re.compile(rb"^uuid = .*$", re.M)


@contextlib.contextmanager
def _jax_keys_removed():
    before = set(JDKV.keys())
    try:
        yield
    finally:
        for k in set(JDKV.keys()) - before:
            if not isinstance(JDKV.peek(k), JJob):
                JDKV.remove(k)


def _members(path):
    """(name, bytes) of every member, ``model.ini``'s uuid line masked."""
    with zipfile.ZipFile(path) as z:
        out = []
        for name in z.namelist():
            data = z.read(name)
            if name.endswith("model.ini"):
                assert len(_UUID.findall(data)) == 1, name
                data = _UUID.sub(b"uuid = -", data)
            out.append((name, data))
    return out


def _info(mojo):
    return {k: v for k, v in mojo.info.items() if k != "uuid"}


def _frames(cols):
    """The same columns as a JAX and a port Frame: (name, values, domain)."""
    jcols, pcols = [], []
    for name, v, dom in cols:
        if dom is None:
            jcols.append(JColumn(name, np.array(v, dtype=np.float64)))
            pcols.append(Column(name, np.array(v, dtype=np.float64)))
        else:
            jcols.append(JColumn(name, np.array(v, dtype=np.int32), JColType.CAT, list(dom)))
            pcols.append(Column(name, np.array(v, dtype=np.int32), ColType.CAT, list(dom)))
    return JFrame(jcols), ht.Frame(pcols)


def _params(jm, cls):
    fields = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in dataclasses.asdict(jm.params).items() if k in fields}


def _carry(jm, pm):
    """``jm`` carried across by ``convert``, under ``jm``'s key; ``pm`` is
    the port's model of the same configuration (its class and parameters)."""
    info = dataclasses.asdict(jm.data_info)
    params = _params(jm, type(pm.params))
    algo = jm.algo_name
    if algo in ("gbm", "drf"):
        ens = jm.booster
        arrays = {"edges": ens.trees_per_class[0].edges, "init_margin": ens.init_margin,
                  "max_depth": ens.trees_per_class[0].max_depth,
                  "n_bins1": ens.trees_per_class[0].n_bins1, "average": ens.average}
        for f in ("feat", "split_bin", "default_left", "is_split", "leaf"):
            arrays[f] = [np.stack(getattr(t, f)) for t in ens.trees_per_class]
        c = type(pm)(type(pm.params)(**params), DataInfo(**info), jm.distribution,
                     torch.device("cpu"))
        c.booster = convert.ensemble_from_numpy(arrays, device="cpu")
    elif algo == "glm":
        arrays = {k: getattr(jm, k) for k in ("beta_std", "beta_multi")
                  if getattr(jm, k) is not None}
        arrays["coefficients"] = jm.coefficients
        c = convert.glm_from_numpy(arrays, info, params, device="cpu")
    elif algo == "gam":
        c = convert.gam_from_numpy(
            {"beta": jm.beta, "specs": [dataclasses.asdict(s) for s in jm.specs]},
            info, params, device="cpu")
        c._threshold_override = jm.default_threshold()  # written into model.ini
    elif algo == "kmeans":
        c = convert.kmeans_from_numpy(
            {"centers_std": jm.centers_std, "centers": jm.centers, "size": jm.size,
             "withinss": jm.withinss}, info, params, device="cpu")
    elif algo == "isolationforest":
        feat, thresh, is_split, path_len = jm.trees
        c = convert.isolation_forest_from_numpy(
            {"feat": feat, "thresh": thresh, "is_split": is_split, "path_len": path_len,
             "c_norm": jm._cn, "min_path_total": jm.min_path_total,
             "max_path_total": jm.max_path_total}, info, params, device="cpu")
    elif algo == "word2vec":
        c = convert.word2vec_from_numpy({"vectors": jm.vectors, "words": jm.words},
                                        info, params, device="cpu")
    elif algo == "deeplearning":
        c = convert.deeplearning_from_numpy(
            {"net_params": jm.net_params, "opt_leaves": jm.opt_leaves,
             "epochs_trained": jm.epochs_trained}, info, params, device="cpu")
    elif algo == "targetencoder":
        c = convert.target_encoder_from_numpy(jm.encodings, jm.prior_mean, jm.fold,
                                              params, info, device="cpu")
    elif algo == "pca":
        c = convert.pca_from_numpy(
            {k: getattr(jm, k) for k in ("eigenvectors", "transform_sub", "transform_mul",
                                         "std_deviation", "pve")},
            info, params, device="cpu")
    elif algo == "coxph":
        c = convert.coxph_from_numpy({"beta": jm.beta, "feature_means": jm.feature_means},
                                     info, params, device="cpu")
    else:
        assert algo == "stackedensemble", algo
        bases = [_carry(jb, pb) for jb, pb in zip(jm.base_models, pm.base_models)]
        meta = _carry(jm.metalearner, pm.metalearner)
        params.pop("base_models", None)
        c = convert.stacked_ensemble_from_models(bases, meta, jm.levelone_names, info,
                                                 params, device="cpu")
    c.key = jm.key
    return c


def _rows_numeric(fr, names):
    return np.stack([fr.col(n).numeric_view().astype(np.float64) for n in names], axis=1)


def _cats_first(fr, model):
    info = model.data_info
    cats = [n for n in info.predictor_names if n in info.cat_domains]
    nums = [n for n in info.predictor_names if n not in info.cat_domains]
    rows = np.stack([np.where(fr.col(n).data >= 0, fr.col(n).data, np.nan).astype(np.float64)
                     for n in cats] + [fr.col(n).numeric_view() for n in nums], axis=1)
    return rows


def _tree_rows(fr, model):
    return tree_matrix(model.data_info, fr).astype(np.float64)


def _predictor_rows(fr, model):
    """Raw rows in predictor order, categoricals as level codes (PCA)."""
    info = model.data_info
    return np.stack([np.where(fr.col(n).data >= 0, fr.col(n).data, np.nan).astype(np.float64)
                     if n in info.cat_domains else fr.col(n).numeric_view()
                     for n in info.predictor_names], axis=1)


def _score(mojo, rows, kind, idx):
    """score0 of the rows ``idx`` (a dict row for GAM, the level codes for
    the target encoder, every word's vector for Word2Vec)."""
    if kind == "w2v":
        return np.stack([mojo.word_vectors[w] for w in sorted(mojo.word_vectors)])
    out = []
    for i in idx:
        if kind == "gam":
            out.append(mojo.gam_score0(rows[i]))
        elif kind == "te":
            got = mojo.te_transform(rows[i])
            out.append(np.array([got[k] for k in sorted(got)]))
        else:
            out.append(mojo.score0(rows[i]))
    return np.stack(out)


def _binomial_cols(rng, n):
    X = rng.normal(size=(n, 4))
    logit = X[:, 0] - 0.8 * X[:, 1] + 0.4 * X[:, 2] * X[:, 3]
    X[rng.random(n) < 0.06, 0] = np.nan  # NA routing bytes
    return X, logit


def _cases(rng):
    """(label, JAX builder + kwargs, port builder, JAX frame, port frame,
    row maker, score kind, native rtol, native atol) for every writer."""
    n = 400
    X, logit = _binomial_cols(rng, n)
    num = [(f"x{i}", X[:, i], None) for i in range(4)]
    yb = (logit + rng.normal(size=n) * 0.3 > 0).astype(np.int32)
    y3 = np.clip(np.digitize(logit, [-1.0, 1.0]), 0, 2).astype(np.int32)
    bin_j, bin_p = _frames(num + [("y", yb, ["n", "p"])])
    multi_j, multi_p = _frames(num + [("y", y3, ["a", "b", "c"])])
    cnt = rng.poisson(np.exp(0.3 * np.nan_to_num(X[:, 0]))).astype(np.float64)
    pois_j, pois_p = _frames(num + [("y", cnt, None)])
    reg_j, reg_p = _frames(num + [("y", logit + rng.normal(size=n) * 0.1, None)])

    g = rng.integers(0, 3, size=n).astype(np.int32)
    Xc = rng.normal(size=(n, 2))
    lc = Xc[:, 0] - Xc[:, 1] + 0.8 * (g == 2)
    x0 = Xc[:, 0].copy()
    x0[rng.random(n) < 0.05] = np.nan
    cat_base = [("g", g, ["u", "v", "w"]), ("x0", x0, None), ("x1", Xc[:, 1], None)]
    glm_bin = _frames(cat_base + [("y", (lc + rng.normal(size=n) * 0.3 > 0).astype(np.int32),
                                    ["n", "p"])])
    glm_multi = _frames(cat_base + [("y", np.clip(np.digitize(lc, [-0.7, 0.7]), 0, 2)
                                      .astype(np.int32), ["a", "b", "c"])])
    glm_gamma = _frames(cat_base + [("y", np.exp(np.clip(np.nan_to_num(x0), -2, 2)) + 0.1,
                                      None)])

    x1, x2, z = rng.normal(size=n), rng.uniform(-2, 2, size=n), rng.normal(size=n)
    fg = np.sin(1.3 * x1) + 0.4 * x2 ** 2 + 0.3 * z + 0.2 * g
    gam = _frames([("z", z, None), ("g", g, ["a", "b", "c"]), ("x1", x1, None),
                   ("x2", x2, None),
                   ("y", (fg + rng.normal(size=n) * 0.3 > 0.5).astype(np.int32), ["n", "p"])])

    Xk = np.concatenate([rng.normal(size=(n // 2, 3)) + 4.0, rng.normal(size=(n // 2, 3)) - 4.0])
    km = _frames([(f"x{i}", Xk[:, i], None) for i in range(3)])

    Xi = rng.normal(size=(n, 4)).astype(np.float32)
    Xi[:10] += 6.0
    Xi[rng.random((n, 4)) < 0.05] = np.nan
    iso = _frames([(f"x{i}", Xi[:, i], None) for i in range(4)])

    Xd = rng.normal(size=(n, 5))
    Xd[rng.random((n, 5)) < 0.05] = np.nan
    ld = np.nan_to_num(Xd[:, 0]) - 0.7 * np.nan_to_num(Xd[:, 1])
    dl = _frames([(f"x{i}", Xd[:, i], None) for i in range(5)]
                 + [("y", (ld > 0).astype(np.int32), ["n", "p"])])

    g1 = rng.integers(0, 4, n).astype(np.int32)
    g2 = rng.integers(0, 2, n).astype(np.int32)
    ty = ((g1 == 0) | (rng.random(n) < 0.3)).astype(np.int32)
    g1[rng.random(n) < 0.1] = -1
    te = _frames([("g1", g1, ["a", "b", "c", "d"]), ("g2", g2, ["x", "y"]),
                  ("y", ty, ["n", "p"])])

    Xp = rng.normal(size=(n, 3))
    pca = _frames([("x0", Xp[:, 0], None), ("g", g, ["u", "v", "w"]), ("x1", Xp[:, 1], None),
                   ("x2", Xp[:, 2], None)])

    lam = np.exp(0.8 * Xc[:, 0] - 0.5 * Xc[:, 1] + 0.4 * (g == 2))
    t_event, t_cens = rng.exponential(1.0 / lam), rng.exponential(2.0, size=n)
    cox = _frames([("g", g, ["u", "v", "w"]), ("x0", Xc[:, 0], None), ("x1", Xc[:, 1], None),
                   ("time", np.minimum(t_event, t_cens), None),
                   ("event", (t_event <= t_cens).astype(np.float64), None)])

    Xs = rng.normal(size=(n, 4))
    ls = Xs[:, 0] - 0.8 * Xs[:, 1] + 0.5 * Xs[:, 2] * Xs[:, 3]
    se = _frames([(f"x{j}", Xs[:, j], None) for j in range(4)]
                 + [("y", (rng.random(n) < 1 / (1 + np.exp(-ls))).astype(np.int32), ["0", "1"])])

    tree_kw = dict(response_column="y", ntrees=5, max_depth=3, seed=3, min_rows=2)
    gam_rows = lambda fr, m: [{"g": float(fr.col("g").data[i]),  # noqa: E731
                               **{c: float(fr.col(c).data[i]) for c in ("z", "x1", "x2")}}
                              for i in range(fr.nrows)]
    te_rows = lambda fr, m: [{c: float(fr.col(c).data[i]) if fr.col(c).data[i] >= 0  # noqa: E731
                              else float("nan") for c in ("g1", "g2")}
                             for i in range(fr.nrows)]
    return [
        ("gbm_binomial", JGBM, ht.GBM, tree_kw, bin_j, bin_p, _tree_rows, "row", 1e-4, 1e-5),
        ("gbm_multinomial", JGBM, ht.GBM, tree_kw, multi_j, multi_p, _tree_rows, "row",
         1e-4, 1e-5),
        ("gbm_poisson", JGBM, ht.GBM, dict(tree_kw, distribution="poisson"), pois_j, pois_p,
         _tree_rows, "row", 1e-4, 1e-5),
        ("drf_binomial", JDRF, ht.DRF, tree_kw, bin_j, bin_p, _tree_rows, "row", 1e-4, 1e-5),
        ("drf_regression", JDRF, ht.DRF, tree_kw, reg_j, reg_p, _tree_rows, "row", 1e-4, 1e-5),
        ("glm_binomial", JGLM, ht.GLM, dict(response_column="y", family="binomial"),
         *glm_bin, _cats_first, "row", 1e-8, 1e-10),
        ("glm_multinomial", JGLM, ht.GLM, dict(response_column="y", family="multinomial"),
         *glm_multi, _cats_first, "row", 1e-6, 1e-8),
        ("glm_gamma", JGLM, ht.GLM, dict(response_column="y", family="gamma"),
         *glm_gamma, _cats_first, "row", 1e-8, 0.0),
        ("gam_binomial", JGAM, ht.GAM,
         dict(response_column="y", gam_columns=["x1", "x2"], num_knots=8, family="binomial",
              lambda_=0.0, standardize=False), *gam, gam_rows, "gam", 1e-6, 1e-8),
        ("kmeans", JKMeans, ht.KMeans, dict(k=2, seed=7), *km,
         lambda fr, m: _rows_numeric(fr, ["x0", "x1", "x2"]), "row", 0.0, 0.0),
        ("isolation_forest", JIsolationForest, ht.IsolationForest,
         dict(ntrees=12, max_depth=6, seed=5), *iso, _tree_rows, "row", 1e-5, 1e-5),
        ("deeplearning", JDeepLearning, ht.DeepLearning,
         dict(hidden=[8, 6], epochs=3, response_column="y", seed=2, activation="tanh"), *dl,
         lambda fr, m: _rows_numeric(fr, [f"x{i}" for i in range(5)]), "row", 1e-4, 1e-5),
        ("targetencoder", JTargetEncoder, ht.TargetEncoder,
         dict(response_column="y", blending=True, noise=0.0), *te, te_rows, "te", 1e-10, 0.0),
        ("pca", JPCA, ht.PCA, dict(k=3, seed=1), *pca, _predictor_rows, "row", 1e-4, 1e-5),
        ("coxph", JCoxPH, ht.CoxPH,
         dict(response_column="event", stop_column="time", ignored_columns=["time"]), *cox,
         _cats_first, "row", 1e-6, 1e-8),
        ("stackedensemble", None, None, None, *se,
         lambda fr, m: _rows_numeric(fr, [f"x{j}" for j in range(4)]), "row", 1e-5, 1e-6),
    ]


def _fit_ensemble(jfr, pfr):
    common = dict(response_column="y", nfolds=3, keep_cross_validation_predictions=True,
                  seed=11)
    jbases = [JGLM(family="binomial", **common).train(jfr),
              JGBM(ntrees=8, max_depth=3, min_rows=2, **common).train(jfr)]
    jm = JStackedEnsemble(base_models=jbases, response_column="y", seed=11).train(jfr)
    with ht.use_device("cpu"):
        pbases = [ht.GLM(family="binomial", **common).train(pfr),
                  ht.GBM(ntrees=8, max_depth=3, min_rows=2, **common).train(pfr)]
        pm = ht.StackedEnsemble(base_models=pbases, response_column="y", seed=11).train(pfr)
    return jm, pm


def test_reference_mojo_writers_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    with _jax_keys_removed():
        for label, jb, pb, kw, jfr, pfr, rows_of, kind, rtol, atol in _cases(rng):
            if label == "stackedensemble":
                jm, pm = _fit_ensemble(jfr, pfr)
            else:
                jm = jb(**kw).train(jfr)
                pm = pb(device="cpu", **kw).train(pfr)
            carried = _carry(jm, pm)
            jpath, ppath = str(tmp_path / f"{label}_j.zip"), str(tmp_path / f"{label}_p.zip")
            jref.write_mojo(jm, jpath)
            pref.write_mojo(carried, ppath)
            assert _members(ppath) == _members(jpath), label

            rows = rows_of(pfr, pm)
            idx = range(0, pfr.nrows, 13)
            jm_p, pm_j = jref.read_mojo(ppath), pref.read_mojo(jpath)
            for a, b in ((jm_p, pm_j), (pref.read_mojo(ppath), jref.read_mojo(jpath))):
                assert _info(a) == _info(b) and a.columns == b.columns, label
                np.testing.assert_array_equal(_score(a, rows, kind, idx),
                                              _score(b, rows, kind, idx), err_msg=label)

            # the port's own fit through the port's writer and reader
            npath = str(tmp_path / f"{label}_native.zip")
            pref.write_mojo(pm, npath)
            got = _score(pref.read_mojo(npath), rows, kind, idx)
            if kind == "te":
                enc = pm.transform(pfr)
                want = np.stack([[enc.col(f"{c}_te").numeric_view()[i] for c in ("g1", "g2")]
                                 for i in idx])
            else:
                raw = pm._predict_raw(pfr)
                want = raw[list(idx)].reshape(len(got), -1)
            if label == "isolation_forest":
                # the mean path length; the MOJO's score is normalized otherwise
                got, want = got[:, 1], pm.mean_path_lengths(rows[list(idx)])
            if label == "kmeans":
                got = got.astype(int)
            np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=label)

        # Word2Vec: the vocabulary file (escapes) and the big-endian vectors
        words = ["alpha", "beta", "gamma", "del\\nta"]
        toks = [w for _ in range(200) for w in rng.choice(words, 8)]
        kw = dict(vec_size=8, window_size=2, epochs=2, min_word_freq=1, seed=3)
        jm = JWord2Vec(**kw).train(JFrame([JColumn("w", np.array(toks, dtype=object),
                                                   JColType.STR)]))
        pm = ht.Word2Vec(device="cpu", **kw).train(
            ht.Frame([Column("w", np.array(toks, dtype=object), ColType.STR)]))
        carried = _carry(jm, pm)
        jpath, ppath = str(tmp_path / "w2v_j.zip"), str(tmp_path / "w2v_p.zip")
        jref.write_mojo(jm, jpath)
        pref.write_mojo(carried, ppath)
        assert _members(ppath) == _members(jpath)
        for path in (jpath, ppath):
            a, b = jref.read_mojo(path), pref.read_mojo(path)
            assert sorted(a.word_vectors) == sorted(b.word_vectors) == sorted(words)
            np.testing.assert_array_equal(_score(a, None, "w2v", None),
                                          _score(b, None, "w2v", None))
        pref.write_mojo(pm, str(tmp_path / "w2v_native.zip"))
        back = pref.read_mojo(str(tmp_path / "w2v_native.zip"))
        for w in pm.words:  # a float32 round trip is exact
            np.testing.assert_array_equal(back.word_vectors[w],
                                          pm.word_vector(w).astype(np.float32))


def test_reference_mojo_refusals_pipeline_and_spelling(tmp_path):
    rng = np.random.default_rng(1)
    n = 300
    X, logit = _binomial_cols(rng, n)
    with _jax_keys_removed():
        # refusals: the JAX package's messages
        jfr, pfr = _frames([(f"x{i}", np.nan_to_num(X[:, i]), None) for i in range(4)]
                           + [("off", 0.1 * X[:, 1], None),
                              ("c", rng.integers(0, 3, n), ["a", "b", "c"]),
                              ("y", (logit > 0).astype(np.int32), ["n", "p"]),
                              ("o", np.clip(np.digitize(logit, [-1, 1]), 0, 2), ["l", "m", "h"]),
                              ("r", logit, None)])
        cases = [
            (JGBM, ht.GBM, dict(response_column="y", ntrees=2, max_depth=2,
                                offset_column="off", ignored_columns=["o", "r"])),
            (JGLM, ht.GLM, dict(response_column="o", family="ordinal",
                                ignored_columns=["y", "r", "off"])),
            (JDeepLearning, ht.DeepLearning, dict(hidden=[4], epochs=1, autoencoder=True,
                                                  seed=1, ignored_columns=["y", "o"])),
            (JKMeans, ht.KMeans, dict(k=2, seed=1, ignored_columns=["y", "o", "r"])),
            (JNaiveBayes, ht.NaiveBayes, dict(response_column="y",
                                              ignored_columns=["o", "r"])),
            (JGAM, ht.GAM, dict(response_column="r", gam_columns=["x1"], num_knots=8, bs=1,
                                lambda_=0.0, standardize=False,
                                ignored_columns=["y", "o", "c"])),
            (JGAM, ht.GAM, dict(response_column="r", gam_columns=["x1"], num_knots=8,
                                lambda_=0.0, standardize=True,
                                ignored_columns=["y", "o", "c"])),
        ]
        for jb, pb, kw in cases:
            jm, pm = jb(**kw).train(jfr), pb(device="cpu", **kw).train(pfr)
            with pytest.raises(ValueError) as jerr:
                jref.write_mojo(jm, str(tmp_path / "j.zip"))
            with pytest.raises(ValueError) as perr:
                pref.write_mojo(pm, str(tmp_path / "p.zip"))
            assert str(perr.value) == str(jerr.value), kw

        # the pipeline MOJO: a GLM stage feeding a GBM main model
        y_lin = 2.0 * X[:, 2] - X[:, 1] + rng.normal(size=n) * 0.1
        stage_j, stage_p = _frames([("a", X[:, 2], None), ("b", X[:, 1], None),
                                    ("ylin", y_lin, None)])
        jglm = JGLM(response_column="ylin", family="gaussian", lambda_=0.0).train(stage_j)
        pglm = ht.GLM(response_column="ylin", family="gaussian", lambda_=0.0,
                      device="cpu").train(stage_p)
        glm_pred = jglm.predict(stage_j).col(0).numeric_view()
        yb = (y_lin + 0.5 * X[:, 3] > 0).astype(np.int32)
        main_j, main_p = _frames([("c", X[:, 3], None), ("glm_pred", glm_pred, None),
                                  ("y", yb, ["n", "p"])])
        kw = dict(ntrees=5, max_depth=3, response_column="y", seed=3, min_rows=2)
        jgbm, pgbm = JGBM(**kw).train(main_j), ht.GBM(device="cpu", **kw).train(main_p)
        carried = {"glm_stage": _carry(jglm, pglm), "main": _carry(jgbm, pgbm)}
        jpath, ppath = str(tmp_path / "pipe_j.zip"), str(tmp_path / "pipe_p.zip")
        jref.write_pipeline_mojo({"glm_stage": jglm, "main": jgbm}, {"glm_pred": "glm_stage:0"},
                                 "main", jpath)
        pref.write_pipeline_mojo(carried, {"glm_pred": "glm_stage:0"}, "main", ppath)
        assert _members(ppath) == _members(jpath)
        want = pgbm._predict_raw(main_p)
        native = str(tmp_path / "pipe_native.zip")
        pref.write_pipeline_mojo({"glm_stage": pglm, "main": pgbm},
                                 {"glm_pred": "glm_stage:0"}, "main", native)
        for path in (jpath, ppath, native):
            a = pref.read_mojo(path)
            b = jref.read_mojo(path)
            assert a.info["algo"] == "pipeline" and a.columns[:2] == ["a", "b"]
            assert "glm_pred" not in a.columns
            ia, ib, ic = (a.columns.index(k) for k in ("a", "b", "c"))
            for i in range(0, n, 23):
                row = np.full(len(a.columns), np.nan)
                row[ia], row[ib], row[ic] = X[i, 2], X[i, 1], X[i, 3]
                np.testing.assert_array_equal(a.score0(row), b.score0(row))
                if path == native:
                    np.testing.assert_allclose(a.score0(row), want[i], rtol=1e-4, atol=1e-5)
        for writer, models in ((jref.write_pipeline_mojo, {"glm_stage": jglm}),
                               (pref.write_pipeline_mojo, {"glm_stage": pglm})):
            with pytest.raises(ValueError, match="alias 'nope'"):
                writer(models, {}, "nope", str(tmp_path / "x.zip"))

    # the Java double spelling, and the vocabulary escapes
    vals = [1.5, float("inf"), float("-inf"), float("nan"), -0.0, 1e-300, 0.1]
    s = pref._jarr(vals)
    assert s == jref._jarr(vals)
    assert "Infinity" in s and "NaN" in s and "inf" not in s.replace("Infinity", "")
    back = pref._parse_jarr(s)
    assert back[:3] == [1.5, float("inf"), float("-inf")] and np.isnan(back[3])
    assert back[4:] == [-0.0, 1e-300, 0.1] and str(back[4]) == "-0.0"
    py = pref._parse_jarr("[inf, -inf, nan, 2.0]")
    assert py[:2] == [float("inf"), float("-inf")] and np.isnan(py[2]) and py[3] == 2.0
    assert pref._parse_jarr("[3, 4]", int) == [3, 4] and pref._parse_jarr("[]") == []
    for w in ("plain", "a\\nb", "line\nbreak", "cr\r", "tab\v\f", "uni x", "\\"):
        esc = pref._escape_vocab_word(w)
        assert esc == jref._escape_vocab_word(w) and len(esc.splitlines()) == 1
        assert pref._unescape_vocab_word(esc) == w == jref._unescape_vocab_word(esc)
