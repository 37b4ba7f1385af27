"""The tree-model surface of the PyTorch port against the JAX package, on the
CPU: ensembles carried across as numpy arrays, batched scoring, thresholds,
``make_metrics``, TreeSHAP contributions, variable importances, binary
save/load, MOJO export with its numpy scorer, POJO source and the entry
step.

Each case fits the same ``np.random.default_rng`` data in both packages (a
GBM classifier with a categorical column that carries NAs, a DRF
regression; depth 3-4, a few trees) and holds the port to the JAX package:

- ``predict_raw_batched`` on ``[f, f, g]`` gives each caller the bits of a
  ``_predict_raw`` of its frame alone, and the JAX package's batched scores
  at rtol 1e-4 / atol 1e-5 (the fit tolerance); ``Frame.rbind`` gives the
  JAX package's codes and domains;
- ``reset_threshold`` and ``prediction_from_raw`` give the JAX package's
  labels; ``make_metrics`` the JAX package's numbers and errors;
- ``predict_contributions`` (with and without a background frame) the JAX
  package's within the fit tolerance, and each row sums to the port's
  ``predict_margin`` at rtol 1e-5 / atol 1e-5 (local accuracy);
- ``variable_importances`` the JAX package's dict;
- save/load on the CPU predicts the same bits, dumps the same bytes twice,
  holds no pickle, refuses the JAX package's archives (and the JAX package
  refuses the port's), and a fit continued from a loaded model grows the
  live model's trees;
- the port's MOJO, scored by the JAX package's ``genmodel`` and by the
  port's, matches ``_predict_raw`` at rtol 1e-4 / atol 1e-5; its arrays
  and metadata match the JAX twin's MOJO, and the port's ``genmodel``
  scores a JAX-written MOJO exactly as the JAX ``genmodel`` does;
- the C POJO, compiled with gcc where the host has it, matches the port's
  predictions at rtol 1e-5 / atol 1e-6 and the JAX twin's compiled POJO at
  the fit tolerance; the Java POJO has the reference's structure;
- ``h2o3_tpu_torch.entry.entry`` on the CPU gives ``__graft_entry__``'s
  scoring step within atol 1e-6.
"""

import copy
import ctypes
import io
import json
import shutil
import subprocess
import zipfile

import numpy as np
import pytest
import torch

from h2o3_tpu import Frame as JFrame
from h2o3_tpu.genmodel import load_mojo as j_load_mojo
from h2o3_tpu.keyed import DKV as JDKV
from h2o3_tpu.models import metrics as JM
from h2o3_tpu.models import persist as jpersist
from h2o3_tpu.models.framework import Job as JJob, Model as JModel, ModelParameters as JParams
from h2o3_tpu.models.mojo_export import write_mojo as j_write_mojo
from h2o3_tpu.models.pojo import pojo_source as j_pojo_source
from h2o3_tpu.models.tree import DRF as JDRF, GBM as JGBM
from h2o3_tpu.models.tree import booster as jb
from h2o3_tpu.models.tree.common import init_margin as j_init_margin
import h2o3_tpu_torch as ht
from h2o3_tpu_torch.convert import ensemble_from_numpy
from h2o3_tpu_torch.entry import entry as p_entry
from h2o3_tpu_torch.genmodel import load_mojo as p_load_mojo
from h2o3_tpu_torch.keyed import DKV as PDKV
from h2o3_tpu_torch.models import metrics as PM
from h2o3_tpu_torch.models import persist as ppersist
from h2o3_tpu_torch.models.framework import Job as PJob, Model as PModel, ModelParameters as PParams
from h2o3_tpu_torch.models.mojo_export import write_mojo as p_write_mojo
from h2o3_tpu_torch.models.pojo import pojo_source as p_pojo_source
from h2o3_tpu_torch.models.tree.common import tree_matrix as p_tree_matrix

torch.set_num_threads(1)

FIT_RTOL, FIT_ATOL = 1e-4, 1e-5


def _surface_data(dist, n, seed):
    """Three N(0,1) features (5% NaN in x2), a 4-level categorical with 5%
    NA, and a response that leans on x0 and x1."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 3))
    X[rng.random(n) < 0.05, 2] = np.nan
    c = np.array(["a", "b", "c", "d"], dtype=object)[rng.integers(0, 4, n)]
    c[rng.random(n) < 0.05] = None
    d = {"x0": X[:, 0], "x1": X[:, 1], "x2": X[:, 2], "c": c}
    if dist == "bernoulli":
        logit = 3 * X[:, 0] - 2 * X[:, 1] + 1.5 * (c == "a")
        d["y"] = np.where(rng.random(n) < 1 / (1 + np.exp(-logit)), "yes", "no")
    else:
        d["y"] = 3 * X[:, 0] + 2 * (X[:, 1] > 0) + 0.3 * rng.normal(size=n)
    return d


def _fit_both(jcls, pcls, d, **kw):
    """The JAX model (its DKV key removed) and the port's, fitted on ``d``."""
    jmodel = jcls(**kw).train(JFrame.from_dict(d))
    JDKV.remove(jmodel.key)
    with ht.use_device("cpu"):
        pmodel = pcls(**kw).train(ht.Frame.from_dict(d))
    for jt, pt in zip(jmodel.booster.trees_per_class, pmodel.booster.trees_per_class):
        for f in ("feat", "split_bin", "default_left", "is_split"):
            np.testing.assert_array_equal(np.stack(getattr(jt, f)),
                                          np.stack(getattr(pt, f)), err_msg=f)
    return jmodel, pmodel


def _columns(d):
    """A column dict for a MOJO scorer: the predictors, None for NA levels."""
    return {k: v for k, v in d.items() if k != "y"}


def _check_contributions(jmodel, pmodel, data, hold):
    """Contributions of the training rows (the scoring frame as its own
    background) and of held-out rows over the training rows as background:
    finite, the JAX package's at the fit tolerance, and local accuracy on
    the port. Every node holds training rows, so no cover is zero (a
    zero-cover child gives NaN in both packages, ROADMAP C5)."""
    for rows, background in ((data, None), (hold, data)):
        jc = jmodel.predict_contributions(
            JFrame.from_dict(rows),
            background_frame=None if background is None else JFrame.from_dict(background))
        with ht.use_device("cpu"):
            pc = pmodel.predict_contributions(
                ht.Frame.from_dict(rows),
                background_frame=None if background is None
                else ht.Frame.from_dict(background))
            X = p_tree_matrix(pmodel.data_info, ht.Frame.from_dict(rows),
                              encoding=pmodel.tree_encoding)
            margin = pmodel.booster.predict_margin(X)[:, 0]
        assert pc.names == jc.names
        got = np.stack([pc.col(n).data for n in pc.names], 1)
        want = np.stack([jc.col(n).data for n in jc.names], 1)
        assert np.all(np.isfinite(got))
        np.testing.assert_allclose(got, want, rtol=FIT_RTOL, atol=FIT_ATOL)
        np.testing.assert_allclose(got.sum(1), margin, rtol=1e-5, atol=1e-5)


def _check_mojo(jmodel, pmodel, d, tmp_path, name):
    """The port's MOJO against ``_predict_raw`` through both scorers, and
    against the JAX twin's MOJO; the port's scorer on the JAX MOJO."""
    with ht.use_device("cpu"):
        raw = pmodel._predict_raw(ht.Frame.from_dict(d))
    ppath, jpath = str(tmp_path / f"{name}_port.zip"), str(tmp_path / f"{name}_jax.zip")
    pmodel.download_mojo(ppath)
    jmodel.download_mojo(jpath)
    cols = _columns(d)
    for scorer in (p_load_mojo, j_load_mojo):
        np.testing.assert_allclose(scorer(ppath).score(cols), raw,
                                   rtol=FIT_RTOL, atol=FIT_ATOL)
    np.testing.assert_array_equal(p_load_mojo(jpath).score(cols),
                                  j_load_mojo(jpath).score(cols))
    with zipfile.ZipFile(ppath) as pz, zipfile.ZipFile(jpath) as jz:
        assert sorted(pz.namelist()) == sorted(jz.namelist())
        pa = np.load(io.BytesIO(pz.read("arrays.npz")), allow_pickle=False)
        ja = np.load(io.BytesIO(jz.read("arrays.npz")), allow_pickle=False)
        assert sorted(pa.files) == sorted(ja.files)
        for key in pa.files:
            assert pa[key].dtype == ja[key].dtype, key
            if pa[key].dtype.kind in "biu":
                np.testing.assert_array_equal(pa[key], ja[key], err_msg=key)
            else:
                np.testing.assert_allclose(pa[key], ja[key], rtol=FIT_RTOL,
                                           atol=FIT_ATOL, err_msg=key)
        pmeta, jmeta = (json.loads(z.read("meta.json")) for z in (pz, jz))
        thr = [m.pop("default_threshold", None) for m in (pmeta, jmeta)]
        assert pmeta == jmeta
        if thr[1] is None:
            assert thr[0] is None
        else:
            assert abs(thr[0] - thr[1]) <= FIT_ATOL, thr
        assert json.loads(pz.read("data_info.json")) == json.loads(jz.read("data_info.json"))
        ini = [[ln for ln in z.read("model.ini").decode().splitlines()
                if not ln.startswith("model_key = ")] for z in (pz, jz)]
        assert ini[0] == ini[1]


def _compile(src, tmp_path, name):
    c_path, so_path = tmp_path / f"{name}.c", tmp_path / f"{name}.so"
    c_path.write_text(src)
    proc = subprocess.run(["gcc", "-O2", "-shared", "-fPIC", "-o", str(so_path),
                           str(c_path), "-lm"], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(so_path))


def _pojo_scores(lib, X32, n_out):
    lib.score.argtypes = [ctypes.POINTER(ctypes.c_float),
                          ctypes.POINTER(ctypes.c_double)]
    out = np.zeros((X32.shape[0], n_out))
    buf = np.zeros(n_out, dtype=np.float64)
    for i in range(X32.shape[0]):
        row = np.ascontiguousarray(X32[i], dtype=np.float32)
        lib.score(row.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                  buf.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        out[i] = buf
    return out


def _check_pojo(jmodel, pmodel, d, tmp_path, name):
    """The Java source's structure; where gcc is on the host, the compiled
    C source against the port's predictions and the JAX twin's POJO."""
    src = pmodel.pojo("java")
    assert "public class POJO_" in src
    assert "public static double[] score0(double[] row" in src
    assert src.count("{") == src.count("}")
    ntrees = sum(t.ntrees for t in pmodel.booster.trees_per_class)
    assert src.count("s += walk(") == ntrees
    if shutil.which("gcc") is None:
        return
    fr = ht.Frame.from_dict(d)
    X32 = p_tree_matrix(pmodel.data_info, fr, encoding=pmodel.tree_encoding)
    with ht.use_device("cpu"):
        raw = pmodel._predict_raw(fr)
    n_out = 1 + raw.shape[1] if raw.ndim == 2 else 1
    port = _pojo_scores(_compile(pmodel.pojo("c"), tmp_path, f"{name}_port"), X32, n_out)
    jax = _pojo_scores(_compile(jmodel.pojo("c"), tmp_path, f"{name}_jax"), X32, n_out)
    if raw.ndim == 2:
        np.testing.assert_allclose(port[:, 1:], raw, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(port[:, 0], raw, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(port, jax, rtol=FIT_RTOL, atol=FIT_ATOL)


def _check_persist(jmodel, pmodel, d, kw, pcls):
    """Save/load on the CPU, the archive's form, the two packages' refusals
    of each other's archives, and a fit continued from a loaded model."""
    fr = ht.Frame.from_dict(d)
    blob = ppersist.dumps_model(pmodel)
    assert ppersist.dumps_model(pmodel) == blob
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        assert sorted(z.namelist()) == ["arrays.npz", "meta.json", "model.json"]
        arrays = np.load(io.BytesIO(z.read("arrays.npz")), allow_pickle=False)
        assert all(arrays[k].dtype != object for k in arrays.files)
        assert "cpu" not in z.read("model.json").decode()
    loaded = ppersist.loads_model(blob, device="cpu")
    assert loaded.device == loaded.booster.device == torch.device("cpu")
    with ht.use_device("cpu"):
        np.testing.assert_array_equal(loaded._predict_raw(fr), pmodel._predict_raw(fr))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ppersist.loads_model(blob)
    carrier = copy.copy(pmodel)  # a tensor never rides into an archive
    carrier.stray = torch.zeros(2)
    with pytest.raises(TypeError, match="cannot serialize"):
        ppersist.dumps_model(carrier)
    with pytest.raises(ValueError, match="allowlist"):
        ppersist.loads_model(jpersist.dumps_model(jmodel), device="cpu")
    with pytest.raises(ValueError, match="allowlist"):
        jpersist.loads_model(blob)
    # checkpoint-continue from the loaded model grows the live model's trees
    ppersist.loads_model(blob, key="surface_loaded", register=True, device="cpu")
    more = dict(kw, ntrees=kw["ntrees"] + 2)
    with ht.use_device("cpu"):
        live = pcls(**dict(more, checkpoint=pmodel.key)).train(fr)
        cont = pcls(**dict(more, checkpoint="surface_loaded")).train(fr)
    for a, b in zip(live.booster.trees_per_class, cont.booster.trees_per_class):
        for f in ("feat", "split_bin", "default_left", "is_split", "leaf"):
            np.testing.assert_array_equal(np.stack(getattr(a, f)),
                                          np.stack(getattr(b, f)), err_msg=f)


def test_ensemble_carried_across_scores_like_jax(tmp_path):
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

    # a GBM classifier fitted by both packages: the scoring surface
    data, hold = _surface_data("bernoulli", 1000, 3), _surface_data("bernoulli", 300, 4)
    kw = dict(response_column="y", ntrees=3, max_depth=3, seed=5)
    jmodel, pmodel = _fit_both(JGBM, ht.GBM, data, **kw)
    jf, jg = JFrame.from_dict(data), JFrame.from_dict(hold)
    pf, pg = ht.Frame.from_dict(data), ht.Frame.from_dict(hold)
    with ht.use_device("cpu"):
        batched = pmodel.predict_raw_batched([pf, pf, pg])
        alone = [pmodel._predict_raw(pf), pmodel._predict_raw(pg)]
    jbatched = jmodel.predict_raw_batched([jf, jf, jg])
    for (raw, _), want, (jraw, _) in zip(batched, [alone[0], alone[0], alone[1]], jbatched):
        np.testing.assert_array_equal(raw, want)
        np.testing.assert_allclose(raw, jraw, rtol=FIT_RTOL, atol=FIT_ATOL)
    assert batched[0][0] is batched[1][0]  # an identical frame scores once

    # thresholds: the training max-F1, then a reset; the labels either way
    old = [m.reset_threshold(0.35) for m in (jmodel, pmodel)]
    assert abs(old[0] - old[1]) <= FIT_ATOL, old
    assert jmodel.default_threshold() == pmodel.default_threshold() == 0.35
    jraw = batched[2][0]  # the same numpy scores through both packages
    np.testing.assert_array_equal(pmodel.prediction_from_raw(jraw).col("predict").data,
                                  jmodel.prediction_from_raw(jraw).col("predict").data)
    with ht.use_device("cpu"):
        plabels = pmodel.predict(pg).col("predict").data
    np.testing.assert_array_equal(plabels, jmodel.predict(jg).col("predict").data)
    assert pmodel.reset_threshold(old[1]) == jmodel.reset_threshold(old[0]) == 0.35

    _check_contributions(jmodel, pmodel, data, hold)
    assert pmodel.variable_importances() == jmodel.variable_importances()
    _check_persist(jmodel, pmodel, data, kw, ht.GBM)
    _check_mojo(jmodel, pmodel, hold, tmp_path, "gbm")
    _check_pojo(jmodel, pmodel, hold, tmp_path, "gbm")

    # ensemble_from_numpy's shape checks, make_metrics, export refusals, Job, rbind
    d = {"edges": np.zeros((2, 6)), "init_margin": np.zeros(1), "max_depth": 2,
         "n_bins1": 8, "feat": [np.zeros((1, 5))], "split_bin": [np.zeros((1, 7))],
         "default_left": [np.zeros((1, 7))], "is_split": [np.zeros((1, 7))],
         "leaf": [np.zeros((1, 7))]}
    with pytest.raises(ValueError, match="feat"):
        ensemble_from_numpy(d, device="cpu")

    # make_metrics on the same numpy inputs: the JAX package's numbers and
    # errors, for every column convention and the non-gaussian deviances
    good, bad = _make_metrics_cases(np.random.default_rng(8))
    for args, kw in good:
        jm, pm = JM.make_metrics(*args, **kw), PM.make_metrics(*args, **kw)
        assert type(jm).__name__ == type(pm).__name__
        jv, pv = _metric_values(jm), _metric_values(pm)
        assert sorted(jv) == sorted(pv)
        for k in jv:
            np.testing.assert_array_equal(pv[k], jv[k], err_msg=f"{kw} {k}")
    for args, kw in bad:
        with pytest.raises(ValueError) as je:
            JM.make_metrics(*args, **kw)
        with pytest.raises(ValueError) as pe:
            PM.make_metrics(*args, **kw)
        assert str(pe.value) == str(je.value)
    # a model of a family not ported yet: MOJO and POJO export refuse it
    # with the JAX package's errors
    msgs = []
    for Model, Params, write_mojo, pojo_source in (
            (JModel, JParams, j_write_mojo, j_pojo_source),
            (PModel, PParams, p_write_mojo, p_pojo_source)):
        other = Model.__new__(Model)
        other.params = Params()
        for export in (lambda: write_mojo(other, "unused.zip"), lambda: pojo_source(other)):
            with pytest.raises(ValueError) as err:
                export()
            msgs.append(str(err.value))
    assert msgs[:2] == msgs[2:]
    assert msgs[2] == "MOJO export not supported for Model"
    assert (PM.ScoringRecord.key_for("gbm_3", "fr@1")
            == JM.ScoringRecord.key_for("gbm_3", "fr@1") == "modelmetrics_gbm_3@fr@1")

    # Job states: done, cancelled, failed, and the run time
    states = []
    for Job, DKV in ((JJob, JDKV), (PJob, PDKV)):
        seq = []
        for action in ("done", "cancel", "fail"):
            job = Job("surface")
            seq.append((job.status, job.run_time, job.stop_requested))
            job.start()
            if action == "cancel":
                job.cancel()
                seq.append(job.stop_requested)
            if action == "fail":
                job.fail(RuntimeError("x"))
            else:
                job.done()
            seq.append((job.status, job.progress, job.run_time >= 0,
                        job.end_time >= job.start_time))
            DKV.remove(job.key)
        states.append(seq)
    assert states[0] == states[1]
    assert [s[0] for s in states[1] if isinstance(s, tuple) and len(s) == 4] == [
        "DONE", "CANCELLED", "FAILED"]

    # rbind: a categorical column with NAs and new levels in the second
    # frame, and a column numeric in one frame and categorical in the other
    rng = np.random.default_rng(12)
    a = {"c": np.array(["b", None, "a", "b"], dtype=object), "k": np.arange(4.0),
         "x": rng.normal(size=4)}
    b = {"c": np.array(["d", "a", None], dtype=object),
         "k": np.array(["u", None, "1"], dtype=object), "x": rng.normal(size=3)}
    jbound = JFrame.from_dict(a).rbind(JFrame.from_dict(b))
    pbound = ht.Frame.from_dict(a).rbind(ht.Frame.from_dict(b))
    assert pbound.names == jbound.names
    for name in jbound.names:
        jc, pc = jbound.col(name), pbound.col(name)
        assert (pc.type.value, pc.domain) == (jc.type.value, jc.domain), name
        np.testing.assert_array_equal(pc.data, jc.data, err_msg=name)
    assert pbound.col("c").domain == ["a", "b", "d"] and pbound.col("c").data[1] == -1
    with pytest.raises(ValueError, match="identical column names"):
        ht.Frame.from_dict({"x": [1.0]}).rbind(ht.Frame.from_dict({"z": [1.0]}))


def test_drf_ensemble_carried_across_scores_like_jax(tmp_path):
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

    # a DRF regression fitted by both packages: contributions (averaged
    # trees), importances, MOJO and POJO. The categorical column is left
    # out: with it, one split of the third tree is a mirror-image tie
    # (ROADMAP C2: the same partition with the children and NA swapped),
    # where the packages keep different tree arrays for the same scores
    data, hold = _surface_data("gaussian", 800, 5), _surface_data("gaussian", 200, 6)
    kw = dict(response_column="y", ntrees=3, max_depth=4, seed=7, ignored_columns=["c"])
    jmodel, pmodel = _fit_both(JDRF, ht.DRF, data, **kw)
    _check_contributions(jmodel, pmodel, data, hold)
    assert pmodel.variable_importances() == jmodel.variable_importances()
    _check_mojo(jmodel, pmodel, hold, tmp_path, "drf")
    _check_pojo(jmodel, pmodel, hold, tmp_path, "drf")

    # the entry step on the CPU is the JAX entry's
    from __graft_entry__ import entry as j_entry

    jfn, jargs = j_entry()
    pfn, pargs = p_entry("cpu")
    assert pargs[0].shape == (8, 256) and pargs[-1] == 17
    np.testing.assert_allclose(pfn(*pargs).numpy(), np.asarray(jfn(*jargs)),
                               rtol=0, atol=1e-6)


def _make_metrics_cases(rng):
    n = 400
    yb = rng.integers(0, 2, n).astype(np.float64)
    p1 = np.clip(0.3 * yb + 0.7 * rng.random(n), 0, 1)
    pm = rng.dirichlet(np.ones(3), size=n)
    ym = rng.integers(0, 3, n)
    yr = rng.poisson(2.0, n).astype(np.float64)
    mu = yr + 0.5 * rng.random(n) + 0.1
    w = rng.integers(1, 3, n).astype(np.float64)
    lab = (p1 > 0.5).astype(np.float64)
    return [
        ((p1, yb), dict(domain=["n", "y"])),
        ((np.stack([1 - p1, p1], 1), yb), dict(domain=["n", "y"], weights=w)),
        ((np.stack([lab, 1 - p1, p1], 1), yb), dict(domain=["n", "y"])),
        ((pm, ym), dict(domain=["a", "b", "c"])),
        ((np.concatenate([pm.argmax(1)[:, None], pm], 1), ym),
         dict(domain=["a", "b", "c"], weights=w)),
        ((mu, yr), {}),
        ((mu, yr), dict(distribution="poisson")),
        ((mu, yr), dict(distribution="tweedie", weights=w)),
    ], [
        ((np.zeros((n, 2)), yr), {}),
        ((np.zeros((n, 4)), yb), dict(domain=["n", "y"])),
        ((np.zeros((n, 5)), ym), dict(domain=["a", "b", "c"])),
        ((mu, yr), dict(distribution="nope")),
    ]


def _metric_values(m):
    out = {}
    for k, v in vars(m).items():
        if isinstance(v, (float, int, np.floating, np.integer, np.ndarray, list)):
            out[k] = np.asarray(v, dtype=object if isinstance(v, list) else None)
    if hasattr(m, "cm"):
        out["cm"] = m.cm.table
    return out
