"""Parity: the PyTorch port's AutoML slice (``h2o3_tpu_torch/models/
target_encoder.py``, ``models/grid.py``, ``models/stacked_ensemble.py``,
``api/registry.py`` and ``automl/automl.py``) against the JAX package, on
the CPU, with the same numpy inputs made from a seed.

- Target encoding: fit and ``transform`` with each leakage mode (none,
  leave-one-out, k-fold), blending on and off, with and without noise, a
  categorical with NAs and an unseen level at transform time, binary and
  numeric targets: the tables, the prior and the folds, and every
  ``<col>_te`` column ``np.array_equal``; the dropped originals and the
  multinomial error are the JAX package's.
- Grid search: the Cartesian and RandomDiscrete walks and the per-cell
  seeds equal; a GBM grid with equal trees per cell and metrics within
  1e-6; ``stopping_rounds`` cutting the walk at the same cell; ``max_models``;
  a failing cell recorded in ``failures`` in both; ``parallelism=2`` under
  ``use_device("cpu")`` giving the grid of ``parallelism=1`` (its worker
  threads see no ``use_device`` block: the cells carry the device);
  ``Grid.save``/``Grid.load``.
- Stacked ensembles over a GBM and a GLM with 2-fold CV: equal level-one
  names and matrices, the GLM metalearner's coefficients at rtol 1e-4 and
  the predictions at 1e-5, a ``gbm`` metalearner with equal trees, and the
  JAX package's ``ValueError`` for a base model without CV predictions.
- AutoML: one parity run (binomial, 400 rows, one categorical with NAs,
  target encoding, ``include_algos=["xgboost", "gbm", "glm",
  "stackedensemble"]``, ``max_models=4``, ``nfolds=2``): the same event
  sequence, the same target encoder, the same leaderboard order by step
  wherever the metrics lie further apart than the tolerance, tree models'
  CV AUC within 1e-6, the GLM's CV metrics at rtol 1e-4 and the ensembles'
  within 1e-4, no failed step; the JAX leader carried across
  (``convert``), with its target encoder, scores a raw frame within 1e-6;
  the budget cases of ``tests/test_automl.py`` (``exclude_algos``, ``x``,
  ``max_runtime_secs``) behave the same; and one port-only run of the
  whole default plan (DeepLearning and DRF included) with no failed step,
  whose leader scores a raw frame as the encoded one and survives save
  and load.

The parity run's response is a rule (``x0 == 1``, or the level ``a`` or
``c``) beside two noise columns, so most nodes end pure. Its trees still
meet ties of ROADMAP C2: the target-encoded ``c_te`` splits a node that
holds a few levels exactly as ``c`` does, with equal gain, and the two
packages break the tie apart (float32 sums over 8 shards there, once
here). A fold fit that takes the other column moves held-out
probabilities near 0 and 1 by up to about 1e-3, so a tree model's CV
logloss and RMSE are held within 1e-4 and its CV AUC, the leaderboard
metric, within 1e-6.

Model keys and event times differ between the packages, so runs are
compared by step, algorithm and metric. The tier-1 run's collected count is
held fixed (ROADMAP C4): this file's five tests came with five checks moved
into other tests' bodies (listed in CHANGES.md).
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import jax

from h2o3_tpu import Frame as JFrame
from h2o3_tpu.automl import AutoML as JAutoML
from h2o3_tpu.keyed import DKV as JDKV
from h2o3_tpu.models import grid as jgrid
from h2o3_tpu.models.framework import Job as JJob
from h2o3_tpu.models.glm import GLM as JGLM
from h2o3_tpu.models.stacked_ensemble import StackedEnsemble as JSE
from h2o3_tpu.models.target_encoder import TargetEncoder as JTE
from h2o3_tpu.models.tree import GBM as JGBM
from h2o3_tpu.models.tree.gbm import GBMParameters as JGBMParameters
import h2o3_tpu_torch as ht
from h2o3_tpu_torch.convert import (
    ensemble_from_numpy,
    glm_from_numpy,
    stacked_ensemble_from_models,
    target_encoder_from_numpy,
)
from h2o3_tpu_torch.api.registry import algo_map
from h2o3_tpu_torch.models import grid as pgrid
from h2o3_tpu_torch.models import persist as ppersist
from h2o3_tpu_torch.models.data_info import DataInfo

torch.set_num_threads(1)

#: tree metrics (equal trees: only the float order of sums differs)
TREE_TOL = 1e-6
#: the GLM's coefficients and metrics (8 shards' sums there, one here)
GLM_RTOL = 1e-4
#: an ensemble's metrics, and leaderboard gaps that must keep their order
ENSEMBLE_TOL = 1e-4
#: an AutoML tree model's CV logloss and RMSE: the target-encoded column
#: ties with its own categorical wherever a node holds levels that both
#: split alike, and the packages break such ties apart (ROADMAP C2), which
#: moves held-out probabilities near 0 and 1 (the CV AUC stays at TREE_TOL)
TIE_TOL = 1e-4


@contextlib.contextmanager
def _jax_keys_removed():
    before = set(JDKV.keys())
    try:
        yield
    finally:
        for k in set(JDKV.keys()) - before:
            if not isinstance(JDKV.peek(k), JJob):
                JDKV.remove(k)


def _strong(n, seed, unseen=False):
    """Four numeric columns (x3 with NAs), a categorical with NAs and a
    binary response with a strong, well-separated signal on x0 and x1."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4))
    X[rng.random(n) < 0.05, 3] = np.nan
    lv = np.array(["a", "b", "c", "d"] + (["zz"] if unseen else []))
    c = np.array(lv[rng.integers(0, len(lv), n)], dtype=object)
    c[rng.random(n) < 0.05] = None
    logit = 3 * X[:, 0] - 2 * X[:, 1]
    y = np.where(rng.random(n) < 1 / (1 + np.exp(-logit)), "yes", "no")
    d = {f"x{j}": X[:, j] for j in range(4)}
    d["c"] = c
    d["y"] = np.array(y, dtype=object)
    d["g"] = logit + rng.normal(size=n)
    return d


def _rule(n, seed):
    """The AutoML parity fixture: ``y`` is ``x0 == 1`` or the level in
    {a, c} (NA is neither), beside two N(0, 1) noise columns."""
    rng = np.random.default_rng(seed)
    x0 = rng.integers(0, 2, n).astype(np.float64)
    lv = np.array(["a", "b", "c", "d", "e"])
    c = np.array(lv[rng.integers(0, 5, n)], dtype=object)
    c[rng.random(n) < 0.05] = None
    y = np.where((x0 == 1) | np.isin(c, ["a", "c"]), "p", "n")
    return {"x0": x0, "x1": rng.normal(size=n), "x2": rng.normal(size=n),
            "c": c, "y": np.array(y, dtype=object)}


def _assert_trees_equal(jm, pm, edges_rtol=0.0):
    """Equal trees: the same nodes split, each on the same feature, bin and
    NA direction, and the leaf values at the fit tolerance. A node left
    unsplit keeps a split candidate that no row reads; in a sampled fit
    (a node with no sampled rows) the two packages may keep different
    ones, so candidates are compared where a node splits. The bin edges
    are equal, but for a metalearner's: its inputs are base models'
    predictions, which carry the GLM's rounding (``edges_rtol``)."""
    for jt, pt in zip(jm.booster.trees_per_class, pm.booster.trees_per_class):
        np.testing.assert_allclose(pt.edges, jt.edges, rtol=edges_rtol, atol=0)
        split = np.stack(jt.is_split)
        np.testing.assert_array_equal(np.stack(pt.is_split), split)
        for f in ("feat", "split_bin", "default_left"):
            np.testing.assert_array_equal(np.stack(getattr(pt, f))[split],
                                          np.stack(getattr(jt, f))[split], err_msg=f)
        np.testing.assert_allclose(np.stack(pt.leaf), np.stack(jt.leaf),
                                   rtol=1e-4, atol=1e-5)


def _metric(model):
    return model.cross_validation_metrics or model.training_metrics


# ---------------------------------------------------------------------------
# target encoding


def test_target_encoding_matches_jax():
    d, s = _strong(300, 1), _strong(120, 2, unseen=True)
    jf, pf = JFrame.from_dict(d), ht.Frame.from_dict(d)
    js, ps = JFrame.from_dict(s), ht.Frame.from_dict(s)
    assert "zz" in ps.col("c").domain and "zz" not in pf.col("c").domain
    cases = [dict(data_leakage_handling=h, blending=b, noise=nz)
             for h in ("none", "leave_one_out", "k_fold")
             for b in (False, True) for nz in (0.0, 0.05)]
    cases += [
        dict(response_column="g", data_leakage_handling="k_fold", blending=True),
        dict(data_leakage_handling="k_fold", fold_assignment="modulo",
             keep_original_categorical_columns=False,
             columns_to_encode=["c", "x2"]),
    ]
    for case in cases:
        kw = {"response_column": "y", "seed": 7, **case}
        with _jax_keys_removed():
            jm = JTE(**kw).train(jf)
            pm = ht.TargetEncoder(device="cpu", **kw).train(pf)
            assert sorted(pm.encodings) == sorted(jm.encodings), case
            for name, (dom, num, den) in jm.encodings.items():
                pdom, pnum, pden = pm.encodings[name]
                assert pdom == dom
                np.testing.assert_array_equal(pnum, num)
                np.testing.assert_array_equal(pden, den)
            assert pm.prior_mean == jm.prior_mean
            if jm.fold is None:
                assert pm.fold is None
            else:
                np.testing.assert_array_equal(pm.fold, jm.fold)
            for fr_j, fr_p, training in ((jf, pf, True), (jf, pf, False), (js, ps, False)):
                jt = jm.transform(fr_j, as_training=training)
                pt = pm.transform(fr_p, as_training=training)
                assert pt.names == jt.names, case
                for name in jm.encodings:
                    np.testing.assert_array_equal(pt.col(f"{name}_te").data,
                                                  jt.col(f"{name}_te").data,
                                                  err_msg=f"{case} {name} {training}")
            # an explicit noise on an inference transform
            np.testing.assert_array_equal(pm.transform(ps, noise=0.1).col("c_te").data,
                                          jm.transform(js, noise=0.1).col("c_te").data)
    m = dict(_strong(60, 3))
    m["y"] = np.array(np.array(["u", "v", "w"])[np.arange(60) % 3], dtype=object)
    with pytest.raises(ValueError) as jerr, _jax_keys_removed():
        JTE(response_column="y").train(JFrame.from_dict(m))
    with pytest.raises(ValueError) as perr:
        ht.TargetEncoder(response_column="y", device="cpu").train(ht.Frame.from_dict(m))
    assert str(perr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# grid search


def test_grid_matches_jax(tmp_path):
    d = _strong(300, 4)
    jf, pf = JFrame.from_dict(d), ht.Frame.from_dict(d)
    base = dict(response_column="y", ntrees=3, max_depth=3, seed=11,
                ignored_columns=["g", "c"])
    hyper = {"learn_rate": [0.1, 0.2], "sample_rate": [0.8, 1.0]}
    wide = {"max_depth": [3, 5, 7, 9], "learn_rate": [0.05, 0.1, 0.2],
            "sample_rate": [0.6, 0.8, 1.0]}

    # the walks and the per-cell seeds
    assert list(pgrid._cartesian(wide)) == list(jgrid._cartesian(wide))
    for seed in (-1, 0, 42, 123):
        if seed != -1:
            assert (list(pgrid._random_discrete(wide, seed))
                    == list(jgrid._random_discrete(wide, seed)))
        for strategy in ("Cartesian", "RandomDiscrete"):
            crit = dict(strategy=strategy, seed=seed)
            jgs = jgrid.GridSearch(JGBM, JGBMParameters(**base), wide,
                                   jgrid.SearchCriteria(**crit))
            pgs = pgrid.GridSearch(ht.GBM, ht.GBM(**base).params, wide,
                                   pgrid.SearchCriteria(**crit))
            hps = list(jgrid._cartesian(wide))
            assert ([pgs._cell_params(hp).seed for hp in hps]
                    == [jgs._cell_params(hp).seed for hp in hps])
            assert pgs.n_cells_hint() == jgs.n_cells_hint()
    assert (pgrid.cell_seed(5, pgrid.cell_key({"a": 1.5}))
            == jgrid.cell_seed(5, jgrid.cell_key({"a": 1.5})))

    def both(hp, crit=None, parallelism=1, params=base):
        with _jax_keys_removed():
            jg = jgrid.GridSearch(JGBM, JGBMParameters(**params), hp,
                                  jgrid.SearchCriteria(**(crit or {}))).train(jf)
        with ht.use_device("cpu"):
            pg = pgrid.GridSearch(ht.GBM, ht.GBM(**params).params, hp,
                                  pgrid.SearchCriteria(**(crit or {})),
                                  parallelism=parallelism).train(pf)
        assert pg.hyper_params == jg.hyper_params
        assert pg.failures == jg.failures
        for jm, pm in zip(jg.models, pg.models):
            assert pm.params.seed == jm.params.seed
            assert pm.device == torch.device("cpu")
            _assert_trees_equal(jm, pm)
            assert abs(pm.training_metrics.auc - jm.training_metrics.auc) <= TREE_TOL
        jrows, prows = jg.summary_table(), pg.summary_table()
        hp_of = lambda r: {k: v for k, v in r.items() if k not in ("model_id", "metric")}
        assert [hp_of(r) for r in prows] == [hp_of(r) for r in jrows]
        np.testing.assert_allclose([r["metric"] for r in prows],
                                   [r["metric"] for r in jrows], rtol=0, atol=TREE_TOL)
        return jg, pg

    jg, pg = both(hyper)
    assert len(pg.models) == 4 and not pg.failures
    # parallelism 2: the cells run on worker threads, outside use_device
    _, pg2 = both(hyper, parallelism=2)
    for a, b in zip(pg.models, pg2.models):
        _assert_trees_equal(a, b)
    # max_models, and stopping_rounds over a walk that stops improving
    _, pg3 = both(hyper, dict(strategy="RandomDiscrete", seed=3, max_models=3))
    assert len(pg3.models) == 3
    _, pg4 = both({"learn_rate": [0.2, 0.1, 0.05, 0.02, 0.01]},
                  dict(stopping_rounds=1, stopping_tolerance=0.5))
    assert 2 <= len(pg4.models) < 5
    # a failing cell is recorded, not raised
    _, pg5 = both({"max_depth": [2, 3], "distribution": ["bernoulli", "nonesuch"]})
    assert len(pg5.models) == 2 and len(pg5.failures) == 2
    with pytest.raises(NotImplementedError, match="A11"):
        pgrid.GridSearch(ht.GBM, ht.GBM(**base).params, hyper, recovery_dir=str(tmp_path))

    # save / load: the models come back on the device asked for
    path = pg.save(str(tmp_path / "grid.bin"))
    loaded = pgrid.Grid.load(path, device="cpu")
    assert loaded.grid_id == pg.grid_id and loaded.hyper_params == pg.hyper_params
    for a, b in zip(pg.models, loaded.models):
        assert b.device == torch.device("cpu") and b.params.device == torch.device("cpu")
        np.testing.assert_array_equal(b.predict(pf).col("pyes").data,
                                      a.predict(pf).col("pyes").data)
    ppersist.save_model(pg.models[0], str(tmp_path / "model.bin"))
    with pytest.raises(ValueError, match="not a grid export"):
        pgrid.Grid.load(str(tmp_path / "model.bin"), device="cpu")


# ---------------------------------------------------------------------------
# stacked ensembles


def test_stacked_ensemble_matches_jax():
    d, s = _strong(300, 5), _strong(150, 6)
    jf, pf = JFrame.from_dict(d), ht.Frame.from_dict(d)
    js, ps = JFrame.from_dict(s), ht.Frame.from_dict(s)
    cv = dict(response_column="y", nfolds=2, keep_cross_validation_predictions=True,
              seed=3, ignored_columns=["g", "c"])
    with _jax_keys_removed():
        jbases = [JGBM(ntrees=3, max_depth=3, **cv).train(jf),
                  JGLM(family="binomial", lambda_=1e-3, **cv).train(jf)]
        with ht.use_device("cpu"):
            pbases = [ht.GBM(ntrees=3, max_depth=3, **cv).train(pf),
                      ht.GLM(family="binomial", lambda_=1e-3, **cv).train(pf)]
        _assert_trees_equal(jbases[0], pbases[0])
        for algo, meta_kw in (("auto", {}), ("gbm", dict(ntrees=3, max_depth=2))):
            kw = dict(response_column="y", metalearner_algorithm=algo,
                      metalearner_params=meta_kw, seed=3)
            jm = JSE(base_models=jbases, **kw).train(jf)
            with ht.use_device("cpu"):
                pm = ht.StackedEnsemble(base_models=pbases, **kw).train(pf)
            assert pm.levelone_names == jm.levelone_names == [
                "m0_gbm_c0", "m1_glm_c0"]
            assert pm.metalearner.device == torch.device("cpu")
            np.testing.assert_allclose(pm._levelone_matrix(ps), jm._levelone_matrix(js),
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(pm.predict(ps).col("pyes").data,
                                       jm.predict(js).col("pyes").data,
                                       rtol=0, atol=1e-5)
            assert abs(pm.training_metrics.auc - jm.training_metrics.auc) <= 1e-5
            if algo == "auto":
                jc, pc = jm.metalearner.coefficients, pm.metalearner.coefficients
                assert sorted(pc) == sorted(jc)
                np.testing.assert_allclose([pc[k] for k in sorted(jc)],
                                           [jc[k] for k in sorted(jc)], rtol=GLM_RTOL)
            else:
                _assert_trees_equal(jm.metalearner, pm.metalearner, edges_rtol=1e-5)
        # a base model without CV predictions
        jplain = JGBM(ntrees=2, max_depth=2, response_column="y").train(jf)
        with ht.use_device("cpu"):
            pplain = ht.GBM(ntrees=2, max_depth=2, response_column="y").train(pf)
        with pytest.raises(ValueError) as jerr:
            JSE(base_models=[jbases[0], jplain], response_column="y").train(jf)
        with pytest.raises(ValueError) as perr, ht.use_device("cpu"):
            ht.StackedEnsemble(base_models=[pbases[0], pplain],
                               response_column="y").train(pf)
        assert (str(perr.value).replace(pplain.key, "K")
                == str(jerr.value).replace(jplain.key, "K"))


# ---------------------------------------------------------------------------
# AutoML


def _steps(aml):
    """The event log without keys, times and metric values: one entry per
    event, the step ids and what happened to them."""
    out = []
    for e in aml.event_log.events:
        msg = e["message"]
        if " -> " in msg:
            msg = msg.split(" -> ")[0] + " -> model"
        elif msg.startswith(("AutoML build", "target encoding applied",
                             "exploitation: refining")):
            msg = msg.split(":")[0]
        out.append((e["stage"], msg))
    return out


def _assert_no_failure(aml):
    bad = [e["message"] for e in aml.event_log.events if "failed" in e["message"]]
    assert not bad, bad


def _assert_leaderboards_agree(ja, pa):
    """The same models by step, each step's CV metrics (training metrics
    for an ensemble) within its tolerance, and the same leaderboard order
    wherever the JAX package's metrics lie further apart than
    ``ENSEMBLE_TOL``."""
    jby, pby = _models_by_step(ja), _models_by_step(pa)
    assert sorted(pby) == sorted(jby)
    step_of = {m.key: s for s, m in list(jby.items()) + list(pby.items())}
    jsteps = [step_of[m.key] for m in ja.leaderboard.models]
    psteps = [step_of[m.key] for m in pa.leaderboard.models]
    assert sorted(psteps) == sorted(jsteps)
    jv = [jgrid.metric_value(m)[0] for m in ja.leaderboard.models]
    for i in range(len(jsteps)):
        for k in range(i + 1, len(jsteps)):
            if jv[i] - jv[k] > ENSEMBLE_TOL:
                assert psteps.index(jsteps[i]) < psteps.index(jsteps[k]), (jsteps, psteps)
    for step, jm in jby.items():
        pm = pby[step]
        assert pm.algo_name == jm.algo_name
        a, b = _metric(jm), _metric(pm)
        diffs = {n: abs(getattr(a, n) - getattr(b, n)) for n in ("auc", "logloss", "rmse")}
        if jm.algo_name in ("gbm", "xgboost", "drf"):
            assert diffs["auc"] <= TREE_TOL, (step, diffs)
            assert max(diffs.values()) <= TIE_TOL, (step, diffs)
        elif jm.algo_name == "glm":
            for name in diffs:
                np.testing.assert_allclose(getattr(b, name), getattr(a, name),
                                           rtol=GLM_RTOL, err_msg=f"{step} {name}")
        else:
            assert max(diffs.values()) <= ENSEMBLE_TOL, (step, diffs)


def _models_by_step(aml):
    keys = {}
    for e in aml.event_log.events:
        msg = e["message"]
        if " -> " in msg and " metric=" in msg:
            step, rest = msg.split(" -> ")
            keys[step] = rest.split(" ")[0]
    by_key = {m.key: m for m in aml.leaderboard.models}
    return {step: by_key[k] for step, k in keys.items()}


def _carry_tree(jm, pm):
    """The JAX tree model's ensemble in a port model of its step."""
    ens = jm.booster
    arrays = {"edges": ens.trees_per_class[0].edges, "init_margin": ens.init_margin,
              "max_depth": ens.trees_per_class[0].max_depth,
              "n_bins1": ens.trees_per_class[0].n_bins1, "average": ens.average}
    for f in ("feat", "split_bin", "default_left", "is_split", "leaf"):
        arrays[f] = [np.stack(getattr(t, f)) for t in ens.trees_per_class]
    fields = {f.name for f in dataclasses.fields(pm.params)}
    params = type(pm.params)(**{k: v for k, v in dataclasses.asdict(jm.params).items()
                                if k in fields})
    carried = type(pm)(params, DataInfo(**dataclasses.asdict(jm.data_info)),
                       jm.distribution, torch.device("cpu"))
    carried.booster = ensemble_from_numpy(arrays, device="cpu")
    return carried


def _carry(jm, pm):
    """A JAX model carried across by ``convert``; ``pm`` is the port's model
    of the same step (it gives the port's class for a tree model)."""
    if jm.algo_name == "glm":
        arrays = {k: getattr(jm, k) for k in ("beta_std", "beta_multi")
                  if getattr(jm, k) is not None}
        arrays["coefficients"] = jm.coefficients
        return glm_from_numpy(arrays, dataclasses.asdict(jm.data_info),
                              dataclasses.asdict(jm.params), device="cpu")
    return _carry_tree(jm, pm)


def test_automl_matches_jax(tmp_path):
    d = _rule(400, 8)
    jf, pf = JFrame.from_dict(d), ht.Frame.from_dict(d)
    # seed 11 splits the 400 rows 200 / 200 in the 2-fold CV: the JAX
    # package compiles each booster for two row counts instead of three
    kw = dict(max_models=4, nfolds=2, seed=11, preprocessing=["target_encoding"],
              include_algos=["xgboost", "gbm", "glm", "stackedensemble"])
    with _jax_keys_removed():
        ja = JAutoML(**kw)
        ja.train(y="y", training_frame=jf)
        with ht.use_device("cpu"):
            pa = ht.AutoML(**kw)
            pa.train(y="y", training_frame=pf)
        _assert_no_failure(ja)
        _assert_no_failure(pa)
        assert _steps(pa) == _steps(ja)
        assert [m.algo_name for m in pa.leaderboard.models].count("stackedensemble") == 2
        _assert_leaderboards_agree(ja, pa)
        # the target encoder of the run, and every model carrying it
        jte, pte = ja._te_model, pa._te_model
        for name, (dom, num, den) in jte.encodings.items():
            assert pte.encodings[name][0] == dom
            np.testing.assert_array_equal(pte.encodings[name][1], num)
            np.testing.assert_array_equal(pte.encodings[name][2], den)
        assert all(m.preprocessors == [pte] and m.device == torch.device("cpu")
                   for m in pa.leaderboard.models)

        # the JAX leader carried across, with its encoder, scores a raw frame
        carried_te = target_encoder_from_numpy(
            jte.encodings, jte.prior_mean, jte.fold,
            dataclasses.asdict(jte.params), dataclasses.asdict(jte.data_info),
            device="cpu")
        jse = next(m for m in ja.leaderboard.models if m.algo_name == "stackedensemble")
        pby = {m.algo_name: m for m in pa.leaderboard.models}
        bases = [_carry(bm, pby[bm.algo_name]) for bm in jse.base_models]
        meta = _carry(jse.metalearner, None)
        sparams = {k: v for k, v in dataclasses.asdict(jse.params).items()
                   if k != "base_models"}
        carried = stacked_ensemble_from_models(
            bases, meta, jse.levelone_names, dataclasses.asdict(jse.data_info),
            sparams, device="cpu")
        carried.preprocessors = [carried_te]
        raw = _rule(150, 9)
        np.testing.assert_allclose(
            carried.predict(ht.Frame.from_dict(raw)).col("pp").data,
            jse.predict(JFrame.from_dict(raw)).col("pp").data, rtol=0, atol=1e-6)
        with pytest.raises(ValueError, match="level-one"):
            stacked_ensemble_from_models(bases[:1], meta, jse.levelone_names,
                                         dataclasses.asdict(jse.data_info), sparams,
                                         device="cpu")

        # the budget cases of tests/test_automl.py
        small = _rule(200, 10)
        js, ps = JFrame.from_dict(small), ht.Frame.from_dict(small)
        for case, x in ((dict(max_models=3, nfolds=2, seed=3,
                              exclude_algos=["xgboost", "deeplearning",
                                             "stackedensemble", "drf", "gbm"]), None),
                        (dict(max_models=1, nfolds=2, seed=5, include_algos=["glm"]),
                         ["x0", "x1"])):
            jb = JAutoML(**case)
            jlead = jb.train(y="y", training_frame=js, x=x)
            pb = ht.AutoML(device="cpu", **case)
            plead = pb.train(y="y", training_frame=ps, x=x)
            assert _steps(pb) == _steps(jb)
            assert ({m.algo_name for m in pb.leaderboard.models}
                    == {m.algo_name for m in jb.leaderboard.models} == {"glm"})
            assert (plead.data_info.predictor_names == jlead.data_info.predictor_names)
        outcome = []
        for cls, fr, extra in ((JAutoML, js, {}), (ht.AutoML, ps, {"device": "cpu"})):
            a = cls(max_models=0, max_runtime_secs=0.001, nfolds=2, seed=6,
                    include_algos=["glm", "gbm", "drf"], **extra)
            try:
                a.train(y="y", training_frame=fr)
            except RuntimeError as e:
                assert "built no models" in str(e)
            logs = [e["message"] for e in a.event_log.events]
            assert any(m.startswith("time budget exhausted before") for m in logs), logs
            outcome.append(len(a.leaderboard.models) <= 1)
        assert outcome == [True, True]
    jax.clear_caches()


def test_automl_default_plan_runs_on_the_port(tmp_path):
    d = _strong(200, 12)
    del d["g"]
    frame = ht.Frame.from_dict(d)
    with ht.use_device("cpu"):
        aml = ht.AutoML(max_models=10, nfolds=2, seed=2,
                        preprocessing=["target_encoding"])
        leader = aml.train(y="y", training_frame=frame)
    _assert_no_failure(aml)
    steps = [s for _, s in _steps(aml) if s.startswith("step ")]
    assert steps == [f"step {s} starting" for s in (
        "xgboost_def_1", "glm_def_1", "drf_def_1", "gbm_def_1", "gbm_def_2",
        "deeplearning_def_1", "xgboost_def_2", "gbm_grid_1", "exploitation",
        "stackedensemble_best_of_family", "stackedensemble_all")]
    algos = [m.algo_name for m in aml.leaderboard.models]
    assert {"xgboost", "glm", "drf", "gbm", "deeplearning"} <= set(algos)
    assert algos.count("stackedensemble") == 2
    assert all(m.device == torch.device("cpu") for m in aml.leaderboard.models)
    metrics = [pgrid.metric_value(m)[0] for m in aml.leaderboard.models]
    assert metrics == sorted(metrics, reverse=True) and metrics[0] > 0.7
    # the leader scores a raw frame through its encoder, as the encoded one
    raw = ht.Frame.from_dict(_strong(100, 13))
    encoded = aml._te_model.transform(raw)
    want = leader.predict(encoded).col("pyes").data
    np.testing.assert_array_equal(leader.predict(raw).col("pyes").data, want)
    # and the leader, its encoder and every nested model survive save/load
    path = ppersist.save_model(leader, str(tmp_path / "leader.bin"))
    back = ppersist.load_model(path, device="cpu")
    assert back.preprocessors[0].encodings.keys() == aml._te_model.encodings.keys()
    np.testing.assert_array_equal(back.predict(raw).col("pyes").data, want)
    assert list(algo_map()) == ["coxph", "deeplearning", "drf", "glm", "glrm", "kmeans",
                              "naivebayes", "pca", "svd", "gbm", "isolationforest",
                              "extendedisolationforest", "aggregator", "word2vec",
                              "stackedensemble", "psvm", "gam", "rulefit", "generic",
                              "xgboost", "targetencoder"]
