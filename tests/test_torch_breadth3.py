"""Parity: the PyTorch port's Aggregator, RuleFit, Generic, Assembly,
ScoringPipeline and segment models (``h2o3_tpu_torch/models/``) against
the JAX package, on the CPU.

Each test builds its data from ``np.random.default_rng`` in numpy, runs
the JAX package and the port on the same data, and holds:

- Aggregator, for each transform, with a categorical and with batches
  smaller than the frame: the exemplar rows, counts and radius equal (host
  numpy in both, on the bit-equal float32 design), the output frame too;
- RuleFit with GBM and DRF rule ensembles and the ``linear`` model type:
  the rules (feature, threshold, direction, NA direction) and their
  supports equal, the LASSO's coefficients rtol 1e-4 / atol 1e-6 (the
  GLM's tolerance), the predictions atol 1e-5, the importance table as a
  mapping from variable to coefficient at the GLM's tolerance (its order
  follows |coefficient|, which a rounding may swap). The fixture's
  response depends on x0 and x1 with well separated split gains, so no
  tree meets a mirror-image tie (ROADMAP C2). A JAX RuleFit carried across
  by ``convert.rulefit_from_numpy`` predicts as the JAX model does
  (atol 1e-6), and the inner fits run on the RuleFit's device;
- Generic: a MOJO written by the JAX package, imported by both packages,
  predicts bit for bit alike; the JAX package's errors;
- Assembly: outputs bit for bit and the ``to_java`` text equal;
- ScoringPipeline: each package's ``from_bytes`` reads the other's
  artifact, ``transform`` gives the same bits from the same artifact, and
  the port's pipeline scores as its model on the assembled frame; a
  transform-only pipeline equals ``Assembly.fit``;
- segment models: the segments (a categorical with its NA segment, a
  numeric column with NaN), the results frame and each segment's trees
  equal (the same nodes split on the same feature, bin and NA direction,
  leaves rtol 1e-4 / atol 1e-5; an unsplit node's unused candidate is not
  compared), with ``parallelism=2`` giving the serial run's trees bit for
  bit, every node.

Each model is also saved and loaded by the port with the same bits and
bytes, looked up in ``algo_map``, and its parameter errors are the JAX
package's.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from h2o3_tpu import Frame as JFrame
from h2o3_tpu.frame.frame import ColType as JColType, Column as JColumn
from h2o3_tpu.keyed import DKV as JDKV
from h2o3_tpu.models import assembly as jasm, pipeline as jpipe
from h2o3_tpu.models.aggregator import Aggregator as JAggregator
from h2o3_tpu.models.framework import Job as JJob
from h2o3_tpu.models.generic import Generic as JGeneric, import_mojo as j_import_mojo
from h2o3_tpu.models.pca import PCA as JPCA
from h2o3_tpu.models.rulefit import RuleFit as JRuleFit
from h2o3_tpu.models.segments import SegmentModelsBuilder as JSegmentModelsBuilder
from h2o3_tpu.models.tree.gbm import GBM as JGBM, GBMParameters as JGBMParameters
import h2o3_tpu_torch as ht
from h2o3_tpu_torch import convert
from h2o3_tpu_torch.api.registry import algo_map
from h2o3_tpu_torch.frame.frame import ColType, Column
from h2o3_tpu_torch.keyed import DKV as PDKV
from h2o3_tpu_torch.models import assembly as pasm, persist as ppersist, pipeline as ppipe
from h2o3_tpu_torch.models.generic import import_mojo as p_import_mojo
from h2o3_tpu_torch.models.segments import SegmentModelsBuilder as PSegmentModelsBuilder
from h2o3_tpu_torch.models.tree.gbm import GBMParameters as PGBMParameters

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


def _assert_frames_equal(jf, pf, skip=()):
    assert pf.names == jf.names
    for jc, pc in zip(jf.columns, pf.columns):
        if jc.name in skip:
            continue
        assert pc.type.name == jc.type.name and pc.domain == jc.domain, jc.name
        np.testing.assert_array_equal(pc.data, jc.data, err_msg=jc.name)


def _check_errors(jb, pb, jfr, pfr, cases):
    for kw in cases:
        with pytest.raises(ValueError) as jerr:
            jb(**kw).train(jfr)
        with pytest.raises(ValueError) as perr:
            pb(device="cpu", **kw).train(pfr)
        assert str(perr.value) == str(jerr.value), kw


def _check_persist(pm, score, tmp_path, label):
    path = ppersist.save_model(pm, tmp_path / f"{label}.bin")
    loaded = ppersist.load_model(path, register=False, device="cpu")
    assert type(loaded) is type(pm) and loaded.device == torch.device("cpu")
    for a, b in zip(score(loaded), score(pm)):
        np.testing.assert_array_equal(a, b, err_msg=label)
    assert ppersist.dumps_model(loaded) == ppersist.dumps_model(pm), label
    builder, params = algo_map()[pm.algo_name]
    assert builder.algo_name == pm.algo_name and type(pm.params) is params


def _assert_trees_equal(jm, pm):
    """The same nodes split, each on the same feature, bin and NA
    direction, and the leaves at the fit tolerance. A node left unsplit
    keeps a candidate that no row reads, which may differ at a tie of
    gains nobody takes, so candidates are compared where a node splits."""
    for jt, pt in zip(jm.booster.trees_per_class, pm.booster.trees_per_class, strict=True):
        np.testing.assert_array_equal(pt.edges, jt.edges)
        split = np.stack(jt.is_split)
        np.testing.assert_array_equal(np.stack(pt.is_split), split)
        for f in ("feat", "split_bin", "default_left"):
            np.testing.assert_array_equal(np.stack(getattr(pt, f))[split],
                                          np.stack(getattr(jt, f))[split], err_msg=f)
        np.testing.assert_allclose(np.stack(pt.leaf), np.stack(jt.leaf), rtol=1e-4, atol=1e-5)


def _rule_data(rng, n):
    X = rng.normal(size=(n, 4))
    X[rng.random(n) < 0.05, 2] = np.nan
    logit = 2.0 * X[:, 0] - 1.2 * X[:, 1] + 0.6 * (X[:, 0] > 0.5) + rng.normal(size=n) * 0.4
    g = rng.integers(0, 3, n)
    cols = [(f"x{i}", X[:, i], None) for i in range(4)] + [("g", g, ["a", "b", "c"])]
    return cols, logit


def test_aggregator_and_rulefit_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    cols, logit = _rule_data(rng, 500)
    agg_j, agg_p = _frames(cols)
    with _jax_keys_removed():
        for kw in (dict(target_num_exemplars=40), dict(target_num_exemplars=60, batch_size=128),
                   dict(target_num_exemplars=30, transform="standardize"),
                   dict(target_num_exemplars=50, transform="none", rel_tol_num_exemplars=0.2,
                        ignored_columns=["g"]),
                   dict(target_num_exemplars=1000)):
            jm = JAggregator(**kw).train(agg_j)
            pm = ht.Aggregator(device="cpu", **kw).train(agg_p)
            np.testing.assert_array_equal(pm.exemplar_rows, jm.exemplar_rows, err_msg=str(kw))
            np.testing.assert_array_equal(pm.counts, jm.counts, err_msg=str(kw))
            assert pm.radius == jm.radius and pm.counts.sum() == 500
            _assert_frames_equal(jm.output_frame, pm.output_frame)
            assert pm.output_frame.names == agg_p.names + ["counts"]
            if kw["target_num_exemplars"] < 500:
                assert len(pm.exemplar_rows) <= kw["target_num_exemplars"] * (
                    1 + kw.get("rel_tol_num_exemplars", 0.5)) and pm.radius > 0
        with pytest.raises(NotImplementedError) as jerr:
            jm.predict(agg_j)
        with pytest.raises(NotImplementedError) as perr:
            pm.predict(agg_p)
        assert str(perr.value) == str(jerr.value)
        _check_persist(pm, lambda m: [m.exemplar_rows, m.counts, m.output_frame.col(0).data],
                       tmp_path, "aggregator")
        _check_errors(JAggregator, ht.Aggregator, agg_j, agg_p,
                      [dict(weights_column="x0"), dict(nfolds=1)])

        # RuleFit: GBM and DRF rules, and the linear model alone. With a
        # categorical predictor the linear terms index past the tree
        # matrix (one column per predictor, one coefficient per level) in
        # both packages, so the fits below leave g out
        yb = (logit > 0).astype(np.int32)
        jcat, pcat = _frames(cols + [("y", yb, ["n", "p"])])
        with pytest.raises(IndexError) as jerr:
            JRuleFit(response_column="y", model_type="linear").train(jcat)
        with pytest.raises(IndexError) as perr:
            ht.RuleFit(response_column="y", model_type="linear", device="cpu").train(pcat)
        assert str(perr.value) == str(jerr.value)
        jfr, pfr = _frames(cols[:4] + [("y", yb, ["n", "p"])])
        rf_cases = [
            dict(response_column="y", rule_generation_ntrees=8, seed=1),
            dict(response_column="y", algorithm="drf", min_rule_length=1, max_rule_length=2,
                 rule_generation_ntrees=6, seed=2),
            dict(response_column="y", model_type="linear", seed=1),
            dict(response_column="y", model_type="rules", rule_generation_ntrees=4,
                 max_num_rules=5, seed=4, lambda_=0.01),
        ]
        for kw in rf_cases:
            jm = JRuleFit(**kw).train(jfr)
            with ht.use_device("cpu"):
                pm = ht.RuleFit(**kw).train(pfr)
            label = str(kw)
            assert pm.device == torch.device("cpu") and pm.glm.device == torch.device("cpu")
            assert [r.key() for r in pm.rules] == [r.key() for r in jm.rules], label
            assert [r.describe() for r in pm.rules] == [r.describe() for r in jm.rules]
            assert [r.support for r in pm.rules] == [r.support for r in jm.rules], label
            if kw.get("model_type") != "linear":
                assert len(pm.rules) > 4
            np.testing.assert_array_equal(pm.winsor[0], jm.winsor[0])
            np.testing.assert_array_equal(pm.winsor[1], jm.winsor[1])
            assert pm.linear_names == jm.linear_names
            jc, pc = jm.glm.coefficients, pm.glm.coefficients
            assert list(pc) == list(jc), label
            np.testing.assert_allclose([pc[k] for k in jc], [jc[k] for k in jc],
                                       rtol=1e-4, atol=1e-6, err_msg=label)
            np.testing.assert_allclose([r.coefficient for r in pm.rules],
                                       [r.coefficient for r in jm.rules], rtol=1e-4, atol=1e-6)
            jimp = {d["variable"]: d["coefficient"] for d in jm.rule_importance}
            pimp = {d["variable"]: d["coefficient"] for d in pm.rule_importance}
            if kw.get("max_num_rules", -1) < 0:
                names = sorted(set(jimp) | set(pimp))
                np.testing.assert_allclose([pimp.get(v, 0.0) for v in names],
                                           [jimp.get(v, 0.0) for v in names],
                                           rtol=1e-4, atol=1e-6, err_msg=label)
            else:
                assert len(pimp) == len(jimp) == kw["max_num_rules"]
            assert {d["variable"]: d["rule"] for d in pm.rule_importance if d["variable"] in jimp} \
                == {d["variable"]: d["rule"] for d in jm.rule_importance if d["variable"] in pimp}
            np.testing.assert_allclose(pm._predict_raw(pfr), jm._predict_raw(jfr),
                                       rtol=0, atol=1e-5, err_msg=label)
            assert abs(pm.training_metrics.auc - jm.training_metrics.auc) <= 1e-4

            # the JAX model carried across
            carried = convert.rulefit_from_numpy(
                {"rules": [dataclasses.asdict(r) for r in jm.rules],
                 "linear_names": jm.linear_names, "winsor_lo": jm.winsor[0],
                 "winsor_hi": jm.winsor[1],
                 "glm": {"arrays": {"beta_std": jm.glm.beta_std,
                                    "coefficients": jm.glm.coefficients},
                         "data_info": dataclasses.asdict(jm.glm.data_info),
                         "params": dataclasses.asdict(jm.glm.params)}},
                dataclasses.asdict(jm.data_info), dataclasses.asdict(jm.params), device="cpu")
            np.testing.assert_allclose(carried._predict_raw(pfr), jm._predict_raw(jfr),
                                       rtol=0, atol=1e-6, err_msg=label)
            assert carried.rule_importance == jm.rule_importance
            assert [r.coefficient for r in carried.rules] == [r.coefficient for r in jm.rules]
            _check_persist(pm, lambda m: [m._predict_raw(pfr)], tmp_path, "rulefit")
        with pytest.raises(ValueError, match="winsor_lo"):
            convert.rulefit_from_numpy(
                {"rules": [], "linear_names": jm.linear_names, "winsor_lo": jm.winsor[0][:2],
                 "winsor_hi": jm.winsor[1], "glm": None},
                dataclasses.asdict(jm.data_info), dataclasses.asdict(jm.params), device="cpu")
        # every inner fit of a RuleFit asked for the CPU ran on the CPU
        inner = [v for k, v in PDKV._store.items() if k.startswith(("gbm_", "drf_"))]
        assert inner and all(m.device == torch.device("cpu") for m in inner)
        _check_errors(JRuleFit, ht.RuleFit, jfr, pfr,
                      [dict(response_column="y", min_rule_length=4, max_rule_length=3),
                       dict(response_column="y", model_type="trees"),
                       dict(response_column="nope"),
                       dict(response_column="y", offset_column="x0")])


def test_generic_assembly_pipeline_and_segments_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    n = 400
    X = rng.normal(size=(n, 3))
    dist = np.exp(rng.normal(6.0, 0.5, n))
    dep = rng.integers(0, 24, n) * 100.0
    arr = (dep + 100 + rng.integers(0, 300, n)) % 2400
    carrier = rng.integers(-1, 4, n)  # -1: NA
    late = (X[:, 0] + 0.002 * (arr - dep) / 100 + 0.3 * (carrier == 1)
            + rng.normal(size=n) * 0.5 > 0).astype(np.int32)
    raw_cols = [("Distance", dist, None), ("CRSDepTime", dep, None), ("CRSArrTime", arr, None),
                ("x0", X[:, 0], None), ("x1", X[:, 1], None),
                ("UniqueCarrier", carrier, ["AA", "DL", "UA", "WN"]),
                ("IsDepDelayed", late, ["NO", "YES"])]
    raw_j, raw_p = _frames(raw_cols)
    steps = [
        {"op": "ColOp", "fun": "log1p", "col": "Distance"},
        {"op": "BinaryOp", "fun": "-", "left": "CRSArrTime", "right": "CRSDepTime",
         "new_col_name": "Block"},
        {"op": "BinaryOp", "fun": "/", "left": "x1", "right": 3.0},
        {"op": "ColOp", "fun": "sign", "col": "x0", "inplace": True},
        {"op": "ColSelect", "cols": ["log1p_Distance", "Block", "x0", "x1_/", "UniqueCarrier",
                                     "IsDepDelayed"]},
    ]
    with _jax_keys_removed():
        # Assembly
        jasm_m, jout = jasm.fit_assembly(steps, raw_j)
        pasm_m, pout = pasm.fit_assembly(steps, raw_p)
        _assert_frames_equal(jout, pout)
        assert PDKV.get(pasm_m.key) is pasm_m and pasm_m.out_names == jasm_m.out_names
        assert pasm_m.to_java("Munger") == jasm_m.to_java("Munger")
        assert pasm_m.to_java("Munger").count("out[") == len(pout.names)
        for bad in ([{"op": "Nope"}], [{"op": "ColOp", "fun": "tan", "col": "x0"}],
                    [{"op": "BinaryOp", "fun": "%", "left": "x0", "right": 1}],
                    [{"op": "ColSelect", "cols": ["x9"]}]):
            with pytest.raises(ValueError) as jerr:
                jasm.Assembly(steps=bad).fit(raw_j)
            with pytest.raises(ValueError) as perr:
                pasm.Assembly(steps=bad).fit(raw_p)
            assert str(perr.value) == str(jerr.value)
        with pytest.raises(ValueError, match="fit before"):
            pasm.Assembly(steps=steps).to_java("M")

        # Generic: a MOJO the JAX package wrote, imported by both packages
        kw = dict(ntrees=4, max_depth=3, response_column="IsDepDelayed", seed=1)
        jgbm = JGBM(**kw).train(jout)
        pgbm = ht.GBM(device="cpu", **kw).train(pout)
        _assert_trees_equal(jgbm, pgbm)
        jmojo = str(tmp_path / "j.mojo")
        jgbm.download_mojo(jmojo)
        jg = j_import_mojo(jmojo, model_id="imported_j")
        pg = p_import_mojo(jmojo, model_id="imported_p", device="cpu")
        assert pg.key == "imported_p" and PDKV.get("imported_p") is pg
        assert pg.source_algo == "gbm" and pg.device == torch.device("cpu")
        assert dataclasses.asdict(pg.data_info) == dataclasses.asdict(jg.data_info)
        _assert_frames_equal(jg.predict(jout), pg.predict(pout))
        np.testing.assert_array_equal(pg._predict_raw(pout), jg._predict_raw(jout))
        np.testing.assert_allclose(pg._predict_raw(pout), pgbm._predict_raw(pout), rtol=1e-4,
                                   atol=1e-5)
        assert abs(pg.model_performance(pout).auc - jg.model_performance(jout).auc) == 0
        with pytest.raises(NotImplementedError):
            pg.variable_importances()
        _check_persist(pg, lambda m: [m._predict_raw(pout)], tmp_path, "generic")
        for bad in (dict(path=jmojo, nfolds=2), dict(path=None), dict(path=jmojo, nfolds=1),
                    dict(path=jmojo, weights_column="w")):
            with pytest.raises(ValueError) as jerr:
                JGeneric(**bad).train()
            with pytest.raises(ValueError) as perr:
                ht.Generic(device="cpu", **bad).train()
            assert str(perr.value) == str(jerr.value), bad

        # ScoringPipeline: each package reads the other's artifact
        jp = jpipe.build_pipeline(jgbm, jasm_m)
        pp = ppipe.build_pipeline(pgbm, pasm_m)
        assert PDKV.get(pp.key) is pp
        assert pp.in_names == jp.in_names and pp.steps == jp.steps
        assert "IsDepDelayed" in pp.in_names  # the ColSelect step reads it
        for data in (jp.to_bytes(), pp.to_bytes()):
            a, b = jpipe.ScoringPipeline.from_bytes(data), ppipe.ScoringPipeline.from_bytes(data)
            assert (b.steps, b.in_names, b.mojo_bytes) == (a.steps, a.in_names, a.mojo_bytes)
            _assert_frames_equal(a.transform(raw_j), b.transform(raw_p))
        pp.save(str(tmp_path / "pipe.zip"))
        back = ppipe.ScoringPipeline.load(str(tmp_path / "pipe.zip"))
        got = back.transform(raw_p)
        want = pgbm.predict(pasm.Assembly(steps=steps).fit(raw_p))
        assert got.names == want.names
        np.testing.assert_array_equal(got.col("predict").data, want.col("predict").data)
        for c in ("pNO", "pYES"):
            np.testing.assert_allclose(got.col(c).data, want.col(c).data, rtol=1e-4, atol=1e-5)
        only = ppipe.build_pipeline(assembly=pasm_m)
        _assert_frames_equal(pasm.Assembly(steps=steps).fit(raw_p),
                             ppipe.ScoringPipeline.from_bytes(only.to_bytes()).transform(raw_p))
        for pkg, fr in ((jpipe, raw_j), (ppipe, raw_p)):
            with pytest.raises(ValueError, match="missing a column: Distance"):
                pkg.ScoringPipeline.from_bytes(jp.to_bytes()).transform(fr.cols(["x0"]))
            with pytest.raises(ValueError, match="model, an assembly, or both"):
                pkg.ScoringPipeline.from_parts()
            with pytest.raises(ValueError, match="no model"):
                pkg.ScoringPipeline.from_bytes(only.to_bytes())._genmodel()
        # a PCA model's [N, k] output stays k numeric columns
        num_j, num_p = jout.cols(["log1p_Distance", "Block", "x1_/"]), pout.cols(
            ["log1p_Distance", "Block", "x1_/"])
        jpca = JPCA(k=2, seed=1).train(num_j)
        ppca = ht.PCA(k=2, seed=1, device="cpu").train(num_p)
        for data in (jpipe.build_pipeline(jpca).to_bytes(), ppipe.build_pipeline(ppca).to_bytes()):
            a = jpipe.ScoringPipeline.from_bytes(data).transform(num_j)
            b = ppipe.ScoringPipeline.from_bytes(data).transform(num_p)
            assert b.ncols == 2 and all(c.type is ColType.NUM for c in b.columns)
            _assert_frames_equal(a, b)

        # segment models: a categorical with its NA segment, a numeric
        # segment column with NaN; segments of 200 rows whose response
        # follows x0 and x1 (well separated split gains, no C2 tie)
        m = 1200
        Xs = rng.normal(size=(m, 3))
        carrier = np.repeat([0, 1, -1], m // 3)
        hub = np.tile([0.0, np.nan], m // 2)
        ys = (1.5 * Xs[:, 0] - Xs[:, 1] + 0.5 * (carrier == 1) + rng.normal(size=m) * 0.5
              > 0).astype(np.int32)
        seg_j, seg_p = _frames([(f"x{i}", Xs[:, i], None) for i in range(3)]
                               + [("UniqueCarrier", carrier, ["AA", "DL", "UA"]),
                                  ("hub", hub, None), ("IsDepDelayed", ys, ["NO", "YES"])])
        kw = dict(ntrees=3, max_depth=3, response_column="IsDepDelayed", seed=7)
        jres = JSegmentModelsBuilder(JGBM, JGBMParameters(**kw), ["UniqueCarrier", "hub"]
                                     ).train(seg_j)
        with ht.use_device("cpu"):  # the worker threads get the caller's device
            pres = [PSegmentModelsBuilder(ht.GBM, PGBMParameters(**kw), ["UniqueCarrier", "hub"],
                                          parallelism=par).train(seg_p) for par in (1, 2)]
        for res in pres:
            assert res.segments == jres.segments and res.errors == jres.errors
            assert len(res.segments) == 6 and all(e is None for e in res.errors)
            assert {s["UniqueCarrier"] for s in res.segments} == {"AA", "DL", None}
            assert {s["hub"] for s in res.segments} == {0.0, None}
            jf, pf = jres.as_frame(), res.as_frame()
            _assert_frames_equal(jf, pf, skip=("model",))
            assert pf.col("model").domain == [m.key for m in res.models]
            for seg, jm, pm in zip(res.segments, jres.models, res.models):
                assert pm.device == torch.device("cpu")
                assert set(pm.params.ignored_columns) == {"UniqueCarrier", "hub"}
                _assert_trees_equal(jm, pm)
                assert res.model_for(**seg) is pm
        for a, b in zip(pres[0].models, pres[1].models):  # threads: the serial bits
            for ta, tb in zip(a.booster.trees_per_class, b.booster.trees_per_class):
                for f in ("feat", "split_bin", "default_left", "is_split", "leaf"):
                    np.testing.assert_array_equal(np.stack(getattr(ta, f)),
                                                  np.stack(getattr(tb, f)))
        assert pres[0].model_for(UniqueCarrier="ZZ") is None
        assert "6/6 succeeded" in repr(pres[1])
        # a segment whose fit fails records the JAX package's error
        bad = dict(kw, weights_column="nope")
        jbad = JSegmentModelsBuilder(JGBM, JGBMParameters(**bad), ["UniqueCarrier"]).train(seg_j)
        pbad = PSegmentModelsBuilder(ht.GBM, PGBMParameters(device="cpu", **bad),
                                     ["UniqueCarrier"]).train(seg_p)
        assert pbad.errors == jbad.errors and all(pbad.errors)
        _assert_frames_equal(jbad.as_frame(), pbad.as_frame(), skip=("model",))
        with pytest.raises(ValueError, match="non-empty"):
            PSegmentModelsBuilder(ht.GBM, PGBMParameters(**kw), [])
