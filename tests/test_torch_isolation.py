"""The PyTorch port stands alone: ``h2o3_tpu_torch`` and ``chip_smoke.py``
import neither ``jax`` nor ``optax`` (an H100 host without JAX has no
optax; the port keeps its own copy of the updates DeepLearning uses, in
``util/optim.py``) nor anything of ``h2o3_tpu``, its MOJO scorer
``h2o3_tpu_torch.genmodel`` imports numpy and not even ``torch``, and the
port's entry points refuse to run quietly on the CPU when no card is
present. The port's algorithm registry equals the JAX package's, key for
key and in its order (read from its source, so this file imports no JAX).

Mind the prefix: ``h2o3_tpu_torch`` starts with ``h2o3_tpu``, so the
import check matches ``h2o3_tpu`` only when a ``.``, a space or the end of
the name follows it.
"""

import ast
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import h2o3_tpu_torch as ht

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = re.compile(r"^(jax|jaxlib|optax|h2o3_tpu)(\.|\s|$)")


def _port_files():
    files = sorted((ROOT / "h2o3_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            yield ("." * node.level) + (node.module or "")
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_no_jax_or_reference_imports_in_the_port():
    # the matcher minds the prefix
    for bad in ("jax", "jax.numpy", "h2o3_tpu", "h2o3_tpu.ops.histogram", "jaxlib",
                "optax", "optax.schedules"):
        assert FORBIDDEN.match(bad), bad
    for ok in ("h2o3_tpu_torch", "h2o3_tpu_torch.ops", "jaxtyping", "torch",
               "optaxx", "h2o3_tpu_torch.util.optim"):
        assert not FORBIDDEN.match(ok), ok
    files = _port_files()
    assert len(files) > 10
    names = {str(p.relative_to(ROOT)) for p in files}
    for module in ("util/jrandom.py", "ops/cuda_sorted_histogram.py",
                   "ops/cuda_build.py", "models/tree/drf.py", "models/glm.py",
                   "models/deeplearning.py", "util/optim.py", "automl/automl.py",
                   "models/grid.py", "models/stacked_ensemble.py",
                   "models/target_encoder.py", "api/registry.py",
                   "models/naive_bayes.py", "models/kmeans.py", "models/pca.py",
                   "models/isolation_forest.py", "models/ext_isolation_forest.py",
                   "models/glrm.py", "models/gam.py", "models/coxph.py",
                   "models/psvm.py", "models/word2vec.py", "models/aggregator.py",
                   "models/rulefit.py", "models/generic.py", "models/assembly.py",
                   "models/pipeline.py", "models/segments.py", "models/mojo_ref.py",
                   "compute/mapreduce.py", "compute/quantile.py", "frame/rollups.py",
                   "rapids/runtime.py", "rapids/fusion.py", "rapids/dist.py",
                   "rapids/merge.py", "rapids/groupby.py", "rapids/prims/mungers.py",
                   "rapids/prims/matrix.py", "rapids/prims/search.py",
                   "rapids/prims/strings.py", "rapids/prims/times.py",
                   "rapids/prims/advmath.py", "rapids/prims/models.py"):
        assert f"h2o3_tpu_torch/{module}" in names, module
    bad = [(str(p.relative_to(ROOT)), m) for p in files
           for m in _imported_modules(p) if FORBIDDEN.match(m)]
    assert not bad, bad

    # algo_map: the JAX package's keys (its source's return dict, in
    # RegisterAlgos.java order), every one of them
    from h2o3_tpu_torch.api.registry import algo_map

    tree = ast.parse((ROOT / "h2o3_tpu" / "api" / "registry.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "algo_map")
    ret = next(n for n in ast.walk(fn) if isinstance(n, ast.Return))
    jax_keys = [k.value for k in ret.value.keys]
    port = algo_map()
    assert list(port) == jax_keys and len(jax_keys) == 21
    for key in ("glrm", "kmeans", "naivebayes", "pca", "svd", "isolationforest",
                "extendedisolationforest", "coxph", "word2vec", "psvm", "gam",
                "aggregator", "rulefit", "generic"):
        builder, params = port[key]
        assert builder.__module__.startswith("h2o3_tpu_torch.models.")
        assert builder(params()).algo_name == key

    # the entry points refuse the CPU unless asked (last: it skips where a
    # card is present)
    # use_device nests and restores
    with ht.use_device("cpu") as dev:
        assert ht.resolve_device() == dev == torch.device("cpu")
        with ht.use_device("cpu"):
            assert ht.resolve_device().type == "cpu"
        assert ht.resolve_device().type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    fr = ht.Frame.from_dict({"a": np.arange(20.0), "y": np.arange(20.0) % 3})
    with pytest.raises(RuntimeError, match="CUDA"):
        ht.XGBoost(ntrees=1, response_column="y").train(fr)
    with pytest.raises(RuntimeError, match="CUDA"):
        ht.GBM(ntrees=1, response_column="y").train(fr)
    with pytest.raises(RuntimeError, match="CUDA"):
        ht.DRF(ntrees=1, response_column="y").train(fr)
    with pytest.raises(RuntimeError, match="CUDA"):
        ht.GLM(response_column="y").train(fr)
    with pytest.raises(RuntimeError, match="CUDA"):
        ht.DeepLearning(hidden=[2], epochs=1, response_column="y").train(fr)
    with pytest.raises(RuntimeError, match="CUDA"):
        ht.resolve_device("cuda")
    for builder in (ht.KMeans(k=2), ht.PCA(k=1), ht.SVD(nv=1), ht.GLRM(k=1),
                    ht.NaiveBayes(response_column="y"), ht.IsolationForest(ntrees=1),
                    ht.ExtendedIsolationForest(ntrees=1),
                    ht.GAM(response_column="y", gam_columns=["a"]),
                    ht.CoxPH(response_column="y", stop_column="a"),
                    ht.PSVM(response_column="y"), ht.Aggregator(),
                    ht.RuleFit(response_column="y")):
        with pytest.raises(RuntimeError, match="CUDA"):
            builder.train(fr)
    words = ht.Frame([ht.Column("w", np.array(["a", "b", None] * 4, dtype=object),
                                ht.ColType.STR)])
    with pytest.raises(RuntimeError, match="CUDA"):
        ht.Word2Vec(min_word_freq=1).train(words)
    with pytest.raises(RuntimeError, match="CUDA"):
        ht.Generic(path="model.mojo").train()
    with pytest.raises(RuntimeError, match="CUDA"):
        ht.SegmentModelsBuilder(ht.GBM, ht.GBM(response_column="y").params, ["a"]).train(fr)
    from h2o3_tpu_torch.entry import entry

    with pytest.raises(RuntimeError, match="CUDA"):
        entry()
    from h2o3_tpu_torch.rapids import Session, exec_rapids

    with pytest.raises(RuntimeError, match="CUDA"):
        Session()
    with pytest.raises(RuntimeError, match="CUDA"):
        exec_rapids("(+ 1 2)")
    assert Session(device="cpu").device.type == "cpu"
    with ht.use_device("cpu"):
        assert exec_rapids("(+ 1 2)").value == 3.0
    m = ht.GBM(ntrees=1, max_depth=2, response_column="y", device="cpu").train(fr)
    assert m.device == torch.device("cpu")
    for builder in (ht.GLM(response_column="y", device="cpu"),
                    ht.DeepLearning(hidden=[2], epochs=1, response_column="y",
                                    device="cpu")):
        assert builder.train(fr).device == torch.device("cpu")
    with pytest.raises(RuntimeError):
        ht.resolve_device()
    # the AutoML slice resolves its device where a run starts
    cat = fr.add_column(ht.Column("c", np.arange(20) % 4, ht.ColType.CAT,
                                  ["a", "b", "c", "d"]))
    with pytest.raises(RuntimeError, match="CUDA"):
        ht.AutoML(max_models=1, include_algos=["glm"]).train(y="y", training_frame=fr)
    with pytest.raises(RuntimeError, match="CUDA"):
        ht.TargetEncoder(response_column="y").train(cat)
    with pytest.raises(RuntimeError, match="CUDA"):
        ht.GridSearch(ht.GBM, ht.GBM(ntrees=1, response_column="y").params,
                      {"max_depth": [2, 3]}).train(fr)
    base = ht.GBM(ntrees=1, max_depth=2, response_column="y", nfolds=2, device="cpu",
                  keep_cross_validation_predictions=True).train(fr)
    with pytest.raises(RuntimeError, match="CUDA"):
        ht.StackedEnsemble(base_models=[base], response_column="y").train(fr)
    assert ht.TargetEncoder(response_column="y", device="cpu").train(cat).device.type == "cpu"


def test_port_runs_with_jax_and_reference_blocked():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["optax"] = None
        sys.modules["h2o3_tpu"] = None
        import numpy as np
        import torch
        torch.set_num_threads(1)
        import h2o3_tpu_torch as ht
        rng = np.random.default_rng(0)
        X = rng.normal(size=(300, 3))
        fr = ht.Frame.from_dict({"a": X[:, 0], "b": X[:, 1], "c": X[:, 2],
                                 "y": np.where(X[:, 0] > 0, "p", "q")})
        with ht.use_device("cpu"):
            m = ht.XGBoost(ntrees=2, max_depth=2, response_column="y",
                           seed=1).train(fr)
            m.predict(fr)
            # sampled, and wide enough for the sorted kernel's plain version
            f = ht.DRF(ntrees=2, max_depth=8, response_column="y", seed=1,
                       hist_impl="kernel").train(fr)
            f.predict(fr)
            g = ht.GLM(family="binomial", response_column="y").train(fr)
            g.predict(fr)
            g2 = ht.GLM(family="binomial", solver="lbfgs", lambda_=1e-3, alpha=0,
                        response_column="y").train(fr)
            d = ht.DeepLearning(hidden=[4], epochs=2, mini_batch_size=32, seed=1,
                                input_dropout_ratio=0.1, response_column="y").train(fr)
            d.predict(fr)
            s = ht.DeepLearning(hidden=[4], epochs=1, mini_batch_size=32, seed=1,
                                adaptive_rate=False, momentum_start=0.5,
                                momentum_stable=0.9, response_column="y").train(fr)
            aml = ht.AutoML(max_models=2, nfolds=2, seed=1,
                            include_algos=["glm", "gbm"])
            aml.train(y="y", training_frame=fr)
            km = ht.KMeans(k=2, seed=1, ignored_columns=["y"]).train(fr)
            pc = ht.PCA(k=2).train(fr)
            sv = ht.SVD(nv=2).train(fr)
            gl = ht.GLRM(k=2, loss="huber", regularization_x="l1", gamma_x=0.1,
                         max_iterations=3, ignored_columns=["y"]).train(fr)
            nb = ht.NaiveBayes(response_column="y").train(fr)
            iso = ht.IsolationForest(ntrees=3, seed=1).train(fr)
            eif = ht.ExtendedIsolationForest(ntrees=3, extension_level=1,
                                             seed=1).train(fr)
            for model in (km, pc, sv, gl, nb, iso, eif):
                model.predict(fr)
            rf = ht.RuleFit(response_column="y", rule_generation_ntrees=3, seed=1).train(fr)
            rf.predict(fr)
            ag = ht.Aggregator(target_num_exemplars=20).train(fr)
            from h2o3_tpu_torch.rapids import Session, dist, exec_rapids
            dist.DIST_SORT_MIN = 1
            rs = Session()
            rs.assign("rfr", fr)
            total = exec_rapids("(sum (* (+ (cols_py rfr 0) 1) 2))", rs).value
            srt = exec_rapids('(GB (sort rfr [3 0] [1 0]) [3] "mean" 0 "rm")', rs).value
            hits = exec_rapids("(which (> (cols_py rfr 0) 0))", rs).value
            rs.assign("tfr", ht.Frame([ht.Column("t", np.array([1.6e12, np.nan]),
                                                 ht.ColType.TIME),
                                       ht.Column("s", np.array(["Ab", None], dtype=object),
                                                 ht.ColType.STR)]))
            years = exec_rapids("(year (cols_py tfr 0))", rs).value
            lower = exec_rapids("(tolower (cols_py tfr 1))", rs).value
            rs.remove("rfr")
            rs.remove("tfr")
        assert np.isclose(total, 2 * (X[:, 0].sum() + 300)) and srt.nrows == 2
        assert np.array_equal(hits.col(0).data, np.nonzero(X[:, 0] > 0)[0])
        assert np.array_equal(years.col(0).data, [2020.0, np.nan], equal_nan=True)
        assert list(lower.col(0).data) == ["ab", None]
        assert m.training_metrics.auc > 0.9
        assert f.training_metrics.auc > 0.9
        assert g.training_metrics.auc > 0.9 and g2.training_metrics.auc > 0.9
        assert np.isfinite(d.training_metrics.logloss)
        assert len(s.opt_leaves) == 3 + 4 + 1
        assert [m.algo_name for m in aml.leaderboard.models].count("glm") == 1
        assert nb.training_metrics.auc > 0.9 and len(km.size) == 2
        assert np.isfinite(gl.objective) and sv.d.shape == (2,)
        assert rf.rules and rf.training_metrics.auc > 0.9 and rf.glm.device.type == "cpu"
        assert ag.counts.sum() == 300
        assert not [e for e in aml.event_log.events if "failed" in e["message"]]
        leaked = [k for k in sys.modules
                  if k.split(".")[0] in ("jax", "jaxlib", "optax", "h2o3_tpu")
                  and sys.modules[k] is not None]
        assert not leaked, leaked
        print("ISOLATED-OK")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=str(ROOT), env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "ISOLATED-OK" in proc.stdout

    # the MOJO scorer needs numpy alone: importing it loads no torch either
    code = textwrap.dedent("""
        import sys
        import h2o3_tpu_torch.genmodel
        from h2o3_tpu_torch.genmodel import EasyPredictModelWrapper, load_mojo
        leaked = [k for k in sys.modules
                  if k.split(".")[0] in ("torch", "jax", "jaxlib", "h2o3_tpu")]
        assert not leaked, leaked
        print("GENMODEL-NUMPY-ONLY")
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=str(ROOT), env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "GENMODEL-NUMPY-ONLY" in proc.stdout
