"""h2o3_tpu_torch — the PyTorch/CUDA port of ``h2o3_tpu``.

A second package beside the JAX one, grown slice by slice until it does
what ``h2o3_tpu`` does with the same answers. It imports ``torch`` and
numpy, never ``jax`` and nothing of ``h2o3_tpu``. Its entry points run on a
CUDA card unless the caller asks for the CPU (``device="cpu"`` or
``use_device("cpu")``); the TPU's Pallas kernels are hand-written CUDA
kernels here (``h2o3_tpu_torch/csrc``), built with ``nvcc`` at first use.

So far: Frames; XGBoost/GBM/DRF fit, cross-validate and score on the
histogram tree core; batched scoring, thresholds, ``make_metrics``, TreeSHAP
contributions, variable importances, binary save/load, MOJO and POJO export
and the numpy-only MOJO scorer ``h2o3_tpu_torch.genmodel``; GLM (every
family, IRLSM with the Gram on the device, L-BFGS, lambda search) and the
DeepLearning MLP (ADADELTA or SGD, dropout, autoencoder) on the dense
design matrix; KMeans, PCA and SVD, GLRM, NaiveBayes and both isolation
forests; GAM (with its C POJO), CoxPH, PSVM and Word2Vec; Aggregator,
RuleFit, Generic (MOJO import), segment models, Assembly munging and
scoring pipelines, and the reference-format MOJO (``models/mojo_ref.py``);
grid search, target encoding, stacked ensembles and AutoML over those
models; the map/reduce core (``compute``) and the Rapids munging engine
(``rapids``: ``Session``, ``exec_rapids``) with its device paths.

The top-level names load on first use (PEP 562), so importing
``h2o3_tpu_torch.genmodel`` loads numpy and nothing of torch.
"""

__version__ = "0.1.0"

__all__ = [
    "Aggregator",
    "AggregatorParameters",
    "AutoML",
    "ColType",
    "Column",
    "CoxPH",
    "CoxPHParameters",
    "DRF",
    "DeepLearning",
    "DeepLearningParameters",
    "ExtendedIsolationForest",
    "ExtendedIsolationForestParameters",
    "Frame",
    "GAM",
    "GAMParameters",
    "GBM",
    "GLM",
    "Generic",
    "GenericParameters",
    "GLMParameters",
    "GLRM",
    "GLRMParameters",
    "GridSearch",
    "IsolationForest",
    "IsolationForestParameters",
    "KMeans",
    "KMeansParameters",
    "NaiveBayes",
    "NaiveBayesParameters",
    "PCA",
    "PCAParameters",
    "PSVM",
    "PSVMParameters",
    "RuleFit",
    "RuleFitParameters",
    "SVD",
    "SVDParameters",
    "SearchCriteria",
    "SegmentModelsBuilder",
    "StackedEnsemble",
    "StackedEnsembleParameters",
    "TargetEncoder",
    "TargetEncoderParameters",
    "Word2Vec",
    "Word2VecParameters",
    "XGBoost",
    "import_mojo",
    "resolve_device",
    "use_device",
]

_LAZY = {
    "Aggregator": ("h2o3_tpu_torch.models.aggregator", "Aggregator"),
    "AggregatorParameters": ("h2o3_tpu_torch.models.aggregator", "AggregatorParameters"),
    "AutoML": ("h2o3_tpu_torch.automl.automl", "AutoML"),
    "ColType": ("h2o3_tpu_torch.frame.frame", "ColType"),
    "Column": ("h2o3_tpu_torch.frame.frame", "Column"),
    "Frame": ("h2o3_tpu_torch.frame.frame", "Frame"),
    "DRF": ("h2o3_tpu_torch.models.tree.drf", "DRF"),
    "DeepLearning": ("h2o3_tpu_torch.models.deeplearning", "DeepLearning"),
    "DeepLearningParameters": ("h2o3_tpu_torch.models.deeplearning",
                               "DeepLearningParameters"),
    "GLM": ("h2o3_tpu_torch.models.glm", "GLM"),
    "GLMParameters": ("h2o3_tpu_torch.models.glm", "GLMParameters"),
    "GLRM": ("h2o3_tpu_torch.models.glrm", "GLRM"),
    "GLRMParameters": ("h2o3_tpu_torch.models.glrm", "GLRMParameters"),
    "ExtendedIsolationForest": ("h2o3_tpu_torch.models.ext_isolation_forest",
                                "ExtendedIsolationForest"),
    "ExtendedIsolationForestParameters": ("h2o3_tpu_torch.models.ext_isolation_forest",
                                          "ExtendedIsolationForestParameters"),
    "IsolationForest": ("h2o3_tpu_torch.models.isolation_forest", "IsolationForest"),
    "IsolationForestParameters": ("h2o3_tpu_torch.models.isolation_forest",
                                  "IsolationForestParameters"),
    "KMeans": ("h2o3_tpu_torch.models.kmeans", "KMeans"),
    "KMeansParameters": ("h2o3_tpu_torch.models.kmeans", "KMeansParameters"),
    "NaiveBayes": ("h2o3_tpu_torch.models.naive_bayes", "NaiveBayes"),
    "NaiveBayesParameters": ("h2o3_tpu_torch.models.naive_bayes", "NaiveBayesParameters"),
    "PCA": ("h2o3_tpu_torch.models.pca", "PCA"),
    "PCAParameters": ("h2o3_tpu_torch.models.pca", "PCAParameters"),
    "SVD": ("h2o3_tpu_torch.models.pca", "SVD"),
    "SVDParameters": ("h2o3_tpu_torch.models.pca", "SVDParameters"),
    "CoxPH": ("h2o3_tpu_torch.models.coxph", "CoxPH"),
    "CoxPHParameters": ("h2o3_tpu_torch.models.coxph", "CoxPHParameters"),
    "GAM": ("h2o3_tpu_torch.models.gam", "GAM"),
    "GAMParameters": ("h2o3_tpu_torch.models.gam", "GAMParameters"),
    "PSVM": ("h2o3_tpu_torch.models.psvm", "PSVM"),
    "PSVMParameters": ("h2o3_tpu_torch.models.psvm", "PSVMParameters"),
    "Word2Vec": ("h2o3_tpu_torch.models.word2vec", "Word2Vec"),
    "Word2VecParameters": ("h2o3_tpu_torch.models.word2vec", "Word2VecParameters"),
    "GBM": ("h2o3_tpu_torch.models.tree.gbm", "GBM"),
    "Generic": ("h2o3_tpu_torch.models.generic", "Generic"),
    "GenericParameters": ("h2o3_tpu_torch.models.generic", "GenericParameters"),
    "RuleFit": ("h2o3_tpu_torch.models.rulefit", "RuleFit"),
    "RuleFitParameters": ("h2o3_tpu_torch.models.rulefit", "RuleFitParameters"),
    "SegmentModelsBuilder": ("h2o3_tpu_torch.models.segments", "SegmentModelsBuilder"),
    "GridSearch": ("h2o3_tpu_torch.models.grid", "GridSearch"),
    "SearchCriteria": ("h2o3_tpu_torch.models.grid", "SearchCriteria"),
    "StackedEnsemble": ("h2o3_tpu_torch.models.stacked_ensemble", "StackedEnsemble"),
    "StackedEnsembleParameters": ("h2o3_tpu_torch.models.stacked_ensemble",
                                  "StackedEnsembleParameters"),
    "TargetEncoder": ("h2o3_tpu_torch.models.target_encoder", "TargetEncoder"),
    "TargetEncoderParameters": ("h2o3_tpu_torch.models.target_encoder",
                                "TargetEncoderParameters"),
    "XGBoost": ("h2o3_tpu_torch.models.tree.xgboost", "XGBoost"),
    "import_mojo": ("h2o3_tpu_torch.models.generic", "import_mojo"),
    "resolve_device": ("h2o3_tpu_torch.device", "resolve_device"),
    "use_device": ("h2o3_tpu_torch.device", "use_device"),
}


def __getattr__(name):
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(mod_name), attr)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
