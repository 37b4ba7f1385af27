"""Algorithm registry — the port of ``h2o3_tpu/api/registry.py``:
algo name -> (ModelBuilder, Parameters).

Reference: ``hex/api/RegisterAlgos.java:16-34``, plus the extension
registrations (xgboost, targetencoder). The map equals the JAX package's,
key for key and in its order. ``AutoML._exploitation`` looks the leader's
builder up here.
"""

from __future__ import annotations

from typing import Dict, Tuple


def algo_map() -> Dict[str, Tuple[type, type]]:
    from h2o3_tpu_torch.models.aggregator import Aggregator, AggregatorParameters
    from h2o3_tpu_torch.models.coxph import CoxPH, CoxPHParameters
    from h2o3_tpu_torch.models.deeplearning import DeepLearning, DeepLearningParameters
    from h2o3_tpu_torch.models.ext_isolation_forest import (
        ExtendedIsolationForest,
        ExtendedIsolationForestParameters,
    )
    from h2o3_tpu_torch.models.gam import GAM, GAMParameters
    from h2o3_tpu_torch.models.generic import Generic, GenericParameters
    from h2o3_tpu_torch.models.glm import GLM, GLMParameters
    from h2o3_tpu_torch.models.glrm import GLRM, GLRMParameters
    from h2o3_tpu_torch.models.isolation_forest import (
        IsolationForest,
        IsolationForestParameters,
    )
    from h2o3_tpu_torch.models.kmeans import KMeans, KMeansParameters
    from h2o3_tpu_torch.models.naive_bayes import NaiveBayes, NaiveBayesParameters
    from h2o3_tpu_torch.models.pca import PCA, PCAParameters, SVD, SVDParameters
    from h2o3_tpu_torch.models.psvm import PSVM, PSVMParameters
    from h2o3_tpu_torch.models.rulefit import RuleFit, RuleFitParameters
    from h2o3_tpu_torch.models.stacked_ensemble import (
        StackedEnsemble,
        StackedEnsembleParameters,
    )
    from h2o3_tpu_torch.models.target_encoder import TargetEncoder, TargetEncoderParameters
    from h2o3_tpu_torch.models.tree.drf import DRF, DRFParameters
    from h2o3_tpu_torch.models.tree.gbm import GBM, GBMParameters
    from h2o3_tpu_torch.models.tree.xgboost import XGBoost, XGBoostParameters
    from h2o3_tpu_torch.models.word2vec import Word2Vec, Word2VecParameters

    return {
        # hex/api/RegisterAlgos.java order
        "coxph": (CoxPH, CoxPHParameters),
        "deeplearning": (DeepLearning, DeepLearningParameters),
        "drf": (DRF, DRFParameters),
        "glm": (GLM, GLMParameters),
        "glrm": (GLRM, GLRMParameters),
        "kmeans": (KMeans, KMeansParameters),
        "naivebayes": (NaiveBayes, NaiveBayesParameters),
        "pca": (PCA, PCAParameters),
        "svd": (SVD, SVDParameters),
        "gbm": (GBM, GBMParameters),
        "isolationforest": (IsolationForest, IsolationForestParameters),
        "extendedisolationforest": (
            ExtendedIsolationForest,
            ExtendedIsolationForestParameters,
        ),
        "aggregator": (Aggregator, AggregatorParameters),
        "word2vec": (Word2Vec, Word2VecParameters),
        "stackedensemble": (StackedEnsemble, StackedEnsembleParameters),
        "psvm": (PSVM, PSVMParameters),
        "gam": (GAM, GAMParameters),
        "rulefit": (RuleFit, RuleFitParameters),
        "generic": (Generic, GenericParameters),
        # extensions
        "xgboost": (XGBoost, XGBoostParameters),
        "targetencoder": (TargetEncoder, TargetEncoderParameters),
    }
