"""Histogram GBDT builders (GBM, XGBoost) on one booster core."""

from h2o3_tpu_torch.models.tree.gbm import GBM, GBMModel, GBMParameters
from h2o3_tpu_torch.models.tree.xgboost import XGBoost, XGBoostModel, XGBoostParameters

__all__ = [
    "GBM", "GBMModel", "GBMParameters",
    "XGBoost", "XGBoostModel", "XGBoostParameters",
]
