"""Histogram tree builders (GBM, DRF, XGBoost) on one booster core."""

from h2o3_tpu_torch.models.tree.drf import DRF, DRFModel, DRFParameters
from h2o3_tpu_torch.models.tree.gbm import GBM, GBMModel, GBMParameters
from h2o3_tpu_torch.models.tree.xgboost import XGBoost, XGBoostModel, XGBoostParameters

__all__ = [
    "DRF", "DRFModel", "DRFParameters",
    "GBM", "GBMModel", "GBMParameters",
    "XGBoost", "XGBoostModel", "XGBoostParameters",
]
