"""Stacked Ensemble — the port of ``h2o3_tpu/models/stacked_ensemble.py``.

Reference: ``hex/ensemble/StackedEnsemble.java:28``. The level-one frame
binds every base model's cross-validation holdout predictions (class
probabilities for a classifier, p1 alone for a binomial one, predictions
for regression) beside the response; the metalearner (by default a GLM of
the response's family, ``hex/ensemble/Metalearners.java``) trains on it.
Prediction stacks the base models' predictions into the same layout and
scores the metalearner.

The level-one assembly is host numpy; the base models score on their own
devices and the metalearner is built on the ensemble's device (its
parameters carry it, so it does not depend on the caller's
``use_device`` block). Base models must be trained with ``nfolds >= 2``
and ``keep_cross_validation_predictions=True`` on the same training frame,
as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import ColType, Column, Frame
from h2o3_tpu_torch.models.data_info import build_data_info
from h2o3_tpu_torch.models.framework import Model, ModelBuilder, ModelParameters


@dataclass
class StackedEnsembleParameters(ModelParameters):
    base_models: List[Any] = field(default_factory=list)  # trained Models
    metalearner_algorithm: str = "auto"  # auto|glm|gbm|drf|deeplearning
    metalearner_params: dict = field(default_factory=dict)
    metalearner_nfolds: int = 0


class StackedEnsembleModel(Model):
    algo_name = "stackedensemble"

    def __init__(self, params, data_info, device: torch.device):
        super().__init__(params, data_info, device)
        self.metalearner: Optional[Model] = None
        self.base_models: List[Any] = []
        self.levelone_names: List[str] = []

    def _levelone_matrix(self, frame: Frame) -> np.ndarray:
        cols = []
        for bm in self.base_models:
            raw = bm._predict_raw(frame)
            cols.append(_pred_columns(raw, bm.nclasses))
        return np.concatenate(cols, axis=1)

    def _predict_raw(self, frame: Frame) -> np.ndarray:
        L1 = self._levelone_matrix(frame)
        lf = _levelone_frame(L1, self.levelone_names)
        return self.metalearner._predict_raw(lf)


class StackedEnsemble(ModelBuilder):
    algo_name = "stackedensemble"

    def __init__(self, params: Optional[StackedEnsembleParameters] = None, **kw) -> None:
        super().__init__(params or StackedEnsembleParameters(**kw))

    def _validate(self, frame: Frame) -> None:
        super()._validate(frame)
        p: StackedEnsembleParameters = self.params
        if not p.base_models:
            raise ValueError("StackedEnsemble needs at least one base model")
        for bm in p.base_models:
            if getattr(bm, "cv_holdout_predictions", None) is None:
                raise ValueError(
                    f"base model {bm.key} lacks CV holdout predictions — train with "
                    "nfolds >= 2 and keep_cross_validation_predictions=True"
                )

    def _fit(self, frame: Frame, valid: Optional[Frame],
             device: torch.device) -> StackedEnsembleModel:
        p: StackedEnsembleParameters = self.params
        y_name = p.response_column or p.base_models[0].params.response_column
        info = build_data_info(frame, y_name, standardize=False)
        model = StackedEnsembleModel(p, info, device)
        model.base_models = list(p.base_models)

        # level-one frame: per-base-model holdout prediction columns + response
        blocks, names = [], []
        for mi, bm in enumerate(p.base_models):
            hp = np.asarray(bm.cv_holdout_predictions)
            block = _pred_columns(hp, bm.nclasses)
            blocks.append(block)
            names += [f"m{mi}_{bm.algo_name}_c{j}" for j in range(block.shape[1])]
        L1 = np.concatenate(blocks, axis=1)
        model.levelone_names = names

        lf = _levelone_frame(L1, names)
        ycol = frame.col(y_name)
        lf = lf.add_column(ycol.copy())

        model.metalearner = _build_metalearner(p, y_name, info, device).train(lf)
        model.training_metrics = model.model_performance(frame)
        if valid is not None:
            model.validation_metrics = model.model_performance(valid)
        return model


def _pred_columns(raw: np.ndarray, nclasses: int) -> np.ndarray:
    """Base-model output -> level-one block (one redundant probability
    column dropped for binomial: the reference's level one keeps p1 only)."""
    if nclasses == 1:
        return raw.reshape(-1, 1).astype(np.float64)
    if nclasses == 2:
        return raw[:, 1:2].astype(np.float64)
    return raw.astype(np.float64)


def _levelone_frame(L1: np.ndarray, names: List[str]) -> Frame:
    return Frame([
        Column(nm, L1[:, j].astype(np.float64), ColType.NUM) for j, nm in enumerate(names)
    ])


def _build_metalearner(p: StackedEnsembleParameters, y_name: str, info,
                       device: torch.device) -> ModelBuilder:
    algo = p.metalearner_algorithm
    kw = dict(p.metalearner_params)
    kw.setdefault("response_column", y_name)
    kw.setdefault("nfolds", p.metalearner_nfolds)
    kw.setdefault("seed", p.seed)
    kw.setdefault("device", device)
    if algo in ("auto", "glm"):
        from h2o3_tpu_torch.models.glm import GLM

        if "family" not in kw:
            dom = info.response_domain
            kw["family"] = (
                "gaussian" if dom is None else ("binomial" if len(dom) == 2 else "multinomial")
            )
        if algo == "auto":
            kw.setdefault("alpha", 0.0)
            kw.setdefault("lambda_", 0.0)
        return GLM(**kw)
    if algo == "gbm":
        from h2o3_tpu_torch.models.tree.gbm import GBM

        return GBM(**kw)
    if algo == "drf":
        from h2o3_tpu_torch.models.tree.drf import DRF

        return DRF(**kw)
    if algo == "deeplearning":
        from h2o3_tpu_torch.models.deeplearning import DeepLearning

        return DeepLearning(**kw)
    raise ValueError(f"unknown metalearner_algorithm {algo!r}")
