"""DRF — the port of ``h2o3_tpu/models/tree/drf.py``.

Distributed random forest (``hex/tree/drf/DRF.java``) on the booster core
of ``models/tree/booster.py``: bagged trees fit the raw response (no
boosting, learn rate 1, ``objective="fixed"``), each tree on a row sample
(``sample_rate`` 0.632) with per-split feature sampling (``mtries``), and
predictions average the trees. A classifier fits one indicator-regression
tree set per class (one set of P(class 1) for a binomial response); the
averaged leaves are class fractions, normalised to probabilities.

Not part of this package yet: the chunk-homed distributed fit.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.data_info import response_vector
from h2o3_tpu_torch.models.framework import ModelBuilder, ModelParameters
from h2o3_tpu_torch.models.tree.booster import TreeParams, train_boosted
from h2o3_tpu_torch.models.tree.common import (
    TreeModelBase,
    checkpoint_booster,
    extra_trees,
    extract_weights,
    finish_tree_fit,
    tree_cache_token,
    tree_data_info,
    tree_matrix,
)


@dataclass
class DRFParameters(ModelParameters):
    ntrees: int = 50
    max_depth: int = 12  # reference default 20; dense level-wise capacity caps this build
    nbins: int = 20
    min_rows: float = 1.0
    min_split_improvement: float = 1e-5
    sample_rate: float = 0.632  # reference DRF default (DRFParametersV3)
    mtries: int = -1  # -1: sqrt(F) classification, F/3 regression (DRF.java)
    #: "kernel" | "plain" histogram; None: kernel on cuda, plain on cpu
    hist_impl: Optional[str] = None
    #: histogram subtraction; None: on for cuda, off for cpu
    tree_subtract: Optional[bool] = None
    #: levels whose padded node count K has K·4 <= this take the
    #: factorized histogram kernel (0: none, the JAX package's default)
    hist_fact_max_kc: int = 0
    #: histogram operand mode: "f32", or "bf16" (g, h and the count weight
    #: rounded to bf16, summed in float: the JAX package's TPU default)
    hist_dtype: str = "f32"


class DRFModel(TreeModelBase):
    algo_name = "drf"

    def _raw_from_margin(self, margin: np.ndarray) -> np.ndarray:
        # margin: averaged leaf values per class
        if not self.is_classifier:
            return margin[:, 0]
        p = np.clip(margin, 1e-9, None)
        if p.shape[1] == 1:  # binomial: one tree set predicts P(class 1)
            p1 = np.clip(margin[:, 0], 0.0, 1.0)
            return np.stack([1 - p1, p1], axis=1)
        return p / p.sum(axis=1, keepdims=True)


class DRF(ModelBuilder):

    SUPPORTED_COMMON = frozenset(
        {"checkpoint", "weights_column", "categorical_encoding"}
    )
    algo_name = "drf"

    def __init__(self, params: Optional[DRFParameters] = None, **kw) -> None:
        super().__init__(params or DRFParameters(**kw))

    def _fit(self, frame: Frame, valid: Optional[Frame],
             device: torch.device) -> DRFModel:
        p: DRFParameters = self.params
        t0 = time.time()
        ignored = list(p.ignored_columns)
        if p.weights_column and p.weights_column not in ignored:
            ignored.append(p.weights_column)
        info = tree_data_info(frame, p.response_column, ignored)
        y = response_vector(info, frame)
        nclasses = len(info.response_domain) if info.response_domain else 1
        model = DRFModel(p, info, "gaussian", device)
        X = tree_matrix(info, frame, encoding=model.tree_encoding)
        keep = ~np.isnan(y)
        weights = extract_weights(frame, p, keep)
        X, y = X[keep], y[keep]
        if weights is not None:
            weights = weights[keep]
        F = X.shape[1]

        mtries = p.mtries
        if mtries <= 0:
            mtries = max(1, int(np.sqrt(F)) if nclasses > 1 else max(1, F // 3))

        # targets: raw y (regression, binomial) or per-class indicators
        if nclasses > 2:
            targets = np.zeros((len(y), nclasses), dtype=np.float64)
            targets[np.arange(len(y)), y.astype(np.int64)] = 1.0
            n_class_trees = nclasses
        else:
            targets = y[:, None]
            n_class_trees = 1
        model.timings["setup_s"] = time.time() - t0

        tp = TreeParams(
            ntrees=extra_trees(p, n_class_trees),
            max_depth=p.max_depth,
            learn_rate=1.0,  # no shrinkage: each tree predicts the target itself
            nbins=p.nbins,
            min_rows=p.min_rows,
            min_split_improvement=p.min_split_improvement,
            reg_lambda=0.0,
            reg_alpha=0.0,
            sample_rate=p.sample_rate,
            mtries=mtries,
            seed=p.actual_seed(),
        )
        # objective='fixed': g = -target, h = 1 make the Newton leaf the
        # in-leaf mean of the target (weighted: g = -w t, h = w)
        model.booster = train_boosted(
            X,
            objective="fixed",
            y=targets,
            n_class_trees=n_class_trees,
            init_margin=np.zeros(n_class_trees),
            params=tp,
            average=True,
            device=device,
            timings=model.timings,
            resume_from=checkpoint_booster(
                p, n_class_trees, self.algo_name,
                n_features=F, encoding=model.tree_encoding,
            ),
            weights=weights,
            hist_impl=p.hist_impl,
            subtract=p.tree_subtract,
            hist_fact_max_kc=p.hist_fact_max_kc,
            hist_dtype=p.hist_dtype,
            cache_token=tree_cache_token(frame, p, model.tree_encoding),
            cache_frame_key=getattr(frame, "key", None),
        )
        return finish_tree_fit(model, frame, valid)
