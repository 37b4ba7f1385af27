"""GBM — the port of ``h2o3_tpu/models/tree/gbm.py``.

H2O-style gradient boosting (``hex/tree/gbm/GBM.java``, defaults from
GBMParametersV3): one tree per class per iteration, Newton leaf values, no
leaf L2, on the booster core of ``models/tree/booster.py``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.framework import ModelBuilder, ModelParameters
from h2o3_tpu_torch.models.tree.booster import TreeParams, train_boosted
from h2o3_tpu_torch.models.tree.common import (
    TreeModelBase,
    checkpoint_booster,
    extra_trees,
    finish_tree_fit,
    make_tree_monitor,
    tree_cache_token,
    tree_fit_setup,
)


@dataclass
class GBMParameters(ModelParameters):
    ntrees: int = 50
    max_depth: int = 5
    learn_rate: float = 0.1
    nbins: int = 20  # reference GBM default nbins=20 (GBMParametersV3)
    min_rows: float = 10.0
    min_split_improvement: float = 1e-5
    sample_rate: float = 1.0
    col_sample_rate_per_tree: float = 1.0
    distribution: str = "auto"
    score_tree_interval: int = 1
    tweedie_power: float = 1.5  # hex/Distribution.java tweedie variance power
    quantile_alpha: float = 0.5
    huber_alpha: float = 0.9
    monotone_constraints: Optional[dict] = None  # {col: -1|+1}
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


class GBMModel(TreeModelBase):
    algo_name = "gbm"


class GBM(ModelBuilder):

    SUPPORTED_COMMON = frozenset(
        {
            "checkpoint",
            "stopping_rounds",
            "weights_column",
            "offset_column",
            "categorical_encoding",
            "max_runtime_secs",
        }
    )
    algo_name = "gbm"

    def __init__(self, params: Optional[GBMParameters] = None, **kw) -> None:
        super().__init__(params or GBMParameters(**kw))

    def _fit(self, frame: Frame, valid: Optional[Frame],
             device: torch.device) -> GBMModel:
        p: GBMParameters = self.params
        t0 = time.time()
        model, X, y, weights, offset, objective, f0, n_class_trees, mono = (
            tree_fit_setup(frame, p, GBMModel, use_offset=True, device=device)
        )
        model.timings["setup_s"] = time.time() - t0
        tp = TreeParams(
            ntrees=extra_trees(p, n_class_trees),
            max_depth=p.max_depth,
            learn_rate=p.learn_rate,
            nbins=p.nbins,
            min_rows=p.min_rows,
            min_split_improvement=p.min_split_improvement,
            reg_lambda=0.0,  # the reference GBM has no leaf L2
            reg_alpha=0.0,
            sample_rate=p.sample_rate,
            col_sample_rate_per_tree=p.col_sample_rate_per_tree,
            seed=p.actual_seed(),
        )
        history = []
        monitor, score_interval = make_tree_monitor(
            model, p, objective, y, weights, history
        )
        model.booster = train_boosted(
            X,
            objective=objective,
            y=y,
            n_class_trees=n_class_trees,
            init_margin=f0,
            params=tp,
            monitor=monitor,
            score_interval=score_interval,
            device=device,
            timings=model.timings,
            resume_from=checkpoint_booster(
                p, n_class_trees, self.algo_name,
                n_features=X.shape[1], encoding=model.tree_encoding,
            ),
            weights=weights,
            offset=offset,
            monotone=mono,
            hist_impl=p.hist_impl,
            subtract=p.tree_subtract,
            hist_fact_max_kc=p.hist_fact_max_kc,
            hist_dtype=p.hist_dtype,
            cache_token=tree_cache_token(frame, p, model.tree_encoding),
            cache_frame_key=getattr(frame, "key", None),
        )
        return finish_tree_fit(model, frame, valid)
