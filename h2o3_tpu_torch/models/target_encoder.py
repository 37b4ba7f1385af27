"""Target (mean) encoding — the port of ``h2o3_tpu/models/target_encoder.py``.

Reference: ``h2o-extensions/target-encoder`` — ``TargetEncoder.java``
(builder), ``TargetEncoderModel.java`` (transform with data-leakage
handling) and ``TargetEncoderHelper.java:237-247`` (the blended value
``P = λ(n)·posterior + (1-λ(n))·prior`` with
``λ(n) = 1 / (1 + exp((k - n) / f))``, k the inflection point, f the
smoothing).

Host numpy, as in the JAX package: the encoding tables are per-level
(numerator, denominator) pairs of one ``bincount`` each, and the transform
is a gather and an elementwise blend. The arithmetic and the noise draws
(``np.random.default_rng(actual_seed())``) are the JAX package's, so the
two give the same encodings bit for bit. K-fold and leave-one-out leakage
handling subtract the held-out contribution from the gathered aggregates.
The model keeps the device it was built for; it does no device work.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import ColType, Column, Frame
from h2o3_tpu_torch.models.data_info import (
    _align_codes,
    build_data_info,
    response_vector,
)
from h2o3_tpu_torch.models.framework import (
    Model,
    ModelBuilder,
    ModelParameters,
    fold_assignment,
)


@dataclass
class TargetEncoderParameters(ModelParameters):
    columns_to_encode: Optional[List[str]] = None  # default: all categoricals
    keep_original_categorical_columns: bool = True
    data_leakage_handling: str = "none"  # none | leave_one_out | k_fold
    blending: bool = False
    inflection_point: float = 10.0  # k in λ(n)
    smoothing: float = 20.0  # f in λ(n)
    noise: float = 0.01  # magnitude of uniform noise added on transform


class TargetEncoderModel(Model):
    algo_name = "targetencoder"

    def __init__(self, params: TargetEncoderParameters, data_info,
                 device: torch.device) -> None:
        super().__init__(params, data_info, device)
        # per encoded column: (domain, numerator[L], denominator[L])
        self.encodings: Dict[str, Tuple[List[str], np.ndarray, np.ndarray]] = {}
        self.prior_mean: float = np.nan
        self.fold: Optional[np.ndarray] = None  # training fold ids (k_fold)
        self.train_key: Optional[str] = None

    @property
    def is_classifier(self) -> bool:
        return False

    def _blend(self, num: np.ndarray, den: np.ndarray) -> np.ndarray:
        """Posterior/prior shrinkage (TargetEncoderHelper.java:246-247)."""
        p = self.params
        post = np.where(den > 0, num / np.maximum(den, 1e-300), self.prior_mean)
        if not p.blending:
            return np.where(den > 0, post, self.prior_mean)
        lam = 1.0 / (1.0 + np.exp((p.inflection_point - den) / max(p.smoothing, 1e-12)))
        return lam * post + (1.0 - lam) * self.prior_mean

    def transform(
        self,
        frame: Frame,
        as_training: bool = False,
        noise: Optional[float] = None,
    ) -> Frame:
        """Append ``<col>_te`` columns. ``as_training=True`` applies the
        configured leakage handling (leave-one-out subtracts the row's own
        target; k-fold uses out-of-fold aggregates) and, by default, the
        noise: ``TargetEncoderModel.transformTraining``. An inference
        transform adds no noise."""
        p = self.params
        rng = np.random.default_rng(p.actual_seed())
        if noise is None:
            noise = p.noise if as_training else 0.0
        y = None
        if as_training and p.data_leakage_handling != "none":
            y = response_vector(self.data_info, frame)
        out = frame
        for name, (dom, num, den) in self.encodings.items():
            if name not in frame.names:
                continue
            col = frame.col(name)
            codes = _codes_on_domain(col, dom)
            g_num, g_den = num[np.clip(codes, 0, None)], den[np.clip(codes, 0, None)]
            if as_training and y is not None:
                ok = ~np.isnan(y)
                if p.data_leakage_handling == "leave_one_out":
                    g_num = g_num - np.where(ok, y, 0.0)
                    g_den = g_den - ok.astype(np.float64)
                elif p.data_leakage_handling == "k_fold" and self.fold is not None:
                    # subtract this fold's per-level aggregates
                    for f in np.unique(self.fold):
                        in_f = self.fold == f
                        fn, fd = _aggregate(codes[in_f], y[in_f], len(dom))
                        g_num[in_f] -= fn[np.clip(codes[in_f], 0, None)]
                        g_den[in_f] -= fd[np.clip(codes[in_f], 0, None)]
            enc = self._blend(g_num, g_den)
            enc = np.where(codes >= 0, enc, self.prior_mean)
            if noise:
                enc = enc + rng.uniform(-noise, noise, size=enc.shape)
            out = out.add_column(Column(f"{name}_te", enc, ColType.NUM))
        if not p.keep_original_categorical_columns:
            out = out.drop([n for n in self.encodings if n in out.names])
        return out

    def _predict_raw(self, frame: Frame) -> np.ndarray:
        raise NotImplementedError("TargetEncoderModel transforms frames; use .transform()")


class TargetEncoder(ModelBuilder):
    algo_name = "targetencoder"

    def __init__(self, params: Optional[TargetEncoderParameters] = None, **kw) -> None:
        super().__init__(params or TargetEncoderParameters(**kw))

    def _fit(self, frame: Frame, valid: Optional[Frame],
             device: torch.device) -> TargetEncoderModel:
        p: TargetEncoderParameters = self.params
        if not p.response_column:
            raise ValueError("target encoding needs a response_column")
        info = build_data_info(frame, p.response_column, ignored=p.ignored_columns,
                               standardize=False)
        model = TargetEncoderModel(p, info, device)
        y = response_vector(info, frame)
        if info.response_domain is not None:
            if len(info.response_domain) != 2:
                raise ValueError("target encoding supports binary or numeric targets")
            # binomial: encode P(y == positive class), positive = last level
            y = (y == len(info.response_domain) - 1).astype(np.float64)
        ok = ~np.isnan(y)
        model.prior_mean = float(y[ok].mean()) if ok.any() else 0.0
        cols = p.columns_to_encode or [
            c.name for c in frame.columns
            if c.type is ColType.CAT and c.name != p.response_column
        ]
        for name in cols:
            col = frame.col(name)
            if col.type is not ColType.CAT:
                col = col.as_factor()
            dom = list(col.domain)
            num, den = _aggregate(col.data, np.where(ok, y, np.nan), len(dom))
            model.encodings[name] = (dom, num, den)
        if p.data_leakage_handling == "k_fold":
            model.fold = fold_assignment(
                n=frame.nrows,
                nfolds=max(p.nfolds, 2) if p.nfolds else 5,
                scheme="auto" if p.fold_assignment == "auto" else p.fold_assignment,
                seed=p.actual_seed(),
                fold_column=frame.col(p.fold_column).numeric_view().astype(np.int64)
                if p.fold_column else None,
            )
        return model


def _aggregate(codes: np.ndarray, y: np.ndarray, n_levels: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-level (Σy, count) ignoring NA codes/targets."""
    ok = (codes >= 0) & ~np.isnan(y)
    num = np.bincount(codes[ok], weights=y[ok], minlength=n_levels).astype(np.float64)
    den = np.bincount(codes[ok], minlength=n_levels).astype(np.float64)
    return num, den


def _codes_on_domain(col: Column, domain: List[str]) -> np.ndarray:
    return _align_codes(col, domain)
