"""DataInfo — the port of ``h2o3_tpu/models/data_info.py``.

The design-matrix layout every builder learns from its training frame
(``hex/DataInfo.java:23``): predictor order, categorical domains, numeric
moments and the response domain, so a scoring frame is adapted exactly as
the training frame was. The trees of this package need the layout and the
response vector; the GLM and DeepLearning train on the dense design matrix
``expand_matrix`` makes from it (one-hot categoricals, standardized
numerics, NA imputation), host numpy as in the JAX package, and the GLM
maps its coefficients back to the input scale with
``destandardize_coefs``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from h2o3_tpu_torch.frame.frame import ColType, Column, Frame


@dataclass
class DataInfo:
    predictor_names: List[str]
    response_name: Optional[str]
    use_all_factor_levels: bool
    standardize: bool
    missing_values_handling: str  # "mean_imputation" | "skip"
    num_means: Dict[str, float] = field(default_factory=dict)
    num_sds: Dict[str, float] = field(default_factory=dict)
    cat_domains: Dict[str, List[str]] = field(default_factory=dict)
    cat_mode: Dict[str, int] = field(default_factory=dict)
    coef_names: List[str] = field(default_factory=list)
    response_domain: Optional[List[str]] = None

    @property
    def n_coefs(self) -> int:
        return len(self.coef_names)


def build_data_info(
    frame: Frame,
    y: Optional[str],
    ignored: Sequence[str] = (),
    use_all_factor_levels: bool = False,
    standardize: bool = True,
    missing_values_handling: str = "mean_imputation",
) -> DataInfo:
    """Learn the design-matrix layout from the training frame."""
    skip = set(ignored) | ({y} if y else set())
    preds = [
        c.name
        for c in frame.columns
        if c.name not in skip and c.type in (ColType.NUM, ColType.TIME, ColType.CAT)
    ]
    info = DataInfo(
        predictor_names=preds,
        response_name=y,
        use_all_factor_levels=use_all_factor_levels,
        standardize=standardize,
        missing_values_handling=missing_values_handling,
    )
    coef_names: List[str] = []
    for name in preds:
        col = frame.col(name)
        if col.type is ColType.CAT:
            dom = list(col.domain)
            info.cat_domains[name] = dom
            counts = np.bincount(col.data[col.data >= 0], minlength=len(dom))
            info.cat_mode[name] = int(counts.argmax()) if counts.size else 0
            start = 0 if use_all_factor_levels else 1
            coef_names += [f"{name}.{lv}" for lv in dom[start:]]
        else:
            r = col.rollups
            info.num_means[name] = float(r.mean) if r.mean == r.mean else 0.0
            sd = float(r.sigma)
            info.num_sds[name] = sd if sd > 0 else 1.0
            coef_names.append(name)
    info.coef_names = coef_names
    if y is not None:
        ycol = frame.col(y)
        info.response_domain = list(ycol.domain) if ycol.type is ColType.CAT else None
    return info


def expand_matrix(
    info: DataInfo,
    frame: Frame,
    dtype=np.float32,
) -> Tuple[np.ndarray, np.ndarray]:
    """Frame -> dense [N, P] design matrix per the learned layout.

    Returns (X, skip_mask): skip_mask marks the rows dropped under
    ``missing_values_handling="skip"``. Unseen categorical levels map to NA
    (adaptTestForTrain) and then follow ``missing_values_handling`` like any
    other NA: the training mode under ``mean_imputation``, a dropped row
    under ``skip``. Numerics are NA-imputed with the training mean and
    standardized with the training mean and sd (``num_sds`` holds 1 for a
    constant column, so a zero-sd column stays finite)."""
    n = frame.nrows
    blocks: List[np.ndarray] = []
    any_na = np.zeros(n, dtype=bool)
    for name in info.predictor_names:
        if name in info.cat_domains:
            dom = info.cat_domains[name]
            codes = _align_codes(frame.col(name), dom)
            na = codes < 0
            any_na |= na
            if info.missing_values_handling == "mean_imputation":
                codes = np.where(na, info.cat_mode[name], codes)
            start = 0 if info.use_all_factor_levels else 1
            block = np.zeros((n, len(dom) - start), dtype=dtype)
            sel = codes - start
            rows = np.nonzero(sel >= 0)[0]
            block[rows, sel[rows]] = 1.0
            blocks.append(block)
        else:
            x = frame.col(name).numeric_view().astype(np.float64)
            na = np.isnan(x)
            any_na |= na
            x = np.where(na, info.num_means[name], x)
            if info.standardize:
                x = (x - info.num_means[name]) / info.num_sds[name]
            blocks.append(x.astype(dtype)[:, None])
    X = np.concatenate(blocks, axis=1) if blocks else np.zeros((n, 0), dtype=dtype)
    skip = any_na if info.missing_values_handling == "skip" else np.zeros(n, dtype=bool)
    return X, skip


def response_vector(info: DataInfo, frame: Frame) -> np.ndarray:
    """Response as float64: class codes for CAT (aligned to training domain)."""
    if info.response_name is None:
        raise ValueError("this model has no response column")
    col = frame.col(info.response_name)
    if info.response_domain is not None:
        codes = _align_codes(col, info.response_domain)
        return np.where(codes >= 0, codes.astype(np.float64), np.nan)
    return col.numeric_view().astype(np.float64)


def destandardize_coefs(
    info: DataInfo, beta_std: np.ndarray, intercept_std: float
) -> Tuple[np.ndarray, float]:
    """Standardized-space coefficients mapped back to the input scale
    (GLMModel beta against beta_std)."""
    beta = beta_std.copy().astype(np.float64)
    intercept = float(intercept_std)
    i = 0
    for name in info.predictor_names:
        if name in info.cat_domains:
            start = 0 if info.use_all_factor_levels else 1
            i += len(info.cat_domains[name]) - start
        else:
            if info.standardize:
                beta[i] = beta_std[i] / info.num_sds[name]
                intercept -= beta[i] * info.num_means[name]
            i += 1
    return beta, intercept


def _align_codes(col: Column, domain: List[str]) -> np.ndarray:
    """Remap a column's codes onto a target domain; unseen levels -> -1
    (Model.adaptTestForTrain domain mapping)."""
    if col.type is not ColType.CAT:
        col = col.as_factor()
    if col.domain == domain:
        return col.data
    index = {lv: i for i, lv in enumerate(domain)}
    remap = np.array([index.get(lv, -1) for lv in col.domain], dtype=np.int32)
    return np.where(col.data >= 0, remap[np.clip(col.data, 0, None)], -1).astype(np.int32)
