"""DataInfo — the port of ``h2o3_tpu/models/data_info.py``.

The design-matrix layout every builder learns from its training frame
(``hex/DataInfo.java:23``): predictor order, categorical domains, numeric
moments and the response domain, so a scoring frame is adapted exactly as
the training frame was. The trees of this package need the layout and the
response vector; the expanded (one-hot, standardized) matrix of the linear
models is not part of it yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

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


def response_vector(info: DataInfo, frame: Frame) -> np.ndarray:
    """Response as float64: class codes for CAT (aligned to training domain)."""
    if info.response_name is None:
        raise ValueError("this model has no response column")
    col = frame.col(info.response_name)
    if info.response_domain is not None:
        codes = _align_codes(col, info.response_domain)
        return np.where(codes >= 0, codes.astype(np.float64), np.nan)
    return col.numeric_view().astype(np.float64)


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
