"""PCA and SVD — the port of ``h2o3_tpu/models/pca.py``.

Reference: ``hex/pca/PCA.java`` (``pca_method=GramSVD``: a distributed
Gram, then a local decomposition on the driver) and ``hex/svd/SVD.java``.

The device program is the Gram ``X.T @ X`` (``_gram_xx``), in float32 on
the design matrix placed once per (frame state, transform, design
parameters, device) through ``frame/devcache.cached`` (kind ``pca_x``).
The rest is host float64, as in the JAX package: the division by n - 1,
``np.linalg.eigh``, the descending order, the sign rule that makes each
component's largest loading positive, pve and cum_pve.

``transform="demean"`` and ``"descale"`` are applied outside
``expand_matrix`` with the training statistics, which the model keeps
(``transform_sub``, ``transform_mul``) and scoring applies again.
``SVD`` wraps a PCA fit and sets ``d = sd * sqrt(n - 1)``; its model is a
``PCAModel`` and exports as a PCA MOJO. Scoring is host numpy, as in the
JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from h2o3_tpu_torch.frame import devcache
from h2o3_tpu_torch.frame.frame import ColType, Column, Frame
from h2o3_tpu_torch.models.data_info import build_data_info, expand_matrix
from h2o3_tpu_torch.models.framework import Model, ModelBuilder, ModelParameters


@dataclass
class PCAParameters(ModelParameters):
    k: int = 2
    transform: str = "standardize"  # none|standardize|demean|descale
    pca_method: str = "gram_svd"
    use_all_factor_levels: bool = False


def _gram_xx(X: torch.Tensor) -> torch.Tensor:
    """The [D, D] float32 Gram of the resident design."""
    return X.T @ X


class PCAModel(Model):
    algo_name = "pca"

    def __init__(self, params, data_info, device: torch.device) -> None:
        super().__init__(params, data_info, device)
        self.eigenvectors: Optional[np.ndarray] = None  # [D, k]
        #: expanded-space demean/descale statistics from training (None
        #: for standardize/none, which expand_matrix applies itself)
        self.transform_sub: Optional[np.ndarray] = None
        self.transform_mul: Optional[np.ndarray] = None
        self.std_deviation: Optional[np.ndarray] = None  # [k]
        self.pve: Optional[np.ndarray] = None  # proportion of variance explained
        self.cum_pve: Optional[np.ndarray] = None

    @property
    def is_classifier(self) -> bool:
        return False

    def _predict_raw(self, frame: Frame) -> np.ndarray:
        X, _ = expand_matrix(self.data_info, frame, dtype=np.float32)
        # the training statistics: the eigenvectors live in the space
        # the fit transformed its rows into
        if self.transform_sub is not None:
            X = X - self.transform_sub
        if self.transform_mul is not None:
            X = X * self.transform_mul
        return X @ self.eigenvectors

    def predict(self, frame: Frame) -> Frame:
        scores = self._predict_raw(frame)
        return Frame(
            [Column(f"PC{i + 1}", scores[:, i].astype(np.float64), ColType.NUM)
             for i in range(scores.shape[1])]
        )

    def model_performance(self, frame: Frame):
        return {"std_deviation": self.std_deviation, "pve": self.pve, "cum_pve": self.cum_pve}


class PCA(ModelBuilder):
    algo_name = "pca"

    def __init__(self, params: Optional[PCAParameters] = None, **kw) -> None:
        super().__init__(params or PCAParameters(**kw))

    def _fit(self, frame: Frame, valid: Optional[Frame],
             device: torch.device) -> PCAModel:
        p: PCAParameters = self.params
        standardize = p.transform == "standardize"
        info = build_data_info(
            frame, y=None, ignored=p.ignored_columns,
            standardize=standardize, use_all_factor_levels=p.use_all_factor_levels,
        )
        X, _ = expand_matrix(info, frame, dtype=np.float32)
        # hex/DataInfo TransformType: STANDARDIZE happens inside
        # expand_matrix; DEMEAN centers only; DESCALE scales only
        tsub = tmul = None
        if p.transform == "demean":
            tsub = X.mean(axis=0, keepdims=True)
            X = X - tsub
        elif p.transform == "descale":
            sd = X.std(axis=0, ddof=1, keepdims=True)
            tmul = 1.0 / np.where(sd > 0, sd, 1.0)
            X = X * tmul
        n, D = X.shape
        k = min(p.k, D)
        model = PCAModel(p, info, device)
        model.transform_sub = tsub
        model.transform_mul = tmul

        Xd = devcache.cached(
            "pca_x", devcache.frame_token(frame),
            (p.transform, p.use_all_factor_levels, tuple(p.ignored_columns)),
            device,
            lambda: torch.from_numpy(np.ascontiguousarray(X, dtype=np.float32)).to(device),
            frame_key=getattr(frame, "key", None),
        )
        G = _gram_xx(Xd).cpu().numpy().astype(np.float64) / max(n - 1, 1)

        evals, evecs = np.linalg.eigh(G)
        order = np.argsort(evals)[::-1]
        evals = np.maximum(evals[order][:k], 0.0)
        evecs = evecs[:, order][:, :k]
        # deterministic sign: each component's largest |loading| positive
        for i in range(k):
            j = np.argmax(np.abs(evecs[:, i]))
            if evecs[j, i] < 0:
                evecs[:, i] = -evecs[:, i]
        total_var = np.trace(G)
        model.eigenvectors = evecs.astype(np.float32)
        model.std_deviation = np.sqrt(evals)
        model.pve = evals / max(total_var, 1e-300)
        model.cum_pve = np.cumsum(model.pve)
        model.training_metrics = model.model_performance(frame)
        return model


@dataclass
class SVDParameters(PCAParameters):
    nv: int = 2  # number of right singular vectors


class SVDModel(PCAModel):
    algo_name = "svd"

    def __init__(self, params, data_info, device: torch.device) -> None:
        super().__init__(params, data_info, device)
        self.d: Optional[np.ndarray] = None  # singular values
        self.v: Optional[np.ndarray] = None  # [D, nv]


class SVD(ModelBuilder):
    """SVD by the Gram's eigendecomposition (hex/svd/SVD.java)."""

    algo_name = "svd"

    def __init__(self, params: Optional[SVDParameters] = None, **kw) -> None:
        super().__init__(params or SVDParameters(**kw))

    def _fit(self, frame: Frame, valid: Optional[Frame],
             device: torch.device) -> SVDModel:
        p: SVDParameters = self.params
        inner = PCA(PCAParameters(
            k=max(p.nv, p.k), transform=p.transform,
            ignored_columns=p.ignored_columns,
            use_all_factor_levels=p.use_all_factor_levels,
        ))
        pca_model = inner._fit(frame, None, device)
        model = SVDModel(p, pca_model.data_info, device)
        n = frame.nrows  # the design's rows: expand_matrix keeps every row
        model.v = pca_model.eigenvectors
        model.d = pca_model.std_deviation * np.sqrt(max(n - 1, 1))
        model.eigenvectors = pca_model.eigenvectors
        model.transform_sub = pca_model.transform_sub
        model.transform_mul = pca_model.transform_mul
        model.std_deviation = pca_model.std_deviation
        model.pve = pca_model.pve
        model.cum_pve = pca_model.cum_pve
        model.training_metrics = {"d": model.d}
        return model
