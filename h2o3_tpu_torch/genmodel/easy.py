"""Row-wise prediction wrapper with typed results.

Reference: ``h2o-genmodel/.../easy/EasyPredictModelWrapper.java`` — wraps a
GenModel, takes a RowData (map of column name -> value), returns typed
prediction objects (BinomialModelPrediction, RegressionModelPrediction,
MultinomialModelPrediction, ClusteringModelPrediction,
AnomalyDetectionPrediction, DimReductionModelPrediction).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from h2o3_tpu_torch.genmodel.mojo_model import (
    IsolationForestMojoModel,
    KMeansMojoModel,
    MojoModel,
    PcaMojoModel,
)


@dataclass
class BinomialModelPrediction:
    label: str
    label_index: int
    class_probabilities: List[float]


@dataclass
class MultinomialModelPrediction:
    label: str
    label_index: int
    class_probabilities: List[float]


@dataclass
class RegressionModelPrediction:
    value: float


@dataclass
class ClusteringModelPrediction:
    cluster: int
    distances: List[float] = field(default_factory=list)


@dataclass
class AnomalyDetectionPrediction:
    score: float
    normalized_score: float


@dataclass
class DimReductionModelPrediction:
    dimensions: List[float]


@dataclass
class AutoEncoderModelPrediction:
    reconstructed: List[float]
    reconstruction_error: Optional[float] = None


class EasyPredictModelWrapper:
    """easy/EasyPredictModelWrapper.java — one wrapper, typed predict_*."""

    def __init__(self, model: MojoModel, threshold: Optional[float] = None) -> None:
        self.model = model
        self.threshold = threshold

    def predict(self, row: Dict[str, Any]):
        """Dispatch on model category (EasyPredictModelWrapper.predict)."""
        m = self.model
        if isinstance(m, KMeansMojoModel):
            return self.predict_clustering(row)
        if isinstance(m, IsolationForestMojoModel):
            return self.predict_anomaly_detection(row)
        if isinstance(m, PcaMojoModel):
            return self.predict_dim_reduction(row)
        if m.meta.get("autoencoder"):
            return self.predict_autoencoder(row)
        if not m.is_classifier:
            return self.predict_regression(row)
        if m.nclasses == 2:
            return self.predict_binomial(row)
        return self.predict_multinomial(row)

    def predict_binomial(self, row: Dict[str, Any]) -> BinomialModelPrediction:
        probs = np.asarray(self.model.score0(row), dtype=np.float64)
        # label threshold priority: wrapper override > exported training
        # max-F1 threshold (matches in-cluster Model.predict) > 0.5
        thr = self.threshold
        if thr is None:
            thr = self.model.meta.get("default_threshold", 0.5)
        idx = int(probs[1] >= thr)
        dom = self.model.domain_values or ["0", "1"]
        return BinomialModelPrediction(
            label=dom[idx], label_index=idx, class_probabilities=probs.tolist()
        )

    def predict_multinomial(self, row: Dict[str, Any]) -> MultinomialModelPrediction:
        probs = np.asarray(self.model.score0(row), dtype=np.float64)
        idx = int(probs.argmax())
        dom = self.model.domain_values or [str(i) for i in range(len(probs))]
        return MultinomialModelPrediction(
            label=dom[idx], label_index=idx, class_probabilities=probs.tolist()
        )

    def predict_regression(self, row: Dict[str, Any]) -> RegressionModelPrediction:
        return RegressionModelPrediction(value=float(self.model.score0(row)))

    def predict_clustering(self, row: Dict[str, Any]) -> ClusteringModelPrediction:
        m = self.model
        cluster = int(m.score0(row))
        dists = m.distances(row)[0].tolist() if isinstance(m, KMeansMojoModel) else []
        return ClusteringModelPrediction(cluster=cluster, distances=dists)

    def predict_anomaly_detection(self, row: Dict[str, Any]) -> AnomalyDetectionPrediction:
        s = float(self.model.score0(row))
        return AnomalyDetectionPrediction(score=s, normalized_score=s)

    def predict_dim_reduction(self, row: Dict[str, Any]) -> DimReductionModelPrediction:
        return DimReductionModelPrediction(
            dimensions=np.asarray(self.model.score0(row), dtype=np.float64).tolist()
        )

    def predict_autoencoder(self, row: Dict[str, Any]) -> AutoEncoderModelPrediction:
        recon = np.asarray(self.model.score0(row), dtype=np.float64)
        X = self.model.layout.expand([row])[0]
        err = float(np.mean((recon - X) ** 2)) if recon.shape == X.shape else None
        return AutoEncoderModelPrediction(
            reconstructed=recon.tolist(), reconstruction_error=err
        )
