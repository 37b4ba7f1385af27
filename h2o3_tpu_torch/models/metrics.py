"""Model metrics — the port of ``h2o3_tpu/models/metrics.py``.

Regression, binomial and multinomial metrics and ScoreKeeper early
stopping, computed in numpy on the host from gathered predictions, with the
JAX package's definitions: ``hex/ModelMetrics*.java``, exact AUC as
``AUC2.perfectAUC`` (``nbins=0``) or the 400-bin approximation of
``AUC2.java:36``, the max-F1 threshold of ``AUC2.defaultThreshold``.

Also the scoring record a REST route keeps (``ScoringRecord``) and
``make_metrics``, metrics from raw predictions and actuals with no model;
its non-gaussian regression deviance is the GLM's ``deviance``
(``models/glm.py``) at the GLM's default parameters.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# shared helpers


def _weighted(x: np.ndarray, w: Optional[np.ndarray]) -> Tuple[np.ndarray, float]:
    if w is None:
        w = np.ones_like(x, dtype=np.float64)
    return w.astype(np.float64), float(w.sum())


# ---------------------------------------------------------------------------
# regression


@dataclass
class RegressionMetrics:
    mse: float
    rmse: float
    mae: float
    rmsle: float
    mean_residual_deviance: float
    r2: float
    nobs: int

    def __repr__(self) -> str:
        return (
            f"RegressionMetrics(rmse={self.rmse:.6g}, mse={self.mse:.6g}, "
            f"mae={self.mae:.6g}, r2={self.r2:.4f}, "
            f"mean_residual_deviance={self.mean_residual_deviance:.6g})"
        )


def regression_metrics(
    actual: np.ndarray,
    predicted: np.ndarray,
    weights: Optional[np.ndarray] = None,
    deviance: Optional[np.ndarray] = None,
) -> RegressionMetrics:
    y = np.asarray(actual, dtype=np.float64)
    p = np.asarray(predicted, dtype=np.float64)
    ok = ~(np.isnan(y) | np.isnan(p))
    y, p = y[ok], p[ok]
    w, wsum = _weighted(y, None if weights is None else np.asarray(weights)[ok])
    err = y - p
    mse = float(np.sum(w * err**2) / wsum)
    mae = float(np.sum(w * np.abs(err)) / wsum)
    if np.all(y >= 0) and np.all(p >= 0):
        rmsle = float(np.sqrt(np.sum(w * (np.log1p(p) - np.log1p(y)) ** 2) / wsum))
    else:
        rmsle = float("nan")
    ybar = float(np.sum(w * y) / wsum)
    ss_tot = float(np.sum(w * (y - ybar) ** 2))
    r2 = 1.0 - np.sum(w * err**2) / ss_tot if ss_tot > 0 else float("nan")
    mrd = (
        float(np.sum(w * deviance[ok]) / wsum)
        if deviance is not None
        else mse  # gaussian deviance == squared error (hex/Distribution.java)
    )
    return RegressionMetrics(
        mse=mse,
        rmse=float(np.sqrt(mse)),
        mae=mae,
        rmsle=rmsle,
        mean_residual_deviance=mrd,
        r2=float(r2),
        nobs=int(len(y)),
    )


# ---------------------------------------------------------------------------
# binomial


@dataclass
class ConfusionMatrix:
    """2x2 at a threshold: [[tn, fp], [fn, tp]] (hex/ConfusionMatrix.java layout
    is domain x domain with actual rows, predicted columns)."""

    tn: float
    fp: float
    fn: float
    tp: float
    threshold: float

    @property
    def table(self) -> np.ndarray:
        return np.array([[self.tn, self.fp], [self.fn, self.tp]])

    @property
    def accuracy(self) -> float:
        t = self.tn + self.fp + self.fn + self.tp
        return (self.tn + self.tp) / t if t else float("nan")

    @property
    def precision(self) -> float:
        d = self.tp + self.fp
        return self.tp / d if d else float("nan")

    @property
    def recall(self) -> float:
        d = self.tp + self.fn
        return self.tp / d if d else float("nan")

    @property
    def specificity(self) -> float:
        d = self.tn + self.fp
        return self.tn / d if d else float("nan")

    @property
    def f1(self) -> float:
        p, r = self.precision, self.recall
        return 2 * p * r / (p + r) if (p + r) else float("nan")

    @property
    def mcc(self) -> float:
        d = np.sqrt(
            (self.tp + self.fp) * (self.tp + self.fn) * (self.tn + self.fp) * (self.tn + self.fn)
        )
        return ((self.tp * self.tn - self.fp * self.fn) / d) if d else float("nan")


@dataclass
class BinomialMetrics:
    auc: float
    pr_auc: float
    gini: float
    logloss: float
    mse: float
    rmse: float
    mean_per_class_error: float
    max_f1_threshold: float
    cm: ConfusionMatrix
    nobs: int
    thresholds: np.ndarray = field(default_factory=lambda: np.empty(0), repr=False)
    tps: np.ndarray = field(default_factory=lambda: np.empty(0), repr=False)
    fps: np.ndarray = field(default_factory=lambda: np.empty(0), repr=False)

    def confusion_matrix(self, threshold: Optional[float] = None) -> ConfusionMatrix:
        return self.cm if threshold is None else _cm_at(self.thresholds, self.tps, self.fps, self._p, self._n, threshold)

    _p: float = 0.0
    _n: float = 0.0

    def __repr__(self) -> str:
        return (
            f"BinomialMetrics(auc={self.auc:.6f}, logloss={self.logloss:.6f}, "
            f"pr_auc={self.pr_auc:.6f}, rmse={self.rmse:.6g}, "
            f"max_f1_threshold={self.max_f1_threshold:.4f})"
        )


def _roc_points(
    actual: np.ndarray, prob: np.ndarray, weights: Optional[np.ndarray], nbins: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, float, float]:
    """Sorted-descending unique thresholds with cumulative tp/fp counts.

    nbins=0 → exact (one threshold per distinct score, AUC2.perfectAUC);
    nbins=400 → the reference's histogram approximation (AUC2.java:36).
    """
    y = np.asarray(actual, dtype=np.float64)
    p = np.asarray(prob, dtype=np.float64)
    ok = ~(np.isnan(y) | np.isnan(p))
    y, p = y[ok], p[ok]
    w, _ = _weighted(y, None if weights is None else np.asarray(weights)[ok])
    if nbins and len(np.unique(p)) > nbins:
        # histogram thresholds: uniform quantile-ish bin centers over score range
        edges = np.quantile(p, np.linspace(0, 1, nbins + 1))
        centers = np.unique(edges)
        idx = np.clip(np.searchsorted(centers, p, side="right") - 1, 0, len(centers) - 1)
        p = centers[idx]
    order = np.argsort(-p, kind="stable")
    ps, ys, ws = p[order], y[order], w[order]
    pos_w = np.where(ys > 0.5, ws, 0.0)
    neg_w = np.where(ys > 0.5, 0.0, ws)
    cum_tp = np.cumsum(pos_w)
    cum_fp = np.cumsum(neg_w)
    # keep last occurrence of each distinct threshold
    last = np.ones(len(ps), dtype=bool)
    last[:-1] = ps[:-1] != ps[1:]
    return ps[last], cum_tp[last], cum_fp[last], float(pos_w.sum()), float(neg_w.sum())


def _cm_at(ths, tps, fps, P, N, threshold) -> ConfusionMatrix:
    i = np.searchsorted(-ths, -threshold, side="right") - 1
    tp = tps[i] if i >= 0 else 0.0
    fp = fps[i] if i >= 0 else 0.0
    return ConfusionMatrix(tn=N - fp, fp=fp, fn=P - tp, tp=tp, threshold=float(threshold))


def binomial_metrics(
    actual: np.ndarray,
    prob: np.ndarray,
    weights: Optional[np.ndarray] = None,
    nbins: int = 0,
) -> BinomialMetrics:
    """Binomial metrics from actual labels {0,1} and P(class=1)."""
    y = np.asarray(actual, dtype=np.float64)
    p = np.asarray(prob, dtype=np.float64)
    ok = ~(np.isnan(y) | np.isnan(p))
    y, p = y[ok], p[ok]
    w, wsum = _weighted(y, None if weights is None else np.asarray(weights)[ok])

    ths, tps, fps, P, N = _roc_points(y, p, w, nbins)
    if P == 0 or N == 0:
        auc = pr = float("nan")
    else:
        tpr = np.concatenate([[0.0], tps / P])
        fpr = np.concatenate([[0.0], fps / N])
        auc = float(np.trapezoid(tpr, fpr))
        prec = tps / np.maximum(tps + fps, 1e-300)
        rec = tps / P
        # PR-AUC by trapezoid over recall (reference pr_auc, AUC2.java:288)
        pr = float(np.trapezoid(np.concatenate([[prec[0]], prec]), np.concatenate([[0.0], rec])))

    eps = 1e-15
    pc = np.clip(p, eps, 1 - eps)
    logloss = float(np.sum(w * -(y * np.log(pc) + (1 - y) * np.log(1 - pc))) / wsum)
    mse = float(np.sum(w * (y - p) ** 2) / wsum)

    # max-F1 threshold scan (default threshold, AUC2 ThresholdCriterion.f1)
    if P > 0 and N > 0 and len(ths):
        precs = tps / np.maximum(tps + fps, 1e-300)
        recs = tps / P
        f1s = np.where(precs + recs > 0, 2 * precs * recs / np.maximum(precs + recs, 1e-300), 0.0)
        best = int(np.argmax(f1s))
        thr = float(ths[best])
    else:
        thr = 0.5
    cm = _cm_at(ths, tps, fps, P, N, thr) if len(ths) else ConfusionMatrix(N, 0, P, 0, thr)
    tpr_ = cm.tp / P if P else float("nan")
    tnr_ = cm.tn / N if N else float("nan")
    mpce = float(1 - (tpr_ + tnr_) / 2)

    m = BinomialMetrics(
        auc=auc,
        pr_auc=pr,
        gini=2 * auc - 1 if auc == auc else float("nan"),
        logloss=logloss,
        mse=mse,
        rmse=float(np.sqrt(mse)),
        mean_per_class_error=mpce,
        max_f1_threshold=thr,
        cm=cm,
        nobs=int(len(y)),
        thresholds=ths,
        tps=tps,
        fps=fps,
    )
    m._p, m._n = P, N
    return m


# ---------------------------------------------------------------------------
# multinomial


@dataclass
class MultinomialMetrics:
    logloss: float
    mse: float
    rmse: float
    mean_per_class_error: float
    confusion_matrix: np.ndarray
    hit_ratios: np.ndarray  # top-k hit ratio, k=1..K (hex/HitRatio semantics)
    domain: List[str]
    nobs: int

    def __repr__(self) -> str:
        return (
            f"MultinomialMetrics(logloss={self.logloss:.6f}, "
            f"mean_per_class_error={self.mean_per_class_error:.4f}, "
            f"top1={self.hit_ratios[0]:.4f})"
        )


def multinomial_metrics(
    actual: np.ndarray,
    probs: np.ndarray,
    domain: List[str],
    weights: Optional[np.ndarray] = None,
    max_hit_ratio_k: int = 10,
) -> MultinomialMetrics:
    """actual: int class ids [N]; probs: [N, K] class probabilities."""
    y = np.asarray(actual)
    P = np.asarray(probs, dtype=np.float64)
    ok = y >= 0
    y, P = y[ok].astype(np.int64), P[ok]
    w, wsum = _weighted(y.astype(np.float64), None if weights is None else np.asarray(weights)[ok])
    K = P.shape[1]
    eps = 1e-15
    py = np.clip(P[np.arange(len(y)), y], eps, 1.0)
    logloss = float(np.sum(w * -np.log(py)) / wsum)
    # MSE over the 1-of-K residual (reference ModelMetricsMultinomial)
    onehot = np.zeros_like(P)
    onehot[np.arange(len(y)), y] = 1.0
    mse = float(np.sum(w[:, None] * (onehot - P) ** 2) / wsum)
    pred = P.argmax(axis=1)
    cm = np.zeros((K, K), dtype=np.float64)
    np.add.at(cm, (y, pred), w)
    row = cm.sum(axis=1)
    per_class_err = np.where(row > 0, 1 - np.diag(cm) / np.maximum(row, 1e-300), np.nan)
    mpce = float(np.nanmean(per_class_err))
    # top-k hit ratios
    kk = min(max_hit_ratio_k, K)
    ranks = np.argsort(-P, axis=1)[:, :kk]
    hits = ranks == y[:, None]
    hr = (hits.astype(np.float64) * w[:, None]).sum(axis=0) if len(y) else np.zeros(kk)
    hit_ratios = np.cumsum(hr) / wsum
    return MultinomialMetrics(
        logloss=logloss,
        mse=mse,
        rmse=float(np.sqrt(mse)),
        mean_per_class_error=mpce,
        confusion_matrix=cm,
        hit_ratios=hit_ratios,
        domain=list(domain),
        nobs=int(len(y)),
    )


# ---------------------------------------------------------------------------
# early stopping — exact ScoreKeeper.stopEarly semantics


def stop_early(
    history: List[float],
    stopping_rounds: int,
    more_is_better: bool,
    stopping_tolerance: float,
) -> bool:
    """Replicates hex/ScoreKeeper.stopEarly (ScoreKeeper.java:261-337):
    k+1 simple moving averages of window k over the last 2k scoring events
    (skipping the first event); converged when the best of the k new averages
    fails to improve on the reference average by rel tolerance."""
    k = stopping_rounds
    if k == 0:
        return False
    if len(history) - 1 < 2 * k:
        return False
    vals = np.asarray(history, dtype=np.float64)
    mov = np.empty(k + 1)
    for i in range(k + 1):
        start = len(vals) - 2 * k + i
        mov[i] = vals[start : start + k].mean()
        if np.isnan(mov[i]):
            return False
    last_before = mov[0]
    min_in, max_in = mov[1:].min(), mov[1:].max()
    if not more_is_better and last_before == 0.0:
        return True  # converged to lower bound
    if np.sign(mov.max()) != np.sign(mov.min()):
        return False  # zero crossing — don't divide
    if more_is_better:
        ratio = max_in / last_before
        return bool(not np.isnan(ratio) and ratio <= 1 + stopping_tolerance)
    ratio = min_in / last_before
    return bool(not np.isnan(ratio) and ratio >= 1 - stopping_tolerance)


# ---------------------------------------------------------------------------
# scoring records + makeMetrics


@dataclass
class ScoringRecord:
    """A cached scoring result (``hex/ModelMetrics.java`` ``buildKey``):
    scoring a frame with a model leaves its metrics keyed by (model,
    frame), which the ModelMetrics routes fetch, filter and delete."""

    model_id: str
    frame_id: str
    metrics: object
    model_category: str
    scoring_time: float

    @staticmethod
    def key_for(model_id: str, frame_id: str) -> str:
        return f"modelmetrics_{model_id}@{frame_id}"


def make_metrics(
    predictions: np.ndarray,
    actuals: np.ndarray,
    domain: Optional[List[str]] = None,
    distribution: str = "gaussian",
    weights: Optional[np.ndarray] = None,
):
    """Metrics from raw predictions and actuals with no model
    (``ModelMetricsHandler.make``, the ``h2o.make_metrics`` call): a domain
    means classification (binomial for 2 levels, multinomial above),
    otherwise regression under ``distribution``.

    Column conventions are the reference's: regression takes one column;
    binomial takes p1, [p0 p1] or [predict p0 p1]; multinomial K or 1+K
    columns (a leading label column is dropped)."""
    P = np.asarray(predictions, dtype=np.float64)
    if P.ndim == 1:
        P = P[:, None]
    if domain is None:
        if P.shape[1] != 1:
            raise ValueError(
                f"regression expects 1 prediction column, got {P.shape[1]}")
        y = np.asarray(actuals, dtype=np.float64)
        dev = None
        if distribution and distribution != "gaussian":
            from h2o3_tpu_torch.models.glm import GLMParameters, deviance

            dev = deviance(distribution, y, P[:, 0],
                           GLMParameters(response_column=""))
        return regression_metrics(y, P[:, 0], weights=weights, deviance=dev)
    K = len(domain)
    if K == 2:
        if P.shape[1] == 1:
            p1 = P[:, 0]
        elif P.shape[1] == 2:
            p1 = P[:, 1]
        elif P.shape[1] == 3:
            p1 = P[:, 2]
        else:
            raise ValueError(
                f"binomial expects 1, 2 or 3 prediction columns, got {P.shape[1]}")
        return binomial_metrics(np.asarray(actuals, dtype=np.float64), p1,
                                weights=weights)
    if P.shape[1] == K + 1:
        P = P[:, 1:]
    if P.shape[1] != K:
        raise ValueError(
            f"multinomial expects {K} or {K + 1} prediction columns, "
            f"got {P.shape[1]}")
    return multinomial_metrics(np.asarray(actuals).astype(np.int64), P,
                               domain, weights=weights)
