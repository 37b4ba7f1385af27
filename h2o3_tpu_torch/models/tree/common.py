"""Shared plumbing for tree models — the port of ``h2o3_tpu/models/tree/common.py``.

Matrices, distributions, monitors and the prediction path GBM, DRF and
XGBoost share. Trees consume raw (non-standardized) predictors; categoricals are
label-encoded ordinals by default or one-hot indicators with
``categorical_encoding="one_hot_explicit"``.

``tree_cache_token`` is the device frame cache's identity of a fit's bin
codes, so repeat fits on an unmutated frame reuse them.

``TreeModelBase`` adds to ``Model`` the tree models' exact SHAP
contributions (``models/tree/shap.py``) and split-count variable
importances.

Not part of this package yet: chunk-homed frames and the custom
distribution.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from h2o3_tpu_torch.frame import devcache
from h2o3_tpu_torch.frame.frame import Column, ColType, Frame
from h2o3_tpu_torch.keyed import DKV
from h2o3_tpu_torch.models import metrics as M
from h2o3_tpu_torch.models.data_info import (
    DataInfo,
    _align_codes,
    build_data_info,
    response_vector,
)
from h2o3_tpu_torch.models.framework import Model


def tree_data_info(frame: Frame, y: str, ignored=()) -> DataInfo:
    """Layout for tree models: raw numerics, label-encoded categoricals."""
    return build_data_info(
        frame, y=y, ignored=ignored, standardize=False, use_all_factor_levels=True
    )


TREE_ENCODINGS = ("auto", "enum", "label_encoder", "one_hot_explicit")


def resolve_tree_encoding(categorical_encoding: str) -> str:
    """Map the categorical_encoding param to a tree matrix layout."""
    if categorical_encoding in ("auto", "enum", "label_encoder"):
        return "label_encoder"
    if categorical_encoding == "one_hot_explicit":
        return "one_hot_explicit"
    raise ValueError(
        f"categorical_encoding {categorical_encoding!r} not supported for "
        f"tree models; choose from {TREE_ENCODINGS}"
    )


def tree_feature_names(info: DataInfo, encoding: str = "label_encoder") -> List[str]:
    """Feature names in tree_matrix column order (one-hot expands levels)."""
    names: List[str] = []
    for name in info.predictor_names:
        if encoding == "one_hot_explicit" and name in info.cat_domains:
            names += [f"{name}.{lv}" for lv in info.cat_domains[name]]
        else:
            names.append(name)
    return names


def tree_matrix(
    info: DataInfo, frame: Frame, encoding: str = "label_encoder"
) -> np.ndarray:
    """[N, F] float32 raw-feature matrix; NaN for NA.

    label_encoder: cat codes as ordinals (one column per predictor).
    one_hot_explicit: one 0/1 column per level; an NA row is NaN across the
    whole block so NA routing still learns a default direction per split.
    """
    cols = []
    for name in info.predictor_names:
        col = frame.col(name)
        if name in info.cat_domains:
            codes = _align_codes(col, info.cat_domains[name])
            if encoding == "one_hot_explicit":
                dom = info.cat_domains[name]
                block = (codes[:, None] == np.arange(len(dom))[None, :]).astype(
                    np.float32
                )
                block[codes < 0] = np.nan
                cols.append(block)
            else:
                cols.append(
                    np.where(codes >= 0, codes.astype(np.float32), np.nan)[:, None]
                )
        else:
            cols.append(col.numeric_view().astype(np.float32)[:, None])
    return np.concatenate(cols, axis=1)


# -- distributions (hex/Distribution.java families) ---------------------------


def sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def softmax(m):
    z = m - m.max(axis=1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=1, keepdims=True)


def _no_custom(distribution: str) -> None:
    if distribution.partition(":")[0] == "custom":
        raise NotImplementedError(
            "custom distributions are not ported to h2o3_tpu_torch yet "
            "(ROADMAP A11: udf)")


def _wmean(y: np.ndarray, w: Optional[np.ndarray]) -> float:
    if w is None:
        return float(np.nanmean(y))
    m = ~np.isnan(y)
    return float(np.average(y[m], weights=w[m]))


def _family_param(params, field: str, distribution: str) -> float:
    """A family parameter must exist on the algorithm's Parameters dataclass —
    a builder that lists a distribution but lacks its parameter would
    otherwise silently train with a hardcoded default (the
    accepted-and-ignored failure mode the param guard exists to prevent)."""
    val = getattr(params, field, None)
    if val is None:
        raise ValueError(
            f"distribution {distribution!r} needs parameter {field!r}, which "
            f"{type(params).__name__} does not declare"
        )
    return float(val)


def resolve_objective(distribution: str, params, y: np.ndarray) -> str:
    """Builder distribution name -> booster objective string, folding the
    family parameter in (``hex/Distribution.java``'s per-family params).
    huber: delta is the huber_alpha quantile of |y - median(y)| residuals."""
    _no_custom(distribution)
    if distribution == "gamma":
        if np.nanmin(y) <= 0:
            raise ValueError("gamma requires a strictly positive response")
    elif distribution in ("poisson", "tweedie"):
        if np.nanmin(y) < 0:
            raise ValueError(f"{distribution} requires a non-negative response")
    if distribution == "tweedie":
        pw = _family_param(params, "tweedie_power", distribution)
        if not 1.0 < pw < 2.0:
            raise ValueError(f"tweedie_power must be in (1, 2), got {pw}")
        return f"tweedie:{pw}"
    if distribution == "quantile":
        alpha = _family_param(params, "quantile_alpha", distribution)
        if not 0.0 < alpha < 1.0:
            raise ValueError(f"quantile_alpha must be in (0, 1), got {alpha}")
        return f"quantile:{alpha}"
    if distribution == "huber":
        ha = _family_param(params, "huber_alpha", distribution)
        r = np.abs(y - np.nanmedian(y))
        delta = max(float(np.nanquantile(r, ha)), 1e-10)
        return f"huber:{delta:.8g}"
    return distribution


def init_margin(
    distribution: str, y: np.ndarray, nclasses: int,
    weights: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Initial margin f0 (SharedTree init: response moments / priors),
    weighted when an observation-weights column is in play."""
    _no_custom(distribution)
    name, _, arg = distribution.partition(":")
    if name in ("gaussian", "huber"):
        return np.array([_wmean(y, weights)])
    if name == "bernoulli":
        p = _wmean(y, weights)
        p = min(max(p, 1e-10), 1 - 1e-10)
        return np.array([np.log(p / (1 - p))])
    if name == "multinomial":
        m = ~np.isnan(y)
        w = weights[m] if weights is not None else None
        pri = np.bincount(
            y[m].astype(np.int64), weights=w, minlength=nclasses
        ).astype(np.float64)
        pri = np.maximum(pri / pri.sum(), 1e-10)
        return np.log(pri)
    if name in ("poisson", "gamma", "tweedie"):
        return np.array([np.log(max(_wmean(y, weights), 1e-10))])
    if name == "laplace" or distribution == "quantile_0.5":
        return np.array([float(np.nanmedian(y))])
    if name == "quantile":
        return np.array([float(np.nanquantile(y, float(arg)))])
    raise ValueError(f"unknown distribution {distribution!r}")


def margin_to_probs(distribution: str, margin: np.ndarray) -> np.ndarray:
    if distribution == "bernoulli":
        p = sigmoid(margin[:, 0])
        return np.stack([1 - p, p], axis=1)
    if distribution == "multinomial":
        return softmax(margin)
    return margin  # regression: identity


def link_inverse(distribution: str, margin: np.ndarray) -> np.ndarray:
    """Regression margin -> response scale (Distribution.linkInv): the
    log-link families train on log(mu), predictions report mu."""
    name = distribution.partition(":")[0]
    if name in ("poisson", "gamma", "tweedie"):
        return np.exp(margin)
    return margin


def auto_distribution(nclasses: int) -> str:
    if nclasses == 2:
        return "bernoulli"
    if nclasses > 2:
        return "multinomial"
    return "gaussian"


def training_score(
    distribution: str, y: np.ndarray, margin: np.ndarray,
    weights: Optional[np.ndarray] = None,
) -> float:
    """Scalar stopping metric from the current margin (deviance-flavored,
    weighted mean when observation weights are in play)."""

    def wavg(v):
        return float(np.average(v, weights=weights))

    name, _, arg = distribution.partition(":")
    if name == "bernoulli":
        p = np.clip(sigmoid(margin[:, 0]), 1e-15, 1 - 1e-15)
        return wavg(-(y * np.log(p) + (1 - y) * np.log(1 - p)))
    if name == "multinomial":
        p = softmax(margin)
        return wavg(-np.log(np.clip(p[np.arange(len(y)), y.astype(np.int64)], 1e-15, 1)))
    if name == "poisson":
        mu = np.exp(margin[:, 0])
        return wavg(2 * (np.where(y > 0, y * np.log(np.where(y > 0, y, 1) / mu), 0) - (y - mu)))
    if name == "gamma":
        mu = np.maximum(np.exp(margin[:, 0]), 1e-15)
        ys = np.maximum(y, 1e-15)
        return wavg(2 * (ys / mu - np.log(ys / mu) - 1))
    if name == "tweedie":
        pw = float(arg)
        mu = np.maximum(np.exp(margin[:, 0]), 1e-15)
        return wavg(
            2 * (
                np.power(np.maximum(y, 0), 2 - pw) / ((1 - pw) * (2 - pw))
                - y * np.power(mu, 1 - pw) / (1 - pw)
                + np.power(mu, 2 - pw) / (2 - pw)
            )
        )
    if name == "huber":
        delta = float(arg)
        r = np.abs(margin[:, 0] - y)
        return wavg(np.where(r <= delta, 0.5 * r * r, delta * (r - 0.5 * delta)))
    if name == "laplace":
        return wavg(np.abs(margin[:, 0] - y))
    if name == "quantile" or distribution == "quantile_0.5":
        alpha = float(arg) if arg else 0.5
        r = y - margin[:, 0]
        return wavg(np.where(r >= 0, alpha * r, (alpha - 1) * r))
    return wavg((margin[:, 0] - y) ** 2)


def tree_cache_token(frame: Frame, p, encoding: str):
    """Device frame cache identity of a booster's bin-code placement.

    The binned matrix is a function of the frame's column versions, the
    categorical encoding, and the params that shape X and the keep mask
    (ignored, response, weights and offset columns) only: it does not
    depend on the algorithm, so GBM, DRF and XGBoost fits on one frame with
    one binning spec share one entry. Returns None (cache bypass) for
    frames without version stamps."""
    tok = devcache.frame_token(frame)
    if tok is None:
        return None
    return (
        tok, encoding, tuple(p.ignored_columns), p.response_column,
        getattr(p, "weights_column", None),
        getattr(p, "offset_column", None),
    )


def extract_weights(frame: Frame, p, keep: np.ndarray):
    """Load + validate weights_column, folding zero/NA-weight rows into the
    keep mask (dropping them is equivalent to the reference's zero
    contribution). Returns the [N] weights or None; index with keep after."""
    if not p.weights_column:
        return None
    weights = frame.col(p.weights_column).numeric_view().astype(np.float64)
    if np.nanmin(weights) < 0:
        raise ValueError("weights_column must be non-negative")
    keep &= ~np.isnan(weights) & (weights > 0)
    return weights


def tree_fit_setup(frame: Frame, p, model_cls, use_offset: bool,
                   device: torch.device):
    """Shared GBM/XGBoost front half of _fit: layout, matrices, aux columns,
    objective resolution, init margin, monotone validation.

    Returns (model, X, y, weights, offset, objective, f0, n_class_trees,
    mono) with the keep mask (NA response / zero-weight / NA-offset rows)
    already applied to X/y/weights/offset."""
    ignored = list(p.ignored_columns)
    aux_cols = [p.weights_column] + ([p.offset_column] if use_offset else [])
    for aux in aux_cols:
        if aux and aux not in ignored:
            ignored.append(aux)
    info = tree_data_info(frame, p.response_column, ignored)
    y = response_vector(info, frame)
    nclasses = len(info.response_domain) if info.response_domain else 1
    dist = auto_distribution(nclasses) if p.distribution == "auto" else p.distribution

    model = model_cls(p, info, dist, device)
    enc = model.tree_encoding
    X = tree_matrix(info, frame, encoding=enc)
    keep = ~np.isnan(y)
    weights = extract_weights(frame, p, keep)
    offset = None
    if use_offset and p.offset_column:
        offset = frame.col(p.offset_column).numeric_view().astype(np.float64)
        keep &= ~np.isnan(offset)
    X, y = X[keep], y[keep]
    if weights is not None:
        weights = weights[keep]
    if offset is not None:
        offset = offset[keep]

    objective = resolve_objective(dist, p, y)
    f0 = init_margin(objective, y, nclasses, weights=weights)
    n_class_trees = nclasses if dist == "multinomial" else 1
    mono = monotone_array(getattr(p, "monotone_constraints", None), info, enc)
    if mono is not None and dist == "multinomial":
        raise ValueError("monotone_constraints not supported for multinomial")
    return model, X, y, weights, offset, objective, f0, n_class_trees, mono


def finish_tree_fit(model, frame: Frame, valid: Optional[Frame]):
    """The end of a GBM/XGBoost/DRF ``_fit``: the trees built, then the
    training (and validation) metrics, their scoring pass timed as
    ``metrics_s``."""
    model.ntrees_built = model.booster.trees_per_class[0].ntrees
    t0 = time.time()
    model.training_metrics = model.model_performance(frame)
    model.timings["metrics_s"] = time.time() - t0
    if valid is not None:
        model.validation_metrics = model.model_performance(valid)
    return model


def make_tree_monitor(model, p, objective, y, weights, history):
    """ScoreKeeper monitor shared by GBM/XGBoost: wall-clock budget
    (max_runtime_secs) + stopping_rounds early stopping. Returns
    (monitor_or_None, score_interval)."""
    import time as _time

    from h2o3_tpu_torch.models.tree.booster import DEFAULT_TREE_BLOCK

    deadline = (_time.time() + p.max_runtime_secs) if p.max_runtime_secs > 0 else None

    def monitor(t: int, margin: np.ndarray) -> bool:
        model.ntrees_built = t + 1
        if deadline is not None and _time.time() >= deadline:
            return True
        if p.stopping_rounds <= 0 or (t + 1) % p.score_tree_interval:
            return False
        history.append(training_score(objective, y, margin, weights=weights))
        model.scoring_history.append({"tree": t + 1, "score": history[-1]})
        return M.stop_early(
            history, p.stopping_rounds, more_is_better=False,
            stopping_tolerance=p.stopping_tolerance,
        )

    if p.stopping_rounds > 0:
        return monitor, p.score_tree_interval
    if deadline is not None:
        return monitor, max(p.score_tree_interval, DEFAULT_TREE_BLOCK)
    return None, p.score_tree_interval


def checkpoint_booster(
    p, n_class_trees: int, algo_name: str = None,
    n_features: int = None, encoding: str = None,
):
    """Resolve the ``checkpoint`` param to the prior model's booster
    (checkpoint-continue, ``hex/tree/SharedTree.java:131-136``). The
    reference validates that non-modifiable params match the checkpoint
    (CheckpointUtils); here: same algo, class count, depth, binning, and
    feature layout (count + categorical encoding) — trees from two
    different layouts index features incompatibly."""
    if not p.checkpoint:
        return None
    prior = DKV.get(p.checkpoint)
    if prior is None:
        raise ValueError(f"checkpoint model {p.checkpoint!r} not found")
    b = getattr(prior, "booster", None)
    if b is None:
        raise ValueError(f"checkpoint model {p.checkpoint!r} is not a tree model")
    if algo_name is not None and getattr(prior, "algo_name", None) != algo_name:
        raise ValueError(
            f"checkpoint model is {getattr(prior, 'algo_name', '?')!r}, "
            f"cannot continue it as {algo_name!r}"
        )
    if b.nclasses_trees != n_class_trees:
        raise ValueError("checkpoint class count differs from this training frame")
    t0 = b.trees_per_class[0]
    if t0.max_depth != p.max_depth:
        raise ValueError(
            f"checkpoint max_depth={t0.max_depth} differs from requested {p.max_depth}"
        )
    if t0.n_bins1 != p.nbins + 1:
        raise ValueError(
            f"checkpoint nbins={t0.n_bins1 - 1} differs from requested {p.nbins}"
        )
    if n_features is not None and t0.edges.shape[0] != n_features:
        raise ValueError(
            f"checkpoint was trained on {t0.edges.shape[0]} tree features, "
            f"this frame/encoding produces {n_features}"
        )
    prior_enc = getattr(prior, "tree_encoding", None)
    if encoding is not None and prior_enc is not None and prior_enc != encoding:
        raise ValueError(
            f"checkpoint categorical_encoding={prior_enc!r} differs from "
            f"requested {encoding!r}"
        )
    return b


def extra_trees(p, n_class_trees: int) -> int:
    """Trees still to build on top of the checkpoint; ``ntrees`` is the TOTAL
    (reference: restart validation requires ntrees > checkpoint's)."""
    b = checkpoint_booster(p, n_class_trees)
    if b is None:
        return p.ntrees
    built = b.trees_per_class[0].ntrees
    if p.ntrees <= built:
        raise ValueError(
            f"checkpoint already has {built} trees; ntrees={p.ntrees} must exceed it"
        )
    return p.ntrees - built


def monotone_array(
    constraints: Optional[dict], info: DataInfo, encoding: str
) -> Optional[np.ndarray]:
    """monotone_constraints dict {col: ±1} -> per-tree-feature int array.

    Reference semantics (hex/tree/gbm/GBM.java monotone validation):
    constraints apply to numeric predictors only; unknown columns and
    categorical columns are errors, not silently dropped."""
    if not constraints:
        return None
    names = tree_feature_names(info, encoding)
    arr = np.zeros(len(names), dtype=np.int32)
    for col, direction in constraints.items():
        if direction not in (-1, 0, 1):
            raise ValueError(
                f"monotone_constraints[{col!r}] must be -1, 0 or 1, got {direction!r}"
            )
        if col in info.cat_domains:
            raise ValueError(
                f"monotone_constraints not supported on categorical column {col!r}"
            )
        if col not in names:
            raise ValueError(f"monotone_constraints column {col!r} not in predictors")
        arr[names.index(col)] = direction
    return arr


class TreeModelBase(Model):
    """Common prediction path for GBM/DRF/XGBoost models."""

    def __init__(self, params, data_info, distribution: str,
                 device: torch.device):
        super().__init__(params, data_info, device)
        self.distribution = distribution
        self.booster = None  # BoostedTrees
        self.ntrees_built = 0
        #: fit wall seconds: setup_s (``tree_fit_setup``: layout, matrix,
        #: targets), prep_s (the booster's set-up: bins_s for ``make_bins``,
        #: place_s for the bin codes made and placed, the rest for y, the
        #: starting margin and the other uploads), train_s (boosting),
        #: metrics_s (the training-metrics scoring pass)
        self.timings: dict = {}
        self.tree_encoding = resolve_tree_encoding(
            getattr(params, "categorical_encoding", "auto"))

    def _predict_raw(self, frame: Frame) -> np.ndarray:
        X = tree_matrix(self.data_info, frame, encoding=self.tree_encoding)
        margin = self.booster.predict_margin(X)
        off = getattr(self.params, "offset_column", None)
        if off:
            # Model.score: the scoring frame's offset column shifts the margin
            if off not in frame.names:
                raise ValueError(
                    f"offset_column {off!r} must be present in the scoring frame")
            off_vals = frame.col(off).numeric_view()
            if np.isnan(off_vals).any():
                raise ValueError(
                    f"offset_column {off!r} has NA values in the scoring frame")
            margin = margin + off_vals[:, None]
        return self._raw_from_margin(margin)

    def _raw_from_margin(self, margin: np.ndarray) -> np.ndarray:
        """Raw scores (probabilities / inverse-linked response) from the
        ensemble margin; DRF overrides it (its margin is averaged leaves)."""
        if self.is_classifier:
            return margin_to_probs(self.distribution, margin)
        return link_inverse(self.distribution, margin[:, 0])


    def predict_contributions(self, frame: Frame, background_frame=None) -> Frame:
        """Exact per-feature SHAP contributions on the margin scale
        (Model.scoreContributions / TreeSHAPPredictor): one column per tree
        feature plus BiasTerm; rows sum to the raw margin."""
        from h2o3_tpu_torch.models.tree.shap import predict_contributions as _pc

        contribs = _pc(self, frame, background_frame=background_frame)
        names = tree_feature_names(self.data_info, self.tree_encoding)
        cols = [
            Column(names[j], contribs[:, j], ColType.NUM)
            for j in range(len(names))
        ]
        cols.append(Column("BiasTerm", contribs[:, -1], ColType.NUM))
        return Frame(cols)

    def variable_importances(self) -> dict:
        """Relative split counts per tree feature, summing to 1 (the
        SharedTree varimp analogue)."""
        names = tree_feature_names(self.data_info, self.tree_encoding)
        imp = np.zeros(len(names))
        for trees in self.booster.trees_per_class:
            for t in range(trees.ntrees):
                sp = trees.is_split[t]
                feats = trees.feat[t][sp]
                np.add.at(imp, feats, 1.0)
        total = imp.sum()
        rel = imp / total if total > 0 else imp
        return dict(zip(names, rel.tolist()))
