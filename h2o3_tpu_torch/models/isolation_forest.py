"""IsolationForest — the port of ``h2o3_tpu/models/isolation_forest.py``.

Reference: ``hex/tree/isofor/IsolationForest.java``: trees grown on small
row samples with uniformly random (feature, threshold) splits; the anomaly
score normalizes the mean path length by c(sample_size),
``score = 2^(-E[path] / c(n))`` (Liu et al.).

Building is host numpy, as in the JAX package: each tree sees
``sample_size`` rows (256 by default) drawn with the same
``np.random.default_rng(seed)`` and the same mtries draws, so the tree
arrays are the JAX package's bits. Scoring, the N-scale work, is the
device program ``_path_lengths``: a heap walk over the stacked ``[T, M]``
arrays for ``max_depth`` levels, one gather of the rows' split feature per
level, NaN routing left (``~(v > t)``), and the path lengths summed tree by
tree in float32, in the JAX package's order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import ColType, Column, Frame
from h2o3_tpu_torch.models.framework import Model, ModelBuilder, ModelParameters
from h2o3_tpu_torch.models.tree.common import tree_data_info, tree_matrix


def _path_lengths(X: torch.Tensor, feat: torch.Tensor, thresh: torch.Tensor,
                  is_split: torch.Tensor, path_len: torch.Tensor,
                  max_depth: int) -> torch.Tensor:
    """Mean isolation path length per row over all trees. X:[N, F] float32;
    feat, thresh, is_split, path_len: [T, M] on X's device."""
    n = X.shape[0]
    total = torch.zeros(n, dtype=torch.float32, device=X.device)
    for tf, tt, tsp, tpl in zip(feat.long(), thresh, is_split, path_len):
        idx = torch.zeros(n, dtype=torch.long, device=X.device)
        for _ in range(max_depth):
            v = torch.gather(X, 1, tf[idx][:, None])[:, 0]
            go_left = ~(v > tt[idx])  # NaN compares False -> routes left
            nxt = 2 * idx + torch.where(go_left, 1, 2)
            idx = torch.where(tsp[idx], nxt, idx)
        total = total + tpl[idx]
    # the mean as a product with the reciprocal of the tree count: what the
    # JAX package's compiled division computes, and what the card computes
    # for a division by a scalar, so the card and the CPU give equal bits
    return total * (1.0 / feat.shape[0])


@dataclass
class IsolationForestParameters(ModelParameters):
    ntrees: int = 50
    sample_size: int = 256
    max_depth: int = 8  # reference default: ceil(log2(sample_size))
    mtries: int = -1


def _c_factor(n: float) -> float:
    """Average unsuccessful BST search length c(n) (Liu et al.; reference scoring)."""
    if n <= 1:
        return 0.0
    return 2.0 * (np.log(n - 1.0) + 0.5772156649) - 2.0 * (n - 1.0) / n


class IsolationForestModel(Model):
    algo_name = "isolationforest"

    def __init__(self, params, data_info, device: torch.device) -> None:
        super().__init__(params, data_info, device)
        self.trees = None  # (feat, thresh, is_split, path_len), each [T, M]
        self.max_depth = params.max_depth
        self._cn = 1.0

    @property
    def is_classifier(self) -> bool:
        return False

    def mean_path_lengths(self, X: np.ndarray) -> np.ndarray:
        """The device walk over ``X`` (a ``tree_matrix``), as float64."""
        dev = self.device
        arrays = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in self.trees]
        Xd = torch.from_numpy(np.ascontiguousarray(X, dtype=np.float32)).to(dev)
        return _path_lengths(Xd, *arrays, self.max_depth).cpu().numpy().astype(np.float64)

    def _predict_raw(self, frame: Frame) -> np.ndarray:
        """Anomaly score in [0,1]; higher = more anomalous."""
        mean_path = self.mean_path_lengths(tree_matrix(self.data_info, frame))
        return np.power(2.0, -mean_path / max(self._cn, 1e-9))

    def model_performance(self, frame: Frame):
        s = self._predict_raw(frame)
        return {"mean_score": float(s.mean()), "max_score": float(s.max())}

    def predict(self, frame: Frame) -> Frame:
        s = self._predict_raw(frame)
        return Frame([Column("anomaly_score", s, ColType.NUM)])


class IsolationForest(ModelBuilder):
    algo_name = "isolationforest"

    def __init__(self, params: Optional[IsolationForestParameters] = None, **kw) -> None:
        super().__init__(params or IsolationForestParameters(**kw))

    def _fit(self, frame: Frame, valid: Optional[Frame],
             device: torch.device) -> IsolationForestModel:
        p: IsolationForestParameters = self.params
        info = tree_data_info(frame, y=None, ignored=p.ignored_columns)
        X = tree_matrix(info, frame)
        n, F = X.shape
        model = IsolationForestModel(p, info, device)
        rng = np.random.default_rng(p.actual_seed())
        sample = min(p.sample_size, n)
        model._cn = _c_factor(sample)
        M = 2 ** (p.max_depth + 1) - 1

        feats = np.zeros((p.ntrees, M), np.int32)
        threshs = np.zeros((p.ntrees, M), np.float32)
        splits = np.zeros((p.ntrees, M), bool)
        plens = np.zeros((p.ntrees, M), np.float32)

        for t in range(p.ntrees):
            rows = rng.choice(n, sample, replace=False)
            self._grow(X[rows], 0, 0, rng, feats[t], threshs[t], splits[t], plens[t], p.max_depth)
        model.trees = (feats, threshs, splits, plens)
        # one full-data scoring pass serves the training metrics and the
        # summed-path-length extremes the reference keeps for MOJO scoring
        # ((max - sum) / (max - min), IsolationForestMojoModel.unifyPreds)
        mean_path = model.mean_path_lengths(X)
        total = mean_path * p.ntrees
        model.min_path_total = float(total.min())
        model.max_path_total = float(total.max())
        score = np.power(2.0, -mean_path / max(model._cn, 1e-9))
        model.training_metrics = {
            "mean_score": float(score.mean()), "max_score": float(score.max())
        }
        return model

    def _grow(self, Xn, node, depth, rng, feat, thresh, is_split, path_len, max_depth) -> None:
        m = len(Xn)
        if depth >= max_depth or m <= 1:
            path_len[node] = depth + _c_factor(m)
            return
        # a random feature with spread (from an mtries subset when set),
        # a random threshold in (min, max)
        F = Xn.shape[1]
        mtries = self.params.mtries
        cand = rng.choice(F, min(mtries, F), replace=False) if mtries > 0 else None
        for _ in range(F):
            f = rng.choice(cand) if cand is not None else rng.integers(F)
            col = Xn[:, f]
            ok = ~np.isnan(col)
            if ok.any() and np.nanmin(col) < np.nanmax(col):
                break
        else:
            path_len[node] = depth + _c_factor(m)
            return
        lo, hi = np.nanmin(col), np.nanmax(col)
        if not (hi > lo):
            path_len[node] = depth + _c_factor(m)
            return
        cut = rng.uniform(lo, hi)
        go_left = ~(col > cut)  # NaN routes left
        feat[node] = f
        thresh[node] = cut
        is_split[node] = True
        for child, rows in ((2 * node + 1, go_left), (2 * node + 2, ~go_left)):
            self._grow(Xn[rows], child, depth + 1, rng, feat, thresh, is_split, path_len,
                       max_depth)
