"""Extended Isolation Forest — the port of
``h2o3_tpu/models/ext_isolation_forest.py``.

Reference: ``hex/tree/isoforextended/ExtendedIsolationForest.java`` (a
subsample per tree, height limit ceil(log2(sample_size)), ``IsolationTree``
with a random slope n and an intercept p drawn in the subsample's bounding
box; ``extension_level`` bounds the active coordinates of n, and level 0
is the axis-aligned Isolation Forest) and
``ExtendedIsolationForestModel.java:55-68`` (``anomaly_score =
2^(-E[h]/c(psi))`` and ``mean_length``).

Every tree is a perfect binary tree of fixed height held as dense arrays
(normals [T, M, D], offsets, split flags and leaf corrections [T, M]).
Building is host numpy in float64 on each tree's subsample, with the same
``np.random.default_rng(seed)`` draws as the JAX package, so the arrays are
its bits; normals, offsets and corrections are kept as float32. Scoring is
the device program ``_path_lengths``: per level, each row's projection on
its node's normal, with the done and terminating credit rules, over
``depth + 1`` levels, summed tree by tree in float32. The rows' node
normals are gathered into one [N, D] buffer that every level reuses.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import ColType, Column, Frame
from h2o3_tpu_torch.models.data_info import build_data_info, expand_matrix
from h2o3_tpu_torch.models.framework import Model, ModelBuilder, ModelParameters
from h2o3_tpu_torch.models.isolation_forest import _c_factor


@dataclass
class ExtendedIsolationForestParameters(ModelParameters):
    ntrees: int = 100
    sample_size: int = 256
    extension_level: int = 0  # 0 .. D-1; 0 == axis-aligned IF


def _path_lengths(X: torch.Tensor, normals: torch.Tensor, offsets: torch.Tensor,
                  is_split: torch.Tensor, correction: torch.Tensor,
                  depth: int) -> torch.Tensor:
    """Mean adjusted path length over trees.

    X [N, D] float32; normals [T, M, D]; offsets [T, M]; is_split [T, M]
    bool; correction [T, M], the c(node size) credit of a terminal node.
    Nodes in heap order: root 0, children 2i+1 / 2i+2."""
    n = X.shape[0]
    total = torch.zeros(n, dtype=X.dtype, device=X.device)
    rows_normal = torch.empty_like(X)  # the rows' node normals, reused
    for nrm, off, sp, corr in zip(normals, offsets, is_split, correction):
        idx = torch.zeros(n, dtype=torch.long, device=X.device)
        length = torch.zeros(n, dtype=X.dtype, device=X.device)
        done = torch.zeros(n, dtype=torch.bool, device=X.device)
        for _ in range(depth + 1):
            torch.index_select(nrm, 0, idx, out=rows_normal)
            rows_normal.mul_(X)
            proj = rows_normal.sum(dim=1)
            go_right = proj > off[idx]
            node_split = sp[idx]
            splitting = node_split & ~done
            # a row that reaches a leaf ends there and takes its credit
            terminating = ~node_split & ~done
            length = length + torch.where(terminating, corr[idx], 0.0)
            length = length + torch.where(splitting, 1.0, 0.0)
            idx = torch.where(splitting, 2 * idx + 1 + go_right.long(), idx)
            done = done | terminating
        # a row still walking at the height limit takes its node's credit
        length = length + torch.where(done, 0.0, corr[idx])
        total = total + length
    # a product with the reciprocal, as in isolation_forest._path_lengths
    return total * (1.0 / normals.shape[0])


class ExtendedIsolationForestModel(Model):
    algo_name = "extendedisolationforest"

    def __init__(self, params, data_info, device: torch.device) -> None:
        super().__init__(params, data_info, device)
        self.normals: Optional[np.ndarray] = None
        self.offsets: Optional[np.ndarray] = None
        self.is_split: Optional[np.ndarray] = None
        self.correction: Optional[np.ndarray] = None
        self.depth: int = 0
        self.sample_size: int = 0

    @property
    def is_classifier(self) -> bool:
        return False

    def _mean_path_lengths(self, frame: Frame) -> np.ndarray:
        X, _ = expand_matrix(self.data_info, frame, dtype=np.float32)
        dev = self.device
        arrays = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in
                  (X, self.normals, self.offsets, self.is_split, self.correction)]
        return _path_lengths(*arrays, self.depth).cpu().numpy().astype(np.float64)

    def _predict_raw(self, frame: Frame) -> np.ndarray:
        mean_len = self._mean_path_lengths(frame)
        return np.power(2.0, -mean_len / _c_factor(float(self.sample_size)))

    def predict(self, frame: Frame) -> Frame:
        """['anomaly_score', 'mean_length'] (ExtendedIsolationForestModel.java:33)."""
        mean_len = self._mean_path_lengths(frame)
        score = np.power(2.0, -mean_len / _c_factor(float(self.sample_size)))
        return Frame([
            Column("anomaly_score", score, ColType.NUM),
            Column("mean_length", mean_len, ColType.NUM),
        ])


class ExtendedIsolationForest(ModelBuilder):
    algo_name = "extendedisolationforest"

    def __init__(self, params: Optional[ExtendedIsolationForestParameters] = None,
                 **kw) -> None:
        super().__init__(params or ExtendedIsolationForestParameters(**kw))

    def _fit(self, frame: Frame, valid: Optional[Frame],
             device: torch.device) -> ExtendedIsolationForestModel:
        p: ExtendedIsolationForestParameters = self.params
        info = build_data_info(frame, None, ignored=p.ignored_columns, standardize=False)
        X, _ = expand_matrix(info, frame, dtype=np.float64)
        n, d = X.shape
        if d == 0:
            raise ValueError("no usable predictor columns")
        if not (0 <= p.extension_level <= max(d - 1, 0)):
            raise ValueError(f"extension_level must be in [0, {d - 1}]")
        psi = min(p.sample_size, n)
        depth = max(int(np.ceil(np.log2(max(psi, 2)))), 1)
        m = 2 ** (depth + 1) - 1
        rng = np.random.default_rng(p.actual_seed())

        normals = np.zeros((p.ntrees, m, d))
        offsets = np.zeros((p.ntrees, m))
        is_split = np.zeros((p.ntrees, m), dtype=bool)
        correction = np.zeros((p.ntrees, m))

        for t in range(p.ntrees):
            sub = X[rng.choice(n, size=psi, replace=False)]
            _build_tree(sub, 0, depth, p.extension_level, rng,
                        normals[t], offsets[t], is_split[t], correction[t])
            if self.job:
                self.job.update((t + 1) / p.ntrees)

        model = ExtendedIsolationForestModel(p, info, device)
        model.normals = normals.astype(np.float32)
        model.offsets = offsets.astype(np.float32)
        model.is_split = is_split
        model.correction = correction.astype(np.float32)
        model.depth = depth
        model.sample_size = psi
        model.training_metrics = None
        return model


def _build_tree(pts, node, depth_left, ext, rng, normals, offsets, is_split, correction):
    """Recursive subsample split: a random slope with ext+1 active
    coordinates, the intercept uniform in the node's bounding box
    (IsolationTree semantics)."""
    m = pts.shape[0]
    if m <= 1 or depth_left == 0:
        correction[node] = _c_factor(float(m)) if m > 1 else 0.0
        return
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    if np.all(hi - lo <= 0):
        correction[node] = _c_factor(float(m))
        return
    d = pts.shape[1]
    nrm = rng.normal(size=d)
    varying = np.nonzero(hi - lo > 0)[0]
    keep = rng.choice(varying, size=min(ext + 1, varying.size), replace=False)
    mask = np.zeros(d, dtype=bool)
    mask[keep] = True
    nrm[~mask] = 0.0
    p_int = rng.uniform(lo, hi)
    proj = pts @ nrm
    thr = float(p_int @ nrm)
    right = proj > thr
    if right.all() or (~right).all():
        correction[node] = _c_factor(float(m))
        return
    normals[node] = nrm
    offsets[node] = thr
    is_split[node] = True
    _build_tree(pts[~right], 2 * node + 1, depth_left - 1, ext, rng,
                normals, offsets, is_split, correction)
    _build_tree(pts[right], 2 * node + 2, depth_left - 1, ext, rng,
                normals, offsets, is_split, correction)
