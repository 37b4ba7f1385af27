"""Exact per-feature prediction contributions for tree ensembles (TreeSHAP)
— the port of ``h2o3_tpu/models/tree/shap.py``.

Reference: ``h2o-genmodel/.../algos/tree/TreeSHAP.java`` /
``TreeSHAPPredictor.java``: exact SHAP values per feature by the
polynomial-time TreeSHAP recursion (Lundberg's Algorithm 2, the
EXTEND/UNWIND path bookkeeping), so that contributions + bias == the raw
margin (local accuracy).

The heap-layout trees carry no covers, so they are counted here by routing
a background frame (default: the scoring frame) through each tree. The bin
codes come from the device binning (``apply_bins_device`` on the model's
device, the fit's and scoring path's codes) and are moved to the host; the
recursion runs there in float64, one row at a time, as in the JAX package.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def node_covers(feat, split_bin, default_left, is_split, bins, n_bins1: int,
                max_depth: int) -> np.ndarray:
    """Per-heap-node row counts from routing `bins` [N, F] down one tree."""
    M = len(feat)
    idx = np.zeros(bins.shape[0], dtype=np.int64)
    covers = np.zeros(M, dtype=np.float64)
    np.add.at(covers, idx, 1.0)
    for _ in range(max_depth):
        f = feat[idx]
        b = bins[np.arange(bins.shape[0]), f]
        is_na = b >= n_bins1 - 1
        go_left = np.where(is_na, default_left[idx], b <= split_bin[idx])
        nxt = 2 * idx + np.where(go_left, 1, 2)
        moved = is_split[idx]
        idx = np.where(moved, nxt, idx)
        np.add.at(covers, idx[moved], 1.0)
    return covers


class _Path:
    """The unique-path state of the TreeSHAP recursion."""

    __slots__ = ("d", "z", "o", "w")

    def __init__(self) -> None:
        self.d: List[int] = []   # feature index (-1 at the root slot)
        self.z: List[float] = []  # fraction of zero (background) paths
        self.o: List[float] = []  # fraction of one (this row's) paths
        self.w: List[float] = []  # permutation weights

    def copy(self) -> "_Path":
        p = _Path()
        p.d = self.d[:]
        p.z = self.z[:]
        p.o = self.o[:]
        p.w = self.w[:]
        return p

    def extend(self, pz: float, po: float, pi: int) -> None:
        l = len(self.d)
        self.d.append(pi)
        self.z.append(pz)
        self.o.append(po)
        self.w.append(1.0 if l == 0 else 0.0)
        for i in range(l - 1, -1, -1):
            self.w[i + 1] += po * self.w[i] * (i + 1) / (l + 1)
            self.w[i] = pz * self.w[i] * (l - i) / (l + 1)

    def unwind(self, i: int) -> None:
        l = len(self.d) - 1
        po, pz = self.o[i], self.z[i]
        n = self.w[l]
        for j in range(l - 1, -1, -1):
            if po != 0:
                t = self.w[j]
                self.w[j] = n * (l + 1) / ((j + 1) * po)
                n = t - self.w[j] * pz * (l - j) / (l + 1)
            else:
                self.w[j] = self.w[j] * (l + 1) / (pz * (l - j))
        for j in range(i, l):
            self.d[j] = self.d[j + 1]
            self.z[j] = self.z[j + 1]
            self.o[j] = self.o[j + 1]
        del self.d[l], self.z[l], self.o[l], self.w[l]

    def unwound_sum(self, i: int) -> float:
        l = len(self.d) - 1
        po, pz = self.o[i], self.z[i]
        total = 0.0
        n = self.w[l]
        for j in range(l - 1, -1, -1):
            if po != 0:
                t = n * (l + 1) / ((j + 1) * po)
                total += t
                n = self.w[j] - t * pz * (l - j) / (l + 1)
            else:
                total += self.w[j] * (l + 1) / (pz * (l - j))
        return total


def tree_shap_row(
    feat, split_bin, default_left, is_split, leaf, covers,
    x_bins: np.ndarray, n_bins1: int, phi: np.ndarray,
) -> None:
    """Accumulate one tree's exact SHAP contributions for one row into phi
    (length F + 1; last slot is the bias). Lundberg Algorithm 2."""
    phi[-1] += leaf[0] if not is_split[0] else 0.0

    def hot_child(node: int) -> Tuple[int, int]:
        f, sb = int(feat[node]), int(split_bin[node])
        b = int(x_bins[f])
        go_left = default_left[node] if b >= n_bins1 - 1 else b <= sb
        l, r = 2 * node + 1, 2 * node + 2
        return (l, r) if go_left else (r, l)

    def recurse(node: int, path: _Path, pz: float, po: float, pi: int) -> None:
        path = path.copy()
        path.extend(pz, po, pi)
        if not is_split[node]:
            v = float(leaf[node])
            for i in range(1, len(path.d)):
                w = path.unwound_sum(i)
                phi[path.d[i]] += w * (path.o[i] - path.z[i]) * v
            return
        f = int(feat[node])
        hot, cold = hot_child(node)
        iz, io = 1.0, 1.0
        k = next((i for i in range(1, len(path.d)) if path.d[i] == f), None)
        if k is not None:
            iz, io = path.z[k], path.o[k]
            path.unwind(k)
        cov = covers[node] if covers[node] > 0 else 1.0
        recurse(hot, path, iz * covers[hot] / cov, io, f)
        recurse(cold, path, iz * covers[cold] / cov, 0.0, f)

    if is_split[0]:
        recurse(0, _Path(), 1.0, 1.0, -1)
        # the bias is E[f(x)] over the background: cover-weighted leaf mean
        total = 0.0
        stack = [0]
        while stack:
            node = stack.pop()
            if not is_split[node]:
                total += covers[node] * float(leaf[node])
            else:
                stack.append(2 * node + 1)
                stack.append(2 * node + 2)
        phi[-1] += total / max(covers[0], 1e-300)


def predict_contributions(
    model,
    frame,
    background_frame=None,
) -> "np.ndarray":
    """[N, F+1] exact SHAP contributions (+ bias last) on the margin scale
    (Model.predict_contributions / /3/Predictions ``predict_contributions``).

    Local accuracy: rows sum (plus init margin) to predict_margin exactly.
    """
    from h2o3_tpu_torch.models.tree.common import tree_matrix
    from h2o3_tpu_torch.ops.histogram import apply_bins_device

    b = model.booster
    if len(b.trees_per_class) != 1:
        raise ValueError(
            "predict_contributions supports regression/binomial models"
        )
    trees = b.trees_per_class[0]

    def host_bins(X):
        # [N, F] codes, made on the model's device as scoring makes them
        return apply_bins_device(X, trees.edges, model.device).T.cpu().numpy()

    X = tree_matrix(model.data_info, frame, encoding=model.tree_encoding)
    bins = host_bins(X)
    if background_frame is None:
        bg_bins = bins
    else:
        bg = tree_matrix(model.data_info, background_frame,
                         encoding=model.tree_encoding)
        bg_bins = host_bins(bg)

    n, F = bins.shape
    out = np.zeros((n, F + 1), dtype=np.float64)
    n_bins1 = trees.n_bins1
    for t in range(trees.ntrees):
        feat = trees.feat[t]
        sb = trees.split_bin[t]
        dl = trees.default_left[t]
        sp = trees.is_split[t]
        lf = trees.leaf[t].astype(np.float64)
        covers = node_covers(feat, sb, dl, sp, bg_bins, n_bins1, trees.max_depth)
        for i in range(n):
            tree_shap_row(feat, sb, dl, sp, lf, covers, bins[i], n_bins1, out[i])
    if b.average and trees.ntrees:
        out /= trees.ntrees
    out[:, -1] += float(b.init_margin[0])
    return out
