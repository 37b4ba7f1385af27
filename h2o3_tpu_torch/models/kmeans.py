"""KMeans — the port of ``h2o3_tpu/models/kmeans.py``.

Reference: ``hex/kmeans/KMeans.java:688,725``: kmeans++ (``plus_plus``),
``furthest`` or ``random`` init on standardized features, Lloyd's
assign-and-recompute once per iteration, within-cluster sums of squares,
and ``estimate_k``'s deterministic largest-cluster splits.

The device program is one Lloyd iteration (``_lloyd_step``): the [N, k]
squared distances ``|x|^2 - 2 x.C + |C|^2`` as one matmul, the argmin
assignment, the one-hot segment sum ``onehot.T @ X``, the counts and the
per-cluster WSS, in float32 on the design matrix placed once per (frame
state, design parameters, device) through ``frame/devcache.cached`` (kind
``kmeans_x``). The step returns the assignment, the counts and the WSS of
the centers it was given, with the new centers beside them; an empty
cluster keeps its center.

The init draws, ``estimate_k``'s splits, the total sum of squares and
scoring (``_predict_raw``) are host numpy, as in the JAX package, on the
same ``np.random.default_rng(seed)``: the start centers are the JAX
package's bits. The JAX package pads the rows to its mesh and masks the
pad rows; one card holds every row, so there is no mask here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from h2o3_tpu_torch.frame import devcache
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.data_info import build_data_info, expand_matrix
from h2o3_tpu_torch.models.framework import Model, ModelBuilder, ModelParameters


@dataclass
class KMeansParameters(ModelParameters):
    k: int = 3
    max_iterations: int = 10
    init: str = "plus_plus"  # plus_plus|random|furthest
    standardize: bool = True
    estimate_k: bool = False


def _lloyd_step(X: torch.Tensor, C: torch.Tensor, k: int):
    """One Lloyd iteration. X:[N,D], C:[k,D], both float32 on one device.
    Returns (assign, new centers, counts, wss, per-cluster wss)."""
    d2 = (
        (X * X).sum(dim=1, keepdim=True)
        - 2.0 * (X @ C.T)
        + (C * C).sum(dim=1)[None, :]
    )  # [N, k]
    assign = torch.argmin(d2, dim=1)
    onehot = torch.nn.functional.one_hot(assign, k).to(X.dtype)
    sums = onehot.T @ X  # [k, D]
    counts = onehot.sum(dim=0)  # [k]
    newC = torch.where(counts[:, None] > 0,
                       sums / torch.clamp(counts[:, None], min=1.0), C)
    per_cluster_wss = (onehot * d2).sum(dim=0)
    wss = per_cluster_wss.sum()
    return assign, newC, counts, wss, per_cluster_wss


class KMeansModel(Model):
    algo_name = "kmeans"

    def __init__(self, params, data_info, device: torch.device) -> None:
        super().__init__(params, data_info, device)
        self.centers_std: Optional[np.ndarray] = None  # standardized space
        self.centers: Optional[np.ndarray] = None  # original space (numeric cols)
        self.size: Optional[np.ndarray] = None
        self.withinss: Optional[np.ndarray] = None
        self.tot_withinss: float = np.nan
        self.totss: float = np.nan
        self.betweenss: float = np.nan
        self.iterations: int = 0

    @property
    def is_classifier(self) -> bool:
        return False

    def _predict_raw(self, frame: Frame) -> np.ndarray:
        X, _ = expand_matrix(self.data_info, frame, dtype=np.float32)
        C = self.centers_std
        d2 = (X * X).sum(1, keepdims=True) - 2 * X @ C.T + (C * C).sum(1)[None, :]
        return d2.argmin(axis=1).astype(np.float64)

    def model_performance(self, frame: Frame):
        return {
            "tot_withinss": self.tot_withinss,
            "totss": self.totss,
            "betweenss": self.betweenss,
            "size": self.size,
        }


class KMeans(ModelBuilder):
    algo_name = "kmeans"

    def __init__(self, params: Optional[KMeansParameters] = None, **kw) -> None:
        super().__init__(params or KMeansParameters(**kw))

    def _validate(self, frame: Frame) -> None:
        super()._validate(frame)
        if self.params.k < 1:
            raise ValueError("k must be >= 1")

    def _fit(self, frame: Frame, valid: Optional[Frame],
             device: torch.device) -> KMeansModel:
        p: KMeansParameters = self.params
        info = build_data_info(
            frame, y=None, ignored=p.ignored_columns,
            standardize=p.standardize, use_all_factor_levels=True,
        )
        X, _ = expand_matrix(info, frame, dtype=np.float32)
        n, D = X.shape
        model = KMeansModel(p, info, device)
        rng = np.random.default_rng(p.actual_seed())

        Xd = devcache.cached(
            "kmeans_x", devcache.frame_token(frame),
            (p.standardize, tuple(p.ignored_columns)), device,
            lambda: torch.from_numpy(X).to(device),
            frame_key=getattr(frame, "key", None),
        )

        def run_lloyd(C0: np.ndarray):
            """Lloyd to convergence from C0; returns the fitted state."""
            k = C0.shape[0]
            Cd = torch.from_numpy(np.ascontiguousarray(C0, dtype=np.float32)).to(device)
            prev_wss = np.inf
            iters = 0
            assign = counts = wss_k = None
            wss = np.inf
            for it in range(p.max_iterations):
                assign, Cd, counts, wss, wss_k = _lloyd_step(Xd, Cd, k)
                iters = it + 1
                wss = float(wss)
                if abs(prev_wss - wss) < 1e-6 * max(abs(prev_wss), 1.0):
                    break
                prev_wss = wss
            return (Cd.cpu().numpy().astype(np.float64),
                    counts.cpu().numpy().astype(np.int64),
                    wss_k.cpu().numpy().astype(np.float64),
                    wss, iters, assign.cpu().numpy())

        if p.estimate_k:
            # KMeans.java estimate_k (:278,301,398-414): deterministic —
            # start at k=1, split the largest cluster each outer round,
            # stop when the relative tot_withinss gain drops under
            # min(0.02 + 10/n + 2.5/F², 0.8); k is the cap
            cutoff = min(0.02 + 10.0 / max(n, 1) + 2.5 / max(D, 1) ** 2, 0.8)
            C = X.mean(axis=0, keepdims=True).astype(np.float32)
            best = run_lloyd(C)
            prev_wss = best[3]
            total_iters = best[4]
            for k in range(2, p.k + 1):
                C = _split_largest_cluster(X, best[0], best[5])
                cur = run_lloyd(C)
                total_iters += cur[4]
                rel = 1.0 if prev_wss == 0 else (prev_wss - cur[3]) / prev_wss
                if k > 1 and rel < cutoff:
                    break  # keep the previous (best) model
                best = cur
                prev_wss = cur[3]
            centers_std, counts, wss_k, _wss, _it, _assign = best
            model.iterations = total_iters
        else:
            C = _init_centers(X, p.k, p.init, rng)
            centers_std, counts, wss_k, _wss, iters, _assign = run_lloyd(C)
            model.iterations = iters

        model.centers_std = centers_std
        model.size = counts
        model.withinss = wss_k
        model.tot_withinss = float(model.withinss.sum())
        gmean = X.mean(axis=0)
        model.totss = float(((X - gmean) ** 2).sum())
        model.betweenss = model.totss - model.tot_withinss
        model.centers = _destandardize_centers(info, model.centers_std)
        model.training_metrics = model.model_performance(frame)
        return model


def _split_largest_cluster(X: np.ndarray, C: np.ndarray, assign: np.ndarray) -> np.ndarray:
    """KMeans.splitLargestCluster analogue, deterministic: the cluster
    with the most rows donates a second center at its farthest member."""
    counts = np.bincount(assign, minlength=C.shape[0])
    big = int(counts.argmax())
    rows = np.nonzero(assign == big)[0]
    if len(rows) <= 1:  # nothing to split: duplicate with a nudge
        new = C[big] + 1e-3
    else:
        d2 = ((X[rows] - C[big].astype(np.float32)) ** 2).sum(axis=1)
        new = X[rows[int(d2.argmax())]]
    return np.vstack([C, new[None, :]]).astype(np.float32)


def _init_centers(X: np.ndarray, k: int, init: str, rng) -> np.ndarray:
    n = len(X)
    if init == "random":
        return X[rng.choice(n, k, replace=False)].copy()
    # kmeans++ and furthest share the distance-seeded loop (KMeans.java init)
    centers = [X[rng.integers(n)]]
    d2 = ((X - centers[0]) ** 2).sum(axis=1)
    for _ in range(1, k):
        if init == "furthest":
            centers.append(X[int(d2.argmax())])
        else:  # plus_plus: sample proportional to d²
            probs = d2 / max(d2.sum(), 1e-30)
            centers.append(X[rng.choice(n, p=probs)])
        d2 = np.minimum(d2, ((X - centers[-1]) ** 2).sum(axis=1))
    return np.stack(centers)


def _destandardize_centers(info, C_std: np.ndarray) -> np.ndarray:
    C = C_std.copy()
    j = 0
    for name in info.predictor_names:
        if name in info.cat_domains:
            j += len(info.cat_domains[name])
        else:
            if info.standardize:
                C[:, j] = C_std[:, j] * info.num_sds[name] + info.num_means[name]
            j += 1
    return C
