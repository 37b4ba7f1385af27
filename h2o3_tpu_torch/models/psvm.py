"""PSVM — the port of ``h2o3_tpu/models/psvm.py``.

A binary soft-margin SVM with a gaussian kernel (``hex/psvm/PSVM.java``):
the kernel matrix is approximated by a low-rank incomplete Cholesky factor
H (``hex/psvm/icf/``, rank sqrt(n) by default), the dual QP is solved over
the factor, and the model keeps the support vectors, alpha y and rho for
exact-kernel scoring (``hex/psvm/ScorerTask``).

As in the JAX package:

- the ICF pivots greedily on the largest residual diagonal, one kernel
  column per pivot, in float64: here on the device (``_icf``), one host
  sync per pivot for its index (``torch.argmax``, like ``np.argmax``,
  returns the first maximum);
- the dual QP, with the bias folded in as a constant feature (no
  y^T alpha = 0 constraint), runs as projected gradient ascent on the box
  in float32 (``_solve_box_qp``: 20 power steps for the step size, then
  ``max_iterations`` steps of two [N, r] matrix products each), as the
  JAX package's jitted solve runs without x64;
- scoring is the exact kernel over the support vectors in float64, here
  on the device in row chunks (``decision_function``), so no [N, S]
  matrix larger than ``_SCORE_CHUNK_BYTES`` is made.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.data_info import build_data_info, expand_matrix, response_vector
from h2o3_tpu_torch.models.framework import Model, ModelBuilder, ModelParameters

#: bytes of one scoring chunk's [rows, S] float64 kernel block
_SCORE_CHUNK_BYTES = 512 << 20


@dataclass
class PSVMParameters(ModelParameters):
    hyper_param: float = 1.0  # C
    kernel_type: str = "gaussian"
    gamma: float = -1.0  # -1: 1/#features
    rank_ratio: float = -1.0  # -1: sqrt(n)/n
    positive_weight: float = 1.0
    negative_weight: float = 1.0
    sv_threshold: float = 1e-4
    max_iterations: int = 300
    fact_threshold: float = 1e-5


def _rbf(X: torch.Tensor, sq: torch.Tensor, P: torch.Tensor, gamma: float) -> torch.Tensor:
    """K(X, P) for the gaussian kernel, as the JAX package forms it:
    ``exp(-gamma * max(|x|^2 - 2 x.p + |p|^2, 0))``."""
    d2 = sq[:, None] - 2.0 * X @ P.T + (P * P).sum(dim=1)[None, :]
    return torch.exp(-gamma * torch.clamp(d2, min=0.0))


def _icf(X: torch.Tensor, gamma: float, rank: int, tol: float) -> torch.Tensor:
    """Incomplete Cholesky of the RBF kernel with greedy pivoting
    (hex/psvm/icf/ IncompleteCholeskyFactorization): K ~ H H^T, H [n, r],
    in the dtype of ``X``."""
    n = X.shape[0]
    H = torch.zeros((n, rank), dtype=X.dtype, device=X.device)
    d = torch.ones(n, dtype=X.dtype, device=X.device)  # diag(K) - sum H^2
    sq = (X * X).sum(dim=1)
    for j in range(rank):
        i = int(torch.argmax(d))
        di = float(d[i])
        if di < tol:
            return H[:, :j]
        kcol = _rbf(X, sq, X[i:i + 1], gamma)[:, 0]
        h = (kcol - H[:, :j] @ H[i, :j]) / np.sqrt(di)
        H[:, j] = h
        d = torch.clamp(d - h * h, min=0.0)
    return H


def _solve_box_qp(Z: torch.Tensor, Cvec: torch.Tensor, iters: int) -> torch.Tensor:
    """max sum(alpha) - 1/2 alpha^T Q alpha, 0 <= alpha <= C, Q = Z Z^T
    (Z = diag(y) [H, 1]): projected gradient ascent with a spectral-norm
    step estimate, in the dtype of ``Z``."""
    n = Z.shape[0]
    v = torch.ones(n, dtype=Z.dtype, device=Z.device)
    v = v / torch.sqrt(torch.tensor(float(n), dtype=Z.dtype, device=Z.device))
    for _ in range(20):
        w = Z @ (Z.T @ v)
        v = w / torch.clamp(torch.linalg.vector_norm(w), min=1e-12)
    L = torch.clamp(v @ (Z @ (Z.T @ v)), min=1e-6)
    step = 1.0 / L
    alpha = torch.zeros(n, dtype=Z.dtype, device=Z.device)
    for _ in range(iters):
        grad = 1.0 - Z @ (Z.T @ alpha)
        alpha = torch.minimum(torch.clamp(alpha + step * grad, min=0.0), Cvec)
    return alpha


class PSVMModel(Model):
    algo_name = "psvm"

    def __init__(self, params, data_info, device: torch.device) -> None:
        super().__init__(params, data_info, device)
        self.support_vectors: Optional[np.ndarray] = None  # [S, D]
        self.alpha_y: Optional[np.ndarray] = None  # alpha_i y_i at support vectors
        self.rho: float = 0.0
        self.gamma_: float = 0.0
        self.svs_count: int = 0
        self.bounded_svs_count: int = 0
        self.rank_: int = 0

    def decision_function(self, frame: Frame) -> np.ndarray:
        X, _ = expand_matrix(self.data_info, frame, dtype=np.float64)
        dev = self.device
        S = torch.from_numpy(np.ascontiguousarray(self.support_vectors, dtype=np.float64)).to(dev)
        ay = torch.from_numpy(np.asarray(self.alpha_y, dtype=np.float64)).to(dev)
        Xd = torch.from_numpy(np.ascontiguousarray(X)).to(dev)
        sq = (Xd * Xd).sum(dim=1)
        rows = max(1, _SCORE_CHUNK_BYTES // (8 * max(S.shape[0], 1)))
        out = torch.empty(X.shape[0], dtype=torch.float64, device=dev)
        for a in range(0, X.shape[0], rows):
            b = min(a + rows, X.shape[0])
            out[a:b] = _rbf(Xd[a:b], sq[a:b], S, self.gamma_) @ ay
        return out.cpu().numpy() - self.rho

    def _predict_raw(self, frame: Frame) -> np.ndarray:
        f = self.decision_function(frame)
        # calibrated-ish probabilities via the logistic of the margin
        pr = 1.0 / (1.0 + np.exp(-f))
        return np.stack([1 - pr, pr], axis=1)


class PSVM(ModelBuilder):
    algo_name = "psvm"

    def __init__(self, params: Optional[PSVMParameters] = None, **kw) -> None:
        super().__init__(params or PSVMParameters(**kw))

    def _validate(self, frame: Frame) -> None:
        super()._validate(frame)
        if self.params.kernel_type != "gaussian":
            raise ValueError("only the gaussian kernel is supported (like the reference)")

    def _fit(self, frame: Frame, valid: Optional[Frame],
             device: torch.device) -> PSVMModel:
        p: PSVMParameters = self.params
        ycol = frame.col(p.response_column)
        if not ycol.is_categorical():
            frame = frame.add_column(ycol.as_factor())
        info = build_data_info(frame, p.response_column, ignored=p.ignored_columns,
                               standardize=True)
        if info.response_domain is None or len(info.response_domain) != 2:
            raise ValueError("PSVM requires a binary response")
        model = PSVMModel(p, info, device)
        X, skip = expand_matrix(info, frame, dtype=np.float64)
        yc = response_vector(info, frame)
        keep = ~(skip | np.isnan(yc))
        X, yc = X[keep], yc[keep]
        y = np.where(yc > 0, 1.0, -1.0)
        n, d = X.shape

        gamma = p.gamma if p.gamma > 0 else 1.0 / max(d, 1)
        model.gamma_ = gamma
        rank = int(p.rank_ratio * n) if p.rank_ratio > 0 else int(np.sqrt(n))
        rank = max(min(rank, n), 1)
        H = _icf(torch.from_numpy(np.ascontiguousarray(X)).to(device), gamma, rank,
                 p.fact_threshold)
        model.rank_ = H.shape[1]

        # bias as a constant pseudo-feature removes the equality constraint
        y_d = torch.from_numpy(y).to(device)
        Z = y_d[:, None] * torch.cat([H, torch.ones((n, 1), dtype=H.dtype, device=device)], 1)
        Cvec = np.where(y > 0, p.hyper_param * p.positive_weight,
                        p.hyper_param * p.negative_weight)
        alpha = _solve_box_qp(Z.float(), torch.from_numpy(Cvec.astype(np.float32)).to(device),
                              p.max_iterations).cpu().numpy()

        sv = alpha > p.sv_threshold
        model.svs_count = int(sv.sum())
        model.bounded_svs_count = int((alpha >= Cvec - 1e-8).sum())
        model.support_vectors = X[sv]
        model.alpha_y = (alpha * y)[sv]
        # rho from the bias pseudo-feature's weight: f(x) = sum(a y K) + b, b = w_r
        w = Z[:, -1].cpu().numpy() @ alpha
        model.rho = -float(w)

        model.training_metrics = model.model_performance(frame)
        if valid is not None:
            model.validation_metrics = model.model_performance(valid)
        return model
