"""GLRM — the port of ``h2o3_tpu/models/glrm.py``.

Reference: ``hex/glrm/GLRM.java:52``: factorize A ~ X Y (X: [N, k] row
factors, Y: [k, P] archetypes) under a per-entry loss (quadratic,
absolute, huber, poisson, logistic) and regularizers on X and Y (none, l1,
l2, non_negative), by alternating updates with the step-halving line
search of ``GLRM.java``'s updateX/updateY; NAs are left out of the loss.

The device programs run in float32 on A and its NA mask M on the model's
device, with the JAX package's arithmetic:

- ``_als_x`` and ``_als_y``: the masked normal equations and a batched
  ``torch.linalg.solve`` with ``+1e-8 I``. The JAX package writes the
  systems as ``einsum("np,kp,lp->nkl")`` and ``einsum("np,nk,nl->pkl")``,
  which hold an [N, P, k] product; here they are one matmul each with the
  k^2 outer products (``M @ (Y_k Y_l)`` and ``M.T @ (X_k X_l)``), [N, k^2]
  and [P, k^2], and the right sides ``(M*A) @ Y.T`` and ``(M*A).T @ X``;
- ``_grads``, ``_objective`` and the proximal ``_solve_x_impl``, a
  fixed-step loop with the prox maps.

The fit loop runs exact ALS for the quadratic loss with none or l2 on both
sides, else the proximal line search, on the host as in the JAX package.
The SVD init is host numpy (a device SVD picks other signs, then other
factors), and so is ``recover_svd``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from h2o3_tpu_torch.device import to_device_f32
from h2o3_tpu_torch.frame.frame import ColType, Column, Frame
from h2o3_tpu_torch.models.data_info import build_data_info, expand_matrix
from h2o3_tpu_torch.models.framework import Model, ModelBuilder, ModelParameters

LOSSES = ("quadratic", "absolute", "huber", "poisson", "logistic")
REGS = ("none", "l1", "l2", "non_negative")


@dataclass
class GLRMParameters(ModelParameters):
    k: int = 1
    loss: str = "quadratic"
    regularization_x: str = "none"
    regularization_y: str = "none"
    gamma_x: float = 0.0
    gamma_y: float = 0.0
    max_iterations: int = 100
    init_step_size: float = 1.0
    min_step_size: float = 1e-4
    init: str = "svd"  # svd | random
    transform: str = "none"  # none | standardize
    recover_svd: bool = False


def _loss_and_grad(loss: str):
    """Per-entry loss l(xy, a) and dl/d(xy); the caller masks the NAs."""
    if loss == "quadratic":
        return (lambda u, a: (u - a) ** 2), (lambda u, a: 2.0 * (u - a))
    if loss == "absolute":
        return (lambda u, a: torch.abs(u - a)), (lambda u, a: torch.sign(u - a))
    if loss == "huber":
        def l(u, a):
            r = u - a
            return torch.where(torch.abs(r) <= 1.0, 0.5 * r * r, torch.abs(r) - 0.5)

        def g(u, a):
            r = u - a
            return torch.where(torch.abs(r) <= 1.0, r, torch.sign(r))

        return l, g
    if loss == "poisson":
        return (
            lambda u, a: torch.exp(u) - a * u,
            lambda u, a: torch.exp(u) - a,
        )
    if loss == "logistic":
        # a in {0, 1}: the logistic loss of the margin
        return (
            lambda u, a: torch.log1p(torch.exp(-(2 * a - 1) * u)),
            lambda u, a: -(2 * a - 1) / (1.0 + torch.exp((2 * a - 1) * u)),
        )
    raise ValueError(f"unknown loss {loss!r}")


def _prox_l1(v, t):
    return torch.sign(v) * torch.clamp(torch.abs(v) - t, min=0.0)


def _prox(reg: str, gamma: float):
    if reg == "none" or gamma == 0.0 and reg != "non_negative":
        return lambda v, step: v
    if reg == "l1":
        return lambda v, step: _prox_l1(v, step * gamma)
    if reg == "l2":
        return lambda v, step: v / (1.0 + 2.0 * step * gamma)
    if reg == "non_negative":
        return lambda v, step: torch.clamp(v, min=0.0)
    raise ValueError(f"unknown regularization {reg!r}")


def _reg_value(reg: str, gamma: float, v: torch.Tensor) -> float:
    if reg == "l1":
        return float(gamma * torch.abs(v).sum())
    if reg == "l2":
        return float(gamma * (v * v).sum())
    return 0.0


class GLRMModel(Model):
    algo_name = "glrm"

    def __init__(self, params, data_info, device: torch.device) -> None:
        super().__init__(params, data_info, device)
        self.archetypes: Optional[np.ndarray] = None  # Y [k, P]
        self.x_factors: Optional[np.ndarray] = None  # X [N, k] (training rows)
        self.objective: float = np.nan
        self.step_size: float = np.nan
        self.iterations: int = 0
        self.singular_vals: Optional[np.ndarray] = None

    @property
    def is_classifier(self) -> bool:
        return False

    def _factors(self, frame: Frame, iterations: int = 50) -> np.ndarray:
        """The frame's row factors with the archetypes fixed."""
        A, mask = _design(self.data_info, frame)
        dev = self.device
        X = _solve_x(to_device_f32(A, dev), to_device_f32(mask, dev),
                     to_device_f32(self.archetypes, dev), self.params, iterations)
        return X.cpu().numpy()

    def transform_frame(self, frame: Frame, iterations: int = 50) -> Frame:
        """Project new rows onto the archetypes (solve for X with Y fixed)."""
        X = self._factors(frame, iterations)
        return Frame([
            Column(f"Arch{j + 1}", X[:, j].astype(np.float64), ColType.NUM)
            for j in range(X.shape[1])
        ])

    def _predict_raw(self, frame: Frame) -> np.ndarray:
        """Reconstruction A^ = XY for the frame's rows."""
        return self._factors(frame) @ self.archetypes

    def reconstruct(self, frame: Frame) -> Frame:
        R = self._predict_raw(frame)
        names = self.data_info.coef_names
        return Frame([
            Column(f"reconstr_{names[j]}", R[:, j].astype(np.float64), ColType.NUM)
            for j in range(R.shape[1])
        ])


def _design(info, frame):
    X, _ = expand_matrix(info, frame, dtype=np.float32)
    # the NA mask holds the original NAs (expand_matrix imputes them)
    mask = np.ones_like(X, dtype=bool)
    col_off = 0
    for name in info.predictor_names:
        if name in info.cat_domains:
            w = len(info.cat_domains[name]) - (0 if info.use_all_factor_levels else 1)
            na = frame.col(name).isna()
            mask[na, col_off : col_off + w] = False
            col_off += w
        else:
            na = frame.col(name).isna()
            mask[na, col_off] = False
            col_off += 1
    return X, mask


def _solve_x_impl(A, M, Y, gamma: float, loss: str, reg: str, steps: int):
    _, gfn = _loss_and_grad(loss)
    n, k = A.shape[0], Y.shape[0]
    L = torch.clamp((Y * Y).sum() * 2.0, min=1e-6)
    step = 1.0 / L
    X = torch.zeros((n, k), dtype=A.dtype, device=A.device)
    for _ in range(steps):
        U = X @ Y
        G = (M * gfn(U, A)) @ Y.T
        V = X - step * G
        if reg == "l1":
            V = _prox_l1(V, step * gamma)
        elif reg == "l2":
            V = V / (1.0 + 2.0 * step * gamma)
        elif reg == "non_negative":
            V = torch.clamp(V, min=0.0)
        X = V
    return X


def _solve_x(A, M, Y, p: GLRMParameters, steps: int):
    if p.loss == "quadratic" and p.regularization_x in ("none", "l2"):
        return _als_x(A, M, Y, p.gamma_x if p.regularization_x == "l2" else 0.0)
    return _solve_x_impl(A, M, Y, p.gamma_x, p.loss, p.regularization_x, steps)


def _objective(A, M, X, Y, loss: str) -> torch.Tensor:
    lfn, _ = _loss_and_grad(loss)
    return (M * lfn(X @ Y, A)).sum()


def _grads(A, M, X, Y, loss: str):
    _, gfn = _loss_and_grad(loss)
    R = M * gfn(X @ Y, A)
    return R @ Y.T, X.T @ R  # grad_X [N,k], grad_Y [k,P]


def _outer_pairs(F: torch.Tensor) -> torch.Tensor:
    """[R, k] -> [R, k*k], row r holding F[r, i] * F[r, j] at i*k + j."""
    return (F[:, :, None] * F[:, None, :]).reshape(F.shape[0], -1)


def _ridge(G: torch.Tensor, ridge: float) -> torch.Tensor:
    eye = torch.eye(G.shape[-1], dtype=G.dtype, device=G.device)
    return G + ridge * eye + 1e-8 * eye


def _als_x(A, M, Y, ridge: float):
    """Exact masked least-squares row solves: X_i = (Y M_i Y^T + ridge I)^-1 Y M_i A_i."""
    k = Y.shape[0]
    G = _ridge((M @ _outer_pairs(Y.T)).reshape(-1, k, k), ridge)  # [N, k, k]
    b = (M * A) @ Y.T  # [N, k]
    return torch.linalg.solve(G, b)


def _als_y(A, M, X, ridge: float):
    """Exact masked least-squares column solves for the archetypes."""
    k = X.shape[1]
    G = _ridge((M.T @ _outer_pairs(X)).reshape(-1, k, k), ridge)  # [P, k, k]
    b = (M * A).T @ X  # [P, k]
    return torch.linalg.solve(G, b).T  # [k, P]


class GLRM(ModelBuilder):
    algo_name = "glrm"

    def __init__(self, params: Optional[GLRMParameters] = None, **kw) -> None:
        super().__init__(params or GLRMParameters(**kw))

    def _validate(self, frame: Frame) -> None:
        super()._validate(frame)
        p: GLRMParameters = self.params
        if p.loss not in LOSSES:
            raise ValueError(f"loss must be one of {LOSSES}")
        if p.regularization_x not in REGS or p.regularization_y not in REGS:
            raise ValueError(f"regularization must be one of {REGS}")

    def _fit(self, frame: Frame, valid: Optional[Frame],
             device: torch.device) -> GLRMModel:
        p: GLRMParameters = self.params
        info = build_data_info(
            frame, None, ignored=p.ignored_columns,
            use_all_factor_levels=True,
            standardize=p.transform == "standardize",
        )
        model = GLRMModel(p, info, device)
        A_np, M_np = _design(info, frame)
        n, pc = A_np.shape
        k = min(p.k, min(n, pc))
        rng = np.random.default_rng(p.actual_seed())

        if p.init == "svd":
            A0 = np.where(M_np, A_np, 0.0)
            U, s, Vt = np.linalg.svd(A0, full_matrices=False)
            X0 = (U[:, :k] * s[:k]).astype(np.float32)
            Y0 = Vt[:k].astype(np.float32)
        else:
            X0 = rng.normal(scale=0.1, size=(n, k)).astype(np.float32)
            Y0 = rng.normal(scale=0.1, size=(k, pc)).astype(np.float32)

        A, M = to_device_f32(A_np, device), to_device_f32(M_np, device)
        X, Y = to_device_f32(X0, device), to_device_f32(Y0, device)
        prox_x = _prox(p.regularization_x, p.gamma_x)
        prox_y = _prox(p.regularization_y, p.gamma_y)

        def full_obj(X, Y):
            return (
                float(_objective(A, M, X, Y, p.loss))
                + _reg_value(p.regularization_x, p.gamma_x, X)
                + _reg_value(p.regularization_y, p.gamma_y, Y)
            )

        obj = full_obj(X, Y)
        step = p.init_step_size
        exact_als = (p.loss == "quadratic"
                     and {p.regularization_x, p.regularization_y} <= {"none", "l2"})
        for it in range(p.max_iterations):
            if exact_als:
                # quadratic + (none|l2): exact alternating masked least squares
                X = _als_x(A, M, Y, p.gamma_x if p.regularization_x == "l2" else 0.0)
                Y = _als_y(A, M, X, p.gamma_y if p.regularization_y == "l2" else 0.0)
                new_obj = full_obj(X, Y)
                improved = new_obj < obj - 1e-10 * max(abs(obj), 1.0)
                obj = new_obj
            else:
                # proximal gradient with per-side Lipschitz steps and
                # backtracking (GLRM.java's step-halving line search)
                improved = False
                lx = 1.0 / max(2.0 * float((Y * Y).sum()), 1e-6)
                while step > p.min_step_size:
                    gX = _grads(A, M, X, Y, p.loss)[0]
                    Xn = prox_x(X - step * lx * gX, step * lx)
                    ly = 1.0 / max(2.0 * float((Xn * Xn).sum()), 1e-6)
                    gYn = _grads(A, M, Xn, Y, p.loss)[1]
                    Yn = prox_y(Y - step * ly * gYn, step * ly)
                    new_obj = full_obj(Xn, Yn)
                    if new_obj < obj:
                        X, Y, obj = Xn, Yn, new_obj
                        step *= 1.05
                        improved = True
                        break
                    step *= 0.5
            model.iterations = it + 1
            if self.job:
                self.job.update((it + 1) / p.max_iterations)
            if not improved:
                break

        model.x_factors = X.cpu().numpy().astype(np.float64)
        model.archetypes = Y.cpu().numpy().astype(np.float64)
        model.objective = obj
        model.step_size = step
        if p.recover_svd:
            # the SVD of the fitted XY product (GLRM.java recover_svd)
            U, s, Vt = np.linalg.svd(model.x_factors @ model.archetypes, full_matrices=False)
            model.singular_vals = s[:k]
        return model
