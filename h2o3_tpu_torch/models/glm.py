"""GLM — the port of ``h2o3_tpu/models/glm.py``.

Generalized linear models by IRLSM with the weighted Gram on the device
(``hex/glm/GLM.java:1160`` fitIRLSM, ``GLMTask.java:1502`` GLMIterationTask,
``Gram.java:452`` Cholesky, ``ADMM.java`` for L1), L-BFGS
(``hex/optimization/L_BFGS.java``), lambda search, the multinomial and
ordinal families and p-values, with the JAX package's arithmetic:

- each IRLSM iteration computes eta, the working weights and the working
  response on the host in float64 (``X64``), as the JAX package does, and
  one Gram pass ``X.T @ (X * w)``, ``X.T @ (w * z)`` in float32 on the
  device (``_gram_kernel``: two ``torch.matmul`` calls, no TF32), returned
  to the host as float64; the (P+1)^2 solve (Cholesky or ADMM) runs on the
  host, as the reference solves the Gram on its driver node;
- L-BFGS takes its value and gradient from ``torch.autograd`` on the
  device in float32 and its steps from scipy's L-BFGS-B on the host;
- the design matrix comes from ``data_info.expand_matrix`` and is placed on
  the device once per (frame state, design parameters, device) through
  ``frame/devcache.cached`` (kinds ``glm_design``, ``glm_lbfgs_x``,
  ``glm_multinomial_x``, ``glm_ordinal_x``).

The JAX package row-shards the matrix over its mesh and sums the shards'
Grams with ``psum`` (``glm.py:166-178``). Here the IRLSM design is
row-sharded over the data mesh (``parallel/mesh.py``) when a process group
is live: each rank places its range of the padded rows, computes its
``X.T @ (X * w)`` and ``X.T @ (w * z)`` and the partials merge by the
mesh's float64 rule, so every rank's host IRLSM runs on the same Gram.
Pad rows carry zero weight. With no group one card sums once and the row
padder is the identity; either way the Gram agrees with the JAX package's
to float32 rounding, not bit for bit. L-BFGS and the ordinal fit run
whole on every rank.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from h2o3_tpu_torch.device import to_device_f32
from h2o3_tpu_torch.frame.frame import ColType, Frame
from h2o3_tpu_torch.parallel.mesh import Mesh, default_mesh, local_rows, psum
from h2o3_tpu_torch.models.data_info import (
    DataInfo,
    build_data_info,
    destandardize_coefs,
    expand_matrix,
    response_vector,
)
from h2o3_tpu_torch.models.framework import Model, ModelBuilder, ModelParameters

FAMILIES = (
    "gaussian", "binomial", "quasibinomial", "poisson", "gamma", "tweedie",
    "multinomial", "ordinal",
)

_DEFAULT_LINK = {
    "gaussian": "identity",
    "binomial": "logit",
    "quasibinomial": "logit",
    "poisson": "log",
    "gamma": "log",
    "tweedie": "tweedie",
    "multinomial": "multinomial",  # softmax
    "ordinal": "ologit",  # cumulative logit (proportional odds)
}

SOLVERS = ("auto", "irlsm", "lbfgs")


@dataclass
class GLMParameters(ModelParameters):
    family: str = "gaussian"
    link: str = "family_default"
    alpha: float = 0.5
    lambda_: float = 0.0
    lambda_search: bool = False
    nlambdas: int = 30
    standardize: bool = True
    intercept: bool = True
    max_iterations: int = 50
    beta_epsilon: float = 1e-4
    objective_epsilon: float = 1e-6
    tweedie_variance_power: float = 1.5
    tweedie_link_power: float = 0.0
    compute_p_values: bool = False
    missing_values_handling: str = "mean_imputation"
    solver: str = "auto"  # auto|irlsm|lbfgs (GLMModel.java:268-334 solver enum)
    lambda_min_ratio: float = 0.0  # 0 = auto: 1e-4 if n > p else 1e-2

    def actual_link(self) -> str:
        return _DEFAULT_LINK[self.family] if self.link == "family_default" else self.link


# ---------------------------------------------------------------------------
# family math (hex/glm/GLMModel.GLMParameters link/variance/deviance defs)


def _linkinv(link: str, eta: np.ndarray, p: GLMParameters) -> np.ndarray:
    if link == "identity":
        return eta
    if link == "logit":
        return 1.0 / (1.0 + np.exp(-eta))
    if link == "log":
        return np.exp(eta)
    if link == "inverse":
        return 1.0 / np.where(np.abs(eta) < 1e-10, np.sign(eta + 1e-30) * 1e-10, eta)
    if link == "tweedie":
        lp = p.tweedie_link_power
        return np.exp(eta) if lp == 0 else np.power(np.maximum(eta, 1e-10), 1.0 / lp)
    raise ValueError(f"unknown link {link}")


def _link_deriv(link: str, mu: np.ndarray, p: GLMParameters) -> np.ndarray:
    """d eta / d mu."""
    if link == "identity":
        return np.ones_like(mu)
    if link == "logit":
        return 1.0 / np.maximum(mu * (1 - mu), 1e-10)
    if link == "log":
        return 1.0 / np.maximum(mu, 1e-10)
    if link == "inverse":
        return -1.0 / np.maximum(mu**2, 1e-10)
    if link == "tweedie":
        lp = p.tweedie_link_power
        if lp == 0:
            return 1.0 / np.maximum(mu, 1e-10)
        return lp * np.power(np.maximum(mu, 1e-10), lp - 1)
    raise ValueError(f"unknown link {link}")


def _variance(family: str, mu: np.ndarray, p: GLMParameters) -> np.ndarray:
    if family == "gaussian":
        return np.ones_like(mu)
    if family in ("binomial", "quasibinomial"):
        return np.maximum(mu * (1 - mu), 1e-10)
    if family == "poisson":
        return np.maximum(mu, 1e-10)
    if family == "gamma":
        return np.maximum(mu**2, 1e-10)
    if family == "tweedie":
        return np.power(np.maximum(mu, 1e-10), p.tweedie_variance_power)
    raise ValueError(f"unknown family {family}")


def deviance(family: str, y: np.ndarray, mu: np.ndarray, p: GLMParameters) -> np.ndarray:
    """Per-row unit deviance (hex/Distribution.java / GLMModel deviance defs)."""
    eps = 1e-10
    if family == "gaussian":
        return (y - mu) ** 2
    if family in ("binomial", "quasibinomial"):
        mu = np.clip(mu, eps, 1 - eps)
        return -2 * (y * np.log(mu) + (1 - y) * np.log(1 - mu))
    if family == "poisson":
        mu = np.maximum(mu, eps)
        t = np.where(y > 0, y * np.log(np.where(y > 0, y, 1.0) / mu), 0.0)
        return 2 * (t - (y - mu))
    if family == "gamma":
        mu = np.maximum(mu, eps)
        ys = np.maximum(y, eps)
        return -2 * (np.log(ys / mu) - (ys - mu) / mu)
    if family == "tweedie":
        vp = p.tweedie_variance_power
        mu = np.maximum(mu, eps)
        ys = np.maximum(y, 0.0)
        a = np.where(ys > 0, np.power(np.maximum(ys, eps), 2 - vp) / ((1 - vp) * (2 - vp)), 0.0)
        b = ys * np.power(mu, 1 - vp) / (1 - vp)
        c = np.power(mu, 2 - vp) / (2 - vp)
        return 2 * (a - b + c)
    raise ValueError(f"unknown family {family}")


# ---------------------------------------------------------------------------
# the device pass: the weighted Gram as one matmul pair


def _gram_kernel(Xw: torch.Tensor, wz: torch.Tensor, w: torch.Tensor):
    """X'WX and X'Wz in one pass. Xw:[N,P+1] (with intercept col), w:[N]."""
    WX = Xw * w[:, None]
    g = Xw.T @ WX
    q = Xw.T @ (w * wz)
    return g, q


def _gram(Xd: torch.Tensor, wz: np.ndarray, w: np.ndarray,
          mesh: Optional[Mesh] = None):
    """The Gram pass on ``Xd``'s device, back on the host as float64. With
    ``mesh``, ``Xd``, ``wz`` and ``w`` are this rank's rows and the rank
    partials merge over it; without, they are every row."""
    g, q = _gram_kernel(Xd, to_device_f32(wz, Xd.device), to_device_f32(w, Xd.device))
    if mesh is not None:
        g, q = psum(g, mesh), psum(q, mesh)
    return (g.cpu().numpy().astype(np.float64), q.cpu().numpy().astype(np.float64))


def _logaddexp0(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, exact for large x (torch's
    ``softplus`` switches to x above a threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# host-side solvers (the reference solves the Gram on the driver node too)


def _solve_ridge(G: np.ndarray, q: np.ndarray, l2: float, free: int) -> np.ndarray:
    """(G + l2*I) b = q, no penalty on the last ``free`` coefs (intercept)."""
    A = G.copy()
    n = A.shape[0]
    pen = n - free
    A[np.arange(pen), np.arange(pen)] += l2
    A[np.arange(n), np.arange(n)] += 1e-10  # jitter for singular one-hot blocks
    try:
        from scipy.linalg import cho_factor, cho_solve

        return cho_solve(cho_factor(A, lower=True), q)
    except Exception:
        return np.linalg.lstsq(A, q, rcond=None)[0]


def _solve_admm(
    G: np.ndarray, q: np.ndarray, l1: float, l2: float, free: int, iters: int = 500, tol: float = 1e-7
) -> np.ndarray:
    """Elastic-net quadratic subproblem via ADMM (hex/optimization/ADMM.java):
    min 1/2 b'Gb - q'b + l1*|b|_1 + l2/2*|b|^2, intercept unpenalized."""
    n = G.shape[0]
    pen = n - free
    rho = float(np.mean(np.diag(G))) + l2 + 1e-6
    A = G.copy()
    A[np.arange(pen), np.arange(pen)] += l2 + rho
    A[np.arange(pen, n), np.arange(pen, n)] += rho
    A[np.arange(n), np.arange(n)] += 1e-10
    from scipy.linalg import cho_factor, cho_solve

    cf = cho_factor(A, lower=True)
    z = np.zeros(n)
    u = np.zeros(n)
    for _ in range(iters):
        x = cho_solve(cf, q + rho * (z - u))
        z_old = z
        xu = x + u
        z = np.concatenate(
            [np.sign(xu[:pen]) * np.maximum(np.abs(xu[:pen]) - l1 / rho, 0.0), xu[pen:]]
        )
        u = xu - z
        if np.max(np.abs(z - z_old)) < tol and np.max(np.abs(x - z)) < tol:
            break
    return z


# ---------------------------------------------------------------------------
# model


class GLMModel(Model):
    algo_name = "glm"

    def __init__(self, params: GLMParameters, data_info: DataInfo,
                 device: torch.device) -> None:
        super().__init__(params, data_info, device)
        self.coefficients: Dict[str, float] = {}
        self.coefficients_std: Dict[str, float] = {}
        self.beta_std: Optional[np.ndarray] = None  # [P+1] incl intercept, std space
        # multinomial: [P+1, K] per-class betas (std space); ordinal: [P] beta
        # + [K-1] increasing thresholds (std space), mirroring
        # GLMModel.GLMOutput._global_beta_multinomial / ordinal intercepts
        self.beta_multi: Optional[np.ndarray] = None
        self.ordinal_thresholds: Optional[np.ndarray] = None
        self.coefficients_multinomial: Optional[Dict[str, Dict[str, float]]] = None
        self.null_deviance: float = np.nan
        self.residual_deviance: float = np.nan
        self.aic: float = np.nan
        self.dispersion: float = 1.0
        self.std_errors: Optional[Dict[str, float]] = None
        self.p_values: Optional[Dict[str, float]] = None
        self.iterations: int = 0
        # lambda_search artifacts (GLMModel.RegularizationPath)
        self.lambda_path: Optional[List[Dict[str, float]]] = None
        self.lambda_best: Optional[float] = None

    def _eta(self, frame: Frame) -> np.ndarray:
        X, _ = expand_matrix(self.data_info, frame, dtype=np.float64)
        b = self.beta_std
        eta = X @ b[:-1] + b[-1]
        if self.params.offset_column:
            eta = eta + frame.col(self.params.offset_column).numeric_view()
        return eta

    def _predict_raw(self, frame: Frame) -> np.ndarray:
        p: GLMParameters = self.params
        if p.family == "multinomial":
            X, _ = expand_matrix(self.data_info, frame, dtype=np.float64)
            eta = X @ self.beta_multi[:-1] + self.beta_multi[-1]
            if p.offset_column:
                eta = eta + frame.col(p.offset_column).numeric_view()[:, None]
            return _softmax(eta)
        if p.family == "ordinal":
            X, _ = expand_matrix(self.data_info, frame, dtype=np.float64)
            eta = X @ self.beta_std
            if p.offset_column:
                eta = eta + frame.col(p.offset_column).numeric_view()
            return _ordinal_probs(eta, self.ordinal_thresholds)
        mu = _linkinv(p.actual_link(), self._eta(frame), p)
        if p.family in ("binomial", "quasibinomial"):
            return np.stack([1 - mu, mu], axis=1)
        return mu


def _softmax(eta: np.ndarray) -> np.ndarray:
    z = eta - eta.max(axis=1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=1, keepdims=True)


def _ordinal_probs(eta: np.ndarray, thresholds: np.ndarray) -> np.ndarray:
    """Proportional-odds class probabilities: P(y<=k) = sigmoid(t_k - eta)."""
    cum = 1.0 / (1.0 + np.exp(-(thresholds[None, :] - eta[:, None])))  # [N, K-1]
    full = np.concatenate([cum, np.ones((len(eta), 1))], axis=1)
    lower = np.concatenate([np.zeros((len(eta), 1)), cum], axis=1)
    return np.maximum(full - lower, 1e-15)


class GLM(ModelBuilder):
    """Builder (reference driver loop: hex/glm/GLM.java:1160 fitIRLSM)."""

    SUPPORTED_COMMON = frozenset({"weights_column", "offset_column"})

    algo_name = "glm"

    def __init__(self, params: Optional[GLMParameters] = None, **kw) -> None:
        super().__init__(params or GLMParameters(**kw))

    def _validate(self, frame: Frame) -> None:
        super()._validate(frame)
        p: GLMParameters = self.params
        if p.family not in FAMILIES:
            raise ValueError(f"family must be one of {FAMILIES}, got {p.family!r}")
        if p.solver not in SOLVERS:
            raise ValueError(f"solver must be one of {SOLVERS}, got {p.solver!r}")
        if not (0 <= p.alpha <= 1):
            raise ValueError("alpha must be in [0, 1]")
        if p.lambda_ < 0:
            raise ValueError("lambda must be >= 0")
        if p.compute_p_values and (p.lambda_ > 0 or p.lambda_search):
            raise ValueError("p-values require lambda = 0 (no regularization)")
        if p.compute_p_values and p.family in ("multinomial", "ordinal"):
            raise ValueError(f"compute_p_values is not supported for family={p.family!r}")
        if p.solver == "lbfgs" and p.alpha > 0 and (p.lambda_ > 0 or p.lambda_search):
            raise ValueError(
                "solver='lbfgs' does not support L1 (alpha > 0 with lambda > 0); "
                "use solver='irlsm' (ADMM) or alpha=0"
            )
        if p.family == "ordinal":
            if p.alpha > 0 and p.lambda_ > 0:
                raise ValueError("family='ordinal' supports L2 regularization only (alpha=0)")
            if p.lambda_search:
                raise ValueError("lambda_search is not supported for family='ordinal'")
            if p.solver == "irlsm":
                raise ValueError(
                    "family='ordinal' uses a gradient solver; set solver='auto' or 'lbfgs'"
                )
        if p.family == "multinomial" and p.offset_column:
            # a shared offset shifts every class eta equally and cancels in the
            # softmax — accepting it would be a silent no-op
            raise ValueError("offset_column is not supported for family='multinomial'")
        if p.lambda_search and p.nlambdas < 1:
            raise ValueError("nlambdas must be >= 1")

    def _fit(self, frame: Frame, valid: Optional[Frame],
             device: torch.device) -> GLMModel:
        p: GLMParameters = self.params
        link = p.actual_link()
        # device-design cache identity, captured BEFORE any response
        # conversion below rebinds `frame`: the expanded and filtered design
        # is a function of the original column versions and these params,
        # so refits on the same unmutated frame reuse the resident matrix
        from h2o3_tpu_torch.frame import devcache as _devcache

        self._device = device
        self._design_token = _devcache.frame_token(frame)
        self._design_sig = (
            p.standardize, p.missing_values_handling,
            tuple(p.ignored_columns), p.response_column, p.weights_column,
            p.offset_column, p.intercept,
        )
        self._train_frame_key = getattr(frame, "key", None)
        if p.family in ("binomial", "quasibinomial", "multinomial", "ordinal"):
            # the reference requires a categorical response for these
            # families; a numeric column is auto-converted (as_factor)
            ycol = frame.col(p.response_column)
            if ycol.type is not ColType.CAT:
                frame = frame.add_column(ycol.as_factor())
                if valid is not None:
                    valid = valid.add_column(valid.col(p.response_column).as_factor())
        info = build_data_info(
            frame,
            y=p.response_column,
            ignored=p.ignored_columns,
            standardize=p.standardize,
            missing_values_handling=p.missing_values_handling,
        )
        model = GLMModel(p, info, device)

        X, skip = expand_matrix(info, frame, dtype=np.float32)
        y = response_vector(info, frame)
        obs_w = (
            frame.col(p.weights_column).numeric_view().astype(np.float64)
            if p.weights_column
            else np.ones(frame.nrows)
        )
        offset = (
            frame.col(p.offset_column).numeric_view().astype(np.float64)
            if p.offset_column
            else np.zeros(frame.nrows)
        )
        keep = ~(skip | np.isnan(y) | np.isnan(obs_w))
        X, y, obs_w, offset = X[keep], y[keep], obs_w[keep], offset[keep]
        n, pcols = X.shape
        if n == 0:
            raise ValueError("no rows left after NA handling")
        X64 = X.astype(np.float64)  # host copy for eta/deviance (made once)
        wsum = float(obs_w.sum())

        # held-out data for lambda_search submodel selection
        valid_data = None
        if valid is not None and p.lambda_search:
            Xv, skipv = expand_matrix(info, valid, dtype=np.float64)
            yv = response_vector(info, valid)
            wv = (
                valid.col(p.weights_column).numeric_view().astype(np.float64)
                if p.weights_column
                else np.ones(valid.nrows)
            )
            ov = (
                valid.col(p.offset_column).numeric_view().astype(np.float64)
                if p.offset_column
                else np.zeros(valid.nrows)
            )
            keepv = ~(skipv | np.isnan(yv) | np.isnan(wv))
            valid_data = (Xv[keepv], yv[keepv], wv[keepv], ov[keepv])

        if p.family == "multinomial":
            self._fit_multinomial(model, info, X, X64, y, obs_w, offset, wsum, valid_data)
        elif p.family == "ordinal":
            self._fit_ordinal(model, info, X, X64, y, obs_w, offset, wsum)
        else:
            self._fit_gaussian_like(
                model, info, X, X64, y, obs_w, offset, link, wsum, valid_data
            )

        model.training_metrics = model.model_performance(frame)
        if valid is not None:
            model.validation_metrics = model.model_performance(valid)
        return model

    # -- exponential-family path (IRLSM / L-BFGS + lambda search) ------------

    def _fit_gaussian_like(
        self, model, info, X, X64, y, obs_w, offset, link, wsum, valid_data
    ) -> None:
        p: GLMParameters = self.params
        n, pcols = X.shape
        ybar = float((obs_w * y).sum() / wsum)
        beta0 = np.zeros(pcols + 1)
        # intercept warm start at the link of the response mean (GLM.java init)
        if p.intercept:
            beta0[-1] = _link_of_mean(link, ybar, p)
        solver = "irlsm" if p.solver == "auto" else p.solver
        if solver == "lbfgs":
            solve = self._make_lbfgs_solver(X64, y, obs_w, offset, link, wsum)
        else:
            Xd, pad = self._device_design(X)
            solve = lambda lam, b0: self._irlsm(
                X64, Xd, pad, y, obs_w, offset, link, lam, b0, wsum
            )

        if p.lambda_search:
            lambdas = self._lambda_grid(X64, y, obs_w, offset, link, wsum, pcols, n)
            null_dev = float(
                (obs_w * deviance(p.family, y, np.full_like(y, ybar), p)).sum()
            )

            def dev_train(b):
                mu = _linkinv(link, X64 @ b[:-1] + b[-1] + offset, p)
                return float((obs_w * deviance(p.family, y, mu, p)).sum())

            dev_valid = None
            if valid_data is not None:
                Xv, yv, wv, ov = valid_data

                def dev_valid(b):
                    muv = _linkinv(link, Xv @ b[:-1] + b[-1] + ov, p)
                    return float((wv * deviance(p.family, yv, muv, p)).sum())

            beta = self._run_lambda_path(
                model, lambdas, solve, dev_train, dev_valid,
                nonzeros=lambda b: int(np.sum(np.abs(b[:-1]) > 1e-12)),
                null_dev=null_dev, state0=beta0,
            )
        else:
            beta, model.iterations = solve(p.lambda_, beta0)

        model.beta_std = beta
        b_raw, icpt = destandardize_coefs(info, beta[:-1], beta[-1])
        model.coefficients = dict(zip(info.coef_names, b_raw.tolist()))
        model.coefficients["Intercept"] = icpt
        model.coefficients_std = dict(zip(info.coef_names, beta[:-1].tolist()))
        model.coefficients_std["Intercept"] = float(beta[-1])

        # deviances + AIC (GLMModel.GLMOutput)
        mu = _linkinv(link, X64 @ beta[:-1] + beta[-1] + offset, p)
        model.residual_deviance = float((obs_w * deviance(p.family, y, mu, p)).sum())
        mu0 = np.full_like(y, ybar)
        model.null_deviance = float((obs_w * deviance(p.family, y, mu0, p)).sum())
        rank = int(np.sum(np.abs(beta[:-1]) > 0)) + (1 if p.intercept else 0)
        model.aic = _aic(p.family, y, mu, obs_w, model.residual_deviance, rank)

        if p.compute_p_values and p.lambda_ == 0 and not p.lambda_search:
            self._p_values(model, X, y, mu, obs_w, offset, link, p, info)

    def _cached_upload(self, kind: str, build, extra=()):
        """Memoize a device placement through the process-wide devcache,
        keyed on (placement kind, frame token, design params and ``extra``,
        device). Falls through to a plain upload when the frame has no
        version stamps."""
        from h2o3_tpu_torch.frame import devcache as _devcache

        sig = getattr(self, "_design_sig", None)
        return _devcache.cached(
            kind, getattr(self, "_design_token", None),
            None if sig is None else sig + tuple(extra), self._device, build,
            frame_key=getattr(self, "_train_frame_key", None),
        )

    def _device_design(self, X: np.ndarray):
        """This rank's rows of the design matrix [S, P(+1 intercept col)] on
        the device, and the row padder that cuts a host vector of every row
        to the same rows (pad rows 0). With no process group: every row,
        and the identity. The IRLSM Gram merges over ``self._mesh``."""
        p: GLMParameters = self.params
        mesh = self._mesh = default_mesh()

        def build():
            Xi = (
                np.concatenate(
                    [X, np.ones((len(X), 1), dtype=np.float32)], axis=1
                )
                if p.intercept
                else X
            )
            return to_device_f32(local_rows(Xi, mesh), self._device)

        Xd = self._cached_upload("glm_design", build, (mesh.size, mesh.rank))
        return Xd, (lambda a: local_rows(a, mesh))

    def _run_lambda_path(
        self, model, lambdas, solve, dev_train, dev_valid, nonzeros, null_dev, state0
    ):
        """Warm-started fit along the lambda path + submodel selection
        (GLM.java:1632 lambda search; selection by validation deviance when a
        validation frame exists, else training deviance)."""
        path: List[Dict[str, float]] = []
        states: List[np.ndarray] = []
        state = state0
        total_iters = 0
        for lam in lambdas:
            state, iters = solve(float(lam), state)
            total_iters += iters
            dev = dev_train(state)
            entry = {
                "lambda": float(lam),
                "deviance_train": dev,
                "explained_deviance_train": 1.0 - dev / max(null_dev, 1e-300),
                "nonzeros": nonzeros(state),
            }
            if dev_valid is not None:
                entry["deviance_valid"] = dev_valid(state)
            path.append(entry)
            states.append(np.array(state, copy=True))
        crit = "deviance_valid" if dev_valid is not None else "deviance_train"
        best = int(np.argmin([e[crit] for e in path]))
        model.lambda_path = path
        model.lambda_best = path[best]["lambda"]
        model.iterations = total_iters
        return states[best]

    def _grid_from_gradient(self, g: np.ndarray, wsum: float, n: int, pcols: int) -> np.ndarray:
        """Lambda grid given the null-model gradient: lambda_max is the
        smallest lambda that zeroes every penalized coefficient."""
        p: GLMParameters = self.params
        lambda_max = max(float(np.max(np.abs(g))) / (wsum * max(p.alpha, 1e-3)), 1e-10)
        lmin_ratio = p.lambda_min_ratio or (1e-4 if n > pcols else 1e-2)
        if p.nlambdas == 1:
            return np.array([lambda_max])
        return np.geomspace(lambda_max, lambda_max * lmin_ratio, p.nlambdas)

    def _irlsm(
        self, X64, Xd, pad, y, obs_w, offset, link, lam, beta0, wsum
    ) -> Tuple[np.ndarray, int]:
        """One IRLSM solve at a fixed lambda (GLM.java:1160 fitIRLSM)."""
        p: GLMParameters = self.params
        l1 = lam * p.alpha
        l2 = lam * (1 - p.alpha)
        beta = beta0.copy()
        prev_obj = np.inf
        iters = 0
        for it in range(p.max_iterations):
            eta = X64 @ beta[:-1] + beta[-1] + offset
            mu = _linkinv(link, eta, p)
            d = _link_deriv(link, mu, p)
            v = _variance(p.family, mu, p)
            w = obs_w / np.maximum(v * d * d, 1e-12)
            wz = (eta - offset) + (y - mu) * d

            G, q = _gram(Xd, pad(wz), pad(w), self._mesh)
            free = 1 if p.intercept else 0
            if l1 > 0:
                solved = _solve_admm(G / wsum, q / wsum, l1, l2, free=free)
            else:
                solved = _solve_ridge(G / wsum, q / wsum, l2, free=free)
            # without an intercept the ones column is excluded from the solve
            # entirely (clamping after solving would converge to wrong coefs)
            beta_new = solved if p.intercept else np.append(solved, 0.0)

            dev = float((obs_w * deviance(p.family, y, _linkinv(link, X64 @ beta_new[:-1] + beta_new[-1] + offset, p), p)).sum())
            obj = dev / (2 * wsum) + lam * (
                p.alpha * np.abs(beta_new[:-1]).sum() + (1 - p.alpha) / 2 * (beta_new[:-1] ** 2).sum()
            )
            delta = np.max(np.abs(beta_new - beta))
            beta = beta_new
            iters = it + 1
            if delta < p.beta_epsilon or abs(prev_obj - obj) < p.objective_epsilon * max(abs(prev_obj), 1.0):
                break
            prev_obj = obj
        return beta, iters

    def _lambda_grid(self, X64, y, obs_w, offset, link, wsum, pcols, n) -> np.ndarray:
        """Log-spaced lambda path from lambda_max down (GLM.java:1632
        makeLambdaSearch; lambda_max = smallest lambda that zeroes every
        penalized coefficient, from the null-model gradient)."""
        p: GLMParameters = self.params
        ybar = float((obs_w * y).sum() / wsum)
        eta0 = np.full_like(y, _link_of_mean(link, ybar, p)) + offset
        mu0 = _linkinv(link, eta0, p)
        d = _link_deriv(link, mu0, p)
        v = _variance(p.family, mu0, p)
        w = obs_w / np.maximum(v * d * d, 1e-12)
        g = X64.T @ (w * (y - mu0) * d)
        return self._grid_from_gradient(g, wsum, n, pcols)

    _CANONICAL_LINK = {
        "gaussian": "identity", "binomial": "logit", "quasibinomial": "logit",
        "poisson": "log", "gamma": "log", "tweedie": "tweedie",
    }

    def _make_lbfgs_solver(self, X64, y, obs_w, offset, link, wsum):
        """L-BFGS solver factory (hex/optimization/L_BFGS.java): the device
        tensors are placed once, and the returned solve(lam, beta0) is
        reused across a lambda path. The NLL
        below is written in eta for the canonical link of each family, so any
        other link must be rejected (it would silently fit a different
        model)."""
        p: GLMParameters = self.params
        canonical = self._CANONICAL_LINK.get(p.family)
        if link != canonical or (p.family == "tweedie" and p.tweedie_link_power != 0):
            raise ValueError(
                f"solver='lbfgs' supports only the canonical link for "
                f"family={p.family!r} ({canonical!r}"
                + (", tweedie_link_power=0" if p.family == "tweedie" else "")
                + f"); got link={link!r}. Use solver='irlsm'."
            )
        dev = self._device
        Xf = self._cached_upload(
            "glm_lbfgs_x", lambda: to_device_f32(X64, dev))
        wd = to_device_f32(obs_w, dev)
        yd = to_device_f32(y, dev)
        od = to_device_f32(offset, dev)
        family = p.family
        vpow = p.tweedie_variance_power
        intercept = p.intercept

        def nll(params, l2):
            beta, icpt = params[:-1], params[-1]
            eta = Xf @ beta + (icpt if intercept else 0.0) + od
            if family == "gaussian":
                per = 0.5 * (yd - eta) ** 2
            elif family in ("binomial", "quasibinomial"):
                per = _logaddexp0(eta) - yd * eta
            elif family == "poisson":
                per = torch.exp(eta) - yd * eta
            elif family == "gamma":
                per = yd * torch.exp(-eta) + eta
            else:  # tweedie, log link
                mu = torch.exp(eta)
                a = torch.where(
                    yd > 0,
                    torch.pow(torch.clamp(yd, min=1e-10), 2 - vpow) / ((1 - vpow) * (2 - vpow)),
                    0.0,
                )
                per = a - yd * torch.pow(mu, 1 - vpow) / (1 - vpow) + torch.pow(mu, 2 - vpow) / (2 - vpow)
            return (wd * per).sum() / wsum + 0.5 * l2 * (beta ** 2).sum()

        from scipy.optimize import minimize

        def solve(lam: float, beta0: np.ndarray) -> Tuple[np.ndarray, int]:
            l2 = float(np.float32(lam * (1 - p.alpha)))

            def fun(x):
                v, g = _value_and_grad(nll, x, dev, l2)
                if not intercept:
                    g[-1] = 0.0
                return float(v), g

            res = minimize(
                fun, beta0, jac=True, method="L-BFGS-B",
                options={"maxiter": max(p.max_iterations * 10, 100), "ftol": 1e-12},
            )
            return np.asarray(res.x, dtype=np.float64), int(res.nit)

        return solve

    # -- multinomial (GLM.java:1160 fitIRLSM multinomial: cyclic per-class) --

    def _fit_multinomial(
        self, model, info, X, X64, y, obs_w, offset, wsum, valid_data
    ) -> None:
        p: GLMParameters = self.params
        K = len(info.response_domain)
        n, pcols = X.shape
        yi = y.astype(np.int64)
        Y = np.zeros((n, K))
        Y[np.arange(n), yi] = 1.0
        priors = np.maximum(obs_w @ Y / wsum, 1e-10)
        B0 = np.zeros((pcols + 1, K))
        if p.intercept:
            B0[-1] = np.log(priors)

        null_mu = np.tile(priors, (n, 1))
        model.null_deviance = float(
            -2.0 * (obs_w * np.log(null_mu[np.arange(n), yi])).sum()
        )

        solver = "irlsm" if p.solver == "auto" else p.solver
        if solver == "lbfgs":
            mn_solve = self._make_multinomial_lbfgs(X64, Y, obs_w, wsum, pcols, K)
        else:
            Xd, pad = self._device_design(X)
            mn_solve = lambda lam, B0_: self._multinomial_irlsm(
                X64, Xd, pad, Y, yi, obs_w, offset, lam, B0_, wsum
            )

        if p.lambda_search:
            # lambda_max from the per-class null-model gradients
            g = X64.T @ (obs_w[:, None] * (Y - null_mu))
            lambdas = self._grid_from_gradient(g, wsum, n, pcols)
            dev_valid = None
            if valid_data is not None:
                Xv, yv, wv, ov = valid_data
                dev_valid = lambda B: self._multinomial_deviance(
                    Xv, B, ov, yv.astype(np.int64), wv
                )
            B = self._run_lambda_path(
                model, lambdas, mn_solve,
                dev_train=lambda B: self._multinomial_deviance(X64, B, offset, yi, obs_w),
                dev_valid=dev_valid,
                nonzeros=lambda B: int(np.sum(np.abs(B[:-1]) > 1e-12)),
                null_dev=model.null_deviance, state0=B0,
            )
        else:
            B, model.iterations = mn_solve(p.lambda_, B0)

        model.beta_multi = B
        model.residual_deviance = self._multinomial_deviance(X64, B, offset, yi, obs_w)
        coefs: Dict[str, Dict[str, float]] = {}
        for k, lv in enumerate(info.response_domain):
            b_raw, icpt = destandardize_coefs(info, B[:-1, k], B[-1, k])
            d = dict(zip(info.coef_names, b_raw.tolist()))
            d["Intercept"] = icpt
            coefs[lv] = d
        model.coefficients_multinomial = coefs
        # flat view for generic consumers: class-suffixed names
        model.coefficients = {
            f"{name}_{lv}": val
            for lv, d in coefs.items()
            for name, val in d.items()
        }

    def _multinomial_irlsm(
        self, X64, Xd, pad, Y, yi, obs_w, offset, lam, B0, wsum
    ) -> Tuple[np.ndarray, int]:
        """Cyclic per-class IRLS: for class c, a weighted least-squares solve
        with softmax weights mu_c(1-mu_c), recomputing the softmax after each
        class update (the reference's multinomial IRLSM sweep)."""
        p: GLMParameters = self.params
        l1 = lam * p.alpha
        l2 = lam * (1 - p.alpha)
        K = Y.shape[1]
        n = len(yi)
        B = B0.copy()
        eta = X64 @ B[:-1] + B[-1] + offset[:, None]
        prev_obj = np.inf
        iters = 0
        free = 1 if p.intercept else 0
        for it in range(p.max_iterations):
            max_delta = 0.0
            for c in range(K):
                mu = _softmax(eta)
                muc = np.clip(mu[:, c], 1e-10, 1 - 1e-10)
                vc = muc * (1 - muc)
                w = obs_w * vc
                wz = (eta[:, c] - offset) + (Y[:, c] - muc) / vc
                G, q = _gram(Xd, pad(wz), pad(w), self._mesh)
                if l1 > 0:
                    solved = _solve_admm(G / wsum, q / wsum, l1, l2, free=free)
                else:
                    solved = _solve_ridge(G / wsum, q / wsum, l2, free=free)
                bc = solved if p.intercept else np.append(solved, 0.0)
                max_delta = max(max_delta, float(np.max(np.abs(bc - B[:, c]))))
                B[:, c] = bc
                eta[:, c] = X64 @ bc[:-1] + bc[-1] + offset
            dev = self._multinomial_deviance(X64, B, offset, yi, obs_w)
            obj = dev / (2 * wsum) + lam * (
                p.alpha * np.abs(B[:-1]).sum() + (1 - p.alpha) / 2 * (B[:-1] ** 2).sum()
            )
            iters = it + 1
            if max_delta < p.beta_epsilon or abs(prev_obj - obj) < p.objective_epsilon * max(abs(prev_obj), 1.0):
                break
            prev_obj = obj
        return B, iters

    @staticmethod
    def _multinomial_deviance(X64, B, offset, yi, obs_w) -> float:
        eta = X64 @ B[:-1] + B[-1]
        if np.ndim(offset) == 1 and len(np.atleast_1d(offset)) == eta.shape[0]:
            eta = eta + np.asarray(offset)[:, None]
        mu = _softmax(eta)
        pi = np.clip(mu[np.arange(len(yi)), yi], 1e-15, 1.0)
        return float(-2.0 * (obs_w * np.log(pi)).sum())

    def _make_multinomial_lbfgs(self, X64, Y, obs_w, wsum, pcols, K):
        """Softmax cross-entropy L-BFGS over the full [P+1, K] coefficient
        block (the reference's multinomial L_BFGS solver path); the device
        tensors are placed once and reused across a lambda path."""
        p: GLMParameters = self.params
        dev = self._device
        Xf = self._cached_upload(
            "glm_multinomial_x", lambda: to_device_f32(X64, dev))
        wd = to_device_f32(obs_w, dev)
        Yd = to_device_f32(Y, dev)
        intercept = p.intercept

        def nll(flat, l2):
            B = flat.reshape(pcols + 1, K)
            eta = Xf @ B[:-1] + (B[-1] if intercept else 0.0)
            logp = torch.log_softmax(eta, dim=1)
            ce = -(wd * (Yd * logp).sum(dim=1)).sum() / wsum
            return ce + 0.5 * l2 * (B[:-1] ** 2).sum()

        from scipy.optimize import minimize

        def solve(lam: float, B0: np.ndarray) -> Tuple[np.ndarray, int]:
            l2 = float(np.float32(lam * (1 - p.alpha)))

            def fun(x):
                v, g = _value_and_grad(nll, x, dev, l2)
                g = g.reshape(pcols + 1, K)
                if not intercept:
                    g[-1] = 0.0
                return float(v), g.ravel()

            res = minimize(
                fun, np.asarray(B0, dtype=np.float64).ravel(), jac=True,
                method="L-BFGS-B",
                options={"maxiter": max(p.max_iterations * 10, 200), "ftol": 1e-12},
            )
            return np.asarray(res.x, dtype=np.float64).reshape(pcols + 1, K), int(res.nit)

        return solve

    # -- ordinal (proportional odds / ologit; GLM.java ordinal solver) -------

    def _fit_ordinal(self, model, info, X, X64, y, obs_w, offset, wsum) -> None:
        """Cumulative-logit fit: shared beta + K-1 increasing thresholds,
        maximized by L-BFGS with the value and gradient on the device (the
        reference's ordinal gradient solver, GLMModel ordinal family)."""
        p: GLMParameters = self.params
        K = len(info.response_domain)
        if K < 2:
            raise ValueError("ordinal family needs a categorical response with >= 2 levels")
        n, pcols = X.shape
        l2 = p.lambda_ * (1 - p.alpha)
        dev = self._device
        Xf = self._cached_upload("glm_ordinal_x", lambda: to_device_f32(X, dev))
        wd = to_device_f32(obs_w, dev)
        yk = torch.from_numpy(y.astype(np.int64)).to(dev)
        od = to_device_f32(offset, dev)
        nth = K - 1
        l2 = float(np.float32(l2))

        def nll(params, l2):
            beta = params[:pcols]
            a = params[pcols:]
            if nth > 1:
                t = torch.cat([a[:1], a[:1] + torch.cumsum(_logaddexp0(a[1:]), 0)])
            else:
                t = a
            eta = Xf @ beta + od
            cum = torch.sigmoid(t[None, :] - eta[:, None])  # [N, K-1]
            ones = torch.ones((cum.shape[0], 1), dtype=cum.dtype, device=dev)
            full = torch.cat([cum, ones], dim=1)
            lower = torch.cat([torch.zeros_like(ones), cum], dim=1)
            pk = torch.clamp(full - lower, 1e-12, 1.0)
            pi = pk.gather(1, yk[:, None])[:, 0]
            return -(wd * torch.log(pi)).sum() / wsum + 0.5 * l2 * (beta ** 2).sum()

        def fun(x):
            return _value_and_grad(nll, x, dev, l2)

        # threshold init from cumulative class priors (logit scale)
        yi = y.astype(np.int64)
        counts = np.bincount(yi, weights=obs_w, minlength=K)
        cp = np.clip(np.cumsum(counts)[:-1] / wsum, 1e-6, 1 - 1e-6)
        t0 = np.log(cp / (1 - cp))
        a0 = np.empty(nth)
        a0[0] = t0[0]
        if nth > 1:
            d = np.maximum(np.diff(t0), 1e-3)
            a0[1:] = np.log(np.expm1(d))  # softplus inverse
        x0 = np.concatenate([np.zeros(pcols), a0])

        from scipy.optimize import minimize

        res = minimize(
            fun, x0, jac=True, method="L-BFGS-B",
            options={"maxiter": max(p.max_iterations * 10, 200), "ftol": 1e-12},
        )
        sol = np.asarray(res.x, dtype=np.float64)
        model.iterations = int(res.nit)
        beta = sol[:pcols]
        a = sol[pcols:]
        t = (
            np.concatenate([a[:1], a[0] + np.cumsum(np.log1p(np.exp(a[1:])))])
            if nth > 1
            else a
        )
        model.beta_std = beta
        model.ordinal_thresholds = t

        b_raw, icpt_shift = destandardize_coefs(info, beta, 0.0)
        model.coefficients = dict(zip(info.coef_names, b_raw.tolist()))
        for k in range(nth):
            # raw-space threshold: P(y<=k) = sigmoid(t_k_raw - x.b_raw)
            model.coefficients[f"Threshold.{info.response_domain[k]}"] = float(t[k] - icpt_shift)
        model.coefficients_std = dict(zip(info.coef_names, beta.tolist()))

        probs = _ordinal_probs(X64 @ beta + offset, t)
        pi = probs[np.arange(n), yi]
        model.residual_deviance = float(-2.0 * (obs_w * np.log(pi)).sum())
        priors = np.maximum(counts / wsum, 1e-15)
        model.null_deviance = float(-2.0 * (obs_w * np.log(priors[yi])).sum())

    def _p_values(self, model, X, y, mu, obs_w, offset, link, p, info) -> None:
        d = _link_deriv(link, mu, p)
        v = _variance(p.family, mu, p)
        w = obs_w / np.maximum(v * d * d, 1e-12)
        Xi = np.concatenate([X.astype(np.float64), np.ones((len(y), 1))], axis=1)
        G = Xi.T @ (w[:, None] * Xi)
        cov = np.linalg.pinv(G)
        if p.family in ("gaussian", "gamma", "tweedie", "quasibinomial"):
            dof = max(len(y) - G.shape[0], 1)
            disp = float((obs_w * (y - mu) ** 2 / _variance(p.family, mu, p)).sum() / dof)
        else:
            disp = 1.0
        model.dispersion = disp
        se = np.sqrt(np.maximum(np.diag(cov) * disp, 0))
        zvals = model.beta_std / np.maximum(se, 1e-300)
        from scipy import stats as sps

        if p.family in ("gaussian",):
            pv = 2 * sps.t.sf(np.abs(zvals), df=max(len(y) - G.shape[0], 1))
        else:
            pv = 2 * sps.norm.sf(np.abs(zvals))
        names = info.coef_names + ["Intercept"]
        model.std_errors = dict(zip(names, se.tolist()))
        model.p_values = dict(zip(names, pv.tolist()))


def _value_and_grad(nll, x: np.ndarray, device: torch.device, l2: float):
    """The objective and its gradient at the host point ``x`` (float64,
    rounded to float32 on the device, as the JAX package rounds it), back
    on the host as (float, float64 array)."""
    params = to_device_f32(x, device).requires_grad_(True)
    v = nll(params, l2)
    (g,) = torch.autograd.grad(v, params)
    return float(v.detach()), g.cpu().numpy().astype(np.float64)


def _link_of_mean(link: str, ybar: float, p: GLMParameters) -> float:
    eps = 1e-10
    if link == "identity":
        return ybar
    if link == "logit":
        yb = min(max(ybar, eps), 1 - eps)
        return float(np.log(yb / (1 - yb)))
    if link == "log":
        return float(np.log(max(ybar, eps)))
    if link == "inverse":
        return 1.0 / max(abs(ybar), eps) * (1 if ybar >= 0 else -1)
    if link == "tweedie":
        lp = p.tweedie_link_power
        return float(np.log(max(ybar, eps))) if lp == 0 else float(np.power(max(ybar, eps), lp))
    raise ValueError(link)


def _aic(family, y, mu, w, resid_dev, rank) -> float:
    n = len(y)
    eps = 1e-15
    if family == "gaussian":
        return float(n * np.log(2 * np.pi * resid_dev / n) + n + 2 * (rank + 1))
    if family == "binomial":
        mu = np.clip(mu, eps, 1 - eps)
        ll = float((w * (y * np.log(mu) + (1 - y) * np.log(1 - mu))).sum())
        return -2 * ll + 2 * rank
    if family == "poisson":
        from scipy.special import gammaln

        ll = float((w * (y * np.log(np.maximum(mu, eps)) - mu - gammaln(y + 1))).sum())
        return -2 * ll + 2 * rank
    return float("nan")  # gamma/tweedie AIC needs dispersion MLE (as in reference: NaN unless computed)
