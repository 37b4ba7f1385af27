"""GAM — the port of ``h2o3_tpu/models/gam.py``.

Generalized additive models (``hex/gam/GAM.java:47``): each ``gam_column``
is expanded into a spline basis block (cubic regression splines, 1-D or
multi-predictor thin-plate smoothers, monotone I-splines, M-splines;
``hex/gam/GamSplines/``), centered against the intercept, and the
penalized IRLSM solves ``(X'WX + sum_j lambda_j S_j) beta = X'Wz``.

The split between host and device is the JAX package's:

- the spline machinery (knots, bases, penalties, the centering
  transforms) is host numpy in float64, a copy of the JAX package's;
- the design ``[X, 1]`` is placed on the device once in float32 through
  ``frame/devcache.cached`` (kind ``gam_design``), keyed on the frame's
  column stamps and the parameters that shape the design only (not
  ``lambda_``, ``alpha`` or ``scale``), so refits that retune the
  smoothing or the penalty reuse it;
- each IRLSM iteration computes eta, the working weights and response
  on the host in float64 and one Gram pass on the device (the GLM's
  ``_gram_kernel``, in float64); the penalized solve (``_solve_ridge``, ``_solve_admm``, the
  non-negative active-set projection of the I-spline blocks) runs on the
  host;
- scoring rebuilds the design on the host and applies beta in float64;
  the training metrics score the design the fit built.

The Gram pass accumulates in float64 where the JAX package's is float32.
Spline designs are ill-conditioned (the binomial GAM of the card's smoke
run, thin-plate and I-spline blocks, has a condition number near 2e3 on
200,000 rows), and a float32 Gram fixes their coefficients only to about
1e-2: the card's and the CPU's float32 sums parted by 0.02. In float64
the card and the CPU agree, and the JAX package's float32 fit lies within
its own rounding of the port's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from h2o3_tpu_torch.device import to_device_f32
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.data_info import build_data_info, expand_matrix, response_vector
from h2o3_tpu_torch.models.framework import Model, ModelBuilder
from h2o3_tpu_torch.models.glm import (
    GLMParameters,
    _aic,
    _gram_kernel,
    _link_deriv,
    _link_of_mean,
    _linkinv,
    _solve_admm,
    _solve_ridge,
    _variance,
    deviance,
)


@dataclass
class GAMParameters(GLMParameters):
    gam_columns: List[str] = field(default_factory=list)
    #: knots per gam column — int (shared) or list aligned with gam_columns
    num_knots: object = 10
    #: smoothing lambda per gam column — float (shared) or aligned list
    scale: object = 1.0
    #: spline family per column (GAMParametersV3 bs codes): 0 = cubic
    #: regression spline, 1 = thin-plate, 2 = monotone I-splines,
    #: 3 = M-splines; int (shared) or aligned list
    bs: object = 0
    #: explicit knot locations per gam column (reference knot_ids frames);
    #: None = quantile placement
    knots: Optional[List[Optional[List[float]]]] = None
    #: I-spline coefficients constrained >= 0 (monotone non-decreasing)
    splines_non_negative: bool = True


# ---------------------------------------------------------------------------
# cubic regression spline machinery (hex/gam/GamSplines/CubicRegressionSplines)


def cr_matrices(knots: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Natural-cubic-spline D ((K-2)xK) and B ((K-2)x(K-2)) matrices.
    gamma = B^-1 D beta maps knot values to interior second derivatives;
    the curvature penalty is S = D^T B^-1 D."""
    h = np.diff(knots)
    K = len(knots)
    D = np.zeros((K - 2, K))
    B = np.zeros((K - 2, K - 2))
    for i in range(K - 2):
        D[i, i] = 1.0 / h[i]
        D[i, i + 1] = -1.0 / h[i] - 1.0 / h[i + 1]
        D[i, i + 2] = 1.0 / h[i + 1]
        B[i, i] = (h[i] + h[i + 1]) / 3.0
        if i + 1 < K - 2:
            B[i, i + 1] = B[i + 1, i] = h[i + 1] / 6.0
    return D, B


def cr_penalty(knots: np.ndarray) -> np.ndarray:
    D, B = cr_matrices(knots)
    return D.T @ np.linalg.solve(B, D)


def cr_basis(x: np.ndarray, knots: np.ndarray) -> np.ndarray:
    """[N, K] cardinal natural-cubic-spline basis: row . beta evaluates the
    spline with values beta at the knots (linear extrapolation outside)."""
    D, B = cr_matrices(knots)
    F = np.vstack([np.zeros(len(knots)), np.linalg.solve(B, D), np.zeros(len(knots))])
    h = np.diff(knots)
    K = len(knots)
    xc = np.clip(x, knots[0], knots[-1])
    j = np.clip(np.searchsorted(knots, xc, side="right") - 1, 0, K - 2)
    hj = h[j]
    kl, kr = knots[j], knots[j + 1]
    am = (kr - xc) / hj
    ap = (xc - kl) / hj
    cm = ((kr - xc) ** 3 / hj - hj * (kr - xc)) / 6.0
    cp = ((xc - kl) ** 3 / hj - hj * (xc - kl)) / 6.0
    n = len(x)
    basis = np.zeros((n, K))
    rows = np.arange(n)
    basis[rows, j] += am
    basis[rows, j + 1] += ap
    basis += cm[:, None] * F[j] + cp[:, None] * F[j + 1]
    # linear extrapolation beyond the boundary knots (natural spline slope)
    lo, hi = x < knots[0], x > knots[-1]
    if lo.any():
        slope = (cr_basis(np.array([knots[0] + 1e-6]), knots) - cr_basis(np.array([knots[0]]), knots)) / 1e-6
        basis[lo] = cr_basis(np.array([knots[0]]), knots) + (x[lo] - knots[0])[:, None] * slope
    if hi.any():
        slope = (cr_basis(np.array([knots[-1]]), knots) - cr_basis(np.array([knots[-1] - 1e-6]), knots)) / 1e-6
        basis[hi] = cr_basis(np.array([knots[-1]]), knots) + (x[hi] - knots[-1])[:, None] * slope
    return basis


# ---------------------------------------------------------------------------
# other spline families (hex/gam/GamSplines: ThinPlate*, NBSplinesTypeI/II)


def tp_basis(x: np.ndarray, knots: np.ndarray) -> np.ndarray:
    """1-D thin-plate basis: {x, |x-k|^3 per knot} (the polynomial-plus-
    radial construction of ThinPlateRegressionUtils, d=1 -> eta(r)=r^3)."""
    r = np.abs(x[:, None] - knots[None, :]) ** 3
    return np.concatenate([x[:, None], r], axis=1)


def tp_penalty(knots: np.ndarray) -> np.ndarray:
    """Bending-energy quadratic form on the radial coefficients; the
    linear term is unpenalized (thin-plate null space)."""
    K = len(knots)
    E = np.abs(knots[:, None] - knots[None, :]) ** 3
    S = np.zeros((K + 1, K + 1))
    S[1:, 1:] = E + 1e-8 * np.eye(K)  # PSD guard
    return S


def tp_m(d: int) -> int:
    """(m-1) = max polynomial degree of the TP null space:
    m = floor((d+1)/2)+1 (ThinPlateRegressionUtils.calculatem)."""
    return int(np.floor((d + 1) * 0.5)) + 1


def tp_poly_exponents(d: int, m: int) -> List[Tuple[int, ...]]:
    """All monomial exponent tuples with total degree < m, the all-zeros
    (constant) term first — M = C(d+m-1, d) of them
    (ThinPlateRegressionUtils.findPolyBasis)."""
    from itertools import product

    combos = [t for t in product(range(m), repeat=d) if sum(t) < m]
    combos.sort(key=lambda t: (sum(t), t))
    return combos


def tp_const(m: int, d: int) -> float:
    """Radial-basis scale (GamUtilsThinPlateRegression.calTPConstantTerm)."""
    from math import factorial, pi

    if d % 2 == 0:
        return ((-1.0) ** (m + 1 + d / 2.0)
                / (2.0 ** (2 * m - 1) * pi ** (d / 2.0)
                   * factorial(m - 1) * factorial(m - d // 2)))
    return ((-1.0) ** m * m
            / (factorial(2 * m) * pi ** ((d - 1) / 2.0)))


def tp_distance(X: np.ndarray, knots: np.ndarray, m: int) -> np.ndarray:
    """[N, K] radial terms phi(|x - k_i|) as the reference scores them
    (GamUtilsThinPlateRegression.calculateDistance): const * r^(2m-d), and
    for even d an extra * log(r^(2m-d)) where the power is nonzero."""
    d = knots.shape[1]
    # the Gram identity keeps temporaries at [N, K] (an [N, K, d] broadcast
    # difference would dominate peak memory when scoring large frames)
    r2 = ((X * X).sum(axis=1)[:, None] + (knots * knots).sum(axis=1)[None]
          - 2.0 * X @ knots.T)
    r = np.sqrt(np.maximum(r2, 0.0))
    dist = r ** (2 * m - d)
    out = tp_const(m, d) * dist
    if d % 2 == 0:
        with np.errstate(divide="ignore"):
            lg = np.where(dist != 0, np.log(np.maximum(dist, 1e-300)), 0.0)
        out = out * lg
    return out


def tp_polynomials(X: np.ndarray,
                   expo: List[Tuple[int, ...]]) -> np.ndarray:
    """[N, M] monomial basis (calculatePolynomialBasis)."""
    out = np.ones((X.shape[0], len(expo)))
    for j, t in enumerate(expo):
        for p, e in enumerate(t):
            if e:
                out[:, j] *= X[:, p] ** e
    return out


def _bspline_knots(knots: np.ndarray, degree: int) -> np.ndarray:
    return np.concatenate([
        np.repeat(knots[0], degree), knots, np.repeat(knots[-1], degree)
    ])


def m_basis(x: np.ndarray, knots: np.ndarray, degree: int = 3) -> np.ndarray:
    """M-spline (normalized B-spline) basis via scipy (NBSplinesTypeII)."""
    from scipy.interpolate import BSpline

    t = _bspline_knots(knots, degree)
    xc = np.clip(x, knots[0], knots[-1])
    return BSpline.design_matrix(xc, t, degree, extrapolate=False).toarray()


def m_penalty(n_basis: int) -> np.ndarray:
    """Second-difference P-spline penalty D2^T D2 (Eilers/Marx: the
    curvature surrogate the reference's NBSpline penalty plays)."""
    D = np.diff(np.eye(n_basis), n=2, axis=0)
    return D.T @ D


def i_basis(x: np.ndarray, knots: np.ndarray, degree: int = 3) -> np.ndarray:
    """I-spline basis (NBSplinesTypeI): running integrals of M-splines;
    each basis function rises monotonically from 0 to 1, so non-negative
    coefficients give a monotone smooth."""
    from scipy.interpolate import BSpline

    t = _bspline_knots(knots, degree + 1)
    xc = np.clip(x, knots[0], knots[-1])
    dm = BSpline.design_matrix(xc, t, degree + 1, extrapolate=False).toarray()
    # I_j(x) = sum of higher-order B-splines from j+1 on (de Boor)
    return np.cumsum(dm[:, ::-1], axis=1)[:, ::-1][:, 1:]


@dataclass
class TpSpec:
    """Multi-predictor thin-plate smoother (ThinPlateDistanceWithKnots +
    ThinPlatePolynomialWithKnots): d-dim radial distances to K knot
    points, projected through zCS (the null space of the knot-polynomial
    matrix, the T'delta=0 constraint), concatenated with the M monomials
    of total degree < m, then centered through Z like every other
    smoother."""

    columns: List[str]
    knots: np.ndarray          # [K, d] knot points (data rows)
    zcs: np.ndarray            # [K, K-M]
    Z: np.ndarray              # [K, K-1] centering transform
    penalty: np.ndarray        # [K-1, K-1] (bending energy through Z)
    na_fill: np.ndarray        # [d] per-predictor training medians
    m: int
    kind: int = 1
    nonneg: bool = False

    @property
    def column(self) -> str:  # display/coefficient-name anchor
        return "_".join(self.columns)

    @property
    def expo(self) -> List[Tuple[int, ...]]:
        return tp_poly_exponents(self.knots.shape[1], self.m)

    def raw_basis(self, X: np.ndarray) -> np.ndarray:
        dist = tp_distance(X, self.knots, self.m) @ self.zcs
        poly = tp_polynomials(X, self.expo)
        return np.concatenate([dist, poly], axis=1)

    def stack(self, frame: Frame) -> np.ndarray:
        """[N, d] raw predictor matrix: the one extraction both training
        and scoring use."""
        return _tp_stack(frame, self.columns)

    def expand(self, X: np.ndarray) -> np.ndarray:
        X = np.where(np.isnan(X), self.na_fill[None, :], X)
        return self.raw_basis(X) @ self.Z


def _tp_stack(frame: Frame, columns) -> np.ndarray:
    return np.column_stack([
        frame.col(c).numeric_view().astype(np.float64) for c in columns])


def _make_tp_spec(columns: List[str], X: np.ndarray,
                  num_knots: int) -> TpSpec:
    """Joint thin-plate smoother over >= 2 predictors. Knots are data
    rows, evenly spaced along the first predictor's sort order."""
    d = X.shape[1]
    ok = ~np.isnan(X).any(axis=1)
    Xs = X[ok]
    m = tp_m(d)
    expo = tp_poly_exponents(d, m)
    M = len(expo)
    if num_knots <= M + 1:
        raise ValueError(
            f"thin-plate smoother over {d} predictors needs num_knots > "
            f"{M + 1} (polynomial null space has {M} terms)")
    if len(Xs) < num_knots:
        raise ValueError("not enough complete rows for the requested "
                         "number of thin-plate knots")
    order = np.argsort(Xs[:, 0], kind="stable")
    pick = order[np.linspace(0, len(order) - 1, num_knots).astype(int)]
    knots = np.unique(Xs[pick], axis=0)
    K = len(knots)
    if K <= M + 1:
        raise ValueError("duplicate rows collapsed the thin-plate knots; "
                         "reduce num_knots or dedupe the predictors")
    # zCS: null space of T' where T[i,j] = poly_j(knot_i)
    T = tp_polynomials(knots, expo)
    Q, _ = np.linalg.qr(T, mode="complete")
    zcs = Q[:, M:]
    # bending energy on the constrained distance coefficients
    E = tp_distance(knots, knots, m)
    S_dist = zcs.T @ E @ zcs
    S_dist = (S_dist + S_dist.T) / 2.0
    # PSD guard: the projected radial form can have tiny negative
    # eigenvalues from float error
    w = np.linalg.eigvalsh(S_dist)
    if w.min() < 0:
        S_dist = S_dist - (w.min() - 1e-10) * np.eye(len(S_dist))
    S_raw = np.zeros((K, K))
    S_raw[:K - M, :K - M] = S_dist
    na_fill = np.median(Xs, axis=0)
    # centering against the intercept, the construction of _make_spec
    spec = TpSpec(columns=list(columns), knots=knots, zcs=zcs,
                  Z=np.empty(0), penalty=np.empty(0), na_fill=na_fill, m=m)
    basis = spec.raw_basis(Xs)
    mean = basis.mean(axis=0)
    _, _, Vt = np.linalg.svd(mean[None, :], full_matrices=True)
    Z = Vt[1:].T
    spec.Z = Z
    spec.penalty = Z.T @ S_raw @ Z
    return spec


@dataclass
class GamSpec:
    column: str
    knots: np.ndarray
    Z: Optional[np.ndarray]  # identifiability transform (None: raw basis)
    penalty: np.ndarray
    na_fill: float
    kind: int = 0  # bs code
    nonneg: bool = False  # coefficients constrained >= 0 (monotone)

    def raw_basis(self, x: np.ndarray) -> np.ndarray:
        if self.kind == 1:
            return tp_basis(x, self.knots)
        if self.kind == 2:
            return i_basis(x, self.knots)
        if self.kind == 3:
            return m_basis(x, self.knots)
        return cr_basis(x, self.knots)

    def expand(self, x: np.ndarray) -> np.ndarray:
        x = np.where(np.isnan(x), self.na_fill, x)
        b = self.raw_basis(x)
        return b @ self.Z if self.Z is not None else b


def _make_spec(name: str, x: np.ndarray, num_knots: int, bs: int = 0,
               user_knots: Optional[List[float]] = None,
               nonneg: bool = True) -> GamSpec:
    ok = ~np.isnan(x)
    xs = x[ok]
    if user_knots is not None:
        knots = np.unique(np.asarray(user_knots, np.float64))
    else:
        qs = np.quantile(xs, np.linspace(0, 1, num_knots))
        knots = np.unique(qs)
    if len(knots) < 3:
        raise ValueError(f"gam column {name!r} has too few distinct values for splines")
    na_fill = float(np.median(xs))
    if bs == 1:
        S = tp_penalty(knots)
        basis = tp_basis(xs, knots)
    elif bs == 2:
        # monotone I-splines: no centering transform, since non-negativity
        # must hold on the coefficients themselves (the monotone cone does
        # not survive a rotation); identifiability comes from the basis
        # having no constant function in its span
        basis = i_basis(xs, knots)
        return GamSpec(name, knots, None, m_penalty(basis.shape[1]),
                       na_fill, kind=2, nonneg=nonneg)
    elif bs == 3:
        basis = m_basis(xs, knots)
        S = m_penalty(basis.shape[1])
    else:
        S = cr_penalty(knots)
        basis = cr_basis(xs, knots)
    m = basis.mean(axis=0)
    # Z: orthonormal basis of the null space of m^T (H2O's centering
    # transform: gamified columns stay orthogonal to the intercept)
    _, _, Vt = np.linalg.svd(m[None, :], full_matrices=True)
    Z = Vt[1:].T
    return GamSpec(name, knots, Z, Z.T @ S @ Z, na_fill, kind=bs)


def _per_column(value, n: int, name: str) -> list:
    if isinstance(value, (list, tuple)):
        if len(value) != n:
            raise ValueError(
                f"{name} list must align with gam_columns "
                f"({len(value)} != {n})")
        return list(value)
    return [value] * n


def _project_nonneg(Gp, q, l2, nonneg_idx, solver):
    """Active-set projection: solve, clamp negative monotone-block coefs
    to zero (drop them from the system), repeat until none violate: the
    NNLS shape the reference's I-spline constraint solve takes."""
    n = len(q)
    clamped = np.zeros(n, dtype=bool)
    nonneg = np.zeros(n, dtype=bool)
    nonneg[nonneg_idx] = True
    beta = np.zeros(n)
    for _ in range(len(nonneg_idx) + 1):
        idxs = np.nonzero(~clamped)[0]
        sub = solver(Gp[np.ix_(idxs, idxs)], q[idxs])
        beta = np.zeros(n)
        beta[idxs] = sub
        bad = nonneg & (beta < -1e-12) & ~clamped
        if not bad.any():
            break
        clamped |= bad
    beta[nonneg] = np.maximum(beta[nonneg], 0.0)
    return beta


_FAMILY_TAG = {0: "cr", 1: "tp", 2: "is", 3: "ms"}


def coefficient_names(linear_names: List[str], specs) -> List[str]:
    """The linear predictors' names, then ``<column>_<cr|tp|is|ms>_<i>``
    for each smoother's centered basis columns."""
    names = list(linear_names)
    for s in specs:
        tag = _FAMILY_TAG.get(s.kind, "cr")
        names += [f"{s.column}_{tag}_{i}" for i in range(s.penalty.shape[0])]
    return names


class GAMModel(Model):
    algo_name = "gam"

    def __init__(self, params: GAMParameters, data_info,
                 device: torch.device) -> None:
        super().__init__(params, data_info, device)
        self.specs: List[GamSpec] = []
        self.beta: Optional[np.ndarray] = None  # [P_lin + sum(K_j - 1) + 1]
        self.coefficients: Dict[str, float] = {}
        self.null_deviance: float = np.nan
        self.residual_deviance: float = np.nan
        self.aic: float = np.nan
        self.iterations: int = 0

    def _design(self, frame: Frame) -> np.ndarray:
        Xl, _ = expand_matrix(self.data_info, frame, dtype=np.float64)
        blocks = [Xl]
        for s in self.specs:
            if isinstance(s, TpSpec):
                blocks.append(s.expand(s.stack(frame)))
            else:
                blocks.append(s.expand(
                    frame.col(s.column).numeric_view().astype(np.float64)))
        return np.concatenate(blocks, axis=1)

    def _predict_raw(self, frame: Frame) -> np.ndarray:
        return self._raw_from_design(self._design(frame))

    def _raw_from_design(self, X: np.ndarray) -> np.ndarray:
        p: GAMParameters = self.params
        eta = X @ self.beta[:-1] + self.beta[-1]
        mu = _linkinv(p.actual_link(), eta, p)
        if p.family in ("binomial", "quasibinomial"):
            return np.stack([1 - mu, mu], axis=1)
        return mu


class GAM(ModelBuilder):

    SUPPORTED_COMMON = frozenset({"weights_column"})
    algo_name = "gam"

    def __init__(self, params: Optional[GAMParameters] = None, **kw) -> None:
        super().__init__(params or GAMParameters(**kw))

    def _validate(self, frame: Frame) -> None:
        super()._validate(frame)
        if not self.params.gam_columns:
            raise ValueError("GAM requires gam_columns")

    def _fit(self, frame: Frame, valid: Optional[Frame],
             device: torch.device) -> GAMModel:
        p: GAMParameters = self.params
        link = p.actual_link()
        # design-cache identity, captured before the response conversion
        # rebinds `frame`: the parameters that shape the design matrix
        # (basis spec and layout), not the solver knobs (lambda, alpha,
        # scale), so refits that only retune those reuse the placement
        from h2o3_tpu_torch.frame import devcache as _devcache

        def _hashable(v):
            if isinstance(v, (list, tuple)):
                return tuple(_hashable(x) for x in v)
            if isinstance(v, np.ndarray):
                return (v.shape, v.tobytes())
            return v

        design_token = _devcache.frame_token(frame)
        design_sig = (
            p.standardize, p.missing_values_handling,
            tuple(p.ignored_columns), p.response_column,
            _hashable(p.gam_columns), _hashable(p.num_knots),
            _hashable(p.bs), _hashable(p.knots), p.splines_non_negative,
        )
        train_frame_key = getattr(frame, "key", None)
        if p.family in ("binomial", "quasibinomial"):
            ycol = frame.col(p.response_column)
            if not ycol.is_categorical():
                frame = frame.add_column(ycol.as_factor())
        # gam columns enter through their basis only (GAM.java removes them
        # from the linear predictors); an entry may be a column name or a
        # list of names (a joint thin-plate smoother, gam_columns[][])
        flat_gam_cols: List[str] = []
        for entry in p.gam_columns:
            if isinstance(entry, (list, tuple)):
                flat_gam_cols.extend(entry)
            else:
                flat_gam_cols.append(entry)
        info = build_data_info(
            frame,
            y=p.response_column,
            ignored=list(p.ignored_columns) + flat_gam_cols,
            standardize=p.standardize,
            missing_values_handling=p.missing_values_handling,
        )
        model = GAMModel(p, info, device)
        ncols = len(p.gam_columns)
        nk_list = _per_column(p.num_knots, ncols, "num_knots")
        bs_list = _per_column(p.bs, ncols, "bs")
        scale_list = _per_column(p.scale, ncols, "scale")
        knots_list = (list(p.knots) if p.knots is not None
                      else [None] * ncols)
        if len(knots_list) != ncols:
            raise ValueError("knots list must align with gam_columns")
        specs = []
        for i, c in enumerate(p.gam_columns):
            if isinstance(c, (list, tuple)) and len(c) > 1:
                if int(bs_list[i]) != 1:
                    # GAM.java: multi-column smoothers are thin-plate only
                    raise ValueError(
                        "multi-predictor gam_columns entries are "
                        "thin-plate smoothers: pass bs=1 for "
                        f"{list(c)}")
                if knots_list[i] is not None:
                    raise ValueError("explicit knots are not supported "
                                     "for multi-predictor smoothers")
                specs.append(_make_tp_spec(
                    list(c), _tp_stack(frame, c), int(nk_list[i])))
            else:
                cc = c[0] if isinstance(c, (list, tuple)) else c
                specs.append(_make_spec(
                    cc, frame.col(cc).numeric_view().astype(np.float64),
                    int(nk_list[i]), bs=int(bs_list[i]),
                    user_knots=knots_list[i],
                    nonneg=p.splines_non_negative,
                ))
        model.specs = specs

        X_all = model._design(frame)
        y = response_vector(info, frame)
        obs_w = (
            frame.col(p.weights_column).numeric_view().astype(np.float64)
            if p.weights_column else np.ones(frame.nrows)
        )
        keep = ~(np.isnan(y) | np.isnan(X_all).any(axis=1))
        X, y, obs_w = X_all[keep], y[keep], obs_w[keep]
        n, pc = X.shape
        n_lin = len(info.coef_names)

        # block-diagonal smoothing penalty, zero on the linear coefs and
        # the intercept; per-column scale (GAMParametersV3 scale array)
        Lam = np.zeros((pc + 1, pc + 1))
        nonneg_idx: List[int] = []
        off = n_lin
        for i, s in enumerate(model.specs):
            kz = s.penalty.shape[0]
            Lam[off: off + kz, off: off + kz] = float(scale_list[i]) * s.penalty
            if s.nonneg:
                nonneg_idx.extend(range(off, off + kz))
            off += kz

        Xd = _devcache.cached(
            "gam_design", design_token, design_sig, device,
            lambda: to_device_f32(np.concatenate([X, np.ones((n, 1))], axis=1), device),
            frame_key=train_frame_key,
        )
        # the float32 design's values, accumulated in float64 (module docstring)
        Xd64 = Xd.to(torch.float64)

        wsum = float(obs_w.sum())
        ybar = float((obs_w * y).sum() / wsum)
        beta = np.zeros(pc + 1)
        beta[-1] = _link_of_mean(link, ybar, p)
        # elastic net as in the GLM: l1 by ADMM soft-thresholding, l2 ridge
        l1 = p.lambda_ * p.alpha
        l2 = p.lambda_ * (1 - p.alpha)

        prev_obj = np.inf
        for it in range(p.max_iterations):
            eta = X @ beta[:-1] + beta[-1]
            mu = _linkinv(link, eta, p)
            d = _link_deriv(link, mu, p)
            v = _variance(p.family, mu, p)
            w = obs_w / np.maximum(v * d * d, 1e-12)
            wz = eta + (y - mu) * d

            g, q = _gram_kernel(Xd64, torch.as_tensor(wz, dtype=torch.float64, device=device),
                                torch.as_tensor(w, dtype=torch.float64, device=device))
            G, q = g.cpu().numpy(), q.cpu().numpy()
            Gp = G / wsum + Lam / wsum  # smoothing penalty folded into the Gram
            if l1 > 0 and nonneg_idx:
                beta_new = _project_nonneg(
                    Gp, q / wsum, l2, nonneg_idx,
                    lambda Gs, qs: _solve_admm(Gs, qs, l1, l2, free=1))
            elif l1 > 0:
                beta_new = _solve_admm(Gp, q / wsum, l1, l2, free=1)
            elif nonneg_idx:
                beta_new = _project_nonneg(
                    Gp, q / wsum, l2, nonneg_idx,
                    lambda Gs, qs: _solve_ridge(Gs, qs, l2, free=1))
            else:
                beta_new = _solve_ridge(Gp, q / wsum, l2, free=1)

            mu_new = _linkinv(link, X @ beta_new[:-1] + beta_new[-1], p)
            dev = float((obs_w * deviance(p.family, y, mu_new, p)).sum())
            bp = beta_new[:-1]  # intercept unpenalized
            obj = (
                dev / (2 * wsum)
                + float(beta_new @ Lam @ beta_new) / (2 * wsum)
                + l1 * float(np.abs(bp).sum())
                + 0.5 * l2 * float(bp @ bp)
            )
            delta = np.max(np.abs(beta_new - beta))
            beta = beta_new
            model.iterations = it + 1
            if delta < p.beta_epsilon or abs(prev_obj - obj) < p.objective_epsilon * max(abs(prev_obj), 1.0):
                break
            prev_obj = obj

        model.beta = beta
        names = coefficient_names(info.coef_names, model.specs)
        model.coefficients = dict(zip(names, beta[:-1].tolist()))
        model.coefficients["Intercept"] = float(beta[-1])

        mu = _linkinv(link, X @ beta[:-1] + beta[-1], p)
        model.residual_deviance = float((obs_w * deviance(p.family, y, mu, p)).sum())
        model.null_deviance = float(
            (obs_w * deviance(p.family, y, np.full_like(y, ybar), p)).sum()
        )
        model.aic = _aic(p.family, y, mu, obs_w, model.residual_deviance, pc + 1)
        # the training frame's design is X_all: its scores are predict's
        model.training_metrics = model._metrics_from_raw(frame, model._raw_from_design(X_all))
        if valid is not None:
            model.validation_metrics = model.model_performance(valid)
        return model
