"""CoxPH — the port of ``h2o3_tpu/models/coxph.py``.

Proportional hazards with Efron or Breslow ties (``hex/coxph/CoxPH.java``):
Newton-Raphson on the partial log-likelihood, whose per-iteration
statistics are the risk-set sums S0 = sum w exp(eta), S1 = sum w x exp(eta)
and S2 = sum w x x^T exp(eta) at each distinct event time, with left
truncation (``start_column``), coefficients, exp(coef), standard errors,
z values, the log-likelihood and Harrell's concordance.

The host does what the JAX package's host does: the sort by descending
stop time (events first within a time, so every risk set is a prefix),
the event-time groups (a vectorized scan of the sorted times), the
left-truncation counts, the float64 Newton solve, ``pinv`` for the
standard errors and ``_concordance`` on its ``default_rng(0)`` subsample.

The device computes the statistics in float32, as the JAX package's
jitted ``_partial_stats`` does (it runs without x64), but without its
[N, P, P] cumulative sums: those are needed only at the groups' ends.
``_RiskSets.stats`` sums each row's r, r x, r x x^T (and the event-
weighted terms) over the segments between consecutive group ends
(``_segment_sums``: row chunks of a bounded size, ``torch.segment_reduce``
within each chunk, which adds a segment's rows in order on the CPU and
the card alike), then takes the cumulative sum over the G segments; the
tied events' sums R0, R1, R2 are those segments' event-weighted sums (a
segment's rows before its group hold no event), and the left-truncation
terms are the same prefix sums over the rows sorted by descending start.
Peak device memory is O(chunk P^2 + G P^2).

Efron's term averages each group's d tied events out of its risk set in
d steps l = 0..d-1 (s0_l = S0 - (l/d) R0, likewise s1_l, s2_l). The
JAX package loops over l inside a scan over the groups; here the terms
take their closed form, linear in S2, R2, S1 S1^T, S1 R1^T + R1 S1^T and
R1 R1^T with per-group scalar sums over l of log s0_l, 1/s0_l, f/s0_l,
1/s0_l^2, f/s0_l^2 and f^2/s0_l^2 (f = l/d): one float32 vector over all
(group, l) pairs, reduced per group. The JAX package's clamps
``maximum(s0, 1e-300)`` are clamps at 0.0 in float32 and stay so here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from h2o3_tpu_torch.device import to_device_f32
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.data_info import build_data_info, expand_matrix, response_vector
from h2o3_tpu_torch.models.framework import Model, ModelBuilder, ModelParameters

#: bytes of per-row values one chunk of ``_segment_sums`` may hold
_CHUNK_BYTES = 256 << 20


@dataclass
class CoxPHParameters(ModelParameters):
    start_column: Optional[str] = None
    stop_column: Optional[str] = None  # event time (required)
    ties: str = "efron"  # efron | breslow
    max_iterations: int = 20
    lre_min: float = 9.0  # log-relative-error convergence (reference default)


def _segment_sums(row_values, bounds: np.ndarray, width: int,
                  device: torch.device) -> torch.Tensor:
    """[G, width] float32 sums of per-row values over the segments
    [bounds[g-1], bounds[g]) (bounds[-1] taken as 0; ``bounds``
    non-decreasing). ``row_values(a, b)`` gives rows [a, b) as a
    [b - a, width] float32 tensor; rows past ``bounds[-1]`` are never asked
    for. Each segment's rows are added in order, chunk by chunk."""
    G = len(bounds)
    out = torch.zeros((G, width), dtype=torch.float32, device=device)
    if G == 0 or bounds[-1] == 0:
        return out
    starts = np.concatenate([[0], bounds[:-1]])
    last = int(bounds[-1])
    chunk = max(1, _CHUNK_BYTES // (4 * width))
    for a in range(0, last, chunk):
        b = min(a + chunk, last)
        g0 = int(np.searchsorted(bounds, a, side="right"))
        g1 = int(np.searchsorted(starts, b, side="left"))
        lens = np.minimum(bounds[g0:g1], b) - np.maximum(starts[g0:g1], a)
        out[g0:g1] += torch.segment_reduce(
            row_values(a, b), "sum",
            lengths=torch.from_numpy(lens.astype(np.int64)).to(device),
            axis=0, unsafe=True)
    return out


def _outer(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Row-wise (v_i x_i) x_i^T as [c, P*P], rounded as the JAX package's
    ``rx[:, :, None] * Xs[:, None, :]``."""
    return (v[:, :, None] * x[:, None, :]).reshape(x.shape[0], -1)


class _RiskSets:
    """The device side of one CoxPH fit: the sorted rows, the group
    structure and, with left truncation, the rows sorted by start.
    ``stats(beta)`` returns the partial log-likelihood, its gradient and
    its Hessian (float, [P], [P, P] float64 on the host) at ``beta``."""

    def __init__(self, Xs, ws, ds, ends, dcount, efron: bool, device,
                 Xe=None, we=None, m=None) -> None:
        self.device = device
        self.P = Xs.shape[1]
        self.Xs, self.ws, self.ds = (to_device_f32(a, device) for a in (Xs, ws, ds))
        # segment g holds rows (ends[g-1], ends[g]]: its event rows are
        # group g's, its other rows are censored rows of event-free times
        self.bounds = np.asarray(ends, dtype=np.int64) + 1
        self.efron = efron
        G = len(self.bounds)
        self.dc = torch.from_numpy(dcount.astype(np.float32)).to(device)
        if efron:
            # the (group, l) pairs of Efron's steps, l = 0..d_g-1
            self.lengths = torch.from_numpy(dcount.astype(np.int64)).to(device)
            gi = np.repeat(np.arange(G), dcount)
            li = np.arange(len(gi)) - np.repeat(np.cumsum(dcount) - dcount, dcount)
            self.gi = torch.from_numpy(gi).to(device)
            self.li = torch.from_numpy(li.astype(np.float32)).to(device)
        self.truncated = Xe is not None
        if self.truncated:
            self.Xe, self.we = to_device_f32(Xe, device), to_device_f32(we, device)
            self.m = np.asarray(m, dtype=np.int64)

    def stats(self, beta: np.ndarray):
        P = self.P
        b = to_device_f32(beta, self.device)
        Xs, ws, ds = self.Xs, self.ws, self.ds
        r = ws * torch.exp(Xs @ b)  # risk contributions
        er = r * ds  # the events' own risk
        ev_w = ws * ds

        def rows(a, c):
            x = Xs[a:c]
            rx = r[a:c, None] * x
            erx = er[a:c, None] * x
            return torch.cat([r[a:c, None], rx, _outer(rx, x), er[a:c, None], erx,
                              _outer(erx, x), ev_w[a:c, None], ev_w[a:c, None] * x],
                             dim=1)

        o = np.cumsum([0, 1, P, P * P, 1, P, P * P, 1, P])
        seg = _segment_sums(rows, self.bounds, int(o[-1]), self.device)
        cum = torch.cumsum(seg[:, : o[3]], dim=0)
        S0, S1, S2 = cum[:, 0], cum[:, o[1]:o[2]], cum[:, o[2]:o[3]]
        R0, R1, R2 = seg[:, o[3]], seg[:, o[4]:o[5]], seg[:, o[5]:o[6]]
        wd, xd = seg[:, o[6]], seg[:, o[7]:o[8]]  # sums of w and w x over the events
        if self.truncated:
            Xe = self.Xe
            re = self.we * torch.exp(Xe @ b)

            def rows_e(a, c):
                rex = re[a:c, None] * Xe[a:c]
                return torch.cat([re[a:c, None], rex, _outer(rex, Xe[a:c])], dim=1)

            # m[g] rows (start >= t_g) have not entered the risk set yet
            A = torch.cumsum(_segment_sums(rows_e, self.m, 1 + P + P * P, self.device), 0)
            S0, S1, S2 = S0 - A[:, 0], S1 - A[:, 1:1 + P], S2 - A[:, 1 + P:]

        if self.efron:
            dmax = torch.clamp(self.dc, min=1.0)
            gi = self.gi
            frac = self.li / dmax[gi]
            s0l = S0[gi] - frac * R0[gi]
            inv = 1.0 / torch.clamp(s0l, min=0.0)
            inv2 = 1.0 / torch.clamp(s0l * s0l, min=0.0)
            terms = torch.stack([torch.log(torch.clamp(s0l, min=0.0)), inv, frac * inv,
                                 inv2, frac * inv2, frac * frac * inv2], dim=1)
            L, Ai, Bf, C, D, E = torch.segment_reduce(
                terms, "sum", lengths=self.lengths, axis=0, unsafe=True).T
            avg = wd / dmax
            ll_g = -avg * L
            g_g = -avg[:, None] * (S1 * Ai[:, None] - R1 * Bf[:, None])
            # sum_g avg_g [S2 A - R2 B - (S1 S1' C - (S1 R1' + R1 S1') D + R1 R1' E)]
            h = (avg * Ai) @ S2 - (avg * Bf) @ R2
            SC, RD, RE = S1 * (avg * C)[:, None], R1 * (avg * D)[:, None], R1 * (avg * E)[:, None]
            h = h.reshape(P, P) - (S1.T @ SC - S1.T @ RD - RD.T @ S1 + R1.T @ RE)
        else:
            s0 = torch.clamp(S0, min=0.0)
            ll_g = -wd * torch.log(s0)
            g_g = -wd[:, None] * S1 / s0[:, None]
            inv2 = 1.0 / torch.clamp(S0 * S0, min=0.0)
            h = (wd / s0) @ S2
            h = h.reshape(P, P) - S1.T @ (S1 * (wd * inv2)[:, None])
        ll = (xd @ b).sum() + ll_g.sum()
        grad = xd.sum(0) + g_g.sum(0)
        hess = -h
        return (float(ll), grad.cpu().numpy().astype(np.float64),
                hess.cpu().numpy().astype(np.float64))


def event_groups(ts: np.ndarray, ds: np.ndarray):
    """Start, size and event count of each run of equal sorted times that
    holds an event (the JAX package's per-row scan, vectorized)."""
    n = len(ts)
    if n == 0:
        return (np.zeros(0, np.int64),) * 3
    run = np.flatnonzero(np.concatenate([[True], ts[1:] != ts[:-1]]))
    size = np.diff(np.concatenate([run, [n]]))
    n_ev = np.add.reduceat(ds, run).astype(np.int64)
    has = n_ev > 0
    return run[has], size[has], n_ev[has]


class CoxPHModel(Model):
    algo_name = "coxph"

    def __init__(self, params, data_info, device: torch.device) -> None:
        super().__init__(params, data_info, device)
        self.coefficients: Dict[str, float] = {}
        self.exp_coef: Dict[str, float] = {}
        self.std_errors: Dict[str, float] = {}
        self.z_values: Dict[str, float] = {}
        self.beta: Optional[np.ndarray] = None
        self.loglik: float = np.nan
        self.loglik_null: float = np.nan
        self.concordance: float = np.nan
        self.n_events: int = 0
        self.iterations: int = 0
        self.feature_means: Optional[np.ndarray] = None

    @property
    def is_classifier(self) -> bool:
        return False

    def _predict_raw(self, frame: Frame) -> np.ndarray:
        """Linear predictor (log relative hazard), centered like the reference."""
        X, _ = expand_matrix(self.data_info, frame, dtype=np.float64)
        return (X - self.feature_means) @ self.beta


class CoxPH(ModelBuilder):

    SUPPORTED_COMMON = frozenset({"weights_column"})
    algo_name = "coxph"

    def __init__(self, params: Optional[CoxPHParameters] = None, **kw) -> None:
        super().__init__(params or CoxPHParameters(**kw))

    def _validate(self, frame: Frame) -> None:
        super()._validate(frame)
        p: CoxPHParameters = self.params
        if not p.stop_column:
            raise ValueError("CoxPH requires stop_column (event time)")
        if not p.response_column:
            raise ValueError("CoxPH requires response_column (event indicator)")
        if p.ties not in ("efron", "breslow"):
            raise ValueError("ties must be 'efron' or 'breslow'")

    def _fit(self, frame: Frame, valid: Optional[Frame],
             device: torch.device) -> CoxPHModel:
        p: CoxPHParameters = self.params
        info = build_data_info(
            frame, y=p.response_column,
            ignored=list(p.ignored_columns) + [p.stop_column]
            + ([p.start_column] if p.start_column else []),
            standardize=False,
        )
        model = CoxPHModel(p, info, device)
        X, skip = expand_matrix(info, frame, dtype=np.float64)
        y = response_vector(info, frame)  # event indicator 0/1
        t = frame.col(p.stop_column).numeric_view().astype(np.float64)
        w = (
            frame.col(p.weights_column).numeric_view().astype(np.float64)
            if p.weights_column else np.ones(frame.nrows)
        )
        s = (
            frame.col(p.start_column).numeric_view().astype(np.float64)
            if p.start_column else None
        )
        keep = ~(skip | np.isnan(y) | np.isnan(t))
        if s is not None:
            keep &= ~np.isnan(s) & (s < t)  # (start, stop] intervals only
        X, y, t, w = X[keep], y[keep], t[keep], w[keep]
        if s is not None:
            s = s[keep]
        n, P = X.shape
        model.n_events = int((y > 0).sum())

        # center covariates (reference centers at the weighted mean)
        mean = (w[:, None] * X).sum(0) / w.sum()
        model.feature_means = mean
        Xc = X - mean

        # sort by descending time; within a time, events first (risk set is a prefix)
        order = np.lexsort((1 - y, -t))
        Xs, ws, ds, ts = Xc[order], w[order], y[order], t[order]
        starts, sizes, dcount = event_groups(ts, ds)
        ends = starts + sizes - 1  # inclusive last row of each tie group

        # left truncation: rows sorted by descending start; m[g] = #rows whose
        # start >= the group's event time (they have not entered the study)
        trunc = {}
        if s is not None:
            e_order = np.argsort(-s, kind="stable")
            group_times = ts[starts]
            m = np.searchsorted(-s[e_order], -group_times, side="right")
            trunc = dict(Xe=Xc[e_order], we=w[e_order], m=m)
        risk = _RiskSets(Xs, ws, ds, ends, dcount, p.ties == "efron", device, **trunc)

        beta = np.zeros(P)
        ll0 = None
        prev_ll = -np.inf
        for it in range(p.max_iterations):
            ll, g, H = risk.stats(beta)  # H negative definite (d2 ll / d beta2)
            if ll0 is None:
                ll0 = ll
            model.iterations = it + 1
            try:
                delta = np.linalg.solve(H - 1e-10 * np.eye(P), g)
            except np.linalg.LinAlgError:
                delta = np.linalg.lstsq(H, g, rcond=None)[0]
            beta = beta - delta
            lre = -np.log10(max(abs(ll - prev_ll) / max(abs(ll), 1e-300), 1e-300))
            prev_ll = ll
            if lre >= p.lre_min:
                break

        ll, _, H = risk.stats(beta)
        model.loglik = ll
        model.loglik_null = float(ll0) if ll0 is not None else np.nan
        cov = np.linalg.pinv(-H)
        se = np.sqrt(np.maximum(np.diag(cov), 0.0))
        model.beta = beta
        names = info.coef_names
        model.coefficients = dict(zip(names, beta.tolist()))
        model.exp_coef = {k: float(np.exp(v)) for k, v in model.coefficients.items()}
        model.std_errors = dict(zip(names, se.tolist()))
        model.z_values = {
            k: (model.coefficients[k] / sd if sd > 0 else np.nan)
            for k, sd in zip(names, se.tolist())
        }
        model.concordance = _concordance(t, y, Xc @ beta, start=s)
        return model


def _concordance(
    t: np.ndarray, d: np.ndarray, risk: np.ndarray,
    start: Optional[np.ndarray] = None,
) -> float:
    """Harrell's C: P(higher risk -> earlier event) over comparable pairs
    (subsampled for large n: a metric, not part of the fit).

    With left truncation, a pair (i event, j) is comparable only if j was
    at risk at t_i, i.e. start_j < t_i."""
    n = len(t)
    if n > 4000:
        rng = np.random.default_rng(0)
        idx = rng.choice(n, 4000, replace=False)
        t, d, risk = t[idx], d[idx], risk[idx]
        if start is not None:
            start = start[idx]
        n = 4000
    conc = ties = comp = 0.0
    ev = np.nonzero(d > 0)[0]
    for i in ev:
        later = (t > t[i]) | ((t == t[i]) & (d == 0))
        if start is not None:
            later &= start < t[i]
        comp += later.sum()
        conc += (risk[i] > risk[later]).sum()
        ties += (risk[i] == risk[later]).sum()
    return float((conc + 0.5 * ties) / comp) if comp > 0 else np.nan
