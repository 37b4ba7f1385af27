"""MOJO reader + per-algo numpy scorers.

Reference: ``h2o-genmodel/src/main/java/hex/genmodel/MojoModel.java`` and
the per-algo readers under ``hex/genmodel/algos/{tree,glm,deeplearning,
kmeans,naivebayes,isofor,pca}``.  Scoring semantics mirror the in-cluster
models bit-for-bit (same design-matrix expansion, same tree routing, same
link inverses) so "same answer everywhere" holds — the reference's
cross-language consistency guarantee (SURVEY.md §4 tier 6).
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

RowLike = Union[Dict[str, Any], Sequence[Any]]


# ---------------------------------------------------------------------------
# design-matrix expansion from a serialized DataInfo (the numpy form of the
# training stack's expand_matrix, held to it by the parity tests)


class _Columns:
    """Column-major batch input: a dict of equal-length column arrays.

    The batch scoring fast path — ``_Layout._columns`` converts each column
    in one vectorized pass instead of materializing N per-row dicts."""

    def __init__(self, data: Dict[str, Any]) -> None:
        self._data = data
        self._n = len(next(iter(data.values()))) if data else 0

    def __len__(self) -> int:
        return self._n

    def column(self, name: str):
        return self._data.get(name)


class _Layout:
    def __init__(self, info: Dict[str, Any]) -> None:
        self.predictor_names: List[str] = info["predictor_names"]
        self.response_name: Optional[str] = info.get("response_name")
        self.use_all_factor_levels: bool = info["use_all_factor_levels"]
        self.standardize: bool = info["standardize"]
        self.missing_values_handling: str = info["missing_values_handling"]
        self.num_means: Dict[str, float] = info.get("num_means", {})
        self.num_sds: Dict[str, float] = info.get("num_sds", {})
        self.cat_domains: Dict[str, List[str]] = info.get("cat_domains", {})
        self.cat_mode: Dict[str, int] = info.get("cat_mode", {})
        self.coef_names: List[str] = info.get("coef_names", [])
        self.response_domain: Optional[List[str]] = info.get("response_domain")

    def _columns(self, rows):
        """Per-predictor raw columns: float array (num) or int codes (cat).
        Accepts a list of row dicts (streaming path) or a _Columns column
        dict (batch path — one vectorized pass per column, no per-row
        Python objects)."""
        if isinstance(rows, _Columns):
            out = {}
            for name in self.predictor_names:
                v = rows.column(name)
                if v is None:
                    out[name] = (
                        np.full(len(rows), -1, np.int64)
                        if name in self.cat_domains
                        else np.full(len(rows), np.nan)
                    )
                elif name in self.cat_domains:
                    index = {lv: i for i, lv in enumerate(self.cat_domains[name])}
                    codes = np.fromiter(
                        (
                            -1
                            if x is None or (isinstance(x, float) and np.isnan(x))
                            else index.get(str(x), -1)
                            for x in v
                        ),
                        dtype=np.int64,
                        count=len(rows),
                    )
                    out[name] = codes
                else:
                    try:
                        x = np.asarray(v, dtype=np.float64)
                    except (TypeError, ValueError):
                        # element-wise with the row path's semantics:
                        # non-numeric values become NA, never an exception
                        def _f(e):
                            if e is None or e == "":
                                return np.nan
                            try:
                                return float(e)
                            except (TypeError, ValueError):
                                return np.nan
                        x = np.fromiter(
                            (_f(e) for e in v), dtype=np.float64, count=len(rows)
                        )
                    out[name] = x
            return out
        n = len(rows)
        out = {}
        for name in self.predictor_names:
            if name in self.cat_domains:
                dom = self.cat_domains[name]
                index = {lv: i for i, lv in enumerate(dom)}
                codes = np.full(n, -1, dtype=np.int64)
                for i, r in enumerate(rows):
                    v = r.get(name)
                    if v is None or (isinstance(v, float) and np.isnan(v)):
                        continue
                    codes[i] = index.get(str(v), -1)  # unseen level -> NA
                out[name] = codes
            else:
                x = np.full(n, np.nan, dtype=np.float64)
                for i, r in enumerate(rows):
                    v = r.get(name)
                    if v is None or v == "":
                        continue
                    try:
                        x[i] = float(v)
                    except (TypeError, ValueError):
                        pass  # non-numeric in a numeric col -> NA
                out[name] = x
        return out

    def expand(self, rows: List[Dict[str, Any]]) -> np.ndarray:
        """Standardized one-hot design matrix [N, P] (GLM/KMeans/DL layout)."""
        n = len(rows)
        cols = self._columns(rows)
        blocks = []
        for name in self.predictor_names:
            if name in self.cat_domains:
                dom = self.cat_domains[name]
                codes = cols[name]
                na = codes < 0
                if self.missing_values_handling == "mean_imputation":
                    codes = np.where(na, self.cat_mode.get(name, 0), codes)
                start = 0 if self.use_all_factor_levels else 1
                width = len(dom) - start
                block = np.zeros((n, width), dtype=np.float64)
                sel = codes - start
                rows_ix = np.nonzero(sel >= 0)[0]
                block[rows_ix, sel[rows_ix]] = 1.0
                blocks.append(block)
            else:
                x = cols[name]
                x = np.where(np.isnan(x), self.num_means.get(name, 0.0), x)
                if self.standardize:
                    x = (x - self.num_means[name]) / self.num_sds[name]
                blocks.append(x[:, None])
        return (
            np.concatenate(blocks, axis=1)
            if blocks
            else np.zeros((n, 0), dtype=np.float64)
        )

    def raw_matrix(
        self, rows: List[Dict[str, Any]], one_hot: bool = False
    ) -> np.ndarray:
        """[N, F] raw features, NaN NA (the tree layout of
        models/tree/common.py:tree_matrix). one_hot mirrors
        categorical_encoding="one_hot_explicit": one 0/1 column per level,
        NA rows NaN across the block."""
        cols = self._columns(rows)
        out = []
        for name in self.predictor_names:
            c = cols[name]
            if name in self.cat_domains:
                if one_hot:
                    dom = self.cat_domains[name]
                    block = (c[:, None] == np.arange(len(dom))[None, :]).astype(
                        np.float64
                    )
                    block[c < 0] = np.nan
                    out.append(block)
                else:
                    out.append(np.where(c >= 0, c.astype(np.float64), np.nan)[:, None])
            else:
                out.append(c[:, None])
        return np.concatenate(out, axis=1).astype(np.float32)


def _as_rows(data: Union[RowLike, List[RowLike]], names: List[str]):
    """Accept a single row dict, a list of row dicts, or a dict of columns."""
    if isinstance(data, dict):
        if data and all(np.iterable(v) and not isinstance(v, str) for v in data.values()):
            n = len(next(iter(data.values())))
            return [{k: data[k][i] for k in data} for i in range(n)], True
        return [data], False
    if isinstance(data, (list, tuple)) and data and isinstance(data[0], dict):
        return list(data), True
    raise TypeError("rows must be a dict row, list of dict rows, or column dict")


# ---------------------------------------------------------------------------
# base


class MojoModel:
    """Loaded offline model (hex/genmodel/MojoModel.java)."""

    algo: str = "?"

    def __init__(self, meta: Dict[str, Any], layout: _Layout, arrays) -> None:
        self.meta = meta
        self.layout = layout
        self._arrays = arrays

    # -- java-GenModel-like surface ------------------------------------------
    @property
    def nclasses(self) -> int:
        dom = self.layout.response_domain
        return len(dom) if dom else 1

    @property
    def is_classifier(self) -> bool:
        return self.nclasses > 1

    @property
    def names(self) -> List[str]:
        return list(self.layout.predictor_names)

    @property
    def domain_values(self) -> Optional[List[str]]:
        return self.layout.response_domain

    def score(self, data) -> np.ndarray:
        """Batch scores: [N] regression / [N, K] class probabilities.
        A dict of column arrays takes the vectorized column path (no
        per-row dict materialization)."""
        if isinstance(data, dict) and data and all(
            np.iterable(v) and not isinstance(v, str) for v in data.values()
        ):
            return self._score_rows(_Columns(data))
        rows, _ = _as_rows(data, self.names)
        return self._score_rows(rows)

    def score0(self, row: RowLike) -> np.ndarray:
        """Single-row score (GenModel.score0)."""
        rows, _ = _as_rows(row, self.names)
        out = self._score_rows(rows)
        return out[0]

    def _score_rows(self, rows: List[Dict[str, Any]]) -> np.ndarray:
        raise NotImplementedError

    @staticmethod
    def load(path: str) -> "MojoModel":
        return load_mojo(path)

    def __repr__(self) -> str:
        return f"<MojoModel algo={self.algo} nclasses={self.nclasses}>"


# ---------------------------------------------------------------------------
# per-algo scorers


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _softmax(m):
    z = m - m.max(axis=1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=1, keepdims=True)


class GlmMojoModel(MojoModel):
    """hex/genmodel/algos/glm/GlmMojoModel.java."""

    algo = "glm"

    def _score_rows(self, rows):
        X = self.layout.expand(rows)
        off_col = self.meta.get("offset_column")
        off = 0.0
        if off_col:  # GLMModel._eta adds the per-row offset
            if isinstance(rows, _Columns):
                v = rows.column(off_col)
                if v is None:
                    off = 0.0
                else:
                    # match the row path exactly: None entries are a zero
                    # offset; NaN values propagate
                    off = np.fromiter(
                        (0.0 if e is None else float(e) for e in v),
                        dtype=np.float64, count=len(rows),
                    )
            else:
                off = np.array(
                    [float(r.get(off_col) or 0.0) for r in rows], dtype=np.float64
                )
        family = self.meta["family"]
        if family == "multinomial":  # softmax over per-class etas
            B = self._arrays["beta_multi"]
            eta = X @ B[:-1] + B[-1]
            z = eta - eta.max(axis=1, keepdims=True)
            e = np.exp(z)
            return e / e.sum(axis=1, keepdims=True)
        if family == "ordinal":  # P(y<=k) = sigmoid(t_k - eta), diffs
            b = self._arrays["beta_std"]  # [P], no intercept slot
            t = self._arrays["thresholds"]
            eta = X @ b + off
            cum = _sigmoid(t[None, :] - eta[:, None])
            full = np.concatenate([cum, np.ones((len(eta), 1))], axis=1)
            lower = np.concatenate([np.zeros((len(eta), 1)), cum], axis=1)
            return np.maximum(full - lower, 1e-15)
        b = self._arrays["beta_std"]
        eta = X @ b[:-1] + b[-1] + off
        link = self.meta["link"]
        if link == "identity":
            mu = eta
        elif link == "logit":
            mu = _sigmoid(eta)
        elif link == "log":
            mu = np.exp(eta)
        elif link == "inverse":
            mu = 1.0 / np.where(np.abs(eta) < 1e-10, np.sign(eta + 1e-30) * 1e-10, eta)
        elif link == "tweedie":
            lp = float(self.meta.get("tweedie_link_power", 0.0))
            mu = np.exp(eta) if lp == 0 else np.power(np.maximum(eta, 1e-10), 1.0 / lp)
        else:
            raise ValueError(f"unknown link {link!r}")
        if self.meta["family"] in ("binomial", "quasibinomial"):
            return np.stack([1 - mu, mu], axis=1)
        return mu


class TreeMojoModel(MojoModel):
    """hex/genmodel/algos/tree/SharedTreeMojoModel.java — heap-layout walk
    identical to models/tree/booster.py:_predict_stacked."""

    algo = "tree"

    def _score_rows(self, rows):
        m = self.meta
        X = self.layout.raw_matrix(
            rows, one_hot=m.get("tree_encoding") == "one_hot_explicit"
        )
        edges = self._arrays["edges"]  # [F, B-1]
        n_bins1 = int(m["n_bins1"])
        nbins = n_bins1 - 1
        # apply_bins (ops/histogram.py): searchsorted right, NA -> nbins
        n, F = X.shape
        bins = np.empty((n, F), dtype=np.int64)
        for f in range(F):
            bins[:, f] = np.searchsorted(edges[f], X[:, f], side="right")
            bins[np.isnan(X[:, f]), f] = nbins
        init_margin = self._arrays["init_margin"]
        C = len(init_margin)
        offset_col = m.get("offset_column")
        offset = None
        if offset_col:
            if isinstance(rows, _Columns):
                v = rows.column(offset_col)
                offset = (
                    np.asarray(v, dtype=np.float64)
                    if v is not None
                    else np.full(len(rows), np.nan)
                )
            else:
                offset = np.full(len(rows), np.nan)
                for i, row in enumerate(rows):
                    v = row.get(offset_col)
                    if v is not None and v != "":
                        offset[i] = float(v)
            if np.isnan(offset).any():
                raise ValueError(
                    f"offset column {offset_col!r} must be present and "
                    f"numeric in every scored row"
                )
        max_depth = int(m["max_depth"])
        average = bool(m.get("average", False))
        margins = np.empty((n, C), dtype=np.float64)
        for c in range(C):
            feat = self._arrays[f"feat_{c}"]
            split_bin = self._arrays[f"split_bin_{c}"]
            default_left = self._arrays[f"default_left_{c}"]
            is_split = self._arrays[f"is_split_{c}"]
            leaf = self._arrays[f"leaf_{c}"]
            T = feat.shape[0]
            total = np.zeros(n, dtype=np.float64)
            for t in range(T):
                idx = np.zeros(n, dtype=np.int64)
                for _ in range(max_depth):
                    f_ = feat[t][idx]
                    b = bins[np.arange(n), f_]
                    is_na = b >= n_bins1 - 1
                    go_left = np.where(is_na, default_left[t][idx], b <= split_bin[t][idx])
                    nxt = 2 * idx + np.where(go_left, 1, 2)
                    idx = np.where(is_split[t][idx], nxt, idx)
                total += leaf[t][idx]
            if average and T > 0:
                total /= T
            margins[:, c] = init_margin[c] + total
            if offset is not None:
                margins[:, c] += offset
        transform = m.get("transform", m["distribution"])
        if transform == "bernoulli":
            p = _sigmoid(margins[:, 0])
            return np.stack([1 - p, p], axis=1)
        if transform == "multinomial":
            return _softmax(margins)
        if transform == "drf_votes":  # DRFModel._predict_raw vote averaging
            if margins.shape[1] == 1:
                p1 = np.clip(margins[:, 0], 0.0, 1.0)
                return np.stack([1 - p1, p1], axis=1)
            p = np.clip(margins, 1e-9, None)
            return p / p.sum(axis=1, keepdims=True)
        if transform == "exp":  # log-link regression (poisson/gamma/tweedie)
            return np.exp(margins[:, 0])
        return margins[:, 0]


class KMeansMojoModel(MojoModel):
    """hex/genmodel/algos/kmeans/KMeansMojoModel.java."""

    algo = "kmeans"

    def _score_rows(self, rows):
        X = self.layout.expand(rows)
        C = self._arrays["centers_std"]
        d2 = (X * X).sum(1, keepdims=True) - 2 * X @ C.T + (C * C).sum(1)[None, :]
        return d2.argmin(axis=1).astype(np.float64)

    def distances(self, data) -> np.ndarray:
        rows, _ = _as_rows(data, self.names)
        X = self.layout.expand(rows)
        C = self._arrays["centers_std"]
        d2 = (X * X).sum(1, keepdims=True) - 2 * X @ C.T + (C * C).sum(1)[None, :]
        return np.sqrt(np.maximum(d2, 0.0))


class DeepLearningMojoModel(MojoModel):
    """hex/genmodel/algos/deeplearning/DeeplearningMojoModel.java."""

    algo = "deeplearning"

    def _score_rows(self, rows):
        X = self.layout.expand(rows).astype(np.float32)
        act = self.meta["activation"]
        n_layers = int(self.meta["n_layers"])
        h = X
        for i in range(n_layers):
            W = self._arrays[f"W_{i}"]
            b = self._arrays[f"b_{i}"]
            h = h @ W + b
            if i < n_layers - 1:
                if act in ("rectifier", "rectifier_with_dropout"):
                    h = np.maximum(h, 0.0)
                elif act in ("tanh", "tanh_with_dropout"):
                    h = np.tanh(h)
                elif act in ("maxout", "maxout_with_dropout"):
                    h = np.maximum(h, 0.0)  # training side uses relu for maxout
                else:
                    raise ValueError(f"unknown activation {act!r}")
        if self.meta.get("autoencoder"):
            return h
        if self.is_classifier:
            return _softmax(h.astype(np.float64))
        return h[:, 0].astype(np.float64)


class NaiveBayesMojoModel(MojoModel):
    """hex/genmodel/algos/naivebayes (reference scores via pojo utils)."""

    algo = "naivebayes"

    def _score_rows(self, rows):
        lay = self.layout
        cols = lay._columns(rows)
        n = len(rows)
        priors = self._arrays["priors"]
        C = len(priors)
        logp = np.tile(np.log(np.maximum(priors, 1e-300)), (n, 1))
        for name in lay.predictor_names:
            if name in lay.cat_domains:
                probs = self._arrays[f"cat_{name}"]  # [C, L]
                codes = cols[name]
                ok = codes >= 0
                contrib = np.zeros((n, C))
                contrib[ok] = np.log(np.maximum(probs[:, codes[ok]].T, 1e-300))
                logp += contrib
            else:
                mean = self._arrays[f"mean_{name}"]  # [C]
                sd = self._arrays[f"sd_{name}"]
                x = cols[name]
                ok = ~np.isnan(x)
                z = (x[ok, None] - mean[None, :]) / sd[None, :]
                contrib = np.zeros((n, C))
                contrib[ok] = -0.5 * z * z - np.log(sd[None, :] * np.sqrt(2 * np.pi))
                logp += contrib
        z = logp - logp.max(axis=1, keepdims=True)
        e = np.exp(z)
        return e / e.sum(axis=1, keepdims=True)


class IsolationForestMojoModel(MojoModel):
    """hex/genmodel/algos/isofor/IsolationForestMojoModel.java."""

    algo = "isolation_forest"

    def _score_rows(self, rows):
        X = self.layout.raw_matrix(rows).astype(np.float64)
        feat = self._arrays["feat"]  # [T, M]
        thresh = self._arrays["thresh"]
        is_split = self._arrays["is_split"]
        path_len = self._arrays["path_len"]
        max_depth = int(self.meta["max_depth"])
        cn = float(self.meta["c_norm"])
        n = X.shape[0]
        T = feat.shape[0]
        total = np.zeros(n)
        for t in range(T):
            idx = np.zeros(n, dtype=np.int64)
            for _ in range(max_depth):
                f_ = feat[t][idx]
                x = X[np.arange(n), f_]
                go_left = np.where(np.isnan(x), True, x <= thresh[t][idx])
                nxt = 2 * idx + np.where(go_left, 1, 2)
                idx = np.where(is_split[t][idx], nxt, idx)
            total += path_len[t][idx]
        mean_path = total / max(T, 1)
        return np.power(2.0, -mean_path / max(cn, 1e-9))


class PcaMojoModel(MojoModel):
    """hex/genmodel/algos/pca/PCAMojoModel.java — projection scores."""

    algo = "pca"

    def _score_rows(self, rows):
        X = self.layout.expand(rows)
        # training-time demean/descale statistics (absent for
        # standardize/none, which the layout expansion already applies)
        sub = self._arrays.get("transform_sub")
        mul = self._arrays.get("transform_mul")
        if sub is not None:
            X = X - sub
        if mul is not None:
            X = X * mul
        return X @ self._arrays["eigenvectors"]


_ALGOS = {
    cls.algo: cls
    for cls in (
        GlmMojoModel,
        TreeMojoModel,
        KMeansMojoModel,
        DeepLearningMojoModel,
        NaiveBayesMojoModel,
        IsolationForestMojoModel,
        PcaMojoModel,
    )
}
# tree family shares one scorer
for _name in ("gbm", "drf", "xgboost"):
    _ALGOS[_name] = TreeMojoModel


def load_mojo(path: str) -> MojoModel:
    """hex/genmodel/MojoModel.load — open the zip, dispatch on algo."""
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("meta.json"))
        info = json.loads(z.read("data_info.json"))
        with z.open("arrays.npz") as f:
            arrays = dict(np.load(io.BytesIO(f.read()), allow_pickle=False))
    algo = meta["algo"]
    cls = _ALGOS.get(algo)
    if cls is None:
        raise ValueError(f"no MOJO reader for algo {algo!r}")
    return cls(meta, _Layout(info), arrays)
