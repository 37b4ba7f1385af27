"""Rapids advanced math prims (18) + misc repeaters/time-series — the port
of ``h2o3_tpu/rapids/prims/advmath.py`` (copied, host numpy and scipy).

Reference: ``water/rapids/ast/prims/advmath/`` — Correlation Distance Hist
Impute KFold Kurtosis Mode ModuloKFold Qtile Runif Skewness
SpearmanCorrelation StratifiedKFold StratifiedSplit Table TfIdf Unique
Variance; plus ``repeaters/`` (RepLen Seq SeqLen), ``timeseries/``
(DiffLag1 Isax), ``misc/`` (Ls Comma SetProperty).
"""

from __future__ import annotations

import numpy as np

from h2o3_tpu_torch.frame.frame import Column, ColType, Frame, NA_CAT
from h2o3_tpu_torch.models.framework import fold_assignment
from h2o3_tpu_torch.rapids.prims import prim
from h2o3_tpu_torch.rapids.prims.util import numeric_data
from h2o3_tpu_torch.rapids.runtime import RapidsError, Val


def _matrix(fr: Frame) -> np.ndarray:
    return np.stack([numeric_data(c) for c in fr.columns], axis=1)


@prim("cor")
def cor(env, args):
    """(cor frx fry use method) — Pearson correlation matrix (AstCorrelation);
    use: everything | complete.obs | all.obs."""
    fx, fy = args[0].as_frame(), args[1].as_frame()
    use = args[2].as_str() if len(args) > 2 else "everything"
    x, y = _matrix(fx), _matrix(fy)
    if use == "complete.obs":
        ok = ~(np.isnan(x).any(axis=1) | np.isnan(y).any(axis=1))
        x, y = x[ok], y[ok]
    elif use == "all.obs" and (np.isnan(x).any() or np.isnan(y).any()):
        raise RapidsError("cor: missing observations with use=all.obs")
    xm = x - x.mean(axis=0)
    ym = y - y.mean(axis=0)
    cov = xm.T @ ym / (len(x) - 1)
    sx = x.std(axis=0, ddof=1)
    sy = y.std(axis=0, ddof=1)
    out = cov / np.outer(sx, sy)
    if out.size == 1:
        return Val.num(float(out[0, 0]))
    return Val.frame(
        Frame([Column(c.name, out[:, j], ColType.NUM) for j, c in enumerate(fy.columns)])
    )


@prim("spearman")
def spearman(env, args):
    """(spearman fr colx coly) — Spearman rank correlation."""
    fr = args[0].as_frame()
    def _c(v):
        return fr.names.index(v.as_str()) if v.is_str() else int(v.as_num())
    x = numeric_data(fr.col(_c(args[1])))
    y = numeric_data(fr.col(_c(args[2])))
    ok = ~(np.isnan(x) | np.isnan(y))
    from scipy import stats

    rho = stats.spearmanr(x[ok], y[ok]).statistic
    return Val.num(float(rho))


@prim("var")
def var(env, args):
    """(var frx fry use symmetric) — covariance matrix (AstVariance)."""
    fx = args[0].as_frame()
    fy = args[1].as_frame() if len(args) > 1 and args[1].is_frame() else fx
    use = args[2].as_str() if len(args) > 2 else "everything"
    x, y = _matrix(fx), _matrix(fy)
    if use == "complete.obs":
        ok = ~(np.isnan(x).any(axis=1) | np.isnan(y).any(axis=1))
        x, y = x[ok], y[ok]
    xm = x - x.mean(axis=0)
    ym = y - y.mean(axis=0)
    cov = xm.T @ ym / (len(x) - 1)
    if cov.size == 1:
        return Val.num(float(cov[0, 0]))
    return Val.frame(
        Frame([Column(c.name, cov[:, j], ColType.NUM) for j, c in enumerate(fy.columns)])
    )


def _moment_stat(env, args, fn):
    fr = args[0].as_frame()
    na_rm = bool(args[1].as_num()) if len(args) > 1 else False
    vals = []
    for c in fr.columns:
        d = numeric_data(c)
        if na_rm:
            d = d[~np.isnan(d)]
        vals.append(fn(d))
    return Val.num(vals[0]) if len(vals) == 1 else Val.nums(vals)


@prim("skewness")
def skewness(env, args):
    """Sample skewness g1 (AstSkewness)."""
    return _moment_stat(
        env, args, lambda d: float(np.mean((d - d.mean()) ** 3) / d.std(ddof=0) ** 3) if len(d) else float("nan")
    )


@prim("kurtosis")
def kurtosis(env, args):
    """Sample kurtosis (not excess) (AstKurtosis)."""
    return _moment_stat(
        env, args, lambda d: float(np.mean((d - d.mean()) ** 4) / d.std(ddof=0) ** 4) if len(d) else float("nan")
    )


@prim("mode")
def mode(env, args):
    fr = args[0].as_frame()
    c = fr.col(0)
    if c.type is ColType.CAT:
        counts = np.bincount(c.data[c.data >= 0], minlength=len(c.domain))
        return Val.num(float(np.argmax(counts)))
    d = numeric_data(c)
    v, n = np.unique(d[~np.isnan(d)], return_counts=True)
    return Val.num(float(v[np.argmax(n)]) if len(v) else float("nan"))


@prim("hist")
def hist(env, args):
    """(hist fr breaks) — histogram frame [breaks counts mids density]
    (AstHist; breaks: count, 'sturges', 'rice', 'sqrt', 'doane', 'fd', 'scott'
    or an explicit break list)."""
    fr = args[0].as_frame()
    c = fr.col(0)
    d = numeric_data(c)
    d = d[~np.isnan(d)]
    spec = args[1] if len(args) > 1 else Val.str_("sturges")
    n = len(d)
    if spec.kind == Val.NUMS and len(spec.value) > 1:
        edges = spec.value
    else:
        if spec.is_str():
            method = spec.as_str().lower()
            k = {
                "sturges": int(np.ceil(np.log2(n) + 1)),
                "rice": int(np.ceil(2 * n ** (1 / 3))),
                "sqrt": int(np.ceil(np.sqrt(n))),
            }.get(method)
            if k is None:
                edges = np.histogram_bin_edges(d, bins=method)
                k = len(edges) - 1
            else:
                edges = np.linspace(d.min(), d.max(), k + 1)
        else:
            k = int(spec.as_num())
            edges = np.linspace(d.min(), d.max(), k + 1)
    counts, edges = np.histogram(d, bins=edges)
    mids = (edges[:-1] + edges[1:]) / 2
    width = np.diff(edges)
    dens = counts / (counts.sum() * width)
    pad = lambda a: np.concatenate([[np.nan], a]) if len(a) < len(edges) else a
    return Val.frame(
        Frame(
            [
                Column("breaks", edges, ColType.NUM),
                Column("counts", pad(counts.astype(np.float64)), ColType.NUM),
                Column("mids_true", pad(mids), ColType.NUM),
                Column("mids", pad(mids), ColType.NUM),
                Column("density", pad(dens), ColType.NUM),
            ]
        )
    )


@prim("impute", "h2o.impute")
def impute(env, args):
    """(impute fr col method combine_method [by] [groupByFrame] [values])
    (AstImpute): method mean|median|mode; col -1 = all."""
    fr = args[0].as_frame()
    col = int(args[1].as_num()) if len(args) > 1 else -1
    method = args[2].as_str().lower() if len(args) > 2 else "mean"
    by = [int(i) for i in args[4].as_nums()] if len(args) > 4 and args[4].kind == Val.NUMS and len(args[4].value) else None
    targets = range(fr.ncols) if col == -1 else [col]
    out = [c.copy() for c in fr.columns]
    filled_means = []
    for j in targets:
        c = out[j]
        if c.type in (ColType.STR, ColType.UUID):
            continue
        if c.type is ColType.CAT and method != "mode":
            if col != -1:
                raise RapidsError("impute: categorical columns need method=mode")
            continue
        if by:
            from h2o3_tpu_torch.rapids import groupby as G

            order, starts, _ = G.group_keys(fr, by)
            bounds = np.append(starts, fr.nrows)
            d = numeric_data(c).copy()
            for g in range(len(starts)):
                rows = order[bounds[g] : bounds[g + 1]]
                seg = d[rows]
                fill = _impute_value(seg, method)
                seg[np.isnan(seg)] = fill
                d[rows] = seg
            new = d
        else:
            d = numeric_data(c).copy()
            fill = _impute_value(d, method)
            filled_means.append(fill)
            d[np.isnan(d)] = fill
            new = d
        if c.type is ColType.CAT:
            out[j] = Column(c.name, new.astype(np.int32), ColType.CAT, c.domain)
        else:
            out[j] = Column(c.name, new, c.type)
    return Val.frame(Frame(out))


def _impute_value(d: np.ndarray, method: str) -> float:
    ok = d[~np.isnan(d)]
    if not len(ok):
        return float("nan")
    if method == "mean":
        return float(ok.mean())
    if method == "median":
        return float(np.median(ok))
    if method == "mode":
        v, n = np.unique(ok, return_counts=True)
        return float(v[np.argmax(n)])
    raise RapidsError(f"impute: unknown method {method!r}")


@prim("h2o.runif")
def runif(env, args):
    """(h2o.runif fr seed) — uniform [0,1) column, length nrows (AstRunif)."""
    fr = args[0].as_frame()
    seed = int(args[1].as_num()) if len(args) > 1 else -1
    rng = np.random.default_rng(None if seed == -1 else seed)
    return Val.frame(Frame([Column("rnd", rng.random(fr.nrows), ColType.NUM)]))


@prim("kfold_column")
def kfold_column(env, args):
    fr = args[0].as_frame()
    nfolds = int(args[1].as_num())
    seed = int(args[2].as_num()) if len(args) > 2 else -1
    f = fold_assignment(fr.nrows, nfolds, "random", seed if seed != -1 else 42)
    return Val.frame(Frame([Column("fold", f.astype(np.float64), ColType.NUM)]))


@prim("modulo_kfold_column")
def modulo_kfold(env, args):
    fr = args[0].as_frame()
    nfolds = int(args[1].as_num())
    f = fold_assignment(fr.nrows, nfolds, "modulo")
    return Val.frame(Frame([Column("fold", f.astype(np.float64), ColType.NUM)]))


@prim("stratified_kfold_column")
def stratified_kfold(env, args):
    fr = args[0].as_frame()
    nfolds = int(args[1].as_num())
    seed = int(args[2].as_num()) if len(args) > 2 else -1
    y = fr.col(0).numeric_view()
    f = fold_assignment(fr.nrows, nfolds, "stratified", seed if seed != -1 else 42, y=y)
    return Val.frame(Frame([Column("fold", f.astype(np.float64), ColType.NUM)]))


@prim("h2o.random_stratified_split")
def stratified_split(env, args):
    """(h2o.random_stratified_split y test_frac seed) -> 0/1 train/test column
    stratified by the response (AstStratifiedSplit)."""
    fr = args[0].as_frame()
    frac = args[1].as_num()
    seed = int(args[2].as_num()) if len(args) > 2 else -1
    rng = np.random.default_rng(None if seed == -1 else seed)
    y = fr.col(0)
    codes = y.data if y.type is ColType.CAT else y.numeric_view()
    out = np.zeros(fr.nrows, dtype=np.float64)
    cf = np.asarray(codes, dtype=np.float64)
    # exclude NAs from stratification: NaN for numeric, code -1 for CAT
    vals = np.unique(cf[~np.isnan(cf) & (cf >= 0 if y.type is ColType.CAT else True)])
    for v in vals:
        idx = np.nonzero(codes == v)[0]
        k = int(round(len(idx) * frac))
        pick = rng.choice(idx, size=k, replace=False)
        out[pick] = 1.0
    return Val.frame(Frame([Column("test_train_split", out, ColType.CAT, ["train", "test"])]))


@prim("quantile")
def quantile(env, args):
    """(quantile fr [probs] interpolation weights) (AstQtile) — per numeric
    column; returns probs column + per-column quantile columns."""
    fr = args[0].as_frame()
    probs = args[1].as_nums()
    method = args[2].as_str() if len(args) > 2 and args[2].is_str() else "interpolated"
    cols = [Column("Probs", probs.copy(), ColType.NUM)]
    for c in fr.columns:
        if c.type in (ColType.STR, ColType.UUID):
            continue
        d = numeric_data(c)
        d = d[~np.isnan(d)]
        # R type-7 linear interpolation — matches hex/quantile default
        q = np.quantile(d, probs, method="linear" if method.startswith("inter") else "lower")
        cols.append(Column(c.name + "Quantiles", np.asarray(q, dtype=np.float64), ColType.NUM))
    return Val.frame(Frame(cols))


@prim("table")
def table(env, args):
    """(table fr1 [fr2] dense) — frequency table (AstTable)."""
    f1 = args[0].as_frame()
    f2 = args[1].as_frame() if len(args) > 1 and args[1].is_frame() else None
    if f1.ncols == 2 and f2 is None:
        f2 = Frame([f1.col(1)])
        f1 = Frame([f1.col(0)])
    c1 = f1.col(0)

    def codes_domain(c):
        """-> (codes, labels, is_cat, raw_values) — raw numeric uniques kept
        exact (a %g label round-trip would collapse values past 6 sig digits)."""
        if c.type is ColType.CAT:
            return c.data.astype(np.int64), list(c.domain), True, None
        d = numeric_data(c)
        u = np.unique(d[~np.isnan(d)])
        codes = np.full(len(d), -1, dtype=np.int64)
        ok = ~np.isnan(d)
        codes[ok] = np.searchsorted(u, d[ok])
        return codes, [repr(float(v)) for v in u], False, u

    def key_column(c, dom, cat, raw):
        if cat:
            return Column(c.name, np.arange(len(dom), dtype=np.int32), ColType.CAT, dom)
        return Column(c.name, raw.astype(np.float64), ColType.NUM)

    k1, dom1, cat1, raw1 = codes_domain(c1)
    if f2 is None:
        counts = np.bincount(k1[k1 >= 0], minlength=len(dom1)).astype(np.float64)
        return Val.frame(
            Frame([key_column(c1, dom1, cat1, raw1), Column("Count", counts, ColType.NUM)])
        )
    c2 = f2.col(0)
    k2, dom2, cat2, raw2 = codes_domain(c2)
    ok = (k1 >= 0) & (k2 >= 0)
    flat = k1[ok] * len(dom2) + k2[ok]
    counts = np.bincount(flat, minlength=len(dom1) * len(dom2)).reshape(len(dom1), len(dom2))
    cols = [key_column(c1, dom1, cat1, raw1)]
    for j, lv in enumerate(dom2):
        cols.append(Column(str(lv), counts[:, j].astype(np.float64), ColType.NUM))
    return Val.frame(Frame(cols))


@prim("unique")
def unique(env, args):
    """(unique fr include_nas) (AstUnique)."""
    fr = args[0].as_frame()
    include_nas = bool(args[1].as_num()) if len(args) > 1 else False
    c = fr.col(0)
    if c.type is ColType.CAT:
        present = np.unique(c.data[c.data >= 0])
        codes = present.astype(np.int32)
        if include_nas and (c.data < 0).any():
            codes = np.concatenate([codes, [NA_CAT]]).astype(np.int32)
        return Val.frame(Frame([Column(c.name, codes, ColType.CAT, c.domain)]))
    d = numeric_data(c)
    u = np.unique(d[~np.isnan(d)])
    if include_nas and np.isnan(d).any():
        u = np.concatenate([u, [np.nan]])
    return Val.frame(Frame([Column(c.name, u, ColType.NUM)]))


@prim("tf-idf")
def tfidf(env, args):
    """(tf-idf fr doc_id_idx text_idx preprocess case_sensitive) (AstTfIdf).
    Output: [doc_id word tf idf tf_idf] (hex/tfidf MRTasks)."""
    fr = args[0].as_frame()
    doc_idx = int(args[1].as_num())
    text_idx = int(args[2].as_num())
    preprocess = bool(args[3].as_num()) if len(args) > 3 else True
    case_sensitive = bool(args[4].as_num()) if len(args) > 4 else True
    from h2o3_tpu_torch.rapids.prims.strings import _str_values

    docs = fr.col(doc_idx).numeric_view()
    texts = _str_values(fr.col(text_idx))
    pairs = {}
    doc_words = {}
    if preprocess:
        tokens_per_row = [
            (d, (t if case_sensitive else t.lower()).split()) if t is not None else (d, [])
            for d, t in zip(docs, texts)
        ]
    else:
        tokens_per_row = [
            (d, [t if case_sensitive else t.lower()]) if t is not None else (d, [])
            for d, t in zip(docs, texts)
        ]
    from collections import Counter, defaultdict

    tf = defaultdict(Counter)
    for d, toks in tokens_per_row:
        tf[d].update(toks)
    n_docs = len(tf)
    df = Counter()
    for d, counter in tf.items():
        df.update(counter.keys())
    rows = []
    for d in sorted(tf):
        for w, c in sorted(tf[d].items()):
            idf = np.log((1.0 + n_docs) / (1.0 + df[w]))
            rows.append((d, w, float(c), idf, float(c) * idf))
    words = sorted({w for _, w, *_ in rows})
    widx = {w: i for i, w in enumerate(words)}
    return Val.frame(
        Frame(
            [
                Column(fr.names[doc_idx], np.array([r[0] for r in rows]), ColType.NUM),
                Column(fr.names[text_idx], np.array([widx[r[1]] for r in rows], dtype=np.int32), ColType.CAT, words),
                Column("TF", np.array([r[2] for r in rows]), ColType.NUM),
                Column("IDF", np.array([r[3] for r in rows]), ColType.NUM),
                Column("TF_IDF", np.array([r[4] for r in rows]), ColType.NUM),
            ]
        )
    )


# -- repeaters / sequences ---------------------------------------------------
@prim("rep_len")
def rep_len(env, args):
    v = args[0]
    n = int(args[1].as_num())
    if v.is_frame():
        c = v.value.col(0)
        data = np.resize(c.data, n)
        return Val.frame(Frame([Column(c.name, data, c.type, c.domain)]))
    return Val.frame(Frame([Column("C1", np.full(n, v.as_num()), ColType.NUM)]))


@prim("seq")
def seq(env, args):
    frm, to, by = args[0].as_num(), args[1].as_num(), args[2].as_num() if len(args) > 2 else 1.0
    vals = np.arange(frm, to + by * 0.5 * np.sign(by), by)
    return Val.frame(Frame([Column("C1", vals, ColType.NUM)]))


@prim("seq_len")
def seq_len(env, args):
    n = int(args[0].as_num())
    return Val.frame(Frame([Column("C1", np.arange(1, n + 1, dtype=np.float64), ColType.NUM)]))


# -- time series -------------------------------------------------------------
@prim("difflag1")
def difflag1(env, args):
    """(difflag1 fr) — first difference x[i]-x[i-1], first row NA (AstDiffLag1)."""
    fr = args[0].as_frame()
    c = fr.col(0)
    d = numeric_data(c)
    out = np.concatenate([[np.nan], np.diff(d)])
    return Val.frame(Frame([Column(c.name, out, ColType.NUM)]))


@prim("isax")
def isax(env, args):
    """(isax fr num_words max_cardinality optimize_card) — iSAX2 symbolic
    aggregate approximation of each row's time series (AstIsax)."""
    fr = args[0].as_frame()
    num_words = int(args[1].as_num())
    max_card = int(args[2].as_num())
    mat = _matrix(fr)
    n, t = mat.shape
    mu = np.nanmean(mat, axis=1, keepdims=True)
    sd = np.nanstd(mat, axis=1, keepdims=True)
    sd[sd == 0] = 1.0
    z = (mat - mu) / sd
    # PAA: mean per word segment
    seg = np.array_split(np.arange(t), num_words)
    paa = np.stack([np.nanmean(z[:, s], axis=1) for s in seg], axis=1)
    # gaussian breakpoints for max_card symbols
    from scipy import stats as _st

    bp = _st.norm.ppf(np.linspace(0, 1, max_card + 1)[1:-1])
    codes = np.stack([np.searchsorted(bp, paa[:, j]) for j in range(num_words)], axis=1)
    strings = np.array(["^".join(str(int(v)) for v in row) for row in codes], dtype=object)
    cols = [Column("iSax_index", strings, ColType.STR)]
    for j in range(num_words):
        cols.append(Column(f"iSax_word_{j}", codes[:, j].astype(np.float64), ColType.NUM))
    return Val.frame(Frame(cols))


# -- misc --------------------------------------------------------------------
@prim("ls")
def ls(env, args):
    from h2o3_tpu_torch.keyed import DKV

    keys = sorted(DKV.keys())
    return Val.frame(Frame([Column("key", np.array(keys, dtype=object), ColType.STR)]))


@prim("setproperty")
def setproperty(env, args):
    import os

    os.environ[args[0].as_str()] = args[1].as_str()
    return Val.num(0)


@prim(",")
def comma(env, args):
    """(, expr expr ...) — sequence; value of the last (AstComma)."""
    return args[-1] if args else Val.num(0)


@prim("distance")
def distance(env, args):
    """(distance references queries measure) — pairwise measure between
    all rows: [R rows x Q cols] (AstDistance). Measures: 'l1', 'l2',
    'cosine' (similarity, dot/(|r||q|)), 'cosine_sq' (dot²/(|r|²|q|²))."""
    refs = _matrix(args[0].as_frame())
    qs = _matrix(args[1].as_frame())
    measure = args[2].as_str().lower()
    if measure not in ("cosine", "cosine_sq", "l1", "l2"):
        raise ValueError(
            f"Invalid distance measure provided: {measure}. Must be one "
            "of ['cosine', 'cosine_sq', 'l1', 'l2']")
    if refs.shape[1] != qs.shape[1]:
        raise ValueError(
            f"Frames must have the same number of cols, found "
            f"{refs.shape[1]} and {qs.shape[1]}")
    if np.isnan(refs).any() or np.isnan(qs).any():
        raise ValueError("distance frames must not contain missing values")
    if measure in ("cosine", "cosine_sq"):
        dot = refs @ qs.T  # [R, Q]
        dr = (refs * refs).sum(axis=1)[:, None]
        dq = (qs * qs).sum(axis=1)[None, :]
        if measure == "cosine_sq":
            out = (dot * dot) / (dr * dq)
        else:
            out = dot / np.sqrt(dr * dq)
    elif measure == "l2":
        d2 = ((refs * refs).sum(axis=1)[:, None]
              + (qs * qs).sum(axis=1)[None, :]
              - 2.0 * (refs @ qs.T))
        out = np.sqrt(np.maximum(d2, 0.0))
    else:  # l1 — accumulate per feature: a [R, Q, p] broadcast temp
        # would be p times the (already R*Q) output size
        out = np.zeros((refs.shape[0], qs.shape[0]))
        for j in range(refs.shape[1]):
            out += np.abs(refs[:, j][:, None] - qs[:, j][None, :])
    return Val.frame(Frame([
        Column(f"C{j + 1}", out[:, j].astype(np.float64), ColType.NUM)
        for j in range(out.shape[1])
    ]))
