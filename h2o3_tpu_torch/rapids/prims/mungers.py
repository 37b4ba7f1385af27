"""Rapids mungers (40) — the port of ``h2o3_tpu/rapids/prims/mungers.py``:
slicing, binding, factors, group-by, reshape.

Reference: ``water/rapids/ast/prims/mungers/`` (SURVEY.md App. A list).
The host functions are the JAX package's; ``sort``, ``merge`` and ``GB``
run their device paths (``rapids/merge.py``, ``rapids/groupby.py``) on the
session's device. The JAX package's chunk-homed ``rows`` path waits for the
cluster port (ROADMAP A10).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import Column, ColType, Frame, NA_CAT
from h2o3_tpu_torch.rapids import groupby as G
from h2o3_tpu_torch.rapids import merge as MG
from h2o3_tpu_torch.rapids.prims import prim
from h2o3_tpu_torch.rapids.prims.util import col_indices, numeric_data, row_indices
from h2o3_tpu_torch.rapids.runtime import RapidsError, Val, apply_fun


# -- shape / names -----------------------------------------------------------
@prim("nrow")
def nrow(env, args):
    return Val.num(args[0].as_frame().nrows)


@prim("ncol")
def ncol(env, args):
    return Val.num(args[0].as_frame().ncols)


@prim("colnames")
def colnames(env, args):
    return Val.strs(args[0].as_frame().names)


@prim("colnames=")
def colnames_set(env, args):
    """(colnames= fr [idxs] [names]) — AstColNames assignment form."""
    fr = args[0].as_frame()
    idxs = col_indices(fr, args[1])
    names = args[2].as_strs()
    mapping = {fr.names[i]: n for i, n in zip(idxs, names)}
    return Val.frame(fr.rename(mapping))


@prim("rename")
def rename(env, args):
    fr = args[0].as_frame()
    return Val.frame(fr.rename({args[1].as_str(): args[2].as_str()}))


# -- slicing -----------------------------------------------------------------
def _cols_fuse_args(ast_args):
    # a literal selector re-indexes columns statically inside a fused
    # program; computed selectors (frames, expressions) fall back
    from h2o3_tpu_torch.rapids.parser import AstNum, AstNumList, AstStr, AstStrList

    return len(ast_args) == 2 and isinstance(
        ast_args[1], (AstNum, AstNumList, AstStr, AstStrList))


@prim("cols", "cols_py", fusible=True, kind="select",
      fuse_args=_cols_fuse_args)
def cols(env, args):
    fr = args[0].as_frame()
    return Val.frame(fr.cols([fr.names[i] for i in col_indices(fr, args[1])]))


@prim("rows")
def rows(env, args):
    fr = args[0].as_frame()
    return Val.frame(fr.rows(row_indices(fr, args[1])))


@prim("flatten")
def flatten(env, args):
    """1x1 frame -> scalar (AstFlatten)."""
    fr = args[0].as_frame()
    if fr.nrows != 1 or fr.ncols != 1:
        return Val.frame(fr)
    c = fr.col(0)
    if c.type in (ColType.STR, ColType.UUID):
        return Val.str_(c.data[0] if c.data[0] is not None else "")
    if c.type is ColType.CAT:
        code = int(c.data[0])
        return Val.str_(c.domain[code]) if code >= 0 else Val.num(float("nan"))
    return Val.num(float(c.data[0]))


@prim("getrow")
def getrow(env, args):
    """Single-row frame -> ROW val (AstGetrow)."""
    fr = args[0].as_frame()
    if fr.nrows != 1:
        raise RapidsError(f"getrow: frame has {fr.nrows} rows, want 1")
    vals = [float(c.numeric_view()[0]) if c.type not in (ColType.STR, ColType.UUID) else float("nan") for c in fr.columns]
    return Val.row(vals, fr.names)


@prim("columnsByType")
def columns_by_type(env, args):
    """(columnsByType fr type) -> indices; type in numeric|categorical|string|
    time|uuid|bad (AstColumnsByType)."""
    fr = args[0].as_frame()
    want = args[1].as_str().lower()
    sel = {
        "numeric": lambda c: c.type is ColType.NUM,
        "categorical": lambda c: c.type is ColType.CAT,
        "string": lambda c: c.type is ColType.STR,
        "time": lambda c: c.type is ColType.TIME,
        "uuid": lambda c: c.type is ColType.UUID,
        "bad": lambda c: c.type is ColType.BAD,
    }.get(want)
    if sel is None:
        raise RapidsError(f"columnsByType: unknown type {want!r}")
    return Val.nums([float(i) for i, c in enumerate(fr.columns) if sel(c)])


# -- bind --------------------------------------------------------------------
@prim("cbind")
def cbind(env, args):
    out = args[0].as_frame()
    for v in args[1:]:
        f = v.as_frame()
        if f.nrows == 1 and out.nrows > 1:  # scalar recycle
            f = Frame([Column(c.name, np.repeat(c.data, out.nrows), c.type, c.domain) for c in f.columns])
        out = out.cbind(f)
    return Val.frame(out)


@prim("rbind")
def rbind(env, args):
    out = args[0].as_frame()
    for v in args[1:]:
        out = out.rbind(v.as_frame())
    return Val.frame(out)


# -- factor / type predicates ------------------------------------------------
# metadata-only prims go through col_types(), as in the JAX package
@prim("is.factor")
def is_factor(env, args):
    fr = args[0].as_frame()
    return Val.nums([float(t is ColType.CAT) for t in fr.col_types()])


@prim("is.numeric")
def is_numeric(env, args):
    fr = args[0].as_frame()
    return Val.nums([float(t in (ColType.NUM, ColType.TIME))
                     for t in fr.col_types()])


@prim("is.character")
def is_character(env, args):
    fr = args[0].as_frame()
    return Val.nums([float(t is ColType.STR) for t in fr.col_types()])


@prim("anyfactor")
def anyfactor(env, args):
    fr = args[0].as_frame()
    return Val.num(float(any(t is ColType.CAT for t in fr.col_types())))


@prim("as.factor")
def as_factor(env, args):
    fr = args[0].as_frame()
    return Val.frame(Frame([c.as_factor() for c in fr.columns]))


@prim("as.numeric")
def as_numeric(env, args):
    fr = args[0].as_frame()
    return Val.frame(Frame([c.as_numeric() for c in fr.columns]))


@prim("as.character")
def as_character(env, args):
    fr = args[0].as_frame()
    cols = []
    for c in fr.columns:
        if c.type is ColType.CAT:
            dom = np.asarray(c.domain + [None], dtype=object)
            data = dom[np.where(c.data >= 0, c.data, len(c.domain))]
        elif c.type in (ColType.STR, ColType.UUID):
            data = c.data.copy()
        else:
            data = np.array(
                [None if np.isnan(v) else (str(int(v)) if float(v).is_integer() else repr(v)) for v in c.data],
                dtype=object,
            )
        cols.append(Column(c.name, data, ColType.STR))
    return Val.frame(Frame(cols))


@prim("levels")
def levels(env, args):
    fr = args[0].as_frame()
    doms = [c.domain or [] for c in fr.columns]
    return Val.strs(doms[0]) if fr.ncols == 1 else Val(Val.STRS, [lv for d in doms for lv in d])


@prim("nlevels")
def nlevels(env, args):
    fr = args[0].as_frame()
    return Val.nums([float(c.cardinality() if c.type is ColType.CAT else 0) for c in fr.columns])


@prim("setLevel")
def set_level(env, args):
    """(setLevel fr level) — set all rows of a CAT col to one level (AstSetLevel)."""
    fr = args[0].as_frame()
    lvl = args[1].as_str()
    c = fr.col(0)
    if c.type is not ColType.CAT or lvl not in c.domain:
        raise RapidsError(f"setLevel: {lvl!r} not a level of {c.name!r}")
    code = c.domain.index(lvl)
    return Val.frame(
        Frame([Column(c.name, np.full(len(c), code, dtype=np.int32), ColType.CAT, c.domain)])
    )


@prim("setDomain")
def set_domain(env, args):
    """(setDomain fr inPlace [levels]) — replace the CAT domain (AstSetDomain)."""
    fr = args[0].as_frame()
    new_dom = args[-1].as_strs()
    c = fr.col(0)
    if c.type is not ColType.CAT:
        raise RapidsError("setDomain: not a categorical column")
    if len(new_dom) < c.cardinality():
        raise RapidsError("setDomain: fewer levels than existing domain")
    return Val.frame(Frame([Column(c.name, c.data.copy(), ColType.CAT, list(new_dom))]))


@prim("relevel")
def relevel(env, args):
    """(relevel fr level) — move level to front (AstReLevel)."""
    fr = args[0].as_frame()
    lvl = args[1].as_str()
    c = fr.col(0)
    if c.type is not ColType.CAT or lvl not in c.domain:
        raise RapidsError(f"relevel: {lvl!r} not a level")
    old = c.domain
    new_dom = [lvl] + [d for d in old if d != lvl]
    remap = np.array([new_dom.index(d) for d in old], dtype=np.int32)
    codes = np.where(c.data >= 0, remap[np.clip(c.data, 0, None)], NA_CAT).astype(np.int32)
    return Val.frame(Frame([Column(c.name, codes, ColType.CAT, new_dom)]))


# -- NA handling -------------------------------------------------------------
@prim("is.na", fusible=True, kind="uniop",
      emit=lambda x: torch.isnan(x).to(torch.float64))
def is_na(env, args):
    fr = args[0].as_frame()
    return Val.frame(
        Frame([Column(c.name, c.isna().astype(np.float64), ColType.NUM) for c in fr.columns])
    )


@prim("na.omit")
def na_omit(env, args):
    return Val.frame(args[0].as_frame().na_omit())


@prim("filterNACols")
def filter_na_cols(env, args):
    """(filterNACols fr frac) -> indices of columns with <= frac NAs."""
    fr = args[0].as_frame()
    frac = args[1].as_num()
    keep = [
        float(i)
        for i, c in enumerate(fr.columns)
        if c.na_count() <= frac * fr.nrows
    ]
    return Val.nums(keep)


@prim("h2o.fillna")
def fillna(env, args):
    """(h2o.fillna fr method axis maxlen) — forward/backward fill (AstFillNA)."""
    fr = args[0].as_frame()
    method = args[1].as_str().lower() if len(args) > 1 else "forward"
    axis = int(args[2].as_num()) if len(args) > 2 else 0
    maxlen = int(args[3].as_num()) if len(args) > 3 else 1
    if axis != 0:
        # axis=1 fills across columns within each row: mat is [N, C] and
        # _fill_along fills along its second axis, so no transpose
        mat = np.stack([numeric_data(c) for c in fr.columns], axis=1)
        filled = _fill_along(mat, method, maxlen)
        return Val.frame(
            Frame([Column(c.name, filled[:, j], ColType.NUM) for j, c in enumerate(fr.columns)])
        )
    cols = []
    for c in fr.columns:
        d = numeric_data(c).copy()
        filled = _fill_along(d[None, :], method, maxlen)[0]
        if c.type is ColType.CAT:
            codes = np.where(np.isnan(filled), -1, filled).astype(np.int32)
            cols.append(Column(c.name, codes, ColType.CAT, c.domain))
        else:
            cols.append(Column(c.name, filled, c.type if c.type is ColType.TIME else ColType.NUM))
    return Val.frame(Frame(cols))


def _fill_along(mat: np.ndarray, method: str, maxlen: int) -> np.ndarray:
    out = mat.astype(np.float64).copy()
    rng = range(1, out.shape[1])
    backward = method.startswith("b")
    if backward:
        out = out[:, ::-1]
    run = np.zeros(out.shape[0], dtype=np.int64)
    for j in range(1, out.shape[1]):
        nan = np.isnan(out[:, j])
        run = np.where(nan, run + 1, 0)
        can = nan & (run <= maxlen)
        out[can, j] = out[can, j - 1]
    return out[:, ::-1] if backward else out


# -- cut / scale -------------------------------------------------------------
@prim("cut")
def cut(env, args):
    """(cut fr [breaks] [labels] include_lowest right digits) (AstCut)."""
    fr = args[0].as_frame()
    breaks = args[1].as_nums()
    labels = args[2].as_strs() if len(args) > 2 and args[2].kind in (Val.STRS, Val.STR) else []
    include_lowest = bool(args[3].as_num()) if len(args) > 3 else False
    right = bool(args[4].as_num()) if len(args) > 4 else True
    digits = int(args[5].as_num()) if len(args) > 5 else 3
    c = fr.col(0)
    d = numeric_data(c)
    if right:
        codes = np.searchsorted(breaks, d, side="left") - 1
        if include_lowest:
            codes[d == breaks[0]] = 0
    else:
        codes = np.searchsorted(breaks, d, side="right") - 1
    codes = codes.astype(np.int32)
    bad = np.isnan(d) | (codes < 0) | (codes >= len(breaks) - 1)
    codes[bad] = NA_CAT
    if not labels:
        fmt = lambda v: f"{round(float(v), digits):g}"
        lb, rb = ("(", "]") if right else ("[", ")")
        labels = [f"{lb}{fmt(breaks[i])},{fmt(breaks[i+1])}{rb}" for i in range(len(breaks) - 1)]
        if include_lowest and right:
            labels[0] = "[" + labels[0][1:]
    return Val.frame(Frame([Column(c.name, codes, ColType.CAT, list(labels))]))


@prim("scale")
def scale(env, args):
    """(scale fr center scale) — center/scale numeric columns (AstScale);
    center/scale may be booleans or per-column number lists."""
    fr = args[0].as_frame()

    def resolve(v, default_fn):
        if v.kind == Val.NUMS:
            return v.value
        flag = bool(v.as_num())
        return default_fn() if flag else None

    cols = [c for c in fr.columns]
    num_idx = [i for i, c in enumerate(cols) if c.type is ColType.NUM]
    if not num_idx:
        return Val.frame(fr)
    mat = np.stack([numeric_data(cols[i]) for i in num_idx], axis=1)
    center = resolve(args[1], lambda: np.nanmean(mat, axis=0))
    scl = resolve(args[2], lambda: np.nanstd(mat, axis=0, ddof=1))
    out = list(cols)
    if mat is not None:
        m = mat
        if center is not None:
            m = m - np.asarray(center)[None, :]
        if scl is not None:
            s = np.asarray(scl, dtype=np.float64).copy()
            s[s == 0] = 1.0
            m = m / s[None, :]
        for k, i in enumerate(num_idx):
            out[i] = Column(cols[i].name, m[:, k], ColType.NUM)
    return Val.frame(Frame(out))


# -- group-by ----------------------------------------------------------------
_AGG_NAMES = set(G.AGGS)


@prim("GB")
def gb(env, args):
    """(GB fr [by] agg col na agg col na ...) (AstGroup)."""
    fr = args[0].as_frame()
    by = [int(i) for i in args[1].as_nums()]
    aggs = []
    i = 2
    while i < len(args):
        agg = args[i].as_str()
        col = int(args[i + 1].as_num()) if not args[i + 1].is_str() else fr.names.index(args[i + 1].as_str())
        na = args[i + 2].as_str() if i + 2 < len(args) and args[i + 2].is_str() else "all"
        aggs.append((agg, col, na))
        i += 3
    grouped = G.group_by(fr, by, aggs, device=env.session.device)
    # reference returns groups sorted by key — group_by already emits sorted
    return Val.frame(grouped)


@prim("ddply")
def ddply(env, args):
    """(ddply fr [by] fun) — split-apply-combine with a lambda per group."""
    fr = args[0].as_frame()
    by = [int(i) for i in args[1].as_nums()]
    fun = args[2]
    if not fun.is_fun():
        raise RapidsError("ddply: third arg must be a lambda")
    order, starts, _ = G.group_keys(fr, by)
    bounds = np.append(starts, fr.nrows)
    key_cols = [fr.col(j) for j in by]
    out_rows: List[List[float]] = []
    for g in range(len(starts)):
        rows_g = order[bounds[g] : bounds[g + 1]]
        sub = fr.rows(rows_g)
        res = apply_fun(fun, [Val.frame(sub)], env)
        if res.is_frame():
            vals = [float(c.numeric_view()[0]) for c in res.value.columns]
        elif res.kind == Val.NUMS:
            vals = [float(x) for x in res.value]
        elif res.kind == Val.ROW:
            vals = [float(x) for x in res.value[0]]
        else:
            vals = [res.as_num()]
        keys = [c.numeric_view()[rows_g[0]] for c in key_cols]
        out_rows.append(keys + vals)
    arr = np.asarray(out_rows, dtype=np.float64)
    names = [c.name for c in key_cols] + [f"ddply_C{i+1}" for i in range(arr.shape[1] - len(by))]
    return Val.frame(Frame([Column(n, arr[:, j], ColType.NUM) for j, n in enumerate(names)]))


@prim("rankWithinGroupBy", "rank_within_groupby")
def rank_within(env, args):
    fr = args[0].as_frame()
    by = [int(i) for i in args[1].as_nums()]
    sort_cols = [int(i) for i in args[2].as_nums()]
    asc = [bool(b) for b in args[3].as_nums()] if len(args) > 3 else [True] * len(sort_cols)
    new_col = args[4].as_str() if len(args) > 4 else "New_Rank_column"
    return Val.frame(G.rank_within_group_by(fr, by, sort_cols, asc, new_col))


# -- merge / sort ------------------------------------------------------------
@prim("merge")
def merge(env, args):
    """(merge left right all_left all_right [by_left] [by_right] method)."""
    left, right = args[0].as_frame(), args[1].as_frame()
    all_left = bool(args[2].as_num()) if len(args) > 2 else False
    all_right = bool(args[3].as_num()) if len(args) > 3 else False
    if len(args) > 4 and len(args[4].as_nums()):
        by_left = [int(i) for i in args[4].as_nums()]
        by_right = [int(i) for i in args[5].as_nums()]
    else:  # default: join on identically named columns
        common = [n for n in left.names if n in right.names]
        if not common:
            raise RapidsError("merge: no common columns")
        by_left = [left.names.index(n) for n in common]
        by_right = [right.names.index(n) for n in common]
    return Val.frame(MG.merge_frames(left, right, by_left, by_right, all_left,
                                     all_right, device=env.session.device))


@prim("sort")
def sort_(env, args):
    fr = args[0].as_frame()
    by = [int(i) for i in args[1].as_nums()]
    asc = [bool(b) for b in args[2].as_nums()] if len(args) > 2 else [True] * len(by)
    return Val.frame(MG.sort_frame(fr, by, asc, device=env.session.device))


# -- reshape -----------------------------------------------------------------
@prim("melt")
def melt(env, args):
    """(melt fr [id_idx] [value_idx] var_name value_name skipna) (AstMelt)."""
    fr = args[0].as_frame()
    id_idx = [int(i) for i in args[1].as_nums()]
    val_idx = [int(i) for i in args[2].as_nums()] if len(args) > 2 and len(args[2].as_nums()) else [
        i for i in range(fr.ncols) if i not in id_idx
    ]
    var_name = args[3].as_str() if len(args) > 3 else "variable"
    value_name = args[4].as_str() if len(args) > 4 else "value"
    skipna = bool(args[5].as_num()) if len(args) > 5 else False
    n, k = fr.nrows, len(val_idx)
    id_cols = []
    for j in id_idx:
        c = fr.col(j)
        id_cols.append(Column(c.name, np.tile(c.data, k), c.type, c.domain))
    var_domain = [fr.names[j] for j in val_idx]
    var_codes = np.repeat(np.arange(k, dtype=np.int32), n)
    vals = np.concatenate([numeric_data(fr.col(j)) for j in val_idx])
    out = Frame(
        id_cols
        + [
            Column(var_name, var_codes, ColType.CAT, var_domain),
            Column(value_name, vals, ColType.NUM),
        ]
    )
    if skipna:
        out = out.rows(~np.isnan(vals))
    return Val.frame(out)


@prim("pivot")
def pivot(env, args):
    """(pivot fr index column value) (AstPivot)."""
    fr = args[0].as_frame()
    def _col(v):
        return fr.names.index(v.as_str()) if v.is_str() else int(v.as_num())
    ji, jc, jv = _col(args[1]), _col(args[2]), _col(args[3])
    index_c, col_c, val_c = fr.col(ji), fr.col(jc), fr.col(jv)
    idx_vals = index_c.numeric_view()
    uniq_idx, idx_codes = np.unique(idx_vals, return_inverse=True)
    if col_c.type is ColType.CAT:
        col_names = list(col_c.domain)
        col_codes = col_c.data.astype(np.int64)
    else:
        u, col_codes = np.unique(col_c.numeric_view(), return_inverse=True)
        col_names = [f"{v:g}" for v in u]
    out = np.full((len(uniq_idx), len(col_names)), np.nan)
    vals = val_c.numeric_view()
    ok = col_codes >= 0
    out[idx_codes[ok], col_codes[ok]] = vals[ok]
    cols = [Column(index_c.name, uniq_idx, ColType.NUM)]
    for j, name in enumerate(col_names):
        cols.append(Column(name, out[:, j], ColType.NUM))
    return Val.frame(Frame(cols))


@prim("apply")
def apply_(env, args):
    """(apply fr margin fun) — margin 1=rows, 2=cols (AstApply)."""
    fr = args[0].as_frame()
    margin = int(args[1].as_num())
    fun = args[2]
    if not fun.is_fun():
        raise RapidsError("apply: third arg must be a function")
    if margin == 2:
        out_cols = []
        for c in fr.columns:
            res = apply_fun(fun, [Val.frame(Frame([c]))], env)
            rf = res.as_frame()
            rc = rf.col(0)
            out_cols.append(Column(c.name, rc.data, rc.type, rc.domain))
        return Val.frame(Frame(out_cols))
    # margin 1: per-row apply. The row binds as ONE COLUMN of its values
    # (the reference's AstApply row binding): reducers then collapse
    # across the row to a scalar, and elementwise arithmetic yields the
    # transformed row values
    mat = np.stack([numeric_data(c) for c in fr.columns], axis=1)
    out_rows = []
    for i in range(fr.nrows):
        row_fr = Frame([Column("C1", mat[i].astype(np.float64), ColType.NUM)])
        res = apply_fun(fun, [Val.frame(row_fr)], env)
        if res.is_frame():
            rf = res.as_frame()
            out_rows.append([float(v) for v in rf.col(0).numeric_view()])
        elif res.kind == Val.NUMS:
            out_rows.append([float(v) for v in res.as_nums()])
        else:
            out_rows.append([res.as_num()])
    arr = np.asarray(out_rows)
    return Val.frame(
        Frame([Column(f"C{j+1}", arr[:, j], ColType.NUM) for j in range(arr.shape[1])])
    )


@prim("dropdup", "dropduplicates")
def dropdup(env, args):
    """(dropdup fr [cols] keep) — drop duplicate rows (AstDropDuplicates)."""
    fr = args[0].as_frame()
    by = [int(i) for i in args[1].as_nums()] if len(args) > 1 else list(range(fr.ncols))
    keep = args[2].as_str() if len(args) > 2 else "first"
    order, starts, _ = G.group_keys(fr, by)
    bounds = np.append(starts, fr.nrows)
    picks = order[starts] if keep == "first" else order[bounds[1:] - 1]
    return Val.frame(fr.rows(np.sort(picks)))


@prim("mojo.pipeline.transform")
def mojo_pipeline_transform(env, args):
    """(mojo.pipeline.transform pipeline frame allowTimestamps) — score a
    frame through a ScoringPipeline (rapids/AstPipelineTransform.java; the
    allowTimestamps flag is accepted for signature parity — this build's
    pipelines carry time columns as numerics, so nothing is gated on it)."""
    from h2o3_tpu_torch.keyed import DKV
    from h2o3_tpu_torch.models.pipeline import ScoringPipeline

    key = args[0].as_str()
    pipe = DKV.get(key)
    if not isinstance(pipe, ScoringPipeline):
        raise RapidsError(f"no pipeline {key!r}")
    fr = args[1].as_frame()
    try:
        return Val.frame(pipe.transform(fr))
    except ValueError as e:
        raise RapidsError(str(e))


@prim("grouped_permute")
def grouped_permute(env, args):
    """(grouped_permute fr permCol groupBy permuteBy keepCol)
    (AstGroupedPermute): within each group (first groupBy column), rows
    split by whether the permuteBy categorical's level is "D"; the two
    sides' (permCol id -> summed keepCol amount) maps are crossed into
    [group, In, Out, InAmnt, OutAmnt] rows — all D-side x other-side
    combinations, first-seen id order, duplicate ids merging amounts."""
    fr = args[0].as_frame()
    perm_col = int(args[1].as_num())
    by = [int(i) for i in args[2].as_nums()]
    permute_by = int(args[3].as_num())
    keep_col = int(args[4].as_num())

    gb_col = fr.col(by[0])
    gid = numeric_data(gb_col)
    pb = fr.col(permute_by)
    if pb.domain is None:
        raise RapidsError("grouped_permute: permuteBy must be categorical")
    is_d = np.array([
        pb.domain[int(c)] == "D" if c >= 0 else False for c in pb.data
    ])
    rid = numeric_data(fr.col(perm_col))
    amt = numeric_data(fr.col(keep_col))

    # per group, per side: insertion-ordered rid -> summed amount.
    # NaN keys canonicalize to one sentinel: the reference's
    # HashMap<Double> treats NaN as equal to itself, so NA groups merge
    def canon(v: float):
        return "__nan__" if np.isnan(v) else float(v)

    groups: dict = {}
    for i in range(fr.nrows):
        sides = groups.setdefault(canon(gid[i]), ({}, {}))
        side = sides[0] if is_d[i] else sides[1]
        side[canon(rid[i])] = side.get(canon(rid[i]), 0.0) + amt[i]

    rows = []
    for key, (d_side, c_side) in groups.items():
        k = np.nan if key == "__nan__" else key
        for r0, a0 in d_side.items():
            for r1, a1 in c_side.items():
                rows.append((k,
                             np.nan if r0 == "__nan__" else r0,
                             np.nan if r1 == "__nan__" else r1,
                             a0, a1))
    out = np.array(rows, dtype=np.float64).reshape(-1, 5)

    def col(name, vals, src):
        if src.domain is not None:
            codes = np.where(np.isnan(vals), -1, vals).astype(np.int32)
            return Column(name, codes, ColType.CAT, list(src.domain))
        return Column(name, vals, ColType.NUM)

    return Val.frame(Frame([
        col(fr.names[by[0]], out[:, 0], gb_col),
        col("In", out[:, 1], fr.col(perm_col)),
        col("Out", out[:, 2], fr.col(perm_col)),
        Column("InAmnt", out[:, 3], ColType.NUM),
        Column("OutAmnt", out[:, 4], ColType.NUM),
    ]))
