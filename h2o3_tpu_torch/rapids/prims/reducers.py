"""Rapids reducers (26) — the port of ``h2o3_tpu/rapids/prims/reducers.py``
(copied, host numpy): frame-wide and cumulative reductions.

Reference: ``water/rapids/ast/prims/reducers/`` — All Any AnyNa CumMax CumMin
CumProd CumSum Mad Max MaxNa Mean Median Min MinNa NaCnt Prod ProdNa Sdev Sum
SumAxis SumNa TopN.  Simple reducers ride cached RollupStats in the reference
(RollupOp); here rollups are the same lazily-cached per-column stats
(``frame/rollups.py``).
"""

from __future__ import annotations

import numpy as np

from h2o3_tpu_torch.frame.frame import Column, ColType, Frame
from h2o3_tpu_torch.rapids.prims import prim
from h2o3_tpu_torch.rapids.prims.util import map_columns, numeric_data
from h2o3_tpu_torch.rapids.runtime import RapidsError, Val


def _numeric_cols(fr: Frame):
    return [c for c in fr.columns if c.type not in (ColType.STR, ColType.UUID)]


def _reduce(name, col_fn, all_fn=None, fusible=False):
    """Reducer over every numeric column. With na_rm=0 (default), NAs poison
    the result (reference Max vs MaxNa pairs); the *Na variants skip NAs.

    Fusible reducers may root a fused region: the elementwise chain below
    them compiles into one dispatch and the reducer runs as a host epilogue
    through this very prim, keeping the combine bit-identical (numpy pairwise
    summation does not match a device reduction's rounding). Only the
    single-arg form fuses — an explicit na_rm argument falls back."""

    @prim(name, fusible=fusible, kind="reduce",
          fuse_args=(lambda ast_args: len(ast_args) == 1) if fusible else None)
    def op(env, args, col_fn=col_fn, name=name):
        v = args[0]
        na_rm = (
            bool(args[1].as_num())
            if len(args) > 1 and not np.isnan(args[1].as_num())
            else name.lower().endswith("na") or name in ("mean", "median", "sd", "mad")
        )
        if not v.is_frame():
            return Val.num(v.as_num())
        vals = []
        for c in _numeric_cols(v.value):
            d = numeric_data(c)
            if na_rm:
                d = d[~np.isnan(d)]
            with np.errstate(all="ignore"):
                vals.append(float(col_fn(d)) if len(d) else float("nan"))
        if not vals:
            raise RapidsError(f"{name}: no numeric columns")
        return Val.num(vals[0]) if len(vals) == 1 else Val.nums(vals)

    return op


_reduce("max", np.max, fusible=True)
_reduce("maxNA", np.max, fusible=True)
_reduce("min", np.min, fusible=True)
_reduce("minNA", np.min, fusible=True)
_reduce("sum", np.sum, fusible=True)
_reduce("sumNA", np.sum, fusible=True)
_reduce("prod", np.prod, fusible=True)
_reduce("prodNA", np.prod, fusible=True)
_reduce("mean", np.mean, fusible=True)
_reduce("median", np.median)
_reduce("sd", lambda d: np.std(d, ddof=1))
_reduce("mad", lambda d: 1.4826 * np.median(np.abs(d - np.median(d))))
# NaN != 0 is True in numpy, so all/any must NA-poison explicitly under
# na_rm=0 (matching the Max/MaxNa NA-poisoning convention above)
_reduce("all", lambda d: float("nan") if np.isnan(d).any() else float(np.all(d != 0)))
_reduce("any", lambda d: float("nan") if np.isnan(d).any() else float(np.any(d != 0)))


@prim("naCnt")
def na_cnt(env, args):
    fr = args[0].as_frame()
    counts = [float(c.na_count()) for c in fr.columns]
    return Val.num(counts[0]) if len(counts) == 1 else Val.nums(counts)


@prim("anyNA", "any.na")
def any_na(env, args):
    fr = args[0].as_frame()
    return Val.num(float(any(c.na_count() > 0 for c in fr.columns)))


def _cumop(name, fn):
    """Cumulative ops along rows (axis=0) or columns (axis=1)."""

    @prim(name)
    def op(env, args, fn=fn):
        fr = args[0].as_frame()
        axis = int(args[1].as_num()) if len(args) > 1 else 0
        mat = np.stack([numeric_data(c) for c in _numeric_cols(fr)], axis=1)
        out = fn(mat, axis=axis)
        cols = [
            Column(c.name, out[:, j], ColType.NUM)
            for j, c in enumerate(_numeric_cols(fr))
        ]
        return Val.frame(Frame(cols))

    return op


_cumop("cumsum", np.cumsum)
_cumop("cumprod", np.cumprod)
_cumop("cummax", np.maximum.accumulate)
_cumop("cummin", np.minimum.accumulate)


@prim("sumaxis")
def sumaxis(env, args):
    """(sumaxis fr na_rm axis) — axis=0 per-column sums as a 1-row frame,
    axis=1 per-row sums as a 1-col frame (AstSumAxis)."""
    fr = args[0].as_frame()
    na_rm = bool(args[1].as_num()) if len(args) > 1 else False
    axis = int(args[2].as_num()) if len(args) > 2 else 0
    cols = _numeric_cols(fr)
    mat = np.stack([numeric_data(c) for c in cols], axis=1)
    red = np.nansum if na_rm else np.sum
    with np.errstate(all="ignore"):
        if axis == 1:
            return Val.frame(Frame([Column("sum", red(mat, axis=1), ColType.NUM)]))
        sums = red(mat, axis=0)
    return Val.frame(
        Frame([Column(c.name, np.array([s]), ColType.NUM) for c, s in zip(cols, sums)])
    )


@prim("topn")
def topn(env, args):
    """(topn fr col_idx percent grab_top) -> 2-col frame [row_idx value]
    of the top/bottom nrows*percent% values (AstTopN)."""
    fr = args[0].as_frame()
    col = fr.col(int(args[1].as_num()))
    percent = args[2].as_num()
    grab_top = int(args[3].as_num()) if len(args) > 3 else 1
    d = numeric_data(col)
    valid = np.nonzero(~np.isnan(d))[0]
    k = max(1, int(len(d) * percent / 100.0))
    order = np.argsort(d[valid], kind="stable")
    picked = valid[order[::-1][:k]] if grab_top else valid[order[:k]]
    return Val.frame(
        Frame(
            [
                Column("Row Indices", picked.astype(np.float64), ColType.NUM),
                Column(col.name, d[picked], ColType.NUM),
            ]
        )
    )
