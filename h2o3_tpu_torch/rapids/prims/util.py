"""Shared helpers for rapids primitives (the port of
``h2o3_tpu/rapids/prims/util.py``, copied): columnwise application and
broadcasting.

Mirrors the reference's ``AstBinOp.prim_apply`` family (frame-frame,
frame-scalar, scalar-frame, row broadcasting) and ``AstUniOp`` columnwise
numeric application.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Union

import numpy as np

from h2o3_tpu_torch.frame.frame import Column, ColType, Frame
from h2o3_tpu_torch.rapids.runtime import RapidsError, Val


def numeric_data(col: Column) -> np.ndarray:
    """float64 data with NaN NAs; CAT columns expose their codes
    (matches reference semantics: arithmetic on categoricals uses codes,
    e.g. == comparisons against level indices)."""
    if col.type is ColType.CAT:
        out = col.data.astype(np.float64)
        out[col.data < 0] = np.nan
        return out
    if col.type in (ColType.STR, ColType.UUID):
        raise RapidsError(f"column {col.name!r} is a string column; op needs numeric")
    return col.data


def map_columns(fr: Frame, fn: Callable[[np.ndarray], np.ndarray]) -> Frame:
    """Apply a numeric elementwise fn to every column (AstUniOp over frame)."""
    cols = []
    for c in fr.columns:
        with np.errstate(all="ignore"):
            cols.append(Column(c.name, fn(numeric_data(c)), ColType.NUM))
    return Frame(cols)


def binop_frame(
    lhs: Val, rhs: Val, fn: Callable[[np.ndarray, np.ndarray], np.ndarray], name: str
) -> Val:
    """Generic binary op with H2O's broadcasting rules (AstBinOp):
    frame⊕frame columnwise (or single-column broadcast), frame⊕scalar,
    scalar⊕frame; scalar⊕scalar folds to a number."""
    with np.errstate(all="ignore"):
        if lhs.is_frame() and rhs.is_frame():
            lf, rf = lhs.value, rhs.value
            if lf.nrows != rf.nrows and 1 not in (lf.nrows, rf.nrows):
                raise RapidsError(
                    f"{name}: row mismatch {lf.nrows} vs {rf.nrows}"
                )
            if lf.ncols == rf.ncols:
                pairs = zip(lf.columns, rf.columns)
            elif rf.ncols == 1:
                pairs = ((a, rf.col(0)) for a in lf.columns)
            elif lf.ncols == 1:
                pairs = ((lf.col(0), b) for b in rf.columns)
            else:
                raise RapidsError(f"{name}: column mismatch {lf.ncols} vs {rf.ncols}")
            out = [
                Column(a.name, fn(numeric_data(a), numeric_data(b)), ColType.NUM)
                for a, b in pairs
            ]
            return Val.frame(Frame(out))
        if lhs.is_frame():
            r = rhs.as_num()
            return Val.frame(
                Frame(
                    [
                        Column(c.name, fn(numeric_data(c), r), ColType.NUM)
                        for c in lhs.value.columns
                    ]
                )
            )
        if rhs.is_frame():
            l = lhs.as_num()
            return Val.frame(
                Frame(
                    [
                        Column(c.name, fn(l, numeric_data(c)), ColType.NUM)
                        for c in rhs.value.columns
                    ]
                )
            )
        return Val.num(float(fn(np.float64(lhs.as_num()), np.float64(rhs.as_num()))))


def col_indices(fr: Frame, sel: Val) -> List[int]:
    """Resolve a column selector Val (num, nums, str, strs) to indices
    (AstColSlice / AstColPySlice semantics; negative = from-end python style)."""
    if sel.kind == Val.STR:
        return [fr.names.index(sel.value)]
    if sel.kind == Val.STRS:
        return [fr.names.index(s) for s in sel.value]
    idx = sel.as_nums().astype(np.int64)
    out = []
    for i in idx:
        j = int(i)
        if j < 0:
            j += fr.ncols
        if not 0 <= j < fr.ncols:
            raise RapidsError(f"column index {int(i)} out of range for {fr.ncols} cols")
        out.append(j)
    return out


def row_indices(fr: Frame, sel: Val) -> np.ndarray:
    """Resolve a row selector: nums = indices; single-col frame = bool mask
    or index list (AstRowSlice)."""
    if sel.is_frame():
        c = sel.value.col(0)
        vals = numeric_data(c)
        if sel.value.nrows == fr.nrows and np.all(np.isin(vals[~np.isnan(vals)], (0.0, 1.0))):
            return np.nonzero(vals == 1.0)[0]
        return vals[~np.isnan(vals)].astype(np.int64)
    idx = sel.as_nums().astype(np.int64)
    idx = np.where(idx < 0, idx + fr.nrows, idx)
    return idx


def single_column(v: Val, op: str) -> Column:
    fr = v.as_frame()
    if fr.ncols != 1:
        raise RapidsError(f"{op}: expected a single-column frame, got {fr.ncols} cols")
    return fr.col(0)


def const_frame(name: str, value: float, nrows: int) -> Frame:
    return Frame([Column(name, np.full(nrows, value), ColType.NUM)])
