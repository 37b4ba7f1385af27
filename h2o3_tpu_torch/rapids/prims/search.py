"""Rapids search prims (4) — the port of ``h2o3_tpu/rapids/prims/search.py``
(copied, host numpy).

Reference: ``water/rapids/ast/prims/search/`` — Match Which WhichMax WhichMin.
"""

from __future__ import annotations

import numpy as np

from h2o3_tpu_torch.frame.frame import Column, ColType, Frame
from h2o3_tpu_torch.rapids.prims import prim
from h2o3_tpu_torch.rapids.prims.util import numeric_data
from h2o3_tpu_torch.rapids.runtime import RapidsError, Val


@prim("match")
def match(env, args):
    """(match fr table nomatch start_index) — positions of values in table
    (AstMatch; R match semantics, 1-based by default via start_index)."""
    fr = args[0].as_frame()
    table = args[1]
    nomatch = args[2].as_num() if len(args) > 2 else float("nan")
    start = int(args[3].as_num()) if len(args) > 3 else 1
    c = fr.col(0)
    if table.kind in (Val.STRS, Val.STR):
        tab = table.as_strs()
        index = {}
        for i, v in enumerate(tab):  # R match: FIRST occurrence wins
            index.setdefault(v, i + start)
        if c.type is ColType.CAT:
            dom_map = np.array(
                [index.get(d, np.nan) for d in c.domain] + [np.nan], dtype=np.float64
            )
            out = dom_map[np.where(c.data >= 0, c.data, len(c.domain))]
        elif c.type in (ColType.STR, ColType.UUID):
            out = np.array([index.get(v, np.nan) if v is not None else np.nan for v in c.data])
        else:
            raise RapidsError("match: string table against numeric column")
    else:
        tab = table.as_nums()
        index = {}
        for i, v in enumerate(tab):
            index.setdefault(v, i + start)
        d = numeric_data(c)
        out = np.array([index.get(v, np.nan) for v in d])
    out = np.where(np.isnan(out), nomatch, out)
    return Val.frame(Frame([Column(c.name, out, ColType.NUM)]))


@prim("which")
def which(env, args):
    """(which fr) — row numbers where the (boolean) column is nonzero."""
    fr = args[0].as_frame()
    d = numeric_data(fr.col(0))
    idx = np.nonzero(~np.isnan(d) & (d != 0))[0].astype(np.float64)
    return Val.frame(Frame([Column("which", idx, ColType.NUM)]))


def _which_extreme(env, args, arg_fn, name):
    fr = args[0].as_frame()
    na_rm = bool(args[1].as_num()) if len(args) > 1 else True
    axis = int(args[2].as_num()) if len(args) > 2 else 0
    mat = np.stack([numeric_data(c) for c in fr.columns], axis=1)
    with np.errstate(all="ignore"):
        if axis == 0:
            out = np.array(
                [
                    np.nan
                    if np.all(np.isnan(mat[:, j]))
                    else float(arg_fn(np.nan_to_num(mat[:, j], nan=-np.inf if name == "max" else np.inf)))
                    for j in range(mat.shape[1])
                ]
            )
            return Val.frame(Frame([Column(c.name, np.array([out[j]]), ColType.NUM) for j, c in enumerate(fr.columns)]))
        filled = np.nan_to_num(mat, nan=-np.inf if name == "max" else np.inf)
        out = arg_fn(filled, axis=1).astype(np.float64)
        all_na = np.all(np.isnan(mat), axis=1)
        out[all_na] = np.nan
        return Val.frame(Frame([Column(f"which.{name}", out, ColType.NUM)]))


@prim("which.max")
def which_max(env, args):
    return _which_extreme(env, args, np.argmax, "max")


@prim("which.min")
def which_min(env, args):
    return _which_extreme(env, args, np.argmin, "min")
