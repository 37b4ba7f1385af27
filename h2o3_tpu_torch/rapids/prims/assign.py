"""Rapids assignment prims — the port of ``h2o3_tpu/rapids/prims/assign.py``
(copied, host numpy).

Reference: ``water/rapids/ast/prims/assign/`` — Append Assign RectangleAssign
Rm TmpAssign (+RecAsgnHelper).  ``tmp=`` and ``=`` are special forms handled
by the evaluator (``rapids/runtime.py``); the rest live here.
"""

from __future__ import annotations

import numpy as np

from h2o3_tpu_torch.frame.frame import Column, ColType, Frame, NA_CAT
from h2o3_tpu_torch.rapids.prims import prim
from h2o3_tpu_torch.rapids.prims.util import col_indices, numeric_data, row_indices
from h2o3_tpu_torch.rapids.runtime import RapidsError, Val


@prim("append")
def append(env, args):
    """(append fr col name) — add/replace a column (AstAppend)."""
    fr = args[0].as_frame()
    src = args[1]
    name = args[2].as_str()
    if src.is_frame():
        c = src.value.col(0).copy()
        if len(c) == 1 and fr.nrows > 1:
            c = Column(name, np.repeat(c.data, fr.nrows), c.type, c.domain)
    else:
        c = Column(name, np.full(max(fr.nrows, 1), src.as_num()), ColType.NUM)
    c.name = name
    return Val.frame(fr.add_column(c))


@prim("rm")
def rm(env, args):
    """(rm key) — delete from the session/DKV (AstRm)."""
    key = args[0].as_str() if args[0].is_str() else None
    if key is None and args[0].is_frame():
        key = args[0].value.key
    if key:
        env.session.remove(key)
    return Val.num(0)


@prim(":=")
def rectangle_assign(env, args):
    """(:= dst src [col_idxs] [row_idxs]) — rectangle assign into a copy of
    dst (AstRecAsgn; rapids frames are immutable-by-copy here, the reference
    does copy-on-write at the chunk level). The JAX package assigns into a
    chunk-homed frame on its homes first; that path waits for the cluster
    port (ROADMAP A10)."""
    dst = args[0].as_frame()
    src = args[1]
    cidx = col_indices(dst, args[2])
    rsel = args[3]
    all_rows = rsel.is_num() and np.isnan(rsel.as_num())
    ridx = np.arange(dst.nrows) if all_rows else row_indices(dst, rsel)
    out_cols = [c.copy() for c in dst.columns]
    for k, j in enumerate(cidx):
        c = out_cols[j]
        if src.is_frame():
            s = src.value.col(k if src.value.ncols > 1 else 0)
            svals = s.data if len(s.data) != 1 else np.repeat(s.data, len(ridx))
            if c.type is ColType.CAT and s.type is ColType.CAT:
                if c.domain == s.domain:
                    c.data[ridx] = svals
                else:
                    remap = {lv: i for i, lv in enumerate(c.domain)}
                    mapped = np.array(
                        [remap.get(s.domain[v], NA_CAT) if v >= 0 else NA_CAT for v in svals],
                        dtype=np.int32,
                    )
                    c.data[ridx] = mapped
            elif c.type in (ColType.STR, ColType.UUID):
                c.data[ridx] = svals
            else:
                out_cols[j] = Column(c.name, _assign_num(c, ridx, np.asarray(svals, dtype=np.float64)), ColType.NUM)
        elif src.is_str():
            if c.type is ColType.CAT:
                s = src.as_str()
                if s not in c.domain:
                    c.domain = c.domain + [s]
                c.data[ridx] = c.domain.index(s)
            elif c.type in (ColType.STR, ColType.UUID):
                c.data[ridx] = src.as_str()
            else:
                raise RapidsError("cannot assign string into numeric column")
        else:
            v = src.as_num()
            if c.type is ColType.CAT:
                c.data[ridx] = NA_CAT if np.isnan(v) else np.int32(v)
            else:
                out_cols[j] = Column(c.name, _assign_num(c, ridx, v), ColType.NUM)
        out_cols[j].invalidate_rollups()
    return Val.frame(Frame(out_cols))


def _assign_num(c: Column, ridx, vals) -> np.ndarray:
    d = numeric_data(c).copy()
    d[ridx] = vals
    return d
