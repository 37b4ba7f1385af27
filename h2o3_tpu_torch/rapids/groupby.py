"""Group-by aggregation engine — the port of ``h2o3_tpu/rapids/groupby.py``.

Reference: ``water/rapids/ast/prims/mungers/AstGroup.java`` — distributed
group-by computing aggregates {nrow, mean, sum, min, max, sd, var, mode,
median, first, last} per group with per-agg NA handling (all/rm/ignore).

TPU-native: groups are materialized with a single lexicographic sort of the
group-key codes (np.lexsort ≡ the reference's radix-order pass), then each
aggregate is one segmented reduction over the sorted runs — the same
sort-then-segment shape a device implementation uses (jax.ops.segment_*);
host numpy keeps it allocation-light for the munging path.

At :data:`dist.DIST_SORT_MIN` rows and more, {nrow, mean, sum, min, max,
sd, var} with NAs removed aggregate on the device (``_group_by_device``).
Whether the device path serves a call is decided before it runs (the row
count, the aggregates, a composite key that would overflow int64); once it
runs, a failure propagates, where the JAX package falls back to the host on
any exception.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from h2o3_tpu_torch.device import DeviceLike
from h2o3_tpu_torch.frame.frame import Column, ColType, Frame
from h2o3_tpu_torch.rapids.merge import lexsort

AGGS = ("nrow", "mean", "sum", "min", "max", "sd", "var", "mode", "median", "first", "last")


def group_keys(fr: Frame, by: Sequence[int]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Return (sorted_order, group_starts, group_ids_sorted): rows lexsorted
    by the key columns, run boundaries marking each distinct key."""
    keys = []
    for j in by:
        c = fr.col(j)
        if c.type is ColType.CAT:
            keys.append(c.data.astype(np.int64))
        elif c.type in (ColType.STR, ColType.UUID):
            _, codes = np.unique(np.asarray([("" if v is None else str(v)) for v in c.data]), return_inverse=True)
            keys.append(codes.astype(np.int64))
        else:
            # factorize numeric values (NaN -> own group at the end)
            d = c.data
            uniq, codes = np.unique(d[~np.isnan(d)], return_inverse=True)
            full = np.full(len(d), len(uniq), dtype=np.int64)
            full[~np.isnan(d)] = codes
            keys.append(full)
    order = lexsort(list(reversed(keys)))
    stacked = np.stack([k[order] for k in keys], axis=1)
    change = np.any(stacked[1:] != stacked[:-1], axis=1)
    starts = np.concatenate([[0], np.nonzero(change)[0] + 1])
    return order, starts, stacked


def _segment_apply(vals: np.ndarray, starts: np.ndarray, fn, na: str) -> np.ndarray:
    out = np.empty(len(starts), dtype=np.float64)
    bounds = np.append(starts, len(vals))
    for g in range(len(starts)):
        seg = vals[bounds[g] : bounds[g + 1]]
        if na == "rm":
            seg = seg[~np.isnan(seg)]
        out[g] = fn(seg) if len(seg) else np.nan
    return out


def _agg_fn(name: str):
    if name == "nrow":
        return len
    if name == "mean":
        return np.mean
    if name == "sum":
        return np.sum
    if name == "min":
        return np.min
    if name == "max":
        return np.max
    if name == "sd":
        return lambda s: np.std(s, ddof=1) if len(s) > 1 else np.nan
    if name == "var":
        return lambda s: np.var(s, ddof=1) if len(s) > 1 else np.nan
    if name == "median":
        return np.median
    if name == "first":
        return lambda s: s[0]
    if name == "last":
        return lambda s: s[-1]
    if name == "mode":
        def mode(s):
            if not len(s):
                return np.nan
            v, c = np.unique(s[~np.isnan(s)], return_counts=True)
            return v[np.argmax(c)] if len(v) else np.nan
        return mode
    raise ValueError(f"unknown aggregate {name!r}")


#: aggregates the device segment-reduction path covers (order statistics
#: like mode/median stay host-side)
_DEVICE_AGGS = {"nrow", "mean", "sum", "min", "max", "sd", "var"}


def _group_by_device(
    fr: Frame, by: Sequence[int], aggs: Sequence[Tuple[str, int, str]],
    device: DeviceLike = None,
) -> Optional[Frame]:
    """Device path: factorize the key tuple host-side (one pass), then every
    aggregate is a segment reduction on ``device``
    (``dist.device_group_aggregate``, AstGroup's reduction). Covers {nrow,
    mean, sum, min, max, sd, var} with NA removal; for anything else, or a
    composite key past int64, it declines (None) before it runs, and the
    host engine serves the call."""
    from h2o3_tpu_torch.rapids import dist

    if fr.nrows < dist.DIST_SORT_MIN:
        return None
    if not all(
        a in _DEVICE_AGGS and (na == "rm" or a == "nrow")
        for a, _j, na in aggs
    ):
        return None
    # composite key code, first column most significant — so sorted
    # composites enumerate groups in the host engine's exact order
    keys = []
    for j in by:
        c = fr.col(j)
        if c.type is ColType.CAT:
            keys.append((c.data.astype(np.int64), len(c.domain) + 1))
        elif c.type in (ColType.STR, ColType.UUID):
            _, codes = np.unique(np.asarray(
                [("" if v is None else str(v)) for v in c.data]),
                return_inverse=True)
            keys.append((codes.astype(np.int64), int(codes.max()) + 2))
        else:
            d = c.data
            uniq, codes = np.unique(d[~np.isnan(d)], return_inverse=True)
            full = np.full(len(d), len(uniq), dtype=np.int64)
            full[~np.isnan(d)] = codes
            keys.append((full, len(uniq) + 2))
    comp = np.zeros(fr.nrows, dtype=np.int64)
    for k, card in keys:
        if int(comp.max(initial=0)) > (2**62) // card:
            return None  # composite would overflow: host path
        comp = comp * card + (k + 1)
    uniq_codes, first_rows, inv = np.unique(
        comp, return_index=True, return_inverse=True)
    G = len(uniq_codes)
    inv = inv.astype(np.int32)

    out_cols: List[Column] = []
    for j in by:
        c = fr.col(j)
        out_cols.append(Column(c.name, c.data[first_rows], c.type, c.domain))
    cache: dict = {}
    for agg_name, j, na in aggs:
        if agg_name == "nrow" and (na != "rm" or j < 0):
            cnt = np.bincount(inv, minlength=G).astype(np.float64)
            out_cols.append(Column("nrow", cnt, ColType.NUM))
            continue
        col = fr.col(j)
        if j not in cache:
            vals = col.numeric_view()
            # center before the values are rounded to f32: shifts cancel
            # in var and are added back to sum/mean exactly once, and the
            # conditioning of sumsq improves by orders of magnitude
            with np.errstate(all="ignore"):
                shift = float(np.nanmean(vals)) if len(vals) else 0.0
            if np.isnan(shift):
                shift = 0.0
            agg = dist.device_group_aggregate(inv, vals - shift, G, device)
            cache[j] = (agg, shift)
        agg, shift = cache[j]
        n, s = agg["count"], agg["sum"]
        if agg_name == "nrow":
            res = n
        elif agg_name == "sum":
            # empty post-rm segment is NA, matching the host oracle
            res = np.where(n > 0, s + n * shift, np.nan)
        elif agg_name == "mean":
            res = np.where(n > 0, s / np.maximum(n, 1) + shift, np.nan)
        elif agg_name == "min":
            res = np.where(n > 0, agg["min"] + shift, np.nan)
        elif agg_name == "max":
            res = np.where(n > 0, agg["max"] + shift, np.nan)
        else:  # sd / var on centered moments
            var = np.where(
                n > 1,
                (agg["sumsq"] - s * s / np.maximum(n, 1)) / np.maximum(n - 1, 1),
                np.nan,
            )
            var = np.maximum(var, 0.0)
            res = np.sqrt(var) if agg_name == "sd" else var
        # the host engine names every nrow aggregate plain "nrow"
        name = "nrow" if agg_name == "nrow" else f"{agg_name}_{col.name}"
        base, k2 = name, 1
        while any(c.name == name for c in out_cols):
            name = f"{base}_{k2}"
            k2 += 1
        out_cols.append(Column(name, np.asarray(res, np.float64), ColType.NUM))
    return Frame(out_cols)


def group_by(
    fr: Frame,
    by: Sequence[int],
    aggs: Sequence[Tuple[str, int, str]],
    device: DeviceLike = None,
) -> Frame:
    """aggs: list of (agg_name, col_idx, na_handling) with na in all|rm|ignore.
    Output: one row per group — key columns then one column per aggregate,
    named ``{agg}_{col}`` (matches reference output naming).

    Large frames aggregate on ``device`` (segment reduction,
    ``rapids/dist.py``); the host engine below is the small-N path, the
    order-statistics (mode/median) path, and the plain version the device
    is held to."""
    dev = _group_by_device(fr, by, aggs, device)
    if dev is not None:
        return dev
    order, starts, stacked = group_keys(fr, by)
    bounds = np.append(starts, fr.nrows)
    out_cols: List[Column] = []
    for i, j in enumerate(by):
        c = fr.col(j)
        first_rows = order[starts]
        out_cols.append(Column(c.name, c.data[first_rows], c.type, c.domain))
    for agg_name, j, na in aggs:
        if agg_name == "nrow":
            if na == "rm" and j >= 0:
                vals = fr.col(j).numeric_view()[order]
                cnt = _segment_apply(vals, starts, len, "rm")
                cnt = np.nan_to_num(cnt, nan=0.0)  # a count is 0, never NA
            else:
                cnt = (bounds[1:] - bounds[:-1]).astype(np.float64)
            out_cols.append(Column("nrow", cnt, ColType.NUM))
            continue
        col = fr.col(j)
        vals = col.numeric_view()[order]
        res = _segment_apply(vals, starts, _agg_fn(agg_name), na)
        name = f"{agg_name}_{col.name}"
        base, k = name, 1
        while any(c.name == name for c in out_cols):
            name = f"{base}_{k}"
            k += 1
        if agg_name in ("mode", "first", "last") and col.type is ColType.CAT:
            codes = np.where(np.isnan(res), -1, res).astype(np.int32)
            out_cols.append(Column(name, codes, ColType.CAT, col.domain))
        else:
            out_cols.append(Column(name, res, ColType.NUM))
    return Frame(out_cols)


def rank_within_group_by(
    fr: Frame, by: Sequence[int], sort_cols: Sequence[int], ascending: Sequence[bool],
    new_col: str,
) -> Frame:
    """AstRankWithinGroupBy: dense rank of rows within each group under the
    given sort order; NAs get NaN rank."""
    order, starts, _ = group_keys(fr, by)
    bounds = np.append(starts, fr.nrows)
    rank = np.full(fr.nrows, np.nan)
    sort_vals = [fr.col(j).numeric_view() for j in sort_cols]
    for g in range(len(starts)):
        rows = order[bounds[g] : bounds[g + 1]]
        keys = []
        valid = np.ones(len(rows), dtype=bool)
        for v, asc in zip(reversed(sort_vals), reversed(list(ascending))):
            vv = v[rows]
            valid &= ~np.isnan(vv)
            keys.append(vv if asc else -vv)
        rows_v = rows[valid]
        if not len(rows_v):
            continue
        sub = lexsort([k[valid] for k in keys])
        rank[rows_v[sub]] = np.arange(1, len(rows_v) + 1, dtype=np.float64)
    out = fr.add_column(Column(new_col, rank, ColType.NUM))
    return out
