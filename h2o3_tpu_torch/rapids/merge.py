"""Sort and merge (join) — the port of ``h2o3_tpu/rapids/merge.py``.

Reference: ``water/rapids/RadixOrder.java`` + ``BinaryMerge.java`` +
``Merge.java`` — MSB radix partition, per-MSB single-threaded order, batched
binary merge of sorted key ranges; powers the ``sort`` and ``merge`` prims.

TPU-native: the MSB-partition/merge machinery existed to move key ranges
between JVMs; with host-canonical dense columns a single vectorized
``np.lexsort`` (radix-family, stable) is the same algorithm without the
shuffle.  Joins: factorize both sides' key tuples into one int64 code space,
sort the right side once, then ``searchsorted`` + run-length expansion —
a sort-merge join, exactly the reference's strategy.

At :data:`dist.DIST_SORT_MIN` rows and more the sort order and the join's
probe run on the device (``rapids/dist.py``). A failure there propagates:
the JAX package falls back to the host on any exception, and here no host
answer stands in for a failed device one. ``stable_argsort`` is numpy's
stable sort; the JAX package's native radix sort (``native/``, the same
order) waits for the native port (ROADMAP A11).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from h2o3_tpu_torch.device import DeviceLike
from h2o3_tpu_torch.frame.frame import Column, ColType, Frame, _merge_domains


def stable_argsort(keys: np.ndarray) -> np.ndarray:
    """Stable argsort (the order of the JAX package's native radix sort)."""
    return np.argsort(np.asarray(keys), kind="stable")


def lexsort(keys: Sequence[np.ndarray]) -> np.ndarray:
    """np.lexsort-compatible multi-key stable sort (last key primary),
    as successive stable radix passes — LSD over whole keys, exactly the
    composition RadixOrder.java applies byte-wise."""
    keys = [np.asarray(k) for k in keys]
    order = stable_argsort(keys[0])
    for k in keys[1:]:
        order = order[stable_argsort(k[order])]
    return order


def sort_frame(fr: Frame, by: Sequence[int], ascending: Optional[Sequence[bool]] = None,
               device: DeviceLike = None) -> Frame:
    """(sort fr [cols] [asc]) — stable multi-key sort; NAs sort first
    (reference Merge.sort: NA = -Inf in radix order).

    Large frames sort on ``device`` (``rapids/dist.py``, the
    RadixOrder.java:20 order); the host path below is the small-N path and
    the plain version the device is held to."""
    if ascending is None:
        ascending = [True] * len(by)
    keys = []
    for j, asc in zip(reversed(list(by)), reversed(list(ascending))):
        c = fr.col(j)
        if c.type in (ColType.STR, ColType.UUID):
            svals = np.asarray([("" if v is None else str(v)) for v in c.data])
            _, codes = np.unique(svals, return_inverse=True)
            k = codes.astype(np.float64)
        else:
            k = c.numeric_view().copy()
            k[np.isnan(k)] = -np.inf  # NAs first
        keys.append(k if asc else -k)
    order = _order_of(keys, fr.nrows, device)
    return fr.rows(order)


def _order_of(keys: Sequence[np.ndarray], nrows: int,
              device: DeviceLike = None) -> np.ndarray:
    """lexsort, on the device at the size threshold and above."""
    from h2o3_tpu_torch.rapids import dist

    if nrows >= dist.DIST_SORT_MIN:
        return dist.device_lexsort(
            [dist.encode_f64(np.asarray(k, np.float64)) for k in keys], device)
    return lexsort(keys)


def _encode_keys(
    left: Frame, right: Frame, by_left: Sequence[int], by_right: Sequence[int]
) -> Tuple[np.ndarray, np.ndarray]:
    """Factorize each key-column pair over the union of both sides, then mix
    the per-column codes into one int64 key per row."""
    lcodes, rcodes = np.zeros(left.nrows, dtype=np.int64), np.zeros(right.nrows, dtype=np.int64)
    for jl, jr in zip(by_left, by_right):
        cl, cr = left.col(jl), right.col(jr)
        if cl.type is ColType.CAT and cr.type is ColType.CAT:
            # align domains so equal levels get equal codes
            dom, rmap = _merge_domains(cl.domain, cr.domain)
            lv = cl.data.astype(np.int64)
            rv = np.where(cr.data >= 0, rmap[np.clip(cr.data, 0, None)], -1).astype(np.int64)
            card = len(dom) + 1
        else:
            lvals, rvals = cl.numeric_view(), cr.numeric_view()
            both = np.concatenate([lvals, rvals])
            finite = both[~np.isnan(both)]
            uniq = np.unique(finite)
            lv = np.where(np.isnan(lvals), -1, np.searchsorted(uniq, np.nan_to_num(lvals))).astype(np.int64)
            rv = np.where(np.isnan(rvals), -1, np.searchsorted(uniq, np.nan_to_num(rvals))).astype(np.int64)
            card = len(uniq) + 1
        # overflow guard: the mixed-radix encoding must stay within int64 or
        # unrelated key tuples would silently collide
        max_prior = max(int(lcodes.max(initial=0)), int(rcodes.max(initial=0)))
        if max_prior > (2**62) // card:
            raise ValueError(
                "merge: combined key cardinality exceeds int64 encoding range; "
                "reduce the number/cardinality of join columns"
            )
        lcodes = lcodes * card + (lv + 1)
        rcodes = rcodes * card + (rv + 1)
    return lcodes, rcodes


def merge_frames(
    left: Frame,
    right: Frame,
    by_left: Sequence[int],
    by_right: Sequence[int],
    all_left: bool = False,
    all_right: bool = False,
    device: DeviceLike = None,
) -> Frame:
    """Sort-merge join (rapids ``merge``; Merge.java semantics):
    inner by default; all_left/all_right add unmatched rows with NAs.
    Output columns: join keys (left naming), then left non-key, right non-key.
    Large joins sort and probe on ``device``."""
    lk, rk = _encode_keys(left, right, by_left, by_right)
    from h2o3_tpu_torch.rapids import dist

    if max(left.nrows, right.nrows) >= dist.DIST_SORT_MIN:
        # on the device: stable sort of the build side and the probe
        # (RadixOrder + BinaryMerge); the codes are non-negative int64, so
        # the uint64 cast keeps their order
        r_order = dist.device_argsort_u64(rk.astype(np.uint64), device)
        rk_sorted = rk[r_order]
        lo, hi = dist.device_searchsorted_both(
            rk_sorted.astype(np.uint64), lk.astype(np.uint64), device)
    else:
        r_order = stable_argsort(rk)
        srt = rk[r_order]
        lo = np.searchsorted(srt, lk, side="left")
        hi = np.searchsorted(srt, lk, side="right")
    counts = hi - lo
    matched = counts > 0

    # inner part: expand each left row by its match count
    l_idx = np.repeat(np.arange(left.nrows), np.where(matched, counts, 0))
    offs = np.concatenate([[0], np.cumsum(np.where(matched, counts, 0))])[:-1]
    within = np.arange(len(l_idx)) - np.repeat(offs, np.where(matched, counts, 0))
    r_idx = r_order[np.repeat(lo, np.where(matched, counts, 0)) + within]

    if all_left:
        un_l = np.nonzero(~matched)[0]
        l_idx = np.concatenate([l_idx, un_l])
        r_idx = np.concatenate([r_idx, np.full(len(un_l), -1, dtype=np.int64)])
    if all_right:
        r_matched = np.zeros(right.nrows, dtype=bool)
        r_matched[np.unique(r_idx[r_idx >= 0])] = True
        un_r = np.nonzero(~r_matched)[0]
        l_idx = np.concatenate([l_idx, np.full(len(un_r), -1, dtype=np.int64)])
        r_idx = np.concatenate([r_idx, un_r])

    def take(col: Column, idx: np.ndarray) -> Column:
        miss = idx < 0
        safe = np.clip(idx, 0, None)
        if col.type is ColType.CAT:
            data = np.where(miss, -1, col.data[safe]).astype(np.int32)
            return Column(col.name, data, ColType.CAT, col.domain)
        if col.type in (ColType.STR, ColType.UUID):
            data = col.data[safe].copy()
            data[miss] = None
            return Column(col.name, data, col.type)
        data = np.where(miss, np.nan, col.data[safe])
        return Column(col.name, data, col.type)

    out_cols: List[Column] = []
    taken = set()
    for pos, (jl, jr) in enumerate(zip(by_left, by_right)):
        # key column: prefer left values, fill from right for all_right rows
        lc, rc = take(left.col(jl), l_idx), take(right.col(jr), r_idx)
        if left.col(jl).type is ColType.CAT and right.col(jr).type is ColType.CAT:
            dom, rmap = _merge_domains(left.col(jl).domain, right.col(jr).domain)
            lcd = lc.data
            rcd = np.where(rc.data >= 0, rmap[np.clip(rc.data, 0, None)], -1).astype(np.int32)
            data = np.where(l_idx >= 0, lcd, rcd).astype(np.int32)
            out_cols.append(Column(lc.name, data, ColType.CAT, dom))
        elif lc.type in (ColType.STR, ColType.UUID):
            data = np.where(l_idx >= 0, lc.data, rc.data)
            out_cols.append(Column(lc.name, data.astype(object), lc.type))
        else:
            data = np.where(l_idx >= 0, lc.data, rc.data)
            out_cols.append(Column(lc.name, data, lc.type))
        taken.add(lc.name)
    for j, c in enumerate(left.columns):
        if j in list(by_left):
            continue
        cc = take(c, l_idx)
        out_cols.append(cc)
        taken.add(cc.name)
    for j, c in enumerate(right.columns):
        if j in list(by_right):
            continue
        cc = take(c, r_idx)
        name, k = cc.name, 0
        while name in taken:
            name = f"{cc.name}_{k}"
            k += 1
        cc.name = name
        taken.add(name)
        out_cols.append(cc)
    return Frame(out_cols)
