"""Device sort, searchsorted and group-by aggregation — the port of
``h2o3_tpu/rapids/dist.py`` on one device.

Reference: ``water/rapids/RadixOrder.java:20,74-85`` (radix partition of
keys across the cluster, per-partition local order), ``BinaryMerge.java``
(merges of sorted key ranges) and ``AstGroup``'s distributed reduction.

The JAX package sorts with a sample sort over its mesh: each shard sorts
locally, splitters come from gathered samples, one ``all_to_all`` exchanges
the rows and a last local sort merges them; ties break on the row id. On
one device that is one stable sort of the whole key column, which gives the
same order (the exchange comes with multi-GPU, ROADMAP A12). Keys are the
JAX package's order-preserving uint64 images of float64 (``encode_f64``);
torch sorts int64, so each key is moved into int64 order by flipping its
top bit, an order-preserving map. Multi-column sorts compose LSD-style,
each pass stable on the previous pass's order, exactly like the host
``lexsort``.

Group-by aggregation is a segment reduction: the rows are stably sorted by
group code on the device and each group's values are reduced in row order
by ``segment_reduce``. The values are rounded to float32 first, as the JAX
package's device lanes hold them, so min and max are float32; the sums
accumulate in float64 with no float atomics, so two calls give the same
bits; counts are exact integers.

The host paths in ``merge.py``/``groupby.py`` are the small-N path below
:data:`DIST_SORT_MIN` rows and the plain version the device is held to.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from h2o3_tpu_torch.device import DeviceLike, resolve_device

#: below this many rows the host numpy paths win on latency (tests lower it)
DIST_SORT_MIN = 262_144

_TOP_BIT = np.uint64(1) << np.uint64(63)


# ---------------------------------------------------------------------------
# key encoding: float64 / int codes -> order-preserving uint64 -> (hi, lo)


def encode_f64(x: np.ndarray, ascending: bool = True,
               na_first: bool = True) -> np.ndarray:
    """Order-preserving uint64 image of float64 (the radix key transform,
    RadixOrder's byte-order trick): flip sign bit for positives, all bits
    for negatives; NaN pinned to the low (or high) end."""
    x = np.ascontiguousarray(x, dtype=np.float64)
    x = x + 0.0  # canonicalize -0.0 == +0.0, matching the host oracle
    u = x.view(np.uint64).copy()
    neg = (u >> np.uint64(63)) != 0
    u[neg] = ~u[neg]
    u[~neg] |= np.uint64(1) << np.uint64(63)
    if not ascending:
        u = ~u
    nan = np.isnan(x)
    # reserve the extreme values for NA so it sorts first (Merge.sort
    # semantics: NA = -Inf) regardless of direction
    u[nan] = np.uint64(0) if na_first else np.uint64(0xFFFFFFFFFFFFFFFE)
    return u


def split_u64(u: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    return ((u >> np.uint64(32)).astype(np.uint32),
            (u & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def _to_device_i64(u: np.ndarray, dev: torch.device) -> torch.Tensor:
    """uint64 keys as int64 in the same order (top bit flipped), on ``dev``."""
    s = (np.ascontiguousarray(u, dtype=np.uint64) ^ _TOP_BIT).view(np.int64)
    return torch.from_numpy(s).to(dev)


# ---------------------------------------------------------------------------
# stable device argsort (the sample sort's order at one device)


def _argsort_keys(keys: Sequence[np.ndarray], dev: torch.device) -> torch.Tensor:
    """LSD stable sort over uint64 key columns (last key primary, as
    ``np.lexsort``), on the device; the row order as an int64 tensor."""
    order = torch.sort(_to_device_i64(keys[0], dev), stable=True).indices
    for k in keys[1:]:
        sub = torch.sort(_to_device_i64(k, dev)[order], stable=True).indices
        order = order[sub]
    return order


def device_argsort_u64(keys: np.ndarray, device: DeviceLike = None) -> np.ndarray:
    """Stable argsort of uint64 keys on the device, ties by row id."""
    dev = resolve_device(device)
    return _argsort_keys([np.asarray(keys, dtype=np.uint64)], dev).cpu().numpy()


def device_lexsort(keys: Sequence[np.ndarray], device: DeviceLike = None) -> np.ndarray:
    """``np.lexsort``-compatible (last key primary) order of uint64 key
    columns: LSD passes of the stable device sort."""
    dev = resolve_device(device)
    return _argsort_keys([np.asarray(k, dtype=np.uint64) for k in keys],
                         dev).cpu().numpy()


# ---------------------------------------------------------------------------
# searchsorted (the probe side of the sort-merge join)


def device_searchsorted(sorted_keys: np.ndarray, queries: np.ndarray,
                        side: str = "left", device: DeviceLike = None) -> np.ndarray:
    """``np.searchsorted(sorted_keys, queries, side)`` of uint64 keys,
    probed on the device."""
    dev = resolve_device(device)
    table = _to_device_i64(sorted_keys, dev)
    out = torch.searchsorted(table, _to_device_i64(queries, dev), right=side == "right")
    return out.cpu().numpy().astype(np.int64)


def device_searchsorted_both(sorted_keys: np.ndarray, queries: np.ndarray,
                             device: DeviceLike = None) -> Tuple[np.ndarray, np.ndarray]:
    """(left, right) insertion points, the table and queries placed once."""
    dev = resolve_device(device)
    table = _to_device_i64(sorted_keys, dev)
    q = _to_device_i64(queries, dev)
    lo = torch.searchsorted(table, q)
    hi = torch.searchsorted(table, q, right=True)
    both = torch.stack([lo, hi]).cpu().numpy().astype(np.int64)
    return both[0], both[1]


# ---------------------------------------------------------------------------
# group-by aggregation (segment reduction)


def device_group_aggregate(
    codes: np.ndarray, values: np.ndarray, num_groups: int,
    device: DeviceLike = None,
) -> Dict[str, np.ndarray]:
    """Per-group {count, sum, sumsq, min, max, nacnt} of one value column.
    NaN values count into nacnt and are left out of the moments (AstGroup
    ignore-NA aggregation). Each value is rounded to float32, as the JAX
    package's device lanes hold it; min and max are those float32 values,
    sum and sumsq add them (and their squares) in float64 in row order
    within each group; count is exact."""
    dev = resolve_device(device)
    codes = np.asarray(codes, np.int64)
    values = np.asarray(values, np.float64)
    nan_in = np.isnan(values)
    c = torch.from_numpy(codes).to(dev)
    v32 = torch.from_numpy(np.nan_to_num(values).astype(np.float32)).to(dev)
    valid = ~torch.from_numpy(nan_in).to(dev)
    # the valid rows in group order, each group in row order
    c_ok, v_ok = c[valid], v32[valid]
    order = torch.sort(c_ok, stable=True).indices
    v_sorted = v_ok[order]
    lengths = torch.bincount(c_ok, minlength=num_groups)
    v64 = v_sorted.to(torch.float64)
    s = torch.segment_reduce(v64, "sum", lengths=lengths, initial=0.0)
    s2 = torch.segment_reduce(v64 * v64, "sum", lengths=lengths, initial=0.0)
    mn = torch.segment_reduce(v_sorted, "min", lengths=lengths, initial=float("inf"))
    mx = torch.segment_reduce(v_sorted, "max", lengths=lengths, initial=float("-inf"))
    host = [t.cpu().numpy() for t in (lengths, s, s2, mn, mx)]
    na_counts = np.bincount(codes[nan_in], minlength=num_groups).astype(np.float64)
    return {
        "count": host[0].astype(np.float64),
        "sum": host[1],
        "sumsq": host[2],
        "min": host[3].astype(np.float64),
        "max": host[4].astype(np.float64),
        "nacnt": na_counts,
    }
