"""Device sort, searchsorted and group-by aggregation — the port of
``h2o3_tpu/rapids/dist.py``.

Reference: ``water/rapids/RadixOrder.java:20,74-85`` (radix partition of
keys across the cluster, per-partition local order), ``BinaryMerge.java``
(merges of sorted key ranges) and ``AstGroup``'s distributed reduction.

With a process group live (``parallel/mesh.py``) the JAX package's sample
sort runs over the ranks (``_sample_sort``, from ``dist.py:90-137``):

1. each rank sorts its range of the padded rows locally, the row id the
   last key (a stable sort of rows in id order);
2. evenly spaced samples of every rank's sorted keys are gathered;
3. D - 1 splitters are chosen from them;
4. one ``all_to_all`` moves bucket d of every rank (capacity S each, the
   rest sentinels) to rank d;
5. each rank merges the D runs it received with one more stable sort.

Equal keys go to one rank, and runs arrive in source order, which is row
id order, so the order equals the one-device stable sort bit for bit. With
no group the one-device sort is one stable sort of the whole key column,
the same order. Keys are the JAX package's order-preserving uint64 images
of float64 (``encode_f64``); torch sorts int64, so each key is moved into
int64 order by flipping its top bit, an order-preserving map. Multi-column
sorts compose LSD-style, each pass stable on the previous pass's order,
exactly like the host ``lexsort``. ``searchsorted`` probes a replicated
table with each rank's range of the queries and gathers the answers.

Group-by aggregation is a segment reduction: each rank's rows are stably
sorted by group code on the device and each group's values are reduced in
row order by ``segment_reduce``. The values are rounded to float32 first,
as the JAX package's device lanes hold them, so min and max are float32;
the sums accumulate in float64 with no float atomics, so two calls give
the same bits; counts are exact integers. Over a group, counts add
exactly, sums and sums of squares by the mesh's float64 merge in rank
order, and min and max by ``pmin``/``pmax``.

The host paths in ``merge.py``/``groupby.py`` are the small-N path below
:data:`DIST_SORT_MIN` rows and the plain version the device is held to.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from h2o3_tpu_torch.device import DeviceLike, resolve_device
from h2o3_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather,
    all_gather_rows,
    all_to_all,
    default_mesh,
    local_rows,
    pmax,
    pmin,
    psum,
    row_mask,
)

#: below this many rows the host numpy paths win on latency (tests lower it)
DIST_SORT_MIN = 262_144

_TOP_BIT = np.uint64(1) << np.uint64(63)
#: the key of pad rows and empty send slots: sorts after every key
_SENT = np.uint64(0xFFFFFFFFFFFFFFFF)


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


def _sample_sort(keys: np.ndarray, dev: torch.device, mesh: Mesh) -> np.ndarray:
    """The stable order of uint64 ``keys`` by the sample sort over ``mesh``
    (every rank gets the whole order)."""
    n = len(keys)
    D = mesh.size
    lo, _, S = mesh.rows(n)
    k = _to_device_i64(local_rows(keys, mesh, _SENT), dev)
    idx = torch.where(row_mask(n, S * D, mesh, dev),
                      torch.arange(lo, lo + S, dtype=torch.int64, device=dev), -1)
    # 1. local sort; rows are in id order, so a stable sort breaks ties by id
    order = torch.sort(k, stable=True).indices
    k, idx = k[order], idx[order]
    # 2-3. splitters from evenly spaced samples of every rank's sorted keys
    n_samples = max(1, min(64, S))
    pos = (torch.arange(n_samples, device=dev) * S) // n_samples
    samples = torch.sort(torch.cat(all_gather(k[pos], mesh))).values
    cut = (torch.arange(1, D, device=dev) * (D * n_samples)) // D
    splitters = samples[cut]
    # destination: the count of splitters below the key (equal keys meet)
    dest = torch.searchsorted(splitters, k)
    counts = torch.bincount(dest, minlength=D)
    starts = torch.cumsum(counts, 0) - counts
    within = torch.arange(S, device=dev) - starts[dest]
    send = torch.empty((D, S, 2), dtype=torch.int64, device=dev)
    send[..., 0] = torch.iinfo(torch.int64).max  # _SENT in int64 order
    send[..., 1] = -1
    send[dest, within, 0] = k
    send[dest, within, 1] = idx
    # 4. bucket d of every rank to rank d, in source-rank (= row id) order
    got = all_to_all(send.reshape(D * S, 2), mesh)
    # 5. merge the runs: a stable sort keeps (key, source, position) order
    merged = got[torch.sort(got[:, 0], stable=True).indices, 1]
    full = torch.cat(all_gather(merged, mesh))
    return full[full >= 0].cpu().numpy()


def _argsort_keys(keys: Sequence[np.ndarray], dev: torch.device,
                  mesh: Mesh) -> np.ndarray:
    """LSD stable sort over uint64 key columns (last key primary, as
    ``np.lexsort``): the row order, by the sample sort over a live mesh or
    by one stable device sort."""
    if mesh.live:
        order = _sample_sort(keys[0], dev, mesh)
        for k in keys[1:]:
            order = order[_sample_sort(k[order], dev, mesh)]
        return order
    order = torch.sort(_to_device_i64(keys[0], dev), stable=True).indices
    for k in keys[1:]:
        sub = torch.sort(_to_device_i64(k, dev)[order], stable=True).indices
        order = order[sub]
    return order.cpu().numpy()


def device_argsort_u64(keys: np.ndarray, device: DeviceLike = None) -> np.ndarray:
    """Stable argsort of uint64 keys on the device, ties by row id (over
    the data mesh when a process group is live)."""
    dev = resolve_device(device)
    return _argsort_keys([np.asarray(keys, dtype=np.uint64)], dev, default_mesh())


def device_lexsort(keys: Sequence[np.ndarray], device: DeviceLike = None) -> np.ndarray:
    """``np.lexsort``-compatible (last key primary) order of uint64 key
    columns: LSD passes of the stable device sort."""
    dev = resolve_device(device)
    return _argsort_keys([np.asarray(k, dtype=np.uint64) for k in keys], dev,
                         default_mesh())


# ---------------------------------------------------------------------------
# searchsorted (the probe side of the sort-merge join)


def _probe(sorted_keys: np.ndarray, queries: np.ndarray, sides: Sequence[bool],
           device: DeviceLike) -> np.ndarray:
    """[len(sides), Q] insertion points of the queries (right side where a
    side is True): the table replicated, each rank probing its range of
    the queries, the answers gathered in query order."""
    dev = resolve_device(device)
    mesh = default_mesh()
    table = _to_device_i64(sorted_keys, dev)
    q = _to_device_i64(local_rows(np.asarray(queries, np.uint64), mesh), dev)
    out = torch.stack([torch.searchsorted(table, q, right=r) for r in sides], 1)
    return all_gather_rows(out, len(queries), mesh).T.cpu().numpy().astype(np.int64)


def device_searchsorted(sorted_keys: np.ndarray, queries: np.ndarray,
                        side: str = "left", device: DeviceLike = None) -> np.ndarray:
    """``np.searchsorted(sorted_keys, queries, side)`` of uint64 keys,
    probed on the device."""
    return _probe(sorted_keys, queries, (side == "right",), device)[0]


def device_searchsorted_both(sorted_keys: np.ndarray, queries: np.ndarray,
                             device: DeviceLike = None) -> Tuple[np.ndarray, np.ndarray]:
    """(left, right) insertion points, the table and queries placed once."""
    both = _probe(sorted_keys, queries, (False, True), device)
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
    within each group (each rank's rows, the ranks' sums then merged in
    rank order over the data mesh); count is exact."""
    dev = resolve_device(device)
    mesh = default_mesh()
    codes = np.asarray(codes, np.int64)
    values = np.asarray(values, np.float64)
    nan_in = np.isnan(values)
    c = torch.from_numpy(np.ascontiguousarray(local_rows(codes, mesh))).to(dev)
    v32 = torch.from_numpy(np.ascontiguousarray(
        local_rows(np.nan_to_num(values).astype(np.float32), mesh))).to(dev)
    # pad rows count as NA here; nacnt below counts the real NAs only
    valid = ~torch.from_numpy(np.ascontiguousarray(local_rows(nan_in, mesh, True))).to(dev)
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
    parts = (psum(lengths, mesh), psum(s, mesh), psum(s2, mesh), pmin(mn, mesh),
             pmax(mx, mesh))
    host = [t.cpu().numpy() for t in parts]
    na_counts = np.bincount(codes[nan_in], minlength=num_groups).astype(np.float64)
    return {
        "count": host[0].astype(np.float64),
        "sum": host[1],
        "sumsq": host[2],
        "min": host[3].astype(np.float64),
        "max": host[4].astype(np.float64),
        "nacnt": na_counts,
    }
