"""RollupStats — the port of ``h2o3_tpu/frame/rollups.py``.

Reference: ``water/fvec/RollupStats.java`` computes min/max/mean/sigma/NA
count/isInt plus a histogram in one pass on first use and caches the result
under a rollup key; any mutation invalidates it.

Columns are host-canonical float64 numpy, and rollups must be
float64-exact (TIME columns hold epoch-milliseconds ~1.6e12; float32 would
be off by tens of seconds), so the pass runs in numpy on the host where the
data lives, as in the JAX package. Cached on the Column object and
invalidated by ``Column.invalidate_rollups()``.

``_weighted_moments`` and ``_dense_moments`` are the per-chunk moment
helpers of the JAX package's codec-aware rollups; ``payload_rollups``, which
merges them over encoded chunk payloads, needs the chunk codecs
(``frame/codecs.py``) and is not part of this package yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from h2o3_tpu_torch.frame.frame import ColType, Column


@dataclass
class RollupStats:
    min: float
    max: float
    mean: float
    sigma: float
    na_count: int
    zero_count: int
    is_int: bool
    histogram: Optional[np.ndarray] = None  # lazy, via histogram()
    checksum: float = 0.0


def compute_rollups(col: Column) -> RollupStats:
    if col.type in (ColType.STR, ColType.UUID):
        na = col.na_count()
        return RollupStats(np.nan, np.nan, np.nan, np.nan, na, 0, False)
    x = col.numeric_view()
    if x.size == 0:
        return RollupStats(np.nan, np.nan, np.nan, np.nan, 0, 0, True)
    ok = ~np.isnan(x)
    n = int(ok.sum())
    if n == 0:
        return RollupStats(np.nan, np.nan, np.nan, np.nan, x.size, 0, True)
    v = x[ok]
    return RollupStats(
        float(v.min()),
        float(v.max()),
        float(v.mean()),
        float(v.std(ddof=1)) if n > 1 else 0.0,
        x.size - n,
        int((v == 0).sum()),
        bool(np.all(np.floor(v) == v)),
        checksum=float(v.sum()),
    )


def _weighted_moments(
    vals: np.ndarray, counts: np.ndarray
) -> Tuple[int, int, int, float, float, float, float, bool]:
    """Moments of a value table with multiplicities (affine/dict codecs):
    (n_valid, na, zero, mn, mx, mean, m2, is_int)."""
    vals = np.asarray(vals, dtype=np.float64)
    counts = np.asarray(counts, dtype=np.int64)
    ok = ~np.isnan(vals)
    na = int(counts[~ok].sum())
    v, c = vals[ok], counts[ok]
    live = c > 0
    v, c = v[live], c[live]
    n = int(c.sum())
    if n == 0:
        return 0, na, 0, np.nan, np.nan, np.nan, 0.0, True
    mean = float((v * c).sum() / n)
    m2 = float((c * (v - mean) ** 2).sum())
    return (n, na, int(c[v == 0].sum()), float(v.min()), float(v.max()),
            mean, m2, bool(np.all(np.floor(v) == v)))


def _dense_moments(
    x: np.ndarray,
) -> Tuple[int, int, int, float, float, float, float, bool]:
    ok = ~np.isnan(x)
    n = int(ok.sum())
    if n == 0:
        return 0, int(x.size), 0, np.nan, np.nan, np.nan, 0.0, True
    v = np.asarray(x[ok], dtype=np.float64)
    mean = float(v.mean())
    return (n, int(x.size - n), int((v == 0).sum()), float(v.min()),
            float(v.max()), mean, float(((v - mean) ** 2).sum()),
            bool(np.all(np.floor(v) == v)))


def histogram(col: Column, nbins: int = 64) -> np.ndarray:
    """Fixed-width histogram over [min, max] (RollupStats lazy histogram)."""
    r = col.rollups
    x = col.numeric_view()
    ok = ~np.isnan(x)
    if not np.any(ok) or not np.isfinite(r.min):
        return np.zeros(nbins, dtype=np.int64)
    span = max(r.max - r.min, 1e-300)
    idx = np.clip(((x[ok] - r.min) / span * nbins).astype(np.int64), 0, nbins - 1)
    return np.bincount(idx, minlength=nbins)
