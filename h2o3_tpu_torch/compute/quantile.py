"""Quantiles by iterative histogram refinement — the port of
``h2o3_tpu/compute/quantile.py``.

Reference: ``hex/quantile/Quantile.java``: build a histogram over the
current [lo, hi] range, find the bin holding the target rank, zoom into
that bin, repeat until exact.

On the device each refinement round is one pass over the column: the
in-range mask, the bin index and an integer ``index_add_`` of the counts
(exact, so the card and the CPU count alike). The round's 1,024 counts come
back to the host, which picks the bin and narrows [lo, hi] in the column's
own dtype (numpy scalars of float32 or float64), so the zoom follows the
JAX package's arithmetic step for step and stops on the same rule: the bin
narrower than the floating-point resolution of its ends, one row left in
it, or 64 rounds. Each rank zooms on its own, as each lane of the JAX
package's ``vmap`` does. The rank arithmetic and the interpolation run on
the host in float64, exact for any row count.

The JAX package runs with 64-bit types off, so a float64 numpy column
reaches its kernel as float32; here a tensor keeps its dtype, float32 or
float64, and a numpy array becomes a tensor of its own dtype.

``sketch_column`` and ``merge_edges`` (the mergeable per-partition sketches
of the distributed booster) are host numpy, copied.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from h2o3_tpu_torch.device import DeviceLike, resolve_device

_NBINS = 1024
_MAX_ITERS = 64  # safety bound; the zoom stops on bin convergence first


def _order_stats_kernel(x: torch.Tensor, mask: torch.Tensor, ranks: np.ndarray,
                        nbins: int = _NBINS) -> np.ndarray:
    """Exact order statistics at integer ``ranks`` via the histogram zoom,
    returned in ``x``'s dtype as numpy."""
    dt = np.float32 if x.dtype == torch.float32 else np.float64
    ok = mask & ~torch.isnan(x)
    inf = torch.tensor(float("inf"), dtype=x.dtype, device=x.device)
    gmin = dt(torch.where(ok, x, inf).min().item())
    gmax = dt(torch.where(ok, x, -inf).max().item())
    eps = dt(1e-7 if dt is np.float32 else 1e-15)
    tiny = dt(1e-30)
    zeros = torch.zeros(nbins, dtype=torch.int64, device=x.device)
    out = np.empty(len(ranks), dtype=dt)
    for r, rank in enumerate(np.asarray(ranks, dtype=np.int64)):
        lo, hi, cnt, it = gmin, gmax, 2, 0
        while True:
            width = dt(hi - lo)
            converged = width <= dt(eps * max(max(abs(lo), abs(hi)), tiny))
            if not (cnt > 1 and not converged and it < _MAX_ITERS):
                break
            span = max(width, tiny)
            in_range = ok & (x >= float(lo)) & (x <= float(hi))
            # lo and span as device tensors: PyTorch divides a CUDA tensor
            # by a host scalar as a product with its reciprocal, which need
            # not round as the division does
            lo_t, span_t = torch.tensor([lo, span], dtype=x.dtype).to(x.device).unbind()
            t = torch.where(in_range, (x - lo_t) / span_t * nbins, 0.0)
            idx = t.to(torch.int32).clamp_(0, nbins - 1)
            hist = zeros.clone().index_add_(0, idx, in_range.to(torch.int64))
            below = (ok & (x < float(lo))).sum()
            host = torch.cat([hist, below.reshape(1)]).cpu().numpy()
            hist_h, below_h = host[:nbins], int(host[nbins])
            cum = below_h + np.concatenate([[0], np.cumsum(hist_h)[:-1]])
            b = int(np.clip(np.searchsorted(cum, rank, side="right") - 1, 0, nbins - 1))
            lo, hi = (dt(lo + dt(dt(b) * span / dt(nbins))),
                      dt(lo + dt(dt(b + 1) * span / dt(nbins))))
            cnt = int(hist_h[b])
            it += 1
        # the exact order statistic inside the converged sliver
        out[r] = dt(torch.where(ok & (x >= float(lo)), x, inf).min().item())
    return out


def quantiles(x, probs: Sequence[float], mask: Optional[torch.Tensor] = None,
              device: DeviceLike = None) -> np.ndarray:
    """Quantiles (linear interpolation, R type 7, the reference default) of
    a column; NaNs ignored. ``x`` is a tensor (its device is used) or a
    numpy array (placed on ``device``)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x)).to(resolve_device(device))
    if mask is None:
        mask = torch.ones(x.shape, dtype=torch.bool, device=x.device)
    p = np.asarray(probs, dtype=np.float64)
    n = int((mask & ~torch.isnan(x)).sum().item())
    if n == 0:
        return np.full(len(p), np.nan)
    # float64 rank arithmetic on the host: exact for any row count
    ranks = p * (n - 1)
    rlo = np.floor(ranks).astype(np.int32)
    rhi = np.minimum(rlo + 1, n - 1).astype(np.int32)
    frac = ranks - rlo
    vals = _order_stats_kernel(x, mask, np.concatenate([rlo, rhi])).astype(np.float64)
    v_lo, v_hi = vals[: len(p)], vals[len(p):]
    return v_lo + frac * (v_hi - v_lo)


# ---------------------------------------------------------------------------
# mergeable per-partition sketches (GlobalQuantilesCalc over chunk homes)


def sketch_column(col: np.ndarray, nbins: int, grid: int = 8) -> dict:
    """One partition's summary of a feature column (NaNs ignored):
    ``{"n", "uniques"}`` when at most ``nbins`` distinct values exist,
    else ``{"n", "q"}`` with a ``grid * nbins + 1``-point quantile grid."""
    valid = col[~np.isnan(col)]
    n = int(valid.size)
    if n == 0:
        return {"n": 0}
    uniq = np.unique(valid.astype(np.float64))
    if uniq.size <= nbins:
        return {"n": n, "uniques": uniq}
    q = np.quantile(valid.astype(np.float64),
                    np.linspace(0.0, 1.0, grid * nbins + 1))
    return {"n": n, "q": q}


def merge_edges(parts, nbins: int) -> np.ndarray:
    """Global interior bin edges [nbins-1] from per-partition sketches.

    Low-cardinality columns (every partial exact, union still <= nbins)
    get exact midpoint edges with +inf padding, the low-card rule of
    ``ops.histogram.make_bins``. Otherwise the pooled, count-weighted
    sketch points answer the interior quantile targets."""
    parts = [p for p in parts if p.get("n", 0) > 0]
    if not parts:
        return np.arange(nbins - 1, dtype=np.float64)
    if all("uniques" in p for p in parts):
        uniq = np.unique(np.concatenate([p["uniques"] for p in parts]))
        if uniq.size <= nbins:
            mids = (uniq[:-1] + uniq[1:]) / 2.0
            e = np.full(nbins - 1, np.inf)
            e[: mids.size] = mids
            return e
    pts_l, wts_l = [], []
    for p in parts:
        arr = np.asarray(p.get("q", p.get("uniques")), np.float64)
        pts_l.append(arr)
        wts_l.append(np.full(arr.size, p["n"] / arr.size, np.float64))
    pts = np.concatenate(pts_l)
    wts = np.concatenate(wts_l)
    order = np.argsort(pts, kind="stable")
    pts, wts = pts[order], wts[order]
    cw = np.cumsum(wts)
    qs = np.linspace(0.0, 1.0, nbins + 1)[1:-1]
    idx = np.searchsorted(cw, qs * cw[-1], side="left")
    e = pts[np.clip(idx, 0, pts.size - 1)]
    return np.maximum.accumulate(e)
