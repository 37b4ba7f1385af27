"""Gradient histograms — the port of ``h2o3_tpu/ops/histogram.py``.

- ``make_bins`` (:113) is copied verbatim and runs on the host in numpy.
  ``apply_bins_device`` makes the bin codes on the fit's device, feature-major
  ([F, N] int32), bit for bit the codes of ``apply_bins`` (:178), which is
  kept verbatim as its reference. The NA code is ``nbins`` (256 at
  XGBoost's default), so codes are int32.
- ``pad_nodes`` (:70-89): the node-count ladder 8/64/512.
- ``build_histogram`` is the dispatch, as ``pallas_histogram.py:475-476,
  494-512`` keys it off the padded node count (``histogram.py:398-402``):
  with the kernels, a level whose padded node count K satisfies K·4 <=
  ``fact_max_kc`` goes to the factorized kernel
  (``ops/cuda_factorized_histogram.hist_factorized``; ``fact_max_kc`` is 0
  by default, as the JAX package's ``H2O3_TPU_HIST_FACT_MAX_KC``) where its
  slab fits, else one with K·4 <= 512 to the node-matmul kernel
  (``ops/cuda_histogram.hist_nodematmul``), a wider one to the sorted
  per-node kernel (``ops/cuda_sorted_histogram.hist_sorted``); the plain
  version (``hist_nodematmul_reference``, the ``index_add_`` twin of
  ``_shard_histogram`` :254) builds every level when asked for. Its
  ``dtype`` (``"f32"`` or ``"bf16"``, the operand mode of
  ``_resolve_hist_dtype``, ``pallas_histogram.py:438``) goes to whichever
  version builds the level.
- ``FitCache`` holds what a fit's levels share: the feature-major codes and
  the sorted kernel's row-major copy of them, made at the first level that
  needs it. The device frame cache keeps it, so later fits on the same
  frame share it too.
- ``node_totals`` (:280): the terminal level's per-node totals, a scatter
  (``index_add_``) as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from h2o3_tpu_torch.ops.cuda_build import check_hist_dtype
from h2o3_tpu_torch.ops.cuda_factorized_histogram import (
    fits as factorized_fits,
    hist_factorized,
)
from h2o3_tpu_torch.ops.cuda_histogram import (
    hist_nodematmul,
    hist_nodematmul_reference,
)
from h2o3_tpu_torch.ops.cuda_sorted_histogram import hist_sorted, row_major_codes

#: the node-capacity ladder (``_DEFAULT_NODE_BUCKETS``)
NODE_BUCKETS: Tuple[int, ...] = (8, 64, 512)

#: channels per node of the TPU kernel's contraction (Σg, Σh, Σw, pad)
_C = 4
#: the TPU node-matmul kernel serves padded K·_C up to this, the sorted
#: kernel every wider level; so do this port's kernels
_NODE_MATMUL_MAX_KC = 512

#: histogram implementations: the hand-written kernel, or the plain version
HIST_IMPLS = ("kernel", "plain")


def pad_nodes(n_nodes: int) -> int:
    """Smallest ladder bucket >= ``n_nodes`` (identity above the ladder)."""
    for b in NODE_BUCKETS:
        if n_nodes <= b:
            return b
    return n_nodes


# ---------------------------------------------------------------------------
# quantile binning (GlobalQuantilesCalc / XGBoost sketch analogue), verbatim


def make_bins(
    X: np.ndarray, nbins: int = 256, sample: int = 200_000, seed: int = 0
) -> np.ndarray:
    """Per-feature bin edges from (sampled) quantiles. Returns [F, nbins-1]
    interior edges; value -> bin = searchsorted(edges, v, 'right')."""
    n, F = X.shape
    if n > sample:
        idx = np.random.default_rng(seed).choice(n, sample, replace=False)
        Xs = X[idx]
    else:
        Xs = X
    qs = np.linspace(0, 1, nbins + 1)[1:-1]
    edges = np.empty((F, nbins - 1), dtype=np.float64)
    for f in range(F):
        col = Xs[:, f]
        col = col[~np.isnan(col)]
        if col.size == 0:
            edges[f] = np.arange(nbins - 1, dtype=np.float64)
            continue
        distinct = np.unique(col)
        if len(distinct) <= nbins:
            # low-cardinality (incl. one-hot indicators): exact midpoint
            # edges give every distinct value its own bin — data quantiles
            # would collapse rare values (e.g. a 3%-frequency indicator)
            # into their neighbor's bin and make them unsplittable
            mids = (distinct[:-1] + distinct[1:]) / 2.0
            e = np.full(nbins - 1, np.inf)  # inf pad: never <= any value
            e[: len(mids)] = mids
            edges[f] = e
            continue
        e = np.quantile(col, qs)
        # de-duplicate while keeping monotonicity (constant-ish features)
        e = np.maximum.accumulate(e)
        edges[f] = e
    return edges


def _apply_bins_batched(X: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """Vectorized per-row searchsorted (no Python loop over features).

    One stable argsort of the per-feature ``[edges | values]`` concatenation
    ranks every value against its own feature's edges in a single batched
    pass: with edges FIRST and the sort stable, an equal edge sorts before
    the value, so the running edge count at a value's sorted position is
    exactly ``searchsorted(edges[f], x, side="right")`` — float64-exact
    (ties, ±inf and NaN-last included). Row chunks bound the workspace.
    """
    n, F = X.shape
    E = edges.shape[1]
    out = np.empty((n, F), dtype=np.int32)
    rows = np.arange(F)[:, None]
    chunk = max(1, 4_000_000 // max(F, 1))
    for s in range(0, n, chunk):
        xb = X[s:s + chunk].T  # [F, m]
        comb = np.concatenate([edges, xb], axis=1)  # [F, E+m]
        order = np.argsort(comb, axis=1, kind="stable")
        is_val = order >= E
        edges_before = np.cumsum(~is_val, axis=1)  # edges at/before position
        blk = np.empty(xb.shape, dtype=np.int32)
        blk[np.broadcast_to(rows, order.shape)[is_val],
            order[is_val] - E] = edges_before[is_val]
        out[s:s + chunk] = blk.T
    return out


def apply_bins(X: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """Quantize raw features to bin codes [N, F] int8-range; NA -> nbins.

    Implementation is measurement-dispatched (single-core CPU numbers, see
    PR notes): for tall matrices — the booster shape, e.g. 1M x 28 — the
    per-feature ``np.searchsorted`` loop IS the fastest exact kernel
    (binary search over L1-resident edges beats every batched formulation:
    argsort ~0.7x, pooled-rank ~0.6x, broadcast-count ~0.3x, grid-bucketed
    ~0.7x, jnp/f32 ~0.7x AND inexact), while for wide-short matrices the
    per-call overhead of F tiny searchsorteds dominates and the batched
    argsort path wins (n=8, F=5000: ~1.8x). Both paths are bit-exact
    against the per-feature formulation.

    In this package it is the reference that ``apply_bins_device`` is held
    to, and no fit or scoring pass calls it: they bin on their device, and
    a repeat fit on an unmutated frame takes its codes resident from the
    device frame cache (``frame/devcache.py``).
    """
    X = np.asarray(X)
    n, F = X.shape
    nbins = edges.shape[1] + 1
    if n == 0 or F == 0:
        return np.empty((n, F), dtype=np.int32)
    if F > 32 * max(n, 1):  # wide-short: loop overhead dominates
        out = _apply_bins_batched(X, edges)
    else:
        out = np.empty((n, F), dtype=np.int32)
        for f in range(F):
            out[:, f] = np.searchsorted(edges[f], X[:, f], side="right")
    out[np.isnan(X)] = nbins  # NA bucket (DHistogram NA bin at end)
    return out


#: values searched per ``torch.searchsorted`` call of ``apply_bins_device``
#: (a float64 workspace of 256 MiB)
_BIN_BLOCK_VALUES = 1 << 25


def apply_bins_device(X: np.ndarray, edges: np.ndarray, device) -> torch.Tensor:
    """``apply_bins(X, edges).T`` made on ``device``: bin codes [F, N] int32,
    feature-major, bit for bit the host function's codes.

    X [N, F] goes to the device as it is and is transposed there. Values
    are widened to float64 before they are searched, as numpy's
    ``searchsorted`` promotes float32 values to the float64 edges' type (a
    float32 search would move codes at values next to an edge): code =
    the number of edges <= the value (``right=True``), so +inf gives
    ``nbins - 1`` even against the +inf edges that pad a low-cardinality
    column, -inf gives 0 and -0.0 equals a 0.0 edge. NaN gives ``nbins``
    by an explicit ``where``. Row blocks bound the float64 workspace."""
    dev = torch.device(device)
    n, F = X.shape
    out = torch.empty((F, n), dtype=torch.int32, device=dev)
    if n == 0 or F == 0:
        return out
    nbins = edges.shape[1] + 1
    x = torch.from_numpy(np.ascontiguousarray(X)).to(dev)
    e = torch.from_numpy(np.ascontiguousarray(edges, dtype=np.float64)).to(dev)
    block = max(1, _BIN_BLOCK_VALUES // F)
    for s in range(0, n, block):
        xb = torch.empty((F, min(block, n - s)), dtype=torch.float64, device=dev)
        xb.copy_(x[s:s + block].T)
        codes = torch.searchsorted(e, xb, right=True, out_int32=True)
        out[:, s:s + block] = torch.where(torch.isnan(xb), nbins, codes)
    return out


# ---------------------------------------------------------------------------
# histograms


def default_hist_impl(device: torch.device) -> str:
    """The kernel on the card, the plain version on the CPU."""
    return "kernel" if device.type == "cuda" else "plain"


class FitCache:
    """What a fit's levels share, for ``build_histogram``: the fit's
    feature-major codes ``bins_fm`` and their row-major copy
    (``cuda_sorted_histogram.row_major_codes``) that the sorted kernel's
    gather reads. The copy is made once, at the first level that goes to
    the sorted kernel, and only on the card: on the CPU that level takes
    the plain version, which reads ``bins_fm``.

    The device frame cache keeps a fit's ``FitCache`` (its tensors are
    ``arrays``), so later fits on the same frame and binning share both
    tensors; ``on_grow``, when set, is told the bytes of the copy when it
    is made (the cache's ``grow_entry`` for the entry)."""

    def __init__(self, bins_fm: torch.Tensor, n_bins1: int,
                 on_grow: Optional[Callable[[int], None]] = None):
        self.bins_fm = bins_fm
        self._n_bins1 = n_bins1
        self._codes_rm: Optional[torch.Tensor] = None
        self.on_grow = on_grow

    @property
    def arrays(self) -> Dict[str, Optional[torch.Tensor]]:
        return {"bins_fm": self.bins_fm, "codes_rm": self._codes_rm}

    def codes_rm(self) -> Optional[torch.Tensor]:
        """The copy (made at the first call), or None on the CPU."""
        if self.bins_fm.device.type == "cpu":
            return None
        if self._codes_rm is None:
            self._codes_rm = row_major_codes(self.bins_fm, self._n_bins1)
            if self.on_grow is not None:
                self.on_grow(self._codes_rm.nbytes)
        return self._codes_rm


def build_histogram(
    bins_fm: torch.Tensor, nodes: torch.Tensor, g: torch.Tensor,
    h: torch.Tensor, n_nodes: int, n_bins1: int,
    rw: Optional[torch.Tensor] = None, impl: Optional[str] = None,
    fact_max_kc: int = 0, cache: Optional[FitCache] = None, dtype: str = "f32",
) -> torch.Tensor:
    """Histogram [n_nodes, F, n_bins1, 3] float32 of (Σg, Σh, Σw).

    bins_fm: [F, N] int32 feature-major bin codes; nodes: [N] int32 (-1 =
    inactive row); g, h: [N] float32; rw: optional [N] count weight
    (weights_column: the count channel reports Σw). impl: "kernel" (the
    default on cuda) or "plain" (the default on cpu); a CPU tensor always
    takes the plain version. fact_max_kc: with the kernels, levels whose
    padded node count K satisfies K·4 <= fact_max_kc take the factorized
    kernel (0, the default, sends none) when its slab fits shared memory,
    else the node-matmul kernel, which sums each cell in the same order and
    so gives the same bits. cache: the fit's ``FitCache`` (made for this
    ``bins_fm``); only a level that goes to the sorted kernel reads it, and
    without it that kernel makes its own copy of the codes. dtype: the
    operand mode, ``"f32"`` or ``"bf16"`` (g, h and rw rounded to bf16 and
    summed in float, counts exact: the JAX package's default on its own
    chip); any other value raises ValueError. The JAX package's scatter
    impl ignores the dtype (``ops/histogram.py:403-404``), but ``"plain"``
    here honours it, because in the port the plain version stands for the
    kernels.

    The JAX package pads the node count up the ladder so one compiled plan
    serves a bucket; here nothing is compiled per shape, so every version
    builds the real node count (the kernels' results do not depend on it).
    The padded count still decides which kernel a level takes, as it
    decides which TPU kernel the JAX package runs."""
    impl = impl or default_hist_impl(bins_fm.device)
    if impl not in HIST_IMPLS:
        raise ValueError(f"hist impl must be one of {HIST_IMPLS}, got {impl!r}")
    check_hist_dtype(dtype)
    args = (bins_fm, nodes, g, h, n_nodes, n_bins1)
    if impl == "plain":
        return hist_nodematmul_reference(*args, rw=rw, dtype=dtype)
    kc = pad_nodes(n_nodes) * _C
    if kc <= fact_max_kc and factorized_fits(n_nodes, n_bins1):
        return hist_factorized(*args, rw=rw, dtype=dtype)
    if kc > _NODE_MATMUL_MAX_KC:
        return hist_sorted(*args, rw=rw, dtype=dtype,
                           codes_rm=None if cache is None else cache.codes_rm())
    return hist_nodematmul(*args, rw=rw, dtype=dtype)


def node_totals(
    nodes: torch.Tensor, g: torch.Tensor, h: torch.Tensor, n_nodes: int,
    rw: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-node (Σg, Σh, Σw) [K, 3] float32 — one masked ``index_add_`` per
    channel, in float64 (the terminal level needs only these totals). It
    has no operand mode: the JAX package's ``node_totals_sharded`` (:304)
    sums the values unrounded in either mode."""
    valid = nodes >= 0
    node = torch.where(valid, nodes, 0).long()
    w = valid.double()
    cw = w if rw is None else w * rw.double()
    chans = [
        torch.zeros(n_nodes, dtype=torch.float64, device=nodes.device)
        .index_add_(0, node, v)
        for v in (g.double() * w, h.double() * w, cw)
    ]
    return torch.stack(chans, dim=1).float()
