"""The histogram GBDT booster — the port of ``h2o3_tpu/models/tree/booster.py``.

Shared by GBM and XGBoost. The design is the JAX package's, written as
eager PyTorch on one device:

* global quantile binning once per fit (``ops/histogram.make_bins`` on the
  host), then the bin codes are made on the device once
  (``apply_bins_device``), feature-major ([F, N] int32), which is the
  layout the histogram kernel reads and the row router gathers from; with
  a ``cache_token`` they are kept in the device frame cache
  (``frame/devcache.py``), so a later fit on the same unmutated frame and
  binning reuses them;
* a tree grows level by level with a fixed node capacity 2^d per level;
  each level builds one histogram for all its nodes (on the card: a
  hand-written kernel, node-matmul up to 64 padded nodes, sorted per-node
  beyond, and factorized for the levels ``hist_fact_max_kc`` sends to it),
  searches the best split per node and routes rows.
  g/h, the row -> node assignment and the margin stay on the device and no
  level waits for the host; the tree arrays of a block of rounds come back
  to the host once, at the end of the block;
* histogram subtraction (build the smaller sibling, derive the larger from
  the parent) is an explicit argument: on by default on the card, off on
  the CPU — the same defaults as the JAX package on the TPU and on the CPU;
* so is the histograms' operand mode (``hist_dtype``): float32 by default,
  or bf16, the JAX package's default on its own chip;
* row sampling (``sample_rate``), per-tree column sampling
  (``col_sample_rate_per_tree``) and per-node feature sampling (``mtries``)
  draw from the JAX package's random streams (``util/jrandom.py``), keyed
  by the absolute tree index, so a seeded fit samples what the JAX
  package samples, on any device, and a fit continued from a checkpoint
  draws what one longer fit draws;
* monotone constraints carry per-node leaf-value bounds down the levels.

Not part of this package yet, each raising ``NotImplementedError``: the
custom objective (ROADMAP A11) and chunk-homed distributed training
(ROADMAP A10).
"""

from __future__ import annotations

import functools
import hashlib
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from h2o3_tpu_torch.device import resolve_device
from h2o3_tpu_torch.frame import devcache
from h2o3_tpu_torch.ops.histogram import (
    HIST_IMPLS,
    FitCache,
    apply_bins_device,
    build_histogram,
    check_hist_dtype,
    default_hist_impl,
    make_bins,
    node_totals,
)
from h2o3_tpu_torch.util import jrandom

#: boosting rounds whose tree arrays come back to the host together when no
#: monitor is active
DEFAULT_TREE_BLOCK = 16


@dataclass(frozen=True)
class TreeParams:
    ntrees: int = 50
    max_depth: int = 6
    learn_rate: float = 0.1
    nbins: int = 256
    min_rows: float = 1.0
    min_split_improvement: float = 1e-5
    reg_lambda: float = 1.0  # L2 on leaf values (xgboost lambda; GBM uses 0)
    reg_alpha: float = 0.0  # L1 on leaf values
    gamma: float = 0.0  # min loss reduction (xgboost gamma)
    sample_rate: float = 1.0  # row subsample per tree
    col_sample_rate_per_tree: float = 1.0
    mtries: int = -1  # features per split; -1 = all
    seed: int = 42


class Trees:
    """Heap-layout tree arrays. Node i's children are 2i+1 / 2i+2.

    Per tree: feat[M] int32, split_bin[M] int32, default_left[M] bool,
    is_split[M] bool, leaf[M] f32 (learn-rate scaled), with
    M = 2^(max_depth+1)-1, kept as host numpy arrays."""

    def __init__(self, max_depth: int, n_bins1: int, edges: np.ndarray):
        self.max_depth = max_depth
        self.n_bins1 = n_bins1
        self.edges = edges  # [F, B-1] for re-binning at predict time
        self.feat: List[np.ndarray] = []
        self.split_bin: List[np.ndarray] = []
        self.default_left: List[np.ndarray] = []
        self.is_split: List[np.ndarray] = []
        self.leaf: List[np.ndarray] = []

    def append(self, feat, split_bin, default_left, is_split, leaf) -> None:
        self.feat.append(np.asarray(feat))
        self.split_bin.append(np.asarray(split_bin))
        self.default_left.append(np.asarray(default_left))
        self.is_split.append(np.asarray(is_split))
        self.leaf.append(np.asarray(leaf))

    @property
    def ntrees(self) -> int:
        return len(self.feat)

    def stacked(self, device: torch.device) -> Tuple[torch.Tensor, ...]:
        """The five fields as [T, M] tensors on ``device``."""
        return tuple(
            torch.from_numpy(np.stack(v)).to(device)
            for v in (self.feat, self.split_bin, self.default_left,
                      self.is_split, self.leaf)
        )


# ---------------------------------------------------------------------------
# objective families (hex/Distribution.java analogue), on the device


def grad_hess_device(objective: str, y: torch.Tensor, margin: torch.Tensor):
    """Per-row (g, h) [N, C] of the loss wrt the margin [N, C] float32.

    y: [N] labels/targets, or [N, C] fixed targets for objective='fixed'.
    Parameterized families carry their parameter in the string:
    ``tweedie:1.5``, ``quantile:0.9``, ``huber:<delta>``."""
    name, _, arg = objective.partition(":")
    if name == "custom":
        raise NotImplementedError(
            "custom distributions are not ported to h2o3_tpu_torch yet "
            "(ROADMAP A11: udf)")
    if name == "fixed":
        t = y if y.dim() == 2 else y[:, None]
        return -t.float(), torch.ones_like(t, dtype=torch.float32)
    if name == "gaussian":
        g = margin[:, 0] - y
        return g[:, None], torch.ones_like(g)[:, None]
    if name == "bernoulli":
        p = torch.sigmoid(margin[:, 0])
        return (p - y)[:, None], torch.clamp(p * (1 - p), min=1e-16)[:, None]
    if name == "multinomial":
        p = torch.softmax(margin, dim=1)
        cls = torch.arange(margin.shape[1], device=margin.device)
        onehot = (y.long()[:, None] == cls[None, :]).float()
        return p - onehot, torch.clamp(p * (1 - p), min=1e-16)
    if name == "poisson":
        mu = torch.exp(margin[:, 0])
        return (mu - y)[:, None], torch.clamp(mu, min=1e-16)[:, None]
    if name == "gamma":
        # deviance with log link: L = 2(y e^{-f} + f - log y - 1)
        ymf = y * torch.exp(-margin[:, 0])
        return (1.0 - ymf)[:, None], torch.clamp(ymf, min=1e-16)[:, None]
    if name == "tweedie":
        # log link, 1<p<2: L = -y e^{(1-p)f}/(1-p) + e^{(2-p)f}/(2-p)
        pw = float(arg)
        a = y * torch.exp((1.0 - pw) * margin[:, 0])
        b = torch.exp((2.0 - pw) * margin[:, 0])
        g = b - a
        h = (pw - 1.0) * a + (2.0 - pw) * b
        return g[:, None], torch.clamp(h, min=1e-16)[:, None]
    if name == "huber":
        delta = float(arg)
        r = margin[:, 0] - y
        return torch.clamp(r, -delta, delta)[:, None], torch.ones_like(r)[:, None]
    if name == "laplace":
        g = torch.sign(margin[:, 0] - y)
        return g[:, None], torch.ones_like(g)[:, None]
    if name == "quantile" or objective == "quantile_0.5":
        alpha = float(arg) if arg else 0.5
        g = torch.where(margin[:, 0] < y, -alpha, 1.0 - alpha).to(margin.dtype)
        return g[:, None], torch.ones_like(g)[:, None]
    raise ValueError(f"unknown objective {objective!r}")


# ---------------------------------------------------------------------------
# level-step pieces


def _split_search(
    hist: torch.Tensor, lam: float, alpha: float, gamma: float, lr: float,
    feat_mask: torch.Tensor, min_rows: float, n_bins1: int,
    child_stats: bool = False, constraints: Optional[torch.Tensor] = None,
    node_lo: Optional[torch.Tensor] = None,
    node_hi: Optional[torch.Tensor] = None,
):
    """Per-node best split over (feature, bin, NA direction).

    hist: [K, F, B+1, 3] (Σg, Σh, count); feat_mask: [F] for every node or
    [K, F] per node (mtries). Returns per-node tensors feat,
    bin, default_left, gain, leaf_value (lr-scaled); with child_stats=True
    or constraints set, also the winning split's unscaled child values
    (wl, wr) and whether the left child holds no more rows than the right —
    what the subtraction level flow and the monotone bounds need.

    Monotone mode (constraints: [F] in {-1, 0, +1}; node_lo, node_hi: [K]
    leaf-value bounds per node): a candidate whose child values go against
    its feature's direction is masked out, and the node's own leaf value is
    clipped into its bounds."""
    B = n_bins1 - 1
    total = hist.sum(dim=2)  # [K, F, 3] — identical across F
    G = total[:, 0, 0]
    H = total[:, 0, 1]
    CNT = total[:, 0, 2]

    real = hist[:, :, :B, :]
    na = hist[:, :, B, :]  # [K, F, 3]
    cum = torch.cumsum(real, dim=2)  # bins <= b on the left

    def thresh(v):
        return torch.sign(v) * torch.clamp(torch.abs(v) - alpha, min=0.0)

    def side_score(gs, hs):
        t = thresh(gs)
        return t * t / torch.clamp(hs + lam, min=1e-12)

    def opt_w(gs, hs):
        return -thresh(gs) / torch.clamp(hs + lam, min=1e-12)

    parent = side_score(G, H)  # [K]

    def dir_gain(gl, hl, cl):
        gr = G[:, None, None] - gl
        hr = H[:, None, None] - hl
        cr = CNT[:, None, None] - cl
        gain = 0.5 * (side_score(gl, hl) + side_score(gr, hr)
                      - parent[:, None, None]) - gamma
        ok = (cl >= min_rows) & (cr >= min_rows)
        gain = torch.where(ok, gain, -torch.inf)
        if constraints is not None:
            c = constraints[None, :, None].to(gl.dtype)
            bad = (c != 0) & (c * (opt_w(gr, hr) - opt_w(gl, hl)) < 0)
            gain = torch.where(bad, -torch.inf, gain)
        return gain

    # NA right (default_left=False): left stats = cum; NA left: += NA bucket
    gain_r = dir_gain(cum[..., 0], cum[..., 1], cum[..., 2])
    gain_l = dir_gain(
        cum[..., 0] + na[..., 0][:, :, None],
        cum[..., 1] + na[..., 1][:, :, None],
        cum[..., 2] + na[..., 2][:, :, None],
    )

    go_left_better = gain_l > gain_r
    gain_fb = torch.where(go_left_better, gain_l, gain_r)  # [K, F, B]
    fm = feat_mask[None, :, None] if feat_mask.dim() == 1 else feat_mask[:, :, None]
    gain_fb = torch.where(fm, gain_fb, -torch.inf)

    K = hist.shape[0]
    flat = gain_fb.reshape(K, -1)
    best = torch.argmax(flat, dim=1)  # first maximum, as jnp.argmax
    best_gain = torch.gather(flat, 1, best[:, None])[:, 0]
    best_f = torch.div(best, B, rounding_mode="floor")
    best_b = best % B
    dl = torch.gather(go_left_better.reshape(K, -1), 1, best[:, None])[:, 0]

    raw_leaf = opt_w(G, H)
    if constraints is not None:
        raw_leaf = torch.clamp(raw_leaf, node_lo, node_hi)
    best_f32, best_b32 = best_f.int(), best_b.int()
    if child_stats or constraints is not None:
        kk = torch.arange(K, device=hist.device)
        stats_l = cum[kk, best_f, best_b] + dl[:, None].to(cum.dtype) * na[kk, best_f]
        gl_b, hl_b, cl_b = stats_l[:, 0], stats_l[:, 1], stats_l[:, 2]
        best_wl = opt_w(gl_b, hl_b)
        best_wr = opt_w(G - gl_b, H - hl_b)
        left_small = 2.0 * cl_b <= CNT
        return (best_f32, best_b32, dl, best_gain, lr * raw_leaf,
                best_wl, best_wr, left_small)
    return best_f32, best_b32, dl, best_gain, lr * raw_leaf


def _route_bins(bins_fm: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """bins_fm[f[i], i] — each row's code of its node's split feature."""
    return torch.gather(bins_fm, 0, f.long()[None, :])[0]


def _tree_walk(bins_fm, feat, split_bin, default_left, is_split, leaf,
               max_depth: int, n_bins1: int) -> torch.Tensor:
    """Heap-walk one tree (arrays [M]); returns per-row leaf values."""
    idx = torch.zeros(bins_fm.shape[1], dtype=torch.long, device=bins_fm.device)
    for _ in range(max_depth):
        b = _route_bins(bins_fm, feat[idx])
        go_left = torch.where(b >= n_bins1 - 1, default_left[idx], b <= split_bin[idx])
        nxt = 2 * idx + torch.where(go_left, 1, 2)
        idx = torch.where(is_split[idx], nxt, idx)
    return leaf[idx]


def _predict_stacked(bins_fm, feat, split_bin, default_left, is_split, leaf,
                     max_depth: int, n_bins1: int) -> torch.Tensor:
    """Sum of all trees' outputs [N] float32, trees added in order.
    Tree arrays: [T, M]; bins_fm: [F, N]."""
    out = torch.zeros(bins_fm.shape[1], dtype=torch.float32, device=bins_fm.device)
    for t in range(feat.shape[0]):
        out = out + _tree_walk(bins_fm, feat[t], split_bin[t], default_left[t],
                               is_split[t], leaf[t], max_depth, n_bins1)
    return out


def _build_one_tree(
    bins_fm: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
    sample: Optional[torch.Tensor], feat_mask: torch.Tensor,
    key: jrandom.Key, p: TreeParams,
    rw: Optional[torch.Tensor], subtract: bool, hist_impl: str,
    constraints: Optional[torch.Tensor] = None, fact_max_kc: int = 0,
    cache: Optional[FitCache] = None, hist_dtype: str = "f32",
):
    """Grow one tree to max_depth with per-level node capacity 2^d.

    Every row (sampled or not) is routed, so its leaf is known at the end
    and the margin update is one gather; only ``sample`` rows ([N] bool,
    None = all) reach the histograms and the terminal totals. With
    ``p.mtries > 0`` each built level splits ``key`` and draws a [K, F]
    uniform, keeping per node the features at or below its mtries-th
    smallest draw (ties kept), within ``feat_mask``.
    ``constraints`` ([F] monotone directions, or None): per-node leaf-value
    bounds start at ±inf and are carried down the levels (the children of
    a split on a constrained feature share the split's midpoint as a
    bound); every leaf value is clipped into its node's bounds.
    ``fact_max_kc`` is ``build_histogram``'s factorized-kernel limit,
    ``cache`` the fit's ``FitCache``, which it hands every level, and
    ``hist_dtype`` its operand mode; the subtraction flow subtracts
    histograms built in that mode, as the JAX package does.
    Returns (heap arrays [M] x5, per-row leaf value [N])."""
    D = p.max_depth
    n_bins1 = p.nbins + 1
    n_feat, n = bins_fm.shape
    dev = bins_fm.device
    pos = torch.zeros(n, dtype=torch.long, device=dev)  # absolute heap position
    lr, lam, alpha = p.learn_rate, p.reg_lambda, p.reg_alpha
    mono = constraints is not None
    if mono:
        b_lo = torch.full((1,), -torch.inf, dtype=torch.float32, device=dev)
        b_hi = torch.full((1,), torch.inf, dtype=torch.float32, device=dev)

    tf_l, tb_l, tdl_l, tsp_l, tlf_l = [], [], [], [], []
    prev_hist = prev_can = prev_left_small = prev_wl = prev_wr = None
    for d in range(D + 1):
        K = 2**d
        lo = K - 1
        local = pos - lo
        in_lvl = (local >= 0) & (local < K)
        in_hist = in_lvl if sample is None else in_lvl & sample
        hist_nodes = torch.where(in_hist, local, -1).int()
        if d == D:
            if subtract and prev_wl is not None:
                # terminal leaves straight from the parent split's child
                # stats: child(2k) = wl[k], child(2k+1) = wr[k]
                raw_leaf = torch.stack([prev_wl, prev_wr], dim=1).reshape(K)
            else:
                tot = node_totals(hist_nodes, g, h, K, rw=rw)
                G, H = tot[:, 0], tot[:, 1]
                t = torch.sign(G) * torch.clamp(torch.abs(G) - alpha, min=0.0)
                raw_leaf = -t / torch.clamp(H + lam, min=1e-12)
            if mono:
                raw_leaf = torch.clamp(raw_leaf, b_lo, b_hi)
            tf_l.append(torch.zeros(K, dtype=torch.int32, device=dev))
            tb_l.append(torch.zeros(K, dtype=torch.int32, device=dev))
            tdl_l.append(torch.zeros(K, dtype=torch.bool, device=dev))
            tsp_l.append(torch.zeros(K, dtype=torch.bool, device=dev))
            tlf_l.append(lr * raw_leaf)
            break
        if subtract and d > 0:
            # build only each parent's smaller child (K/2 kernel nodes);
            # the larger sibling = parent - smaller. Children of parents
            # that did not split hold no rows: their small half is zero by
            # the in_lvl mask and their big half is masked by prev_can.
            Kp = K // 2
            par = torch.clamp(torch.div(local, 2, rounding_mode="floor"), 0, Kp - 1)
            parity = local % 2
            small_parity = torch.where(prev_left_small, 0, 1)  # [Kp]
            half_nodes = torch.where(
                in_hist & (parity == small_parity[par]), par, -1).int()
            hist_small = build_histogram(
                bins_fm, half_nodes, g, h, Kp, n_bins1, rw=rw, impl=hist_impl,
                fact_max_kc=fact_max_kc, cache=cache, dtype=hist_dtype)
            can_m = prev_can[:, None, None, None]
            hist_big = torch.where(can_m, prev_hist - hist_small, 0.0)
            ls_m = prev_left_small[:, None, None, None]
            left = torch.where(ls_m, hist_small, hist_big)
            right = torch.where(ls_m, hist_big, hist_small)
            hist = torch.stack([left, right], dim=1).reshape(K, *hist_small.shape[1:])
        else:
            hist = build_histogram(
                bins_fm, hist_nodes, g, h, K, n_bins1, rw=rw, impl=hist_impl,
                fact_max_kc=fact_max_kc, cache=cache, dtype=hist_dtype)
        node_feat_mask = feat_mask
        if p.mtries > 0:
            key, sub = jrandom.split(key)
            r = jrandom.uniform(sub, (K, n_feat), dev)
            # mtries > F keeps every feature (JAX clamps the index)
            m = min(p.mtries, n_feat)
            thresh = torch.sort(r, dim=1).values[:, m - 1:m]
            node_feat_mask = (r <= thresh) & feat_mask[None, :]
        out = _split_search(
            hist, lam, alpha, p.gamma, lr, node_feat_mask,
            min_rows=float(p.min_rows), n_bins1=n_bins1, child_stats=subtract,
            constraints=constraints, node_lo=b_lo if mono else None,
            node_hi=b_hi if mono else None,
        )
        if subtract or mono:
            bf, bb, dl, gain, leaf, bwl, bwr, left_small = out
        else:
            bf, bb, dl, gain, leaf = out
        can = (gain > max(p.min_split_improvement, 0.0)) & torch.isfinite(gain)
        tf_l.append(bf)
        tb_l.append(bb)
        tdl_l.append(dl)
        tsp_l.append(can)
        tlf_l.append(leaf)
        if subtract:
            prev_hist, prev_can, prev_left_small = hist, can, left_small
            prev_wl, prev_wr = bwl, bwr
        k = torch.clamp(local, 0, K - 1)
        b = _route_bins(bins_fm, bf[k])
        go_left = torch.where(b >= n_bins1 - 1, dl[k], b <= bb[k])
        child = 2 * (lo + k) + torch.where(go_left, 1, 2)
        pos = torch.where(in_lvl & can[k], child, pos)
        if mono:
            # the split's midpoint caps the constrained side of each child
            c_best = constraints[bf.long()].float()
            mid = torch.clamp(0.5 * (bwl + bwr), b_lo, b_hi)
            lo_left = torch.where(c_best < 0, torch.maximum(b_lo, mid), b_lo)
            hi_left = torch.where(c_best > 0, torch.minimum(b_hi, mid), b_hi)
            lo_right = torch.where(c_best > 0, torch.maximum(b_lo, mid), b_lo)
            hi_right = torch.where(c_best < 0, torch.minimum(b_hi, mid), b_hi)
            b_lo = torch.stack([lo_left, lo_right], dim=1).reshape(2 * K)
            b_hi = torch.stack([hi_left, hi_right], dim=1).reshape(2 * K)

    # per-level concatenation IS the heap layout: node (d, i) -> 2^d - 1 + i
    tree = tuple(torch.cat(v) for v in (tf_l, tb_l, tdl_l, tsp_l, tlf_l))
    return tree, tree[4][pos]


# ---------------------------------------------------------------------------
# training loop


class BoostedTrees:
    """Trained ensemble: per-class Trees + binning spec + init margin."""

    def __init__(
        self,
        trees_per_class: List[Trees],
        init_margin: np.ndarray,  # [C]
        params: TreeParams,
        average: bool = False,  # DRF averages instead of summing margins
        device: Optional[torch.device] = None,
    ):
        self.trees_per_class = trees_per_class
        self.init_margin = init_margin
        self.params = params
        self.average = average
        self.device = resolve_device(device)

    @property
    def nclasses_trees(self) -> int:
        return len(self.trees_per_class)

    def predict_margin(self, X: np.ndarray) -> np.ndarray:
        """Raw margins [N, C] float64 from raw features, re-binned with the
        stored edges and the trees walked, on the device."""
        bins_fm = apply_bins_device(X, self.trees_per_class[0].edges, self.device)
        cols = []
        for c, trees in enumerate(self.trees_per_class):
            if trees.ntrees == 0:
                cols.append(np.full(X.shape[0], self.init_margin[c], dtype=np.float64))
                continue
            s = _predict_stacked(bins_fm, *trees.stacked(self.device),
                                 max_depth=trees.max_depth, n_bins1=trees.n_bins1)
            s = s.cpu().numpy().astype(np.float64)
            if self.average:
                s = s / trees.ntrees
            cols.append(self.init_margin[c] + s)
        return np.stack(cols, axis=1)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to h2o3_tpu_torch yet ({item})")


def train_boosted(
    X: np.ndarray,
    objective: str,
    y: np.ndarray,
    n_class_trees: int,
    init_margin: np.ndarray,
    params: TreeParams,
    average: bool = False,
    monitor: Optional[Callable[[int, np.ndarray], bool]] = None,
    score_interval: int = 1,
    device=None,
    timings: Optional[dict] = None,
    resume_from: Optional["BoostedTrees"] = None,
    weights: Optional[np.ndarray] = None,
    offset: Optional[np.ndarray] = None,
    monotone: Optional[np.ndarray] = None,
    hist_impl: Optional[str] = None,
    subtract: Optional[bool] = None,
    hist_fact_max_kc: int = 0,
    hist_dtype: str = "f32",
    cache_token=None,
    cache_frame_key: Optional[str] = None,
) -> BoostedTrees:
    """Device-resident booster loop.

    objective: a ``grad_hess_device`` family ('gaussian', 'bernoulli',
    'multinomial', 'poisson', 'gamma', 'laplace', 'tweedie:<p>',
    'huber:<delta>', 'quantile:<alpha>') or 'fixed' with y = targets [N, C].
    monitor(tree_idx, margin[N, C]) -> True stops early; it is called every
    ``score_interval`` trees, which is also the block size then.
    resume_from: checkpoint-continue: start from an existing ensemble's
    binning, init margin, trees and margin and build ``params.ntrees`` MORE
    trees. Tree keys fold in the absolute tree index, so k trees and then k
    more draw what one 2k-tree fit draws.
    weights: [N] observation weights folded into (g, h) and the count
    channel. offset: [N] margin offset (single-margin objectives).
    monotone: [F] per-feature direction in {-1, 0, +1}.
    device: where the fit runs (see ``device.resolve_device``).
    hist_impl: "kernel" or "plain" (default: kernel on cuda, plain on cpu).
    subtract: histogram subtraction (default: on for cuda, off for cpu).
    hist_fact_max_kc: levels whose padded node count K satisfies K·4 <= this
    take the factorized kernel (``ops/histogram.build_histogram``; 0, the
    JAX package's default, sends none).
    hist_dtype: the histograms' operand mode, "f32" (the default) or
    "bf16": g, h and the count weight rounded to bf16 and summed in float,
    as the JAX package's histograms do by default on its own chip (its
    ``H2O3_TPU_HIST_DTYPE``). The terminal level's node totals are not
    rounded.
    cache_token: hashable identity of X's provenance (frame column versions
    and encoding; ``models/tree/common.tree_cache_token``). When set, the
    fit's ``FitCache`` (the bin codes made on the device, and the sorted
    kernel's row-major copy once a level makes it) is kept in the device
    frame cache under (token, edges, nbins, device), so a repeat GBM, DRF
    or XGBoost fit on the same unmutated frame reuses the resident codes
    instead of binning again. cache_frame_key links the entry to a DKV
    frame for eviction. None bypasses the cache."""
    if getattr(X, "is_dist_hist", False):
        raise _not_ported("chunk-homed distributed training",
                          "ROADMAP A10: cluster-side compute")
    p = params
    dev = resolve_device(device)
    hist_impl = hist_impl or default_hist_impl(dev)
    if hist_impl not in HIST_IMPLS:
        raise ValueError(f"hist_impl must be one of {HIST_IMPLS}, got {hist_impl!r}")
    check_hist_dtype(hist_dtype)
    subtract_on = dev.type == "cuda" if subtract is None else bool(subtract)

    _t0 = time.time()
    n, F = X.shape
    if resume_from is not None:
        # continue training: reuse the checkpoint's binning and f0 exactly
        init_margin = resume_from.init_margin
        edges = resume_from.trees_per_class[0].edges
        if resume_from.trees_per_class[0].n_bins1 != p.nbins + 1:
            raise ValueError("checkpoint nbins mismatch")
    else:
        edges = make_bins(X, p.nbins, seed=p.seed)
    _t_bins = time.time()
    n_bins1 = p.nbins + 1
    # the codes are a function of (X's provenance, edges, device) alone,
    # reusable across fits of any algorithm that share a frame and a
    # binning spec. A hit must not change a tree: nothing on the fit's or
    # the scoring path writes into bins_fm or codes_rm in place.
    extra_key = (hashlib.sha1(np.ascontiguousarray(edges).tobytes()).hexdigest(),
                 p.nbins)
    entry = devcache.cache_key("tree_bins", cache_token, extra_key, dev)

    def _place():
        return FitCache(apply_bins_device(X, edges, dev), n_bins1,
                        on_grow=functools.partial(devcache.DEVCACHE.grow_entry, entry))

    cache = devcache.cached("tree_bins", cache_token, extra_key, dev, _place,
                            frame_key=cache_frame_key)
    bins_fm = cache.bins_fm
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    _t_place = time.time()

    C = n_class_trees
    y_d = torch.from_numpy(np.ascontiguousarray(y, dtype=np.float32)).to(dev)

    if resume_from is not None and objective != "fixed":
        margin_host = resume_from.predict_margin(X).astype(np.float32)  # [n, C]
    else:
        margin_host = np.tile(np.asarray(init_margin, dtype=np.float32), (n, 1))
    if offset is not None:
        if C != 1:
            raise ValueError("offset_column requires a single-margin objective")
        margin_host[:, 0] += np.asarray(offset, dtype=np.float32)
    margin = torch.from_numpy(margin_host).to(dev)

    w_d = None
    if weights is not None:
        w_d = torch.from_numpy(np.asarray(weights, dtype=np.float32)).to(dev)
    mono_d = None
    if monotone is not None and np.any(np.asarray(monotone) != 0):
        mono_d = torch.from_numpy(np.asarray(monotone, dtype=np.int32)).to(dev)
    all_feats = torch.ones(F, dtype=torch.bool, device=dev)
    key = jrandom.PRNGKey(p.seed)
    # sampling draws compare float32 uniforms with the rate as float32
    sample_rate = float(np.float32(p.sample_rate))

    trees_per_class = [Trees(p.max_depth, n_bins1, edges) for _ in range(C)]
    tree_offset = 0
    if resume_from is not None:
        tree_offset = resume_from.trees_per_class[0].ntrees
        for src, dst in zip(resume_from.trees_per_class, trees_per_class):
            for field in ("feat", "split_bin", "default_left", "is_split", "leaf"):
                setattr(dst, field, list(getattr(src, field)))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    _t_prep = time.time()

    built = 0
    while built < p.ntrees:
        block = min(score_interval if monitor is not None else DEFAULT_TREE_BLOCK,
                    p.ntrees - built)
        rounds = []
        for t in range(built, built + block):
            g_all, h_all = grad_hess_device(objective, y_d, margin)
            if w_d is not None:
                # row weights fold into (g, h): every Σg/Σh is weighted
                g_all = g_all * w_d[:, None]
                h_all = h_all * w_d[:, None]
            # one key per absolute tree index, split as the JAX block does
            kr, kc, kt = jrandom.split(jrandom.fold_in(key, tree_offset + t), 3)
            sample = None
            if p.sample_rate < 1.0:
                sample = jrandom.uniform(kr, (n,), dev) < sample_rate
            feat_mask = all_feats
            if p.col_sample_rate_per_tree < 1.0:
                ncols = max(1, int(round(p.col_sample_rate_per_tree * F)))
                r = jrandom.uniform(kc, (F,), dev)
                feat_mask = r <= torch.sort(r).values[ncols - 1]
            outs = []
            for c in range(C):
                tree, pred = _build_one_tree(
                    bins_fm, g_all[:, c].float().contiguous(),
                    h_all[:, c].float().contiguous(), sample, feat_mask,
                    jrandom.fold_in(kt, c), p,
                    rw=w_d, subtract=subtract_on, hist_impl=hist_impl,
                    constraints=mono_d, fact_max_kc=hist_fact_max_kc,
                    cache=cache, hist_dtype=hist_dtype,
                )
                margin[:, c] += pred
                outs.append(tree)
            rounds.append(outs)
        # the block's tree arrays cross to the host once: [block, C, M] each
        fields = [
            torch.stack([torch.stack([rnd[c][i] for c in range(C)]) for rnd in rounds])
            .cpu().numpy()
            for i in range(5)
        ]
        for t in range(block):
            for c in range(C):
                trees_per_class[c].append(*(f[t, c] for f in fields))
        built += block
        if monitor is not None:
            margin_host = margin.cpu().numpy().astype(np.float64)
            if monitor(built - 1, margin_host):
                break

    if timings is not None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        timings["prep_s"] = _t_prep - _t0
        timings["bins_s"] = _t_bins - _t0
        timings["place_s"] = _t_place - _t_bins
        timings["train_s"] = time.time() - _t_prep
    return BoostedTrees(trees_per_class, np.asarray(init_margin, np.float64), p,
                        average=average, device=dev)
