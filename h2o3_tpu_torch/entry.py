"""Entry point of the port — the counterpart of the repository's
``__graft_entry__.entry``: one scoring step of the flagship histogram
booster, ready to call.

``entry(device=None)`` -> ``(fn, args)``: ``fn(*args)`` sums 4 random
trees of depth 4 over 256 rows x 8 features of 17-bin codes
(``models/tree/booster._predict_stacked``), the inputs drawn from
``np.random.default_rng(0)`` exactly as the JAX entry draws them and placed
on the resolved device (``device.resolve_device``: ``cuda`` unless asked
for the CPU). The JAX entry's codes are row-major ``[N, F]``; the port's
walk reads feature-major ``[F, N]`` codes and takes the bin count as a
Python int.

The multi-chip dry run (one sharded boosting round) waits for the port's
multi-GPU layer (ROADMAP A12).
"""

from __future__ import annotations

import numpy as np
import torch

from h2o3_tpu_torch.device import DeviceLike, resolve_device
from h2o3_tpu_torch.models.tree.booster import _predict_stacked


def entry(device: DeviceLike = None):
    dev = resolve_device(device)
    T, depth = 4, 4
    M = 2 ** (depth + 1) - 1
    nbins1 = 17
    rng = np.random.default_rng(0)
    bins = rng.integers(0, nbins1, size=(256, 8)).astype(np.int32)
    feat = rng.integers(0, 8, size=(T, M)).astype(np.int32)
    split_bin = rng.integers(0, nbins1 - 1, size=(T, M)).astype(np.int32)
    default_left = rng.random((T, M)) < 0.5
    is_split = rng.random((T, M)) < 0.5
    leaf = rng.normal(size=(T, M)).astype(np.float32)

    def fn(b, f, sb, dl, sp, lf, nb1):
        return _predict_stacked(b, f, sb, dl, sp, lf, depth, nb1)

    args = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        bins.T, feat, split_bin, default_left, is_split, leaf)) + (nbins1,)
    return fn, args
