"""Carry a trained tree ensemble into the port from plain numpy arrays.

``ensemble_from_numpy(d)`` builds the port's ``BoostedTrees`` from a dict
of numpy arrays, so an ensemble trained elsewhere (for instance by the JAX
package, whose ``BoostedTrees`` holds the same heap-layout fields) scores
here without this package ever seeing the other package's objects:

- ``edges``: [F, nbins-1] float64 bin edges;
- ``feat``, ``split_bin``, ``default_left``, ``is_split``, ``leaf``: one
  [T, M] stack per class, given as a sequence of C arrays or one [C, T, M]
  array (M = 2^(max_depth+1) - 1);
- ``init_margin``: [C]; ``max_depth``; ``n_bins1`` (= nbins + 1);
- ``average``: optional, True for averaged (DRF) ensembles.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np

from h2o3_tpu_torch.models.tree.booster import BoostedTrees, TreeParams, Trees

_FIELDS = (
    ("feat", np.int32), ("split_bin", np.int32), ("default_left", np.bool_),
    ("is_split", np.bool_), ("leaf", np.float32),
)


def ensemble_from_numpy(d: Mapping[str, Any], device=None) -> BoostedTrees:
    max_depth = int(d["max_depth"])
    n_bins1 = int(d["n_bins1"])
    edges = np.asarray(d["edges"], dtype=np.float64)
    if edges.ndim != 2 or edges.shape[1] != n_bins1 - 2:
        raise ValueError(
            f"edges must be [F, n_bins1 - 2] = [F, {n_bins1 - 2}], "
            f"got {edges.shape}")
    init = np.asarray(d["init_margin"], dtype=np.float64).reshape(-1)
    n_class = len(d["feat"])
    if init.shape[0] != n_class:
        raise ValueError(f"init_margin has {init.shape[0]} classes, trees {n_class}")
    m = 2 ** (max_depth + 1) - 1
    trees_per_class = []
    for c in range(n_class):
        trees = Trees(max_depth, n_bins1, edges)
        stacks = [np.asarray(d[name][c], dtype=dt) for name, dt in _FIELDS]
        for name, s in zip((f for f, _ in _FIELDS), stacks):
            if s.ndim != 2 or s.shape[1] != m or s.shape[0] != stacks[0].shape[0]:
                raise ValueError(
                    f"{name}[{c}] must be [T, {m}], got {s.shape}")
        for t in range(stacks[0].shape[0]):
            trees.append(*(s[t] for s in stacks))
        trees_per_class.append(trees)
    params = TreeParams(ntrees=trees_per_class[0].ntrees, max_depth=max_depth,
                        nbins=n_bins1 - 1)
    return BoostedTrees(trees_per_class, init, params,
                        average=bool(d.get("average", False)), device=device)
