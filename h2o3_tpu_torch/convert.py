"""Carry trained models into the port from plain numpy arrays.

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

``glm_from_numpy(arrays, data_info, params)`` and
``deeplearning_from_numpy(arrays, data_info, params)`` build a GLM or
DeepLearning model from its fitted arrays, the fields of its ``DataInfo``
(``dataclasses.asdict`` of the JAX package's) and the fields of its
parameters, as plain dicts:

- GLM ``arrays``: ``beta_std`` ([P+1], the intercept last; [P] for the
  ordinal family, with ``ordinal_thresholds`` [K-1]) or ``beta_multi``
  ([P+1, K]), and ``coefficients`` (the raw-scale dict);
- DeepLearning ``arrays``: ``net_params`` ([(W, b)] per layer),
  ``opt_leaves`` (optax's state leaves, in optax's order) and
  ``epochs_trained``. Such a model scores as the model it came from and
  continues training (``checkpoint=``) as that model would.

``target_encoder_from_numpy(encodings, prior_mean, fold, params,
data_info)`` builds a target encoder from its tables (``encodings``:
``{column: (domain, numerator[L], denominator[L])}``), its prior mean, its
training fold ids (or None) and, as plain dicts, its parameters and
``DataInfo`` fields. ``stacked_ensemble_from_models(base_models,
metalearner, levelone_names, data_info, params)`` assembles a stacked
ensemble from port models that the converters above built, in the base
models' order, with the level-one column names of the ensemble they come
from; ``params`` are the ensemble's parameters but its base models. So an
AutoML leader of the JAX package, with its target encoder set as each
model's ``preprocessors``, scores here.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import numpy as np

from h2o3_tpu_torch.device import resolve_device
from h2o3_tpu_torch.models.data_info import DataInfo
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


def glm_from_numpy(arrays: Mapping[str, Any], data_info: Mapping[str, Any],
                   params: Mapping[str, Any], device=None):
    from h2o3_tpu_torch.models.glm import GLMModel, GLMParameters

    p = GLMParameters(**params)
    info = DataInfo(**data_info)
    model = GLMModel(p, info, resolve_device(device if device is not None else p.device))
    P = len(info.coef_names)
    if p.family == "multinomial":
        B = np.asarray(arrays["beta_multi"], dtype=np.float64)
        K = len(info.response_domain or ())
        if B.shape != (P + 1, K):
            raise ValueError(f"beta_multi must be [P + 1, K] = [{P + 1}, {K}], got {B.shape}")
        model.beta_multi = B
    else:
        beta = np.asarray(arrays["beta_std"], dtype=np.float64)
        want = P if p.family == "ordinal" else P + 1
        if beta.shape != (want,):
            raise ValueError(f"beta_std must be [{want}], got {beta.shape}")
        model.beta_std = beta
        if p.family == "ordinal":
            model.ordinal_thresholds = np.asarray(arrays["ordinal_thresholds"],
                                                  dtype=np.float64)
    model.coefficients = dict(arrays["coefficients"])
    return model


def deeplearning_from_numpy(arrays: Mapping[str, Any], data_info: Mapping[str, Any],
                            params: Mapping[str, Any], device=None):
    from h2o3_tpu_torch.models.deeplearning import (
        DeepLearningModel, DeepLearningParameters, loss_kind)

    p = DeepLearningParameters(**params)
    info = DataInfo(**data_info)
    net = [(np.asarray(W, dtype=np.float32), np.asarray(b, dtype=np.float32))
           for W, b in arrays["net_params"]]
    d_in = len(info.coef_names)
    nclasses = len(info.response_domain) if info.response_domain else 1
    d_out = d_in if p.autoencoder else nclasses
    sizes = [d_in] + list(p.hidden) + [d_out]
    shapes = [(W.shape, b.shape) for W, b in net]
    want = [((sizes[i], sizes[i + 1]), (sizes[i + 1],)) for i in range(len(sizes) - 1)]
    if shapes != want:
        raise ValueError(f"net_params shapes {shapes} are not the layout {want}")
    model = DeepLearningModel(p, info, loss_kind(p, nclasses),
                              resolve_device(device if device is not None else p.device))
    model.net_params = net
    leaves = arrays.get("opt_leaves")
    model.opt_leaves = None if leaves is None else [np.asarray(x) for x in leaves]
    model.epochs_trained = float(arrays.get("epochs_trained", 0.0))
    return model


def target_encoder_from_numpy(encodings: Mapping[str, Any], prior_mean: float,
                              fold: Optional[np.ndarray], params: Mapping[str, Any],
                              data_info: Mapping[str, Any], device=None):
    from h2o3_tpu_torch.models.target_encoder import (
        TargetEncoderModel, TargetEncoderParameters)

    p = TargetEncoderParameters(**params)
    info = DataInfo(**data_info)
    model = TargetEncoderModel(
        p, info, resolve_device(device if device is not None else p.device))
    for name, (dom, num, den) in encodings.items():
        num = np.asarray(num, dtype=np.float64)
        den = np.asarray(den, dtype=np.float64)
        if num.shape != (len(dom),) or den.shape != (len(dom),):
            raise ValueError(
                f"encoding of {name!r}: numerator {num.shape} and denominator "
                f"{den.shape} must be [{len(dom)}], one per level")
        model.encodings[name] = (list(dom), num, den)
    model.prior_mean = float(prior_mean)
    model.fold = None if fold is None else np.asarray(fold, dtype=np.int64)
    return model


def stacked_ensemble_from_models(base_models: Sequence[Any], metalearner,
                                 levelone_names: Sequence[str],
                                 data_info: Mapping[str, Any],
                                 params: Mapping[str, Any], device=None):
    from h2o3_tpu_torch.models.stacked_ensemble import (
        StackedEnsembleModel, StackedEnsembleParameters)

    want = sum(1 if bm.nclasses <= 2 else bm.nclasses for bm in base_models)
    if len(levelone_names) != want:
        raise ValueError(f"{len(levelone_names)} level-one names for base models "
                         f"giving {want} columns")
    if list(metalearner.data_info.predictor_names) != list(levelone_names):
        raise ValueError(
            f"the metalearner's predictors {metalearner.data_info.predictor_names} "
            f"are not the level-one columns {list(levelone_names)}")
    p = StackedEnsembleParameters(**params)
    p.base_models = list(base_models)
    info = DataInfo(**data_info)
    model = StackedEnsembleModel(
        p, info, resolve_device(device if device is not None else p.device))
    model.base_models = list(base_models)
    model.metalearner = metalearner
    model.levelone_names = list(levelone_names)
    return model
