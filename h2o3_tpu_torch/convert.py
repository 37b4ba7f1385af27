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
  ([P+1, K]; the per-class raw-scale ``coefficients_multinomial`` are
  made from it as a fit makes them), and ``coefficients`` (the raw-scale
  dict);
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

One function each for KMeans, PCA and SVD, GLRM, NaiveBayes and the two
isolation forests takes the fitted arrays (a dict), the ``DataInfo``
fields and the parameters as plain dicts, and returns a port model that
scores as the model it came from:

- ``kmeans_from_numpy``: ``centers_std`` and ``centers`` [k, P], ``size``
  and ``withinss`` [k], optionally ``totss``;
- ``pca_from_numpy``: ``eigenvectors`` [P, k], ``transform_sub`` and
  ``transform_mul`` ([1, P] or None), ``std_deviation`` and ``pve`` [k];
  with ``d`` [k] and ``v`` [P, k] it builds an SVD model;
- ``glrm_from_numpy``: ``archetypes`` [k, P], optionally ``x_factors``
  [N, k] and ``objective``;
- ``naive_bayes_from_numpy``: ``priors`` [C] and the dicts ``num_mean``,
  ``num_sd`` ([C] per numeric predictor) and ``cat_probs`` ([C, L] per
  categorical one);
- ``isolation_forest_from_numpy``: ``feat``, ``thresh``, ``is_split`` and
  ``path_len`` [T, M] (M = 2^(max_depth+1) - 1, ``max_depth`` a
  parameter) and ``c_norm`` (the JAX model's ``_cn``), optionally
  ``min_path_total`` and ``max_path_total``;
- ``ext_isolation_forest_from_numpy``: ``normals`` [T, M, P],
  ``offsets``, ``is_split`` and ``correction`` [T, M], ``depth`` and
  ``sample_size``.

GAM, CoxPH, PSVM and Word2Vec take the same three dicts:

- ``gam_from_numpy``: ``beta`` [P_lin + sum of the smoothers' widths + 1]
  and ``specs``, one dict per smoother (``dataclasses.asdict`` of the JAX
  package's ``GamSpec``, or of its ``TpSpec`` for a multi-predictor
  thin-plate smoother);
- ``coxph_from_numpy``: ``beta`` and ``feature_means`` [P];
- ``psvm_from_numpy``: ``support_vectors`` [S, P], ``alpha_y`` [S],
  ``rho`` and ``gamma_``;
- ``word2vec_from_numpy``: ``vectors`` [V, D] and ``words`` (the
  vocabulary in row order).

``rulefit_from_numpy(arrays, data_info, params)`` takes the same three
dicts: ``rules``, one dict per rule with its ``conditions`` (each a dict
of ``feature``, ``feature_name``, ``threshold``, ``go_left`` and
``na_left``: ``dataclasses.asdict`` of the JAX package's ``RuleCondition``)
and its ``support``; ``linear_names``; ``winsor_lo`` and ``winsor_hi``
[F]; and ``glm``, the inner LASSO as the three dicts of
``glm_from_numpy`` (``arrays``, ``data_info``, ``params``). Each rule's
coefficient and the importance table come from the inner GLM's
coefficients, as a fit makes them.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import numpy as np

from h2o3_tpu_torch.device import resolve_device
from h2o3_tpu_torch.models.data_info import DataInfo, destandardize_coefs
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
    model = GLMModel(p, info, _model_device(device, p))
    P = len(info.coef_names)
    if p.family == "multinomial":
        B = np.asarray(arrays["beta_multi"], dtype=np.float64)
        K = len(info.response_domain or ())
        if B.shape != (P + 1, K):
            raise ValueError(f"beta_multi must be [P + 1, K] = [{P + 1}, {K}], got {B.shape}")
        model.beta_multi = B
        # the per-class raw-scale coefficients, as the fit makes them
        model.coefficients_multinomial = {}
        for k, lv in enumerate(info.response_domain):
            b_raw, icpt = destandardize_coefs(info, B[:-1, k], B[-1, k])
            model.coefficients_multinomial[lv] = dict(zip(info.coef_names, b_raw.tolist()))
            model.coefficients_multinomial[lv]["Intercept"] = icpt
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
                              _model_device(device, p))
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
        p, info, _model_device(device, p))
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
        p, info, _model_device(device, p))
    model.base_models = list(base_models)
    model.metalearner = metalearner
    model.levelone_names = list(levelone_names)
    return model


def _model_device(device, p):
    return resolve_device(device if device is not None else p.device)


def _check_shape(name: str, a: np.ndarray, shape) -> np.ndarray:
    if a.shape != tuple(shape):
        raise ValueError(f"{name} must be {list(shape)}, got {list(a.shape)}")
    return a


def kmeans_from_numpy(arrays: Mapping[str, Any], data_info: Mapping[str, Any],
                      params: Mapping[str, Any], device=None):
    from h2o3_tpu_torch.models.kmeans import KMeansModel, KMeansParameters

    p = KMeansParameters(**params)
    info = DataInfo(**data_info)
    model = KMeansModel(p, info, _model_device(device, p))
    C = np.asarray(arrays["centers_std"], dtype=np.float64)
    k = C.shape[0]
    shape = (k, len(info.coef_names))
    model.centers_std = _check_shape("centers_std", C, shape)
    model.centers = _check_shape(
        "centers", np.asarray(arrays["centers"], dtype=np.float64), shape)
    model.size = _check_shape("size", np.asarray(arrays["size"], dtype=np.int64), (k,))
    model.withinss = _check_shape(
        "withinss", np.asarray(arrays["withinss"], dtype=np.float64), (k,))
    model.tot_withinss = float(model.withinss.sum())
    if arrays.get("totss") is not None:
        model.totss = float(arrays["totss"])
        model.betweenss = model.totss - model.tot_withinss
    model.training_metrics = model.model_performance(None)
    return model


def pca_from_numpy(arrays: Mapping[str, Any], data_info: Mapping[str, Any],
                   params: Mapping[str, Any], device=None):
    from h2o3_tpu_torch.models.pca import (
        PCAModel, PCAParameters, SVDModel, SVDParameters)

    svd = arrays.get("d") is not None
    p = (SVDParameters if svd else PCAParameters)(**params)
    info = DataInfo(**data_info)
    model = (SVDModel if svd else PCAModel)(p, info, _model_device(device, p))
    V = np.asarray(arrays["eigenvectors"], dtype=np.float32)
    P = len(info.coef_names)
    if V.ndim != 2 or V.shape[0] != P:
        raise ValueError(f"eigenvectors must be [{P}, k], got {list(V.shape)}")
    k = V.shape[1]
    model.eigenvectors = V
    for name in ("transform_sub", "transform_mul"):
        a = arrays.get(name)
        setattr(model, name, None if a is None else _check_shape(
            name, np.asarray(a, dtype=np.float32), (1, P)))
    model.std_deviation = _check_shape(
        "std_deviation", np.asarray(arrays["std_deviation"], dtype=np.float64), (k,))
    model.pve = _check_shape("pve", np.asarray(arrays["pve"], dtype=np.float64), (k,))
    model.cum_pve = np.cumsum(model.pve)
    model.training_metrics = model.model_performance(None)
    if svd:
        model.d = _check_shape("d", np.asarray(arrays["d"], dtype=np.float64), (k,))
        model.v = _check_shape("v", np.asarray(arrays["v"], dtype=np.float32), (P, k))
        model.training_metrics = {"d": model.d}
    return model


def glrm_from_numpy(arrays: Mapping[str, Any], data_info: Mapping[str, Any],
                    params: Mapping[str, Any], device=None):
    from h2o3_tpu_torch.models.glrm import GLRMModel, GLRMParameters

    p = GLRMParameters(**params)
    info = DataInfo(**data_info)
    model = GLRMModel(p, info, _model_device(device, p))
    Y = np.asarray(arrays["archetypes"], dtype=np.float64)
    P = len(info.coef_names)
    if Y.ndim != 2 or Y.shape[1] != P:
        raise ValueError(f"archetypes must be [k, {P}], got {list(Y.shape)}")
    model.archetypes = Y
    x = arrays.get("x_factors")
    if x is not None:
        x = np.asarray(x, dtype=np.float64)
        if x.ndim != 2 or x.shape[1] != Y.shape[0]:
            raise ValueError(f"x_factors must be [N, {Y.shape[0]}], got {list(x.shape)}")
        model.x_factors = x
    if arrays.get("objective") is not None:
        model.objective = float(arrays["objective"])
    return model


def naive_bayes_from_numpy(arrays: Mapping[str, Any], data_info: Mapping[str, Any],
                           params: Mapping[str, Any], device=None):
    from h2o3_tpu_torch.models.naive_bayes import NaiveBayesModel, NaiveBayesParameters

    p = NaiveBayesParameters(**params)
    info = DataInfo(**data_info)
    model = NaiveBayesModel(p, info, _model_device(device, p))
    C = len(info.response_domain or ())
    model.priors = _check_shape(
        "priors", np.asarray(arrays["priors"], dtype=np.float64), (C,))
    for name in info.predictor_names:
        if name in info.cat_domains:
            model.cat_probs[name] = _check_shape(
                f"cat_probs[{name!r}]",
                np.asarray(arrays["cat_probs"][name], dtype=np.float64),
                (C, len(info.cat_domains[name])))
        else:
            for field in ("num_mean", "num_sd"):
                getattr(model, field)[name] = _check_shape(
                    f"{field}[{name!r}]",
                    np.asarray(arrays[field][name], dtype=np.float64), (C,))
    return model


def isolation_forest_from_numpy(arrays: Mapping[str, Any], data_info: Mapping[str, Any],
                                params: Mapping[str, Any], device=None):
    from h2o3_tpu_torch.models.isolation_forest import (
        IsolationForestModel, IsolationForestParameters)

    p = IsolationForestParameters(**params)
    info = DataInfo(**data_info)
    model = IsolationForestModel(p, info, _model_device(device, p))
    shape = (np.shape(arrays["feat"])[0], 2 ** (p.max_depth + 1) - 1)
    model.trees = tuple(
        _check_shape(name, np.asarray(arrays[name], dtype=dt), shape)
        for name, dt in (("feat", np.int32), ("thresh", np.float32),
                         ("is_split", np.bool_), ("path_len", np.float32)))
    model._cn = float(arrays["c_norm"])
    for name in ("min_path_total", "max_path_total"):
        if arrays.get(name) is not None:
            setattr(model, name, float(arrays[name]))
    return model


def ext_isolation_forest_from_numpy(arrays: Mapping[str, Any],
                                    data_info: Mapping[str, Any],
                                    params: Mapping[str, Any], device=None):
    from h2o3_tpu_torch.models.ext_isolation_forest import (
        ExtendedIsolationForestModel, ExtendedIsolationForestParameters)

    p = ExtendedIsolationForestParameters(**params)
    info = DataInfo(**data_info)
    model = ExtendedIsolationForestModel(p, info, _model_device(device, p))
    model.depth = int(arrays["depth"])
    model.sample_size = int(arrays["sample_size"])
    T = np.shape(arrays["normals"])[0]
    m = 2 ** (model.depth + 1) - 1
    model.normals = _check_shape("normals", np.asarray(arrays["normals"], dtype=np.float32),
                                 (T, m, len(info.coef_names)))
    model.offsets = _check_shape("offsets", np.asarray(arrays["offsets"], dtype=np.float32),
                                 (T, m))
    model.is_split = _check_shape("is_split", np.asarray(arrays["is_split"], dtype=bool),
                                  (T, m))
    model.correction = _check_shape(
        "correction", np.asarray(arrays["correction"], dtype=np.float32), (T, m))
    return model


def gam_from_numpy(arrays: Mapping[str, Any], data_info: Mapping[str, Any],
                   params: Mapping[str, Any], device=None):
    from h2o3_tpu_torch.models.gam import (
        GAMModel, GAMParameters, GamSpec, TpSpec, coefficient_names)

    p = GAMParameters(**params)
    info = DataInfo(**data_info)
    model = GAMModel(p, info, _model_device(device, p))
    specs = []
    for d in arrays["specs"]:
        d = {k: np.asarray(v, dtype=np.float64) if isinstance(v, np.ndarray) else v
             for k, v in d.items()}
        specs.append(TpSpec(**d) if "columns" in d else GamSpec(**d))
    model.specs = specs
    width = len(info.coef_names) + sum(s.penalty.shape[0] for s in specs) + 1
    model.beta = _check_shape("beta", np.asarray(arrays["beta"], dtype=np.float64),
                              (width,))
    names = coefficient_names(info.coef_names, specs)
    model.coefficients = dict(zip(names, model.beta[:-1].tolist()))
    model.coefficients["Intercept"] = float(model.beta[-1])
    return model


def coxph_from_numpy(arrays: Mapping[str, Any], data_info: Mapping[str, Any],
                     params: Mapping[str, Any], device=None):
    from h2o3_tpu_torch.models.coxph import CoxPHModel, CoxPHParameters

    p = CoxPHParameters(**params)
    info = DataInfo(**data_info)
    model = CoxPHModel(p, info, _model_device(device, p))
    P = len(info.coef_names)
    model.beta = _check_shape("beta", np.asarray(arrays["beta"], dtype=np.float64), (P,))
    model.feature_means = _check_shape(
        "feature_means", np.asarray(arrays["feature_means"], dtype=np.float64), (P,))
    model.coefficients = dict(zip(info.coef_names, model.beta.tolist()))
    model.exp_coef = {k: float(np.exp(v)) for k, v in model.coefficients.items()}
    return model


def psvm_from_numpy(arrays: Mapping[str, Any], data_info: Mapping[str, Any],
                    params: Mapping[str, Any], device=None):
    from h2o3_tpu_torch.models.psvm import PSVMModel, PSVMParameters

    p = PSVMParameters(**params)
    info = DataInfo(**data_info)
    model = PSVMModel(p, info, _model_device(device, p))
    sv = np.asarray(arrays["support_vectors"], dtype=np.float64)
    model.support_vectors = _check_shape(
        "support_vectors", sv, (sv.shape[0], len(info.coef_names)))
    model.alpha_y = _check_shape(
        "alpha_y", np.asarray(arrays["alpha_y"], dtype=np.float64), (sv.shape[0],))
    model.rho = float(arrays["rho"])
    model.gamma_ = float(arrays["gamma_"])
    model.svs_count = sv.shape[0]
    return model


def word2vec_from_numpy(arrays: Mapping[str, Any], data_info: Mapping[str, Any],
                        params: Mapping[str, Any], device=None):
    from h2o3_tpu_torch.models.word2vec import Word2VecModel, Word2VecParameters

    p = Word2VecParameters(**params)
    model = Word2VecModel(p, DataInfo(**data_info), _model_device(device, p))
    words = [str(w) for w in arrays["words"]]
    model.vectors = _check_shape(
        "vectors", np.asarray(arrays["vectors"], dtype=np.float64), (len(words), p.vec_size))
    model.words = words
    model.vocab = {w: i for i, w in enumerate(words)}
    return model


def rulefit_from_numpy(arrays: Mapping[str, Any], data_info: Mapping[str, Any],
                       params: Mapping[str, Any], device=None):
    from h2o3_tpu_torch.models.rulefit import (
        Rule, RuleCondition, RuleFitModel, RuleFitParameters, _rule_importance)

    p = RuleFitParameters(**params)
    info = DataInfo(**data_info)
    dev = _model_device(device, p)
    model = RuleFitModel(p, info, dev)
    F = len(info.predictor_names)
    model.rules = [
        Rule([RuleCondition(int(c["feature"]), str(c["feature_name"]),
                            float(c["threshold"]), bool(c["go_left"]),
                            bool(c["na_left"])) for c in r["conditions"]],
             support=float(r["support"]))
        for r in arrays["rules"]
    ]
    model.linear_names = [str(n) for n in arrays["linear_names"]]
    model.winsor = (
        _check_shape("winsor_lo", np.asarray(arrays["winsor_lo"]), (F,)),
        _check_shape("winsor_hi", np.asarray(arrays["winsor_hi"]), (F,)),
    )
    g = arrays["glm"]
    model.glm = glm_from_numpy(g["arrays"], g["data_info"], g["params"], device=dev)
    model.rule_importance = _rule_importance(model)
    return model
