"""MOJO writer — the port of ``h2o3_tpu/models/mojo_export.py``.

Reference: ``hex/ModelMojoWriter.java`` (a zip of ``model.ini`` and
per-algo blobs). The archive is the JAX package's: ``model.ini`` (a
readable summary), ``meta.json`` (algo scalars), ``data_info.json`` (the
design-matrix layout, ``dataclasses.asdict`` of ``DataInfo``) and
``arrays.npz`` (the trees), read back by the numpy-only
``h2o3_tpu_torch.genmodel`` package (or the JAX package's ``genmodel``,
which reads the same layout).

Tree models (GBM, XGBoost, DRF), GLM (standardized betas; the
multinomial block; the ordinal betas and thresholds), DeepLearning (each
layer's W and b), KMeans (centers), NaiveBayes (priors and tables),
IsolationForest (the stacked trees) and PCA (eigenvectors and the
demean/descale statistics; an SVD model exports as its PCA) are exported.
GLRM, the extended isolation forest, GAM, CoxPH, PSVM and Word2Vec raise
the JAX package's ``ValueError``, as they do there (their reference-format
MOJOs wait for ``mojo_ref.py``, ROADMAP A4).
"""

from __future__ import annotations

import dataclasses
import io
import json
import zipfile
from typing import Any, Dict, Tuple

import numpy as np

from h2o3_tpu_torch.models.framework import Model

Payload = Tuple[Dict[str, Any], Dict[str, np.ndarray]]


def _info_dict(model: Model) -> Dict[str, Any]:
    return dataclasses.asdict(model.data_info)


def _payload(model: Model) -> Payload:
    """The per-algo payload (the *MojoWriter analogue)."""
    from h2o3_tpu_torch.models.deeplearning import DeepLearningModel
    from h2o3_tpu_torch.models.glm import GLMModel
    from h2o3_tpu_torch.models.isolation_forest import IsolationForestModel
    from h2o3_tpu_torch.models.kmeans import KMeansModel
    from h2o3_tpu_torch.models.naive_bayes import NaiveBayesModel
    from h2o3_tpu_torch.models.pca import PCAModel
    from h2o3_tpu_torch.models.tree.common import TreeModelBase
    from h2o3_tpu_torch.models.tree.drf import DRFModel

    if isinstance(model, GLMModel):
        p = model.params
        meta = {
            "algo": "glm",
            "family": p.family,
            "link": p.actual_link(),
            "tweedie_link_power": p.tweedie_link_power,
            "offset_column": p.offset_column,
        }
        if p.family == "multinomial":
            return meta, {"beta_multi": np.asarray(model.beta_multi, dtype=np.float64)}
        if p.family == "ordinal":
            return meta, {
                # the ordinal beta_std is [P] (no intercept slot; the
                # thresholds play that role), as GLMModel._predict_raw reads it
                "beta_std": np.asarray(model.beta_std, dtype=np.float64),
                "thresholds": np.asarray(model.ordinal_thresholds, dtype=np.float64),
            }
        return meta, {"beta_std": np.asarray(model.beta_std, dtype=np.float64)}
    if isinstance(model, DeepLearningModel):
        p = model.params
        arrays = {}
        for i, (W, bia) in enumerate(model.net_params):
            arrays[f"W_{i}"] = np.asarray(W, dtype=np.float32)
            arrays[f"b_{i}"] = np.asarray(bia, dtype=np.float32)
        meta = {
            "algo": "deeplearning",
            "activation": p.activation.lower(),
            "n_layers": len(model.net_params),
            "autoencoder": bool(p.autoencoder),
        }
        return meta, arrays
    if isinstance(model, KMeansModel):
        return {"algo": "kmeans"}, {
            "centers_std": np.asarray(model.centers_std, dtype=np.float64),
            "centers": np.asarray(model.centers, dtype=np.float64),
        }
    if isinstance(model, NaiveBayesModel):
        arrays = {"priors": np.asarray(model.priors, dtype=np.float64)}
        for name, v in model.num_mean.items():
            arrays[f"mean_{name}"] = np.asarray(v, dtype=np.float64)
        for name, v in model.num_sd.items():
            arrays[f"sd_{name}"] = np.asarray(v, dtype=np.float64)
        for name, v in model.cat_probs.items():
            arrays[f"cat_{name}"] = np.asarray(v, dtype=np.float64)
        return {"algo": "naivebayes"}, arrays
    if isinstance(model, IsolationForestModel):
        feat, thresh, is_split, path_len = model.trees
        return (
            {
                "algo": "isolation_forest",
                "max_depth": int(model.max_depth),
                "c_norm": float(model._cn),
            },
            {
                "feat": np.asarray(feat, dtype=np.int32),
                "thresh": np.asarray(thresh, dtype=np.float64),
                "is_split": np.asarray(is_split, dtype=bool),
                "path_len": np.asarray(path_len, dtype=np.float64),
            },
        )
    if isinstance(model, PCAModel):
        arrays = {"eigenvectors": np.asarray(model.eigenvectors, dtype=np.float64)}
        # the demean/descale statistics live outside the design-matrix
        # layout; without them the scorer would project untransformed rows
        # onto transformed-space eigenvectors
        if model.transform_sub is not None:
            arrays["transform_sub"] = np.asarray(model.transform_sub, dtype=np.float64)
        if model.transform_mul is not None:
            arrays["transform_mul"] = np.asarray(model.transform_mul, dtype=np.float64)
        return {"algo": "pca"}, arrays
    if not isinstance(model, TreeModelBase):
        raise ValueError(f"MOJO export not supported for {type(model).__name__}")
    b = model.booster
    t0 = b.trees_per_class[0]
    if isinstance(model, DRFModel):
        # DRF classification averages votes, clipped and normalized
        # (DRFModel._raw_from_margin), not a link function
        transform = "drf_votes" if model.is_classifier else "identity"
    elif model.distribution in ("bernoulli", "multinomial"):
        transform = model.distribution
    elif model.distribution in ("poisson", "gamma", "tweedie"):
        transform = "exp"  # log link: margin -> response scale
    else:
        transform = "identity"
    meta = {
        "algo": model.algo_name,
        "distribution": model.distribution,
        "transform": transform,
        "n_bins1": int(t0.n_bins1),
        "max_depth": int(t0.max_depth),
        "average": bool(b.average),
        "tree_encoding": getattr(model, "tree_encoding", "label_encoder"),
        # an offset model shifts the margin by the scoring frame's offset
        # column (Model.java offset handling); so must the MOJO
        "offset_column": getattr(model.params, "offset_column", None),
    }
    arrays: Dict[str, np.ndarray] = {
        "edges": np.asarray(t0.edges, dtype=np.float64),
        "init_margin": np.asarray(b.init_margin, dtype=np.float64),
    }
    for c, trees in enumerate(b.trees_per_class):
        arrays[f"feat_{c}"] = np.stack(trees.feat).astype(np.int32)
        arrays[f"split_bin_{c}"] = np.stack(trees.split_bin).astype(np.int32)
        arrays[f"default_left_{c}"] = np.stack(trees.default_left).astype(bool)
        arrays[f"is_split_{c}"] = np.stack(trees.is_split).astype(bool)
        arrays[f"leaf_{c}"] = np.stack(trees.leaf).astype(np.float32)
    return meta, arrays


def write_mojo(model: Model, path: str) -> str:
    """Model.getMojo / ModelMojoWriter.writeTo: serialize to a .mojo zip."""
    meta, arrays = _payload(model)
    info = _info_dict(model)
    # binomial label threshold: offline labels must match Model.predict's,
    # so an explicit reset_threshold wins over the training max-F1 point
    thr = getattr(model, "_threshold_override", None)
    if thr is None:
        thr = getattr(model.training_metrics, "max_f1_threshold", None)
    if thr is not None and np.isfinite(thr):
        meta["default_threshold"] = float(thr)
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    ini_lines = [
        "[info]",
        f"algo = {meta['algo']}",
        "mojo_version = 1.0",
        f"model_key = {model.key}",
        f"nclasses = {model.nclasses}",
        f"n_predictors = {len(model.data_info.predictor_names)}",
        "",
        "[columns]",
        *model.data_info.predictor_names,
    ]
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("model.ini", "\n".join(ini_lines) + "\n")
        z.writestr("meta.json", json.dumps(meta, indent=1))
        z.writestr("data_info.json", json.dumps(info, indent=1))
        z.writestr("arrays.npz", buf.getvalue())
    return path
