"""Model-valued rapids primitives — the port of
``h2o3_tpu/rapids/prims/models.py`` (copied).

Reference: ``water/rapids/ast/prims/models/`` — AstPerfectAUC,
AstModelResetThreshold, AstPermutationVarImp, AstSegmentModelsAsFrame.
These are the reference's rapids-only model operations (no REST route of
their own; clients reach them through ``/99/Rapids``).
``PermutationVarImp`` scores each shuffled frame through the model's
``model_performance``: scoring on the model's device, metrics on the host.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from h2o3_tpu_torch.frame.frame import Column, ColType, Frame
from h2o3_tpu_torch.rapids.prims import prim
from h2o3_tpu_torch.rapids.runtime import Val


def _single_vec(v: Val, what: str) -> np.ndarray:
    fr = v.as_frame()
    if fr.ncols != 1:
        raise ValueError(
            f"Expected a frame containing a single vector of {what}. "
            f"Instead got {fr.ncols} columns")
    return fr.col(0).numeric_view()


def perfect_auc_values(probs: np.ndarray, acts: np.ndarray) -> float:
    """Exact (non-binned) AUC by sorting the full dataset
    (``hex/AUC2.java:589`` perfectAUC).  The reference walks sorted probs
    accumulating trapezoids with a diagonal across tied-probability runs;
    that is exactly the tie-averaged Mann-Whitney statistic, computed here
    with midranks in vectorized numpy."""
    acts = np.asarray(acts, np.float64)
    probs = np.asarray(probs, np.float64)
    if np.any(np.isnan(acts)) or np.any(acts < 0) or np.any(acts > 1) \
            or np.any(acts != np.floor(acts)):
        raise ValueError("Actuals are either 0 or 1")
    if np.any(np.isnan(probs)) or np.any(probs < 0) or np.any(probs > 1):
        raise ValueError("Probabilities are between 0 and 1")
    pos = acts == 1.0
    n_pos = int(pos.sum())
    n_neg = len(acts) - n_pos
    if n_pos == 0 or n_neg == 0:
        return 0.0 if n_pos == 0 else 1.0
    order = np.argsort(probs, kind="stable")
    sp = probs[order]
    # midranks: average 1-based rank over each tied run
    starts = np.concatenate(([0], np.flatnonzero(sp[1:] != sp[:-1]) + 1))
    ends = np.concatenate((starts[1:], [len(sp)]))
    run_rank = (starts + ends + 1) / 2.0  # mean of ranks start+1..end
    ranks = np.empty(len(sp))
    ranks[order] = np.repeat(run_rank, ends - starts)
    u = ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


@prim("perfectAUC")
def _perfect_auc(env, args: List[Val]) -> Val:
    """(perfectAUC probs acts) — AstPerfectAUC."""
    probs = _single_vec(args[0], "probabilities")
    acts = _single_vec(args[1], "actuals")
    auc = perfect_auc_values(probs, acts)
    return Val.frame(Frame([Column("C1", np.array([auc]), ColType.NUM)]))


@prim("model.reset.threshold")
def _reset_threshold(env, args: List[Val]) -> Val:
    """(model.reset.threshold model threshold) — AstModelResetThreshold:
    set the model's classification threshold, return the old one."""
    model = args[0].as_model()
    new_thr = args[1].as_num()
    old = model.reset_threshold(new_thr)
    return Val.frame(Frame([Column("C1", np.array([old]), ColType.NUM)]))


@prim("segment_models_as_frame")
def _segment_models_as_frame(env, args: List[Val]) -> Val:
    """(segment_models_as_frame id) — AstSegmentModelsAsFrame."""
    from h2o3_tpu_torch.models.segments import SegmentModels

    v = args[0]
    obj = v.value
    if v.kind == Val.STR:
        from h2o3_tpu_torch.keyed import DKV

        obj = DKV.get(v.value)
    if not isinstance(obj, SegmentModels):
        raise TypeError(f"expected a SegmentModels id, got {v!r}")
    return Val.frame(obj.as_frame())


# ---------------------------------------------------------------------------
# Permutation variable importance (water/rapids/PermutationVarImp.java)

#: metrics getPermutationVarImp accepts, lowercase (ModelMetrics fields)
_PVI_METRICS = {"auc", "pr_auc", "logloss", "mse", "rmse", "mae", "rmsle",
                "mean_per_class_error", "r2"}


def _metric_of(mm, metric: str) -> float:
    v = getattr(mm, metric, None)
    if v is None or (isinstance(v, float) and np.isnan(v)):
        raise ValueError(
            f"Model doesn't support the following metric {metric}")
    return float(v)


def _infer_metric(model, metric: str) -> str:
    """'auto' -> auc (binomial) / rmse (regression) / logloss (multinomial)
    (PermutationVarImp.inferAndValidateMetric)."""
    metric = metric.lower()
    if metric == "auto":
        if not model.is_classifier:
            return "rmse"
        return "auc" if model.nclasses == 2 else "logloss"
    if metric not in _PVI_METRICS:
        raise ValueError(
            f"Permutation Variable Importance doesn't support {metric}")
    return metric


def permutation_var_imp(
    model, fr: Frame, metric: str = "auto", n_samples: int = -1,
    n_repeats: int = 1, features: Optional[List[str]] = None,
    seed: int = -1,
) -> Frame:
    """One-feature-at-a-time shuffle importance
    (``water/rapids/PermutationVarImp.java:98`` calculatePermutationVarImp):
    score the frame, then for each predictor shuffle its column, rescore,
    and record |metric - baseline|.  n_repeats=1 yields the
    relative/scaled/percentage table (ModelMetrics.calcVarImp); >1 yields
    one column per run, rows ordered by the first run's importance."""
    metric = _infer_metric(model, metric)
    if n_samples < -1 or n_samples in (0, 1) or n_samples > fr.nrows:
        raise ValueError(
            "Argument n_samples has to be either -1 to use the whole frame "
            "or greater than 2 and lower than or equal to the number of "
            "rows of the provided frame!")
    if n_repeats < 1:
        raise ValueError("Argument n_repeats must be greater than 0!")

    names = fr.names
    non_pred = {model.params.response_column,
                getattr(model.params, "weights_column", None),
                getattr(model.params, "offset_column", None),
                getattr(model.params, "fold_column", None)}
    non_pred |= set(getattr(model.params, "ignored_columns", None) or [])
    if features:
        missing = [f for f in features if f not in names]
        if missing:
            raise ValueError(
                "Features " + ", ".join(missing) +
                " are not present in the provided frame!")
        not_used = [f for f in features
                    if f not in model.data_info.predictor_names]
        if not_used:
            raise ValueError(
                "Features " + ", ".join(not_used) +
                " weren't used for training!")
        todo = set(features) - non_pred
    else:
        # the model's predictors, not the frame's columns: an extra
        # non-predictor column (id/join key) must not be shuffled and
        # rescored (PermutationVarImp iterates the model's features)
        todo = (set(model.data_info.predictor_names) & set(names)) - non_pred

    runs: List[Dict[str, float]] = []
    full_base: Optional[float] = None
    for rep in range(n_repeats):
        rep_seed = None if seed == -1 else seed + rep
        rng = np.random.default_rng(rep_seed)
        if n_samples > 1:
            # without replacement, like MRUtils.sampleFrame — a duplicated
            # row would double-weight its metric contribution
            idx = rng.choice(fr.nrows, size=n_samples, replace=False)
            sub = fr.rows(idx)
            base = _metric_of(model.model_performance(sub), metric)
        else:
            sub = fr
            if full_base is None:  # same frame every repeat: score once
                full_base = _metric_of(
                    model.model_performance(sub), metric)
            base = full_base
        result: Dict[str, float] = {}
        cols = list(sub.columns)
        for j, name in enumerate(sub.names):
            if name not in todo:
                continue
            orig = cols[j]
            shuf = orig.copy()
            shuf.data = shuf.data[rng.permutation(len(shuf.data))]
            cols[j] = shuf
            mm = model.model_performance(Frame(cols))
            result[name] = abs(_metric_of(mm, metric) - base)
            cols[j] = orig
        runs.append(result)

    feats = sorted(runs[0], key=runs[0].get, reverse=True)
    var_col = Column("Variable", np.asarray(feats, dtype=object), ColType.STR)
    if n_repeats == 1:
        imp = np.array([runs[0][f] for f in feats])
        mx, tot = imp.max() if len(imp) else 1.0, imp.sum()
        return Frame([
            var_col,
            Column("Relative Importance", imp, ColType.NUM),
            Column("Scaled Importance",
                   imp / mx if mx else imp, ColType.NUM),
            Column("Percentage", imp / tot if tot else imp, ColType.NUM),
        ])
    cols = [var_col]
    for rep in range(n_repeats):
        cols.append(Column(f"Run {rep + 1}",
                           np.array([runs[rep][f] for f in feats]),
                           ColType.NUM))
    return Frame(cols)


@prim("PermutationVarImp")
def _permutation_var_imp(env, args: List[Val]) -> Val:
    """(PermutationVarImp model frame metric n_samples n_repeats features
    seed) — AstPermutationVarImp."""
    model = args[0].as_model()
    fr = args[1].as_frame()
    metric = args[2].as_str()
    n_samples = args[3].as_int()
    n_repeats = args[4].as_int()
    features = None
    if args[5].kind == Val.STRS and args[5].value:
        features = args[5].as_strs()
    elif args[5].kind == Val.STR and args[5].value:
        features = [args[5].as_str()]
    seed = args[6].as_int()
    return Val.frame(permutation_var_imp(
        model, fr, metric, n_samples, n_repeats, features, seed))
