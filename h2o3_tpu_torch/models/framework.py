"""Model framework — the port of ``h2o3_tpu/models/framework.py``.

Parameters / Job / Model / ModelBuilder lifecycle (``hex/Model.java``,
``hex/ModelBuilder.java:368-377``, ``water/Job.java``): validate the
parameters, build, cross-validate (``nfolds`` or ``fold_column``), score,
compute metrics. ``ModelBuilder.train`` resolves the device the build runs
on once (``device.resolve_device``) and the model keeps it, so scoring runs
where training ran; the fold fits run there too.

A trained ``Model`` scores one frame (``predict``, ``model_performance``)
or several in one pass (``predict_raw_batched``: identical frames once,
distinct frames of one schema row-stacked into one scoring pass on the
device), resets its binomial threshold, and is exported through
``models/persist.py`` (binary), ``models/mojo_export.py`` (MOJO) and
``models/pojo.py`` (C or Java source).

A model trained on a preprocessed frame (AutoML's target encoding) carries
its transformers in ``preprocessors``, and every scoring entry point
passes a raw frame through them first (``_apply_preprocessors``).

Not part of this package yet: the telemetry spans and homing a finished
model on a cluster's serving ring.
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass, field as dataclass_field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from h2o3_tpu_torch.device import resolve_device
from h2o3_tpu_torch.frame.frame import ColType, Column, Frame
from h2o3_tpu_torch.keyed import DKV
from h2o3_tpu_torch.models import metrics as M
from h2o3_tpu_torch.models.data_info import DataInfo, response_vector


@dataclass
class ModelParameters:
    """Common hyperparameters (hex/Model.Parameters).

    ``device``: where the build runs — ``"cuda"``, ``"cpu"``, or None for
    the innermost ``use_device`` block, else ``cuda``."""

    response_column: Optional[str] = None
    ignored_columns: List[str] = dataclass_field(default_factory=list)
    weights_column: Optional[str] = None
    offset_column: Optional[str] = None
    fold_column: Optional[str] = None
    nfolds: int = 0
    fold_assignment: str = "auto"
    keep_cross_validation_predictions: bool = False
    seed: int = -1
    max_runtime_secs: float = 0.0
    stopping_rounds: int = 0
    stopping_metric: str = "auto"
    stopping_tolerance: float = 1e-3
    categorical_encoding: str = "auto"
    checkpoint: Optional[str] = None
    device: Optional[str] = None

    def actual_seed(self) -> int:
        if self.seed is None or self.seed == -1:
            return int(time.time_ns() % (2**31))
        return int(self.seed)


class Job:
    """Cancellable, progress-reporting handle (water/Job.java)."""

    def __init__(self, description: str = "") -> None:
        self.key = DKV.make_key("job")
        self.description = description
        self.progress = 0.0
        self.status = "CREATED"
        self.start_time: Optional[float] = None
        self.end_time: Optional[float] = None
        self.exception: Optional[BaseException] = None
        self._cancel_requested = False
        DKV.put(self.key, self)

    def start(self) -> "Job":
        self.start_time = time.time()
        self.status = "RUNNING"
        return self

    def update(self, progress: float) -> None:
        self.progress = min(max(progress, 0.0), 1.0)

    def cancel(self) -> None:
        self._cancel_requested = True

    @property
    def stop_requested(self) -> bool:
        return self._cancel_requested

    def done(self) -> None:
        self.end_time = time.time()
        self.progress = 1.0
        self.status = "DONE" if not self._cancel_requested else "CANCELLED"

    def fail(self, e: BaseException) -> None:
        self.end_time = time.time()
        self.exception = e
        self.status = "FAILED"

    @property
    def run_time(self) -> float:
        end = self.end_time if self.end_time is not None else time.time()
        return (end - self.start_time) if self.start_time else 0.0


def prediction_frame(raw: np.ndarray, domain, threshold: float = 0.5) -> Frame:
    """Raw scores -> the predictions frame (Model.score layout): 'predict'
    plus, for a classifier, one probability column per class. Binomial
    labels threshold ``p[:, 1]``; multinomial labels take the argmax."""
    if domain is None:
        if raw.ndim == 1:
            return Frame([Column("predict", raw.astype(np.float64), ColType.NUM)])
        return Frame([
            Column(f"C{k + 1}", raw[:, k].astype(np.float64), ColType.NUM)
            for k in range(raw.shape[1])
        ])
    if raw.shape[1] == 2:
        labels = (raw[:, 1] >= threshold).astype(np.int32)
    else:
        labels = raw.argmax(axis=1).astype(np.int32)
    cols = [Column("predict", labels, ColType.CAT, list(domain))]
    for k, lv in enumerate(domain):
        cols.append(Column(f"p{lv}", raw[:, k].astype(np.float64), ColType.NUM))
    return Frame(cols)


class Model:
    """Trained model: predict + metrics (hex/Model.java).

    Subclasses implement ``_predict_raw(frame) -> np.ndarray``: [N] for
    regression, [N, K] class probabilities for a classifier."""

    algo_name: str = "model"

    def __init__(self, params: ModelParameters, data_info: DataInfo,
                 device: torch.device) -> None:
        self.key = DKV.make_key(self.algo_name)
        self.params = params
        self.data_info = data_info
        self.device = device
        self.training_metrics: Optional[Any] = None
        self.validation_metrics: Optional[Any] = None
        self.cross_validation_metrics: Optional[Any] = None
        self.scoring_history: List[Dict[str, Any]] = []
        self.run_time: float = 0.0
        DKV.put(self.key, self)

    @property
    def nclasses(self) -> int:
        dom = self.data_info.response_domain
        return len(dom) if dom else 1

    @property
    def is_classifier(self) -> bool:
        return self.nclasses > 1

    def _predict_raw(self, frame: Frame) -> np.ndarray:
        raise NotImplementedError

    def _apply_preprocessors(self, frame: Frame) -> Frame:
        """The scoring frame as the model's preprocessors give it. A model
        trained on a preprocessed frame (AutoML's target encoding) carries
        its transformers in ``self.preprocessors``, so a raw frame scores
        as the training frame did; a frame that already holds every
        ``<col>_te`` column of a preprocessor passes it untouched."""
        for pre in getattr(self, "preprocessors", None) or []:
            outs = [f"{name}_te" for name in getattr(pre, "encodings", {})]
            if outs and all(o in frame.names for o in outs):
                continue
            frame = pre.transform(frame)
        return frame

    def default_threshold(self) -> float:
        """Binomial label threshold: an explicit reset wins, else the
        training max-F1 (Model._output.defaultThreshold())."""
        override = getattr(self, "_threshold_override", None)
        if override is not None:
            return override
        return getattr(self.training_metrics, "max_f1_threshold", 0.5) or 0.5

    def reset_threshold(self, threshold: float) -> float:
        """Set the classification threshold used by predict; returns the
        previous effective threshold (Model.resetThreshold)."""
        old = self.default_threshold()
        self._threshold_override = float(threshold)
        return old

    def predict(self, frame: Frame) -> Frame:
        """Predictions frame: 'predict' (+ per-class probability columns)."""
        frame = self._apply_preprocessors(frame)
        return self.prediction_from_raw(self._predict_raw(frame))

    def prediction_from_raw(self, raw: np.ndarray) -> Frame:
        """Raw scores -> the predictions frame (the second half of
        ``predict``, for raw scores computed once for several callers)."""
        if not self.is_classifier:
            return prediction_frame(raw, None)
        return prediction_frame(raw, self.data_info.response_domain,
                                self.default_threshold())

    def predict_raw_batched(
        self, frames: Sequence[Frame]
    ) -> List[Tuple[np.ndarray, Frame]]:
        """One raw-score pass over several frames. Returns ``(raw,
        preprocessed_frame)`` per input, aligned. Identical frames (same
        object, or equal (names, types, version) stamps) score once and
        share the result; distinct frames of one schema are row-stacked
        (``Frame.rbind``) into one ``_predict_raw``, one binning and tree
        walk on the device, and split back per caller. The walk scores each
        row alone, so each caller's raw scores are the bits of a
        ``_predict_raw`` of its frame alone; frames of different schemas
        score one pass each."""
        pres = [self._apply_preprocessors(f) for f in frames]
        uniq: List[Frame] = []
        which: List[int] = []
        seen: Dict[Any, int] = {}
        for f in pres:
            sig = (tuple(f.names), tuple(c.type for c in f.columns), f.version)
            i = seen.get(sig)
            if i is None:
                i = seen[sig] = len(uniq)
                uniq.append(f)
            which.append(i)
        if len(uniq) == 1:
            raws = [self._predict_raw(uniq[0])]
        else:
            head = uniq[0]
            same_schema = all(
                u.names == head.names
                and [c.type for c in u.columns] == [c.type for c in head.columns]
                for u in uniq[1:]
            )
            if same_schema:
                stacked = head
                for u in uniq[1:]:
                    stacked = stacked.rbind(u)
                raw_all = self._predict_raw(stacked)
                raws, off = [], 0
                for u in uniq:
                    raws.append(raw_all[off:off + u.nrows])
                    off += u.nrows
            else:
                raws = [self._predict_raw(u) for u in uniq]
        return [(raws[i], pres[k]) for k, i in enumerate(which)]

    def model_performance(self, frame: Frame) -> Any:
        """Score a frame and build its ModelMetrics."""
        frame = self._apply_preprocessors(frame)
        return self._metrics_from_raw(frame, self._predict_raw(frame))

    def _metrics_from_raw(self, frame: Frame, raw: np.ndarray) -> Any:
        """ModelMetrics from raw scores already computed over an already
        preprocessed frame: ``model_performance`` without its scoring pass."""
        y = response_vector(self.data_info, frame)
        w = (
            frame.col(self.params.weights_column).numeric_view()
            if self.params.weights_column
            else None
        )
        if not self.is_classifier:
            return M.regression_metrics(y, raw, weights=w)
        if self.nclasses == 2:
            return M.binomial_metrics(y, raw[:, 1], weights=w)
        return M.multinomial_metrics(
            y.astype(np.int64), raw, self.data_info.response_domain, weights=w
        )

    def pojo(self, lang: str = "c") -> str:
        """Standalone scoring source (TreeJCodeGen, water/codegen): C, which
        compiles with any C99 compiler, or Java in the genmodel ``score0``
        shape. Tree models (C or Java), GLM and GAM (C)."""
        from h2o3_tpu_torch.models.pojo import pojo_source

        return pojo_source(self, lang)

    def download_mojo(self, path: str) -> str:
        """Export as a MOJO zip (Model.getMojo), scored offline by the
        numpy-only ``h2o3_tpu_torch.genmodel`` package."""
        from h2o3_tpu_torch.models.mojo_export import write_mojo

        return write_mojo(self, path)

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.key} metrics={self.training_metrics!r}>"


class ModelBuilder:
    """Train lifecycle (hex/ModelBuilder.java:368-377 trainModel).

    Subclasses implement ``_fit(frame, valid, device) -> Model``."""

    algo_name: str = "builder"

    #: common ModelParameters fields this builder honors; any other guarded
    #: field set to a non-default value raises instead of being ignored
    SUPPORTED_COMMON: frozenset = frozenset()

    _GUARDED_DEFAULTS = {
        "weights_column": None,
        "offset_column": None,
        "checkpoint": None,
        "stopping_rounds": 0,
        "max_runtime_secs": 0.0,
        "categorical_encoding": "auto",
    }

    def __init__(self, params: ModelParameters) -> None:
        self.params = params
        self.job: Optional[Job] = None

    def _validate_params(self) -> None:
        """The checks that need no frame: the guard on common parameters
        and the cross-validation settings. A builder without a training
        frame (``Generic``) runs these alone."""
        p = self.params
        for name, default in self._GUARDED_DEFAULTS.items():
            val = getattr(p, name, default)
            if val != default and name not in self.SUPPORTED_COMMON:
                raise ValueError(
                    f"{self.algo_name} does not support {name!r} "
                    f"(got {val!r}); supported common params: "
                    f"{sorted(self.SUPPORTED_COMMON) or 'none'}"
                )
        if p.nfolds == 1:
            raise ValueError("nfolds must be 0 or >= 2")
        if p.nfolds and p.fold_column:
            raise ValueError("cannot use both nfolds and fold_column")

    def _validate(self, frame: Frame) -> None:
        self._validate_params()
        p = self.params
        if p.response_column and p.response_column not in frame.names:
            raise ValueError(f"response_column {p.response_column!r} not in frame")
        if p.weights_column and p.weights_column not in frame.names:
            raise ValueError(f"weights_column {p.weights_column!r} not in frame")

    def _fit(self, frame: Frame, valid: Optional[Frame],
             device: torch.device) -> Model:
        raise NotImplementedError

    def train(self, frame: Frame, valid: Optional[Frame] = None) -> Model:
        self._validate(frame)
        device = resolve_device(self.params.device)
        self.job = Job(f"{self.algo_name} train").start()
        t0 = time.time()
        # the training frame(s) must not be deleted mid-build (Lockable)
        locked = [
            fr.key for fr in (frame, valid)
            if fr is not None and getattr(fr, "key", None)
        ]
        for k in locked:
            DKV.read_lock(k, self.job.key)
        # a failed build leaves no half-built model in the DKV
        DKV.scope_enter()
        keep = [self.job.key]
        try:
            model = self._fit(frame, valid, device)
            if self.params.nfolds >= 2 or self.params.fold_column:
                self._cross_validate(model, frame, device)
            model.run_time = time.time() - t0
            self.job.done()
            keep = None
            return model
        except BaseException as e:
            self.job.fail(e)
            raise
        finally:
            DKV.scope_exit(keep=DKV.keys() if keep is None else keep)
            for k in locked:
                DKV.read_unlock(k, self.job.key)

    # -- cross-validation (ModelBuilder.computeCrossValidation) --------------
    def _cross_validate(self, main_model: Model, frame: Frame,
                        device: torch.device) -> None:
        """Fit one model per fold on the other folds' rows, score its
        holdout, and give the main model the metrics of the assembled
        holdout predictions (``cross_validation_metrics``), the fold models
        (``cv_models``) and, with ``keep_cross_validation_predictions``,
        the predictions (``cv_holdout_predictions``)."""
        p = self.params
        fold = fold_assignment(
            n=frame.nrows,
            nfolds=p.nfolds,
            scheme=p.fold_assignment,
            seed=p.actual_seed(),
            y=response_vector(main_model.data_info, frame)
            if p.fold_assignment == "stratified" else None,
            fold_column=frame.col(p.fold_column).numeric_view().astype(np.int64)
            if p.fold_column
            else None,
        )
        nfolds = int(fold.max()) + 1
        nclasses = main_model.nclasses
        holdout = (
            np.full(frame.nrows, np.nan)
            if nclasses == 1
            else np.full((frame.nrows, nclasses), np.nan)
        )
        cv_models = []
        for f in range(nfolds):
            tr = frame.rows(fold != f)
            te = frame.rows(fold == f)
            sub = type(self)(_clone_params_no_cv(p))
            m = sub._fit(tr, None, device)
            cv_models.append(m)
            holdout[fold == f] = m._predict_raw(te)
            self.job.update(0.5 + 0.5 * (f + 1) / nfolds)
        y = response_vector(main_model.data_info, frame)
        w = (
            frame.col(p.weights_column).numeric_view() if p.weights_column else None
        )
        if nclasses == 1:
            main_model.cross_validation_metrics = M.regression_metrics(y, holdout, weights=w)
        elif nclasses == 2:
            main_model.cross_validation_metrics = M.binomial_metrics(y, holdout[:, 1], weights=w)
        else:
            main_model.cross_validation_metrics = M.multinomial_metrics(
                y.astype(np.int64), holdout, main_model.data_info.response_domain, weights=w
            )
        main_model.cv_models = cv_models
        if p.keep_cross_validation_predictions:
            main_model.cv_holdout_predictions = holdout


def _clone_params_no_cv(p: ModelParameters) -> ModelParameters:
    q = copy.deepcopy(p)
    q.nfolds = 0
    q.fold_column = None
    return q


def fold_assignment(
    n: int,
    nfolds: int,
    scheme: str = "auto",
    seed: int = 42,
    y: Optional[np.ndarray] = None,
    fold_column: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Row -> fold id (hex/FoldAssignment.java). auto==random; modulo is
    deterministic row%nfolds; stratified balances class frequencies per fold."""
    if fold_column is not None:
        vals = fold_column
        uniq = np.unique(vals)
        remap = {v: i for i, v in enumerate(uniq)}
        return np.array([remap[v] for v in vals], dtype=np.int64)
    if scheme in ("auto", "random"):
        rng = np.random.default_rng(seed)
        return rng.integers(0, nfolds, size=n)
    if scheme == "modulo":
        return np.arange(n) % nfolds
    if scheme == "stratified":
        if y is None:
            raise ValueError("stratified fold assignment needs the response")
        rng = np.random.default_rng(seed)
        fold = np.zeros(n, dtype=np.int64)
        for cls in np.unique(y[~np.isnan(y)]):
            idx = np.nonzero(y == cls)[0]
            perm = rng.permutation(len(idx))
            fold[idx[perm]] = np.arange(len(idx)) % nfolds
        return fold
    raise ValueError(f"unknown fold_assignment {scheme!r}")
