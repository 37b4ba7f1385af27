"""The AutoML orchestrator — the port of ``h2o3_tpu/automl/automl.py``: steps,
budget, leaderboard, event log.

Reference call shape: ``H2OAutoML(max_models=…, max_runtime_secs=…,
seed=…).train(y=…, training_frame=…)``, then ``aml.leaderboard`` and
``aml.leader``. The default modeling plan follows the reference's step
sequence (AutoML.java defaultModelingPlan: XGBoost defaults, GLM, DRF, GBM
defaults, DeepLearning, a random GBM grid, exploitation, and the
best-of-family and all-models stacked ensembles); every model is trained
with k-fold CV and the leaderboard ranks by the CV metric
(``leaderboard/Leaderboard.java``).

The run resolves its device once, when ``train`` starts (``device=``, else
the caller's ``use_device`` block, else ``cuda``), and every model it
builds carries it in its parameters: the target encoder, each step, the
grid's cells and the ensembles' metalearners. A failed step, or failed
target encoding, is logged in the event log and the run carries on, as in
the JAX package.

Not part of this package yet: fanning the plan's independent steps across
a cluster (``cluster/search.py``; ROADMAP A10). ``_distribute_prefix``
keeps its contract and returns the plan unchanged, the JAX package's own
behaviour when no cloud is live.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from h2o3_tpu_torch.device import DeviceLike, resolve_device
from h2o3_tpu_torch.frame.frame import ColType, Frame
from h2o3_tpu_torch.keyed import DKV
from h2o3_tpu_torch.models.framework import Model
from h2o3_tpu_torch.models.grid import metric_value


class EventLog:
    """events/EventLog.java — timestamped orchestration trace."""

    def __init__(self) -> None:
        self.events: List[Dict[str, Any]] = []

    def log(self, stage: str, message: str) -> None:
        self.events.append(
            {"timestamp": time.time(), "stage": stage, "message": message}
        )

    def __repr__(self) -> str:
        return f"<EventLog {len(self.events)} events>"


class Leaderboard:
    """leaderboard/Leaderboard.java — models ranked by the sort metric."""

    def __init__(self, sort_metric: str = "auto") -> None:
        self.sort_metric = sort_metric
        self.models: List[Model] = []

    def add(self, model: Model) -> None:
        self.models.append(model)
        self._sort()

    def _sort(self) -> None:
        vals = [metric_value(m, self.sort_metric) for m in self.models]
        larger = vals[0][1] if vals else True
        order = np.argsort([v for v, _ in vals])
        if larger:
            order = order[::-1]
        order = sorted(order, key=lambda i: np.isnan(vals[i][0]))
        self.models = [self.models[i] for i in order]

    @property
    def leader(self) -> Optional[Model]:
        return self.models[0] if self.models else None

    def as_table(self) -> List[Dict[str, Any]]:
        out = []
        for m in self.models:
            v, _ = metric_value(m, self.sort_metric)
            out.append({"model_id": m.key, "algo": m.algo_name, "metric": v})
        return out

    def __repr__(self) -> str:
        rows = "\n".join(
            f"  {r['model_id']}  {r['algo']}  {r['metric']:.5f}"
            for r in self.as_table()[:10]
        )
        return f"<Leaderboard ({self.sort_metric})>\n{rows}"


@dataclass
class _Step:
    """StepDefinition/ModelingStep — one budgeted training unit."""

    id: str
    weight: int  # work allocation units (WorkAllocations.java)
    build: Callable[["AutoML", Frame], List[Model]]


class AutoML:
    """The orchestrator (AutoML.java:40). ``device``: where every model of
    the run is built, resolved when ``train`` starts."""

    def __init__(
        self,
        max_models: int = 10,
        max_runtime_secs: float = 0.0,
        seed: int = -1,
        nfolds: int = 5,
        sort_metric: str = "auto",
        include_algos: Optional[Sequence[str]] = None,
        exclude_algos: Optional[Sequence[str]] = None,
        keep_cross_validation_predictions: bool = True,
        preprocessing: Optional[Sequence[str]] = None,
        exploitation_ratio: float = 0.1,
        device: DeviceLike = None,
    ) -> None:
        self.max_models = max_models
        self.max_runtime_secs = max_runtime_secs
        self.seed = seed
        self.nfolds = max(2, nfolds)
        self.sort_metric = sort_metric
        self.include_algos = set(a.lower() for a in include_algos) if include_algos else None
        self.exclude_algos = set(a.lower() for a in exclude_algos) if exclude_algos else set()
        self.keep_cv_preds = keep_cross_validation_predictions
        #: ["target_encoding"] enables the TE preprocessing step
        #: (h2o-automl/.../preprocessing/TargetEncoding.java)
        self.preprocessing = [p.lower() for p in (preprocessing or [])]
        for p_ in self.preprocessing:
            if p_ != "target_encoding":
                raise ValueError(f"unknown preprocessing step {p_!r}")
        #: fraction of the budget reserved for refining the best model
        #: (the reference's exploitation phase, AutoML exploitation_ratio)
        self.exploitation_ratio = float(exploitation_ratio)
        self.device = device
        self.project_key = DKV.make_key("automl")
        self.leaderboard = Leaderboard(sort_metric)
        self.event_log = EventLog()
        self._t0 = 0.0
        self._y: Optional[str] = None
        self._ignored: List[str] = []
        self._nclasses: int = 1
        self._te_model = None
        self._device: Optional[torch.device] = None
        DKV.put(self.project_key, self)

    # -- budget (WorkAllocations.java) ---------------------------------------
    def _max_models_reached(self) -> bool:
        # the reference does not count Stacked Ensembles against max_models
        n = len([
            m for m in self.leaderboard.models
            if m.algo_name != "stackedensemble"
        ])
        return bool(self.max_models) and n >= self.max_models

    def _out_of_time(self) -> bool:
        return bool(self.max_runtime_secs) and (
            time.time() - self._t0
        ) >= self.max_runtime_secs

    def _algo_allowed(self, algo: str) -> bool:
        algo = algo.lower()
        if self.include_algos is not None:
            return algo in self.include_algos
        return algo not in self.exclude_algos

    # -- steps (modeling/*StepsProvider) -------------------------------------
    def _common(self, extra: Dict[str, Any]) -> Dict[str, Any]:
        return {
            "response_column": self._y,
            "ignored_columns": list(self._ignored),
            "nfolds": self.nfolds,
            "keep_cross_validation_predictions": self.keep_cv_preds,
            "seed": self.seed if self.seed != -1 else 42,
            "device": self._device,
            **extra,
        }

    def _one(self, builder_cls, params_cls, frame, **extra) -> List[Model]:
        # pass the remaining wall-clock budget into builders that can
        # enforce it mid-build; others keep step-boundary enforcement only
        if self.max_runtime_secs and "max_runtime_secs" in getattr(
            builder_cls, "SUPPORTED_COMMON", ()
        ):
            remaining = self.max_runtime_secs - (time.time() - self._t0)
            if remaining > 0:
                extra.setdefault("max_runtime_secs", remaining)
        p = params_cls(**self._common(extra))
        m = builder_cls(p).train(frame)
        return [m]

    # -- preprocessing (preprocessing/TargetEncoding.java) -------------------
    def _apply_target_encoding(self, frame: Frame) -> Frame:
        """Fit a k-fold-leakage-safe target encoder on the training frame
        and append ``<col>_te`` columns; every model of the run carries the
        encoder, so raw frames score as the training frame did."""
        from h2o3_tpu_torch.models.target_encoder import (
            TargetEncoder,
            TargetEncoderParameters,
        )

        cat_cols = [
            c.name for c in frame.columns
            if c.type is ColType.CAT and c.name != self._y
            and c.name not in self._ignored
        ]
        if not cat_cols:
            self.event_log.log(
                "DataProcessing", "target encoding skipped: no categorical columns"
            )
            return frame
        # nfolds stays 0 on the params (no model-level CV for a transform);
        # the encoder's k_fold leakage handling defaults to 5 folds itself
        te = TargetEncoder(
            TargetEncoderParameters(
                response_column=self._y,
                columns_to_encode=cat_cols,
                data_leakage_handling="k_fold",
                blending=True,
                seed=self.seed if self.seed != -1 else 42,
                device=self._device,
            )
        ).train(frame)
        self._te_model = te
        out = te.transform(frame, as_training=True)
        self.event_log.log(
            "DataProcessing",
            f"target encoding applied to {len(cat_cols)} columns "
            f"(k_fold leakage handling) -> {te.key}",
        )
        return out

    def _default_plan(self) -> List[_Step]:
        from h2o3_tpu_torch.models.deeplearning import DeepLearning, DeepLearningParameters
        from h2o3_tpu_torch.models.glm import GLM, GLMParameters
        from h2o3_tpu_torch.models.tree.drf import DRF, DRFParameters
        from h2o3_tpu_torch.models.tree.gbm import GBM, GBMParameters
        from h2o3_tpu_torch.models.tree.xgboost import XGBoost, XGBoostParameters

        steps: List[_Step] = []

        def add(algo: str, sid: str, weight: int, fn) -> None:
            if self._algo_allowed(algo):
                steps.append(_Step(f"{algo}_{sid}", weight, fn))

        def one(bcls, pcls, **extra):
            """A single-model step's build."""
            return lambda a, f: a._one(bcls, pcls, f, **extra)

        fam = (
            "multinomial" if self._nclasses > 2
            else "binomial" if self._nclasses == 2 else "gaussian"
        )
        # the reference's default plan order (AutoML.java defaultModelingPlan)
        add("xgboost", "def_1", 10, one(
            XGBoost, XGBoostParameters, ntrees=50, max_depth=6, learn_rate=0.1))
        add("glm", "def_1", 10, one(
            GLM, GLMParameters, family=fam, alpha=0.5, lambda_=1e-4))
        add("drf", "def_1", 10, one(
            DRF, DRFParameters, ntrees=50, max_depth=12))
        add("gbm", "def_1", 10, one(
            GBM, GBMParameters, ntrees=50, max_depth=5, learn_rate=0.1))
        add("gbm", "def_2", 10, one(
            GBM, GBMParameters, ntrees=50, max_depth=3, learn_rate=0.1))
        add("deeplearning", "def_1", 10, one(
            DeepLearning, DeepLearningParameters, hidden=[32, 32], epochs=10))
        add("xgboost", "def_2", 10, one(
            XGBoost, XGBoostParameters, ntrees=100, max_depth=4, learn_rate=0.05))
        add("gbm", "grid_1", 20, self._gbm_grid)
        if self.exploitation_ratio > 0:
            steps.append(_Step("exploitation", 10, lambda a, f: a._exploitation(f)))
        add("stackedensemble", "best_of_family", 5,
            lambda a, f: a._stacked(f, best_of_family=True))
        add("stackedensemble", "all", 5, lambda a, f: a._stacked(f, best_of_family=False))
        return steps

    def _distribute_prefix(self, steps: List[_Step], frame: Frame) -> List[_Step]:
        """Fan the plan's leading run of fully determined single-model steps
        across a live cloud and return the steps left for the sequential
        loop. This package has no cloud yet (ROADMAP A10), so every step
        stays in the loop: the plan comes back unchanged."""
        return steps

    def _gbm_grid(self, a: "AutoML", frame: Frame) -> List[Model]:
        """Random GBM grid (modeling/GBMStepsProvider grid step)."""
        from h2o3_tpu_torch.models.grid import GridSearch, SearchCriteria
        from h2o3_tpu_torch.models.tree.gbm import GBM, GBMParameters

        budget_models = 3
        if self.max_models:
            budget_models = max(
                1, min(3, self.max_models - len(self.leaderboard.models) - 2)
            )
        remaining = (
            self.max_runtime_secs - (time.time() - self._t0)
            if self.max_runtime_secs else 0.0
        )
        crit = SearchCriteria(
            strategy="RandomDiscrete",
            max_models=budget_models,
            max_runtime_secs=max(remaining, 0.0),
            seed=self.seed if self.seed != -1 else 42,
        )
        gs = GridSearch(
            GBM,
            GBMParameters(**self._common({})),
            {
                "max_depth": [3, 5, 7, 9],
                "learn_rate": [0.05, 0.1, 0.2],
                "sample_rate": [0.6, 0.8, 1.0],
            },
            search_criteria=crit,
        )
        grid = gs.train(frame)
        return list(grid.models)

    def _exploitation(self, frame: Frame) -> List[Model]:
        """Refine the current best boosted model (the reference's
        exploitation phase spends exploitation_ratio of the budget
        improving the champion): retrain the leader's booster with more
        trees at a lower learning rate."""
        # only boosted champions: DRF has no learn_rate
        leaders = [
            m for m in self.leaderboard.models
            if m.algo_name in ("gbm", "xgboost")
        ]
        if not leaders:
            self.event_log.log("ModelTraining", "skip exploitation: no boosted leader")
            return []
        best = leaders[0]  # leaderboard sorted best-first
        p = best.params
        kw = {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}
        kw.update(
            ntrees=int(p.ntrees * 1.5) + 10,
            learn_rate=max(getattr(p, "learn_rate", 0.1) * 0.75, 0.01),
        )
        if self.max_runtime_secs:
            remaining = self.max_runtime_secs - (time.time() - self._t0)
            if remaining <= 0:
                return []
            kw["max_runtime_secs"] = remaining
        from h2o3_tpu_torch.api.registry import algo_map

        bcls, pcls = algo_map()[best.algo_name]
        self.event_log.log(
            "ModelTraining",
            f"exploitation: refining {best.key} "
            f"(ntrees {p.ntrees} -> {kw['ntrees']})",
        )
        return [bcls(pcls(**kw)).train(frame)]

    def _stacked(self, frame: Frame, best_of_family: bool) -> List[Model]:
        from h2o3_tpu_torch.models.stacked_ensemble import (
            StackedEnsemble,
            StackedEnsembleParameters,
        )

        bases = [
            m for m in self.leaderboard.models
            if m.algo_name != "stackedensemble"
            and getattr(m, "cv_holdout_predictions", None) is not None
        ]
        if best_of_family:
            seen: Dict[str, Model] = {}
            for m in bases:  # leaderboard is sorted best-first
                seen.setdefault(m.algo_name, m)
            bases = list(seen.values())
        if len(bases) < 2:
            self.event_log.log("ModelTraining", "skip ensemble: <2 base models")
            return []
        p = StackedEnsembleParameters(
            response_column=self._y, base_models=bases, device=self._device
        )
        return [StackedEnsemble(p).train(frame)]

    # -- the run (AutoML.learn) ----------------------------------------------
    def train(
        self,
        y: str,
        training_frame: Frame,
        x: Optional[Sequence[str]] = None,
        leaderboard_frame: Optional[Frame] = None,
    ) -> Model:
        self._device = resolve_device(self.device)
        self._y = y
        self._t0 = time.time()
        ev = self.event_log
        ev.log("Workflow", f"AutoML build started: {self.project_key}")
        self._ignored = (
            [c for c in training_frame.names if c not in x and c != y]
            if x is not None else []
        )
        ycol = training_frame.col(y)
        self._nclasses = len(ycol.domain) if ycol.domain else 1

        if "target_encoding" in self.preprocessing:
            try:
                training_frame = self._apply_target_encoding(training_frame)
            except Exception as e:  # preprocessing failure never kills the run
                ev.log("DataProcessing", f"target encoding failed: {e}")

        plan = self._distribute_prefix(self._default_plan(), training_frame)
        for step in plan:
            if self._out_of_time():
                ev.log("Workflow", f"time budget exhausted before {step.id}")
                break
            if self._max_models_reached() and not step.id.startswith(
                "stackedensemble"
            ):
                # ensembles still run: they are not counted (reference
                # AutoML max_models semantics)
                ev.log("Workflow", f"max_models reached, skipping {step.id}")
                continue
            ev.log("ModelTraining", f"step {step.id} starting")
            try:
                models = step.build(self, training_frame)
            except Exception as e:  # a failed step never kills the run
                ev.log("ModelTraining", f"step {step.id} failed: {e}")
                continue
            for m in models:
                if self._te_model is not None:
                    # raw frames score correctly: the model re-applies the
                    # encoder at predict time (Model._apply_preprocessors)
                    m.preprocessors = [self._te_model]
                self.leaderboard.add(m)
                v, _ = metric_value(m, self.sort_metric)
                ev.log("ModelTraining", f"{step.id} -> {m.key} metric={v:.5f}")
        ev.log(
            "Workflow",
            f"AutoML build done: {len(self.leaderboard.models)} models in "
            f"{time.time() - self._t0:.1f}s",
        )
        if self.leaderboard.leader is None:
            raise RuntimeError("AutoML built no models (budget too small?)")
        return self.leaderboard.leader

    @property
    def leader(self) -> Optional[Model]:
        return self.leaderboard.leader

    def __repr__(self) -> str:
        return f"<AutoML {self.project_key} models={len(self.leaderboard.models)}>"
