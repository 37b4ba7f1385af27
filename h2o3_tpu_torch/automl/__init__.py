"""AutoML — the port of ``h2o3_tpu/automl``: budgeted automatic model
selection and stacking.

Reference: ``h2o-automl``: the ``AutoML.java:40`` orchestrator running the
modeling steps of its providers
(``modeling/{XGBoost,GLM,DRF,GBM,DeepLearning,StackedEnsemble}StepsProvider``)
under a model and time budget (``WorkAllocations``), the CV-metric
leaderboard (``leaderboard/``) and the event log (``events/EventLog.java``).
"""

from h2o3_tpu_torch.automl.automl import AutoML, EventLog, Leaderboard

__all__ = ["AutoML", "EventLog", "Leaderboard"]
