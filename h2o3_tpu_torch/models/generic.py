"""Generic model — the port of ``h2o3_tpu/models/generic.py``: a MOJO
imported back as a servable model.

Reference: ``h2o-algos/src/main/java/hex/generic/`` — ``Generic`` is a
ModelBuilder whose "training" reads a MOJO; the ``GenericModel`` scores
through the embedded MojoModel and is otherwise a model like any other
(predict, metrics on demand, a DKV key).

The embedded scorer is the numpy-only ``h2o3_tpu_torch.genmodel``
MojoModel, fed whole columns, so an imported model scores vectorized on
the host. It reads this package's MOJOs and the JAX package's alike (one
archive format). The builder resolves its device as every entry point
does and the model records it; nothing of the scoring runs on it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from h2o3_tpu_torch.device import resolve_device
from h2o3_tpu_torch.frame.frame import ColType, Frame
from h2o3_tpu_torch.keyed import DKV
from h2o3_tpu_torch.models.data_info import DataInfo
from h2o3_tpu_torch.models.framework import Job, Model, ModelBuilder, ModelParameters


@dataclass
class GenericParameters(ModelParameters):
    #: path of the MOJO archive to import (GenericModelParameters._path)
    path: Optional[str] = None


class GenericModel(Model):
    algo_name = "generic"

    def __init__(self, params: GenericParameters, data_info: DataInfo, mojo,
                 device: torch.device) -> None:
        super().__init__(params, data_info, device)
        self.mojo = mojo

    @property
    def source_algo(self) -> str:
        return self.mojo.meta.get("algo", "?")

    def _predict_raw(self, frame: Frame) -> np.ndarray:
        # the MojoModel takes whole columns and reads only what it needs
        # (the predictors and an optional offset column)
        data = {}
        for col in frame.columns:
            if col.type is ColType.CAT:
                data[col.name] = [
                    col.domain[v] if v >= 0 else None for v in col.data
                ]
            elif col.type is ColType.STR:
                data[col.name] = list(col.data)
            else:
                data[col.name] = col.numeric_view()
        return self.mojo.score(data)

    def variable_importances(self) -> dict:
        raise NotImplementedError("imported MOJOs carry no variable importances")


class Generic(ModelBuilder):
    """hex/generic/Generic.java — "training" is loading the artifact."""

    algo_name = "generic"

    def __init__(self, params: Optional[GenericParameters] = None, **kw) -> None:
        super().__init__(params or GenericParameters(**kw))

    def train(self, frame: Optional[Frame] = None,
              valid: Optional[Frame] = None) -> GenericModel:
        # no training frame: the artifact defines the layout, but the
        # guard on common parameters still holds (the frameless half of
        # _validate)
        self._validate_params()
        p: GenericParameters = self.params
        if p.nfolds or p.fold_column:
            raise ValueError("generic import does not support cross-validation")
        device = resolve_device(p.device)
        self.job = Job("generic import").start()
        try:
            model = self._fit(frame, valid, device)
            self.job.done()
            return model
        except BaseException as e:
            self.job.fail(e)
            raise

    def _fit(self, frame: Optional[Frame], valid: Optional[Frame],
             device: torch.device) -> GenericModel:
        p: GenericParameters = self.params
        if not p.path:
            raise ValueError("generic import requires `path` to a MOJO archive")
        from h2o3_tpu_torch.genmodel import load_mojo

        mojo = load_mojo(p.path)
        lay = mojo.layout
        info = DataInfo(
            predictor_names=list(lay.predictor_names),
            response_name=lay.response_name,
            use_all_factor_levels=lay.use_all_factor_levels,
            standardize=lay.standardize,
            missing_values_handling=lay.missing_values_handling,
            num_means=dict(lay.num_means),
            num_sds=dict(lay.num_sds),
            cat_domains={k: list(v) for k, v in lay.cat_domains.items()},
            cat_mode=dict(lay.cat_mode),
            coef_names=list(lay.coef_names),
            response_domain=list(lay.response_domain) if lay.response_domain else None,
        )
        return GenericModel(p, info, mojo, device)


def import_mojo(path: str, model_id: Optional[str] = None,
                device=None) -> GenericModel:
    """h2o.import_mojo: a MOJO file as a servable Generic model."""
    model = Generic(path=path, device=device).train()
    if model_id:
        DKV.rekey(model, model_id)
    return model
