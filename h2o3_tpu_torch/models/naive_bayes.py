"""NaiveBayes — the port of ``h2o3_tpu/models/naive_bayes.py``.

Reference: ``hex/naivebayes/NaiveBayes.java``: per-class priors,
per-(class, categorical level) counts with Laplace smoothing, and a
per-(class, numeric feature) gaussian mean and sd under the
``min_sdev``/``eps_sdev`` rule.

The JAX package builds the tables and scores in numpy on the host, and so
does this module, on the same ``_align_codes`` and ``response_vector``:
the tables, probabilities and metrics are the JAX package's bits. The
model holds no device state; its metrics come from ``make_metrics``'s
binomial or multinomial path through ``Model.model_performance``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.data_info import _align_codes, build_data_info, response_vector
from h2o3_tpu_torch.models.framework import Model, ModelBuilder, ModelParameters


@dataclass
class NaiveBayesParameters(ModelParameters):
    laplace: float = 0.0
    min_sdev: float = 1e-3
    eps_sdev: float = 0.0


class NaiveBayesModel(Model):
    algo_name = "naivebayes"

    def __init__(self, params, data_info, device: torch.device) -> None:
        super().__init__(params, data_info, device)
        self.priors: Optional[np.ndarray] = None  # [C]
        self.num_mean: Dict[str, np.ndarray] = {}  # name -> [C]
        self.num_sd: Dict[str, np.ndarray] = {}
        self.cat_probs: Dict[str, np.ndarray] = {}  # name -> [C, levels]

    def _predict_raw(self, frame: Frame) -> np.ndarray:
        C = len(self.priors)
        n = frame.nrows
        logp = np.tile(np.log(np.maximum(self.priors, 1e-300)), (n, 1))
        for name in self.data_info.predictor_names:
            col = frame.col(name)
            if name in self.cat_probs:
                codes = _align_codes(col, self.data_info.cat_domains[name])
                probs = self.cat_probs[name]  # [C, L]
                ok = codes >= 0
                contrib = np.zeros((n, C))
                contrib[ok] = np.log(np.maximum(probs[:, codes[ok]].T, 1e-300))
                logp += contrib
            else:
                x = col.numeric_view()
                mu, sd = self.num_mean[name], self.num_sd[name]  # [C]
                ok = ~np.isnan(x)
                z = (x[ok][:, None] - mu[None, :]) / sd[None, :]
                contrib = np.zeros((n, C))
                contrib[ok] = -0.5 * z * z - np.log(sd[None, :] * np.sqrt(2 * np.pi))
                logp += contrib
        z = logp - logp.max(axis=1, keepdims=True)
        e = np.exp(z)
        return e / e.sum(axis=1, keepdims=True)


class NaiveBayes(ModelBuilder):
    algo_name = "naivebayes"

    def __init__(self, params: Optional[NaiveBayesParameters] = None, **kw) -> None:
        super().__init__(params or NaiveBayesParameters(**kw))

    def _fit(self, frame: Frame, valid: Optional[Frame],
             device: torch.device) -> NaiveBayesModel:
        p: NaiveBayesParameters = self.params
        info = build_data_info(
            frame, y=p.response_column, ignored=p.ignored_columns,
            standardize=False, use_all_factor_levels=True,
        )
        if info.response_domain is None:
            raise ValueError("NaiveBayes requires a categorical response")
        y = response_vector(info, frame)
        keep = ~np.isnan(y)
        yk = y[keep].astype(np.int64)
        C = len(info.response_domain)
        model = NaiveBayesModel(p, info, device)

        counts = np.bincount(yk, minlength=C).astype(np.float64)
        model.priors = counts / counts.sum()

        for name in info.predictor_names:
            col = frame.col(name)
            if name in info.cat_domains:
                codes = _align_codes(col, info.cat_domains[name])[keep]
                L = len(info.cat_domains[name])
                tab = np.zeros((C, L))
                ok = codes >= 0
                np.add.at(tab, (yk[ok], codes[ok]), 1.0)
                tab += p.laplace
                model.cat_probs[name] = tab / np.maximum(tab.sum(axis=1, keepdims=True), 1e-300)
            else:
                x = col.numeric_view()[keep]
                ok = ~np.isnan(x)
                mu = np.zeros(C)
                sd = np.full(C, p.min_sdev)
                for c in range(C):
                    xc = x[ok & (yk == c)]
                    if len(xc):
                        mu[c] = xc.mean()
                        s = xc.std(ddof=1) if len(xc) > 1 else p.min_sdev
                        # an sd at or below eps_sdev snaps to min_sdev
                        if s <= p.eps_sdev:
                            s = p.min_sdev
                        sd[c] = max(s, p.min_sdev)
                model.num_mean[name] = mu
                model.num_sd[name] = sd

        model.training_metrics = model.model_performance(frame)
        if valid is not None:
            model.validation_metrics = model.model_performance(valid)
        return model
