"""Aggregator — the port of ``h2o3_tpu/models/aggregator.py``.

Reference: ``hex/aggregator/Aggregator.java:16`` — one pass over the rows:
a row within ``radius`` of an existing exemplar is counted into it, else
it becomes a new exemplar; whenever the exemplar count overshoots
``target_num_exemplars`` by more than ``rel_tol_num_exemplars`` the radius
grows and the exemplars are re-aggregated. The output is the exemplar rows
with a ``counts`` column.

The JAX package runs this on the host in numpy by design (the exemplar
count changes every batch, so a compiled version would recompile per
batch), and so does this module, line for line on the same float32 design
(``expand_matrix``): the exemplar rows, counts and radius are the JAX
package's. Each batch's [B, E] distances to the current exemplars are one
matmul; the rows no exemplar covers are taken greedily, one at a time.
The model holds no device state.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import ColType, Column, Frame
from h2o3_tpu_torch.models.data_info import build_data_info, expand_matrix
from h2o3_tpu_torch.models.framework import Model, ModelBuilder, ModelParameters


@dataclass
class AggregatorParameters(ModelParameters):
    target_num_exemplars: int = 5000
    rel_tol_num_exemplars: float = 0.5
    transform: str = "normalize"  # none | standardize | normalize
    batch_size: int = 65536


def _dist2(B: np.ndarray, E: np.ndarray) -> np.ndarray:
    """Squared euclidean distances [nb, ne] by the matmul expansion."""
    return (
        (B * B).sum(axis=1, keepdims=True)
        - 2.0 * B @ E.T
        + (E * E).sum(axis=1)[None, :]
    )


class _ExemplarBuffer:
    """Capacity-doubling [cap, d] float32 buffer (amortized O(1) append)."""

    def __init__(self, d: int, cap: int = 1024) -> None:
        self._buf = np.zeros((cap, d), dtype=np.float32)
        self.n = 0

    def append(self, x: np.ndarray) -> None:
        if self.n == len(self._buf):
            self._buf = np.concatenate([self._buf, np.zeros_like(self._buf)])
        self._buf[self.n] = x
        self.n += 1

    @property
    def view(self) -> np.ndarray:
        return self._buf[: self.n]


class AggregatorModel(Model):
    algo_name = "aggregator"

    def __init__(self, params, data_info, device: torch.device) -> None:
        super().__init__(params, data_info, device)
        self.exemplar_rows: Optional[np.ndarray] = None  # row indices into the training frame
        self.counts: Optional[np.ndarray] = None
        self.output_frame: Optional[Frame] = None
        self.radius: float = 0.0

    @property
    def is_classifier(self) -> bool:
        return False

    def _predict_raw(self, frame: Frame) -> np.ndarray:
        raise NotImplementedError("Aggregator produces an output frame, not predictions")


class Aggregator(ModelBuilder):
    algo_name = "aggregator"

    def __init__(self, params: Optional[AggregatorParameters] = None, **kw) -> None:
        super().__init__(params or AggregatorParameters(**kw))

    def _fit(self, frame: Frame, valid: Optional[Frame],
             device: torch.device) -> AggregatorModel:
        p: AggregatorParameters = self.params
        info = build_data_info(
            frame, None, ignored=p.ignored_columns,
            standardize=p.transform in ("standardize", "normalize"),
        )
        X, _ = expand_matrix(info, frame, dtype=np.float32)
        n, d = X.shape
        if p.transform == "normalize" and d:
            # standardized features scaled into about [-.5, .5] per column
            span = X.max(axis=0) - X.min(axis=0)
            X = X / np.where(span > 0, span, 1.0)

        target = min(p.target_num_exemplars, n)
        hi_cap = target * (1.0 + p.rel_tol_num_exemplars)
        radius2 = 0.0  # exact at first: every distinct row is an exemplar until the overshoot
        ex_idx: List[int] = []
        counts: List[float] = []

        buf = _ExemplarBuffer(d)
        for start in range(0, n, p.batch_size):
            B = X[start : start + p.batch_size]
            covered = np.zeros(len(B), dtype=bool)
            assign = np.zeros(len(B), dtype=np.int64)
            if buf.n:
                d2 = _dist2(B, buf.view)
                j = d2.argmin(axis=1)
                m = d2[np.arange(len(B)), j] <= radius2
                covered, assign = m, j
            for k, c in zip(*np.unique(assign[covered], return_counts=True)):
                counts[k] += float(c)
            for bi in np.nonzero(~covered)[0]:
                x = B[bi]
                if buf.n:
                    d2x = ((buf.view - x) ** 2).sum(axis=1)
                    k = int(d2x.argmin())
                    if d2x[k] <= radius2:
                        counts[k] += 1.0
                        continue
                ex_idx.append(start + int(bi))
                counts.append(1.0)
                buf.append(x)
                if buf.n > hi_cap:
                    radius2 = _grow_radius(radius2, X)
                    ex_idx, counts, buf = _reaggregate(ex_idx, buf, counts, radius2)
            if self.job:
                self.job.update(min(1.0, (start + len(B)) / n))

        model = AggregatorModel(p, info, device)
        model.exemplar_rows = np.asarray(ex_idx, dtype=np.int64)
        model.counts = np.asarray(counts)
        model.radius = float(np.sqrt(radius2))
        out = frame.rows(model.exemplar_rows)
        model.output_frame = out.add_column(Column("counts", model.counts, ColType.NUM))
        return model


def _grow_radius(radius2: float, X: np.ndarray) -> float:
    """Escalate the merge radius (Aggregator.java's iterative radius growth)."""
    if radius2 <= 0.0:
        d = X.shape[1]
        return 1e-4 * max(d, 1)
    return radius2 * 2.0


def _reaggregate(ex_idx, buf: "_ExemplarBuffer", counts, radius2):
    """Merge exemplars that now lie within the grown radius of an earlier one."""
    keep_idx: List[int] = []
    keep_counts: List[float] = []
    kept = _ExemplarBuffer(buf.view.shape[1])
    for i in range(len(ex_idx)):
        x = buf.view[i]
        if kept.n:
            d2 = ((kept.view - x) ** 2).sum(axis=1)
            k = int(d2.argmin())
            if d2[k] <= radius2:
                keep_counts[k] += counts[i]
                continue
        keep_idx.append(ex_idx[i])
        keep_counts.append(counts[i])
        kept.append(x)
    return keep_idx, keep_counts, kept
