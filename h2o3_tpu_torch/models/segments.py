"""Segment models — the port of ``h2o3_tpu/models/segments.py``: one model
per data segment.

Reference: ``hex/segments/SegmentModelsBuilder.java`` /
``SegmentModels.java`` — split the training frame by the distinct value
combinations of the segment columns, train an independent model per
segment, and collect model key, status and error per segment into a frame
(``SegmentModelsUtils``, ``segment_models_as_frame`` over REST).

The builder resolves its device once, when ``train`` starts (the
parameters' ``device``, else the caller's ``use_device`` block, else
``cuda``), and every segment's parameters carry it: segments built on the
worker threads of ``parallelism > 1`` fit where the caller asked, although
``use_device`` blocks are per thread. With a process group live the
segments fit one after another on every rank, so every rank's fits issue
their collectives in the same order. A failed segment records its error
and the others go on, as in the reference.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
from typing import Any, Dict, List, Optional, Sequence, Type

import numpy as np

from h2o3_tpu_torch.device import resolve_device
from h2o3_tpu_torch.parallel.mesh import default_mesh
from h2o3_tpu_torch.frame.frame import ColType, Column, Frame
from h2o3_tpu_torch.keyed import DKV
from h2o3_tpu_torch.models.framework import Model, ModelBuilder


class SegmentModels:
    """The result (hex/segments/SegmentModels.java)."""

    def __init__(self, key: Optional[str] = None) -> None:
        self.key = key or DKV.make_key("segment_models")
        self.segments: List[Dict[str, Any]] = []  # segment column -> value
        self.models: List[Optional[Model]] = []
        self.errors: List[Optional[str]] = []
        self.run_times: List[float] = []
        DKV.put(self.key, self)

    def as_frame(self) -> Frame:
        """The segment columns and model/status/errors
        (SegmentModelsUtils.toFrame / AstSegmentModelsAsFrame)."""
        if not self.segments:
            return Frame([])
        cols: List[Column] = []
        for name in self.segments[0]:
            vals = [str(s[name]) for s in self.segments]
            dom = sorted(set(vals))
            codes = np.array([dom.index(v) for v in vals], dtype=np.int32)
            cols.append(Column(name, codes, ColType.CAT, dom))
        status = ["succeeded" if e is None else "failed" for e in self.errors]
        sdom = sorted(set(status))
        cols.append(
            Column(
                "status",
                np.array([sdom.index(s) for s in status], dtype=np.int32),
                ColType.CAT,
                sdom,
            )
        )
        mids = [m.key if m is not None else "" for m in self.models]
        mdom = list(dict.fromkeys(mids))
        cols.append(
            Column(
                "model",
                np.array([mdom.index(v) for v in mids], dtype=np.int32),
                ColType.CAT,
                mdom,
            )
        )
        errs = [e or "" for e in self.errors]
        edom = list(dict.fromkeys(errs))
        cols.append(
            Column(
                "errors",
                np.array([edom.index(v) for v in errs], dtype=np.int32),
                ColType.CAT,
                edom,
            )
        )
        return Frame(cols)

    def model_for(self, **segment_values: Any) -> Optional[Model]:
        for seg, m in zip(self.segments, self.models):
            if all(str(seg.get(k)) == str(v) for k, v in segment_values.items()):
                return m
        return None

    def __repr__(self) -> str:
        ok = sum(e is None for e in self.errors)
        return f"<SegmentModels {self.key}: {ok}/{len(self.segments)} succeeded>"


class SegmentModelsBuilder:
    """hex/segments/SegmentModelsBuilder.java: enumerate the segments, train each."""

    def __init__(
        self,
        builder_cls: Type[ModelBuilder],
        params: Any,
        segment_columns: Sequence[str],
        parallelism: int = 1,
    ) -> None:
        if not segment_columns:
            raise ValueError("segment_columns must be non-empty")
        self.builder_cls = builder_cls
        self.params = params
        self.segment_columns = list(segment_columns)
        self.parallelism = max(1, int(parallelism))

    def _enumerate_segments(self, frame: Frame) -> List[Dict[str, Any]]:
        cols = []
        for name in self.segment_columns:
            c = frame.col(name)
            if c.type is ColType.CAT:
                cols.append([c.domain[v] if v >= 0 else None for v in c.data])
            else:
                # NaN as None: float('nan') != float('nan'), so raw NaNs
                # would each become a segment of their own
                cols.append(
                    [None if np.isnan(v) else float(v) for v in c.numeric_view()]
                )
        seen: Dict[tuple, None] = {}
        for row in zip(*cols):
            seen.setdefault(row, None)
        return [dict(zip(self.segment_columns, k)) for k in seen]

    def _segment_mask(self, frame: Frame, seg: Dict[str, Any]) -> np.ndarray:
        mask = np.ones(frame.nrows, dtype=bool)
        for name, val in seg.items():
            c = frame.col(name)
            if c.type is ColType.CAT:
                if val is None:
                    mask &= c.data < 0
                else:
                    mask &= c.data == c.domain.index(val)
            else:
                x = c.numeric_view()
                mask &= np.isnan(x) if val is None else (x == val)
        return mask

    def train(self, frame: Frame) -> SegmentModels:
        device = resolve_device(getattr(self.params, "device", None))
        segments = self._enumerate_segments(frame)
        result = SegmentModels()

        def build(seg: Dict[str, Any]):
            sub = frame.rows(self._segment_mask(frame, seg))
            p = replace(
                self.params,
                ignored_columns=list(
                    set(self.params.ignored_columns) | set(self.segment_columns)
                ),
                device=device,
            )
            return self.builder_cls(p).train(sub)

        def run_one(seg):
            t0 = time.time()
            try:
                m = build(seg)
                return seg, m, None, time.time() - t0
            except Exception as e:
                return seg, None, f"{type(e).__name__}: {e}", time.time() - t0

        if self.parallelism == 1 or default_mesh().live:
            outs = [run_one(s) for s in segments]
        else:
            with ThreadPoolExecutor(max_workers=self.parallelism) as pool:
                outs = list(pool.map(run_one, segments))
        for seg, m, err, dt in outs:
            result.segments.append(seg)
            result.models.append(m)
            result.errors.append(err)
            result.run_times.append(dt)
        return result
