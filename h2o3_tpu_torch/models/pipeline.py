"""Scoring pipeline — the port of ``h2o3_tpu/models/pipeline.py``:
munging steps and a model in one portable artifact.

Reference: the mojo-pipeline extension
(``h2o-extensions/mojo-pipeline/.../MojoPipeline.java:34-77``:
``transform(Frame)`` over a pipeline artifact with strict adaptation of
the input columns) and ``rapids/AstPipelineTransform.java``. The
reference scores DriverlessAI MOJO2 archives through a closed runtime;
here, as in the JAX package, the artifact describes itself: a zip of

* ``pipeline.json``: the fitted Assembly steps (``models/assembly.py``)
  and the input column contract, and
* ``model.mojo``: this package's MOJO (``models/mojo_export.py``),

scored by the numpy-only genmodel reader. The format is the JAX
package's, so either package reads the other's artifacts.
``transform`` adapts the columns (a missing input raises, as
``MojoPipeline.adaptFrame`` does), replays the munging steps and scores
on the host.
"""

from __future__ import annotations

import io
import json
import os
import tempfile
import zipfile
from typing import Any, Dict, List, Optional

from h2o3_tpu_torch.frame.frame import ColType, Frame
from h2o3_tpu_torch.keyed import DKV

#: artifact member names
_META = "pipeline.json"
_MOJO = "model.mojo"


class ScoringPipeline:
    """A fitted munging pipeline + embedded MOJO, servable and portable.

    steps: Assembly step dicts (may be empty — model-only pipeline);
    mojo_bytes: the embedded model artifact (None = transform-only);
    in_names: required input columns (adaptFrame contract).
    """

    def __init__(
        self,
        steps: List[Dict[str, Any]],
        mojo_bytes: Optional[bytes],
        in_names: List[str],
        key: str = "",
    ) -> None:
        self.steps = list(steps)
        self.mojo_bytes = mojo_bytes
        self.in_names = list(in_names)
        self.key = key
        self._mojo = None  # lazily loaded genmodel MojoModel

    # -- construction --------------------------------------------------------

    @classmethod
    def from_parts(cls, model=None, assembly=None) -> "ScoringPipeline":
        """Build from live objects: a trained Model and/or a fitted
        Assembly (either may be None, not both)."""
        if model is None and assembly is None:
            raise ValueError("pipeline needs a model, an assembly, or both")
        steps = list(assembly.steps) if assembly is not None else []
        # scoring-time inputs = columns the steps read + the model's
        # predictors that the steps don't themselves produce.  The frame
        # the assembly was FIT on may carry more (the response, id
        # columns); requiring those at transform time would make the
        # deployed pipeline unusable on unlabeled data.
        produced = set()
        referenced = set()
        for s in steps:
            op = s.get("op")
            if op == "ColSelect":
                referenced.update(s.get("cols") or [])
            elif op == "ColOp":
                referenced.add(s.get("col"))
                produced.add(
                    s["col"] if s.get("inplace")
                    else (s.get("new_col_name") or f"{s.get('fun')}_{s.get('col')}"))
            elif op == "BinaryOp":
                referenced.add(s.get("left"))
                if isinstance(s.get("right"), str):
                    referenced.add(s["right"])
                produced.add(
                    s.get("new_col_name") or f"{s.get('left')}_{s.get('fun')}")
        needed = set(referenced)
        if model is not None:
            needed.update(
                n for n in model.data_info.predictor_names
                if n not in produced
            )
        if assembly is not None and assembly.in_names:
            in_names = [n for n in assembly.in_names if n in needed]
            # a model predictor absent from the fit frame cannot happen in
            # a fit assembly; keep any stragglers anyway (fail loud later)
            in_names += sorted(needed - set(assembly.in_names) - produced)
        else:
            in_names = sorted(needed)
        mojo_bytes = None
        if model is not None:
            fd, path = tempfile.mkstemp(suffix=".mojo")
            os.close(fd)
            try:
                model.download_mojo(path)
                with open(path, "rb") as f:
                    mojo_bytes = f.read()
            finally:
                os.unlink(path)
        return cls(steps, mojo_bytes, in_names)

    # -- the artifact --------------------------------------------------------

    def to_bytes(self) -> bytes:
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
            z.writestr(_META, json.dumps({
                "version": 1,
                "steps": self.steps,
                "in_names": self.in_names,
            }))
            if self.mojo_bytes is not None:
                z.writestr(_MOJO, self.mojo_bytes)
        return buf.getvalue()

    def save(self, path: str) -> str:
        with open(path, "wb") as f:
            f.write(self.to_bytes())
        return path

    @classmethod
    def from_bytes(cls, data: bytes) -> "ScoringPipeline":
        with zipfile.ZipFile(io.BytesIO(data)) as z:
            names = set(z.namelist())
            if _META not in names:
                raise ValueError(
                    f"not a pipeline artifact (no {_META} member)")
            meta = json.loads(z.read(_META).decode())
            mojo = z.read(_MOJO) if _MOJO in names else None
        return cls(meta.get("steps") or [], mojo,
                   meta.get("in_names") or [])

    @classmethod
    def load(cls, path: str) -> "ScoringPipeline":
        with open(path, "rb") as f:
            return cls.from_bytes(f.read())

    # -- scoring -------------------------------------------------------------

    def _genmodel(self):
        if self._mojo is None:
            if self.mojo_bytes is None:
                raise ValueError("transform-only pipeline has no model")
            from h2o3_tpu_torch.genmodel.mojo_model import load_mojo

            fd, path = tempfile.mkstemp(suffix=".mojo")
            os.close(fd)
            try:
                with open(path, "wb") as f:
                    f.write(self.mojo_bytes)
                self._mojo = load_mojo(path)
            finally:
                os.unlink(path)
        return self._mojo

    def _adapt(self, frame: Frame) -> Frame:
        """MojoPipeline.adaptFrame: every declared input column must be
        present; extra columns pass through untouched (munging steps may
        reference them only if they were recorded as inputs)."""
        for name in self.in_names:
            if name not in frame.names:
                raise ValueError(
                    f"Input frame is missing a column: {name}")
        return frame

    def transform(self, frame: Frame) -> Frame:
        """Munging steps then (if a model is embedded) scoring; returns the
        output frame (predictions, or the munged frame for transform-only
        pipelines)."""
        fr = self._adapt(frame)
        if self.steps:
            from h2o3_tpu_torch.models.assembly import Assembly

            fr = Assembly(steps=self.steps).fit(fr)
        if self.mojo_bytes is None:
            return fr
        mojo = self._genmodel()
        data: Dict[str, Any] = {}
        for col in fr.columns:
            if col.type is ColType.CAT:
                data[col.name] = [
                    col.domain[v] if v >= 0 else None for v in col.data
                ]
            elif col.type is ColType.STR:
                data[col.name] = list(col.data)
            else:
                data[col.name] = col.numeric_view()
        raw = mojo.score(data)
        from h2o3_tpu_torch.models.framework import prediction_frame

        # dispatch on the MOJO's declared response domain, NOT the score
        # shape: an unsupervised model's [N, k] output (PCA projections)
        # must come back as k numeric columns, not argmax "labels"
        if not mojo.is_classifier:
            return prediction_frame(raw, None)
        return prediction_frame(
            raw, mojo.domain_values,
            float(mojo.meta.get("default_threshold", 0.5)))


def build_pipeline(model=None, assembly=None) -> ScoringPipeline:
    """Construct, register in the DKV, and return a ScoringPipeline."""
    pipe = ScoringPipeline.from_parts(model=model, assembly=assembly)
    pipe.key = DKV.make_key("pipeline")
    DKV.put(pipe.key, pipe)
    return pipe
