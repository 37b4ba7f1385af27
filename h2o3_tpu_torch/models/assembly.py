"""Assembly — the port of ``h2o3_tpu/models/assembly.py``: a fitted
munging pipeline, exportable as standalone code.

Reference: ``water/api/AssemblyHandler.java`` and h2o-py's ``H2OAssembly``
(steps ``H2OColSelect``, ``H2OColOp``, ``H2OBinaryOp``) — a named pipeline
of frame transforms fitted once and exported by ``toJava`` as a munger
without dependencies that replays the steps outside the cluster.

The steps are small host column ops in numpy, as in the JAX package, so
their outputs are the JAX package's bits; the Java emitter writes a
``double[] fit(double[] row)`` over the numeric row (genmodel's
GenMunger contract), the JAX package's text.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List

import numpy as np

from h2o3_tpu_torch.frame.frame import ColType, Column, Frame
from h2o3_tpu_torch.keyed import DKV

#: unary functions shared by apply + codegen (name -> (numpy, java expr))
_UNI = {
    "log": (np.log, "Math.log(v)"),
    "log1p": (np.log1p, "Math.log1p(v)"),
    "exp": (np.exp, "Math.exp(v)"),
    "sqrt": (np.sqrt, "Math.sqrt(v)"),
    "abs": (np.abs, "Math.abs(v)"),
    "floor": (np.floor, "Math.floor(v)"),
    "ceil": (np.ceil, "Math.ceil(v)"),
    "sin": (np.sin, "Math.sin(v)"),
    "cos": (np.cos, "Math.cos(v)"),
    "sign": (np.sign, "Math.signum(v)"),
    "negate": (np.negative, "-v"),
}

_BIN = {
    "+": "+", "-": "-", "*": "*", "/": "/",
}


@dataclass
class Assembly:
    """An ordered list of steps; ``fit`` applies them to a frame."""

    steps: List[Dict[str, Any]]
    key: str = ""
    #: column order of the fitted OUTPUT frame (codegen contract)
    out_names: List[str] = field(default_factory=list)
    in_names: List[str] = field(default_factory=list)

    def fit(self, frame: Frame) -> Frame:
        self.in_names = list(frame.names)
        fr = frame
        for step in self.steps:
            fr = self._apply(fr, step)
        self.out_names = list(fr.names)
        return fr

    def _apply(self, fr: Frame, step: Dict[str, Any]) -> Frame:
        op = step.get("op")
        if op == "ColSelect":
            cols = step.get("cols") or []
            missing = [c for c in cols if c not in fr.names]
            if missing:
                raise ValueError(f"ColSelect: no such columns {missing}")
            return fr.cols(list(cols))
        if op == "ColOp":
            fun = step.get("fun")
            if fun not in _UNI:
                raise ValueError(
                    f"ColOp: unknown fun {fun!r} (have {sorted(_UNI)})")
            col = step.get("col")
            c = fr.col(col)
            inplace = bool(step.get("inplace"))
            new = col if inplace else (
                step.get("new_col_name") or f"{fun}_{col}")
            with np.errstate(all="ignore"):
                data = _UNI[fun][0](c.numeric_view().astype(np.float64))
            # add_column replaces an existing same-named column IN PLACE,
            # so the inplace path keeps column order
            return fr.add_column(Column(new, data, ColType.NUM))
        if op == "BinaryOp":
            fun = step.get("fun")
            if fun not in _BIN:
                raise ValueError(
                    f"BinaryOp: unknown fun {fun!r} (have {sorted(_BIN)})")
            left = fr.col(step.get("left")).numeric_view().astype(np.float64)
            rhs = step.get("right")
            if isinstance(rhs, str):
                right = fr.col(rhs).numeric_view().astype(np.float64)
            else:
                right = float(rhs)
            with np.errstate(all="ignore"):
                data = {"+": np.add, "-": np.subtract,
                        "*": np.multiply, "/": np.divide}[fun](left, right)
            new = step.get("new_col_name") or f"{step.get('left')}_{fun}"
            return fr.add_column(Column(new, data, ColType.NUM))
        raise ValueError(f"unknown assembly op {op!r} "
                         f"(ColSelect | ColOp | BinaryOp)")

    # -- codegen (AssemblyHandler.toJava / GenMunger contract) ---------------
    def to_java(self, pojo_name: str) -> str:
        """Standalone Java munger: double[] fit(double[] row) replays the
        steps over the numeric input row (input order = in_names;
        categorical columns travel as their level codes)."""
        if not self.out_names:
            raise ValueError("assembly must be fit before toJava")
        idx = {n: i for i, n in enumerate(self.in_names)}
        lines = [
            f"// GENERATED assembly munger — do not edit.",
            f"// input columns: {', '.join(self.in_names)}",
            f"// output columns: {', '.join(self.out_names)}",
            f"public class {pojo_name} {{",
            f"  public static double[] fit(double[] row) {{",
            f"    java.util.HashMap<String, Double> v = new java.util.HashMap<>();",
        ]
        for n, i in idx.items():
            lines.append(f'    v.put("{n}", row[{i}]);')
        # the output projection comes from out_names (recorded at fit);
        # ColSelect steps only affect which names fit() kept
        for step in self.steps:
            op = step.get("op")
            if op == "ColOp":
                fun, col = step["fun"], step["col"]
                new = (col if step.get("inplace")
                       else (step.get("new_col_name") or f"{fun}_{col}"))
                expr = _UNI[fun][1].replace("v", f'v.get("{col}")')
                lines.append(f'    v.put("{new}", {expr});')
            elif op == "BinaryOp":
                fun = _BIN[step["fun"]]
                left = f'v.get("{step["left"]}")'
                rhs = step.get("right")
                right = (f'v.get("{rhs}")' if isinstance(rhs, str)
                         else repr(float(rhs)))
                new = step.get("new_col_name") or f"{step['left']}_{step['fun']}"
                lines.append(f'    v.put("{new}", {left} {fun} {right});')
        lines.append(f"    double[] out = new double[{len(self.out_names)}];")
        for j, n in enumerate(self.out_names):
            lines.append(f'    out[{j}] = v.get("{n}");')
        lines += ["    return out;", "  }", "}"]
        return "\n".join(lines) + "\n"


def fit_assembly(steps: List[Dict[str, Any]], frame: Frame) -> tuple:
    asm = Assembly(steps=list(steps))
    out = asm.fit(frame)
    asm.key = DKV.make_key("assembly")
    DKV.put(asm.key, asm)
    return asm, out
