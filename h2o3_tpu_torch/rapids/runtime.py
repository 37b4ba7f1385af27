"""Rapids runtime — the port of ``h2o3_tpu/rapids/runtime.py``: Val types,
Session, evaluator.

Reference: ``water/rapids/Val.java`` (NUM/NUMS/STR/STRS/FRAME/ROW/FUN),
``water/rapids/Session.java`` (per-client session with ref-counted temp
frames), ``water/rapids/ast/AstExec`` dispatch.

The evaluator is a small tree-walker: special forms (assignment, lambdas)
are handled here; everything else evaluates its args and dispatches into the
primitive registry (``rapids/prims``).

A :class:`Session` carries the choices the JAX package reads from its
environment: ``fusion`` (the fusion pass on or off; off, the evaluator is
the plain interpreter), ``fusion_min_ops`` (the fewest fusible ops a region
must cover to run as one device program) and ``device``, resolved once by
``resolve_device``: the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Union

import numpy as np

from h2o3_tpu_torch.device import DeviceLike, resolve_device
from h2o3_tpu_torch.frame.frame import Column, ColType, Frame
from h2o3_tpu_torch.keyed import DKV
from h2o3_tpu_torch.rapids import parser as P
from h2o3_tpu_torch.rapids.parser import (
    AstExec,
    AstFun,
    AstId,
    AstNode,
    AstNum,
    AstNumList,
    AstStr,
    AstStrList,
)


class Val:
    """Tagged runtime value (water/rapids/Val.java)."""

    NUM, NUMS, STR, STRS, FRAME, ROW, FUN, MODEL, KEYED = range(9)

    __slots__ = ("kind", "value")

    def __init__(self, kind: int, value: Any) -> None:
        self.kind = kind
        self.value = value

    # -- constructors --------------------------------------------------------
    @staticmethod
    def num(x: float) -> "Val":
        return Val(Val.NUM, float(x))

    @staticmethod
    def nums(xs) -> "Val":
        return Val(Val.NUMS, np.asarray(xs, dtype=np.float64))

    @staticmethod
    def str_(s: str) -> "Val":
        return Val(Val.STR, s)

    @staticmethod
    def strs(ss) -> "Val":
        return Val(Val.STRS, list(ss))

    @staticmethod
    def frame(fr: Frame) -> "Val":
        return Val(Val.FRAME, fr)

    @staticmethod
    def row(xs, names=None) -> "Val":
        return Val(Val.ROW, (np.asarray(xs, dtype=np.float64), names))

    @staticmethod
    def fun(f) -> "Val":
        return Val(Val.FUN, f)

    @staticmethod
    def model(m) -> "Val":
        return Val(Val.MODEL, m)

    @staticmethod
    def keyed(obj) -> "Val":
        return Val(Val.KEYED, obj)

    # -- coercions (Val.getNum/getFrame/... semantics) -----------------------
    def as_num(self) -> float:
        if self.kind == Val.NUM:
            return self.value
        if self.kind == Val.FRAME and self.value.ncols == 1 and self.value.nrows == 1:
            return float(self.value.col(0).numeric_view()[0])
        if self.kind == Val.NUMS and len(self.value) == 1:
            return float(self.value[0])
        raise TypeError(f"expected a number, got {self!r}")

    def as_int(self) -> int:
        return int(self.as_num())

    def as_str(self) -> str:
        if self.kind == Val.STR:
            return self.value
        if self.kind == Val.STRS and len(self.value) == 1:
            return self.value[0]
        raise TypeError(f"expected a string, got {self!r}")

    def as_frame(self) -> Frame:
        if self.kind == Val.FRAME:
            return self.value
        if self.kind == Val.NUM:
            return Frame([Column("C1", np.array([self.value]), ColType.NUM)])
        if self.kind == Val.NUMS:
            return Frame([Column("C1", self.value, ColType.NUM)])
        raise TypeError(f"expected a frame, got {self!r}")

    def as_nums(self) -> np.ndarray:
        if self.kind == Val.NUMS:
            return self.value
        if self.kind == Val.NUM:
            return np.array([self.value], dtype=np.float64)
        raise TypeError(f"expected numbers, got {self!r}")

    def as_strs(self) -> List[str]:
        if self.kind == Val.STRS:
            return self.value
        if self.kind == Val.STR:
            return [self.value]
        raise TypeError(f"expected strings, got {self!r}")

    def is_frame(self) -> bool:
        return self.kind == Val.FRAME

    def is_num(self) -> bool:
        return self.kind == Val.NUM

    def is_str(self) -> bool:
        return self.kind == Val.STR

    def is_fun(self) -> bool:
        return self.kind == Val.FUN

    def as_model(self):
        """Val.getModel — a MODEL val, or a str/id naming a model in the
        DKV (h2o-py serializes ModelBase args as bare model ids)."""
        if self.kind == Val.MODEL:
            return self.value
        if self.kind in (Val.STR, Val.KEYED):
            from h2o3_tpu_torch.models.framework import Model

            obj = self.value if self.kind == Val.KEYED else DKV.get(self.value)
            if isinstance(obj, Model):
                return obj
        raise TypeError(f"expected a model, got {self!r}")

    def __repr__(self) -> str:
        names = {0: "num", 1: "nums", 2: "str", 3: "strs", 4: "frame",
                 5: "row", 6: "fun", 7: "model", 8: "keyed"}
        return f"<Val:{names[self.kind]} {self.value!r}>"


class Session:
    """Per-client rapids session with temp-frame lifetime tracking
    (water/rapids/Session.java — ref-counted temps, end() sweeps them),
    the fusion choices and the device its device paths run on."""

    _ids = itertools.count()

    def __init__(self, session_id: Optional[str] = None, fusion: bool = True,
                 fusion_min_ops: int = 2, device: DeviceLike = None) -> None:
        self.id = session_id or f"session_{next(Session._ids)}"
        self.fusion = bool(fusion)
        self.fusion_min_ops = max(1, int(fusion_min_ops))
        self.device = resolve_device(device)
        self.frames: Dict[str, Frame] = {}
        self.temps: List[str] = []

    def lookup(self, key: str) -> Optional[Frame]:
        if key in self.frames:
            return self.frames[key]
        obj = DKV.get(key)
        return obj if isinstance(obj, Frame) else None

    def assign(self, key: str, fr: Frame, temp: bool = False) -> Frame:
        fr.key = key
        self.frames[key] = fr
        DKV.put(key, fr)
        if temp and key not in self.temps:
            self.temps.append(key)
        return fr

    def remove(self, key: str) -> None:
        self.frames.pop(key, None)
        DKV.remove(key)
        if key in self.temps:
            self.temps.remove(key)

    def end(self) -> int:
        """Sweep temps (Session.end). A temp read-locked by a running
        training job is skipped (Lockable) — aborting the sweep on it
        would leak every remaining temp."""
        n = len(self.temps)
        for key in list(self.temps):
            try:
                self.remove(key)
            except ValueError:
                self.frames.pop(key, None)  # in use: leave it in the DKV
        self.temps.clear()
        return n


class Env:
    """Lexical environment for lambda application (water/rapids/Env.java)."""

    def __init__(self, session: Session, parent: Optional["Env"] = None) -> None:
        self.session = session
        self.parent = parent
        self.vars: Dict[str, Val] = {}

    def lookup(self, name: str) -> Optional[Val]:
        env: Optional[Env] = self
        while env is not None:
            if name in env.vars:
                return env.vars[name]
            env = env.parent
        return None


class RapidsError(ValueError):
    pass


def parse_rapids(text: str) -> AstNode:
    return P.parse(text)


def exec_rapids(text: str, session: Optional[Session] = None) -> Val:
    """Parse + execute one rapids expression (Rapids.exec, Rapids.java:49).
    Without a session, a new :class:`Session` on the resolved device."""
    session = session or Session()
    return eval_ast(parse_rapids(text), Env(session))


def eval_ast(node: AstNode, env: Env) -> Val:
    if isinstance(node, AstNum):
        return Val.num(node.value)
    if isinstance(node, AstStr):
        return Val.str_(node.value)
    if isinstance(node, AstNumList):
        return Val.nums(node.values)
    if isinstance(node, AstStrList):
        return Val.strs(node.values)
    if isinstance(node, AstFun):
        return Val.fun(_Closure(node, env))
    if isinstance(node, AstId):
        return _eval_id(node.name, env)
    if isinstance(node, AstExec):
        return _eval_exec(node, env)
    raise RapidsError(f"cannot evaluate {node!r}")


def _eval_id(name: str, env: Env) -> Val:
    if name == "_":  # placeholder / absent-argument marker used by clients
        return Val.num(float("nan"))
    bound = env.lookup(name)
    if bound is not None:
        return bound
    fr = env.session.lookup(name)
    if fr is not None:
        return Val.frame(fr)
    obj = DKV.get(name)
    if obj is not None:  # DKV ids beyond frames: models, segment models
        from h2o3_tpu_torch.models.framework import Model

        return Val.model(obj) if isinstance(obj, Model) else Val.keyed(obj)
    from h2o3_tpu_torch.rapids.prims import PRIMS

    if name in PRIMS:
        return Val.fun(PRIMS[name])
    raise RapidsError(f"unknown identifier {name!r}")


def _eval_exec(node: AstExec, env: Env) -> Val:
    from h2o3_tpu_torch.rapids.prims import PRIMS

    # resolve the operator
    if isinstance(node.op, AstId):
        op_name = node.op.name
        if op_name in ("tmp=", "=", "assign"):
            # AstAssign registers as "assign"; "=" is the legacy spelling
            return _eval_assign("=" if op_name == "assign" else op_name,
                                node.args, env)
        prim = PRIMS.get(op_name)
        if prim is not None:
            from h2o3_tpu_torch.rapids import fusion

            fused = fusion.try_fuse(node, env)
            if fused is not None:
                return fused
            args = [eval_ast(a, env) for a in node.args]
            return prim(env, args)
        fn_val = env.lookup(op_name) or (
            Val.frame(env.session.lookup(op_name)) if env.session.lookup(op_name) else None
        )
        if fn_val is None:
            raise RapidsError(f"unknown function {op_name!r}")
    else:
        fn_val = eval_ast(node.op, env)
    args = [eval_ast(a, env) for a in node.args]
    if fn_val.is_fun():
        return apply_fun(fn_val, args, env)
    raise RapidsError(f"{fn_val!r} is not callable")


def _eval_assign(op: str, args: List[AstNode], env: Env) -> Val:
    """(tmp= key expr) — session temp; (= key expr) — global assign
    (rapids/ast/prims/assign/AstTmpAssign, AstAssign)."""
    if len(args) != 2 or not isinstance(args[0], AstId):
        raise RapidsError(f"({op} key expr) expects an identifier key")
    key = args[0].name
    val = eval_ast(args[1], env)
    fr = val.as_frame()
    env.session.assign(key, fr, temp=(op == "tmp="))
    return Val.frame(fr)


class _Closure:
    """User lambda (AstFunction): params + body + defining env."""

    def __init__(self, node: AstFun, env: Env) -> None:
        self.node = node
        self.env = env

    def __call__(self, env: Env, args: List[Val]) -> Val:
        if len(args) != len(self.node.params):
            raise RapidsError(
                f"lambda expects {len(self.node.params)} args, got {len(args)}"
            )
        inner = Env(env.session, parent=self.env)
        for name, val in zip(self.node.params, args):
            inner.vars[name] = val
        return eval_ast(self.node.body, inner)


def apply_fun(fn: Val, args: List[Val], env: Env) -> Val:
    return fn.value(env, args)
