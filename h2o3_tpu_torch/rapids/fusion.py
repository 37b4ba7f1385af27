"""Rapids query fusion — the port of ``h2o3_tpu/rapids/fusion.py``: munging
pipelines as one column program on the session's device.

The evaluator in runtime.py executes op-at-a-time on host numpy: every prim
materializes a full intermediate Frame. Before interpreting a prim
application, this pass greedily covers the maximal subtree of *fusible* ops
rooted there (``rapids/prims.FUSIBLE``: arithmetic, comparison and logical
operators, exact per-row math, per-row mungers, trailing reducers), lowers
it to one column program, and runs it as one ``map_batches`` call over the
leaves' columns on the device, in float64, one torch op after another.

Pipeline per candidate region:

1. **Scan** (static, no evaluation): walk the AST from the fusible root;
   non-fusible children become region *leaves* in depth-first argument
   order, the order the interpreter would evaluate them. A prim whose emit
   does not give numpy's bits on the session's device type
   (``FuseSpec.devices``) is a leaf there.
2. **Leaf evaluation**: each leaf AST evaluates once through the normal
   evaluator (nested fusible regions inside a leaf fuse recursively).
3. **Plan lookup**: the plan is memoized in the plan cache
   (:func:`h2o3_tpu_torch.compute.mapreduce.plan_memo`) keyed on the
   subtree's canonical S-expression, the leaf schema and the device type,
   so a repeated pipeline plans nothing.
4. **Lowering** (on a miss): replicate ``binop_frame``'s broadcasting and
   naming rules symbolically, producing one expression per output column
   over column references and scalar slots. Literal-only scalar
   subexpressions fold on the host through the registered prims.
5. **Host checks**: one row count across the inputs, no string column in
   the arithmetic (memoized on the inputs' ``region_token``).
6. **Dispatch**: the referenced columns resolve through the device frame
   cache as float64 ``FrameTable``s keyed on column version stamps (an
   unmutated frame uploads nothing), and the program runs on them.
   Trailing reducers run as a host epilogue through their registered prim.

What the lowering cannot prove bit-identical (string/categorical
semantics, 1-row broadcasts, computed selectors, duplicate output names,
runtime type surprises) raises :class:`_Unfusible` in steps 3-5, before
anything is launched, and the region *replays* through the same prim
functions on the already-evaluated leaf values: no double evaluation, and
results (including raised errors) match the interpreter's. The JAX
package replays after any exception, the dispatch's included; here a
failure in step 6 propagates, and no host answer stands in for it.

The session's ``fusion`` (off: the evaluator is the plain interpreter) and
``fusion_min_ops`` (default 2: the fewest fused ops worth a device round
trip) take the place of the JAX package's environment knobs. The JAX
package's chunk-codec decode specs (``affine``, ``dict``, ``const``) and its
hand-off of chunk-homed leaves to the cluster (``peek_dist``, ``try_dist``)
wait for the codec and cluster ports (ROADMAP A11, A10); with no cloud the
JAX package takes the path kept here.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from h2o3_tpu_torch.compute.mapreduce import (
    FrameTable,
    gather_rows,
    map_batches,
    plan_memo,
)
from h2o3_tpu_torch.frame.devcache import region_token
from h2o3_tpu_torch.frame.frame import Column, ColType, Frame
from h2o3_tpu_torch.rapids.parser import (
    AstExec,
    AstId,
    AstNum,
    AstNumList,
    AstStr,
    AstStrList,
    canonical_sexpr,
)
from h2o3_tpu_torch.rapids.prims import FUSIBLE, PRIMS
from h2o3_tpu_torch.rapids.runtime import Val, eval_ast

#: regions run as one program ("fused") or replayed through the
#: interpreter's prims ("fallback") since the process started
COUNTS = {"fused": 0, "fallback": 0}
_counts_lock = threading.Lock()


def _bump(what: str) -> None:
    with _counts_lock:
        COUNTS[what] += 1


class _Unfusible(Exception):
    """Region cannot run bit-identically as one program — replay it instead."""


#: negative plan-cache sentinel: this (sexpr, schema) can never fuse
_UNFUSIBLE_PLAN = "unfusible"

#: AST children the scanner descends into, per fuse kind (remaining args —
#: round digits, cols selectors — are static and handled by the lowering)
_SCAN_ARITY = {"binop": 2, "uniop": 1, "ifelse": 3, "select": 1, "reduce": 1}
_DEFAULT_ARITY = {"binop": 2, "uniop": 1, "ifelse": 3}


# ---------------------------------------------------------------------------
# phase 1: static region scan


def _node_spec(node, root: bool, dev_type: str):
    """FuseSpec if ``node`` is a fusible application on device type
    ``dev_type``, else None (leaf)."""
    if not (isinstance(node, AstExec) and isinstance(node.op, AstId)):
        return None
    spec = FUSIBLE.get(node.op.name)
    if spec is None:
        return None
    if dev_type not in spec.devices:
        return None
    if spec.kind == "reduce" and not root:
        # interior reducers produce scalars; they stay interpreter leaves
        # (their own argument chain still fuses when the leaf evaluates)
        return None
    if spec.fuse_args is not None:
        if not spec.fuse_args(node.args):
            return None
    elif len(node.args) != _DEFAULT_ARITY.get(spec.kind, -1):
        return None
    return spec


def _scan(node, leaves: List, seen: set, dev_type: str) -> int:
    """Fused-op count under ``node``; leaves collect in DFS arg order."""
    if isinstance(node, AstNum):
        return 0
    spec = _node_spec(node, False, dev_type)
    if spec is None:
        if id(node) not in seen:
            seen.add(id(node))
            leaves.append(node)
        return 0
    n = 1
    for child in node.args[: _SCAN_ARITY[spec.kind]]:
        n += _scan(child, leaves, seen, dev_type)
    return n


# ---------------------------------------------------------------------------
# phase 2: lowering — symbolic column sets replicating binop_frame exactly
#
# Column expressions (plain tuples, safe to close over and hash-print):
#   ("lit", v)            — float literal, baked into the plan key
#   ("sval", k)           — k-th runtime scalar leaf, passed as a traced arg
#   ("colref", li, name)  — column ``name`` of frame leaf ``li``
#   ("emit", prim, *xs)   — FUSIBLE[prim].emit(*xs)


class _C:
    """One symbolic column: name + expression + leaf-type flags."""

    __slots__ = ("name", "expr", "is_cat", "is_str")

    def __init__(self, name, expr, is_cat=False, is_str=False):
        self.name = name
        self.expr = expr
        self.is_cat = is_cat
        self.is_str = is_str

    def numeric(self):
        # the analogue of util.numeric_data: string columns cannot enter
        # numeric compute (the interpreter raises; we fall back and let it)
        if self.is_str:
            raise _Unfusible
        return self.expr


class _Cols:
    __slots__ = ("cols",)

    def __init__(self, cols):
        self.cols = cols


class _Scalar:
    __slots__ = ("expr",)

    def __init__(self, expr):
        self.expr = expr


def _fold(name: str, scalars: List[float]) -> float:
    """Host-fold a literal-only application through the registered prim —
    identical to the interpreter's scalar path by construction."""
    out = PRIMS[name](None, [Val.num(s) for s in scalars])
    return float(out.as_num())


def _leaf_schema(v: Val) -> Tuple:
    if v.kind == Val.FRAME:
        cols = tuple(
            (c.name,
             1 if c.type in (ColType.STR, ColType.UUID) else
             2 if c.type is ColType.CAT else 0)
            for c in v.value.columns)
        return ("frame",) + cols
    if v.kind == Val.NUM:
        return ("num",)
    if v.kind == Val.NUMS:
        return ("num",) if len(v.value) == 1 else ("nums", len(v.value))
    return ("other", v.kind)


class _Plan:
    __slots__ = ("static", "out_names", "outputs", "dev_exprs", "refs",
                 "sval_leaves", "lit_vals", "reduce_name", "fn",
                 "validated_token")

    def __init__(self):
        self.static = None          # folded scalar result, or None
        self.out_names = ()         # output column names
        self.outputs = ()           # ("host", li, name) | ("dev", k)
        self.dev_exprs = ()         # computed column expressions
        self.refs = ()              # ordered unique (li, name) device inputs
        self.sval_leaves = ()       # leaf indices feeding scalar slots
        self.lit_vals = ()          # literal constants fed as runtime scalars
        self.reduce_name = None     # host-epilogue reducer prim, if any
        self.fn = None              # the column program (stable identity)
        self.validated_token = None  # region_token of last validated inputs


def _build_plan(node, leaf_idx_by_id: Dict[int, int],
                schemas: Tuple, dev_type: str) -> "_Plan":
    sval_slots: Dict[int, int] = {}
    for i, sch in enumerate(schemas):
        if sch == ("num",):
            sval_slots[i] = len(sval_slots)

    def leaf_cols(idx: int) -> "_Cols":
        sch = schemas[idx]
        names = [name for name, _tc in sch[1:]]
        if len(set(names)) != len(names):
            raise _Unfusible  # by-name column refs need unique names
        return _Cols([
            _C(name, ("colref", idx, name), is_cat=tc == 2, is_str=tc == 1)
            for name, tc in sch[1:]
        ])

    def branch01(v):
        """ifelse branch: scalar expr, or col(0) of a frame (the prim
        always takes column 0 regardless of width)."""
        if isinstance(v, _Scalar):
            return v.expr, False
        c = v.cols[0]
        return c.numeric(), c.is_cat

    def low(n, root=False):
        if isinstance(n, AstNum):
            return _Scalar(("lit", float(n.value)))
        idx = leaf_idx_by_id.get(id(n))
        if idx is not None:
            sch = schemas[idx]
            if sch[0] == "frame":
                return leaf_cols(idx)
            if sch == ("num",):
                return _Scalar(("sval", sval_slots[idx]))
            raise _Unfusible
        spec = _node_spec(n, root, dev_type)
        if spec is None:  # scanner invariant: every non-leaf is fusible
            raise _Unfusible
        name = n.op.name
        if spec.kind == "reduce":
            child = low(n.args[0])
            return ("reduce", name, child)
        if spec.kind == "select":
            a = low(n.args[0])
            if isinstance(a, _Scalar):
                raise _Unfusible  # as_frame coercion of scalars: fall back
            return _Cols([a.cols[j] for j in _sel_indices(a, n.args[1])])
        if spec.kind == "uniop":
            a = low(n.args[0])
            if isinstance(a, _Scalar):
                if a.expr[0] == "lit":
                    return _Scalar(("lit", _fold(name, [a.expr[1]])))
                return _Scalar(("emit", name, a.expr))
            return _Cols([
                _C(c.name, ("emit", name, c.numeric())) for c in a.cols
            ])
        if spec.kind == "ifelse":
            t = low(n.args[0])
            y = low(n.args[1])
            z = low(n.args[2])
            for b in (y, z):
                if not isinstance(b, (_Scalar, _Cols)):
                    raise _Unfusible
            if isinstance(t, _Scalar):
                if t.expr[0] != "lit":
                    raise _Unfusible
                # (ifelse scalar y n): branch VALUE selection; NaN tests
                # true (nan != 0) exactly like the interpreter's as_num path
                return y if t.expr[1] != 0 else z
            ye, ycat = branch01(y)
            ze, zcat = branch01(z)
            if ycat and zcat:
                # both branches categorical: the interpreter may preserve a
                # shared domain — a non-NUM output shape we never fuse
                raise _Unfusible
            return _Cols([
                _C(tc.name, ("emit", name, tc.numeric(), ye, ze))
                for tc in t.cols
            ])
        # binop — replicate binop_frame's pairing and naming byte-for-byte
        a = low(n.args[0])
        b = low(n.args[1])
        if isinstance(a, _Scalar) and isinstance(b, _Scalar):
            if a.expr[0] == "lit" and b.expr[0] == "lit":
                return _Scalar(
                    ("lit", _fold(name, [a.expr[1], b.expr[1]])))
            return _Scalar(("emit", name, a.expr, b.expr))
        if isinstance(a, _Cols) and isinstance(b, _Scalar):
            return _Cols([
                _C(c.name, ("emit", name, c.numeric(), b.expr))
                for c in a.cols
            ])
        if isinstance(a, _Scalar) and isinstance(b, _Cols):
            return _Cols([
                _C(c.name, ("emit", name, a.expr, c.numeric()))
                for c in b.cols
            ])
        na, nb = len(a.cols), len(b.cols)
        if na == nb:
            pairs = zip(a.cols, b.cols)
        elif nb == 1:
            pairs = ((x, b.cols[0]) for x in a.cols)
        elif na == 1:
            pairs = ((a.cols[0], y) for y in b.cols)
        else:
            raise _Unfusible  # interpreter raises; the fallback will too
        return _Cols([
            _C(x.name, ("emit", name, x.numeric(), y.numeric()))
            for x, y in pairs
        ])

    plan = _Plan()
    res = low(node, root=True)
    if isinstance(res, tuple) and res[0] == "reduce":
        plan.reduce_name = res[1]
        res = res[2]
        if isinstance(res, _Scalar):
            # (reduce scalar) is the scalar itself (interpreter: as_num)
            if res.expr[0] == "lit":
                plan.static = res.expr[1]
                return plan
            raise _Unfusible
    if isinstance(res, _Scalar):
        if res.expr[0] == "lit":
            plan.static = res.expr[1]
            return plan
        raise _Unfusible  # pure-scalar chains: host interpreter is exact
    outputs: List[Tuple] = []
    dev_exprs: List[Tuple] = []
    for c in res.cols:
        if c.expr[0] == "colref":
            # bare pass-through: reuse the host Column object (type, domain
            # and aliasing identical to the interpreter's cols path)
            outputs.append(("host", c.expr[1], c.expr[2]))
        else:
            outputs.append(("dev", len(dev_exprs)))
            dev_exprs.append(c.expr)
    plan.out_names = tuple(c.name for c in res.cols)
    if len(set(plan.out_names)) != len(plan.out_names):
        raise _Unfusible  # the interpreter's Frame raises; the replay will too
    plan.outputs = tuple(outputs)
    # literals become runtime scalar slots, as in the JAX package (there so
    # that XLA's simplifier cannot fold x + 0.0 -> x, which flips the sign
    # of zero); eager torch folds nothing, and one slot layout keeps the
    # program's inputs the JAX package's. The plan key already pins the
    # literal values via the canonical S-expression.
    dev_exprs, lit_vals = _externalize_lits(dev_exprs, len(sval_slots))
    plan.lit_vals = tuple(lit_vals)
    plan.dev_exprs = tuple(dev_exprs)
    refs: Dict[Tuple[int, str], None] = {}

    def walk(e):
        if e[0] == "colref":
            refs.setdefault((e[1], e[2]))
        elif e[0] == "emit":
            for x in e[2:]:
                walk(x)

    for e in dev_exprs:
        walk(e)
    plan.refs = tuple(refs)
    plan.sval_leaves = tuple(sorted(sval_slots, key=sval_slots.get))
    if dev_exprs:
        plan.fn = _make_fn(plan.dev_exprs)
    return plan


def _externalize_lits(exprs: List[Tuple], base_slot: int):
    """Rewrite every ("lit", v) into a fresh ("sval", slot) past the leaf
    slots, returning the rewritten exprs and the literal values in slot
    order."""
    lits: List[float] = []

    def sub(e):
        if e[0] == "lit":
            slot = base_slot + len(lits)
            lits.append(e[1])
            return ("sval", slot)
        if e[0] == "emit":
            return ("emit", e[1]) + tuple(sub(x) for x in e[2:])
        return e

    return [sub(e) for e in exprs], lits


def _sel_indices(a: "_Cols", sel) -> List[int]:
    """Static column selection, replicating util.col_indices; any
    out-of-range/unknown selector falls back so the interpreter raises."""
    names = [c.name for c in a.cols]
    if isinstance(sel, AstStr):
        picks = [sel.value]
    elif isinstance(sel, AstStrList):
        picks = list(sel.values)
    else:
        vals = [sel.value] if isinstance(sel, AstNum) else list(sel.values)
        out = []
        for v in vals:
            j = int(np.int64(v))
            if j < 0:
                j += len(names)
            if not 0 <= j < len(names):
                raise _Unfusible
            out.append(j)
        return out
    try:
        return [names.index(s) for s in picks]
    except ValueError:
        raise _Unfusible


def _akey(li: int, name: str) -> str:
    return f"{li}:{name}"


def _make_fn(dev_exprs: Tuple, decode: Tuple = ()):
    """The column program, one closure per cached plan.

    ``decode`` maps column-ref akeys to decode specs: absent or
    ``("dense",)``, the input is plain float64; ``("f32",)``, float32
    storage widened in the program (exact). The JAX package's codec specs
    (``affine``, ``dict``, ``const``) wait for the chunk codecs."""
    dec = dict(decode)

    def fused_program(arrays, mask, *svals):
        def col(li, name):
            akey = _akey(li, name)
            spec = dec.get(akey)
            if spec is None or spec[0] == "dense":
                return arrays[akey]
            if spec[0] == "f32":
                return arrays[akey].to(torch.float64)
            raise ValueError(f"unknown decode spec {spec[0]!r}")

        def ev(e):
            tag = e[0]
            if tag == "sval":
                return svals[e[1]]
            if tag == "colref":
                return col(e[1], e[2])
            return FUSIBLE[e[1]].emit(*[ev(x) for x in e[2:]])

        return tuple(ev(e) for e in dev_exprs)

    return fused_program


# ---------------------------------------------------------------------------
# phase 3: host checks (may raise _Unfusible), then the dispatch (never caught)


def _prepare(plan: "_Plan", leaf_vals: List[Val]) -> Dict[str, Any]:
    """Everything the dispatch needs, decided on the host before anything is
    launched; raises :class:`_Unfusible` where the interpreter must run."""
    used: Dict[int, None] = {}
    for kind, *rest in plan.outputs:
        if kind == "host":
            used.setdefault(rest[0])
    for li, _name in plan.refs:
        used.setdefault(li)
    frames = {li: leaf_vals[li].value for li in used}
    nrows = {fr.nrows for fr in frames.values()}
    if len(nrows) != 1 or 0 in nrows:
        raise _Unfusible  # mixed row counts = 1-row broadcasts: interpreter
    ref_lis = list(dict.fromkeys(li for li, _ in plan.refs))
    by_leaf = {li: [n for j, n in plan.refs if j == li] for li in ref_lis}
    rtok = region_token([(frames[li], by_leaf[li]) for li in ref_lis])
    if rtok is None or rtok != plan.validated_token:
        for li, name in plan.refs:
            if frames[li].col(name).type in (ColType.STR, ColType.UUID):
                raise _Unfusible
        plan.validated_token = rtok
    svals = [float(leaf_vals[li].as_num()) for li in plan.sval_leaves]
    svals += list(plan.lit_vals)
    return {"frames": frames, "n_valid": next(iter(nrows)), "ref_lis": ref_lis,
            "by_leaf": by_leaf, "svals": svals}


def _dispatch(plan: "_Plan", prep: Dict[str, Any], env) -> Val:
    """Run the program on the session's device (float64 end to end, as the
    interpreter computes on the host) and assemble the result."""
    frames, n_valid = prep["frames"], prep["n_valid"]
    dev_host: List[np.ndarray] = []
    if plan.dev_exprs:
        dev = env.session.device
        merged: Dict[str, Any] = {}
        for li in prep["ref_lis"]:
            t = FrameTable.from_frame(frames[li], columns=prep["by_leaf"][li],
                                      device=dev, dtype=torch.float64)
            for name in prep["by_leaf"][li]:
                merged[_akey(li, name)] = t.arrays[name]
            mask = t.mask
        table = FrameTable(merged, mask, n_valid, dev, t.mesh)
        slots = torch.tensor(prep["svals"], dtype=torch.float64, device=dev)
        outs = map_batches(plan.fn, table, *slots.unbind())
        dev_host = [gather_rows(o, n_valid).copy() for o in outs]
    cols = []
    for name, out in zip(plan.out_names, plan.outputs):
        if out[0] == "host":
            cols.append(frames[out[1]].col(out[2]))
        else:
            cols.append(Column(name, dev_host[out[1]], ColType.NUM))
    result = Frame(cols)
    if plan.reduce_name is not None:
        return PRIMS[plan.reduce_name](env, [Val.frame(result)])
    return Val.frame(result)


# ---------------------------------------------------------------------------
# fallback: replay the region through the interpreter prims


def _replay(node, env, leaf_val_by_id: Dict[int, Val]) -> Val:
    v = leaf_val_by_id.get(id(node))
    if v is not None:
        return v
    if isinstance(node, AstExec):
        args = [_replay(a, env, leaf_val_by_id) for a in node.args]
        return PRIMS[node.op.name](env, args)
    return eval_ast(node, env)  # literals / static selector args


# ---------------------------------------------------------------------------
# entry point


def try_fuse(node: AstExec, env) -> Optional[Val]:
    """Attempt to execute ``node`` as one fused dispatch.

    Returns the result Val, or None when the node is not a worthwhile
    region root (the caller then interprets it normally). Leaf subtrees are
    evaluated exactly once in interpreter order. A region that cannot fuse
    (decided on the host, before any launch) replays over those values
    through the same prim functions, so results and raised errors match the
    interpreter; a failure of the dispatch itself propagates."""
    session = env.session
    if not session.fusion:
        return None
    dev_type = session.device.type
    spec = _node_spec(node, True, dev_type)
    if spec is None:
        return None
    leaves: List = []
    seen: set = set()
    n_ops = 1
    for child in node.args[: _SCAN_ARITY[spec.kind]]:
        n_ops += _scan(child, leaves, seen, dev_type)
    if n_ops < session.fusion_min_ops:
        # below the device-dispatch threshold: interpret normally
        return None
    leaf_vals = [eval_ast(leaf, env) for leaf in leaves]
    try:
        schemas = tuple(_leaf_schema(v) for v in leaf_vals)
        key = (canonical_sexpr(node), schemas, dev_type)
        leaf_idx_by_id = {id(leaf): i for i, leaf in enumerate(leaves)}

        def build():
            try:
                return _build_plan(node, leaf_idx_by_id, schemas, dev_type)
            except _Unfusible:
                return _UNFUSIBLE_PLAN

        plan = plan_memo("rapids_fusion", key, build)
        if plan == _UNFUSIBLE_PLAN:
            raise _Unfusible
        if plan.static is not None:
            _bump("fused")
            return Val.num(plan.static)
        prep = _prepare(plan, leaf_vals)
    except Exception:
        # a region that cannot fuse, or an error while planning on the host
        # (a user error re-raises from the replay, as the interpreter would)
        _bump("fallback")
        return _replay(node, env, {id(l): v for l, v in zip(leaves, leaf_vals)})
    result = _dispatch(plan, prep, env)
    _bump("fused")
    return result
