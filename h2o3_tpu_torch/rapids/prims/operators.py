"""Rapids operators (21) — the port of ``h2o3_tpu/rapids/prims/operators.py``:
arithmetic, comparison, logical, ifelse.

Reference: ``water/rapids/ast/prims/operators/`` — And BinOp Div Eq Ge Gt
IfElse IntDiv IntDivR LAnd LOr Le Lt Mod ModR Mul Ne Or Plus Pow Sub.

The host functions are the JAX package's. Each fusible operator's emit is
float64 torch that gives numpy's bits: ``+ - * /`` are IEEE-rounded on
every device type; ``%%`` and ``%/%`` rebuild numpy's ``npy_divmod`` from
``fmod`` and fuse where ``fmod`` is exact (:data:`_FMOD_DEVICES`); the
comparisons and the logical operators return NaN where numpy's host
functions do.
"""

from __future__ import annotations

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import Column, ColType, Frame
from h2o3_tpu_torch.rapids.prims import ALL_DEVICES, prim
from h2o3_tpu_torch.rapids.prims.util import binop_frame, numeric_data
from h2o3_tpu_torch.rapids.runtime import RapidsError, Val


def _binop(name: str, fn, emit=None, devices=ALL_DEVICES):
    @prim(name, fusible=emit is not None, kind="binop", emit=emit, devices=devices)
    def op(env, args, fn=fn, name=name):
        if len(args) != 2:
            raise RapidsError(f"{name} expects 2 args")
        return _maybe_string_eq(name, args) or binop_frame(args[0], args[1], fn, name)

    return op


# ---------------------------------------------------------------------------
# emits: the torch forms of the fusible operators, float64 in and out. Each
# gives numpy's bits (NaN payloads aside) for every float64 input; ``^``
# stays unfused, since pow need not round as numpy's does.

_NAN = float("nan")

#: device types whose float64 fmod is exact, as numpy's is: torch's
#: vectorized fmod on the CPU gives NaN where the quotient overflows
#: (1e300 fmod 1e-300), so the remainder and the quotient fuse on the card
_FMOD_DEVICES = ("cuda",)


def _e_mod(a, b):
    # numpy's npy_divmod remainder: fmod (exact), then the divisor's sign; an
    # exact-zero remainder takes the divisor's sign (torch.remainder differs)
    mod = torch.fmod(a, b)
    adj = (mod != 0) & ((b < 0) != (mod < 0))
    out = torch.where(adj, mod + b, mod)
    return torch.where(mod == 0, torch.copysign(torch.zeros_like(out), b), out)


def _e_intdiv(a, b):
    # numpy's npy_divmod quotient (fmod -> sign adjust -> snap to integer):
    # floor(a/b) differs on signed zeros, b == 0 (numpy returns a/b there)
    # and inf dividends (fmod makes them NaN)
    mod = torch.fmod(a, b)
    div = (a - mod) / b
    adj = (mod != 0) & ((b < 0) != (mod < 0))
    div = torch.where(adj, div - 1.0, div)
    fd = torch.floor(div)
    fd = torch.where((div - fd) > 0.5, fd + 1.0, fd)
    q = a / b
    fd = torch.where(div == 0, torch.copysign(torch.zeros_like(fd), q), fd)
    return torch.where(b == 0, q, fd)


def _e_cmp(op):
    def e(a, b, op=op):
        out = op(a, b).to(torch.float64)
        return torch.where(torch.isnan(a) | torch.isnan(b), _NAN, out)

    return e


def _e_and(a, b):
    out = ((a != 0) & (b != 0)).to(torch.float64)
    na = torch.isnan(a) | torch.isnan(b)
    zero = (a == 0) | (b == 0)
    return torch.where(na & ~zero, _NAN, out)


def _e_or(a, b):
    out = ((a != 0) | (b != 0)).to(torch.float64)
    na = torch.isnan(a) | torch.isnan(b)
    one = (~torch.isnan(a) & (a != 0)) | (~torch.isnan(b) & (b != 0))
    return torch.where(na & ~one, _NAN, out)


def _maybe_string_eq(name, args):
    """== / != against a string literal compares CAT levels / STR values
    (reference AstEq handles categorical string comparison)."""
    if name not in ("==", "!="):
        return None
    fr_v, s_v = None, None
    if args[0].is_frame() and args[1].is_str():
        fr_v, s_v = args[0], args[1]
    elif args[1].is_frame() and args[0].is_str():
        fr_v, s_v = args[1], args[0]
    else:
        return None
    s = s_v.as_str()
    cols = []
    for c in fr_v.value.columns:
        if c.type is ColType.CAT:
            try:
                code = c.domain.index(s)
                eq = (c.data == code).astype(np.float64)
            except ValueError:
                eq = np.zeros(len(c), dtype=np.float64)
        elif c.type in (ColType.STR, ColType.UUID):
            # vectorized object-array compare: elementwise __eq__ against the
            # scalar, NA (None) cells compare unequal. Some object payloads
            # defeat numpy's elementwise broadcast (it may return a single
            # bool) — fall back to the per-row loop for those.
            arr = np.asarray(c.data, dtype=object)
            raw = arr == s
            if not (isinstance(raw, np.ndarray) and raw.shape == arr.shape):
                raw = np.fromiter((v == s for v in arr), dtype=bool,
                                  count=len(arr))
            eq = raw.astype(np.float64)
        else:
            eq = np.zeros(len(c), dtype=np.float64)
        if name == "!=":
            eq = 1.0 - eq
        cols.append(Column(c.name, eq, ColType.NUM))
    return Val.frame(Frame(cols))


# NaN-propagating comparisons return NaN for NA inputs (reference cmp semantics)
def _cmp(fn):
    def g(a, b):
        out = fn(a, b).astype(np.float64)
        na = np.isnan(a) | np.isnan(b)
        return np.where(na, np.nan, out) if np.ndim(out) else (np.nan if na else out)

    return g


_binop("+", lambda a, b: a + b, emit=lambda a, b: a + b)
_binop("-", lambda a, b: a - b, emit=lambda a, b: a - b)
_binop("*", lambda a, b: a * b, emit=lambda a, b: a * b)
_binop("/", lambda a, b: a / b, emit=lambda a, b: a / b)
_binop("^", lambda a, b: np.power(a, b))  # unfused: pow need not be numpy's
_binop("%", lambda a, b: np.mod(a, b), emit=_e_mod, devices=_FMOD_DEVICES)  # R-style modulo (AstMod)
_binop("%%", lambda a, b: np.mod(a, b), emit=_e_mod, devices=_FMOD_DEVICES)
_binop("intDiv", lambda a, b: np.floor_divide(a, b), emit=_e_intdiv,
       devices=_FMOD_DEVICES)
_binop("%/%", lambda a, b: np.floor_divide(a, b), emit=_e_intdiv,
       devices=_FMOD_DEVICES)
_binop("==", _cmp(lambda a, b: a == b), emit=_e_cmp(lambda a, b: a == b))
_binop("!=", _cmp(lambda a, b: a != b), emit=_e_cmp(lambda a, b: a != b))
_binop("<", _cmp(lambda a, b: a < b), emit=_e_cmp(lambda a, b: a < b))
_binop("<=", _cmp(lambda a, b: a <= b), emit=_e_cmp(lambda a, b: a <= b))
_binop(">", _cmp(lambda a, b: a > b), emit=_e_cmp(lambda a, b: a > b))
_binop(">=", _cmp(lambda a, b: a >= b), emit=_e_cmp(lambda a, b: a >= b))
# logical: NA-aware and/or (AstAnd/AstOr: 0 && NA == 0, 1 || NA == 1)


def _and(a, b):
    out = ((a != 0) & (b != 0)).astype(np.float64)
    na = np.isnan(a) | np.isnan(b)
    zero = (a == 0) | (b == 0)
    return np.where(na & ~zero, np.nan, out)


def _or(a, b):
    out = ((a != 0) | (b != 0)).astype(np.float64)
    na = np.isnan(a) | np.isnan(b)
    one = (~np.isnan(a) & (a != 0)) | (~np.isnan(b) & (b != 0))
    return np.where(na & ~one, np.nan, out)


_binop("&", _and, emit=_e_and)
_binop("&&", _and, emit=_e_and)
_binop("|", _or, emit=_e_or)
_binop("||", _or, emit=_e_or)


@prim(
    "ifelse",
    fusible=True,
    kind="ifelse",
    emit=lambda t, y, n: torch.where(
        torch.isnan(t), _NAN, torch.where(t != 0, y, n)
    ),
)
def ifelse(env, args):
    """(ifelse test yes no) — vectorized conditional (AstIfElse)."""
    if len(args) != 3:
        raise RapidsError("ifelse expects 3 args")
    test, yes, no = args
    if not test.is_frame():
        return yes if test.as_num() != 0 else no
    tf = test.value
    n = tf.nrows
    cols = []
    for tc in tf.columns:
        t = numeric_data(tc)

        def _branch(v):
            if v.is_frame():
                c = v.value.col(0)
                d = numeric_data(c)
                return (np.full(n, d[0]) if len(d) == 1 and n > 1 else d), c
            return np.full(n, v.as_num()), None

        yv, yc = _branch(yes)
        nv, nc = _branch(no)
        out = np.where(np.isnan(t), np.nan, np.where(t != 0, yv, nv))
        # preserve a shared categorical domain when both branches agree
        if (
            yc is not None
            and nc is not None
            and yc.type is ColType.CAT
            and nc.type is ColType.CAT
            and yc.domain == nc.domain
        ):
            codes = np.where(np.isnan(out), -1, out).astype(np.int32)
            cols.append(Column(tc.name, codes, ColType.CAT, yc.domain))
        else:
            cols.append(Column(tc.name, out, ColType.NUM))
    return Val.frame(Frame(cols))


@prim(
    "not",
    fusible=True,
    kind="uniop",
    emit=lambda x: torch.where(
        torch.isnan(x), _NAN, (x == 0).to(torch.float64)
    ),
)
def not_(env, args):
    """(not fr) — logical negation, NA-propagating (math/AstNot)."""
    from h2o3_tpu_torch.rapids.prims.util import map_columns

    v = args[0]
    if not v.is_frame():
        x = v.as_num()
        return Val.num(float("nan") if np.isnan(x) else float(x == 0))
    return Val.frame(
        map_columns(v.value, lambda a: np.where(np.isnan(a), np.nan, (a == 0).astype(np.float64)))
    )
