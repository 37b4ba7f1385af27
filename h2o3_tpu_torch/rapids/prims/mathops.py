"""Rapids math prims (36) — the port of ``h2o3_tpu/rapids/prims/mathops.py``:
elementwise transcendental/rounding functions.

Reference: ``water/rapids/ast/prims/math/`` — Abs..Trunc (SURVEY.md App. A).
All are columnwise NaN-propagating maps over numeric columns; the host
functions are the JAX package's.

Fusible are the JAX package's fusible unaries, each with a float64 torch
emit and the device types on which that emit gives numpy's bits: exact
arithmetic, rounding and selection fuse everywhere. torch's float64
``sqrt`` on the CPU is vectorized with SLEEF and is not correctly rounded
(numpy's is), so ``sqrt`` fuses on the card alone; ``sin``, ``cos``,
``sinpi`` and ``cospi`` rest on a libm whose last bit need not be glibc's
and fuse on no device type here (ROADMAP C3). The rest of the
transcendental family and the scipy specials stay interpreted, as in the
JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy import special as _sp_special

from h2o3_tpu_torch.rapids.prims import ALL_DEVICES, prim
from h2o3_tpu_torch.rapids.prims.util import map_columns
from h2o3_tpu_torch.rapids.runtime import RapidsError, Val

#: device types whose float64 sqrt is correctly rounded, as numpy's is
_SQRT_DEVICES = ("cuda",)
#: device types whose float64 sin and cos give glibc's bits
_TRIG_DEVICES = ()


def _uniop(name: str, fn, emit=None, devices=ALL_DEVICES):
    @prim(name, fusible=emit is not None, kind="uniop", emit=emit,
          devices=devices)
    def op(env, args, fn=fn, name=name):
        if len(args) != 1:
            raise RapidsError(f"{name} expects 1 arg")
        v = args[0]
        if v.is_frame():
            return Val.frame(map_columns(v.value, fn))
        with np.errstate(all="ignore"):
            return Val.num(float(fn(np.float64(v.as_num()))))

    return op


def _e_sign(x):
    # numpy's sign(-0.0) is +0.0 and sign(NaN) NaN; torch's sign keeps the
    # zero's sign and gives 0 for NaN
    return torch.where(torch.isnan(x), x, torch.where(x == 0.0, 0.0, torch.sign(x)))


_uniop("abs", np.abs, emit=torch.abs)
_uniop("acos", np.arccos)
_uniop("acosh", np.arccosh)
_uniop("asin", np.arcsin)
_uniop("asinh", np.arcsinh)
_uniop("atan", np.arctan)
_uniop("atanh", np.arctanh)
_uniop("ceiling", np.ceil, emit=torch.ceil)
_uniop("cos", np.cos, emit=torch.cos, devices=_TRIG_DEVICES)
_uniop("cospi", lambda x: np.cos(np.pi * x),
       emit=lambda x: torch.cos(math.pi * x), devices=_TRIG_DEVICES)
_uniop("cosh", np.cosh)
_uniop("digamma", _sp_special.digamma)
_uniop("exp", np.exp)
_uniop("expm1", np.expm1)
_uniop("floor", np.floor, emit=torch.floor)
_uniop("gamma", _sp_special.gamma)
_uniop("lgamma", _sp_special.gammaln)
_uniop("log", np.log)
_uniop("log10", np.log10)
_uniop("log1p", np.log1p)
_uniop("log2", np.log2)
_uniop("sgn", np.sign, emit=_e_sign)
_uniop("sign", np.sign, emit=_e_sign)
_uniop("sin", np.sin, emit=torch.sin, devices=_TRIG_DEVICES)
_uniop("sinpi", lambda x: np.sin(np.pi * x),
       emit=lambda x: torch.sin(math.pi * x), devices=_TRIG_DEVICES)
_uniop("sinh", np.sinh)
_uniop("sqrt", np.sqrt, emit=torch.sqrt, devices=_SQRT_DEVICES)
_uniop("tan", np.tan)
_uniop("tanpi", lambda x: np.tan(np.pi * x))
_uniop("tanh", np.tanh)
_uniop("trigamma", lambda x: _sp_special.polygamma(1, x))
_uniop("trunc", np.trunc, emit=torch.trunc)
_uniop("none", lambda x: x, emit=lambda x: x)  # AstNoOp


def _round_half_even(x, digits):
    # R/H2O round: IEC 60559 round-half-to-even (AstRound)
    return np.round(x, int(digits))


def _round_fuse_args(ast_args):
    # only the digits=0 form fuses: torch.round is numpy's half-to-even
    # there, while the scaled digits!=0 path multiplies by 10^d and may
    # part in the last ulp
    from h2o3_tpu_torch.rapids.parser import AstNum

    if len(ast_args) == 1:
        return True
    return (len(ast_args) == 2 and isinstance(ast_args[1], AstNum)
            and ast_args[1].value == 0)


@prim("round", fusible=True, kind="uniop", emit=torch.round,
      fuse_args=_round_fuse_args)
def round_(env, args):
    digits = args[1].as_num() if len(args) > 1 else 0
    v = args[0]
    if v.is_frame():
        return Val.frame(map_columns(v.value, lambda a: _round_half_even(a, digits)))
    return Val.num(float(_round_half_even(np.float64(v.as_num()), digits)))


@prim("signif")
def signif(env, args):
    """(signif fr digits) — round to significant digits (AstSignif)."""
    digits = int(args[1].as_num()) if len(args) > 1 else 6
    digits = max(digits, 1)

    def fn(a):
        with np.errstate(all="ignore"):
            mag = np.where(a == 0, 1.0, np.power(10.0, digits - 1 - np.floor(np.log10(np.abs(a)))))
            return np.round(a * mag) / mag

    v = args[0]
    if v.is_frame():
        return Val.frame(map_columns(v.value, fn))
    return Val.num(float(fn(np.array([v.as_num()]))[0]))
