"""Rapids primitive registry — the port of ``h2o3_tpu/rapids/prims/__init__.py``.

Reference: ``water/rapids/ast/prims/{mungers,math,reducers,operators,advmath,
string,time,matrix,assign,search,...}``; each ``Ast*`` class registers a
name. Each primitive is a function ``prim(env, args: List[Val]) -> Val``
registered under one or more rapids names.

Fusibility: a prim may declare itself *fusible*, eligible for the fusion
pass (``rapids/fusion.py``), which runs maximal subtrees of fusible ops as
one column program on the session's device instead of interpreting them op
at a time. A fusible prim carries an ``emit(*args)`` that computes its
host-numpy elementwise semantics in float64 torch, bit for bit, and
``devices``: the device types on which the emit gives numpy's bits. A prim
fuses only on those; elsewhere it is a region leaf and runs through the
interpreter. ``tests/test_torch_rapids.py`` holds every emit to numpy on
the CPU, and ``chip_smoke.py`` on the card.

Every group is ported: the registry's names are the JAX package's. The
prims of ``strings``, ``times``, ``advmath``, ``models`` and ``search``
run on the host in numpy, as in the JAX package; a fused region among their
arguments still runs on the session's device.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

PRIMS: Dict[str, Callable] = {}

#: every device type the port runs on
ALL_DEVICES = ("cpu", "cuda")


class FuseSpec:
    """Fusibility declaration for one prim.

    kind:
      * ``binop``  — 2-arg elementwise with H2O broadcasting (emit required)
      * ``uniop``  — 1-arg columnwise map (emit required)
      * ``ifelse`` — 3-arg vectorized conditional (emit required)
      * ``select`` — static column re-indexing (cols/cols_py; structural,
                     no emit: the fusion pass rewires column references)
      * ``reduce`` — trailing reducer: the fused program materializes its
                     child chain in one dispatch and the reducer itself runs
                     as a host epilogue through the registered prim, so the
                     combine is the interpreter's by construction

    ``fuse_args(ast_args)`` — optional static predicate over the
    *unevaluated* AST argument list; a node whose args fail it is a region
    leaf (``round`` only fuses the digits=0 form, ``cols`` only literal
    selectors, reducers only the single-arg form).

    ``devices`` — the device types on which the emit gives numpy's bits.
    """

    __slots__ = ("name", "kind", "emit", "fuse_args", "devices")

    _EMIT_KINDS = ("binop", "uniop", "ifelse")

    def __init__(self, name: str, kind: str, emit: Optional[Callable],
                 fuse_args: Optional[Callable],
                 devices: Tuple[str, ...] = ALL_DEVICES) -> None:
        if kind not in ("binop", "uniop", "ifelse", "select", "reduce"):
            raise RuntimeError(f"prim {name!r}: unknown fuse kind {kind!r}")
        if kind in self._EMIT_KINDS and emit is None:
            raise RuntimeError(
                f"prim {name!r} is flagged fusible ({kind}) but has no emit")
        self.name = name
        self.kind = kind
        self.emit = emit
        self.fuse_args = fuse_args
        self.devices = tuple(devices)


#: rapids name -> FuseSpec for every prim the fusion pass may fold
FUSIBLE: Dict[str, FuseSpec] = {}


def prim(*names: str, fusible: bool = False, kind: Optional[str] = None,
         emit: Optional[Callable] = None,
         fuse_args: Optional[Callable] = None,
         devices: Tuple[str, ...] = ALL_DEVICES):
    """Register a primitive under the given rapids op names.

    ``fusible=True`` also registers a :class:`FuseSpec` so the fusion pass
    may fold the op into a column program on ``devices``; ``kind``, ``emit``
    and ``fuse_args`` describe how (see FuseSpec)."""

    def deco(fn):
        for n in names:
            if n in PRIMS:
                raise RuntimeError(f"duplicate rapids prim {n!r}")
            PRIMS[n] = fn
            if fusible:
                FUSIBLE[n] = FuseSpec(n, kind, emit, fuse_args, devices)
        return fn

    return deco


# importing the groups populates PRIMS
from h2o3_tpu_torch.rapids.prims import (  # noqa: E402,F401
    advmath,
    assign,
    mathops,
    matrix,
    models,
    mungers,
    operators,
    reducers,
    search,
    strings,
    times,
)
