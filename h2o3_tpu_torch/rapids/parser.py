"""Rapids AST parser — the port of ``h2o3_tpu/rapids/parser.py`` (copied:
host Python, no device code).

Reference grammar (``water/rapids/Rapids.java:19-40``)::

    expr  := '(' op arg* ')'            function application
    arg   := expr | num | string | numlist | strlist | id | fun
    num   := [-+0-9.eE]+  | NaN
    string:= "..." | '...'
    numlist := '[' (num | num:count | num:count:stride)* ']'
    strlist := '[' string* ']'
    fun   := '{' id* '.' expr '}'       lambda (AstFunction)
    id    := anything else (frame key / symbol / builtin name)

Produces plain-python AST nodes consumed by ``rapids/runtime.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple, Union

import numpy as np


@dataclass
class AstNum:
    value: float


@dataclass
class AstStr:
    value: str


@dataclass
class AstId:
    name: str


@dataclass
class AstNumList:
    # expanded host array; ranges like 0:4 / 0:4:2 expand at parse time
    values: np.ndarray


@dataclass
class AstStrList:
    values: List[str]


@dataclass
class AstExec:
    op: "AstNode"
    args: List["AstNode"]


@dataclass
class AstFun:
    params: List[str]
    body: "AstNode"


AstNode = Union[AstNum, AstStr, AstId, AstNumList, AstStrList, AstExec, AstFun]


class RapidsParseError(ValueError):
    pass


class _Scanner:
    def __init__(self, text: str) -> None:
        self.text = text
        self.pos = 0

    def peek(self) -> str:
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def next(self) -> str:
        ch = self.peek()
        self.pos += 1
        return ch

    def skip_ws(self) -> None:
        # note: peek() returns "" at EOF and "" is a substring of anything,
        # so the emptiness check must come first
        while self.peek() and self.peek() in " \t\n\r,":
            self.pos += 1

    def token(self) -> str:
        """Read a bare token (number / id) up to a delimiter."""
        start = self.pos
        while self.peek() and self.peek() not in " \t\n\r,()[]{}\"'":
            self.pos += 1
        return self.text[start : self.pos]

    def string(self) -> str:
        quote = self.next()
        out = []
        while True:
            ch = self.next()
            if not ch:
                raise RapidsParseError("unterminated string literal")
            if ch == "\\":
                nxt = self.next()
                out.append({"n": "\n", "t": "\t", "\\": "\\", quote: quote}.get(nxt, nxt))
            elif ch == quote:
                return "".join(out)
            else:
                out.append(ch)


def _parse_number(tok: str) -> float:
    if tok in ("NaN", "nan", "NA"):
        return float("nan")
    return float(tok)


def _is_number(tok: str) -> bool:
    if tok in ("NaN", "nan", "NA"):
        return True
    try:
        float(tok)
        return True
    except ValueError:
        return False


def parse(text: str) -> AstNode:
    sc = _Scanner(text)
    node = _parse_one(sc)
    sc.skip_ws()
    if sc.peek():
        raise RapidsParseError(f"trailing input at {sc.pos}: {sc.text[sc.pos:sc.pos+20]!r}")
    return node


def _parse_one(sc: _Scanner) -> AstNode:
    sc.skip_ws()
    ch = sc.peek()
    if not ch:
        raise RapidsParseError("unexpected end of input")
    if ch == "(":
        sc.next()
        op = _parse_one(sc)
        args: List[AstNode] = []
        while True:
            sc.skip_ws()
            if sc.peek() == ")":
                sc.next()
                return AstExec(op, args)
            if not sc.peek():
                raise RapidsParseError("unterminated (")
            args.append(_parse_one(sc))
    if ch == "[":
        return _parse_list(sc)
    if ch == "{":
        return _parse_fun(sc)
    if ch in "\"'":
        return AstStr(sc.string())
    tok = sc.token()
    if not tok:
        raise RapidsParseError(f"unexpected char {ch!r} at {sc.pos}")
    if _is_number(tok):
        return AstNum(_parse_number(tok))
    return AstId(tok)


def _parse_list(sc: _Scanner) -> Union[AstNumList, AstStrList]:
    sc.next()  # [
    nums: List[np.ndarray] = []
    strs: List[str] = []
    while True:
        sc.skip_ws()
        ch = sc.peek()
        if ch == "]":
            sc.next()
            break
        if not ch:
            raise RapidsParseError("unterminated [")
        if ch in "\"'":
            strs.append(sc.string())
            continue
        tok = sc.token()
        if not tok:
            raise RapidsParseError(f"bad list element at {sc.pos}")
        nums.append(_expand_range(tok))
    if strs and nums:
        raise RapidsParseError("mixed numeric/string list")
    if strs:
        return AstStrList(strs)
    flat = np.concatenate(nums) if nums else np.empty(0, dtype=np.float64)
    return AstNumList(flat)


def _expand_range(tok: str) -> np.ndarray:
    """``base`` | ``base:count`` | ``base:count:stride`` (AstNumList ranges)."""
    parts = tok.split(":")
    if len(parts) == 1:
        return np.array([_parse_number(parts[0])], dtype=np.float64)
    base = _parse_number(parts[0])
    count = int(_parse_number(parts[1]))
    stride = _parse_number(parts[2]) if len(parts) == 3 else 1.0
    if count < 0:
        raise RapidsParseError(f"negative range count in {tok!r}")
    return base + stride * np.arange(count, dtype=np.float64)


def canonical_sexpr(node: AstNode) -> str:
    """Deterministic S-expression serialization of an AST subtree.

    The fusion pass keys compiled column-programs on this string (plus the
    input schema), so two textually different but structurally identical
    expressions share one compiled plan. Number literals serialize through
    ``repr(float)`` (shortest round-trip form), strings are quoted/escaped,
    lists expand to their parsed elements — whitespace and range-syntax
    differences in the source text cannot split the cache.
    """
    if isinstance(node, AstNum):
        return repr(node.value)
    if isinstance(node, AstStr):
        return '"' + node.value.replace("\\", "\\\\").replace('"', '\\"') + '"'
    if isinstance(node, AstId):
        return node.name
    if isinstance(node, AstNumList):
        return "[" + " ".join(repr(float(v)) for v in node.values) + "]"
    if isinstance(node, AstStrList):
        return "[" + " ".join(
            '"' + s.replace("\\", "\\\\").replace('"', '\\"') + '"'
            for s in node.values
        ) + "]"
    if isinstance(node, AstExec):
        parts = [canonical_sexpr(node.op)] + [canonical_sexpr(a) for a in node.args]
        return "(" + " ".join(parts) + ")"
    if isinstance(node, AstFun):
        return "{" + " ".join(node.params) + " . " + canonical_sexpr(node.body) + "}"
    raise RapidsParseError(f"cannot serialize {node!r}")


def _parse_fun(sc: _Scanner) -> AstFun:
    sc.next()  # {
    params: List[str] = []
    while True:
        sc.skip_ws()
        if sc.peek() == ".":
            sc.next()
            break
        if not sc.peek() or sc.peek() == "}":
            raise RapidsParseError("lambda missing '.' separator")
        tok = sc.token()
        if not tok:
            raise RapidsParseError("bad lambda parameter")
        params.append(tok)
    body = _parse_one(sc)
    sc.skip_ws()
    if sc.next() != "}":
        raise RapidsParseError("unterminated {")
    return AstFun(params, body)
