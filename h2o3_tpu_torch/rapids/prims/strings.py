"""Rapids string prims (17) — the port of ``h2o3_tpu/rapids/prims/strings.py``
(copied, host Python ``re`` and numpy).

Reference: ``water/rapids/ast/prims/string/`` — CountMatches
CountSubstringsWords Entropy Grep LStrip RStrip ReplaceAll ReplaceFirst
StrDistance StrLength StrSplit Substring ToLower ToUpper Tokenize Trim.
String columns stay host-side (device holds dictionary codes only — mirrors
the reference's CStrChunk + domain design, SURVEY.md §7 hard part (c)).
"""

from __future__ import annotations

import math
import re
from collections import Counter
from typing import Callable, List, Optional

import numpy as np

from h2o3_tpu_torch.frame.frame import Column, ColType, Frame, NA_CAT
from h2o3_tpu_torch.rapids.prims import prim
from h2o3_tpu_torch.rapids.runtime import RapidsError, Val


def _str_values(c: Column) -> List[Optional[str]]:
    if c.type is ColType.CAT:
        return [c.domain[i] if i >= 0 else None for i in c.data]
    if c.type in (ColType.STR, ColType.UUID):
        return list(c.data)
    raise RapidsError(f"column {c.name!r} is not a string/categorical column")


def _map_str(fr: Frame, fn: Callable[[str], Optional[str]]) -> Frame:
    """Apply a str->str fn to every string/cat column. CAT columns map their
    domains (the reference mutates domains, not rows — cheap and exact)."""
    cols = []
    for c in fr.columns:
        if c.type is ColType.CAT:
            new_dom = [fn(d) for d in c.domain]
            # domains must stay unique; re-code if the map collapses levels
            if len(set(new_dom)) == len(new_dom):
                cols.append(Column(c.name, c.data.copy(), ColType.CAT, new_dom))
            else:
                uniq = sorted(set(new_dom))
                remap = np.array([uniq.index(d) for d in new_dom], dtype=np.int32)
                codes = np.where(c.data >= 0, remap[np.clip(c.data, 0, None)], NA_CAT).astype(np.int32)
                cols.append(Column(c.name, codes, ColType.CAT, uniq))
        elif c.type in (ColType.STR, ColType.UUID):
            data = np.array([None if v is None else fn(v) for v in c.data], dtype=object)
            cols.append(Column(c.name, data, ColType.STR))
        else:
            cols.append(c.copy())
    return Frame(cols)


def _map_str_num(fr: Frame, fn: Callable[[Optional[str]], float]) -> Frame:
    cols = []
    for c in fr.columns:
        vals = _str_values(c)
        cols.append(Column(c.name, np.array([fn(v) for v in vals], dtype=np.float64), ColType.NUM))
    return Frame(cols)


@prim("tolower")
def tolower(env, args):
    return Val.frame(_map_str(args[0].as_frame(), str.lower))


@prim("toupper")
def toupper(env, args):
    return Val.frame(_map_str(args[0].as_frame(), str.upper))


@prim("trim")
def trim(env, args):
    return Val.frame(_map_str(args[0].as_frame(), str.strip))


@prim("lstrip")
def lstrip(env, args):
    chars = args[1].as_str() if len(args) > 1 else None
    return Val.frame(_map_str(args[0].as_frame(), lambda s: s.lstrip(chars)))


@prim("rstrip")
def rstrip(env, args):
    chars = args[1].as_str() if len(args) > 1 else None
    return Val.frame(_map_str(args[0].as_frame(), lambda s: s.rstrip(chars)))


@prim("replaceall")
def replaceall(env, args):
    pattern, replacement = args[1].as_str(), args[2].as_str()
    ignore_case = bool(args[3].as_num()) if len(args) > 3 else False
    rx = re.compile(pattern, re.IGNORECASE if ignore_case else 0)
    return Val.frame(_map_str(args[0].as_frame(), lambda s: rx.sub(replacement, s)))


@prim("replacefirst")
def replacefirst(env, args):
    pattern, replacement = args[1].as_str(), args[2].as_str()
    ignore_case = bool(args[3].as_num()) if len(args) > 3 else False
    rx = re.compile(pattern, re.IGNORECASE if ignore_case else 0)
    return Val.frame(_map_str(args[0].as_frame(), lambda s: rx.sub(replacement, s, count=1)))


@prim("strsplit")
def strsplit(env, args):
    """(strsplit fr pattern) -> multi-column frame of split parts."""
    fr = args[0].as_frame()
    pattern = args[1].as_str()
    rx = re.compile(pattern)
    out_cols = []
    for c in fr.columns:
        vals = _str_values(c)
        parts = [rx.split(v) if v is not None else [] for v in vals]
        width = max((len(p) for p in parts), default=0)
        for j in range(width):
            data = np.array([p[j] if j < len(p) else None for p in parts], dtype=object)
            out_cols.append(Column(f"{c.name}{j+1}", data, ColType.STR))
    return Val.frame(Frame(out_cols))


@prim("substring")
def substring(env, args):
    fr = args[0].as_frame()
    # AstSubstring clamps indices into [0, len] — raw python slicing would
    # give negative-start from-the-end semantics instead
    start = max(int(args[1].as_num()), 0)
    end = int(args[2].as_num()) if len(args) > 2 and not math.isnan(args[2].as_num()) else None
    if end is not None:
        end = max(end, start)
    return Val.frame(_map_str(fr, lambda s: s[start:end]))


@prim("length", "strlen")
def strlen(env, args):
    return Val.frame(_map_str_num(args[0].as_frame(), lambda v: float(len(v)) if v is not None else float("nan")))


@prim("entropy")
def entropy(env, args):
    """Shannon entropy of the character distribution (AstEntropy)."""

    def ent(v):
        if v is None or not v:
            return float("nan") if v is None else 0.0
        counts = Counter(v)
        n = len(v)
        return -sum((c / n) * math.log2(c / n) for c in counts.values())

    return Val.frame(_map_str_num(args[0].as_frame(), ent))


@prim("countmatches")
def countmatches(env, args):
    pats = args[1].as_strs()
    return Val.frame(
        _map_str_num(
            args[0].as_frame(),
            lambda v: float("nan") if v is None else float(sum(v.count(p) for p in pats)),
        )
    )


@prim("num_valid_substrings")
def count_substrings_words(env, args):
    """(num_valid_substrings fr words_path) — count substrings that are valid
    words (AstCountSubstringsWords; the reference reads a words file)."""
    fr = args[0].as_frame()
    path = args[1].as_str()
    with open(path) as f:
        words = {w.strip() for w in f if w.strip()}

    def count(v):
        if v is None:
            return float("nan")
        n = 0
        for i in range(len(v)):
            for j in range(i + 2, len(v) + 1):  # reference: substrings len>=2
                if v[i:j] in words:
                    n += 1
        return float(n)

    return Val.frame(_map_str_num(fr, count))


@prim("grep")
def grep(env, args):
    """(grep fr regex ignore_case invert output_logical) (AstGrep)."""
    fr = args[0].as_frame()
    rx = re.compile(args[1].as_str(), re.IGNORECASE if len(args) > 2 and args[2].as_num() else 0)
    invert = bool(args[3].as_num()) if len(args) > 3 else False
    output_logical = bool(args[4].as_num()) if len(args) > 4 else False
    vals = _str_values(fr.col(0))
    hit = np.array([bool(rx.search(v)) if v is not None else False for v in vals])
    if invert:
        hit = ~hit
    if output_logical:
        return Val.frame(Frame([Column("grep", hit.astype(np.float64), ColType.NUM)]))
    return Val.frame(
        Frame([Column("grep", np.nonzero(hit)[0].astype(np.float64), ColType.NUM)])
    )


def _levenshtein(a: str, b: str) -> float:
    if a == b:
        return 0.0
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return float(prev[-1])


def _jaccard(a: str, b: str) -> float:
    sa, sb = set(a), set(b)
    return len(sa & sb) / len(sa | sb) if sa | sb else 1.0


def _jaro(a: str, b: str) -> float:
    if a == b:
        return 1.0
    la, lb = len(a), len(b)
    if not la or not lb:
        return 0.0
    window = max(la, lb) // 2 - 1
    ma = [False] * la
    mb = [False] * lb
    matches = 0
    for i in range(la):
        lo, hi = max(0, i - window), min(lb, i + window + 1)
        for j in range(lo, hi):
            if not mb[j] and a[i] == b[j]:
                ma[i] = mb[j] = True
                matches += 1
                break
    if not matches:
        return 0.0
    t = 0.0
    k = 0
    for i in range(la):
        if ma[i]:
            while not mb[k]:
                k += 1
            if a[i] != b[k]:
                t += 0.5
            k += 1
    return (matches / la + matches / lb + (matches - t) / matches) / 3.0


def _jaro_winkler(a: str, b: str) -> float:
    j = _jaro(a, b)
    prefix = 0
    for ca, cb in zip(a, b):
        if ca != cb or prefix == 4:
            break
        prefix += 1
    return j + prefix * 0.1 * (1 - j)


_STR_MEASURES = {
    "lv": _levenshtein,
    "levenshtein": _levenshtein,
    "jaccard": _jaccard,
    "jw": _jaro_winkler,
    "jaro_winkler": _jaro_winkler,
}


@prim("strDistance")
def str_distance(env, args):
    """(strDistance fr1 fr2 measure compare_empty) (AstStrDistance)."""
    f1, f2 = args[0].as_frame(), args[1].as_frame()
    measure = args[2].as_str().lower()
    compare_empty = bool(args[3].as_num()) if len(args) > 3 else True
    fn = _STR_MEASURES.get(measure)
    if fn is None:
        raise RapidsError(f"strDistance: unknown measure {measure!r}")
    v1, v2 = _str_values(f1.col(0)), _str_values(f2.col(0))
    out = np.empty(len(v1))
    for i, (a, b) in enumerate(zip(v1, v2)):
        if a is None or b is None or (not compare_empty and (a == "" or b == "")):
            out[i] = np.nan
        else:
            out[i] = fn(a, b)
    return Val.frame(Frame([Column("distance", out, ColType.NUM)]))


@prim("tokenize")
def tokenize(env, args):
    """(tokenize fr regex) -> single string column of tokens with NA row
    separating each input row (AstTokenize output contract)."""
    fr = args[0].as_frame()
    rx = re.compile(args[1].as_str())
    col_vals = [_str_values(c) for c in fr.columns]
    out: List[Optional[str]] = []
    for i in range(fr.nrows):
        for vals in col_vals:
            v = vals[i]
            if v is None:
                continue
            out.extend(t for t in rx.split(v) if t)
        out.append(None)
    return Val.frame(Frame([Column("token", np.array(out, dtype=object), ColType.STR)]))
