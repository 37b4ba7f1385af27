"""Columnar Frame — the port of ``h2o3_tpu/frame/frame.py``.

A ``Frame`` is a named list of ``Column``s. A column's canonical storage is
one dense numpy array on the host (float64 with NaN for NUM/TIME, int32
codes with -1 for CAT, object for STR). The model builders move what they
need to the device themselves, so the frame itself holds no tensors.

Kept from the JAX package: ``Column``, ``Frame``, ``from_dict``, row
selection (``Frame.rows``), ``Frame.drop``, ``Frame.rbind`` (categorical
domains merged in first-seen order, as the JAX package merges them),
``rename``, ``cbind``, ``na_omit``, ``to_numpy``, the conversions
``as_factor`` and ``as_numeric``, the column version stamps the device
frame cache keys on, the type predicates, and the lazily cached rollups
(``frame/rollups.py``, numpy). CSV parsing, the native tokenizer and the
chunk codecs are not part of this package yet.
"""

from __future__ import annotations

import enum
import itertools
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np


class ColType(enum.Enum):
    """Column types (water/fvec/Vec.java type ids)."""

    NUM = "numeric"
    CAT = "categorical"
    TIME = "time"
    STR = "string"
    UUID = "uuid"
    BAD = "bad"  # all-NA column


#: process-wide monotonic column-version source. Every Column state (a
#: fresh construction or an in-place mutation, ``invalidate_rollups``) draws
#: a new number, so a (name, version) pair identifies column data for the
#: life of the process; the device frame cache (``frame/devcache.py``) keys
#: its placements on these stamps.
_COLUMN_VERSIONS = itertools.count(1)


NA_CAT = np.int32(-1)  # categorical NA sentinel (codes); numeric NA is NaN

#: string tokens read as NA when ``from_dict`` builds a categorical column
_NA_STRINGS = frozenset({"", "NA"})


class Column:
    """One named, typed column with host-canonical numpy storage."""

    __slots__ = ("name", "type", "data", "domain", "_rollups", "version")

    def __init__(
        self,
        name: str,
        data: np.ndarray,
        type: Optional[ColType] = None,
        domain: Optional[List[str]] = None,
    ) -> None:
        if type is None:
            arr = np.asarray(data)
            type = ColType.STR if arr.dtype == object or arr.dtype.kind in "US" \
                else ColType.NUM
        self.name = name
        self.type = type
        self.data = _canonicalize(data, type)
        self.domain = list(domain) if domain is not None else None
        self._rollups = None
        self.version = next(_COLUMN_VERSIONS)
        if self.type is ColType.CAT and self.domain is None:
            raise ValueError(f"CAT column {name!r} requires a domain")

    def __len__(self) -> int:
        return int(self.data.shape[0])

    @property
    def nrows(self) -> int:
        return len(self)

    # -- type predicates (Vec.isCategorical/isString) ------------------------
    def is_categorical(self) -> bool:
        return self.type is ColType.CAT

    def is_string(self) -> bool:
        return self.type is ColType.STR

    def isna(self) -> np.ndarray:
        if self.type is ColType.CAT:
            return self.data < 0
        if self.type in (ColType.STR, ColType.UUID):
            return np.array([v is None for v in self.data], dtype=bool)
        return np.isnan(self.data)

    def na_count(self) -> int:
        return int(self.isna().sum())

    def is_numeric(self) -> bool:
        return self.type in (ColType.NUM, ColType.TIME)

    def is_time(self) -> bool:
        return self.type is ColType.TIME

    def cardinality(self) -> int:
        """Domain size for CAT columns, -1 otherwise (Vec.cardinality())."""
        return len(self.domain) if self.domain is not None else -1

    @property
    def rollups(self):
        if self._rollups is None:
            from h2o3_tpu_torch.frame.rollups import compute_rollups

            self._rollups = compute_rollups(self)
        return self._rollups

    def invalidate_rollups(self) -> None:
        """Mutation notification: drops the cached rollups and bumps the
        version stamp, so no device placement keyed on the old state is
        served for the mutated data."""
        self._rollups = None
        self.version = next(_COLUMN_VERSIONS)

    def numeric_view(self) -> np.ndarray:
        """float64 view: CAT codes as floats with NaN NAs."""
        if self.type is ColType.CAT:
            out = self.data.astype(np.float64)
            out[self.data < 0] = np.nan
            return out
        if self.type in (ColType.STR, ColType.UUID):
            raise TypeError(
                f"column {self.name!r} of type {self.type} has no numeric view")
        return self.data

    def as_factor(self) -> "Column":
        """NUM/STR -> CAT with a sorted domain (rapids AstAsFactor)."""
        if self.type is ColType.CAT:
            return self
        if self.type in (ColType.STR, ColType.UUID):
            mask = np.array([v is not None for v in self.data], dtype=bool)
            uniq = sorted({str(v) for v in self.data[mask]})
            index = {lv: i for i, lv in enumerate(uniq)}
            codes = np.full(len(self.data), NA_CAT, dtype=np.int32)
            codes[mask] = [index[str(v)] for v in self.data[mask]]
            return Column(self.name, codes, ColType.CAT, uniq)
        vals = self.data
        mask = ~np.isnan(vals)
        uniq = np.unique(vals[mask])
        domain = [_format_level(v) for v in uniq]
        codes = np.full(len(vals), NA_CAT, dtype=np.int32)
        codes[mask] = np.searchsorted(uniq, vals[mask]).astype(np.int32)
        return Column(self.name, codes, ColType.CAT, domain)

    def as_numeric(self) -> "Column":
        """CAT -> NUM (rapids AstAsNumeric): parse levels, else codes."""
        if self.type is not ColType.CAT:
            return Column(self.name, self.numeric_view(), ColType.NUM)
        try:
            lv = np.array([float(d) for d in self.domain], dtype=np.float64)
            out = np.where(self.data >= 0, lv[np.clip(self.data, 0, None)], np.nan)
        except ValueError:
            out = np.where(self.data >= 0, self.data.astype(np.float64), np.nan)
        return Column(self.name, out, ColType.NUM)

    def copy(self) -> "Column":
        return Column(self.name, self.data.copy(), self.type, self.domain)

    def select(self, idx: np.ndarray) -> "Column":
        return Column(self.name, self.data[idx], self.type, self.domain)

    def __repr__(self) -> str:
        dom = f", card={len(self.domain)}" if self.domain is not None else ""
        return f"<Column {self.name!r} {self.type.value} n={len(self)}{dom}>"


def _canonicalize(data: Any, type: ColType) -> np.ndarray:
    data = np.asarray(data)
    if type in (ColType.NUM, ColType.TIME, ColType.BAD):
        return np.ascontiguousarray(data, dtype=np.float64)
    if type is ColType.CAT:
        return np.ascontiguousarray(data, dtype=np.int32)
    if type in (ColType.STR, ColType.UUID):
        return data if data.dtype == object else data.astype(object)
    raise ValueError(f"unknown column type {type}")


def _format_level(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else repr(float(v))


def _is_number(t: str) -> bool:
    try:
        float(t)
    except ValueError:
        return False
    return True


def _column_from_strings(name: str, tokens: Sequence[Optional[str]]) -> Column:
    """String tokens -> NUM when every non-NA token parses as a number,
    else CAT with a lexicographically sorted domain (the parser's type
    guess for the cases a tree frame holds)."""
    toks = [None if t is None or t in _NA_STRINGS else str(t) for t in tokens]
    vals = [t for t in toks if t is not None]
    if not vals:
        return Column(name, np.full(len(toks), np.nan), ColType.BAD)
    if all(_is_number(t) for t in vals):
        return Column(name, np.array(
            [np.nan if t is None else float(t) for t in toks]), ColType.NUM)
    return Column(name, np.array(toks, dtype=object), ColType.STR).as_factor()


class Frame:
    """A named collection of equal-length Columns (water/fvec/Frame.java)."""

    def __init__(self, columns: Sequence[Column], key: Optional[str] = None) -> None:
        cols = list(columns)
        if cols:
            n = len(cols[0])
            for c in cols:
                if len(c) != n:
                    raise ValueError(
                        f"column {c.name!r} has {len(c)} rows, expected {n}")
        names = [c.name for c in cols]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate column names: {names}")
        self._cols: List[Column] = cols
        self.key = key

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Frame":
        cols = []
        for name, vals in d.items():
            if isinstance(vals, Column):
                c = vals.copy()
                c.name = name
                cols.append(c)
                continue
            arr = np.asarray(vals)
            if arr.dtype == object or arr.dtype.kind in "US":
                cols.append(_column_from_strings(name, list(arr)))
            else:
                cols.append(Column(name, arr.astype(np.float64), ColType.NUM))
        return Frame(cols)

    @property
    def nrows(self) -> int:
        return len(self._cols[0]) if self._cols else 0

    @property
    def ncols(self) -> int:
        return len(self._cols)

    @property
    def names(self) -> List[str]:
        return [c.name for c in self._cols]

    @property
    def columns(self) -> List[Column]:
        return list(self._cols)

    def col_types(self) -> List[ColType]:
        """Column types in column order (the Rapids type predicates)."""
        return [c.type for c in self._cols]

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.nrows, self.ncols)

    @property
    def version(self) -> Tuple[int, ...]:
        """Per-column version stamps. Two frames with equal (names, version)
        tuples hold identical data; a mutating path makes a fresh Column
        (new stamp) or bumps in place with ``invalidate_rollups``."""
        return tuple(c.version for c in self._cols)

    def col(self, name_or_idx: Union[str, int]) -> Column:
        if isinstance(name_or_idx, int):
            return self._cols[name_or_idx]
        for c in self._cols:
            if c.name == name_or_idx:
                return c
        raise KeyError(f"no column {name_or_idx!r} in {self.names}")

    def cols(self, sel: Any) -> "Frame":
        """The named (or indexed) columns, in the order given, as a new
        Frame sharing the Columns (Assembly's ``ColSelect``)."""
        if sel is None or (isinstance(sel, slice) and sel == slice(None)):
            return self
        if isinstance(sel, (str, int)):
            sel = [sel]
        return Frame([self.col(s) for s in sel])

    def add_column(self, col: Column) -> "Frame":
        """A new Frame with ``col`` in place of the column of its name, or
        appended (the GLM's response conversion)."""
        if col.name in self.names:
            cols = [col if c.name == col.name else c for c in self._cols]
        else:
            cols = self._cols + [col]
        return Frame(cols)

    def rows(self, sel: Any) -> "Frame":
        """The rows a slice, a boolean mask or an index array selects, as a
        new Frame of new Columns (new version stamps)."""
        if isinstance(sel, slice) or (
            isinstance(sel, np.ndarray) and sel.dtype in (bool, np.bool_)
        ):
            idx = np.arange(self.nrows)[sel]
        else:
            idx = np.asarray(sel, dtype=np.int64)
        return Frame([c.select(idx) for c in self._cols])

    def drop(self, names: Union[str, Iterable[str]]) -> "Frame":
        """A new Frame without the named columns (the target encoder's
        ``keep_original_categorical_columns=False``)."""
        if isinstance(names, str):
            names = [names]
        names = set(names)
        return Frame([c for c in self._cols if c.name not in names])

    def rename(self, mapping: Dict[str, str]) -> "Frame":
        cols = []
        for c in self._cols:
            c2 = c.copy()
            c2.name = mapping.get(c.name, c.name)
            cols.append(c2)
        return Frame(cols)

    def cbind(self, other: "Frame") -> "Frame":
        """``self``'s columns then copies of ``other``'s, a clashing name
        suffixed with the first free counter."""
        cols = list(self._cols)
        taken = set(self.names)
        for c in other._cols:
            name, i = c.name, 0
            while name in taken:
                name = f"{c.name}{i}"
                i += 1
            c2 = c.copy()
            c2.name = name
            taken.add(name)
            cols.append(c2)
        return Frame(cols)

    def na_omit(self) -> "Frame":
        mask = np.zeros(self.nrows, dtype=bool)
        for c in self._cols:
            mask |= c.isna()
        return self.rows(~mask)

    def to_numpy(self, columns: Optional[Sequence[str]] = None) -> np.ndarray:
        """[N, C] float64 of the columns' numeric views."""
        names = list(columns) if columns is not None else self.names
        return np.stack([self.col(n).numeric_view() for n in names], axis=1)

    def rbind(self, other: "Frame") -> "Frame":
        """The rows of ``self`` then ``other``, as new Columns. A column that
        is categorical in either frame becomes categorical in both, and the
        two domains merge: ``self``'s levels keep their codes, ``other``'s
        new levels follow in their order."""
        if self.names != other.names:
            raise ValueError("rbind requires identical column names")
        out = []
        for a, b in zip(self._cols, other._cols):
            if a.type is ColType.CAT or b.type is ColType.CAT:
                a, b = _unify_cat(a), _unify_cat(b)
                domain, bmap = _merge_domains(a.domain, b.domain)
                bd = np.where(b.data >= 0, bmap[np.clip(b.data, 0, None)], NA_CAT)
                out.append(Column(a.name, np.concatenate([a.data, bd.astype(np.int32)]),
                                  ColType.CAT, domain))
            else:
                out.append(Column(a.name, np.concatenate([a.data, b.data]), a.type))
        return Frame(out)

    def __repr__(self) -> str:
        more = "..." if self.ncols > 8 else ""
        return f"<Frame {self.nrows}x{self.ncols} {self.names[:8]}{more}>"


def _unify_cat(c: Column) -> Column:
    return c if c.type is ColType.CAT else c.as_factor()


def _merge_domains(a: List[str], b: List[str]) -> Tuple[List[str], np.ndarray]:
    """The merged domain (``a``'s levels, then ``b``'s new ones) and the map
    from ``b``'s codes to merged codes."""
    index = {lv: i for i, lv in enumerate(a)}
    merged = list(a)
    bmap = np.empty(len(b), dtype=np.int32)
    for j, lv in enumerate(b):
        if lv not in index:
            index[lv] = len(merged)
            merged.append(lv)
        bmap[j] = index[lv]
    return merged, bmap
