"""Device frame cache — the port of ``h2o3_tpu/frame/devcache.py``.

A frame placed on the device once serves every later fit on the same
unmutated data: the tree booster's bin codes (``kind="tree_bins"``) are
made and placed once per (data state, binning, device), and a repeat GBM,
XGBoost or DRF fit on the frame reuses the resident tensors.

Keying: every :class:`~h2o3_tpu_torch.frame.frame.Column` carries a
process-wide monotonic ``version`` stamp, bumped whenever its data changes
(``invalidate_rollups``), so a key built from ``(name, version)`` pairs
(:func:`frame_token`) identifies column data, and a mutation makes the old
key unreachable. The device is part of every key
(:func:`device_fingerprint`): a placement on the CPU is never served to the
card, or the reverse. Explicit lifecycle eviction rides on the keyed store:
``KeyedStore.remove`` and the drops of ``scope_exit`` call
:meth:`DeviceFrameCache.invalidate_frame` for the frame's key.

Memory: entries are LRU in a byte budget (``max_bytes``, 1 GiB by
default, as the JAX package's), so the least recently used placements go
first. The cache counts its own hits, misses, evictions and bytes saved
per placement kind (:meth:`DeviceFrameCache.stats`).

:func:`region_token` combines the tokens of several ``(frame, columns)``
inputs for the Rapids fusion pass. Not part of this package yet:
``cached_host`` (chunk-homed training, ROADMAP A10) and the telemetry
counters, ledger charges and flight records (A11).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

__all__ = [
    "DEVCACHE",
    "DeviceFrameCache",
    "cache_key",
    "cached",
    "device_fingerprint",
    "device_nbytes",
    "frame_token",
    "region_token",
]

_DEFAULT_BUDGET = 1 << 30  # 1 GiB of device-resident placements


def device_fingerprint(device) -> Tuple:
    """Hashable identity of a placement's device: its type and index (an
    unindexed ``cuda`` is the current card)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        return ("cuda", index)
    return (dev.type, dev.index)


def frame_token(frame, columns: Optional[Sequence[str]] = None) -> Optional[Tuple]:
    """Data-identity token of (a column subset of) a frame.

    Built from per-column ``(name, version)`` stamps plus the row count;
    versions are unique per column state, so equal tokens imply identical
    host data. Returns None for objects without version stamps — callers
    then skip the cache."""
    if frame is None:
        return None
    try:
        cols = (
            [frame.col(c) for c in columns]
            if columns is not None
            else list(frame.columns)
        )
        token = tuple((c.name, c.version) for c in cols)
        nrows = frame.nrows
    except (AttributeError, KeyError, TypeError):
        return None
    return ("frame", nrows, token)


def region_token(inputs: Sequence[Tuple[Any, Sequence[str]]]) -> Optional[Tuple]:
    """Combined data-identity token over several ``(frame, columns)`` inputs.

    The fusion plan-cache entry point: a fused region reads column subsets
    of one or more frames, and this token (a tuple of per-input
    :func:`frame_token` stamps) identifies the exact device-input state of
    one dispatch, so per-dispatch input validation can be memoized on it.
    None if any input lacks version stamps (callers then re-validate)."""
    parts = []
    for frame, columns in inputs:
        tok = frame_token(frame, list(columns))
        if tok is None:
            return None
        parts.append(tok)
    return ("region", tuple(parts))


def device_nbytes(value: Any) -> int:
    """Bytes of every tensor reachable from ``value`` (dict/list/tuple
    nesting, and objects that hold their tensors in an ``arrays`` dict
    beside an optional ``mask``, as a ``FrameTable`` does)."""
    total = 0
    stack = [value]
    while stack:
        v = stack.pop()
        if v is None:
            continue
        if hasattr(v, "nbytes") and hasattr(v, "dtype") and hasattr(v, "shape"):
            total += int(v.nbytes)
        elif isinstance(v, dict):
            stack.extend(v.values())
        elif isinstance(v, (list, tuple)):
            stack.extend(v)
        elif isinstance(getattr(v, "arrays", None), dict):
            stack.extend(v.arrays.values())
            stack.append(getattr(v, "mask", None))
    return total


class _Entry:
    __slots__ = ("value", "nbytes", "kind", "frame_keys")

    def __init__(self, value: Any, nbytes: int, kind: str) -> None:
        self.value = value
        self.nbytes = nbytes
        self.kind = kind
        self.frame_keys: set = set()


class DeviceFrameCache:
    """LRU cache of device placements, byte-budgeted.

    ``get_or_put(key, build)`` is the single entry point: the builder runs
    only on a miss, outside the lock (a large upload must not block
    concurrent lookups); a lost insert race keeps the first entry. Passing
    ``frame_key`` links the entry to a keyed-store frame so that
    ``DKV.remove`` and scope drops can evict it explicitly."""

    def __init__(self, max_bytes: int = _DEFAULT_BUDGET) -> None:
        self._lock = threading.RLock()
        self._entries: "OrderedDict[Tuple, _Entry]" = OrderedDict()
        self._by_frame_key: Dict[str, set] = {}
        self._bytes = 0
        self._max_bytes = int(max_bytes)
        #: kind -> {"hits", "misses", "evictions", "bytes_saved"}
        self._counts: Dict[str, Dict[str, int]] = {}

    # -- sizing --------------------------------------------------------------
    def set_max_bytes(self, max_bytes: int) -> None:
        with self._lock:
            self._max_bytes = int(max_bytes)
            self._shrink()

    def stats(self) -> Dict[str, Any]:
        """Entries, resident bytes, the budget, and per placement kind the
        hits, misses, evictions and bytes saved since the cache was made."""
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "max_bytes": self._max_bytes,
                "kinds": {k: dict(v) for k, v in self._counts.items()},
            }

    def kind_bytes(self) -> Dict[str, int]:
        """Resident bytes by placement kind."""
        with self._lock:
            out: Dict[str, int] = {}
            for entry in self._entries.values():
                out[entry.kind] = out.get(entry.kind, 0) + entry.nbytes
            return out

    def _count(self, kind: str, what: str, n: int = 1) -> None:
        # caller holds the lock
        c = self._counts.setdefault(
            kind, {"hits": 0, "misses": 0, "evictions": 0, "bytes_saved": 0})
        c[what] += n

    # -- the cache protocol --------------------------------------------------
    def get_or_put(
        self,
        key: Tuple,
        build: Callable[[], Any],
        frame_key: Optional[str] = None,
        kind: str = "table",
    ) -> Any:
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self._link(entry, key, frame_key)
                self._count(kind, "hits")
                self._count(kind, "bytes_saved", entry.nbytes)
                return entry.value
            self._count(kind, "misses")
        value = build()  # the upload happens without the lock
        nbytes = device_nbytes(value)
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:  # lost a concurrent build race: keep first
                self._entries.move_to_end(key)
                self._link(entry, key, frame_key)  # our lifecycle link still applies
                return entry.value
            entry = _Entry(value, nbytes, kind)
            self._entries[key] = entry
            self._bytes += nbytes
            self._link(entry, key, frame_key)
            self._shrink()
        return value

    def _link(self, entry: _Entry, key: Tuple, frame_key: Optional[str]) -> None:
        if frame_key:
            entry.frame_keys.add(frame_key)
            self._by_frame_key.setdefault(frame_key, set()).add(key)

    def grow_entry(self, key: Tuple, nbytes: int) -> None:
        """Attribute extra device bytes to a resident entry — a tensor made
        later and kept on the entry's value — so the byte budget sees the
        entry's true footprint. No-op once evicted."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return
            entry.nbytes += int(nbytes)
            self._bytes += int(nbytes)
            self._shrink()

    # -- eviction ------------------------------------------------------------
    def _drop(self, key: Tuple) -> None:
        # caller holds the lock
        entry = self._entries.pop(key, None)
        if entry is None:
            return
        self._bytes -= entry.nbytes
        for fk in entry.frame_keys:
            keys = self._by_frame_key.get(fk)
            if keys is not None:
                keys.discard(key)
                if not keys:
                    del self._by_frame_key[fk]
        self._count(entry.kind, "evictions")

    def _shrink(self) -> None:
        # caller holds the lock; never evict the most recent entry — a
        # single over-budget placement must still be usable while resident
        while self._bytes > self._max_bytes and len(self._entries) > 1:
            self._drop(next(iter(self._entries)))

    def invalidate_frame(self, frame_key: str) -> int:
        """Drop every placement linked to a keyed-store frame (``DKV.remove``,
        a scope drop). Returns the entries dropped."""
        with self._lock:
            keys = list(self._by_frame_key.get(frame_key, ()))
            for k in keys:
                self._drop(k)
            return len(keys)

    def clear(self) -> None:
        with self._lock:
            for k in list(self._entries):
                self._drop(k)
            self._by_frame_key.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


#: The process-wide device frame cache (one per process, like the DKV).
DEVCACHE = DeviceFrameCache()


def cache_key(kind: str, token: Tuple, extra_key, device) -> Tuple:
    """The key :func:`cached` files a placement under."""
    return (kind, token, extra_key, device_fingerprint(device))


def cached(
    kind: str,
    token: Optional[Tuple],
    extra_key,
    device,
    build: Callable[[], Any],
    frame_key: Optional[str] = None,
) -> Any:
    """The one-call memoized-placement pattern every upload site uses:
    bypass (plain build, no counts) when the frame yielded no token, else
    serve from / insert into :data:`DEVCACHE` under ``cache_key(kind,
    token, extra_key, device)``."""
    if token is None:
        return build()
    return DEVCACHE.get_or_put(
        cache_key(kind, token, extra_key, device), build,
        frame_key=frame_key, kind=kind,
    )
