"""Keyed object catalog — the port of the in-memory part of ``h2o3_tpu/keyed.py``.

The DKV of the reference (``water/DKV.java``) keeps every Frame and Model
under a key. In one process it is a plain keyed store; what it keeps from
the reference is the lifecycle surface that ``models/framework.py`` uses:
``make_key``/``put``/``get``/``remove``, read locks (``water/Lockable.java``:
a frame in use by a running build cannot be removed) and per-thread scopes
(``water/Scope.java``: keys a failed build registered are swept).

Removing a frame's key (``remove``, or a scope drop) also evicts the
device placements linked to it in the device frame cache
(``frame/devcache.py``).

Persistence, the memory budget with its ice spill, ``clear`` and the
cluster router are not part of this package yet.
"""

from __future__ import annotations

import sys
import threading
import uuid
from typing import Any, Dict, List, Optional


def _devcache_invalidate(key: Optional[str]) -> None:
    """Drop device placements linked to a dropped frame key.

    Looked up through sys.modules so the store never imports the cache: if
    the module was never loaded, nothing was ever cached."""
    if not key:
        return
    mod = sys.modules.get("h2o3_tpu_torch.frame.devcache")
    if mod is not None:
        mod.DEVCACHE.invalidate_frame(key)


class KeyedStore:
    """Process-local keyed object store with read locks and scopes."""

    def __init__(self) -> None:
        self._store: Dict[str, Any] = {}
        self._lock = threading.RLock()
        self._read_locks: Dict[str, set] = {}
        self._scopes_tl = threading.local()

    @property
    def _scopes(self) -> List[List[str]]:
        stack = getattr(self._scopes_tl, "stack", None)
        if stack is None:
            stack = self._scopes_tl.stack = []
        return stack

    @staticmethod
    def make_key(prefix: str = "obj") -> str:
        """Fresh unique key (``Key.make()``, water/Key.java:44)."""
        return f"{prefix}_{uuid.uuid4().hex[:12]}"

    def read_lock(self, key: str, owner: str) -> None:
        with self._lock:
            self._read_locks.setdefault(key, set()).add(owner)

    def read_unlock(self, key: str, owner: str) -> None:
        with self._lock:
            owners = self._read_locks.get(key)
            if owners is not None:
                owners.discard(owner)
                if not owners:
                    del self._read_locks[key]

    def _check_unlocked(self, key: str) -> None:
        owners = self._read_locks.get(key)
        if owners:
            raise ValueError(
                f"{key!r} is locked by {sorted(owners)} and cannot be "
                f"removed or replaced (Lockable)"
            )

    def put(self, key: str, value: Any) -> str:
        with self._lock:
            if key in self._read_locks and self._store.get(key) is not value:
                self._check_unlocked(key)
            self._store[key] = value
            if self._scopes:
                self._scopes[-1].append(key)
        return key

    def get(self, key: str, default: Any = None) -> Any:
        with self._lock:
            return self._store.get(key, default)

    def remove(self, key: str) -> None:
        with self._lock:
            self._check_unlocked(key)
            v = self._store.pop(key, None)
        if v is not None:
            _devcache_invalidate(key)

    def rekey(self, obj: Any, new_key: str) -> str:
        """Register ``obj`` (which carries a ``.key``) under ``new_key``.
        The old key is dropped only while it still holds ``obj``, so a
        rename never removes another object that shares the old key; the
        device placements linked to the old key are evicted."""
        with self._lock:
            old = getattr(obj, "key", None)
            if old and self._store.get(old) is obj:
                self._check_unlocked(old)
                self._store.pop(old, None)
            obj.key = new_key
            self._store[new_key] = obj
            if self._scopes:
                self._scopes[-1].append(new_key)
        if old and old != new_key:
            _devcache_invalidate(old)
        return new_key

    def keys(self) -> List[str]:
        with self._lock:
            return list(self._store.keys())

    def scope_enter(self) -> None:
        with self._lock:
            self._scopes.append([])

    def scope_exit(self, keep: Optional[List[str]] = None) -> None:
        keep_set = set(keep or [])
        dropped: List[str] = []
        with self._lock:
            if not self._scopes:
                return
            for k in self._scopes.pop():
                if k in keep_set or self._read_locks.get(k):
                    continue
                if self._store.pop(k, None) is not None:
                    dropped.append(k)
        for k in dropped:
            _devcache_invalidate(k)


#: the process-wide catalog
DKV = KeyedStore()
