"""Binary model save/load — the port of ``h2o3_tpu/models/persist.py``.

Reference: ``hex/Model.java`` ``exportBinaryModel`` / ``importBinaryModel``
on the Iced auto-serialization (``water/Iced.java``). Here, as in the JAX
package, a typed, allowlisted object-tree format with no pickle: structure
goes to JSON, numeric payloads to one npz, and only classes of this package
(``h2o3_tpu_torch.``) are instantiated at load time, through ``__new__`` and
field assignment, so loading never runs code from the file. The JAX
package's archives name classes of ``h2o3_tpu.``, outside this allowlist,
and are refused; the JAX package refuses this package's archives the same
way.

The device is not part of a model: the archive records where a model held
a ``torch.device`` but not which, and ``load_model``/``loads_model`` put
the model (and its booster) on the device they are given, resolved as
every entry point resolves it (``device.resolve_device``: without a card
and without ``device="cpu"`` loading raises). A ``torch.Tensor`` never
rides into an archive. Every zip entry, the npz's members too, carries a
fixed timestamp, so one model always dumps to the same bytes.
"""

from __future__ import annotations

import importlib
import io
import json
import math
import os
import zipfile
from enum import Enum
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from h2o3_tpu_torch.device import DeviceLike, resolve_device

FORMAT_VERSION = 1

#: only classes inside these packages may be instantiated at load time
_ALLOWED_PREFIXES = ("h2o3_tpu_torch.",)

_FIXED_DATE = (1980, 1, 1, 0, 0, 0)


def _allowed(mod: str) -> bool:
    return any(mod.startswith(p) or mod == p.rstrip(".") for p in _ALLOWED_PREFIXES)


# ---------------------------------------------------------------------------
# encode


class _Encoder:
    def __init__(self) -> None:
        self.arrays: Dict[str, np.ndarray] = {}
        self.memo: Dict[int, int] = {}  # id(obj) -> object table index
        self.next_ref = 0

    def enc(self, o: Any) -> Any:
        if o is None or isinstance(o, (bool, str)):
            return o
        if isinstance(o, (int, np.integer)):
            return int(o)
        if isinstance(o, (float, np.floating)):
            f = float(o)
            if math.isfinite(f):
                return f
            return {"__k": "f", "v": repr(f)}
        if isinstance(o, np.ndarray):
            aid = f"a{len(self.arrays)}"
            self.arrays[aid] = o
            return {"__k": "nd", "id": aid}
        if isinstance(o, torch.device):
            return {"__k": "device"}  # set at load time, never recorded
        if isinstance(o, torch.Tensor):
            raise TypeError(f"cannot serialize {type(o)!r}")
        if isinstance(o, (list, tuple)):
            return {
                "__k": "list" if isinstance(o, list) else "tuple",
                "items": [self.enc(x) for x in o],
            }
        if isinstance(o, dict):
            return {
                "__k": "dict",
                "items": [[self.enc(k), self.enc(v)] for k, v in o.items()],
            }
        if isinstance(o, Enum):
            return {
                "__k": "enum",
                "cls": f"{type(o).__module__}:{type(o).__qualname__}",
                "name": o.name,
            }
        if hasattr(o, "__dict__") or hasattr(o, "__slots__"):
            oid = id(o)
            if oid in self.memo:
                return {"__k": "ref", "ref": self.memo[oid]}
            self.memo[oid] = ref = self.next_ref
            self.next_ref += 1
            cls = type(o)
            mod = cls.__module__
            if not _allowed(mod):
                raise TypeError(
                    f"cannot serialize {cls.__module__}.{cls.__qualname__}: "
                    "outside the h2o3_tpu_torch allowlist"
                )
            if hasattr(o, "__dict__"):
                fields = dict(vars(o))
            else:
                fields = {s: getattr(o, s) for s in cls.__slots__ if hasattr(o, s)}
            # bound callables (monitors, caches) cannot ride a checkpoint
            clean = {k: v for k, v in fields.items()
                     if not (callable(v) and not isinstance(v, type))}
            return {
                "__k": "obj",
                "id": ref,
                "cls": f"{mod}:{cls.__qualname__}",
                "fields": {k: self.enc(v) for k, v in clean.items()},
            }
        raise TypeError(f"cannot serialize {type(o)!r}")


# ---------------------------------------------------------------------------
# decode


class _Decoder:
    def __init__(self, arrays, device: torch.device) -> None:
        self.arrays = arrays
        self.device = device
        self.table: Dict[int, Any] = {}

    @staticmethod
    def _resolve(spec: str) -> type:
        mod, _, qual = spec.partition(":")
        if not _allowed(mod):
            raise ValueError(f"class {spec!r} outside the h2o3_tpu_torch allowlist")
        m = importlib.import_module(mod)
        o: Any = m
        for part in qual.split("."):
            o = getattr(o, part)
        if not isinstance(o, type):
            raise ValueError(f"{spec!r} is not a class")
        return o

    def dec(self, e: Any) -> Any:
        if e is None or isinstance(e, (bool, int, float, str)):
            return e
        k = e["__k"]
        if k == "f":
            return float(e["v"])
        if k == "nd":
            return np.asarray(self.arrays[e["id"]])
        if k == "device":
            return self.device
        if k == "list":
            return [self.dec(x) for x in e["items"]]
        if k == "tuple":
            return tuple(self.dec(x) for x in e["items"])
        if k == "dict":
            return {self.dec(kk): self.dec(v) for kk, v in e["items"]}
        if k == "enum":
            return getattr(self._resolve(e["cls"]), e["name"])
        if k == "ref":
            return self.table[e["ref"]]
        if k == "obj":
            cls = self._resolve(e["cls"])
            obj = cls.__new__(cls)
            self.table[e["id"]] = obj
            for name, fe in e["fields"].items():
                object.__setattr__(obj, name, self.dec(fe))
            return obj
        raise ValueError(f"unknown node kind {k!r}")


# ---------------------------------------------------------------------------
# public API


def _zip_entry(z: zipfile.ZipFile, name: str, data) -> None:
    info = zipfile.ZipInfo(name, date_time=_FIXED_DATE)
    info.compress_type = zipfile.ZIP_DEFLATED
    info.external_attr = 0o600 << 16
    z.writestr(info, data)


def _npz_bytes(arrays: Dict[str, np.ndarray]) -> bytes:
    """``np.savez_compressed``'s layout (one ``.npy`` member per array, no
    pickle) with fixed member timestamps: numpy stamps each member with
    the current time, which would change the bytes from second to second."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        for name, arr in arrays.items():
            member = io.BytesIO()
            np.lib.format.write_array(member, np.asanyarray(arr), allow_pickle=False)
            _zip_entry(z, f"{name}.npy", member.getvalue())
    return buf.getvalue()


def _write_archive(dest, model) -> None:
    """Write the zip(JSON tree + npz) container to a path or file object."""
    enc = _Encoder()
    tree = enc.enc(model)
    meta = {
        "version": FORMAT_VERSION,
        "algo": getattr(model, "algo_name", type(model).__name__),
        "class": f"{type(model).__module__}:{type(model).__qualname__}",
    }
    with zipfile.ZipFile(dest, "w", zipfile.ZIP_DEFLATED) as z:
        for name, data in (("meta.json", json.dumps(meta)),
                           ("model.json", json.dumps(tree)),
                           ("arrays.npz", _npz_bytes(enc.arrays))):
            _zip_entry(z, name, data)


def _read_archive(src, device: torch.device):
    """Decode a container written by :func:`_write_archive` onto ``device``."""
    with zipfile.ZipFile(src, "r") as z:
        meta = json.loads(z.read("meta.json"))
        if meta.get("version", 0) > FORMAT_VERSION:
            raise ValueError(f"model file version {meta['version']} too new")
        tree = json.loads(z.read("model.json"))
        arrays = np.load(io.BytesIO(z.read("arrays.npz")), allow_pickle=False)
        return _Decoder(arrays, device).dec(tree)


def _register(model, key: Optional[str]):
    from h2o3_tpu_torch.keyed import DKV

    if key:
        model.key = key
        DKV.put(key, model)
    elif getattr(model, "key", None):
        DKV.put(model.key, model)
    return model


def save_model(model, path: Union[str, os.PathLike]) -> str:
    """Serialize a trained model to ``path``. Returns the path."""
    path = os.fspath(path)
    _write_archive(path, model)
    return path


def dumps_model(model) -> bytes:
    """The :func:`save_model` container as bytes."""
    buf = io.BytesIO()
    _write_archive(buf, model)
    return buf.getvalue()


def loads_model(data: bytes, key: Optional[str] = None, register: bool = False,
                device: DeviceLike = None):
    """Decode a :func:`dumps_model` blob onto ``device``. ``register=False``
    by default: a receiver must check keys minted in another process before
    the model joins the DKV."""
    model = _read_archive(io.BytesIO(data), resolve_device(device))
    return _register(model, key) if register else model


def load_model(path: Union[str, os.PathLike], key: Optional[str] = None,
               register: bool = True, device: DeviceLike = None):
    """Load a model written by ``save_model`` onto ``device`` and register
    it in the DKV, so a fit can continue from it (``checkpoint=``).

    key: register under this key instead of the file's saved key, which is
    then left untouched. register=False: decode only, touch nothing."""
    model = _read_archive(os.fspath(path), resolve_device(device))
    return _register(model, key) if register else model
