"""The compute primitive — the port of ``h2o3_tpu/compute/mapreduce.py``.

Reference: ``new MRTask(){ map(Chunk[]); reduce(T); }.doAll(frame)``
(``water/MRTask.java:15-64,391``): fan out over the node tree, map each
home chunk, reduce partials pairwise back up the tree.

The JAX package runs a user map function per device shard under
``shard_map`` and combines partials with ``psum``/``pmax``/``pmin``. Here
the shards are the ranks of the data mesh (``parallel/mesh.py``): with a
process group live, a table's columns hold this rank's range of the rows,
padded to the world size with NaN, and the validity ``mask`` is false on
the pad rows; ``map_reduce`` reduces the rank partials over the mesh (sums
by the mesh's merge rule, max and min exactly) and ``map_batches`` gathers
the per-row outputs in row order, the same on every rank. With no group a
table's columns are whole tensors on one ``torch.device``, rows are not
padded (``n_padded == n_valid``), the mask is all true, and the reduction
over the one shard is the map's own output.

Two entry points, as in the JAX package:
  * ``map_reduce(fn, table)``  — fn: (cols, mask) -> pytree of partials;
  * ``map_batches(fn, table)`` — fn: (cols, mask) -> per-row outputs.

Caching: ``FrameTable.from_frame`` memoizes the device placement in the
process-wide :data:`h2o3_tpu_torch.frame.devcache.DEVCACHE` under kind
``frame_table``, keyed on column version stamps, dtype and device, and
``matrix()`` caches its stacked design matrix per column tuple. Eager torch
compiles nothing, so of the JAX package's dispatch plan cache what stays is
``plan_memo``: an LRU of ``PLAN_CACHE_SIZE`` entries that its callers (the
Rapids fusion pass) build once per key, with hit, miss and eviction counts
(:func:`plan_stats`).

``map_reduce_frame`` takes the local path; the fan-out over a cluster's
members waits for the cluster port (ROADMAP A10).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from h2o3_tpu_torch.device import DeviceLike, resolve_device
from h2o3_tpu_torch.frame.devcache import DEVCACHE, device_fingerprint, frame_token
from h2o3_tpu_torch.frame.frame import ColType, Frame
from h2o3_tpu_torch.parallel.mesh import (
    Mesh,
    default_mesh,
    gather_tree_rows,
    local_rows,
    row_mask,
    tree_reduce,
)

#: entries the dispatch plan cache keeps (the JAX package's default)
PLAN_CACHE_SIZE = 128

_plans: "OrderedDict[Tuple, object]" = OrderedDict()
_plans_lock = threading.Lock()
#: namespace -> {"hits", "misses", "evictions"}
_plan_counts: Dict[str, Dict[str, int]] = {}


def _count(namespace: str, what: str) -> None:
    # caller holds _plans_lock
    c = _plan_counts.setdefault(namespace, {"hits": 0, "misses": 0, "evictions": 0})
    c[what] += 1


def plan_stats() -> Dict[str, Dict[str, int]]:
    """Plan-cache hits, misses and evictions per namespace (the fusion
    pass's ``rapids_fusion``) since the process started."""
    with _plans_lock:
        return {k: dict(v) for k, v in _plan_counts.items()}


def plan_memo(namespace: str, key: Tuple, build: Callable[[], object]):
    """Memoize ``build()`` under ``(namespace, key)`` in the shared LRU
    plan cache. The Rapids fusion pass keeps its lowered column programs
    here, keyed on canonical S-expression, leaf schema and device type."""
    full = (namespace, key)
    with _plans_lock:
        hit = _plans.get(full)
        if hit is not None:
            _plans.move_to_end(full)
            _count(namespace, "hits")
            return hit
        _count(namespace, "misses")
    value = build()
    with _plans_lock:
        existing = _plans.get(full)
        if existing is not None:
            return existing  # lost a build race: converge on one plan
        _plans[full] = value
        while len(_plans) > PLAN_CACHE_SIZE:
            _count(_plans.popitem(last=False)[0][0], "evictions")
    return value


class FrameTable:
    """Device-resident view of (a subset of) a Frame's columns: this rank's
    padded rows of each (every row with no process group).

    Columns are float32 by default (float64 on request, e.g. for the Rapids
    fusion pass), one tensor each, with a boolean ``mask`` of the real rows.
    ``mesh`` is the data mesh the rows shard over (None: one device)."""

    def __init__(self, arrays: Dict[str, torch.Tensor], mask: torch.Tensor,
                 n_valid: int, device: torch.device,
                 mesh: Optional[Mesh] = None) -> None:
        self.arrays = arrays
        self.mask = mask
        self.n_valid = n_valid
        self.device = torch.device(device)
        self.mesh = mesh or default_mesh()
        self._matrix_lock = threading.Lock()
        self._matrix_cache: Dict[Tuple[str, ...], torch.Tensor] = {}
        #: devcache key when this table is cache-resident: stacked matrices
        #: built on it are byte-attributed to that entry
        self._devcache_key: Optional[Tuple] = None

    @staticmethod
    def from_frame(
        frame: Frame,
        columns: Optional[Sequence[str]] = None,
        device: DeviceLike = None,
        dtype: torch.dtype = torch.float32,
        cache: bool = True,
    ) -> "FrameTable":
        """Device-resident view of ``frame``, memoized process-wide under
        (column versions, dtype, device, world size, rank): repeat calls on
        an unmutated frame return the same resident table. ``cache=False``
        forces an upload. With a process group live the table holds this
        rank's rows, padded with NaN (``parallel/mesh.shard_rows``)."""
        dev = resolve_device(device)
        mesh = default_mesh()
        np_dtype = np.float64 if dtype == torch.float64 else np.float32
        names = list(columns) if columns is not None else [
            c.name for c in frame.columns if c.type not in (ColType.STR, ColType.UUID)
        ]
        if not names:
            raise ValueError("no device-shardable (numeric/categorical/time) columns")

        def build() -> "FrameTable":
            n = frame.nrows
            arrays = {
                name: torch.from_numpy(np.ascontiguousarray(local_rows(
                    np.asarray(frame.col(name).numeric_view(), dtype=np_dtype),
                    mesh, np.nan))).to(dev)
                for name in names
            }
            mask = row_mask(n, mesh.rows(n)[2] * mesh.size, mesh, dev)
            return FrameTable(arrays, mask, n, dev, mesh)

        token = frame_token(frame, names) if cache else None
        if token is None:
            return build()
        key = ("frame_table", token, str(dtype), device_fingerprint(dev),
               mesh.size, mesh.rank)
        table = DEVCACHE.get_or_put(
            key, build, frame_key=getattr(frame, "key", None), kind="frame_table")
        table._devcache_key = key
        return table

    @property
    def n_padded(self) -> int:
        """Rows of the padded table, over every rank."""
        return int(next(iter(self.arrays.values())).shape[0]) * self.mesh.size

    def matrix(self, columns: Optional[Sequence[str]] = None) -> torch.Tensor:
        """[S, F] feature matrix of this rank's rows (column-stacked), cached
        per column tuple: with the table itself cached, repeat fits stack
        nothing."""
        names = tuple(columns) if columns is not None else tuple(self.arrays)
        with self._matrix_lock:
            cached = self._matrix_cache.get(names)
        if cached is not None:
            return cached
        m = torch.stack([self.arrays[n] for n in names], dim=1)
        with self._matrix_lock:
            cur = self._matrix_cache.get(names)
            if cur is not None:
                return cur  # lost the stack race; the winner is cached
            self._matrix_cache[names] = m
            if self._devcache_key is not None:
                DEVCACHE.grow_entry(self._devcache_key, int(m.nbytes))
        return m


#: valid ``map_reduce(reduce=...)`` choices
_REDUCERS = ("max", "min", "sum")


def map_reduce(fn: Callable, table: FrameTable, *extra_args, reduce: str = "sum"):
    """Run ``fn(cols_dict, mask, *extra)`` over this rank's rows and reduce
    the pytree of partials over the table's mesh (``sum``, ``max`` or
    ``min``; with one device the partials are already the reduction). The
    result is the same on every rank. ``reduce`` is checked as the JAX
    package checks it."""
    if reduce not in _REDUCERS:
        raise ValueError(
            f"unknown reduce {reduce!r}; valid choices: {sorted(_REDUCERS)}")
    return tree_reduce(fn(table.arrays, table.mask, *extra_args), reduce, table.mesh)


def map_batches(fn: Callable, table: FrameTable, *extra_args):
    """Run ``fn(cols_dict, mask, *extra)`` over this rank's rows and keep
    its per-row outputs on the device, gathered in row order over the mesh
    (an MRTask writing an output Frame, ``water/MRTask.java:558-559``)."""
    out = fn(table.arrays, table.mask, *extra_args)
    if not table.mesh.live:
        return out
    return gather_tree_rows(out, table.n_padded, table.mesh)


def gather_rows(x: torch.Tensor, n_valid: int) -> np.ndarray:
    """Pull a per-row device result (``map_batches``'s, every row in row
    order) back to the host, without the pad rows."""
    return x[:n_valid].cpu().numpy()


def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return np.asarray(tree)


def map_reduce_frame(
    fn: Callable,
    frame: Frame,
    columns: Optional[Sequence[str]] = None,
    reduce: str = "sum",
    device: DeviceLike = None,
):
    """``map_reduce`` over a Frame's (numeric, categorical, time) columns,
    the reduced pytree returned as host numpy arrays. The JAX package fans
    a chunk-homed frame out over a live cloud; with no cloud it takes this
    local path, the only one here until the cluster port (ROADMAP A10)."""
    names = list(columns) if columns is not None else [
        c.name for c in frame.columns if c.type not in (ColType.STR, ColType.UUID)]
    table = FrameTable.from_frame(frame, columns=names, device=device)
    return _to_host(map_reduce(fn, table, reduce=reduce))
