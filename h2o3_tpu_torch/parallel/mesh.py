"""Row sharding over ``torch.distributed`` — the port of
``h2o3_tpu/parallel/mesh.py``.

The JAX package is a single controller: one process holds the whole host
array and ``jax.device_put(..., row_sharding)`` spreads it over a
``jax.sharding.Mesh``; XLA inserts the ``psum`` that MRTask's node tree did
by hand (``water/MRTask.java:96-127``). This package follows PyTorch's SPMD
form instead:

* every rank (one process per GPU, as ``torchrun --nproc-per-node=N`` or
  ``torch.multiprocessing`` starts them) runs the same program and calls
  the same entry points with the same host arguments;
* a host array of N rows is padded to a multiple of the world size W
  (``pad_rows``) and rank r places only its own range of S = N_pad / W
  rows (``row_sharding``, ``shard_rows``) on its device;
* replicated values (merged histograms, split choices, trees, gathered
  margins, metrics) are bit-identical on every rank, and every decision
  that changes control flow is taken from them, so every rank issues the
  same collectives in the same order. A divergence would hang, so every
  collective runs under the process group's timeout, and a timeout raises.

The merge rule. A float ``psum`` all-gathers the rank partials and adds
them in rank order in float64 on every rank, then casts back; it never
calls ``all_reduce(SUM)``. Every rank and every run gets the same bits,
whatever algorithm NCCL picks, which is the rule the histogram kernels
keep inside a card (partials add in float64 in a fixed order). Integer
sums are exact; ``pmin`` and ``pmax`` are exact.

Backends: NCCL with one rank per card (``cuda:<local rank>``), gloo on the
CPU. A gloo group given CUDA tensors stages them through host copies
(``Mesh.staged``), which is how two ranks share one card; the backend is an
explicit argument of ``distributed_initialize``, not an environment knob.

With no group initialized, ``default_mesh()`` is a one-device mesh: every
row is local, nothing is padded, and every collective is the identity, so
each path keeps its one-device bits.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

#: name of the data axis; every fit shards rows over it (pure data
#: parallelism: the long axis is rows, SURVEY.md §2.4)
DATA_AXIS = "data"

#: seconds a collective may wait for the other ranks before it raises
DEFAULT_TIMEOUT_S = 300.0

#: what the collectives did since the last ``reset_counts``: calls, float
#: merges, and bytes each rank received
COUNTS: Dict[str, int] = {"collectives": 0, "merges": 0, "bytes_gathered": 0}

#: the live group's device, set by ``distributed_initialize``
_group_device: List[Optional[torch.device]] = [None]

_INIT_KEYS = ("backend", "init_method", "rank", "world_size", "timeout", "device")


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


@dataclass(frozen=True)
class Mesh:
    """A 1-D data mesh: a process group (None: one device, no group), this
    process's rank and the world size, the group's backend and the device
    this rank's rows live on."""

    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    backend: Optional[str]
    device: Optional[torch.device]

    @property
    def live(self) -> bool:
        """Whether collectives go through a process group (else identity)."""
        return self.group is not None

    @property
    def staged(self) -> bool:
        """gloo moves tensors through host copies (NCCL through the card)."""
        return self.backend == "gloo"

    def rows(self, n: int) -> Tuple[int, int, int]:
        """(lo, hi, S): this rank holds padded rows [lo, lo + S), of which
        rows [lo, hi) are real (hi <= n)."""
        s = -(-n // self.size)
        lo = min(self.rank * s, n)
        return lo, min(lo + s, n), s


def group_device() -> Optional[torch.device]:
    """The device of the live process group's rank, or None."""
    return _group_device[0] if dist.is_available() and dist.is_initialized() else None


def _fmt_kwargs(kwargs: dict) -> str:
    return ", ".join(f"{k}={v!r}" for k, v in sorted(kwargs.items()))


def distributed_initialize(**kwargs) -> None:
    """Join this process to the process group (replaces the reference's
    Paxos cloud formation; SURVEY.md §5). Call once per rank before any
    fit.

    Settings come from the explicit ``rank``, ``world_size``,
    ``init_method`` (default ``env://``) and ``backend`` (default ``nccl``
    with a card, else ``gloo``), or from the ``torchrun`` environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``LOCAL_RANK``).
    ``timeout`` (seconds, default ``DEFAULT_TIMEOUT_S``) bounds every
    collective; ``device`` is this rank's device (default
    ``cuda:<LOCAL_RANK>`` under either backend: the CPU only when asked
    for, so a fit in a group on a host without a card raises, as one
    outside a group does).

    As in the JAX package: a repeat initialization is benign; a bare call
    in a single process with nothing configured is a no-op; any other
    failure raises with the kwargs in its message."""
    if dist.is_initialized():
        return
    if not kwargs and "RANK" not in os.environ and "WORLD_SIZE" not in os.environ:
        return
    what = f"torch.distributed.init_process_group({_fmt_kwargs(kwargs)})"
    unknown = sorted(set(kwargs) - set(_INIT_KEYS))
    if unknown:
        raise TypeError(f"{what} failed: unknown argument(s) {unknown}")
    backend = kwargs.get("backend") or ("nccl" if torch.cuda.is_available() else "gloo")
    timeout = kwargs.get("timeout", DEFAULT_TIMEOUT_S)
    if not isinstance(timeout, datetime.timedelta):
        timeout = datetime.timedelta(seconds=float(timeout))
    device = kwargs.get("device")
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', kwargs.get('rank', 0)))}"
    try:
        device = torch.device(device)
        if device.type == "cuda" and torch.cuda.is_available():
            torch.cuda.set_device(device)
        init = {"backend": backend, "init_method": kwargs.get("init_method", "env://"),
                "timeout": timeout}
        for k in ("rank", "world_size"):
            if k in kwargs:
                init[k] = kwargs[k]
        dist.init_process_group(**init)
    except AssertionError as e:  # torch asserts on an unknown backend name
        raise ValueError(f"{what} failed: {e}") from e
    except (RuntimeError, ValueError, TypeError) as e:
        raise type(e)(f"{what} failed: {e}") from e
    _group_device[0] = device


def destroy() -> None:
    """Leave the process group (the inverse of ``distributed_initialize``)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _group_device[0] = None


def device_count() -> int:
    """Devices of the data mesh: the world size, or 1 with no group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def default_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The data mesh over every rank of the live group, or the one-device
    mesh when there is none. ``n_devices`` must be the world size."""
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(
                f"a mesh of {n_devices} devices needs a process group of "
                f"{n_devices} ranks; none is initialized")
        return Mesh(None, 0, 1, None, None)
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"a mesh of {n_devices} devices in a group of {size} ranks")
    return Mesh(dist.group.WORLD, dist.get_rank(), size, dist.get_backend(),
                _group_device[0])


def row_sharding(mesh: Mesh, n: int) -> slice:
    """This rank's range of the ``n`` real rows (the JAX package's
    ``NamedSharding(mesh, P(DATA_AXIS))``: rows split in rank order)."""
    lo, hi, _ = mesh.rows(n)
    return slice(lo, hi)


def pad_rows(
    x: np.ndarray, multiple: int, fill: Union[int, float] = 0
) -> Tuple[np.ndarray, int]:
    """Pad axis 0 up to a multiple; returns (padded, original_n)."""
    n = x.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    pad_widths = [(0, rem)] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad_widths, constant_values=fill), n


def local_rows(x: np.ndarray, mesh: Mesh, fill: Union[int, float] = 0) -> np.ndarray:
    """This rank's S padded rows of host array ``x`` (all of ``x`` on the
    one-device mesh, without a copy)."""
    lo, hi, s = mesh.rows(x.shape[0])
    if lo == 0 and hi == s == x.shape[0]:
        return x
    return pad_rows(x[lo:hi], s, fill)[0] if hi > lo else np.full(
        (s,) + x.shape[1:], fill, dtype=x.dtype)


def shard_rows(
    x: np.ndarray, mesh: Optional[Mesh] = None, fill: Union[int, float] = 0,
    device=None,
) -> Tuple[torch.Tensor, int]:
    """Place this rank's padded rows of a host array on ``device`` (default:
    the mesh's); returns (tensor, valid_rows of the whole array)."""
    mesh = mesh or default_mesh()
    x = np.asarray(x)
    dev = torch.device(device) if device is not None else _mesh_device(mesh)
    part = np.ascontiguousarray(local_rows(x, mesh, fill))
    return torch.from_numpy(part).to(dev), x.shape[0]


def row_mask(n_valid: int, n_padded: int, mesh: Optional[Mesh] = None,
             device=None) -> torch.Tensor:
    """This rank's slice of the validity mask of ``n_padded`` rows."""
    mesh = mesh or default_mesh()
    s = n_padded // mesh.size
    dev = torch.device(device) if device is not None else _mesh_device(mesh)
    return torch.arange(mesh.rank * s, (mesh.rank + 1) * s, device=dev) < n_valid


def shard_table(
    columns: Dict[str, np.ndarray], mesh: Optional[Mesh] = None, device=None,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, int]:
    """Shard a dict of equal-length host columns; returns (this rank's
    columns, its mask, the valid rows)."""
    mesh = mesh or default_mesh()
    out: Dict[str, torch.Tensor] = {}
    n = None
    for name, arr in columns.items():
        out[name], n = shard_rows(arr, mesh, device=device)
    if n is None:
        raise ValueError("empty table")
    some = next(iter(out.values()))
    return out, row_mask(n, some.shape[0] * mesh.size, mesh, some.device), n


def _mesh_device(mesh: Mesh) -> torch.device:
    from h2o3_tpu_torch.device import resolve_device

    return mesh.device if mesh.device is not None else resolve_device(None)


# ---------------------------------------------------------------------------
# collectives (each the identity on the one-device mesh)


def _to_comm(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``t`` where the backend reads it: the host for gloo, the rank's card
    for NCCL."""
    comm = torch.device("cpu") if mesh.staged else mesh.device
    return t.contiguous().to(comm)


def all_gather(t: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """Every rank's ``t`` (equal shapes), in rank order, on ``t``'s device."""
    if not mesh.live:
        return [t]
    src = _to_comm(t, mesh)
    outs = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(outs, src, group=mesh.group)
    COUNTS["collectives"] += 1
    COUNTS["bytes_gathered"] += src.nbytes * mesh.size
    return [o.to(t.device) for o in outs]


def psum(t: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The sum of every rank's ``t``, the same bits on every rank: floats
    add in rank order in float64 and are cast back; integers add exactly."""
    mesh = mesh or default_mesh()
    if not mesh.live:
        return t
    parts = all_gather(t, mesh)
    if not t.is_floating_point():
        return torch.stack(parts).sum(0).to(t.dtype)
    COUNTS["merges"] += 1
    acc = parts[0].double()
    for p in parts[1:]:
        acc = acc + p.double()
    return acc.to(t.dtype)


def pmax(t: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The elementwise maximum over every rank's ``t`` (exact)."""
    mesh = mesh or default_mesh()
    parts = all_gather(t, mesh)
    out = parts[0]
    for p in parts[1:]:
        out = torch.maximum(out, p)
    return out


def pmin(t: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The elementwise minimum over every rank's ``t`` (exact)."""
    mesh = mesh or default_mesh()
    parts = all_gather(t, mesh)
    out = parts[0]
    for p in parts[1:]:
        out = torch.minimum(out, p)
    return out


def any_rank(flag: bool, mesh: Optional[Mesh] = None) -> bool:
    """Whether ``flag`` holds on any rank: a decision taken from a
    rank-local value (a wall clock, a stop request) made the same on every
    rank, so that every rank goes on issuing the same collectives. Every
    rank must call it at the same point; ``flag`` itself with no group."""
    mesh = mesh or default_mesh()
    if not mesh.live:
        return bool(flag)
    return bool(pmax(torch.tensor([int(bool(flag))]), mesh)[0])


def all_gather_rows(t: torch.Tensor, n_valid: int,
                    mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Every rank's padded rows of ``t`` in row order, cut to ``n_valid``:
    the whole array, the same on every rank."""
    mesh = mesh or default_mesh()
    if not mesh.live:
        return t[:n_valid]
    return torch.cat(all_gather(t, mesh))[:n_valid]


def all_to_all(t: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Split ``t``'s rows into ``mesh.size`` equal blocks and send block d to
    rank d; returns the blocks received, in source-rank order."""
    mesh = mesh or default_mesh()
    if not mesh.live:
        return t
    if t.shape[0] % mesh.size:
        raise ValueError(f"all_to_all: {t.shape[0]} rows do not split over "
                         f"{mesh.size} ranks")
    src = _to_comm(t, mesh)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=mesh.group)
    COUNTS["collectives"] += 1
    COUNTS["bytes_gathered"] += out.nbytes
    return out.to(t.device)


def tree_reduce(tree, reduce: str, mesh: Optional[Mesh] = None):
    """``psum``/``pmax``/``pmin`` over every tensor of a pytree (dicts,
    lists, tuples), in a fixed traversal order."""
    fn = {"sum": psum, "max": pmax, "min": pmin}[reduce]
    return _tree_map(lambda t: fn(t, mesh), tree)


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k]) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def gather_tree_rows(tree, n_valid: int, mesh: Optional[Mesh] = None):
    """``all_gather_rows`` over every tensor of a pytree whose first axis
    is this rank's rows."""
    return _tree_map(lambda t: all_gather_rows(t, n_valid, mesh), tree)


__all__: Sequence[str] = (
    "DATA_AXIS", "DEFAULT_TIMEOUT_S", "COUNTS", "Mesh", "all_gather", "any_rank",
    "all_gather_rows", "all_to_all", "default_mesh", "destroy", "device_count",
    "distributed_initialize", "group_device", "local_rows", "pad_rows", "pmax",
    "pmin", "psum", "reset_counts", "row_mask", "row_sharding", "gather_tree_rows",
    "shard_rows", "shard_table", "tree_reduce",
)
