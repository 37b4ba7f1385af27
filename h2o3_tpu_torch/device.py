"""Device choice.

Every tensor of one rank's share of a fit lives on one ``torch.device``.
Rows are sharded over ranks by ``parallel/mesh.py`` (the port of
``h2o3_tpu/parallel/mesh.py``): with a process group live, each rank holds
its own range of the padded rows on its device and partials merge over the
group; with none, one device holds every row, unpadded.

Device policy: entry points run on ``cuda`` unless the caller asks for the
CPU, either with an explicit ``device=`` argument or inside
``use_device("cpu")``. With a process group live and neither given, they
run on the group's device for this rank (``cuda:<local rank>`` under NCCL).
Without a card and without a request for the CPU they raise: a fit never
carries on quietly on the CPU.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]

_local = threading.local()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


@contextlib.contextmanager
def use_device(device: DeviceLike) -> Iterator[torch.device]:
    """Run entry points called inside the block on ``device`` (per thread)."""
    dev = torch.device(device)
    _stack().append(dev)
    try:
        yield dev
    finally:
        _stack().pop()


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: the explicit argument, else the
    innermost ``use_device`` block, else the live process group's device
    for this rank, else ``cuda``. Asking for ``cuda`` (or asking for
    nothing) on a host without a card raises."""
    if device is None:
        stack = _stack()
        if stack:
            dev = stack[-1]
        else:
            from h2o3_tpu_torch.parallel.mesh import group_device

            dev = group_device() or torch.device("cuda")
    else:
        dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "h2o3_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' or wrap the call in use_device('cpu') to run "
            "on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def to_device_f32(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a contiguous float32 tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)
