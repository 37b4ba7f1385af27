"""Device choice — the port of ``h2o3_tpu/parallel/mesh.py``.

The JAX package shards rows over a mesh of devices and reduces per-shard
partials with ``psum``. This package runs on one card: every tensor of a fit
lives on one ``torch.device`` and there is no sharding (multi-GPU NCCL is a
later step). Rows are not padded either: ``pad_rows`` (:119) and
``row_mask`` (:156) exist for the mesh's shard multiple, and the histogram
kernel here takes any row count.

Device policy: entry points run on ``cuda`` unless the caller asks for the
CPU, either with an explicit ``device=`` argument or inside
``use_device("cpu")``. Without a card and without that request they raise:
a fit never carries on quietly on the CPU.
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
    innermost ``use_device`` block, else ``cuda``. Asking for ``cuda`` (or
    asking for nothing) on a host without a card raises."""
    if device is None:
        stack = _stack()
        dev = stack[-1] if stack else torch.device("cuda")
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
