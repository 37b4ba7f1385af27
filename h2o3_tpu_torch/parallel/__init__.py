"""Row sharding over ``torch.distributed``: the data mesh, the collectives
and their merge rule (``parallel/mesh.py``)."""

from h2o3_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    default_mesh,
    device_count,
    distributed_initialize,
    pad_rows,
    row_mask,
    row_sharding,
    shard_rows,
    shard_table,
)

__all__ = [
    "DATA_AXIS",
    "Mesh",
    "default_mesh",
    "device_count",
    "distributed_initialize",
    "pad_rows",
    "row_mask",
    "row_sharding",
    "shard_rows",
    "shard_table",
]
