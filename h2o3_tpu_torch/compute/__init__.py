from h2o3_tpu_torch.compute.mapreduce import FrameTable, map_reduce
from h2o3_tpu_torch.compute.quantile import quantiles

__all__ = ["FrameTable", "map_reduce", "quantiles"]
