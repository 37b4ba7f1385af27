"""h2o3_tpu_torch — the PyTorch/CUDA port of ``h2o3_tpu``.

A second package beside the JAX one, grown slice by slice until it does
what ``h2o3_tpu`` does with the same answers. It imports ``torch`` and
numpy, never ``jax`` and nothing of ``h2o3_tpu``. Its entry points run on a
CUDA card unless the caller asks for the CPU (``device="cpu"`` or
``use_device("cpu")``); the TPU's Pallas kernels are hand-written CUDA
kernels here (``h2o3_tpu_torch/csrc``), built with ``nvcc`` at first use.

So far: Frames, and XGBoost/GBM/DRF fit + score on the histogram tree core.
"""

from h2o3_tpu_torch.device import resolve_device, use_device
from h2o3_tpu_torch.frame.frame import ColType, Column, Frame
from h2o3_tpu_torch.models.tree.drf import DRF
from h2o3_tpu_torch.models.tree.gbm import GBM
from h2o3_tpu_torch.models.tree.xgboost import XGBoost

__version__ = "0.1.0"

__all__ = [
    "ColType",
    "Column",
    "DRF",
    "Frame",
    "GBM",
    "XGBoost",
    "resolve_device",
    "use_device",
]
