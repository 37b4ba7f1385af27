"""Frames for the PyTorch port (host-canonical numpy columns)."""

from h2o3_tpu_torch.frame.frame import ColType, Column, Frame

__all__ = ["ColType", "Column", "Frame"]
