"""h2o3_tpu_torch.genmodel — offline MOJO scoring with numpy alone; the port
of ``h2o3_tpu/genmodel``.

Reference: ``h2o-genmodel/``, the standalone scoring jar: ``MojoModel.load``,
per-algo readers in ``h2o-genmodel/.../algos/`` and the row-wise
``EasyPredictModelWrapper`` API.

This package imports numpy and nothing else of the stack: not ``torch``,
not ``jax``, and neither ``h2o3_tpu_torch``'s training code nor the JAX
package, since a production scorer needs numpy alone (the reference ships
genmodel as a dependency-light jar for the same reason). It reads the MOJO
files that ``h2o3_tpu_torch.models.mojo_export`` writes, and those of every
algorithm the JAX package's ``mojo_export`` writes (the same zip of
model.ini + data_info.json + meta.json + arrays.npz, shaped like the
reference's ``hex/ModelMojoWriter.java`` though not byte-compatible with
Java H2O).
"""

from h2o3_tpu_torch.genmodel.mojo_model import MojoModel, load_mojo
from h2o3_tpu_torch.genmodel.easy import EasyPredictModelWrapper

__all__ = ["MojoModel", "load_mojo", "EasyPredictModelWrapper"]
