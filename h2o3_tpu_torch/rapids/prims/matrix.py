"""Rapids matrix prims — the port of ``h2o3_tpu/rapids/prims/matrix.py``:
matrix multiply and transpose.

Reference: ``water/rapids/ast/prims/matrix/`` — AstMMult (chunk-blocked
distributed matmul), AstTranspose.

Above ``_DEVICE_MIN_ELEMS`` elements the product runs on the session's
device as one float32 ``torch.matmul`` (the JAX package's float32 product
on its mesh; a plain product outside any Pallas kernel, so a library call
here). The left operand's placement is memoized in the device frame cache
under kind ``mmult_lhs``. The package never turns TF32 on (PyTorch's
default keeps it off for matmuls), so the product is true float32. Small
frames multiply in host numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from h2o3_tpu_torch.frame import devcache
from h2o3_tpu_torch.frame.frame import Column, ColType, Frame
from h2o3_tpu_torch.rapids.prims import prim
from h2o3_tpu_torch.rapids.runtime import RapidsError, Val

_DEVICE_MIN_ELEMS = 1 << 20  # below this, host matmul wins on transfer cost


@prim("x")
def mmult(env, args):
    """(x fr1 fr2) — matrix multiply (AstMMult)."""
    a_fr = args[0].as_frame()
    b = args[1].as_frame().to_numpy()
    a_shape = (a_fr.nrows, a_fr.ncols)
    if a_shape[1] != b.shape[0]:
        raise RapidsError(f"x: shape mismatch {a_shape} @ {b.shape}")
    if a_shape[0] * a_shape[1] + b.size >= _DEVICE_MIN_ELEMS:
        dev = env.session.device
        # to_numpy stays inside the builder, so a warm repeat of
        # (x fr other) skips the O(N*P) host materialization too
        a_dev = devcache.cached(
            "mmult_lhs", devcache.frame_token(a_fr), None, dev,
            lambda: torch.from_numpy(a_fr.to_numpy().astype(np.float32)).to(dev),
            frame_key=getattr(a_fr, "key", None),
        )
        b_dev = torch.from_numpy(b.astype(np.float32)).to(dev)
        out = torch.matmul(a_dev, b_dev).cpu().numpy().astype(np.float64)
    else:
        out = a_fr.to_numpy() @ b
    return Val.frame(
        Frame([Column(f"C{j+1}", out[:, j], ColType.NUM) for j in range(out.shape[1])])
    )


@prim("t")
def transpose(env, args):
    fr = args[0].as_frame()
    m = fr.to_numpy().T
    return Val.frame(
        Frame([Column(f"C{j+1}", m[:, j], ColType.NUM) for j in range(m.shape[1])])
    )
