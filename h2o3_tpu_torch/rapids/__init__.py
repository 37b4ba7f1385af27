"""Rapids — the port of ``h2o3_tpu/rapids``: the dataframe munging DSL.

Reference: ``water/rapids/`` — a Lisp-like AST language (``Rapids.java:19-51``)
with ~200 primitives under ``rapids/ast/prims/{mungers,math,reducers,...}``,
interpreted server-side against distributed Frames; Python/R clients compile
dataframe expressions to these ASTs (``h2o-py/h2o/expr.py``).

The same wire syntax and primitives, interpreted against the host-canonical
columnar Frame, as in the JAX package. The device paths run on the
session's device: fused column programs (``fusion.py``), the sort, merge
probe and group-by aggregation of large frames (``dist.py``) and large
matrix products (``prims/matrix.py``). On the CPU::

    from h2o3_tpu_torch.rapids import Session, exec_rapids
    sess = Session(device="cpu")
    sess.assign("fr", frame)
    exec_rapids("(sum (* (cols_py fr 0) 2))", sess)
"""

from h2o3_tpu_torch.rapids.runtime import Session, Val, exec_rapids, parse_rapids

__all__ = ["Session", "Val", "exec_rapids", "parse_rapids"]
