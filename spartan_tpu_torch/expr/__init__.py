"""Lazy expression layer: nodes, optimizer, builtins.

Function names that collide with submodule names (``map``, ``reduce``,
``dot``, ``ndarray``, ``optimize``) are not re-exported here; they live at
the top-level ``spartan_tpu_torch`` namespace.
"""

from spartan_tpu_torch.expr.base import (Aval, Expr, ListExpr, Val, evaluate,
                                         force, glom, lazify)
from spartan_tpu_torch.expr.dot import DotExpr, OuterExpr, TensorDotExpr
from spartan_tpu_torch.expr.fio import (CheckpointExpr, HostExpr, checkpoint,
                                        from_file, load, save)
from spartan_tpu_torch.expr.map import MapExpr
from spartan_tpu_torch.expr.ndarray import CreationExpr
from spartan_tpu_torch.expr.reduce import ReduceExpr, dtype_for_reduction
from spartan_tpu_torch.expr.reshape import TransposeExpr
