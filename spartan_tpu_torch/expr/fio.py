"""The host escape hatch of ``spartan_tpu/expr/fio.py``: ``HostExpr``.

A NumPy function over the evaluated inputs, run on the host, for ops
whose output shape depends on the data (a boolean part inside a tuple
index; ``where`` with one argument).  Its abstract value raises
:class:`NotShapeable`, so the evaluator evaluates it before the region
that reads it.  The rest of the reference's ``fio.py`` (save, load,
checkpoint, from_file) is not ported yet.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from spartan_tpu_torch.core.array import SpartanArray, from_numpy
from spartan_tpu_torch.expr.base import Expr, NotShapeable, lazify

counts = {"host_runs": 0}


class HostExpr(Expr):
  """``fn(*inputs)`` on the host, over NumPy copies of the inputs."""

  _members = ("inputs",)
  _params = ("fn",)

  def __init__(self, inputs, fn: Callable):
    super().__init__(inputs=[lazify(v) for v in inputs], fn=fn)

  def aval(self):
    raise NotShapeable(f"host op {self.fn} has a data-dependent shape")

  def _emit(self, ctx, deps):
    raise NotShapeable("host op must be evaluated eagerly")

  def evaluate_eager(self) -> SpartanArray:
    counts["host_runs"] += 1
    args = [c.evaluate().glom() for c in self.inputs]
    return from_numpy(np.asarray(self.fn(*args)))
