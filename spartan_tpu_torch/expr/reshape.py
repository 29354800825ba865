"""Lazy transpose (the slice's part of ``spartan_tpu/expr/reshape.py``)."""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

from spartan_tpu_torch.expr.base import EmitCtx, Expr, lazify


class TransposeExpr(Expr):
  """Permute axes (reversed when ``axes`` is None); emits a strided view."""

  _members = ("inputs",)
  _params = ("axes",)

  def __init__(self, src, axes: Optional[Sequence[int]] = None):
    super().__init__(inputs=[lazify(src)],
                     axes=tuple(axes) if axes is not None else None)

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    x = deps[0]
    axes = self.axes if self.axes is not None else tuple(
        reversed(range(x.ndim)))
    return x.permute(axes)
