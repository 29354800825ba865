"""Lazy reshape, ravel and transpose (the slices' part of
``spartan_tpu/expr/reshape.py``; concatenate, stack and tile come later)."""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

from spartan_tpu_torch.expr.base import EmitCtx, Expr, lazify


class ReshapeExpr(Expr):
  """NumPy reshape (C order, one ``-1`` allowed); a view where torch can
  give one, else a copy."""

  _members = ("inputs",)
  _params = ("new_shape",)

  def __init__(self, src, new_shape: Sequence[int]):
    super().__init__(inputs=[lazify(src)], new_shape=tuple(new_shape))

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    return deps[0].reshape(self.new_shape)


class RavelExpr(Expr):
  """Flatten to 1-D in C order (a 0-d value becomes shape (1,))."""

  _members = ("inputs",)
  _params = ()

  def __init__(self, src):
    super().__init__(inputs=[lazify(src)])

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    return deps[0].reshape(-1)


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
