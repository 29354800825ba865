"""Lazy reshape, ravel, transpose, concatenate, stack and tile (port of
``spartan_tpu/expr/reshape.py``).

torch's ``cat`` and ``stack`` promote by torch's rules (int32 with float32
gives float32); the nodes here cast every input to NumPy's result type
first, as ``map2`` does.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import torch

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


def _common(deps: List[Any]) -> List[torch.Tensor]:
  """The inputs as tensors in NumPy's result type of them all."""
  from spartan_tpu_torch.expr.map import _lift, result_type
  device = next((d.device for d in deps if isinstance(d, torch.Tensor)), None)
  xs = [_lift(d, device) for d in deps]
  dt = xs[0].dtype
  for x in xs[1:]:
    dt = result_type(dt, x.dtype)
  return [x.to(dt) for x in xs]


class ConcatenateExpr(Expr):
  """``numpy.concatenate``: ``axis=None`` joins the flattened inputs."""

  _members = ("inputs",)
  _params = ("axis",)

  def __init__(self, arrays, axis: Optional[int] = 0):
    super().__init__(inputs=[lazify(a) for a in arrays], axis=axis)

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    xs = _common(deps)
    if self.axis is None:
      return torch.cat([x.reshape(-1) for x in xs])
    return torch.cat(xs, dim=self.axis)


class StackExpr(Expr):
  """``numpy.stack``: the inputs, of one shape, along a new axis."""

  _members = ("inputs",)
  _params = ("axis",)

  def __init__(self, arrays, axis: int = 0):
    super().__init__(inputs=[lazify(a) for a in arrays], axis=axis)

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    return torch.stack(_common(deps), dim=self.axis)


class TileExpr(Expr):
  """``numpy.tile``: the whole array repeated ``reps`` times along each
  axis (torch's ``tile`` has NumPy's rules for unequal lengths)."""

  _members = ("inputs",)
  _params = ("reps",)

  def __init__(self, src, reps):
    reps = (int(reps),) if not isinstance(reps, (tuple, list)) else tuple(
        int(r) for r in reps)
    super().__init__(inputs=[lazify(src)], reps=reps)

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    from spartan_tpu_torch.expr.map import _lift
    return torch.tile(_lift(deps[0], ctx.device), self.reps)
