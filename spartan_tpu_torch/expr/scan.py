"""Prefix scans (port of ``spartan_tpu/expr/scan.py``).

The named scans are one torch op each: ``sum`` and ``prod`` accumulate in
``dtype_for_reduction`` (float32 in float64 under ``float64_reductions``,
bool and integers in int64), ``max`` and ``min`` are ``torch.cummax`` /
``torch.cummin``, which carry a NaN forward as NumPy's
``maximum.accumulate`` does.  A user's associative ``scan_fn`` runs as
``jax.lax.associative_scan`` runs it: pairs combined, the half-size scan
by recursion, the even elements filled in, so about 2·log2(n) whole-tensor
calls of ``scan_fn`` and no loop over elements.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch

from spartan_tpu_torch.expr.base import EmitCtx, Expr, lazify
from spartan_tpu_torch.expr.reduce import dtype_for_reduction

_OPS = ("sum", "prod", "max", "min")


def _raveled(x: torch.Tensor, axis: Optional[int]):
  return (x.reshape(-1), 0) if axis is None else (x, axis)


class ScanExpr(Expr):
  _members = ("inputs",)
  _params = ("op", "axis")

  def __init__(self, src, op: str = "sum", axis: Optional[int] = None):
    if op not in _OPS:
      raise ValueError(f"unknown scan op {op!r}")
    super().__init__(inputs=[lazify(src)], op=op, axis=axis)

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    x, axis = _raveled(deps[0], self.axis)
    if self.op == "sum":
      return torch.cumsum(x, axis, dtype=dtype_for_reduction(x.dtype))
    if self.op == "prod":
      return torch.cumprod(x, axis, dtype=dtype_for_reduction(x.dtype))
    if self.op == "max":
      return torch.cummax(x, axis).values
    return torch.cummin(x, axis).values


def associative_scan(fn: Callable, x: torch.Tensor, axis: int = 0,
                     reverse: bool = False) -> torch.Tensor:
  """``jax.lax.associative_scan(fn, x, axis, reverse)`` over one tensor:
  ``fn(a, b)`` with ``a`` the earlier element, the same combinations in
  the same order."""
  x = x.movedim(axis, 0)
  if reverse:
    x = x.flip(0)
  out = _scan(fn, x)
  if reverse:
    out = out.flip(0)
  return out.movedim(0, axis)


def _scan(fn: Callable, x: torch.Tensor) -> torch.Tensor:
  n = x.shape[0]
  if n < 2:
    return x
  odd = _scan(fn, fn(x[0:-1:2], x[1::2]))
  even = fn(odd[:-1] if n % 2 == 0 else odd, x[2::2])
  even = torch.cat([x[:1].to(even.dtype), even])
  out = torch.empty((n,) + tuple(odd.shape[1:]),
                    dtype=torch.promote_types(even.dtype, odd.dtype),
                    device=x.device)
  out[0::2] = even
  out[1::2] = odd
  return out


class CustomScanExpr(Expr):
  """A prefix scan by the user's binary ASSOCIATIVE ``fn(a, b)`` over torch
  tensors (the reference's extensible scan form)."""

  _members = ("inputs",)
  _params = ("fn", "axis", "reverse")

  def __init__(self, src, fn, axis=None, reverse=False):
    super().__init__(inputs=[lazify(src)], fn=fn, axis=axis,
                     reverse=bool(reverse))

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    x, axis = _raveled(deps[0], self.axis)
    return associative_scan(self.fn, x, axis, self.reverse)


def scan(v, op: str = "sum", axis: Optional[int] = None, scan_fn=None,
         reverse: bool = False):
  """Named-op prefix scan, or the extensible form via ``scan_fn(a, b)``
  (binary associative combiner, e.g. log-sum-exp accumulation).
  ``reverse=True`` gives the suffix scan (both forms)."""
  if scan_fn is not None:
    return CustomScanExpr(v, fn=scan_fn, axis=axis, reverse=reverse)
  if reverse:
    # suffix scan for named ops: flip → prefix scan → flip (keeps the
    # float64 accumulation of ScanExpr)
    from spartan_tpu_torch.expr.builtins import flip, ravel
    src = lazify(v)
    if axis is None:
      src, axis = ravel(src), 0
    return flip(ScanExpr(flip(src, axis=axis), op=op, axis=axis),
                axis=axis)
  return ScanExpr(v, op=op, axis=axis)
