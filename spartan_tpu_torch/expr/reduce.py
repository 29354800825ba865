"""Axis reductions with reference accumulation semantics.

Port of ``spartan_tpu/expr/reduce.py``.  Float inputs accumulate (and
return) float64 under ``FLAGS.float64_reductions``, integer and bool inputs
accumulate in int64 (``dtype_for_reduction``).  Two fast paths run before
the plain torch reduction, as in the reference:

* the affine rewrite: ``sum(a·x + b)`` → ``a·sum(x) + b·count``;
* the fused-reduce kernel hook (:meth:`ReduceExpr._try_kernel_full_sum`):
  a full ``sum`` over one big float operand and 0-d scalars goes to
  ``backend/kernels/fused_reduce.fused_sum``, which launches the CUDA kernel
  on a CUDA tensor and runs its plain version on a CPU one.  Chains the
  kernel cannot express are routed to the plain path up front (counted).
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from spartan_tpu_torch.config import FLAGS
from spartan_tpu_torch.core.array import dtype_kind, to_torch_dtype
from spartan_tpu_torch.expr.base import EmitCtx, Expr, lazify, scalar_array
from spartan_tpu_torch.expr.local import LocalExpr


def dtype_for_reduction(dtype) -> torch.dtype:
  """Accumulator/result dtype for additive reductions."""
  dtype = to_torch_dtype(dtype)
  kind = dtype_kind(dtype)
  if kind in "biu":
    # numpy accumulates bool and signed ints in int64 (torch has no uint64
    # arithmetic; its only unsigned type, uint8, also widens to int64)
    return torch.int64
  if kind == "f" and FLAGS.float64_reductions:
    return torch.promote_types(dtype, torch.float64)
  if kind == "c" and FLAGS.float64_reductions:
    return torch.promote_types(dtype, torch.complex128)
  return dtype


_OPS = ("sum", "mean", "max", "min", "argmax", "argmin", "prod", "var",
        "std", "all", "any", "count_nonzero", "nansum", "nanmax", "nanmin")


def _ndim(v) -> int:
  return v.ndim if isinstance(v, torch.Tensor) else 0


class ReduceExpr(Expr):
  """Reduce ``inputs[0]`` (or the fused ``local_op`` over ``inputs``) along
  ``axis`` with named ``op``."""

  _members = ("inputs",)
  _params = ("op", "axis", "keepdims", "out_dtype", "local_op", "ddof")

  def __init__(self, inputs, op: str, axis=None, keepdims=False,
               out_dtype=None, local_op: Optional[LocalExpr] = None,
               ddof: int = 0):
    if op not in _OPS:
      raise ValueError(f"unknown reduction {op!r}; the port has {_OPS}")
    if isinstance(inputs, Expr):
      inputs = [inputs]
    super().__init__(inputs=[lazify(v) for v in inputs], op=op,
                     axis=_canon_axis(axis), keepdims=keepdims,
                     out_dtype=(to_torch_dtype(out_dtype)
                                if out_dtype is not None else None),
                     local_op=local_op, ddof=int(ddof))

  def _value(self, deps: List[Any], device=None):
    if self.local_op is not None:
      return self.local_op.evaluate(deps, device=device)
    return deps[0]

  def _weak_operands(self) -> bool:
    return self.local_op is not None  # the fused map promotes them

  def _try_affine_rewrite(self, deps: List[Any]):
    """Strength-reduce ``sum(a·x + b)`` to ``a·sum(x) + b·count`` (and the
    mean likewise): the per-element chain collapses into a scalar epilogue
    around a pure sum.  Accumulation dtype unchanged."""
    if self.op not in ("sum", "mean") or not FLAGS.opt_affine_reduce:
      return None
    if self.local_op is None:
      return None
    big = [k for k, d in enumerate(deps) if _ndim(d) >= 1]
    if len(big) != 1:
      return None
    bi = big[0]
    affine = _extract_affine(self.local_op, bi)
    if affine is None:
      return None
    is_const, a_fn, b_fn = affine
    if is_const:
      return None
    x = deps[bi]
    if dtype_kind(x.dtype) not in "fiu":
      return None
    # accumulator = the node's output dtype over the UNREWRITTEN chain
    # (sum(int_arr / 2) must not truncate the 0.5 coefficient)
    acc = self.aval().dtype
    if dtype_kind(acc) not in "fc" and any(
        dtype_kind(d.dtype) not in "iub" for d in deps
        if isinstance(d, torch.Tensor)):
      return None
    a = torch.as_tensor(a_fn(deps), dtype=acc, device=x.device)
    b = torch.as_tensor(b_fn(deps), dtype=acc, device=x.device)
    dims = self.axis
    if self.op == "sum":
      s = torch.sum(x, dim=dims, dtype=acc, keepdim=self.keepdims)
      count = _reduced_count(x.shape, self.axis)
      return a * s + b * torch.as_tensor(count, dtype=acc, device=x.device)
    m = torch.mean(x, dim=dims, dtype=acc, keepdim=self.keepdims)
    return a * m + b

  def _try_kernel_full_sum(self, deps: List[Any]):
    """Lower a full ``sum`` over one big operand (+ 0-d scalars) to the
    fused elementwise+reduce kernel.  Returns None when the gates (the
    reference's, unchanged) do not hold or the chain is outside the
    kernel's op table."""
    if self.op != "sum" or self.axis is not None or not FLAGS.use_kernels:
      return None
    big = [k for k, d in enumerate(deps) if _ndim(d) >= 1]
    if len(big) != 1:
      return None
    main = deps[big[0]]
    if main.ndim > 2 or main.dtype not in (torch.float32, torch.bfloat16,
                                           torch.float16):
      return None
    if any(_ndim(deps[k]) != 0 for k in range(len(deps)) if k != big[0]):
      return None
    acc = self.out_dtype or dtype_for_reduction(main.dtype)
    if dtype_kind(acc) != "f":
      return None
    from spartan_tpu_torch.backend.kernels import fused_reduce
    scal_idx = [k for k in range(len(deps)) if k != big[0]]
    program = fused_reduce.plan(self.local_op, big[0], main.dtype,
                                {k: deps[k] for k in scal_idx})
    if program is None:
      return None
    return fused_reduce.fused_sum(main.contiguous(), program,
                                  [deps[k] for k in scal_idx], acc)

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    if not ctx.abstract:
      fast = self._try_affine_rewrite(deps)
      if fast is not None:
        return fast
      if not ctx.differentiable:   # the kernel has no autograd rule
        fast = self._try_kernel_full_sum(deps)
        if fast is not None:
          return fast
    x = scalar_array(self._value(deps, ctx.device), ctx.device)
    op, keepdims = self.op, self.keepdims
    dims = self.axis
    if op in _MORE:
      return _MORE[op](self, x)
    if op in ("sum", "mean"):
      acc = self.out_dtype or dtype_for_reduction(x.dtype)
      if op == "sum":
        return torch.sum(x, dim=dims, dtype=acc, keepdim=keepdims)
      if dtype_kind(acc) in "iu":
        acc = torch.float64
      return torch.mean(x, dim=dims, dtype=acc, keepdim=keepdims)
    if op == "max":
      return torch.amax(x, dim=dims if dims is not None else (),
                        keepdim=keepdims)
    if op == "min":
      return torch.amin(x, dim=dims if dims is not None else (),
                        keepdim=keepdims)
    fn = torch.argmax if op == "argmax" else torch.argmin
    if x.dtype == torch.bool:
      x = x.to(torch.uint8)  # torch has no argmax of bool; NumPy's order
    if self.axis is None:
      out = fn(x.reshape(-1))
      return out.reshape((1,) * x.ndim) if keepdims else out
    return fn(x, dim=self.axis, keepdim=keepdims)

  def _sig_local(self, memo, result):
    return ("ReduceExpr", self.op, self.axis, self.keepdims,
            str(self.out_dtype), self.ddof,
            self.local_op.signature() if self.local_op is not None else None,
            tuple(self._child_sig(c, memo, result) for c in self.inputs))


def _dims(x: torch.Tensor, axis) -> Tuple[int, ...]:
  """The reduced axes, non-negative and sorted (all of them for None)."""
  if axis is None:
    return tuple(range(x.ndim))
  axes = axis if isinstance(axis, tuple) else (axis,)
  return tuple(sorted(a % x.ndim for a in axes)) if x.ndim else ()


def _prod(e: "ReduceExpr", x: torch.Tensor):
  acc = e.out_dtype or dtype_for_reduction(x.dtype)
  out = x.to(acc)
  for d in reversed(_dims(x, e.axis)):  # torch.prod takes one axis
    out = torch.prod(out, dim=d, keepdim=e.keepdims)
  return out


def _var(e: "ReduceExpr", x: torch.Tensor):
  acc = e.out_dtype or dtype_for_reduction(x.dtype)
  if dtype_kind(acc) in "biu":
    acc = torch.float64
  v = torch.var(x.to(acc), dim=_dims(x, e.axis), correction=e.ddof,
                keepdim=e.keepdims)
  return torch.sqrt(v) if e.op == "std" else v


def _all_any(e: "ReduceExpr", x: torch.Tensor):
  fn = torch.all if e.op == "all" else torch.any
  b = x if x.dtype == torch.bool else x != 0
  return fn(b, dim=_dims(x, e.axis), keepdim=e.keepdims)


def _count_nonzero(e: "ReduceExpr", x: torch.Tensor):
  return torch.count_nonzero(x, dim=_dims(x, e.axis))


def _nansum(e: "ReduceExpr", x: torch.Tensor):
  acc = e.out_dtype or dtype_for_reduction(x.dtype)
  if not x.is_floating_point():
    return torch.sum(x, dim=_dims(x, e.axis), dtype=acc, keepdim=e.keepdims)
  return torch.nansum(x.to(acc), dim=_dims(x, e.axis), keepdim=e.keepdims)


def _nanmax_min(e: "ReduceExpr", x: torch.Tensor):
  """NumPy's ``nanmax``/``nanmin``: NaN is skipped, and a slice of NaN
  only gives NaN."""
  fn = torch.amax if e.op == "nanmax" else torch.amin
  dims = _dims(x, e.axis)
  if not x.is_floating_point():
    return fn(x, dim=dims, keepdim=e.keepdims)
  nan = torch.isnan(x)
  fill = float("-inf") if e.op == "nanmax" else float("inf")
  out = fn(torch.where(nan, torch.full_like(x, fill), x), dim=dims,
           keepdim=e.keepdims)
  return torch.where(torch.all(nan, dim=dims, keepdim=e.keepdims),
                     torch.full_like(out, float("nan")), out)


# the reductions beyond the slice-1 set, each over the reduction's value
_MORE = {"prod": _prod, "var": _var, "std": _var, "all": _all_any,
         "any": _all_any, "count_nonzero": _count_nonzero,
         "nansum": _nansum, "nanmax": _nanmax_min, "nanmin": _nanmax_min}


def _canon_axis(axis):
  """NumPy-style axis → None | int | tuple[int] (single ints unwrapped)."""
  if axis is None:
    return None
  if isinstance(axis, (list, tuple, np.ndarray)):
    axes = tuple(int(a) for a in axis)
    return axes[0] if len(axes) == 1 else axes
  return int(axis)


def _reduced_count(shape, axis) -> int:
  if axis is None:
    axis = range(len(shape))
  elif not isinstance(axis, tuple):
    axis = (axis,)
  n = 1
  for a in axis:
    n *= int(shape[a % len(shape)])
  return n


def _extract_affine(node, big_idx: int):
  """Symbolically decompose a LocalExpr as ``a·x + b`` in input slot
  ``big_idx``; scalar slots stay symbolic (evaluated against the real dep
  values at emit time).  Returns ``(is_const, a_fn, b_fn)`` with
  ``a_fn/b_fn: deps -> scalar``, or None if non-affine."""
  from spartan_tpu_torch.expr.local import FnCallExpr, LocalConst, LocalInput

  if isinstance(node, LocalInput):
    if node.idx == big_idx:
      return (False, lambda d: 1.0, lambda d: 0.0)
    return (True, lambda d: 0.0, lambda d, i=node.idx: d[i])
  if isinstance(node, LocalConst):
    v = node.value
    return (True, lambda d: 0.0, lambda d: v)
  if not isinstance(node, FnCallExpr) or node.kw:
    return None
  name = getattr(node.fn, "__name__", "")
  subs = [_extract_affine(c, big_idx) for c in node.deps]
  if any(s is None for s in subs):
    return None
  if name == "add" and len(subs) == 2:
    (c1, a1, b1), (c2, a2, b2) = subs
    return (c1 and c2, lambda d: a1(d) + a2(d), lambda d: b1(d) + b2(d))
  if name == "subtract" and len(subs) == 2:
    (c1, a1, b1), (c2, a2, b2) = subs
    return (c1 and c2, lambda d: a1(d) - a2(d), lambda d: b1(d) - b2(d))
  if name == "negative" and len(subs) == 1:
    (c1, a1, b1) = subs[0]
    return (c1, lambda d: -a1(d), lambda d: -b1(d))
  if name == "multiply" and len(subs) == 2:
    (c1, a1, b1), (c2, a2, b2) = subs
    if c1:
      return (c1 and c2, lambda d: b1(d) * a2(d), lambda d: b1(d) * b2(d))
    if c2:
      return (False, lambda d: a1(d) * b2(d), lambda d: b1(d) * b2(d))
    return None
  if name in ("true_divide", "divide") and len(subs) == 2:
    (c1, a1, b1), (c2, a2, b2) = subs
    if c2:
      return (c1, lambda d: a1(d) / b2(d), lambda d: b1(d) / b2(d))
    return None
  return None


class CustomReduceExpr(Expr):
  """A reduction the user supplies: ``fn(x, axis=axis, **fn_kw)``, a torch
  function over the whole input (the reference's ``reduce`` with
  ``local_reduce_fn``)."""

  _members = ("inputs",)
  _params = ("fn", "axis", "fn_kw")

  def __init__(self, inputs, fn, axis=None, fn_kw=None):
    if isinstance(inputs, Expr):
      inputs = [inputs]
    super().__init__(inputs=[lazify(v) for v in inputs], fn=fn, axis=axis,
                     fn_kw=dict(fn_kw or {}))

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    return self.fn(deps[0], axis=self.axis, **self.fn_kw)


def reduce(v, op=None, axis=None, keepdims=False, out_dtype=None,
           ddof: int = 0, dtype_fn=None, local_reduce_fn=None,
           accumulate_fn=None, fn_kw=None) -> Expr:
  """A named reduction (``op``: one of ``_OPS``) or, in the reference's
  extensible form, ``local_reduce_fn(x, axis=..., **fn_kw)`` over the
  whole input.  ``dtype_fn`` and ``accumulate_fn`` are accepted as the
  reference accepts them: there is no per-tile merge, so the function
  must give the whole reduction itself."""
  # ``v`` is the one input: an array, tensor or list is not a list of
  # inputs (the reference reduces such a ``v``'s first element alone)
  if local_reduce_fn is not None:
    del accumulate_fn, dtype_fn
    return CustomReduceExpr([v], fn=local_reduce_fn, axis=axis, fn_kw=fn_kw)
  if not isinstance(op, str):
    raise TypeError("reduce needs op=<str> or local_reduce_fn=<callable>")
  return ReduceExpr([v], op=op, axis=axis, keepdims=keepdims,
                    out_dtype=out_dtype, ddof=ddof)
