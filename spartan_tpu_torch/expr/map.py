"""Elementwise / broadcast map (port of ``spartan_tpu/expr/map.py``).

A map applies a fused ``LocalExpr`` kernel to whole tensors on the mesh's
device; torch broadcasting is NumPy broadcasting.

torch and NumPy promote differently: torch gives int32 + float32 →
float32 and int / int → the default float (float32), where NumPy gives
float64 in both.  ``map2`` therefore casts strong operands to
``np.result_type`` explicitly (as the reference's ``_numpy_promoting``
does against jax's lattice), and the float-valued unary ufuncs lift
integer input to float64.  Python scalars stay weak: ``f32 * 2.0`` is
float32, while a float scalar against an integer tensor gives float64.
"""

from __future__ import annotations

import builtins as _py
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from spartan_tpu_torch.core.array import dtype_kind, to_numpy_dtype, to_torch_dtype
from spartan_tpu_torch.expr.base import EmitCtx, Expr, lazify
from spartan_tpu_torch.expr.local import FnCallExpr, LocalExpr, LocalInput


class MapExpr(Expr):
  """Apply a fused local kernel elementwise over N inputs."""

  _members = ("inputs",)
  _params = ("op",)  # a LocalExpr tree

  def __init__(self, inputs: Sequence[Expr], op: LocalExpr):
    super().__init__(inputs=list(inputs), op=op)

  def _emit(self, ctx: EmitCtx, deps: List):
    return self.op.evaluate(deps)

  def _sig_local(self, memo, result):
    return ("MapExpr", self.op.signature(),
            tuple(self._child_sig(c, memo, result) for c in self.inputs))


def map(inputs, fn: Callable, fn_kw=None) -> MapExpr:
  """Lazy elementwise map: ``fn(*inputs)`` over torch tensors (or weak
  Python scalars) with broadcasting."""
  if isinstance(inputs, Expr) or not isinstance(inputs, (list, tuple)):
    inputs = [inputs]
  exprs = [lazify(v) for v in inputs]
  op = FnCallExpr(fn, [LocalInput(i) for i in range(len(exprs))], fn_kw)
  return MapExpr(inputs=exprs, op=op)


def map1(a, fn: Callable, **kw) -> MapExpr:
  return map([a], fn, fn_kw=kw or None)


def result_type(a: torch.dtype, b: torch.dtype) -> torch.dtype:
  """NumPy's promotion of two strong dtypes (torch's for bfloat16, which
  NumPy lacks)."""
  if torch.bfloat16 in (a, b):
    return torch.promote_types(a, b)
  return to_torch_dtype(np.result_type(to_numpy_dtype(a), to_numpy_dtype(b)))


def _numpy_promoting(fn: Callable) -> Callable:
  """Wrap a binary op so operands promote by NumPy's rules."""
  name = getattr(fn, "__name__", "")
  int_div = name in ("true_divide", "divide")

  def wrapped(x, y):
    xt, yt = isinstance(x, torch.Tensor), isinstance(y, torch.Tensor)
    if xt and yt:
      dt = result_type(x.dtype, y.dtype)
      if int_div and dtype_kind(dt) in "biu":
        dt = torch.float64  # numpy: int / int → float64
      return fn(x.to(dt), y.to(dt))
    if xt or yt:
      t, s = (x, y) if xt else (y, x)
      kind = dtype_kind(t.dtype)
      if kind in "biu" and (isinstance(s, float) or int_div):
        t = t.to(torch.float64)  # weak float against ints → default float
      x, y = (t, s) if xt else (s, t)
    return fn(x, y)

  wrapped.__name__ = name or "binary"
  wrapped.__qualname__ = f"np_promoting_{name}"
  return wrapped


_PROMOTING_CACHE: Dict[Callable, Callable] = {}


def map2(a, b, fn: Callable) -> MapExpr:
  """Binary map with NumPy promotion semantics; scalar operands stay
  inline as weak-typed leaf values."""
  wrapped = _PROMOTING_CACHE.get(fn)
  if wrapped is None:
    wrapped = _numpy_promoting(fn)
    _PROMOTING_CACHE[fn] = wrapped
  return map([a, b], wrapped)


# -- the elementwise ufuncs of the slice, named after NumPy's ---------------

def _inexact(x):
  """NumPy's input lifting for float-valued ufuncs: ints → float64."""
  if not isinstance(x, torch.Tensor):
    return torch.tensor(x, dtype=torch.complex128 if isinstance(x, complex)
                        else torch.float64)
  if dtype_kind(x.dtype) in "biu":
    return x.to(torch.float64)
  return x


def add(x, y):
  return x + y


def subtract(x, y):
  return x - y


def multiply(x, y):
  return x * y


def true_divide(x, y):
  return x / y


def maximum(x, y):
  if isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor):
    return torch.maximum(x, y)
  if isinstance(x, torch.Tensor):
    return torch.clamp(x, min=y)
  if isinstance(y, torch.Tensor):
    return torch.clamp(y, min=x)
  return _py.max(x, y)


def minimum(x, y):
  if isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor):
    return torch.minimum(x, y)
  if isinstance(x, torch.Tensor):
    return torch.clamp(x, max=y)
  if isinstance(y, torch.Tensor):
    return torch.clamp(y, max=x)
  return _py.min(x, y)


def less(x, y):
  return x < y


def less_equal(x, y):
  return x <= y


def greater(x, y):
  return x > y


def greater_equal(x, y):
  return x >= y


def negative(x):
  return -x


def absolute(x):
  return _py.abs(x)


def square(x):
  return x * x


def sqrt(x):
  return torch.sqrt(_inexact(x))


def exp(x):
  return torch.exp(_inexact(x))


def log(x):
  return torch.log(_inexact(x))


# the comparisons give bool and are outside the fused-reduce kernel's op
# table (backend/kernels/fused_reduce.OPS), so its translator refuses them
BINARY = {f.__name__: f for f in (add, subtract, multiply, true_divide,
                                  maximum, minimum, less, less_equal,
                                  greater, greater_equal)}
UNARY = {f.__name__: f for f in (negative, absolute, square, sqrt, exp, log)}

# what map kernels actually hold: binary ops wrapped for NumPy promotion
UFUNCS: Dict[str, Callable] = dict(UNARY)
UFUNCS.update({name: _numpy_promoting(f) for name, f in BINARY.items()})
_PROMOTING_CACHE.update({f: UFUNCS[name] for name, f in BINARY.items()})
