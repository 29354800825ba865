"""The slice's part of the NumPy-compatible builtins
(port of ``spartan_tpu/expr/builtins.py``).

Thin lazy constructors: creation ops become :class:`CreationExpr` (folded
into fused regions), elementwise math becomes map kernels over the
NumPy-named torch ufuncs of ``expr/map.py``, reductions carry the
reference's float64-accumulation semantics.  Only what configs 1–3 and
the examples of this slice call is here; the rest of the reference surface
arrives with later slices.
"""

from __future__ import annotations

import builtins as _py
from typing import Sequence

import numpy as np

import spartan_tpu_torch.expr.dot as dot_mod
import spartan_tpu_torch.expr.reduce as reduce_mod
from spartan_tpu_torch.core.array import from_numpy as _from_numpy_arr
from spartan_tpu_torch.core.array import to_torch_dtype
from spartan_tpu_torch.expr import map as map_mod
from spartan_tpu_torch.expr.base import Expr, Val, lazify
from spartan_tpu_torch.expr.map import map, map1, map2
from spartan_tpu_torch.expr.ndarray import (CreationExpr, _next_seed,
                                            set_random_seed)
from spartan_tpu_torch.expr.reshape import (RavelExpr, ReshapeExpr,
                                            TransposeExpr)
from spartan_tpu_torch.expr.stencil import avgpool, maxpool, stencil

_DEFAULT_FLOAT = np.float64


# -- creation ---------------------------------------------------------------

def _tuplify(shape) -> tuple:
  if isinstance(shape, (int, np.integer)):
    return (int(shape),)
  return tuple(int(s) for s in shape)


def zeros(shape, dtype=_DEFAULT_FLOAT, tile_hint=None) -> Expr:
  return CreationExpr("full", _tuplify(shape), dtype, {"fill": 0}, tile_hint)


def ones(shape, dtype=_DEFAULT_FLOAT, tile_hint=None) -> Expr:
  return CreationExpr("full", _tuplify(shape), dtype, {"fill": 1}, tile_hint)


def full(shape, fill_value, dtype=None, tile_hint=None) -> Expr:
  if dtype is None:
    dtype = np.asarray(fill_value).dtype
  return CreationExpr("full", _tuplify(shape), dtype, {"fill": fill_value},
                      tile_hint)


def arange(start, stop=None, step=1, dtype=None, tile_hint=None) -> Expr:
  if stop is None:
    start, stop = 0, start
  n = _py.max(0, int(np.ceil((stop - start) / step)))
  if dtype is None:
    dtype = np.arange(start, stop, step).dtype if n else np.int64
  return CreationExpr("arange", (n,), dtype,
                      {"start": start, "stop": stop, "step": step}, tile_hint)


def rand(*shape, tile_hint=None) -> Expr:
  return CreationExpr("rand", shape, _DEFAULT_FLOAT, {"seed": _next_seed()},
                      tile_hint)


def randn(*shape, tile_hint=None) -> Expr:
  return CreationExpr("randn", shape, _DEFAULT_FLOAT, {"seed": _next_seed()},
                      tile_hint)


def from_numpy(arr, tile_hint=None) -> Expr:
  """Copy host data onto the mesh's device as a leaf."""
  return Val(_from_numpy_arr(np.asarray(arr), tile_hint))


# -- elementwise math (the fused-reduce kernel's op table) -------------------

def _unary(name):
  fn = map_mod.UNARY[name]

  def op(v):
    return map1(lazify(v), fn)
  op.__name__ = name
  op.__doc__ = f"Lazy elementwise {name}."
  return op


def _binary(name):
  fn = map_mod.BINARY[name]

  def op(a, b):
    return map2(a, b, fn)
  op.__name__ = name
  op.__doc__ = f"Lazy elementwise {name} with NumPy promotion."
  return op


negative = _unary("negative")
abs = _unary("absolute")
absolute = abs
square = _unary("square")
sqrt = _unary("sqrt")
exp = _unary("exp")
log = _unary("log")
add = _binary("add")
subtract = _binary("subtract")
multiply = _binary("multiply")
divide = _binary("true_divide")
true_divide = divide
maximum = _binary("maximum")
minimum = _binary("minimum")


def _astype_fn(x, dtype):
  return x.to(dtype)


def astype(v, dtype) -> Expr:
  return map([lazify(v)], _astype_fn, fn_kw={"dtype": to_torch_dtype(dtype)})


# -- reductions -------------------------------------------------------------

def sum(v, axis=None, keepdims=False, dtype=None) -> Expr:
  return reduce_mod.reduce(v, "sum", axis=axis, keepdims=keepdims,
                           out_dtype=dtype)


def mean(v, axis=None, keepdims=False, dtype=None) -> Expr:
  return reduce_mod.reduce(v, "mean", axis=axis, keepdims=keepdims,
                           out_dtype=dtype)


def max(v, axis=None, keepdims=False) -> Expr:
  return reduce_mod.reduce(v, "max", axis=axis, keepdims=keepdims)


def min(v, axis=None, keepdims=False) -> Expr:
  return reduce_mod.reduce(v, "min", axis=axis, keepdims=keepdims)


def argmax(v, axis=None, keepdims=False) -> Expr:
  return reduce_mod.reduce(v, "argmax", axis=axis, keepdims=keepdims)


def argmin(v, axis=None, keepdims=False) -> Expr:
  return reduce_mod.reduce(v, "argmin", axis=axis, keepdims=keepdims)


# -- linear algebra and shape ------------------------------------------------

def dot(a, b, precision=None) -> Expr:
  return dot_mod.dot(a, b, precision=precision)


def transpose(v, axes: Sequence[int] = None) -> Expr:
  return TransposeExpr(lazify(v), axes)


def reshape(v, shape) -> Expr:
  return ReshapeExpr(lazify(v), _tuplify(shape))


def ravel(v) -> Expr:
  return RavelExpr(lazify(v))


flatten = ravel


__all__ = [
    "zeros", "ones", "full", "arange", "rand", "randn", "from_numpy",
    "set_random_seed", "negative", "abs", "absolute", "square", "sqrt",
    "exp", "log", "add", "subtract", "multiply", "divide", "true_divide",
    "maximum", "minimum", "astype", "sum", "mean", "max", "min", "argmax",
    "argmin", "dot", "transpose", "reshape", "ravel", "flatten", "stencil",
    "maxpool", "avgpool",
]
