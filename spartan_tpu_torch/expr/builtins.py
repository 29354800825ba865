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
import functools
from typing import Sequence

import numpy as np
import torch

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
from spartan_tpu_torch.expr.shuffle import shuffle
from spartan_tpu_torch.expr.stencil import avgpool, maxpool, stencil
from spartan_tpu_torch.expr.write import assign, write

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
less = _binary("less")
less_equal = _binary("less_equal")
greater = _binary("greater")
greater_equal = _binary("greater_equal")
floor_divide = _binary("floor_divide")
remainder = _binary("remainder")
mod = remainder
fmod = _binary("fmod")
float_power = _binary("float_power")
equal = _binary("equal")
not_equal = _binary("not_equal")
bitwise_and = _binary("bitwise_and")
bitwise_or = _binary("bitwise_or")
bitwise_xor = _binary("bitwise_xor")
left_shift = _binary("left_shift")
right_shift = _binary("right_shift")
logical_and = _binary("logical_and")
logical_or = _binary("logical_or")
logical_xor = _binary("logical_xor")
bitwise_not = _unary("bitwise_not")
invert = bitwise_not
logical_not = _unary("logical_not")
isnan = _unary("isnan")
isinf = _unary("isinf")
isfinite = _unary("isfinite")
sign = _unary("sign")
reciprocal = _unary("reciprocal")
positive = _unary("positive")
conj = _unary("conj")
copy = _unary("copy")


def power(a, b) -> Expr:
  """Lazy elementwise power with NumPy promotion (``pow`` for every
  exponent; the operator ``**`` takes NumPy's scalar fast paths)."""
  map_mod.check_power(lazify(a), b)
  return map2(a, b, map_mod.BINARY["power"])


def _round_fn(x, decimals):
  return map_mod.round(x, decimals=decimals)


def round(v, decimals=0) -> Expr:
  """NumPy's ``round``: half to even, at ``decimals`` places."""
  return map([lazify(v)], _round_fn, fn_kw={"decimals": int(decimals)})


around = round


def clip(v, a_min=None, a_max=None) -> Expr:
  """``minimum(maximum(v, a_min), a_max)`` with NumPy promotion; either
  bound may be None, not both."""
  if a_min is None and a_max is None:
    raise ValueError("One of max or min must be given")
  out = lazify(v)
  if a_min is not None:
    out = maximum(out, a_min)
  if a_max is not None:
    out = minimum(out, a_max)
  return out


def _where_fn(cond, x, y):
  x, y = map_mod.promote(x, y)
  if not isinstance(cond, torch.Tensor):
    cond = torch.tensor(bool(cond))
  ref = next(v for v in (x, y, cond) if isinstance(v, torch.Tensor))
  device = ref.device
  return torch.where(cond.to(device).bool(), map_mod._lift(x, device),
                     map_mod._lift(y, device))


def _nonzero_part(i, x):
  return np.nonzero(x)[i]


def where(cond, a=None, b=None):
  """``a`` where ``cond`` holds, else ``b``, with NumPy promotion of the
  two; with ``cond`` alone, NumPy's ``nonzero`` (a tuple of host index
  arrays, each a ``HostExpr``)."""
  if a is None and b is None:
    from spartan_tpu_torch.expr.fio import HostExpr
    v = lazify(cond)
    return tuple(HostExpr([v], functools.partial(_nonzero_part, i))
                 for i in _py.range(_py.max(v.ndim, 1)))
  if a is None or b is None:
    raise ValueError("either both or neither of x and y should be given")
  return map([lazify(cond), lazify(a), lazify(b)], _where_fn)


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


def prod(v, axis=None, keepdims=False, dtype=None) -> Expr:
  return reduce_mod.reduce(v, "prod", axis=axis, keepdims=keepdims,
                           out_dtype=dtype)


def std(v, axis=None, ddof=0) -> Expr:
  return reduce_mod.reduce(v, "std", axis=axis, ddof=ddof)


def var(v, axis=None, ddof=0) -> Expr:
  return reduce_mod.reduce(v, "var", axis=axis, ddof=ddof)


def all(v, axis=None) -> Expr:
  return reduce_mod.reduce(v, "all", axis=axis)


def any(v, axis=None) -> Expr:
  return reduce_mod.reduce(v, "any", axis=axis)


def count_nonzero(v, axis=None) -> Expr:
  return reduce_mod.reduce(v, "count_nonzero", axis=axis)


def nansum(v, axis=None) -> Expr:
  return reduce_mod.reduce(v, "nansum", axis=axis)


def nanmax(v, axis=None) -> Expr:
  return reduce_mod.reduce(v, "nanmax", axis=axis)


def nanmin(v, axis=None) -> Expr:
  return reduce_mod.reduce(v, "nanmin", axis=axis)


def nanmean(v, axis=None) -> Expr:
  """The mean of the values that are not NaN, composed as the reference
  composes it."""
  v = lazify(v)
  cnt = sum(astype(logical_not(isnan(v)), np.float64), axis=axis)
  return nansum(v, axis=axis) / cnt


def nanvar(v, axis=None, ddof: int = 0) -> Expr:
  v = lazify(v)
  mu = nanmean(v, axis=axis)
  if axis is not None:
    mu = expand_dims(mu, axis)
  cnt = sum(astype(logical_not(isnan(v)), np.float64), axis=axis)
  return nansum((v - mu) ** 2, axis=axis) / (cnt - ddof)


def nanstd(v, axis=None, ddof: int = 0) -> Expr:
  return sqrt(nanvar(v, axis=axis, ddof=ddof))


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


def _expand_dims_fn(x, axis):
  axes = (axis,) if isinstance(axis, int) else tuple(axis)
  ndim = x.ndim + len(axes)
  for a in sorted(a % ndim for a in axes):
    x = x.unsqueeze(a)
  return x


def outer(a, b) -> Expr:
  return dot_mod.outer(a, b)


def swapaxes(v, a, b) -> Expr:
  v = lazify(v)
  axes = list(_py.range(v.ndim))
  axes[a], axes[b] = axes[b], axes[a]
  return TransposeExpr(v, axes)


def _squeeze_fn(x, axis):
  return x.squeeze() if axis is None else x.squeeze(axis)


def squeeze(v, axis=None) -> Expr:
  """NumPy's ``squeeze``: an axis given must have length 1."""
  v = lazify(v)
  if axis is not None:
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    for a in axes:
      if v.shape[a] != 1:
        raise ValueError("cannot select an axis to squeeze out which has "
                         "size not equal to one")
    axis = tuple(a % v.ndim for a in axes)
  return map([v], _squeeze_fn, fn_kw={"axis": axis})


def _repeat_fn(x, repeats, axis):
  if axis is None:
    return torch.repeat_interleave(x.reshape(-1), repeats)
  return torch.repeat_interleave(x, repeats, dim=axis)


def repeat(v, repeats, axis=None) -> Expr:
  """NumPy's ``repeat`` with a Python int ``repeats`` (a count per element
  would give a shape that depends on the data)."""
  return map([lazify(v)], _repeat_fn,
             fn_kw={"repeats": int(repeats), "axis": axis})


def _take_fn(x, idx, axis):
  if axis is None:
    x, axis = x.reshape(-1), 0
  from spartan_tpu_torch.expr.slice import _clamped
  idx = _clamped(torch.as_tensor(idx, device=x.device), x.shape[axis])
  return x[(slice(None),) * (axis % x.ndim) + (idx,)]


def take(v, indices, axis=None) -> Expr:
  """NumPy's ``take``: a concrete index out of bounds raises
  ``IndexError`` when the expr is built; an index that is an expr is
  clamped, as a gather's is."""
  v = lazify(v)
  if isinstance(indices, (np.ndarray, list, int, np.integer)):
    ia = np.asarray(indices)
    n = v.size if axis is None else v.shape[axis]
    lo, hi = (int(ia.min()), int(ia.max())) if ia.size else (0, 0)
    if lo < -n or hi >= n:
      raise IndexError(f"index {hi if hi >= n else lo} is out of bounds "
                       f"for size {n}")
  return map([v, lazify(indices)], _take_fn, fn_kw={"axis": axis})


def _diagonal_fn(x, offset):
  return torch.diagonal(x, offset=offset, dim1=0, dim2=1)


def diagonal(v, offset=0) -> Expr:
  return map([lazify(v)], _diagonal_fn, fn_kw={"offset": int(offset)})


def trace(v, offset=0) -> Expr:
  return sum(diagonal(v, offset))


def expand_dims(v, axis) -> Expr:
  """NumPy's ``expand_dims``: new unit axes at ``axis`` (an int or a
  tuple) of the result."""
  return map([lazify(v)], _expand_dims_fn, fn_kw={"axis": axis})


__all__ = [
    "zeros", "ones", "full", "arange", "rand", "randn", "from_numpy",
    "set_random_seed", "negative", "abs", "absolute", "square", "sqrt",
    "exp", "log", "add", "subtract", "multiply", "divide", "true_divide",
    "maximum", "minimum", "less", "less_equal", "greater", "greater_equal",
    "astype", "sum", "mean", "max", "min", "argmax", "argmin", "dot",
    "transpose", "reshape", "ravel", "flatten", "expand_dims", "stencil",
    "maxpool", "avgpool", "shuffle",
    # the core expression surface
    "floor_divide", "mod", "remainder", "fmod", "power", "float_power",
    "equal", "not_equal", "bitwise_and", "bitwise_or", "bitwise_xor",
    "bitwise_not", "invert", "left_shift", "right_shift", "logical_and",
    "logical_or", "logical_xor", "logical_not", "isnan", "isinf",
    "isfinite", "sign", "reciprocal", "positive", "where", "clip", "round",
    "around", "prod", "std", "var", "all", "any", "count_nonzero",
    "nansum", "nanmean", "nanvar", "nanstd", "nanmax", "nanmin", "take",
    "write", "assign", "squeeze", "swapaxes", "diagonal", "trace", "repeat",
    "copy", "conj", "outer",
]
