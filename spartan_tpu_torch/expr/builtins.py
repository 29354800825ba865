"""The NumPy-compatible builtins ported so far
(port of ``spartan_tpu/expr/builtins.py``).

Thin lazy constructors: creation ops become :class:`CreationExpr` (folded
into fused regions), elementwise math becomes map kernels over the
NumPy-named torch ufuncs of ``expr/map.py``, reductions carry the
reference's float64-accumulation semantics, and the selections whose
length depends on the data are ``SelectExpr`` nodes, evaluated on the
device before the region that reads them.  The names still missing are
pinned in ``tests/test_torch_coverage.py``.
"""

from __future__ import annotations

import builtins as _py
import collections
import functools
from typing import Sequence

import numpy as np
import torch

import spartan_tpu_torch.expr.dot as dot_mod
import spartan_tpu_torch.expr.reduce as reduce_mod
from spartan_tpu_torch.core.array import from_numpy as _from_numpy_arr
from spartan_tpu_torch.core.array import SpartanArray, dtype_kind, to_torch_dtype
from spartan_tpu_torch.expr import map as map_mod
from spartan_tpu_torch.expr.base import Expr, Val, lazify
from spartan_tpu_torch.expr.map import map, map1, map2, map_with_location
from spartan_tpu_torch.expr.ndarray import (CreationExpr, _next_seed,
                                            set_random_seed)
from spartan_tpu_torch.expr.reshape import (RavelExpr, ReshapeExpr,
                                            TransposeExpr)
from spartan_tpu_torch.expr.shuffle import shuffle
from spartan_tpu_torch.expr.slice import SelectExpr
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


# -- the float ufuncs (K1's and K2's rare ops among them) ------------------

sin = _unary("sin")
cos = _unary("cos")
tan = _unary("tan")
arcsin = asin = _unary("arcsin")
arccos = acos = _unary("arccos")
arctan = atan = _unary("arctan")
sinh = _unary("sinh")
cosh = _unary("cosh")
tanh = _unary("tanh")
arcsinh = asinh = _unary("arcsinh")
arccosh = acosh = _unary("arccosh")
arctanh = atanh = _unary("arctanh")
floor = _unary("floor")
ceil = _unary("ceil")
trunc = _unary("trunc")
fix = _unary("fix")
rint = _unary("rint")
exp2 = _unary("exp2")
expm1 = _unary("expm1")
log2 = _unary("log2")
log10 = _unary("log10")
log1p = _unary("log1p")
cbrt = _unary("cbrt")
fabs = _unary("fabs")
degrees = _unary("degrees")
radians = _unary("radians")
rad2deg = _unary("rad2deg")
deg2rad = _unary("deg2rad")
signbit = _unary("signbit")
spacing = _unary("spacing")
erf = _unary("erf")
erfc = _unary("erfc")
i0 = _unary("i0")
sinc = _unary("sinc")
bitwise_count = _unary("bitwise_count")
angle = _unary("angle")
real = _unary("real")
imag = _unary("imag")
iscomplex = _unary("iscomplex")
isreal = _unary("isreal")
isneginf = _unary("isneginf")
isposinf = _unary("isposinf")
conjugate = conj
arctan2 = atan2 = _binary("arctan2")
hypot = _binary("hypot")
copysign = _binary("copysign")
nextafter = _binary("nextafter")
heaviside = _binary("heaviside")
logaddexp = _binary("logaddexp")
logaddexp2 = _binary("logaddexp2")
fmax = _binary("fmax")
fmin = _binary("fmin")
gcd = _binary("gcd")
lcm = _binary("lcm")
pow = power  # noqa: A001 (NumPy shadows the builtin the same way)
bitwise_invert = bitwise_not
bitwise_left_shift = left_shift
bitwise_right_shift = right_shift


def ldexp(a, b) -> Expr:
  """``a * 2**b`` with an integer ``b`` (NumPy's ``ldexp``)."""
  if isinstance(b, float) or (isinstance(b, Expr)
                              and dtype_kind(b.dtype) not in "biu"):
    raise TypeError("ufunc 'ldexp' needs an integer exponent")
  return map([lazify(a), lazify(b)], map_mod.ldexp)


def nan_to_num(v, nan=0.0, posinf=None, neginf=None) -> Expr:
  return map([lazify(v)], map_mod.nan_to_num,
             fn_kw={"nan": nan, "posinf": posinf, "neginf": neginf})


def isclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False) -> Expr:
  return map([lazify(a), lazify(b)], map_mod.isclose,
             fn_kw={"rtol": rtol, "atol": atol, "equal_nan": equal_nan})


def modf(v):
  """``(fractional, integral)`` parts, each with the sign of ``v``."""
  v = lazify(v)
  return (map1(v, map_mod.modf_fraction), map1(v, map_mod.modf_integral))


def frexp(v):
  """``(mantissa, exponent)``, the exponent as int32."""
  v = lazify(v)
  return (map1(v, map_mod.frexp_mantissa), map1(v, map_mod.frexp_exponent))


def divmod(a, b):  # noqa: A001 (NumPy shadows the builtin the same way)
  return (floor_divide(a, b), remainder(a, b))


# -- eager predicates (Python values, as NumPy returns them) -----------------

def _pair(a, b):
  """Both evaluated, as tensors on one device in NumPy's common dtype."""
  x, y = lazify(a).evaluate().data, lazify(b).evaluate().data
  dt = map_mod.result_type(x.dtype, y.dtype)
  return x.to(dt), y.to(x.device, dt)


def allclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False) -> bool:
  x, y = _pair(a, b)
  return bool(map_mod.isclose(x, y, rtol, atol, equal_nan).all())


def array_equal(a, b, equal_nan=False) -> bool:
  x, y = _pair(a, b)
  if x.shape != y.shape:
    return False
  same = x == y
  if equal_nan and (x.is_floating_point() or x.is_complex()):
    same = same | (torch.isnan(x) & torch.isnan(y))
  return bool(same.all())


def array_equiv(a, b) -> bool:
  x, y = _pair(a, b)
  try:
    x, y = torch.broadcast_tensors(x, y)
  except RuntimeError:
    return False
  return bool((x == y).all())


def iscomplexobj(v) -> bool:
  return lazify(v).dtype.is_complex


def isrealobj(v) -> bool:
  return not lazify(v).dtype.is_complex


def real_if_close(v, tol: float = 100.0) -> Expr:
  """The real part where every imaginary part is within ``tol`` machine
  epsilons of 0 (a result dtype that depends on the data: eager)."""
  arr = lazify(v).evaluate()
  x = arr.data
  if not x.is_complex():
    return Val(arr)
  eps = torch.finfo(x.real.dtype).eps
  cut = tol * eps if tol > 1 else tol
  if bool((x.imag.abs() < cut).all()):
    return Val(SpartanArray(x.real.clone(), arr.tiling))
  return Val(arr)


def asarray_chkfinite(v, dtype=None) -> Expr:
  """``v`` as an array, raising ``ValueError`` if it holds inf or nan."""
  arr = lazify(v).evaluate()
  x = arr.data
  if (x.is_floating_point() or x.is_complex()) and not bool(
      torch.isfinite(x).all()):
    raise ValueError("array must not contain infs or NaNs")
  out = Val(arr)
  return astype(out, dtype) if dtype is not None else out


# -- constructors --------------------------------------------------------------

def empty(shape, dtype=_DEFAULT_FLOAT, tile_hint=None) -> Expr:
  """Zeros: a lazy array is always defined (the reference's ``empty``)."""
  return zeros(shape, dtype, tile_hint)


def ndarray(shape, dtype=_DEFAULT_FLOAT, tile_hint=None, reducer=None) -> Expr:
  """A lazily allocated zeroed array; ``reducer`` is accepted for the
  reference's API and unused."""
  del reducer
  return zeros(shape, dtype, tile_hint)


def zeros_like(v, dtype=None) -> Expr:
  v = lazify(v)
  return zeros(v.shape, v.dtype if dtype is None else dtype)


empty_like = zeros_like


def ones_like(v, dtype=None) -> Expr:
  v = lazify(v)
  return ones(v.shape, v.dtype if dtype is None else dtype)


def full_like(v, fill_value, dtype=None) -> Expr:
  v = lazify(v)
  return full(v.shape, fill_value, v.dtype if dtype is None else dtype)


def eye(n, m=None, k=0, dtype=_DEFAULT_FLOAT, tile_hint=None) -> Expr:
  m = n if m is None else m
  return CreationExpr("eye", (int(n), int(m)), dtype, {"k": int(k)},
                      tile_hint)


def identity(n, dtype=_DEFAULT_FLOAT) -> Expr:
  return eye(n, dtype=dtype)


def tri(N, M=None, k=0, dtype=_DEFAULT_FLOAT) -> Expr:
  M = N if M is None else M
  return CreationExpr("tri", (int(N), int(M)), dtype, {"k": int(k)})


def linspace(start, stop, num=50, dtype=_DEFAULT_FLOAT) -> Expr:
  """NumPy's values (float64, the last one ``stop``), cast to ``dtype``."""
  return CreationExpr("linspace", (int(num),), dtype,
                      {"start": float(start), "stop": float(stop)})


def logspace(start, stop, num=50, base=10.0, dtype=None) -> Expr:
  return astype(power(float(base), linspace(start, stop, num)),
                np.float64 if dtype is None else dtype)


def _geomspace_fn(x, start, stop):
  out = x.clone()
  if out.numel():
    out[0] = start
  if out.numel() > 1:
    out[-1] = stop
  return out


def geomspace(start, stop, num=50, dtype=None) -> Expr:
  """NumPy's ``geomspace`` of real endpoints of one sign: ``logspace`` of
  their log10s, the endpoints exact."""
  if start == 0 or stop == 0:
    raise ValueError("Geometric sequence cannot include zero")
  sign = -1.0 if (start < 0 and stop < 0) else 1.0
  if start * stop < 0:
    raise ValueError("geomspace of endpoints of two signs needs complex "
                     "output, which is not ported")
  lo, hi = np.log10(sign * start), np.log10(sign * stop)
  out = logspace(lo, hi, num) * sign
  out = map([out], _geomspace_fn,
            fn_kw={"start": float(start), "stop": float(stop)})
  return astype(out, np.float64 if dtype is None else dtype)


def _window(name):
  def op(M):
    return CreationExpr("window", (_py.max(int(M), 0),), _DEFAULT_FLOAT,
                        {"name": name})
  op.__name__ = name
  op.__doc__ = f"Lazy {name} window of length M (numpy.{name})."
  return op


bartlett = _window("bartlett")
blackman = _window("blackman")
hamming = _window("hamming")
hanning = _window("hanning")


def kaiser(M, beta) -> Expr:
  return CreationExpr("window", (_py.max(int(M), 0),), _DEFAULT_FLOAT,
                      {"name": "kaiser", "beta": float(beta)})


def randint(low, high=None, size=(), dtype=np.int64, tile_hint=None) -> Expr:
  """Uniform integers in ``[low, high)`` from the port's own stream
  (torch's generator; not ``jax.random``'s)."""
  if high is None:
    low, high = 0, low
  return CreationExpr("randint", _tuplify(size), dtype,
                      {"low": int(low), "high": int(high),
                       "seed": _next_seed()}, tile_hint)


def asarray(v, dtype=None) -> Expr:
  """``numpy.asarray``: host data as a leaf, an expr as itself."""
  out = lazify(v)
  return astype(out, dtype) if dtype is not None else out


array = asarray
as_array = from_numpy


def _indices_fn(x, dims):
  grids = torch.meshgrid(*[torch.arange(n, dtype=x.dtype, device=x.device)
                           for n in dims], indexing="ij")
  return torch.stack(grids) if grids else x.reshape((0,))


def indices(dimensions, dtype=np.int64) -> Expr:
  dims = _tuplify(dimensions)
  return map([zeros((), dtype)], _indices_fn, fn_kw={"dims": dims})


def fromfunction(fn, shape, **kw) -> Expr:
  """NumPy's ``fromfunction``: ``fn`` over host index arrays (its
  contract), the result a leaf on the device."""
  return from_numpy(np.fromfunction(fn, _tuplify(shape), **kw))


def fromiter(iterable, dtype, count=-1) -> Expr:
  return from_numpy(np.fromiter(iterable, dtype, count=count))


def from_dlpack(x) -> Expr:
  return Val(torch.from_dlpack(x))


def _meshgrid_fn(*xs, i, indexing):
  axes = list(_py.range(len(xs)))  # the axis along which coordinate k runs
  if indexing == "xy" and len(xs) > 1:
    axes[0], axes[1] = 1, 0
  shape = [0] * len(xs)
  for k, ax in enumerate(axes):
    shape[ax] = xs[k].numel()
  view = [1] * len(xs)
  view[axes[i]] = xs[i].numel()
  return xs[i].reshape(view).expand(shape).contiguous()


def meshgrid(*coords, indexing="xy"):
  """NumPy's ``meshgrid`` (copies, ``xy`` or ``ij``): a list of lazy
  grids, each one map over the coordinate vectors."""
  if indexing not in ("xy", "ij"):
    raise ValueError("Valid values for `indexing` are 'xy' and 'ij'.")
  xs = [lazify(c) for c in coords]
  return [map(xs, _meshgrid_fn, fn_kw={"i": i, "indexing": indexing})
          for i in _py.range(len(xs))]


def ix_(*seqs):
  """Open-mesh index arrays (``numpy.ix_``) of 1-D index exprs."""
  n = len(seqs)
  out = []
  for i, seq in enumerate(seqs):
    v = lazify(seq)
    if v.ndim != 1:
      raise ValueError("Cross index must be 1 dimensional")
    shape = [1] * n
    shape[i] = int(v.shape[0])
    out.append(reshape(v, tuple(shape)))
  return tuple(out)


def diag_indices(n, ndim=2):
  return tuple(arange(int(n)) for _ in _py.range(int(ndim)))


def diag_indices_from(v):
  v = lazify(v)
  if v.ndim < 2 or len(set(v.shape)) != 1:
    raise ValueError("input array must be square (all dimensions equal)")
  return diag_indices(int(v.shape[0]), v.ndim)


def _tri_indices(fn, n, k, m):
  m = n if m is None else m
  rows, cols = np.nonzero(fn(np.ones((int(n), int(m)), dtype=bool), int(k)))
  return from_numpy(rows.astype(np.int64)), from_numpy(cols.astype(np.int64))


def tril_indices(n, k=0, m=None):
  return _tri_indices(np.tril, n, k, m)


def triu_indices(n, k=0, m=None):
  return _tri_indices(np.triu, n, k, m)


def tril_indices_from(v, k=0):
  v = lazify(v)
  if v.ndim != 2:
    raise ValueError("input array must be 2-d")
  return tril_indices(int(v.shape[0]), k, int(v.shape[1]))


def triu_indices_from(v, k=0):
  v = lazify(v)
  if v.ndim != 2:
    raise ValueError("input array must be 2-d")
  return triu_indices(int(v.shape[0]), k, int(v.shape[1]))


def mask_indices(n, mask_func, k=0):
  return tuple(from_numpy(i) for i in np.mask_indices(int(n), mask_func, k))


def _unravel_fn(x, shape, d):
  stride = int(np.prod(shape[d + 1:], dtype=np.int64))
  return torch.div(x.to(torch.int64), stride,
                   rounding_mode="floor") % shape[d]


def unravel_index(indices, shape):
  """A tuple of coordinate exprs (int64).  Concrete indices out of range
  raise ``ValueError`` as NumPy's do."""
  shape = _tuplify(shape)
  if isinstance(indices, (int, np.integer, list, np.ndarray)):
    ia = np.asarray(indices)
    size = int(np.prod(shape, dtype=np.int64))
    if ia.size and (ia.min() < 0 or ia.max() >= size):
      raise ValueError(f"index {int(ia.max())} is out of bounds for array "
                       f"with size {size}")
  v = lazify(indices)
  return tuple(map([v], _unravel_fn, fn_kw={"shape": shape, "d": d})
               for d in _py.range(len(shape)))


def _ravel_multi_fn(*idx, dims, mode):
  out = None
  for i, n in zip(idx, dims):
    i = i.to(torch.int64)
    i = i % n if mode == "wrap" else i.clamp(0, n - 1)
    out = i if out is None else out * n + i
  return out


def ravel_multi_index(multi_index, dims, mode="clip") -> Expr:
  """``numpy.ravel_multi_index`` with the reference's default ``clip``
  (``raise`` checks concrete indices when the expr is built, then
  clips)."""
  dims = _tuplify(dims)
  if mode == "raise":
    for i, n in zip(multi_index, dims):
      if isinstance(i, (int, np.integer, list, np.ndarray)):
        ia = np.asarray(i)
        if ia.size and (ia.min() < 0 or ia.max() >= n):
          raise ValueError("invalid entry in coordinates array")
    mode = "clip"
  return map([lazify(i) for i in multi_index], _ravel_multi_fn,
             fn_kw={"dims": dims, "mode": mode})


def broadcast_shapes(*shapes):
  return np.broadcast_shapes(*shapes)


# -- selection: the data-dependent lengths on the device (SelectExpr) --------

def _nonzero_fn(x):
  return torch.nonzero(x.reshape(1) if x.ndim == 0 else x).T.contiguous()


def nonzero(v) -> Expr:
  """The indices of the nonzero elements as one stacked ``(ndim, n)``
  int64 array (the reference's form; NumPy's tuple is its rows)."""
  return SelectExpr([lazify(v)], _nonzero_fn)


def _flatnonzero_fn(x):
  return torch.nonzero(x.reshape(-1)).reshape(-1)


def flatnonzero(v) -> Expr:
  return SelectExpr([lazify(v)], _flatnonzero_fn)


def _argwhere_fn(x):
  if x.ndim == 0:
    return torch.zeros((int(bool(x)), 0), dtype=torch.int64, device=x.device)
  return torch.nonzero(x)


def argwhere(v) -> Expr:
  return SelectExpr([lazify(v)], _argwhere_fn)


def _extract_fn(cond, x):
  return x.reshape(-1)[torch.nonzero(cond.reshape(-1)).reshape(-1)]


def extract(cond, v) -> Expr:
  return SelectExpr([lazify(cond), lazify(v)], _extract_fn)


def _compress_fn(cond, x, axis):
  if axis is None:
    x, axis = x.reshape(-1), 0
  c = cond.reshape(-1).to(torch.bool)
  n = x.shape[axis]
  if c.numel() > n:
    if bool(c[n:].any()):
      raise IndexError(f"index {n} is out of bounds for axis {axis} with "
                       f"size {n}")
    c = c[:n]
  return torch.index_select(x, axis, torch.nonzero(c).reshape(-1))


def compress(cond, v, axis=None) -> Expr:
  return SelectExpr([lazify(cond), lazify(v)], _compress_fn,
                    {"axis": axis})


def _choose_fn(i, *cs):
  dt = cs[0].dtype
  for c in cs[1:]:
    dt = map_mod.result_type(dt, c.dtype)
  i = i.to(torch.int64).clamp(0, len(cs) - 1)
  out = cs[-1].to(dt)
  for k in _py.range(len(cs) - 2, -1, -1):
    out = torch.where(i == k, cs[k].to(dt), out)
  return torch.broadcast_to(out, torch.broadcast_shapes(
      i.shape, *[c.shape for c in cs])).contiguous()


def choose(idx, choices) -> Expr:
  """``numpy.choose`` with the reference's ``mode='clip'``."""
  return map([lazify(idx)] + [lazify(c) for c in choices], _choose_fn)


def _select_fn(*xs, n, default):
  conds, choices = xs[:n], xs[n:]
  dt = choices[0].dtype
  for c in choices[1:]:
    dt = map_mod.result_type(dt, c.dtype)
  out = map_mod._lift(default, choices[0].device)
  out = out.to(map_mod.promote(choices[0].to(dt), default)[0].dtype)
  dt = out.dtype
  for c, ch in zip(reversed(conds), reversed(choices)):
    out = torch.where(c.to(torch.bool), ch.to(dt), out)
  shape = torch.broadcast_shapes(*[x.shape for x in xs])
  return torch.broadcast_to(out, shape).contiguous()


def select(condlist, choicelist, default=0) -> Expr:
  """``numpy.select``: the first choice whose condition holds, else
  ``default``."""
  if len(condlist) != len(choicelist):
    raise ValueError("list of cases must be same length as list of "
                     "conditions")
  ins = [lazify(c) for c in condlist] + [lazify(c) for c in choicelist]
  return map(ins, _select_fn, fn_kw={"n": len(condlist), "default": default})


def _resize_fn(x, new_shape):
  total = int(np.prod(new_shape, dtype=np.int64))
  flat = x.reshape(-1)
  if flat.numel() == 0:
    return torch.zeros(new_shape, dtype=x.dtype, device=x.device)
  reps = -(-total // flat.numel())
  return flat.repeat(reps)[:total].reshape(new_shape)


def resize(v, new_shape) -> Expr:
  """``numpy.resize``: the data repeated (or cut) to ``new_shape``."""
  return map([lazify(v)], _resize_fn, fn_kw={"new_shape": _tuplify(new_shape)})


def _unique_sorted(x, equal_nan: bool):
  """(values, inverse, counts, first index) of the flattened ``x`` in
  sorted order, NaNs last: merged into one where ``equal_nan``."""
  flat = x.reshape(-1)
  order = torch.sort(flat, stable=True).indices
  s = flat[order]
  new = torch.ones_like(s, dtype=torch.bool)
  if s.numel() > 1:
    same = s[1:] == s[:-1]
    if equal_nan and (s.is_floating_point() or s.is_complex()):
      same = same | (torch.isnan(s[1:]) & torch.isnan(s[:-1]))
    new[1:] = ~same
  group = torch.cumsum(new.to(torch.int64), 0) - 1
  values = s[new]
  inverse = torch.empty_like(group)
  inverse[order] = group
  counts = torch.bincount(group, minlength=values.numel())
  starts = torch.nonzero(new).reshape(-1)
  return values, inverse.reshape(x.shape), counts, order[starts]


def _unique_fn(x, part, equal_nan):
  return _unique_sorted(x, equal_nan)[part]


def unique(v) -> Expr:
  """NumPy's ``unique``: the sorted distinct values, NaNs merged into one
  (torch's keeps each NaN)."""
  return SelectExpr([lazify(v)], _unique_fn, {"part": 0, "equal_nan": True})


_UniqueCounts = collections.namedtuple("UniqueCountsResult",
                                       ["values", "counts"])
_UniqueInverse = collections.namedtuple("UniqueInverseResult",
                                        ["values", "inverse_indices"])
_UniqueAll = collections.namedtuple(
    "UniqueAllResult", ["values", "indices", "inverse_indices", "counts"])


def _unique_parts(v, parts):
  v = lazify(v)
  return [SelectExpr([v], _unique_fn, {"part": p, "equal_nan": False})
          for p in parts]


def unique_values(v) -> Expr:
  """The array API's ``unique_values``: NumPy's, NaNs kept apart."""
  return _unique_parts(v, (0,))[0]


def unique_counts(v):
  return _UniqueCounts(*_unique_parts(v, (0, 2)))


def unique_inverse(v):
  return _UniqueInverse(*_unique_parts(v, (0, 1)))


def unique_all(v):
  return _UniqueAll(*_unique_parts(v, (0, 3, 1, 2)))


def _in(x, test):
  return torch.isin(x, test.to(x.device))


def _setdiff_fn(a, b):
  u = _unique_sorted(a, True)[0]
  return u[~_in(u, b.reshape(-1))]


def _union_fn(a, b):
  dt = map_mod.result_type(a.dtype, b.dtype)
  return _unique_sorted(torch.cat([a.reshape(-1).to(dt),
                                   b.reshape(-1).to(dt)]), True)[0]


def _intersect_fn(a, b):
  dt = map_mod.result_type(a.dtype, b.dtype)
  ua = _unique_sorted(a.to(dt), True)[0]
  ub = _unique_sorted(b.to(dt), True)[0]
  aux = torch.sort(torch.cat([ua, ub]), stable=True).values
  return aux[:-1][aux[1:] == aux[:-1]]


def _setxor_fn(a, b):
  dt = map_mod.result_type(a.dtype, b.dtype)
  ua = _unique_sorted(a.to(dt), True)[0]
  ub = _unique_sorted(b.to(dt), True)[0]
  aux = torch.sort(torch.cat([ua, ub]), stable=True).values
  if aux.numel() == 0:
    return aux
  edge = torch.ones(1, dtype=torch.bool, device=aux.device)
  flag = torch.cat([edge, aux[1:] != aux[:-1], edge])
  return aux[flag[1:] & flag[:-1]]


def setdiff1d(a, b) -> Expr:
  """The sorted distinct values of ``a`` not in ``b`` (NumPy's)."""
  return SelectExpr([lazify(a), lazify(b)], _setdiff_fn)


def union1d(a, b) -> Expr:
  return SelectExpr([lazify(a), lazify(b)], _union_fn)


def intersect1d(a, b) -> Expr:
  return SelectExpr([lazify(a), lazify(b)], _intersect_fn)


def setxor1d(a, b) -> Expr:
  return SelectExpr([lazify(a), lazify(b)], _setxor_fn)


def isin(element, test_elements) -> Expr:
  """Whether each element is among ``test_elements`` (NaN never is)."""
  return map([lazify(element), lazify(test_elements)], _in)


def _in1d_fn(a, b):
  return _in(a.reshape(-1), b)


def in1d(a, b) -> Expr:
  return map([lazify(a), lazify(b)], _in1d_fn)


def _trim_zeros_fn(x, trim):
  nz = torch.nonzero(x.reshape(-1)).reshape(-1)
  if nz.numel() == 0:
    return x[:0]
  lo = int(nz[0]) if "f" in trim.lower() else 0
  hi = int(nz[-1]) + 1 if "b" in trim.lower() else x.shape[0]
  return x[lo:hi]


def trim_zeros(v, trim: str = "fb") -> Expr:
  return SelectExpr([lazify(v)], _trim_zeros_fn, {"trim": trim})


def _bincount_fn(x, *w, minlength):
  if x.numel() and bool((x < 0).any()):
    raise ValueError("'list' argument must have no negative elements")
  weights = w[0].to(torch.float64) if w else None
  return torch.bincount(x.reshape(-1).to(torch.int64), weights=weights,
                        minlength=minlength)


def bincount(v, minlength=None, weights=None) -> Expr:
  """NumPy's ``bincount``: ``max(minlength, max(v) + 1)`` bins (the
  reference's ``minlength`` gives exactly that many, dropping larger
  values), float64 with ``weights``."""
  ins = [lazify(v)] + ([lazify(weights)] if weights is not None else [])
  return SelectExpr(ins, _bincount_fn, {"minlength": int(minlength or 0)})


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
    # the float, integer and complex ufuncs and the eager predicates
    "sin", "cos", "tan", "arcsin", "asin", "arccos", "acos", "arctan",
    "atan", "arctan2", "atan2", "sinh", "cosh", "tanh", "arcsinh", "asinh",
    "arccosh", "acosh", "arctanh", "atanh", "floor", "ceil", "trunc", "fix",
    "rint", "exp2", "expm1", "log2", "log10", "log1p", "logaddexp",
    "logaddexp2", "cbrt", "fabs", "degrees", "radians", "deg2rad",
    "rad2deg", "hypot", "copysign", "nextafter", "heaviside", "signbit",
    "spacing", "ldexp", "frexp", "modf", "divmod", "fmax", "fmin",
    "nan_to_num", "erf", "erfc", "i0", "sinc", "gcd", "lcm",
    "bitwise_count", "angle", "real", "imag", "iscomplex", "isreal",
    "conjugate", "isneginf", "isposinf", "isclose", "pow", "bitwise_invert",
    "bitwise_left_shift", "bitwise_right_shift", "allclose", "array_equal",
    "array_equiv", "iscomplexobj", "isrealobj", "real_if_close",
    "asarray_chkfinite",
    # constructors and index helpers
    "empty", "empty_like", "zeros_like", "ones_like", "full_like", "eye",
    "identity", "tri", "linspace", "logspace", "geomspace", "indices",
    "fromfunction", "fromiter", "from_dlpack", "randint", "asarray",
    "array", "as_array", "ndarray", "bartlett", "blackman", "hamming",
    "hanning", "kaiser", "meshgrid", "ix_", "diag_indices",
    "diag_indices_from", "tril_indices", "tril_indices_from",
    "triu_indices", "triu_indices_from", "mask_indices", "unravel_index",
    "ravel_multi_index", "broadcast_shapes",
    # selection and data-dependent lengths
    "nonzero", "flatnonzero", "argwhere", "extract", "compress", "choose",
    "select", "resize", "unique", "unique_values", "unique_counts",
    "unique_inverse", "unique_all", "setdiff1d", "union1d", "intersect1d",
    "setxor1d", "isin", "in1d", "trim_zeros", "bincount",
    "map_with_location",
]
