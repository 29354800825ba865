"""The NumPy-compatible builtins ported so far
(port of ``spartan_tpu/expr/builtins.py``).

Thin lazy constructors: creation ops become :class:`CreationExpr` (folded
into fused regions), elementwise math becomes map kernels over the
NumPy-named torch ufuncs of ``expr/map.py``, reductions carry the
reference's float64-accumulation semantics, and the selections whose
length depends on the data are ``SelectExpr`` nodes, evaluated on the
device before the region that reads them.  A builtin that is not
elementwise (a contraction, a histogram, ``pad``) is one map over a
private torch function marked ``map.structural``; concatenation, stacking
and tiling are nodes of ``expr/reshape.py``.  The names still missing are
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
import spartan_tpu_torch.expr.scan as scan_mod
import spartan_tpu_torch.expr.sort_expr as sort_mod
from spartan_tpu_torch.core.array import from_numpy as _from_numpy_arr
from spartan_tpu_torch.core.array import SpartanArray, dtype_kind, to_torch_dtype
from spartan_tpu_torch.expr import map as map_mod
from spartan_tpu_torch.expr.base import Expr, Val, lazify
from spartan_tpu_torch.expr.map import map, map1, map2, map_with_location
from spartan_tpu_torch.expr.ndarray import (CreationExpr, _next_seed,
                                            set_random_seed)
from spartan_tpu_torch.expr.reshape import (ConcatenateExpr, RavelExpr,
                                            ReshapeExpr, StackExpr, TileExpr,
                                            TransposeExpr)
from spartan_tpu_torch.expr.shuffle import shuffle
from spartan_tpu_torch.expr.slice import SelectExpr
from spartan_tpu_torch.expr.sort_expr import PercentileExpr, SortExpr
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
  xl, yl = map_mod._lift(x, device), map_mod._lift(y, device)
  if isinstance(x, torch.Tensor) != isinstance(y, torch.Tensor):
    # a weak scalar beside a tensor takes NumPy's result dtype of the two
    # (torch would promote a 0-d tensor pair to the scalar's own dtype)
    t, s = (x, y) if isinstance(x, torch.Tensor) else (y, x)
    dt = torch.result_type(t, s)
    xl, yl = xl.to(dt), yl.to(dt)
  return torch.where(cond.to(device).bool(), xl, yl)


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


@map_mod.structural
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


@map_mod.structural
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


@map_mod.structural
def _repeat_fn(x, repeats, axis):
  if axis is None:
    return torch.repeat_interleave(x.reshape(-1), repeats)
  return torch.repeat_interleave(x, repeats, dim=axis)


def repeat(v, repeats, axis=None) -> Expr:
  """NumPy's ``repeat`` with a Python int ``repeats`` (a count per element
  would give a shape that depends on the data)."""
  return map([lazify(v)], _repeat_fn,
             fn_kw={"repeats": int(repeats), "axis": axis})


@map_mod.structural
def _take_fn(x, idx, axis):
  if axis is None:
    x, axis = x.reshape(-1), 0
  from spartan_tpu_torch.expr.slice import _clamped
  idx = _clamped(torch.as_tensor(idx, device=x.device), x.shape[axis])
  axis %= x.ndim
  if idx.ndim == 0:
    # a 0-d tensor index would be read on the host (``.item()``), which a
    # device index (a loop's counter) or a meta tensor cannot give
    return x.index_select(axis, idx.reshape(1)).squeeze(axis)
  return x[(slice(None),) * axis + (idx,)]


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


@map_mod.structural
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


@map_mod.structural
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
  """NumPy's: ``ndim`` copies of ``arange(n)`` (a float ``n`` gives float64
  indices, as NumPy's ``arange``)."""
  return tuple(arange(n) for _ in _py.range(int(ndim)))


def diag_indices_from(v):
  v = lazify(v)
  if v.ndim < 2 or len(set(v.shape)) != 1:
    raise ValueError("input array must be square (all dimensions equal)")
  return diag_indices(int(v.shape[0]), v.ndim)


def _tri_indices(fn, n, k, m):
  """NumPy's own index pair, uploaded (a float ``n`` counts as NumPy's
  ``tri`` counts it)."""
  rows, cols = fn(n, k, m)
  return from_numpy(rows.astype(np.int64)), from_numpy(cols.astype(np.int64))


def tril_indices(n, k=0, m=None):
  return _tri_indices(np.tril_indices, n, k, m)


def triu_indices(n, k=0, m=None):
  return _tri_indices(np.triu_indices, n, k, m)


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


@map_mod.structural
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
  order = sort_mod.argsort(flat)  # NaNs last on the card too
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


@map_mod.structural
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
  aux = sort_mod.sort(torch.cat([ua, ub]))
  return aux[:-1][aux[1:] == aux[:-1]]


def _setxor_fn(a, b):
  dt = map_mod.result_type(a.dtype, b.dtype)
  ua = _unique_sorted(a.to(dt), True)[0]
  ub = _unique_sorted(b.to(dt), True)[0]
  aux = sort_mod.sort(torch.cat([ua, ub]))
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


@map_mod.structural
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
  if ins[0].ndim != 1:
    raise ValueError("object of too small depth for desired array"
                     if ins[0].ndim == 0 else "object too deep for desired "
                     "array")
  return SelectExpr(ins, _bincount_fn, {"minlength": int(minlength or 0)})


# -- helpers of the slice's builtins ------------------------------------------

_np_ops = map_mod.UFUNCS  # the ufuncs over tensors with NumPy's promotion


def _norm_axis(axis: int, ndim: int) -> int:
  """``axis`` in ``[0, ndim)``, or NumPy's ``AxisError``."""
  if not -ndim <= axis < ndim:
    raise np.exceptions.AxisError(axis, ndim)
  return axis % ndim


def _shape_or_none(e: Expr):
  """``e.shape``, or None where it depends on the data."""
  from spartan_tpu_torch.expr.base import NotShapeable
  try:
    return e.shape
  except NotShapeable:
    return None


def _tensors(*xs):
  """The arguments as tensors on the device of the first tensor among
  them."""
  device = next((x.device for x in xs if isinstance(x, torch.Tensor)), None)
  return [map_mod._lift(x, device) for x in xs]


def _result(*dtypes) -> torch.dtype:
  """NumPy's result type of several strong dtypes."""
  out = dtypes[0]
  for d in dtypes[1:]:
    out = map_mod.result_type(out, d)
  return out


def _is_exact_route(dt: torch.dtype, device: torch.device) -> bool:
  """Does a contraction in ``dt`` take ``expr/dot.py``'s exact integer
  route (counted there)?  Shape inference on meta tensors never does."""
  return device.type != "meta" and dot_mod._exact_route(dt, device)


def _contract(x: torch.Tensor, y: torch.Tensor, dims) -> torch.Tensor:
  """``tensordot(x, y, dims)`` in NumPy's result type, through the exact
  route for integers on the card and for bool anywhere."""
  dt = _result(x.dtype, y.dtype)
  x, y = x.to(dt), y.to(dt)
  if _is_exact_route(dt, x.device):
    return dot_mod._exact_tensordot(x, y, dims, dt)
  return torch.tensordot(x, y, dims=dims)


# -- contractions and the linear-algebra helpers -----------------------------

def matmul(a, b) -> Expr:
  """``dot`` (the reference's ``matmul``)."""
  return dot_mod.dot(a, b)


def tensordot(a, b, axes=2) -> Expr:
  """A ``TensorDotExpr``: ``torch.tensordot``, or the exact integer route
  on the card."""
  return dot_mod.tensordot(a, b, axes)


def _einsum_io(subscripts: str):
  """(input terms, output term) of subscripts without an ellipsis; the
  implicit output is the letters that appear once, sorted."""
  s = subscripts.replace(" ", "")
  if "->" in s:
    ins, out = s.split("->")
  else:
    ins = s
    counts: dict = {}
    for c in ins.replace(",", ""):
      counts[c] = counts.get(c, 0) + 1
    out = "".join(sorted(c for c in counts if counts[c] == 1))
  return ins, out


def einsum(subscripts: str, *operands, optimize="greedy") -> Expr:
  """Lazy einsum, routed as the reference routes it: a pure two-operand
  contraction is a ``TensorDotExpr`` (then a transpose); three or more
  operands go pairwise along ``numpy.einsum_path``; batch, trace and
  diagonal forms are one generic map over ``torch.einsum`` (integers on
  the card and bool anywhere through the exact integer route, counted in
  ``expr.dot.counts["exact_int_route"]``)."""
  routed = _route_einsum_contraction(subscripts, operands)
  if routed is None and optimize is not False:
    routed = _route_einsum_multi(subscripts, operands, optimize=optimize)
  if routed is not None:
    return routed
  return map([lazify(o) for o in operands], _einsum_fn,
             fn_kw={"subscripts": subscripts})


def _route_einsum_contraction(subscripts: str, operands):
  s = subscripts.replace(" ", "")
  if "..." in s or s.count(",") != 1 or len(operands) != 2:
    return None
  ins, out = _einsum_io(s)
  t1, t2 = ins.split(",")
  if len(set(t1)) != len(t1) or len(set(t2)) != len(t2):
    return None  # a diagonal within an operand
  shared = [c for c in t1 if c in t2]
  free1 = [c for c in t1 if c not in t2]
  free2 = [c for c in t2 if c not in t1]
  if (sorted(out) != sorted(free1 + free2)
      or _py.any(c in out for c in shared)):
    return None  # batch axes or summed-out free axes
  a, b = lazify(operands[0]), lazify(operands[1])
  if len(t1) != a.ndim or len(t2) != b.ndim:
    return None
  td = dot_mod.tensordot(a, b, axes=([t1.index(c) for c in shared],
                                     [t2.index(c) for c in shared]))
  natural = free1 + free2
  if out != "".join(natural):
    td = transpose(td, tuple(natural.index(c) for c in out))
  return td


def _route_einsum_multi(subscripts: str, operands, optimize="greedy"):
  """Three or more operands, pairwise along NumPy's shape-only
  ``einsum_path``; each two-operand step re-enters :func:`einsum`.  None
  (the generic map) for an ellipsis, a diagonal or malformed subscripts."""
  s = subscripts.replace(" ", "")
  if "..." in s or len(operands) < 3:
    return None
  ins_str, out = _einsum_io(s)
  terms = ins_str.split(",")
  if len(terms) != len(operands):
    return None  # torch.einsum raises the arity error
  if _py.any(len(set(t)) != len(t) for t in terms):
    return None
  ops = [lazify(o) for o in operands]
  if _py.any(len(t) != o.ndim for t, o in zip(terms, ops)):
    return None
  try:
    # the order depends on the shapes only: zero-stride stand-ins
    dummies = [np.broadcast_to(np.zeros(()), o.shape) for o in ops]
    path, _ = np.einsum_path(ins_str + "->" + out, *dummies,
                             optimize=optimize)
  except ValueError:
    return None
  work = list(zip(terms, ops))
  for step in path[1:]:  # path[0] is the marker 'einsum_path'
    popped = [work[i] for i in step]
    for i in sorted(step, reverse=True):
      work.pop(i)
    sub_terms = [t for t, _ in popped]
    keep = set("".join(t for t, _ in work)) | set(out)
    sub_out = "".join(c for c in dict.fromkeys("".join(sub_terms))
                      if c in keep)
    sub_sub = ",".join(sub_terms) + "->" + sub_out
    if len(popped) == 2:
      inter = einsum(sub_sub, *[o for _, o in popped])
    else:
      # NumPy's one step over all operands (outer products): the generic
      # map, since recursing would meet the same problem
      inter = map([o for _, o in popped], _einsum_fn,
                  fn_kw={"subscripts": sub_sub})
    work.append((sub_out, inter))
  (final_t, final_o), = work
  if final_t != out:
    final_o = transpose(final_o, tuple(final_t.index(c) for c in out))
  return final_o


def _einsum_letters(subscripts: str, ndims):
  """(terms, output) with each ellipsis spelled out in letters the
  subscripts do not use, right-aligned as NumPy broadcasts them."""
  s = subscripts.replace(" ", "")
  ins, out = (s.split("->") + [None])[:2]
  terms = ins.split(",")
  spare = [c for c in "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
           if c not in s]
  width = _py.max([nd - (len(t) - 3) for t, nd in zip(terms, ndims)
                   if "..." in t] or [0])
  ell = "".join(spare[:width])
  terms = [t.replace("...", ell[width - (nd - (len(t) - 3)):])
           if "..." in t else t for t, nd in zip(terms, ndims)]
  if out is None:
    counts: dict = {}
    for c in "".join(terms):
      counts[c] = counts.get(c, 0) + 1
    out = ell + "".join(sorted(c for c in counts
                               if counts[c] == 1 and c not in ell))
  else:
    out = out.replace("...", ell)
  return terms, out


def _exact_einsum(subscripts: str, xs, out_dtype: torch.dtype):
  """``torch.einsum`` of integer or bool operands, exactly: diagonals
  taken, then pairwise batched int64 products through
  ``expr/dot.py``'s ``_exact_matmul``, cast to ``out_dtype``."""
  terms, out = _einsum_letters(subscripts, [x.ndim for x in xs])
  ops = []
  for t, x in zip(terms, xs):
    x = x.to(torch.int64)
    t = list(t)
    while len(set(t)) != len(t):  # a repeated letter: its diagonal
      c = next(c for c in t if t.count(c) > 1)
      i = t.index(c)
      j = t.index(c, i + 1)
      x = torch.diagonal(x, 0, i, j)
      t = [l for k, l in enumerate(t) if k not in (i, j)] + [c]
    ops.append((t, x))

  def drop(t, x, keep):
    gone = [k for k, c in enumerate(t) if c not in keep]
    if gone:
      x = x.sum(dim=gone)
      t = [c for c in t if c in keep]
    return t, x

  ta, a = ops[0]
  for k, (tb, b) in enumerate(ops[1:], 1):
    rest = set(out).union(*[set(t) for t, _ in ops[k + 1:]])
    ta, a = drop(ta, a, rest | set(tb))
    tb, b = drop(tb, b, rest | set(ta))
    batch = [c for c in ta if c in tb and c in rest]
    summed = [c for c in ta if c in tb and c not in rest]
    fa = [c for c in ta if c not in tb]
    fb = [c for c in tb if c not in ta]
    a3 = a.permute([ta.index(c) for c in batch + fa + summed])
    b3 = b.permute([tb.index(c) for c in batch + summed + fb])
    nb = len(batch)
    ksz = int(np.prod([a3.shape[nb + len(fa) + i] for i in range(len(summed))]))
    fa_shape, fb_shape = a3.shape[nb:nb + len(fa)], b3.shape[nb + len(summed):]
    y = dot_mod._exact_matmul(
        a3.reshape(*a3.shape[:nb], int(np.prod(fa_shape)), ksz),
        b3.reshape(*b3.shape[:nb], ksz, int(np.prod(fb_shape))), torch.int64)
    a = y.reshape(*y.shape[:nb], *fa_shape, *fb_shape)
    ta = batch + fa + fb
  ta, a = drop(ta, a, set(out))
  a = a.permute([ta.index(c) for c in out]) if out else a
  return a != 0 if out_dtype == torch.bool else a.to(out_dtype)


@map_mod.structural
def _einsum_fn(*xs, subscripts):
  xs = _tensors(*xs)
  dt = _result(*[x.dtype for x in xs])
  xs = [x.to(dt) for x in xs]
  # integers on the card and bool anywhere: dot.py's exact route, counted;
  # torch's einsum of integers elsewhere sums in int64 (NumPy keeps int32)
  if _is_exact_route(dt, xs[0].device) or not (dt.is_floating_point
                                               or dt.is_complex):
    return _exact_einsum(subscripts, xs, dt)
  return torch.einsum(subscripts, *xs)


def einsum_path(subscripts, *operands, optimize="greedy"):
  """NumPy's contraction order and its report, over zero-stride stand-ins
  of the operands' shapes (host metadata: nothing is evaluated)."""
  dummies = [np.broadcast_to(np.zeros(()), lazify(o).shape)
             for o in operands]
  return np.einsum_path(subscripts, *dummies, optimize=optimize)


@map_mod.structural
def _inner_fn(x, y):
  x, y = _tensors(*map_mod.promote(x, y))
  if x.ndim == 0 or y.ndim == 0:
    return x * y
  return _contract(x, y, ([x.ndim - 1], [y.ndim - 1]))


def inner(a, b) -> Expr:
  """NumPy's ``inner``: the last axes contracted (a product for a 0-d
  operand)."""
  return map([lazify(a), lazify(b)], _inner_fn)


def vdot(a, b) -> Expr:
  """``sum(conj(ravel(a)) * ravel(b))``: the reference's sum, with its
  float64 accumulation (NumPy's ``vdot`` keeps float32)."""
  a, b = lazify(a), lazify(b)
  ra = ravel(a)
  if a.dtype.is_complex:
    ra = conj(ra)
  return sum(multiply(ra, ravel(b)))


@map_mod.structural
def _vecdot_fn(x, y, axis):
  x, y = _tensors(*map_mod.promote(x, y))
  x, y = torch.movedim(x, axis, -1), torch.movedim(y, axis, -1)
  if x.dtype == torch.bool:
    return (x & y).any(dim=-1)
  return ((x.conj() if x.is_complex() else x) * y).sum(dim=-1, dtype=x.dtype)


def vecdot(a, b, axis=-1) -> Expr:
  """NumPy 2's ``vecdot``: ``sum(conj(a) * b)`` along ``axis``, broadcast
  over the other axes, in the operands' result type."""
  return map([lazify(a), lazify(b)], _vecdot_fn, fn_kw={"axis": int(axis)})


@map_mod.structural
def _kron_fn(x, y):
  x, y = _tensors(*map_mod.promote(x, y))
  return torch.kron(x, y)


def kron(a, b) -> Expr:
  return map([lazify(a), lazify(b)], _kron_fn)


@map_mod.structural
def _cross_fn(x, y, axis):
  x, y = _tensors(*map_mod.promote(x, y))
  x, y = torch.movedim(x, axis, -1), torch.movedim(y, axis, -1)
  if x.shape[-1] == 2 and y.shape[-1] == 2:
    return x[..., 0] * y[..., 1] - x[..., 1] * y[..., 0]

  def xyz(v):
    if v.shape[-1] == 3:
      return v[..., 0], v[..., 1], v[..., 2]
    return v[..., 0], v[..., 1], torch.zeros_like(v[..., 0])

  (a0, a1, a2), (b0, b1, b2) = xyz(x), xyz(y)
  cp = torch.stack(torch.broadcast_tensors(a1 * b2 - a2 * b1,
                                           a2 * b0 - a0 * b2,
                                           a0 * b1 - a1 * b0), dim=-1)
  return torch.movedim(cp, -1, axis)


def cross(a, b, axis=-1) -> Expr:
  """NumPy's ``cross`` of 2- and 3-vectors along ``axis`` (two 2-vectors
  give the z component, as NumPy and the reference do)."""
  a, b = lazify(a), lazify(b)
  for v in (a, b):
    if v.ndim == 0 or v.shape[axis] not in (2, 3):
      raise ValueError("incompatible dimensions for cross product\n"
                       "(dimension must be 2 or 3)")
  if a.shape[axis] == 3 or b.shape[axis] == 3:
    nd = _py.max(a.ndim, b.ndim)
    axis = _norm_axis(axis, nd)  # the result's axis, as NumPy's axisc
  return map([a, b], _cross_fn, fn_kw={"axis": int(axis)})


@map_mod.structural
def _diag_fn(x, k):
  return torch.diag(x, k)


def diag(v, k=0) -> Expr:
  """NumPy's ``diag``: a 1-D array's square matrix, a 2-D array's
  diagonal ``k``."""
  v = lazify(v)
  if v.ndim not in (1, 2):
    raise ValueError("Input must be 1- or 2-d.")
  return map([v], _diag_fn, fn_kw={"k": int(k)})


@map_mod.structural
def _diagflat_fn(x, k):
  return torch.diagflat(x.reshape(-1), k)


def diagflat(v, k=0) -> Expr:
  return map([lazify(v)], _diagflat_fn, fn_kw={"k": int(k)})


@map_mod.structural
def _tri_mask_fn(x, k, lower):
  if x.ndim == 1:  # NumPy: a 1-D array is masked as (n, n) rows of it
    x = x.expand(x.shape[0], x.shape[0])
  n, m = x.shape[-2:]
  ones = torch.ones((n, m), dtype=torch.bool, device=x.device)
  mask = torch.tril(ones, k) if lower else torch.triu(ones, k)
  return torch.where(mask, x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def tril(v, k=0) -> Expr:
  """NumPy's ``tril`` over the last two axes; a 1-D array gives the
  ``(n, n)`` masked broadcast of its rows (torch's raises, as does the
  reference)."""
  v = lazify(v)
  if v.ndim == 0:
    raise ValueError("tril needs an array of at least one dimension")
  return map([v], _tri_mask_fn, fn_kw={"k": int(k), "lower": True})


def triu(v, k=0) -> Expr:
  """NumPy's ``triu``; see :func:`tril`."""
  v = lazify(v)
  if v.ndim == 0:
    raise ValueError("triu needs an array of at least one dimension")
  return map([v], _tri_mask_fn, fn_kw={"k": int(k), "lower": False})


@map_mod.structural
def _fill_diagonal_fn(x, val, step, end):
  flat = x.reshape(-1).clone()
  idx = torch.arange(0, _py.min(end, flat.numel()), step, device=x.device)
  vals = _tensors(x, val)[1].reshape(-1)
  if idx.numel() and vals.numel():
    reps = -(-idx.numel() // vals.numel())
    flat[idx] = vals.repeat(reps)[:idx.numel()].to(x.dtype)
  return flat.reshape(x.shape)


def fill_diagonal(v, val, wrap=False) -> Expr:
  """Functional ``numpy.fill_diagonal``: a new expr with the main diagonal
  set to ``val``, cycled where it is shorter (NumPy's ``wrap=False``
  stops at the square's end)."""
  v = lazify(v)
  if v.ndim < 2:
    raise ValueError("array must be at least 2-d")
  if v.ndim == 2:
    step = v.shape[1] + 1
    end = v.size if wrap else v.shape[1] * v.shape[1]
  else:
    if len(set(v.shape)) != 1:
      raise ValueError("All dimensions of input must be of equal length")
    step = 1 + int(np.cumprod(v.shape[:-1]).sum())
    end = v.size
  return map([v, lazify(val)], _fill_diagonal_fn,
             fn_kw={"step": int(step), "end": int(end)})


def norm(v, ord=2, axis=None) -> Expr:
  """The reference's flat norm: ``ord`` 2, ``"fro"`` or None give the
  2-norm of all the entries (the Frobenius norm of a matrix, where
  NumPy's ``norm(x, 2)`` is the spectral norm), 1 ``sum|v|``, inf
  ``max|v|``, any other p ``(sum|v|^p)^(1/p)``.  A full sum over one
  float32 or 16-bit operand runs on the fused-reduce kernel."""
  v = lazify(v)
  if ord in (2, "fro", None):
    return sqrt(sum(abs(v) ** 2, axis=axis))
  if ord == 1:
    return sum(abs(v), axis=axis)
  if ord == np.inf:
    return max(abs(v), axis=axis)
  return sum(abs(v) ** ord, axis=axis) ** (1.0 / ord)


# -- statistics and calculus -------------------------------------------------

amax = max
amin = min


def ptp(v, axis=None) -> Expr:
  """``max - min`` along ``axis``."""
  return max(v, axis=axis) - min(v, axis=axis)


@map_mod.structural
def _average_fn(x, w, axis):
  x, w = _tensors(x, w)
  dt = _result(x.dtype, w.dtype)
  if not (x.dtype.is_floating_point or x.dtype.is_complex):
    dt = _result(dt, torch.float64)
  if x.shape != w.shape:
    if axis is None:
      raise TypeError("Axis must be specified when shapes of a and weights "
                      "differ.")
    if w.ndim != 1:
      raise TypeError("1D weights expected when shapes of a and weights "
                      "differ.")
    if w.shape[0] != x.shape[axis]:
      raise ValueError("Length of weights not compatible with specified "
                       "axis.")
    shape = [1] * x.ndim
    shape[axis] = -1
    w = w.reshape(shape)
  dims = tuple(_py.range(x.ndim)) if axis is None else axis
  return (x.to(dt) * w.to(dt)).sum(dims) / w.to(dt).sum(dims)


def average(v, axis=None, weights=None) -> Expr:
  """The mean without weights; with them NumPy's weighted mean, in
  NumPy's result type of the two (float64 for integers or float64
  weights; the reference's ``jnp.average`` keeps float32)."""
  if weights is None:
    return mean(v, axis=axis)
  v = lazify(v)
  if axis is not None:
    axis = _norm_axis(int(axis), v.ndim)
  return map([v, lazify(weights)], _average_fn, fn_kw={"axis": axis})


@map_mod.structural
def _cov_fn(m, rowvar, ddof):
  x, = _tensors(m)
  dt = _result(x.dtype, torch.float64)
  x = x.to(dt)
  if x.ndim < 2:
    x = x.reshape(1, -1)
  if not rowvar and x.shape[0] != 1:
    x = x.T
  if x.shape[0] == 0:
    return torch.zeros((0, 0), dtype=dt, device=x.device)
  fact = x.shape[1] - (1 if ddof is None else ddof)
  fact = _py.max(fact, 0)
  x = x - x.mean(dim=1, keepdim=True)
  c = x @ x.T.conj()
  return (c * (1.0 / fact if fact else float("inf"))).squeeze()


def cov(m, rowvar=True, ddof=None) -> Expr:
  """NumPy's ``cov``: rows are variables (columns with
  ``rowvar=False``), ``ddof`` 1 by default, float64 for float32 input as
  NumPy gives it (the reference keeps float32)."""
  m = lazify(m)
  if m.ndim > 2:
    raise ValueError("m has more than 2 dimensions")
  return map([m], _cov_fn, fn_kw={"rowvar": bool(rowvar), "ddof": ddof})


@map_mod.structural
def _corrcoef_fn(m, rowvar):
  c = _cov_fn(m, rowvar, None)
  if c.ndim == 0:
    return c / c
  std = torch.sqrt(torch.diagonal(c).real)
  c = c / std[:, None]
  c = c / std[None, :]
  if c.is_complex():
    return torch.complex(c.real.clamp(-1, 1), c.imag.clamp(-1, 1))
  return c.clamp(-1, 1)


def corrcoef(m, rowvar=True) -> Expr:
  """NumPy's ``corrcoef`` (float64 for float32 input, as NumPy)."""
  m = lazify(m)
  if m.ndim > 2:
    raise ValueError("m has more than 2 dimensions")
  return map([m], _corrcoef_fn, fn_kw={"rowvar": bool(rowvar)})


@map_mod.structural
def _nanarg_fn(x, axis, largest):
  if axis is None:
    x = x.reshape(-1)
  dim = 0 if axis is None else axis
  if x.dtype == torch.bool:
    x = x.to(torch.uint8)
  pick = torch.argmax if largest else torch.argmin
  if not (x.is_floating_point() or x.is_complex()):
    return pick(x, dim=dim)
  nan = torch.isnan(x)
  fill = torch.full((), float("-inf") if largest else float("inf"),
                    dtype=x.dtype, device=x.device)
  out = pick(torch.where(nan, fill, x), dim=dim)
  return torch.where(nan.all(dim=dim), torch.full_like(out, -1), out)


def nanargmax(v, axis=None) -> Expr:
  """The index of the largest value that is not NaN; an all-NaN slice
  gives -1, the reference's value (NumPy raises ``ValueError``)."""
  return map([lazify(v)], _nanarg_fn, fn_kw={"axis": axis, "largest": True})


def nanargmin(v, axis=None) -> Expr:
  """As :func:`nanargmax`, the smallest value."""
  return map([lazify(v)], _nanarg_fn, fn_kw={"axis": axis, "largest": False})


def _nan_as_one(x):
  if not isinstance(x, torch.Tensor):
    return type(x)(1) if x != x else x
  return torch.where(torch.isnan(x), torch.ones((), dtype=x.dtype,
                                                device=x.device), x)


def nanprod(v, axis=None) -> Expr:
  """``prod`` with NaN counted as 1."""
  v = lazify(v)
  if dtype_kind(v.dtype) not in "fc":
    return prod(v, axis=axis)
  return prod(map([v], _nan_as_one), axis=axis)


@map_mod.structural
def _diff_fn(x, n, axis):
  for _ in _py.range(n):
    m = x.shape[axis]
    if m == 0:
      break
    hi, lo = x.narrow(axis, 1, m - 1), x.narrow(axis, 0, m - 1)
    x = hi != lo if x.dtype == torch.bool else hi - lo
  return x


def diff(v, n=1, axis=-1) -> Expr:
  """NumPy's ``diff``: the n-th differences along ``axis`` (``!=`` for
  bool, as NumPy)."""
  v = lazify(v)
  if n < 0:
    raise ValueError(f"order must be non-negative but got {n!r}")
  if v.ndim == 0:
    raise ValueError("diff requires input that is at least one dimensional")
  return map([v], _diff_fn, fn_kw={"n": int(n),
                                   "axis": _norm_axis(axis, v.ndim)})


def ediff1d(v) -> Expr:
  """The differences of the flattened array."""
  v = lazify(v)
  if v.dtype == torch.bool:
    raise TypeError("numpy boolean subtract, the `-` operator, is not "
                    "supported, use the bitwise_xor, the `^` operator, or "
                    "the logical_xor function instead.")
  return map([ravel(v)], _diff_fn, fn_kw={"n": 1, "axis": 0})


def _gradient_axis(f, axis, dx, edge_order, otype):
  """NumPy's ``gradient`` of ``f`` along one axis: second-order central
  differences inside, one-sided ones of ``edge_order`` at the ends, for a
  scalar spacing or the differences of coordinates (``dx``).  As in
  NumPy, a Python float spacing is weak (the arithmetic stays in ``f``'s
  dtype), a NumPy float64 one strong: differences of ``f`` are taken in
  its dtype, then divided or weighted in float64, and each result is
  stored in ``otype``."""
  uniform = np.ndim(dx) == 0
  strong = not (uniform and type(dx) in (int, float))
  wide = torch.promote_types(f.dtype, torch.float64)
  n = f.ndim

  def at(s):
    idx = [slice(None)] * n
    idx[axis] = s
    return f[tuple(idx)]

  def coef(c):
    if np.ndim(c) == 0:
      return float(c)
    shape = [1] * n
    shape[axis] = -1
    return torch.as_tensor(c, device=f.device).reshape(shape)

  def quotient(num, c):  # (f[i] - f[j]) / c
    return (num.to(wide) if strong else num) / coef(c)

  def weighted(ca, fa, cb, fb, cc, fc):  # ca * fa + cb * fb + cc * fc
    if strong:
      fa, fb, fc = fa.to(wide), fb.to(wide), fc.to(wide)
    return coef(ca) * fa + coef(cb) * fb + coef(cc) * fc

  out = torch.empty(f.shape, dtype=otype, device=f.device)

  def put(s, value):
    idx = [slice(None)] * n
    idx[axis] = s
    out[tuple(idx)] = value

  if uniform:
    put(slice(1, -1), quotient(at(slice(2, None)) - at(slice(None, -2)),
                               2. * dx))
  else:
    dx1, dx2 = dx[0:-1], dx[1:]
    put(slice(1, -1), weighted(-(dx2) / (dx1 * (dx1 + dx2)),
                               at(slice(None, -2)),
                               (dx2 - dx1) / (dx1 * dx2), at(slice(1, -1)),
                               dx1 / (dx2 * (dx1 + dx2)), at(slice(2, None))))
  if edge_order == 1:
    put(0, quotient(at(1) - at(0), dx if uniform else dx[0]))
    put(-1, quotient(at(-1) - at(-2), dx if uniform else dx[-1]))
    return out
  if uniform:
    a, b, c = -1.5 / dx, 2. / dx, -0.5 / dx
  else:
    dx1, dx2 = dx[0], dx[1]
    a = -(2. * dx1 + dx2) / (dx1 * (dx1 + dx2))
    b = (dx1 + dx2) / (dx1 * dx2)
    c = - dx1 / (dx2 * (dx1 + dx2))
  put(0, weighted(a, at(0), b, at(1), c, at(2)))
  if uniform:
    a, b, c = 0.5 / dx, -2. / dx, 1.5 / dx
  else:
    dx1, dx2 = dx[-2], dx[-1]
    a = (dx2) / (dx1 * (dx1 + dx2))
    b = - (dx2 + dx1) / (dx1 * dx2)
    c = (2. * dx2 + dx1) / (dx2 * (dx1 + dx2))
  put(-1, weighted(a, at(-3), b, at(-2), c, at(-1)))
  return out


@map_mod.structural
def _gradient_fn(f, axis, dx, edge_order):
  otype = f.dtype
  if not (otype.is_floating_point or otype.is_complex):
    f = f.to(torch.float64)
    otype = torch.float64
  return _gradient_axis(f, axis, dx, edge_order, otype)


def gradient(v, *varargs, axis=None, edge_order=1):
  """NumPy's ``gradient``: one expr for one axis, else a tuple of exprs,
  one an axis (the reference raises for a 2-D array).  Spacings are host
  values: a scalar, or one scalar or coordinate vector an axis."""
  v = lazify(v)
  nd = v.ndim
  if axis is None:
    axes = tuple(_py.range(nd))
  else:
    axes = tuple(_norm_axis(a, nd) for a in (
        axis if isinstance(axis, (tuple, list)) else (axis,)))
    if len(set(axes)) != len(axes):
      raise ValueError("repeated axis")
  if len(varargs) == 0:
    dxs = [1.0] * len(axes)
  elif len(varargs) == 1 and np.ndim(varargs[0]) == 0:
    dxs = list(varargs) * len(axes)
  elif len(varargs) == len(axes):
    dxs = []
    for i, d in enumerate(varargs):
      d = np.asarray(d.glom() if isinstance(d, Expr) else d)
      if d.ndim == 0:
        dxs.append(varargs[i] if isinstance(varargs[i], (int, float))
                   else d[()])
        continue
      if d.ndim != 1:
        raise ValueError("distances must be either scalars or 1d")
      if len(d) != v.shape[axes[i]]:
        raise ValueError("when 1d, distances must match the length of the "
                         "corresponding dimension")
      if np.issubdtype(d.dtype, np.integer):
        d = d.astype(np.float64)
      diffx = np.diff(d)
      dxs.append(diffx[0] if (diffx == diffx[0]).all() else diffx)
  else:
    raise TypeError("invalid number of arguments")
  if edge_order > 2:
    raise ValueError("'edge_order' greater than 2 not supported")
  for ax in axes:
    if v.shape[ax] < edge_order + 1:
      raise ValueError("Shape of array too small to calculate a numerical "
                       "gradient, at least (edge_order + 1) elements are "
                       "required.")
  outs = tuple(map([v], _gradient_fn, fn_kw={"axis": ax, "dx": dx,
                                             "edge_order": int(edge_order)})
               for ax, dx in zip(axes, dxs))
  return outs[0] if len(outs) == 1 else outs


def _interp_part(x, xp, fp, lval, rval, by_reciprocal: bool):
  """NumPy's ``interp`` of float64 ``fp`` (one part of a complex one with
  ``by_reciprocal``: NumPy's complex loop multiplies by ``1 / dx`` where
  its real loop divides)."""
  n = xp.numel()
  j = torch.searchsorted(xp, x.contiguous(), right=True) - 1
  lo = j.clamp(0, _py.max(n - 2, 0))
  hi = (lo + 1).clamp(max=n - 1)
  x0, x1, y0, y1 = xp[lo], xp[hi], fp[lo], fp[hi]
  slope = ((y1 - y0) * (1 / (x1 - x0)) if by_reciprocal
           else (y1 - y0) / (x1 - x0))
  out = slope * (x - x0) + y0
  # NumPy: a NaN from one side is tried from the other
  alt = slope * (x - x1) + y1
  alt = torch.where(torch.isnan(alt) & (y0 == y1), y0, alt)
  out = torch.where(torch.isnan(out), alt, out)
  out = torch.where(x == x0, y0, out)
  out = torch.where(j == n - 1, fp[-1], out)
  out = torch.where(j < 0, lval, out)
  out = torch.where(x > xp[-1], rval, out)
  return torch.where(torch.isnan(x), x, out)


@map_mod.structural
def _interp_fn(x, xp, fp, left, right):
  x, xp, fp = _tensors(x, xp, fp)
  x, xp = x.to(torch.float64), xp.to(torch.float64)

  def end(value, default, part):
    if value is None:
      return default
    return torch.tensor(part(complex(value)), dtype=torch.float64,
                        device=x.device)

  if not fp.is_complex():
    fp = fp.to(torch.float64)
    return _interp_part(x, xp, fp, end(left, fp[0], lambda c: c.real),
                        end(right, fp[-1], lambda c: c.real), False)
  fp = fp.to(torch.complex128)
  re, im = (_interp_part(x, xp, f, end(left, f[0], part),
                         end(right, f[-1], part), True)
            for f, part in ((fp.real, lambda c: c.real),
                            (fp.imag, lambda c: c.imag)))
  return torch.complex(re, im)


def interp(x, xp, fp, left=None, right=None) -> Expr:
  """NumPy's ``interp`` (increasing ``xp``), float64 as NumPy gives it
  for float32 input (the reference keeps float32); complex128 for a
  complex ``fp``, each part as NumPy's complex loop computes it."""
  xp_, fp_ = lazify(xp), lazify(fp)
  if xp_.ndim != 1 or fp_.ndim != 1:
    raise ValueError("Data points must be 1-D sequences")
  if xp_.shape[0] != fp_.shape[0]:
    raise ValueError("fp and xp are not of the same length")
  if xp_.shape[0] == 0:
    raise ValueError("array of sample points is empty")
  return map([lazify(x), xp_, fp_], _interp_fn,
             fn_kw={"left": left, "right": right})


@map_mod.structural
def _trapezoid_fn(y, *x, dx, axis):
  y, = _tensors(y)
  if x:
    xs = _tensors(y, x[0])[1]
    if xs.ndim == 1:
      d = xs[1:] - xs[:-1]
      shape = [1] * y.ndim
      shape[axis] = d.shape[0]
      d = d.reshape(shape)
    else:
      d = _diff_fn(xs, 1, axis % xs.ndim)
  else:
    d = dx
  m = y.shape[axis]
  s = _np_ops["add"](y.narrow(axis, 1, _py.max(m - 1, 0)),
                     y.narrow(axis, 0, _py.max(m - 1, 0)))
  ret = _np_ops["true_divide"](_np_ops["multiply"](d, s), 2.0)
  return ret.sum(axis)


def trapezoid(y, x=None, dx: float = 1.0, axis: int = -1) -> Expr:
  """NumPy's ``trapezoid`` along ``axis``: over the coordinates ``x`` if
  given, else the spacing ``dx``."""
  y = lazify(y)
  axis = _norm_axis(int(axis), y.ndim)
  ins = [y] + ([lazify(x)] if x is not None else [])
  return map(ins, _trapezoid_fn, fn_kw={"dx": dx, "axis": axis})


trapz = trapezoid

_CORR_MODES = {"valid": "valid", "same": "same", "full": "full", 0: "valid",
               1: "same", 2: "full"}


def _correlate_core(a: torch.Tensor, v: torch.Tensor, mode: str):
  """``out[k] = sum_j a_pad[k + j] * v[j]`` for ``len(a) >= len(v)``,
  ``a`` zero-padded as NumPy's ``_pyarray_correlate`` pads it."""
  m = v.shape[0]
  left, right = {"valid": (0, 0), "same": (m // 2, m - 1 - m // 2),
                 "full": (m - 1, m - 1)}[mode]
  if a.is_complex():  # four real correlations: NumPy's complex products
    ar, ai, vr, vi = a.real, a.imag, v.real, v.imag
    return torch.complex(
        _correlate_core(ar, vr, mode) - _correlate_core(ai, vi, mode),
        _correlate_core(ar, vi, mode) + _correlate_core(ai, vr, mode))
  if a.is_floating_point():
    work = a.dtype if a.dtype in (torch.float32, torch.float64) else (
        torch.float32)
    out = torch.nn.functional.conv1d(
        torch.nn.functional.pad(a.to(work), (left, right))[None, None],
        v.to(work)[None, None])[0, 0]
    return out.to(a.dtype)
  # integers and bool: exact int64 sums, one tap at a time
  ap = torch.nn.functional.pad(a.to(torch.int64), (left, right))
  n_out = ap.shape[0] - m + 1
  out = torch.zeros(n_out, dtype=torch.int64, device=a.device)
  vi = v.to(torch.int64)
  for j in _py.range(m):
    out += ap[j:j + n_out] * vi[j]
  return out != 0 if a.dtype == torch.bool else out.to(a.dtype)


@map_mod.structural
def _correlate_fn(a, v, mode, flip):
  a, v = _tensors(*map_mod.promote(a, v))
  a, v = a.reshape(-1), v.reshape(-1)
  if flip:  # convolve: the longer one first, the other reversed
    if v.shape[0] > a.shape[0]:
      a, v = v, a
    return _correlate_core(a, v.flip(0), mode)
  # NumPy conjugates v; it swaps a shorter a with v, correlates and
  # reverses the result
  if v.shape[0] > a.shape[0]:
    return _correlate_core(v.conj_physical(), a, mode).flip(0)
  return _correlate_core(a, v.conj_physical(), mode)


def _correlation(a, v, mode, flip) -> Expr:
  a, v = lazify(a), lazify(v)
  if mode not in _CORR_MODES:
    raise ValueError(f"mode must be one of 'valid', 'same', or 'full' (got "
                     f"{mode!r})")
  for name, x in (("a", a), ("v", v)):
    if x.ndim > 1:
      raise ValueError("object too deep for desired array")
    if x.size == 0:
      raise ValueError(f"{name} cannot be empty")
  return map([a, v], _correlate_fn,
             fn_kw={"mode": _CORR_MODES[mode], "flip": flip})


def convolve(a, v, mode: str = "full") -> Expr:
  """NumPy's ``convolve`` of two 1-D arrays (``F.conv1d`` for floats,
  exact int64 sums for integers and bool)."""
  return _correlation(a, v, mode, True)


def correlate(a, v, mode: str = "valid") -> Expr:
  """NumPy's ``correlate`` of two 1-D arrays, ``v`` conjugated: ``v`` the
  longer, the two swapped and the result reversed, as NumPy does."""
  return _correlation(a, v, mode, False)


# -- polynomials ---------------------------------------------------------------

def _inexact_dtype(dt: torch.dtype) -> torch.dtype:
  """NumPy's ``x + 0.0``: integers and bool become float64."""
  return dt if dt.is_floating_point or dt.is_complex else torch.float64


@map_mod.structural
def _poly_fn(z):
  z = z.reshape(-1)
  dt = z.dtype if z.dtype in (torch.float32, torch.float64, torch.complex64,
                              torch.complex128) else torch.float64
  z = z.to(dt)
  a = torch.ones(1, dtype=dt, device=z.device)
  zero = torch.zeros(1, dtype=dt, device=z.device)
  for i in _py.range(z.shape[0]):
    # NumPy's convolve(a, [1, -z_i]): a[k] + (-z_i) * a[k - 1]
    a = torch.cat([a, zero]) + torch.cat([zero, a]) * (-z[i])
  return a


def poly(seq_of_zeros) -> Expr:
  """The coefficients of the polynomial with the given roots; a square
  matrix's characteristic polynomial is a host boundary (its eigenvalues,
  ``numpy.poly``, counted in ``expr.fio.counts["host_runs"]``)."""
  from spartan_tpu_torch.expr.fio import HostExpr
  v = lazify(seq_of_zeros)
  if v.ndim == 2 and v.shape[0] == v.shape[1] and v.shape[0] != 0:
    return HostExpr([v], np.poly)
  if v.ndim > 1:
    raise ValueError("input must be 1d or non-empty square 2d array.")
  if v.size == 0:
    return from_numpy(np.asarray(1.0))
  return map([v], _poly_fn)


@map_mod.structural
def _polyaddsub_fn(a, b, name):
  a, b = _tensors(a, b)
  a, b = a.reshape(-1), b.reshape(-1)
  diff = b.shape[0] - a.shape[0]
  if diff > 0:
    a = torch.cat([torch.zeros(diff, dtype=a.dtype, device=a.device), a])
  elif diff < 0:
    b = torch.cat([torch.zeros(-diff, dtype=b.dtype, device=b.device), b])
  return _np_ops[name](a, b)


def polyadd(a1, a2) -> Expr:
  """The sum of two coefficient vectors, the shorter aligned to the
  longer's end."""
  return map([lazify(a1), lazify(a2)], _polyaddsub_fn, fn_kw={"name": "add"})


def polysub(a1, a2) -> Expr:
  return map([lazify(a1), lazify(a2)], _polyaddsub_fn,
             fn_kw={"name": "subtract"})


def polymul(a1, a2) -> Expr:
  """The product's coefficients: ``convolve(a1, a2)``."""
  return convolve(a1, a2)


@map_mod.structural
def _polyder_fn(p, m):
  p = _tensors(p)[0].reshape(-1)
  for _ in _py.range(m):
    n = p.shape[0] - 1
    p = _np_ops["multiply"](p[:-1], torch.arange(n, 0, -1, device=p.device))
  return p


def _coefficients(p) -> Expr:
  """A coefficient array: NumPy takes ``len(p)``, so a 0-d one raises."""
  p = lazify(p)
  if p.ndim == 0:
    raise TypeError("len() of unsized object")
  return p


def polyder(p, m=1) -> Expr:
  """The m-th derivative's coefficients (int64 weights: float32
  coefficients give float64, as NumPy)."""
  m = int(m)
  if m < 0:
    raise ValueError("Order of derivative must be positive (see polyint)")
  p = _coefficients(p)
  return map([p], _polyder_fn, fn_kw={"m": m})


@map_mod.structural
def _polyint_fn(p, m, k):
  p = _tensors(p)[0].reshape(-1)
  for i in _py.range(m):
    y = _np_ops["true_divide"](p, torch.arange(p.shape[0], 0, -1,
                                               device=p.device))
    c = torch.as_tensor(k[i:i + 1], device=p.device)
    p = torch.cat([y.to(_result(y.dtype, c.dtype)),
                   c.to(_result(y.dtype, c.dtype))])
  return p


def polyint(p, m=1, k=None) -> Expr:
  """The m-th antiderivative's coefficients with integration constants
  ``k`` (host values: zeros by default, one scalar for every order)."""
  m = int(m)
  if m < 0:
    raise ValueError("Order of integral must be positive (see polyder)")
  k = np.zeros(m, float) if k is None else np.atleast_1d(k)
  if len(k) == 1 and m > 1:
    k = k[0] * np.ones(m, float)
  if len(k) < m:
    raise ValueError("k must be a scalar or a rank-1 array of length 1 or "
                     ">m.")
  return map([_coefficients(p)], _polyint_fn, fn_kw={"m": m, "k": np.array(k)})


@map_mod.structural
def _polydiv_fn(u, v, part, nr):
  u, v = _tensors(u, v)
  u, v = u.reshape(-1), v.reshape(-1)
  u = u.to(_inexact_dtype(u.dtype))
  v = v.to(_inexact_dtype(v.dtype))
  w = _result(u.dtype, v.dtype)
  m, n = u.shape[0] - 1, v.shape[0] - 1
  scale = (1.0 / v[0]).to(w)
  q = torch.zeros(_py.max(m - n + 1, 1), dtype=w, device=u.device)
  r = u.to(w).clone()
  vw = v.to(w)
  for k in _py.range(0, m - n + 1):
    d = scale * r[k]
    q[k] = d
    r[k:k + n + 1] -= d * vw
  return q if part == 0 else r[-nr:]


def polydiv(u, v):
  """``(quotient, remainder)`` of two coefficient vectors.  The remainder
  keeps ``max(1, len(v) - 1)`` entries, the static bound of its degree
  that the reference keeps (NumPy trims its leading zeros, a length that
  depends on the data)."""
  u, v = lazify(u), lazify(v)
  nr = _py.max(1, int(v.shape[-1]) - 1)
  return (map([u, v], _polydiv_fn, fn_kw={"part": 0, "nr": nr}),
          map([u, v], _polydiv_fn, fn_kw={"part": 1, "nr": nr}))


def _lstsq_svd(a: torch.Tensor, b: torch.Tensor,
               rcond: float) -> torch.Tensor:
  """The minimum-norm least-squares solution of ``a x = b`` through the
  SVD, singular values below ``rcond · s_max`` dropped (the mask of
  ``jnp.linalg.lstsq``), the same code on every device: torch's CUDA
  least-squares solver has only the QR driver, which assumes full rank."""
  u, s, vt = torch.linalg.svd(a, full_matrices=False)
  mask = (s > 0) & (s >= rcond * s[:1])
  s_inv = torch.where(mask, 1 / torch.where(mask, s, 1), 0)
  if b.ndim == 1:
    return vt.mT @ (s_inv * (u.mT @ b))
  return vt.mT @ (s_inv[:, None] * (u.mT @ b))


@map_mod.structural
def _polyfit_fn(x, y, deg):
  x, y = _tensors(x, y)
  x = x.to(_inexact_dtype(x.dtype))
  y = y.to(_inexact_dtype(y.dtype))
  order = deg + 1
  # the Vandermonde matrix is float64 (NumPy promotes it with int)
  lhs = _vander_fn(x, order, False)
  scale = torch.sqrt((lhs * lhs).sum(dim=0))
  lhs = lhs / scale
  rhs = y.to(lhs.dtype).reshape(y.shape[0], -1)
  # NumPy's SVD solve and cut-off, on every device
  sol = _lstsq_svd(lhs, rhs, len(x) * float(torch.finfo(x.dtype).eps))
  c = sol.reshape((order,) + tuple(y.shape[1:]))
  return c / scale.reshape((-1,) + (1,) * (c.ndim - 1))


def polyfit(x, y, deg: int) -> Expr:
  """The least-squares polynomial fit of degree ``deg``, its Vandermonde
  columns scaled to unit norm before the solve, as NumPy's."""
  x, y = lazify(x), lazify(y)
  deg = int(deg)
  if deg < 0:
    raise ValueError("expected deg >= 0")
  if x.ndim != 1:
    raise TypeError("expected 1D vector for x")
  if x.size == 0:
    raise TypeError("expected non-empty vector for x")
  if y.ndim < 1 or y.ndim > 2:
    raise TypeError("expected 1D or 2D array for y")
  if x.shape[0] != y.shape[0]:
    raise TypeError("expected x and y to have same length")
  return map([x, y], _polyfit_fn, fn_kw={"deg": deg})


@map_mod.structural
def _polyval_fn(p, x):
  p, x = _tensors(p, x)
  dt = _result(p.dtype, x.dtype)
  p, x = p.reshape(-1).to(dt), x.to(dt)
  y = torch.zeros(x.shape, dtype=dt, device=x.device)
  for i in _py.range(p.shape[0]):
    y = y * x + p[i]
  return y


def polyval(p, x) -> Expr:
  """Horner's evaluation of the coefficients ``p`` at ``x``."""
  return map([lazify(p), lazify(x)], _polyval_fn)


def roots(p) -> Expr:
  """The polynomial's roots: a host boundary (a companion matrix's
  eigenvalues, ``numpy.roots``), as in the reference; counted in
  ``expr.fio.counts["host_runs"]``."""
  from spartan_tpu_torch.expr.fio import HostExpr
  return HostExpr([lazify(p)], np.roots)


@map_mod.structural
def _vander_fn(x, N, increasing):
  dt = _result(x.dtype, torch.int64)
  x = x.to(dt)
  v = torch.empty((x.shape[0], N), dtype=dt, device=x.device)
  if N > 0:
    v[:, 0] = 1
  if N > 1:
    v[:, 1:] = torch.cumprod(x[:, None].expand(x.shape[0], N - 1), dim=1)
  return v if increasing else v.flip(1)


def vander(x, N=None, increasing: bool = False) -> Expr:
  """The Vandermonde matrix (int64 or float64, as NumPy promotes with
  int)."""
  x = lazify(x)
  if x.ndim != 1:
    raise ValueError("x must be a one-dimensional array or sequence.")
  return map([x], _vander_fn, fn_kw={"N": int(x.shape[0] if N is None
                                              else N),
                                     "increasing": bool(increasing)})


# -- histograms: edges and counts on the device --------------------------------

def _outer_edges(x: torch.Tensor, rng):
  """NumPy's ``_get_outer_edges``: the range given, else the data's
  min and max (0 and 1 when empty), widened by 0.5 a side when equal;
  with the dtype NumPy's ``linspace`` then computes in."""
  if rng is not None:
    lo, hi = float(rng[0]), float(rng[1])
    if lo == hi:
      lo, hi = lo - 0.5, hi + 0.5
    return (torch.tensor(lo, dtype=torch.float64, device=x.device),
            torch.tensor(hi, dtype=torch.float64, device=x.device))
  if x.numel() == 0:
    zero = torch.zeros((), dtype=torch.float64, device=x.device)
    return zero, zero + 1
  cdt = x.dtype if x.is_floating_point() else torch.float64
  lo, hi = x.min().to(cdt), x.max().to(cdt)
  same = lo == hi
  return torch.where(same, lo - 0.5, lo), torch.where(same, hi + 0.5, hi)


def _linspace(lo: torch.Tensor, hi: torch.Tensor, num: int) -> torch.Tensor:
  """NumPy's ``linspace(lo, hi, num)`` in ``lo``'s dtype (0-d ``lo`` and
  ``hi``): ``arange * step + lo``, the last value ``hi``."""
  step = (hi - lo) / (num - 1)
  y = torch.arange(num, dtype=lo.dtype, device=lo.device)
  y = torch.where(step == 0, y / (num - 1) * (hi - lo), y * step) + lo
  y[-1] = hi
  return y


def _hist_edges(x: torch.Tensor, bins, rng, edge_dtype) -> torch.Tensor:
  if not isinstance(bins, int):
    return torch.as_tensor(np.asarray(bins), device=x.device)
  lo, hi = _outer_edges(x, rng)
  return _linspace(lo, hi, bins + 1).to(edge_dtype)


def _hist_dtype(x: torch.Tensor) -> torch.dtype:
  """The edges' dtype of NumPy's ``histogram``: the data's float dtype,
  float64 for integers."""
  return x.dtype if x.is_floating_point() else torch.float64


def _bin_index(v: torch.Tensor, edges: torch.Tensor):
  """Each value's bin (``edges[i] <= v < edges[i + 1]``, the last bin
  closed) and whether it lies within the edges."""
  dt = _result(v.dtype, edges.dtype)
  v, e = v.to(dt), edges.to(dt).contiguous()
  nb = e.shape[0] - 1
  idx = torch.searchsorted(e, v.contiguous(), right=True) - 1
  idx = torch.where(v == e[-1], nb - 1, idx)
  keep = (v >= e[0]) & (v <= e[-1])
  return idx, keep


@map_mod.structural
def _histogram_fn(x, *w, bins, rng, density):
  x = x.reshape(-1)
  if x.dtype == torch.bool:
    x = x.to(torch.uint8)
  edges = _hist_edges(x, bins, rng, _hist_dtype(x))
  nb = edges.shape[0] - 1
  idx, keep = _bin_index(x, edges)
  slot = torch.where(keep, idx, nb)
  weights = w[0].reshape(-1).to(torch.float64) if w else None
  counts = torch.bincount(slot, weights=weights, minlength=nb + 1)[:nb]
  if density:
    width = (edges[1:] - edges[:-1]).to(torch.float64)
    return counts.to(torch.float64) / width / counts.sum()
  return counts.to(w[0].dtype) if w else counts


@map_mod.structural
def _bin_edges_fn(x, bins, rng):
  x = x.reshape(-1)
  if x.dtype == torch.bool:
    x = x.to(torch.uint8)
  return _hist_edges(x, bins, rng, _hist_dtype(x))


def _check_range(rng):
  if rng is not None:
    lo, hi = rng
    if lo > hi:
      raise ValueError("max must be larger than min in range parameter.")
    if not (np.isfinite(lo) and np.isfinite(hi)):
      raise ValueError(f"supplied range of [{lo}, {hi}] is not finite")


def _check_bins(bins):
  if isinstance(bins, (int, np.integer)):
    if bins < 1:
      raise ValueError("`bins` must be positive, when an integer")
    return int(bins)
  edges = np.asarray(bins)
  if edges.ndim != 1:
    raise ValueError("`bins` must be 1d, when an array")
  if np.any(edges[:-1] > edges[1:]):
    raise ValueError("`bins` must increase monotonically, when an array")
  return edges


def histogram(v, bins=10, range=None, weights=None, density: bool = False):
  """The counts of NumPy's ``histogram``, as the reference returns them
  (NumPy's edges: :func:`histogram_bin_edges`): ``bins`` equal bins over
  ``range`` (the data's min and max, found on the device, when None) or
  the given edges; values outside dropped, the last bin closed.  Counts
  are int64, the weights' dtype with ``weights``, a float64 density with
  ``density``."""
  _check_range(range)
  ins = [lazify(v)] + ([lazify(weights)] if weights is not None else [])
  return map(ins, _histogram_fn, fn_kw={"bins": _check_bins(bins),
                                        "rng": range,
                                        "density": bool(density)})


def histogram_bin_edges(v, bins=10, range=None) -> Expr:
  """NumPy's bin edges for ``histogram`` (in the data's float dtype)."""
  _check_range(range)
  return map([lazify(v)], _bin_edges_fn,
             fn_kw={"bins": _check_bins(bins), "rng": range})


def _dd_edges(sample: torch.Tensor, bins, rng):
  """``histogramdd``'s edges, one vector an axis: NumPy's ``linspace`` of
  the outer edges (float64 for a given range, the sample's float dtype for
  its own min and max), or the edges given."""
  edges = []
  for i, b in enumerate(bins):
    col = sample[:, i]
    if isinstance(b, int):
      lo, hi = _outer_edges(col, rng[i])
      edges.append(_linspace(lo, hi, b + 1))
    else:
      edges.append(torch.as_tensor(b, device=sample.device))
  return edges


@map_mod.structural
def _histogramdd_fn(sample, *w, bins, rng, density, part):
  if sample.dtype == torch.bool:
    sample = sample.to(torch.uint8)
  edges = _dd_edges(sample, bins, rng)
  if part > 0:
    return edges[part - 1]
  nbin = [e.shape[0] + 1 for e in edges]
  flat = torch.zeros(sample.shape[0], dtype=torch.int64,
                     device=sample.device)
  for i, e in enumerate(edges):
    col = sample[:, i]
    dt = _result(col.dtype, e.dtype)
    col, e = col.to(dt), e.to(dt).contiguous()
    idx = torch.searchsorted(e, col.contiguous(), right=True)
    idx = torch.where(col == e[-1], idx - 1, idx)  # the last bin closed
    flat = flat * nbin[i] + idx
  weights = w[0].reshape(-1).to(torch.float64) if w else None
  total = int(np.prod(nbin))
  hist = torch.bincount(flat, weights=weights, minlength=total)
  hist = hist.reshape(nbin).to(torch.float64)
  hist = hist[(slice(1, -1),) * len(nbin)]  # the outliers dropped
  if density:
    s = hist.sum()
    for i, e in enumerate(edges):
      shape = [1] * len(nbin)
      shape[i] = nbin[i] - 2
      hist = hist / (e[1:] - e[:-1]).to(torch.float64).reshape(shape)
    hist = hist / s
  return hist.contiguous()


def histogramdd(sample, bins=10, range=None, weights=None,
                density: bool = False):
  """``(counts, [edges an axis])`` of an ``(N, D)`` sample (or a sequence
  of D 1-D arrays), as NumPy's: float64 counts, outliers dropped, the
  last bin of each axis closed; each a lazy expr."""
  if isinstance(sample, (list, tuple)):
    sample = stack([lazify(s) for s in sample], axis=1)
  v = lazify(sample)
  if v.ndim != 2:
    raise ValueError("sample must be an (N, D) array or a sequence of D "
                     "arrays")
  d = v.shape[1]
  bins = ([_check_bins(bins)] * d if isinstance(bins, (int, np.integer))
          else [_check_bins(b) for b in bins])
  if len(bins) != d:
    raise ValueError("The dimension of bins must be equal to the dimension "
                     "of the sample x.")
  rng = [None] * d if range is None else list(range)
  if len(rng) != d:
    raise ValueError("range argument must have one entry per dimension")
  for r in rng:
    _check_range(r)
  ins = [v] + ([lazify(weights)] if weights is not None else [])
  kw = {"bins": bins, "rng": rng, "density": bool(density)}
  counts = map(ins, _histogramdd_fn, fn_kw=dict(kw, part=0))
  edges = [map(ins, _histogramdd_fn, fn_kw=dict(kw, part=i + 1))
           for i in _py.range(d)]
  return counts, edges


def histogram2d(x, y, bins=10, range=None, weights=None,
                density: bool = False):
  """``(counts, xedges, yedges)``: :func:`histogramdd` of the pairs."""
  try:
    n = len(bins)
  except TypeError:
    n = 1
  if n != 1 and n != 2:
    bins = [bins, bins]
  counts, (xe, ye) = histogramdd([x, y], bins, range, weights, density)
  return counts, xe, ye


# -- bits, gathers along an axis, functions along an axis ----------------------

@map_mod.structural
def _packbits_fn(x, axis, little):
  if axis is None:
    x, axis = x.reshape(-1), 0
  bits = torch.movedim(x != 0, axis, -1).to(torch.int32)
  pad = -bits.shape[-1] % 8
  bits = torch.nn.functional.pad(bits, (0, pad))
  bits = bits.reshape(*bits.shape[:-1], bits.shape[-1] // 8, 8)
  shifts = torch.arange(8, device=x.device, dtype=torch.int32)
  if not little:
    shifts = 7 - shifts
  out = (bits << shifts).sum(dim=-1).to(torch.uint8)
  return torch.movedim(out, -1, axis)


def packbits(v, axis=None, bitorder: str = "big") -> Expr:
  """NumPy's ``packbits``: each nonzero element one bit, eight a uint8
  along ``axis`` (flattened when None), the last byte zero-padded."""
  v = lazify(v)
  if dtype_kind(v.dtype) not in "biu":
    raise TypeError("Expected an input array of integer or boolean data "
                    "type")
  if bitorder not in ("big", "little"):
    raise ValueError("'order' must be either 'little' or 'big'")
  if axis is not None:
    axis = _norm_axis(int(axis), v.ndim)
  return map([v], _packbits_fn, fn_kw={"axis": axis,
                                       "little": bitorder == "little"})


@map_mod.structural
def _unpackbits_fn(x, axis, count, little):
  if axis is None:
    x, axis = x.reshape(-1), 0
  y = torch.movedim(x, axis, -1).to(torch.int32)
  shifts = torch.arange(8, device=x.device, dtype=torch.int32)
  if not little:
    shifts = 7 - shifts
  bits = ((y[..., None] >> shifts) & 1).to(torch.uint8)
  bits = bits.reshape(*bits.shape[:-2], bits.shape[-2] * 8)
  if count is not None:
    n = bits.shape[-1]
    keep = count if count >= 0 else n + count
    if keep > n:
      bits = torch.nn.functional.pad(bits, (0, keep - n))
    bits = bits[..., :keep]
  return torch.movedim(bits, -1, axis)


def unpackbits(v, axis=None, count=None, bitorder: str = "big") -> Expr:
  """NumPy's ``unpackbits`` of a uint8 array: eight uint8 bits a byte
  along ``axis`` (flattened when None), ``count`` of them kept (padded
  with zeros past the end; a negative count drops bits)."""
  v = lazify(v)
  if v.dtype != torch.uint8:
    raise TypeError("Expected an input array of unsigned byte data type")
  if bitorder not in ("big", "little"):
    raise ValueError("'order' must be either 'little' or 'big'")
  if axis is not None:
    axis = _norm_axis(int(axis), v.ndim)
  n = 8 * (v.size if axis is None else v.shape[axis])
  if count is not None and -count > n:
    raise ValueError("-count larger than number of elements")
  return map([v], _unpackbits_fn, fn_kw={
      "axis": axis, "count": None if count is None else int(count),
      "little": bitorder == "little"})


@map_mod.structural
def _take_along_fn(x, idx, axis):
  from spartan_tpu_torch.expr.slice import _clamped
  if axis is None:
    x, axis = x.reshape(-1), 0
  return torch.take_along_dim(x, _clamped(idx, x.shape[axis]), dim=axis)


def take_along_axis(v, indices, axis) -> Expr:
  """NumPy's ``take_along_axis``: a negative index counts from the end
  (torch's ``take_along_dim`` does not); a concrete index out of bounds
  raises ``IndexError``, an expr index is clamped, as a gather's is."""
  v, idx = lazify(v), lazify(indices)
  if dtype_kind(idx.dtype) not in "iu":
    raise IndexError("`indices` must be an integer array")
  if axis is None:
    if idx.ndim != 1:
      raise ValueError("when axis=None, `indices` must have a single "
                       "dimension.")
    n = v.size
  else:
    axis = _norm_axis(int(axis), v.ndim)
    if idx.ndim != v.ndim:
      raise ValueError("`indices` and `arr` must have the same number of "
                       "dimensions")
    n = v.shape[axis]
  if isinstance(indices, (np.ndarray, list)):
    ia = np.asarray(indices)
    if ia.size and (ia.min() < -n or ia.max() >= n):
      bad = int(ia.max() if ia.max() >= n else ia.min())
      raise IndexError(f"index {bad} is out of bounds for size {n}")
  return map([v, idx], _take_along_fn, fn_kw={"axis": axis})


@map_mod.structural
def _apply_along_fn(x, func1d, axis):
  rows = torch.movedim(x, axis, -1)
  lead = tuple(rows.shape[:-1])
  try:
    out = torch.func.vmap(func1d)(rows.reshape(-1, rows.shape[-1]))
  except Exception as err:
    raise ValueError(f"apply_along_axis: func1d cannot run under "
                     f"torch.func.vmap: {err}") from err
  res = tuple(out.shape[1:])
  out = out.reshape(lead + res)
  # NumPy: the function's axes take the place of ``axis``
  order = (list(_py.range(axis)) + list(_py.range(len(lead), len(lead)
                                                   + len(res)))
           + list(_py.range(axis, len(lead))))
  return out.permute(order)


def apply_along_axis(func1d, axis, arr) -> Expr:
  """``func1d`` of each 1-D slice along ``axis``, vectorized by
  ``torch.func.vmap`` over torch rows (the reference vmaps its
  function).  ``func1d`` takes a torch tensor; one that vmap cannot run
  (``.item()``, a branch on the data) raises ``ValueError`` with vmap's
  reason."""
  v = lazify(arr)
  return map([v], _apply_along_fn, fn_kw={
      "func1d": func1d, "axis": _norm_axis(int(axis), v.ndim)})


# -- shape helpers ---------------------------------------------------------------

def _atleast(arys, nd):
  out = []
  for a in arys:
    a = lazify(a)
    shape = tuple(a.shape)
    if len(shape) < nd:
      if nd == 3 and len(shape) == 2:
        shape = shape + (1,)
      elif nd == 3 and len(shape) == 1:
        shape = (1,) + shape + (1,)
      else:
        shape = (1,) * (nd - len(shape)) + shape
      a = reshape(a, shape)
    out.append(a)
  return out[0] if len(out) == 1 else tuple(out)


def atleast_1d(*arys):
  """Each array with at least one axis (a 0-d array becomes ``(1,)``);
  one expr for one argument, else a tuple."""
  return _atleast(arys, 1)


def atleast_2d(*arys):
  """At least two axes: ``(n,)`` becomes ``(1, n)``."""
  return _atleast(arys, 2)


def atleast_3d(*arys):
  """At least three axes: ``(n,)`` becomes ``(1, n, 1)``, ``(m, n)``
  becomes ``(m, n, 1)``."""
  return _atleast(arys, 3)


@map_mod.structural
def _broadcast_to_fn(x, shape):
  return torch.broadcast_to(_tensors(x)[0], shape)


def broadcast_to(v, shape) -> Expr:
  """``v`` broadcast to ``shape``: a view with zero strides inside the
  region, as NumPy's read-only view (writes clone their destination, and
  the fused-reduce kernel reads a contiguous copy)."""
  v = lazify(v)
  shape = _tuplify(shape)
  if np.broadcast_shapes(v.shape, shape) != shape:
    raise ValueError(f"operands could not be broadcast together with "
                     f"remapped shapes [original->remapped]: {v.shape} and "
                     f"requested shape {shape}")
  return map([v], _broadcast_to_fn, fn_kw={"shape": shape})


def broadcast_arrays(*arrays):
  """The arrays broadcast against each other: a list of exprs, as the
  reference returns them."""
  arrs = [lazify(a) for a in arrays]
  out = np.broadcast_shapes(*[a.shape for a in arrs])
  return [broadcast_to(a, out) for a in arrs]


@map_mod.structural
def _flip_fn(x, axes):
  return torch.flip(x, axes)


def flip(v, axis=None) -> Expr:
  """NumPy's ``flip``: the order of the elements reversed along ``axis``
  (every axis when None); a copy."""
  v = lazify(v)
  if axis is None:
    axes = tuple(_py.range(v.ndim))
  else:
    axes = tuple(_norm_axis(int(a), v.ndim) for a in (
        axis if isinstance(axis, (tuple, list)) else (axis,)))
  return map([v], _flip_fn, fn_kw={"axes": axes})


def fliplr(v) -> Expr:
  v = lazify(v)
  if v.ndim < 2:
    raise ValueError("Input must be >= 2-d.")
  return flip(v, axis=1)


def flipud(v) -> Expr:
  v = lazify(v)
  if v.ndim < 1:
    raise ValueError("Input must be >= 1-d.")
  return flip(v, axis=0)


def matrix_transpose(v) -> Expr:
  """The last two axes swapped: a ``TransposeExpr``."""
  v = lazify(v)
  if v.ndim < 2:
    raise ValueError("Input array must be at least 2-dimensional")
  return swapaxes(v, -2, -1)


permute_dims = transpose


def moveaxis(v, source, destination) -> Expr:
  """NumPy's ``moveaxis`` as a ``TransposeExpr``."""
  v = lazify(v)
  n = v.ndim
  src = [source] if isinstance(source, (int, np.integer)) else list(source)
  dst = ([destination] if isinstance(destination, (int, np.integer))
         else list(destination))
  src = [_norm_axis(int(a), n) for a in src]
  dst = [_norm_axis(int(a), n) for a in dst]
  if len(set(src)) != len(src) or len(set(dst)) != len(dst):
    raise ValueError("repeated axis in `source` or `destination` argument")
  if len(src) != len(dst):
    raise ValueError("`source` and `destination` arguments must have the "
                     "same number of elements")
  order = [a for a in _py.range(n) if a not in src]
  for d, s in sorted(zip(dst, src)):
    order.insert(d, s)
  return TransposeExpr(v, order)


def rollaxis(v, axis, start=0) -> Expr:
  """NumPy's ``rollaxis`` (``moveaxis``'s old spelling) as a
  ``TransposeExpr``."""
  v = lazify(v)
  n = v.ndim
  axis = _norm_axis(int(axis), n)
  if start < 0:
    start += n
  if not 0 <= start < n + 1:
    raise np.exceptions.AxisError(
        f"'start' arg requires {-n} <= start < {n + 1}, but {start} was "
        f"passed in")
  if axis < start:
    start -= 1
  axes = list(_py.range(n))
  axes.remove(axis)
  axes.insert(start, axis)
  return TransposeExpr(v, axes)


@map_mod.structural
def _rot90_fn(x, k, axes):
  return torch.rot90(x, k, axes)


def rot90(v, k=1, axes=(0, 1)) -> Expr:
  """NumPy's ``rot90``: ``k`` quarter turns from the first of ``axes``
  towards the second."""
  v = lazify(v)
  axes = tuple(axes)
  if len(axes) != 2:
    raise ValueError("len(axes) must be 2.")
  if axes[0] == axes[1] or np.absolute(axes[0] - axes[1]) == v.ndim:
    raise ValueError("Axes must be different.")
  if (axes[0] >= v.ndim or axes[0] < -v.ndim or axes[1] >= v.ndim
      or axes[1] < -v.ndim):
    raise ValueError(f"Axes={axes} out of range for array of ndim={v.ndim}.")
  return map([v], _rot90_fn, fn_kw={"k": int(k) % 4,
                                    "axes": tuple(a % v.ndim for a in axes)})


def apply_over_axes(func, v, axes) -> Expr:
  """``func(v, axis)`` over each axis in turn; a result that lost the axis
  gets it back as length 1 (NumPy's rule)."""
  res = lazify(v)
  nd = res.ndim
  for ax in ([axes] if isinstance(axes, (int, np.integer)) else axes):
    ax = int(ax) + nd if ax < 0 else int(ax)
    r = lazify(func(res, ax))
    if r.ndim != nd:
      r = expand_dims(r, ax)
      if r.ndim != nd:
        raise ValueError("function is not returning an array of the correct "
                         "shape")
    res = r
  return res


# np.pad, ported to a torch buffer: each axis in turn, the pad areas of the
# earlier axes included, as NumPy's ``_view_roi`` walks them

def _as_pairs(x, ndim, as_index=False):
  """NumPy's ``_as_pairs``: ``x`` as ``ndim`` (before, after) pairs (NumPy
  scalars where one or two values were given, Python ones else, as
  NumPy's: a linear ramp's dtype depends on it)."""
  if x is None:
    return ((None, None),) * ndim
  x = np.array(x)
  if as_index:
    x = np.round(x).astype(np.intp, copy=False)
  if x.ndim < 3:
    if x.size == 1:
      x = x.ravel()
      if as_index and x < 0:
        raise ValueError("index can't contain negative values")
      return ((x[0], x[0]),) * ndim
    if x.size == 2 and x.shape != (2, 1):
      x = x.ravel()
      if as_index and (x[0] < 0 or x[1] < 0):
        raise ValueError("index can't contain negative values")
      return ((x[0], x[1]),) * ndim
  if as_index and x.min() < 0:
    raise ValueError("index can't contain negative values")
  return [tuple(p) for p in np.broadcast_to(x, (ndim, 2)).tolist()]


def _at_axis(sl, axis):
  return (slice(None),) * axis + (sl,)


def _set_pad_area(padded, axis, width_pair, value_pair):
  left, right = (v.item() if isinstance(v, np.generic) else v
                 for v in value_pair)
  padded[_at_axis(slice(None, width_pair[0]), axis)] = left
  padded[_at_axis(slice(padded.shape[axis] - width_pair[1], None),
                  axis)] = right


def _get_edges(padded, axis, width_pair):
  left = width_pair[0]
  right = padded.shape[axis] - width_pair[1]
  return (padded[_at_axis(slice(left, left + 1), axis)],
          padded[_at_axis(slice(right - 1, right), axis)])


def _ramp(start, stop: torch.Tensor, num: int, dtype: torch.dtype, axis):
  """NumPy's ``linspace(start, stop, num, endpoint=False, dtype, axis)``
  for a scalar ``start`` (weak if a Python one, strong if a NumPy one)
  and a tensor ``stop``."""
  dt = stop.dtype
  if isinstance(start, np.generic):
    dt = _result(dt, to_torch_dtype(np.result_type(start)))
    start = start.item()
  dt = _inexact_dtype(dt)
  start = torch.tensor(start, dtype=dt, device=stop.device)
  delta = stop.to(dt) - start
  y = torch.arange(num, dtype=dt, device=stop.device).reshape(
      (-1,) + (1,) * delta.ndim)
  if num > 0:
    step = delta / num
    # NumPy's special case for denormal steps, chosen on the device
    y = torch.where((step == 0).any(), y / num * delta, y * step)
  else:
    y = y * delta
  y = torch.movedim(y + start, 0, axis)
  if not (dtype.is_floating_point or dtype.is_complex):
    y = torch.floor(y)
  return y.to(dtype)


def _get_stats(padded, axis, width_pair, length_pair, stat):
  left_index = width_pair[0]
  right_index = padded.shape[axis] - width_pair[1]
  max_length = right_index - left_index
  left_length, right_length = length_pair
  if left_length is None or max_length < left_length:
    left_length = max_length
  if right_length is None or max_length < right_length:
    right_length = max_length
  if (left_length == 0 or right_length == 0) and stat in ("maximum",
                                                          "minimum"):
    raise ValueError("stat_length of 0 yields no value for padding")
  left = _stat(padded[_at_axis(slice(left_index, left_index + left_length),
                               axis)], axis, stat)
  if left_length == right_length == max_length:
    return left, left
  right = _stat(padded[_at_axis(slice(right_index - right_length,
                                      right_index), axis)], axis, stat)
  return left, right


def _stat(chunk, axis, stat):
  """NumPy's amax/amin/mean/median of ``chunk`` along ``axis`` (kept),
  rounded half to even for an integer array."""
  if stat == "maximum":
    return torch.amax(chunk, dim=axis, keepdim=True)
  if stat == "minimum":
    return torch.amin(chunk, dim=axis, keepdim=True)
  x = chunk if chunk.is_floating_point() or chunk.is_complex() else (
      chunk.to(torch.float64))
  if stat == "mean":
    out = torch.mean(x, dim=axis, keepdim=True)
  else:
    s = torch.sort(x, dim=axis, stable=True).values
    n = s.shape[axis]
    hi = s.narrow(axis, n // 2, 1)
    out = hi if n % 2 else (s.narrow(axis, n // 2 - 1, 1) + hi) / 2
    if x.is_floating_point():  # NaN anywhere gives NaN, as NumPy's
      out = torch.where(torch.isnan(x).any(dim=axis, keepdim=True),
                        torch.full_like(out, float("nan")), out)
  if not (chunk.is_floating_point() or chunk.is_complex()):
    out = torch.round(out)
  return out


def _rev(padded, axis, start, stop):
  """``padded[start:stop:-1]`` along ``axis`` (torch slices step
  forward)."""
  idx = list(_py.range(*slice(start, stop, -1).indices(padded.shape[axis])))
  return torch.index_select(padded, axis,
                            torch.tensor(idx, dtype=torch.int64,
                                         device=padded.device))


def _set_reflect_both(padded, axis, width_pair, method, original_period,
                      include_edge):
  left_pad, right_pad = width_pair
  old_length = padded.shape[axis] - right_pad - left_pad
  if include_edge:
    old_length = old_length // original_period * original_period
    edge_offset = 1
  else:
    old_length = ((old_length - 1) // (original_period - 1)
                  * (original_period - 1) + 1)
    edge_offset = 0
    old_length -= 1
  if left_pad > 0:
    chunk_length = _py.min(old_length, left_pad)
    stop = left_pad - edge_offset
    start = stop + chunk_length
    chunk = _rev(padded, axis, start, stop)
    if method == "odd":
      edge = padded[_at_axis(slice(left_pad, left_pad + 1), axis)]
      chunk = 2 * edge - chunk
    padded[_at_axis(slice(left_pad - chunk_length, left_pad), axis)] = chunk
    left_pad -= chunk_length
  if right_pad > 0:
    chunk_length = _py.min(old_length, right_pad)
    start = -right_pad + edge_offset - 2
    stop = start - chunk_length
    chunk = _rev(padded, axis, start, stop)
    if method == "odd":
      n = padded.shape[axis]
      edge = padded[_at_axis(slice(n - right_pad - 1, n - right_pad), axis)]
      chunk = 2 * edge - chunk
    start = padded.shape[axis] - right_pad
    padded[_at_axis(slice(start, start + chunk_length), axis)] = chunk
    right_pad -= chunk_length
  return left_pad, right_pad


def _set_wrap_both(padded, axis, width_pair, original_period):
  left_pad, right_pad = width_pair
  n = padded.shape[axis]
  period = n - right_pad - left_pad
  period = period // original_period * original_period
  new_left_pad = new_right_pad = 0
  if left_pad > 0:
    slice_end = left_pad + period
    slice_start = slice_end - _py.min(period, left_pad)
    chunk = padded[_at_axis(slice(slice_start, slice_end), axis)].clone()
    if left_pad > period:
      area = slice(left_pad - period, left_pad)
      new_left_pad = left_pad - period
    else:
      area = slice(None, left_pad)
    padded[_at_axis(area, axis)] = chunk
  if right_pad > 0:
    slice_start = n - right_pad - period
    slice_end = slice_start + _py.min(period, right_pad)
    chunk = padded[_at_axis(slice(slice_start, slice_end), axis)].clone()
    if right_pad > period:
      area = slice(n - right_pad, n - right_pad + period)
      new_right_pad = right_pad - period
    else:
      area = slice(n - right_pad, None)
    padded[_at_axis(area, axis)] = chunk
  return new_left_pad, new_right_pad


_PAD_KWARGS = {"empty": (), "edge": (), "wrap": (),
               "constant": ("constant_values",),
               "linear_ramp": ("end_values",), "maximum": ("stat_length",),
               "mean": ("stat_length",), "median": ("stat_length",),
               "minimum": ("stat_length",), "reflect": ("reflect_type",),
               "symmetric": ("reflect_type",)}


@map_mod.structural
def _pad_fn(x, pad_width, mode, kw):
  shape = tuple(l + s + r for s, (l, r) in zip(x.shape, pad_width))
  padded = torch.zeros(shape, dtype=x.dtype, device=x.device)
  area = tuple(slice(l, l + s) for s, (l, r) in zip(x.shape, pad_width))
  padded[area] = x

  def roi(axis):  # NumPy's _view_roi: later axes at their original extent
    return padded[(slice(None),) * (axis + 1) + area[axis + 1:]]

  axes = _py.range(x.ndim)
  if mode == "constant":
    values = _as_pairs(kw.get("constant_values", 0), x.ndim)
    for axis, width, value in zip(axes, pad_width, values):
      _set_pad_area(roi(axis), axis, width, value)
  elif mode == "empty" or x.numel() == 0:
    pass  # zeros, or the empty axes checked when the expr was built
  elif mode == "edge":
    for axis, width in zip(axes, pad_width):
      r = roi(axis)
      _set_pad_area(r, axis, width, _get_edges(r, axis, width))
  elif mode == "linear_ramp":
    ends = _as_pairs(kw.get("end_values", 0), x.ndim)
    for axis, width, end in zip(axes, pad_width, ends):
      r = roi(axis)
      edges = _get_edges(r, axis, width)
      left, right = (_ramp(e, edge.squeeze(axis), w, x.dtype, axis)
                     for e, edge, w in zip(end, edges, width))
      _set_pad_area(r, axis, width, (left, right.flip(axis)))
  elif mode in ("maximum", "minimum", "mean", "median"):
    lengths = _as_pairs(kw.get("stat_length", None), x.ndim, as_index=True)
    for axis, width, length in zip(axes, pad_width, lengths):
      r = roi(axis)
      _set_pad_area(r, axis, width, _get_stats(r, axis, width, length, mode))
  elif mode in ("reflect", "symmetric"):
    method = kw.get("reflect_type", "even")
    for axis, (left, right) in zip(axes, pad_width):
      if x.shape[axis] == 1 and (left > 0 or right > 0):
        # NumPy's legacy rule: a singleton axis repeats its edge
        _set_pad_area(padded, axis, (left, right),
                      _get_edges(padded, axis, (left, right)))
        continue
      r = roi(axis)
      while left > 0 or right > 0:
        left, right = _set_reflect_both(r, axis, (left, right), method,
                                        x.shape[axis], mode == "symmetric")
  elif mode == "wrap":
    for axis, (left, right) in zip(axes, pad_width):
      r = roi(axis)
      period = r.shape[axis] - right - left
      while left > 0 or right > 0:
        left, right = _set_wrap_both(r, axis, (left, right), period)
  return padded


def pad(v, pad_width, mode: str = "constant", **kw) -> Expr:
  """NumPy's ``pad`` in every mode (``constant``, ``edge``,
  ``linear_ramp``, ``maximum``, ``mean``, ``median``, ``minimum``,
  ``reflect``, ``symmetric``, ``wrap``, ``empty``, with their keywords),
  ported axis by axis to a buffer on the device (``F.pad`` pads at most
  three axes and lacks most of these modes).  ``empty`` fills zeros."""
  v = lazify(v)
  if callable(mode):
    raise NotImplementedError("pad with a function as mode is not ported")
  if mode not in _PAD_KWARGS:
    raise ValueError(f"mode '{mode}' is not supported")
  extra = set(kw) - set(_PAD_KWARGS[mode])
  if extra:
    raise ValueError(f"unsupported keyword arguments for mode '{mode}': "
                     f"{extra}")
  if not np.asarray(pad_width).dtype.kind == "i":
    raise TypeError("`pad_width` must be of integral type.")
  widths = tuple(tuple(int(w) for w in p)
                 for p in _as_pairs(pad_width, v.ndim, as_index=True))
  if mode not in ("constant", "empty") and v.size == 0:
    for axis, pair in enumerate(widths):
      if v.shape[axis] == 0 and _py.any(pair):
        raise ValueError(f"can't extend empty axis {axis} using modes other "
                         f"than 'constant' or 'empty'")
  kw = {k: (tuple(np.asarray(w).tolist()) if isinstance(
      w, (list, tuple, np.ndarray)) else w) for k, w in kw.items()}
  return map([v], _pad_fn, fn_kw={"pad_width": widths, "mode": mode,
                                  "kw": kw})


# -- concatenation, stacking, tiling and splitting -----------------------------

def _check_concat(arrays, axis):
  shapes = [_shape_or_none(a) for a in arrays]
  if _py.any(s is None for s in shapes):
    return axis  # a data-dependent shape: torch checks when it runs
  nd = len(shapes[0])
  if nd == 0:
    raise ValueError("zero-dimensional arrays cannot be concatenated")
  axis = _norm_axis(int(axis), nd)
  for i, s in enumerate(shapes[1:], 1):
    if len(s) != nd:
      raise ValueError(f"all the input arrays must have same number of "
                       f"dimensions, but the array at index 0 has {nd} "
                       f"dimension(s) and the array at index {i} has "
                       f"{len(s)} dimension(s)")
    for d in _py.range(nd):
      if d != axis and s[d] != shapes[0][d]:
        raise ValueError(f"all the input array dimensions except for the "
                         f"concatenation axis must match exactly, but along "
                         f"dimension {d}, the array at index 0 has size "
                         f"{shapes[0][d]} and the array at index {i} has "
                         f"size {s[d]}")
  return axis


def concatenate(arrays, axis=0) -> Expr:
  """NumPy's ``concatenate`` (a ``ConcatenateExpr``); ``axis=None`` joins
  the flattened arrays."""
  arrays = [lazify(a) for a in arrays]
  if not arrays:
    raise ValueError("need at least one array to concatenate")
  if axis is not None:
    axis = _check_concat(arrays, axis)
  return ConcatenateExpr(arrays, axis)


concat = concatenate


def stack(arrays, axis=0) -> Expr:
  """NumPy's ``stack``: arrays of one shape along a new axis."""
  arrays = [lazify(a) for a in arrays]
  if not arrays:
    raise ValueError("need at least one array to stack")
  shapes = [_shape_or_none(a) for a in arrays]
  if _py.all(s is not None for s in shapes):
    if len(set(shapes)) != 1:
      raise ValueError("all input arrays must have the same shape")
    axis = _norm_axis(int(axis), len(shapes[0]) + 1)
  return StackExpr(arrays, axis)


def vstack(arrays) -> Expr:
  """NumPy's ``vstack``: every array at least 2-D, joined along axis 0 (a
  1-D beside a 2-D array works, where the reference raises)."""
  arrs = [atleast_2d(a) for a in arrays]
  return concatenate(arrs, 0)


def hstack(arrays) -> Expr:
  """NumPy's ``hstack``: along axis 1, or axis 0 for 1-D arrays."""
  arrs = [atleast_1d(a) for a in arrays]
  return concatenate(arrs, 0 if arrs and arrs[0].ndim == 1 else 1)


def dstack(arrays) -> Expr:
  """NumPy's ``dstack``: every array at least 3-D, along axis 2."""
  return concatenate([atleast_3d(a) for a in arrays], 2)


def column_stack(arrays) -> Expr:
  """NumPy's ``column_stack``: 1-D arrays as columns, along axis 1."""
  arrs = []
  for a in arrays:
    a = lazify(a)
    if a.ndim < 2:
      a = reshape(a, (-1, 1) if a.ndim == 1 else (1, 1))
    arrs.append(a)
  return concatenate(arrs, 1)


def tile(v, reps) -> Expr:
  """NumPy's ``tile`` (a ``TileExpr``)."""
  return TileExpr(lazify(v), reps)


def append(a, b, axis=None) -> Expr:
  a, b = lazify(a), lazify(b)
  if axis is None:
    return concatenate([ravel(a), ravel(b)], axis=0)
  return concatenate([a, b], axis=axis)


def block(arrays) -> Expr:
  """NumPy's ``block``: nested lists joined innermost along the last
  axis, each level out one axis further, the leaves raised to the
  result's rank with leading unit axes; ``ConcatenateExpr`` nodes."""
  if isinstance(arrays, tuple):
    raise TypeError("arrays is a tuple. Only lists can be used to arrange "
                    "blocks, and np.block does not allow implicit conversion "
                    "from tuple to ndarray.")

  def depth(x, where):
    if isinstance(x, tuple):
      raise TypeError(f"{where} is a tuple. Only lists can be used to "
                      f"arrange blocks, and np.block does not allow implicit "
                      f"conversion from tuple to ndarray.")
    if not isinstance(x, list):
      return 0, lazify(x).ndim
    if not x:
      raise ValueError(f"List at {where} cannot be empty")
    found = [depth(e, f"{where}[{i}]") for i, e in enumerate(x)]
    if len({d for d, _ in found}) != 1:
      raise ValueError(f"List depths are mismatched at {where}")
    return found[0][0] + 1, _py.max(nd for _, nd in found)

  list_depth, max_nd = depth(arrays, "arrays")
  result_nd = _py.max(list_depth, max_nd)

  def build(x, level):
    if not isinstance(x, list):
      e = lazify(x)
      if e.ndim < result_nd:
        e = reshape(e, (1,) * (result_nd - e.ndim) + tuple(e.shape))
      return e
    parts = [build(e, level + 1) for e in x]
    return concatenate(parts, axis=-(list_depth - level))

  return build(arrays, 0)


@map_mod.structural
def _insert_fn(x, values, axis, index, positions, old_mask):
  if axis is None:
    x, axis = x.reshape(-1), 0
  values = _tensors(x, values)[1].to(x.dtype)
  n = x.shape[axis]
  if index is not None:  # one index: NumPy's a[:, i:i+k, :] = values form
    vals = values.reshape((1,) * (x.ndim - values.ndim) + tuple(
        values.shape)) if values.ndim < x.ndim else values
    vals = torch.movedim(vals, 0, axis)
    numnew = vals.shape[axis]
    shape = list(x.shape)
    shape[axis] = numnew
    vals = torch.broadcast_to(vals, shape)
    return torch.cat([x.narrow(axis, 0, index), vals,
                      x.narrow(axis, index, n - index)], dim=axis)
  shape = list(x.shape)
  shape[axis] += len(positions)
  new = torch.zeros(shape, dtype=x.dtype, device=x.device)
  pos = torch.tensor(positions, dtype=torch.int64, device=x.device)
  keep = torch.tensor(old_mask, dtype=torch.bool, device=x.device)
  lead = (slice(None),) * axis
  slot_shape = list(x.shape)
  slot_shape[axis] = len(positions)
  new[lead + (pos,)] = torch.broadcast_to(values, slot_shape)
  new[lead + (keep,)] = x
  return new


def insert(v, obj, values, axis=None) -> Expr:
  """NumPy's ``insert`` at static positions ``obj`` (an int, a slice or a
  sequence), ``values`` cast to ``v``'s dtype."""
  v = lazify(v)
  nd = 1 if axis is None else v.ndim
  if axis is not None:
    axis = _norm_axis(int(axis), nd)
  n = v.size if axis is None else v.shape[axis]
  if isinstance(obj, slice):
    idx = np.arange(*obj.indices(n))
  else:
    idx = np.asarray(obj)
    if idx.dtype == bool:
      raise IndexError("boolean obj is not ported for insert")
    idx = idx.astype(np.intp)
  kw = {"axis": axis, "index": None, "positions": None, "old_mask": None}
  if idx.ndim == 0:
    index = int(idx)
    if index < -n or index > n:
      raise IndexError(f"index {obj} is out of bounds for axis {axis or 0} "
                       f"with size {n}")
    kw["index"] = index + n if index < 0 else index
  else:
    idx = idx.reshape(-1).copy()
    idx[idx < 0] += n
    order = idx.argsort(kind="mergesort")
    idx[order] += np.arange(len(idx))
    old_mask = np.ones(n + len(idx), dtype=bool)
    old_mask[idx] = False
    kw["positions"] = tuple(int(i) for i in idx)
    kw["old_mask"] = tuple(bool(b) for b in old_mask)
  return map([v, lazify(values)], _insert_fn, fn_kw=kw)


@map_mod.structural
def _delete_fn(x, axis, keep):
  if axis is None:
    x, axis = x.reshape(-1), 0
  return torch.index_select(x, axis, torch.tensor(keep, dtype=torch.int64,
                                                  device=x.device))


def delete(v, obj, axis=None) -> Expr:
  """NumPy's ``delete`` of static positions ``obj`` (an int, a slice, a
  sequence or a boolean mask)."""
  v = lazify(v)
  if axis is not None:
    axis = _norm_axis(int(axis), v.ndim)
  n = v.size if axis is None else v.shape[axis]
  keep = np.ones(n, dtype=bool)
  if isinstance(obj, slice):
    keep[obj] = False
  elif isinstance(obj, (int, np.integer)) and not isinstance(obj, bool):
    if obj < -n or obj >= n:
      raise IndexError(f"index {obj} is out of bounds for axis {axis or 0} "
                       f"with size {n}")
    keep[obj] = False
  else:
    o = np.asarray(obj)
    if o.dtype == bool:
      if o.shape != (n,):
        raise ValueError(f"boolean array argument obj to delete must be one "
                         f"dimensional and match the axis length of {n}")
      keep = ~o
    else:
      keep[o.astype(np.intp).reshape(-1)] = False
  return map([v], _delete_fn, fn_kw={
      "axis": axis, "keep": tuple(int(i) for i in np.flatnonzero(keep))})


@map_mod.structural
def _roll_fn(x, shifts, dims):
  if dims is None:
    return torch.roll(x.reshape(-1), shifts).reshape(x.shape)
  return torch.roll(x, shifts, dims)


def roll(v, shift, axis=None) -> Expr:
  """NumPy's ``roll`` (shifts of one axis add up, as NumPy's do)."""
  v = lazify(v)
  if axis is None:
    return map([v], _roll_fn, fn_kw={"shifts": int(np.sum(shift)),
                                     "dims": None})
  total: dict = {}
  for s, a in np.broadcast(shift, axis):
    a = _norm_axis(int(a), v.ndim)
    total[a] = total.get(a, 0) + int(s)
  dims = tuple(sorted(total))
  return map([v], _roll_fn, fn_kw={"shifts": tuple(total[a] for a in dims),
                                   "dims": dims})


def split(v, indices_or_sections, axis=0):
  """A list of slice exprs; an int must divide the axis evenly."""
  v = lazify(v)
  n = v.shape[axis]
  if isinstance(indices_or_sections, (int, np.integer)) and n % int(
      indices_or_sections):
    raise ValueError("array split does not result in an equal division")
  return array_split(v, indices_or_sections, axis)


def array_split(v, indices_or_sections, axis=0):
  """A list of slice exprs: ``k`` sections (the first ``n % k`` one
  longer) or the pieces between the indices given."""
  v = lazify(v)
  axis = _norm_axis(int(axis), v.ndim)
  n = int(v.shape[axis])
  if isinstance(indices_or_sections, (int, np.integer)):
    k = int(indices_or_sections)
    if k <= 0:
      raise ValueError("number sections must be larger than 0.")
    each, extra = _py.divmod(n, k)
    sizes = [0] + extra * [each + 1] + (k - extra) * [each]
    points = np.cumsum(sizes).tolist()
  else:
    points = [0] + [int(i) for i in indices_or_sections] + [n]
  out = []
  for lo, hi in zip(points[:-1], points[1:]):
    idx = [slice(None)] * v.ndim
    idx[axis] = slice(lo, hi)
    out.append(v[tuple(idx)])
  return out


def hsplit(v, indices_or_sections):
  v = lazify(v)
  if v.ndim == 0:
    raise ValueError("hsplit only works on arrays of 1 or more dimensions")
  return split(v, indices_or_sections, axis=1 if v.ndim > 1 else 0)


def vsplit(v, indices_or_sections):
  v = lazify(v)
  if v.ndim < 2:
    raise ValueError("vsplit only works on arrays of 2 or more dimensions")
  return split(v, indices_or_sections, axis=0)


def dsplit(v, indices_or_sections):
  v = lazify(v)
  if v.ndim < 3:
    raise ValueError("dsplit only works on arrays of 3 or more dimensions")
  return split(v, indices_or_sections, axis=2)


# -- scans ---------------------------------------------------------------------

def cumsum(v, axis=None) -> Expr:
  return scan_mod.scan(v, "sum", axis=axis)


def cumprod(v, axis=None) -> Expr:
  return scan_mod.scan(v, "prod", axis=axis)


def cummax(v, axis=None) -> Expr:
  return scan_mod.scan(v, "max", axis=axis)


def cummin(v, axis=None) -> Expr:
  return scan_mod.scan(v, "min", axis=axis)


scan = scan_mod.scan


def _nan_as_zero(x):
  if not isinstance(x, torch.Tensor):
    return type(x)(0) if x != x else x  # a weak scalar stays weak
  return torch.where(torch.isnan(x), torch.zeros((), dtype=x.dtype,
                                                 device=x.device), x)


def nancumsum(v, axis=None) -> Expr:
  """``cumsum`` with NaN counted as 0."""
  v = lazify(v)
  if dtype_kind(v.dtype) not in "fc":
    return cumsum(v, axis=axis)
  return cumsum(map([v], _nan_as_zero), axis=axis)


def nancumprod(v, axis=None) -> Expr:
  """``cumprod`` with NaN counted as 1."""
  v = lazify(v)
  if dtype_kind(v.dtype) not in "fc":
    return cumprod(v, axis=axis)
  return cumprod(map([v], _nan_as_one), axis=axis)


@map_mod.structural
def _unwrap_fn(p, discont, axis, period):
  p, = _tensors(p)
  dd = _diff_fn(p, 1, axis)
  if discont is None:
    discont = period / 2
  if dtype_kind(dd.dtype) in "iu" and isinstance(period, (int, np.integer)):
    interval_high, rem = _py.divmod(period, 2)  # NumPy's integer unwrap
    ambiguous = rem == 0
  else:
    interval_high, ambiguous = period / 2, True
  interval_low = -interval_high
  ops = _np_ops
  ddmod = ops["add"](ops["remainder"](ops["subtract"](dd, interval_low),
                                      period), interval_low)
  if ambiguous:  # abs(dd) == period / 2 keeps the sign of dd
    ddmod = torch.where((ddmod == interval_low) & (dd > 0), interval_high,
                        ddmod)
  ph_correct = ops["subtract"](ddmod, dd)
  ph_correct = torch.where(ops["less"](ops["absolute"](dd), discont), 0,
                           ph_correct)
  tail = p.narrow(axis, 1, _py.max(p.shape[axis] - 1, 0))
  return torch.cat([p.narrow(axis, 0, _py.min(p.shape[axis], 1)).to(
      ph_correct.dtype), ops["add"](tail, torch.cumsum(ph_correct, axis))],
                   axis)


def unwrap(p, discont=None, axis=-1, period=2 * np.pi) -> Expr:
  """NumPy's ``unwrap``: jumps of more than ``max(discont, period / 2)``
  between neighbours along ``axis`` taken back by multiples of
  ``period`` (its algorithm: ``diff``, the wrapped differences, and the
  ``cumsum`` of the corrections)."""
  p = lazify(p)
  return map([p], _unwrap_fn, fn_kw={"discont": discont,
                                     "axis": _norm_axis(int(axis), p.ndim),
                                     "period": period})


# -- sorting, order statistics and searching -----------------------------------

def sort(v, axis=-1) -> Expr:
  return SortExpr(lazify(v), axis, "sort")


def argsort(v, axis=-1) -> Expr:
  """NumPy's ``argsort``; of a 0-d array, ``[0]`` (NumPy sorts it as the
  one-element vector it ravels to)."""
  v = lazify(v)
  if v.ndim == 0 and axis is not None:
    v, axis = ravel(v), 0
  return SortExpr(v, axis, "argsort")


def msort(v) -> Expr:
  return sort(v, axis=0)


def partition(v, kth, axis=-1) -> Expr:
  """NumPy's ``partition`` by a full sort, as the reference: element
  ``kth`` lands at its sorted place with the smaller values before it and
  the larger after, which a total sort satisfies."""
  del kth
  return SortExpr(lazify(v), axis, "sort")


def argpartition(v, kth, axis=-1) -> Expr:
  del kth
  return SortExpr(lazify(v), axis, "argsort")


def _check_interpolable(v: Expr):
  if v.dtype == torch.bool:  # NumPy's lerp subtracts: it raises too
    raise TypeError("numpy boolean subtract, the `-` operator, is not "
                    "supported, use the bitwise_xor, the `^` operator, or "
                    "the logical_xor function instead.")


def _check_percent(q):
  qa = np.asarray(q)
  if np.any(qa < 0) or np.any(qa > 100):
    raise ValueError("Percentiles must be in the range [0, 100]")


def _check_fraction(q):
  qa = np.asarray(q)
  if np.any(qa < 0) or np.any(qa > 1):
    raise ValueError("Quantiles must be in the range [0, 1]")


def _fractions(q):
  """The percentiles ``q`` as fractions, divided by 100 once in float64."""
  return np.true_divide(np.asarray(q, np.float64), 100)


def percentile(v, q, axis=None) -> Expr:
  """NumPy's ``percentile`` by its ``linear`` method (float64 for
  integers, the dtype of a float array)."""
  v = lazify(v)
  _check_percent(q)
  _check_interpolable(v)
  return PercentileExpr(v, _fractions(q), axis)


def median(v, axis=None) -> Expr:
  return PercentileExpr(lazify(v), 0.5, axis)


def quantile(v, q, axis=None) -> Expr:
  """NumPy's quantile (q in [0, 1])."""
  v = lazify(v)
  _check_fraction(q)
  _check_interpolable(v)
  return PercentileExpr(v, q, axis)


def nanmedian(v, axis=None) -> Expr:
  """``median`` of the values that are not NaN (NaN for a slice of NaN
  only), from the sort with NaN last and each slice's count."""
  return PercentileExpr(lazify(v), 0.5, axis, ignore_nan=True)


def nanpercentile(v, q, axis=None) -> Expr:
  v = lazify(v)
  _check_percent(q)
  _check_interpolable(v)
  return PercentileExpr(v, _fractions(q), axis, ignore_nan=True)


def nanquantile(v, q, axis=None) -> Expr:
  v = lazify(v)
  _check_fraction(q)
  _check_interpolable(v)
  return PercentileExpr(v, q, axis, ignore_nan=True)


def _searchsorted(a: torch.Tensor, v: torch.Tensor, right: bool):
  """``np.searchsorted(a, v, side)`` of a sorted 1-D ``a`` (NaN last): in
  NumPy's order NaN is above every number (torch's search treats a NaN
  boundary as below).  The NaNs of ``a`` become inf for the search; a
  NaN query goes after the numbers (left) or at the end (right), an inf
  query with ``right`` before the NaNs."""
  a, v = _tensors(*map_mod.promote(a, v))
  if a.dtype == torch.bool:
    a, v = a.to(torch.uint8), v.to(torch.uint8)
  shape = v.shape
  v = v.reshape(-1).contiguous()
  if not a.is_floating_point():
    return torch.searchsorted(a.contiguous(), v, right=right).reshape(shape)
  numbers = (~torch.isnan(a)).sum()
  out = torch.searchsorted(
      torch.where(torch.isnan(a), float("inf"), a).contiguous(), v,
      right=right)
  if right:
    out = torch.where(v == float("inf"), numbers, out)
    out = torch.where(torch.isnan(v), a.shape[0], out)
  else:
    out = torch.where(torch.isnan(v), numbers, out)
  return out.reshape(shape)


@map_mod.structural
def _searchsorted_fn(a, v, side):
  return _searchsorted(a, v, side == "right")


def _check_sorted_operand(a: Expr, name: str):
  if a.ndim != 1:
    raise ValueError(f"{name} must be 1-dimensional")
  if a.dtype.is_complex:
    raise TypeError(f"searching complex {name} is not supported")


def searchsorted(v, queries, side="left") -> Expr:
  """NumPy's ``searchsorted`` of ``queries`` in the sorted 1-D ``v``
  (int64 indices; both promoted to NumPy's common type)."""
  if side not in ("left", "right"):
    raise ValueError(f"side must be 'left' or 'right' (got {side!r})")
  v = lazify(v)
  _check_sorted_operand(v, "a")
  return map([v, lazify(queries)], _searchsorted_fn, fn_kw={"side": side})


@map_mod.structural
def _digitize_fn(x, bins, right):
  bins, = _tensors(bins)
  if bins.shape[0] == 0:
    return _searchsorted(bins, x, not right)
  desc = bins[-1] < bins[0]
  idx = _searchsorted(torch.where(desc, bins.flip(0), bins), x, not right)
  return torch.where(desc, bins.shape[0] - idx, idx)


def digitize(x, bins, right=False) -> Expr:
  """NumPy's ``digitize``: bins increasing, or decreasing (the last below
  the first, decided on the device; then NumPy's ``len(bins) -
  searchsorted(bins[::-1], x)``)."""
  x, bins = lazify(x), lazify(bins)
  if x.dtype.is_complex:
    raise TypeError("x may not be complex")
  _check_sorted_operand(bins, "bins")
  return map([x, bins], _digitize_fn, fn_kw={"right": bool(right)})


@map_mod.structural
def _lexsort_fn(*keys, axis):
  keys = torch.broadcast_tensors(*_tensors(*keys))
  order = sort_mod.argsort(keys[0], axis)
  for k in keys[1:]:
    order = torch.take_along_dim(order, sort_mod.argsort(
        torch.take_along_dim(k, order, axis), axis), axis)
  return order


def lexsort(keys, axis=-1) -> Expr:
  """NumPy's ``lexsort``: the last key sorts first, by successive stable
  argsorts from the first key to the last."""
  ins = [lazify(k) for k in keys]
  if not ins:
    raise TypeError("need sequence of keys with len > 0 in lexsort")
  return map(ins, _lexsort_fn, fn_kw={"axis": axis})


_COMPLEX64_FROM = (torch.int8, torch.int16, torch.uint8)


@map_mod.structural
def _sort_complex_fn(x):
  out = torch.complex64 if x.dtype in _COMPLEX64_FROM else torch.complex128
  return sort_mod.sort(x, -1).to(x.dtype if x.is_complex() else out)


def sort_complex(v) -> Expr:
  """NumPy's ``sort_complex``: sorted along the last axis by the real
  part, then the imaginary part, as complex (NumPy's complex64 for int8,
  int16 and uint8, complex128 for the other real dtypes)."""
  v = lazify(v)
  _norm_axis(-1, v.ndim)
  return map([v], _sort_complex_fn)


def permutation(v) -> Expr:
  """A random permutation (``np.random.permutation``): an int gives a
  permuted ``arange``, an array is permuted along axis 0; the argsort of
  uniform random keys, as the reference (its stream differs from
  ``jax.random``'s)."""
  if isinstance(v, (int, np.integer)):
    return argsort(rand(int(v)))
  v = lazify(v)
  return take(v, argsort(rand(v.shape[0])), axis=0)


def choice(v, size, replace: bool = True) -> Expr:
  """A random sample of a 1-D population (``np.random.choice``): with
  replacement a gather at uniform random indices, without the first
  ``size`` entries of a permutation."""
  if isinstance(v, (int, np.integer)):
    v = arange(int(v))
  v = lazify(v)
  if len(v.shape) != 1:
    raise ValueError("a must be 1-dimensional")
  n = v.shape[0]
  size = int(size)
  if replace:
    return take(v, randint(0, n, size=(size,)))
  if size > n:
    raise ValueError("cannot take a larger sample than population when "
                     "replace=False")
  return take(v, permutation(n)[:size])


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
    # contractions and the linear-algebra helpers
    "matmul", "tensordot", "einsum", "einsum_path", "inner", "vdot",
    "vecdot", "kron", "cross", "diag", "diagflat", "tril", "triu",
    "fill_diagonal", "norm",
    # statistics and calculus
    "amax", "amin", "ptp", "average", "cov", "corrcoef", "nanargmax",
    "nanargmin", "nanprod", "diff", "ediff1d", "gradient", "interp",
    "trapezoid", "trapz", "convolve", "correlate",
    # polynomials, histograms, bits and functions along an axis
    "poly", "polyadd", "polysub", "polymul", "polyder", "polyint", "polydiv",
    "polyfit", "polyval", "roots", "vander", "histogram",
    "histogram_bin_edges", "histogram2d", "histogramdd", "packbits",
    "unpackbits", "take_along_axis", "apply_along_axis",
    # shape helpers
    "atleast_1d", "atleast_2d", "atleast_3d", "broadcast_arrays",
    "broadcast_to", "flip", "fliplr", "flipud", "matrix_transpose",
    "moveaxis", "permute_dims", "rollaxis", "rot90", "apply_over_axes",
    "pad",
    # concatenation, stacking, tiling and splitting
    "concatenate", "concat", "stack", "vstack", "hstack", "dstack",
    "column_stack", "tile", "append", "block", "insert", "delete", "roll",
    "split", "array_split", "hsplit", "vsplit", "dsplit",
    # scans, sorts, order statistics and searches
    "cumsum", "cumprod", "cummax", "cummin", "scan", "nancumsum",
    "nancumprod", "unwrap", "sort", "argsort", "msort", "partition",
    "argpartition", "percentile", "median", "quantile", "nanmedian",
    "nanpercentile", "nanquantile", "searchsorted", "digitize", "lexsort",
    "sort_complex", "permutation", "choice",
]
