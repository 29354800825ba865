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


def promote(x, y, name: str = ""):
  """``x`` and ``y`` cast as NumPy promotes them for the binary ufunc
  ``name`` (a weak Python scalar stays a Python scalar)."""
  int_div = name in ("true_divide", "divide")
  xt, yt = isinstance(x, torch.Tensor), isinstance(y, torch.Tensor)
  if xt and yt:
    dt = result_type(x.dtype, y.dtype)
    if int_div and dtype_kind(dt) in "biu":
      dt = torch.float64  # numpy: int / int → float64
    elif dt == torch.bool and name in _BOOL_AS_INT8:
      dt = torch.int8  # numpy: the arithmetic of bools is int8's
    return x.to(dt), y.to(dt)
  if xt or yt:
    t, s = (x, y) if xt else (y, x)
    kind = dtype_kind(t.dtype)
    if kind in "biu" and (isinstance(s, float) or int_div):
      t = t.to(torch.float64)  # weak float against ints → default float
    elif kind == "b" and isinstance(s, int) and not isinstance(s, bool):
      t = t.to(torch.int64)  # weak int against bool → default int
    elif kind == "b" and name in _BOOL_AS_INT8:
      t = t.to(torch.int8)
    elif t.dtype in _HALF and isinstance(s, (int, float)) and not (
        isinstance(s, bool)):
      # a weak scalar takes the 16-bit tensor's dtype, as in JAX: torch
      # would compute with it unrounded, in float32
      s = float(torch.tensor(s, dtype=t.dtype))
    return (t, s) if xt else (s, t)
  return x, y


def _numpy_promoting(fn: Callable) -> Callable:
  """Wrap a binary op so operands promote by NumPy's rules."""
  name = getattr(fn, "__name__", "")

  def wrapped(x, y):
    return fn(*promote(x, y, name))

  wrapped.__name__ = name or "binary"
  wrapped.__qualname__ = f"np_promoting_{name}"
  return wrapped


_PROMOTING_CACHE: Dict[Callable, Callable] = {}
_HALF = (torch.bfloat16, torch.float16)
# ufuncs whose bool operands compute as int8, as NumPy's loops do
_BOOL_AS_INT8 = ("floor_divide", "remainder", "fmod", "power", "left_shift",
                 "right_shift")


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
  if (isinstance(x, (int, float)) and isinstance(y, torch.Tensor)
      and y.is_floating_point()):
    # torch divides a real Python scalar by a float tensor as a reciprocal
    # and a product, off by an ulp; a 0-d tensor divides IEEE-rounded
    x = torch.tensor(x, dtype=y.dtype, device=y.device)
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
  if isinstance(x, torch.Tensor) and x.dtype == torch.bool:
    return x  # NumPy: abs of bool is bool, unchanged
  return _py.abs(x)


def square(x):
  return x * x


def sqrt(x):
  return torch.sqrt(_inexact(x))


def exp(x):
  return torch.exp(_inexact(x))


def log(x):
  return torch.log(_inexact(x))


def _lift(v, device=None) -> torch.Tensor:
  """A weak Python scalar as a 0-d tensor of its Python type's dtype:
  torch promotes a 0-d tensor as NumPy does a weak scalar (the
  dimensioned operand's dtype wins within a kind)."""
  if isinstance(v, torch.Tensor):
    return v
  return torch.tensor(v, dtype=_PY_DTYPES[type(v)], device=device)


_PY_DTYPES = {bool: torch.bool, int: torch.int64, float: torch.float64,
              complex: torch.complex128}


def _tensors(x, y):
  """Both operands as tensors on the device of the one that is one."""
  like = x if isinstance(x, torch.Tensor) else y
  device = like.device if isinstance(like, torch.Tensor) else None
  return _lift(x, device), _lift(y, device)


def _integral(x, y) -> bool:
  return all(dtype_kind(v.dtype) in "biu" if isinstance(v, torch.Tensor)
             else isinstance(v, int) for v in (x, y))


def _zero_guarded(op: Callable, x, y):
  """``op(x, y)`` for integer operands, 0 where ``y`` is 0, as NumPy
  gives: torch raises there on the CPU and leaves it undefined on CUDA."""
  x, y = _tensors(x, y)
  zero = y == 0
  out = op(x, torch.where(zero, torch.ones_like(y), y))
  return torch.where(zero, torch.zeros_like(out), out)


def floor_divide(x, y):
  """NumPy's ``floor_divide``; an integer ``x // 0`` is 0, a float one
  ±inf or nan (torch's and NumPy's IEEE quotient)."""
  if _integral(x, y):
    return _zero_guarded(torch.floor_divide, x, y)
  return torch.floor_divide(*_tensors(x, y))


def remainder(x, y):
  """NumPy's ``remainder`` (``mod``): the sign of the divisor; an integer
  ``x % 0`` is 0."""
  if _integral(x, y):
    return _zero_guarded(torch.remainder, x, y)
  return torch.remainder(*_tensors(x, y))


def fmod(x, y):
  """C's ``fmod``: the sign of the dividend; an integer ``fmod(x, 0)`` is
  0."""
  if _integral(x, y):
    return _zero_guarded(torch.fmod, x, y)
  return torch.fmod(*_tensors(x, y))


def power(x, y):
  """``x ** y``.  A negative integer exponent of an integer base gives
  torch's (and the reference's) integer result, 0 unless the base is
  ±1; a negative Python int exponent is refused when the expr is built
  (:func:`check_power`).  A Python scalar exponent stays a scalar, so
  torch takes its scalar fast paths (2: a square, 0.5: a square root),
  as K1's translator does (``fused_reduce._POWERS``)."""
  if not isinstance(x, torch.Tensor) and not isinstance(y, torch.Tensor):
    x = _lift(x)
  return torch.pow(x, y)


def float_power(x, y):
  return torch.float_power(*_tensors(x, y))


def equal(x, y):
  return x == y


def not_equal(x, y):
  return x != y


def _bitwise(name: str, op: Callable) -> Callable:
  def fn(x, y):
    for v in (x, y):
      if (isinstance(v, torch.Tensor) and dtype_kind(v.dtype) not in "biu"
          or isinstance(v, (float, complex))):
        raise TypeError(f"ufunc '{name}' not supported for the input types "
                        f"(integers and bools only)")
    return op(x, y)
  fn.__name__ = name
  return fn


bitwise_and = _bitwise("bitwise_and", lambda x, y: x & y)
bitwise_or = _bitwise("bitwise_or", lambda x, y: x | y)
bitwise_xor = _bitwise("bitwise_xor", lambda x, y: x ^ y)
left_shift = _bitwise("left_shift", lambda x, y: x << y)
right_shift = _bitwise("right_shift", lambda x, y: x >> y)


def logical_and(x, y):
  return torch.logical_and(*_tensors(x, y))


def logical_or(x, y):
  return torch.logical_or(*_tensors(x, y))


def logical_xor(x, y):
  return torch.logical_xor(*_tensors(x, y))


def bitwise_not(x):
  x = _lift(x)
  if dtype_kind(x.dtype) not in "biu":
    raise TypeError("ufunc 'invert' not supported for the input types "
                    "(integers and bools only)")
  return ~x


def logical_not(x):
  return torch.logical_not(_lift(x))


def isnan(x):
  return torch.isnan(_lift(x))


def isinf(x):
  return torch.isinf(_lift(x))


def isfinite(x):
  return torch.isfinite(_lift(x))


def sign(x):
  """NumPy's ``sign``: nan stays nan (torch gives 0)."""
  x = _lift(x)
  if x.dtype == torch.bool:
    raise TypeError("ufunc 'sign' did not contain a loop for bool")
  if x.is_floating_point():
    return torch.where(torch.isnan(x), x, torch.sign(x))
  return torch.sign(x)


def reciprocal(x):
  x = _lift(x)
  if dtype_kind(x.dtype) in "biu":
    # NumPy's integer reciprocal: 1 for ±1 as the sign, 0 otherwise
    return torch.where(x.abs() == 1, x, torch.zeros_like(x)).to(x.dtype)
  return torch.reciprocal(x)


def positive(x):
  """``+x`` as a copy (NumPy's ``positive``, which has no bool loop)."""
  x = _lift(x)
  if x.dtype == torch.bool:
    raise TypeError("ufunc 'positive' did not contain a loop for bool")
  return x.clone()


def round(x, decimals: int = 0):
  """NumPy's ``round`` (``around``): half to even; ``decimals`` scales
  by ``10**decimals`` first.  An integer array rounds only to a negative
  ``decimals``."""
  x = _lift(x)
  if dtype_kind(x.dtype) in "biu":
    if decimals >= 0:
      return x.clone()
    f = 10 ** -decimals
    return (torch.round(x.to(torch.float64) / f) * f).to(x.dtype)
  return torch.round(x, decimals=decimals)


def conj(x):
  """NumPy's ``conjugate``: a copy of a real array (bool as int8, as
  NumPy's loops give it)."""
  x = _lift(x)
  if x.dtype == torch.bool:
    return x.to(torch.int8)
  return torch.conj_physical(x) if x.is_complex() else x.clone()


def copy(x):
  return _lift(x).clone()


def check_power(base, exponent) -> None:
  """NumPy's refusal, when the expr is built, of an integer (or bool)
  base raised to a negative Python int."""
  if (isinstance(exponent, (int, np.integer))
      and not isinstance(exponent, (bool, np.bool_)) and exponent < 0
      and isinstance(base, Expr) and dtype_kind(base.dtype) in "biu"):
    raise ValueError("Integers to negative integer powers are not allowed.")


# the operator ``x ** c`` on a float array, for these Python scalars c,
# takes NumPy's fast path (``sp.power`` stays ``pow``)
_FAST_POWERS = {2: "square", 0.5: "sqrt", -1: "reciprocal", 1: "positive"}


def power_operator(base: Expr, exponent) -> MapExpr:
  """``base ** exponent``."""
  check_power(base, exponent)
  if type(exponent) in (int, float) and dtype_kind(base.dtype) in "fc":
    name = _FAST_POWERS.get(exponent)
    if name is not None:
      return map1(base, UNARY[name])
  return map2(base, exponent, BINARY["power"])


# The kernel's op table (backend/kernels/fused_reduce.OPS) holds a subset:
# its translator refuses the rest (the comparisons and bitwise ops give
# bool or integers) up front.
BINARY = {f.__name__: f for f in (
    add, subtract, multiply, true_divide, maximum, minimum, less,
    less_equal, greater, greater_equal, floor_divide, remainder, fmod,
    power, float_power, equal, not_equal, bitwise_and, bitwise_or,
    bitwise_xor, left_shift, right_shift, logical_and, logical_or,
    logical_xor)}
UNARY = {f.__name__: f for f in (
    negative, absolute, square, sqrt, exp, log, bitwise_not, logical_not,
    isnan, isinf, isfinite, sign, reciprocal, positive, conj, copy)}

# what map kernels actually hold: binary ops wrapped for NumPy promotion
UFUNCS: Dict[str, Callable] = dict(UNARY)
UFUNCS.update({name: _numpy_promoting(f) for name, f in BINARY.items()})
_PROMOTING_CACHE.update({f: UFUNCS[name] for name, f in BINARY.items()})
