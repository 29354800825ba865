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
Where torch's function differs from NumPy's (no ``cbrt``, ``spacing``,
``modf`` or popcount; ``imag`` of a real tensor; ``heaviside`` of nan;
``gcd``/``lcm`` of floats; ``ldexp``'s rounding of ``2**e``), the ufunc
here computes NumPy's.  ``map_with_location`` hands its function the
global index grids as well.
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
    return self.op.evaluate(deps, device=ctx.device)

  def _weak_operands(self) -> bool:
    return True  # its structural calls lift them (``local.FnCallExpr``)

  def _sig_local(self, memo, result):
    return ("MapExpr", self.op.signature(),
            tuple(self._child_sig(c, memo, result) for c in self.inputs))


class MapWithLocationExpr(Expr):
  """``fn(*values, coords, **fn_kw)``: a map that also sees the global index
  grids of its first input's shape, ``coords[d]`` the index along axis d as
  int32 (the reference's ``broadcasted_iota``), a broadcast view."""

  _members = ("inputs",)
  _params = ("fn", "fn_kw")

  def __init__(self, inputs: Sequence[Expr], fn: Callable, fn_kw=None):
    super().__init__(inputs=list(inputs), fn=fn, fn_kw=dict(fn_kw or {}))

  def _emit(self, ctx: EmitCtx, deps: List):
    shape = tuple(deps[0].shape)
    device = deps[0].device
    coords = tuple(
        torch.arange(n, dtype=torch.int32, device=device).reshape(
            (1,) * d + (n,) + (1,) * (len(shape) - d - 1)).expand(shape)
        for d, n in enumerate(shape))
    return self.fn(*deps, coords, **self.fn_kw)

  def _weak_operands(self) -> bool:
    return True


def structural(fn: Callable) -> Callable:
  """Mark a map function that is not elementwise (its result's shape is
  not the broadcast of its inputs' shapes: a gather, ``kron``, ``pad``):
  the optimizer then keeps its inputs whole (``ConstFoldCreations``)."""
  fn.structural = True
  return fn


def is_structural(op: LocalExpr) -> bool:
  """Does the fused kernel ``op`` call a :func:`structural` function?"""
  from spartan_tpu_torch.expr.local import _postorder
  return _postorder(op, lambda n: False,
                    lambda n, deps: (getattr(n.fn, "structural", False)
                                     or _py.any(deps)))


def map_with_location(inputs, fn: Callable, fn_kw=None) -> MapWithLocationExpr:
  """Lazy map where ``fn(*values, coords)`` sees the global index grids."""
  if isinstance(inputs, Expr) or not isinstance(inputs, (list, tuple)):
    inputs = [inputs]
  return MapWithLocationExpr([lazify(v) for v in inputs], fn, fn_kw)


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
    # and a product, off by an ulp; a 0-d tensor divides IEEE-rounded.
    # torch.full fills it on the device: torch.tensor would copy it from
    # pageable host memory, which waits for the stream
    x = torch.full((), x, dtype=y.dtype, device=y.device)
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
  # filled on the device, not copied from pageable host memory (a copy that
  # waits for the stream)
  return torch.full((), v, dtype=_PY_DTYPES[type(v)], device=device)


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
  ±inf or nan (torch's and NumPy's IEEE quotient).  Its derivative is 0
  in both operands, as JAX's (a step function): torch has no formula for
  it, so the quotient is taken of detached operands, a constant to
  autograd (and to the double-vjp ``jvp``, ``hvp`` and ``hessian``)."""
  if _integral(x, y):
    return _zero_guarded(torch.floor_divide, x, y)
  x, y = _tensors(x, y)
  return torch.floor_divide(x.detach(), y.detach())


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


# -- the float ufuncs of builtins' trig, hyperbolic, rounding and log/exp
# families (the rare ops of K1's and K2's op table) ----------------------

def _float_unary(name: str, op: Callable) -> Callable:
  """A float-valued unary ufunc: integer and bool input lift to float64
  (``_inexact``), float dtypes stay."""
  def fn(x):
    return op(_inexact(x))
  fn.__name__ = name
  fn.__qualname__ = name
  return fn


def _float_operands(x, y, name: str = ""):
  """``x`` and ``y`` promoted as NumPy does (:func:`promote`), an integer
  or bool result lifted to float64, both as tensors on one device."""
  x, y = promote(x, y, name)
  x, y = _tensors(x, y)
  if x.device != y.device:  # a constant lifted on the host: its 0-d value
    x, y = (x.to(y.device), y) if x.dim() == 0 else (x, y.to(x.device))
  dt = torch.promote_types(x.dtype, y.dtype)
  if dtype_kind(dt) in "biu":
    x, y = x.to(torch.float64), y.to(torch.float64)
  return x, y


def _float_binary(name: str, op: Callable) -> Callable:
  def fn(x, y):
    return op(*_float_operands(x, y, name))
  fn.__name__ = name
  fn.__qualname__ = name
  return fn


def cbrt_plain(x: torch.Tensor) -> torch.Tensor:
  """The real cube root (torch has none): ``|x| ** (1/3)`` in float64 and
  one Newton step, with the sign of x; ±0, ±inf and nan pass through."""
  d = x.to(torch.float64)
  a = d.abs()
  y = torch.pow(a, 1.0 / 3.0)
  refined = y - (y * y * y - a) / (3.0 * y * y)
  y = torch.where(torch.isfinite(y) & (y > 0), refined, y)
  return torch.copysign(y, d).to(x.dtype)


# NumPy's constants for degrees and radians: float32 (and the 16-bit types,
# computed in float32) use ``180.0f / NPY_PIf``, float64 ``180.0 / NPY_PI``
# (torch's and the reference's float32 constant is float32(180 / pi), an
# ulp away)
_SCALES = {"rad2deg": (float(np.float32(180.0) / np.float32(np.pi)),
                       180.0 / np.pi),
           "deg2rad": (float(np.float32(np.pi) / np.float32(180.0)),
                       np.pi / 180.0)}


def scale_factor(kind: str, dtype: torch.dtype) -> float:
  """The constant ``rad2deg``/``deg2rad`` multiply a ``dtype`` array by."""
  single, double = _SCALES[kind]
  return double if dtype == torch.float64 else single


def _scaled(kind: str, name: str) -> Callable:
  def fn(x):
    x = _inexact(x)
    c = scale_factor(kind, x.dtype)
    if x.dtype in _HALF:  # NumPy's half loops: float32, rounded once
      return (x.float() * c).to(x.dtype)
    return x * c
  fn.__name__ = name
  fn.__qualname__ = name
  return fn


def spacing(x):
  """NumPy's ``spacing``: the distance to the next value away from zero,
  negative below zero (-0.0 counts as zero; nan at ±inf)."""
  x = _inexact(x)
  inf = torch.full_like(x, float("inf"))
  out = torch.nextafter(x, torch.where(x < 0, -inf, inf)) - x
  return torch.where(torch.isinf(x), torch.full_like(x, float("nan")), out)


def fabs(x):
  x = _inexact(x)
  if x.is_complex():
    raise TypeError("ufunc 'fabs' not supported for complex input")
  return torch.abs(x)


def signbit(x):
  return torch.signbit(_lift(x))


def nan_to_num(x, nan: float = 0.0, posinf=None, neginf=None):
  x = _lift(x)
  if not (x.is_floating_point() or x.is_complex()):
    return x.clone()
  return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


def isneginf(x):
  return torch.isneginf(_lift(x))


def isposinf(x):
  return torch.isposinf(_lift(x))


def real(x):
  x = _lift(x)
  return x.real.clone() if x.is_complex() else x.clone()


def imag(x):
  """NumPy's ``imag``: zeros of the array's dtype for a real array (torch
  raises there)."""
  x = _lift(x)
  return x.imag.clone() if x.is_complex() else torch.zeros_like(x)


def iscomplex(x):
  x = _lift(x)
  if x.is_complex():
    return x.imag != 0
  return torch.zeros_like(x, dtype=torch.bool)


def isreal(x):
  x = _lift(x)
  if x.is_complex():
    return x.imag == 0
  return torch.ones_like(x, dtype=torch.bool)


def angle(x):
  """NumPy's ``angle``: ``arctan2(imag, real)``, so a negative real (and
  -0.0) gives pi."""
  x = _lift(x)
  if x.is_complex():
    return torch.angle(x)
  x = _inexact(x)
  return torch.atan2(torch.zeros_like(x), x)


_POPCOUNT = None


def bitwise_count(x):
  """NumPy's ``bitwise_count``: the 1 bits of |x|, as uint8 (a byte
  table; torch has no popcount)."""
  global _POPCOUNT
  x = _lift(x)
  if dtype_kind(x.dtype) not in "biu":
    raise TypeError("ufunc 'bitwise_count' not supported for the input "
                    "types (integers and bools only)")
  if _POPCOUNT is None or _POPCOUNT.device != x.device:
    _POPCOUNT = torch.tensor([bin(i).count("1") for i in _py.range(256)],
                             dtype=torch.uint8, device=x.device)
  a = x.to(torch.int64).abs()
  out = torch.zeros(x.shape, dtype=torch.uint8, device=x.device)
  for shift in _py.range(0, 8 * x.element_size(), 8):
    out += _POPCOUNT[(a >> shift) & 255]
  return out


def arctan2(x, y):
  return torch.atan2(*_float_operands(x, y, "arctan2"))


def hypot(x, y):
  return torch.hypot(*_float_operands(x, y, "hypot"))


def copysign(x, y):
  return torch.copysign(*_float_operands(x, y, "copysign"))


def nextafter(x, y):
  return torch.nextafter(*_float_operands(x, y, "nextafter"))


def logaddexp(x, y):
  return torch.logaddexp(*_float_operands(x, y, "logaddexp"))


def logaddexp2(x, y):
  return torch.logaddexp2(*_float_operands(x, y, "logaddexp2"))


def heaviside(x, y):
  """NumPy's ``heaviside``: 0 below zero, ``y`` at zero, 1 above; nan
  stays nan (torch's gives 0, and needs one dtype)."""
  x, y = _float_operands(x, y, "heaviside")
  dt = torch.result_type(x, y)
  x, y = x.to(dt), y.to(dt)
  step = torch.where(x == 0, y, (x > 0).to(x.dtype))
  return torch.where(torch.isnan(x), x, step)


def _fmaxmin(name: str, op: Callable, logical: Callable) -> Callable:
  def fn(x, y):
    x, y = _tensors(*promote(x, y, name))
    if x.dtype == torch.bool and y.dtype == torch.bool:
      return logical(x, y)
    return op(x, y)
  fn.__name__ = name
  fn.__qualname__ = name
  return fn


fmax = _fmaxmin("fmax", torch.fmax, torch.logical_or)
fmin = _fmaxmin("fmin", torch.fmin, torch.logical_and)


def ldexp(x, e):
  """``x * 2**e`` exactly (torch's ``ldexp`` rounds ``2**e`` in x's dtype
  first): the power in two float64 halves.  ``e`` must be an integer."""
  if (isinstance(e, torch.Tensor) and dtype_kind(e.dtype) not in "biu"
      or isinstance(e, float)):
    raise TypeError("ufunc 'ldexp' needs an integer exponent")
  x = _inexact(x)
  e = torch.as_tensor(e, device=x.device).to(torch.int64).clamp(-2200, 2200)
  half = torch.div(e, 2, rounding_mode="floor")
  two = torch.tensor(2.0, dtype=torch.float64, device=x.device)
  out = x.to(torch.float64) * torch.pow(two, half) * torch.pow(two, e - half)
  return out.to(x.dtype)


def gcd(x, y):
  x, y = _tensors(*promote(x, y, "gcd"))
  if dtype_kind(x.dtype) not in "iu" or dtype_kind(y.dtype) not in "iu":
    raise TypeError("ufunc 'gcd' not supported for the input types "
                    "(integers only)")
  return torch.gcd(x, y)


def lcm(x, y):
  x, y = _tensors(*promote(x, y, "lcm"))
  if dtype_kind(x.dtype) not in "iu" or dtype_kind(y.dtype) not in "iu":
    raise TypeError("ufunc 'lcm' not supported for the input types "
                    "(integers only)")
  return torch.lcm(x, y)


def isclose(x, y, rtol: float = 1e-05, atol: float = 1e-08,
            equal_nan: bool = False):
  """NumPy's ``isclose``: ``|x - y| <= atol + rtol * |y|``, infinities
  close only to themselves; integers compare as float64."""
  x, y = _float_operands(x, y, "isclose")
  x, y = torch.broadcast_tensors(x, y)
  return torch.isclose(x, y, rtol=rtol, atol=atol, equal_nan=equal_nan)


def frexp_mantissa(x):
  return torch.frexp(_inexact(x)).mantissa


def frexp_exponent(x):
  """The exponent of ``frexp`` as int32, as NumPy gives it."""
  return torch.frexp(_inexact(x)).exponent.to(torch.int32)


def modf_fraction(x):
  """``modf``'s fractional part with the sign of x: 0 at ±inf."""
  x = _inexact(x)
  frac = torch.where(torch.isinf(x), torch.zeros_like(x), x - torch.trunc(x))
  return torch.copysign(frac, x)


def modf_integral(x):
  return torch.trunc(_inexact(x))


sin = _float_unary("sin", torch.sin)
cos = _float_unary("cos", torch.cos)
tan = _float_unary("tan", torch.tan)
arcsin = _float_unary("arcsin", torch.asin)
arccos = _float_unary("arccos", torch.acos)
arctan = _float_unary("arctan", torch.atan)
sinh = _float_unary("sinh", torch.sinh)
cosh = _float_unary("cosh", torch.cosh)
tanh = _float_unary("tanh", torch.tanh)
arcsinh = _float_unary("arcsinh", torch.asinh)
arccosh = _float_unary("arccosh", torch.acosh)
arctanh = _float_unary("arctanh", torch.atanh)
floor = _float_unary("floor", torch.floor)
ceil = _float_unary("ceil", torch.ceil)
trunc = _float_unary("trunc", torch.trunc)
exp2 = _float_unary("exp2", torch.exp2)
expm1 = _float_unary("expm1", torch.expm1)
log2 = _float_unary("log2", torch.log2)
log10 = _float_unary("log10", torch.log10)
log1p = _float_unary("log1p", torch.log1p)
fix = _float_unary("fix", torch.trunc)  # a float result, as NumPy's
rint = _float_unary("rint", torch.round)  # half to even
sinc = _float_unary("sinc", torch.sinc)
i0 = _float_unary("i0", torch.i0)
erf = _float_unary("erf", torch.erf)
erfc = _float_unary("erfc", torch.erfc)
cbrt = _float_unary("cbrt", cbrt_plain)
rad2deg = _scaled("rad2deg", "rad2deg")
deg2rad = _scaled("deg2rad", "deg2rad")
degrees = _scaled("rad2deg", "degrees")
radians = _scaled("deg2rad", "radians")


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
    logical_xor, arctan2, hypot, copysign, nextafter, logaddexp,
    logaddexp2, heaviside, fmax, fmin, gcd, lcm)}
UNARY = {f.__name__: f for f in (
    negative, absolute, square, sqrt, exp, log, bitwise_not, logical_not,
    isnan, isinf, isfinite, sign, reciprocal, positive, conj, copy, sin,
    cos, tan, arcsin, arccos, arctan, sinh, cosh, tanh, arcsinh, arccosh,
    arctanh, floor, ceil, trunc, exp2, expm1, log2, log10, log1p, cbrt,
    spacing, sinc, fabs, signbit, fix, rint, i0, erf, erfc, isneginf,
    isposinf, real, imag, iscomplex, isreal, angle, bitwise_count, rad2deg,
    deg2rad, degrees, radians, frexp_mantissa, frexp_exponent,
    modf_fraction, modf_integral)}

# what map kernels actually hold: binary ops wrapped for NumPy promotion
UFUNCS: Dict[str, Callable] = dict(UNARY)
UFUNCS.update({name: _numpy_promoting(f) for name, f in BINARY.items()})
_PROMOTING_CACHE.update({f: UFUNCS[name] for name, f in BINARY.items()})
