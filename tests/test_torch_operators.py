"""The port's operators and elementwise ufuncs of the core expression
surface against the reference, on the same seeded NumPy data: ``//``,
``%``, ``**``, the bitwise operators and shifts (each with its reflected
form), ``~``, ``==``, ``!=``, ``__bool__``/``__int__``, ``__array_ufunc__``
and the ufuncs ``floor_divide`` … ``round``.

Tolerances: exact for integer and bool results; float64 to rtol 1e-10;
float32 to rtol 1e-6 (the reference computes in XLA, the port in torch:
the two may round a quotient or a power one ulp apart).  Where the port
follows NumPy and the reference follows JAX (bool arithmetic as int8,
integer ``x // 0`` and ``x % 0``, float ``x // 0``, ``nan`` under
``sign``, a negative Python int power of an integer), the case is held
against NumPy instead, exactly.
"""

import numpy as np
import pytest
import torch

import spartan_tpu as ref

import spartan_tpu_torch as sp


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


DTYPES = ["bool", "int8", "uint8", "int32", "float32", "float64"]
RTOL = {"float32": 1e-6, "float64": 1e-10}


def _data(dtype, shape=(5, 6), seed=0, nonzero=False):
  rng = np.random.default_rng(seed)
  if dtype == "bool":
    out = rng.random(shape) < 0.5
    return np.ones(shape, bool) if nonzero else out
  if dtype in ("int8", "int32"):
    out = rng.integers(-9, 10, shape).astype(dtype)
  elif dtype == "uint8":
    out = rng.integers(0, 20, shape).astype(dtype)
  else:
    out = np.round(rng.uniform(-4.0, 4.0, shape), 2).astype(dtype)
  if nonzero:
    out[out == 0] = 3
  return out


def _lift(mod, v):
  return mod.from_numpy(v) if isinstance(v, np.ndarray) else v


def _same(got, want, dtype=None):
  got, want = np.asarray(got), np.asarray(want)
  assert got.dtype == want.dtype, (got.dtype, want.dtype)
  assert got.shape == want.shape
  kind = want.dtype.kind
  if kind in "biu":
    np.testing.assert_array_equal(got, want)
  else:
    np.testing.assert_allclose(got, want, rtol=RTOL[str(want.dtype)],
                               atol=0, equal_nan=True)


ARITH = {"//": lambda a, b: a // b, "%": lambda a, b: a % b,
         "**": lambda a, b: a ** b}
BITS = {"&": lambda a, b: a & b, "|": lambda a, b: a | b,
        "^": lambda a, b: a ^ b, "<<": lambda a, b: a << b,
        ">>": lambda a, b: a >> b}
COMPARE = {"==": lambda a, b: a == b, "!=": lambda a, b: a != b}


def _operands(op, dtype, pair):
  """(lhs, rhs) for ``pair``: two arrays, an array and a Python scalar on
  either side, or a row broadcast against the array."""
  a = _data(dtype, seed=1)
  b = _data(dtype, seed=2, nonzero=op in ("//", "%"))
  if op in ("<<", ">>"):
    b = np.abs(b.astype(np.int64)).astype(dtype) % 5 if dtype != "bool" else b
  if op == "**" and dtype not in ("float32", "float64"):
    b = np.abs(b.astype(np.int64)).astype(dtype) % 4 if dtype != "bool" else b
  if op == "**" and dtype in ("float32", "float64"):
    a = np.abs(a) + np.array(0.5, dtype)
  scalar = {"bool": True, "int8": 3, "uint8": 3, "int32": 3,
            "float32": 1.5, "float64": 1.5}[dtype]
  if op in ("<<", ">>", "**") and dtype not in ("bool", "float32",
                                                   "float64"):
    scalar = 2
  return {"array-array": (a, b), "array-scalar": (a, scalar),
          "scalar-array": (scalar, b), "broadcast": (a, b[2])}[pair]


PAIRS = ["array-array", "array-scalar", "scalar-array", "broadcast"]


@pytest.mark.parametrize("pair", PAIRS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", sorted(ARITH))
def test_arithmetic_operators_match_reference(op, dtype, pair):
  lhs, rhs = _operands(op, dtype, pair)
  fn = ARITH[op]
  got = fn(_lift(sp, lhs), _lift(sp, rhs)).glom()
  want_np = fn(lhs, rhs)
  if dtype == "bool" or (op == "**" and isinstance(lhs, (int, bool)) and
                         dtype != "float64" and dtype != "float32"):
    # NumPy computes bool arithmetic in int8 (the reference: int32)
    _same(got, want_np)
    return
  want = np.asarray(fn(_lift(ref, lhs), _lift(ref, rhs)).glom())
  _same(got, want)
  _same(got, want_np)


@pytest.mark.parametrize("pair", PAIRS)
@pytest.mark.parametrize("dtype", ["bool", "int8", "uint8", "int32"])
@pytest.mark.parametrize("op", sorted(BITS))
def test_bitwise_operators_match_reference(op, dtype, pair):
  lhs, rhs = _operands(op, dtype, pair)
  fn = BITS[op]
  got = fn(_lift(sp, lhs), _lift(sp, rhs)).glom()
  want_np = fn(lhs, rhs)
  _same(got, want_np)
  if not (dtype == "bool" and op in ("<<", ">>")):
    _same(got, np.asarray(fn(_lift(ref, lhs), _lift(ref, rhs)).glom()))


@pytest.mark.parametrize("dtype", ["bool", "int8", "uint8", "int32"])
def test_invert_matches_reference(dtype):
  a = _data(dtype)
  got = (~sp.from_numpy(a)).glom()
  _same(got, np.asarray((~ref.from_numpy(a)).glom()))
  _same(got, ~a)


@pytest.mark.parametrize("op", ["&", "|", "^", "<<", ">>", "~"])
def test_bitwise_of_floats_raises_type_error(op):
  a = sp.from_numpy(_data("float64"))
  with pytest.raises(TypeError):
    (~a if op == "~" else BITS[op](a, a)).glom()


@pytest.mark.parametrize("pair", PAIRS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", sorted(COMPARE))
def test_equality_operators_match_reference(op, dtype, pair):
  lhs, rhs = _operands("==", dtype, pair)
  if isinstance(rhs, np.ndarray):
    rhs = rhs.copy()
    rhs.flat[::3] = (lhs if isinstance(lhs, np.ndarray) else
                     np.full(rhs.shape, lhs, rhs.dtype)).flat[::3][
                         :rhs.size // 3 + (rhs.size % 3 > 0)]
  fn = COMPARE[op]
  got = fn(_lift(sp, lhs), _lift(sp, rhs)).glom()
  _same(got, np.asarray(fn(_lift(ref, lhs), _lift(ref, rhs)).glom()))
  _same(got, fn(lhs, rhs))


def test_mixed_dtype_operators_promote_as_numpy():
  i = _data("int32", nonzero=True)
  f = _data("float32", seed=3, nonzero=True)
  u = _data("uint8", seed=4, nonzero=True)
  for fn in (lambda a, b: a // b, lambda a, b: a % b, lambda a, b: a == b):
    for lhs, rhs in ((i, f), (u, i), (f, u)):
      got = fn(sp.from_numpy(lhs), sp.from_numpy(rhs)).glom()
      want = np.asarray(fn(ref.from_numpy(lhs), ref.from_numpy(rhs)).glom())
      _same(got, want)
      _same(got, fn(lhs, rhs))


# -- the cases the port pins down against NumPy --------------------------------

@pytest.mark.parametrize("dtype", ["int8", "uint8", "int32"])
def test_integer_division_by_zero_gives_zero_as_numpy(dtype):
  a = _data(dtype, seed=5)
  b = _data(dtype, seed=6)
  b.flat[::2] = 0
  sa, sb = sp.from_numpy(a), sp.from_numpy(b)
  with np.errstate(divide="ignore"):
    for got, want in (((sa // sb).glom(), a // b), ((sa % sb).glom(), a % b),
                      ((sa // 0).glom(), a // 0), ((sa % 0).glom(), a % 0),
                      (sp.fmod(sa, sb).glom(), np.fmod(a, b))):
      _same(got, want)
      assert not got[b == 0].any()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_float_division_by_zero_follows_numpy(dtype):
  a = np.array([1.5, -2.0, 0.0, np.inf, -0.75], dtype)
  z = np.zeros_like(a)
  with np.errstate(divide="ignore", invalid="ignore"):
    _same((sp.from_numpy(a) // sp.from_numpy(z)).glom(), a // z)
    _same((sp.from_numpy(a) // 0.0).glom(), a // 0.0)
    _same((sp.from_numpy(a) % 1.25).glom(), a % 1.25)


def test_floor_divide_sign_of_zero_follows_numpy():
  a = np.array([-0.696, 0.5, -0.25], np.float32)
  b = np.array([-3.856, 7.0, 9.0], np.float32)
  got = (sp.from_numpy(a) // sp.from_numpy(b)).glom()
  np.testing.assert_array_equal(np.signbit(got), np.signbit(a // b))


@pytest.mark.parametrize("dtype", ["bool", "int8", "uint8", "int32"])
def test_negative_python_int_power_of_integers_raises(dtype):
  x = sp.from_numpy(_data(dtype))
  with pytest.raises(ValueError, match="negative integer powers"):
    x ** -1
  with pytest.raises(ValueError, match="negative integer powers"):
    sp.power(x, -2)
  with pytest.raises((ValueError, OverflowError)):  # NumPy's uint8: overflow
    _data(dtype) ** -1


def test_negative_integer_array_exponent_gives_zero_unless_the_base_is_one():
  """NumPy raises here (a check that would depend on the data); the port
  gives torch's integer power, 0 unless |base| is 1.  The reference gives
  the same for 2 ** -1 and ±1, but an overflowed value for 3 ** -2."""
  base = np.array([2, 3, 1, -1, -1, 5], np.int32)
  exp = np.array([-1, -2, -3, -3, -2, 0], np.int32)
  got = (sp.from_numpy(base) ** sp.from_numpy(exp)).glom()
  _same(got, np.array([0, 0, 1, -1, 1, 1], np.int32))
  want = np.asarray((ref.from_numpy(base) ** ref.from_numpy(exp)).glom())
  np.testing.assert_array_equal(got[[0, 2, 3, 4, 5]], want[[0, 2, 3, 4, 5]])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("exponent, ufunc", [(2, "square"), (2.0, "square"),
                                             (0.5, "sqrt"),
                                             (-1, "reciprocal"),
                                             (1, "positive")])
def test_scalar_power_operator_takes_numpy_fast_paths(exponent, ufunc, dtype):
  a = np.abs(_data(dtype)) + np.array(0.25, dtype)
  e = sp.from_numpy(a) ** exponent
  assert e.op.pretty_name == ufunc
  _same(e.glom(), getattr(np, ufunc)(a))
  assert sp.power(sp.from_numpy(a), exponent).op.pretty_name == "power"


def test_sign_keeps_nan_as_numpy():
  a = np.array([np.nan, -0.0, 2.5, -3.0, 0.0, np.inf])
  got = sp.sign(sp.from_numpy(a)).glom()
  np.testing.assert_array_equal(got, np.sign(a))


# -- the ufuncs ---------------------------------------------------------------

BINARY_UFUNCS = ["floor_divide", "mod", "remainder", "fmod", "power",
                 "float_power", "equal", "not_equal", "logical_and",
                 "logical_or", "logical_xor"]
INT_UFUNCS = ["bitwise_and", "bitwise_or", "bitwise_xor", "left_shift",
              "right_shift"]
UNARY_UFUNCS = ["isnan", "isinf", "isfinite", "sign", "logical_not",
                "bitwise_not", "invert", "conj", "copy", "positive",
                "reciprocal"]


@pytest.mark.parametrize("dtype", ["int32", "float32", "float64"])
@pytest.mark.parametrize("name", BINARY_UFUNCS)
def test_binary_ufuncs_match_reference(name, dtype):
  a = _data(dtype, seed=7)
  b = _data(dtype, seed=8, nonzero=True)
  if name in ("power", "float_power"):
    a = np.abs(a) + (1 if dtype == "int32" else np.array(0.5, dtype))
    b = np.abs(b) % 4
  got = getattr(sp, name)(sp.from_numpy(a), sp.from_numpy(b)).glom()
  want = np.asarray(getattr(ref, name)(ref.from_numpy(a),
                                       ref.from_numpy(b)).glom())
  _same(got, getattr(np, name)(a, b))
  if name != "float_power":  # the reference: float32 (JAX's default float)
    _same(got, want)


@pytest.mark.parametrize("dtype", ["bool", "int8", "uint8", "int32"])
@pytest.mark.parametrize("name", INT_UFUNCS)
def test_integer_ufuncs_match_reference(name, dtype):
  a = _data(dtype, seed=9)
  b = _data(dtype, seed=10)
  if name.endswith("shift") and dtype != "bool":
    b = np.abs(b.astype(np.int64)).astype(dtype) % 6
  got = getattr(sp, name)(sp.from_numpy(a), sp.from_numpy(b)).glom()
  _same(got, getattr(np, name)(a, b))
  if not (dtype == "bool" and name.endswith("shift")):
    _same(got, np.asarray(getattr(ref, name)(ref.from_numpy(a),
                                             ref.from_numpy(b)).glom()))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", UNARY_UFUNCS)
def test_unary_ufuncs_match_reference(name, dtype):
  a = _data(dtype, seed=11)
  if dtype.startswith("float"):
    a.flat[::7] = np.nan
    a.flat[3] = np.inf
  integer_only = name in ("bitwise_not", "invert")
  if (integer_only and dtype.startswith("float")) or (
      name in ("sign", "positive") and dtype == "bool") or (
      name == "reciprocal" and dtype != "float64"):
    with pytest.raises(TypeError if name != "reciprocal" else Exception):
      np.asarray(getattr(sp, name)(sp.from_numpy(a)).glom())
      if name == "reciprocal":
        raise TypeError("held below for float64 only")
    return
  got = getattr(sp, name)(sp.from_numpy(a)).glom()
  with np.errstate(divide="ignore"):
    _same(got, getattr(np, name)(a))
  if not (name == "conj" and dtype == "bool"):  # NumPy: int8
    _same(got, np.asarray(getattr(ref, name)(ref.from_numpy(a)).glom()))


@pytest.mark.parametrize("decimals", [0, 1, 2, -1])
@pytest.mark.parametrize("dtype", ["int32", "float32", "float64"])
def test_round_matches_reference(dtype, decimals):
  a = _data(dtype, seed=12) * (7 if dtype == "int32" else 1.37)
  a = a.astype(dtype)
  got = sp.round(sp.from_numpy(a), decimals).glom()
  _same(got, np.round(a, decimals))
  if dtype != "int32" or decimals >= 0:
    _same(got, np.asarray(ref.round(ref.from_numpy(a), decimals).glom()))
  _same(sp.around(sp.from_numpy(a), decimals).glom(), got)
  _same(sp.from_numpy(a).round(decimals).glom(), got)


@pytest.mark.parametrize("bounds", [(-1.0, 2.0), (None, 0.5), (-0.5, None),
                                    (3.0, -3.0)], ids=str)
@pytest.mark.parametrize("dtype", ["int32", "float32", "float64"])
def test_clip_matches_reference(dtype, bounds):
  a = _data(dtype, seed=13)
  lo, hi = bounds
  got = sp.clip(sp.from_numpy(a), lo, hi).glom()
  _same(got, np.asarray(ref.clip(ref.from_numpy(a), lo, hi).glom()))
  _same(got, np.clip(a, lo, hi))
  _same(sp.from_numpy(a).clip(lo, hi).glom(), got)


def test_clip_needs_a_bound():
  with pytest.raises(ValueError, match="max or min"):
    sp.clip(sp.from_numpy(_data("float64")), None, None)


@pytest.mark.parametrize("pair", ["arrays", "scalars", "mixed-dtypes",
                                  "broadcast"])
def test_where_matches_reference(pair):
  a, b = _data("float64", seed=14), _data("int32", seed=15)
  cond = a > 0
  x, y = {"arrays": (a, -a), "scalars": (1.5, 0), "mixed-dtypes": (a, b),
          "broadcast": (a[0], b)}[pair]
  got = sp.where(sp.from_numpy(cond), _lift(sp, x), _lift(sp, y)).glom()
  want = np.asarray(ref.where(ref.from_numpy(cond), _lift(ref, x),
                              _lift(ref, y)).glom())
  _same(got, want)
  _same(got, np.where(cond, x, y))


def test_where_with_a_condition_alone_is_nonzero():
  a = _data("int32", seed=16)
  got = sp.where(sp.from_numpy(a > 2))
  want = np.nonzero(a > 2)
  assert len(got) == len(want) == 2
  for g, w in zip(got, want):
    np.testing.assert_array_equal(g.glom(), w)


# -- conversions and NumPy's dispatch -------------------------------------------

def test_bool_and_int_follow_the_size_one_rule():
  a = _data("float64", seed=17)
  sa = sp.from_numpy(a)
  assert bool(sa.sum() > a.sum() - 1) is True
  assert int(sp.from_numpy(np.int64(42))) == 42
  assert int(sa[0, 0] * 0 + 7) == 7
  with pytest.raises(ValueError, match="ambiguous"):
    bool(sa > 0)
  with pytest.raises(TypeError, match="size-1"):
    int(sa)
  with pytest.raises(TypeError, match="size-1"):
    float(sa)
  # the reference's messages
  with pytest.raises(ValueError, match="ambiguous"):
    bool(ref.from_numpy(a) > 0)


def test_numpy_ufuncs_on_exprs_stay_lazy():
  a = _data("float64", seed=18)
  sa = sp.from_numpy(a)
  for got, want in ((np.add(a, sa), a + a), (np.multiply(sa, 2.0), a * 2),
                    (np.sqrt(np.abs(sa)), np.sqrt(np.abs(a))),
                    (np.floor_divide(a, sa + 10), a // (a + 10)),
                    (a ** sp.from_numpy(np.full(a.shape, 2.0)), a ** 2)):
    assert isinstance(got, sp.Expr)
    _same(got.glom(), want)
  # a ufunc the builtins do not name is computed by NumPy
  np.testing.assert_array_equal(np.sin(sa), np.sin(a))


def test_tolist_and_item():
  a = _data("int32", seed=19)
  assert sp.from_numpy(a).tolist() == a.tolist()
  assert sp.from_numpy(a)[1, 2].item() == a[1, 2]


def test_an_evaluated_array_takes_the_operators():
  a = _data("int32", seed=20)
  arr = (sp.from_numpy(a) + 0).evaluate()
  for fn in (lambda v: v // 3, lambda v: v % 4, lambda v: v ** 2,
             lambda v: v & 5, lambda v: v == 2, lambda v: ~v, lambda v: v[1:3],
             lambda v: 2 ** (v % 3), lambda v: v.clip(-1, 1), lambda v: v != 1):
    _same(fn(arr).glom(), fn(a))


SURFACE = ["floor_divide", "mod", "remainder", "fmod", "power", "float_power",
           "equal", "not_equal", "bitwise_and", "bitwise_or", "bitwise_xor",
           "bitwise_not", "invert", "left_shift", "right_shift",
           "logical_and", "logical_or", "logical_xor", "logical_not", "isnan",
           "isinf", "isfinite", "sign", "where", "clip", "round", "around",
           "prod", "std", "var", "all", "any", "count_nonzero", "nansum",
           "nanmean", "nanvar", "nanstd", "nanmax", "nanmin", "take", "write",
           "assign", "squeeze", "swapaxes", "diagonal", "trace", "repeat",
           "copy", "conj", "outer"]


def test_the_surface_is_exported():
  assert len(SURFACE) == 50
  missing = [n for n in SURFACE if n not in sp.__all__ or
             not callable(getattr(sp, n))]
  assert not missing
  assert all(n in ref.__all__ for n in SURFACE)
  shared = set(sp.__all__) & set(ref.__all__)
  assert len(shared) >= 117, len(shared)
