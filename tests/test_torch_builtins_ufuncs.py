"""The port's elementwise ufuncs of ``expr/builtins.py`` (the trig,
hyperbolic, rounding, log/exp, float, integer and complex ufuncs, their
array-API aliases) and its eager predicates, against the reference and
NumPy on the same seeded data.

Each name is one case of a parametrised test, at float64, float32, int32
and bool where the ufunc takes them:

* Against NumPy (scipy.special for ``erf``/``erfc``) on regular values,
  NaN, ±inf, ±0, a subnormal and an empty array: the result dtype equals
  NumPy's, except that bool input lifts to float64 where NumPy gives
  float16 (the port's pinned promotion, ROADMAP's Watch list); the values
  to rtol 1e-10 at float64 and 1e-6 at float32 (torch's and NumPy's libm
  differ by an ulp), exactly for the exact ops (rounding, ``copysign``,
  ``fmax``/``fmin``, ``signbit``, the predicates, the integer ufuncs).
* Against the reference on the regular values (its XLA CPU build flushes
  subnormals and follows JAX's promotion: int32 gives float32 there, and
  its float32 ``rad2deg``/``degrees`` multiply by float32(180/pi), an ulp
  off NumPy's ``180.0f/NPY_PIf``): the same tolerances on the values, the
  reference's cast to the port's dtype.
"""

import warnings

import numpy as np
import pytest
import scipy.special
import torch

import spartan_tpu as ref

import spartan_tpu_torch as sp


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


RTOL = {"float64": 1e-10, "float32": 1e-6}
EXACT = {"floor", "ceil", "trunc", "fix", "rint", "fabs", "signbit",
         "copysign", "fmax", "fmin", "nan_to_num", "real", "imag",
         "iscomplex", "isreal", "isneginf", "isposinf", "conjugate",
         "bitwise_count", "gcd", "lcm", "nextafter", "spacing", "heaviside",
         "ldexp", "isclose", "bitwise_invert", "bitwise_left_shift",
         "bitwise_right_shift", "pow_int", "angle"}
# (name, NumPy's function, the domain of the regular values)
UNARY = [
    ("sin", np.sin, "any"), ("cos", np.cos, "any"), ("tan", np.tan, "any"),
    ("arcsin", np.arcsin, "unit"), ("asin", np.arcsin, "unit"),
    ("arccos", np.arccos, "unit"), ("acos", np.arccos, "unit"),
    ("arctan", np.arctan, "any"), ("atan", np.arctan, "any"),
    ("sinh", np.sinh, "any"), ("cosh", np.cosh, "any"),
    ("tanh", np.tanh, "any"), ("arcsinh", np.arcsinh, "any"),
    ("asinh", np.arcsinh, "any"), ("arccosh", np.arccosh, "ge1"),
    ("acosh", np.arccosh, "ge1"), ("arctanh", np.arctanh, "unit"),
    ("atanh", np.arctanh, "unit"), ("floor", np.floor, "any"),
    ("ceil", np.ceil, "any"), ("trunc", np.trunc, "any"),
    ("fix", np.fix, "any"), ("rint", np.rint, "any"),
    ("exp2", np.exp2, "any"), ("expm1", np.expm1, "any"),
    ("log2", np.log2, "pos"), ("log10", np.log10, "pos"),
    ("log1p", np.log1p, "pos"), ("cbrt", np.cbrt, "any"),
    ("fabs", np.fabs, "any"), ("degrees", np.degrees, "any"),
    ("radians", np.radians, "any"), ("deg2rad", np.deg2rad, "any"),
    ("rad2deg", np.rad2deg, "any"), ("signbit", np.signbit, "any"),
    ("spacing", np.spacing, "any"), ("erf", scipy.special.erf, "any"),
    ("erfc", scipy.special.erfc, "any"), ("i0", np.i0, "any"),
    ("sinc", np.sinc, "any"), ("nan_to_num", np.nan_to_num, "any"),
    ("angle", np.angle, "any"), ("real", np.real, "any"),
    ("imag", np.imag, "any"), ("iscomplex", np.iscomplex, "any"),
    ("isreal", np.isreal, "any"), ("isneginf", np.isneginf, "any"),
    ("isposinf", np.isposinf, "any"), ("conjugate", np.conjugate, "any"),
]
BINARY = [
    ("arctan2", np.arctan2), ("atan2", np.arctan2), ("hypot", np.hypot),
    ("copysign", np.copysign), ("nextafter", np.nextafter),
    ("heaviside", np.heaviside), ("logaddexp", np.logaddexp),
    ("logaddexp2", np.logaddexp2), ("fmax", np.fmax), ("fmin", np.fmin),
]
SPECIAL = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-310]


def _regular(domain, dtype, seed=0, shape=(4, 6)):
  rng = np.random.default_rng(seed)
  lo, hi = {"any": (-6.0, 6.0), "unit": (-0.95, 0.95), "pos": (0.05, 40.0),
            "ge1": (1.0, 40.0)}[domain]
  if dtype == "int32":
    ilo, ihi = {"any": (-6, 7), "unit": (-1, 2), "pos": (1, 40),
                "ge1": (1, 40)}[domain]
    return rng.integers(ilo, ihi, shape).astype(np.int32)
  if dtype == "bool":
    return rng.random(shape) < 0.5
  out = rng.uniform(lo, hi, shape)
  out.flat[::5] = np.round(out.flat[::5] * 2) / 2  # halves: rint's ties
  return out.astype(dtype)


def _with_special(x):
  if x.dtype.kind != "f":
    return x
  flat = np.concatenate([x.reshape(-1), np.array(SPECIAL, x.dtype)])
  return flat


def _numpy(fn, *args):
  with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    return np.asarray(fn(*args))


def _close(got, want, name, dtype, port_dtype=None):
  got, want = np.asarray(got), np.asarray(want)
  assert got.shape == want.shape, (got.shape, want.shape)
  if want.dtype.kind in "biu" or name in EXACT:
    np.testing.assert_array_equal(got, want.astype(got.dtype))
    return
  rtol = RTOL.get(str(port_dtype or got.dtype), 1e-6)
  # a float32 reference against the port's float64 (int32 input): its
  # values near 0 are float32 roundings of values of order 1
  finite = np.isfinite(want)
  atol = (1e-6 * float(np.abs(want[finite]).max(initial=0.0))
          if port_dtype == "float32" and got.dtype == np.float64 else 0.0)
  np.testing.assert_allclose(got.astype(np.float64),
                             want.astype(np.float64), rtol=rtol, atol=atol,
                             equal_nan=True)


def _dtype_like_numpy(got, want, x):
  if x.dtype == np.bool_ and want.dtype == np.float16:
    assert got.dtype == np.float64  # the port's pinned bool promotion
  else:
    assert got.dtype == want.dtype, (got.dtype, want.dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32", "int32", "bool"])
@pytest.mark.parametrize("name, np_fn, domain", UNARY,
                         ids=[u[0] for u in UNARY])
def test_unary_ufunc_against_numpy_and_the_reference(name, np_fn, domain,
                                                     dtype):
  x = _regular(domain, dtype)
  full = _with_special(x)
  got = getattr(sp, name)(sp.from_numpy(full)).glom()
  want = _numpy(np_fn, full.astype(np.float64) if dtype == "bool" else full)
  _dtype_like_numpy(got, _numpy(np_fn, full), full)
  _close(got, want, name, dtype)
  empty = np.zeros((0, 3), x.dtype)
  assert getattr(sp, name)(sp.from_numpy(empty)).glom().shape == (0, 3)
  if dtype == "bool":
    return
  if name == "spacing":
    if dtype == "int32":
      return  # the reference's float32 spacing against float64's
    x = x[x != 0]  # the reference flushes the subnormal spacing of 0
  r = np.asarray(getattr(ref, name)(ref.from_numpy(x)).glom())
  mine = getattr(sp, name)(sp.from_numpy(x)).glom()
  _close(mine, r.astype(mine.dtype), name, dtype,
         port_dtype="float32" if r.dtype == np.float32 else None)


@pytest.mark.parametrize("dtype", ["float64", "float32", "int32"])
@pytest.mark.parametrize("name, np_fn", BINARY, ids=[b[0] for b in BINARY])
def test_binary_ufunc_against_numpy_and_the_reference(name, np_fn, dtype):
  x = _regular("any", dtype, seed=1)
  y = _regular("any", dtype, seed=2)
  if dtype != "int32":
    x = np.concatenate([x.reshape(-1), np.array(
        SPECIAL + [0.0, 2.0, np.inf], dtype)])
    y = np.concatenate([y.reshape(-1), np.array(
        [1.0, np.nan, np.inf, -0.0, 0.0, 3.0, 0.0, np.nan, np.inf], dtype)])
  got = getattr(sp, name)(sp.from_numpy(x), sp.from_numpy(y)).glom()
  want = _numpy(np_fn, x, y)
  _dtype_like_numpy(got, want, x)
  _close(got, want, name, dtype)
  # a weak Python scalar on either side keeps the array's float dtype
  got_s = getattr(sp, name)(sp.from_numpy(x), 0.5).glom()
  want_s = _numpy(np_fn, x, 0.5)
  assert got_s.dtype == want_s.dtype
  _close(got_s, want_s, name, dtype)
  if name == "nextafter" and dtype == "int32":
    return  # the reference's float32 steps against float64's
  xr, yr = _regular("any", dtype, 3), _regular("any", dtype, 4)
  r = np.asarray(getattr(ref, name)(ref.from_numpy(xr),
                                    ref.from_numpy(yr)).glom())
  mine = getattr(sp, name)(sp.from_numpy(xr), sp.from_numpy(yr)).glom()
  _close(mine, r.astype(mine.dtype), name, dtype,
         port_dtype="float32" if r.dtype == np.float32 else None)


INT_BINARY = [("gcd", np.gcd), ("lcm", np.lcm),
              ("bitwise_left_shift", np.left_shift),
              ("bitwise_right_shift", np.right_shift), ("pow", np.power)]


@pytest.mark.parametrize("dtype", ["int32", "int8"])
@pytest.mark.parametrize("name, np_fn", INT_BINARY,
                         ids=[b[0] for b in INT_BINARY])
def test_integer_binary_ufunc_exact(name, np_fn, dtype):
  rng = np.random.default_rng(5)
  x = rng.integers(-12, 13, (5, 6)).astype(dtype)
  y = rng.integers(0, 5 if "shift" in name or name == "pow" else 13,
                   (5, 6)).astype(dtype)
  got = getattr(sp, name)(sp.from_numpy(x), sp.from_numpy(y)).glom()
  want = np_fn(x, y)
  assert got.dtype == want.dtype
  np.testing.assert_array_equal(got, want)
  r = np.asarray(getattr(ref, name)(ref.from_numpy(x),
                                    ref.from_numpy(y)).glom())
  np.testing.assert_array_equal(got, r.astype(got.dtype))


@pytest.mark.parametrize("dtype", ["int8", "int32", "bool"])
@pytest.mark.parametrize("name", ["bitwise_count", "bitwise_invert"])
def test_integer_unary_ufunc_exact(name, dtype):
  rng = np.random.default_rng(6)
  x = (rng.random((4, 5)) < 0.5 if dtype == "bool" else rng.integers(
      np.iinfo(dtype).min, np.iinfo(dtype).max, (4, 5)).astype(dtype))
  got = getattr(sp, name)(sp.from_numpy(x)).glom()
  want = {"bitwise_count": np.bitwise_count, "bitwise_invert": np.invert}[
      name](x)
  assert got.dtype == want.dtype
  np.testing.assert_array_equal(got, want)
  r = np.asarray(getattr(ref, name)(ref.from_numpy(x)).glom())
  np.testing.assert_array_equal(got, r.astype(got.dtype))


def test_integer_ufuncs_refuse_floats():
  f = sp.from_numpy(np.ones(3))
  for fn in (sp.gcd, sp.lcm):
    with pytest.raises(TypeError):
      fn(f, f).glom()
  with pytest.raises(TypeError):
    sp.bitwise_count(f).glom()
  with pytest.raises(TypeError):
    sp.ldexp(f, 1.5)


@pytest.mark.parametrize("dtype", ["float64", "float32", "int32"])
def test_ldexp(dtype):
  x = _regular("any", dtype, 7)
  e = np.random.default_rng(8).integers(-40, 40, x.shape).astype(np.int32)
  got = sp.ldexp(sp.from_numpy(x), sp.from_numpy(e)).glom()
  want = np.ldexp(x, e)
  assert got.dtype == want.dtype
  np.testing.assert_array_equal(got, want)
  # past float32's range for 2**e, yet in range for the product
  tiny = np.array([1e-30, 0.0, -3e-38], np.float32)
  np.testing.assert_array_equal(
      sp.ldexp(sp.from_numpy(tiny), 120).glom(), np.ldexp(tiny, 120))
  r = np.asarray(ref.ldexp(ref.from_numpy(x), ref.from_numpy(e)).glom())
  np.testing.assert_allclose(got, r.astype(got.dtype), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float64", "float32", "int32"])
@pytest.mark.parametrize("name", ["modf", "frexp", "divmod"])
def test_tuple_ufuncs(name, dtype):
  x = _with_special(_regular("any", dtype, 9))
  if name == "divmod":
    got = sp.divmod(sp.from_numpy(x), 1.5)
    want = np.divmod(x, 1.5)
  else:
    got = getattr(sp, name)(sp.from_numpy(x))
    with warnings.catch_warnings():
      warnings.simplefilter("ignore")
      want = getattr(np, name)(x)
  for g, w in zip(got, want):
    g = g.glom()
    assert g.dtype == w.dtype, (g.dtype, w.dtype)
    np.testing.assert_array_equal(g, w)
    if name == "modf":  # the sign of a zero part follows x
      np.testing.assert_array_equal(np.signbit(g), np.signbit(w))
  xr = _regular("any", dtype, 10)
  if name == "divmod":
    rgot = ref.divmod(ref.from_numpy(xr), 1.5)
    mine = sp.divmod(sp.from_numpy(xr), 1.5)
  else:
    rgot = getattr(ref, name)(ref.from_numpy(xr))
    mine = getattr(sp, name)(sp.from_numpy(xr))
  for m, r in zip(mine, rgot):
    m = m.glom()
    np.testing.assert_allclose(m, np.asarray(r.glom()).astype(m.dtype),
                               rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float64", "float32", "int32"])
def test_isclose(dtype):
  x = _regular("any", dtype, 11)
  y = (x + np.where(np.arange(x.size).reshape(x.shape) % 2, 1e-9,
                    1e-3)).astype(x.dtype) if dtype != "int32" else x
  got = sp.isclose(sp.from_numpy(x), sp.from_numpy(y)).glom()
  np.testing.assert_array_equal(got, np.isclose(x, y))
  np.testing.assert_array_equal(
      got, np.asarray(ref.isclose(ref.from_numpy(x), ref.from_numpy(y)).glom()))
  sx = np.array([np.nan, np.inf, -np.inf, 1.0])
  np.testing.assert_array_equal(
      sp.isclose(sp.from_numpy(sx), sp.from_numpy(sx)).glom(),
      np.isclose(sx, sx))


def test_aliases_are_the_same_functions():
  for alias, name in (("asin", "arcsin"), ("acos", "arccos"),
                      ("atan", "arctan"), ("atan2", "arctan2"),
                      ("asinh", "arcsinh"), ("acosh", "arccosh"),
                      ("atanh", "arctanh"), ("pow", "power"),
                      ("bitwise_invert", "invert"),
                      ("bitwise_left_shift", "left_shift"),
                      ("bitwise_right_shift", "right_shift"),
                      ("conjugate", "conj")):
    assert getattr(sp, alias) is getattr(sp, name)


# -- eager predicates -------------------------------------------------------

PREDICATES = ["allclose", "array_equal", "array_equiv"]


@pytest.mark.parametrize("case", ["same", "close", "far", "nan", "shape",
                                  "broadcast", "int"])
@pytest.mark.parametrize("name", PREDICATES)
def test_eager_predicates(name, case):
  rng = np.random.default_rng(12)
  a = rng.uniform(-3, 3, (4, 5))
  b = {"same": a.copy(), "close": a * (1 + 1e-9), "far": a + 0.1,
       "nan": np.where(a > 0, np.nan, a), "shape": a[:3],
       "broadcast": np.tile(a[:1], (4, 1)), "int": a}[case]
  if case == "nan":
    a = b.copy()
  if case == "broadcast":
    a = a[:1]
  if case == "int":
    a = np.round(a).astype(np.int32)
    b = a.astype(np.float64)
  if name == "allclose" and case == "shape":
    with pytest.raises((ValueError, RuntimeError)):
      sp.allclose(a, b)
    return
  got = getattr(sp, name)(sp.from_numpy(a), sp.from_numpy(b))
  assert isinstance(got, bool)
  assert got == bool(getattr(np, name)(a, b))
  assert got == getattr(ref, name)(ref.from_numpy(a), ref.from_numpy(b))


@pytest.mark.parametrize("name", ["iscomplexobj", "isrealobj"])
@pytest.mark.parametrize("dtype", ["float32", "int32", "complex64", "bool"])
def test_dtype_predicates(name, dtype):
  a = np.ones((2, 3), dtype)
  got = getattr(sp, name)(sp.from_numpy(a))
  assert got is getattr(np, name)(a)
  assert got == getattr(ref, name)(ref.from_numpy(a))


@pytest.mark.parametrize("imag", [0.0, 1e-20, 1e-3])
def test_real_if_close(imag):
  a = np.array([1.0 + imag * 1j, 2.0 - imag * 1j])
  got = sp.real_if_close(sp.from_numpy(a)).glom()
  want = np.real_if_close(a)
  assert got.dtype == want.dtype
  np.testing.assert_array_equal(got, want)
  r = np.asarray(ref.real_if_close(ref.from_numpy(a)).glom())
  assert r.dtype == got.dtype
  real = np.array([1.5, 2.5])
  np.testing.assert_array_equal(
      sp.real_if_close(sp.from_numpy(real)).glom(), real)


@pytest.mark.parametrize("bad", [None, np.nan, np.inf])
def test_asarray_chkfinite(bad):
  a = np.arange(6.0)
  if bad is not None:
    a[2] = bad
    with pytest.raises(ValueError):
      sp.asarray_chkfinite(sp.from_numpy(a))
    with pytest.raises(ValueError):
      np.asarray_chkfinite(a)
    return
  got = sp.asarray_chkfinite(sp.from_numpy(a), dtype=np.float32).glom()
  np.testing.assert_array_equal(got, np.asarray_chkfinite(a, np.float32))
  assert got.dtype == np.float32
  np.testing.assert_array_equal(
      got, np.asarray(ref.asarray_chkfinite(ref.from_numpy(a),
                                            dtype=np.float32).glom()))
