"""The port's prefix scans (``expr/scan.py``: ``cumsum``, ``cumprod``,
``cummax``, ``cummin``, ``scan``, ``nancumsum``, ``nancumprod``) and
``unwrap`` against NumPy and the reference on its 8-device CPU mesh, on
seeded inputs carried across with ``interop.from_reference``.

Tolerances: integer scans and every ``max``/``min`` scan exactly; float64
sums and products at 1e-10 relative (float32 input accumulates in
float64, as the reference's, and is held to NumPy's float64 scan of the
same values); ``unwrap`` at 1e-10 relative in float64 and 2^-20 of the
largest |value| in float32 (NumPy's float32 steps, a cumsum in another
order on the card).  ``scan_fn`` scans combine as
``lax.associative_scan`` does (pairs, then the half-size scan): with
``torch.maximum`` they are exact; with ``torch.logaddexp`` each step is
within 2 ulps of the exact value, so the port is held to the reference
(the same 2·log2(n) steps, another ``logaddexp``) at 64 float64 ulps and
to NumPy's sequential ``logaddexp.accumulate`` (n steps) at 2n ulps.

Pinned (ROADMAP): ``cumsum``/``cumprod`` of uint8 give int64 (torch has
no uint64 arithmetic), where NumPy and the reference give uint64.
"""

import numpy as np
import pytest
import torch

import spartan_tpu as ref

import spartan_tpu_torch as sp
from spartan_tpu_torch.expr.base import EmitCtx
from spartan_tpu_torch.expr.scan import CustomScanExpr, ScanExpr

ULP = 2.0 ** -52


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


RNG = np.random.default_rng(16)
F64 = RNG.standard_normal((5, 7))
SPECIAL = F64.copy()
SPECIAL[1, 2], SPECIAL[3, 0], SPECIAL[4, 6] = np.nan, np.inf, -np.inf
SPECIAL[0, 1], SPECIAL[2, 3] = 0.0, -0.0
DATA = {"float64": F64, "float32": F64.astype(np.float32),
        "int32": RNG.integers(-9, 10, (5, 7)).astype(np.int32),
        "bool": RNG.random((5, 7)) < 0.5,
        "uint8": RNG.integers(0, 256, (5, 7)).astype(np.uint8),
        "special": SPECIAL, "empty": np.zeros((0, 3))}
KINDS = tuple(DATA)


def _glom(x):
  return np.asarray(x.glom())


def _carried(x):
  """``x`` as the reference holds it, and carried across to the port."""
  r = ref.from_numpy(x)
  return r, sp.interop.from_reference(r)


def _wide(x):
  """NumPy's scan input for the port's accumulation dtype."""
  kind = x.dtype.kind
  return x.astype(np.int64 if kind in "biu" else np.float64)


def _held(got, want, exact):
  got, want = np.asarray(got), np.asarray(want)
  assert got.shape == want.shape, (got.shape, want.shape)
  if exact or want.dtype.kind in "biu":
    np.testing.assert_array_equal(got, want)
  else:
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


AXES = (None, 0, 1, -1)
# name → (call over a module m, NumPy's call over x, exact)
CASES = {
    "cumsum": (lambda m, x, a: m.cumsum(x, axis=a),
               lambda x, a: np.cumsum(_wide(x), axis=a), False),
    "cumprod": (lambda m, x, a: m.cumprod(x, axis=a),
                lambda x, a: np.cumprod(_wide(x), axis=a), False),
    "cummax": (lambda m, x, a: m.cummax(x, axis=a),
               lambda x, a: np.maximum.accumulate(
                   x.ravel() if a is None else x, axis=0 if a is None else a),
               True),
    "cummin": (lambda m, x, a: m.cummin(x, axis=a),
               lambda x, a: np.minimum.accumulate(
                   x.ravel() if a is None else x, axis=0 if a is None else a),
               True),
    "scan_sum_reverse": (
        lambda m, x, a: m.scan(x, "sum", axis=a, reverse=True),
        lambda x, a: np.flip(np.cumsum(np.flip(_wide(x).ravel() if a is None
                                               else _wide(x), 0 if a is None
                                               else a), axis=0 if a is None
                                       else a), 0 if a is None else a),
        False),
    "scan_max_reverse": (
        lambda m, x, a: m.scan(x, "max", axis=a, reverse=True),
        lambda x, a: np.flip(np.maximum.accumulate(
            np.flip(x.ravel() if a is None else x, 0 if a is None else a),
            axis=0 if a is None else a), 0 if a is None else a), True),
    "nancumsum": (lambda m, x, a: m.nancumsum(x, axis=a),
                  lambda x, a: np.nancumsum(_wide(x), axis=a), False),
    "nancumprod": (lambda m, x, a: m.nancumprod(x, axis=a),
                   lambda x, a: np.nancumprod(_wide(x), axis=a), False),
}
# the reference's dtype differs: uint8 sums and products in uint64
REF_DTYPE = {("cumsum", "uint8"), ("cumprod", "uint8"),
             ("scan_sum_reverse", "uint8"), ("nancumsum", "uint8"),
             ("nancumprod", "uint8")}


@pytest.mark.parametrize("axis", AXES, ids=str)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_scans_against_numpy_and_the_reference(name, kind, axis):
  call, np_call, exact = CASES[name]
  x = DATA[kind]
  r, p = _carried(x)
  e = call(sp, p, axis)
  with np.errstate(all="ignore"):
    want = np_call(x, axis)
  got = _glom(e)
  assert e.shape == got.shape and e.dtype == torch.from_numpy(got).dtype
  _held(got, want, exact)
  rgot = _glom(call(ref, r, axis))
  if (name, kind) in REF_DTYPE:
    assert rgot.dtype == np.uint64 and got.dtype == np.int64
    rgot = rgot.astype(np.int64)
  assert got.dtype == rgot.dtype, (got.dtype, rgot.dtype)
  _held(got, rgot, exact)


def test_float32_scans_accumulate_in_float64():
  x = DATA["float32"]
  got = _glom(sp.cumsum(x, axis=1))
  assert got.dtype == np.float64
  np.testing.assert_array_equal(got, np.cumsum(x.astype(np.float64), axis=1))
  assert _glom(sp.cummax(x)).dtype == np.float32


@pytest.mark.parametrize("name", ["cumsum", "cumprod"])
def test_uint8_sums_are_int64_where_numpy_gives_uint64(name):
  x = np.array([200, 100, 3], np.uint8)
  got = _glom(getattr(sp, name)(x))
  want = getattr(np, name)(x)
  assert got.dtype == np.int64 and want.dtype == np.uint64
  np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("name", ["cummax", "cummin"])
def test_nan_propagates_through_cummax_and_cummin(name):
  x = np.array([1.0, np.nan, 3.0, -2.0, np.inf])
  got = _glom(getattr(sp, name)(x))
  np.testing.assert_array_equal(
      got, getattr(np, name[3:] + "imum").accumulate(x))
  assert np.isnan(got[1:4]).all()


def test_scan_shapes_come_from_meta_tensors():
  x = sp.from_numpy(DATA["int32"])
  for e, shape, dtype in ((ScanExpr(x, "sum", axis=None), (35,), torch.int64),
                          (ScanExpr(x, "max", axis=0), (5, 7), torch.int32),
                          (CustomScanExpr(x, torch.add, axis=1), (5, 7),
                           torch.int32)):
    v = e._emit(EmitCtx(abstract=True),
                [torch.empty((5, 7), dtype=torch.int32, device="meta")])
    assert v.device.type == "meta"
    assert tuple(v.shape) == shape == e.shape and v.dtype == dtype == e.dtype
  with pytest.raises(ValueError, match="unknown scan op"):
    ScanExpr(x, "mean")


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 33, 257])
@pytest.mark.parametrize("reverse", [False, True])
def test_associative_scan_is_the_references_combination_order(n, reverse):
  """``a * 0.5 + b`` is neither commutative nor associative, so its scan
  shows the order of the combinations: the port must make the same calls
  as ``lax.associative_scan``, the earlier element first, and with
  ``reverse`` fold from the end."""
  from spartan_tpu_torch.expr.scan import associative_scan
  x = torch.arange(n, dtype=torch.float64)
  calls = []

  def fn(a, b):
    calls.append(a.shape[0])
    return a * 0.5 + b  # associative only up to rounding: order shows
  got = associative_scan(fn, x, 0, reverse)
  import jax
  import jax.numpy as jnp
  want = jax.lax.associative_scan(lambda a, b: a * 0.5 + b,
                                  jnp.asarray(x.numpy()), reverse=reverse)
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))
  assert len(calls) <= 2 * max(int(np.ceil(np.log2(max(n, 2)))), 1)


def test_cumsum(rng):
  a = rng.standard_normal((12, 16))
  r, p = _carried(a)
  for axis in (0, 1, None):
    got = _glom(sp.cumsum(p, axis=axis))
    np.testing.assert_allclose(got, np.cumsum(a, axis=axis), rtol=1e-13)
    np.testing.assert_allclose(got, _glom(ref.cumsum(r, axis=axis)),
                               rtol=1e-13)


def test_cumprod(rng):
  a = rng.uniform(0.9, 1.1, (10, 10))
  r, p = _carried(a)
  got = _glom(sp.cumprod(p, axis=1))
  np.testing.assert_allclose(got, a.cumprod(axis=1), rtol=1e-12)
  np.testing.assert_allclose(got, _glom(ref.cumprod(r, axis=1)), rtol=1e-12)


def test_cummax(rng):
  a = rng.standard_normal((30,))
  r, p = _carried(a)
  got = _glom(sp.scan(p, "max", axis=0))
  np.testing.assert_array_equal(got, np.maximum.accumulate(a))
  np.testing.assert_array_equal(got, _glom(ref.scan(r, "max", axis=0)))


def test_int_cumsum(rng):
  x = rng.integers(0, 10, (20,), dtype=np.int32)
  got = sp.cumsum(sp.from_numpy(x)).glom()
  assert got.dtype == np.int64
  np.testing.assert_array_equal(got, x.astype(np.int64).cumsum())
  np.testing.assert_array_equal(got, ref.cumsum(ref.from_numpy(x)).glom())


def test_custom_scan_fn(rng):
  """The extensible scan: a user's associative combiner over torch
  tensors."""
  import jax.numpy as jnp
  x = rng.standard_normal(257)
  r, p = _carried(x)
  got = _glom(sp.scan(p, scan_fn=torch.maximum))
  np.testing.assert_array_equal(got, np.maximum.accumulate(x))
  np.testing.assert_array_equal(got, _glom(ref.scan(r, scan_fn=jnp.maximum)))
  # log-sum-exp running accumulation (associative in log space)
  got = _glom(sp.scan(p, scan_fn=torch.logaddexp))
  rgot = _glom(ref.scan(r, scan_fn=jnp.logaddexp))
  want = np.logaddexp.accumulate(x)
  np.testing.assert_allclose(got, rgot, rtol=64 * ULP, atol=0)
  np.testing.assert_allclose(got, want, rtol=2 * x.size * ULP, atol=0)
  # reverse form
  got = _glom(sp.scan(p, scan_fn=torch.maximum, reverse=True))
  np.testing.assert_array_equal(got, np.maximum.accumulate(x[::-1])[::-1])
  np.testing.assert_array_equal(got, _glom(ref.scan(r, scan_fn=jnp.maximum,
                                                    reverse=True)))
  # 2-D along an axis
  m = rng.standard_normal((8, 16))
  rm, pm = _carried(m)
  got = _glom(sp.scan(pm, scan_fn=torch.minimum, axis=1))
  np.testing.assert_array_equal(got, np.minimum.accumulate(m, axis=1))
  np.testing.assert_array_equal(got, _glom(ref.scan(rm, scan_fn=jnp.minimum,
                                                    axis=1)))


@pytest.mark.parametrize("kind", ["float64", "int32", "bool", "empty"])
@pytest.mark.parametrize("axis", [None, 0, 1])
def test_custom_scan_of_integers_and_bools_is_exact(kind, axis):
  import jax.numpy as jnp
  x = DATA[kind]
  r, p = _carried(x)
  for fn, jfn, npfn in ((torch.maximum, jnp.maximum, np.maximum),
                        (torch.add, jnp.add, np.add)):
    if kind == "bool" and fn is torch.add:
      continue
    got = _glom(sp.scan(p, scan_fn=fn, axis=axis))
    want = npfn.accumulate(x.ravel() if axis is None else x,
                           axis=0 if axis is None else axis)
    if kind == "float64" and fn is torch.add:
      np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-14)
    else:
      np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _glom(ref.scan(r, scan_fn=jfn,
                                                      axis=axis)))


def test_expr_methods_cumsum_and_cumprod():
  x = DATA["float64"]
  r, p = _carried(x)
  for name in ("cumsum", "cumprod"):
    for axis in (None, 0, 1):
      got = _glom(getattr(sp.lazify(p), name)(axis=axis))
      np.testing.assert_allclose(got, getattr(np, name)(x, axis=axis),
                                 rtol=1e-10, atol=1e-12)
      np.testing.assert_allclose(
          got, _glom(getattr(ref.lazify(r), name)(axis=axis)), rtol=1e-10,
          atol=1e-12)


PHASES = np.cumsum(RNG.uniform(-4.5, 4.5, (4, 40)), axis=1)


@pytest.mark.parametrize("args", [
    {}, {"axis": 0}, {"discont": 4.0}, {"period": 5.0},
    {"period": 360.0, "discont": 100.0}], ids=str)
@pytest.mark.parametrize("kind", ["float64", "float32", "int32"])
def test_unwrap(kind, args):
  x = {"float64": PHASES, "float32": PHASES.astype(np.float32),
       "int32": np.round(PHASES * 40).astype(np.int32)}[kind]
  r, p = _carried(x)
  got = _glom(sp.unwrap(p, **args))
  want = np.unwrap(x, **args)
  assert got.dtype == want.dtype, (got.dtype, want.dtype)
  if kind == "float32":
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2.0 ** -20 * np.abs(want).max())
  else:
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
  rgot = _glom(ref.unwrap(r, **args))
  np.testing.assert_allclose(got, rgot, rtol=1e-5 if kind == "float32" else
                             1e-10, atol=1e-5 * np.abs(want).max())


def test_unwrap_with_an_integer_period_stays_integer():
  x = (np.arange(30) * 7) % 23
  got = _glom(sp.unwrap(x, period=10))
  want = np.unwrap(x, period=10)
  assert got.dtype == want.dtype == np.int64
  np.testing.assert_array_equal(got, want)
  odd = _glom(sp.unwrap(x, period=9))
  np.testing.assert_array_equal(odd, np.unwrap(x, period=9))
