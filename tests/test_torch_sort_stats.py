"""The port's order statistics (``PercentileExpr``: ``percentile``,
``median``, ``quantile``; and ``nanmedian``, ``nanpercentile``,
``nanquantile``) against NumPy and the reference on its 8-device CPU
mesh, on seeded inputs carried across with ``interop.from_reference``.

The port computes NumPy's ``linear`` method as NumPy does: the virtual
index ``(n - 1) q``, the floor and ceil ranks of the sorted slice, and
NumPy's ``_lerp`` (``a + (b - a) t``, or ``b - (b - a)(1 - t)`` for
``t >= 0.5``) in float64.  Tolerances: float64, integer and bool input
exactly against NumPy, except ``median``/``nanmedian`` at 1e-15 relative
(NumPy's is the mean of the two middle values, the same lerp at
t = 0.5 in another form); against the reference at 1e-10
relative (its lerp is ``a (1 - t) + b t``).  float32 input against NumPy
within (n + 2) float32 ulps of the largest |value| (NumPy's float32 index
for a scalar q carries n rounding errors of 2^-24; the port's float64 lerp
rounds once) and against the reference at 1e-6 relative of the same.

Pinned (ROADMAP): float32 input gives float32 for a vector q too (the
reference's dtype; NumPy gives float64 there, as its q divides in
float64); the nan-functions of integers give NumPy's float64 (the
reference's jnp functions float32, held at the float32 tolerance); an
empty slice gives NaN (NumPy raises ``IndexError``).
"""

import contextlib
import warnings

import numpy as np
import pytest
import torch

import spartan_tpu as ref

import spartan_tpu_torch as sp


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


RNG = np.random.default_rng(18)
F64 = RNG.standard_normal((6, 7))
SPECIAL = F64.copy()
SPECIAL[0, [1, 4]] = np.nan
SPECIAL[2, 3], SPECIAL[5, 0] = np.inf, -np.inf
SPECIAL[4, [2, 5]] = [0.0, -0.0]
ALL_NAN = F64.copy()
ALL_NAN[3] = np.nan
ALL_NAN[1, [0, 6]] = np.nan
DATA = {"float64": F64, "float32": F64.astype(np.float32),
        "int32": RNG.integers(-20, 21, (6, 7)).astype(np.int32),
        "bool": RNG.random((6, 7)) < 0.5,
        "uint8": RNG.integers(0, 256, (6, 7)).astype(np.uint8),
        "ties": RNG.integers(0, 3, (6, 7)).astype(np.float64),
        "special": SPECIAL, "all_nan_row": ALL_NAN}
KINDS = tuple(DATA)
AXES = (None, 0, 1, (0, 1))
QS = {"scalar": 37.5, "zero": 0, "hundred": 100, "vector": [1, 50, 99],
      "vector_ties": [25.0, 25.0, 100.0 / 3]}


def _glom(x):
  return np.asarray(x.glom())


def _carried(x):
  r = ref.from_numpy(x)
  return r, sp.interop.from_reference(r)


def _held(got, want, x, rtol=0.0, f32=False):
  got, want = np.asarray(got), np.asarray(want)
  assert got.shape == want.shape, (got.shape, want.shape)
  if f32:
    fin = np.abs(x[np.isfinite(x)])
    scale = float(fin.max()) if fin.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=(x.size + 2) * 2.0 ** -23 * scale)
  elif rtol:
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)
  else:
    np.testing.assert_array_equal(got, want)


@contextlib.contextmanager
def _quiet():
  with np.errstate(all="ignore"), warnings.catch_warnings():
    warnings.simplefilter("ignore", RuntimeWarning)
    yield


def _expected_dtype(x):
  return np.float64 if x.dtype.kind in "biu" else x.dtype


# name → (the port/reference call over a module m, NumPy's call, its
# relative tolerance against NumPy outside float32)
CASES = {
    "percentile": (lambda m, x, q, a: m.percentile(x, q, axis=a),
                   lambda x, q, a: np.percentile(x, q, axis=a), 0.0),
    "quantile": (lambda m, x, q, a: m.quantile(x, np.asarray(q) / 100,
                                               axis=a),
                 lambda x, q, a: np.quantile(x, np.asarray(q) / 100, axis=a),
                 0.0),
    "nanpercentile": (lambda m, x, q, a: m.nanpercentile(x, q, axis=a),
                      lambda x, q, a: np.nanpercentile(x, q, axis=a), 0.0),
    "nanquantile": (lambda m, x, q, a: m.nanquantile(x, np.asarray(q) / 100,
                                                     axis=a),
                    lambda x, q, a: np.nanquantile(x, np.asarray(q) / 100,
                                                   axis=a), 0.0),
}
# between -inf and a number NumPy's lerp (and the port's) gives NaN, the
# reference's a (1 - t) + b t gives -inf: held to NumPy
# (test_infinite_neighbours_follow_numpys_lerp)
REF_SKIP = {(name, "special", q) for name in CASES
            for q in ("vector", "vector_ties")}


@pytest.mark.parametrize("axis", AXES, ids=str)
@pytest.mark.parametrize("q", sorted(QS))
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_quantiles_against_numpy_and_the_reference(name, kind, q, axis):
  call, np_call, rtol = CASES[name]
  x = DATA[kind]
  r, p = _carried(x)
  if kind == "bool":  # NumPy's lerp subtracts booleans, and raises
    with pytest.raises(TypeError, match="boolean subtract"):
      np_call(x, QS[q], axis)
    with pytest.raises(TypeError, match="boolean subtract"):
      call(sp, p, QS[q], axis)
    return
  e = call(sp, p, QS[q], axis)
  got = _glom(e)
  assert e.shape == got.shape
  assert got.dtype == _expected_dtype(x)
  with _quiet():  # NumPy warns of all-NaN slices
    want = np_call(x, QS[q], axis)
  f32 = kind == "float32"
  _held(got, want.astype(got.dtype) if f32 else want, x, rtol, f32)
  if (name, kind, q) in REF_SKIP:
    return
  rgot = _glom(call(ref, r, QS[q], axis))
  if name.startswith("nan") and kind in ("int32", "uint8"):
    # jnp's nan-functions of integers compute in float32
    assert rgot.dtype == np.float32
    f32 = True
  assert rgot.dtype == got.dtype or f32, (rgot.dtype, got.dtype)
  if f32:
    _held(got, rgot, x, f32=True)
  else:
    np.testing.assert_allclose(got, rgot, rtol=1e-10, atol=1e-300)


@pytest.mark.parametrize("axis", AXES, ids=str)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", ["median", "nanmedian"])
def test_medians_against_numpy_and_the_reference(name, kind, axis):
  x = DATA[kind]
  r, p = _carried(x)
  got = _glom(getattr(sp, name)(p, axis=axis))
  assert got.dtype == _expected_dtype(x)
  with _quiet():
    want = getattr(np, name)(x, axis=axis)
  f32 = kind == "float32"
  _held(got, np.asarray(want).astype(got.dtype), x, 1e-15, f32)
  rgot = _glom(getattr(ref, name)(r, axis=axis))
  if name == "nanmedian" and kind in ("int32", "uint8"):
    assert rgot.dtype == np.float32  # jnp's nanmedian of integers
    f32 = True
  if f32:
    _held(got, rgot, x, f32=True)
  else:
    np.testing.assert_allclose(got, rgot, rtol=1e-10, atol=1e-300)


def test_median_is_the_mean_of_the_middle_two_not_the_lower():
  x = np.array([1.0, 2.0, 3.0, 4.0])
  assert float(sp.median(x).glom()) == 2.5 == np.median(x)
  assert float(torch.median(torch.tensor(x))) == 2.0  # why it is not used
  i = np.array([[4, 1, 3, 2], [7, 7, 8, 8]], np.int32)
  np.testing.assert_array_equal(_glom(sp.median(i, axis=1)), [2.5, 7.5])


@pytest.mark.parametrize("name", ["quantile", "nanquantile"])
def test_quantile_on_a_rank_is_that_rank_exactly(name):
  """(n - 1) q = 125 * 0.056 lands on rank 7 exactly: the port keeps q as
  given, so it returns rank 7's value, 0.0, and does not lerp toward rank
  8's 1.0 (``0.056 * 100 / 100`` is 0.05600000000000001, whose index is
  7.000000000000001)."""
  x = np.random.default_rng(3).permutation(126).astype(np.float64) - 7
  assert np.sort(x)[7:9].tolist() == [0.0, 1.0]
  got = _glom(getattr(sp, name)(x, 0.056))
  want = getattr(np, name)(x, 0.056)
  assert want == 0.0
  np.testing.assert_array_equal(got, want)
  got = _glom(getattr(sp, name)(x, [0.056, 0.104, 0.5]))
  np.testing.assert_array_equal(
      got, getattr(np, name)(x, [0.056, 0.104, 0.5]))


def test_infinite_neighbours_follow_numpys_lerp():
  x = np.array([-np.inf, 1.0, 2.0, np.inf])
  q = [0, 10, 50, 100]
  got = _glom(sp.percentile(x, q))
  with _quiet():
    want = np.percentile(x, q)
  np.testing.assert_array_equal(got, want)
  np.testing.assert_array_equal(got, [np.nan, np.nan, 1.5, np.nan])
  rgot = _glom(ref.percentile(ref.from_numpy(x), q))
  assert rgot[1] == -np.inf


def test_any_nan_in_a_slice_gives_nan():
  x = F64.copy()
  x[0, [1, 4]] = np.nan
  got = _glom(sp.percentile(x, [0, 50, 100], axis=1))
  assert np.isnan(got[:, 0]).all() and not np.isnan(got[:, 1:]).any()
  assert np.isnan(float(sp.median(x).glom()))
  got = _glom(sp.nanpercentile(ALL_NAN, [0, 50], axis=1))
  assert np.isnan(got[:, 3]).all() and not np.isnan(np.delete(got, 3,
                                                              1)).any()


def test_float32_with_a_vector_q_stays_float32():
  x = DATA["float32"]
  got = _glom(sp.percentile(x, [10, 90], axis=0))
  assert got.dtype == np.float32
  assert np.percentile(x, [10, 90], axis=0).dtype == np.float64
  assert _glom(ref.percentile(ref.from_numpy(x), [10, 90],
                              axis=0)).dtype == np.float32


def test_empty_slices_give_nan():
  x = np.zeros((0, 3))
  got = _glom(sp.percentile(x, [10, 90], axis=0))
  assert got.shape == (2, 3) and np.isnan(got).all()
  with pytest.raises(IndexError):
    np.percentile(x, [10, 90], axis=0)
  assert _glom(sp.median(x, axis=1)).shape == (0,)


def test_percentile_refuses_what_numpy_refuses():
  x = DATA["float64"]
  for bad in (-1, 101, [10, 120]):
    with pytest.raises(ValueError, match="Percentiles"):
      sp.percentile(x, bad)
    with pytest.raises(ValueError, match="Percentiles"):
      sp.nanpercentile(x, bad)
  for bad in (-0.1, 1.5):
    with pytest.raises(ValueError, match="Quantiles"):
      sp.quantile(x, bad)
    with pytest.raises(ValueError, match="Quantiles"):
      sp.nanquantile(x, bad)
  with pytest.raises(TypeError, match="real numbers"):
    sp.percentile(x + 1j, 50).glom()


def test_long_slices_past_torch_quantiles_limit_of_2_to_24():
  """``torch.quantile`` refuses inputs past 2^24 elements; the port sorts
  and gathers, so it has no such limit (a 2^24 + 3 slice here)."""
  rng = np.random.default_rng(2)
  x = rng.standard_normal((1 << 24) + 3).astype(np.float32)
  got = _glom(sp.percentile(x, [0, 1, 50, 99.9999, 100]))
  want = np.percentile(x.astype(np.float64), [0, 1, 50, 99.9999, 100])
  np.testing.assert_allclose(got, want.astype(np.float32), rtol=2.0 ** -23)
  with pytest.raises(RuntimeError, match="too large"):
    torch.quantile(torch.from_numpy(x), 0.5)
