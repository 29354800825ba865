"""The port's statistics and calculus builtins (``amax`` … ``correlate``)
against NumPy and the reference.

Inputs come from a NumPy seed, with NaN, ±inf and empty arrays where they
apply.  Tolerances: integer, bool and index results, ``amax``/``amin``/
``ptp``/``diff``/``ediff1d`` and the integer ``convolve``/``correlate``
exactly; float64 at 1e-10 (sums in another order); float32 at 1e-5 of the
largest |value| (float32 sums of a few terms in another order, and
``F.conv1d``'s order).  ``gradient`` and ``interp`` compute as NumPy does
(the same operations on the same dtypes) and are held to NumPy exactly on
the CPU.

Pinned where NumPy and the reference differ (ROADMAP): ``cov``,
``corrcoef`` and ``interp`` give float64 for float32 input, as NumPy (the
reference keeps float32), and ``trapezoid`` of integers float64; a
weighted ``average`` is NumPy's result type; ``gradient`` of a 2-D array is NumPy's tuple of one array an
axis (the reference raises); ``nanargmax``/``nanargmin`` of an all-NaN
slice give -1, the reference's value, where NumPy raises.
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


RNG = np.random.default_rng(15)
F64 = RNG.standard_normal((5, 7))
F64_SPECIAL = F64.copy()
F64_SPECIAL[1, 2], F64_SPECIAL[3, 0], F64_SPECIAL[4, 6] = np.nan, np.inf, -np.inf
DATA = {"float64": F64, "float32": F64.astype(np.float32),
        "int32": RNG.integers(-9, 10, (5, 7)).astype(np.int32),
        "bool": RNG.random((5, 7)) < 0.5, "special": F64_SPECIAL,
        "empty": np.zeros((0, 3))}
W = RNG.random(7) + 0.1
XS = np.cumsum(RNG.random(7) + 0.05)


def _glom(x):
  return np.asarray(x.glom())


def _close(got, want, kind, exact=False):
  got, want = np.asarray(got), np.asarray(want)
  assert got.shape == want.shape, (got.shape, want.shape)
  if exact or want.dtype.kind in "biu":
    np.testing.assert_array_equal(got, want)
  elif kind == "float32":
    fin = np.abs(want[np.isfinite(want)])
    scale = max(float(fin.max()) if fin.size else 0.0, 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
  else:
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


# name → (port/reference call over a module m and x, NumPy's call, exact,
# data kinds, whether the reference's dtype is NumPy's)
CASES = {
    "amax": (lambda m, x: m.amax(x, axis=1), lambda x: np.amax(x, axis=1),
             True, ("float64", "float32", "int32", "bool", "special")),
    "amin": (lambda m, x: m.amin(x), lambda x: np.amin(x), True,
             ("float64", "float32", "int32", "bool", "special")),
    "ptp": (lambda m, x: m.ptp(x, axis=0), lambda x: np.ptp(x, axis=0), True,
            ("float64", "float32", "int32", "special")),
    "average": (lambda m, x: m.average(x, axis=1),
                lambda x: np.average(x.astype(np.float64), axis=1), False,
                ("float64", "int32")),
    "average_weights": (lambda m, x: m.average(x, axis=1, weights=W),
                        lambda x: np.average(x, axis=1, weights=W), False,
                        ("float64", "float32", "int32", "bool")),
    "average_weights_2d": (lambda m, x: m.average(x, weights=np.abs(x) + 1),
                           lambda x: np.average(x, weights=np.abs(x) + 1),
                           False, ("float64", "float32")),
    "cov": (lambda m, x: m.cov(x), lambda x: np.cov(x), False,
            ("float64", "float32", "int32")),
    "cov_cols_ddof0": (lambda m, x: m.cov(x, rowvar=False, ddof=0),
                       lambda x: np.cov(x, rowvar=False, ddof=0), False,
                       ("float64", "float32", "int32")),
    "cov_one_variable": (lambda m, x: m.cov(x[0]), lambda x: np.cov(x[0]),
                         False, ("float64", "float32")),
    "corrcoef": (lambda m, x: m.corrcoef(x), lambda x: np.corrcoef(x), False,
                 ("float64", "float32", "int32")),
    "corrcoef_cols": (lambda m, x: m.corrcoef(x, rowvar=False),
                      lambda x: np.corrcoef(x, rowvar=False), False,
                      ("float64", "float32")),
    "nanargmax": (lambda m, x: m.nanargmax(x), lambda x: np.nanargmax(x),
                  True, ("float64", "float32", "int32", "bool", "special")),
    "nanargmin": (lambda m, x: m.nanargmin(x), lambda x: np.nanargmin(x),
                  True, ("float64", "float32", "int32", "bool", "special")),
    "nanprod": (lambda m, x: m.nanprod(x, axis=1),
                lambda x: np.nanprod(x.astype(np.float64), axis=1), False,
                ("float64", "float32", "special")),
    "diff": (lambda m, x: m.diff(x), lambda x: np.diff(x), True,
             ("float64", "float32", "int32", "bool", "special", "empty")),
    "diff_n2_axis0": (lambda m, x: m.diff(x, 2, axis=0),
                      lambda x: np.diff(x, 2, axis=0), True,
                      ("float64", "int32", "bool")),
    "ediff1d": (lambda m, x: m.ediff1d(x), lambda x: np.ediff1d(x), True,
                ("float64", "float32", "int32", "empty")),
    "gradient_1d": (lambda m, x: m.gradient(x[0]),
                    lambda x: np.gradient(x[0]), True,
                    ("float64", "float32", "int32")),
    "gradient_1d_spacing": (lambda m, x: m.gradient(x[0], 0.3),
                            lambda x: np.gradient(x[0], 0.3), True,
                            ("float64", "float32")),
    "gradient_1d_coords": (lambda m, x: m.gradient(x[0], XS),
                           lambda x: np.gradient(x[0], XS), True,
                           ("float64", "float32", "int32")),
    "gradient_1d_edge2": (lambda m, x: m.gradient(x[0], XS, edge_order=2),
                          lambda x: np.gradient(x[0], XS, edge_order=2), True,
                          ("float64", "float32")),
    "trapezoid": (lambda m, x: m.trapezoid(x), lambda x: np.trapezoid(x),
                  False, ("float64", "float32", "int32")),
    "trapezoid_dx_axis0": (lambda m, x: m.trapezoid(x, dx=0.25, axis=0),
                           lambda x: np.trapezoid(x, dx=0.25, axis=0), False,
                           ("float64", "float32", "int32")),
    "trapezoid_x": (lambda m, x: m.trapezoid(x, XS),
                    lambda x: np.trapezoid(x, XS), False,
                    ("float64", "float32")),
    "trapz": (lambda m, x: m.trapz(x, dx=2.0), lambda x: np.trapezoid(
        x, dx=2.0), False, ("float64", "int32")),
}
# NumPy's dtype where the reference's (jnp's) differs
NUMPY_DTYPE = {"cov", "cov_cols_ddof0", "cov_one_variable", "corrcoef",
               "corrcoef_cols", "average_weights", "average_weights_2d",
               "gradient_1d_coords", "gradient_1d", "trapezoid",
               "trapezoid_dx_axis0", "trapz"}
# the reference's values differ from NumPy's (jnp's nan-aware choices), or
# it fails
# or it fails; its gradient takes no edge_order
REF_SKIP = {("ptp", "special"), ("nanargmax", "bool"), ("nanargmin", "bool"),
            ("diff", "empty"), ("ediff1d", "empty"), ("amax", "bool"),
            ("amin", "bool"), ("gradient_1d_edge2", "float64"),
            ("gradient_1d_edge2", "float32")}


@pytest.mark.parametrize("name, kind", [(n, k) for n in sorted(CASES)
                                        for k in CASES[n][3]])
def test_against_numpy_and_the_reference(name, kind):
  call, np_call, exact, _ = CASES[name]
  x = DATA[kind]
  got = _glom(call(sp, sp.from_numpy(x)))
  with np.errstate(all="ignore"):
    want = np.asarray(np_call(x))
  if name not in ("average", "nanprod"):  # the port's float64 accumulation
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
  _close(got, want, kind, exact)
  if (name, kind) in REF_SKIP:
    return
  r = _glom(call(ref, ref.from_numpy(x)))
  if name not in NUMPY_DTYPE:
    assert got.dtype == r.dtype, (got.dtype, r.dtype)
  _close(got, r, "float32" if name in NUMPY_DTYPE else kind,
         exact and kind != "float32" and name not in NUMPY_DTYPE)


@pytest.mark.parametrize("name", ["cov", "corrcoef", "interp"])
def test_float32_input_gives_numpys_float64_where_the_reference_keeps_float32(
    name):
  x = DATA["float32"]
  calls = {"cov": lambda m, v: m.cov(v), "corrcoef": lambda m, v: m.corrcoef(v),
           "interp": lambda m, v: m.interp(v[0], m.from_numpy(np.sort(v[1])),
                                           m.from_numpy(v[2]))}
  nps = {"cov": np.cov, "corrcoef": np.corrcoef,
         "interp": lambda v: np.interp(v[0], np.sort(v[1]), v[2])}
  got = _glom(calls[name](sp, sp.from_numpy(x)))
  assert got.dtype == np.float64 == nps[name](x).dtype
  r = _glom(calls[name](ref, ref.from_numpy(x)))
  assert r.dtype == np.float32


def test_gradient_of_2d_is_numpys_tuple_where_the_reference_raises():
  x = DATA["float64"]
  got = sp.gradient(sp.from_numpy(x), 0.5, XS)
  want = np.gradient(x, 0.5, XS)
  assert isinstance(got, tuple) and len(got) == 2
  for g, w in zip(got, want):
    np.testing.assert_array_equal(_glom(g), w)
  for axis in (0, 1, (1, 0)):
    gs = sp.gradient(sp.from_numpy(DATA["int32"]), axis=axis, edge_order=2)
    ws = np.gradient(DATA["int32"], axis=axis, edge_order=2)
    for g, w in zip(gs if isinstance(gs, tuple) else (gs,),
                    ws if isinstance(ws, tuple) else (ws,)):
      np.testing.assert_array_equal(_glom(g), w)
  with pytest.raises(AttributeError):
    ref.gradient(ref.from_numpy(x)).glom()


def test_gradient_refuses_what_numpy_refuses():
  with pytest.raises(ValueError, match="too small"):
    sp.gradient(sp.from_numpy(np.ones(2)), edge_order=2)
  with pytest.raises(ValueError, match="greater than 2"):
    sp.gradient(sp.from_numpy(np.ones(5)), edge_order=3)
  with pytest.raises(ValueError, match="must match the length"):
    sp.gradient(sp.from_numpy(np.ones(5)), np.arange(4.0))


@pytest.mark.parametrize("kind", ["float64", "float32", "special"])
@pytest.mark.parametrize("name", ["nanargmax", "nanargmin"])
def test_nanarg_along_an_axis(name, kind):
  x = DATA[kind]
  for axis in (0, 1):
    got = _glom(getattr(sp, name)(sp.from_numpy(x), axis=axis))
    np.testing.assert_array_equal(got, getattr(np, name)(x, axis=axis))


@pytest.mark.parametrize("name", ["nanargmax", "nanargmin"])
def test_nanargmax_of_an_all_nan_slice_gives_minus_one_where_numpy_raises(
    name):
  x = DATA["float64"].copy()
  x[2] = np.nan
  got = _glom(getattr(sp, name)(sp.from_numpy(x), axis=1))
  assert got[2] == -1
  np.testing.assert_array_equal(np.delete(got, 2), getattr(np, name)(
      np.delete(x, 2, axis=0), axis=1))
  with pytest.raises(ValueError):
    getattr(np, name)(x, axis=1)
  all_nan = np.full(4, np.nan)
  assert int(getattr(sp, name)(sp.from_numpy(all_nan)).glom()) == -1
  assert int(getattr(ref, name)(ref.from_numpy(all_nan)).glom()) == -1


XP = np.sort(RNG.uniform(-2, 2, 40))
FP = RNG.standard_normal(40)
XQ = np.concatenate([RNG.uniform(-2.5, 2.5, 200), XP[::7], [XP[0], XP[-1],
                                                            np.nan, -np.inf,
                                                            np.inf]])


@pytest.mark.parametrize("left, right", [(None, None), (-7.0, 3.5)])
@pytest.mark.parametrize("kind", ["float64", "float32", "int32"])
def test_interp(kind, left, right):
  xq = XQ if kind != "int32" else np.round(XQ[np.isfinite(XQ)]).astype(
      np.int32)
  xq = xq.astype(np.float32) if kind == "float32" else xq
  got = _glom(sp.interp(sp.from_numpy(xq), XP, FP, left=left, right=right))
  want = np.interp(xq, XP, FP, left=left, right=right)
  assert got.dtype == want.dtype == np.float64
  np.testing.assert_array_equal(got, want)
  r = _glom(ref.interp(ref.from_numpy(xq), ref.from_numpy(XP),
                       ref.from_numpy(FP), left=left, right=right))
  np.testing.assert_allclose(got, r, rtol=1e-6 if kind == "float32" else
                             1e-12, atol=1e-12)


def test_interp_nan_in_fp_tries_the_other_side():
  xp = np.array([0.0, 1.0, 2.0])
  fp = np.array([np.inf, np.inf, 1.0])
  xq = np.array([0.5, 1.5, 0.0, 2.0])
  np.testing.assert_array_equal(
      _glom(sp.interp(xq, xp, fp)), np.interp(xq, xp, fp))


SIGNALS = {"float64": (RNG.standard_normal(11), RNG.standard_normal(4)),
           "float32": (RNG.standard_normal(11).astype(np.float32),
                       RNG.standard_normal(4).astype(np.float32)),
           "int32": (RNG.integers(-50, 50, 11).astype(np.int32),
                     RNG.integers(-9, 9, 4).astype(np.int32)),
           "bool": (RNG.random(11) < 0.5, RNG.random(4) < 0.5)}


@pytest.mark.parametrize("longer", ["first", "second", "equal"])
@pytest.mark.parametrize("mode", ["full", "same", "valid"])
@pytest.mark.parametrize("kind", sorted(SIGNALS))
@pytest.mark.parametrize("name", ["convolve", "correlate"])
def test_convolve_and_correlate(name, kind, mode, longer):
  a, v = SIGNALS[kind]
  if longer == "second":
    a, v = v, a
  elif longer == "equal":
    v = a[::-1].copy()
  got = _glom(getattr(sp, name)(sp.from_numpy(a), sp.from_numpy(v), mode))
  want = getattr(np, name)(a, v, mode)
  assert got.dtype == want.dtype, (got.dtype, want.dtype)
  _close(got, want, kind)
  if kind in ("float64", "int32") and longer == "first":
    r = _glom(getattr(ref, name)(ref.from_numpy(a), ref.from_numpy(v), mode))
    _close(got, r, kind)


def test_convolve_refuses_empty_and_2d():
  with pytest.raises(ValueError, match="cannot be empty"):
    sp.convolve(sp.from_numpy(np.zeros(0)), sp.from_numpy(np.ones(3)))
  with pytest.raises(ValueError, match="too deep"):
    sp.correlate(sp.from_numpy(np.ones((2, 2))), sp.from_numpy(np.ones(3)))
  with pytest.raises(ValueError, match="mode"):
    sp.convolve(sp.from_numpy(np.ones(3)), sp.from_numpy(np.ones(3)), "half")
