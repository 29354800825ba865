"""The port's polynomial, histogram, bit-packing and along-an-axis
builtins (``poly`` … ``apply_along_axis``) against NumPy and the
reference.

Inputs come from a NumPy seed.  Tolerances: integer results, histogram
counts and edges, ``vander``, ``polyval`` (Horner's products and sums in
NumPy's order), ``packbits``/``unpackbits`` and ``take_along_axis``
exactly; the polynomial products and divisions at 1e-12 (NumPy's
``convolve`` may fuse a multiply-add); ``polyfit`` at 1e-10 in float64
(NumPy's scaled Vandermonde columns, an SVD solve here too) and 1e-5 from
float32 data; weighted float32 counts at 1e-6.

Pinned (ROADMAP): ``histogram`` returns the counts, as the reference does
(the edges are ``histogram_bin_edges``); ``polydiv``'s remainder keeps
``max(1, len(v) - 1)`` entries, the reference's static bound (NumPy trims
its leading zeros); ``take_along_axis`` counts a negative index from the
end, as NumPy and the reference do; ``apply_along_axis`` runs its
function under ``torch.func.vmap``, and one that vmap cannot run raises
``ValueError`` with vmap's reason.
"""

import warnings

import numpy as np
import pytest
import torch

import spartan_tpu as ref

import spartan_tpu_torch as sp
from spartan_tpu_torch.expr import fio


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


RNG = np.random.default_rng(16)
P64 = RNG.standard_normal(6)
Q64 = RNG.standard_normal(3)
POLYS = {"float64": (P64, Q64),
         "float32": (P64.astype(np.float32), Q64.astype(np.float32)),
         "int32": (RNG.integers(-5, 6, 6).astype(np.int32),
                   RNG.integers(-5, 6, 3).astype(np.int32)),
         "bool": (np.concatenate([[True], RNG.random(5) < 0.5]),
                  np.array([True, False, True]))}
X2 = RNG.standard_normal((3, 4))


def _glom(x):
  return np.asarray(x.glom())


def _close(got, want, tol):
  got, want = np.asarray(got), np.asarray(want)
  assert got.shape == want.shape, (got.shape, want.shape)
  if tol == 0 or want.dtype.kind in "biu":
    np.testing.assert_array_equal(got, want)
  else:
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


# name → (call over m, p, q; NumPy's; tolerance; kinds; reference dtype =
# NumPy's)
CASES = {
    "poly": (lambda m, p, q: m.poly(q), lambda p, q: np.poly(q), 1e-12,
             ("float64", "float32", "int32"), False),
    "poly_square": (lambda m, p, q: m.poly(X2[:3, :3]),
                    lambda p, q: np.poly(X2[:3, :3]), 1e-10, ("float64",),
                    False),
    "polyadd": (lambda m, p, q: m.polyadd(p, q), lambda p, q: np.polyadd(p, q),
                0, ("float64", "float32", "int32", "bool"), True),
    "polyadd_shorter_first": (lambda m, p, q: m.polyadd(q, p),
                              lambda p, q: np.polyadd(q, p), 0,
                              ("float64", "int32"), True),
    "polysub": (lambda m, p, q: m.polysub(q, p), lambda p, q: np.polysub(q, p),
                0, ("float64", "float32", "int32"), True),
    "polymul": (lambda m, p, q: m.polymul(p, q), lambda p, q: np.polymul(p, q),
                1e-6, ("float64", "float32", "int32", "bool"), False),
    "polyder": (lambda m, p, q: m.polyder(p), lambda p, q: np.polyder(p), 0,
                ("float64", "float32", "int32"), False),
    "polyder_3": (lambda m, p, q: m.polyder(p, 3),
                  lambda p, q: np.polyder(p, 3), 0, ("float64", "int32"),
                  False),
    "polyint": (lambda m, p, q: m.polyint(p), lambda p, q: np.polyint(p),
                1e-15, ("float64", "float32", "int32"), False),
    "polyint_2_k": (lambda m, p, q: m.polyint(p, 2, k=[1.5, -2.0]),
                    lambda p, q: np.polyint(p, 2, k=[1.5, -2.0]), 1e-15,
                    ("float64", "int32"), False),
    "polyval": (lambda m, p, q: m.polyval(p, X2), lambda p, q: np.polyval(
        p, X2), 0, ("float64", "float32", "int32"), True),
    "polyval_of_ints": (lambda m, p, q: m.polyval(p, q),
                        lambda p, q: np.polyval(p, q), 0, ("int32",), False),
    "vander": (lambda m, p, q: m.vander(p), lambda p, q: np.vander(p), 0,
               ("float64", "int32", "bool"), False),
    "vander_n_increasing": (lambda m, p, q: m.vander(q, 5, True),
                            lambda p, q: np.vander(q, 5, True), 0,
                            ("float64", "float32", "int32"), False),
}
# the reference fails, or trims (jnp's bool polymul), or takes no list k
REF_SKIP = {("polymul", "bool"), ("polyadd", "bool"), ("vander", "bool"),
            ("poly_square", "float64"), ("polyint_2_k", "float64"),
            ("polyint_2_k", "int32")}


@pytest.mark.parametrize("name, kind", [(n, k) for n in sorted(CASES)
                                        for k in CASES[n][3]])
def test_polynomials_against_numpy_and_the_reference(name, kind):
  call, np_call, tol, _, ref_dtype = CASES[name]
  p, q = POLYS[kind]
  got = _glom(call(sp, sp.from_numpy(p), sp.from_numpy(q)))
  want = np.asarray(np_call(p, q))
  assert got.dtype == want.dtype, (got.dtype, want.dtype)
  _close(got, want, tol)
  if (name, kind) in REF_SKIP:
    return
  r = _glom(call(ref, ref.from_numpy(p), ref.from_numpy(q)))
  if ref_dtype:
    assert r.dtype == got.dtype
  # XLA fuses multiply-adds: an ulp apart from NumPy's order (jnp gives
  # float32 where NumPy gives float64 for integers)
  _close(got, r, 1e-5 if np.float32 in (r.dtype, got.dtype) else 1e-12)


@pytest.mark.parametrize("kind", ["float64", "float32", "int32"])
@pytest.mark.parametrize("divisor", ["q", "linear", "longer"])
def test_polydiv_keeps_the_references_static_remainder(kind, divisor):
  p, q = POLYS[kind]
  d = {"q": q, "linear": q[:2], "longer": np.concatenate([p, q])}[divisor]
  got_q, got_r = sp.polydiv(sp.from_numpy(p), sp.from_numpy(d))
  want_q, want_r = np.polydiv(p, d)
  nr = min(max(1, len(d) - 1), len(p))
  got_q, got_r = _glom(got_q), _glom(got_r)
  assert got_r.shape == (nr,)
  assert got_q.dtype == want_q.dtype and got_r.dtype == want_r.dtype
  np.testing.assert_allclose(got_q, want_q, rtol=1e-12, atol=1e-12)
  # NumPy trims the remainder's leading zeros: pad it back to nr
  full = np.concatenate([np.zeros(max(nr - len(want_r), 0)), want_r])[-nr:]
  np.testing.assert_allclose(got_r, full, rtol=1e-9, atol=1e-9 * max(
      1.0, float(np.abs(p).max())))
  rq, rr = ref.polydiv(ref.from_numpy(p), ref.from_numpy(d))
  np.testing.assert_allclose(got_r, _glom(rr), rtol=1e-5, atol=1e-5)
  np.testing.assert_allclose(got_q, _glom(rq), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ydim", [1, 2])
@pytest.mark.parametrize("kind", ["float64", "float32"])
@pytest.mark.parametrize("deg", [0, 1, 3])
def test_polyfit(deg, kind, ydim):
  x = np.linspace(-1.5, 2.0, 25)
  y = 0.5 * x ** 3 - x + 2.0 + 0.01 * RNG.standard_normal(25)
  if ydim == 2:
    y = np.stack([y, np.cos(x)], axis=1)
  x, y = x.astype(kind), y.astype(kind)
  got = _glom(sp.polyfit(sp.from_numpy(x), sp.from_numpy(y), deg))
  want = np.polyfit(x, y, deg)
  assert got.dtype == want.dtype == np.float64
  np.testing.assert_allclose(got, want, rtol=1e-10 if kind == "float64"
                             else 1e-5, atol=1e-10 if kind == "float64"
                             else 1e-5)
  if ydim == 1:
    r = _glom(ref.polyfit(ref.from_numpy(x), ref.from_numpy(y), deg))
    np.testing.assert_allclose(got, r, rtol=1e-4, atol=1e-4)


def test_polymul_keeps_leading_zeros_as_the_reference_does():
  """NumPy's polymul trims its operands' leading zeros (``poly1d``), a
  length that depends on the data; the port, as the reference, keeps
  them."""
  a, b = np.array([0.0, 1.0, 2.0]), np.array([1.0, -1.0])
  got = _glom(sp.polymul(sp.from_numpy(a), sp.from_numpy(b)))
  np.testing.assert_array_equal(got, np.convolve(a, b))
  np.testing.assert_array_equal(got[1:], np.polymul(a, b))
  np.testing.assert_array_equal(
      got, _glom(ref.polymul(ref.from_numpy(a), ref.from_numpy(b))))


def test_roots_is_a_counted_host_boundary():
  before = fio.counts["host_runs"]
  got = _glom(sp.roots(sp.from_numpy(P64)))
  assert fio.counts["host_runs"] == before + 1
  np.testing.assert_allclose(np.sort_complex(got),
                             np.sort_complex(np.roots(P64)), rtol=1e-12)
  real = _glom(sp.roots(np.array([1.0, -3.0, 2.0])))
  np.testing.assert_array_equal(np.sort(real), [1.0, 2.0])


# -- histograms -------------------------------------------------------------------

H32 = RNG.standard_normal(2000).astype(np.float32)
H32[:4] = [np.nan, np.inf, -np.inf, 4.0]
FINITE = H32[4:]
HIST = {"float32": FINITE, "float64": FINITE.astype(np.float64),
        "int32": RNG.integers(-20, 30, 500).astype(np.int32),
        "bool": RNG.random(300) < 0.3, "constant": np.full(10, 2.5),
        "empty": np.zeros(0)}
HIST_CALLS = {
    "bins_10": dict(), "bins_7_range": dict(bins=7, range=(-1.3, 2.1)),
    "edges": dict(bins=[-3.0, -1.0, 0.0, 0.25, 2.0]),
    "density": dict(bins=9, density=True),
    "weights": dict(bins=6, weights=True),
}


@pytest.mark.parametrize("call", sorted(HIST_CALLS))
@pytest.mark.parametrize("kind", sorted(HIST))
def test_histogram_counts_and_edges(kind, call):
  x = HIST[kind]
  kw = dict(HIST_CALLS[call])
  w = None
  if kw.pop("weights", False):
    w = RNG.random(x.shape[0]).astype(np.float32)
    kw["weights"] = w
  if kind == "empty" and call in ("density",):
    return  # NumPy divides 0 by 0 with a warning: nothing to hold
  with warnings.catch_warnings():
    warnings.simplefilter("ignore", RuntimeWarning)  # bool → uint8
    want, want_edges = np.histogram(x, **kw)
  port_kw = dict(kw, weights=sp.from_numpy(w)) if w is not None else kw
  got = _glom(sp.histogram(sp.from_numpy(x), **port_kw))
  assert got.dtype == want.dtype, (got.dtype, want.dtype)
  _close(got, want, 1e-6 if w is not None else (
      1e-15 if kw.get("density") else 0))
  if w is None:
    edges = _glom(sp.histogram_bin_edges(sp.from_numpy(x), bins=kw.get(
        "bins", 10), range=kw.get("range")))
    assert edges.dtype == want_edges.dtype
    np.testing.assert_array_equal(edges, want_edges)
  if kind in ("float64", "int32") and call in ("bins_10", "bins_7_range",
                                               "density"):
    r = _glom(ref.histogram(ref.from_numpy(x), **kw))
    _close(got, r, 1e-12 if kw.get("density") else 0)


def test_histogram_drops_nan_and_inf_outside_its_range():
  got = _glom(sp.histogram(sp.from_numpy(H32), bins=16, range=(-2.0, 2.0)))
  np.testing.assert_array_equal(got, np.histogram(H32, 16,
                                                  range=(-2.0, 2.0))[0])
  assert got.sum() == np.count_nonzero((H32 >= -2) & (H32 <= 2))


def test_histogram_refuses_a_reversed_range_and_bad_bins():
  with pytest.raises(ValueError, match="max must be larger"):
    sp.histogram(sp.from_numpy(FINITE), range=(1.0, 0.0))
  with pytest.raises(ValueError, match="not finite"):
    sp.histogram(sp.from_numpy(FINITE), range=(0.0, np.inf))
  with pytest.raises(ValueError, match="monotonically"):
    sp.histogram(sp.from_numpy(FINITE), bins=[0.0, 2.0, 1.0])


SAMPLE = RNG.standard_normal((400, 3)).astype(np.float32)


@pytest.mark.parametrize("call", ["bins", "range_density", "weights",
                                  "edges"])
@pytest.mark.parametrize("kind", ["float32", "float64", "int32"])
def test_histogramdd(kind, call):
  s = (SAMPLE if kind == "float32" else SAMPLE.astype(np.float64)
       if kind == "float64" else np.round(SAMPLE * 3).astype(np.int32))
  kw = {"bins": dict(bins=[3, 4, 5]),
        "range_density": dict(bins=4, range=[(-2, 2), None, (-1, 3)],
                              density=True),
        "weights": dict(bins=5, weights=s[:, 0].astype(np.float64)),
        "edges": dict(bins=[[-3, 0, 1, 3], 4, [-1.5, 0.5, 2.5]])}[call]
  want, want_edges = np.histogramdd(s, **kw)
  port_kw = dict(kw)
  if "weights" in kw:
    port_kw["weights"] = sp.from_numpy(kw["weights"])
  got, got_edges = sp.histogramdd(sp.from_numpy(s), **port_kw)
  got = _glom(got)
  assert got.dtype == want.dtype == np.float64
  _close(got, want, 1e-12 if call in ("range_density", "weights") else 0)
  assert len(got_edges) == 3
  for g, w in zip(got_edges, want_edges):
    g = _glom(g)
    assert g.dtype == np.asarray(w).dtype
    np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("bins", [6, (5, 3)])
@pytest.mark.parametrize("kind", ["float64", "float32"])
def test_histogram2d(kind, bins):
  x = RNG.standard_normal(300).astype(kind)
  y = RNG.standard_normal(300).astype(kind)
  counts, xe, ye = sp.histogram2d(sp.from_numpy(x), sp.from_numpy(y), bins)
  want, wxe, wye = np.histogram2d(x, y, bins)
  np.testing.assert_array_equal(_glom(counts), want)
  np.testing.assert_array_equal(_glom(xe), wxe)
  np.testing.assert_array_equal(_glom(ye), wye)
  if kind == "float64":
    rc, rxe, rye = ref.histogram2d(ref.from_numpy(x), ref.from_numpy(y),
                                   bins)
    np.testing.assert_array_equal(_glom(counts), _glom(rc))
    np.testing.assert_allclose(_glom(xe), _glom(rxe), rtol=1e-12)


# -- bits ---------------------------------------------------------------------

BITS = {"bool": RNG.random((3, 13)) < 0.5,
        "int32": RNG.integers(-2, 3, (3, 13)).astype(np.int32),
        "uint8": RNG.integers(0, 3, (3, 13)).astype(np.uint8),
        "empty": np.zeros((0, 5), bool)}


@pytest.mark.parametrize("order", ["big", "little"])
@pytest.mark.parametrize("axis", [None, 0, 1, -1])
@pytest.mark.parametrize("kind", sorted(BITS))
def test_packbits_and_unpackbits(kind, axis, order):
  x = BITS[kind]
  got = _glom(sp.packbits(sp.from_numpy(x), axis=axis, bitorder=order))
  want = np.packbits(x, axis=axis, bitorder=order)
  assert got.dtype == want.dtype == np.uint8
  np.testing.assert_array_equal(got, want)
  counts = [None, -2] + ([3] if kind != "empty" else []) + (
      [50] if axis is None and kind != "empty" else [])
  for count in counts:
    try:
      expected = np.unpackbits(want, axis=axis, count=count, bitorder=order)
    except ValueError:
      with pytest.raises(ValueError, match="-count"):
        sp.unpackbits(sp.from_numpy(want), axis=axis, count=count,
                      bitorder=order)
      continue
    back = _glom(sp.unpackbits(sp.from_numpy(want), axis=axis, count=count,
                               bitorder=order))
    np.testing.assert_array_equal(back, expected)
  if kind != "empty":
    r = _glom(ref.packbits(ref.from_numpy(x), axis=axis, bitorder=order))
    np.testing.assert_array_equal(got, r)


def test_packbits_refuses_floats_and_unpackbits_non_bytes():
  with pytest.raises(TypeError):
    sp.packbits(sp.from_numpy(np.ones(3)))
  with pytest.raises(TypeError):
    sp.unpackbits(sp.from_numpy(np.ones(3, np.int32)))


# -- along an axis -----------------------------------------------------------------

ARR = RNG.standard_normal((4, 6))


@pytest.mark.parametrize("form", ["same_shape", "broadcast", "axis0",
                                  "flat"])
def test_take_along_axis_wraps_negative_indices(form):
  if form == "same_shape":
    idx, axis = RNG.integers(-6, 6, (4, 6)), 1
  elif form == "broadcast":
    idx, axis = RNG.integers(-6, 6, (1, 3)), 1
  elif form == "axis0":
    idx, axis = RNG.integers(-4, 4, (2, 6)), 0
  else:
    idx, axis = RNG.integers(-24, 24, 9), None
  got = _glom(sp.take_along_axis(sp.from_numpy(ARR), sp.from_numpy(idx),
                                 axis))
  want = np.take_along_axis(ARR, idx, axis)
  np.testing.assert_array_equal(got, want)
  r = _glom(ref.take_along_axis(ref.from_numpy(ARR), ref.from_numpy(idx),
                                axis))
  np.testing.assert_array_equal(got, r)


def test_take_along_axis_out_of_bounds_and_argsort_order():
  with pytest.raises(IndexError):
    sp.take_along_axis(sp.from_numpy(ARR), np.array([[7]]), 1)
  order = np.argsort(ARR, axis=1)
  np.testing.assert_array_equal(
      _glom(sp.take_along_axis(sp.from_numpy(ARR), order, 1)),
      np.sort(ARR, axis=1))


FUNCS = {"sum_of_squares": lambda r: (r * r).sum(),
         "first_two_doubled": lambda r: r[:2] * 2,
         "range": lambda r: r.max() - r.min(),
         "outer": lambda r: r[:3, None] * r[None, :2]}


@pytest.mark.parametrize("axis", [0, 1, -1])
@pytest.mark.parametrize("fn", sorted(FUNCS))
def test_apply_along_axis_through_vmap(fn, axis):
  f = FUNCS[fn]
  got = _glom(sp.apply_along_axis(f, axis, sp.from_numpy(ARR)))
  want = np.apply_along_axis(f, axis, ARR)
  np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-14)
  r = _glom(ref.apply_along_axis(f, axis, ref.from_numpy(ARR)))
  np.testing.assert_allclose(got, r, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("fn", ["branch", "item"])
def test_apply_along_axis_raises_what_vmap_cannot_run(fn):
  f = {"branch": lambda r: r if r.sum() > 0 else -r,
       "item": lambda r: r * float(r[0].item())}[fn]
  with pytest.raises(ValueError, match="vmap"):
    sp.apply_along_axis(f, 1, sp.from_numpy(ARR)).glom()
