"""The port's selection builtins and the ones whose length depends on the
data (``nonzero`` … ``bincount``), and ``map_with_location``, against the
reference and NumPy.

Every result is held exactly, in NumPy's order.  The data-dependent ones
run on the device as ``SelectExpr`` nodes (counted in
``expr.slice.counts["selection_device"]``), where the reference runs them
on the host.  Pinned on purpose (ROADMAP): ``nonzero`` returns one
stacked ``(ndim, n)`` array as the reference does (NumPy's tuple is its
rows); ``choose`` clips as the reference does; ``bincount`` follows
NumPy's length, ``max(minlength, max + 1)``, where the reference's
``minlength`` gives exactly that many bins; ``unique`` merges NaNs as
NumPy does and the array-API ``unique_*`` keep them apart as NumPy 2's
do; ``map_with_location``'s coordinates are int32, as the reference's.
"""

import numpy as np
import pytest
import torch

import spartan_tpu as ref

import spartan_tpu_torch as sp
from spartan_tpu_torch.expr import slice as slice_mod


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


def _same(got, want):
  got, want = np.asarray(got), np.asarray(want)
  assert got.dtype == want.dtype, (got.dtype, want.dtype)
  assert got.shape == want.shape, (got.shape, want.shape)
  np.testing.assert_array_equal(got, want)


def _glom(x):
  return np.asarray(x.glom())


RNG = np.random.default_rng(0)
F = np.round(RNG.uniform(-3, 3, (6, 7)), 1)
F[1, 2] = F[4, 5] = 0.0
I32 = RNG.integers(-4, 5, (5, 6)).astype(np.int32)
B = RNG.random((4, 5)) < 0.4
DATA = {"float64": F, "float32": F.astype(np.float32), "int32": I32,
        "bool": B, "empty": np.zeros((0, 3)), "scalar": np.array(2.5)}

UNARY_SELECT = {
    "nonzero": lambda x: np.stack(np.nonzero(np.atleast_1d(x))),
    "flatnonzero": np.flatnonzero,
    "argwhere": np.argwhere,
    "unique": np.unique,
    "unique_values": np.unique_values,
    "trim_zeros": None,
}


@pytest.mark.parametrize("data", sorted(DATA))
@pytest.mark.parametrize("name", sorted(n for n in UNARY_SELECT
                                        if n != "trim_zeros"))
def test_unary_selection(name, data):
  x = DATA[data]
  if name.startswith("unique") and data == "scalar":
    x = np.atleast_1d(x)
  before = slice_mod.counts["selection_device"]
  got = _glom(getattr(sp, name)(sp.from_numpy(x)))
  assert slice_mod.counts["selection_device"] == before + 1
  _same(got, UNARY_SELECT[name](x))
  if data in ("empty", "scalar"):
    return
  r = _glom(getattr(ref, name)(ref.from_numpy(x)))
  np.testing.assert_array_equal(got, r)


def test_nonzero_of_a_comparison_feeds_a_region():
  """The stacked indices, a leaf after the eager boundary, index the
  array inside the next region."""
  b = sp.from_numpy(F)
  idx = sp.nonzero(b > 1.0)
  got = _glom(b[idx[0], idx[1]] * 2.0)
  np.testing.assert_array_equal(got, F[F > 1.0] * 2.0)


@pytest.mark.parametrize("trim", ["fb", "f", "b"])
@pytest.mark.parametrize("case", ["both", "none", "all_zero", "empty"])
def test_trim_zeros(case, trim):
  x = {"both": np.array([0, 0, 3, 0, 4, 0]), "none": np.array([1, 0, 2]),
       "all_zero": np.zeros(4, np.int64), "empty": np.zeros(0, np.int64)}[case]
  got = _glom(sp.trim_zeros(sp.from_numpy(x), trim))
  _same(got, np.trim_zeros(x, trim))
  if x.size:
    np.testing.assert_array_equal(
        got, _glom(ref.trim_zeros(ref.from_numpy(x), trim)))


@pytest.mark.parametrize("data", ["float64", "float32", "int32"])
@pytest.mark.parametrize("name", ["extract", "compress"])
def test_masked_selection(name, data):
  x = DATA[data]
  cond = x > 0
  if name == "extract":
    got, want = sp.extract(sp.from_numpy(cond), sp.from_numpy(x)), np.extract(
        cond, x)
    r = ref.extract(ref.from_numpy(cond), ref.from_numpy(x))
    _same(_glom(got), want)
    np.testing.assert_array_equal(_glom(got), _glom(r))
    return
  for axis in (None, 0, 1):
    c = cond.reshape(-1) if axis is None else cond[:, 0] if axis == 0 else (
        cond[0])
    got = _glom(sp.compress(c, sp.from_numpy(x), axis=axis))
    _same(got, np.compress(c, x, axis=axis))
    np.testing.assert_array_equal(
        got, _glom(ref.compress(c, ref.from_numpy(x), axis=axis)))
  short = np.array([True, False, True])
  _same(_glom(sp.compress(short, sp.from_numpy(x), axis=0)),
        np.compress(short, x, axis=0))
  with pytest.raises(IndexError):
    _glom(sp.compress(np.ones(x.shape[0] + 1, bool), sp.from_numpy(x),
                      axis=0))


@pytest.mark.parametrize("dtype", ["float64", "int32"])
def test_choose_clips(dtype):
  choices = [np.arange(12).reshape(3, 4).astype(dtype) * k for k in (1, 2, 3)]
  idx = np.array([[0, 1, 2, 5], [-1, 2, 1, 0], [2, 2, 0, 1]])
  got = _glom(sp.choose(sp.from_numpy(idx), [sp.from_numpy(c)
                                             for c in choices]))
  _same(got, np.choose(idx, choices, mode="clip"))
  r = _glom(ref.choose(ref.from_numpy(idx), [ref.from_numpy(c)
                                             for c in choices]))
  np.testing.assert_array_equal(got, r)
  # a row of choices broadcast against the index
  _same(_glom(sp.choose(sp.from_numpy(idx[:, :1] % 2),
                        [choices[0], choices[1][:1]])),
        np.choose(idx[:, :1] % 2, [choices[0], choices[1][:1]], mode="clip"))


@pytest.mark.parametrize("default", [0, -1.5])
def test_select(default):
  x = F
  conds = [x > 1.0, x < -1.0]
  choices = [x * 2, x.astype(np.float32)]
  got = _glom(sp.select([sp.from_numpy(c) for c in conds],
                        [sp.from_numpy(c) for c in choices], default))
  want = np.select(conds, choices, default)
  _same(got, want)
  r = _glom(ref.select([ref.from_numpy(c) for c in conds],
                       [ref.from_numpy(c) for c in choices], default))
  np.testing.assert_array_equal(got, r)


@pytest.mark.parametrize("shape", [(3, 20), (2, 2), (50,), (0,), (4, 0)])
def test_resize_repeats_the_data(shape):
  got = _glom(sp.resize(sp.from_numpy(F), shape))
  _same(got, np.resize(F, shape))
  if 0 not in shape:
    np.testing.assert_array_equal(got, _glom(ref.resize(ref.from_numpy(F),
                                                         shape)))
  _same(_glom(sp.resize(sp.from_numpy(np.zeros(0)), (2, 3))),
        np.zeros((2, 3)))


NAN_DATA = np.array([3.0, np.nan, 1.0, np.nan, 3.0, -0.0, 0.0, 2.0])


def test_unique_merges_nans_as_numpy():
  got = _glom(sp.unique(sp.from_numpy(NAN_DATA)))
  _same(got, np.unique(NAN_DATA))
  assert np.isnan(got).sum() == 1


@pytest.mark.parametrize("data", ["nan", "float32", "int32", "bool"])
@pytest.mark.parametrize("name", ["unique_counts", "unique_inverse",
                                  "unique_all"])
def test_unique_family(name, data):
  x = NAN_DATA if data == "nan" else DATA[data]
  got = getattr(sp, name)(sp.from_numpy(x))
  want = getattr(np, name)(x)
  assert type(got).__name__ == type(want).__name__
  assert got._fields == want._fields
  for field, g, w in zip(want._fields, got, want):
    w = np.asarray(w)
    _same(_glom(g), w if field == "values" else w.astype(np.int64))
  if data != "nan":  # the reference's np.unique merges NaNs here
    for g, r in zip(got, getattr(ref, name)(ref.from_numpy(x))):
      np.testing.assert_array_equal(_glom(g).reshape(-1),
                                    _glom(r).reshape(-1))


SET_OPS = ["setdiff1d", "union1d", "intersect1d", "setxor1d"]


@pytest.mark.parametrize("case", ["ints", "floats", "nan", "empty", "mixed"])
@pytest.mark.parametrize("name", SET_OPS)
def test_set_operations(name, case):
  a, b = {
      "ints": (np.array([5, 1, 3, 3, 9, 0]), np.array([3, 4, 5, 5, 10])),
      "floats": (F.reshape(-1), np.round(RNG.uniform(-3, 3, 9), 1)),
      "nan": (np.array([3.0, np.nan, 1.0]), np.array([np.nan, 2.0, 3.0])),
      "empty": (np.zeros(0), np.array([1.0, 2.0])),
      "mixed": (np.array([1, 2, 3], np.int32), np.array([2.5, 3.0])),
  }[case]
  got = _glom(getattr(sp, name)(sp.from_numpy(a), sp.from_numpy(b)))
  _same(got, getattr(np, name)(a, b))
  if case not in ("nan", "empty"):
    np.testing.assert_array_equal(
        got, _glom(getattr(ref, name)(ref.from_numpy(a), ref.from_numpy(b))))


@pytest.mark.parametrize("name", ["isin", "in1d"])
def test_membership(name):
  a = I32
  test = np.array([0, 3, -4, 7])
  got = _glom(getattr(sp, name)(sp.from_numpy(a), sp.from_numpy(test)))
  _same(got, getattr(np, name)(a, test))
  np.testing.assert_array_equal(
      got, _glom(getattr(ref, name)(ref.from_numpy(a), ref.from_numpy(test))))
  nan = np.array([np.nan, 1.0])
  _same(_glom(sp.isin(sp.from_numpy(nan), nan)), np.isin(nan, nan))


@pytest.mark.parametrize("weights", [False, True])
@pytest.mark.parametrize("minlength", [None, 3, 20])
def test_bincount_against_numpy(minlength, weights):
  x = np.array([0, 1, 1, 5, 3, 1, 0], np.int32)
  w = np.linspace(0.5, 3.5, x.size)
  kw = {"weights": w} if weights else {}
  got = _glom(sp.bincount(sp.from_numpy(x), minlength=minlength,
                          **({"weights": sp.from_numpy(w)} if weights else {})))
  _same(got, np.bincount(x, minlength=minlength or 0, **kw))
  if minlength and minlength >= x.max() + 1:  # where the reference agrees
    r = _glom(ref.bincount(ref.from_numpy(x), minlength=minlength,
                           weights=ref.from_numpy(w) if weights else None))
    np.testing.assert_allclose(got, r, rtol=1e-12)


def test_bincount_minlength_below_the_largest_value_is_pinned_to_numpy():
  """The reference's ``minlength=m`` is ``jnp.bincount(length=m)``: m bins,
  larger values dropped.  The port gives NumPy's longer result."""
  x = np.array([0, 1, 7, 7], np.int64)
  got = _glom(sp.bincount(sp.from_numpy(x), minlength=3))
  _same(got, np.bincount(x, minlength=3))
  assert got.shape == (8,)
  r = _glom(ref.bincount(ref.from_numpy(x), minlength=3))
  assert r.shape == (3,)
  with pytest.raises(ValueError):
    _glom(sp.bincount(sp.from_numpy(np.array([1, -1]))))


@pytest.mark.parametrize("shape", [(5, 7), (4,), (2, 3, 4)])
def test_map_with_location(shape):
  x = RNG.uniform(-1, 1, shape)

  def fn(v, c):
    return v + c[0] - (c[1] if len(c) > 1 else 0) * 2

  got = sp.map_with_location(sp.from_numpy(x), fn)
  grids = np.indices(shape)
  want = x + grids[0] - (grids[1] if len(shape) > 1 else 0) * 2
  np.testing.assert_array_equal(_glom(got), want)
  np.testing.assert_array_equal(
      _glom(got), _glom(ref.map_with_location(ref.from_numpy(x), fn)))

  def dtypes(v, c):
    assert all(g.dtype == torch.int32 for g in c)
    return v * 0 + c[-1]

  np.testing.assert_array_equal(
      _glom(sp.map_with_location([sp.from_numpy(x)], dtypes)),
      np.broadcast_to(grids[-1], shape).astype(np.float64))
  # in a fused chain, and with keyword options
  chained = sp.map_with_location(sp.from_numpy(x) * 2.0,
                                 lambda v, c, k: v + k * c[0],
                                 fn_kw={"k": 3}).sum()
  np.testing.assert_allclose(float(chained.glom()),
                             (x * 2.0 + 3 * grids[0]).sum(), rtol=1e-12)


def test_not_shapeable_is_exported():
  assert sp.NotShapeable is ref.NotShapeable.__class__ or issubclass(
      sp.NotShapeable, Exception)
  assert "NotShapeable" in sp.__all__
  with pytest.raises(sp.NotShapeable):
    sp.unique(sp.from_numpy(F)).aval()
