"""Indexing (``expr/slice.py``) against the reference on the same seeded
NumPy data: basic and strided slices, integer-array gathers, mixed
tuples, boolean masks (evaluated on the device, counted), boolean parts
in tuples (the host path), ``take`` and the static bounds checks; the
index in the structural signature (two slices never share a runner); a
slice inside ``make_fori``; the evaluator's caches after ``==`` became
elementwise.

Tolerances: exact (a gather copies values; float64 reductions over a
slice to rtol 1e-12, the same sum in another order).
"""

import numpy as np
import pytest
import torch

import spartan_tpu as ref

import spartan_tpu_torch as sp
from spartan_tpu_torch.backend import evaluator
from spartan_tpu_torch.expr import fio
from spartan_tpu_torch.expr import slice as slice_mod


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


def _a(dtype="float64", shape=(16, 20), seed=0):
  rng = np.random.default_rng(seed)
  if dtype == "int32":
    return rng.integers(-50, 50, shape).astype(np.int32)
  if dtype == "bool":
    return rng.random(shape) < 0.5
  return rng.standard_normal(shape).astype(dtype)


def _both(a, idx, lift=False):
  """(port, reference) of ``a[idx]``; with ``lift`` each ndarray part of
  the index goes in as a leaf expr of its own package."""
  def conv(mod, i):
    if not lift:
      return i
    if isinstance(i, tuple):
      return tuple(conv(mod, p) for p in i)
    return mod.from_numpy(i) if isinstance(i, np.ndarray) else i
  got = sp.from_numpy(a)[conv(sp, idx)].glom()
  want = np.asarray(ref.from_numpy(a)[conv(ref, idx)].glom())
  return got, want


BASIC = {
    "rows": np.s_[2:7], "block": np.s_[2:7, 3:9], "cols": np.s_[:, 4:],
    "int": np.s_[3], "negative": np.s_[-2:, -3:], "ellipsis": np.s_[..., 0],
    "strided": np.s_[1::3, ::2], "reversed": np.s_[::-1],
    "reversed-cols": np.s_[:, ::-3], "newaxis": np.s_[None, 2, :],
    "int-and-slice": np.s_[4, 1:-1], "empty": np.s_[5:5],
    "clamped": np.s_[1:99], "np-int": (np.int64(3), slice(None, None, -2)),
    "bool-scalar": np.s_[True], "reversed-window": np.s_[10:2:-2, 7:1:-1],
}


@pytest.mark.parametrize("dtype", ["float64", "float32", "int32", "bool"])
@pytest.mark.parametrize("name", sorted(BASIC))
def test_basic_slices_match_reference(name, dtype):
  a = _a(dtype)
  got, want = _both(a, BASIC[name])
  assert got.dtype == want.dtype and got.shape == want.shape
  np.testing.assert_array_equal(got, want)
  np.testing.assert_array_equal(got, a[BASIC[name]])


FANCY = {
    "rows": np.array([3, 1, 4, 1, 5]), "negative": np.array([0, -1, -16]),
    "2d": np.array([[0, 2], [4, 6]]), "list": [2, 0, 2],
    "int32": np.array([7, 3], np.int32), "uint8": np.array([1, 9], np.uint8),
    "empty": np.array([], np.int64),
}


@pytest.mark.parametrize("lift", [False, True], ids=["host", "expr"])
@pytest.mark.parametrize("name", sorted(FANCY))
def test_fancy_gathers_match_reference(name, lift):
  a = _a()
  idx = FANCY[name]
  if lift and isinstance(idx, list):
    idx = np.asarray(idx)
  got, want = _both(a, idx, lift)
  assert got.shape == want.shape == a[idx].shape
  np.testing.assert_array_equal(got, want)
  np.testing.assert_array_equal(got, a[idx])


MIXED = {
    "pairs": (np.array([0, 3, 5]), np.array([1, 4, 2])),
    "column-of-rows": (np.array([[0], [2], [5]]), 3),
    "rows-window": (np.array([1, 2]), np.s_[2:6]),
    "window-cols": (np.s_[1:4], np.array([0, 19, -1])),
    "broadcast": (np.array([[0], [1]]), np.array([2, 3, 4])),
    "reversed-rows": (np.s_[::-2], np.array([1, 2])),
    "int-and-array": (4, np.array([5, 6, 7])),
}


@pytest.mark.parametrize("lift", [False, True], ids=["host", "expr"])
@pytest.mark.parametrize("name", sorted(MIXED))
def test_mixed_tuples_match_reference(name, lift):
  a = _a()
  idx = MIXED[name]
  got, want = _both(a, idx, lift)
  assert got.shape == want.shape == a[idx].shape
  np.testing.assert_array_equal(got, want)
  np.testing.assert_array_equal(got, a[idx])


def test_multi_index_on_three_axes():
  a = np.arange(120.0).reshape(4, 5, 6)
  for idx in ((np.array([1, 3]), np.s_[:], np.array([0, 5])),
              (Ellipsis, np.array([2, 2, 0])),
              (np.s_[1:], np.array([[0, 1], [2, 3]]), 4)):
    got, want = _both(a, idx)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, a[idx])


@pytest.mark.parametrize("form", ["host-mask", "expr-mask", "lazy-predicate",
                                  "row-mask", "list-mask"])
def test_boolean_masks_evaluate_on_the_device(form):
  a = _a()
  mask = {"host-mask": a > 0, "expr-mask": a > 0.5,
          "lazy-predicate": None, "row-mask": a[:, 0] > 0,
          "list-mask": list(a[:, 1] > 0)}[form]
  before = slice_mod.counts["boolean_mask_device"]
  host_before = fio.counts["host_runs"]
  sa, ra = sp.from_numpy(a), ref.from_numpy(a)
  if form == "lazy-predicate":
    got, want, np_want = sa[sa > 0].glom(), ra[ra > 0].glom(), a[a > 0]
  elif form == "expr-mask":
    got = sa[sp.from_numpy(mask)].glom()
    want, np_want = ra[ref.from_numpy(mask)].glom(), a[mask]
  else:
    got, want, np_want = sa[mask].glom(), ra[mask].glom(), a[np.asarray(mask)]
  np.testing.assert_array_equal(got, np.asarray(want))
  np.testing.assert_array_equal(got, np_want)
  assert slice_mod.counts["boolean_mask_device"] == before + 1
  assert fio.counts["host_runs"] == host_before


def test_a_masked_selection_feeds_a_region():
  a = _a()
  sa = sp.from_numpy(a)
  got = float(((sa[sa > 0] * 2.0) + 1.0).sum().glom())
  np.testing.assert_allclose(got, (a[a > 0] * 2.0 + 1.0).sum(), rtol=1e-12)
  assert repr(sa[sa > 0]).endswith("(shape=<data-dependent>)")


def test_a_mask_of_the_wrong_shape_raises():
  a = _a()
  with pytest.raises(IndexError):
    sp.from_numpy(a)[sp.from_numpy(np.ones(5, bool))].glom()


def test_boolean_part_in_a_tuple_takes_the_host_path():
  a = _a()
  mask = a[:, 0] > 0
  before = fio.counts["host_runs"]
  got = sp.from_numpy(a)[sp.from_numpy(mask), 3].glom()
  want = np.asarray(ref.from_numpy(a)[ref.from_numpy(mask), 3].glom())
  np.testing.assert_array_equal(got, want)
  np.testing.assert_array_equal(got, a[mask, 3])
  assert fio.counts["host_runs"] == before + 1
  x3n = np.arange(120.0).reshape(4, 5, 6)
  m = np.zeros((4, 5), bool)
  m[0, 0] = m[1, 2] = True
  np.testing.assert_array_equal(sp.from_numpy(x3n)[m, np.array([5])].glom(),
                                x3n[m, np.array([5])])


@pytest.mark.parametrize("bad", [
    lambda x: x[:, 99], lambda x: x[4], lambda x: x[-5], lambda x: x[..., 5],
    lambda x: x[0, -6], lambda x: x[np.array([0, 99])], lambda x: x[[0, -9]],
    lambda x: x[np.array([1]), np.array([7])], lambda x: x[np.array([1]), 7]])
def test_static_index_out_of_bounds_raises(bad):
  x = sp.from_numpy(_a(shape=(4, 5)))
  with pytest.raises(IndexError, match="out of bounds"):
    bad(x)
  with pytest.raises(IndexError, match="out of bounds"):
    bad(ref.from_numpy(_a(shape=(4, 5))))


def test_in_bounds_forms_and_expr_indices_clamp():
  x = sp.from_numpy(np.arange(20.0).reshape(4, 5))
  assert x[-4].glom().shape == (5,)
  assert x[..., 4].glom().shape == (4,)
  assert x[None, 2, :].glom().shape == (1, 5)
  assert x[1:99].glom().shape == (3, 5)
  assert x[np.array([1, 2]), np.array([0, 4])].glom().shape == (2,)
  # an index that is an expr is data: clamped as the reference's gather
  idx = np.array([0, 7, -9])
  got = x[sp.from_numpy(idx)].glom()
  want = np.asarray(ref.from_numpy(np.arange(20.0).reshape(4, 5))[
      ref.from_numpy(idx)].glom())
  np.testing.assert_array_equal(got, want)


def test_float_index_array_raises():
  with pytest.raises(IndexError, match="integer"):
    sp.from_numpy(_a())[np.array([1.0, 2.0])]


@pytest.mark.parametrize("axis", [None, 0, 1, -1])
def test_take_matches_reference(axis):
  a = _a()
  idx = np.array([3, 1, -2, 3])
  got = sp.take(sp.from_numpy(a), sp.from_numpy(idx), axis=axis).glom()
  want = np.asarray(ref.take(ref.from_numpy(a), ref.from_numpy(idx),
                             axis=axis).glom())
  np.testing.assert_array_equal(got, want)
  np.testing.assert_array_equal(got, np.take(a, idx, axis=axis))
  np.testing.assert_array_equal(sp.from_numpy(a).take(idx, axis=axis).glom(),
                                got)
  with pytest.raises(IndexError):
    sp.take(sp.from_numpy(a), np.array([400]), axis=axis)


def test_slice_stays_in_its_region():
  a = _a()
  sa = sp.from_numpy(a)
  got = float((sa[2:10, 2:10] * 2.0).sum().glom())
  np.testing.assert_allclose(got, (a[2:10, 2:10] * 2.0).sum(), rtol=1e-12)
  np.testing.assert_allclose(float(sa[1:-1, 1:-1].sum().glom()),
                             a[1:-1, 1:-1].sum(), rtol=1e-12)
  np.testing.assert_allclose(float(sa[::2].mean().glom()), a[::2].mean(),
                             rtol=1e-12)


def test_two_slices_never_share_a_runner():
  a = _a()
  sa = sp.from_numpy(a)
  evaluator.clear_cache()
  compiles = evaluator.stats["compiles"]
  outs = [sa[1:5].glom(), sa[2:6].glom(), sa[1:5, ::2].glom(),
          sa[:, 1:5].glom(), sa[::-1].glom(), sa[np.s_[3]].glom()]
  assert evaluator.stats["compiles"] == compiles + 6
  for got, idx in zip(outs, (np.s_[1:5], np.s_[2:6], np.s_[1:5, ::2],
                             np.s_[:, 1:5], np.s_[::-1], np.s_[3])):
    np.testing.assert_array_equal(got, a[idx])
  # the same slice of another array of that shape reuses its runner
  b = _a(seed=1)
  hits = evaluator.stats["fast_hits"]
  np.testing.assert_array_equal(sp.from_numpy(b)[2:6].glom(), b[2:6])
  assert evaluator.stats["fast_hits"] == hits + 1
  # two index arrays of one shape share a runner and bind their own values
  for idx in (np.array([0, 5, 2]), np.array([7, 7, 1])):
    np.testing.assert_array_equal(sa[idx].glom(), a[idx])


def test_caches_still_hit_with_elementwise_equality():
  """The evaluator keys nodes by expr_id, so exprs that compare
  elementwise (``==``) leave its caches as they were."""
  a = _a()
  sa = sp.from_numpy(a)
  evaluator.clear_cache()
  first = ((sa == 0.5) | (sa != sa)).sum()
  want = int(((a == 0.5) | (a != a)).sum())
  assert int(first.glom()) == want
  compiles, hits = evaluator.stats["compiles"], evaluator.stats["fast_hits"]
  again = ((sa == 0.5) | (sa != sa)).sum()
  assert int(again.glom()) == want
  assert evaluator.stats["compiles"] == compiles
  assert evaluator.stats["fast_hits"] == hits + 1
  shared = sa * 2.0
  both = sp.ListExpr([shared == 1.0, shared + 1.0, shared])
  outs = both.evaluate()
  np.testing.assert_array_equal(outs[0].glom(), a * 2.0 == 1.0)
  np.testing.assert_array_equal(outs[2].glom(), a * 2.0)


def test_slice_inside_make_fori():
  a = _a(shape=(8, 8))
  run = sp.make_fori(lambda x: sp.write(x, np.s_[1:-1, 1:-1],
                                        x[:-2, 1:-1] * 0.5 + x[2:, 1:-1] * 0.5),
                     sp.from_numpy(a))
  got = run(3).glom()
  want = a.copy()
  for _ in range(3):
    want[1:-1, 1:-1] = want[:-2, 1:-1] * 0.5 + want[2:, 1:-1] * 0.5
  np.testing.assert_allclose(got, want, rtol=1e-12)
  ref_run = ref.make_fori(
      lambda x: ref.write(x, np.s_[1:-1, 1:-1],
                          x[:-2, 1:-1] * 0.5 + x[2:, 1:-1] * 0.5),
      ref.from_numpy(a))
  np.testing.assert_allclose(got, np.asarray(ref_run(3).glom()), rtol=1e-12)
