"""Functional writes (``expr/write.py``) and ``.at`` against the reference
on the same seeded NumPy data, and against NumPy's ``ufunc.at`` where
the port follows NumPy: ``write``, ``assign``, ``ScatterAssignExpr``,
``e.at[...].set/add/multiply/max/min`` with duplicate, negative and
multi-axis indices, boolean masks, the ``same_kind`` casting rule, the
static bounds checks, dropped out-of-bounds expr indices, NaN under
``max``/``min`` (as ``np.maximum.at``), ``__setitem__``'s ``TypeError``,
and an ``.at`` update inside ``make_fori``.

Tolerances: exact, except float64 sums of duplicates (rtol 1e-12: the
same adds in another order).
"""

import numpy as np
import pytest
import torch

import spartan_tpu as ref

import spartan_tpu_torch as sp
from spartan_tpu_torch.expr.write import ScatterAssignExpr


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


def _a(dtype="float64", shape=(8, 6), seed=0):
  rng = np.random.default_rng(seed)
  if dtype == "int32":
    return rng.integers(-20, 20, shape).astype(np.int32)
  return np.round(rng.standard_normal(shape), 3).astype(dtype)


def _close(got, want):
  got, want = np.asarray(got), np.asarray(want)
  assert got.dtype == want.dtype and got.shape == want.shape
  if want.dtype.kind == "f":
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0, equal_nan=True)
  else:
    np.testing.assert_array_equal(got, want)


NP_AT = {"set": None, "add": np.add, "multiply": np.multiply,
         "max": np.maximum, "min": np.minimum}


def _numpy_at(a, idx, v, op):
  out = a.copy()
  if op == "set":
    out[idx] = v
  else:
    NP_AT[op].at(out, idx, v)
  return out


@pytest.mark.parametrize("dtype", ["float64", "float32", "int32"])
@pytest.mark.parametrize("op", sorted(NP_AT))
@pytest.mark.parametrize("index", ["flat-duplicates", "negative",
                                   "expr-index", "pairs", "pairs-duplicates",
                                   "int-and-array", "leading-rows"])
def test_at_updates_match_reference(index, op, dtype):
  a = _a(dtype)
  idx = {"flat-duplicates": np.array([1, 1, 4, 1]),
         "negative": np.array([-1, 0, -8]),
         "expr-index": np.array([2, 5, 2]),
         "pairs": (np.array([0, 3, 7]), np.array([1, 5, 0])),
         "pairs-duplicates": (np.array([2, 2, 2, 6]), np.array([3, 3, 1, 1])),
         "int-and-array": (3, np.array([0, 2, 2])),
         "leading-rows": (np.array([1, 6]),)}[index]
  v = np.array(2, dtype) if dtype == "int32" else np.array(1.5, dtype)
  lift = index == "expr-index"

  def run(mod):
    i = mod.from_numpy(idx) if lift else idx
    return np.asarray(getattr(mod.from_numpy(a).at[i], op)(v).glom())

  got = run(sp)
  if op == "set" and "duplicates" in index:
    pass  # which duplicate a set keeps is unspecified; held to NumPy below
  else:
    _close(got, run(ref))
  np_idx = idx
  _close(got, _numpy_at(a, np_idx, v, op))


def test_at_values_broadcast_per_index():
  a = _a()
  idx = np.array([0, 2, 2])
  vals = np.arange(18.0).reshape(3, 6)
  for op in ("add", "max", "set"):
    got = getattr(sp.from_numpy(a).at[idx], op)(sp.from_numpy(vals)).glom()
    if op != "set":
      want = np.asarray(getattr(ref.from_numpy(a).at[idx], op)(
          ref.from_numpy(vals)).glom())
      _close(got, want)
    out = a.copy()
    if op == "set":
      out[[0, 2]] = vals[[0, 2]]
    else:
      NP_AT[op].at(out, idx, vals)
    _close(got, out)


@pytest.mark.parametrize("op", ["max", "min"])
def test_at_max_min_keep_nan_as_numpy(op):
  a = _a()
  a[5, 2] = np.nan
  idx = np.array([1, 1, 5, 3])
  vals = np.full((4, 6), 0.25)
  vals[0, 4] = np.nan
  got = getattr(sp.from_numpy(a).at[idx], op)(sp.from_numpy(vals)).glom()
  want = a.copy()
  NP_AT[op].at(want, idx, vals)
  _close(got, want)
  assert np.isnan(got[1, 4]) and np.isnan(got[5, 2])


def test_expr_indices_out_of_bounds_drop_their_updates():
  a = _a()
  idx = np.array([1, 8, -9, 100, 2])
  got = sp.from_numpy(a).at[sp.from_numpy(idx)].add(1.0).glom()
  want = np.asarray(ref.from_numpy(a).at[ref.from_numpy(idx)].add(1.0)
                    .glom())
  _close(got, want)
  out = a.copy()
  out[[1, 2]] += 1.0
  _close(got, out)


@pytest.mark.parametrize("bad", [
    lambda x: x.at[np.array([0, 8])].add(1.0),
    lambda x: x.at[[-9]].set(1.0),
    lambda x: x.at[np.array([1]), np.array([6])].add(1.0),
    lambda x: x.at[8, np.array([0])].add(1.0)])
def test_at_static_index_out_of_bounds_raises(bad):
  with pytest.raises(IndexError):
    bad(sp.from_numpy(_a()))
  with pytest.raises(IndexError):
    bad(ref.from_numpy(_a()))


def test_at_casting_rule_is_the_references():
  x = sp.from_numpy(_a("int32"))
  with pytest.raises(TypeError, match="same_kind"):
    x.at[np.array([0])].add(1.5)
  with pytest.raises(TypeError, match="same_kind"):
    ref.from_numpy(_a("int32")).at[np.array([0])].add(1.5)
  # set truncates, as NumPy's assignment does
  got = x.at[np.array([0])].set(1.5).glom()
  want = _a("int32")
  want[0] = 1.5
  _close(got, want)


@pytest.mark.parametrize("op", ["set", "add", "multiply", "max", "min"])
def test_at_boolean_mask_with_a_scalar(op):
  a = _a()
  mask = a > 0.2
  got = getattr(sp.from_numpy(a).at[sp.from_numpy(mask)], op)(0.5).glom()
  want = np.asarray(getattr(ref.from_numpy(a).at[ref.from_numpy(mask)], op)(
      0.5).glom())
  _close(got, want)
  rows = a[:, 0] > 0
  got_rows = getattr(sp.from_numpy(a).at[rows], op)(0.5).glom()
  want_rows = np.asarray(getattr(ref.from_numpy(a).at[rows], op)(0.5).glom())
  _close(got_rows, want_rows)
  with pytest.raises(NotImplementedError, match="scalar values only"):
    getattr(sp.from_numpy(a).at[mask], op)(sp.from_numpy(a))


def test_at_slices_write_a_region():
  a = _a()
  got = sp.from_numpy(a).at[2:5, ::2].add(1.0).glom()
  want = np.asarray(ref.from_numpy(a).at[2:5, ::2].add(1.0).glom())
  _close(got, want)
  out = a.copy()
  out[2:5, ::2] += 1.0
  _close(got, out)


def test_write_and_assign_match_reference():
  a = _a()
  src = np.ones((3, 4))
  for reducer in (None, np.add, np.multiply, np.maximum, np.minimum):
    got = sp.write(sp.from_numpy(a), (slice(2, 5), slice(1, 5)),
                   sp.from_numpy(src), reducer=reducer).glom()
    want = np.asarray(ref.write(ref.from_numpy(a), (slice(2, 5), slice(1, 5)),
                                ref.from_numpy(src), reducer=reducer).glom())
    _close(got, want)
  got = sp.assign(sp.from_numpy(a), (slice(0, 3), slice(0, 4)),
                  sp.from_numpy(src)).glom()
  out = a.copy()
  out[0:3, 0:4] = src
  _close(got, out)
  _close(got, np.asarray(ref.assign(ref.from_numpy(a),
                                    (slice(0, 3), slice(0, 4)),
                                    ref.from_numpy(src)).glom()))


def test_write_with_a_negative_step_region():
  a = _a()
  got = sp.write(sp.from_numpy(a), np.s_[6:1:-2, ::-1], 7.0, np.add).glom()
  want = np.asarray(ref.write(ref.from_numpy(a), np.s_[6:1:-2, ::-1], 7.0,
                              np.add).glom())
  _close(got, want)


def test_writes_leave_their_source_unchanged():
  a = _a()
  x = sp.from_numpy(a).evaluate()
  y = x.at[np.array([0, 1])].set(9.0)
  z = sp.write(x, np.s_[0:2], 5.0)
  y.glom(), z.glom()
  np.testing.assert_array_equal(x.glom(), a)


def test_scatter_assign_expr_is_data_indexed():
  """The index array is a child leaf: two index arrays of one shape share
  the runner and each binds its own values."""
  a = _a()
  for idx in (np.array([0, 0, 3]), np.array([7, 1, 1])):
    got = ScatterAssignExpr(sp.from_numpy(a), idx, 2.0, np.add).glom()
    out = a.copy()
    np.add.at(out, idx, 2.0)
    _close(got, out)


def test_setitem_raises_type_error_with_the_reference_message():
  x = sp.from_numpy(_a())
  with pytest.raises(TypeError, match=r"at\[idx\]"):
    x[0] = 1.0
  with pytest.raises(TypeError, match=r"at\[idx\]"):
    ref.from_numpy(_a())[0] = 1.0


def test_at_update_inside_make_fori():
  a = _a()
  idx = np.array([0, 3, 3])
  run = sp.make_fori(lambda x: x.at[idx].add(1.0) * 0.5, sp.from_numpy(a))
  got = run(4).glom()
  want = a.copy()
  for _ in range(4):
    np.add.at(want, idx, 1.0)
    want = want * 0.5
  _close(got, want)
  ref_got = ref.make_fori(lambda x: x.at[idx].add(1.0) * 0.5,
                          ref.from_numpy(a))(4).glom()
  _close(got, np.asarray(ref_got))
