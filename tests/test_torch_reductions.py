"""The reductions of the core expression surface against the reference
on the same seeded NumPy data: ``prod``, ``var`` and ``std`` (with
``ddof``), ``all``, ``any``, ``count_nonzero``, ``nansum``, ``nanmax``,
``nanmin``, ``nanmean``, ``nanvar``, ``nanstd``, ``CustomReduceExpr``
through ``reduce(local_reduce_fn=...)``, and the shape methods that
reduce or reorder (``squeeze``, ``swapaxes``, ``repeat``, ``diagonal``,
``trace``, ``outer``, ``copy``, ``conj``).

Tolerances: float64 to rtol 1e-10 (the same sums in another order);
float32 input accumulates in float64, as the reference's does, so it is
held there too; exact for integer and bool results.  The reference's
all-axis ``nanmax``/``nanmin`` of an all-NaN array on its 8-device mesh
is not compared (ROADMAP: its mesh drops NaN); NumPy is.
"""

import numpy as np
import pytest
import torch

import spartan_tpu as ref

import spartan_tpu_torch as sp
from spartan_tpu_torch.expr.reduce import CustomReduceExpr


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


def _a(dtype="float64", shape=(6, 5, 4), seed=0, nan=False):
  rng = np.random.default_rng(seed)
  if dtype == "bool":
    return rng.random(shape) < 0.7
  if dtype in ("int8", "int32", "uint8"):
    lo = 0 if dtype == "uint8" else -3
    return rng.integers(lo, 4, shape).astype(dtype)
  out = rng.uniform(0.5, 1.5, shape).astype(dtype)
  if nan:
    out[rng.random(shape) < 0.15] = np.nan
  return out


def _close(got, want):
  got, want = np.asarray(got), np.asarray(want)
  assert got.shape == want.shape, (got.shape, want.shape)
  assert got.dtype == want.dtype, (got.dtype, want.dtype)
  if want.dtype.kind in "fc":
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=0, equal_nan=True)
  else:
    np.testing.assert_array_equal(got, want)


AXES = [None, 0, 1, -1, (0, 2)]
DTYPES = ["bool", "int8", "int32", "float32", "float64"]


def _axis_id(axis):
  return "all" if axis is None else str(axis)


@pytest.mark.parametrize("axis", AXES, ids=_axis_id)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", ["prod", "all", "any", "count_nonzero"])
def test_reductions_match_reference(op, dtype, axis):
  a = _a(dtype)
  got = getattr(sp, op)(sp.from_numpy(a), axis=axis).glom()
  want = np.asarray(getattr(ref, op)(ref.from_numpy(a), axis=axis).glom())
  if op == "count_nonzero":
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.count_nonzero(a, axis=axis))
    return
  _close(got, want)


@pytest.mark.parametrize("ddof", [0, 1, 2])
@pytest.mark.parametrize("axis", AXES, ids=_axis_id)
@pytest.mark.parametrize("dtype", ["int32", "float32", "float64"])
@pytest.mark.parametrize("op", ["var", "std"])
def test_var_and_std_match_reference(op, dtype, axis, ddof):
  a = _a(dtype)
  got = getattr(sp, op)(sp.from_numpy(a), axis=axis, ddof=ddof).glom()
  want = np.asarray(getattr(ref, op)(ref.from_numpy(a), axis=axis,
                                     ddof=ddof).glom())
  _close(got, want)
  _close(got, getattr(np, op)(a.astype(np.float64), axis=axis, ddof=ddof))
  _close(getattr(sp.from_numpy(a), op)(axis=axis, ddof=ddof).glom(), got)


@pytest.mark.parametrize("keepdims", [False, True])
def test_prod_methods_and_keepdims(keepdims):
  a = _a()
  got = sp.from_numpy(a).prod(axis=(0, 2), keepdims=keepdims).glom()
  want = np.asarray(ref.from_numpy(a).prod(axis=(0, 2),
                                           keepdims=keepdims).glom())
  _close(got, want)
  _close(got, np.prod(a, axis=(0, 2), keepdims=keepdims))


@pytest.mark.parametrize("axis", AXES, ids=_axis_id)
@pytest.mark.parametrize("op", ["nansum", "nanmax", "nanmin", "nanmean",
                                "nanvar", "nanstd"])
def test_nan_reductions_match_reference(op, axis):
  a = _a(nan=True)
  got = getattr(sp, op)(sp.from_numpy(a), axis=axis).glom()
  want = np.asarray(getattr(ref, op)(ref.from_numpy(a), axis=axis).glom())
  _close(got, want)
  _close(got, getattr(np, op)(a, axis=axis))


def test_nan_reductions_on_all_nan_slices_follow_numpy():
  a = _a(nan=True)
  a[2] = np.nan
  with np.errstate(invalid="ignore"), pytest.warns(RuntimeWarning):
    for op in ("nanmax", "nanmin"):
      _close(getattr(sp, op)(sp.from_numpy(a), axis=(1, 2)).glom(),
             getattr(np, op)(a, axis=(1, 2)))
  full = np.full((3, 3), np.nan)
  assert np.isnan(float(sp.nanmax(sp.from_numpy(full)).glom()))
  assert float(sp.nansum(sp.from_numpy(full)).glom()) == 0.0


def test_nanvar_with_ddof_and_int_nansum():
  a = _a(nan=True)
  got = sp.nanvar(sp.from_numpy(a), axis=1, ddof=1).glom()
  _close(got, np.asarray(ref.nanvar(ref.from_numpy(a), axis=1, ddof=1)
                         .glom()))
  _close(got, np.nanvar(a, axis=1, ddof=1))
  _close(sp.nanstd(sp.from_numpy(a), ddof=1).glom(), np.nanstd(a, ddof=1))
  i = _a("int32")
  _close(sp.nansum(sp.from_numpy(i), axis=0).glom(), np.nansum(i, axis=0))
  _close(sp.nanmax(sp.from_numpy(i)).glom(), np.nanmax(i))


def test_methods_all_and_any():
  a = _a("int32")
  _close(sp.from_numpy(a).all(axis=1).glom(), a.all(axis=1))
  _close(sp.from_numpy(a).any().glom(), a.any())
  nan = np.array([0.0, np.nan])
  _close(sp.any(sp.from_numpy(nan)).glom(), np.any(nan))
  _close(sp.all(sp.from_numpy(nan)).glom(), np.all(nan))


def test_custom_reduce_reference_form():
  a = _a(shape=(16, 8))
  out = sp.reduce(sp.from_numpy(a), axis=0,
                  local_reduce_fn=lambda v, axis: torch.log(
                      torch.sum(torch.exp(v), dim=axis)),
                  accumulate_fn=lambda p, q: torch.logaddexp(p, q))
  assert isinstance(out, CustomReduceExpr)
  import jax.numpy as jnp
  want = np.asarray(ref.reduce(
      ref.from_numpy(a), axis=0,
      local_reduce_fn=lambda v, axis: jnp.log(jnp.sum(jnp.exp(v), axis=axis)),
      accumulate_fn=lambda p, q: jnp.logaddexp(p, q)).glom())
  _close(out.glom(), want)
  _close(out.glom(), np.log(np.exp(a).sum(axis=0)))


def test_custom_reduce_with_fn_kw():
  a = _a(shape=(8, 8))
  out = sp.reduce(sp.from_numpy(a), axis=1,
                  local_reduce_fn=lambda v, axis, q: torch.quantile(
                      v, q, dim=axis), fn_kw={"q": 0.5})
  _close(out.glom(), np.quantile(a, 0.5, axis=1))


def test_named_reduce_rejects_non_string_op():
  with pytest.raises(TypeError):
    sp.reduce(sp.ones((4, 4)), op=123)
  with pytest.raises(ValueError, match="unknown reduction"):
    sp.reduce(sp.ones((4, 4)), op="median")


# -- shape methods -------------------------------------------------------------

def test_squeeze_matches_reference():
  a = _a(shape=(3, 1, 4, 1))
  for axis in (None, 1, -1, (1, 3)):
    got = sp.squeeze(sp.from_numpy(a), axis=axis).glom()
    _close(got, np.asarray(ref.squeeze(ref.from_numpy(a), axis=axis).glom()))
    _close(got, np.squeeze(a, axis=axis))
    _close(sp.from_numpy(a).squeeze(axis=axis).glom(), got)
  with pytest.raises(ValueError, match="size not equal to one"):
    sp.squeeze(sp.from_numpy(a), axis=0)


@pytest.mark.parametrize("axes", [(0, 1), (0, 2), (-1, 1)], ids=str)
def test_swapaxes_matches_reference(axes):
  a = _a()
  got = sp.swapaxes(sp.from_numpy(a), *axes).glom()
  _close(got, np.asarray(ref.swapaxes(ref.from_numpy(a), *axes).glom()))
  _close(sp.from_numpy(a).swapaxes(*axes).glom(), np.swapaxes(a, *axes))


@pytest.mark.parametrize("axis", [None, 0, 1, -1])
def test_repeat_matches_reference(axis):
  a = _a("int32")
  got = sp.repeat(sp.from_numpy(a), 3, axis=axis).glom()
  _close(got, np.asarray(ref.repeat(ref.from_numpy(a), 3, axis=axis).glom()))
  _close(got, np.repeat(a, 3, axis=axis))
  _close(sp.from_numpy(a).repeat(3, axis=axis).glom(), got)


@pytest.mark.parametrize("offset", [0, 1, -2, 7])
def test_diagonal_and_trace_match_reference(offset):
  a = _a(shape=(5, 6))
  got = sp.diagonal(sp.from_numpy(a), offset).glom()
  _close(got, np.asarray(ref.diagonal(ref.from_numpy(a), offset).glom()))
  _close(got, np.diagonal(a, offset))
  t = sp.trace(sp.from_numpy(a), offset).glom()
  _close(t, np.asarray(ref.trace(ref.from_numpy(a), offset).glom()))
  _close(sp.from_numpy(a).trace(offset).glom(), t)
  i = _a("int32", shape=(4, 4))
  _close(sp.from_numpy(i).trace().glom(), np.trace(i))
  a3 = _a(shape=(3, 4, 2))
  _close(sp.from_numpy(a3).diagonal(1).glom(), np.diagonal(a3, 1))


def test_outer_copy_conj_match_reference():
  x, y = _a(shape=(5,)), _a("int32", shape=(7,), seed=1)
  got = sp.outer(sp.from_numpy(x), sp.from_numpy(y)).glom()
  _close(got, np.asarray(ref.outer(ref.from_numpy(x), ref.from_numpy(y))
                         .glom()))
  _close(sp.from_numpy(x).outer(y).glom(), np.outer(x, y))
  a = _a()
  _close(sp.copy(sp.from_numpy(a)).glom(), a)
  _close(sp.from_numpy(a).copy().glom(), a)
  _close(sp.conj(sp.from_numpy(a)).glom(), np.conj(a))
  _close(sp.from_numpy(a).conjugate().glom(), np.conj(a))


def test_reductions_of_a_size_one_expr_convert():
  a = _a()
  assert bool(sp.all(sp.from_numpy(a) > 0))
  assert int(sp.count_nonzero(sp.from_numpy(a) > 1.0)) == int(
      np.count_nonzero(a > 1.0))
