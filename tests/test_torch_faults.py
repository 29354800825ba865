"""Faults of the port found by running both packages on the same inputs,
each held to the reference where the reference is right and to NumPy where
it has a known defect:

* ``shuffle`` with an index out of range drops that update, on every
  reducer, as JAX's scatter does; the check is per axis.
* ``abs``, ``argmax``/``argmin`` and ``subtract`` with a bool operand
  follow NumPy's types.
* A bool ``dot``/``tensordot`` takes the exact integer route (torch has
  no bool matmul); integer contractions on the CPU stay on torch.matmul.

The reference's all-axis ``max``/``min`` and its shuffle ``maximum``/
``minimum`` lose a NaN on the 8-device mesh of tests/conftest.py, so the
shuffle cases run the reference on a one-device mesh.

Tolerance: exact everywhere (the same scatters, integer arithmetic, and
bool/int results).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spartan_tpu as ref
from spartan_tpu.core import mesh as ref_mesh

import spartan_tpu_torch as sp
from spartan_tpu_torch.expr import dot as D

# the input of the fault as found: index 7 is past the target of 5
VALUES = np.array([1.0, 2.0, np.nan, 4.0, 5.0, -1.0])
INDEX = np.array([0, 1, 1, 2, 7, -1])
# for ``set``, whose winner among updates to one position is unspecified
SET_INDEX = np.array([0, 1, 3, 2, 7, -6])


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


@pytest.fixture
def one_device_reference():
  with ref.with_mesh(ref_mesh.make_mesh(devices=jax.devices()[:1])):
    yield


@pytest.mark.parametrize("reducer", [np.add, np.multiply, np.maximum,
                                     np.minimum, None],
                         ids=["add", "mul", "max", "min", "set"])
def test_shuffle_drops_out_of_range_updates(one_device_reference, reducer):
  index = SET_INDEX if reducer is None else INDEX
  want = np.asarray(ref.shuffle(
      [ref.from_numpy(VALUES), ref.from_numpy(index)],
      lambda v, i, c: ((i,), v), target_shape=(5,), reducer=reducer).glom())
  got = sp.shuffle([sp.from_numpy(VALUES), sp.from_numpy(index)],
                   lambda v, i, c: ((i,), v), target_shape=(5,),
                   reducer=reducer).glom()
  np.testing.assert_array_equal(got, want)
  if reducer is np.add:
    np.testing.assert_array_equal(got, [1.0, np.nan, 4.0, 0.0, -1.0])


@pytest.mark.parametrize("dtype", [np.float64, np.int64], ids=str)
def test_shuffle_drops_per_axis_on_a_2d_target(one_device_reference, dtype):
  """(0, 5) flattens to 5, inside a (3, 4) target, but its column is out
  of range: it is dropped; (2, -9) is out of range after the wrap."""
  vals = np.arange(1, 6).astype(dtype)
  rows, cols = np.array([0, 0, 1, 2, 2]), np.array([5, 1, -1, -9, 3])
  want = np.asarray(ref.shuffle(
      [ref.from_numpy(vals)],
      lambda v, c: ((jnp.asarray(rows), jnp.asarray(cols)), v),
      target_shape=(3, 4), reducer=np.add).glom())
  got = sp.shuffle([sp.from_numpy(vals)],
                   lambda v, c: ((torch.as_tensor(rows),
                                  torch.as_tensor(cols)), v),
                   target_shape=(3, 4), reducer=np.add).glom()
  assert got.dtype == want.dtype == dtype
  np.testing.assert_array_equal(got, want)
  np.testing.assert_array_equal(got, [[0, 2, 0, 0], [0, 0, 0, 3],
                                      [0, 0, 0, 5]])


def test_shuffle_with_every_update_out_of_range(one_device_reference):
  want = np.asarray(ref.shuffle(
      [ref.from_numpy(VALUES)], lambda v, c: ((c[0] + 9,), v),
      target_shape=(5,), reducer=np.multiply, init=1.0).glom())
  got = sp.shuffle([sp.from_numpy(VALUES)], lambda v, c: ((c[0] + 9,), v),
                   target_shape=(5,), reducer=np.multiply, init=1.0).glom()
  np.testing.assert_array_equal(got, want)
  np.testing.assert_array_equal(got, np.ones(5))


BOOLS = np.array([[True, False, True], [False, False, True]])


def test_abs_of_bool_is_bool():
  got = abs(sp.from_numpy(BOOLS)).glom()
  want = np.asarray(abs(ref.from_numpy(BOOLS)).glom())
  assert got.dtype == want.dtype == np.abs(BOOLS).dtype == np.bool_
  np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", ["argmax", "argmin"])
@pytest.mark.parametrize("axis", [None, 0, 1], ids=str)
def test_argmax_and_argmin_of_bool(op, axis):
  got = getattr(sp.from_numpy(BOOLS), op)(axis=axis).glom()
  want = np.asarray(getattr(ref.from_numpy(BOOLS), op)(axis=axis).glom())
  oracle = getattr(np, op)(BOOLS, axis=axis)
  assert np.asarray(got).dtype == want.dtype == np.int64
  np.testing.assert_array_equal(got, want)
  np.testing.assert_array_equal(got, oracle)


@pytest.mark.parametrize("name", ["subtract", "add", "multiply", "maximum"])
def test_bool_against_a_weak_int_is_int64(name):
  got = getattr(sp, name)(sp.from_numpy(BOOLS), 2).glom()
  want = np.asarray(getattr(ref, name)(ref.from_numpy(BOOLS), 2).glom())
  oracle = getattr(np, name)(BOOLS, 2)
  assert got.dtype == want.dtype == oracle.dtype == np.int64
  np.testing.assert_array_equal(got, want)
  np.testing.assert_array_equal(got, oracle)


def test_bool_dot_and_tensordot_take_the_exact_route():
  rng = np.random.default_rng(3)
  a, b = rng.random((6, 9)) < 0.3, rng.random((9, 4)) < 0.3
  D.reset_counts()
  got = sp.dot(sp.from_numpy(a), sp.from_numpy(b)).glom()
  got_t = D.tensordot(sp.from_numpy(a), sp.from_numpy(b), 1).glom()
  assert D.counts["exact_int_route"] == 2
  want = np.asarray(ref.dot(ref.from_numpy(a), ref.from_numpy(b)).glom())
  assert got.dtype == got_t.dtype == want.dtype == np.bool_
  np.testing.assert_array_equal(got, want)
  np.testing.assert_array_equal(got, np.dot(a, b))
  np.testing.assert_array_equal(got_t, np.tensordot(a, b, 1))


@pytest.mark.parametrize("dtype", [np.int32, np.int64], ids=str)
def test_integer_dot_on_the_cpu_stays_on_matmul(dtype):
  rng = np.random.default_rng(4)
  a = rng.integers(-50, 50, (7, 11)).astype(dtype)
  b = rng.integers(-50, 50, (11, 3)).astype(dtype)
  D.reset_counts()
  got = sp.dot(sp.from_numpy(a), sp.from_numpy(b)).glom()
  assert D.counts["exact_int_route"] == 0
  want = np.asarray(ref.dot(ref.from_numpy(a), ref.from_numpy(b)).glom())
  assert got.dtype == want.dtype == dtype
  np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shapes", [((7, 11), (11, 3)), ((11,), (11, 3)),
                                    ((7, 11), (11,)), ((11,), (11,)),
                                    ((2, 7, 11), (11, 3))], ids=str)
@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.uint8], ids=str)
def test_exact_matmul_equals_numpy(shapes, dtype):
  """The card's integer route, run here on CPU tensors: NumPy's result,
  wrapping included (int64 products near 2^62, uint8 sums past 255)."""
  rng = np.random.default_rng(5)
  hi = {np.int32: 1 << 20, np.int64: 1 << 31, np.uint8: 256}[dtype]
  a = rng.integers(0, hi, shapes[0]).astype(dtype)
  b = rng.integers(0, hi, shapes[1]).astype(dtype)
  got = D._exact_matmul(torch.as_tensor(a), torch.as_tensor(b),
                        torch.as_tensor(a).dtype).numpy()
  want = np.matmul(a, b)
  assert got.dtype == want.dtype
  np.testing.assert_array_equal(got, want)


def test_exact_tensordot_equals_numpy():
  rng = np.random.default_rng(6)
  a = rng.integers(-9, 9, (3, 4, 5))
  for b, axes in ((rng.integers(-9, 9, (5, 4, 2)), ([1, 2], [1, 0])),
                  (rng.integers(-9, 9, (5, 8)), 1),
                  (rng.integers(-9, 9, (5, 2)), ([2], [0]))):
    got = D._exact_tensordot(torch.as_tensor(a), torch.as_tensor(b), axes,
                             torch.int64).numpy()
    np.testing.assert_array_equal(got, np.tensordot(a, b, axes))


@pytest.mark.parametrize("scalar", [0.7, 1.0 / 3.0, 1e-3, 3])
@pytest.mark.parametrize("name", ["add", "subtract", "multiply",
                                  "true_divide", "maximum", "minimum"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_weak_scalar_ops_round_like_the_reference(dtype, name, scalar):
  """Two faults of the eager path, where K1's op program was right:
  ``b * 0.7`` on a bfloat16 or float16 array rounds 0.7 to that dtype
  first, as JAX's weak typing does (torch multiplied by 0.7 in float32: 7
  of these 77 bfloat16 products differed in the last bit); and ``0.7 / b``
  divides IEEE-rounded (torch took a reciprocal and a product: an ulp off
  in 26 % of float32 quotients).  The eager path, K1's op program and the
  reference now agree bit for bit."""
  host = np.linspace(-2.0, 3.0, 77).astype(np.float32)
  jx = jnp.asarray(host).astype(dtype)
  tx = sp.from_numpy(host).astype(getattr(torch, dtype))
  jfn, tfn = getattr(jnp, name), getattr(sp, name)
  for args_j, args_t in (((jx, scalar), (tx, scalar)),
                         ((scalar, jx), (scalar, tx))):
    want = np.asarray(jfn(*args_j).astype(jnp.float32))
    got = tfn(*args_t).astype(torch.float32).glom()
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("scalar", [1 + 2j, -0.5j])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_complex_scalar_divides_a_real_array(dtype, scalar):
  """A complex Python scalar over a real array, and the array over it, give
  a complex result as in the reference: the IEEE-rounded scalar / tensor
  division takes only a real scalar.  Tolerance: 4 ulp of the complex
  dtype (the two complex divisions may round differently)."""
  host = np.linspace(0.25, 3.0, 41).astype(dtype)
  jx, tx = jnp.asarray(host), sp.from_numpy(host)
  for args_j, args_t in (((scalar, jx), (scalar, tx)),
                         ((jx, scalar), (tx, scalar))):
    want = np.asarray(jnp.true_divide(*args_j))
    got = np.asarray(sp.true_divide(*args_t).glom())
    assert got.dtype == want.dtype and np.iscomplexobj(got)
    eps = np.finfo(want.dtype).eps
    np.testing.assert_allclose(got, want, rtol=4 * eps, atol=0)
