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


@pytest.mark.parametrize("dtype", ["float32", "float16", "float64"])
@pytest.mark.parametrize("shape", [(), (5,)], ids=["0-d", "1-d"])
def test_where_with_a_weak_scalar_keeps_the_arrays_float_dtype(dtype, shape):
  """``where(c, x, 1.0)`` with a float x has x's dtype, as NumPy 2's and the
  reference's: the weak Python float takes the array's dtype.  The port
  gave float64 for a 0-d x (torch promotes a pair of 0-d tensors to the
  wider dtype), which turned a float32 solver's 0-d carry into float64."""
  host = np.full(shape, 2.5, dtype)
  x = sp.from_numpy(host)
  for got, want in ((sp.where(x > 1.0, x, 1.0), np.where(host > 1.0, host, 1.0)),
                    (sp.where(x > 1.0, 1.0, x), np.where(host > 1.0, 1.0, host))):
    assert got.dtype == getattr(torch, dtype)
    assert np.asarray(got.glom()).dtype == want.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(got.glom(), want)
  r = ref.where(ref.from_numpy(host) > 1.0, ref.from_numpy(host), 1.0)
  assert np.asarray(r.glom()).dtype == np.dtype(dtype)


@pytest.mark.parametrize("shape", [(), (4,)], ids=["0-d", "1-d"])
def test_where_with_a_weak_scalar_follows_numpy_across_kinds(shape):
  """An int32 array beside a weak float gives float64 and beside a weak int
  int32; a bool array beside a weak int int64; a float32 array beside a
  weak complex complex64: NumPy 2's result types."""
  for host, scalar in ((np.full(shape, 3, np.int32), 0.5),
                       (np.full(shape, 3, np.int32), 7),
                       (np.full(shape, True), 7),
                       (np.full(shape, 1.5, np.float32), 2j)):
    got = sp.where(sp.from_numpy(host) != 0, sp.from_numpy(host), scalar)
    want = np.where(host != 0, host, scalar)
    assert np.asarray(got.glom()).dtype == want.dtype
    np.testing.assert_array_equal(got.glom(), want)


@pytest.mark.parametrize("op", ["add", "multiply"])
def test_a_weak_int_out_of_an_integer_arrays_range_wraps(op):
  """Pinned: a Python int outside an integer array's range wraps in the
  port, as it does in the reference (JAX casts the weak int to the array's
  dtype); NumPy 2 raises ``OverflowError``.  ``uint8 + 300`` is
  ``(x + 44) % 256`` and an int8 array times 1000 wraps modulo 256."""
  if op == "add":
    host, scalar = np.arange(0, 256, 17, dtype=np.uint8), 300
    want = ((host.astype(np.int64) + 44) % 256).astype(np.uint8)
  else:
    host, scalar = np.array([-128, -3, 0, 5, 100, 127], np.int8), 1000
    want = (host.astype(np.int64) * 1000).astype(np.int8)
  fn = getattr(np, op)
  got = getattr(sp, op)(sp.from_numpy(host), scalar)
  assert got.dtype == getattr(torch, host.dtype.name)
  np.testing.assert_array_equal(got.glom(), want)
  np.testing.assert_array_equal(
      np.asarray(getattr(ref, op)(ref.from_numpy(host), scalar).glom()), want)
  with pytest.raises(OverflowError):
    fn(host, scalar)


@pytest.mark.parametrize("kind", ["SpartanArray", "ndarray", "tensor", "list"])
@pytest.mark.parametrize("name", ["sum", "mean", "max", "var", "any",
                                  "argmax", "nansum", "ptp"])
def test_a_reduction_of_an_array_that_is_not_an_expr_reduces_all_of_it(
    kind, name):
  """``sp.sum(v)`` with ``v`` an evaluated array, a numpy array, a tensor or
  a list reduces all of ``v``, as NumPy's does.  The port took such a ``v``
  for a list of inputs and reduced its first element alone; the reference
  still does (``ref.sum(np.arange(8.0))`` is 0.0)."""
  host = np.array([3.0, -1.0, 7.5, 2.0, 0.0, 4.0], np.float32)
  v = {"SpartanArray": sp.lazify(sp.from_numpy(host)).evaluate(),
       "ndarray": host, "tensor": torch.from_numpy(host),
       "list": host.tolist()}[kind]
  got = np.asarray(getattr(sp, name)(v).glom())
  np.testing.assert_allclose(got, getattr(np, name)(host), rtol=1e-6)
  if name == "sum":
    assert float(ref.sum(host).glom()) == host[0]


def test_a_shared_map_is_computed_once_after_its_inputs_fuse():
  """Map fusion splices a map into its consumer only when it has one.
  The port (as the reference) counted consumers on the DAG before the
  pass, so a shared map rebuilt because its own input fused took a fresh
  id, looked unshared, and was spliced into every consumer: computed once
  a consumer (the reference's XLA merges the copies again; the port ran
  them, most of lsmr's scalar recurrences several times a step).
  Tolerance: exact (the same ops, run once)."""
  from spartan_tpu_torch.expr import optimize as opt
  from spartan_tpu_torch.expr.local import FnCallExpr
  calls = []

  def traced(t):
    if t.device.type != "meta":
      calls.append(1)
    return t * 2.0

  host = np.arange(6.0)
  x = sp.map([sp.from_numpy(host) + 1.0], traced)  # its input fuses into it
  pair = sp.ListExpr([x * 3.0, x + 4.0])
  fused = opt.optimize(pair)
  ops = set()

  def walk(node):
    if isinstance(node, FnCallExpr) and id(node) not in ops:
      ops.add(id(node))
      for d in node.deps:
        walk(d)

  fused.visit(lambda e: walk(e.op) if hasattr(e, "op") else None)
  assert len(ops) == 4  # + 1, traced, * 3, + 4
  y1, y2 = pair.evaluate()
  assert len(calls) == 1
  np.testing.assert_array_equal(y1.glom(), (host + 1.0) * 2.0 * 3.0)
  np.testing.assert_array_equal(y2.glom(), (host + 1.0) * 2.0 + 4.0)


# -- F1: ``//`` differentiates to zero, as JAX's floor_divide ----------------

_F1_EXPRS = {
    "floor_divide": lambda m, x: m.sum(m.floor_divide(x, 0.3) + x),
    "remainder_by_hand": lambda m, x: m.sum(x - 0.3 * (x // 0.3)),
    "product": lambda m, x: m.sum((x // 0.3) * x * x),
}


def _derivative(m, kind, build, host):
  x = m.from_numpy(host)
  e = build(m, x)
  t = np.linspace(-1.0, 1.0, host.size)
  if kind == "grad":
    out = m.grad(e, [x])[0]
  elif kind == "value_and_grad":
    out = m.value_and_grad(e, [x])[1][0]
  elif kind == "jvp":
    out = m.jvp(e, [x], [t])[1]
  elif kind == "hvp":
    out = m.hvp(e, [x], [t])[0]
  else:
    out = m.hessian(e, [x])
  return np.asarray(out.glom())


@pytest.mark.parametrize("kind", ["grad", "value_and_grad", "jvp", "hvp",
                                  "hessian"])
@pytest.mark.parametrize("expr", sorted(_F1_EXPRS))
def test_floor_divide_differentiates_to_zero(expr, kind):
  """F1: ``x // c`` is a step function, and JAX gives it the derivative 0
  in both operands, so the gradient of ``sum(x // 0.3 + x)`` is ones.  The
  port raised ``RuntimeError: derivative for aten::floor_divide is not
  implemented`` from every derivative.  Tolerance: the reference's values
  to 1e-13 (the double-vjp ``jvp`` of the product sums in another order)."""
  host = np.random.default_rng(0).standard_normal(16)
  want = _derivative(ref, kind, _F1_EXPRS[expr], host)
  got = _derivative(sp, kind, _F1_EXPRS[expr], host)
  assert got.shape == want.shape and got.dtype == want.dtype
  np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)
  if expr == "floor_divide" and kind == "grad":
    np.testing.assert_array_equal(got, np.ones(16))


def test_floor_divide_keeps_its_forward_bits():
  """The derivative's fix leaves the quotient as it was: NumPy's bits for
  floats (±inf for a zero divisor) and the zero guard for integers."""
  host = np.random.default_rng(1).standard_normal(64) * 10
  host[:3] = [0.0, -0.0, 7.0]
  got = np.asarray((sp.from_numpy(host) // 0.3).glom())
  np.testing.assert_array_equal(got, host // 0.3)
  with np.errstate(divide="ignore", invalid="ignore"):
    want = host // np.where(np.arange(64) % 5 == 0, 0.0, 1.5)
  got = np.asarray(sp.floor_divide(
      sp.from_numpy(host),
      sp.from_numpy(np.where(np.arange(64) % 5 == 0, 0.0, 1.5))).glom())
  np.testing.assert_array_equal(got, want)
  ints = np.arange(-6, 6)
  got = np.asarray((sp.from_numpy(ints) // sp.from_numpy(ints % 3)).glom())
  np.testing.assert_array_equal(got, np.where(ints % 3 == 0, 0,
                                              ints // np.maximum(ints % 3, 1)))


# -- F2: a Python scalar as the array of a function that is not elementwise --

# process state the sweep must not change: the mesh and the random seed
_STATEFUL = {"initialize", "shutdown", "with_mesh", "set_random_seed"}
# draws: torch's stream is not jax.random's (ROADMAP Watch list), so only
# the shape and dtype are held
_DRAWS = {"rand", "randn", "randint", "permutation", "choice", "sprandn"}
# where the reference has a documented defect or follows JAX, the port is
# held to NumPy:
_NUMPY_HELD = {
    # the reference iterates a non-expr and reduces its first element, or
    # raises on a scalar
    "all", "amax", "amin", "any", "argmax", "argmin", "average",
    "count_nonzero", "max", "mean", "min", "nanmax", "nanmin", "nansum",
    "prod", "ptp", "std", "sum", "var",
    # NumPy 2's float64 rounding of integers (the reference keeps the
    # integer dtype)
    "ceil", "floor", "trunc", "fix",
    # NumPy's integer reciprocal (the reference gives float64)
    "reciprocal",
    # NumPy sorts a 0-d array as the vector it ravels to (the reference
    # raises an AxisError)
    "argsort",
    # the reference's gradient raises; NumPy's gives ()
    "gradient",
    # NumPy 2.0's clip needs a bound (the reference returns its input)
    "clip",
    # NumPy's ndarray(3) is (3,) float64, left uninitialized
    "ndarray",
}


def _exported_functions():
  import inspect

  import spartan_tpu.scipy_linalg as ref_sl
  out = []
  for ns, mine, theirs in (("sp", sp, ref),
                           ("scipy_linalg", sp.scipy_linalg, ref_sl)):
    for name in sorted(set(mine.__all__) & set(theirs.__all__)):
      f = getattr(mine, name)
      if (name in _STATEFUL or not callable(f) or inspect.isclass(f)
          or inspect.ismodule(f)):
        continue
      out.append((ns, name))
  return out


def _host(out):
  if isinstance(out, (tuple, list)):
    return tuple(_host(o) for o in out)
  if hasattr(out, "glom"):
    out = out.glom()
  if isinstance(out, torch.Tensor):
    out = out.cpu().numpy()
  return np.asarray(out)


def _outcome(fn, arg):
  try:
    return _host(fn(arg))
  except Exception as e:  # the outcome compared is the raise itself
    return e


def _hold(got, want, values: bool):
  if isinstance(want, tuple):
    assert isinstance(got, tuple) and len(got) == len(want)
    for g, w in zip(got, want):
      _hold(g, w, values)
    return
  assert not isinstance(got, tuple)
  assert got.shape == want.shape and got.dtype == want.dtype, (got, want)
  if not values:
    return
  if want.dtype.kind in "fc":
    np.testing.assert_allclose(got, want, rtol=5e-16, atol=0)
  else:
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arg", [2.5, 3], ids=["float", "int"])
@pytest.mark.parametrize("ns,name", _exported_functions(),
                         ids=[f"{n}.{m}" for n, m in _exported_functions()])
def test_every_exported_function_takes_a_python_scalar(ns, name, arg):
  """F2: every exported function of ``sp`` and ``sp.scipy_linalg`` called
  with a Python float and with an int gives the reference's outcome (its
  value and dtype, or a raise where it raises), or NumPy's where the
  reference is defective (``_NUMPY_HELD``).  The port handed the raw
  scalar to every emitter, so 27 functions of ``sp`` (``cumsum``,
  ``atleast_1d``, ``median``, ``flip``, …) and ``block_diag``,
  ``issymmetric`` and ``ishermitian`` raised ``AttributeError`` or
  ``TypeError``, and a scalar result came out float32
  (``cholesky_banded(2.5)``, ``abs(2.5)``).  The functions that change
  process state (``initialize``, ``shutdown``, ``with_mesh``,
  ``set_random_seed``) and
  the classes are left out.  Tolerance: 5e-16 relative (the reference's
  XLA ``acosh``, ``cosh``, ``cbrt`` … of a scalar are an ulp from NumPy's,
  which the port's equal), dtypes exact."""
  import spartan_tpu.scipy_linalg as ref_sl
  mine = getattr(sp if ns == "sp" else sp.scipy_linalg, name)
  if ns == "sp" and name in _NUMPY_HELD:
    want = _outcome(getattr(np, name), arg)
  else:
    want = _outcome(getattr(ref if ns == "sp" else ref_sl, name), arg)
  got = _outcome(mine, arg)
  if isinstance(want, Exception):
    assert isinstance(got, Exception), (got, want)
    return
  assert not isinstance(got, Exception), (got, want)
  _hold(got, want, values=name not in _DRAWS and name != "ndarray")


# -- F3: ``sp.special.ndtr`` lost the normal CDF's left tail ------------------

_TAIL = np.concatenate([np.linspace(-37.0, -0.5, 400),
                        np.linspace(-0.8, 0.8, 33), np.linspace(0.5, 8.0, 40)])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_ndtr_keeps_the_left_tail(dtype):
  """F3: ``sp.special.ndtr`` was ``torch.special.ndtr``, which computes
  (1 + erf(x/√2)) / 2 on the CPU and on the card: 2.5e-8 relative at
  x = -6 and 0 below x ≈ -8.3, where the reference (jax's erfc form) and
  scipy are exact to 1e-15.  Now jax's form.  Held to scipy at 1e-13
  relative in float64 (the erfc's own error, down to 1e-300) and to the
  reference at the same bound; float32 to 2e-5 relative above float32's
  smallest normal (x/√2 rounded to float32, amplified x² times by the
  tail's conditioning: about 170 ulps at x = -13).  The old form gave 1.0
  relative there (0 for a value of 1e-38)."""
  import scipy.special as ssp
  x = _TAIL.astype(dtype)
  got = np.asarray(sp.special.ndtr(sp.from_numpy(x)).glom())
  assert got.dtype == dtype
  want = ssp.ndtr(x.astype(np.float64))
  if dtype == np.float64:
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=0)
    theirs = np.asarray(ref.special.ndtr(x).glom())
    np.testing.assert_allclose(got, theirs, rtol=1e-13, atol=0)
    return
  normal = want > np.finfo(np.float32).tiny
  np.testing.assert_allclose(got[normal], want[normal], rtol=2e-5, atol=0)


def test_the_normal_distributions_keep_their_tails():
  """F3 through ``sp.stats``: norm/lognorm/halfnorm/truncnorm's cdf and
  logcdf take the same ndtr; norm.logcdf at -6..-30 sigma within 1e-13
  relative of scipy's."""
  import scipy.stats as sst
  z = np.linspace(-30.0, -6.0, 25)
  np.testing.assert_allclose(np.asarray(sp.stats.norm.cdf(z).glom()),
                             sst.norm.cdf(z), rtol=1e-13, atol=0)
  np.testing.assert_allclose(np.asarray(sp.stats.norm.logcdf(z).glom()),
                             sst.norm.logcdf(z), rtol=1e-13, atol=0)
  np.testing.assert_allclose(np.asarray(sp.stats.norm.sf(-z).glom()),
                             sst.norm.sf(-z), rtol=1e-13, atol=0)
  w = np.exp(z / 4)
  np.testing.assert_allclose(np.asarray(sp.stats.lognorm.cdf(w, 0.5).glom()),
                             sst.lognorm.cdf(w, 0.5), rtol=1e-13, atol=0)
