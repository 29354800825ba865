"""The port's contractions and linear-algebra helpers (``matmul`` …
``norm``) against the reference and NumPy, ``einsum``'s routing, and
``norm``'s chains on K1.

Inputs come from a NumPy seed; the reference runs on its 8-device CPU mesh
(``tests/conftest.py``), the port with ``--device=cpu``.  Dtypes are the
reference's (a contraction or a sum accumulates float32 in float64, as
``dot`` does), values NumPy's and the reference's.  Tolerances:
integer and bool results, ``diag``/``diagflat``/``tril``/``triu``/
``fill_diagonal`` and ``kron`` exactly; float64 contractions at 1e-10
(sums in another order); float32 ones at 1e-5 of the largest value (a
float32 sum of at most 7 terms).  Pinned (ROADMAP): ``norm`` is the
reference's flat norm (``norm(x, 2)`` of a matrix is its Frobenius norm,
NumPy's spectral norm is ``linalg.norm``'s); ``tril``/``triu`` of a 1-D
array follow NumPy where the reference raises; the generic ``einsum`` map
takes the exact integer route for integers on the card and bool
anywhere (``_exact_einsum``, held here against ``np.einsum``).

K1: ``norm(v)``, ``norm(v, 1)`` and ``norm(v, 3)`` of a float32 and a
bfloat16 main plan onto K1 (``plan`` gives a program, ``routed_plain``
unmoved), and K1's plain version of each chain is held to the reference's
``fused_sum(..., interpret=True)`` at ``tests/test_torch_builtins_ops.py``'s
tolerances, against the sum of ``|values|``: 1e-12 for the correctly
rounded chains (``|v|``, ``|v|**2``), 1e-6 for ``|v|**3`` (``powf``
differs by an ulp), 2^-8 for a bfloat16 main.
"""

import warnings

import numpy as np
import pytest
import torch

import spartan_tpu as ref

import spartan_tpu_torch as sp
from spartan_tpu_torch.backend.kernels import fused_reduce as K
from spartan_tpu_torch.expr import builtins as B
from spartan_tpu_torch.expr import dot as dot_mod
from spartan_tpu_torch.expr.dot import TensorDotExpr
from spartan_tpu_torch.expr.map import MapExpr
from spartan_tpu_torch.expr.reduce import ReduceExpr
from spartan_tpu_torch.expr.reshape import TransposeExpr


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


RNG = np.random.default_rng(14)
F64 = RNG.standard_normal((5, 6))
G64 = RNG.standard_normal((6, 4))
V64 = RNG.standard_normal(6)
I32 = RNG.integers(-5, 6, (5, 6)).astype(np.int32)
J32 = RNG.integers(-5, 6, (6, 4)).astype(np.int32)
BOOL = RNG.random((5, 6)) < 0.5
BOOL2 = RNG.random((6, 4)) < 0.5
DATA = {
    "float64": (F64, G64), "float32": (F64.astype(np.float32),
                                       G64.astype(np.float32)),
    "int32": (I32, J32), "bool": (BOOL, BOOL2)}


def _glom(x):
  return np.asarray(x.glom())


def _close(got, want, dtype, exact=False):
  got, want = np.asarray(got), np.asarray(want)
  assert got.shape == want.shape, (got.shape, want.shape)
  if exact or want.dtype.kind in "biu":
    np.testing.assert_array_equal(got, want)
  elif dtype == "float32":
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
  else:
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


# name → (call over a module m and operands a (5x6), b (6x4), NumPy's call,
# exact, dtypes); the reference is called the same way
CASES = {
    "matmul": (lambda m, a, b: m.matmul(a, b), lambda a, b: a @ b, False,
               ("float64", "float32", "int32")),
    "tensordot": (lambda m, a, b: m.tensordot(a, b, axes=1),
                  lambda a, b: np.tensordot(a, b, axes=1), False,
                  ("float64", "float32", "int32")),
    "tensordot_lists": (lambda m, a, b: m.tensordot(a, b.T, axes=([1], [1])),
                        lambda a, b: np.tensordot(a, b.T, axes=([1], [1])),
                        False, ("float64", "int32")),
    "einsum_pair": (lambda m, a, b: m.einsum("ij,jk->ki", a, b),
                    lambda a, b: np.einsum("ij,jk->ki", a, b), False,
                    ("float64", "float32", "int32")),
    "einsum_implicit": (lambda m, a, b: m.einsum("ij,jk", a, b),
                        lambda a, b: np.einsum("ij,jk", a, b), False,
                        ("float64", "int32")),
    "inner": (lambda m, a, b: m.inner(a, b.T),
              lambda a, b: np.inner(a, b.T), False,
              ("float64", "float32", "int32", "bool")),
    "vdot": (lambda m, a, b: m.vdot(a, a), lambda a, b: np.vdot(a, a), False,
             ("float64", "int32")),
    "vecdot": (lambda m, a, b: m.vecdot(a, a[0]),
               lambda a, b: np.vecdot(a, a[0]), False,
               ("float64", "float32", "int32", "bool")),
    "vecdot_axis0": (lambda m, a, b: m.vecdot(a, a, axis=0),
                     lambda a, b: np.vecdot(a, a, axis=0), False,
                     ("float64", "int32")),
    "kron": (lambda m, a, b: m.kron(a[:2, :3], b[:3, :2]),
             lambda a, b: np.kron(a[:2, :3], b[:3, :2]), True,
             ("float64", "float32", "int32", "bool")),
    "kron_1d_2d": (lambda m, a, b: m.kron(a[0], b[:2, :2]),
                   lambda a, b: np.kron(a[0], b[:2, :2]), True,
                   ("float64", "int32")),
    "cross3": (lambda m, a, b: m.cross(a[:, :3], b[:5, 1:]),
               lambda a, b: np.cross(a[:, :3], b[:5, 1:]), False,
               ("float64", "float32", "int32")),
    "cross_axis0": (lambda m, a, b: m.cross(a[:3, :4], b[:3], axis=0),
                    lambda a, b: np.cross(a[:3, :4], b[:3], axis=0), False,
                    ("float64", "int32")),
    "cross2": (lambda m, a, b: m.cross(a[:, :2], b[:5, :2]),
               lambda a, b: np.cross(a[:, :2], b[:5, :2]), False,
               ("float64", "int32")),
    "cross2_3": (lambda m, a, b: m.cross(a[:, :2], b[:5, 1:]),
                 lambda a, b: np.cross(a[:, :2], b[:5, 1:]), False,
                 ("float64", "int32")),
    "diag_2d": (lambda m, a, b: m.diag(a, -1), lambda a, b: np.diag(a, -1),
                True, ("float64", "float32", "int32", "bool")),
    "diag_1d": (lambda m, a, b: m.diag(a[0], 2),
                lambda a, b: np.diag(a[0], 2), True,
                ("float64", "int32", "bool")),
    "diagflat": (lambda m, a, b: m.diagflat(a[:2, :2], 1),
                 lambda a, b: np.diagflat(a[:2, :2], 1), True,
                 ("float64", "int32", "bool")),
    "tril": (lambda m, a, b: m.tril(a, 1), lambda a, b: np.tril(a, 1), True,
             ("float64", "float32", "int32", "bool")),
    "triu": (lambda m, a, b: m.triu(a, -2), lambda a, b: np.triu(a, -2),
             True, ("float64", "float32", "int32", "bool")),
    "norm": (lambda m, a, b: m.norm(a), lambda a, b: np.sqrt(
        (np.abs(a.astype(np.float64)) ** 2).sum()), False,
             ("float64", "float32")),
    "norm_1": (lambda m, a, b: m.norm(a, 1),
               lambda a, b: np.abs(a.astype(np.float64)).sum(), False,
               ("float64", "float32")),
    "norm_3": (lambda m, a, b: m.norm(a, 3),
               lambda a, b: (np.abs(a.astype(np.float64)) ** 3).sum()
               ** (1 / 3), False, ("float64", "float32")),
    "norm_inf_axis": (lambda m, a, b: m.norm(a, np.inf, axis=1),
                      lambda a, b: np.abs(a).max(axis=1), True,
                      ("float64", "float32")),
}


# where the reference fails and NumPy does not (jax's mul takes no bool)
REF_FAILS = {("kron", "bool")}


@pytest.mark.parametrize("name, dtype", [(n, d) for n in sorted(CASES)
                                         for d in CASES[n][3]])
def test_against_numpy_and_the_reference(name, dtype):
  call, np_call, exact, _ = CASES[name]
  a, b = DATA[dtype]
  got = _glom(call(sp, sp.from_numpy(a), sp.from_numpy(b)))
  with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)  # 2-vector cross
    want = np_call(a, b)
  _close(got, want, dtype, exact)
  if (name, dtype) in REF_FAILS:
    with pytest.raises(TypeError):
      call(ref, ref.from_numpy(a), ref.from_numpy(b)).glom()
    return
  r = _glom(call(ref, ref.from_numpy(a), ref.from_numpy(b)))
  # the reference's dtypes (its float64 accumulation of contractions and
  # sums), the values NumPy's
  assert got.dtype == r.dtype, (got.dtype, r.dtype)
  _close(got, r, dtype, exact and dtype != "float32")


def test_fill_diagonal_is_functional_cycles_val_and_stops_at_the_square():
  tall = np.zeros((7, 3))
  got = sp.fill_diagonal(sp.from_numpy(tall), sp.from_numpy(
      np.array([1.5, 2.5])))
  want = tall.copy()
  np.fill_diagonal(want, [1.5, 2.5])
  np.testing.assert_array_equal(_glom(got), want)
  assert not tall.any()  # the input is untouched
  wrapped = tall.copy()
  np.fill_diagonal(wrapped, 4.0, wrap=True)
  np.testing.assert_array_equal(
      _glom(sp.fill_diagonal(sp.from_numpy(tall), 4.0, wrap=True)), wrapped)
  cube = np.zeros((3, 3, 3), np.int32)
  np.fill_diagonal(cube, 7)
  np.testing.assert_array_equal(
      _glom(sp.fill_diagonal(sp.from_numpy(np.zeros((3, 3, 3), np.int32)),
                             7)), cube)
  ints = I32.copy()
  np.fill_diagonal(ints, 2.7)  # NumPy truncates toward zero
  np.testing.assert_array_equal(
      _glom(sp.fill_diagonal(sp.from_numpy(I32), 2.7)), ints)
  with pytest.raises(ValueError):
    sp.fill_diagonal(sp.from_numpy(V64), 1.0)


@pytest.mark.parametrize("name", ["tril", "triu"])
def test_tril_triu_of_1d_follow_numpy_where_the_reference_raises(name):
  got = _glom(getattr(sp, name)(sp.from_numpy(V64), 1))
  want = getattr(np, name)(V64, 1)
  assert got.shape == (6, 6)
  np.testing.assert_array_equal(got, want)
  with pytest.raises(Exception):
    _glom(getattr(ref, name)(ref.from_numpy(V64), 1))


def test_norm_of_a_matrix_is_the_flat_two_norm_not_numpys_spectral_norm():
  x = np.array([[3.0, 0.0], [0.0, 4.0]])
  got = float(sp.norm(sp.from_numpy(x), 2).glom())
  assert got == pytest.approx(np.sqrt((x * x).sum()), rel=1e-15)
  assert got == pytest.approx(float(ref.norm(ref.from_numpy(x), 2).glom()),
                              rel=1e-15)
  assert got == 5.0 and np.linalg.norm(x, 2) == 4.0  # NumPy's: spectral


# -- einsum's routing -----------------------------------------------------------

def _nodes(e):
  out = []
  e.visit(out.append)
  return out


@pytest.mark.parametrize("subs", ["ij,jk->ik", "ij,jk->ki", "ij,kj->ik",
                                  "i,j->ij", "ij,j->i"])
def test_a_two_operand_contraction_is_a_tensordot_node(subs):
  ins = subs.split("->")[0].split(",")
  shapes = {"i": 5, "j": 6, "k": 4}
  ops = [RNG.standard_normal([shapes[c] for c in t]) for t in ins]
  e = sp.einsum(subs, *[sp.from_numpy(o) for o in ops])
  root = e.inputs[0] if isinstance(e, TransposeExpr) else e
  assert isinstance(root, TensorDotExpr)
  want = np.einsum(subs, *ops)
  np.testing.assert_allclose(_glom(e), want, rtol=1e-10, atol=1e-12)
  np.testing.assert_allclose(
      _glom(e), _glom(ref.einsum(subs, *[ref.from_numpy(o) for o in ops])),
      rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("subs, shapes", [
    ("ij,jk,kl->il", [(5, 6), (6, 4), (4, 3)]),
    ("ij,jk,kl,lm->im", [(5, 60), (60, 2), (2, 40), (40, 3)]),
    ("ab,bc,ca->", [(4, 5), (5, 6), (6, 4)]),
])
def test_chains_go_pairwise_in_numpys_einsum_path_order(subs, shapes):
  ops = [RNG.standard_normal(s) for s in shapes]
  e = sp.einsum(subs, *[sp.from_numpy(o) for o in ops])
  dots = [n for n in _nodes(e) if isinstance(n, TensorDotExpr)]
  assert len(dots) == len(ops) - 1
  assert not any(isinstance(n, MapExpr) for n in _nodes(e))
  path = np.einsum_path(subs, *ops, optimize="greedy")[0]
  assert sp.einsum_path(subs, *[sp.from_numpy(o) for o in ops])[0] == path
  # the first pair contracted (the innermost dot) is the path's first step
  first, step = dots[0], path[1]
  assert sorted(first.inputs[0].shape + first.inputs[1].shape) == sorted(
      tuple(ops[step[0]].shape) + tuple(ops[step[1]].shape))
  want = np.einsum(subs, *ops)
  np.testing.assert_allclose(_glom(e), want, rtol=1e-10, atol=1e-10)
  np.testing.assert_allclose(
      _glom(e), _glom(ref.einsum(subs, *[ref.from_numpy(o) for o in ops])),
      rtol=1e-10, atol=1e-10)


GENERIC = {
    "batch": ("bij,bjk->bik", [(3, 4, 5), (3, 5, 2)]),
    "diagonal": ("ii->i", [(5, 5)]),
    "trace": ("ii", [(5, 5)]),
    "diag_pair": ("iij,jk->ik", [(4, 4, 3), (3, 2)]),
    "ellipsis": ("...j,jk->...k", [(2, 3, 4), (4, 5)]),
    "elementwise": ("ij,ij->ij", [(3, 4), (3, 4)]),
    "sum_free": ("ij,jk->i", [(3, 4), (4, 5)]),
}


@pytest.mark.parametrize("dtype", ["float64", "float32", "int32", "bool"])
@pytest.mark.parametrize("form", sorted(GENERIC))
def test_batch_and_diagonal_forms_are_one_generic_map(form, dtype):
  subs, shapes = GENERIC[form]
  if dtype == "bool":
    ops = [RNG.random(s) < 0.5 for s in shapes]
  elif dtype == "int32":
    ops = [RNG.integers(-4, 5, s).astype(np.int32) for s in shapes]
  else:
    ops = [RNG.standard_normal(s).astype(dtype) for s in shapes]
  before = dot_mod.counts["exact_int_route"]
  e = sp.einsum(subs, *[sp.from_numpy(o) for o in ops])
  assert isinstance(e, MapExpr)
  got = _glom(e)
  want = np.einsum(subs, *ops)
  assert got.dtype == want.dtype, (got.dtype, want.dtype)
  _close(got, want, dtype)
  if dtype == "bool":  # torch has no bool matmul: the exact route, counted
    assert dot_mod.counts["exact_int_route"] == before + 1
  if dtype in ("float64", "int32"):
    r = _glom(ref.einsum(subs, *[ref.from_numpy(o) for o in ops]))
    _close(got, r, dtype)


@pytest.mark.parametrize("form", sorted(GENERIC))
def test_the_exact_integer_einsum_matches_numpy(form):
  """The route an integer einsum takes on the card, run here directly."""
  subs, shapes = GENERIC[form]
  ops = [RNG.integers(-2 ** 20, 2 ** 20, s).astype(np.int64) for s in shapes]
  got = B._exact_einsum(subs, [torch.from_numpy(o) for o in ops],
                        torch.int64)
  np.testing.assert_array_equal(got.numpy(), np.einsum(subs, *ops))


@pytest.mark.parametrize("name", ["inner", "einsum_generic", "vecdot"])
def test_int64_contractions_are_exact_past_2_to_the_53(name):
  a = RNG.integers(-2 ** 40, 2 ** 40, (4, 5)).astype(np.int64)
  call = {"inner": (lambda m: m.inner(a, a), lambda: np.inner(a, a)),
          "einsum_generic": (lambda m: m.einsum("ij,ij->i", a, a),
                             lambda: np.einsum("ij,ij->i", a, a)),
          "vecdot": (lambda m: m.vecdot(a, a), lambda: np.vecdot(a, a))}
  port, want = call[name]
  got = _glom(port(sp))
  assert got.dtype == np.int64
  np.testing.assert_array_equal(got, want())


def test_einsum_optimize_false_is_one_map():
  ops = [RNG.standard_normal((3, 4)), RNG.standard_normal((4, 5)),
         RNG.standard_normal((5, 2))]
  e = sp.einsum("ij,jk,kl->il", *[sp.from_numpy(o) for o in ops],
                optimize=False)
  assert isinstance(e, MapExpr)
  np.testing.assert_allclose(_glom(e), np.einsum("ij,jk,kl->il", *ops),
                             rtol=1e-12)


def test_cross_refuses_other_lengths():
  with pytest.raises(ValueError, match="dimension must be 2 or 3"):
    sp.cross(sp.from_numpy(F64), sp.from_numpy(F64))
  with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    assert np.cross([1, 2], [3, 4]) == _glom(sp.cross(np.array([1, 2]),
                                                      np.array([3, 4])))


# -- norm on K1 ------------------------------------------------------------------

def _k1_reduce(e):
  """The ReduceExpr of the optimized expr (its fused local op)."""
  return next(n for n in _nodes(e.optimized()) if isinstance(n, ReduceExpr))


NORM_F = {1: lambda jnp: lambda v: jnp.abs(v),
          2: lambda jnp: lambda v: jnp.abs(v) ** 2,
          3: lambda jnp: lambda v: jnp.abs(v) ** 3}


def _main(dtype):
  host = RNG.standard_normal((64, 256)).astype(np.float32)
  return host, torch.from_numpy(host).to(getattr(torch, dtype))


@pytest.mark.parametrize("main", ["float32", "bfloat16"])
@pytest.mark.parametrize("order", [2, 1, 3])
def test_norm_plans_onto_k1(order, main):
  host, x = _main(main)
  before = dict(K.counts)
  got = float(sp.norm(sp.Val(x), order).glom())
  assert K.counts["routed_plain"] == before["routed_plain"]
  assert K.counts["plain_runs"] == before["plain_runs"] + 1
  red = _k1_reduce(sp.norm(sp.Val(x), order))
  big = [k for k, c in enumerate(red.inputs) if c.ndim >= 1]
  assert len(big) == 1
  scalars = {k: c.leaf_value() for k, c in enumerate(red.inputs)
             if k not in big}
  program = K.plan(red.local_op, big[0], x.dtype, scalars)
  assert program is not None
  wide = x.double().abs()
  want = float((wide ** order).sum() ** (1.0 / order))
  tol = 2.0 ** -8 if main == "bfloat16" else 1e-6
  assert got == pytest.approx(want, rel=tol)
  if main == "float32":
    r = float(ref.norm(ref.from_numpy(host), order).glom())
    assert got == pytest.approx(r, rel=1e-6)


@pytest.mark.parametrize("main", ["float32", "bfloat16"])
@pytest.mark.parametrize("order", [2, 1, 3])
def test_plain_k1_norm_chain_matches_the_reference_kernel(order, main):
  import jax.numpy as jnp
  from spartan_tpu.backend.kernels import fused_reduce as ref_kernels
  host, x = _main(main)
  red = _k1_reduce(sp.norm(sp.Val(x), order))
  big = next(k for k, c in enumerate(red.inputs) if c.ndim >= 1)
  slots = [k for k in range(len(red.inputs)) if k != big]
  scalars = {k: red.inputs[k].leaf_value() for k in slots}
  program = K.plan(red.local_op, big, x.dtype, scalars)
  got = float(K.fused_sum(x, program, [scalars[k] for k in slots],
                          torch.float64 if main == "float32"
                          else torch.float32))
  acc = jnp.float64 if main == "float32" else jnp.float32
  want = float(ref_kernels.fused_sum(
      jnp.asarray(host).astype(getattr(jnp, main)), NORM_F[order](jnp),
      scalars=[], acc_dtype=acc, interpret=True))
  scale = float(K.evaluate_program(program, x, [scalars[k] for k in slots])
                .double().abs().sum())
  if main == "bfloat16":
    tol = 2.0 ** -8
  else:
    tol = 1e-6 if order == 3 else 1e-12
  assert abs(got - want) <= tol * scale, (got, want, scale)
