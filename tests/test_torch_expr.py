"""The port's expression layer against the reference on the same inputs.

Both packages get the same seeded numpy data; results agree at rtol 1e-10
in float64 (float32 operands are accumulated in float64 by both, so only
the summation order differs).
"""

import numpy as np
import pytest
import torch

import spartan_tpu as ref
from spartan_tpu.config import FLAGS as REF_FLAGS

import spartan_tpu_torch as sp
from spartan_tpu_torch.backend import evaluator
from spartan_tpu_torch.backend.kernels import fused_reduce as K

RTOL = 1e-10


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


def _host(shape, dtype=np.float64, seed=11):
  return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _ref_with_pallas(build):
  """Evaluate the reference with its Pallas kernels in interpret mode."""
  REF_FLAGS.pallas_interpret = True
  try:
    return np.asarray(build().glom())
  finally:
    REF_FLAGS.pallas_interpret = False


SUM_CASES = {
    # affine: rewritten to a plain sum, no kernel
    "affine_ones_plus_2b": (lambda m, b, s: (m.ones(s, dtype=np.float32)
                                             + b * 2).sum(), False, RTOL),
    # non-affine: the fused-reduce kernel
    "abs_one_plus_2b": (lambda m, b, s: abs(1 + b * 2).sum(), True, RTOL),
    # ConstFoldCreations turns ones(f64) into a strong 0-d leaf: the chain
    # computes in float64 around a float32 operand
    "abs_ones64_plus_2b": (lambda m, b, s: abs(m.ones(s) + b * 2).sum(), True,
                           RTOL),
    # float32 exp is not correctly rounded: XLA's and torch's differ by an
    # ulp on some elements, so this chain is held at 1e-6
    "exp_neg_b2": (lambda m, b, s: m.exp(-(b * b)).sum(), True, 1e-6),
    "max_b_half": (lambda m, b, s: m.maximum(b, 0.5).sum(), True, RTOL),
}


@pytest.mark.parametrize("shape", [(64, 256), (37, 11)], ids=str)
@pytest.mark.parametrize("case", sorted(SUM_CASES))
def test_fused_sum_matches_reference(case, shape):
  build, takes_kernel, rtol = SUM_CASES[case]
  host = _host(shape, np.float32)
  want = _ref_with_pallas(lambda: build(ref, ref.from_numpy(host), shape))
  before = dict(K.counts)
  got = build(sp, sp.from_numpy(host), shape).glom()
  assert got.dtype == want.dtype == np.float64
  np.testing.assert_allclose(got, want, rtol=rtol)
  assert K.counts["plain_runs"] == before["plain_runs"] + int(takes_kernel)
  assert K.counts["routed_plain"] == before["routed_plain"]


AXIS_CASES = [(op, axis, keepdims)
              for op in ("sum", "mean", "max", "min", "argmax", "argmin")
              for axis in (None, 0, 1)
              for keepdims in (False, True)
              if not (op.startswith("arg") and keepdims)]


@pytest.mark.parametrize("op,axis,keepdims", AXIS_CASES,
                         ids=lambda v: str(v))
def test_axis_reductions_match_reference(op, axis, keepdims):
  host = _host((24, 40))
  kw = {} if op.startswith("arg") else {"keepdims": keepdims}
  want = getattr(ref, op)(ref.from_numpy(host) * 3 + 1, axis=axis, **kw).glom()
  got = getattr(sp, op)(sp.from_numpy(host) * 3 + 1, axis=axis, **kw).glom()
  assert got.shape == np.asarray(want).shape
  assert got.dtype == np.asarray(want).dtype
  np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=str)
@pytest.mark.parametrize("shapes", [((48, 32), (32, 16)), ((48, 32), (32,)),
                                    ((32,), (32, 16))], ids=str)
def test_dot_matches_reference(shapes, dtype):
  a, b = _host(shapes[0], dtype, 1), _host(shapes[1], dtype, 2)
  want = ref.dot(ref.from_numpy(a), ref.from_numpy(b)).glom()
  got = sp.dot(sp.from_numpy(a), sp.from_numpy(b)).glom()
  assert got.dtype == np.asarray(want).dtype == np.float64
  np.testing.assert_allclose(got, want, rtol=RTOL)


def test_dot_transpose_chain_matches_reference():
  a = _host((40, 8), seed=5)
  v = _host((40,), seed=6)
  want = ref.dot(ref.from_numpy(a).T, ref.from_numpy(v) * 0.5).glom()
  got = sp.dot(sp.from_numpy(a).T, sp.from_numpy(v) * 0.5).glom()
  np.testing.assert_allclose(got, want, rtol=RTOL)


PROMOTION_CASES = {
    "i32_plus_f32": (np.int32, np.float32, lambda x, y: x + y),
    "i32_div_i32": (np.int32, np.int32, lambda x, y: x / y),
    "i64_times_weak_float": (np.int64, None, lambda x, y: x * 2.5),
    "f32_times_weak_float": (np.float32, None, lambda x, y: x * 2.5),
    "i32_plus_weak_int": (np.int32, None, lambda x, y: x + 3),
    "f32_minus_f64": (np.float32, np.float64, lambda x, y: x - y),
}


@pytest.mark.parametrize("case", sorted(PROMOTION_CASES))
def test_numpy_promotion_matches_reference(case):
  dx, dy, fn = PROMOTION_CASES[case]
  x = (np.arange(1, 13) % 5 + 1).astype(dx)
  y = (np.arange(12) % 3 + 1).astype(dy or np.float64)
  want = fn(ref.from_numpy(x), ref.from_numpy(y)).glom()
  got = fn(sp.from_numpy(x), sp.from_numpy(y)).glom()
  numpy_dtype = fn(x, y).dtype
  assert got.dtype == np.asarray(want).dtype == numpy_dtype
  np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("name", ["sqrt", "exp", "log", "square", "negative",
                                  "abs"])
def test_unary_ufuncs_match_reference(name):
  x = np.abs(_host((10, 7))) + 0.25
  want = getattr(ref, name)(ref.from_numpy(x)).glom()
  got = getattr(sp, name)(sp.from_numpy(x)).glom()
  np.testing.assert_allclose(got, want, rtol=RTOL)


def test_sqrt_of_ints_is_float64_like_reference():
  x = np.arange(1, 9, dtype=np.int64)
  want = ref.sqrt(ref.from_numpy(x)).glom()
  got = sp.sqrt(sp.from_numpy(x)).glom()
  assert got.dtype == np.asarray(want).dtype == np.float64
  np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("op", ["zeros", "ones", "arange"])
def test_creation_matches_reference(op):
  if op == "arange":
    want, got = ref.arange(2, 30, 3).glom(), sp.arange(2, 30, 3).glom()
  else:
    want = getattr(ref, op)((5, 6)).glom()
    got = getattr(sp, op)((5, 6)).glom()
  assert got.dtype == np.asarray(want).dtype
  np.testing.assert_array_equal(got, want)


def test_random_creation_is_seeded_and_shaped():
  """The port's generator stream differs from jax.random by design; what
  must hold is shape, dtype, range and reproducibility per seed."""
  sp.set_random_seed(3)
  a = sp.rand(64, 32).glom()
  sp.set_random_seed(3)
  b = sp.rand(64, 32).glom()
  n = sp.randn(4096).glom()
  assert a.shape == (64, 32) and a.dtype == np.float64
  np.testing.assert_array_equal(a, b)
  assert 0.0 <= a.min() and a.max() < 1.0
  assert abs(n.mean()) < 0.1 and abs(n.std() - 1.0) < 0.1


def test_second_evaluation_is_a_fast_lane_hit():
  host = _host((32, 32), np.float32)
  b = sp.from_numpy(host)
  first = abs(1 + b * 2).sum().glom()
  before = dict(evaluator.stats)
  second = abs(1 + b * 2).sum().glom()
  assert evaluator.stats["fast_hits"] == before["fast_hits"] + 1
  assert evaluator.stats["compiles"] == before["compiles"]
  assert first == second


def test_use_kernels_off_takes_plain_reduction():
  host = _host((16, 16), np.float32)
  sp.FLAGS.use_kernels = False
  try:
    before = dict(K.counts)
    got = abs(1 + sp.from_numpy(host) * 2).sum().glom()
  finally:
    sp.FLAGS.use_kernels = True
  assert K.counts == before
  np.testing.assert_allclose(
      got, np.abs(1 + host * np.float32(2)).astype(np.float64).sum(),
      rtol=RTOL)


def test_interop_carries_dtypes_exactly():
  values = {"f64": _host((3, 4)), "i64": np.arange(5), "b": np.array(
      [True, False]), "f32": _host((2,), np.float32)}
  ref_arrays = {k: ref.from_numpy(v) for k, v in values.items()}
  ported = sp.interop.from_reference(ref_arrays, device="cpu")
  for k, v in values.items():
    assert ported[k].dtype == sp.core.array.to_torch_dtype(v.dtype)
    np.testing.assert_array_equal(ported[k].glom(), v)


def test_initialize_refuses_missing_cuda(monkeypatch):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="is_available"):
    sp.initialize(["--device=cuda"])
  sp.initialize(["--device=cpu"])
  assert sp.get_mesh().device == torch.device("cpu")


def test_sparse_dot_names_the_later_slice():
  """The sparse x dense-matrix product, the slice after SpMV, is an SpMM
  expr now; a scipy matrix must be converted first."""
  import scipy.sparse as ss
  S = sp.sparse.from_scipy(ss.eye(4, format="csr"))
  e = sp.dot(S, sp.from_numpy(np.arange(8.0).reshape(4, 2)))
  assert isinstance(e, sp.sparse.SpMMExpr)
  np.testing.assert_array_equal(e.glom(), np.arange(8.0).reshape(4, 2))
  with pytest.raises(TypeError, match="from_scipy"):
    sp.dot(ss.eye(4, format="csr"), sp.from_numpy(np.ones(4)))
