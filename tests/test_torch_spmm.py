"""The port's SpMM against the reference's, on the same seeded inputs.

* ``spmm_csr_plain`` (K5a's plain version) against
  ``spmm_pallas.make_spmm_windowed(pack_windowed_spmm(A), interpret=True)``
  (the reference's kernel itself, called directly), on matrices above the
  reference's 0.2 pack-fill gate: a width that is not a multiple of the
  1024-column window, a band of empty rows, one row of thousands of
  entries; k from 1 to 512; float32, bfloat16 and float64 B.
* the eager ``spmm``, ``bsr_spmm``, ``SpMMExpr`` / ``spmm_expr`` and the
  ``sp.dot`` dispatch against the reference's, under the default flags and
  ``sparse_force_winmm`` / ``sparse_force_dense``.

Tolerances.  Against the Pallas kernel, per entry
(2^-16 + 2·len(row)·2^-24)·Σ_j|a_ij·b_jc|: the reference splits each f32
product into bf16 hi and lo halves (within 2^-17 of the product,
``spmm_pallas.py:222-228``) and each side sums the row's products in float32
in its own order (each within len·2^-24 of the exact sum); the bound doubles
the split's share for the strips' extra adds.  float64 on the plain gather:
rtol 1e-10.  float32 through the routes: 1e-5 of max|Y| (float32 sums in
another order, the reference's hi/lo split).  The reference runs on a
one-device mesh where a test targets K5a itself; on the 8-device mesh it
takes the sharded form (K5b), which the port does not have yet.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as ss
import torch

import spartan_tpu as ref
from spartan_tpu.backend import sparse as ref_sps
from spartan_tpu.backend.kernels import spmm_pallas as smp
from spartan_tpu.config import FLAGS as REF_FLAGS
from spartan_tpu.core import mesh as ref_mesh

import spartan_tpu_torch as sp
from spartan_tpu_torch.backend import sparse as sps
from spartan_tpu_torch.backend.kernels import spmm as K5
from spartan_tpu_torch.config import FLAGS
from spartan_tpu_torch.expr.base import EmitCtx


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


@pytest.fixture
def flags():
  saved = []

  def set_(name, value):
    saved.append((name, getattr(FLAGS, name), getattr(REF_FLAGS, name)))
    setattr(FLAGS, name, value)
    setattr(REF_FLAGS, name, value)

  yield set_
  for name, port_v, ref_v in reversed(saved):
    setattr(FLAGS, name, port_v)
    setattr(REF_FLAGS, name, ref_v)


@pytest.fixture
def one_device():
  with ref.with_mesh(ref_mesh.make_mesh(devices=jax.devices()[:1])):
    yield


def close(got, want, rtol=1e-5):
  got, want = np.asarray(got), np.asarray(want)
  assert got.shape == want.shape
  np.testing.assert_allclose(got, want, rtol=0,
                             atol=rtol * max(np.abs(want).max(), 1e-30))


def kernel_matrix(kind: str):
  """float32 CSR matrices above the reference's 0.2 pack-fill gate."""
  if kind == "odd_m":
    return ss.random(300, 2500, density=0.01, random_state=1, format="csr",
                     dtype=np.float32)
  if kind == "empty_rows":
    A = ss.random(400, 1100, density=0.02, random_state=2, format="lil",
                  dtype=np.float32)
    A[130:260, :] = 0
    return A.tocsr()
  if kind == "long_row":
    A = ss.random(200, 3000, density=0.01, random_state=3, format="lil",
                  dtype=np.float32)
    rng = np.random.default_rng(3)
    A[7, rng.choice(3000, 2500, replace=False)] = rng.standard_normal(
        2500).astype(np.float32)
    return A.tocsr()
  raise ValueError(kind)


def _windowed(A, B):
  packed = smp.pack_windowed_spmm(A)
  assert packed.fill >= 0.2  # the reference's gate would route it here
  return np.asarray(smp.make_spmm_windowed(packed, interpret=True)(
      jnp.asarray(B)))


def _check_plain_against_windowed(A, B):
  csr = sps.from_scipy(A).to_csr()
  Bt = torch.from_numpy(np.asarray(B, np.float32) if B.dtype.name ==
                        "bfloat16" else B)
  got = K5.spmm_csr_plain(*csr, Bt)
  want = _windowed(A, B)
  assert got.dtype == torch.promote_types(torch.float32, Bt.dtype)
  assert str(want.dtype) == str(got.dtype).split(".")[1]
  lengths = np.diff(A.indptr)[:, None].astype(np.float64)
  sum_abs = np.abs(A).astype(np.float64) @ np.abs(
      np.asarray(B, np.float32).astype(np.float64))
  tol = (2.0 ** -16 + 2 * lengths * 2.0 ** -24) * sum_abs
  assert np.all(np.abs(got.double().numpy() - want.astype(np.float64))
                <= tol + 1e-30)


@pytest.mark.parametrize("k", [1, 7, 64])
@pytest.mark.parametrize("kind", ["odd_m", "empty_rows", "long_row"])
def test_spmm_csr_plain_matches_windowed_kernel(kind, k):
  A = kernel_matrix(kind)
  B = np.random.default_rng(k).standard_normal((A.shape[1], k)).astype(
      np.float32)
  _check_plain_against_windowed(A, B)


@pytest.mark.parametrize("k", [130, 512])
def test_spmm_csr_plain_matches_windowed_kernel_past_its_strips(k):
  """Past 128 columns the reference tiles B into 128-column strips over
  one pack; the port's product takes them in one pass."""
  A = kernel_matrix("odd_m")
  B = np.random.default_rng(k).standard_normal((A.shape[1], k)).astype(
      np.float32)
  _check_plain_against_windowed(A, B)


@pytest.mark.parametrize("dtype", ["bfloat16", "float64"])
def test_spmm_csr_plain_matches_windowed_kernel_in_b_dtype(dtype):
  A = kernel_matrix("empty_rows")
  B = np.random.default_rng(5).standard_normal((A.shape[1], 64))
  if dtype == "bfloat16":
    _check_plain_against_windowed(A, jnp.asarray(B, jnp.bfloat16))
  else:
    _check_plain_against_windowed(A, B)


def test_plain_version_works_in_chunks(monkeypatch):
  A = kernel_matrix("long_row")
  B = torch.from_numpy(np.random.default_rng(6).standard_normal(
      (A.shape[1], 9)))
  csr = sps.from_scipy(A).to_csr()
  whole = K5.spmm_csr_plain(*csr, B)
  monkeypatch.setattr(K5, "PLAIN_CHUNK", 1000)  # cuts inside the long row
  np.testing.assert_allclose(K5.spmm_csr_plain(*csr, B).numpy(),
                             whole.numpy(), rtol=1e-6)
  close(whole.numpy(), A.astype(np.float64) @ B.float().double().numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float64], ids=str)
def test_wrapper_runs_its_plain_version_on_cpu(dtype):
  A = ss.random(40, 30, density=0.2, random_state=7, format="csr",
                dtype=np.float32)
  csr = sps.from_scipy(A).to_csr()
  B = torch.from_numpy(np.random.default_rng(7).standard_normal(
      (30, 5))).to(dtype)
  before = dict(K5.counts)
  got = K5.spmm_csr(*csr, B)
  assert K5.counts == dict(before, plain_runs=before["plain_runs"] + 1)
  assert got.dtype == torch.promote_types(torch.float32, dtype)
  torch.testing.assert_close(got, K5.spmm_csr_plain(*csr, B), rtol=0,
                             atol=0)


def test_wrapper_refuses_what_the_kernel_does_not_take():
  A = ss.random(10, 8, density=0.3, random_state=8, format="csr",
                dtype=np.float32)
  indptr, indices, data = sps.from_scipy(A).to_csr()
  B = torch.ones(8, 3)
  with pytest.raises(ValueError, match="k <= 512"):
    K5.spmm_csr(indptr, indices, data, torch.ones(8, 513))
  with pytest.raises(TypeError, match="float B"):
    K5.spmm_csr(indptr, indices, data, B.long())
  with pytest.raises(TypeError, match="float32/bfloat16/float16 data"):
    K5.spmm_csr(indptr, indices, data.double(), B)
  with pytest.raises(TypeError, match="int64 indptr"):
    K5.spmm_csr(indptr.int(), indices, data, B)
  with pytest.raises(ValueError, match=r"B \(m, k\)"):
    K5.spmm_csr(indptr, indices, data, B[:, 0])


# -- the entry points against the reference -----------------------------------------

def _problem(dtype=np.float64, n=120, m=90, k=6, seed=11):
  A = ss.random(n, m, density=0.05, random_state=seed, format="csr",
                dtype=dtype)
  B = np.random.default_rng(seed).standard_normal((m, k)).astype(dtype)
  return A, B


def test_eager_spmm_float64_matches_reference():
  A, B = _problem()
  R, S = ref_sps.from_scipy(A), sps.from_scipy(A)
  before = dict(K5.counts)
  for use in (None, False):
    got = sps.spmm(S, B, use_kernels=use)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_sps.spmm(R, B)),
                               rtol=1e-10)
  assert K5.counts == before  # CPU, no forcing flag: the plain gather
  np.testing.assert_allclose(got.numpy(), A @ B, rtol=1e-10)


@pytest.mark.parametrize("case", ["default", "force_winmm", "force_dense",
                                  "exact_precision", "float64"])
def test_fmt_chosen_as_the_reference_chooses_it(case, flags, one_device):
  dtype = np.float64 if case == "float64" else np.float32
  A, B = _problem(dtype, seed=12)
  precision = "highest" if case == "exact_precision" else None
  if case in ("force_winmm", "exact_precision", "float64"):
    flags("sparse_force_winmm", True)
  if case == "force_dense":
    flags("sparse_force_dense", True)
  R, S = ref_sps.from_scipy(A), sps.from_scipy(A)
  e_ref = ref_sps.SpMMExpr(R, ref.from_numpy(B), precision=precision)
  e = sps.SpMMExpr(S, sp.from_numpy(B), precision=precision)
  assert e.fmt == e_ref.fmt
  assert (e.n_rows, e.pad_m, e.bs, e.n_shards) == (
      e_ref.n_rows, e_ref.pad_m, e_ref.bs, e_ref.n_shards)
  before = dict(K5.counts)
  want, got = np.asarray(e_ref.glom()), e.glom()
  assert K5.counts["plain_runs"] == before["plain_runs"] + (
      e.fmt == "winmm")
  assert got.dtype == want.dtype and got.shape == (120, 6)
  tol = 1e-10 if dtype == np.float64 else 1e-5
  np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def test_float64_b_takes_the_kernel_route(flags, one_device):
  """A float32 matrix times a float64 B: the kernel route casts B to
  float32 and returns float64, as the reference's SpMMExpr does (ALS's
  products)."""
  flags("sparse_force_winmm", True)
  A, _ = _problem(np.float32, seed=13)
  B = np.random.default_rng(13).standard_normal((90, 6))
  e_ref = ref_sps.spmm_expr(ref_sps.from_scipy(A), ref.from_numpy(B))
  S = sps.from_scipy(A)
  e = sps.spmm_expr(S, sp.from_numpy(B))
  assert e.fmt == e_ref.fmt == "winmm"
  before = K5.counts["plain_runs"]
  got = e.glom()
  eager = sps.spmm(S, B)
  assert K5.counts["plain_runs"] == before + 2
  assert got.dtype == eager.numpy().dtype == np.float64
  close(got, np.asarray(e_ref.glom()))
  np.testing.assert_array_equal(eager.numpy(), got)


@pytest.mark.parametrize("k, fmt", [(512, "winmm"), (513, "ell")])
def test_k_gate(k, fmt, flags, one_device):
  flags("sparse_force_winmm", True)
  A, _ = _problem(np.float32, m=40, seed=14)
  A = A + ss.random(120, 40, density=0.2, random_state=14, format="csr",
                    dtype=np.float32)  # above the reference's fill gate
  B = np.ones((40, k), np.float32)
  R, S = ref_sps.from_scipy(A), sps.from_scipy(A)
  assert sps.spmm_expr(S, sp.from_numpy(B)).fmt == fmt
  ref_fmt = ref_sps.spmm_expr(R, ref.from_numpy(B)).fmt
  assert ref_fmt.startswith("winmm") == (fmt == "winmm")


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=str)
def test_dot_dispatch_matches_reference(dtype):
  A, B = _problem(dtype, seed=15)
  Bt = np.ascontiguousarray(B.T[:, :80])  # (6, 80) for dot(dense, S[:80]^T)
  A2 = A[:, :80].T.tocsr()                 # (80, 120)
  R, S = ref_sps.from_scipy(A), sps.from_scipy(A)
  R2, S2 = ref_sps.from_scipy(A2), sps.from_scipy(A2)
  tol = 1e-10 if dtype == np.float64 else 1e-5
  cases = [(ref.dot(R, ref.from_numpy(B)), sp.dot(S, sp.from_numpy(B))),
           (R @ ref.from_numpy(B), S @ sp.from_numpy(B)),
           (R.dot(ref.from_numpy(B)), S.dot(sp.from_numpy(B))),
           (ref.dot(ref.from_numpy(Bt), R2), sp.dot(sp.from_numpy(Bt), S2)),
           (Bt @ R2, Bt @ S2)]
  for want, got in cases:
    w, g = np.asarray(want.glom()), got.glom()
    assert g.dtype == w.dtype and g.shape == w.shape
    np.testing.assert_allclose(g, w, rtol=0, atol=tol * np.abs(w).max())
  assert isinstance(sp.dot(S, sp.from_numpy(B)), sps.SpMMExpr)


def test_map_chain_after_spmm_expr(flags, one_device):
  flags("sparse_force_winmm", True)
  A, B = _problem(np.float32, seed=16)
  R, S = ref_sps.from_scipy(A), sps.from_scipy(A)
  want = (ref_sps.spmm_expr(R, ref.from_numpy(B)) * 2.0 + 1.0).glom()
  before = K5.counts["plain_runs"]
  got = (sps.spmm_expr(S, sp.from_numpy(B)) * 2.0 + 1.0).glom()
  assert K5.counts["plain_runs"] == before + 1
  close(got, np.asarray(want))


def test_errors_match_reference():
  A, B = _problem(seed=17)
  R, S = ref_sps.from_scipy(A), sps.from_scipy(A)
  with pytest.raises(ValueError, match="dim mismatch"):
    ref_sps.spmm(R, B[:-1])
  with pytest.raises(ValueError, match="dim mismatch"):
    sps.spmm(S, B[:-1])
  with pytest.raises(ValueError, match="dim mismatch"):
    sps.spmm_expr(S, sp.from_numpy(B[:-1]))
  cube = np.ones((90, 2, 3))
  with pytest.raises(ValueError, match="3-D"):
    ref_sps.sparse_dot(R, ref.from_numpy(cube))
  with pytest.raises(ValueError, match="3-D"):
    sp.dot(S, sp.from_numpy(cube))
  with pytest.raises(ValueError, match="2-D right operand"):
    sps.spmm(S, cube)
  with pytest.raises(ValueError, match="precision"):
    sps.SpMMExpr(S, B, precision="fast")


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=str)
def test_bsr_spmm_matches_reference(dtype):
  rng = np.random.default_rng(18)
  A = ss.bsr_matrix((rng.random((8, 16, 16)), rng.integers(0, 4, 8),
                     np.arange(5) * 2), shape=(64, 64)).tocsr().astype(dtype)
  B = rng.standard_normal((64, 5)).astype(dtype)
  want = np.asarray(ref_sps.bsr_spmm(ref_sps.from_scipy_bsr(A, bs=16), B))
  blocks = sps.from_scipy_bsr(A, bs=16)
  got = sps.bsr_spmm(blocks, B).numpy()
  assert got.dtype == want.dtype
  tol = 1e-10 if dtype == np.float64 else 1e-5
  np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())
  np.testing.assert_array_equal(sps.spmm(blocks, B).numpy(), got)
  e = sps.spmm_expr(blocks, sp.from_numpy(B))
  assert e.fmt == "bsr"
  np.testing.assert_allclose(e.glom(), want, rtol=0,
                             atol=tol * np.abs(want).max())
  with pytest.raises(ValueError, match="dim mismatch"):
    sps.bsr_spmm(blocks, B[:-1])


@pytest.mark.parametrize("flag", [None, "sparse_force_winmm",
                                  "sparse_force_dense"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=str)
def test_eager_spmm_and_spmm_expr_take_one_route(flag, dtype, flags):
  """The eager ``spmm`` and ``SpMMExpr`` share their route: the same
  wrapper counts rise and the results agree."""
  if flag:
    flags(flag, True)
  A, B = _problem(dtype, seed=19)
  S = sps.from_scipy(A)
  before = dict(K5.counts)
  eager = sps.spmm(S, B)
  mid = dict(K5.counts)
  e = sps.spmm_expr(S, sp.from_numpy(B))
  got = e.glom()
  assert ({k: mid[k] - before[k] for k in K5.counts}
          == {k: K5.counts[k] - mid[k] for k in K5.counts})
  assert e.fmt == sps._spmm_route(S, eager.dtype, 6, on_accel=False)[0]
  if dtype == np.float64 or flag is None:
    assert e.fmt == "ell" and K5.counts == before
  assert eager.numpy().dtype == got.dtype == dtype
  tol = 1e-6 if dtype == np.float32 else 1e-12
  np.testing.assert_allclose(eager.numpy(), got, rtol=0,
                             atol=tol * np.abs(got).max())


def test_differentiable_emit_takes_the_plain_version(flags):
  """Under ``EmitCtx(differentiable=True)`` no kernel wrapper is called and
  gradients reach B."""
  flags("sparse_force_winmm", True)
  A, B = _problem(np.float32, seed=20)
  e = sps.spmm_expr(sps.from_scipy(A), sp.from_numpy(B))
  assert e.fmt == "winmm"
  deps = [c.leaf_value() for c in e.inputs[:-1]]
  Bt = torch.from_numpy(B).requires_grad_()
  before = dict(K5.counts)
  Y = e._emit(EmitCtx(differentiable=True, device=torch.device("cpu")),
              deps + [Bt])
  assert K5.counts == before
  close(Y.detach().numpy(), A @ B)
  G = np.random.default_rng(21).standard_normal(Y.shape).astype(np.float32)
  Y.backward(torch.from_numpy(G))
  close(Bt.grad.numpy(), A.T @ G)


@pytest.mark.parametrize("flag", [None, "sparse_force_winmm",
                                  "sparse_force_dense"])
def test_shape_inference_reaches_no_kernel(flags, flag):
  if flag:
    flags(flag, True)
  A, _ = _problem(np.float32, seed=22)
  before = dict(K5.counts)
  e = sps.spmm_expr(sps.from_scipy(A), sp.ones((90, 4)) * 2)
  assert (e.shape, e.dtype) == ((120, 4), torch.float64)
  assert K5.counts == before
