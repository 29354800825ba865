"""The port's SpMV kernels' plain versions against the reference's Pallas
kernels in interpret mode, and the eager ``spmv`` and ``SpMVExpr`` under
the kernel-forcing flags against the reference under the same flags, on
the same seeded inputs.

* ``spmv_ell_plain`` (K3a's plain version) against
  ``spmv_pallas.spmv(..., interpret=True)``;
* ``spmv_csr_plain`` (K3b's) against
  ``make_spmv_windowed(pack_windowed(A), interpret=True)``, including the
  chunked-launch case of ``tests/test_kernels.py``.

Tolerance: 1e-5 of max|y| in float32.  Both sides sum float32 products in
different orders, and the reference's one-hot and windowed kernels read x
through bf16 hi/lo halves (about 3e-6 relative, ``spmv_pallas.py:25``).
float64 stays on the plain gather in both packages: rtol 1e-10.  The
reference runs on a one-device mesh where a test targets K3a or K3b
itself; on the 8-device mesh it takes the sharded forms, which the port
does not have yet.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as ss
import torch

import spartan_tpu as ref
from spartan_tpu.backend import sparse as ref_sps
from spartan_tpu.backend.kernels import spmv_pallas as sk
from spartan_tpu.config import FLAGS as REF_FLAGS
from spartan_tpu.core import mesh as ref_mesh

import spartan_tpu_torch as sp
from spartan_tpu_torch.backend import sparse as sps
from spartan_tpu_torch.backend.kernels import spmv as KS
from spartan_tpu_torch.config import FLAGS


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


# -- the plain versions against the Pallas kernels --------------------------------

@pytest.mark.parametrize("n, k, m", [(13, 3, 20), (300, 17, 200),
                                     (1024, 64, 4096), (8, 130, 100)])
def test_spmv_ell_plain_matches_onehot_kernel(n, k, m):
  rng = np.random.default_rng(n + k)
  cols = rng.integers(0, m, (n, k)).astype(np.int32)
  vals = rng.standard_normal((n, k)).astype(np.float32)
  vals[:, k // 2:][rng.random((n, k - k // 2)) < 0.5] = 0  # pad-like zeros
  x = rng.standard_normal(m).astype(np.float32)
  want = sk.spmv(jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(x),
                 interpret=True)
  got = KS.spmv_ell_plain(torch.from_numpy(cols), torch.from_numpy(vals),
                          torch.from_numpy(x))
  assert got.dtype == torch.float32
  close(got, want)


def _windowed(A, x):
  return np.asarray(sk.make_spmv_windowed(sk.pack_windowed(A),
                                          interpret=True)(jnp.asarray(x)))


def _csr_plain(A, x):
  S = sps.from_scipy(A)
  out = KS.spmv_csr_plain(*S.to_csr(), torch.from_numpy(x))
  assert out.dtype == torch.float32
  return out


@pytest.mark.parametrize("shape, density", [((600, 600), 0.01),
                                            ((1500, 2300), 0.005),
                                            ((13, 20), 0.3)])
def test_spmv_csr_plain_matches_windowed_kernel(shape, density):
  A = ss.random(*shape, density=density, random_state=7, format="csr",
                dtype=np.float32)
  x = np.random.default_rng(1).standard_normal(shape[1]).astype(np.float32)
  close(_csr_plain(A, x), _windowed(A, x))


def test_spmv_csr_plain_matches_windowed_kernel_with_empty_rows():
  A = ss.random(4096, 2500, density=0.004, random_state=3, format="lil",
                dtype=np.float32)
  A[2048:3072, :] = 0
  A = A.tocsr()
  x = np.random.default_rng(2).standard_normal(2500).astype(np.float32)
  got = _csr_plain(A, x)
  assert float(got[2048:3072].abs().max()) == 0.0
  close(got, _windowed(A, x))


def test_spmv_csr_plain_matches_chunked_windowed_launches(monkeypatch):
  """The reference's chunked launches (its SMEM budget forced down to 7
  grid steps so cuts land mid-row-block) give the port's CSR product."""
  monkeypatch.setattr(sk, "_MAX_PREFETCH_STEPS", 7)
  A = ss.random(2048, 12000, density=0.002,
                random_state=np.random.RandomState(1), format="csr",
                dtype=np.float32)
  packed = sk.pack_windowed(A)
  assert packed.rb.shape[0] > 21  # several chunks
  x = np.random.default_rng(42).standard_normal(12000).astype(np.float32)
  want = np.asarray(sk.make_spmv_windowed(packed, interpret=True)(
      jnp.asarray(x)))
  close(_csr_plain(A, x), want)


def test_to_csr_is_scipys_csr_without_stored_zeros():
  A = ss.random(50, 40, density=0.1, random_state=4, format="csr",
                dtype=np.float32)
  S = sps.from_scipy(A)
  indptr, indices, data = S.to_csr()
  assert S.to_csr() is S.to_csr()
  assert (indptr.dtype, indices.dtype, data.dtype) == (
      torch.int64, torch.int32, torch.float32)
  A.sort_indices()
  np.testing.assert_array_equal(indptr.numpy(), A.indptr)
  np.testing.assert_array_equal(indices.numpy(), A.indices)
  np.testing.assert_array_equal(data.numpy(), A.data)


@pytest.mark.parametrize("per_row, g", [(0.5, 1), (1, 1), (3, 4), (16, 16),
                                        (17, 32), (41, 32), (10_000, 32)])
def test_group_size(per_row, g):
  assert KS.group_size(per_row) == g


# -- the wrappers on CPU tensors ---------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
def test_wrappers_run_their_plain_versions_on_cpu(dtype):
  A = ss.random(40, 30, density=0.2, random_state=5, format="csr",
                dtype=np.float32)
  S = sps.from_scipy(A)
  x = torch.from_numpy(np.random.default_rng(3).standard_normal(30).astype(
      np.float32)).to(dtype)
  before = dict(KS.counts)
  y_ell = KS.spmv_ell(S.cols, S.vals.to(dtype), x)
  y_csr = KS.spmv_csr(*S.to_csr(), x)
  assert KS.counts["ell_plain_runs"] == before["ell_plain_runs"] + 1
  assert KS.counts["csr_plain_runs"] == before["csr_plain_runs"] + 1
  assert KS.counts["ell_launches"] == before["ell_launches"]
  assert KS.counts["csr_launches"] == before["csr_launches"]
  assert y_ell.dtype == y_csr.dtype == dtype
  want = A @ x.float().numpy()
  tol = 1e-5 if dtype == torch.float32 else 1e-2
  close(y_ell.float(), want, tol)
  close(y_csr.float(), want, tol)


def test_wrappers_refuse_what_the_kernels_do_not_take():
  S = sps.from_scipy(ss.random(10, 8, density=0.3, random_state=6,
                               format="csr", dtype=np.float32))
  x = torch.ones(8)
  with pytest.raises(TypeError, match="int32 cols"):
    KS.spmv_ell(S.cols.long(), S.vals, x)
  with pytest.raises(TypeError, match="float32/bfloat16/float16"):
    KS.spmv_ell(S.cols, S.vals, x.double())
  with pytest.raises(ValueError, match=r"cols/vals \(n, k\)"):
    KS.spmv_ell(S.cols, S.vals, x[None])
  indptr, indices, data = S.to_csr()
  with pytest.raises(TypeError, match="int64 indptr"):
    KS.spmv_csr(indptr.int(), indices, data, x)
  with pytest.raises(ValueError, match="indptr"):
    KS.spmv_csr(indptr, indices, data[:-1], x)


# -- eager spmv and SpMVExpr under the forcing flags ------------------------------

ROUTES = [("sparse_force_onehot", "ell", "ell_plain_runs"),
          ("sparse_force_windowed", "win", "csr_plain_runs")]


def _problem(dtype=np.float32, n=700, seed=13):
  A = ss.random(n, n, density=0.02, random_state=seed, format="csr",
                dtype=dtype)
  x = np.random.default_rng(seed).standard_normal(n).astype(dtype)
  return A, x


@pytest.mark.parametrize("flag, fmt, count", ROUTES)
def test_eager_spmv_under_forced_route(flag, fmt, count, flags, one_device):
  flags(flag, True)
  A, x = _problem()
  before = KS.counts[count]
  got = sps.spmv(sps.from_scipy(A), x)
  assert KS.counts[count] == before + 1  # the kernel route, plain on CPU
  want = ref_sps.spmv(ref_sps.from_scipy(A), x)
  assert got.dtype == torch.float32
  close(got.numpy(), want)
  close(got.numpy(), A.astype(np.float64) @ x.astype(np.float64))


@pytest.mark.parametrize("flag, fmt, count", ROUTES)
def test_spmv_expr_under_forced_route(flag, fmt, count, flags, one_device):
  flags(flag, True)
  A, x = _problem(seed=14)
  e_ref = ref_sps.spmv_expr(ref_sps.from_scipy(A), ref.from_numpy(x))
  e = sps.spmv_expr(sps.from_scipy(A), sp.from_numpy(x))
  assert e.fmt == e_ref.fmt == fmt
  before = KS.counts[count]
  got = e.glom()
  assert KS.counts[count] == before + 1
  close(got, e_ref.glom())


@pytest.mark.parametrize("flag, fmt, count", ROUTES)
def test_spmv_expr_in_a_loop_under_forced_route(flag, fmt, count, flags,
                                                one_device):
  flags(flag, True)
  A, x = _problem(n=400, seed=15)
  R, S = ref_sps.from_scipy(A), sps.from_scipy(A)
  run_ref = ref.make_fori(lambda r: ref_sps.spmv_expr(R, r) * 0.5 + 0.5 / 400,
                          ref.ones((400,), dtype=np.float32) / 400)
  run = sp.make_fori(lambda r: sps.spmv_expr(S, r) * 0.5 + 0.5 / 400,
                     sp.ones((400,), dtype=np.float32) / 400)
  before = KS.counts[count]
  got = run(5).glom()
  assert KS.counts[count] == before + 5
  close(got, np.asarray(run_ref(5).data))


def test_eager_spmv_plain_routes_match_reference():
  A, x = _problem(np.float64)
  R, S = ref_sps.from_scipy(A), sps.from_scipy(A)
  before = dict(KS.counts)
  for use in (None, False):
    got = sps.spmv(S, x, use_kernels=use)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_sps.spmv(R, x)),
                               rtol=1e-10)
  assert KS.counts == before  # CPU, no forcing flag: the plain gather
  with pytest.raises(ValueError, match="dim mismatch"):
    sps.spmv(S, x[:-1])


def test_float64_stays_on_the_plain_gather_when_forced(flags, one_device):
  flags("sparse_force_windowed", True)
  A, x = _problem(np.float64, seed=16)
  e = sps.spmv_expr(sps.from_scipy(A), sp.from_numpy(x))
  e_ref = ref_sps.spmv_expr(ref_sps.from_scipy(A), ref.from_numpy(x))
  assert e.fmt == e_ref.fmt == "ell"
  before = dict(KS.counts)
  got = e.glom()
  assert KS.counts == before and got.dtype == np.float64
  np.testing.assert_allclose(got, np.asarray(e_ref.glom()), rtol=1e-10)


@pytest.mark.parametrize("flag, fmt", [("sparse_force_onehot", "ell"),
                                       ("sparse_force_windowed", "win")])
def test_differentiable_emit_takes_the_plain_version(flag, fmt, flags):
  """Under ``EmitCtx(differentiable=True)`` no kernel wrapper is called
  (the kernels have no autograd rule) and gradients reach x."""
  from spartan_tpu_torch.expr.base import EmitCtx
  flags(flag, True)
  A, x = _problem(n=120, seed=17)
  e = sps.spmv_expr(sps.from_scipy(A), sp.from_numpy(x))
  assert e.fmt == fmt
  deps = [c.leaf_value() for c in e.inputs[:-1]]
  xt = torch.from_numpy(x).requires_grad_()
  before = dict(KS.counts)
  y = e._emit(EmitCtx(differentiable=True, device=torch.device("cpu")),
              deps + [xt])
  assert KS.counts == before
  close(y.detach().numpy(), A @ x)
  g = np.random.default_rng(18).standard_normal(120).astype(np.float32)
  y.backward(torch.from_numpy(g))
  close(xt.grad.numpy(), A.T @ g)


@pytest.mark.parametrize("flag", [None, "sparse_force_onehot",
                                  "sparse_force_windowed",
                                  "sparse_force_dense"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=str)
def test_eager_spmv_and_spmv_expr_take_one_route(flag, dtype, flags):
  """The eager ``spmv`` and ``SpMVExpr`` share their route: the same
  wrapper counts rise and the results agree (1e-6 of max|y| in float32,
  1e-12 in float64)."""
  if flag:
    flags(flag, True)
  A, x = _problem(dtype, n=300, seed=19)
  S = sps.from_scipy(A)
  before = dict(KS.counts)
  eager = sps.spmv(S, x)
  mid = dict(KS.counts)
  e = sps.spmv_expr(S, sp.from_numpy(x))
  got = e.glom()
  assert ({k: mid[k] - before[k] for k in KS.counts}
          == {k: KS.counts[k] - mid[k] for k in KS.counts})
  assert e.fmt == sps._route(S, eager.dtype, on_accel=False)[0]
  if dtype == np.float64 or flag is None:
    assert e.fmt == "ell" and KS.counts == before  # the plain gather
  assert eager.numpy().dtype == got.dtype == dtype
  tol = 1e-6 if dtype == np.float32 else 1e-12
  np.testing.assert_allclose(eager.numpy(), got, rtol=0,
                             atol=tol * np.abs(got).max())
