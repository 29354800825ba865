"""PageRank (config 5's workload) in both packages from the same link
matrix: the dense ``fit`` and the sparse ``fit_sparse``, with the sparse
matrix carried across by ``interop.from_reference``.

Tolerances: float64 at rtol 1e-10 (sums in another order); float32 at
1e-5 of max r (float32 sums in another order over 30 iterations; the
reference's TPU-shaped kernels read x through bf16 hi/lo halves).
"""

import jax
import numpy as np
import pytest
import scipy.sparse as ss
import torch

import spartan_tpu as ref
from spartan_tpu.backend import sparse as ref_sps
from spartan_tpu.config import FLAGS as REF_FLAGS
from spartan_tpu.core import mesh as ref_mesh
from spartan_tpu.examples import pagerank as ref_pagerank

import spartan_tpu_torch as sp
from spartan_tpu_torch.backend import sparse as sps
from spartan_tpu_torch.backend.kernels import spmv as KS
from spartan_tpu_torch.config import FLAGS
from spartan_tpu_torch.examples import pagerank

ITERS = 30


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


def numpy_pagerank(M, iterations=ITERS, damping=0.85):
  n = M.shape[0]
  r = np.full(n, 1.0 / n)
  for _ in range(iterations):
    r = damping * (M @ r) + (1 - damping) / n
  return r


def test_make_link_matrix_is_the_references():
  np.testing.assert_array_equal(pagerank.make_link_matrix(128, 6, seed=3),
                                ref_pagerank.make_link_matrix(128, 6, seed=3))


@pytest.mark.parametrize("n", [64, 256])
def test_fit_matches_reference(n):
  M = pagerank.make_link_matrix(n)
  want = ref_pagerank.fit(ref.from_numpy(M), ITERS).glom()
  got = pagerank.fit(sp.interop.from_reference(ref.from_numpy(M)),
                     ITERS).glom()
  assert got.dtype == np.float64
  np.testing.assert_allclose(got, want, rtol=1e-10)
  np.testing.assert_allclose(got, numpy_pagerank(M), rtol=1e-10)


def test_run_matches_reference():
  r, M = pagerank.run(96, 12)
  r_ref, M_ref = ref_pagerank.run(96, 12)
  np.testing.assert_array_equal(M, M_ref)
  np.testing.assert_allclose(r.glom(), r_ref.glom(), rtol=1e-10)


def test_step_is_lazy_and_matches_reference():
  M = pagerank.make_link_matrix(64)
  r = np.random.default_rng(1).random(64)
  got = pagerank.step(sp.from_numpy(M), sp.from_numpy(r))
  assert isinstance(got, sp.Expr)
  np.testing.assert_allclose(
      got.glom(), ref_pagerank.step(ref.from_numpy(M), ref.from_numpy(r)).glom(),
      rtol=1e-10)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=str)
@pytest.mark.parametrize("n", [64, 300])
def test_fit_sparse_matches_reference(n, dtype):
  M = ss.csr_matrix(pagerank.make_link_matrix(n).astype(dtype))
  R = ref_sps.from_scipy(M)
  want = ref_pagerank.fit_sparse(R, ITERS)
  got = pagerank.fit_sparse(sp.interop.from_reference(R), ITERS)
  assert got.dtype == want.dtype == dtype
  tol = 1e-10 if dtype == np.float64 else 1e-5
  np.testing.assert_allclose(got, want, rtol=0, atol=tol * want.max())
  np.testing.assert_allclose(got, numpy_pagerank(M.astype(np.float64)),
                             rtol=0, atol=tol * want.max())


@pytest.mark.parametrize("flag, count", [("sparse_force_onehot",
                                          "ell_plain_runs"),
                                         ("sparse_force_windowed",
                                          "csr_plain_runs")])
def test_fit_sparse_through_each_kernel_route(flag, count):
  """Under each forcing flag the port's loop takes the kernel route (its
  plain version on the CPU) and the reference its Pallas kernel (interpret
  mode, one-device mesh)."""
  M = ss.csr_matrix(pagerank.make_link_matrix(200).astype(np.float32))
  old = (getattr(FLAGS, flag), getattr(REF_FLAGS, flag))
  setattr(FLAGS, flag, True)
  setattr(REF_FLAGS, flag, True)
  try:
    with ref.with_mesh(ref_mesh.make_mesh(devices=jax.devices()[:1])):
      want = ref_pagerank.fit_sparse(ref_sps.from_scipy(M), ITERS)
    before = KS.counts[count]
    got = pagerank.fit_sparse(sps.from_scipy(M), ITERS)
    assert KS.counts[count] == before + ITERS
  finally:
    setattr(FLAGS, flag, old[0])
    setattr(REF_FLAGS, flag, old[1])
  np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * want.max())


def test_fit_sparse_over_block_ell_matches_reference():
  """Config 5's block-structured shape (here 16 block-rows of 32, 4 blocks a
  row) as a block-ELL matrix: the block route, no kernel."""
  rng = np.random.default_rng(0)
  nb, per_row, bs = 16, 4, 32
  data = rng.random((nb * per_row, bs, bs))
  A = ss.bsr_matrix((data, rng.integers(0, nb, nb * per_row),
                     np.arange(nb + 1) * per_row), shape=(nb * bs,) * 2)
  A = (A.tocsr() @ ss.diags(1.0 / np.maximum(
      np.asarray(A.sum(axis=0)).ravel(), 1e-9))).astype(np.float32)
  RB = ref_sps.from_scipy_bsr(A, bs=bs)
  want = ref_pagerank.fit_sparse(RB, ITERS)
  before = dict(KS.counts)
  got = pagerank.fit_sparse(sp.interop.from_reference(RB), ITERS)
  assert KS.counts == before
  np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * want.max())
  np.testing.assert_allclose(got, numpy_pagerank(A.astype(np.float64)),
                             rtol=0, atol=1e-5 * want.max())
