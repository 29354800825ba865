"""ALS (``examples/als.py``) in both packages on the same ratings and seed:
dense and sparse float64 ratings, float32 sparse ratings through the SpMM
kernel route, ``reconstruction_error`` and ``run``.

Tolerances: float64 at atol 1e-9 (the reference's own bar between its
sparse and dense runs, ``tests/test_sparse.py``
``test_als_sparse_matches_dense``).  float32 ratings under
``sparse_force_winmm``: both packages compute ``R @ V`` in float32 (the
reference through bf16 hi/lo halves, within about 1e-5 of max|R V|) and
solve in float64; four iterations of Gram solves with condition numbers
near 10 carry that to the factors, so 1e-4 of max|U| and max|V|.
"""

import jax
import numpy as np
import pytest
import torch

import spartan_tpu as ref
from spartan_tpu.backend import sparse as ref_sps
from spartan_tpu.config import FLAGS as REF_FLAGS
from spartan_tpu.core import mesh as ref_mesh
from spartan_tpu.examples import als as ref_als

import spartan_tpu_torch as sp
from spartan_tpu_torch.backend import sparse as sps
from spartan_tpu_torch.backend.kernels import spmm as K5
from spartan_tpu_torch.config import FLAGS
from spartan_tpu_torch.examples import als

N, M, K, ITERS = 96, 64, 4, 4


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


def ratings(seed=0):
  """Low-rank ratings with 70 % of the entries zeroed (the reference's
  test matrix)."""
  rng = np.random.default_rng(seed)
  dense = rng.standard_normal((N, K)) @ rng.standard_normal((M, K)).T
  dense[rng.random((N, M)) < 0.7] = 0.0
  return dense


def test_fit_dense_matches_reference():
  R = ratings()
  U, V = als.fit(R, k=K, iterations=ITERS, seed=3)
  U_ref, V_ref = ref_als.fit(R, k=K, iterations=ITERS, seed=3)
  assert U.dtype == V.dtype == np.float64
  np.testing.assert_allclose(U, U_ref, rtol=0, atol=1e-9)
  np.testing.assert_allclose(V, V_ref, rtol=0, atol=1e-9)


def test_fit_sparse_float64_matches_reference_and_dense():
  R = ratings(1)
  before = dict(K5.counts)
  U, V = als.fit(sps.from_dense(R), k=K, iterations=ITERS, seed=3)
  assert K5.counts == before  # float64: the plain gather
  U_ref, V_ref = ref_als.fit(ref_sps.from_dense(R), k=K, iterations=ITERS,
                             seed=3)
  U_dense, V_dense = als.fit(R, k=K, iterations=ITERS, seed=3)
  for got, want in ((U, U_ref), (V, V_ref), (U, U_dense), (V, V_dense)):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


def test_fit_float32_sparse_through_the_kernel_route():
  """float32 ratings and float64 factors take the SpMM kernel route in
  both packages (the reference's K5a on one device, in interpret mode;
  the port's plain version of K5a here)."""
  R = ratings(2).astype(np.float32)
  saved = FLAGS.sparse_force_winmm, REF_FLAGS.sparse_force_winmm
  FLAGS.sparse_force_winmm = REF_FLAGS.sparse_force_winmm = True
  try:
    S = sps.from_dense(R)
    assert sps.spmm_expr(S, sp.ones((M, K))).fmt == "winmm"
    before = K5.counts["plain_runs"]
    U, V = als.fit(S, k=K, iterations=ITERS, seed=3)
    assert K5.counts["plain_runs"] == before + 2 * ITERS
    with ref.with_mesh(ref_mesh.make_mesh(devices=jax.devices()[:1])):
      RS = ref_sps.from_dense(R)
      assert ref_sps.spmm_expr(RS, ref.ones((M, K))).fmt == "winmm"
      U_ref, V_ref = ref_als.fit(RS, k=K, iterations=ITERS, seed=3)
  finally:
    FLAGS.sparse_force_winmm, REF_FLAGS.sparse_force_winmm = saved
  np.testing.assert_allclose(U, U_ref, rtol=0, atol=1e-4 * np.abs(U_ref).max())
  np.testing.assert_allclose(V, V_ref, rtol=0, atol=1e-4 * np.abs(V_ref).max())


@pytest.mark.parametrize("sparse", [False, True])
def test_reconstruction_error_matches_reference(sparse):
  R = ratings(3)
  rng = np.random.default_rng(4)
  U, V = rng.standard_normal((N, K)), rng.standard_normal((M, K))
  ours = sps.from_dense(R) if sparse else R
  theirs = ref_sps.from_dense(R) if sparse else R
  got = als.reconstruction_error(ours, U, V)
  want = ref_als.reconstruction_error(theirs, U, V)
  np.testing.assert_allclose(got, want, rtol=1e-10)
  np.testing.assert_allclose(got, np.mean((R - U @ V.T) ** 2), rtol=1e-10)


def test_run_matches_reference():
  U, V, err = als.run(n=64, m=32, k=4, iterations=3, seed=5)
  U_ref, V_ref, err_ref = ref_als.run(n=64, m=32, k=4, iterations=3, seed=5)
  np.testing.assert_allclose(U, U_ref, rtol=0, atol=1e-9)
  np.testing.assert_allclose(V, V_ref, rtol=0, atol=1e-9)
  np.testing.assert_allclose(err, err_ref, rtol=1e-9)
