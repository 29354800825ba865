"""The sharded sparse forms on a mesh of p logical shards of the CPU, against
the reference's shard_map forms on its virtual CPU devices (interpret
mode), case for case with tests/test_kernels.py and tests/test_sparse.py:

* the packs: ``pack_windowed_sharded`` and ``pack_windowed_spmm_sharded``
  cut the rows where the reference's packs do, over views of the CSR form;
* the entry points ``sharded_onehot_spmv`` (K3a sharded),
  ``sharded_windowed_spmv_traced`` (K3d) and
  ``sharded_windowed_spmm_traced`` (K5b), their plain versions here;
* ``unshard_windowed`` for a node built under 4 shards and run under 8;
* the routes ``winsh``/``winmmsh``/sharded ELL under the force flags, one
  plain run a non-empty shard;
* PageRank and ALS under an 8-shard mesh against the reference under its
  8-device mesh.

Tolerances: the port's sharded forms equal its unsharded ones exactly
(each row is summed alone, in the same order).  Against the reference in
float32: 1e-5 of max|y| for SpMV (the reference's kernels split x into
bf16 hi/lo halves), 2e-5 of max|Y| for SpMM, as its own tests hold it;
PageRank 1e-5 of max r, ALS 1e-4 of max|U|, max|V| (tests/test_torch_als.py
states why).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as ss
import torch

from spartan_tpu.backend import sparse as ref_sps
from spartan_tpu.backend.kernels import spmm_pallas as ref_spmm
from spartan_tpu.backend.kernels import spmv_pallas as ref_spmv
from spartan_tpu.config import FLAGS as REF_FLAGS
from spartan_tpu.core import mesh as ref_mesh
from spartan_tpu.examples import als as ref_als
from spartan_tpu.examples import pagerank as ref_pagerank

import spartan_tpu_torch as sp
from spartan_tpu_torch.backend import sparse as sps
from spartan_tpu_torch.backend.kernels import spmm as K5
from spartan_tpu_torch.backend.kernels import spmv as KS
from spartan_tpu_torch.config import FLAGS
from spartan_tpu_torch.examples import als, pagerank

SHARDS = [1, 2, 3, 4, 8]


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


def _mesh(p):
  return sp.make_mesh("cpu", shape=(p,))


def _ref_mesh(p):
  return ref_mesh.make_mesh((p,), ("x",), devices=jax.devices()[:p])


@functools.lru_cache(maxsize=None)
def _matrix(n, m, density, seed):
  """A seeded float32 scipy CSR matrix, drawn once per file (not to be
  changed by a test)."""
  return ss.random(n, m, density=density, random_state=seed, format="csr",
                   dtype=np.float32)


@pytest.fixture
def forced(request):
  """Set one force flag in both packages for the test."""
  names = request.param if isinstance(request.param, tuple) else (
      request.param,)
  saved = [(n, getattr(FLAGS, n), getattr(REF_FLAGS, n)) for n in names]
  for n in names:
    setattr(FLAGS, n, True)
    setattr(REF_FLAGS, n, True)
  yield request.param
  for n, ours, theirs in saved:
    setattr(FLAGS, n, ours)
    setattr(REF_FLAGS, n, theirs)


# -- the packs ------------------------------------------------------------------

@pytest.mark.parametrize("p", SHARDS)
@pytest.mark.parametrize("n, m, density", [(8192, 2048, 0.002),
                                           (5000, 7000, 0.001),
                                           (600, 2048, 0.01)], ids=str)
def test_sharded_packs_cut_rows_where_the_reference_does(n, m, density, p):
  A = _matrix(n, m, density, 11)
  S = sps.from_scipy(A)
  indptr, indices, data = S.to_csr()
  for packed, ref_rows, sharded in (
      (S.to_windowed_sharded(p), ref_spmv.rb_per_of(n, p) * 1024,
       KS.ShardedWindowedELL),
      (S.to_windowed_spmm_sharded(p), K5.rbmm_per_of(n, p) * 128,
       K5.ShardedWindowedSpMM)):
    assert isinstance(packed, sharded)
    assert packed.n_shards == p and packed.rows_per == ref_rows
    assert packed.nnz == A.nnz and packed.shape == (n, m)
    for d, (b_ptr, b_idx, b_data) in enumerate(packed.bands):
      r0, r1 = min(d * ref_rows, n), min(d * ref_rows + ref_rows, n)
      assert packed.rows(d) == (r0, r1)
      lo, hi = A.indptr[r0], A.indptr[r1]
      np.testing.assert_array_equal(b_ptr.numpy(), A.indptr[r0:r1 + 1] - lo)
      # views of the matrix's CSR form, not copies
      assert b_idx.data_ptr() == indices[lo:].data_ptr()
      assert b_data.data_ptr() == data[lo:].data_ptr()
      assert b_idx.shape[0] == hi - lo
  assert S.to_windowed_sharded(p) is S.to_windowed_sharded(p)
  # the reference's pack: the same nonzeros a shard
  ref_pack = ref_spmv.pack_windowed_sharded(A, p)
  per_shard = (np.asarray(ref_pack.vals) != 0).reshape(p, -1).sum(1)
  np.testing.assert_array_equal(
      per_shard, [b[1].shape[0] for b in S.to_windowed_sharded(p).bands])


# -- the entry points against the reference --------------------------------------

@pytest.mark.parametrize("n, m, density, p", [(600, 2048, 0.01, 8),
                                              (3000, 3000, 0.004, 4)],
                         ids=str)
def test_sharded_windowed_spmv_matches_the_reference(n, m, density, p, rng):
  A = _matrix(n, m, density, 11)
  x = rng.standard_normal(m).astype(np.float32)
  pk = ref_spmv.pack_windowed_sharded(A, p)
  want = np.asarray(ref_spmv.sharded_windowed_spmv_traced(
      *(jnp.asarray(a) for a in (pk.rb, pk.win, pk.init, pk.cols_lo,
                                 pk.rows_lo, pk.vals)),
      jnp.asarray(x), shape=pk.shape, mesh=_ref_mesh(p), interpret=True))
  packed = KS.pack_windowed_sharded(A, p)
  xt = torch.as_tensor(x)
  before = KS.counts["sharded_csr_plain_runs"]
  got = KS.sharded_windowed_spmv_traced(packed, xt, _mesh(p))
  assert KS.counts["sharded_csr_plain_runs"] == before + sum(
      packed.rows(d)[1] > packed.rows(d)[0] for d in range(p))
  assert got.shape == (n,) and got.dtype == torch.float32
  assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
  whole = KS.pack_windowed(A)
  assert torch.equal(got, KS.spmv_csr(whole.indptr, whole.indices,
                                      whole.data, xt))
  with pytest.raises(ValueError, match="shards"):
    KS.sharded_windowed_spmv_traced(packed, xt, _mesh(p + 1))


@pytest.mark.parametrize("p", [2, 8])
def test_sharded_onehot_spmv_matches_the_reference(p, rng):
  A = _matrix(700, 700, 0.02, 13)
  S = sps.from_scipy(A)
  x = rng.standard_normal(700).astype(np.float32)
  want = np.asarray(ref_spmv.sharded_onehot_spmv(
      jnp.asarray(S.cols.numpy()), jnp.asarray(S.vals.numpy()),
      jnp.asarray(x), mesh=_ref_mesh(p), interpret=True))
  xt = torch.as_tensor(x)
  before = KS.counts["sharded_ell_plain_runs"]
  got = KS.sharded_onehot_spmv(S.cols, S.vals, xt, _mesh(p))
  assert KS.counts["sharded_ell_plain_runs"] == before + p
  assert got.shape == (700,) and got.dtype == torch.float32
  assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
  assert torch.equal(got, KS.spmv_ell(S.cols, S.vals, xt))
  # bfloat16 values come back in their own dtype
  got16 = KS.sharded_onehot_spmv(S.cols, S.vals.bfloat16(), xt, _mesh(p))
  assert got16.dtype == torch.bfloat16


@pytest.mark.parametrize("p", [2, 8])
def test_sharded_windowed_spmm_matches_the_reference(p, rng):
  A = ss.random(900, 1200, density=0.03, format="csr", dtype=np.float32,
                random_state=np.random.RandomState(21))
  B = rng.standard_normal((1200, 24)).astype(np.float32)
  pk = ref_spmm.pack_windowed_spmm_sharded(A, p)
  want = np.asarray(ref_spmm.sharded_windowed_spmm_traced(
      *(jnp.asarray(a) for a in (pk.rb, pk.win, pk.init, pk.cols_lo,
                                 pk.rows_lo, pk.vals)),
      jnp.asarray(B), shape=pk.shape, mesh=_ref_mesh(p), interpret=True))
  packed = K5.pack_windowed_spmm_sharded(A, p)
  Bt = torch.as_tensor(B)
  before = K5.counts["sharded_plain_runs"]
  got = K5.sharded_windowed_spmm_traced(packed, Bt, _mesh(p))
  assert K5.counts["sharded_plain_runs"] == before + p
  assert got.shape == (900, 24) and got.dtype == torch.float32
  assert np.abs(got.numpy() - want).max() <= 2e-5 * np.abs(want).max()
  csr = sps.from_scipy(A).to_csr()
  assert torch.equal(got, K5.spmm_csr(*csr, Bt))
  assert K5.sharded_windowed_spmm_traced(packed, Bt.double(),
                                         _mesh(p)).dtype == torch.float64


def test_unshard_windowed_at_4_shards_on_a_mesh_of_8(rng):
  """A winsh node built under 4 shards and evaluated under 8 flattens its
  bands back and runs the unsharded kernel, as the reference's does."""
  n = 3000
  A = _matrix(n, n, 0.004, 5)
  x = rng.standard_normal(n).astype(np.float32)
  pk = ref_spmv.pack_windowed_sharded(A, 4)
  *flat, n_pad = ref_spmv.unshard_windowed(
      *(jnp.asarray(a) for a in (pk.rb, pk.win, pk.init, pk.cols_lo,
                                 pk.rows_lo, pk.vals)), n, 4)
  want = np.asarray(ref_spmv.windowed_spmv_traced(
      *flat, jnp.asarray(x), shape=(int(n_pad), n), interpret=True))[:n]
  packed = KS.pack_windowed_sharded(A, 4)
  indptr, indices, data, got_pad = KS.unshard_windowed(packed)
  assert got_pad == int(n_pad) == 4096
  np.testing.assert_array_equal(indptr[:n + 1].numpy(), A.indptr)
  assert int(indptr[-1]) == A.nnz
  saved = FLAGS.sparse_force_windowed
  FLAGS.sparse_force_windowed = True
  try:
    S = sps.from_scipy(A)
    with sp.with_mesh(_mesh(4)):
      e = sps.spmv_expr(S, sp.from_numpy(x))
    assert e.fmt == "winsh" and e.n_shards == 4
    with sp.with_mesh(_mesh(8)):
      before = dict(KS.counts)
      got = e.glom()
      assert KS.counts["csr_plain_runs"] == before["csr_plain_runs"] + 1
      assert KS.counts["sharded_csr_plain_runs"] == before[
          "sharded_csr_plain_runs"]
  finally:
    FLAGS.sparse_force_windowed = saved
  assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
  np.testing.assert_array_equal(
      got, KS.spmv_csr(*S.to_csr(), torch.as_tensor(x)).numpy())


# -- the routes ------------------------------------------------------------------

@pytest.mark.parametrize("p", [2, 3, 4, 8])
@pytest.mark.parametrize("forced, fmt, key", [
    ("sparse_force_windowed", "winsh", "sharded_csr_plain_runs"),
    ("sparse_force_onehot", "ell", "sharded_ell_plain_runs")],
    indirect=["forced"], ids=["winsh", "ell"])
def test_spmv_routes_on_a_mesh(forced, fmt, key, p, rng):
  """Eager spmv and SpMVExpr take one route; each runs its kernel's plain
  version once a shard and equals the one-shard result exactly."""
  A = _matrix(8192, 2000, 0.002, 3)
  S = sps.from_scipy(A)
  x = rng.standard_normal(2000).astype(np.float32)
  want = sps.spmv(S, x).numpy()
  with sp.with_mesh(_mesh(p)):
    e = sps.spmv_expr(S, sp.from_numpy(x))
    assert e.fmt == fmt and e.n_shards == (p if fmt == "winsh" else 0)
    KS.reset_counts()
    eager = sps.spmv(S, x).numpy()
    assert KS.counts[key] == p
    lazy = e.glom()
    assert KS.counts[key] == 2 * p
  np.testing.assert_array_equal(eager, want)
  np.testing.assert_array_equal(lazy, want)
  np.testing.assert_allclose(want, A @ x, rtol=0,
                             atol=1e-5 * np.abs(A @ x).max())


@pytest.mark.parametrize("p", [2, 3, 4, 8])
@pytest.mark.parametrize("forced", ["sparse_force_winmm"], indirect=True)
def test_spmm_route_on_a_mesh(forced, p, rng):
  A = _matrix(3072, 700, 0.005, 4)  # 24 blocks of 128 rows: no empty shard
  S = sps.from_scipy(A)
  B = rng.standard_normal((700, 9)).astype(np.float32)
  want = sps.spmm(S, B).numpy()
  with sp.with_mesh(_mesh(p)):
    e = sps.spmm_expr(S, sp.from_numpy(B))
    assert e.fmt == "winmmsh" and e.n_shards == p
    K5.reset_counts()
    eager = sps.spmm(S, B).numpy()
    lazy = e.glom()
    assert K5.counts["sharded_plain_runs"] == 2 * p
    assert K5.counts["plain_runs"] == 0
  np.testing.assert_array_equal(eager, want)
  np.testing.assert_array_equal(lazy, want)
  # built for 4 shards, run on 8: the unsharded plain version
  with sp.with_mesh(_mesh(4)):
    e4 = sps.spmm_expr(S, sp.from_numpy(B))
  with sp.with_mesh(_mesh(8)):
    np.testing.assert_array_equal(e4.glom(), want)


@pytest.mark.parametrize("p", [3, 8])
def test_ell_routes_on_a_mesh_read_the_matrix_as_it_is(p, rng):
  """No ELL route pads or copies the matrix on a mesh: the plain SpMV
  gather (float64), the SpMM ELL gather and the sharded ELL kernel route
  all read ``A.cols``/``A.vals`` themselves, and give the one-shard
  result."""
  A = _matrix(700, 700, 0.02, 13)
  S = sps.from_scipy(A)
  S64 = sps.from_scipy(A.astype(np.float64))
  x = rng.standard_normal(700).astype(np.float32)
  B = rng.standard_normal((700, 5)).astype(np.float32)
  want = (sps.spmv(S64, x.astype(np.float64)).numpy(), sps.spmm(S, B).numpy())
  saved = FLAGS.sparse_force_onehot
  with sp.with_mesh(_mesh(p)):
    exprs = (sps.spmv_expr(S64, sp.from_numpy(x.astype(np.float64))),
             sps.spmm_expr(S, sp.from_numpy(B)))
    FLAGS.sparse_force_onehot = True
    try:
      exprs += (sps.spmv_expr(S, sp.from_numpy(x)),)
      KS.reset_counts()
      forced = exprs[2].glom()
      assert KS.counts["sharded_ell_plain_runs"] == p
    finally:
      FLAGS.sparse_force_onehot = saved
    got = [e.glom() for e in exprs[:2]]
  for e, M in zip(exprs, (S64, S, S)):
    assert e.fmt == "ell" and e.n_shards == 0
    assert e.inputs[0].value is M.cols and e.inputs[1].value is M.vals
  for g, w in zip(got, want):
    np.testing.assert_array_equal(g, w)
  np.testing.assert_array_equal(forced,
                                KS.spmv_ell(S.cols, S.vals,
                                            torch.as_tensor(x)).numpy())


@pytest.mark.parametrize("n, p", [(700, 3), (10, 8), (9, 4), (1, 2), (64, 8)],
                         ids=str)
def test_sharded_onehot_spmv_bands_are_near_equal(n, p, rng):
  """Shard d owns rows [min(d·ceil(n/p), n), min((d+1)·ceil(n/p), n));
  nothing is padded, an empty band runs nothing, and the result equals
  the unsharded kernel's exactly."""
  A = ss.random(n, 50, density=0.2, format="csr", dtype=np.float32,
                random_state=np.random.RandomState(n))
  S = sps.from_scipy(A)
  x = torch.as_tensor(rng.standard_normal(50).astype(np.float32))
  band = -(-n // p)
  before = KS.counts["sharded_ell_plain_runs"]
  got = KS.sharded_onehot_spmv(S.cols, S.vals, x, _mesh(p))
  assert KS.counts["sharded_ell_plain_runs"] - before == -(-n // band)
  assert got.shape == (n,)
  assert torch.equal(got, KS.spmv_ell(S.cols, S.vals, x))


def test_block_and_dense_routes_stay_unsharded(rng):
  A = _matrix(256, 256, 0.05, 8)
  S = sps.from_scipy(A)
  x = rng.standard_normal(256).astype(np.float32)
  saved = FLAGS.sparse_force_dense
  FLAGS.sparse_force_dense = True
  try:
    with sp.with_mesh(_mesh(4)):
      e = sps.spmv_expr(S, sp.from_numpy(x))
      assert e.fmt == "dense" and e.n_shards == 0
      got = e.glom()
  finally:
    FLAGS.sparse_force_dense = saved
  np.testing.assert_allclose(got, A @ x, rtol=0,
                             atol=1e-5 * np.abs(A @ x).max())


# -- PageRank and ALS on an 8-shard mesh --------------------------------------

ITERS = 10


@pytest.mark.parametrize("forced, key", [
    ("sparse_force_windowed", "sharded_csr_plain_runs"),
    ("sparse_force_onehot", "sharded_ell_plain_runs")],
    indirect=["forced"], ids=["winsh", "ell"])
def test_pagerank_on_8_shards_matches_the_reference(forced, key, cluster):
  n = 1200
  M = ss.csr_matrix(pagerank.make_link_matrix(n).astype(np.float32))
  want = ref_pagerank.fit_sparse(ref_sps.from_scipy(M), ITERS)
  with sp.with_mesh(_mesh(8)):
    KS.reset_counts()
    got = pagerank.fit_sparse(sps.from_scipy(M), ITERS)
    shards = 8 if key == "sharded_ell_plain_runs" else 2  # 1024-row bands
    assert KS.counts[key] == shards * ITERS
  with sp.with_mesh(_mesh(1)):
    one = pagerank.fit_sparse(sps.from_scipy(M), ITERS)
  np.testing.assert_array_equal(got, one)
  np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * want.max())


@pytest.mark.parametrize("forced", ["sparse_force_winmm"], indirect=True)
def test_als_on_8_shards_matches_the_reference(forced, cluster):
  rng = np.random.default_rng(7)
  R = np.where(rng.random((1100, 150)) < 0.1,
               rng.integers(1, 6, (1100, 150)), 0).astype(np.float32)
  U_ref, V_ref = ref_als.fit(ref_sps.from_dense(R), k=4, iterations=3,
                             seed=3)
  with sp.with_mesh(_mesh(8)):
    S = sps.from_dense(R)
    assert sps.spmm_expr(S, sp.ones((150, 4))).fmt == "winmmsh"
    K5.reset_counts()
    U, V = als.fit(S, k=4, iterations=3, seed=3)
    # R @ V: bands of 256 rows, five of them non-empty (the last of 76
    # rows); R.T @ U: bands of 128 rows, two non-empty
    assert K5.counts["sharded_plain_runs"] == 3 * (5 + 2)
  with sp.with_mesh(_mesh(1)):
    U1, V1 = als.fit(sps.from_dense(R), k=4, iterations=3, seed=3)
  np.testing.assert_array_equal(U, U1)
  np.testing.assert_array_equal(V, V1)
  np.testing.assert_allclose(U, U_ref, rtol=0, atol=1e-4 * np.abs(U_ref).max())
  np.testing.assert_allclose(V, V_ref, rtol=0, atol=1e-4 * np.abs(V_ref).max())
