"""The port's sparse arrays against the reference's (``spartan_tpu.backend.
sparse``) on the same seeded scipy matrices: construction, conversions
(``to_scipy``, ``transpose``, ``canonicalize`` on the device), block
structure and the block route, the densified route, the ``sp.dot``
dispatch, the fmt each SpMV expr takes, the scipy-style elementwise
surface, ``merge_csr`` and ``save_sparse``/``load_sparse``.

Tolerances: layouts (ELL ``cols``/``vals``, block-ELL buffers, dense
forms, elementwise results) are compared exactly; float64 sums and
products at rtol 1e-10 (sums in another order); float32 products at 1e-5
of max|y| (float32 sums in another order; the reference's TPU-shaped
kernels split x into bf16 halves, about 3e-6 relative).
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
  """Set a flag in both packages; restored afterwards."""
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
  """The reference on a one-device mesh, where it takes the
  single-device kernel forms the port's kernels replace."""
  with ref.with_mesh(ref_mesh.make_mesh(devices=jax.devices()[:1])):
    yield


def matrix(kind: str, dtype=np.float64):
  if kind == "random":
    A = ss.random(60, 45, density=0.1, random_state=1, format="csr")
  elif kind == "empty_rows":
    A = ss.random(50, 70, density=0.08, random_state=2, format="lil")
    A[10:25, :] = 0
    A = A.tocsr()
  elif kind == "skewed":
    A = ss.random(40, 40, density=0.05, random_state=3, format="lil")
    A[3, :] = np.arange(1, 41)
    A = A.tocsr()
  elif kind == "blocks":
    rng = np.random.default_rng(4)
    data = rng.random((8, 16, 16))
    A = ss.bsr_matrix((data, rng.integers(0, 4, 8), np.arange(5) * 2),
                      shape=(64, 64)).tocsr()
  else:
    raise ValueError(kind)
  return A.astype(dtype)


KINDS = ["random", "empty_rows", "skewed", "blocks"]


def host(t):
  return t.detach().cpu().numpy()


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=str)
@pytest.mark.parametrize("kind", KINDS)
def test_from_scipy_matches_reference(kind, dtype):
  A = matrix(kind, dtype)
  want = ref_sps.from_scipy(A)
  got = sps.from_scipy(A)
  np.testing.assert_array_equal(host(got.cols), np.asarray(want.cols))
  np.testing.assert_array_equal(host(got.vals), np.asarray(want.vals))
  assert got.vals.dtype == sp.core.array.to_torch_dtype(dtype)
  assert got.cols.dtype == torch.int32
  assert (got.shape, got.nnz, got.max_nnz_per_row, got.format) == (
      want.shape, want.nnz, want.max_nnz_per_row, want.format)
  assert got.density == want.density
  assert got.cols.device == sp.get_mesh().device


@pytest.mark.parametrize("kind", KINDS)
def test_conversions_round_trip(kind):
  A = matrix(kind)
  S = sps.from_scipy(A)
  np.testing.assert_array_equal(S.todense(), A.toarray())
  np.testing.assert_array_equal(S.toarray(), ref_sps.from_scipy(A).todense())
  assert (S.to_scipy() != A).nnz == 0
  assert (S.tocsr() != A).nnz == 0
  coo = S.tocoo()
  assert coo.format == "coo" and (coo.tocsr() != A).nnz == 0


@pytest.mark.parametrize("name", ["from_coo", "from_dense", "sprandn",
                                  "sparse_rand", "sparse_diagonal"])
def test_constructors_match_reference(name):
  rng = np.random.default_rng(5)
  if name == "from_coo":
    r, c = rng.integers(0, 30, 80), rng.integers(0, 20, 80)
    args = (r, c, rng.standard_normal(80), (30, 20))
  elif name == "from_dense":
    args = (rng.standard_normal((25, 35)), 0.8)
  elif name in ("sprandn", "sparse_rand"):
    args = (40, 30, 0.05, 11)
  else:
    args = (rng.standard_normal(17),)
  want = getattr(ref_sps, name)(*args)
  got = getattr(sps, name)(*args)
  np.testing.assert_array_equal(got.todense(), want.todense())
  assert (got.shape, got.nnz, got.max_nnz_per_row) == (
      want.shape, want.nnz, want.max_nnz_per_row)


def test_transpose_is_memoized_and_matches_reference():
  A = matrix("skewed")
  S = sps.from_scipy(A)
  assert S.T is S.transpose() and S.T.T is S
  np.testing.assert_array_equal(S.T.todense(), A.T.toarray())
  np.testing.assert_array_equal(host(S.T.cols),
                                np.asarray(ref_sps.from_scipy(A).T.cols))


def test_canonicalize_astype_copy_repr():
  A = matrix("random")
  doubled = ref_sps.from_scipy(A) + ref_sps.from_scipy(A)  # duplicates
  S2 = sp.interop.from_reference(doubled)
  assert S2.nnz == 2 * A.nnz
  np.testing.assert_array_equal(S2.todense(), 2 * A.toarray())
  canon = S2.canonicalize()
  want = doubled.canonicalize()
  np.testing.assert_array_equal(host(canon.cols), np.asarray(want.cols))
  np.testing.assert_array_equal(host(canon.vals), np.asarray(want.vals))
  S = sps.from_scipy(A)
  f32 = S.astype(np.float32)
  assert f32.dtype == torch.float32 and S.dtype == torch.float64
  c = S.copy()
  c.vals.zero_()
  assert S.todense().any() and not c.todense().any()
  assert repr(S) == (f"SparseArray(shape={A.shape}, nnz={A.nnz}, "
                     f"max_nnz/row={S.max_nnz_per_row}, dtype=torch.float64)")
  assert S.__array_ufunc__ is None


def test_interop_carries_sparse_arrays():
  A = matrix("blocks")
  R = ref_sps.from_scipy(A)
  R.fmt = "coo"
  S = sp.interop.from_reference(R)
  assert isinstance(S, sps.SparseArray) and S.format == "coo"
  np.testing.assert_array_equal(host(S.vals), np.asarray(R.vals))
  RB = ref_sps.from_scipy_bsr(A, bs=16)
  B = sp.interop.from_reference(RB)
  assert isinstance(B, sps.BlockSparseArray)
  assert (B.shape, B.bs, B.nnz_blocks) == (RB.shape, RB.bs, RB.nnz_blocks)
  np.testing.assert_array_equal(B.todense(), RB.todense())


@pytest.mark.parametrize("bs", [16, 32])
@pytest.mark.parametrize("kind", ["blocks", "random"])
def test_block_stats_and_auto_route_match_reference(kind, bs):
  A = matrix(kind)
  R, S = ref_sps.from_scipy(A), sps.from_scipy(A)
  assert S.block_stats(bs) == R.block_stats(bs)
  want, got = R.auto_route(bs), S.auto_route(bs)
  assert (got is None) == (want is None)
  assert S.auto_route(bs) is got  # decided once per block size
  if want is not None:
    np.testing.assert_array_equal(host(got.block_cols),
                                  np.asarray(want.block_cols))
    np.testing.assert_array_equal(host(got.block_vals),
                                  np.asarray(want.block_vals))
    np.testing.assert_array_equal(got.todense(), want.todense())


def test_auto_route_obeys_its_flag(flags):
  S = sps.from_scipy(matrix("blocks"))
  flags("sparse_auto_bsr", False)
  assert S.auto_route(16) is None


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=str)
def test_bsr_spmv_matches_reference(dtype):
  A = matrix("blocks", dtype)
  x = np.random.default_rng(6).standard_normal(64).astype(dtype)
  want = np.asarray(ref_sps.bsr_spmv(ref_sps.from_scipy_bsr(A, bs=16), x))
  got = host(sps.bsr_spmv(sps.from_scipy_bsr(A, bs=16), x))
  assert got.dtype == want.dtype
  rtol = 1e-10 if dtype == np.float64 else 1e-5
  np.testing.assert_allclose(got, want, rtol=0,
                             atol=rtol * np.abs(want).max())


def test_bsr_spmv_checks_dims():
  B = sps.from_scipy_bsr(matrix("blocks"), bs=16)
  with pytest.raises(ValueError, match="dim mismatch"):
    sps.bsr_spmv(B, np.ones(63))


@pytest.mark.parametrize("via", ["eager", "expr"])
def test_densified_route_under_force_dense(flags, via):
  flags("sparse_force_dense", True)
  A = matrix("random", np.float32)
  x = np.random.default_rng(7).standard_normal(45).astype(np.float32)
  R, S = ref_sps.from_scipy(A), sps.from_scipy(A)
  np.testing.assert_array_equal(host(S.to_densified()), A.toarray())
  assert S.to_densified() is S.to_densified()
  if via == "eager":
    want, got = np.asarray(ref_sps.spmv(R, x)), host(sps.spmv(S, x))
  else:
    e_ref = ref_sps.spmv_expr(R, ref.from_numpy(x))
    e = sps.spmv_expr(S, sp.from_numpy(x))
    assert e.fmt == e_ref.fmt == "dense"
    want, got = np.asarray(e_ref.glom()), e.glom()
  assert got.dtype == want.dtype == np.float32
  np.testing.assert_allclose(got, want, rtol=0,
                             atol=1e-5 * np.abs(want).max())


def test_dense_route_stays_off_for_float64_and_on_the_cpu(flags):
  S32 = sps.from_scipy(matrix("random", np.float32))
  S64 = sps.from_scipy(matrix("random"))
  assert S32.density > FLAGS.sparse_dense_min_density_spmv
  assert not sps._dense_routable(S32)  # dense enough, but CPU
  flags("sparse_force_dense", True)
  assert sps._dense_routable(S32)
  assert not sps._dense_routable(S64)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=str)
def test_dot_dispatch_matches_reference(dtype):
  A = matrix("skewed", dtype)
  rng = np.random.default_rng(8)
  v = rng.standard_normal(40).astype(dtype)
  R, S = ref_sps.from_scipy(A), sps.from_scipy(A)
  tol = (1e-10 if dtype == np.float64 else 1e-5)
  cases = [(ref.dot(R, ref.from_numpy(v)), sp.dot(S, sp.from_numpy(v))),
           (ref.dot(ref.from_numpy(v), R), sp.dot(sp.from_numpy(v), S)),
           (R @ ref.from_numpy(v), S @ sp.from_numpy(v)),
           (v @ R, v @ S),
           (R.dot(ref.from_numpy(v)), S.dot(sp.from_numpy(v)))]
  for want, got in cases:
    assert isinstance(got, sps.SpMVExpr)
    w, g = np.asarray(want.glom()), got.glom()
    assert g.dtype == w.dtype
    np.testing.assert_allclose(g, w, rtol=0, atol=tol * np.abs(w).max())


def test_dot_refuses_what_is_not_ported():
  """What stays refused now that matrices take SpMM: dense @ block-ELL,
  sparse @ sparse and an unknown precision."""
  S = sps.from_scipy(matrix("blocks"))
  B = sps.from_scipy_bsr(matrix("blocks"), bs=16)
  assert isinstance(sp.dot(S, sp.from_numpy(np.ones((64, 3)))),
                    sps.SpMMExpr)
  assert sp.dot(sp.from_numpy(np.ones((3, 64))), S).shape == (3, 64)
  with pytest.raises(TypeError, match="BlockSparseArray"):
    sp.dot(sp.from_numpy(np.ones(64)), B)
  with pytest.raises(TypeError, match="sparse @ sparse"):
    S @ S
  with pytest.raises(ValueError, match="precision"):
    sps.SpMVExpr(S, np.ones(64), precision="fast")


@pytest.mark.parametrize("case", ["default", "force_windowed", "force_dense",
                                  "exact_precision", "float64"])
def test_fmt_chosen_as_the_reference_chooses_it(case, flags, one_device):
  dtype = np.float64 if case == "float64" else np.float32
  A = matrix("random", dtype)
  x = np.random.default_rng(9).standard_normal(45).astype(dtype)
  precision = "highest" if case == "exact_precision" else None
  if case in ("force_windowed", "exact_precision", "float64"):
    flags("sparse_force_windowed", True)
  if case == "force_dense":
    flags("sparse_force_dense", True)
  R, S = ref_sps.from_scipy(A), sps.from_scipy(A)
  e_ref = ref_sps.SpMVExpr(R, ref.from_numpy(x), precision=precision)
  e = sps.SpMVExpr(S, sp.from_numpy(x), precision=precision)
  assert e.fmt == e_ref.fmt
  assert (e.n_rows, e.pad_m, e.bs, e.n_shards) == (
      e_ref.n_rows, e_ref.pad_m, e_ref.bs, e_ref.n_shards)
  want, got = np.asarray(e_ref.glom()), e.glom()
  assert got.dtype == want.dtype
  tol = 1e-10 if dtype == np.float64 else 1e-5
  np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("fmt_flag", [None, "sparse_force_windowed",
                                      "sparse_force_dense"])
def test_shape_inference_reaches_no_kernel(flags, fmt_flag):
  if fmt_flag:
    flags(fmt_flag, True)
  S = sps.from_scipy(matrix("random", np.float32))
  before = dict(KS.counts)
  e = sps.spmv_expr(S, sp.ones((45,), dtype=np.float32) * 2)
  assert (e.shape, e.dtype) == ((60,), torch.float32)
  assert KS.counts == before


# -- conversions on the device: empty rows, explicit zeros, duplicates ----------------

def with_explicit_zeros():
  """Empty rows and stored zeros (kept by from_scipy, dropped by
  to_scipy in both packages)."""
  A = matrix("empty_rows")
  A.data[::5] = 0.0
  assert A.nnz > np.count_nonzero(A.data)
  return A


@pytest.mark.parametrize("kind", ["empty_rows", "explicit_zeros", "duplicates"])
def test_device_conversions_match_reference(kind):
  if kind == "duplicates":  # ELLs side by side: repeated coordinates
    A = matrix("skewed")
    R = ref_sps.from_scipy(A) + ref_sps.from_scipy(A * 3)
    S = sps.from_scipy(A) + sps.from_scipy(A * 3)
  else:
    A = matrix("empty_rows") if kind == "empty_rows" else with_explicit_zeros()
    R, S = ref_sps.from_scipy(A), sps.from_scipy(A)
  want, got = R.to_scipy(), S.to_scipy()
  for name in ("indptr", "indices", "data"):
    np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
  assert got.shape == want.shape and got.has_canonical_format
  for mine, theirs in ((S.T, R.T), (S.canonicalize(), R.canonicalize())):
    np.testing.assert_array_equal(host(mine.cols), np.asarray(theirs.cols))
    np.testing.assert_array_equal(host(mine.vals), np.asarray(theirs.vals))
    assert (mine.shape, mine.nnz) == (theirs.shape, theirs.nnz)
  assert S.T.T is S and S.T.cols.device == S.cols.device


def test_cancelled_duplicates_stay_stored_as_scipy_keeps_them():
  A = matrix("random")
  R = ref_sps.from_scipy(A) + (-ref_sps.from_scipy(A))
  S = sps.from_scipy(A) + (-sps.from_scipy(A))
  assert S.canonicalize().nnz == R.canonicalize().nnz == A.nnz
  got, want = S.to_scipy(), R.to_scipy()
  assert got.nnz == want.nnz == A.nnz and not got.data.any()
  np.testing.assert_array_equal(got.indices, want.indices)


# -- the scipy-style elementwise surface ----------------------------------------------

def operands(A):
  """Dense operands of A's shape, a row, a column and their NaN/Inf
  variants (non-finite values where the ELL pads read: column 0)."""
  n, m = A.shape
  rng = np.random.default_rng(10)
  full = rng.standard_normal((n, m))
  bad = full.copy()
  bad[:, 0] = np.inf
  bad[::2, 0] = np.nan
  row = rng.standard_normal(m)
  bad_row = row.copy()
  bad_row[0] = np.inf
  return {"full": full, "row": row[None, :], "vec": row,
          "col": rng.standard_normal((n, 1)), "bad": bad,
          "bad_row": bad_row}


SURFACE = {
    "sum": lambda S, T, d: S.sum(),
    "sum0": lambda S, T, d: S.sum(0),
    "sum1": lambda S, T, d: S.sum(1),
    "sum-1": lambda S, T, d: S.sum(-1),
    "mean": lambda S, T, d: S.mean(),
    "mean0": lambda S, T, d: S.mean(0),
    "mean1": lambda S, T, d: S.mean(1),
    "getnnz": lambda S, T, d: S.getnnz(),
    "getnnz0": lambda S, T, d: S.getnnz(0),
    "count_nonzero1": lambda S, T, d: S.count_nonzero(1),
    "diagonal": lambda S, T, d: S.diagonal(),
    "diagonal2": lambda S, T, d: S.diagonal(2),
    "diagonal-3": lambda S, T, d: S.diagonal(-3),
    "diagonal_outside": lambda S, T, d: S.diagonal(1000),
    "mul_scalar": lambda S, T, d: S * 2.5,
    "rmul_scalar": lambda S, T, d: 2.5 * S,
    "multiply_dense": lambda S, T, d: S.multiply(d["full"]),
    "multiply_row": lambda S, T, d: S.multiply(d["row"]),
    "multiply_vec": lambda S, T, d: S.multiply(d["vec"]),
    "multiply_col": lambda S, T, d: S.multiply(d["col"]),
    "multiply_sparse": lambda S, T, d: S.multiply(T),
    "multiply_nan_inf": lambda S, T, d: S.multiply(d["bad"]),
    "multiply_inf_row": lambda S, T, d: S.multiply(d["bad_row"]),
    "mul_inf": lambda S, T, d: S * np.inf,
    "div": lambda S, T, d: S / 4.0,
    "div_by_zero": lambda S, T, d: S / 0.0,
    "power2": lambda S, T, d: S.power(2),
    "power_half": lambda S, T, d: abs(S).power(0.5),
    "sqrt": lambda S, T, d: abs(S).sqrt(),
    "sqrt_negative": lambda S, T, d: S.sqrt(),
    "abs": lambda S, T, d: abs(S),
    "neg": lambda S, T, d: -S,
    "astype": lambda S, T, d: S.astype(np.float32),
    "add_sparse": lambda S, T, d: S + T,
    "add_zero": lambda S, T, d: S + 0,
    "add_dense": lambda S, T, d: S + d["full"],
    "add_nan_inf": lambda S, T, d: S + d["bad"],
    "radd_dense": lambda S, T, d: d["full"] + S,
    "sub_sparse": lambda S, T, d: S - T,
    "sub_zero": lambda S, T, d: S - 0,
    "sub_dense": lambda S, T, d: S - d["full"],
    "rsub_dense": lambda S, T, d: d["full"] - S,
}


def same(got, want):
  """Sparse results: the layout exactly, values within rtol 1e-15 (sqrt and
  fractional powers differ by an ulp between XLA and torch); dense ones at
  rtol 1e-10 (sums in another order); NaN where the reference has NaN."""
  if isinstance(want, ref_sps.SparseArray):
    assert isinstance(got, sps.SparseArray)
    assert (got.shape, got.nnz) == (want.shape, want.nnz)
    np.testing.assert_array_equal(host(got.cols), np.asarray(want.cols))
    w = np.asarray(want.vals)
    np.testing.assert_allclose(host(got.vals), w, rtol=1e-15, atol=0,
                               equal_nan=True)
    assert host(got.vals).dtype == w.dtype
    return
  g = host(got) if isinstance(got, torch.Tensor) else np.asarray(got)
  w = np.asarray(want)
  assert g.shape == w.shape and g.dtype == w.dtype
  np.testing.assert_allclose(g, w, rtol=1e-10, atol=0, equal_nan=True)


@pytest.mark.parametrize("kind", ["random", "empty_rows", "skewed"])
@pytest.mark.parametrize("op", sorted(SURFACE))
def test_surface_matches_reference(op, kind):
  A = matrix(kind)
  other = ss.random(*A.shape, density=0.1, random_state=11, format="csr")
  d = operands(A)
  want = SURFACE[op](ref_sps.from_scipy(A), ref_sps.from_scipy(other), d)
  got = SURFACE[op](sps.from_scipy(A), sps.from_scipy(other), d)
  same(got, want)
  if isinstance(got, sps.SparseArray):  # the 0-pad invariant holds
    pads = host(got.vals) == 0
    assert (host(got.cols)[pads] == 0).all() or op.startswith(("add", "sub"))
    assert np.isfinite(host(got.vals)[~np.isnan(host(got.vals))]).all() or (
        op in ("mul_inf", "div_by_zero", "multiply_nan_inf",
               "multiply_inf_row"))


def test_surface_refuses_as_the_reference_does():
  A = matrix("random")
  S = sps.from_scipy(A)
  with pytest.raises(ValueError, match="axis"):
    S.sum(2)
  with pytest.raises(ValueError, match="axis"):
    S.getnnz(5)
  with pytest.raises(ValueError, match="p > 0"):
    S.power(0)
  with pytest.raises(TypeError, match="scalars"):
    S / np.ones(A.shape)
  with pytest.raises(NotImplementedError, match="densify"):
    S + 1.0
  with pytest.raises(ValueError, match="shape mismatch"):
    S + sps.from_scipy(matrix("skewed"))
  with pytest.raises(ValueError, match="shape mismatch"):
    S + np.ones((3, 3))
  with pytest.raises(ValueError, match="inconsistent shapes"):
    S.multiply(np.ones((3, 3)))


# -- merge_csr and save/load ------------------------------------------------------------

def test_merge_csr_matches_reference():
  a, b = matrix("random"), ss.random(60, 45, density=0.2, random_state=12,
                                     format="csr")
  got, want = sps.merge_csr(a, b), ref_sps.merge_csr(a, b)
  assert got.format == "csr" and got.shape == want.shape
  np.testing.assert_allclose(got.toarray(), want.toarray(), rtol=1e-15)
  np.testing.assert_array_equal(got.toarray(), (a + b).toarray())
  with pytest.raises(ValueError, match="shape mismatch"):
    sps.merge_csr(a, matrix("skewed"))


def _same_ell(got, want):
  np.testing.assert_array_equal(host(got.cols), np.asarray(want.cols))
  np.testing.assert_array_equal(host(got.vals), np.asarray(want.vals))
  assert (got.shape, got.nnz) == (tuple(want.shape), want.nnz)


def test_reference_save_loads_in_the_port(tmp_path):
  """A directory the reference saved, with its block-ELL repack and its
  windowed TPU pack, loads in the port (the pack is ignored)."""
  A = matrix("blocks")
  R = ref_sps.from_scipy(A)
  assert R.auto_route(16) is not None
  R.to_windowed()
  ref_sps.save_sparse(R, str(tmp_path / "a"))
  assert (tmp_path / "a" / "windowed.npz").exists()
  S = sps.load_sparse(str(tmp_path / "a"))
  _same_ell(S, R)
  bs, blocks = S._bsr_cache
  assert bs == 16 and blocks.nnz_blocks == R._bsr_cache[1].nnz_blocks
  np.testing.assert_array_equal(blocks.todense(), R._bsr_cache[1].todense())
  assert S.cols.device == sp.get_mesh().device
  ref_sps.save_sparse(R._bsr_cache[1], str(tmp_path / "b"))
  B = sps.load_sparse(str(tmp_path / "b"))
  assert isinstance(B, sps.BlockSparseArray)
  np.testing.assert_array_equal(B.todense(), A.toarray())


def test_port_save_round_trips_and_loads_in_the_reference(tmp_path):
  A = matrix("blocks")
  S = sps.from_scipy(A)
  assert S.auto_route(16) is not None
  sps.save_sparse(S, str(tmp_path / "a"))
  assert not (tmp_path / "a" / "windowed.npz").exists()
  back = sps.load_sparse(str(tmp_path / "a"))
  np.testing.assert_array_equal(host(back.cols), host(S.cols))
  np.testing.assert_array_equal(host(back.vals), host(S.vals))
  assert (back.shape, back.nnz, back.dtype) == (S.shape, S.nnz, S.dtype)
  np.testing.assert_array_equal(back._bsr_cache[1].todense(), A.toarray())
  theirs = ref_sps.load_sparse(str(tmp_path / "a"))
  _same_ell(back, theirs)
  np.testing.assert_array_equal(theirs._bsr_cache[1].todense(), A.toarray())
  sps.save_sparse(back._bsr_cache[1], str(tmp_path / "b"))
  blocks = sps.load_sparse(str(tmp_path / "b"))
  assert isinstance(blocks, sps.BlockSparseArray) and blocks.bs == 16
  np.testing.assert_array_equal(blocks.todense(), A.toarray())
