"""``sp.sparse``'s builders in both packages on the same seeded inputs: the
counterparts of the reference's ``tests/test_sparse_construct.py``, each
held to the reference's matrix and to scipy's.

Tolerances: the builders move stored values without arithmetic, so the
port's matrices equal the reference's and scipy's exactly (``kron``
multiplies two float64 values once, exactly as each of them does); sums
through SpMV and ``canonicalize`` are float64 at 1e-12 relative, the
order of a row's few additions being the only difference.
"""

import numpy as np
import pytest
import scipy.sparse as ss
import torch

import spartan_tpu as ref

import spartan_tpu_torch as sp
from spartan_tpu_torch.backend.sparse import SparseArray
from spartan_tpu_torch.sparse_construct import __all__ as PORT_NAMES


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


@pytest.fixture
def rng():
  return np.random.default_rng(7)


def _dense(S):
  return np.asarray(S.todense())


def _rand_sparse(rng, n, m, density=0.2, dtype=np.float64):
  M = ss.random(n, m, density=density, random_state=np.random.RandomState(
      rng.integers(1 << 30)), dtype=dtype)
  M.data[M.data == 0] = 0.5
  return M.tocsr()


def _same(port, refm, want=None):
  """The port's matrix equals the reference's (dense and nnz) and, when
  given, scipy's dense ``want``."""
  assert isinstance(port, SparseArray)
  np.testing.assert_array_equal(_dense(port), _dense(refm))
  assert port.nnz == refm.nnz
  assert port.shape == tuple(refm.shape)
  if want is not None:
    np.testing.assert_array_equal(_dense(port), want)
  # the invariant the kernels' CSR form reads: a pad is (col 0, val 0)
  pads = port.vals == 0
  assert not bool((port.cols[pads] != 0).any())


def test_the_port_has_every_builder_of_the_reference():
  import spartan_tpu.sparse_construct as rsc
  assert sorted(PORT_NAMES) == sorted(rsc.__all__)
  for name in rsc.__all__:
    assert getattr(sp.sparse, name) is not None, name


@pytest.mark.parametrize("m,n,k", [(5, None, 0), (5, 7, 2), (7, 5, -2),
                                   (3, 3, -1), (4, 4, 5)])
def test_eye_variants(m, n, k):
  want = np.eye(m, n, k=k)
  _same(sp.sparse.eye(m, n, k=k), ref.sparse.eye(m, n, k=k), want)


def test_identity():
  got = sp.sparse.identity(6, dtype=np.float32)
  _same(got, ref.sparse.identity(6, dtype=np.float32),
        np.eye(6, dtype=np.float32))
  assert got.dtype == torch.float32


@pytest.mark.parametrize("case", ["multi", "rect", "broadcast"])
def test_diags(case):
  if case == "multi":
    args = ([np.array([1.0, 2, 3, 4]), np.array([5.0, 6, 7]),
             np.array([8.0, 9])], [0, 1, -2])
    kw = {}
  elif case == "rect":
    args = (np.array([1.0, 2, 3, 4]), 1)
    kw = {"shape": (4, 5)}
  else:
    args = ([2.0, -1.0], [0, 1])
    kw = {"shape": (5, 5)}
  _same(sp.sparse.diags(*args, **kw), ref.sparse.diags(*args, **kw),
        ss.diags(*args, **kw).toarray())


def test_diags_contract_errors():
  with pytest.raises(ValueError):  # the exact-length contract
    sp.sparse.diags(np.array([1.0, 2, 3]), 1, shape=(4, 5))
  with pytest.raises(ValueError):
    sp.sparse.diags([[1.0], [2.0]], [0, 0], shape=(2, 2))


@pytest.mark.parametrize("shape", [(4, 4), (3, 4)])
def test_spdiags_matlab_convention(shape):
  data = np.array([[1.0, 2, 3, 4], [5.0, 6, 7, 8], [9.0, 10, 11, 12]])
  offs = [-1, 0, 2]
  _same(sp.sparse.spdiags(data, offs, *shape),
        ref.sparse.spdiags(data, offs, *shape),
        ss.spdiags(data, offs, *shape).toarray())


def test_kron(rng):
  A = _rand_sparse(rng, 5, 4, 0.4)
  B = _rand_sparse(rng, 3, 6, 0.3)
  got = sp.sparse.kron(sp.sparse.from_scipy(A), sp.sparse.from_scipy(B))
  want = ref.sparse.kron(ref.sparse.from_scipy(A), ref.sparse.from_scipy(B))
  _same(got, want, ss.kron(A, B).toarray())
  assert got.max_nnz_per_row == want.cols.shape[1]
  # a dense operand
  got2 = sp.sparse.kron(sp.sparse.from_scipy(A), B.toarray())
  np.testing.assert_array_equal(_dense(got2), ss.kron(A, B).toarray())


def test_kron_feeds_spmv(rng):
  A = _rand_sparse(rng, 4, 4, 0.5)
  B = _rand_sparse(rng, 5, 5, 0.4)
  K = sp.sparse.kron(sp.sparse.from_scipy(A), sp.sparse.from_scipy(B))
  x = rng.standard_normal(20)
  np.testing.assert_allclose(sp.sparse.spmv(K, x).numpy(),
                             ss.kron(A, B) @ x, rtol=1e-12)


def test_kronsum(rng):
  A = _rand_sparse(rng, 4, 4, 0.5)
  B = _rand_sparse(rng, 3, 3, 0.5)
  got = sp.sparse.kronsum(sp.sparse.from_scipy(A), sp.sparse.from_scipy(B))
  want = ref.sparse.kronsum(ref.sparse.from_scipy(A),
                            ref.sparse.from_scipy(B))
  _same(got, want)
  np.testing.assert_allclose(_dense(got), ss.kronsum(A, B).toarray(),
                             rtol=1e-12)
  with pytest.raises(ValueError):
    sp.sparse.kronsum(sp.sparse.from_scipy(_rand_sparse(rng, 3, 4)),
                      sp.sparse.from_scipy(B))


def test_grid_laplacian_by_kronsum_of_diags():
  """The 5-point Laplacian of a grid as phase 20 builds it: its CSR form
  (the one the SpMV kernels read) is scipy's kronsum with the two stored
  diagonals of a row summed."""
  nx, ny = 6, 9
  lx = sp.sparse.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx))
  ly = sp.sparse.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(ny, ny))
  L = sp.sparse.kronsum(lx, ly)
  want = ss.kronsum(ss.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx)),
                    ss.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(ny, ny)))
  assert (L.to_scipy() != want.tocsr()).nnz == 0
  indptr, indices, data = L.to_csr()
  csr = ss.csr_matrix((data.numpy(), indices.numpy(), indptr.numpy()),
                      shape=L.shape)
  np.testing.assert_array_equal(csr.toarray(), want.toarray())
  x = np.random.default_rng(0).standard_normal(nx * ny)
  np.testing.assert_allclose(sp.sparse.spmv(L, x).numpy(), want @ x,
                             rtol=1e-12)


def test_hstack_vstack(rng):
  A = _rand_sparse(rng, 4, 3, 0.5)
  B = _rand_sparse(rng, 4, 5, 0.3)
  C = _rand_sparse(rng, 2, 8, 0.4)
  h = sp.sparse.hstack([sp.sparse.from_scipy(A), sp.sparse.from_scipy(B)])
  rh = ref.sparse.hstack([ref.sparse.from_scipy(A),
                          ref.sparse.from_scipy(B)])
  _same(h, rh, ss.hstack([A, B]).toarray())
  v = sp.sparse.vstack([h, sp.sparse.from_scipy(C)])
  rv = ref.sparse.vstack([rh, ref.sparse.from_scipy(C)])
  _same(v, rv, ss.vstack([ss.hstack([A, B]), C]).toarray())
  with pytest.raises(ValueError):
    sp.sparse.hstack([sp.sparse.from_scipy(A),
                      sp.sparse.from_scipy(_rand_sparse(rng, 5, 3))])


def test_block_diag(rng):
  mats = [_rand_sparse(rng, 3, 4, 0.5), _rand_sparse(rng, 2, 2, 0.8),
          _rand_sparse(rng, 4, 1, 0.9)]
  _same(sp.sparse.block_diag([sp.sparse.from_scipy(m) for m in mats]),
        ref.sparse.block_diag([ref.sparse.from_scipy(m) for m in mats]),
        ss.block_diag(mats).toarray())


def test_bmat_with_none(rng):
  A = _rand_sparse(rng, 3, 4, 0.5)
  B = _rand_sparse(rng, 3, 2, 0.5)
  C = _rand_sparse(rng, 2, 4, 0.5)
  got = sp.sparse.bmat([[sp.sparse.from_scipy(A), sp.sparse.from_scipy(B)],
                        [sp.sparse.from_scipy(C), None]])
  want = ref.sparse.bmat([[ref.sparse.from_scipy(A),
                           ref.sparse.from_scipy(B)],
                          [ref.sparse.from_scipy(C), None]])
  _same(got, want, ss.bmat([[A, B], [C, None]]).toarray())
  with pytest.raises(ValueError):
    sp.sparse.bmat([[None], [None]])


@pytest.mark.parametrize("k", [-2, 0, 1, 3])
def test_tril_triu(rng, k):
  A = _rand_sparse(rng, 6, 6, 0.5)
  SA, RA = sp.sparse.from_scipy(A), ref.sparse.from_scipy(A)
  _same(sp.sparse.tril(SA, k), ref.sparse.tril(RA, k),
        ss.tril(A, k).toarray())
  _same(sp.sparse.triu(SA, k), ref.sparse.triu(RA, k),
        ss.triu(A, k).toarray())


@pytest.mark.parametrize("m,n,density,seed,dtype",
                         [(40, 30, 0.1, 3, np.float64),
                          (40, 30, 0.9, 8, np.float64),  # tops up twice
                          (64, 200, 0.05, 11, np.float32),
                          (1000, 900, 0.002, 5, np.float64),
                          (10, 10, 0.0, 0, np.float64)])
def test_random_equals_the_reference_entry_for_entry(m, n, density, seed,
                                                     dtype):
  """The same random_state gives the reference's matrix: the same ELL
  (columns and values, slot by slot) and exactly round(density·m·n)
  distinct positions in [0, 1)."""
  got = sp.sparse.random(m, n, density=density, random_state=seed,
                         dtype=dtype)
  want = ref.sparse.random(m, n, density=density, random_state=seed,
                           dtype=dtype)
  np.testing.assert_array_equal(got.cols.numpy(), np.asarray(want.cols))
  np.testing.assert_array_equal(got.vals.numpy(), np.asarray(want.vals))
  assert got.nnz == want.nnz == round(density * m * n)
  d = _dense(got)
  assert np.count_nonzero(d) == got.nnz
  assert ((d >= 0) & (d < 1)).all()
  assert got.dtype == torch.float64 if dtype == np.float64 else torch.float32


def test_random_data_rvs_and_rand():
  def rvs(seed):
    g = np.random.default_rng(seed)
    return lambda k: g.standard_normal(k)
  got = sp.sparse.random(20, 20, density=0.2, random_state=1,
                         data_rvs=rvs(0))
  want = ref.sparse.random(20, 20, density=0.2, random_state=1,
                           data_rvs=rvs(0))
  np.testing.assert_array_equal(_dense(got), _dense(want))
  assert got.nnz == round(0.2 * 400)
  np.testing.assert_array_equal(
      _dense(sp.sparse.rand(12, 9, density=0.3, random_state=4)),
      _dense(ref.sparse.rand(12, 9, density=0.3, random_state=4)))


def test_add_sub_and_canonicalize(rng):
  A = _rand_sparse(rng, 5, 6, 0.4)
  B = _rand_sparse(rng, 5, 6, 0.4)
  SA, SB = sp.sparse.from_scipy(A), sp.sparse.from_scipy(B)
  got = SA + SB
  np.testing.assert_allclose(_dense(got), (A + B).toarray())
  np.testing.assert_allclose(_dense(SA - SB), (A - B).toarray())
  x = rng.standard_normal(6)
  np.testing.assert_allclose(sp.sparse.spmv(got, x).numpy(), (A + B) @ x,
                             rtol=1e-12)
  canon = got.canonicalize()
  np.testing.assert_allclose(_dense(canon), (A + B).toarray())
  assert canon.max_nnz_per_row <= got.max_nnz_per_row


def test_issparse(rng):
  assert sp.sparse.issparse(sp.sparse.from_scipy(_rand_sparse(rng, 3, 3)))
  assert not sp.sparse.issparse(np.eye(3))
  assert sp.sparse.isspmatrix is sp.sparse.issparse


@pytest.mark.parametrize("name", ["csr_matrix", "csc_matrix", "coo_matrix",
                                  "dia_matrix", "bsr_matrix", "csr_array",
                                  "csc_array", "coo_array", "bsr_array",
                                  "dia_array"])
def test_format_constructors_all_input_forms(name):
  D = np.array([[1.0, 0, 2], [0, 0, 3], [4, 5, 0]])
  S = ss.csr_matrix(D)
  ctor, rctor = getattr(sp.sparse, name), getattr(ref.sparse, name)
  for arg in (D, S):
    got = ctor(arg)
    _same(got, rctor(arg), D)
    assert got.format == name.split("_")[0]
  assert ctor((3, 4)).nnz == 0 and ctor((3, 4)).shape == (3, 4)


def test_format_constructor_forms_and_tags():
  D = np.array([[1.0, 0, 2], [0, 0, 3], [4, 5, 0]])
  S = ss.csr_matrix(D)
  coo = S.tocoo()
  got = sp.sparse.coo_matrix((coo.data, (coo.row, coo.col)), shape=(3, 3))
  np.testing.assert_array_equal(_dense(got), D)
  assert got.format == "coo"
  got = sp.sparse.csr_matrix((S.data, S.indices, S.indptr), shape=(3, 3))
  np.testing.assert_array_equal(_dense(got), D)
  f32 = sp.sparse.csr_matrix(D, dtype=np.float32)
  assert f32.dtype == torch.float32
  re = sp.sparse.coo_matrix(f32)
  assert re.format == "coo" and f32.format == "csr"
  with pytest.raises(ValueError):
    sp.sparse.csr_matrix(f32, shape=(4, 4))


def test_isspmatrix_predicates():
  A = sp.sparse.csc_matrix(np.eye(3))
  assert sp.sparse.isspmatrix_csc(A) and not sp.sparse.isspmatrix_csr(A)
  assert not sp.sparse.isspmatrix_dok(A) and not sp.sparse.isspmatrix_lil(A)
  assert sp.sparse.issparse(A)
  assert sp.sparse.isspmatrix_csr(sp.sparse.from_dense(np.eye(3)))


def test_find_matches_scipy_and_the_reference(rng):
  M = _rand_sparse(rng, 9, 7)
  got = sp.sparse.find(sp.sparse.csr_matrix(M))
  want = ref.sparse.find(ref.sparse.csr_matrix(M))
  for g, w, s in zip(got, want, ss.find(M)):
    np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(g, s)


def test_npz_crosses_between_the_packages(tmp_path, rng):
  M = _rand_sparse(rng, 8, 8)
  p = str(tmp_path / "port.npz")
  sp.sparse.save_npz(p, sp.sparse.coo_matrix(M))
  back = sp.sparse.load_npz(p)
  np.testing.assert_array_equal(_dense(back), M.toarray())
  assert back.format == "coo"
  np.testing.assert_array_equal(ss.load_npz(p).toarray(), M.toarray())
  np.testing.assert_array_equal(_dense(ref.sparse.load_npz(p)), M.toarray())
  q = str(tmp_path / "ref.npz")
  ref.sparse.save_npz(q, ref.sparse.csc_matrix(M))
  back = sp.sparse.load_npz(q)
  np.testing.assert_array_equal(_dense(back), M.toarray())
  assert back.format == "csc"


def test_array_api_builders():
  _same(sp.sparse.eye_array(4, k=1), ref.sparse.eye_array(4, k=1),
        ss.eye_array(4, k=1).toarray())
  _same(sp.sparse.diags_array([1., 2, 3], offsets=1, shape=(4, 4)),
        ref.sparse.diags_array([1., 2, 3], offsets=1, shape=(4, 4)),
        ss.diags_array([1., 2, 3], offsets=1, shape=(4, 4)).toarray())
  blocks = [[np.eye(2), None], [None, 2 * np.eye(2)]]
  _same(sp.sparse.block_array(blocks), ref.sparse.block_array(blocks),
        ss.block_array([[ss.csr_matrix(np.eye(2)), None],
                        [None, ss.csr_matrix(2 * np.eye(2))]]).toarray())
  R = sp.sparse.random_array((20, 10), density=0.3,
                             rng=np.random.default_rng(3))
  W = ref.sparse.random_array((20, 10), density=0.3,
                              rng=np.random.default_rng(3))
  assert R.shape == (20, 10) and R.nnz == round(0.3 * 200)
  np.testing.assert_array_equal(_dense(R), _dense(W))


def test_sparse_warnings_exist():
  assert issubclass(sp.sparse.SparseEfficiencyWarning,
                    sp.sparse.SparseWarning)


def test_int32_columns_are_checked():
  big = sp.sparse.eye(1, 1 << 20)
  with pytest.raises(ValueError, match="int32"):
    sp.sparse.kron(big, sp.sparse.eye(1, 1 << 12))
