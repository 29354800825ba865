"""The spectral solvers, the densified functions, ``LaplacianNd`` and the host
boundaries of ``sp.sparse.linalg`` in both packages on the same seeded
inputs: the counterparts of the reference's ``tests/test_sparse_linalg.py``
from ``test_eigsh_which_modes`` on, each held to the reference and to
scipy or a dense oracle; then the port's own pins: the SpMVs of a solve
with the kernel route forced (K3a's plain version, and K3a sharded's and
K3d's on a mesh of four shards), a float32 operator's basis kept in
float32, the host runs of the host boundaries.

Tolerances: eigenvalues against the reference 1e-10 in float64 (the same
recurrence from the same start vector; the Ritz values of a converged
solve agree to the residual bound, 1e-13 of the scale, times a gap ratio
below 100 here); eigenvectors by their subspace's projector (a repeated or
close eigenvalue leaves the basis free inside it); against scipy the
reference test's bound; float32 solves within ``F32`` = 1e-5 of the
spectral scale, eigsh's own float32 residual tolerance.
"""

import numpy as np
import pytest
import scipy.linalg as sla
import scipy.sparse as ss
import scipy.sparse.linalg as ssl
import torch

import spartan_tpu as ref
import spartan_tpu.sparse_linalg as rspl

import spartan_tpu_torch as sp
from spartan_tpu_torch import sparse_linalg as spl
from spartan_tpu_torch.backend.kernels import spmv as KS
from spartan_tpu_torch.config import FLAGS
from spartan_tpu_torch.expr import fio
from spartan_tpu_torch.expr import loop as loop_mod

F32 = 1e-5


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


@pytest.fixture
def rng():
  return np.random.default_rng(42)


def _x(v) -> np.ndarray:
  return np.asarray(sp.lazify(v).glom())


def _rx(v) -> np.ndarray:
  return np.asarray(ref.lazify(v).glom())


def _sparse_spd(n, density=0.05, seed=2):
  G = ss.random(n, n, density=density,
                random_state=np.random.RandomState(seed), format="csr")
  A = (G + G.T).tocsr()
  A = A + ss.diags(np.asarray(np.abs(A).sum(axis=1)).ravel() + 1.0)
  return A.tocsr()


def _sym_spectrum(rng, n, lo=-5.0, hi=5.0):
  Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
  lam = np.linspace(lo, hi, n)
  A = (Q * lam) @ Q.T
  return (A + A.T) / 2, lam


def _same_subspace(V, W, tol):
  """The column spaces of V and W (orthonormalized) agree: their
  projectors differ by at most ``tol``."""
  qv, _ = np.linalg.qr(np.real(V))
  qw, _ = np.linalg.qr(np.real(W))
  assert np.abs(qv @ qv.T - qw @ qw.T).max() < tol


def test_eigsh_which_modes(rng):
  n = 128
  M = rng.standard_normal((n, n))
  A = (M + M.T) / 2
  wt = np.linalg.eigvalsh(A)
  w, v = spl.eigsh(A, k=4, which="LM", ncv=60)
  wr, vr = rspl.eigsh(A, k=4, which="LM", ncv=60)
  want = np.sort(wt[np.argsort(np.abs(wt))[-4:]])
  np.testing.assert_allclose(w, want, atol=1e-9)
  np.testing.assert_allclose(w, wr, atol=1e-10)
  vv = _x(v)
  assert np.abs(A @ vv - vv * w).max() < 1e-5 * np.abs(w).max()
  assert np.abs(vv.T @ vv - np.eye(4)).max() < 1e-10
  _same_subspace(vv, _rx(vr), 1e-8)
  for which, k, want in (("SA", 3, wt[:3]), ("LA", 3, wt[-3:])):
    w2, _ = spl.eigsh(A, k=k, which=which, ncv=60)
    np.testing.assert_allclose(w2, want, atol=1e-9)
    np.testing.assert_allclose(
        w2, rspl.eigsh(A, k=k, which=which, ncv=60)[0], atol=1e-10)
  with pytest.raises(ValueError, match="which"):
    spl.eigsh(A, k=3, which="XX", ncv=60, maxiter=1)
  with pytest.raises(ValueError, match="ncv"):
    spl.eigsh(A, k=30, ncv=20)


def test_eigsh_matvec_only_operator():
  n = 96
  d = np.linspace(1.0, 5.0, n)
  op = spl.LinearOperator((n, n), lambda x: sp.lazify(d) * x)
  w, v = spl.eigsh(op, k=2, which="LA", ncv=48)
  np.testing.assert_allclose(w, d[-2:], atol=1e-8)
  rop = rspl.LinearOperator((n, n), lambda x: ref.lazify(d) * x)
  np.testing.assert_allclose(w, rspl.eigsh(rop, k=2, which="LA", ncv=48)[0],
                             atol=1e-10)


def test_eigs_nonsymmetric_krylov_schur(rng):
  n = 256
  B = rng.standard_normal((n, n))
  w, v = spl.eigs(B, k=3, ncv=20, maxiter=80)
  assert w.dtype.kind == "c" and v.shape == (n, 3)
  assert np.abs(B @ v - v * w).max() < 1e-8
  assert spl.stats["cycles"] > 1  # the Krylov-Schur restarts engaged
  wt = np.linalg.eigvals(B)
  want = np.sort(np.abs(wt))[-3:]
  np.testing.assert_allclose(np.sort(np.abs(w)), want, atol=1e-9)
  wr, _ = rspl.eigs(B, k=3, ncv=20, maxiter=80)
  np.testing.assert_allclose(np.sort_complex(w), np.sort_complex(wr),
                             atol=1e-9)
  w2, v2 = spl.eigs(B, k=2, which="LA", ncv=20, maxiter=80)
  assert np.abs(B @ v2 - v2 * w2).max() < 1e-8
  np.testing.assert_allclose(np.sort(w2.real), np.sort(wt.real)[-2:],
                             atol=1e-9)


def test_svds_tall_and_wide(rng):
  X = rng.standard_normal((150, 80))
  u, s, vt = spl.svds(X, k=4, ncv=60)
  st = np.linalg.svd(X, compute_uv=False)
  np.testing.assert_allclose(s, np.sort(st[:4]), atol=1e-9)
  np.testing.assert_allclose(s, rspl.svds(X, k=4, ncv=60)[1], atol=1e-10)
  uu, vvt = _x(u), _x(vt)
  assert np.abs(X @ vvt.T - uu * s).max() < 1e-7
  assert np.abs(X.T @ uu - vvt.T * s).max() < 1e-7
  u2, s2, vt2 = spl.svds(X.T, k=3, ncv=60)
  np.testing.assert_allclose(s2, np.sort(st[:3]), atol=1e-9)
  assert _x(u2).shape == (80, 3)
  assert _x(vt2).shape == (3, 150)
  with pytest.raises(ValueError, match="rmatvec"):
    spl.svds(spl.LinearOperator((5, 5), lambda v: v), k=2)


def test_expm_multiply(rng):
  n = 150
  A = rng.standard_normal((n, n)) / np.sqrt(n)
  v = rng.standard_normal(n)
  got = _x(spl.expm_multiply(A, v, t=1.2, ncv=40))
  want = sla.expm(1.2 * A) @ v
  assert np.abs(got - want).max() / np.abs(want).max() < 1e-12
  rgot = _rx(rspl.expm_multiply(A, v, t=1.2, ncv=40))
  assert np.abs(got - rgot).max() / np.abs(want).max() < 1e-12
  G = ss.random(n, n, density=0.05,
                random_state=np.random.RandomState(1), format="csr") / 3
  S = sp.sparse.from_scipy(G.tocsr())
  B = rng.standard_normal((n, 2))
  got2 = _x(spl.expm_multiply(S, B, t=0.7, ncv=40))
  want2 = sla.expm(0.7 * G.toarray()) @ B
  assert np.abs(got2 - want2).max() / np.abs(want2).max() < 1e-12
  assert np.abs(_x(spl.expm_multiply(A, np.zeros(n)))).max() == 0.0
  with pytest.raises(ValueError, match="incompatible"):
    spl.expm_multiply(A, np.ones(n + 1))


def test_eigsh_shift_invert_dense_lu(rng):
  A, _ = _sym_spectrum(rng, 200)
  for sigma in (0.3, -2.7):
    w, v = spl.eigsh(A, k=4, sigma=sigma)
    ww, _ = ssl.eigsh(A, k=4, sigma=sigma)
    np.testing.assert_allclose(np.sort(w), np.sort(ww), atol=1e-10)
    np.testing.assert_allclose(w, rspl.eigsh(A, k=4, sigma=sigma)[0],
                               atol=1e-10)
    vn = _x(v)
    assert np.abs(A @ vn - vn * w).max() < 1e-9
    np.testing.assert_allclose(vn.T @ vn, np.eye(4), atol=1e-10)


def test_eigsh_shift_invert_iterative_inner_solve(rng):
  A, _ = _sym_spectrum(rng, 160)
  w, _ = spl.eigsh(A, k=3, sigma=0.1, mode="iterative")
  ww, _ = ssl.eigsh(A, k=3, sigma=0.1)
  np.testing.assert_allclose(np.sort(w), np.sort(ww), atol=1e-8)
  assert not spl.stats["fused"]  # each matvec a minres solve
  np.testing.assert_allclose(
      w, rspl.eigsh(A, k=3, sigma=0.1, mode="iterative")[0], atol=1e-8)
  with pytest.raises(ValueError, match="mode"):
    spl.eigsh(A, k=3, sigma=0.1, mode="exact")


def test_eigsh_shift_invert_sparse_and_which_sm():
  A = _sparse_spd(300)
  S = sp.sparse.from_scipy(A)
  w, _ = spl.eigsh(S, k=3, sigma=0.0)
  ww, _ = ssl.eigsh(A, k=3, sigma=0.0)
  np.testing.assert_allclose(np.sort(w), np.sort(ww), atol=1e-9)
  np.testing.assert_allclose(
      w, rspl.eigsh(ref.sparse.from_scipy(A), k=3, sigma=0.0)[0], atol=1e-10)


def test_eigsh_opinv_override(rng):
  A, _ = _sym_spectrum(rng, 120)
  sigma = 0.5
  inv = np.linalg.inv(A - sigma * np.eye(120))
  w, _ = spl.eigsh(A, k=3, sigma=sigma, OPinv=inv)
  ww, _ = ssl.eigsh(A, k=3, sigma=sigma)
  np.testing.assert_allclose(np.sort(w), np.sort(ww), atol=1e-9)


def test_eigs_shift_invert(rng):
  n = 150
  B = rng.standard_normal((n, n)) * 0.3 + np.diag(np.linspace(1, 10, n))
  w, v = spl.eigs(B, k=3, sigma=4.0)
  ww, _ = ssl.eigs(B, k=3, sigma=4.0)
  assert np.abs(np.sort(w.real) - np.sort(ww.real)).max() < 1e-9
  assert np.abs(np.sort(w.imag) - np.sort(ww.imag)).max() < 1e-9
  wr, _ = rspl.eigs(B, k=3, sigma=4.0)
  np.testing.assert_allclose(np.sort_complex(w), np.sort_complex(wr),
                             atol=1e-9)
  assert np.abs(B @ v - v * w).max() < 1e-7
  with pytest.raises(ValueError):
    spl.eigs(B, k=2, sigma=1.0 + 2.0j)


def test_svds_smallest(rng):
  A = rng.standard_normal((120, 80))
  u, s, vt = spl.svds(A, k=3, which="SM")
  sw = np.sort(np.linalg.svd(A, compute_uv=False))[:3]
  np.testing.assert_allclose(np.sort(s), sw, atol=1e-9)
  np.testing.assert_allclose(s, rspl.svds(A, k=3, which="SM")[1], atol=1e-10)
  un, vn = _x(u), _x(vt)
  assert np.abs(A @ vn.T - un * s).max() < 1e-9
  Ad = A[:, :40] @ rng.standard_normal((40, 80))  # rank <= 40
  _, s2, _ = spl.svds(Ad, k=2, which="SM")
  np.testing.assert_allclose(s2, 0.0, atol=1e-6)
  # a sparse operand and a matrix-free one
  Sp = ss.random(90, 60, density=0.2, random_state=np.random.RandomState(4),
                 format="csr") + ss.eye(90, 60)
  _, s3, _ = spl.svds(sp.sparse.from_scipy(Sp.tocsr()), k=2, which="SM")
  np.testing.assert_allclose(
      s3, np.sort(np.linalg.svd(Sp.toarray(), compute_uv=False))[:2],
      atol=1e-9)
  op = spl.aslinearoperator(A)
  lo = spl.LinearOperator(op.shape, op.matvec, op.rmatvec, dtype=np.float64)
  _, s4, _ = spl.svds(lo, k=2, which="SM")
  np.testing.assert_allclose(s4, sw[:2], atol=1e-7)
  with pytest.raises(ValueError):
    spl.svds(A, k=2, which="XX")


def test_eigsh_fused_restart_matches_driver_path(rng, monkeypatch):
  n = 256
  M = rng.standard_normal((n, n))
  A = (M + M.T) / 2
  wt = np.linalg.eigvalsh(A)
  assert FLAGS.eigsh_fused_restart  # on by default
  w_f, v_f = spl.eigsh(A, k=4, which="SA", ncv=32)
  fused = dict(spl.stats)
  monkeypatch.setattr(FLAGS, "eigsh_fused_restart", False)
  w_d, v_d = spl.eigsh(A, k=4, which="SA", ncv=32)
  driver = dict(spl.stats)
  np.testing.assert_allclose(w_f, wt[:4], atol=1e-9)
  np.testing.assert_allclose(w_d, wt[:4], atol=1e-9)
  np.testing.assert_allclose(w_f, w_d, atol=1e-10)
  assert fused["fused"] and not driver["fused"]
  assert fused["cycles"] == driver["cycles"] > 1
  assert fused["steps"] == driver["steps"]
  vf = _x(v_f)
  assert np.abs(A @ vf - vf * w_f).max() < 1e-6 * np.abs(wt).max()
  _same_subspace(vf, _x(v_d), 1e-8)
  np.testing.assert_allclose(w_f, rspl.eigsh(A, k=4, which="SA", ncv=32)[0],
                             atol=1e-10)


def test_eigsh_fused_runner_is_cached(rng):
  n = 96
  M = rng.standard_normal((n, n))
  A = (M + M.T) / 2
  spl.eigsh(A, k=3, ncv=24)
  n_keys = sum(1 for k in loop_mod._runner_cache if k[0] == "eigsh_tr")
  assert n_keys >= 1
  B = A + np.eye(n)  # the same structure, other values: the step reused
  w, _ = spl.eigsh(B, k=3, ncv=24)
  n_keys2 = sum(1 for k in loop_mod._runner_cache if k[0] == "eigsh_tr")
  assert n_keys2 == n_keys
  wt = np.linalg.eigvalsh(B)
  np.testing.assert_allclose(w, np.sort(wt[np.argsort(np.abs(wt))[-3:]]),
                             atol=1e-9)


def test_eigsh_fused_breakdown_low_rank(rng):
  """An invariant subspace met inside a cycle (a rank-3 operator): the
  dead columns' masking keeps spurious Ritz pairs out."""
  n = 64
  U = np.linalg.qr(rng.standard_normal((n, 3)))[0]
  A = U @ np.diag([5.0, 3.0, 2.0]) @ U.T
  w, v = spl.eigsh(A, k=2, which="LM", ncv=20)
  np.testing.assert_allclose(w, [3.0, 5.0], atol=1e-8)
  vv = _x(v)
  assert np.abs(A @ vv - vv * w).max() < 1e-8
  np.testing.assert_allclose(w, rspl.eigsh(A, k=2, which="LM", ncv=20)[0],
                             atol=1e-10)


def test_sparse_expm_inv_power_triangular(rng):
  S = _sparse_spd(24) * 0.05
  Ssp = sp.sparse.csr_matrix(S)
  Sr = ref.sparse.csr_matrix(S)
  got = _x(spl.expm(Ssp))
  np.testing.assert_allclose(got, ssl.expm(S.tocsc()).toarray(), atol=1e-9)
  np.testing.assert_allclose(got, _rx(rspl.expm(Sr)), atol=1e-12)
  np.testing.assert_allclose(_x(spl.inv(Ssp)), np.linalg.inv(S.toarray()),
                             atol=1e-8)
  np.testing.assert_allclose(_x(spl.matrix_power(Ssp, 3)),
                             np.linalg.matrix_power(S.toarray(), 3),
                             atol=1e-10)
  np.testing.assert_allclose(_x(spl.matrix_power(Ssp, 3)),
                             _rx(rspl.matrix_power(Sr, 3)), atol=1e-14)
  T = np.tril(rng.standard_normal((16, 16))) + 8 * np.eye(16)
  bb = rng.standard_normal(16)
  Ts = sp.sparse.csr_matrix(ss.csr_matrix(T))
  np.testing.assert_allclose(_x(spl.spsolve_triangular(Ts, bb)),
                             ssl.spsolve_triangular(ss.csr_matrix(T), bb),
                             atol=1e-9)
  U = sp.sparse.csr_matrix(ss.csr_matrix(T.T))
  np.testing.assert_allclose(
      _x(spl.spsolve_triangular(U, bb, lower=False)),
      ssl.spsolve_triangular(ss.csr_matrix(T.T), bb, lower=False), atol=1e-9)
  Tu = np.tril(T, -1) + np.eye(16) * 7  # the diagonal taken as ones
  np.testing.assert_allclose(
      _x(spl.spsolve_triangular(sp.sparse.csr_matrix(ss.csr_matrix(Tu)),
                                bb, unit_diagonal=True)),
      ssl.spsolve_triangular(ss.csr_matrix(Tu), bb, unit_diagonal=True),
      atol=1e-9)
  # a dense operand passes through
  np.testing.assert_allclose(_x(spl.inv(T)), np.linalg.inv(T), atol=1e-12)


def test_structure_probes():
  T = ss.csr_matrix(np.tril(np.ones((6, 6))))
  assert spl.is_sptriangular(sp.sparse.csr_matrix(T)) == (True, False)
  assert spl.is_sptriangular(T.T.tocsr()) == (False, True)
  D = ss.diags([np.ones(5), np.ones(6), np.ones(3)], [-1, 0, 3]).tocsr()
  assert spl.spbandwidth(sp.sparse.csr_matrix(D)) == (1, 3)
  assert spl.spbandwidth(D) == rspl.spbandwidth(ref.sparse.csr_matrix(D))
  if hasattr(ss.linalg, "spbandwidth"):  # scipy >= 1.15
    assert spl.spbandwidth(D) == ss.linalg.spbandwidth(D)
    assert spl.is_sptriangular(D) == ss.linalg.is_sptriangular(D)
  assert spl.is_sptriangular(sp.sparse.eye(4)) == (True, True)


@pytest.mark.parametrize("bc", ["neumann", "dirichlet", "periodic"])
def test_laplacian_nd_matches_scipy(rng, bc):
  for shape in ((4, 5), (3, 2, 6), (2,)):
    ours = spl.LaplacianNd(shape, boundary_conditions=bc)
    want = ssl.LaplacianNd(shape, boundary_conditions=bc)
    n = int(np.prod(shape))
    np.testing.assert_allclose(ours.toarray(), want.toarray(), atol=1e-12)
    np.testing.assert_allclose(ours.eigenvalues(), want.eigenvalues(),
                               atol=1e-10)
    v = rng.standard_normal(n)
    got = _x(ours.matvec(v))
    np.testing.assert_allclose(got, want.toarray() @ v, atol=1e-12)
    rl = rspl.LaplacianNd(shape, boundary_conditions=bc)
    np.testing.assert_allclose(got, _rx(rl.matvec(v)), atol=1e-12)
    np.testing.assert_allclose(_x(ours.rmatvec(v)), got, atol=0)
    np.testing.assert_allclose(ours.tosparse().todense(), want.toarray(),
                               atol=1e-12)
  v32 = rng.standard_normal(20).astype(np.float32)
  ours_32 = spl.LaplacianNd((4, 5), boundary_conditions=bc)
  assert _x(ours_32.matvec(v32)).dtype == np.float32
  ours = spl.LaplacianNd((6,), boundary_conditions=bc)
  want = ssl.LaplacianNd((6,), boundary_conditions=bc)
  np.testing.assert_allclose(ours.eigenvalues(2), want.eigenvalues(2),
                             atol=1e-12)
  with pytest.raises(ValueError, match="boundary"):
    spl.LaplacianNd((3,), boundary_conditions="robin")


def test_eigsh_on_laplacian_nd_agrees_with_its_eigenvalues():
  """eigsh on a rectangular grid's Laplacian (its eigenvalues distinct at
  the top) against the closed form, float64."""
  L = spl.LaplacianNd((12, 17), boundary_conditions="dirichlet",
                      dtype=np.float64)
  w, v = spl.eigsh(L, k=4, which="LA", ncv=40, maxiter=60)
  np.testing.assert_allclose(w, L.eigenvalues(4), atol=1e-10)
  vv = _x(v)
  Ld = L.toarray()
  assert np.abs(Ld @ vv - vv * w).max() < 1e-8


def test_host_boundary_superlu_family(rng):
  S = _sparse_spd(32)
  Ssp = sp.sparse.csr_matrix(S)
  before = fio.counts["host_runs"]
  lu = spl.splu(Ssp)
  assert isinstance(lu, spl.SuperLU)
  b = rng.standard_normal(32)
  np.testing.assert_allclose(lu.solve(b), np.linalg.solve(S.toarray(), b),
                             atol=1e-8)
  ilu = spl.spilu(Ssp, drop_tol=0.0)
  np.testing.assert_allclose(ilu.solve(b), np.linalg.solve(S.toarray(), b),
                             atol=1e-8)
  solve = spl.factorized(Ssp)
  np.testing.assert_allclose(solve(b), np.linalg.solve(S.toarray(), b),
                             atol=1e-8)
  est = spl.onenormest(Ssp)
  assert abs(est - np.abs(S.toarray()).sum(axis=0).max()) < 1e-8
  x, info = spl.lgmres(Ssp, b, rtol=1e-10)
  assert info == 0
  np.testing.assert_allclose(x, np.linalg.solve(S.toarray(), b), atol=1e-6)
  x2, info2 = spl.gcrotmk(Ssp, b, rtol=1e-10)
  assert info2 == 0
  np.testing.assert_allclose(x2, np.linalg.solve(S.toarray(), b), atol=1e-6)
  lam, V = spl.lobpcg(Ssp, rng.standard_normal((32, 3)), tol=1e-9,
                      maxiter=200)
  wl = np.linalg.eigvalsh(S.toarray())[-3:]
  np.testing.assert_allclose(np.sort(lam), wl, rtol=1e-5)
  assert fio.counts["host_runs"] == before + 7


def test_funm_multiply_krylov_is_scipy_or_its_attribute_error(monkeypatch):
  """The host boundary calls scipy's own function; where the installed
  scipy lacks it, scipy's AttributeError comes out and nothing else
  runs."""
  S = _sparse_spd(40)
  b = np.ones(40)
  if hasattr(ssl, "funm_multiply_krylov"):
    got = spl.funm_multiply_krylov(sla.expm, sp.sparse.csr_matrix(S * 0.01),
                                   b, assume_a="her")
    np.testing.assert_allclose(got, sla.expm(S.toarray() * 0.01) @ b,
                               rtol=1e-6)
    monkeypatch.delattr(ssl, "funm_multiply_krylov")
  with pytest.raises(AttributeError):
    spl.funm_multiply_krylov(sla.expm, S, b)


def test_arpack_classes_and_use_solver():
  err = spl.ArpackNoConvergence("no conv", np.ones(2), np.eye(2))
  assert isinstance(err, spl.ArpackError)
  assert err.eigenvalues.shape == (2,) and err.info == -1
  assert spl.ArpackError(3).info == 3
  assert issubclass(spl.MatrixRankWarning, UserWarning)
  assert spl.use_solver(useUmfpack=False) is None


def _grid_laplacian(nx, ny):
  d = [-1.0, 2.0, -1.0]
  return ss.kronsum(ss.diags(d, [-1, 0, 1], shape=(nx, nx)),
                    ss.diags(d, [-1, 0, 1], shape=(ny, ny))).tocsr()


def test_float32_eigsh_keeps_its_basis_float32_on_the_forced_kernel(
    monkeypatch):
  """A float32 sparse operator: the basis stays float32 (the Arnoldi step's
  carries keep their dtype, or the loop raises), each step one SpMV on the
  ELL kernel route (its plain version here, counted), eigsh's launches
  = the Arnoldi steps it reports; the Ritz values within F32 of the scale
  of a float64 solve's."""
  A = _grid_laplacian(10, 13)
  S = sp.sparse.from_scipy(A.astype(np.float32))
  monkeypatch.setattr(FLAGS, "sparse_force_onehot", True)
  KS.reset_counts()
  w, v = spl.eigsh(S, k=3, which="LA", ncv=24, maxiter=60)
  assert v.dtype == torch.float32
  st = dict(spl.stats)
  assert st["fused"] and st["steps"] >= 24
  assert KS.counts["ell_plain_runs"] == st["steps"]
  assert KS.counts["ell_launches"] == 0
  wt = np.linalg.eigvalsh(A.toarray())
  np.testing.assert_allclose(w, wt[-3:], rtol=0, atol=F32 * wt[-1] * 10)
  vv = _x(v).astype(np.float64)
  assert np.abs(A @ vv - vv * w).max() < 10 * F32 * wt[-1]
  # the host-paced restarts: the same steps, the same SpMVs
  monkeypatch.setattr(FLAGS, "eigsh_fused_restart", False)
  KS.reset_counts()
  w_d, _ = spl.eigsh(S, k=3, which="LA", ncv=24, maxiter=60)
  assert KS.counts["ell_plain_runs"] == spl.stats["steps"]
  np.testing.assert_allclose(w_d, w, atol=F32 * wt[-1] * 10)
  # eigs and expm_multiply keep the operator's float32 too
  KS.reset_counts()
  we, _ = spl.eigs(S, k=2, which="LA", ncv=24, maxiter=60)
  assert KS.counts["ell_plain_runs"] == spl.stats["steps"]
  np.testing.assert_allclose(np.sort(we.real), wt[-2:],
                             atol=F32 * wt[-1] * 10)
  KS.reset_counts()
  y = spl.expm_multiply(S, np.ones(130, np.float32), t=-0.1, ncv=20)
  assert y.dtype == torch.float32 and KS.counts["ell_plain_runs"] == 20
  np.testing.assert_allclose(
      _x(y), sla.expm(-0.1 * A.toarray()) @ np.ones(130), rtol=1e-5)


@pytest.mark.parametrize("force", ["sparse_force_onehot",
                                   "sparse_force_windowed"])
def test_eigsh_on_a_mesh_of_four_shards(monkeypatch, force):
  """On a mesh of 4 shards a float32 sparse operator's steps take the
  sharded kernel routes, one SpMV a step: K3a sharded's plain version runs
  once a shard, K3d's once a non-empty band of 1024 rows (3840 rows: 4 of
  each); the pairs agree with one shard's and with the closed form."""
  nx, ny = 48, 80
  A = _grid_laplacian(nx, ny)
  w1, _ = spl.eigsh(sp.sparse.from_scipy(A.astype(np.float32)), k=3,
                    which="LA", ncv=24, maxiter=60)
  monkeypatch.setattr(FLAGS, force, True)
  key = {"sparse_force_onehot": "sharded_ell_plain_runs",
         "sparse_force_windowed": "sharded_csr_plain_runs"}[force]
  with sp.with_mesh(sp.make_mesh("cpu", shape=(4,))):
    S = sp.sparse.from_scipy(A.astype(np.float32))
    KS.reset_counts()
    w, _ = spl.eigsh(S, k=3, which="LA", ncv=24, maxiter=60)
    assert KS.counts[key] == 4 * spl.stats["steps"] > 0
  lx = 2 - 2 * np.cos(np.arange(1, nx + 1) * np.pi / (nx + 1))
  ly = 2 - 2 * np.cos(np.arange(1, ny + 1) * np.pi / (ny + 1))
  top = np.sort((lx[:, None] + ly[None, :]).ravel())[-3:]
  np.testing.assert_allclose(w, w1, atol=F32 * top[-1])
  np.testing.assert_allclose(w, top, atol=10 * F32 * top[-1])


def test_svds_keeps_the_sparse_operand_and_its_transpose(monkeypatch):
  """svds of a float32 sparse matrix: ``A x`` on the ELL route (fewer than
  32768 columns) and ``Aᵀ y`` through the transpose built once and kept
  with A for the whole solve; two SpMVs an Arnoldi step, k more for the
  other side's vectors."""
  R = ss.random(300, 120, density=0.05, random_state=np.random.RandomState(3),
                format="csr", dtype=np.float64)
  S = sp.sparse.from_scipy(R.astype(np.float32))
  monkeypatch.setattr(FLAGS, "sparse_force_onehot", True)
  KS.reset_counts()
  u, s, vt = spl.svds(S, k=4)
  steps = spl.stats["steps"]
  assert KS.counts["ell_plain_runs"] == 2 * steps + 4
  assert S._t_cache is not None and S.T is S.transpose()
  st = np.linalg.svd(R.toarray(), compute_uv=False)
  np.testing.assert_allclose(s, np.sort(st[:4]), rtol=0,
                             atol=10 * F32 * st[0])
  uu, vv = _x(u).astype(np.float64), _x(vt).astype(np.float64)
  assert np.abs(R @ vv.T - uu * s).max() < 10 * F32 * st[0]


def test_coverage_of_the_reference_names():
  assert sorted(spl.__all__) == sorted(rspl.__all__)
  for name in spl.__all__:
    assert hasattr(spl, name), name
