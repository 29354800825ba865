"""``sp.scipy_linalg`` of the port against the reference's and scipy's on the
same seeded float64 inputs: the counterparts of the reference's
``tests/test_scipy_linalg.py`` (its ``grad`` test waits for the port's
autodiff), the reference's parity audit replaced by the exact name list,
and the port's own pins: scipy's 0-based pivots from ``lu_factor``, the
matrix-function gate and its counts, the host runs of the host boundaries.

Tolerances, relative to max|want|: 1e-10 against the reference where both
compute the same function in float64 on inputs of condition number below
1e3 (the two round differently, by κ · 1e-16 at most); the reference
test's own bound against scipy; where a bound is looser it is stated
beside the check.
"""

import numpy as np
import pytest
import scipy.linalg as sla
import torch

import spartan_tpu as ref

import spartan_tpu_torch as sp
from spartan_tpu_torch import scipy_linalg as L
from spartan_tpu_torch.expr import fio
from spartan_tpu_torch.expr.base import Expr
from spartan_tpu_torch.expr.fio import HostExpr

R = ref.scipy_linalg

# the reference test's module-level draws, in its order
rng = np.random.default_rng(42)
A = rng.normal(size=(16, 16))
S = A @ A.T + 16 * np.eye(16)
B = rng.normal(size=(16, 16))
b = rng.normal(size=16)


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


def g(x):
  return np.asarray(sp.lazify(x).glom())


def rg(x):
  return np.asarray(ref.lazify(x).glom())


def close(got, want, tol):
  got = got if isinstance(got, np.ndarray) else g(got)
  want = np.asarray(want)
  assert got.shape == want.shape, (got.shape, want.shape)
  denom = np.max(np.abs(want)) + 1e-30
  err = np.max(np.abs(got - want)) / denom if want.size else 0.0
  assert err < tol, err


def both(name, *args, tol=1e-10, **kw):
  """``name`` in both packages on the same inputs, held to each other;
  returns the port's value."""
  got = g(getattr(L, name)(*args, **kw))
  close(got, rg(getattr(R, name)(*args, **kw)), tol)
  return got


def test_expm_and_action():
  close(both("expm", 0.1 * A), sla.expm(0.1 * A), 1e-11)
  assert sp.linalg.expm is L.expm


def test_expm_frechet():
  E = np.random.default_rng(1).normal(size=(16, 16))
  eA, fr = L.expm_frechet(0.05 * A, E)
  reA, rfr = R.expm_frechet(0.05 * A, E)
  eAw, frw = sla.expm_frechet(0.05 * A, E)
  close(eA, rg(reA), 1e-10)
  close(fr, rg(rfr), 1e-10)
  close(eA, eAw, 1e-10)
  close(fr, frw, 1e-8)


def test_lu_reconstruction():
  p, l, u = L.lu(A)
  close(sp.dot(sp.dot(p, l), u), A, 1e-12)
  rp, rl, ru = R.lu(A)
  for got, want in ((p, rp), (l, rl), (u, ru)):
    close(got, rg(want), 1e-12)  # the same pivoting, unique factors
  pl, u2 = L.lu(A, permute_l=True)
  close(sp.dot(pl, u2), A, 1e-12)
  close(pl, rg(R.lu(A, permute_l=True)[0]), 1e-12)


def test_lu_factor_solve_with_zero_based_pivots():
  lu_, piv = L.lu_factor(A)
  rlu, rpiv = R.lu_factor(A)
  wlu, wpiv = sla.lu_factor(A)
  pv = g(piv)
  # scipy's 0-based pivots, as the reference returns them (torch's own
  # are LAPACK's 1-based); none reaches past the last row
  assert pv.dtype == np.int32 and pv.min() >= 0 and pv.max() < 16
  np.testing.assert_array_equal(pv, rg(rpiv))
  np.testing.assert_array_equal(pv, wpiv)
  close(lu_, wlu, 1e-12)
  close(lu_, rg(rlu), 1e-12)
  x = L.lu_solve((lu_, piv), b)
  close(x, np.linalg.solve(A, b), 1e-10)
  close(x, rg(R.lu_solve((rlu, rpiv), b)), 1e-10)
  bm = rng.normal(size=(16, 3))
  close(L.lu_solve((lu_, piv), bm), np.linalg.solve(A, bm), 1e-10)
  # scipy's own factors solve through the port, and trans 1 and 2
  close(L.lu_solve((wlu, wpiv), b), np.linalg.solve(A, b), 1e-10)
  for trans in (1, 2):
    close(L.lu_solve((lu_, piv), b, trans=trans), np.linalg.solve(A.T, b),
          1e-10)
  Ac = A + 1j * B
  luc, pivc = L.lu_factor(Ac)
  bc = b + 0.5j * b[::-1]
  for trans, M in ((0, Ac), (1, Ac.T), (2, Ac.conj().T)):
    close(L.lu_solve((luc, pivc), bc, trans=trans), np.linalg.solve(M, bc),
          1e-10)
  with pytest.raises(ValueError, match="trans"):
    L.lu_solve((lu_, piv), b, trans=3)


def test_cho_factor_solve():
  c = L.cho_factor(S, lower=True)
  assert c[1] is True
  close(L.cho_solve(c, b), np.linalg.solve(S, b), 1e-10)
  close(L.cho_solve(c, b), rg(R.cho_solve(R.cho_factor(S, lower=True), b)),
        1e-10)
  c2 = L.cho_factor(S)  # upper (scipy's default)
  close(L.cho_solve(c2, b), np.linalg.solve(S, b), 1e-10)
  # the meaningful triangle is the Cholesky factor of scipy's
  close(np.triu(g(c2[0])), np.triu(sla.cho_factor(S)[0]), 1e-12)
  close(np.tril(g(c[0])), np.tril(sla.cho_factor(S, lower=True)[0]), 1e-12)


def test_polar():
  u, p = L.polar(A)
  close(sp.dot(u, p), A, 1e-9)
  un = g(u)
  assert np.allclose(un.T @ un, np.eye(16), atol=1e-9)
  # unique for a full-rank A: jax's QDWH reaches the same factors to its
  # own iteration's tolerance
  ru, rp = R.polar(A)
  close(u, rg(ru), 1e-9)
  close(p, rg(rp), 1e-9)
  close(u, sla.polar(A)[0], 1e-10)
  T = rng.normal(size=(8, 20))
  u2, p2 = L.polar(T, side="left")
  close(sp.dot(p2, u2), T, 1e-9)
  close(p2, sla.polar(T, side="left")[1], 1e-10)
  # any shape on either side, as scipy's (jax's QDWH limits them)
  u3, p3 = L.polar(T, side="right")
  close(sp.dot(u3, p3), T, 1e-9)
  with pytest.raises(ValueError, match="side"):
    L.polar(A, side="up")


def test_eigh_tridiagonal():
  d, e = rng.normal(size=12), rng.normal(size=11)
  close(both("eigh_tridiagonal", d, e),
        sla.eigh_tridiagonal(d, e, eigvals_only=True), 1e-10)


def test_block_diag_khatri_rao():
  close(both("block_diag", A, B[:3, :3], b[None, :4], tol=1e-14),
        sla.block_diag(A, B[:3, :3], b[None, :4]), 1e-14)
  close(both("khatri_rao", A[:3], B[:5], tol=1e-14),
        sla.khatri_rao(A[:3], B[:5]), 1e-14)
  assert g(L.block_diag()).shape == (1, 0)
  close(L.block_diag(b[:3], b[3:5]), sla.block_diag(b[:3], b[3:5]), 1e-14)


def test_pinvh():
  close(both("pinvh", S), sla.pinvh(S), 1e-9)
  Rk = A[:, :5] @ A[:, :5].T  # rank 5: the cut decides
  close(both("pinvh", Rk, tol=1e-8), sla.pinvh(Rk), 1e-8)


def test_structured_constructors():
  c1, r1 = rng.normal(size=7), rng.normal(size=5)
  for name, args, want in [
      ("toeplitz", (c1, r1), sla.toeplitz(c1, r1)),
      ("toeplitz", (c1,), sla.toeplitz(c1)),
      ("circulant", (c1,), sla.circulant(c1)),
      ("hankel", (c1, r1), sla.hankel(c1, r1)),
      ("hankel", (c1,), sla.hankel(c1)),
      ("companion", (np.array([2., 3, 4, 5]),),
       sla.companion(np.array([2., 3, 4, 5]))),
      ("fiedler", (c1,), sla.fiedler(c1)),
      ("fiedler_companion", (np.array([1., 2, 3, 4]),),
       sla.fiedler_companion(np.array([1., 2, 3, 4]))),
      ("hilbert", (9,), sla.hilbert(9)),
      ("helmert", (6,), sla.helmert(6)),
      ("leslie", (c1[:4], np.abs(c1[:3])),
       sla.leslie(c1[:4], np.abs(c1[:3])))]:
    close(both(name, *args, tol=1e-14), want, 1e-14)
  close(both("invhilbert", 6, tol=1e-12), sla.invhilbert(6), 1e-12)
  close(both("pascal", 7, tol=1e-14), sla.pascal(7), 1e-14)  # exact ints
  close(g(L.dft(5)), sla.dft(5), 1e-14)
  for mode in ("full", "same", "valid"):
    close(both("convolution_matrix", c1, 10, mode, tol=1e-14),
          sla.convolution_matrix(c1, 10, mode), 1e-14)


def test_convolution_matrix_matches_convolve():
  a, v = rng.normal(size=6), rng.normal(size=9)
  for mode in ("full", "same", "valid"):
    close(sp.dot(L.convolution_matrix(a, 9, mode), v),
          np.convolve(a, v, mode), 1e-13)


def test_diagnostics():
  for M in (np.triu(A), np.tril(A, 2), np.eye(4), np.diag(b[:5], -2)):
    assert L.bandwidth(M) == R.bandwidth(M) == sla.bandwidth(M)
  assert L.bandwidth(np.triu(A)) == (0, 15)
  assert L.bandwidth(np.tril(A, 2)) == (15, 2)
  assert L.issymmetric(S) and not L.issymmetric(A)
  assert L.ishermitian(S)
  assert L.issymmetric(S + 1e-12 * A, atol=1e-10)
  assert not L.issymmetric(S + 1e-6 * A, atol=1e-10)
  assert L.issymmetric(S + 1e-12 * A, rtol=1e-12)


def test_schur_family():
  t, z = L.schur(A)
  close(sp.dot(sp.dot(z, t), sp.transpose(z)), A, 1e-12)
  close(t, sla.schur(A)[0], 1e-12)  # scipy's own call on the host
  h, q = L.hessenberg(A, calc_q=True)
  close(sp.dot(sp.dot(q, h), sp.transpose(q)), A, 1e-12)
  close(L.hessenberg(A), sla.hessenberg(A), 1e-12)
  close(both("sqrtm", S), sla.sqrtm(S), 1e-11)
  close(both("logm", S), sla.logm(S), 1e-11)
  close(L.funm(S, np.exp), sla.funm(S, np.exp), 1e-11)
  close(both("signm", S), sla.signm(S), 1e-11)
  for name in ("cosm", "sinm", "tanm", "coshm", "sinhm", "tanhm"):
    close(both(name, 0.1 * A), getattr(sla, name)(0.1 * A), 1e-11)
  tt, zz = L.rsf2csf(t, z)
  close(sp.dot(sp.dot(zz, tt), sp.conj(sp.transpose(zz))), A, 1e-11)


def test_matrix_equation_solvers():
  X = L.solve_sylvester(A, B, S)
  close(sp.dot(sp.lazify(A), X) + sp.dot(X, B), S, 1e-10)
  close(L.solve_continuous_lyapunov(A, S),
        sla.solve_continuous_lyapunov(A, S), 1e-10)
  assert L.solve_lyapunov is L.solve_continuous_lyapunov
  close(L.solve_discrete_lyapunov(0.1 * A, S),
        sla.solve_discrete_lyapunov(0.1 * A, S), 1e-10)


def test_ldl_banded():
  lu_, d_, perm = L.ldl(S, lower=True)
  luw, dw, permw = sla.ldl(S, lower=True)
  close(lu_, luw, 1e-12)
  close(d_, dw, 1e-12)
  assert np.array_equal(perm, permw)
  ab = np.zeros((3, 16))
  ab[0, 1:] = rng.normal(size=15)
  ab[1] = 6 + rng.normal(size=16)
  ab[2, :-1] = rng.normal(size=15)
  close(L.solve_banded((1, 1), ab, b), sla.solve_banded((1, 1), ab, b),
        1e-12)
  abh = np.zeros((2, 16))
  abh[0, 1:] = 0.1 * rng.normal(size=15)
  abh[1] = 6 + rng.normal(size=16)
  close(L.solveh_banded(abh, b), sla.solveh_banded(abh, b), 1e-12)


def test_orth_null_space():
  M = np.concatenate([A[:, :4], A[:, :4] @ rng.normal(size=(4, 4))],
                     axis=1)
  o = g(L.orth(M))
  assert o.shape == (16, 4) == rg(R.orth(M)).shape
  assert np.allclose(o.T @ o, np.eye(4), atol=1e-10)
  # the same range as scipy's basis: the projectors agree
  ow = sla.orth(M)
  close(o @ o.T, ow @ ow.T, 1e-10)
  ns = g(L.null_space(M))
  assert ns.shape == (8, 4)
  assert np.abs(M @ ns).max() < 1e-10
  nw = sla.null_space(M)
  close(ns @ ns.T, nw @ nw.T, 1e-10)
  close(L.subspace_angles(A[:, :3], B[:, :3]),
        sla.subspace_angles(A[:, :3], B[:, :3]), 1e-9)
  Bb, T = L.matrix_balance(A)
  Bw, Tw = sla.matrix_balance(A)
  close(Bb, Bw, 1e-14)
  close(T, Tw, 1e-14)


def test_on_device_names_stay_lazy():
  """The device names return exprs that are neither evaluated arrays nor
  host ops."""
  for e in (L.expm(A), L.lu(A)[1], L.lu_factor(A)[1], L.cho_factor(S)[0],
            L.polar(A)[0], L.toeplitz(b), L.circulant(b), L.hilbert(8),
            L.khatri_rao(A[:3], B[:4]), L.pinvh(S), L.cosm(A),
            L.matmul_toeplitz((b, b[:5]), b[:5]), L.rq(A)[0]):
    assert isinstance(e, Expr) and not isinstance(e, (sp.Val, HostExpr)), \
        type(e)


def test_host_boundary_is_eager_and_counted():
  """The true Schur-family names are host ops, counted as host runs when
  they run; the eager utilities count their call."""
  assert isinstance(L.funm(S, np.exp), HostExpr)
  e = L.solve_sylvester(A, B, S)
  assert isinstance(e, HostExpr)
  before = fio.counts["host_runs"]
  g(e)
  assert fio.counts["host_runs"] == before + 1
  L.expm_cond(0.1 * A)
  L.ordqz(A[:4, :4], B[:4, :4])
  assert fio.counts["host_runs"] == before + 3


def test_matrix_functions_on_device():
  """sqrtm/logm/signm give the device kernel's result (no host op) on
  inputs off the branch cut, counted as device results; the residual is
  packed, so ``disp=False`` is free."""
  def _no_host(e):
    assert isinstance(e, Expr) and not isinstance(e, HostExpr), type(e)

  L.reset_counts()
  X = L.sqrtm(S)
  _no_host(X)
  close(X, sla.sqrtm(S), 1e-10)
  Xd, err = L.sqrtm(S, disp=False)
  assert err < 1e-10
  _, rerr = R.sqrtm(S, disp=False)
  assert abs(err - rerr) < 1e-12
  _no_host(L.logm(S))
  _no_host(L.signm(S))
  _no_host(L.cosm(0.1 * A))
  _no_host(L.orth(A))
  assert L.counts == {"matfun_device": 4, "matfun_host_fallbacks": 0,
                      "matfun_complex_host": 0}
  # non-symmetric but off the cut (the spectrum shifted right of 0)
  G = 0.1 * A + 3 * np.eye(16)
  close(both("sqrtm", G, tol=1e-9), sla.sqrtm(G), 1e-9)
  close(both("logm", G, tol=1e-9), sla.logm(G), 1e-9)
  # signm of an indefinite symmetric matrix (a spectrum of both signs)
  Ind = S - 20.0 * np.eye(16)
  close(both("signm", Ind, tol=1e-8), sla.signm(Ind), 1e-8)
  assert L.counts["matfun_host_fallbacks"] == 0


def test_matrix_functions_host_fallback_is_counted():
  """Inputs on the branch cut (negative real eigenvalues: a complex
  principal sqrt/log) fail the packed residual's gate and take scipy's
  host path, each counted; a complex input goes to the host up front,
  counted apart."""
  N = A @ np.diag(np.concatenate([[-2.0, -0.5], 3 + np.arange(14.)])) \
      @ np.linalg.inv(A)
  L.reset_counts()
  got = g(L.sqrtm(N))
  want = sla.sqrtm(N)
  assert np.iscomplexobj(got)
  assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-8
  gotl = g(L.logm(N))
  wantl = sla.logm(N)
  assert np.max(np.abs(gotl - wantl)) / np.max(np.abs(wantl)) < 1e-8
  np.testing.assert_allclose(gotl, rg(R.logm(N)), atol=1e-8 * np.abs(
      wantl).max())
  assert L.counts["matfun_host_fallbacks"] == 2
  assert L.counts["matfun_device"] == 0
  Xc, errc = L.sqrtm(N.astype(complex), disp=False)
  assert isinstance(Xc, HostExpr)
  assert errc < 1e-10
  assert L.counts == {"matfun_device": 0, "matfun_host_fallbacks": 2,
                      "matfun_complex_host": 1}
  _, err = L.sqrtm(N, disp=False)
  assert err < 1e-10 and L.counts["matfun_host_fallbacks"] == 3


def test_orth_null_space_rcond_and_wide():
  W = rng.normal(size=(4, 10))
  ns = g(L.null_space(W))
  assert ns.shape == (10, 6)
  assert np.abs(W @ ns).max() < 1e-10
  assert np.allclose(ns.T @ ns, np.eye(6), atol=1e-10)
  o = g(L.orth(A[:, :5], rcond=None))
  assert o.shape == (16, 5)
  M2 = np.concatenate([A[:, :3], 1e-12 * A[:, 3:5]], axis=1)
  o2 = g(L.orth(M2, rcond=1e-9))
  assert o2.shape == sla.orth(M2, rcond=1e-9).shape == (16, 3)
  assert rg(R.orth(M2, rcond=1e-9)).shape == (16, 3)


def test_linalg_namespace_merge():
  """The non-conflicting names are merged into sp.linalg; the overlap
  keeps sp.linalg's own."""
  for name in ("expm", "lu", "cho_factor", "polar", "schur", "sqrtm",
               "toeplitz", "block_diag"):
    assert getattr(sp.linalg, name) is getattr(L, name)
  import spartan_tpu_torch.linalg as _lin
  assert sp.linalg.cholesky is _lin.cholesky
  assert sp.linalg.solve_triangular is _lin.solve_triangular
  for name in L.__all__:
    assert hasattr(sp.linalg, name), name


def test_convolution_matrix_kernel_longer_than_n():
  a, v = rng.normal(size=5), rng.normal(size=3)
  for mode in ("full", "same", "valid"):
    close(sp.dot(L.convolution_matrix(a, 3, mode), v),
          np.convolve(a, v, mode), 1e-13)
    close(both("convolution_matrix", a, 3, mode, tol=1e-14),
          sla.convolution_matrix(a, 3, mode), 1e-14)


def test_exact_constructors_return_host_arrays():
  m = L.pascal(36, exact=True)
  assert isinstance(m, np.ndarray)
  assert (m == sla.pascal(36, exact=True)).all()
  ih = L.invhilbert(6, exact=True)
  assert isinstance(ih, np.ndarray)
  assert (ih == sla.invhilbert(6, exact=True)).all()


def test_ishermitian_complex():
  Ac = np.array([[1.0, 1j], [1j, 1.0]])  # symmetric, not Hermitian
  assert L.issymmetric(np.real(Ac) * 0 + np.eye(2))
  assert not L.ishermitian(Ac)
  H = np.array([[2.0, 1 - 1j], [1 + 1j, 3.0]])
  assert L.ishermitian(H)
  assert L.ishermitian(H + 1e-13, atol=1e-12)


def test_companion_rejects_zero_leading():
  with pytest.raises(ValueError):
    L.companion(np.array([0., 1., 2.]))
  with pytest.raises(ValueError):
    L.companion(np.array([1.]))


def test_diagsvd_hadamard_invpascal():
  s = np.array([3.0, 2.0, 1.0])
  np.testing.assert_array_equal(g(L.diagsvd(s, 5, 3)), sla.diagsvd(s, 5, 3))
  np.testing.assert_array_equal(g(L.diagsvd(s, 3, 6)), sla.diagsvd(s, 3, 6))
  np.testing.assert_array_equal(g(L.diagsvd(s, 3, 6)),
                                rg(R.diagsvd(s, 3, 6)))
  for n in (1, 2, 8, 64):
    np.testing.assert_array_equal(L.hadamard(n), sla.hadamard(n))
  np.testing.assert_array_equal(g(L.hadamard(4, dtype=float)),
                                sla.hadamard(4, dtype=float))
  with pytest.raises(ValueError):
    L.hadamard(6)
  np.testing.assert_array_equal(L.invpascal(5), sla.invpascal(5))
  np.testing.assert_allclose(g(L.invpascal(5, exact=False)),
                             sla.invpascal(5, exact=False))


def test_rq_reconstruction():
  for shape, mode in [((6, 6), "full"), ((4, 7), "full"), ((7, 4), "full"),
                      ((4, 7), "economic"), ((7, 4), "economic")]:
    M = rng.normal(size=shape)
    Rr, Q = L.rq(M, mode=mode)
    Rv, Qv = g(Rr), g(Q)
    wr, wq = sla.rq(M, mode=mode)
    assert Rv.shape == wr.shape and Qv.shape == wq.shape
    np.testing.assert_allclose(Rv @ Qv, M, atol=1e-10)
    np.testing.assert_allclose(Qv @ Qv.T, np.eye(Qv.shape[0]), atol=1e-10)
    np.testing.assert_allclose(Rv[wr == 0], 0, atol=1e-10)
    # unique up to a sign a row: |R| as scipy's
    np.testing.assert_allclose(np.abs(Rv), np.abs(wr), atol=1e-10)
  Ronly = g(L.rq(rng.normal(size=(5, 5)), mode="r"))
  assert Ronly.shape == (5, 5)
  with pytest.raises(ValueError):
    L.rq(A, mode="thin")


def test_orthogonal_procrustes():
  M = rng.normal(size=(9, 4))
  w = rng.normal(size=(4, 4))
  qw, _ = np.linalg.qr(w)
  Bm = M @ qw + 0.01 * rng.normal(size=(9, 4))
  Rr, scale = L.orthogonal_procrustes(M, Bm)
  wR, wscale = sla.orthogonal_procrustes(M, Bm)
  np.testing.assert_allclose(g(Rr), wR, atol=1e-9)
  assert abs(scale - wscale) < 1e-8 * abs(wscale)
  rR, rscale = R.orthogonal_procrustes(M, Bm)
  np.testing.assert_allclose(g(Rr), rg(rR), atol=1e-10)
  assert abs(scale - rscale) < 1e-10 * abs(rscale)


def test_fractional_matrix_power():
  M = 0.1 * rng.normal(size=(12, 12)) + 2 * np.eye(12)
  for t in [3, -2, 0.5, 1.7, -0.3]:
    got = g(L.fractional_matrix_power(M, t))
    want = sla.fractional_matrix_power(M, t)
    np.testing.assert_allclose(got, np.real(want), atol=2e-8)
    np.testing.assert_allclose(got, rg(R.fractional_matrix_power(M, t)),
                               atol=1e-10 * np.abs(got).max())
  # a spectrum on the branch cut: the host path, complex, scipy's value
  N = A @ np.diag(np.concatenate([[-2.0], 2 + np.arange(15.)])) \
      @ np.linalg.inv(A)
  got = g(L.fractional_matrix_power(N, 0.5))
  np.testing.assert_allclose(got, sla.fractional_matrix_power(N, 0.5),
                             atol=1e-7)


def test_matmul_toeplitz_and_solves():
  c = rng.normal(size=6)
  r = np.concatenate([[c[0]], rng.normal(size=4)])
  x1 = rng.normal(size=5)
  x2 = rng.normal(size=(5, 3))
  for x in (x1, x2):
    got = g(L.matmul_toeplitz((c, r), x))
    np.testing.assert_allclose(got, sla.matmul_toeplitz((c, r), x),
                               atol=1e-10)
    np.testing.assert_allclose(got, rg(R.matmul_toeplitz((c, r), x)),
                               atol=1e-12)
  got = g(L.matmul_toeplitz(c, rng.normal(size=6)))
  assert got.shape == (6,)
  xc = x1 + 1j * x1[::-1]
  e = L.matmul_toeplitz((c, r), xc)
  assert isinstance(e, HostExpr)
  np.testing.assert_allclose(g(e), sla.matmul_toeplitz((c, r), xc),
                             atol=1e-12)
  with pytest.raises(ValueError, match="rows"):
    L.matmul_toeplitz((c, r), rng.normal(size=4))
  cc = np.array([5.0, 1, 0.5, 0.2])
  bb = rng.normal(size=4)
  np.testing.assert_allclose(g(L.solve_circulant(cc, bb)),
                             sla.solve_circulant(cc, bb), atol=1e-10)
  B2 = rng.normal(size=(4, 2))
  np.testing.assert_allclose(g(L.solve_circulant(cc, B2)),
                             sla.solve_circulant(cc, B2), atol=1e-10)
  csing = np.array([1.0, -1.0, 1.0, -1.0])
  with pytest.raises(np.linalg.LinAlgError):
    L.solve_circulant(csing, bb)
  np.testing.assert_allclose(
      g(L.solve_circulant(csing, bb, singular="lstsq")),
      sla.solve_circulant(csing, bb, singular="lstsq"), atol=1e-10)
  np.testing.assert_allclose(g(L.solve_toeplitz((c[:5], r), x1)),
                             sla.solve_toeplitz((c[:5], r), x1), atol=1e-10)


def test_cdf2rdf():
  M = rng.normal(size=(6, 6))
  w, v = np.linalg.eig(M)
  wr, vr = L.cdf2rdf(w, v)
  wwr, wvr = sla.cdf2rdf(w, v)
  np.testing.assert_allclose(wr, wwr, atol=1e-12)
  np.testing.assert_allclose(vr, wvr, atol=1e-12)
  np.testing.assert_allclose(vr @ wr @ np.linalg.inv(vr), M, atol=1e-8)


def test_qz_and_banded_host_wrappers():
  M = rng.normal(size=(6, 6))
  Bq = rng.normal(size=(6, 6))
  AA, BB, Q, Z = (g(x) for x in L.qz(M, Bq))
  np.testing.assert_allclose(Q @ AA @ Z.T, M, atol=1e-9)
  np.testing.assert_allclose(Q @ BB @ Z.T, Bq, atol=1e-9)
  with pytest.raises(ValueError, match="ordqz"):
    L.qz(M, Bq, sort="lhp")
  res = L.ordqz(M, Bq, sort="lhp")
  assert len(res) == 6
  d = rng.normal(size=8) + 4
  e = rng.normal(size=7)
  band = np.zeros((2, 8))
  band[0, 1:] = e
  band[1] = d
  T = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
  w, v = L.eig_banded(band)
  np.testing.assert_allclose(g(w), np.linalg.eigvalsh(T), atol=1e-10)
  vv = g(v)
  np.testing.assert_allclose(T @ vv, vv * g(w), atol=1e-10)
  np.testing.assert_allclose(g(L.eigvals_banded(band)),
                             np.linalg.eigvalsh(T), atol=1e-10)
  np.testing.assert_allclose(g(L.eigvalsh_tridiagonal(d, e)),
                             np.linalg.eigvalsh(T), atol=1e-10)
  with pytest.raises(NotImplementedError):
    L.eigvalsh_tridiagonal(d, e, select="i", select_range=(0, 2))
  ab = g(L.cholesky_banded(band))
  np.testing.assert_allclose(ab, sla.cholesky_banded(band), atol=1e-10)
  bb = rng.normal(size=8)
  np.testing.assert_allclose(g(L.cho_solve_banded((ab, False), bb)),
                             np.linalg.solve(T, bb), atol=1e-10)


def test_riccati_and_qr_updates():
  n = 4
  a = rng.normal(size=(n, n)) - 3 * np.eye(n)
  bm = rng.normal(size=(n, 2))
  q = np.eye(n)
  r = np.eye(2)
  X = g(L.solve_continuous_are(a, bm, q, r))
  np.testing.assert_allclose(
      a.T @ X + X @ a - X @ bm @ np.linalg.inv(r) @ bm.T @ X + q,
      0, atol=1e-8)
  np.testing.assert_allclose(X, sla.solve_continuous_are(a, bm, q, r),
                             atol=1e-10)
  Xd = g(L.solve_discrete_are(a * 0.1, bm, q, r))
  np.testing.assert_allclose(Xd, sla.solve_discrete_are(a * 0.1, bm, q, r),
                             atol=1e-10)
  Xe = g(L.solve_continuous_are(a, bm, q, r, e=np.eye(n)))
  np.testing.assert_allclose(Xe, X, atol=1e-10)
  M = rng.normal(size=(6, 4))
  Q, Rr = np.linalg.qr(M)
  u = rng.normal(size=6)
  v = rng.normal(size=4)
  Q1, R1 = L.qr_update(Q, Rr, u, v)
  np.testing.assert_allclose(Q1 @ R1, M + np.outer(u, v), atol=1e-10)
  Q2, R2 = L.qr_delete(Q, Rr, 1, which="row")
  np.testing.assert_allclose(Q2 @ R2, np.delete(M, 1, axis=0), atol=1e-10)
  Qf, Rf = np.linalg.qr(M, mode="complete")
  Q3, R3 = L.qr_insert(Qf, Rf, rng.normal(size=4), 2, which="row")
  assert Q3.shape == (7, 7)
  cm = rng.normal(size=(4, 2))
  for got, want in zip(L.qr_multiply(M, cm, mode="left"),
                       sla.qr_multiply(M, cm, mode="left")):
    np.testing.assert_allclose(got, want, atol=1e-12)
  c = float(L.expm_cond(0.1 * rng.normal(size=(5, 5))))
  assert c > 0


def test_clarkson_woodruff_sketch():
  M = rng.normal(size=(64, 8))
  Sk = g(L.clarkson_woodruff_transform(M, 16, rng=np.random.default_rng(5)))
  assert Sk.shape == (16, 8)
  assert 0.3 < np.linalg.norm(Sk) / np.linalg.norm(M) < 3.0
  # the same draw as the reference's: the same sketch
  rs = rg(R.clarkson_woodruff_transform(M, 16, rng=np.random.default_rng(5)))
  np.testing.assert_allclose(Sk, rs, atol=1e-12)


def test_cossin_host():
  from scipy.stats import ortho_group
  X = ortho_group.rvs(6, random_state=3)
  u, cs, vdh = L.cossin(X, p=3, q=3)
  np.testing.assert_allclose(u @ cs @ vdh, X, atol=1e-10)


def test_all_names_equal_the_reference():
  """The port's ``scipy_linalg.__all__`` is the reference's, name for
  name (the reference's parity audit reads its own tool)."""
  assert L.__all__ == R.__all__
  for name in L.__all__:
    assert callable(getattr(L, name)), name
  assert "scipy_linalg" in sp.__all__ and sp.scipy_linalg is L


def test_a_name_older_scipy_lacks_raises_attribute_error(monkeypatch):
  """A host boundary whose scipy function is absent raises scipy's own
  AttributeError, not another path."""
  import scipy.linalg
  monkeypatch.delattr(scipy.linalg, "solve_sylvester")
  with pytest.raises(AttributeError):
    L.solve_sylvester(A, B, S)
