"""``sp.linalg`` and the examples it wraps (cholesky, qr, lanczos, pca,
spectral) in both packages on the same seeded inputs: the counterparts of
the reference's ``tests/test_linalg.py``, each held to the reference and to
NumPy.

Tolerances (float64 throughout):
* the same algorithm on both sides (the blocked Cholesky and triangular
  solves, CholeskyQR2, Lanczos, SSVD, PCA, the normal equations): 1e-10
  relative to the result's largest entry; their LAPACK or Krylov steps run
  in another order, a difference of about 1e-15 amplified by condition
  numbers below 1e4 here;
* the dense factorizations, torch's LAPACK call against XLA's: 1e-10
  (1e-9 for the power and the condition number, whose products of 30
  factors carry more rounding); eigenvectors and singular vectors are held
  by their defining identities, since their signs are LAPACK's choice;
* the reference test's own bounds where it holds to NumPy.
"""

import numpy as np
import pytest
import scipy.sparse as ss
import torch

import spartan_tpu as ref
from spartan_tpu.examples import cholesky as rchol
from spartan_tpu.examples import lanczos as rlan
from spartan_tpu.examples import pca as rpca
from spartan_tpu.examples import qr as rqr
from spartan_tpu.examples import spectral as rspec

import spartan_tpu_torch as sp
from spartan_tpu_torch import linalg as L
from spartan_tpu_torch.backend.kernels import spmv as KS
from spartan_tpu_torch.config import FLAGS
from spartan_tpu_torch.examples import cholesky as chol
from spartan_tpu_torch.examples import lanczos as lan
from spartan_tpu_torch.examples import pca
from spartan_tpu_torch.examples import qr as qr_example
from spartan_tpu_torch.examples import spectral
from spartan_tpu_torch.expr import fio

TOL = 1e-10


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


def _spd(n, rng):
  m = rng.standard_normal((n, n))
  return m @ m.T + n * np.eye(n)


def _g(e):
  return np.asarray(e.glom())


def _close(got, want, tol=TOL):
  got, want = np.asarray(got), np.asarray(want)
  assert got.shape == want.shape
  scale = max(float(np.abs(want).max()), 1e-300)
  assert float(np.abs(got - want).max()) <= tol * scale, (
      float(np.abs(got - want).max()) / scale)


def test_the_surface_is_the_references():
  import spartan_tpu.linalg as rl
  assert sorted(L.__all__) == sorted(rl.__all__)
  for name in rl.__all__:
    assert callable(getattr(sp.linalg, name)), name


def test_cholesky(rng):
  a = _spd(96, rng)
  got = _g(sp.linalg.cholesky(sp.from_numpy(a), block=32))
  _close(got, _g(ref.linalg.cholesky(ref.from_numpy(a), block=32)))
  _close(got, np.linalg.cholesky(a))


def test_cholesky_of_a_matrix_that_is_not_spd_raises(rng):
  a = _spd(40, rng)
  a[30, 30] = -1e6
  with pytest.raises(np.linalg.LinAlgError):
    sp.linalg.cholesky(a, block=16)


@pytest.mark.parametrize("rhs", [(96,), (64, 3)])
@pytest.mark.parametrize("lower", [True, False])
def test_solve_triangular(rng, rhs, lower):
  n = rhs[0]
  T = np.tril(rng.standard_normal((n, n))) + n * np.eye(n)
  if not lower:
    T = T.T
  b = rng.standard_normal(rhs)
  x = _g(sp.linalg.solve_triangular(sp.from_numpy(T), sp.from_numpy(b),
                                    lower=lower, block=32))
  _close(x, _g(ref.linalg.solve_triangular(ref.from_numpy(T),
                                           ref.from_numpy(b), lower=lower,
                                           block=32)))
  np.testing.assert_allclose(T @ x, b, rtol=1e-9, atol=1e-9)


def test_solve_spd_direct_and_cg(rng):
  a = _spd(96, rng)
  b = rng.standard_normal(96)
  want = np.linalg.solve(a, b)
  x = _g(sp.linalg.solve(sp.from_numpy(a), sp.from_numpy(b),
                         method="cholesky", block=32))
  _close(x, _g(ref.linalg.solve(ref.from_numpy(a), ref.from_numpy(b),
                                method="cholesky", block=32)))
  np.testing.assert_allclose(x, want, rtol=1e-8, atol=1e-8)
  xcg = _g(sp.linalg.solve(sp.from_numpy(a), sp.from_numpy(b), method="cg",
                           tol=1e-12))
  np.testing.assert_allclose(xcg, want, rtol=1e-7, atol=1e-7)
  with pytest.raises(ValueError):
    sp.linalg.solve(a, b, method="qr")


def test_solve_general_lu(rng):
  a = rng.standard_normal((48, 48))
  for b in (rng.standard_normal(48), rng.standard_normal((48, 3))):
    x = _g(sp.linalg.solve(sp.from_numpy(a), sp.from_numpy(b)))
    _close(x, _g(ref.linalg.solve(ref.from_numpy(a), ref.from_numpy(b))))
    np.testing.assert_allclose(x, np.linalg.solve(a, b), rtol=1e-8,
                               atol=1e-9)


def test_a_singular_matrix_gives_the_references_values_and_does_not_raise():
  """``inv`` and ``solve`` are the ``_ex`` forms: no check on the host
  inside a map; an exactly singular matrix gives the reference's inf/nan."""
  a = np.array([[1.0, 2.0], [2.0, 4.0]])
  b = np.array([1.0, 1.0])
  for got, want in [(sp.linalg.inv(a), ref.linalg.inv(a)),
                    (sp.linalg.solve(a, b), ref.linalg.solve(a, b)),
                    (sp.linalg.inv(np.zeros((3, 3))),
                     ref.linalg.inv(np.zeros((3, 3))))]:
    np.testing.assert_array_equal(_g(got), _g(want))
  # cond by the inverse (p = 1): inf, not nan, as the reference's
  assert np.isinf(float(_g(sp.linalg.cond(a, 1)))) and np.isinf(
      float(_g(ref.linalg.cond(a, 1))))


def test_lstsq(rng):
  X = rng.standard_normal((256, 8))
  y = rng.standard_normal(256)
  w = _g(sp.linalg.lstsq(sp.from_numpy(X), sp.from_numpy(y)))
  _close(w, _g(ref.linalg.lstsq(ref.from_numpy(X), ref.from_numpy(y))))
  np.testing.assert_allclose(w, np.linalg.lstsq(X, y, rcond=None)[0],
                             rtol=1e-8, atol=1e-8)
  wr = _g(sp.linalg.lstsq(X, y, reg=0.5))
  _close(wr, np.linalg.solve(X.T @ X + 0.5 * np.eye(8), X.T @ y))


def test_qr_tsqr(rng):
  X = rng.standard_normal((512, 12))
  Q, R = sp.linalg.qr(sp.from_numpy(X))
  RQ, RR = ref.linalg.qr(ref.from_numpy(X))
  q, r = _g(Q), _g(R)
  _close(q, _g(RQ))
  _close(r, _g(RR))
  np.testing.assert_allclose(q.T @ q, np.eye(12), atol=1e-10)
  np.testing.assert_allclose(q @ r, X, atol=1e-10)
  assert np.allclose(r, np.triu(r))


def test_qr_square_householder(rng):
  a = rng.standard_normal((32, 32))
  q, r = sp.linalg.qr(a)
  qn, rn = _g(q), _g(r)
  np.testing.assert_allclose(qn @ rn, a, atol=1e-10)
  np.testing.assert_allclose(qn.T @ qn, np.eye(32), atol=1e-10)
  u = rng.standard_normal((16, 16))
  s = np.logspace(0, -12, 16)
  ill = ((np.linalg.qr(u)[0] * s)
         @ np.linalg.qr(rng.standard_normal((16, 16)))[0])
  q, r = sp.linalg.qr(ill)
  np.testing.assert_allclose(_g(q) @ _g(r), ill, atol=1e-12)
  with pytest.raises(ValueError):
    sp.linalg.qr(a, method="givens")


def test_eigvalsh_lanczos(rng):
  m = rng.standard_normal((128, 128))
  a = (m + m.T) / 2
  got = sp.linalg.eigvalsh_lanczos(sp.from_numpy(a), k=3, m=64)
  np.testing.assert_allclose(got, np.linalg.eigvalsh(a)[-3:], rtol=1e-6,
                             atol=1e-6)
  _close(sp.linalg.eigvalsh_lanczos(sp.from_numpy(a), k=3, m=12),
         ref.linalg.eigvalsh_lanczos(ref.from_numpy(a), k=3, m=12))


def _grid_laplacian(nx, ny, dtype, pkg):
  d = [-1.0, 2.0, -1.0]
  return pkg.sparse.kronsum(
      pkg.sparse.diags(d, [-1, 0, 1], shape=(nx, nx), dtype=dtype),
      pkg.sparse.diags(d, [-1, 0, 1], shape=(ny, ny), dtype=dtype))


def _grid_eigenvalues(nx, ny):
  lx = 2 - 2 * np.cos(np.arange(1, nx + 1) * np.pi / (nx + 1))
  ly = 2 - 2 * np.cos(np.arange(1, ny + 1) * np.pi / (ny + 1))
  return np.sort((lx[:, None] + ly[None, :]).ravel())


def test_lanczos_of_a_sparse_grid_laplacian(monkeypatch):
  """``eigvalsh_lanczos`` of the 5-point Laplacian built by ``kronsum``:
  float64 equal at 1e-10 to the reference's of the same matrix dense (the
  reference's cannot take a SparseArray: it raises ``TypeError``); float32
  through the SpMV kernel route (counted as the ELL wrapper's plain runs
  with the kernel route forced on the CPU, one a Lanczos step) within
  ``lanczos.lanczos_tol`` of the float64 run; both at most the
  closed-form spectrum's top k (Cauchy interlacing: the j-th largest Ritz
  value is at most the j-th largest eigenvalue)."""
  nx, ny, k, m = 16, 24, 6, 24
  L64 = _grid_laplacian(nx, ny, np.float64, sp)
  got64 = sp.linalg.eigvalsh_lanczos(L64, k=k, m=m)
  _close(got64, ref.linalg.eigvalsh_lanczos(ref.from_numpy(L64.todense()),
                                            k=k, m=m))
  with pytest.raises(TypeError):
    ref.linalg.eigvalsh_lanczos(_grid_laplacian(nx, ny, np.float64, ref),
                                k=k, m=m)
  L32 = _grid_laplacian(nx, ny, np.float32, sp)
  monkeypatch.setattr(FLAGS, "sparse_force_onehot", True)
  KS.reset_counts()
  got32 = sp.linalg.eigvalsh_lanczos(L32, k=k, m=m)
  assert KS.counts["ell_plain_runs"] == m
  slack = lan.lanczos_tol(m, 8.0)
  assert abs(got32 - got64).max() <= slack
  top = _grid_eigenvalues(nx, ny)[-k:]
  assert (got64 <= top + 1e-12).all() and (got32 <= top + slack).all()


def test_lanczos_example(rng):
  est, true = lan.run(n=128, k=40)
  assert abs(est - true) <= 1e-8 * abs(true)
  est12, _ = lan.run(n=128, k=12)
  r_est12, _ = rlan.run(n=128, k=12)
  assert abs(est12 - r_est12) <= TOL * abs(true)
  alphas, betas, basis = lan.tridiagonalize(rng.standard_normal((5, 5)) +
                                            np.eye(5) * 10, k=5)
  assert len(alphas) == len(basis) == 5 and len(betas) == 4


def test_svd_lowrank(rng):
  X = rng.standard_normal((256, 32)) @ rng.standard_normal((32, 16))
  U, s, Vt = sp.linalg.svd_lowrank(sp.from_numpy(X), k=4, iterations=30)
  RU, rs, RVt = ref.linalg.svd_lowrank(ref.from_numpy(X), k=4,
                                       iterations=30)
  _close(s, rs)
  _close(U * s, RU * rs)
  np.testing.assert_allclose(s, np.linalg.svd(X, compute_uv=False)[:4],
                             rtol=1e-6)


def test_pca_fit_and_transform(rng):
  comps, evals, X = pca.run(n=1024, d=16, k=3)
  rcomps, revals, _ = rpca.run(n=1024, d=16, k=3)
  _close(evals, revals)
  _close(np.abs(comps), np.abs(rcomps))
  proj = _g(pca.transform(sp.from_numpy(X), comps))
  _close(proj, _g(rpca.transform(ref.from_numpy(X), comps)))
  # 30 subspace iterations at these eigenvalue gaps leave about 1e-4
  Xc = X - X.mean(0)
  w = np.linalg.eigvalsh(Xc.T @ Xc / X.shape[0])[::-1][:3]
  np.testing.assert_allclose(evals, w, rtol=1e-3)


def test_cholesky_and_qr_examples():
  _, err = chol.run(n=128, block=32)
  _, rerr = rchol.run(n=128, block=32)
  assert err < 1e-10 and rerr < 1e-10
  orth, recon = qr_example.run(n=2048, d=16)
  rorth, rrecon = rqr.run(n=2048, d=16)
  assert orth < 1e-12 and recon < 1e-12 and rorth < 1e-12


def test_spectral_clustering_recovers_the_rings():
  assert spectral.run(n=256) == 1.0 == rspec.run(n=256)


def test_spectral_embedding_equals_the_references(rng):
  th = rng.uniform(0, 2 * np.pi, 64)
  X = np.stack([np.cos(th), np.sin(th)], 1) * rng.uniform(1, 3, (64, 1))
  W = _g(spectral.affinity_rbf(sp.from_numpy(X), 4.0))
  _close(W, _g(rspec.affinity_rbf(ref.from_numpy(X), 4.0)))
  emb = _g(spectral.embed(sp.from_numpy(W), 2))
  remb = _g(rspec.embed(ref.from_numpy(W), 2))
  _close(np.abs(emb), np.abs(remb), 1e-8)  # eigenvector signs: LAPACK's


def test_inv_det_slogdet(rng):
  a = _spd(48, rng)
  _close(_g(sp.linalg.inv(a)), _g(ref.linalg.inv(a)))
  _close(_g(sp.linalg.inv(a)), np.linalg.inv(a), 1e-8)
  np.testing.assert_allclose(float(_g(sp.linalg.det(a[:6, :6]))),
                             np.linalg.det(a[:6, :6]), rtol=1e-10)
  sign, logdet = sp.linalg.slogdet(a)
  rsign, rlogdet = ref.linalg.slogdet(a)
  assert float(_g(sign)) == float(_g(rsign)) == np.linalg.slogdet(a)[0]
  np.testing.assert_allclose(float(_g(logdet)), float(_g(rlogdet)),
                             rtol=1e-13)


def test_eigh_full(rng):
  m = rng.standard_normal((64, 64))
  a = (m + m.T) / 2
  _close(_g(sp.linalg.eigvalsh(a)), _g(ref.linalg.eigvalsh(a)))
  _close(_g(sp.linalg.eigvalsh(a)), np.linalg.eigvalsh(a))
  w, v = sp.linalg.eigh(a)
  wn, vn = _g(w), _g(v)
  np.testing.assert_allclose(a @ vn, vn * wn, atol=1e-10)
  np.testing.assert_allclose(vn.T @ vn, np.eye(64), atol=1e-12)


def test_eigh_symmetrizes_its_input_as_the_reference_does(rng):
  a = rng.standard_normal((12, 12))
  _close(_g(sp.linalg.eigvalsh(a)), _g(ref.linalg.eigvalsh(a)))
  _close(_g(sp.linalg.eigh(a)[0]), np.linalg.eigvalsh((a + a.T) / 2))


def test_eig_general_host_boundary(rng):
  a = rng.standard_normal((24, 24))
  before = fio.counts["host_runs"]
  w, v = sp.linalg.eig(a)
  wn, vn = _g(w), _g(v)
  np.testing.assert_allclose(a @ vn, vn * wn, atol=1e-10)
  ev = _g(sp.linalg.eigvals(a))
  np.testing.assert_allclose(np.sort_complex(ev), np.sort_complex(wn),
                             atol=1e-10)
  assert fio.counts["host_runs"] == before + 2


def test_eig_host_notice_fires_once(rng, monkeypatch):
  seen = []
  monkeypatch.setattr(sp.util, "log_info", lambda *a: seen.append(a))
  monkeypatch.setattr(L._eig_host_notice, "done", False)
  a = rng.standard_normal((8, 8))
  L.eig(a)
  L.eigvals(a)
  assert len(seen) == 1 and "EAGERLY" in seen[0][0] % seen[0][1:]


def test_svd_full(rng):
  x = rng.standard_normal((40, 24))
  u, s, vt = sp.linalg.svd(x)
  un, sn, vtn = (_g(e) for e in (u, s, vt))
  assert un.shape == (40, 24) and vtn.shape == (24, 24)
  np.testing.assert_allclose((un * sn) @ vtn, x, atol=1e-12)
  _close(sn, _g(ref.linalg.svd(x)[1]))
  _close(_g(sp.linalg.svdvals(x)), np.linalg.svd(x, compute_uv=False))
  U, _, _ = sp.linalg.svd(x, full_matrices=True)
  assert _g(U).shape == (40, 40)


def test_power_rank_cond_norm(rng):
  a = _spd(32, rng)
  _close(_g(sp.linalg.matrix_power(a, 3)), _g(ref.linalg.matrix_power(a, 3)),
         1e-9)
  _close(_g(sp.linalg.matrix_power(a, 3)), np.linalg.matrix_power(a, 3),
         1e-9)
  assert int(_g(sp.linalg.matrix_rank(a))) == 32
  lowrank = np.outer(rng.standard_normal(16), rng.standard_normal(16))
  assert int(_g(sp.linalg.matrix_rank(lowrank))) == 1
  for p in (None, 2, -2, 1, np.inf, "fro"):
    got = float(_g(sp.linalg.cond(a, p)))
    np.testing.assert_allclose(got, float(_g(ref.linalg.cond(a, p))),
                               rtol=1e-9)
    np.testing.assert_allclose(got, np.linalg.cond(a, p), rtol=1e-9)
  x = rng.standard_normal((8, 12))
  for o in (None, "fro", "nuc", 1, -1, np.inf, -np.inf, 2, -2):
    got = float(_g(sp.linalg.norm(x, ord=o)))
    np.testing.assert_allclose(got, float(_g(ref.linalg.norm(x, ord=o))),
                               rtol=TOL)
    np.testing.assert_allclose(got, np.linalg.norm(x, ord=o), rtol=TOL)
  for axis, o in [(1, None), (0, 3), (1, np.inf), ((0, 1), "fro")]:
    _close(_g(sp.linalg.norm(x, ord=o, axis=axis, keepdims=True)),
           np.linalg.norm(x, ord=o, axis=axis, keepdims=True))


def test_pinv_and_matrix_rank_default_tolerances_are_the_references(rng):
  """Pinned: the defaults are ``jnp.linalg``'s, not NumPy 2's.  A singular
  value of 5e-15 (s_max = 2) lies above NumPy's pinv cut-off (1e-15 ·
  s_max) and below the reference's (10 · max(m, n) · eps · s_max ≈ 1.1e-13
  at 24 × 12), so NumPy inverts it and the reference and the port drop it;
  it is also below matrix_rank's default (max(m, n) · eps · s_max ≈
  1.1e-14); matrix_rank's given ``rtol`` is an absolute tolerance in the
  reference, as here."""
  u = np.linalg.qr(rng.standard_normal((24, 12)))[0]
  v = np.linalg.qr(rng.standard_normal((12, 12)))[0]
  s = np.linspace(2.0, 1.0, 12)
  s[-1] = 5e-15
  x = (u * s) @ v.T
  got = _g(sp.linalg.pinv(x))
  _close(got, _g(ref.linalg.pinv(x)), 1e-8)
  assert np.abs(got).max() < 10 and np.abs(np.linalg.pinv(x)).max() > 1e12
  # a given rtol below the 2e-14 keeps it, as NumPy's default does
  assert np.abs(_g(sp.linalg.pinv(x, rtol=1e-15))).max() > 1e12
  assert np.abs(_g(ref.linalg.pinv(x, rtol=1e-15))).max() > 1e12
  assert int(_g(sp.linalg.matrix_rank(x))) == int(
      _g(ref.linalg.matrix_rank(x))) == 11
  for rtol in (0.5, 1.5, 1e-13):
    assert int(_g(sp.linalg.matrix_rank(x, rtol=rtol))) == int(
        _g(ref.linalg.matrix_rank(x, rtol=rtol)))
  assert int(_g(sp.linalg.matrix_rank(x, rtol=1.5))) == 6
  x2 = rng.standard_normal((24, 12))
  _close(_g(sp.linalg.pinv(x2)), np.linalg.pinv(x2), 1e-10)


def test_multi_dot_tensor_ops(rng):
  ms = [rng.standard_normal(s) for s in [(6, 50), (50, 4), (4, 30), (30, 3)]]
  _close(_g(sp.linalg.multi_dot(ms)), np.linalg.multi_dot(ms))
  a = rng.standard_normal((4, 3, 4, 3))
  b = rng.standard_normal((4, 3))
  _close(_g(sp.linalg.tensorsolve(a, b)), np.linalg.tensorsolve(a, b))
  _close(_g(sp.linalg.tensorsolve(a, b, axes=(0, 1))),
         np.linalg.tensorsolve(a, b, axes=(0, 1)))
  _close(_g(sp.linalg.tensorinv(a)), np.linalg.tensorinv(a))
  m = rng.standard_normal((2, 3, 4))
  np.testing.assert_array_equal(_g(sp.linalg.matrix_transpose(m)),
                                np.swapaxes(m, -1, -2))


def test_array_api_additions(rng):
  a = rng.standard_normal((5, 5))
  b = rng.standard_normal((5, 5))
  v = rng.standard_normal(5)
  _close(_g(sp.linalg.matmul(a, b)), a @ b)
  _close(_g(sp.linalg.tensordot(a, b, axes=1)), np.tensordot(a, b, 1))
  _close(_g(sp.linalg.outer(v, v)), np.outer(v, v))
  _close(_g(sp.linalg.cross(a[:, :3], b[:, :3])),
         np.cross(a[:, :3], b[:, :3]))
  _close(_g(sp.linalg.diagonal(a, 1)), np.diagonal(a, 1))
  _close(_g(sp.linalg.trace(a)), np.trace(a))
  _close(_g(sp.linalg.vecdot(a, b)), np.linalg.vecdot(a, b))
  _close(_g(sp.linalg.matrix_norm(a)), np.linalg.matrix_norm(a))
  _close(_g(sp.linalg.vector_norm(a, keepdims=True)),
         np.linalg.vector_norm(a, keepdims=True))
  _close(_g(sp.linalg.vector_norm(a, ord=1, axis=0)),
         np.linalg.vector_norm(a, ord=1, axis=0))


def test_no_host_check_inside_the_dense_maps(rng):
  """The maps build on meta tensors (shape inference runs each torch
  function there), so none of them reads a value on the host."""
  a = sp.from_numpy(_spd(8, rng))
  for e in (sp.linalg.inv(a), sp.linalg.solve(a, a), sp.linalg.pinv(a),
            sp.linalg.det(a), sp.linalg.eigh(a)[1], sp.linalg.svd(a)[0],
            sp.linalg.matrix_rank(a), sp.linalg.cond(a, 1),
            sp.linalg.norm(a, 2), sp.linalg.slogdet(a)[1]):
    assert e.aval() is not None


@pytest.mark.parametrize("name, n_out, fn", [
    ("svd", 3, "svd"), ("eigh", 2, "eigh"), ("slogdet", 2, "slogdet"),
    ("qr", 2, "qr")])
def test_outputs_evaluated_together_factor_once(rng, monkeypatch, name,
                                                n_out, fn):
  """The outputs of one factorization share one node: evaluated one by one
  or in one region, ``torch.linalg`` factors the matrix once (shape
  inference on meta tensors not counted), and the outputs agree with the
  reference."""
  a = _spd(24, rng)
  calls = []
  real = getattr(torch.linalg, fn)

  def counted(t, *args, **kw):
    if t.device.type != "meta":
      calls.append(fn)
    return real(t, *args, **kw)

  monkeypatch.setattr(torch.linalg, fn, counted)
  kw = {"method": "householder"} if name == "qr" else {}
  outs = getattr(sp.linalg, name)(a, **kw)
  assert len(outs) == n_out
  got = [np.asarray(o.glom()) for o in sp.evaluate(list(outs))]
  assert calls == [fn]
  again = getattr(sp.linalg, name)(a, **kw)
  together = sp.TupleExpr(list(again)).evaluate()
  assert calls == [fn, fn]
  for g, t in zip(got, together):
    assert np.array_equal(g, np.asarray(t.glom()))
  want = [_g(o) for o in getattr(ref.linalg, name)(a, **kw)]
  if name == "svd":
    u, s, vt = got
    np.testing.assert_allclose((u * s) @ vt, a, atol=1e-12)
    _close(s, want[1])
  elif name == "eigh":
    w, v = got
    np.testing.assert_allclose(a @ v, v * w, atol=1e-10)
    _close(w, want[0])
  elif name == "qr":
    q, r = got
    np.testing.assert_allclose(q @ r, a, atol=1e-12)
    _close(np.abs(r), np.abs(want[1]))
  else:
    assert float(got[0]) == float(want[0])
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-13)


def test_sparse_norm_and_spsolve(rng):
  """``sp.sparse.linalg.norm`` is the Frobenius norm over the stored values
  (the reference's), its float32 sum one K1 reduction; ``spsolve``
  densifies and solves up to ``--spsolve_dense_max`` rows."""
  from spartan_tpu_torch.backend.kernels import fused_reduce as K1
  import spartan_tpu.sparse_linalg as rspl
  M = ss.random(60, 60, density=0.1, random_state=np.random.RandomState(3))
  M = (M + ss.eye(60) * 4).tocsr()
  S = sp.sparse.from_scipy(M)
  got = float(_g(sp.sparse_linalg.norm(S)))
  np.testing.assert_allclose(got, float(_g(rspl.norm(
      ref.sparse.from_scipy(M)))), rtol=1e-14)
  np.testing.assert_allclose(got, ss.linalg.norm(M), rtol=1e-14)
  S32 = sp.sparse.from_scipy(M.astype(np.float32))
  K1.reset_counts()
  got32 = float(_g(sp.sparse_linalg.norm(S32)))
  assert K1.counts["plain_runs"] == 1  # the kernel's plain version on CPU
  np.testing.assert_allclose(got32, ss.linalg.norm(M), rtol=1e-6)
  with pytest.raises(ValueError):
    sp.sparse_linalg.norm(S, ord=1)
  d = rng.standard_normal((5, 5))
  _close(_g(sp.sparse_linalg.norm(d)), np.linalg.norm(d))
  b = rng.standard_normal(60)
  x = _g(sp.sparse_linalg.spsolve(S, b))
  _close(x, _g(rspl.spsolve(ref.sparse.from_scipy(M), b)))
  _close(x, ss.linalg.spsolve(M.tocsc(), b))
  _close(_g(sp.sparse_linalg.spsolve(d, b[:5])), np.linalg.solve(d, b[:5]))
  old = FLAGS.spsolve_dense_max
  FLAGS.spsolve_dense_max = 50
  try:
    with pytest.raises(ValueError, match="spsolve_dense_max"):
      sp.sparse_linalg.spsolve(S, b)
  finally:
    FLAGS.spsolve_dense_max = old
