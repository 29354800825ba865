"""The Krylov solvers of ``sp.sparse.linalg`` in both packages on the same
seeded inputs: the counterparts of the reference's
``tests/test_sparse_linalg.py`` for the twelve ported names, each held to
the reference's ``x`` and ``info`` and to scipy (or a direct solve), in
float64 and in float32.

The reference's float32 solve under x64 raises (its float32 inner products
come out float64 and change a carry's dtype), so its float32 runs here set
its ``--float64_reductions`` off: its inner products are then float32, as
on its TPU.  The port keeps its flags: its inner products accumulate in
float64 and round to float32 once.

Tolerances, relative to max|x|:
* float64 against the reference: 1e-10 (the same recurrence; inner
  products summed in another order, a difference of about 1e-16 that the
  iteration amplifies by at most the condition number, below 1e3 here);
* float32 against the reference: ``F32`` = 100 · κ · 2^-24 (both round
  every vector op to float32, at 6e-8 of the value; the error of a
  converged Krylov solve is bounded by κ times the residual's, and the two
  stop within an iteration of each other);
* against scipy or a direct solve: the reference test's bound in float64,
  and κ · (rtol + 1000 · 2^-24) in float32: the solve stops when its
  recursively updated residual reaches rtol, which bounds the relative
  error by κ · rtol; in float32 that residual drifts from the true one by
  about 2^-24 a step, over the few hundred steps of these solves.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as ss
import scipy.sparse.linalg as ssl
import torch

import spartan_tpu as ref
import spartan_tpu.sparse_linalg as rspl

import spartan_tpu_torch as sp
from spartan_tpu_torch import sparse_linalg as spl
from spartan_tpu_torch.backend import sparse as sps
from spartan_tpu_torch.backend.kernels import spmv as KS
from spartan_tpu_torch.config import FLAGS
from spartan_tpu_torch.expr.loop import SymbolicVal

DTYPES = [np.float64, np.float32]
EPS32 = 2.0 ** -24


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


@pytest.fixture(params=DTYPES, ids=lambda d: d.__name__)
def dtype(request):
  """Each solver in float64 and float32; the reference's float32 solve
  with its float32 inner products (its x64 one raises)."""
  ref.FLAGS.float64_reductions = request.param == np.float64
  yield request.param
  ref.FLAGS.float64_reductions = True


@pytest.fixture
def rng():
  return np.random.default_rng(42)


def _spd(rng, n):
  Q = rng.standard_normal((n, n))
  A = Q @ Q.T + n * np.eye(n)
  xt = rng.standard_normal(n)
  return A, xt, A @ xt


def _sparse_spd(n, density=0.05, seed=2):
  G = ss.random(n, n, density=density,
                random_state=np.random.RandomState(seed), format="csr")
  A = (G + G.T).tocsr()
  A = A + ss.diags(np.asarray(np.abs(A).sum(axis=1)).ravel() + 1.0)
  return A.tocsr()


def _nonsym(rng, n):
  A = rng.standard_normal((n, n)) * 0.3 + n * 0.15 * np.eye(n)
  xt = rng.standard_normal(n)
  return A, xt, A @ xt


def _kappa(A) -> float:
  A = A.toarray() if ss.issparse(A) else np.asarray(A)
  return float(np.linalg.cond(A))


def _tol(dtype, kappa) -> float:
  """The bound on the two packages' difference, relative to max|x|."""
  return 1e-10 if dtype == np.float64 else 100 * kappa * EPS32


def _operands(A, dtype):
  """A (dense or scipy sparse) as each package's operand in ``dtype``."""
  if ss.issparse(A):
    A = ss.csr_matrix(A, dtype=dtype)
    return sp.sparse.from_scipy(A), ref.sparse.from_scipy(A)
  return A.astype(dtype), A.astype(dtype)


def _x(v) -> np.ndarray:
  return np.asarray(sp.lazify(v).glom())


def _rx(v) -> np.ndarray:
  return np.asarray(ref.lazify(v).glom())


def _agree(name, A, b, dtype, kappa, **kw):
  """Run solver ``name`` in both packages; hold x and info to each other.
  Returns the port's x (numpy) and info."""
  Ap, Ar = _operands(A, dtype)
  bb = np.asarray(b, dtype)
  x, info = getattr(spl, name)(Ap, bb, **kw)
  xr, info_r = getattr(rspl, name)(Ar, bb, **kw)
  got, want = _x(x), _rx(xr)
  assert got.dtype == dtype
  assert info == info_r
  np.testing.assert_allclose(got, want, rtol=0,
                             atol=_tol(dtype, kappa) * np.abs(want).max())
  return got, info


def _to_direct(got, xt, dtype, kappa, rtol, atol64):
  """x against the direct solution: the reference test's bound in
  float64, κ · rtol of max|x| (plus the float32 rounding) in float32."""
  if dtype == np.float64:
    np.testing.assert_allclose(got, xt, atol=atol64)
  else:
    bound = kappa * (rtol + 1000 * EPS32) * np.abs(xt).max()
    np.testing.assert_allclose(got, xt, rtol=0, atol=bound)


def test_cg_dense_matches_direct(rng, dtype):
  A, xt, b = _spd(rng, 96)
  rtol = 1e-12 if dtype == np.float64 else 1e-5
  got, info = _agree("cg", A, b, dtype, _kappa(A), rtol=rtol)
  assert info == 0
  _to_direct(got, xt, dtype, _kappa(A), rtol, 1e-8)
  _to_direct(got, ssl.cg(A, b, rtol=rtol)[0], dtype, _kappa(A), rtol, 1e-8)


def test_cg_sparse_and_jacobi_preconditioner(rng, dtype):
  A = _sparse_spd(160)
  xt = rng.standard_normal(160)
  b = A @ xt
  rtol = 1e-12 if dtype == np.float64 else 1e-5
  got, info = _agree("cg", A, b, dtype, _kappa(A), rtol=rtol)
  assert info == 0
  _to_direct(got, xt, dtype, _kappa(A), rtol, 1e-9)
  dinv = (1.0 / A.diagonal()).astype(dtype)
  S, Sr = _operands(A, dtype)
  M = spl.LinearOperator((160, 160), lambda v: sp.lazify(dinv) * v)
  Mr = rspl.LinearOperator((160, 160), lambda v: ref.lazify(dinv) * v)
  x2, info2 = spl.cg(S, b.astype(dtype), rtol=rtol, M=M)
  xr2, info_r2 = rspl.cg(Sr, b.astype(dtype), rtol=rtol, M=Mr)
  assert info2 == info_r2 == 0
  np.testing.assert_allclose(_x(x2), _rx(xr2), rtol=0,
                             atol=_tol(dtype, _kappa(A)) * np.abs(xt).max())
  _to_direct(_x(x2), xt, dtype, _kappa(A), rtol, 1e-9)
  want = ssl.cg(A, b, rtol=rtol, M=ss.diags(1.0 / A.diagonal()))[0]
  _to_direct(_x(x2), want, dtype, _kappa(A), rtol, 1e-9)


def test_cg_block_multi_rhs(rng, dtype):
  n, k = 160, 5
  Q = rng.standard_normal((n, n))
  A = Q @ Q.T + n * np.eye(n)
  Xt = rng.standard_normal((n, k))
  rtol = 1e-11 if dtype == np.float64 else 1e-5
  Ap, Ar = _operands(A, dtype)
  B = (A @ Xt).astype(dtype)
  X, info = spl.cg(Ap, B, rtol=rtol)
  Xr, info_r = rspl.cg(Ar, B, rtol=rtol)
  got = _x(X)
  assert info == info_r == 0 and got.dtype == dtype
  np.testing.assert_allclose(got, _rx(Xr), rtol=0,
                             atol=_tol(dtype, _kappa(A)) * np.abs(Xt).max())
  _to_direct(got, Xt, dtype, _kappa(A), rtol, 1e-8)
  # sparse operand, mixed column scales, one zero column
  Asp = _sparse_spd(n)
  S, Sr = _operands(Asp, dtype)
  Xt2 = Xt * np.array([1e-3, 1.0, 10.0, 100.0, 1.0])
  B2 = Asp @ Xt2
  B2[:, 4] = 0.0
  rtol2 = 1e-10 if dtype == np.float64 else 1e-5
  X2, info2 = spl.cg(S, B2.astype(dtype), rtol=rtol2)
  Xr2, info_r2 = rspl.cg(Sr, B2.astype(dtype), rtol=rtol2)
  assert info2 == info_r2 == 0
  got2, want2 = _x(X2), _rx(Xr2)
  for j in range(4):
    scale = max(np.abs(Xt2[:, j]).max(), 1.0)
    bound = (1e-7 if dtype == np.float64
             else _kappa(Asp) * (rtol2 + 1000 * EPS32))
    assert np.abs(got2[:, j] - Xt2[:, j]).max() <= bound * scale
    assert np.abs(got2[:, j] - want2[:, j]).max() <= _tol(
        dtype, _kappa(Asp)) * scale
  assert np.abs(got2[:, 4]).max() == 0.0


def test_cg_nonconverged_info_and_zero_b(rng, dtype):
  A, xt, b = _spd(rng, 64)
  Ap, Ar = _operands(A, dtype)
  x, info = spl.cg(Ap, b.astype(dtype), rtol=1e-14, maxiter=2)
  xr, info_r = rspl.cg(Ar, b.astype(dtype), rtol=1e-14, maxiter=2)
  assert info == info_r == 2  # iteration count at exit, scipy convention
  np.testing.assert_allclose(_x(x), _rx(xr), rtol=0,
                             atol=_tol(dtype, _kappa(A)) * np.abs(_rx(xr)).max())
  x0, info0 = spl.cg(Ap, np.zeros(64, dtype), rtol=1e-12)
  assert info0 == 0
  assert np.abs(_x(x0)).max() == 0.0 and _x(x0).dtype == dtype


def test_bicgstab_nonsymmetric(rng, dtype):
  n = 96
  B = rng.standard_normal((n, n)) + n * np.eye(n)
  xt = rng.standard_normal(n)
  rtol = 1e-11 if dtype == np.float64 else 1e-5
  got, info = _agree("bicgstab", B, B @ xt, dtype, _kappa(B), rtol=rtol)
  assert info == 0
  _to_direct(got, xt, dtype, _kappa(B), rtol, 1e-7)
  want = ssl.bicgstab(B, B @ xt, rtol=rtol)[0]
  _to_direct(got, want, dtype, _kappa(B), rtol, 1e-7)


def test_minres_symmetric_indefinite(rng, dtype):
  n = 120
  Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
  d = np.concatenate([np.linspace(1, n // 2, n // 2),
                      -np.linspace(1, n // 2, n - n // 2)])
  A = (Q * d) @ Q.T   # indefinite: cg's SPD assumption fails here
  xt = rng.standard_normal(n)
  rtol = 1e-12 if dtype == np.float64 else 1e-5
  got, info = _agree("minres", A, A @ xt, dtype, _kappa(A), rtol=rtol)
  assert info == 0
  _to_direct(got, xt, dtype, _kappa(A), rtol, 1e-9)
  want = ssl.minres(A, A @ xt, rtol=rtol)[0]
  _to_direct(got, want, dtype, _kappa(A), rtol, 1e-9)
  # sparse operand
  As = ss.csr_matrix(A * (np.abs(A) > 0.05))
  As = ((As + As.T) / 2).tocsr()
  rtol_s = 1e-10 if dtype == np.float64 else 1e-5
  got_s, info_s = _agree("minres", As, As @ xt, dtype, _kappa(As),
                         rtol=rtol_s)
  assert info_s == 0
  bound = 1e-7 if dtype == np.float64 else (
      (rtol_s + 100 * EPS32) * np.abs(As @ xt).max() * 10)
  assert np.abs(As @ got_s - As @ xt).max() < bound


def test_gmres_restarted_matches_direct(rng, dtype):
  n = 80
  B = rng.standard_normal((n, n)) + 0.5 * n * np.eye(n)
  xt = rng.standard_normal(n)
  rtol = 1e-11 if dtype == np.float64 else 1e-5
  # restart far below n forces the in-loop restart path
  got, info = _agree("gmres", B, B @ xt, dtype, _kappa(B), rtol=rtol,
                     restart=15)
  assert info == 0
  _to_direct(got, xt, dtype, _kappa(B), rtol, 1e-7)
  want = ssl.gmres(B, B @ xt, rtol=rtol, restart=15)[0]
  _to_direct(got, want, dtype, _kappa(B), rtol, 1e-7)


def test_gmres_left_preconditioned_sparse(rng, dtype):
  A = _sparse_spd(128)
  B = (A + ss.diags(rng.standard_normal(128) * 0.1)).tocsr()
  xt = rng.standard_normal(128)
  dinv = (1.0 / B.diagonal()).astype(dtype)
  S, Sr = _operands(B, dtype)
  M = spl.LinearOperator((128, 128), lambda v: sp.lazify(dinv) * v)
  Mr = rspl.LinearOperator((128, 128), lambda v: ref.lazify(dinv) * v)
  rtol = 1e-11 if dtype == np.float64 else 1e-5
  x, info = spl.gmres(S, (B @ xt).astype(dtype), rtol=rtol, restart=25, M=M)
  xr, info_r = rspl.gmres(Sr, (B @ xt).astype(dtype), rtol=rtol, restart=25,
                          M=Mr)
  assert info == info_r == 0
  np.testing.assert_allclose(_x(x), _rx(xr), rtol=0,
                             atol=_tol(dtype, _kappa(B)) * np.abs(xt).max())
  _to_direct(_x(x), xt, dtype, _kappa(B), rtol, 1e-7)
  want = ssl.gmres(B, B @ xt, rtol=rtol, restart=25,
                   M=ss.diags(1.0 / B.diagonal()))[0]
  _to_direct(_x(x), want, dtype, _kappa(B), rtol, 1e-7)


def test_lsqr_overdetermined_matches_numpy(rng, dtype):
  X = rng.standard_normal((200, 40))
  y = rng.standard_normal(200)
  atol = 1e-13 if dtype == np.float64 else 1e-5
  Xp, Xr = _operands(X, dtype)
  x, istop, itn, r1 = spl.lsqr(Xp, y.astype(dtype), atol=atol)
  xr, istop_r, itn_r, r1_r = rspl.lsqr(Xr, y.astype(dtype), atol=atol)
  assert istop == istop_r == 1 and itn > 0 and abs(itn - itn_r) <= 1
  want = np.linalg.lstsq(X, y, rcond=None)[0]
  kappa = _kappa(X)
  np.testing.assert_allclose(_x(x), _rx(xr), rtol=0,
                             atol=_tol(dtype, kappa ** 2) * np.abs(want).max())
  sc = ssl.lsqr(X, y, atol=1e-13, btol=1e-13)
  assert abs(r1 - sc[3]) <= 1e-6 * sc[3]
  if dtype == np.float64:
    np.testing.assert_allclose(_x(x), want, atol=1e-9)
    np.testing.assert_allclose(_x(x), sc[0], atol=1e-9)
    assert abs(r1 - np.linalg.norm(X @ want - y)) < 1e-8
  else:
    bound = kappa ** 2 * (atol + 1000 * EPS32)
    np.testing.assert_allclose(_x(x), want, rtol=0,
                               atol=bound * np.abs(want).max())
    assert abs(r1 - np.linalg.norm(X @ want - y)) < 1e-4 * np.linalg.norm(y)


def test_lsqr_damped_matches_ridge(rng, dtype):
  X = rng.standard_normal((120, 30))
  y = rng.standard_normal(120)
  damp = 0.7
  atol = 1e-13 if dtype == np.float64 else 1e-5
  Xp, Xr = _operands(X, dtype)
  x, istop, itn, _ = spl.lsqr(Xp, y.astype(dtype), damp=damp, atol=atol)
  xr, istop_r, _, _ = rspl.lsqr(Xr, y.astype(dtype), damp=damp, atol=atol)
  assert istop == istop_r == 1
  want = np.linalg.solve(X.T @ X + damp ** 2 * np.eye(30), X.T @ y)
  kappa2 = _kappa(X.T @ X + damp ** 2 * np.eye(30))
  np.testing.assert_allclose(_x(x), _rx(xr), rtol=0,
                             atol=_tol(dtype, kappa2) * np.abs(want).max())
  _to_direct(_x(x), want, dtype, kappa2, atol, 1e-9)


def test_linear_operator_surface(rng):
  A = rng.standard_normal((12, 8))
  op = spl.aslinearoperator(A)
  x = rng.standard_normal(8)
  np.testing.assert_allclose(_x(op @ x), A @ x, atol=1e-12)
  y = rng.standard_normal(12)
  np.testing.assert_allclose(_x(op.T @ y), A.T @ y, atol=1e-12)
  assert op.shape == (12, 8) and op.T.shape == (8, 12)
  mv_only = spl.LinearOperator((8, 8), lambda v: v * 2.0)
  with pytest.raises(ValueError, match="rmatvec"):
    mv_only.rmatvec(x)
  with pytest.raises(ValueError, match="rmatvec"):
    mv_only.T
  assert spl.aslinearoperator(mv_only) is mv_only
  with pytest.raises(ValueError, match="2-D"):
    spl.aslinearoperator(np.ones(3))
  with pytest.raises(ValueError, match=r"\(m, n\)"):
    spl.LinearOperator((3,), lambda v: v)
  rop = rspl.aslinearoperator(A)
  np.testing.assert_allclose(_x(op @ x), _rx(rop @ x), rtol=1e-12)
  # a sparse operand: matvec and the memoised transpose's rmatvec
  S_np = _sparse_spd(40) + ss.random(40, 40, density=0.1, random_state=3)
  S = sp.sparse.from_scipy(S_np.tocsr())
  sop = spl.aslinearoperator(S)
  v = rng.standard_normal(40)
  np.testing.assert_allclose(_x(sop.matvec(v)), S_np @ v, rtol=1e-12)
  np.testing.assert_allclose(_x(sop.rmatvec(v)), S_np.T @ v, rtol=1e-12)
  sop.rmatvec(v)
  assert S.T is S.transpose()  # built once, then memoised


def test_lstsq_kernel_matches_jnp_on_a_rank_deficient_hessenberg(rng, dtype):
  """Inside a restart cycle every column of H after column j is zero: the
  least-squares solve must drop those directions (``jnp.linalg.lstsq``'s
  SVD cutoff) and give the minimum-norm solution, with no inf or NaN."""
  m, j = 20, 6
  H = np.zeros((m + 1, m))
  for c in range(j + 1):
    H[:c + 2, c] = rng.standard_normal(c + 2)
  g = np.zeros(m + 1)
  g[0] = 3.5
  H, g = H.astype(dtype), g.astype(dtype)
  got = spl._lstsq_kernel(torch.from_numpy(H), torch.from_numpy(g)).numpy()
  want = np.asarray(jnp.linalg.lstsq(jnp.asarray(H), jnp.asarray(g))[0])
  assert got.dtype == dtype and np.isfinite(got).all()
  assert np.abs(got[j + 1:]).max() == 0.0
  tol = 1e-12 if dtype == np.float64 else 1e-4
  np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())
  # the full-rank case at the cycle's last step
  H2 = np.triu(rng.standard_normal((m + 1, m)), -1).astype(dtype)
  got2 = spl._lstsq_kernel(torch.from_numpy(H2), torch.from_numpy(g)).numpy()
  want2 = np.asarray(jnp.linalg.lstsq(jnp.asarray(H2), jnp.asarray(g))[0])
  np.testing.assert_allclose(got2, want2, rtol=0,
                             atol=tol * 10 * np.abs(want2).max())


def test_no_torch_lstsq_in_the_port():
  """On the card ``torch.linalg.lstsq`` has only the QR driver (gels),
  which assumes full rank; the port's least-squares solves (gmres's,
  polyfit's) are the SVD form of ``builtins._lstsq_svd`` instead."""
  import pathlib
  root = pathlib.Path(sp.__file__).parent
  assert [p for p in root.rglob("*.py")
          if "torch.linalg.lstsq" in p.read_text()] == []


@pytest.mark.parametrize("m, want_fmt", [(32768, "ell"), (32769, "win")])
def test_sparse_operator_matvec_plans_onto_the_kernel_routes(m, want_fmt):
  """A SparseArray operator's matvec is ``sp.dot(A, x)`` with no precision:
  an ``SpMVExpr`` that a CUDA device routes onto K3a (ELL, up to 32768
  columns) or K3b (CSR, beyond).  ``precision="highest"`` would keep it on
  the plain gather."""
  A_np = ss.random(64, m, density=4.0 / m, random_state=5, format="csr",
                   dtype=np.float32)
  S = sp.sparse.from_scipy(A_np)
  op = spl.aslinearoperator(S)
  v = sp.lazify(np.ones(m, np.float32))
  e = op.matvec(v)
  assert isinstance(e, sps.SpMVExpr) and e.precision is None
  fmt, _ = sps._route(S, torch.float32, on_accel=True)
  assert fmt == want_fmt
  assert sps._route(S, torch.float32, on_accel=True, exact=True)[0] == "ell"
  inside = op.matvec(SymbolicVal(v.aval()))
  assert isinstance(inside, sps.SpMVExpr) and inside.precision is None


@pytest.mark.parametrize("name", sorted(spl._MATVECS))
def test_matvecs_per_solve(monkeypatch, name):
  """The SpMVs one solve runs, as ``sparse_linalg._MATVECS`` states them
  (an iteration of its loop, and outside it), counted as the ELL
  wrapper's runs with the kernel route forced on the CPU (``A`` and
  ``A.T`` alike).  chip_smoke.py's phase 19 and the card tests hold the
  card's launches to the same table."""
  per_iter, extra = spl._MATVECS[name]
  A = _sparse_spd(96, seed=7)
  if name not in ("cg", "minres"):
    A = (A + ss.diags(np.linspace(0, 1, 95), 1)).tocsr()
  xt = np.random.default_rng(8).standard_normal(96)
  S = sp.sparse.from_scipy(A.astype(np.float32))
  b = (A @ xt).astype(np.float32)
  monkeypatch.setattr(FLAGS, "sparse_force_onehot", True)
  KS.reset_counts()
  with spl._loops_run() as runs:
    if name in ("lsqr", "lsmr"):
      ok = getattr(spl, name)(S, b, atol=1e-5)[1] in (1, 2)
    else:
      ok = getattr(spl, name)(S, b, rtol=1e-5)[1] == 0
  assert ok and len(runs) == 1
  iters = spl._iterations(name, runs[0][0])
  assert iters > 2
  assert KS.counts["ell_plain_runs"] == per_iter * iters + extra
  assert KS.counts["ell_launches"] == 0


@pytest.mark.parametrize("name", sorted(set(spl._MATVECS) - {"lsmr"}))
def test_float32_solve_within_its_residual_bound(name):
  """A float32 solve of a SparseArray, its true residual in float64 within
  the bound ``sparse_linalg._residual_bound`` fixes from rtol, the
  iterations and |A|_2 |A^-1|_2 (``_normal_bound`` from atol for lsqr),
  and the same x scaled by 1 + 1e-3 past it: the bounds the card tests and
  chip_smoke.py's phase 19 hold the card's solves to.  The system is
  diagonally dominant with margin 1 by rows and by columns, so |A^-1|_2
  <= 1 and |x|_2 <= |b|_2; |A|_2 <= sqrt(|A|_1 |A|_inf)."""
  n = 512
  A = _sparse_spd(n, density=16.0 / n, seed=3)
  if name not in ("cg", "minres"):
    A = (A + ss.diags([np.full(n, 0.5), np.full(n - 1, 0.5)], [0, 1])
         ).tocsr()
  b = np.random.default_rng(9).standard_normal(n).astype(np.float32)
  b64 = b.astype(np.float64)
  aa = abs(A)
  a_norm = float(np.sqrt(aa.sum(axis=0).max() * aa.sum(axis=1).max()))
  S = sp.sparse.from_scipy(A.astype(np.float32))
  with spl._loops_run() as runs:
    out = getattr(spl, name)(S, b, **({"atol": 1e-6} if name == "lsqr"
                                       else {"rtol": 1e-5}))
  assert out[1] == (1 if name == "lsqr" else 0)
  iters = spl._iterations(name, runs[-1][0])
  x = out[0].glom().astype(np.float64)
  assert out[0].dtype == torch.float32
  b_norm = np.linalg.norm(b64)
  if name == "lsqr":
    atb = np.linalg.norm(A.T @ b64)
    x_norm = np.linalg.norm(ssl.spsolve(A.tocsc(), b64))
    bound = spl._normal_bound(1e-6, iters, a_norm, x_norm, b_norm, atb)
    held = [np.linalg.norm(A.T @ (b64 - A @ v)) / atb
            for v in (x, x * (1 + 1e-3))]
  else:
    bound = spl._residual_bound(1e-5, iters, a_norm, b_norm, b_norm)
    held = [np.linalg.norm(b64 - A @ v) / b_norm for v in (x, x * (1 + 1e-3))]
  assert held[0] <= bound < held[1]


def test_bicg_matches_direct(rng, dtype):
  A, xt, b = _nonsym(rng, 64)
  rtol = 1e-12 if dtype == np.float64 else 1e-5
  got, info = _agree("bicg", A, b, dtype, _kappa(A), rtol=rtol, maxiter=500)
  assert info == 0
  _to_direct(got, xt, dtype, _kappa(A), rtol, 1e-7)
  _to_direct(got, ssl.bicg(A, b, rtol=rtol, maxiter=500)[0], dtype,
             _kappa(A), rtol, 1e-7)
  # sparse operand (the transpose built before the loop)
  S = _sparse_spd(96)
  bt = S @ np.ones(96)
  got_s, info_s = _agree("bicg", S, bt, dtype, _kappa(S), rtol=rtol)
  assert info_s == 0
  _to_direct(got_s, np.ones(96), dtype, _kappa(S), rtol, 1e-7)


def test_cgs_matches_direct(rng, dtype):
  A, xt, b = _nonsym(rng, 64)
  rtol = 1e-12 if dtype == np.float64 else 1e-5
  got, info = _agree("cgs", A, b, dtype, _kappa(A), rtol=rtol, maxiter=500)
  assert info == 0
  _to_direct(got, xt, dtype, _kappa(A), rtol, 1e-6)
  want = ssl.cgs(A, b, rtol=rtol, maxiter=500)[0]
  _to_direct(got, want, dtype, _kappa(A), rtol, 1e-6)


def test_tfqmr_matches_direct(rng, dtype):
  A, xt, b = _nonsym(rng, 64)
  rtol = 1e-10 if dtype == np.float64 else 1e-5
  got, info = _agree("tfqmr", A, b, dtype, _kappa(A), rtol=rtol, maxiter=500)
  assert info == 0
  _to_direct(got, xt, dtype, _kappa(A), rtol, 1e-6)
  _to_direct(got, ssl.tfqmr(A, b, rtol=rtol, maxiter=500)[0], dtype,
             _kappa(A), rtol, 1e-6)
  S = _sparse_spd(96)
  bt = S @ np.ones(96)
  got_s, info_s = _agree("tfqmr", S, bt, dtype, _kappa(S), rtol=rtol)
  assert info_s == 0
  _to_direct(got_s, np.ones(96), dtype, _kappa(S), rtol, 1e-6)


def test_qmr_matches_direct(rng, dtype):
  A, xt, b = _nonsym(rng, 48)
  rtol = 1e-11 if dtype == np.float64 else 1e-5
  got, info = _agree("qmr", A, b, dtype, _kappa(A), rtol=rtol, maxiter=500)
  assert info == 0
  _to_direct(got, xt, dtype, _kappa(A), rtol, 1e-6)
  want = ssl.qmr(A, b, rtol=rtol, maxiter=500)[0]
  _to_direct(got, want, dtype, _kappa(A), rtol, 1e-6)
  with pytest.raises(NotImplementedError, match="M1/M2"):
    spl.qmr(A, b, M1=np.eye(48))


def test_lsmr_overdetermined_and_damped(rng, dtype):
  A = rng.standard_normal((80, 24))
  b = rng.standard_normal(80)
  tols = (1e-12 if dtype == np.float64 else 1e-6)
  Ap, Ar = _operands(A, dtype)
  out = spl.lsmr(Ap, b.astype(dtype), atol=tols, btol=tols, maxiter=200)
  out_r = rspl.lsmr(Ar, b.astype(dtype), atol=tols, btol=tols, maxiter=200)
  want, *_ = np.linalg.lstsq(A, b, rcond=None)
  kappa2 = _kappa(A) ** 2
  assert out[1] == out_r[1] == 2  # a least-squares solution, not Ax = b
  assert abs(out[2] - out_r[2]) <= 1
  np.testing.assert_allclose(_x(out[0]), _rx(out_r[0]), rtol=0,
                             atol=_tol(dtype, kappa2) * np.abs(want).max())
  _to_direct(_x(out[0]), want, dtype, kappa2, tols, 1e-7)
  # normr, normA, condA, normx; normar is at the stopping bound
  # atol · normA · normr, far below its own rounding
  rt = 1e-6 if dtype == np.float64 else 1e-3
  np.testing.assert_allclose([out[i] for i in (3, 5, 6, 7)],
                             [out_r[i] for i in (3, 5, 6, 7)], rtol=rt)
  assert out[4] <= tols * out[5] * out[3] * (1 + 1e-6)
  sc = ssl.lsmr(A, b, atol=tols, btol=tols, maxiter=200)
  np.testing.assert_allclose(out[3], sc[3], rtol=rt)
  # damped: the ridge solution
  damp = 0.5
  x_d = spl.lsmr(Ap, b.astype(dtype), damp=damp, atol=tols, btol=tols,
                 maxiter=200)[0]
  ridge = np.linalg.solve(A.T @ A + damp ** 2 * np.eye(24), A.T @ b)
  _to_direct(_x(x_d), ridge, dtype, kappa2, tols, 1e-7)


@pytest.mark.parametrize("name", ["cg", "bicgstab", "minres", "gmres",
                                  "bicg", "cgs", "tfqmr", "qmr"])
def test_float32_solves_keep_float32_carries(name):
  """Every carry of a float32 solve stays float32 under the port's default
  flags (``while_loop`` raises on any dtype change); the reference's
  float32 solve under x64 changes a carry to float64 and raises."""
  A = _sparse_spd(64, density=0.1)
  b = (A @ np.ones(64)).astype(np.float32)
  S = sp.sparse.from_scipy(A.astype(np.float32))
  x, info = getattr(spl, name)(S, b, rtol=1e-5)
  assert info == 0 and _x(x).dtype == np.float32
  with pytest.raises(TypeError, match="carry"):
    getattr(rspl, name)(ref.sparse.from_scipy(A.astype(np.float32)), b,
                        rtol=1e-5)


def test_integer_rhs_solves_in_float64(rng):
  A, xt, b = _spd(rng, 32)
  x, info = spl.cg(A, np.rint(b).astype(np.int64), rtol=1e-12)
  assert info == 0 and _x(x).dtype == np.float64
  np.testing.assert_allclose(_x(x), np.linalg.solve(A, np.rint(b)),
                             atol=1e-9)


def test_sparse_linalg_is_sp_sparse_linalg():
  assert sp.sparse.linalg is spl is sp.sparse_linalg
  assert sorted(spl.__all__) == sorted(rspl.__all__)
  for name in spl.__all__:
    if name == "SuperLU":  # scipy's own class, in both packages
      assert spl.SuperLU is rspl.SuperLU
      continue
    assert getattr(spl, name) is not getattr(rspl, name)
