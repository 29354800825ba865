"""The Krylov solvers of the ``scipy.sparse.linalg`` surface.

Port of the solver half of ``spartan_tpu/sparse_linalg.py``: ``cg`` (also
over a block of right-hand sides), ``bicgstab``, ``minres``, ``gmres``,
``lsqr``, ``bicg``, ``cgs``, ``tfqmr``, ``qmr`` and ``lsmr``, with
``LinearOperator`` and ``aslinearoperator``.  Each solve is one
:func:`spartan_tpu_torch.while_loop` whose body is the reference's: the
scalar recurrences ride the carry, the vector arithmetic is plain torch
ops, and the matvec of a ``SparseArray`` is ``sp.dot(A, x)``, an
``SpMVExpr`` that routes to the SpMV kernels (K3a up to 32768 columns,
K3b past them; K3a sharded and K3d on a mesh of several shards).  The loop
reads its condition on the host once an iteration.

Krylov bases are ``(m+1, n)`` row blocks updated by rank-1 one-hot outer
products, as in the reference.  Inner products are
``sp.dot(..., precision="highest")`` returned in the operands' dtype: under
``--float64_reductions`` a float32 product accumulates in float64 and
rounds once, so a float32 solve keeps every carry in float32 (the
reference's float32 solve under x64 changes a carry's dtype and raises).

``norm`` and ``spsolve`` come with ``sp.linalg``: a ``SparseArray``'s
Frobenius norm is ``sqrt(sum(square(v)))`` over its stored values (a
float32 one's sum plans onto K1), and ``spsolve`` densifies a system of at most
``--spsolve_dense_max`` rows and solves it by LU on the device.

The reference's spectral solvers (``eigsh``, ``eigs``, ``svds``,
``expm_multiply``) and its densified and host functions are not ported
yet.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import numpy as np
import torch

import spartan_tpu_torch as sp
from spartan_tpu_torch.config import FLAGS, IntFlag
from spartan_tpu_torch.core.array import SpartanArray, to_numpy_dtype
from spartan_tpu_torch.expr.base import Expr
from spartan_tpu_torch.expr.builtins import _lstsq_svd
from spartan_tpu_torch.expr.map import result_type, structural

FLAGS.add(IntFlag(
    "spsolve_dense_max", 8192,
    "spsolve densifies and LU-factorizes up to this many rows; larger "
    "systems raise (use cg/gmres/lsqr)"))

__all__ = [
    "LinearOperator", "aslinearoperator", "cg", "bicgstab", "gmres",
    "minres", "lsqr", "bicg", "cgs", "tfqmr", "qmr", "lsmr", "norm",
    "spsolve",
]

_TINY = 1e-30


def _default_float():
  """The dtype a non-float right-hand side is solved in: float64, the
  reference's under ``jax_enable_x64``."""
  return np.dtype(np.float64)


def _hi_dot(a, b):
  """``sp.dot(a, b, precision="highest")`` in NumPy's result dtype of the
  operands (a float32 product accumulated in float64 rounds once)."""
  a, b = sp.lazify(a), sp.lazify(b)
  out = sp.dot(a, b, precision="highest")
  want = result_type(a.dtype, b.dtype)
  return out if out.dtype == want else out.astype(want)


def _np_dtype(v) -> np.dtype:
  return np.dtype(to_numpy_dtype(v.dtype))


class LinearOperator:
  """Matrix-free operator: ``matvec`` (and optional ``rmatvec``) are
  expr-level callables ``(n,) expr -> (m,) expr`` whose bodies may use
  any lazy ops (they are built into the solver's loop body)."""

  def __init__(self, shape, matvec: Callable, rmatvec: Callable = None,
               dtype=None):
    self.shape = tuple(int(s) for s in shape)
    if len(self.shape) != 2:
      raise ValueError("LinearOperator shape must be (m, n)")
    self._matvec = matvec
    self._rmatvec = rmatvec
    self.dtype = (dtype if dtype is None or isinstance(dtype, torch.dtype)
                  else np.dtype(dtype))

  def matvec(self, x):
    return self._matvec(x)

  def rmatvec(self, x):
    if self._rmatvec is None:
      raise ValueError("this LinearOperator has no rmatvec (pass one to "
                       "use lsqr/svds/transpose)")
    return self._rmatvec(x)

  @property
  def T(self):
    if self._rmatvec is None:
      raise ValueError("cannot transpose a LinearOperator without "
                       "rmatvec (pass one at construction)")
    return LinearOperator((self.shape[1], self.shape[0]),
                          self._rmatvec, self._matvec, dtype=self.dtype)

  def __matmul__(self, x):
    return self.matvec(x)


def aslinearoperator(A) -> LinearOperator:
  """Wrap a dense expr/ndarray, a sparse array, or a LinearOperator."""
  from spartan_tpu_torch.backend import sparse as sps
  if isinstance(A, LinearOperator):
    return A
  if isinstance(A, (sps.SparseArray, sps.BlockSparseArray)):
    # no explicit precision: 'highest' would keep the product off the SpMV
    # kernels (sparse._route's exact gate) and on the plain gather.
    # A.T is built on first rmatvec use (cg/gmres never need it)
    def _rmv(x, _memo=[]):
      if not _memo:
        _memo.append(A.T)
      return sp.dot(_memo[0], x)
    return LinearOperator(
        A.shape, lambda x: sp.dot(A, x),
        _rmv if hasattr(A, "T") else None, dtype=A.dtype)
  Ae = sp.lazify(A)
  if Ae.ndim != 2:
    raise ValueError(f"expected a 2-D operator, got ndim={Ae.ndim}")
  Av = sp.Val(Ae.evaluate())  # share ONE evaluated leaf across the loop
  return LinearOperator(Av.shape, lambda x: _hi_dot(Av, x),
                        lambda x: _hi_dot(x, Av), dtype=Av.dtype)


def _psolve(M) -> Callable:
  if M is None:
    return lambda x: x
  return aslinearoperator(M).matvec


def _setup(A, b, x0):
  op = aslinearoperator(A)
  b = sp.lazify(b)
  if b.ndim != 1 or b.shape[0] != op.shape[0]:
    raise ValueError(f"b shape {b.shape} incompatible with operator "
                     f"{op.shape}")
  n = op.shape[1]
  dt = _np_dtype(b.evaluate())
  if dt.kind != "f":
    dt = _default_float()
    b = b.astype(dt)
  x0e = sp.zeros((n,), dtype=dt) if x0 is None else sp.lazify(x0).astype(dt)
  return op, b, x0e, dt


def _tol_of(b, rtol, atol) -> float:
  bnorm = float(sp.sqrt(_hi_dot(b, b)).glom())
  return max(float(rtol) * bnorm, float(atol)), bnorm


def _i32(v):
  return v.astype(np.int32) if isinstance(v, Expr) else np.int32(v)


def _safe(d):
  return sp.where(sp.abs(d) > _TINY, d, 1.0)


def _residual_info(x, r, tol, k):
  """``(x, info)``: info 0 when the true residual ``r`` meets ``tol``, else
  the iteration count at exit (scipy's convention)."""
  rnorm = float(np.sqrt(float(sp.dot(r, r, precision="highest").glom())))
  return x, (0 if rnorm <= tol * (1 + 1e-6) else int(np.asarray(k.glom())))


def cg(A, b, x0=None, *, rtol: float = 1e-5, atol: float = 0.0,
       maxiter: int = None, M=None):
  """Conjugate gradient for SPD ``A``.  Returns ``(x, info)`` — info 0
  on convergence (``|r| <= max(rtol*|b|, atol)``), else the iteration
  count at exit (scipy convention).  With ``M`` (a preconditioner
  approximating ``A⁻¹``) this is preconditioned CG.  ``b`` may also be an
  (n, k) block of right-hand sides: each column runs its own recurrence in
  one loop until every column meets its own tolerance; returns
  ``(X (n, k), info)``."""
  if getattr(sp.lazify(b), "ndim", 1) == 2:
    return _cg_block(A, b, x0, rtol=rtol, atol=atol, maxiter=maxiter,
                     M=M)
  op, b, x0e, dt = _setup(A, b, x0)
  psolve = _psolve(M)
  tol, bnorm = _tol_of(b, rtol, atol)
  if bnorm == 0.0:
    return sp.zeros((op.shape[1],), dtype=dt).evaluate(), 0
  maxiter = int(maxiter) if maxiter else 10 * op.shape[1]

  r0 = b - op.matvec(x0e)
  z0 = psolve(r0)
  rz0 = _hi_dot(r0, z0)

  def cond(x, r, p, rz, k):
    return (sp.sqrt(_hi_dot(r, r)) > tol) & (k < maxiter)

  def body(x, r, p, rz, k):
    Ap = op.matvec(p)
    denom = _hi_dot(p, Ap)
    alpha = rz / _safe(denom)
    x2 = x + alpha * p
    r2 = r - alpha * Ap
    z2 = psolve(r2)
    rz2 = _hi_dot(r2, z2)
    beta = rz2 / _safe(rz)
    return x2, r2, z2 + beta * p, rz2, _i32(k + 1)

  x, r, _, _, k = sp.while_loop(cond, body, (x0e, r0, z0, rz0, _i32(0)),
                                max_iters=maxiter)
  return _residual_info(x, r, tol, k)


def _cg_block(A, B, x0=None, *, rtol: float = 1e-5, atol: float = 0.0,
              maxiter: int = None, M=None):
  """Multi-RHS CG: independent per-column recurrences, one loop."""
  op = aslinearoperator(A)
  Be = sp.lazify(B)
  if Be.ndim != 2 or Be.shape[0] != op.shape[0]:
    raise ValueError(f"B shape {Be.shape} incompatible with operator "
                     f"{op.shape}")
  n = op.shape[1]
  dt = _np_dtype(Be.evaluate())
  if dt.kind != "f":
    dt = _default_float()
    Be = Be.astype(dt)
  psolve = _psolve(M)
  X0 = sp.zeros((n, Be.shape[1]), dtype=dt) if x0 is None else sp.lazify(
      x0).astype(dt)
  bnorm2 = np.asarray(sp.sum(Be * Be, axis=0).glom(), np.float64)
  tol2 = np.maximum(float(rtol) ** 2 * bnorm2, float(atol) ** 2)
  tol2 = np.maximum(tol2, 1e-300).astype(dt)  # zero columns: converged
  maxiter = int(maxiter) if maxiter else 10 * n

  def _colsum(u, v):
    # (k,) columnwise inner products, in the operands' dtype as _hi_dot's
    return sp.sum(u * v, axis=0).astype(dt)

  R0 = Be - op.matvec(X0)
  Z0 = psolve(R0)
  rz0 = _colsum(R0, Z0)

  def cond(X, R, P, rz, kk):
    return sp.any(_colsum(R, R) > tol2) & (kk < maxiter)

  def body(X, R, P, rz, kk):
    AP = op.matvec(P)
    denom = _colsum(P, AP)
    alpha = rz / _safe(denom)
    X2 = X + alpha * P
    R2 = R - alpha * AP
    Z2 = psolve(R2)
    rz2 = _colsum(R2, Z2)
    beta = rz2 / _safe(rz)
    return X2, R2, Z2 + beta * P, rz2, _i32(kk + 1)

  X, R, _, _, kk = sp.while_loop(cond, body, (X0, R0, Z0, rz0, _i32(0)),
                                 max_iters=maxiter)
  r2 = np.asarray(sp.sum(sp.lazify(R) * sp.lazify(R), axis=0).glom(),
                  np.float64)
  ok = bool((r2 <= tol2.astype(np.float64) * (1 + 1e-6)).all())
  return X, (0 if ok else int(np.asarray(kk.glom())))


def bicgstab(A, b, x0=None, *, rtol: float = 1e-5, atol: float = 0.0,
             maxiter: int = None, M=None):
  """BiCGSTAB for general (nonsymmetric) ``A``, preconditioned, van der
  Vorst form.  Returns ``(x, info)`` like :func:`cg`."""
  op, b, x0e, dt = _setup(A, b, x0)
  psolve = _psolve(M)
  tol, bnorm = _tol_of(b, rtol, atol)
  if bnorm == 0.0:
    return sp.zeros((op.shape[1],), dtype=dt).evaluate(), 0
  maxiter = int(maxiter) if maxiter else 10 * op.shape[1]

  r0 = sp.Val((b - op.matvec(x0e)).evaluate())  # shadow residual, fixed

  def cond(x, r, p, v, rho, alpha, omega, k):
    return (sp.sqrt(_hi_dot(r, r)) > tol) & (k < maxiter)

  def body(x, r, p, v, rho, alpha, omega, k):
    rho2 = _hi_dot(r0, r)
    beta = (rho2 / _safe(rho)) * (alpha / _safe(omega))
    p2 = r + beta * (p - omega * v)
    ph = psolve(p2)
    v2 = op.matvec(ph)
    alpha2 = rho2 / _safe(_hi_dot(r0, v2))
    s = r - alpha2 * v2
    sh = psolve(s)
    t = op.matvec(sh)
    omega2 = _hi_dot(t, s) / _safe(_hi_dot(t, t))
    x2 = x + alpha2 * ph + omega2 * sh
    r2 = s - omega2 * t
    return x2, r2, p2, v2, rho2, alpha2, omega2, _i32(k + 1)

  zero = sp.zeros((op.shape[1],), dtype=dt)
  one = sp.lazify(np.asarray(1.0, dtype=dt))
  x, r, *_, k = sp.while_loop(
      cond, body, (x0e, r0, zero, zero, one, one, one, _i32(0)),
      max_iters=maxiter)
  return _residual_info(x, r, tol, k)


def minres(A, b, x0=None, *, rtol: float = 1e-5, atol: float = 0.0,
           maxiter: int = None):
  """MINRES for symmetric (possibly indefinite) ``A``: a 3-term Lanczos
  recurrence with on-the-fly Givens QR, one matvec an iteration
  (Paige–Saunders).  Returns ``(x, info)`` like :func:`cg`; info comes
  from a true residual ``b - A x`` after the loop."""
  op, b, x0e, dt = _setup(A, b, x0)
  tol, bnorm = _tol_of(b, rtol, atol)
  if bnorm == 0.0:
    return sp.zeros((op.shape[1],), dtype=dt).evaluate(), 0
  maxiter = int(maxiter) if maxiter else 10 * op.shape[1]

  r0 = sp.Val((b - op.matvec(x0e)).evaluate())
  beta1 = sp.sqrt(_hi_dot(r0, r0))
  zero_v = sp.zeros((op.shape[1],), dtype=dt)
  zero_s = sp.lazify(np.asarray(0.0, dtype=dt))

  def cond(x, r1, r2, w, w2, oldb, beta, dbar, epsln, phibar, cs, sn, k):
    # phibar tracks |r| exactly in exact arithmetic
    return (phibar > tol) & (k < maxiter)

  def body(x, r1, r2, w, w2, oldb, beta, dbar, epsln, phibar, cs, sn, k):
    v = r2 / _safe(beta)
    y = op.matvec(v)
    y = y - sp.where(k > 0, beta / _safe(oldb), 0.0) * r1
    alfa = _hi_dot(v, y)
    y = y - (alfa / _safe(beta)) * r2
    r1n, r2n = r2, y
    oldb2 = beta
    beta2 = sp.sqrt(_hi_dot(y, y))
    oldeps = epsln
    delta = cs * dbar + sn * alfa
    gbar = sn * dbar - cs * alfa
    epsln2 = sn * beta2
    dbar2 = -cs * beta2
    gamma = sp.maximum(sp.sqrt(gbar * gbar + beta2 * beta2), _TINY)
    cs2 = gbar / gamma
    sn2 = beta2 / gamma
    phi = cs2 * phibar
    phibar2 = sn2 * phibar
    w1n, w2n = w2, w
    wn = (v - oldeps * w1n - delta * w2n) / gamma
    x2 = x + phi * wn
    return (x2, r1n, r2n, wn, w2n, oldb2, beta2, dbar2, epsln2,
            phibar2, cs2, sn2, _i32(k + 1))

  init = (x0e, r0, r0, zero_v, zero_v, zero_s, beta1, zero_s, zero_s,
          beta1, sp.lazify(np.asarray(-1.0, dtype=dt)), zero_s, _i32(0))
  out = sp.while_loop(cond, body, init, max_iters=maxiter)
  x, k = out[0], out[-1]
  return _residual_info(x, b - op.matvec(sp.Val(x)), tol, k)


@structural
def _lstsq_kernel(h, g):
  """``jnp.linalg.lstsq(h, g)[0]``: the SVD solve with its cut-off
  ``eps · max(m, n)``, so a rank-deficient ``h`` (a restart cycle's ``H``
  until its last step) gets the minimum-norm solution on every device."""
  rcond = torch.finfo(h.dtype).eps * max(h.shape)
  return _lstsq_svd(h, g.to(h.dtype), rcond)


def _onehot(j, m, dt):
  return (sp.arange(m) == j).astype(dt)


def gmres(A, b, x0=None, *, rtol: float = 1e-5, atol: float = 0.0,
          restart: int = 20, maxiter: int = None, M=None):
  """Restarted GMRES(m) for general ``A``, restarts included in one loop.

  Per iteration: one matvec, classical Gram–Schmidt twice against the
  ``(m+1, n)`` basis block, rank-1 one-hot updates of ``V``/``H``, and the
  small ``(m+1, m)`` least-squares solve (:func:`_lstsq_kernel`).  The
  residual norm is the Krylov-space estimate ``|β e₁ − H y|``, so a
  restart needs no extra matvec: its residual is ``qᵀV`` with
  ``q = β e₁ − H y``.  Left-preconditioned when ``M`` is given (tol
  applies to the preconditioned residual, as in scipy).  Returns
  ``(x, info)`` like :func:`cg`; the final check recomputes ``b − A x``.
  ``maxiter`` counts restart cycles, as in scipy."""
  op, b, x0e, dt = _setup(A, b, x0)
  psolve = _psolve(M)
  mv = lambda v: psolve(op.matvec(v))  # noqa: E731
  be = sp.Val(psolve(b).evaluate())
  tol, bnorm = _tol_of(be, rtol, atol)
  if bnorm == 0.0:
    return sp.zeros((op.shape[1],), dtype=dt).evaluate(), 0
  n = op.shape[1]
  m = max(1, min(int(restart), n))
  max_inner = (int(maxiter) * m) if maxiter else 10 * n

  r0 = sp.Val((be - mv(x0e)).evaluate())
  beta0_0 = sp.sqrt(_hi_dot(r0, r0))
  V0 = sp.outer(_onehot(0, m + 1, dt),
                r0 / sp.maximum(beta0_0, _TINY)).astype(dt)
  H0 = sp.zeros((m + 1, m), dtype=dt)
  e1 = _onehot(0, m + 1, dt)

  def _step(x, V, H, vj, beta0, j):
    w = mv(vj)
    h = _hi_dot(V, w)           # rows past j are zero -> entries 0
    w = w - _hi_dot(h, V)
    h2 = _hi_dot(V, w)          # second Gram-Schmidt pass
    w = w - _hi_dot(h2, V)
    h = h + h2
    beta = sp.sqrt(_hi_dot(w, w))
    vnext = w / sp.maximum(beta, _TINY)
    V2 = V + sp.outer(_onehot(j + 1, m + 1, dt), vnext)
    hcol = h + beta * _onehot(j + 1, m + 1, dt)
    H2 = H + sp.outer(hcol, _onehot(j, m, dt))
    # the small LS solve + Krylov residual estimate, every step
    y = sp.map([H2, beta0 * e1], _lstsq_kernel)         # (m,)
    q = beta0 * e1 - _hi_dot(H2, y)
    rn = sp.sqrt(_hi_dot(q, q))
    x_new = x + _hi_dot(y, V2[:m])
    return V2, H2, x_new, q, rn, vnext, _i32(j + 1)

  def cond(x, xc, V, H, vj, beta0, j, k, rnorm):
    return (rnorm > tol) & (k < max_inner)

  def body(x, xc, V, H, vj, beta0, j, k, rnorm):
    V2, H2, x_new, q, rn, vnext, j2 = _step(x, V, H, vj, beta0, j)
    end = j2 == m
    # at a cycle boundary: restart from the Krylov-form residual q.V
    r_new = _hi_dot(q, V2)
    rn_new = sp.maximum(rn, _TINY)
    V_rst = sp.outer(e1, r_new / rn_new).astype(dt)
    x3 = sp.where(end, x_new, x)        # x only advances at cycle end /
    xc2 = x_new                         # xc tracks the running correction
    V3 = sp.where(end, V_rst, V2)
    H3 = sp.where(end, H0, H2)
    vj3 = sp.where(end, r_new / rn_new, vnext)
    beta0_3 = sp.where(end, rn, beta0)
    j3 = _i32(sp.where(end, 0, j2))
    return x3, xc2, V3, H3, vj3, beta0_3, j3, _i32(k + 1), rn

  vj0 = sp.Val((r0 / sp.maximum(beta0_0, _TINY)).astype(dt).evaluate())
  x, xc, V, H, vj, beta0, j, k, rnorm = sp.while_loop(
      cond, body,
      (x0e, x0e, V0, H0, vj0, beta0_0, _i32(0), _i32(0), beta0_0),
      max_iters=max_inner)
  # mid-cycle exit: xc holds the freshest correction
  x_fin = xc if int(np.asarray(j.glom())) > 0 else x
  r = be - mv(sp.Val(x_fin))
  rnorm_t = float(np.sqrt(float(sp.dot(r, r, precision="highest").glom())))
  cycles = -(-int(np.asarray(k.glom())) // m)
  return x_fin, (0 if rnorm_t <= tol * (1 + 1e-6) else cycles)


def lsqr(A, b, damp: float = 0.0, *, atol: float = 1e-8,
         iter_lim: int = None):
  """Regularized least squares ``min |Ax − b|² + damp²|x|²`` via CGLS
  (the normal-equation CG, algebraically equivalent to LSQR).  Stops
  when ``|Aᵀr − damp²x| <= atol · |Aᵀb|``.  Returns ``(x, istop, itn,
  r1norm)`` — the head of scipy's 10-tuple (istop 1 = converged, 7 =
  iteration limit)."""
  op = aslinearoperator(A)
  if op._rmatvec is None:
    raise ValueError("lsqr needs rmatvec (dense/sparse operators provide "
                     "it automatically)")
  b = sp.lazify(b)
  dt = _np_dtype(b.evaluate())
  if dt.kind != "f":
    dt = _default_float()
    b = b.astype(dt)
  n = op.shape[1]
  iter_lim = int(iter_lim) if iter_lim else 2 * n
  damp2 = float(damp) ** 2

  s0 = op.rmatvec(b)
  g0 = _hi_dot(s0, s0)
  gtol = float(atol) ** 2 * float(g0.glom())

  def cond(x, r, s, p, g, k):
    return (g > gtol) & (k < iter_lim)

  def body(x, r, s, p, g, k):
    q = op.matvec(p)
    den = _hi_dot(q, q) + damp2 * _hi_dot(p, p)
    alpha = g / _safe(den)
    x2 = x + alpha * p
    r2 = r - alpha * q
    s2 = op.rmatvec(r2) - damp2 * x2
    g2 = _hi_dot(s2, s2)
    beta = g2 / _safe(g)
    return x2, r2, s2, s2 + beta * p, g2, _i32(k + 1)

  x, r, s, p, g, k = sp.while_loop(
      cond, body,
      (sp.zeros((n,), dtype=dt), b, s0, s0, g0, _i32(0)),
      max_iters=iter_lim)
  itn = int(np.asarray(k.glom()))
  gf = float(g.glom())
  r1norm = float(np.sqrt(float(sp.dot(r, r, precision="highest").glom())))
  return x, (1 if gf <= gtol * (1 + 1e-6) else 7), itn, r1norm


def bicg(A, b, x0=None, *, rtol: float = 1e-5, atol: float = 0.0,
         maxiter: int = None, M=None):
  """BiConjugate Gradient (needs ``A^T`` matvecs); a sparse operand's
  transpose is built once, before the loop.  Returns ``(x, info)`` like
  :func:`cg`."""
  op, b, x0e, dt = _setup(A, b, x0)
  psolve = _psolve(M)
  rpsolve = (lambda x: x) if M is None else aslinearoperator(M).rmatvec
  tol, bnorm = _tol_of(b, rtol, atol)
  if bnorm == 0.0:
    return sp.zeros((op.shape[1],), dtype=dt).evaluate(), 0
  maxiter = int(maxiter) if maxiter else 10 * op.shape[1]
  op.rmatvec(sp.zeros((op.shape[0],), dtype=dt))  # force A.T build NOW

  r0 = sp.Val((b - op.matvec(x0e)).evaluate())

  def cond(x, r, rt, p, pt, rho, k):
    return (sp.sqrt(_hi_dot(r, r)) > tol) & (k < maxiter)

  def body(x, r, rt, p, pt, rho, k):
    z = psolve(r)
    zt = rpsolve(rt)
    rho2 = _hi_dot(rt, z)
    beta = rho2 / _safe(rho)
    p2 = z + beta * p
    pt2 = zt + beta * pt
    q = op.matvec(p2)
    qt = op.rmatvec(pt2)
    alpha = rho2 / _safe(_hi_dot(pt2, q))
    return (x + alpha * p2, r - alpha * q, rt - alpha * qt,
            p2, pt2, rho2, _i32(k + 1))

  zero = sp.zeros((op.shape[1],), dtype=dt)
  one = sp.lazify(np.asarray(1.0, dtype=dt))
  x, r, *_, k = sp.while_loop(
      cond, body, (x0e, r0, r0, zero, zero, one, _i32(0)),
      max_iters=maxiter)
  return _residual_info(x, r, tol, k)


def cgs(A, b, x0=None, *, rtol: float = 1e-5, atol: float = 0.0,
        maxiter: int = None, M=None):
  """Conjugate Gradient Squared (transpose-free).  Returns ``(x, info)``
  like :func:`cg`."""
  op, b, x0e, dt = _setup(A, b, x0)
  psolve = _psolve(M)
  tol, bnorm = _tol_of(b, rtol, atol)
  if bnorm == 0.0:
    return sp.zeros((op.shape[1],), dtype=dt).evaluate(), 0
  maxiter = int(maxiter) if maxiter else 10 * op.shape[1]

  r0 = sp.Val((b - op.matvec(x0e)).evaluate())

  def cond(x, r, u, p, q, rho, k):
    return (sp.sqrt(_hi_dot(r, r)) > tol) & (k < maxiter)

  def body(x, r, u, p, q, rho, k):
    rho2 = _hi_dot(r0, r)
    beta = rho2 / _safe(rho)
    u2 = r + beta * q
    p2 = u2 + beta * (q + beta * p)
    vhat = op.matvec(psolve(p2))
    alpha = rho2 / _safe(_hi_dot(r0, vhat))
    q2 = u2 - alpha * vhat
    uhat = psolve(u2 + q2)
    x2 = x + alpha * uhat
    r2 = r - alpha * op.matvec(uhat)
    return x2, r2, u2, p2, q2, rho2, _i32(k + 1)

  zero = sp.zeros((op.shape[1],), dtype=dt)
  one = sp.lazify(np.asarray(1.0, dtype=dt))
  x, r, *_, k = sp.while_loop(
      cond, body, (x0e, r0, zero, zero, zero, one, _i32(0)),
      max_iters=maxiter)
  return _residual_info(x, r, tol, k)


def tfqmr(A, b, x0=None, *, rtol: float = 1e-5, atol: float = 0.0,
          maxiter: int = None, M=None, callback=None, show=False):
  """Transpose-Free QMR — half-steps of Freund's algorithm as one loop
  body with parity selects (the even-step alpha is carried through the
  odd step), one preconditioned matvec a half-step like scipy's.
  Returns ``(x, info)``."""
  del callback, show
  op, b, x0e, dt = _setup(A, b, x0)
  psolve = _psolve(M)
  maxiter = int(maxiter) if maxiter else min(10000, 10 * op.shape[0])

  r0 = sp.Val((b - op.matvec(x0e)).evaluate())
  rho0 = float(_hi_dot(r0, r0).glom())
  r0norm = float(np.sqrt(rho0))
  if r0norm == 0.0:
    return x0e.evaluate(), 0
  tol = max(float(atol), float(rtol) * r0norm)

  def mav(v):
    return psolve(op.matvec(v))

  v0 = sp.Val(mav(r0).evaluate())

  def cond(x, w, u, v, uhat, d, theta, eta, rho, rhoL, alpha, tau, k):
    return (tau * sp.sqrt(sp.maximum(k.astype(dt), 1.0)) > tol) \
        & (k < maxiter)

  def body(x, w, u, v, uhat, d, theta, eta, rho, rhoL, alpha, tau, k):
    even = (k % 2) == 0
    alpha2 = sp.where(even, rho / _safe(_hi_dot(r0, v)), alpha)
    w2 = w - alpha2 * uhat
    d2 = u + ((theta * theta) / _safe(alpha2)) * eta * d
    theta2 = sp.sqrt(_hi_dot(w2, w2)) / _safe(tau)
    c2 = 1.0 / sp.sqrt(1.0 + theta2 * theta2)
    tau2 = tau * theta2 * c2
    eta2 = c2 * c2 * alpha2
    x2 = x + eta2 * psolve(d2)
    # even: advance u along v; odd: new rho/beta and search directions
    uN = u - alpha2 * v
    rho_o = _hi_dot(r0, w2)
    beta = rho_o / _safe(rhoL)
    u_o = w2 + beta * u
    u2 = sp.where(even, uN, u_o)
    uhat2 = mav(u2)
    v2 = sp.where(even, v, beta * uhat + (beta * beta) * v + uhat2)
    rho2 = sp.where(even, rho, rho_o)
    rhoL2 = sp.where(even, rho, rhoL)
    return (x2, w2, u2, v2, uhat2, d2, theta2, eta2, rho2, rhoL2,
            alpha2, tau2, _i32(k + 1))

  zero_v = sp.zeros((op.shape[1],), dtype=dt)
  zs = sp.lazify(np.asarray(0.0, dtype=dt))
  rho_e = sp.lazify(np.asarray(rho0, dtype=dt))
  tau_e = sp.lazify(np.asarray(r0norm, dtype=dt))
  out = sp.while_loop(
      cond, body,
      (x0e, r0, r0, v0, v0, zero_v, zs, zs, rho_e, rho_e, zs, tau_e,
       _i32(0)),
      max_iters=maxiter)
  x, k = out[0], out[-1]
  return _residual_info(x, b - op.matvec(sp.Val(x)), tol, k)


def qmr(A, b, x0=None, *, rtol: float = 1e-5, atol: float = 0.0,
        maxiter: int = None, M1=None, M2=None, callback=None):
  """Quasi-Minimal Residual (coupled two-term Lanczos, needs ``A^T``):
  Freund–Nachtigal recurrences, the scipy formulation.  Preconditioners
  M1/M2 are not supported (scipy's split-preconditioned QMR needs four
  extra solves a step); pass them to :func:`gmres`/:func:`bicgstab`."""
  del callback
  if M1 is not None or M2 is not None:
    raise NotImplementedError("qmr: M1/M2 preconditioning is not "
                              "supported — use gmres/bicgstab")
  op, b, x0e, dt = _setup(A, b, x0)
  tol, bnorm = _tol_of(b, rtol, atol)
  if bnorm == 0.0:
    return sp.zeros((op.shape[1],), dtype=dt).evaluate(), 0
  maxiter = int(maxiter) if maxiter else 10 * op.shape[1]
  op.rmatvec(sp.zeros((op.shape[0],), dtype=dt))  # force A.T build NOW

  r0 = sp.Val((b - op.matvec(x0e)).evaluate())
  rho0 = sp.sqrt(_hi_dot(r0, r0))
  breakdown = float(np.finfo(dt).eps)

  def cond(x, r, vt, wt, rho, xi, gamma, eta, theta, eps, p, q, d, s, k):
    ok = (sp.abs(rho) > breakdown) & (sp.abs(xi) > breakdown) \
        & (sp.abs(gamma) > breakdown)
    return (sp.sqrt(_hi_dot(r, r)) > tol) & (k < maxiter) & ok

  def body(x, r, vt, wt, rho, xi, gamma, eta, theta, eps, p, q, d, s, k):
    v = vt / _safe(rho)
    w = wt / _safe(xi)
    delta = _hi_dot(w, v)          # z==w, y==v (no preconditioning)
    p2 = v - (xi * delta / _safe(eps)) * p
    q2 = w - (rho * delta / _safe(eps)) * q
    pt = op.matvec(p2)
    eps2 = _hi_dot(q2, pt)
    beta = eps2 / _safe(delta)
    vt2 = pt - beta * v
    rho2 = sp.sqrt(_hi_dot(vt2, vt2))
    wt2 = op.rmatvec(q2) - beta * w
    xi2 = sp.sqrt(_hi_dot(wt2, wt2))
    theta2 = rho2 / _safe(gamma * sp.abs(beta))
    gamma2 = 1.0 / sp.sqrt(1.0 + theta2 * theta2)
    eta2 = -eta * rho * gamma2 * gamma2 / _safe(beta * gamma * gamma)
    tg2 = (theta * gamma2) * (theta * gamma2)
    d2 = eta2 * p2 + tg2 * d
    s2 = eta2 * pt + tg2 * s
    return (x + d2, r - s2, vt2, wt2, rho2, xi2, gamma2, eta2, theta2,
            eps2, p2, q2, d2, s2, _i32(k + 1))

  zero_v = sp.zeros((op.shape[1],), dtype=dt)
  one = sp.lazify(np.asarray(1.0, dtype=dt))
  init = (x0e, r0, r0, r0, rho0, rho0, one, -one,
          sp.lazify(np.asarray(0.0, dtype=dt)), one,
          zero_v, zero_v, zero_v, zero_v, _i32(0))
  out = sp.while_loop(cond, body, init, max_iters=maxiter)
  x, k = out[0], out[-1]
  return _residual_info(x, b - op.matvec(sp.Val(x)), tol, k)


def _sym_ortho_e(a, b):
  """Stable Givens (expr scalars): c, s, r with r = hypot(a, b)."""
  r = sp.sqrt(a * a + b * b)
  rs = sp.where(sp.abs(r) > _TINY, r, 1.0)
  return a / rs, b / rs, r


def lsmr(A, b, damp: float = 0.0, atol: float = 1e-6, btol: float = 1e-6,
         conlim: float = 1e8, maxiter: int = None, show: bool = False,
         x0=None):
  """LSMR (Fong–Saunders): Golub–Kahan bidiagonalization with MINRES-style
  double rotations, min ``|A'(Ax-b)|``: two matvecs and about 20 scalar
  rotations a step, the |r|/|A'r|/|A| estimates in the carry.  Returns
  scipy's 8-tuple ``(x, istop, itn, normr, normar, normA, condA,
  normx)``."""
  del show
  op = aslinearoperator(A)
  be = sp.lazify(b)
  m, n = op.shape
  dt = _np_dtype(be.evaluate())
  if dt.kind != "f":
    dt = _default_float()
    be = be.astype(dt)
  maxiter = int(maxiter) if maxiter else min(m, n)
  x0e = sp.zeros((n,), dtype=dt) if x0 is None else sp.lazify(x0).astype(dt)
  u0 = be if x0 is None else be - op.matvec(x0e)
  beta0 = float(sp.sqrt(_hi_dot(u0, u0)).glom())
  normb = float(sp.sqrt(_hi_dot(be, be)).glom())
  if normb == 0.0:
    return (sp.zeros((n,), dtype=dt).evaluate(), 0, 0, 0.0, 0.0, 0.0,
            1.0, 0.0)
  damp = float(damp)
  ctol = 1.0 / float(conlim) if conlim > 0 else 0.0

  u_init = sp.Val((u0 / max(beta0, np.finfo(dt).tiny)).evaluate())
  v0 = op.rmatvec(u_init)
  alpha0 = float(sp.sqrt(_hi_dot(v0, v0)).glom())
  v_init = sp.Val((v0 / max(alpha0, np.finfo(dt).tiny)).evaluate())

  # carry: x u v h hbar  alpha alphabar zeta zetabar rho rhobar cbar
  # sbar  betadd betad rhodold tautildeold thetatilde dsq normA2 maxrbar
  # minrbar normr normar k
  def cond(*st):
    (x, u, v, h, hbar, alpha, alphabar, zeta, zetabar, rho, rhobar,
     cbar, sbar, betadd, betad, rhodold, tautildeold, thetatilde,
     dsq, normA2, maxrbar, minrbar, normr, normar, k) = st
    normA = sp.sqrt(normA2)
    normx = sp.sqrt(_hi_dot(x, x))
    # scipy stopping: istop 1/2/3 conditions
    t1 = normr - (btol * normb + atol * normA * normx)
    t2 = normar - atol * normA * normr
    condA = maxrbar / _safe(minrbar)
    t3 = (1.0 / _safe(condA)) - ctol
    return (t1 > 0) & (t2 > 0) & (t3 > 0) & (k < maxiter)

  def body(*st):
    (x, u, v, h, hbar, alpha, alphabar, zeta, zetabar, rho, rhobar,
     cbar, sbar, betadd, betad, rhodold, tautildeold, thetatilde,
     dsq, normA2, maxrbar, minrbar, normr, normar, k) = st
    u2 = op.matvec(v) - alpha * u
    beta = sp.sqrt(_hi_dot(u2, u2))
    u2 = u2 / _safe(beta)
    v2 = op.rmatvec(u2) - beta * v
    alpha2 = sp.sqrt(_hi_dot(v2, v2))
    v2 = v2 / _safe(alpha2)
    chat, shat, alphahat = _sym_ortho_e(alphabar,
                                        sp.lazify(np.asarray(damp, dt)))
    rhoold = rho
    c, s, rho2 = _sym_ortho_e(alphahat, beta)
    thetanew = s * alpha2
    alphabar2 = c * alpha2
    rhobarold = rhobar
    zetaold = zeta
    thetabar = sbar * rho2
    cbar2, sbar2, rhobar2 = _sym_ortho_e(cbar * rho2, thetanew)
    zeta2 = cbar2 * zetabar
    zetabar2 = -sbar2 * zetabar
    hbar2 = h - (thetabar * rho2 / _safe(rhoold * rhobarold)) * hbar
    x2 = x + (zeta2 / _safe(rho2 * rhobar2)) * hbar2
    h2 = v2 - (thetanew / _safe(rho2)) * h
    # |r| estimate (Fong–Saunders §5)
    betaacute = chat * betadd
    betacheck = -shat * betadd
    betahat = c * betaacute
    betadd2 = -s * betaacute
    thetatildeold = thetatilde
    ctO, stO, rhotildeold = _sym_ortho_e(rhodold, thetabar)
    thetatilde2 = stO * rhobar2
    rhodold2 = ctO * rhobar2
    betad2 = -stO * betad + ctO * betahat
    tautildeold2 = (zetaold - thetatildeold * tautildeold) \
        / _safe(rhotildeold)
    taud = (zeta2 - thetatilde2 * tautildeold2) / _safe(rhodold2)
    dsq2 = dsq + betacheck * betacheck
    normr2 = sp.sqrt(dsq2 + (betad2 - taud) ** 2 + betadd2 * betadd2)
    normA22 = normA2 + beta * beta + alpha2 * alpha2
    maxrbar2 = sp.maximum(maxrbar, rhobarold)
    minrbar2 = sp.where(k > 0, sp.minimum(minrbar, rhobarold), minrbar)
    normar2 = sp.abs(zetabar2)
    return (x2, u2, v2, h2, hbar2, alpha2, alphabar2, zeta2, zetabar2,
            rho2, rhobar2, cbar2, sbar2, betadd2, betad2, rhodold2,
            tautildeold2, thetatilde2, dsq2, normA22, maxrbar2,
            minrbar2, normr2, normar2, _i32(k + 1))

  a0 = sp.lazify(np.asarray(alpha0, dt))
  b0 = sp.lazify(np.asarray(beta0, dt))
  zs = sp.lazify(np.asarray(0.0, dt))
  one = sp.lazify(np.asarray(1.0, dt))
  init = (x0e, u_init, v_init, v_init, sp.zeros((n,), dtype=dt),
          a0, a0, zs, a0 * b0, one, one, one, zs,
          b0, zs, one, zs, zs, zs, a0 * a0, zs,
          sp.lazify(np.asarray(np.finfo(dt).max / 4, dt)), b0,
          a0 * b0, _i32(0))
  out = sp.while_loop(cond, body, init, max_iters=maxiter)
  x = out[0]
  k = int(np.asarray(out[-1].glom()))
  normr = float(np.asarray(out[-3].glom()))
  normar = float(np.asarray(out[-2].glom()))
  normA = float(np.sqrt(float(np.asarray(out[19].glom()))))
  maxr = float(np.asarray(out[20].glom()))
  minr = float(np.asarray(out[21].glom()))
  condA = maxr / max(minr, np.finfo(dt).tiny) if k > 0 else 1.0
  normx = float(np.sqrt(float(_hi_dot(x, x).glom())))
  if normr <= btol * normb + atol * normA * normx:
    istop = 1
  elif normar <= atol * normA * max(normr, np.finfo(dt).tiny):
    istop = 2
  elif ctol and 1.0 / max(condA, 1.0) <= ctol:
    istop = 3
  else:
    istop = 7
  return x, istop, k, normr, normar, normA, condA, normx


def norm(A, ord="fro"):
  """Sparse matrix norm: ``'fro'`` is ``sqrt(sum(square(v)))`` over the
  stored values (pads are 0; duplicates count apart, as in the reference),
  one reduction over one operand, which plans onto K1 for float32 values
  (``v * v`` of a leaf would be two operands).  Anything but a sparse
  array goes to ``sp.linalg.norm``."""
  from spartan_tpu_torch.backend import sparse as sps
  if not isinstance(A, (sps.SparseArray, sps.BlockSparseArray)):
    return sp.linalg.norm(A, ord=ord)
  if ord not in ("fro", None):
    raise ValueError("sparse norm supports ord='fro' only (pads make "
                     "signed element iteration ambiguous); densify for "
                     "ord=1/inf")
  v = sp.lazify(A.block_vals if isinstance(A, sps.BlockSparseArray)
                else A.vals)
  return sp.sqrt(sp.sum(sp.square(v)))


def spsolve(A, b):
  """Direct sparse solve, gated by size: densifies and solves by LU on the
  device when ``n <= --spsolve_dense_max``, raises with the iterative
  solvers named above it."""
  from spartan_tpu_torch.backend import sparse as sps
  if not isinstance(A, (sps.SparseArray, sps.BlockSparseArray)):
    return sp.linalg.solve(A, b)
  n = A.shape[0]
  if n > int(FLAGS.spsolve_dense_max):
    raise ValueError(
        f"spsolve densifies (n={n} > --spsolve_dense_max="
        f"{int(FLAGS.spsolve_dense_max)}); use sparse_linalg.cg (SPD), "
        "gmres/bicgstab (general), or raise the flag")
  dense = (sp.Val(SpartanArray(A.dense_tensor()))
           if isinstance(A, sps.SparseArray) else sp.from_numpy(A.todense()))
  return sp.linalg.solve(dense, b)


# -- what one solve of a SparseArray runs, and what it may leave --------------
# Read by the tests and by chip_smoke.py's phase 19, which hold the SpMV
# kernels' launches and a float32 solve's float64 true residual to them.

# The SpMVs of one solve: (an iteration of its loop, outside the loop).
# Outside the loop: the initial residual (cg, bicgstab, minres, gmres, bicg,
# cgs, tfqmr, qmr), tfqmr's ``M A r0``, a true residual after the loop
# (minres, gmres, tfqmr, qmr), and for lsqr/lsmr ``A.T b`` twice: once for
# its norm (a glom) and once as a carry, since the evaluator caches a
# root's value and not its interior nodes.  Building the transpose (bicg,
# qmr) runs no product.
_MATVECS = {"cg": (1, 1), "bicgstab": (2, 1), "minres": (1, 2),
            "gmres": (1, 2), "bicg": (2, 1), "cgs": (2, 1),
            "tfqmr": (1, 3), "qmr": (2, 2), "lsqr": (2, 2), "lsmr": (2, 2)}


def _iterations(name: str, carry) -> int:
  """The iterations a solve of ``name`` ran, read from its loop's final
  carry: the counter is the carry's last entry, gmres's the second to last
  (its last is the residual norm)."""
  return int(np.asarray(carry[-2 if name == "gmres" else -1].glom()))


@contextlib.contextmanager
def _loops_run():
  """Records each ``sp.while_loop`` call the block makes: yields a list
  that gets, for each call in order, its final carry and the seconds the
  call took (every iteration reads its condition on the host, so the call
  ends when its last iteration has run on the device)."""
  runs = []
  real = sp.while_loop

  def recorded(*args, **kw):
    t0 = time.perf_counter()
    out = real(*args, **kw)
    runs.append((out, time.perf_counter() - t0))
    return out

  sp.while_loop = recorded
  try:
    yield runs
  finally:
    sp.while_loop = real


def _residual_bound(rtol, iters, a_norm, x_norm, b_norm,
                    eps=2.0 ** -24) -> float:
  """The true residual ``|b - A x|_2 / |b|_2`` a solve stopped at ``rtol``
  may leave: ``rtol`` plus the drift of its recursive residual from the
  true one, a random walk of one rounding of ``A x`` an iteration,
  ``sqrt(iters) eps |A|_2 |x|_2 / |b|_2`` (``a_norm`` and ``x_norm`` upper
  bounds of ``|A|_2`` and ``|x|_2``; ``eps`` float32's unit roundoff)."""
  return rtol + iters ** 0.5 * eps * a_norm * x_norm / b_norm


def _normal_bound(atol, iters, a_norm, x_norm, b_norm, atb_norm,
                  eps=2.0 ** -24) -> float:
  """The normal-equations residual ``|A'(b - A x)|_2 / |A'b|_2`` a
  least-squares solve stopped at ``|A'r| <= atol |A'b|`` may leave:
  ``atol`` plus the drift of its recursive ``A'r`` from the true one,
  ``sqrt(iters) eps |A|_2 (|A|_2 |x|_2 + |b|_2) / |A'b|_2``."""
  return atol + (iters ** 0.5 * eps * a_norm * (a_norm * x_norm + b_norm)
                 / atb_norm)
