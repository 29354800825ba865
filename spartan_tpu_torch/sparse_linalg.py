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

The spectral solvers run Krylov cycles over the same ``(m+1, n)`` basis
block, their matvecs the SpMV kernels for a float32 ``SparseArray`` (the
basis keeps the operator's float dtype, so that the product stays on the
kernels; the reference under x64 computes ``eigs`` and ``expm_multiply`` in
float64 whatever the operator):

* ``eigsh``: thick-restart Lanczos.  By default (``--eigsh_fused_restart``)
  the whole restarted solve is one loop over the compiled Arnoldi step of
  ``expr/loop.py`` (the step holds the matvec, so a sparse operator
  launches K3a/K3b a step), with the small Ritz problem solved by
  ``torch.linalg.eigh`` in float64 on the device and the basis compressed
  by one product a cycle, accumulated in float64; the host reads the Ritz residual once a cycle (and
  torch's ``eigh`` checks its result once a cycle).  With the flag off,
  and for the inexact shift-invert route, the cycles are paced from the
  host with NumPy Ritz solves, as in the reference; both give the same
  pairs.  Shift-invert (``sigma``) factors ``A − σI`` on the device by
  :func:`scipy_linalg.lu_factor` up to ``_DENSE_SI_MAX`` rows, else each
  matvec is one ``minres`` (``gmres`` for ``eigs``) solve.
* ``eigs``: Krylov–Schur restarts; the small Schur and eigen problems run
  on the host (scipy), the basis compressions and the Ritz vectors are
  products on the device.
* ``svds``: Lanczos on the Gram operator of the smaller side (``A`` and
  ``A.T``, the transpose built once and kept with ``A``); ``'SM'`` by
  shift-invert at a small negative shift.
* ``expm_multiply``: one Arnoldi cycle a column, scipy's ``expm`` of the
  small ``H`` on the host, one product.

``expm``, ``inv``, ``matrix_power`` and ``spsolve_triangular`` densify a
``SparseArray`` on the device (duplicates summed) and call
``torch.linalg``; ``is_sptriangular`` and ``spbandwidth`` reduce over the
ELL tensors.  ``LaplacianNd``'s matvec is a map of slices and
concatenates axis by axis (the periodic boundary too: two slices and a
concatenate, not ``torch.roll``), its eigenvalues the closed form, its
``toarray`` one batched application to the identity.  ``splu``, ``spilu``,
``factorized``, ``lobpcg``, ``lgmres``, ``gcrotmk``, ``onenormest`` and
``funm_multiply_krylov`` are scipy on the host, each noticed once a process
and counted in ``expr.fio.counts["host_runs"]``; a name the installed scipy
lacks raises scipy's own ``AttributeError``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import numpy as np
import torch

import spartan_tpu_torch as sp
from spartan_tpu_torch.config import FLAGS, BoolFlag, IntFlag
from spartan_tpu_torch.core.array import (SpartanArray, to_numpy_dtype,
                                          to_torch_dtype)
from spartan_tpu_torch.expr.base import Expr
from spartan_tpu_torch.expr.builtins import _lstsq_svd
from spartan_tpu_torch.expr.map import result_type, structural

FLAGS.add(IntFlag(
    "spsolve_dense_max", 8192,
    "spsolve densifies and LU-factorizes up to this many rows; larger "
    "systems raise (use cg/gmres/lsqr)"))

__all__ = [
    "LinearOperator", "aslinearoperator", "cg", "bicgstab", "gmres",
    "minres", "lsqr", "eigsh", "eigs", "svds", "norm", "spsolve",
    "expm_multiply",
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


# -- the spectral solvers ------------------------------------------------------

def _op_float(op) -> np.dtype:
  """The dtype a Krylov basis of ``op`` keeps: the operator's own float
  dtype (so a float32 sparse operator's matvec stays on the SpMV kernels),
  else the default float."""
  dt = op.dtype
  if dt is None:
    return _default_float()
  dt = to_numpy_dtype(dt) if isinstance(dt, torch.dtype) else np.dtype(dt)
  return dt if dt.kind == "f" else _default_float()


def _arnoldi_body(matvec, m: int, dt):
  """One Arnoldi step over the (m+1, n) basis block at carried position j:
  one matvec, classical Gram–Schmidt twice against the whole block
  (unfilled rows are zero and project to nothing), rank-1 one-hot updates
  of V and of the projected matrix H."""
  def body(V, H, vj, j):
    w = matvec(vj)
    h = _hi_dot(V, w)
    w = w - _hi_dot(h, V)
    h2 = _hi_dot(V, w)
    w = w - _hi_dot(h2, V)
    h = h + h2
    beta = sp.sqrt(_hi_dot(w, w))
    vnext = sp.where(beta > 1e-12, w / sp.maximum(beta, _TINY), 0.0)
    V2 = V + sp.outer(_onehot(j + 1, m + 1, dt), vnext)
    H2 = H + sp.outer(h + beta * _onehot(j + 1, m + 1, dt),
                      _onehot(j, m, dt))
    return V2, H2, vnext, _i32(j + 1)
  return body


def _arnoldi_cycle(matvec, V0, H0, j0: int, m: int, dt):
  """Positions j0 .. m-1 as one ``fori_loop`` over the compiled step; the
  current basis vector rides the carry (selected from V0 once here).
  Returns (V, H)."""
  vj0 = _hi_dot(_onehot(j0, m + 1, dt), sp.lazify(V0))
  V, H, _, _ = sp.fori_loop(m - j0, _arnoldi_body(matvec, m, dt),
                            (V0, H0, vj0, _i32(j0)))
  return V, H


def _arnoldi_cycle_eager(matvec, V0, H0, j0: int, m: int, dt):
  """The same cycle paced from the host, one evaluated step a position:
  for a matvec that is itself a solver call (the inexact shift-invert's
  minres/gmres), which runs its own loop and cannot sit inside a step."""
  V = sp.lazify(V0)
  H = sp.lazify(H0)
  vj = sp.Val(_hi_dot(_onehot(j0, m + 1, dt), V).evaluate())
  body = _arnoldi_body(matvec, m, dt)
  j = int(j0)
  for _ in range(m - j0):
    V, H, vj, j = body(V, H, vj, j)
    V = sp.Val(sp.lazify(V).evaluate())
    H = sp.Val(sp.lazify(H).evaluate())
    vj = sp.Val(sp.lazify(vj).evaluate())
    j = int(j)
  return V, H


FLAGS.add(BoolFlag(
    "eigsh_fused_restart", True,
    "run eigsh's whole thick-restart loop (Arnoldi cycles over the compiled "
    "step, the Ritz solves by torch.linalg.eigh and the basis compression "
    "on the device, one host read of the residual a cycle); off = "
    "host-paced restarts with NumPy Ritz solves between the cycles"))

# the last eigsh/eigs call: its restart cycles, the Arnoldi steps they ran
# (one matvec each) and whether the restarts ran fused
stats = {"cycles": 0, "steps": 0, "fused": False}


def _ritz_device(Hh: torch.Tensor, m: int, k: int, l: int, which: str):
  """The host path's breakdown guard, selection, residual and TRLan
  compression (:func:`_ritz_host`, the restart in :func:`eigsh`) on the
  device over the (m+1, m) projected matrix: ``(res / scale, Hn, P)``.
  The small eigenproblem is solved in float64 whatever the basis's dtype:
  cuSOLVER's float32 ``eigh`` returns vectors orthonormal to about 5e-6
  only (LAPACK's to 6e-7), and the compression ``P`` carries that loss
  into the basis every restart (a float32 solve's Ritz values then strayed
  4e-4 from its vectors' Rayleigh quotients at n = 2^22 on an NVIDIA H100
  80GB HBM3 at 700 W, ``tools/torch_spectral_probe.py``).  ``P``
  comes back in float64 for the compression's float64 accumulation."""
  dt = Hh.dtype
  H = Hh.double()
  Hm = (H[:m, :m] + H[:m, :m].mT) * 0.5
  scale0 = torch.clamp(H.abs().max(), min=1.0)
  dead = H.abs().amax(0) < 1e-12 * scale0
  alive = torch.cumsum(dead.to(torch.int32), 0) == 0
  alive = alive | (alive.sum() < k)
  mask = alive[:, None] & alive[None, :]
  w, Y = torch.linalg.eigh(torch.where(mask, Hm, torch.zeros_like(Hm)))
  # spurious pairs (the dead block's zeros) live on dead coordinates
  genuine = ((Y * Y) * alive[:, None].to(Y.dtype)).sum(0) > 0.5
  genuine = genuine | (genuine.sum() < k)
  keyv = {"LM": w.abs(), "SM": -w.abs(), "LA": w, "SA": -w}[which]
  order = torch.argsort(torch.where(genuine, -keyv, torch.inf), stable=True)
  beta_last = torch.where(alive.all(), H[m, m - 1], torch.zeros_like(w[0]))
  res = (beta_last * Y[m - 1, order[:k]]).abs().max()
  wsc = torch.clamp(torch.where(genuine, w, torch.zeros_like(w)).abs().max(),
                    min=1e-30)
  keep = order[:l]
  P = torch.zeros((m + 1, m + 1), dtype=torch.float64, device=Hh.device)
  P[:l, :m] = Y[:, keep].mT
  P[l, m] = 1
  Hn = torch.zeros((m + 1, m), dtype=dt, device=Hh.device)
  ar = torch.arange(l, device=Hh.device)
  Hn[ar, ar] = w[keep].to(dt)
  Hn[l, :l] = (beta_last * Y[m - 1, keep]).to(dt)
  return res / wsc, Hn, P


def _eigsh_fused_solve(matvec, v0n, m: int, k: int, l: int, which: str,
                       dt, maxiter: int, tol_eff: float):
  """The whole thick-restart Lanczos solve as one loop of cycles: each
  cycle runs the compiled Arnoldi step (built once and cached under
  ``"eigsh_tr"`` by ``expr/loop.py``, its matvec inside, so a sparse
  operator launches its SpMV kernel a step) from position l to m with no
  host read, then :func:`_ritz_device` on the device; the host reads the
  Ritz residual once a cycle to decide the next.  Returns ``(V
  SpartanArray (m+1, n), H numpy (m+1, m), cycles, res_rel)``; the final
  selection runs on the host (:func:`_ritz_host`), as on the host-paced
  path."""
  from spartan_tpu_torch.core.mesh import get_mesh
  from spartan_tpu_torch.expr import loop as L
  which = which.upper()
  V0 = sp.outer(_onehot(0, m + 1, dt), v0n)
  _, init_arrs, syms = L._symbolic_carry(
      (V0, sp.zeros((m + 1, m), dtype=dt), v0n, np.int32(0)))
  body_exprs = L._as_exprs(_arnoldi_body(matvec, m, dt)(*syms))
  L._check_carry(body_exprs, init_arrs)
  # the step depends on the body's structure and the carries' avals only
  (step,), (consts,) = L._steps("eigsh_tr", [body_exprs], syms, init_arrs)
  device = get_mesh().device

  def cycle(carry, j_lo):
    for _ in range(j_lo, m):
      carry = step(carry, consts)
    return carry

  V, H, _, _ = cycle(tuple(a.data for a in init_arrs), 0)
  res, Hn, P = _ritz_device(H, m, k, l, which)
  cycles = 1
  while cycles < maxiter and float(res) > tol_eff:  # one host read a cycle
    Vn = (P @ V.double()).to(V.dtype)  # accumulated in float64, as _hi_dot
    V, H, _, _ = cycle(
        (Vn, Hn, Vn[l], torch.tensor(l, dtype=torch.int32, device=device)), l)
    res, Hn, P = _ritz_device(H, m, k, l, which)
    cycles += 1
  return SpartanArray(V), H.cpu().numpy(), cycles, float(res)


_DENSE_SI_MAX = 4096  # densified-LU shift-invert size bound (n² memory)


def _dense_operand(A) -> torch.Tensor:
  """A sparse array or dense operand as a dense tensor on the device."""
  from spartan_tpu_torch.backend import sparse as sps
  if isinstance(A, sps.SparseArray):
    return A.dense_tensor()
  if isinstance(A, sps.BlockSparseArray):
    return sp.from_numpy(A.todense()).data
  return sp.lazify(A).evaluate().data


def _shift_invert_op(A, sigma: float, OPinv, mode: str, sym: bool, dt,
                     n: int):
  """``(A − σI)⁻¹`` as a matvec, ARPACK's mode 3.  Returns ``(matvec,
  fused)``:

  * ``OPinv`` given: the user's operator, inside the fused cycle;
  * the dense path (a materializable A of at most ``_DENSE_SI_MAX`` rows
    if sparse, or ``mode='dense'``): one ``lu_factor`` of the shifted
    matrix on the device, matvec a lazy ``lu_solve``, inside the fused
    cycle;
  * the iterative path (a LinearOperator, a larger sparse A, or
    ``mode='iterative'``): each matvec one :func:`minres` (symmetric) or
    :func:`gmres` (general) solve of the shifted operator, the cycle paced
    from the host (``fused=False``)."""
  if OPinv is not None:
    return aslinearoperator(OPinv).matvec, True
  if mode in ("auto", "normal"):
    mode = "auto"
  if mode not in ("auto", "dense", "iterative"):
    raise ValueError(f"mode must be auto/dense/iterative, got {mode!r}")
  from spartan_tpu_torch import scipy_linalg as sla
  from spartan_tpu_torch.backend import sparse as sps
  is_sparse = isinstance(A, (sps.SparseArray, sps.BlockSparseArray))
  is_lo = isinstance(A, LinearOperator)
  dense_ok = (not is_lo) and (not is_sparse or n <= _DENSE_SI_MAX)
  if mode == "dense" and not dense_ok:
    raise ValueError("mode='dense' needs a materializable operator "
                     f"(got {type(A).__name__}, n={n})")
  if mode == "dense" or (mode == "auto" and dense_ok):
    tdt = to_torch_dtype(np.dtype(dt))
    Ad = _dense_operand(A).to(tdt)
    As = Ad - float(sigma) * torch.eye(n, dtype=tdt, device=Ad.device)
    lu_, piv = sla.lu_factor(sp.Val(SpartanArray(As)))
    lu_v = sp.Val(sp.lazify(lu_).evaluate())
    piv_v = sp.Val(sp.lazify(piv).evaluate())
    return (lambda x: sla.lu_solve((lu_v, piv_v), x)), True
  op = aslinearoperator(A)
  sig = np.asarray(sigma, dtype=dt)
  shifted = LinearOperator(
      op.shape, lambda x: op.matvec(x) - sig * sp.lazify(x), dtype=dt)
  inner_rtol = 1e-11 if np.dtype(dt) == np.float64 else 1e-6
  solver = minres if sym else gmres

  def mv(x):
    y, info = solver(shifted, x, rtol=inner_rtol)
    if info != 0:
      from spartan_tpu_torch.util import log_warn
      log_warn("shift-invert inner solve did not fully converge "
               "(info=%s) — eigenpair accuracy is bounded by the inner "
               "residual; raise its budget or use mode='dense'", info)
    return y

  return mv, False


def _ritz_host(Hh: np.ndarray, m: int, k: int, which: str):
  """The Ritz solve on a fetched (m+1, m) projected matrix on the host:
  the breakdown guard (a zero column means an invariant subspace), the
  symmetrized eigenproblem, the selection by ``which`` and the Ritz
  residual bound."""
  dead = np.nonzero(np.abs(Hh).max(axis=0)
                    < 1e-12 * max(np.abs(Hh).max(), 1.0))[0]
  m_eff = int(dead[0]) if dead.size else m
  if m_eff < k:
    m_eff = m
  Hm = (Hh[:m_eff, :m_eff] + Hh[:m_eff, :m_eff].T) / 2
  beta_last = float(Hh[m_eff, m_eff - 1]) if m_eff == m else 0.0
  w_all, Y = np.linalg.eigh(Hm)
  idx = _pick(w_all, min(k, m_eff), which)
  scale = max(float(np.abs(w_all).max()), 1e-30)
  res = np.abs(beta_last * Y[m_eff - 1, idx])
  return w_all, Y, idx, m_eff, beta_last, res, scale


def _pick(vals: np.ndarray, k: int, which: str) -> np.ndarray:
  order = {
      "LM": np.argsort(np.abs(vals))[-k:],
      "SM": np.argsort(np.abs(vals))[:k],
      "LA": np.argsort(vals.real)[-k:],
      "SA": np.argsort(vals.real)[:k],
  }.get(which.upper())
  if order is None:
    raise ValueError(f"which={which!r} not in LM/SM/LA/SA")
  return order[np.argsort(vals[order].real)]  # ascending, scipy's order


def _start_vector(n: int, v0, dt):
  """The starting vector: ``v0``, or the reference's seeded draw
  (``np.random.default_rng(0)``), so that both packages start alike."""
  if v0 is None:
    v0 = np.random.default_rng(0).standard_normal(n)
  return sp.lazify(v0).astype(dt)


def _not_converged(name, res, tol, cycles, m):
  from spartan_tpu_torch.util import log_warn
  log_warn("%s: Ritz residual %.2e > tol %.2e after %d restart cycles "
           "(ncv=%d) — returned pairs are NOT fully converged; raise ncv "
           "or maxiter", name, res, tol, cycles, m)


def eigsh(A, k: int = 6, *, which: str = "LM", ncv: int = None, v0=None,
          maxiter: int = None, tol: float = 0.0, sigma=None, OPinv=None,
          mode: str = "auto"):
  """k eigenpairs of a symmetric ``A`` by thick-restart Lanczos: ``ncv``-step
  Arnoldi cycles (full reorthogonalization, twice, against the ``(ncv+1,
  n)`` block) with TRLan restarts, which keep the ``k``-plus-a-buffer best
  Ritz vectors and the residual direction and re-enter the same cycle at
  position l.  By default the whole restarted solve runs fused
  (:func:`_eigsh_fused_solve`); ``--eigsh_fused_restart=0`` paces the
  cycles from the host with NumPy Ritz solves, and the inexact
  shift-invert route always does.  Returns ``(w (k,) numpy ascending, v
  (n, k) SpartanArray)``; ``maxiter`` counts restart cycles (default 20);
  ``tol`` bounds the Ritz residual relative to the spectral scale (0: 1e-13
  in float64, 1e-5 in float32).

  Shift-invert (``sigma=σ``, ARPACK's mode 3): Lanczos on ``(A − σI)⁻¹``
  (:func:`_shift_invert_op`), eigenvalues mapped back by ``λ = σ + 1/ν``;
  with the default ``which='LM'`` the k eigenvalues nearest σ (``which``
  selects in the transformed spectrum, as in scipy).  ``OPinv`` (an
  operator applying ``(A − σI)⁻¹``) overrides the routing."""
  op = aslinearoperator(A)
  n = op.shape[1]
  if op.shape[0] != n:
    raise ValueError("eigsh needs a square operator")
  k = int(k)
  m = min(n, int(ncv) if ncv else max(2 * k + 1, 20))
  if not 0 < k < m:
    raise ValueError(f"need 0 < k={k} < ncv={m}")
  if which.upper() not in ("LM", "SM", "LA", "SA"):
    raise ValueError(f"which={which!r} not in LM/SM/LA/SA")
  dt = _op_float(op)
  maxiter = int(maxiter) if maxiter else 20
  tol_eff = float(tol) if tol else (1e-13 if dt == np.float64 else 1e-5)
  v0 = _start_vector(n, v0, dt)
  if sigma is not None:
    matvec, fused = _shift_invert_op(A, float(sigma), OPinv, mode,
                                     sym=True, dt=dt, n=n)
  else:
    matvec, fused = op.matvec, True
  nrm = sp.sqrt(_hi_dot(v0, v0))
  # the Ritz vectors kept a restart: a buffer of the next-closest pairs
  # (about ncv/2, TRLan/ARPACK practice) speeds convergence and keeps the
  # restart off the wrong member of a near-tied cluster
  l = min(max(k + min(k, 8), m // 2), m - 2)
  if fused and FLAGS.eigsh_fused_restart:
    maxiter_eff = 1 if (m >= n or l < 1) else maxiter
    v0n = sp.Val(((v0 / sp.maximum(nrm, _TINY)).astype(dt)).evaluate())
    V, Hh, cycles, _ = _eigsh_fused_solve(
        matvec, v0n, m, k, l, which, dt, maxiter_eff, tol_eff)
    V = sp.Val(V)
    w_all, Y, idx, m_eff, beta_last, res, scale = _ritz_host(
        Hh, m, k, which)
    if res.max() > tol_eff * scale and m < n and m_eff == m:
      _not_converged("eigsh", float(res.max()), tol_eff * scale, cycles, m)
    stats.update(cycles=cycles, steps=m + (cycles - 1) * (m - l),
                 fused=True)
  else:
    cycle_fn = _arnoldi_cycle if fused else _arnoldi_cycle_eager
    V = sp.outer(_onehot(0, m + 1, dt), v0 / sp.maximum(nrm, _TINY))
    H = sp.zeros((m + 1, m), dtype=dt)
    j0 = steps = 0
    for cycle in range(maxiter):
      V, H = cycle_fn(matvec, V, H, j0, m, dt)
      steps += m - j0
      Hh = np.asarray(sp.lazify(H).glom())
      w_all, Y, idx, m_eff, beta_last, res, scale = _ritz_host(
          Hh, m, k, which)
      converged = res.max() <= tol_eff * scale
      if (converged or m >= n or m_eff < m or l < 1
          or cycle == maxiter - 1):
        if not converged and m < n and m_eff == m:
          _not_converged("eigsh", float(res.max()), tol_eff * scale,
                         cycle + 1, m)
        break
      keep = _pick(w_all, l, which)
      Yk = np.ascontiguousarray(Y[:, keep].T.astype(dt))        # (l, m)
      Wnew = _hi_dot(sp.lazify(Yk), sp.lazify(V)[:m])           # (l, n)
      vres = sp.lazify(V)[m:m + 1]                              # (1, n)
      Vn = sp.concatenate(
          [Wnew, vres, sp.zeros((m - l, n), dtype=dt)], axis=0)
      Hn = np.zeros((m + 1, m), dtype=dt)
      Hn[np.arange(l), np.arange(l)] = w_all[keep].astype(dt)
      Hn[l, :l] = (beta_last * Y[m - 1, keep]).astype(dt)
      V = sp.Val(Vn.evaluate())
      H = sp.lazify(Hn)
      j0 = l
    stats.update(cycles=cycle + 1, steps=steps, fused=False)
  w = w_all[idx]
  if sigma is not None:
    # back from the shift-inverted spectrum, re-sorted ascending
    lam = float(sigma) + 1.0 / w
    order = np.argsort(lam)
    w = lam[order]
    idx = idx[order]
  # Ritz vectors: Yᵀ (k, m_eff) · V's rows (m_eff, n) -> (k, n) -> (n, k)
  coef = np.ascontiguousarray(Y[:, idx].T.astype(dt))
  pad = np.zeros((coef.shape[0], m + 1 - m_eff), dtype=dt)
  v = sp.transpose(_hi_dot(sp.lazify(np.hstack([coef, pad])), V)).evaluate()
  return w, v


def eigs(A, k: int = 6, *, which: str = "LM", ncv: int = None, v0=None,
         maxiter: int = None, tol: float = 0.0, sigma=None, OPinv=None,
         mode: str = "auto"):
  """k eigenpairs of a general (nonsymmetric) operator by Krylov–Schur
  restarted Arnoldi: ``ncv``-step cycles over the compiled step; a restart
  keeps the leading (``which``-ordered) real Schur vectors of the small
  Hessenberg matrix, a real product on the device, and re-enters the cycle
  at position l.  The small Schur and eigen problems run on the host
  (scipy).  Returns ``(w, v)`` as complex NumPy arrays ((k,), (n, k)), the
  Ritz vectors from two real products on the device.  ``maxiter`` counts
  restart cycles (default 20); ``tol`` bounds the Ritz residual relative to
  the spectral scale.

  Shift-invert (``sigma=σ``, real): Arnoldi on ``(A − σI)⁻¹`` (an LU on the
  device, or ``gmres`` inner solves for a matrix-free operator,
  :func:`_shift_invert_op`), eigenvalues mapped back by ``λ = σ + 1/ν``."""
  op = aslinearoperator(A)
  n = op.shape[1]
  if op.shape[0] != n:
    raise ValueError("eigs needs a square operator")
  if sigma is not None and np.iscomplexobj(sigma):
    raise ValueError("complex sigma is not supported (the device path "
                     "is real)")
  k = int(k)
  m = min(n, int(ncv) if ncv else max(2 * k + 1, 20))
  if not 0 < k < m:
    raise ValueError(f"need 0 < k={k} < ncv={m}")
  dt = _op_float(op)
  maxiter = int(maxiter) if maxiter else 20
  tol_eff = float(tol) if tol else (1e-12 if dt == np.float64 else 1e-5)
  v0e = _start_vector(n, v0, dt)
  if sigma is not None:
    matvec, fused = _shift_invert_op(A, float(sigma), OPinv, mode,
                                     sym=False, dt=dt, n=n)
  else:
    matvec, fused = op.matvec, True
  cycle_fn = _arnoldi_cycle if fused else _arnoldi_cycle_eager
  nrm = sp.sqrt(_hi_dot(v0e, v0e))
  V = sp.outer(_onehot(0, m + 1, dt), v0e / sp.maximum(nrm, _TINY))
  H = sp.zeros((m + 1, m), dtype=dt)
  j0 = 0
  # about ncv/2 kept: near-tied |w| clusters (the common case for LM on
  # real random spectra) need the buffer, or the restart locks onto
  # interior members
  l = min(max(k + min(k, 8), m // 2), m - 2)

  def _crit(wr, wi):
    if which.upper() in ("LM", "SM"):
      return np.hypot(wr, wi)
    return np.asarray(wr)

  bigger_is_better = which.upper() in ("LM", "LA")
  steps = 0
  for cycle in range(maxiter):
    V, H = cycle_fn(matvec, V, H, j0, m, dt)
    steps += m - j0
    Hh = np.asarray(sp.lazify(H).glom())
    Hm = Hh[:m, :m]
    beta_last = float(Hh[m, m - 1])
    w_all, S = np.linalg.eig(Hm)
    idx = _pick(w_all, k, which)
    scale = max(float(np.abs(w_all).max()), 1e-30)
    res = np.abs(beta_last * S[m - 1, idx])
    converged = res.max() <= tol_eff * scale
    if converged or m >= n or l < 1 or cycle == maxiter - 1:
      if not converged and m < n:
        _not_converged("eigs", float(res.max() / scale), tol_eff,
                       cycle + 1, m)
      break
    # Krylov–Schur restart: order the real Schur form so the l best
    # eigenvalues lead (a cutoff predicate keeps 2x2 conjugate blocks
    # together: a pair's members share |w| and Re w)
    from scipy.linalg import LinAlgError, schur
    crit_all = _crit(w_all.real, w_all.imag)
    order = (np.sort(crit_all)[::-1] if bigger_is_better
             else np.sort(crit_all))
    cutoff = order[min(l, m) - 1]
    # reordering moves a 2x2 block's eigenvalues by about eps(dt); a cutoff
    # too tight fails LAPACK's check after the reordering (seen in float32):
    # retry with a wider fuzz, away from the kept set whatever the
    # cutoff's sign
    base_fuzz = 1e-12 if dt == np.float64 else 1e-6
    T = Z = None
    for fuzz in (base_fuzz, base_fuzz * 1e2, base_fuzz * 1e4):
      slack = fuzz * (abs(cutoff) + 1.0)
      if bigger_is_better:
        pred = lambda wr, wi, s=slack: _crit(wr, wi) >= cutoff - s  # noqa
      else:
        pred = lambda wr, wi, s=slack: _crit(wr, wi) <= cutoff + s  # noqa
      try:
        T, Z, sdim = schur(Hm, output="real", sort=pred)
        break
      except LinAlgError:
        continue
    from spartan_tpu_torch.util import log_warn
    if T is None:
      log_warn("eigs: Schur reordering unstable at this cutoff — "
               "returning the current cycle's Ritz pairs")
      break
    l_eff = int(sdim)
    if not 0 < l_eff <= m - 2:
      log_warn("eigs: Krylov-Schur restart degenerate (kept %d of %d) "
               "— returning the current cycle's Ritz pairs", l_eff, m)
      break
    Qk = np.ascontiguousarray(Z[:, :l_eff].T.astype(dt))      # (l, m)
    Wnew = _hi_dot(sp.lazify(Qk), sp.lazify(V)[:m])           # (l, n)
    vres = sp.lazify(V)[m:m + 1]
    Vn = sp.concatenate(
        [Wnew, vres, sp.zeros((m - l_eff, n), dtype=dt)], axis=0)
    Hn = np.zeros((m + 1, m), dtype=dt)
    Hn[:l_eff, :l_eff] = T[:l_eff, :l_eff].astype(dt)
    Hn[l_eff, :l_eff] = (beta_last * Z[m - 1, :l_eff]).astype(dt)
    V = sp.Val(Vn.evaluate())
    H = sp.lazify(Hn)
    j0 = l_eff
  stats.update(cycles=cycle + 1, steps=steps, fused=False)
  w = w_all[idx]
  if sigma is not None:
    w = sigma + 1.0 / w  # the columns of S[:, idx] are unchanged
  cr = np.ascontiguousarray(S[:, idx].T.real.astype(dt))
  ci = np.ascontiguousarray(S[:, idx].T.imag.astype(dt))
  Vr = np.asarray(_hi_dot(sp.lazify(cr), sp.lazify(V)[:m]).glom())  # (k, n)
  Vi = np.asarray(_hi_dot(sp.lazify(ci), sp.lazify(V)[:m]).glom())
  return w, (Vr + 1j * Vi).T


def svds(A, k: int = 6, *, ncv: int = None, which: str = "LM"):
  """The top-k (``which='LM'``) or bottom-k (``'SM'``) singular triplets by
  Lanczos on the Gram operator of the smaller side (``AᵀA`` or ``AAᵀ``).
  Returns ``(u (p, k), s (k,) ascending, vt (k, q))``, scipy's shapes and
  order.  A sparse ``A``'s transpose is built once, on the first
  ``rmatvec``, and the operator keeps ``A`` itself for the whole solve
  (the transpose holds it weakly).

  ``'SM'`` runs shift-invert Lanczos on the Gram operator at a small
  negative shift ``σ = −δ`` (δ from an estimate of the spectral scale):
  the eigenvalues nearest −δ are the smallest, and ``G + δI`` stays
  positive definite, so the LU or the inner minres never meets a singular
  shifted operator, even for a rank-deficient ``A``."""
  op = aslinearoperator(A)
  p, q = op.shape
  if op._rmatvec is None:
    raise ValueError("svds needs rmatvec")
  small_right = q <= p
  if small_right:
    gram = LinearOperator((q, q), lambda x: op.rmatvec(op.matvec(x)),
                          dtype=op.dtype)
  else:
    gram = LinearOperator((p, p), lambda x: op.matvec(op.rmatvec(x)),
                          dtype=op.dtype)
  which = which.upper()
  if which == "LM":
    w, y = eigsh(gram, k, which="LM", ncv=ncv)
  elif which == "SM":
    if isinstance(A, LinearOperator):
      G_si, mode = gram, "iterative"
      # the spectral scale: two host-driven power steps on G
      v = np.random.default_rng(0).standard_normal(gram.shape[1])
      v /= np.linalg.norm(v)
      for _ in range(2):
        gv = np.asarray(sp.lazify(gram.matvec(sp.lazify(v))).glom())
        scale = float(np.linalg.norm(gv))
        v = gv / max(scale, _TINY)
    else:
      Ad = _dense_operand(A)
      G = Ad.mT @ Ad if small_right else Ad @ Ad.mT
      scale = float(G.abs().sum(1).max())  # ≥ λmax
      G_si, mode = sp.Val(SpartanArray(G)), "auto"
    delta = max(1e-6 * scale, 1e-30)
    w, y = eigsh(G_si, k, which="LM", ncv=ncv, sigma=-delta, mode=mode)
  else:
    raise ValueError(f"which={which!r} not in LM/SM")
  s = np.sqrt(np.clip(w, 0.0, None))
  ye = sp.lazify(y)
  # the small side's basis through A (or Aᵀ), normalized
  other = []
  for i in range(k):
    z = op.matvec(ye[:, i]) if small_right else op.rmatvec(ye[:, i])
    other.append(z / max(float(s[i]), _TINY))
  oth = sp.transpose(sp.stack([sp.lazify(o) for o in other])).evaluate()
  if small_right:
    u, vt = oth, sp.transpose(ye).evaluate()
  else:
    u, vt = y, sp.transpose(sp.lazify(oth)).evaluate()
  return u, s, vt


def expm_multiply(A, B, t: float = 1.0, *, ncv: int = None):
  """``exp(t·A) @ B`` without forming the exponential: one ``ncv``-step
  Arnoldi cycle a column over the compiled step, scipy's ``expm`` of the
  small ``t·H`` on the host, and one product ``V[:m]ᵀ (e^{tH} β e₁)`` on
  the device.  The Krylov error decays factorially in ``ncv`` (default
  ``min(n, 30)``) while ``t·‖A‖`` is within its reach; a posterior
  estimate warns past 1e-10 (float64) or 1e-5 (float32)."""
  from scipy.linalg import expm as _small_expm
  op = aslinearoperator(A)
  n = op.shape[1]
  if op.shape[0] != n:
    raise ValueError("expm_multiply needs a square operator")
  Be = sp.lazify(B)
  if Be.ndim not in (1, 2) or Be.shape[0] != n:
    raise ValueError(f"B shape {Be.shape} incompatible with operator "
                     f"{op.shape}")
  one_d = Be.ndim == 1
  cols = [Be] if one_d else [Be[:, i] for i in range(Be.shape[1])]
  dt = _op_float(op)
  m = min(n, int(ncv) if ncv else 30)
  outs = []
  for c in cols:
    ce = sp.lazify(c).astype(dt)
    beta = sp.sqrt(_hi_dot(ce, ce))
    beta_f = float(beta.glom())
    if beta_f == 0.0:
      outs.append(sp.zeros((n,), dtype=dt))
      continue
    V0 = sp.outer(_onehot(0, m + 1, dt), ce / beta)
    H0 = sp.zeros((m + 1, m), dtype=dt)
    V, H = _arnoldi_cycle(op.matvec, V0, H0, 0, m, dt)
    Hh = np.asarray(sp.lazify(H).glom())
    eH = _small_expm(float(t) * Hh[:m, :m].astype(np.float64))
    y = (beta_f * eH[:, 0]).astype(dt)
    # the discarded next-basis coupling |beta_m e_mᵀ e^{tH} e_1| bounds
    # the leading truncation term
    ynorm = max(float(np.linalg.norm(y)), 1e-300)
    rel_est = abs(float(Hh[m, m - 1]) * beta_f * eH[m - 1, 0]) / ynorm
    warn_tol = 1e-10 if dt == np.float64 else 1e-5
    if m < n and rel_est > warn_tol:
      from spartan_tpu_torch.util import log_warn
      log_warn("expm_multiply: Krylov truncation estimate %.2e at "
               "ncv=%d — raise ncv (or split t) for t*||A|| this large",
               rel_est, m)
    outs.append(_hi_dot(sp.lazify(y), sp.lazify(V)[:m]))
  if one_d:
    return outs[0].evaluate()
  return sp.transpose(sp.stack([sp.lazify(o) for o in outs])).evaluate()


# -- the error classes and the host boundaries ----------------------------------

class ArpackError(RuntimeError):
  """ARPACK's error class (scipy.sparse.linalg's)."""

  def __init__(self, info, infodict=None):
    self.info = info
    super().__init__(f"ARPACK error {info}")


class ArpackNoConvergence(ArpackError):
  """An eigensolver that did not converge, with its partial results (as
  scipy's)."""

  def __init__(self, msg, eigenvalues, eigenvectors):
    RuntimeError.__init__(self, msg)
    self.info = -1
    self.eigenvalues = eigenvalues
    self.eigenvectors = eigenvectors


class MatrixRankWarning(UserWarning):
  """scipy.sparse.linalg.MatrixRankWarning."""


def use_solver(**kwargs):
  """scipy switches its UMFPACK backend here; the port has one solve path,
  so this does nothing."""
  del kwargs


_host_noticed: set = set()


def _host_notice(name, why):
  """Say once a process that ``name`` runs on the host, and count the run
  in ``expr.fio.counts["host_runs"]``."""
  from spartan_tpu_torch.expr import fio
  fio.counts["host_runs"] += 1
  if name in _host_noticed:
    return
  _host_noticed.add(name)
  from spartan_tpu_torch.util import log_info
  log_info("sp.sparse.linalg.%s: %s — runs EAGERLY on the host "
           "(scipy.sparse.linalg), the sp.linalg.eig convention.",
           name, why)


def _to_scipy_sparse(A):
  from spartan_tpu_torch.backend import sparse as sps
  if isinstance(A, sps.SparseArray):
    return A.to_scipy()
  import scipy.sparse as ss
  if ss.issparse(A):
    return A
  return ss.csr_matrix(np.asarray(sp.lazify(A).glom()))


def _densified_leaf(A):
  """A SparseArray as a dense leaf on its device in its own dtype
  (duplicates summed, no host round trip); anything else lazified."""
  from spartan_tpu_torch.backend import sparse as sps
  if isinstance(A, sps.SparseArray):
    return sp.Val(SpartanArray(A.dense_tensor()))
  return sp.lazify(A)


# -- the densified device matrix functions --------------------------------------

def expm(A):
  """Sparse ``e^A``: densified on the device, then
  ``scipy_linalg.expm``; a dense lazy expr (``e^A`` is dense; for the
  action at scale, :func:`expm_multiply`)."""
  from spartan_tpu_torch import scipy_linalg as _sl
  return _sl.expm(_densified_leaf(A))


@structural
def _inv_k(a):
  a = a if a.dtype in (torch.float64, torch.float32) else a.to(torch.float32)
  return torch.linalg.inv_ex(a).inverse


def inv(A):
  """Sparse inverse: densified, then ``torch.linalg.inv_ex`` on the device
  (a dense lazy expr; prefer :func:`spsolve`/:func:`cg` for a solve)."""
  return sp.map([_densified_leaf(A)], _inv_k)


def matrix_power(A, power: int):
  """``A**power``: densified, then ``torch.linalg.matrix_power`` on the
  device (a dense lazy expr; sparse powers fill in fast)."""
  from spartan_tpu_torch.scipy_linalg import _matrix_power_k
  return sp.map([_densified_leaf(A)], _matrix_power_k,
                fn_kw={"n": int(power)})


@structural
def _trsv_k(a, b, lower=True, unit=False):
  dt = torch.promote_types(a.dtype, b.dtype)
  if dt not in (torch.float64, torch.float32):
    dt = torch.float32
  vec = b.ndim == 1
  x = torch.linalg.solve_triangular(a.to(dt), (b[:, None] if vec else b)
                                    .to(dt), upper=not lower,
                                    unitriangular=unit)
  return x[:, 0] if vec else x


def spsolve_triangular(A, b, lower: bool = True,
                       overwrite_A=False, overwrite_b=False,
                       unit_diagonal: bool = False):
  """Triangular solve: densified, then ``torch.linalg.solve_triangular``
  on the device (level scheduling of a sparse triangle is a sequential
  host algorithm)."""
  del overwrite_A, overwrite_b
  return sp.map([_densified_leaf(A), sp.lazify(b)], _trsv_k,
                fn_kw={"lower": bool(lower), "unit": bool(unit_diagonal)})


def _ell_offsets(A):
  """Signed column − row offsets of the stored entries, and which of them
  are nonzero, on the device."""
  rows = torch.arange(A.shape[0], device=A.cols.device)[:, None]
  return A.cols.long() - rows, A.vals != 0


def _as_sparse(A):
  from spartan_tpu_torch.backend import sparse as sps
  if isinstance(A, sps.SparseArray):
    return A
  return sps.from_scipy(_to_scipy_sparse(A))


def is_sptriangular(A):
  """``(lower, upper)``: two masked reductions over the ELL tensors on the
  device (scipy walks indptr on the host)."""
  off, live = _ell_offsets(_as_sparse(A))
  above = bool((live & (off > 0)).any())
  below = bool((live & (off < 0)).any())
  return (not above, not below)


def spbandwidth(A):
  """``(below, above)`` bandwidths: masked max-reductions on the
  device."""
  off, live = _ell_offsets(_as_sparse(A))
  zero = torch.zeros_like(off)
  lo = int(torch.where(live, -off, zero).max()) if off.numel() else 0
  hi = int(torch.where(live, off, zero).max()) if off.numel() else 0
  return lo, hi


@structural
def _laplacian_nd(x, grid_shape=(), bc="neumann"):
  """The grid Laplacian of ``x`` (its last axis the raveled grid, any
  leading axes a batch), axis by axis: the neighbours above and below are
  a slice and a concatenate (with a zero face, or the opposite face for the
  periodic boundary), minus each point's degree times itself."""
  dt = x.dtype if x.dtype in (torch.float32, torch.float64) else torch.float32
  lead = x.shape[:-1]
  g = x.to(dt).reshape(lead + tuple(grid_shape))
  out = torch.zeros_like(g)
  deg = torch.zeros((), dtype=dt, device=x.device)
  for i, size in enumerate(grid_shape):
    ax = len(lead) + i
    if bc == "periodic":
      up = torch.cat([g.narrow(ax, 1, size - 1), g.narrow(ax, 0, 1)], ax)
      dn = torch.cat([g.narrow(ax, size - 1, 1), g.narrow(ax, 0, size - 1)],
                     ax)
      deg = deg + 2.0
    else:
      zshape = list(g.shape)
      zshape[ax] = 1
      z = torch.zeros(zshape, dtype=dt, device=x.device)
      up = torch.cat([g.narrow(ax, 1, size - 1), z], ax)
      dn = torch.cat([z, g.narrow(ax, 0, size - 1)], ax)
      if bc == "neumann":
        nb = torch.full((size,), 2.0, dtype=dt, device=x.device)
        nb[0] -= 1.0
        nb[-1] -= 1.0
        view = [1] * g.ndim
        view[ax] = size
        deg = deg + nb.reshape(view)
      else:
        deg = deg + 2.0
    out = out + up + dn
  return (out - deg * g).reshape(x.shape)


class LaplacianNd(LinearOperator):
  """The N-D grid Laplacian (scipy.sparse.linalg.LaplacianNd): its matvec
  is a map of slices and concatenates on the device (no matrix is formed),
  its eigenvalues the closed-form sums of the per-axis spectra.
  ``boundary_conditions`` is one of 'neumann', 'dirichlet', 'periodic'."""

  def __init__(self, grid_shape, *, boundary_conditions: str = "neumann",
               dtype=np.int8):
    self.grid_shape = tuple(int(g) for g in grid_shape)
    if boundary_conditions not in ("neumann", "dirichlet", "periodic"):
      raise ValueError(f"unknown boundary_conditions "
                       f"{boundary_conditions!r}")
    self.boundary_conditions = boundary_conditions
    n = int(np.prod(self.grid_shape))
    self._kw = {"grid_shape": self.grid_shape, "bc": boundary_conditions}
    mv = self._apply
    super().__init__((n, n), mv, mv, dtype=dtype)  # symmetric

  def _apply(self, v):
    return sp.map([sp.lazify(v)], _laplacian_nd, fn_kw=self._kw)

  def _axis_eigs(self, m: int) -> np.ndarray:
    k = np.arange(m)
    if self.boundary_conditions == "dirichlet":
      return -4.0 * np.sin(np.pi * (k + 1) / (2 * (m + 1))) ** 2
    if self.boundary_conditions == "neumann":
      return -4.0 * np.sin(np.pi * k / (2 * m)) ** 2
    return -4.0 * np.sin(np.pi * np.floor((k + 1) / 2) / m) ** 2

  def eigenvalues(self, m: int = None) -> np.ndarray:
    """All (or the ``m`` largest) eigenvalues, ascending: the per-axis
    spectra summed over the grid on the host, O(N)."""
    grids = np.meshgrid(*[self._axis_eigs(g) for g in self.grid_shape],
                        indexing="ij")
    lam = np.sort(sum(grids).ravel())
    return lam if m is None else lam[-m:]

  def toarray(self) -> np.ndarray:
    """The dense form: one application of the map to the identity's rows
    as a batch (never column by column)."""
    n = self.shape[0]
    rows = np.asarray(self._apply(sp.eye(n, dtype=np.float64)).glom())
    return rows.T

  def tosparse(self):
    from spartan_tpu_torch.backend.sparse import from_dense
    return from_dense(self.toarray())


# -- the host boundaries (SuperLU, ARPACK's neighbours) --------------------------

def splu(A, **kw):
  """Sparse LU (SuperLU) on the host: sequential pivoting has no device
  kernel.  Returns scipy's SuperLU (its ``solve`` runs on the host)."""
  import scipy.sparse.linalg as ssl
  _host_notice("splu", "sequential sparse pivoting (SuperLU)")
  return ssl.splu(_to_scipy_sparse(A).tocsc(), **kw)


def spilu(A, **kw):
  """Incomplete LU on the host; its ``.solve`` in a device solver pays a
  host round trip an iteration."""
  import scipy.sparse.linalg as ssl
  _host_notice("spilu", "sequential incomplete factorization (SuperLU)")
  return ssl.spilu(_to_scipy_sparse(A).tocsc(), **kw)


def factorized(A):
  """A pre-factorized solve closure on the host (SuperLU)."""
  import scipy.sparse.linalg as ssl
  _host_notice("factorized", "sequential sparse pivoting (SuperLU)")
  return ssl.factorized(_to_scipy_sparse(A).tocsc())


# splu/spilu return scipy's SuperLU objects; the class itself keeps
# isinstance checks working
from scipy.sparse.linalg import SuperLU  # noqa: E402


def _host_operand(op):
  if op is None:
    return None
  if hasattr(op, "to_scipy"):
    return op.to_scipy()
  if isinstance(op, (Expr, np.ndarray)):
    return np.asarray(sp.lazify(op).glom())
  return op  # a scipy operator or a callable


def lobpcg(A, X, B=None, M=None, Y=None, tol=None, maxiter=20,
           largest=True, verbosityLevel=0, retLambdaHistory=False,
           retResidualNormsHistory=False, restartControl=20):
  """LOBPCG on the host (scipy's adaptive driver); for eigenproblems on
  the device, :func:`eigsh`."""
  import scipy.sparse.linalg as ssl
  _host_notice("lobpcg", "adaptive host driver")
  return ssl.lobpcg(_to_scipy_sparse(A), np.asarray(sp.lazify(X).glom()),
                    B=_host_operand(B), M=_host_operand(M),
                    Y=None if Y is None else np.asarray(sp.lazify(Y).glom()),
                    tol=tol, maxiter=maxiter, largest=largest,
                    verbosityLevel=verbosityLevel,
                    retLambdaHistory=retLambdaHistory,
                    retResidualNormsHistory=retResidualNormsHistory,
                    restartControl=restartControl)


def _host_vec(x):
  return None if x is None else np.asarray(sp.lazify(x).glom())


def lgmres(A, b, x0=None, *, rtol=1e-5, atol=0.0, maxiter=1000, M=None,
           inner_m=30, outer_k=3, outer_v=None, store_outer_Av=True,
           prepend_outer_v=False):
  """LGMRES (augmented restarts) on the host; :func:`gmres` runs
  restarted GMRES on the device."""
  import scipy.sparse.linalg as ssl
  _host_notice("lgmres", "adaptive augmented-restart host driver")
  return ssl.lgmres(_to_scipy_sparse(A), _host_vec(b), x0=_host_vec(x0),
                    rtol=rtol, atol=atol, maxiter=maxiter, M=M,
                    inner_m=inner_m, outer_k=outer_k, outer_v=outer_v,
                    store_outer_Av=store_outer_Av,
                    prepend_outer_v=prepend_outer_v)


def gcrotmk(A, b, x0=None, *, rtol=1e-5, atol=0.0, maxiter=1000,
            M=None, callback=None, m=20, k=None, CU=None,
            discard_C=False, truncate="oldest"):
  """GCROT(m,k) on the host (a recycling-subspace driver)."""
  import scipy.sparse.linalg as ssl
  _host_notice("gcrotmk", "recycling-subspace host driver")
  return ssl.gcrotmk(_to_scipy_sparse(A), _host_vec(b), x0=_host_vec(x0),
                     rtol=rtol, atol=atol, maxiter=maxiter, M=M,
                     callback=callback, m=m, k=k, CU=CU,
                     discard_C=discard_C, truncate=truncate)


def onenormest(A, t: int = 2, itmax: int = 5, compute_v=False,
               compute_w=False):
  """The Higham–Tisseur 1-norm estimate on the host (sign-vector matvecs
  steered by host argmaxes)."""
  import scipy.sparse.linalg as ssl
  _host_notice("onenormest", "host argmax-steered estimator")
  return ssl.onenormest(_to_scipy_sparse(A), t=t, itmax=itmax,
                        compute_v=compute_v, compute_w=compute_w)


def funm_multiply_krylov(f, A, b, **kw):
  """Krylov ``f(A) b`` on the host (scipy's adaptive restart driver; for
  ``f = exp``, :func:`expm_multiply` on the device).  The keywords go to
  scipy as given (its names moved between releases: ``restart_every_m``
  in 1.17, where the reference passes ``restart_every_n``); an older scipy
  lacks the function and raises its own ``AttributeError``."""
  import scipy.sparse.linalg as ssl
  _host_notice("funm_multiply_krylov", "adaptive host restart driver")
  return ssl.funm_multiply_krylov(f, _to_scipy_sparse(A), _host_vec(b), **kw)


__all__ += [
    "bicg", "cgs", "tfqmr", "qmr", "lsmr",
    "expm", "inv", "matrix_power", "spsolve_triangular",
    "is_sptriangular", "spbandwidth", "LaplacianNd",
    "ArpackError", "ArpackNoConvergence", "MatrixRankWarning",
    "use_solver", "splu", "spilu", "factorized", "SuperLU",
    "lobpcg", "lgmres", "gcrotmk", "onenormest",
    "funm_multiply_krylov",
]
