"""Lanczos iteration: extremal eigenvalues of a large symmetric matrix (port
of ``spartan_tpu/examples/lanczos.py``).

Each step is a matvec and inner products over the expression layer; the
k × k tridiagonal eigenproblem runs on the host, as in the reference.  The
matvec of a float32 (or 16-bit) ``SparseArray`` is ``sp.dot(A, v)`` with
no precision, in the matrix's dtype, so it plans onto the SpMV kernels
(K3a up to 32768 columns, K3b past them); the recurrence stays in the
vectors' float64, as the reference's.  Dense and float64 matrices take
``sp.dot(..., precision="highest")``, the reference's.
"""

from __future__ import annotations

import numpy as np

import spartan_tpu_torch as sp
from spartan_tpu_torch.backend.sparse import SparseArray, spmv_kernel_dtype


def matvec(A, v):
  """``A @ v`` in ``v``'s dtype: through the SpMV kernels' dtype for a
  float32 or 16-bit sparse A, else at the highest precision."""
  if isinstance(A, SparseArray) and spmv_kernel_dtype(A.dtype):
    return sp.dot(A, v.astype(A.dtype)).astype(v.dtype)
  return sp.dot(A, v, precision="highest")


def tridiagonalize(A, k: int = 32, seed: int = 0,
                   full_reorth: bool = True):
  """k-step Lanczos on symmetric A (SparseArray, SpartanArray, expr or
  numpy): ``(alphas (k,), betas (k-1,), the k basis vectors as leaves)``.
  ``full_reorth`` orthogonalizes each new vector against the whole basis
  (plain Lanczos loses orthogonality in floating point)."""
  if not isinstance(A, SparseArray):
    A = sp.lazify(A)
  n = A.shape[0]
  rng = np.random.default_rng(seed)
  v0 = rng.standard_normal(n)
  v = sp.Val(sp.lazify(v0 / np.linalg.norm(v0)).evaluate())
  v_prev = None
  beta = 0.0
  alphas, betas, basis = [], [], []
  for i in range(k):
    basis.append(v)
    # a leaf: the alpha read and the update below would each run it again
    w = sp.Val(matvec(A, v).evaluate())
    if v_prev is not None:
      w = w - beta * v_prev
    alpha = float(sp.dot(w, v, precision="highest").glom())
    w = w - alpha * v
    if full_reorth:
      for u in basis:
        w = w - sp.dot(w, u, precision="highest") * u
      w = sp.Val(w.evaluate())
    alphas.append(alpha)
    if i + 1 == k:
      break
    beta = float(sp.sqrt(sp.dot(w, w)).glom())
    if beta < 1e-14:  # an invariant subspace: exact breakdown
      break
    v_prev = v
    v = sp.Val((w / beta).evaluate())
    betas.append(beta)
  return np.asarray(alphas), np.asarray(betas), basis


def ritz_values(alphas, betas) -> np.ndarray:
  """Eigenvalues of the tridiagonal T of a Lanczos run, ascending."""
  t = np.diag(alphas)
  if len(betas):
    m = len(alphas)
    t += np.diag(betas[:m - 1], 1) + np.diag(betas[:m - 1], -1)
  return np.linalg.eigvalsh(t)


def lanczos_tol(m: int, a_norm: float, eps: float = 2.0 ** -24) -> float:
  """How far the Ritz values of an m-step Lanczos run in float32 (its
  matvecs rounded to ``eps``) may lie from the same run's in float64: with
  full reorthogonalization the computed T_m is the exact one of a matrix
  within about ``m · eps · |A|_2`` of A, each step adding one rounding of
  a matvec and of m orthogonalizations, and a Ritz value moves by at most
  that much (Weyl); ``sqrt(m)`` more covers the Krylov space's own
  sensitivity over m steps.  ``a_norm`` bounds ``|A|_2``."""
  return m ** 1.5 * eps * a_norm


def top_eigenvalue(A, k: int = 32, seed: int = 0) -> float:
  """Largest eigenvalue estimate from the k-step Krylov subspace."""
  alphas, betas, _ = tridiagonalize(A, k=k, seed=seed)
  return float(ritz_values(alphas, betas)[-1])


def run(n: int = 512, k: int = 40, seed: int = 0):
  rng = np.random.default_rng(seed)
  m = rng.standard_normal((n, n))
  A = (m + m.T) / 2.0
  est = top_eigenvalue(A, k=k, seed=seed)
  true = float(np.linalg.eigvalsh(A)[-1])
  return est, true
