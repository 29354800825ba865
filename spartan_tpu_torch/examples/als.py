"""Alternating least squares matrix factorization (port of
``spartan_tpu/examples/als.py``, the reference's ALS / netflix example
family).

Factor updates use the normal-equations form: the Gram matrices (k×k) are
tiny, so the device work is the two big products ``R @ V`` / ``R.T @ U``;
the small solves run on the host, as in the reference.  A sparse ``R``
(``sparse.from_scipy(ratings, dtype="float32")``) takes both products
through :class:`~spartan_tpu_torch.backend.sparse.SpMMExpr`, which on the
card is the CSR SpMM kernel (K5a's counterpart).
"""

from __future__ import annotations

import numpy as np

import spartan_tpu_torch as sp


def fit(R, k: int = 8, iterations: int = 10, reg: float = 0.1, seed: int = 0):
  """Factor ratings ``R (n×m) ≈ U (n×k) @ V.T (k×m)``.

  ``R`` may be dense (array/expr) or a ``sparse.SparseArray``: the big
  products ``R @ V`` / ``R.T @ U`` then ride the lazy SpMM node (``sp.dot``
  sparse dispatch).  Zeros are treated as ratings of 0 (the reference's
  simple normal-equations ALS), so sparse and dense runs agree.  ``U`` and
  ``V`` are float64 numpy arrays, solved on the host."""
  from spartan_tpu_torch.backend import sparse as sps
  is_sparse = isinstance(R, sps.SparseArray)
  if not is_sparse:
    R = sp.lazify(R)
  Rt = R.transpose() if is_sparse else R.T
  n, m = R.shape
  rng = np.random.default_rng(seed)
  U = rng.standard_normal((n, k)) * 0.1
  V = rng.standard_normal((m, k)) * 0.1
  eye = reg * np.eye(k)
  for _ in range(iterations):
    sv = sp.from_numpy(V)
    gram_v = np.asarray(sp.dot(sv.T, sv).glom()) + eye
    rv = np.asarray(sp.dot(R, sv).glom())
    U = np.linalg.solve(gram_v, rv.T).T
    su = sp.from_numpy(U)
    gram_u = np.asarray(sp.dot(su.T, su).glom()) + eye
    ru = np.asarray(sp.dot(Rt, su).glom())
    V = np.linalg.solve(gram_u, ru.T).T
  return U, V


def reconstruction_error(R, U, V):
  """Mean squared error of ``U @ V.T`` over every entry of ``R`` (a sparse
  ``R`` is densified)."""
  from spartan_tpu_torch.backend import sparse as sps
  if isinstance(R, sps.SparseArray):
    R = R.todense()
  R = sp.lazify(R)
  pred = sp.dot(sp.from_numpy(U), sp.from_numpy(V).T)
  return float(sp.mean(sp.square(R - pred)).glom())


def run(n: int = 256, m: int = 128, k: int = 8, iterations: int = 10,
        seed: int = 0):
  rng = np.random.default_rng(seed)
  U0 = rng.standard_normal((n, k))
  V0 = rng.standard_normal((m, k))
  R = U0 @ V0.T + 0.01 * rng.standard_normal((n, m))
  U, V = fit(sp.from_numpy(R), k, iterations)
  err = reconstruction_error(sp.from_numpy(R), U, V)
  return U, V, err
