"""PCA by a covariance and subspace (power) iteration, and the randomized
SVD (SSVD), port of ``spartan_tpu/examples/pca.py``.

The covariance ``Xcᵀ Xc / n`` and each iteration's products are
contractions over the expression layer; the QR of the small n × k or
d × k factor each iteration runs on the host, as in the reference.
"""

from __future__ import annotations

import numpy as np

import spartan_tpu_torch as sp


def covariance(X):
  """Mean-centered covariance (lazy)."""
  X = sp.lazify(X)
  n = X.shape[0]
  mu = X.mean(axis=0)
  Xc = X - mu
  return sp.dot(Xc.T, Xc) / float(n)


def fit(X, k: int = 2, iterations: int = 30, seed: int = 0):
  """Top-k principal directions by subspace iteration on the covariance:
  ``(components (d, k), eigenvalues (k,))``, numpy, largest first."""
  C = sp.Val(covariance(X).evaluate())
  d = C.shape[0]
  rng = np.random.default_rng(seed)
  Q = np.linalg.qr(rng.standard_normal((d, k)))[0]
  for _ in range(iterations):
    Z = sp.dot(C, sp.from_numpy(Q)).glom()
    Q, _ = np.linalg.qr(Z)
  evals = np.asarray(sp.dot(sp.from_numpy(Q.T),
                            sp.dot(C, sp.from_numpy(Q))).glom()).diagonal()
  order = np.argsort(-evals)
  return Q[:, order], evals[order]


def ssvd(X, k: int = 2, iterations: int = 20, seed: int = 0):
  """Randomized SVD (the reference's SSVD): subspace iteration on ``XᵀX``
  without forming it; ``(U (n, k), S (k,), Vt (k, d))`` numpy."""
  X = sp.lazify(X)
  n, d = X.shape
  rng = np.random.default_rng(seed)
  Q = np.linalg.qr(rng.standard_normal((d, k)))[0]
  for _ in range(iterations):
    Z = np.asarray(sp.dot(X.T, sp.dot(X, sp.from_numpy(Q))).glom())
    Q, _ = np.linalg.qr(Z)
  B = np.asarray(sp.dot(X, sp.from_numpy(Q)).glom())
  Ub, s, Wt = np.linalg.svd(B, full_matrices=False)
  V = Q @ Wt.T
  return Ub, s, V.T


def transform(X, components):
  X = sp.lazify(X)
  mu = X.mean(axis=0)
  return sp.dot(X - mu, sp.from_numpy(components))


def run(n: int = 2048, d: int = 16, k: int = 3, seed: int = 0):
  rng = np.random.default_rng(seed)
  scales = np.linspace(10, 1, d)
  X = rng.standard_normal((n, d)) * scales
  comps, evals = fit(sp.from_numpy(X), k)
  return comps, evals, X
