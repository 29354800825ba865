"""Lasso regression by FISTA (port of ``spartan_tpu/examples/lasso.py``).

The Gram matrix is one contraction on the device; its 30 power iterations
for the Lipschitz constant run on the host, as in the reference.  The
proximal-gradient run (two products, the soft-threshold prox and the
momentum) goes through ``sp.make_fori``, whose carry keeps the 0-d
float64 momentum scalar.
"""

from __future__ import annotations

import numpy as np

import spartan_tpu_torch as sp


def _soft_threshold(v, t: float):
  return sp.sign(v) * sp.maximum(sp.abs(v) - t, 0.0)


def fit_fused(X, y, reg: float = 0.1, iters: int = 200):
  """argmin_w  |X w − y|²/(2n) + reg·|w|₁  (FISTA through ``sp.make_fori``)."""
  X, y = sp.lazify(X), sp.lazify(y)
  n, d = X.shape
  # Lipschitz constant of the gradient: the largest eigenvalue of XᵀX/n by
  # 30 power iterations on the host (a host scalar, as in the reference)
  g = sp.dot(sp.transpose(X), X, precision="highest").evaluate()
  v = np.ones(d) / np.sqrt(d)
  gn = np.asarray(g.glom())
  for _ in range(30):
    v = gn @ v
    v /= np.linalg.norm(v)
  lip = float(v @ gn @ v) / n
  step = 1.0 / lip

  def body(w, z, t):
    grad = sp.dot(sp.transpose(X), sp.dot(X, z) - y) / n
    w_new = _soft_threshold(z - step * grad, step * reg)
    t_new = (1.0 + sp.sqrt(1.0 + 4.0 * t * t)) / 2.0
    z_new = w_new + ((t - 1.0) / t_new) * (w_new - w)
    return (w_new, z_new, t_new)

  w0 = sp.zeros((d,), dtype=np.float64)
  run = sp.make_fori(body, (w0, w0, sp.Val(np.float64(1.0))))
  w, _, _ = run(iters)
  return w


def fit_numpy(X, y, reg: float = 0.1, iters: int = 200):
  """Identical FISTA loop in numpy (the universal oracle)."""
  X, y = np.asarray(X, np.float64), np.asarray(y, np.float64)
  n, d = X.shape
  gn = X.T @ X
  v = np.ones(d) / np.sqrt(d)
  for _ in range(30):
    v = gn @ v
    v /= np.linalg.norm(v)
  step = n / float(v @ gn @ v)
  w = z = np.zeros(d)
  t = 1.0
  for _ in range(iters):
    grad = X.T @ (X @ z - y) / n
    u = z - step * grad
    w_new = np.sign(u) * np.maximum(np.abs(u) - step * reg, 0.0)
    t_new = (1.0 + np.sqrt(1.0 + 4.0 * t * t)) / 2.0
    z = w_new + ((t - 1.0) / t_new) * (w_new - w)
    w, t = w_new, t_new
  return w


def run(n: int = 8192, d: int = 32, reg: float = 0.1, seed: int = 0):
  rng = np.random.default_rng(seed)
  X = rng.standard_normal((n, d))
  w_true = np.zeros(d)
  w_true[rng.choice(d, d // 4, replace=False)] = rng.standard_normal(d // 4)
  y = X @ w_true + 0.01 * rng.standard_normal(n)
  w = np.asarray(fit_fused(sp.from_numpy(X), sp.from_numpy(y), reg).glom())
  w_oracle = fit_numpy(X, y, reg)
  return w, w_oracle, w_true
