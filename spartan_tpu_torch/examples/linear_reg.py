"""Linear regression by batch gradient descent (port of
``spartan_tpu/examples/linear_reg.py``).

Repeated map (prediction error) + dot (gradient) over the design matrix;
each step is one region of the evaluator, replayed from its cache after
the first step.
"""

from __future__ import annotations

import numpy as np

import spartan_tpu_torch as sp


def gradient_step(X, y, w, alpha: float):
  """One GD step: ``w - alpha * 2/N * X^T (X w - y)`` (lazy)."""
  n = X.shape[0]
  residual = sp.dot(X, w) - y
  grad = sp.dot(X.T, residual) * (2.0 / n)
  return w - alpha * grad


def fit(X, y, iterations: int = 50, alpha: float = 0.05):
  """Train; X/y are SpartanArrays, exprs, or numpy arrays."""
  X, y = sp.lazify(X), sp.lazify(y)
  w = sp.zeros((X.shape[1],), dtype=np.float64)
  for _ in range(iterations):
    w = sp.Val(gradient_step(X, y, w, alpha).evaluate())
  return w.evaluate()


def fit_fused(X, y, iterations: int = 50, alpha: float = 0.05):
  """The same training as :func:`fit` in one device loop
  (``sp.fori_loop`` over :func:`gradient_step`, the hand gradient): the
  step is optimized once and replayed, with no host read inside the loop.
  Starts from zeros of X's dtype."""
  X, y = sp.lazify(X), sp.lazify(y)
  w0 = sp.zeros((X.shape[1],), dtype=X.dtype)
  return sp.fori_loop(iterations,
                      lambda w: gradient_step(X, y, w, alpha), w0)


def make_data(n: int = 4096, d: int = 16, seed: int = 0, tile_hint=None):
  rng = np.random.default_rng(seed)
  X = rng.standard_normal((n, d))
  w_true = rng.standard_normal(d)
  y = X @ w_true + 0.01 * rng.standard_normal(n)
  return (sp.from_numpy(X, tile_hint=tile_hint), sp.from_numpy(y), w_true)


def run(n: int = 4096, d: int = 16, iterations: int = 50, alpha: float = 0.05):
  """Fit the seeded data of :func:`make_data`; returns ``(w, w_true)``."""
  X, y, w_true = make_data(n, d)
  w = fit(X, y, iterations, alpha)
  return w, w_true
