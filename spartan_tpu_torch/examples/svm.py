"""Linear SVM by subgradient descent on the hinge loss (port of
``spartan_tpu/examples/svm.py``).  The hinge mask, the subgradient's
reduction and the weight update are one expression a step.
"""

from __future__ import annotations

import numpy as np

import spartan_tpu_torch as sp


def gradient_step(X, y, w, alpha: float, C: float):
  """Subgradient of ``0.5||w||² + C Σ max(0, 1 - y x·w)``."""
  n = X.shape[0]
  margin = sp.dot(X, w) * y
  active = sp.astype(margin < 1.0, np.float64)
  subgrad = sp.dot(X.T, -(active * y)) * (C / n)
  return w - alpha * (w + subgrad)


def fit(X, y, iterations: int = 100, alpha: float = 0.1, C: float = 10.0):
  """y in {-1, +1}."""
  X, y = sp.lazify(X), sp.lazify(y)
  w = sp.zeros((X.shape[1],), dtype=np.float64)
  for _ in range(iterations):
    w = sp.Val(gradient_step(X, y, w, alpha, C).evaluate())
  return w.evaluate()


def fit_fused(X, y, iterations: int = 100, alpha: float = 0.1,
              C: float = 10.0):
  """The whole subgradient run through ``sp.make_fori``; the same
  iterates as :func:`fit`."""
  X, y = sp.lazify(X), sp.lazify(y)
  run = sp.make_fori(lambda w: gradient_step(X, y, w, alpha, C),
                     sp.zeros((X.shape[1],), dtype=np.float64))
  return run(iterations)


def predict(X, w):
  return sp.sign(sp.dot(sp.lazify(X), sp.lazify(w)))


def make_data(n: int = 2048, d: int = 8, seed: int = 0):
  rng = np.random.default_rng(seed)
  w_true = rng.standard_normal(d)
  X = rng.standard_normal((n, d))
  y = np.sign(X @ w_true + 1e-9)
  return sp.from_numpy(X), sp.from_numpy(y), w_true


def run(n: int = 2048, d: int = 8, iterations: int = 100):
  X, y, w_true = make_data(n, d)
  w = fit(X, y, iterations)
  acc = (np.asarray(predict(X, w).glom()) == y.glom()).mean()
  return w, acc
