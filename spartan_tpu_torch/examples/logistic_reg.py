"""Logistic regression by batch gradient descent (port of
``spartan_tpu/examples/logistic_reg.py``).

The linear-regression loop plus a sigmoid map; each step is one region of
the evaluator, and :func:`fit_fused` builds the step once with
``make_fori``.
"""

from __future__ import annotations

import numpy as np

import spartan_tpu_torch as sp


def sigmoid(v):
  return 1.0 / (1.0 + sp.exp(-v))


def gradient_step(X, y, w, alpha: float):
  """One GD step on the logistic loss: ``w - alpha/N * X^T (σ(X w) - y)``
  (lazy)."""
  n = X.shape[0]
  pred = sigmoid(sp.dot(X, w))
  grad = sp.dot(X.T, pred - y) * (1.0 / n)
  return w - alpha * grad


def fit(X, y, iterations: int = 50, alpha: float = 1.0):
  X, y = sp.lazify(X), sp.lazify(y)
  w = sp.zeros((X.shape[1],), dtype=np.float64)
  for _ in range(iterations):
    w = sp.Val(gradient_step(X, y, w, alpha).evaluate())
  return w.evaluate()


def fit_fused(X, y, iterations: int = 50, alpha: float = 1.0):
  """The whole run as one cached loop step (``sp.make_fori``): the same
  steps as :func:`fit`, without rebuilding the expression each step."""
  X, y = sp.lazify(X), sp.lazify(y)
  run = sp.make_fori(lambda w: gradient_step(X, y, w, alpha),
                     sp.zeros((X.shape[1],), dtype=np.float64))
  return run(iterations)


def predict(X, w):
  return sigmoid(sp.dot(sp.lazify(X), sp.lazify(w))) > 0.5


def make_data(n: int = 4096, d: int = 16, seed: int = 0):
  """The reference's seeded data: X standard normal, labels from a random
  true weight vector."""
  rng = np.random.default_rng(seed)
  X = rng.standard_normal((n, d))
  w_true = rng.standard_normal(d)
  y = (1.0 / (1.0 + np.exp(-X @ w_true)) > 0.5).astype(np.float64)
  return sp.from_numpy(X), sp.from_numpy(y), w_true


def run(n: int = 4096, d: int = 16, iterations: int = 50):
  X, y, w_true = make_data(n, d)
  w = fit(X, y, iterations)
  acc = (np.asarray(predict(X, w).glom()) ==
         (y.glom() > 0.5)).mean()
  return w, acc
