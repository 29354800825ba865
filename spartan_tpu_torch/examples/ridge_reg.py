"""Ridge regression in closed form through the Gram matrix (port of
``spartan_tpu/examples/ridge_reg.py``).

``X.T X`` and ``X.T y`` are evaluated together as two contractions on the
device; the (d × d) solve is the host's ``np.linalg.solve``, as in the
reference.
"""

from __future__ import annotations

import numpy as np

import spartan_tpu_torch as sp


def fit(X, y, reg: float = 1.0):
  X, y = sp.lazify(X), sp.lazify(y)
  d = X.shape[1]
  out = sp.evaluate(sp.ListExpr([sp.dot(X.T, X), sp.dot(X.T, y)]))
  gram = np.asarray(out[0].glom()) + reg * np.eye(d)
  xty = np.asarray(out[1].glom())
  return np.linalg.solve(gram, xty)


def run(n: int = 4096, d: int = 16, reg: float = 1e-3, seed: int = 0):
  rng = np.random.default_rng(seed)
  X = rng.standard_normal((n, d))
  w_true = rng.standard_normal(d)
  y = X @ w_true + 0.01 * rng.standard_normal(n)
  w = fit(sp.from_numpy(X), sp.from_numpy(y), reg)
  return w, w_true
