"""k-nearest-neighbours classification (port of
``spartan_tpu/examples/knn.py``).

- the pairwise squared distances are one product
  (``|a - b|² = |a|² + |b|² - 2 a·bᵀ``);
- the neighbours come from ``argpartition`` (the port's full sort: the
  same k nearest wherever distances do not tie);
- the majority vote sums a one-hot of the neighbours' labels.
"""

from __future__ import annotations

import numpy as np

import spartan_tpu_torch as sp


def pairwise_sq_dists(Q, X):
  """(nq, nx) squared euclidean distances, Gram-term formulation."""
  Q, X = sp.lazify(Q), sp.lazify(X)
  qn = sp.sum(Q * Q, axis=1, keepdims=True)          # (nq, 1)
  xn = sp.reshape(sp.sum(X * X, axis=1), (1, int(X.shape[0])))
  return qn + xn - 2.0 * sp.dot(Q, X.T)


def predict(Q, X, y, k: int = 5, n_classes: int | None = None):
  """Labels for queries ``Q`` given train set ``(X, y)`` — lazy expr."""
  Q, X = sp.lazify(Q), sp.lazify(X)
  y = sp.lazify(y)
  if n_classes is None:
    n_classes = int(np.asarray(sp.max(y).glom())) + 1
  d2 = pairwise_sq_dists(Q, X)
  # k smallest distances per query row; argpartition is O(m) per row
  idx = sp.argpartition(d2, k, axis=1)[:, :k]        # (nq, k) neighbor ids
  labels = sp.take(y, idx)                           # (nq, k)
  # majority vote = one-hot over classes, summed over the k axis
  onehot = sp.astype(
      sp.equal(sp.expand_dims(labels, 2),
               sp.reshape(sp.arange(n_classes, dtype=np.int64),
                          (1, 1, n_classes))), np.float64)
  votes = sp.sum(onehot, axis=1)                     # (nq, n_classes)
  return sp.argmax(votes, axis=1)


def make_blobs(n: int = 2048, d: int = 8, n_classes: int = 4,
               seed: int = 0, spread: float = 0.6):
  rng = np.random.default_rng(seed)
  centers = rng.standard_normal((n_classes, d)) * 3.0
  y = rng.integers(0, n_classes, n)
  X = centers[y] + spread * rng.standard_normal((n, d))
  return X, y


def run(n: int = 2048, d: int = 8, k: int = 5, seed: int = 0):
  X, y = make_blobs(n + 512, d, seed=seed)
  Xt, yt, Xq, yq = X[:n], y[:n], X[n:], y[n:]
  pred = np.asarray(predict(sp.from_numpy(Xq), sp.from_numpy(Xt),
                            sp.from_numpy(yt), k=k, n_classes=4).glom())
  return float((pred == yq).mean())
