"""Spectral clustering: an RBF affinity, the normalized Laplacian's
embedding, then k-means on it (port of
``spartan_tpu/examples/spectral.py``).

The n × n affinity and the degree normalization are map, dot and reduce
exprs; the embedding comes from ``sp.linalg.eigh`` (``torch.linalg.eigh``
on the device); the clustering is ``examples/kmeans.fit_fused`` with
farthest-point seeding.
"""

from __future__ import annotations

import numpy as np

import spartan_tpu_torch as sp


def affinity_rbf(X, gamma: float = 10.0):
  """``W_ij = exp(-gamma |x_i - x_j|²)`` with a zero diagonal:
  ``|x_i - x_j|² = |x_i|² + |x_j|² - 2 x_i·x_j``."""
  X = sp.lazify(X)
  sq = sp.sum(X * X, axis=1)
  d2 = sq.reshape((X.shape[0], 1)) + sq - 2.0 * sp.dot(X, sp.transpose(X))
  w = sp.exp(-gamma * sp.maximum(d2, 0.0))
  return w - sp.diag(sp.diagonal(w))


def embed(W, k: int):
  """Rows of the top-k eigenvectors of ``D^-1/2 W D^-1/2`` (the normalized
  Laplacian's smallest), row-normalized (Ng, Jordan and Weiss)."""
  W = sp.lazify(W)
  dinv = 1.0 / sp.sqrt(sp.sum(W, axis=0) + 1e-12)
  sym = W * dinv.reshape((W.shape[0], 1)) * dinv
  _, vecs = sp.linalg.eigh(sym)
  top = vecs[:, -k:]  # eigh is ascending
  norm = sp.sqrt(sp.sum(top * top, axis=1) + 1e-12)
  return top / norm.reshape((W.shape[0], 1))


def fit(X, k: int, gamma: float = 10.0, iterations: int = 20,
        seed: int = 0):
  """Cluster labels for the rows of X (numpy)."""
  from spartan_tpu_torch.examples import kmeans
  emb = sp.Val(embed(affinity_rbf(X, gamma), k).evaluate())
  # farthest-point seeding: the embedding is tight orthogonal blobs, where
  # two random seeds in one blob leave an empty cluster
  centers = kmeans.fit_fused(emb, k, iterations, seed=seed,
                             init="farthest")
  labels = kmeans.assign_labels(emb, sp.Val(centers))
  return np.asarray(labels.glom())


def run(n: int = 512, seed: int = 0):
  """Two concentric rings, which no line separates: spectral clustering
  recovers them; the accuracy is label-permutation invariant."""
  rng = np.random.default_rng(seed)
  half = n // 2
  th = rng.uniform(0, 2 * np.pi, n)
  r = np.concatenate([np.full(half, 1.0), np.full(n - half, 3.0)])
  r = r + 0.05 * rng.standard_normal(n)
  X = np.stack([r * np.cos(th), r * np.sin(th)], axis=1)
  truth = np.concatenate([np.zeros(half, np.int64),
                          np.ones(n - half, np.int64)])
  labels = fit(sp.from_numpy(X), 2, gamma=4.0, seed=seed)
  return max(float((labels == truth).mean()),
             float((labels == 1 - truth).mean()))
