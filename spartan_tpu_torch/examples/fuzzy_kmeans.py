"""Fuzzy (soft) k-means (port of ``spartan_tpu/examples/fuzzy_kmeans.py``).
Membership weights replace hard labels; the weighted centroid update is
two products (the memberships are dense).
"""

from __future__ import annotations

import numpy as np

import spartan_tpu_torch as sp


def memberships(points, centers, m: float = 2.0):
  """Soft membership u_ik ∝ 1 / d_ik^(2/(m-1)), rows normalized."""
  d2 = (sp.sum(points * points, axis=1).reshape(points.shape[0], 1)
        - 2.0 * sp.dot(points, centers.T)
        + sp.sum(centers * centers, axis=1))
  d2 = sp.maximum(d2, 1e-12)
  inv = d2 ** (-1.0 / (m - 1.0))
  return inv / sp.expand_dims(sp.sum(inv, axis=1), 1)


def update_centers(points, u, m: float = 2.0):
  um = u ** m
  weighted = sp.dot(um.T, points)
  weights = sp.sum(um, axis=0)
  return weighted / sp.expand_dims(weights, 1)


def fit(points, k: int, iterations: int = 15, m: float = 2.0, seed: int = 0):
  points = sp.lazify(points)
  n, d = points.shape
  rng = np.random.default_rng(seed)
  centers = sp.from_numpy(
      np.asarray(points.evaluate().glom()[rng.choice(n, k, replace=False)]))
  u = None
  for _ in range(iterations):
    u = memberships(points, centers, m)
    centers = sp.Val(update_centers(points, u, m).evaluate())
  return centers.evaluate(), u.evaluate()


def fit_fused(points, k: int, iterations: int = 15, m: float = 2.0,
              seed: int = 0):
  """The whole fuzzy-c-means run through ``sp.make_fori`` over the
  centers carry; the same result as :func:`fit`."""
  points = sp.lazify(points)
  n, d = points.shape
  rng = np.random.default_rng(seed)
  c0 = sp.from_numpy(
      np.asarray(points.evaluate().glom()[rng.choice(n, k, replace=False)]))
  run = sp.make_fori(
      lambda c: update_centers(points, memberships(points, c, m), m), c0)
  centers = run(iterations)
  # :func:`fit` returns the memberships w.r.t. the centers BEFORE the
  # last update (the classic FCM loop order): the same runner at one
  # fewer iteration (the count is a host count, so the step is reused)
  c_prev = run(iterations - 1) if iterations > 0 else c0.evaluate()
  u = memberships(points, sp.lazify(c_prev), m).evaluate()
  return centers, u


def run(n: int = 2048, d: int = 4, k: int = 3, iterations: int = 15):
  from spartan_tpu_torch.examples.kmeans import make_data
  pts, true_centers = make_data(n, d, k)
  centers, u = fit(pts, k, iterations)
  return centers, u, true_centers
