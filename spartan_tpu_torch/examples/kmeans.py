"""k-means clustering (port of ``spartan_tpu/examples/kmeans.py``).

Distances by one ``dot`` → argmin labels → the centroid update, either as
a one-hot matrix product (the default) or as the reference's shuffle with
an add reducer (``use_matmul=False``).  :func:`fit` evaluates one update a
step; :func:`fit_fused` runs the whole Lloyd loop as torch ops on the
device, seeded at random or by :func:`farthest_init`.
"""

from __future__ import annotations

import numpy as np
import torch

import spartan_tpu_torch as sp
from spartan_tpu_torch.core.array import SpartanArray


def assign_labels(points, centers):
  """Nearest-centroid labels via ||p||² - 2 p·c + ||c||² (the ||p||² term
  is constant per row and dropped); ties go to the first centroid."""
  d = (-2.0) * sp.dot(points, centers.T) + sp.sum(centers * centers, axis=1)
  return sp.argmin(d, axis=1)


def _emit_sums(p, l, coords):
  rows = l[:, None].expand(p.shape)
  return (rows, coords[1]), p


def _emit_counts(l, coords):
  # the port's default float (float64), as the reference's result_type(float)
  return (l,), torch.ones_like(l, dtype=torch.float64)


def _onehot(l, k):
  classes = torch.arange(k, dtype=l.dtype, device=l.device)
  return (l[:, None] == classes[None, :]).to(torch.float64)


def update_centers(points, labels, k: int, use_matmul: bool = True):
  """Centroid update.  Two formulations, identical results:

  * scatter-add (the reference's shuffle+combiner pattern);
  * one-hot matmul segment-sum (default).
  """
  d = points.shape[1]
  if use_matmul:
    onehot = sp.map([labels], _onehot, fn_kw={"k": k})
    sums = sp.dot(onehot.T, points)
    counts = sp.sum(onehot, axis=0)
  else:
    sums = sp.shuffle([points, labels], _emit_sums, (k, d), np.add)
    counts = sp.shuffle(labels, _emit_counts, (k,), np.add)
  safe = sp.maximum(counts, 1.0)
  return sums / sp.expand_dims(safe, 1)


def fit(points, k: int, iterations: int = 10, centers=None, seed: int = 0):
  points = sp.lazify(points)
  n, d = points.shape
  if centers is None:
    rng = np.random.default_rng(seed)
    centers = sp.from_numpy(
        np.asarray(points.evaluate().glom()[rng.choice(n, k, replace=False)]))
  else:
    centers = sp.lazify(centers)
  labels = None
  for _ in range(iterations):
    labels = assign_labels(points, centers)
    centers = sp.Val(update_centers(points, labels, k).evaluate())
  return centers.evaluate(), labels.evaluate() if labels is not None else None


def farthest_init(points, k: int, seed: int = 0) -> np.ndarray:
  """Farthest-point (k-center greedy) seeding: a random first center,
  then repeatedly the point farthest from its nearest chosen center, one
  fused distance map and argmax a round.  Immune to the random seeding's
  empty-cluster fixed point (two seeds in one tight blob)."""
  points = sp.lazify(points)
  n = points.shape[0]
  rng = np.random.default_rng(seed)
  first = int(rng.integers(0, n))
  chosen = [np.asarray(points[first].glom())]
  for _ in range(k - 1):
    cs = sp.Val(np.stack(chosen))
    d2 = (sp.sum(points * points, axis=1).reshape((n, 1))
          - 2.0 * sp.dot(points, sp.transpose(cs))
          + sp.sum(cs * cs, axis=1))
    nxt = int(sp.argmax(sp.min(d2, axis=1)).glom())
    chosen.append(np.asarray(points[nxt].glom()))
  return np.stack(chosen)


def fit_fused(points, k: int, iterations: int = 10, centers=None,
              seed: int = 0, init: str = "random"):
  """The whole Lloyd loop as torch ops on the points' device, in the
  points' dtype (the reference's one compiled loop; semantics match
  :func:`fit`; ``init='farthest'`` seeds with :func:`farthest_init`).
  Returns a ``SpartanArray``."""
  points = sp.lazify(points).evaluate()
  n, d = points.shape
  if centers is None and init == "farthest":
    c0 = farthest_init(sp.Val(points), k, seed)
  elif centers is None:
    rng = np.random.default_rng(seed)
    c0 = np.asarray(points.glom()[rng.choice(n, k, replace=False)])
  else:
    c0 = np.asarray(sp.lazify(centers).glom())
  p = points.data
  c = torch.as_tensor(c0, device=p.device).to(p.dtype)
  for _ in range(int(iterations)):
    dist = (-2.0) * (p @ c.T) + torch.sum(c * c, dim=1)
    lab = torch.argmin(dist, dim=1)
    onehot = _onehot(lab, k).to(p.dtype)
    sums = onehot.T @ p
    counts = torch.sum(onehot, dim=0)
    c = sums / torch.clamp_min(counts, 1.0)[:, None]
  return SpartanArray(c)


def make_data(n: int = 4096, d: int = 8, k: int = 4, seed: int = 0):
  """The reference's seeded blobs: k true centers ~ 6·N(0, 1), points at
  unit-variance noise around them."""
  rng = np.random.default_rng(seed)
  true_centers = rng.standard_normal((k, d)) * 6.0
  labels = rng.integers(0, k, n)
  pts = true_centers[labels] + rng.standard_normal((n, d))
  return sp.from_numpy(pts), true_centers


def run(n: int = 4096, d: int = 8, k: int = 4, iterations: int = 10):
  pts, true_centers = make_data(n, d, k)
  centers, labels = fit(pts, k, iterations)
  return centers, labels, true_centers
