"""Multinomial naive Bayes (port of
``spartan_tpu/examples/naive_bayes.py``).  The per-class feature counts
are a one-hot product (the default) or the reference's scatter-add
shuffle (``use_matmul=False``); scoring is one product of
log-probabilities.
"""

from __future__ import annotations

import numpy as np
import torch

import spartan_tpu_torch as sp


def _emit_counts(x, lab, coords):
  rows = lab[:, None].expand(x.shape)
  return (rows, coords[1]), x


def _emit_class_counts(lab, coords):
  # the port's default float (float64), as the reference's result_type(float)
  return (lab,), torch.ones_like(lab, dtype=torch.float64)


def _onehot(l, k):
  classes = torch.arange(k, dtype=l.dtype, device=l.device)
  return (l[:, None] == classes[None, :]).to(torch.float64)


def fit(X, labels, n_classes: int, alpha: float = 1.0,
        use_matmul: bool = True):
  """X: (n, d) nonneg feature counts; labels: (n,) ints.

  Returns (log_prior (k,), log_likelihood (k, d)) as SpartanArrays.
  Per-class aggregation defaults to the one-hot product (a segment sum);
  ``use_matmul=False`` keeps the reference-style scatter-add shuffle.
  """
  X, labels = sp.lazify(X), sp.lazify(labels)
  n, d = X.shape
  if use_matmul:
    onehot = sp.map([labels], _onehot, fn_kw={"k": n_classes})
    feat = sp.dot(onehot.T, X)
    cls = sp.sum(onehot, axis=0)
  else:
    feat = sp.shuffle([X, labels], _emit_counts, (n_classes, d), np.add)
    cls = sp.shuffle(labels, _emit_class_counts, (n_classes,), np.add)
  smoothed = feat + alpha
  log_lik = sp.log(smoothed) - sp.log(
      sp.expand_dims(sp.sum(smoothed, axis=1), 1))
  log_prior = sp.log(cls / float(n))
  out = sp.evaluate(sp.ListExpr([log_prior, log_lik]))
  return out[0], out[1]


def predict(X, log_prior, log_lik):
  scores = sp.dot(sp.lazify(X), sp.lazify(log_lik).T) + sp.lazify(log_prior)
  return sp.argmax(scores, axis=1)


def make_data(n: int = 2048, d: int = 20, k: int = 3, seed: int = 0):
  rng = np.random.default_rng(seed)
  profiles = rng.dirichlet(np.ones(d), size=k)
  labels = rng.integers(0, k, n)
  X = np.stack([rng.multinomial(50, profiles[l]) for l in labels]).astype(
      np.float64)
  return sp.from_numpy(X), sp.from_numpy(labels), labels


def run(n: int = 2048, d: int = 20, k: int = 3):
  X, slabels, labels = make_data(n, d, k)
  lp, ll = fit(X, slabels, k)
  pred = np.asarray(predict(X, lp, ll).glom())
  return (pred == labels).mean()
