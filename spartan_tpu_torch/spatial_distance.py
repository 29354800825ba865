"""``sp.spatial.distance`` — the scipy.spatial.distance surface (port of
``spartan_tpu/spatial_distance.py``).

``cdist``/``pdist`` are ``map.structural`` functions over whole tensors:

* the inner-product metrics (euclidean, sqeuclidean, cosine, correlation,
  mahalanobis, seuclidean) are one ``torch.matmul`` (TF32 off,
  ``sp.initialize``) with the rank-one corrections ``|a|² + |b|² - 2ab``,
  clamped at 0;
* the broadcast metrics (cityblock, chebyshev, minkowski, canberra,
  braycurtis, hamming, jaccard, jensenshannon and the boolean
  dissimilarities) reduce ``f(a[:, None, :], b[None, :, :])`` over the last
  axis.  The ``(n, m, d)`` difference is never built whole: the rows of
  ``a`` go in chunks whose difference fits ``BUDGET`` bytes, chosen from
  the shapes before the first launch (``counts["chunks"]``); each row's
  result is the unchunked one.

``pdist`` is the strict upper triangle of the square form.  ``seuclidean``
without ``V`` and ``mahalanobis`` without ``VI`` take scipy's: the variance
(ddof 1) of the stacked rows, and the inverse of their covariance.  Integer
and bool operands become float64 (``special._f``); float32 stays float32.
``is_valid_dm``/``is_valid_y`` call scipy on the evaluated input, counted in
``expr.fio.counts["host_runs"]``.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.spatial.distance as _ssd
import torch

import spartan_tpu_torch as sp
from spartan_tpu_torch.expr import fio
from spartan_tpu_torch.special import _f, _host_value, _mapn_whole
from spartan_tpu_torch.special import rel_entr as _rel_entr

__all__ = [
    "cdist", "pdist", "squareform", "directed_hausdorff",
    "minkowski", "euclidean", "sqeuclidean", "cosine", "correlation",
    "cityblock", "chebyshev", "canberra", "braycurtis", "hamming",
    "jaccard", "jensenshannon", "rel_entr", "seuclidean",
    "mahalanobis", "russellrao", "rogerstanimoto", "sokalsneath",
    "dice", "yule", "kulczynski1",
    "is_valid_dm", "is_valid_y", "num_obs_dm", "num_obs_y",
]

# the broadcast metrics: the most bytes of (rows, m, d) difference a chunk
# of a's rows may hold
BUDGET = 1 << 30

counts = {"chunks": 0}

_INNER = ("sqeuclidean", "euclidean", "cosine", "correlation",
          "mahalanobis", "seuclidean")
_BCAST = ("cityblock", "chebyshev", "minkowski", "canberra", "braycurtis",
          "hamming", "jaccard", "jensenshannon", "russellrao",
          "rogerstanimoto", "sokalsneath", "dice", "yule", "kulczynski1")


def _dot(a, b):
  return torch.matmul(a, b)


def _pair_dot(a, b):
  """|a|² + |b|² - 2ab, clamped at 0 (the cancellation guard)."""
  sq = ((a * a).sum(-1)[:, None] + (b * b).sum(-1)[None, :]
        - 2.0 * _dot(a, b.T))
  return torch.clamp(sq, min=0.0)


def chunk_rows(n: int, m: int, d: int, itemsize: int) -> int:
  """Rows of ``a`` a chunk takes so that its ``(rows, m, d)`` difference
  fits ``BUDGET`` bytes (at least one)."""
  return max(1, min(n, BUDGET // max(1, m * d * itemsize)))


def _chunked(red):
  """``red(A[:, None, :], B[None, :, :])`` over chunks of A's rows."""
  def kern(a, b, *extra):
    n, m = a.shape[0], b.shape[0]
    if a.is_meta:
      return red(a[:1, None, :], b[None, :, :]).expand(n, m)
    rows = chunk_rows(n, m, a.shape[1], a.element_size())
    if rows >= n:
      counts["chunks"] += 1
      return red(a[:, None, :], b[None, :, :])
    parts = []
    for i in range(0, n, rows):
      counts["chunks"] += 1
      parts.append(red(a[i:i + rows, None, :], b[None, :, :]))
    return torch.cat(parts, 0)
  return kern


def _counts(A, B):
  """The boolean contingency counts (ctt, ctf, cft, cff) as floats."""
  A, B = A != 0, B != 0
  dt = torch.float64
  return ((A & B).sum(-1).to(dt), (A & ~B).sum(-1).to(dt),
          (~A & B).sum(-1).to(dt), (~A & ~B).sum(-1).to(dt))


def _where(c, x, y):
  """``torch.where`` with a Python scalar branch in ``x``'s dtype."""
  return torch.where(c, x, torch.as_tensor(y, dtype=x.dtype,
                                           device=x.device))


def _js(A, B, axis=-1, keepdims=False):
  P = A / torch.clamp(A.sum(axis, keepdim=True), min=1e-300)
  Q = B / torch.clamp(B.sum(axis, keepdim=True), min=1e-300)
  M = (P + Q) / 2.0

  def kl(x, m):
    return _where(x > 0, x * (torch.log(_where(x > 0, x, 1.0))
                              - torch.log(_where(m > 0, m, 1.0))), 0.0)
  d2 = (kl(P, M) + kl(Q, M)).sum(axis, keepdim=keepdims) / 2.0
  return torch.sqrt(torch.clamp(d2, min=0.0))


def _bcast_red(metric, p):
  """The reduction of ``(A, B)`` of shapes ``(r, 1, d)``, ``(1, m, d)``."""
  if metric == "cityblock":
    return lambda A, B: torch.abs(A - B).sum(-1)
  if metric == "chebyshev":
    return lambda A, B: torch.abs(A - B).amax(-1)
  if metric == "minkowski":
    return lambda A, B: (torch.abs(A - B) ** p).sum(-1) ** (1.0 / p)
  if metric == "canberra":
    def canb(A, B):
      num = torch.abs(A - B)
      den = torch.abs(A) + torch.abs(B)
      return _where(den > 0, num / _where(den > 0, den, 1.0), 0.0).sum(-1)
    return canb
  if metric == "braycurtis":
    return lambda A, B: (torch.abs(A - B).sum(-1)
                         / torch.abs(A + B).sum(-1))
  if metric == "hamming":
    return lambda A, B: (A != B).to(A.dtype).mean(-1)
  if metric == "jaccard":
    def jac(A, B):
      nz = (A != 0) | (B != 0)
      num = ((A != B) & nz).sum(-1).to(A.dtype)
      den = nz.sum(-1).to(A.dtype)
      return _where(den > 0, num / torch.clamp(den, min=1.0), 0.0)
    return jac
  if metric == "jensenshannon":
    return _js
  if metric == "russellrao":
    return lambda A, B: ((A.shape[-1] - ((A != 0) & (B != 0)).sum(-1)
                          .to(torch.float64)) / A.shape[-1])

  def boolean(fn):
    return lambda A, B: fn(*_counts(A, B))
  if metric == "rogerstanimoto":
    return boolean(lambda tt, tf, ft, ff: 2 * (tf + ft)
                   / (tt + ff + 2 * (tf + ft)))
  if metric == "sokalsneath":
    return boolean(lambda tt, tf, ft, ff: 2.0 * (tf + ft)
                   / (tt + 2 * (tf + ft)))
  if metric == "dice":
    return boolean(lambda tt, tf, ft, ff: (tf + ft) / (2 * tt + tf + ft))
  if metric == "yule":
    def yule(tt, tf, ft, ff):
      half = tf * ft
      return _where(half > 0, 2.0 * half / (tt * ff + half), 0.0)
    return boolean(yule)
  if metric == "kulczynski1":
    return boolean(lambda tt, tf, ft, ff: tt / (tf + ft))
  raise ValueError(f"unsupported metric {metric!r} — supported: "
                   + " ".join(_INNER + _BCAST))


def _metric_kern(metric, kw):
  """``(n, d), (m, d), *extra -> (n, m)`` for ``metric``."""
  if metric == "sqeuclidean":
    return lambda a, b, *s: _pair_dot(a, b)
  if metric == "euclidean":
    return lambda a, b, *s: torch.sqrt(_pair_dot(a, b))
  if metric in ("cosine", "correlation"):
    def cos(a, b, *s):
      if metric == "correlation":
        a = a - a.mean(-1, keepdim=True)
        b = b - b.mean(-1, keepdim=True)
      na = torch.linalg.vector_norm(a, dim=-1)[:, None]
      nb = torch.linalg.vector_norm(b, dim=-1)[None, :]
      return 1.0 - _dot(a, b.T) / (na * nb)
    return cos
  if metric == "mahalanobis":
    def maha(a, b, VI):
      aVI = _dot(a, VI)
      d2 = ((aVI * a).sum(-1)[:, None] + (_dot(b, VI) * b).sum(-1)[None, :]
            - 2.0 * _dot(aVI, b.T))
      return torch.sqrt(torch.clamp(d2, min=0.0))
    return maha
  if metric == "seuclidean":
    def seuc(a, b, V):
      iv = 1.0 / V
      d2 = ((a * a * iv).sum(-1)[:, None] + (b * b * iv).sum(-1)[None, :]
            - 2.0 * _dot(a * iv, b.T))
      return torch.sqrt(torch.clamp(d2, min=0.0))
    return seuc
  return _chunked(_bcast_red(metric, float(kw.get("p", 2.0))))


def _default_extra(metric, a, b):
  """scipy's ``V``/``VI`` from the stacked rows."""
  X = a if b is None else torch.cat([a, b], 0)
  if metric == "seuclidean":
    return torch.var(X, dim=0, correction=1)
  return torch.linalg.inv(torch.cov(X.T)).T


def _extra(metric, kw):
  """The ``V``/``VI`` operand the caller gave, or None for scipy's."""
  if metric == "mahalanobis":
    return kw.get("VI")
  if metric == "seuclidean":
    return kw.get("V")
  return None


def _floats(a, b):
  a, b = _f(a), _f(b)
  dt = torch.promote_types(a.dtype, b.dtype)
  return a.to(dt), b.to(dt)


def cdist(XA, XB, metric="euclidean", **kw):
  """Pairwise distances between two collections (lazy)."""
  A, B = sp.lazify(XA), sp.lazify(XB)
  kern = _metric_kern(metric, kw)
  given = _extra(metric, kw)
  needs = metric in ("mahalanobis", "seuclidean")

  def run(a, b, *s):
    a, b = _floats(a, b)
    extra = [_f(v).to(a.dtype) for v in s]
    if needs and not extra:
      extra = [_default_extra(metric, a, b)]
    return kern(a, b, *extra)
  ops = [A, B] + ([] if given is None else [sp.lazify(given)])
  return _mapn_whole(run, *ops)


def pdist(X, metric="euclidean", **kw):
  """Condensed pairwise distances: the strict upper triangle of the
  square form."""
  A = sp.lazify(X)
  n = A.shape[0]
  kern = _metric_kern(metric, kw)
  given = _extra(metric, kw)
  needs = metric in ("mahalanobis", "seuclidean")

  def run(a, *s):
    a = _f(a)
    extra = [_f(v).to(a.dtype) for v in s]
    if needs and not extra:
      extra = [_default_extra(metric, a, None)]
    iu = torch.triu_indices(n, n, 1, device=a.device)
    return kern(a, a, *extra)[iu[0], iu[1]]
  ops = [A] + ([] if given is None else [sp.lazify(given)])
  return _mapn_whole(run, *ops)


def _triangular(m: int) -> int:
  n = int(round((1 + math.sqrt(1 + 8 * m)) / 2))
  if n * (n - 1) // 2 != m:
    raise ValueError(f"condensed length {m} is not triangular")
  return n


def squareform(X, force="no", checks=True):
  """Condensed to square and back (static shapes both ways)."""
  A = sp.lazify(X)
  if len(A.shape) == 1:
    n = _triangular(A.shape[0])

    def to_square(v):
      out = torch.zeros((n, n), dtype=v.dtype, device=v.device)
      iu = torch.triu_indices(n, n, 1, device=v.device)
      out[iu[0], iu[1]] = v
      return out + out.T
    return _mapn_whole(to_square, A)
  n = A.shape[0]

  def to_condensed(a):
    iu = torch.triu_indices(n, n, 1, device=a.device)
    return a[iu[0], iu[1]]
  return _mapn_whole(to_condensed, A)


def directed_hausdorff(u, v, rng=None):
  """The directed Hausdorff distance: the maximum over u of the distance
  to v's nearest point; ``(d, 0, 0)`` (the witnesses need the host)."""
  def kern(a, b):
    a, b = _floats(a, b)
    return torch.sqrt(_pair_dot(a, b)).amin(1).amax()
  return (_mapn_whole(kern, u, v), 0, 0)


def _vec_metric(metric):
  def op(u, v, *extra, **kw):
    kern = _metric_kern(metric, kw)

    def run(a, b, *s):
      a, b = _floats(a, b)
      return kern(a[None, :], b[None, :], *[_f(x) for x in s])[0, 0]
    return _mapn_whole(run, u, v, *[e for e in extra if e is not None])
  op.__name__ = op.__qualname__ = metric
  op.__doc__ = f"The {metric} distance between two 1-D vectors (lazy)."
  return op


euclidean = _vec_metric("euclidean")
sqeuclidean = _vec_metric("sqeuclidean")
cosine = _vec_metric("cosine")
correlation = _vec_metric("correlation")
cityblock = _vec_metric("cityblock")
chebyshev = _vec_metric("chebyshev")
canberra = _vec_metric("canberra")
braycurtis = _vec_metric("braycurtis")
hamming = _vec_metric("hamming")
jaccard = _vec_metric("jaccard")
russellrao = _vec_metric("russellrao")
rogerstanimoto = _vec_metric("rogerstanimoto")
sokalsneath = _vec_metric("sokalsneath")
dice = _vec_metric("dice")
yule = _vec_metric("yule")
kulczynski1 = _vec_metric("kulczynski1")


def jensenshannon(p, q, base=None, *, axis=0, keepdims=False):
  """The Jensen-Shannon distance between two distributions (lazy)."""
  scale = 1.0 if base is None else float(np.log(base))

  def kern(a, b):
    a, b = _floats(a, b)
    return _js(a, b, axis, keepdims) / math.sqrt(scale)
  return _mapn_whole(kern, p, q)


def rel_entr(x, y, out=None):
  """Elementwise relative entropy (``sp.special.rel_entr``, which
  scipy.spatial.distance re-exports too)."""
  del out
  return _rel_entr(x, y)


def minkowski(u, v, p=2.0, w=None):
  """The Minkowski distance between two 1-D vectors."""
  if w is not None:
    def kern(a, b, ww):
      a, b = _floats(a, b)
      return (_f(ww) * torch.abs(a - b) ** p).sum() ** (1.0 / p)
    return _mapn_whole(kern, u, v, w)

  def kern2(a, b):
    a, b = _floats(a, b)
    return (torch.abs(a - b) ** p).sum() ** (1.0 / p)
  return _mapn_whole(kern2, u, v)


def seuclidean(u, v, V):
  """The standardized Euclidean distance between two 1-D vectors."""
  def kern(a, b, vv):
    a, b = _floats(a, b)
    return torch.sqrt(((a - b) ** 2 / _f(vv)).sum())
  return _mapn_whole(kern, u, v, V)


def mahalanobis(u, v, VI):
  """The Mahalanobis distance between two 1-D vectors."""
  def kern(a, b, vi):
    a, b = _floats(a, b)
    d = a - b
    return torch.sqrt(_dot(_dot(d, _f(vi).to(d.dtype)), d))
  return _mapn_whole(kern, u, v, VI)


def is_valid_dm(D, tol=0.0, throw=False, name="D", warning=False):
  """Square distance matrix validity (scipy on the host, counted)."""
  fio.counts["host_runs"] += 1
  return _ssd.is_valid_dm(np.asarray(_host_value(sp.lazify(D))), tol=tol,
                          throw=throw, name=name, warning=warning)


def is_valid_y(y, warning=False, throw=False, name=None):
  """Condensed distance vector validity (scipy on the host, counted)."""
  fio.counts["host_runs"] += 1
  return _ssd.is_valid_y(np.asarray(_host_value(sp.lazify(y))),
                         warning=warning, throw=throw, name=name)


def num_obs_dm(d):
  """Observations in a square distance matrix."""
  return sp.lazify(d).shape[0]


def num_obs_y(Y):
  """Observations implied by a condensed distance vector."""
  return _triangular(sp.lazify(Y).shape[0])
