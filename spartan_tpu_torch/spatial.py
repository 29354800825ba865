"""``sp.spatial`` — the scipy.spatial surface (port of
``spartan_tpu/spatial.py``).

``KDTree``/``cKDTree`` keep scipy's API over the brute-force distance tile
(queries × points): ``torch.matmul`` with the rank-one corrections for the
Euclidean distance without a box, the chunked broadcast of
``spatial.distance`` for every other p or a ``boxsize`` (the minimum
image).  The tile is taken in chunks of queries that fit
``spatial.distance.BUDGET`` bytes, decided from the shapes before the first
launch (``counts["tile_chunks"]``).

* ``query``: the k nearest of each query with scipy's order, the lower index
  first among equal distances (``_k_smallest``: ``torch.topk`` gives the
  k-th distance, the ties at it are taken in index order, and the k are
  ordered by a stable sort, so duplicate points and lattices give the same
  indices on every device); indices are int64, scipy's.  The k distances
  of the matmul form are taken again as ``|q - x|`` (``_exact_k``), so a
  coincident point is at 0.
* ``count_neighbors``: each chunk of the flattened tile sorted through
  ``expr.sort_expr`` and searched with ``searchsorted`` (weights: a
  cumulative sum of the sorted pair weights).
* the ragged queries (``query_ball_point`` lists, ``query_ball_tree``,
  ``query_pairs``, ``sparse_distance_matrix``): the mask on the device, its
  indices read on the host, counted in ``expr.fio.counts["host_runs"]``.

``distance_matrix``, ``minkowski_distance(_p)``, ``procrustes`` and
``geometric_slerp`` run on the device.  The Qhull family (``ConvexHull``,
``Delaunay``, ``Voronoi``, ``SphericalVoronoi``, ``HalfspaceIntersection``,
``tsearch``, ``QhullError``, ``Rectangle``) is scipy's own, re-exported.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.spatial import (  # noqa: F401  (re-exported whole)
    ConvexHull, Delaunay, HalfspaceIntersection, QhullError, Rectangle,
    SphericalVoronoi, Voronoi, tsearch)

import spartan_tpu_torch as sp
from spartan_tpu_torch import spatial_distance as distance  # noqa: F401
from spartan_tpu_torch import spatial_transform as transform  # noqa: F401
from spartan_tpu_torch.expr import fio
from spartan_tpu_torch.expr import sort_expr as _sort
from spartan_tpu_torch.spatial_distance import _chunked, _floats, _pair_dot
from spartan_tpu_torch.special import _f, _host_value, _mapn_whole

__all__ = [
    "KDTree", "cKDTree", "distance_matrix", "minkowski_distance",
    "minkowski_distance_p", "procrustes", "geometric_slerp",
    "ConvexHull", "Delaunay", "Voronoi", "HalfspaceIntersection",
    "SphericalVoronoi", "QhullError", "Rectangle", "tsearch",
    "distance", "transform",
]

_HOST_NAMES = [
    "ConvexHull", "Delaunay", "HalfspaceIntersection", "QhullError",
    "Rectangle", "SphericalVoronoi", "Voronoi", "tsearch",
]

counts = {"tile_chunks": 0}


def _pair_minkowski(a, b, p, box=None):
  """``(n, d), (m, d) -> (n, m)``: the matmul form for p = 2 without a
  box, else the broadcast reduction over chunks of a's rows."""
  a, b = _floats(a, b)
  if box is None and p == 2.0:
    return torch.sqrt(_pair_dot(a, b))
  bx = None if box is None else torch.as_tensor(box, dtype=a.dtype,
                                                device=a.device)

  def red(A, B):
    d = torch.abs(A - B)
    if bx is not None:
      d = torch.minimum(d, bx - d)
    if math.isinf(p):
      return d.amax(-1)
    if p == 1.0:
      return d.sum(-1)
    if p == 2.0:
      return torch.sqrt((d * d).sum(-1))
    return (d ** p).sum(-1) ** (1.0 / p)
  return _chunked(red)(a, b)


def tile_rows(q: int, n: int, itemsize: int) -> int:
  """Queries a chunk takes so that its ``(rows, n)`` tile fits
  ``spatial.distance.BUDGET`` bytes (at least one)."""
  return max(1, min(q, distance.BUDGET // max(1, n * itemsize)))


def _tiles(q, data, p, box):
  """``(start, tile)`` over chunks of the query rows ``q``."""
  rows = tile_rows(q.shape[0], data.shape[0], max(q.element_size(),
                                                  data.element_size()))
  for i in range(0, max(q.shape[0], 1), rows):
    counts["tile_chunks"] += 1
    yield i, _pair_minkowski(q[i:i + rows], data, p, box)


def _k_smallest(D, k):
  """The k smallest of each row of ``D`` by (distance, index): the k-th
  distance by ``topk``, the ties at it taken in index order, and the k
  ordered by a stable sort."""
  kth = torch.topk(D, k, dim=1, largest=False).values[:, -1:]
  below = D < kth
  tie = D == kth
  room = k - below.sum(1, keepdim=True)
  keep = below | (tie & (torch.cumsum(tie.to(torch.int32), 1) <= room))
  # exactly k kept a row: their columns in index order, row by row
  idx = torch.nonzero(keep)[:, 1].reshape(D.shape[0], k)
  dist = torch.gather(D, 1, idx)
  order = _sort.argsort(dist, 1)
  return torch.gather(dist, 1, order), torch.gather(idx, 1, order)


def _exact_k(q, data, idx):
  """The matmul form's k nearest with their distances taken again as
  ``|q - x|`` (exact for coincident points, where ``|a|² + |b|² - 2ab``
  keeps about 1e-8 of cancellation), reordered by a stable sort."""
  d = torch.linalg.vector_norm(q[:, None, :] - data[idx], dim=-1)
  order = _sort.argsort(d, 1)
  return torch.gather(d, 1, order), torch.gather(idx, 1, order)


class KDTree:
  """scipy.spatial.KDTree's API over brute-force distance tiles.

  ``leafsize``/``compact_nodes``/``balanced_tree`` are accepted and
  ignored (there is no tree).  ``boxsize`` (a torus) takes the minimum
  image in every distance."""

  def __init__(self, data, leafsize=10, compact_nodes=True,
               copy_data=False, balanced_tree=True, boxsize=None):
    self.data = sp.lazify(data)
    if len(self.data.shape) != 2:
      raise ValueError("data must be (n, m)")
    self.n, self.m = self.data.shape
    self.leafsize = leafsize
    self.boxsize = None
    if boxsize is not None:
      bs = np.broadcast_to(np.asarray(boxsize, float), (self.m,))
      if (bs <= 0).any():
        raise ValueError("boxsize must be positive")
      self.boxsize = bs.copy()
      box = self.boxsize
      self.data = _mapn_whole(
          lambda a: torch.remainder(_f(a), torch.as_tensor(
              box, dtype=_f(a).dtype, device=a.device)), self.data)
    self.maxes = _mapn_whole(lambda a: a.amax(0), self.data)
    self.mins = _mapn_whole(lambda a: a.amin(0), self.data)
    self.size = self.n

  def query(self, x, k=1, eps=0, p=2.0, distance_upper_bound=np.inf,
            workers=1):
    """The k nearest neighbours: ``(d, i)`` lazy, scipy's order (the lower
    index first among equal distances); a missing neighbour is ``d = inf``,
    ``i = n``."""
    xl = sp.lazify(x)
    if tuple(xl.shape[-1:]) != (self.m,):
      raise ValueError(f"query points must have {self.m} columns")
    batch_shape = tuple(xl.shape[:-1])
    ks = list(k) if np.ndim(k) else list(range(1, int(k) + 1))
    if not ks or min(ks) < 1 or max(ks) > self.n:
      raise ValueError(f"k={k} out of range for n={self.n}")
    kmax = max(ks)
    cols = [c - 1 for c in ks]
    n, bound, box = self.n, float(distance_upper_bound), self.boxsize
    squeeze = np.ndim(k) == 0 and int(k) == 1
    out_shape = batch_shape if squeeze else batch_shape + (len(cols),)

    def kern(q, data):
      q2, data = _floats(q, data)
      q2 = q2.reshape(-1, data.shape[1])
      rows = q2.shape[0]
      if q2.is_meta:
        return torch.empty((2, rows, len(cols)), dtype=torch.float64,
                           device=q2.device)
      dd = torch.empty((rows, kmax), dtype=q2.dtype, device=q2.device)
      ii = torch.empty((rows, kmax), dtype=torch.int64, device=q2.device)
      for i, D in _tiles(q2, data, p, box):
        d_k, i_k = _k_smallest(D, kmax)
        if box is None and p == 2.0:
          d_k, i_k = _exact_k(q2[i:i + D.shape[0]], data, i_k)
        dd[i:i + D.shape[0]], ii[i:i + D.shape[0]] = d_k, i_k
      miss = dd > bound
      dd = torch.where(miss, math.inf, dd)[:, cols]
      ii = torch.where(miss, n, ii)[:, cols]
      return torch.stack([dd.to(torch.float64), ii.to(torch.float64)])
    packed = _mapn_whole(kern, xl, self.data)
    dt = _floats(torch.empty((), dtype=xl.dtype),
                 torch.empty((), dtype=self.data.dtype))[0].dtype
    d = _mapn_whole(lambda P: P[0].to(dt).reshape(out_shape), packed)
    i = _mapn_whole(lambda P: P[1].to(torch.int64).reshape(out_shape),
                    packed)
    return d, i

  def count_neighbors(self, other, r, p=2.0, weights=None,
                      cumulative=True):
    """Pairs within each radius: each chunk of the flattened tile sorted
    (``sort_expr``) and searched (weighted: the cumulative sum of the
    sorted pair weights)."""
    rs = np.atleast_1d(np.asarray(r, float))
    scalar_r = np.ndim(r) == 0
    box = self.boxsize
    wa = wb = None
    if weights is not None:
      wa, wb = (weights if isinstance(weights, tuple)
                else (weights, weights))
    ops = [self.data, other.data]
    if wa is not None:
      ops += [sp.lazify(wa), sp.lazify(wb)]

    def kern(a, b, *w):
      a, b = _floats(a, b)
      radii = torch.as_tensor(rs, dtype=a.dtype, device=a.device)
      weighted = bool(w)
      total = torch.zeros(len(rs), dtype=torch.float64 if weighted
                          else torch.int64, device=a.device)
      if a.is_meta:
        out = total
      else:
        for i, D in _tiles(a, b, p, box):
          flat = D.reshape(-1)
          order = _sort.argsort(flat)
          pos = torch.searchsorted(flat[order], radii, right=True)
          if weighted:
            pw = (_f(w[0])[i:i + D.shape[0], None]
                  * _f(w[1])[None, :]).reshape(-1)[order]
            cw = torch.cat([torch.zeros(1, dtype=pw.dtype,
                                        device=pw.device),
                            torch.cumsum(pw, 0)])
            total = total + cw[pos].to(torch.float64)
          else:
            total = total + pos
        out = total
      if not cumulative:
        out = torch.diff(out, prepend=torch.zeros(1, dtype=out.dtype,
                                                  device=out.device))
      return out[0] if scalar_r else out
    return _mapn_whole(kern, *ops)

  def _mask_pairs(self, a_expr, b_expr, p, r, upper=False):
    """The ``(i, j)`` of tile entries within ``r`` (``i < j`` when
    ``upper``) and their distances, read on the host (counted)."""
    box = self.boxsize
    fio.counts["host_runs"] += 1

    def kern(a, b):
      a, b = _floats(a, b)
      parts = []
      if a.is_meta:
        return torch.empty((3, 0), dtype=torch.float64, device=a.device)
      for i, D in _tiles(a, b, p, box):
        ok = D <= r
        if upper:
          rows = torch.arange(i, i + D.shape[0], device=D.device)[:, None]
          ok = ok & (rows < torch.arange(D.shape[1], device=D.device))
        ij = torch.nonzero(ok)
        val = D[ij[:, 0], ij[:, 1]]
        if box is None and p == 2.0:  # exact, as in query
          val = torch.linalg.vector_norm(a[ij[:, 0] + i] - b[ij[:, 1]],
                                         dim=-1)
        parts.append(torch.stack([(ij[:, 0] + i).to(torch.float64),
                                  ij[:, 1].to(torch.float64),
                                  val.to(torch.float64)]))
      return torch.cat(parts, 1)
    out = kern(sp.lazify(a_expr).evaluate().data,
               sp.lazify(b_expr).evaluate().data).cpu().numpy()
    return out[0].astype(np.intp), out[1].astype(np.intp), out[2]

  def sparse_distance_matrix(self, other, max_distance, p=2.0,
                             output_type="dok_matrix"):
    """Distances within ``max_distance``: the tile on the device, the
    ragged extraction on the host (counted)."""
    i, j, v = self._mask_pairs(self.data, other.data, p, max_distance)
    if output_type == "dict":
      return {(int(a), int(c)): float(x) for a, c, x in zip(i, j, v)}
    if output_type == "ndarray":
      out = np.empty(len(i), dtype=[("i", np.intp), ("j", np.intp),
                                    ("v", np.float64)])
      out["i"], out["j"], out["v"] = i, j, v
      return out
    if output_type in ("dok_matrix", "coo_matrix"):
      return sp.sparse.coo_matrix((v, (i, j)), shape=(self.n, other.n))
    raise ValueError(f"unknown output_type {output_type!r}")

  def query_ball_point(self, x, r, p=2.0, eps=0, workers=1,
                       return_sorted=None, return_length=False):
    """The points within ``r`` of each query: lists (read on the host,
    counted), or with ``return_length`` their lazy counts."""
    xl = sp.lazify(x)
    single = len(xl.shape) == 1
    rr = np.asarray(r, float)
    box = self.boxsize

    def mask_of(q, data):
      q, data = _floats(q, data)
      q = q.reshape(-1, data.shape[1])
      rad = torch.as_tensor(rr, dtype=q.dtype, device=q.device)
      rad = rad if rad.ndim == 0 else rad.reshape(-1, 1)
      if q.is_meta:
        return torch.empty((q.shape[0], data.shape[0]), dtype=torch.bool,
                           device=q.device)
      return torch.cat([D <= (rad if rad.ndim == 0 else
                              rad[i:i + D.shape[0]])
                        for i, D in _tiles(q, data, p, box)], 0)
    if return_length:
      cnt = _mapn_whole(lambda q, d: mask_of(q, d).sum(-1), xl, self.data)
      if single:
        return _mapn_whole(lambda c: c[0], cnt)
      return _mapn_whole(lambda c: c.reshape(tuple(xl.shape[:-1])), cnt)
    fio.counts["host_runs"] += 1
    mv = np.asarray(_mapn_whole(mask_of, xl, self.data).glom())
    lists = [np.nonzero(row)[0].tolist() for row in mv]
    if single:
      return lists[0]
    out = np.empty(len(lists), dtype=object)
    out[:] = lists
    return out.reshape(tuple(xl.shape[:-1]))

  def query_ball_tree(self, other, r, p=2.0, eps=0):
    i, j, _ = self._mask_pairs(self.data, other.data, p, r)
    lists = [[] for _ in range(self.n)]
    for a, b in zip(i, j):
      lists[a].append(int(b))
    return lists

  def query_pairs(self, r, p=2.0, eps=0, output_type="set"):
    i, j, _ = self._mask_pairs(self.data, self.data, p, r, upper=True)
    if output_type == "ndarray":
      return np.stack([i, j], axis=1)
    return {(int(a), int(b)) for a, b in zip(i, j)}

  def __reduce__(self):
    return (KDTree, (np.asarray(self.data.glom()), self.leafsize))


class cKDTree(KDTree):
  """scipy's C tree and its Python tree are one class here."""


def distance_matrix(x, y, p=2.0, threshold=1000000):
  """All pairwise Minkowski distances (lazy; ``threshold``, scipy's host
  chunking, is replaced by the broadcast's byte budget)."""
  X, Y = sp.lazify(x), sp.lazify(y)
  if X.shape[-1] != Y.shape[-1]:
    raise ValueError(f"x ({X.shape}) and y ({Y.shape}) column counts "
                     "differ")
  return _mapn_whole(lambda a, b: _pair_minkowski(a, b, p), X, Y)


def minkowski_distance_p(x, y, p=2.0):
  """``sum |x - y|^p`` over the last axis (no root; ``max`` for p = inf)."""
  def kern(a, b):
    a, b = _floats(a, b)
    d = torch.abs(a - b)
    return d.amax(-1) if math.isinf(p) else (d ** p).sum(-1)
  return _mapn_whole(kern, x, y)


def minkowski_distance(x, y, p=2.0):
  """The L_p distance along the last axis (row by row)."""
  def kern(a, b):
    a, b = _floats(a, b)
    d = torch.abs(a - b)
    if math.isinf(p):
      return d.amax(-1)
    return (d ** p).sum(-1) ** (1.0 / p)
  return _mapn_whole(kern, x, y)


def _procrustes(a, b):
  a, b = _floats(a, b)

  def standardize(v):
    v = v - v.mean(0, keepdim=True)
    return v / torch.linalg.norm(v)
  m1, m2 = standardize(a), standardize(b)
  u, w, vt = torch.linalg.svd((m2.T @ m1).T)
  R = u @ vt
  m2r = (m2 @ R.T) * w.sum()
  return m1, m2r, ((m1 - m2r) ** 2).sum()


def procrustes(data1, data2):
  """Procrustes analysis (standardize, then the SVD of Kabsch):
  ``(mtx1, mtx2, disparity)``, lazy."""
  A, B = sp.lazify(data1), sp.lazify(data2)
  if A.shape != B.shape or len(A.shape) != 2:
    raise ValueError("procrustes operands must be equal-shape (n, m)")
  return tuple(_mapn_whole(lambda a, b, j=j: _procrustes(a, b)[j], A, B)
               for j in range(3))


def geometric_slerp(start, end, t, tol=1e-7):
  """Spherical linear interpolation between two unit vectors (the checks
  of scipy's contract read the two small vectors on the host)."""
  S, E = sp.lazify(start), sp.lazify(end)
  if S.shape != E.shape or len(S.shape) != 1:
    raise ValueError("start/end must be equal-length 1-D")
  sv = np.asarray(_host_value(S), float)
  ev = np.asarray(_host_value(E), float)
  for name, v in (("start", sv), ("end", ev)):
    if abs(np.linalg.norm(v) - 1.0) > np.sqrt(np.finfo(float).eps):
      raise ValueError(f"{name} must be a unit vector")
  if np.linalg.norm(sv + ev) < float(tol):
    raise ValueError("antipodal vectors: slerp path is undefined")
  T = sp.lazify(t)
  scalar_t = len(T.shape) == 0

  def kern(s, e, tt):
    s, e = _floats(s, e)
    tt = torch.atleast_1d(_f(tt)).to(s.dtype)
    cosw = torch.clamp((s * e).sum(), -1.0, 1.0)
    w = torch.arccos(cosw)
    sinw = torch.sin(w)
    safe = sinw > 1e-12
    denom = torch.where(safe, sinw, torch.ones_like(sinw))
    c0 = torch.where(safe, torch.sin((1.0 - tt) * w) / denom, 1.0 - tt)
    c1 = torch.where(safe, torch.sin(tt * w) / denom, tt)
    out = c0[:, None] * s[None, :] + c1[:, None] * e[None, :]
    return out[0] if scalar_t else out
  return _mapn_whole(kern, S, E, T)
