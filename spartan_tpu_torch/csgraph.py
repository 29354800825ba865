"""``sp.sparse.csgraph``: scipy.sparse.csgraph over device loops (port of
``spartan_tpu/csgraph.py``).

* **Shortest paths and components are min-plus relaxations** written as
  gathers over the padded ELL (no scatters): row ``j`` of ``Gᵀ`` lists
  the sources of ``j``'s incoming edges, so one
  ``take(dist, GT.cols, axis=1)`` and a masked ``min`` over the slot axis
  is a whole Bellman–Ford round.  The rounds run in one ``sp.while_loop``
  that stops when a round changes nothing, or after ``n + 1`` rounds.
* **Floyd–Warshall** runs dense: an ``sp.fori_loop`` over the pivots
  carrying ``(k, D)``, whose pivot row and column are ``take``\\ s by the
  device index ``k``.
* **Sequential or structure-building algorithms** (DFS, minimum spanning
  tree, RCM ordering, structural rank, matchings, Yen's paths, maximum
  flow, strong components) are host boundaries through scipy, as in the
  reference, each counted in :data:`host_runs` and logged once a process.

Edge convention: a stored 0 means no edge (scipy's dense
``null_value=0``): the ELL pads are (column 0, value 0), so an explicit
edge of weight 0 cannot be represented; inf and nan are dropped on dense
ingest.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

import spartan_tpu_torch as sp
from spartan_tpu_torch.backend.sparse import (SparseArray, from_coo,
                                              from_scipy, spmv)
from spartan_tpu_torch.util import log_info


__all__ = [
    "NegativeCycleError", "shortest_path", "floyd_warshall",
    "bellman_ford", "dijkstra", "johnson", "connected_components",
    "laplacian", "breadth_first_order", "breadth_first_tree",
    "depth_first_order", "depth_first_tree", "minimum_spanning_tree",
    "reverse_cuthill_mckee", "structural_rank",
    "maximum_bipartite_matching", "csgraph_from_dense",
    "csgraph_to_dense",
]

_INF = np.inf
_NULL = -9999  # scipy's predecessor sentinel

# the rounds of the last relaxation or label-propagation loop
stats = {"rounds": 0}
# calls of each host boundary, by name
host_runs: Dict[str, int] = {}


class NegativeCycleError(Exception):
  """Raised when a negative-weight cycle is reachable (scipy contract)."""


# ---------------------------------------------------------------------
# ingest
# ---------------------------------------------------------------------

def _as_sparse(csgraph) -> SparseArray:
  """Any accepted graph form as a padded-ELL SparseArray."""
  if isinstance(csgraph, SparseArray):
    return csgraph
  import scipy.sparse as ss
  if ss.issparse(csgraph):
    return from_scipy(csgraph.tocsr())
  dense = np.asarray(sp.lazify(csgraph).glom())
  if dense.ndim != 2 or dense.shape[0] != dense.shape[1]:
    raise ValueError(f"csgraph must be square 2-D, got {dense.shape}")
  # scipy's dense-ingest contract: 0, inf and nan all mean "no edge"
  dense = np.where(np.isfinite(dense), dense, 0.0)
  return from_scipy(ss.csr_matrix(dense))


def csgraph_from_dense(graph, null_value=0, nan_null=True,
                       infinity_null=True):
  """Dense → sparse graph (``null_value`` entries dropped; inf/nan
  dropped by default — scipy contract)."""
  dense = np.array(np.asarray(sp.lazify(graph).glom()), copy=True)
  if nan_null:
    dense = np.where(np.isnan(dense), 0.0, dense)
  if infinity_null:
    dense = np.where(np.isinf(dense), 0.0, dense)
  if null_value != 0:
    dense = np.where(dense == null_value, 0.0, dense)
  import scipy.sparse as ss
  return from_scipy(ss.csr_matrix(dense))


def csgraph_to_dense(csgraph, null_value=0):
  """Sparse → dense graph with ``null_value`` at non-edges."""
  d = np.asarray(_as_sparse(csgraph).todense())
  if null_value != 0:
    d = np.where(d == 0, null_value, d)
  return d


def _edge_exprs(G: SparseArray):
  """(cols, vals) leaves of one ELL orientation, on the device, vals as
  float64; None when the orientation stores nothing."""
  if G.cols.shape[1] == 0:
    return None
  return sp.Val(G.cols), sp.Val(G.vals.to(torch.float64))


# ---------------------------------------------------------------------
# the min-plus relaxation core (gathers, no scatters)
# ---------------------------------------------------------------------

def _relax(dist, edges, unweighted: bool):
  """One min-plus round: ``out[s, j] = min_slot dist[s, src[j, slot]] +
  w[j, slot]`` with pads and non-edges masked to +inf; ``dist`` is
  (k, n)."""
  cols, vals = edges
  gathered = sp.take(dist, cols, axis=1)            # (k, n, w)
  mask = sp.not_equal(vals, 0.0)                    # (n, w): 0 is no edge
  w = 1.0 if unweighted else vals
  cand = sp.where(mask, gathered + w, np.float64(_INF))
  return sp.min(cand, axis=2)                       # (k, n)


def _sssp(G: SparseArray, sources: np.ndarray, directed: bool,
          unweighted: bool, detect_negative: bool):
  """Shortest paths from several sources in one while_loop of relaxation
  rounds: ``(dist (k, n) float64 ndarray, hit the round limit)``."""
  n = G.shape[0]
  k = len(sources)
  device = G.cols.device
  dist0 = torch.full((k, n), _INF, dtype=torch.float64, device=device)
  dist0[torch.arange(k, device=device),
        torch.as_tensor(sources, device=device)] = 0.0
  inc = _edge_exprs(G.transpose())                  # incoming edges of j
  out = None if directed else _edge_exprs(G)        # the reverse ones
  if inc is None and out is None:
    stats["rounds"] = 0
    return dist0.cpu().numpy(), False
  limit = n + 1  # paths need <= n-1 rounds; a change at round n is a cycle

  def cond(dist, changed, it):
    return sp.logical_and(changed > 0, it < np.int32(limit))

  def body(dist, changed, it):
    rel = None
    if inc is not None:
      rel = _relax(dist, inc, unweighted)
    if out is not None:
      r2 = _relax(dist, out, unweighted)
      rel = r2 if rel is None else sp.minimum(rel, r2)
    new = sp.minimum(dist, rel)
    chg = sp.any(sp.less(new, dist)).astype(np.int32)
    return new, chg, it + 1

  dist, changed, it = sp.while_loop(
      cond, body,
      (sp.Val(dist0), sp.Val(np.int32(1)), sp.Val(np.int32(0))))
  rounds = int(it.data)
  stats["rounds"] = rounds
  hit_limit = bool(changed.data) and rounds >= limit
  if detect_negative and hit_limit:
    raise NegativeCycleError(
        "negative-weight cycle reachable from the given sources")
  return dist.data.cpu().numpy(), hit_limit


def _predecessors(G: SparseArray, dist: np.ndarray, sources: np.ndarray,
                  directed: bool, unweighted: bool) -> np.ndarray:
  """One pass after convergence: pred[s, j] = the source of the edge that
  achieves dist[s, j] (argmin over the gathered candidates)."""
  k, n = dist.shape
  orientations = [_edge_exprs(G.transpose())]
  if not directed:
    orientations.append(_edge_exprs(G))
  d = sp.Val(dist)
  best = sp.Val(np.full((k, n), _INF))
  src = sp.Val(np.full((k, n), _NULL, dtype=np.int32))
  for edges in orientations:
    if edges is None:
      continue
    cols, vals = edges
    gathered = sp.take(d, cols, axis=1)
    mask = sp.not_equal(vals, 0.0)
    w = 1.0 if unweighted else vals
    cand = sp.where(mask, gathered + w, np.float64(_INF))   # (k, n, w)
    slot = sp.argmin(cand, axis=2)                          # (k, n)
    val = sp.min(cand, axis=2)
    # the source vertex in the winning slot
    colsb = sp.broadcast_to(cols[None, :, :], tuple(cand.shape))
    this_src = sp.squeeze(
        sp.take_along_axis(colsb, slot[:, :, None], axis=2), axis=2)
    better = sp.less(val, best)
    best = sp.where(better, val, best)
    src = sp.where(better, this_src.astype(np.int32), src)
  bestn = np.asarray(best.glom())
  srcn = np.asarray(src.glom()).astype(np.int32)
  pred = np.where(np.isfinite(dist) & (bestn == dist), srcn, _NULL)
  pred = pred.astype(np.int32)
  pred[np.arange(k), sources] = _NULL  # sources have no predecessor
  return pred


def _indices_array(indices, n) -> np.ndarray:
  if indices is None:
    return np.arange(n)
  idx = np.atleast_1d(np.asarray(indices, dtype=np.int64))
  if idx.ndim != 1:
    raise ValueError("indices must be at most 1-D")
  idx = np.where(idx < 0, idx + n, idx)
  if (idx < 0).any() or (idx >= n).any():
    raise ValueError("indices out of range")
  return idx


def _maybe_squeeze(arr, indices):
  return arr[0] if np.isscalar(indices) or (
      indices is not None and np.ndim(indices) == 0) else arr


# ---------------------------------------------------------------------
# shortest paths
# ---------------------------------------------------------------------

def bellman_ford(csgraph, directed=True, indices=None,
                 return_predecessors=False, unweighted=False):
  """Bellman–Ford from the given sources (all vertices by default):
  negative weights allowed; raises :class:`NegativeCycleError` when a
  negative cycle is reachable.  One device while_loop."""
  G = _as_sparse(csgraph)
  srcs = _indices_array(indices, G.shape[0])
  dist, _ = _sssp(G, srcs, directed, unweighted, detect_negative=True)
  if not return_predecessors:
    return _maybe_squeeze(dist, indices)
  pred = _predecessors(G, dist, srcs, directed, unweighted)
  return _maybe_squeeze(dist, indices), _maybe_squeeze(pred, indices)


def dijkstra(csgraph, directed=True, indices=None,
             return_predecessors=False, unweighted=False, limit=_INF):
  """Shortest paths for non-negative weights.  A priority queue has no
  data-parallel form; for non-negative weights the relaxation loop
  converges to the same distances, so this takes it, as the reference
  does.  Raises ValueError on a negative weight (scipy contract)."""
  G = _as_sparse(csgraph)
  if not unweighted and G.nnz and float(G.vals.min()) < 0:
    raise ValueError("dijkstra requires non-negative weights — use "
                     "bellman_ford / johnson")
  srcs = _indices_array(indices, G.shape[0])
  dist, _ = _sssp(G, srcs, directed, unweighted, detect_negative=False)
  if limit != _INF:
    dist = np.where(dist > limit, _INF, dist)
  if not return_predecessors:
    return _maybe_squeeze(dist, indices)
  pred = _predecessors(G, dist, srcs, directed, unweighted)
  if limit != _INF:
    pred = np.where(np.isinf(dist), _NULL, pred).astype(np.int32)
  return _maybe_squeeze(dist, indices), _maybe_squeeze(pred, indices)


def johnson(csgraph, directed=True, indices=None,
            return_predecessors=False, unweighted=False):
  """All pairs with negative weights allowed.  scipy reweights and runs
  Dijkstra; the relaxation loop takes negative weights as they are, so
  this is :func:`bellman_ford` (the same results, one loop)."""
  return bellman_ford(csgraph, directed=directed, indices=indices,
                      return_predecessors=return_predecessors,
                      unweighted=unweighted)


def floyd_warshall(csgraph, directed=True, return_predecessors=False,
                   unweighted=False):
  """Dense all-pairs shortest paths: an ``sp.fori_loop`` over the pivots,
  each an (n, n) min-plus update by the pivot's row and column."""
  G = _as_sparse(csgraph)
  n = G.shape[0]
  dense = np.asarray(G.todense(), dtype=np.float64)
  if unweighted:
    dense = (dense != 0).astype(np.float64)
  D0 = np.where(dense != 0, dense, _INF)
  np.fill_diagonal(D0, 0.0)
  if not directed:
    D0 = np.minimum(D0, D0.T)

  if not return_predecessors:
    def body(k, D):
      row = sp.take(D, k, axis=0)
      col = sp.take(D, k, axis=1)
      return k + 1, sp.minimum(D, col[:, None] + row[None, :])

    _, Df = sp.fori_loop(n, body, (sp.Val(np.int32(0)), sp.Val(D0)))
    dist = np.asarray(Df.glom())
    if n and np.diag(dist).min() < 0:
      raise NegativeCycleError("negative-weight cycle in the graph")
    return dist

  # the predecessors ride inside the pivot loop (pred[i, j] <- pred[k, j]
  # wherever D[i, k] + D[k, j] < D[i, j]): matching them afterwards against
  # dist is fragile to one ulp, the pivot order sums differently
  P0 = np.full((n, n), _NULL, dtype=np.int32)
  edge = np.isfinite(D0) & ~np.eye(n, dtype=bool)
  P0[edge] = np.broadcast_to(np.arange(n)[:, None], (n, n))[edge]

  def body_p(k, D, P):
    row = sp.take(D, k, axis=0)
    col = sp.take(D, k, axis=1)
    cand = col[:, None] + row[None, :]
    better = sp.less(cand, D)
    predk = sp.take(P, k, axis=0)
    newP = sp.where(better, sp.broadcast_to(predk[None, :], (n, n)), P)
    return k + 1, sp.where(better, cand, D), newP

  _, Df, Pf = sp.fori_loop(
      n, body_p, (sp.Val(np.int32(0)), sp.Val(D0), sp.Val(P0)))
  dist = np.asarray(Df.glom())
  if n and np.diag(dist).min() < 0:
    raise NegativeCycleError("negative-weight cycle in the graph")
  return dist, np.asarray(Pf.glom()).astype(np.int32)


def shortest_path(csgraph, method="auto", directed=True,
                  return_predecessors=False, unweighted=False,
                  indices=None):
  """scipy's ``shortest_path`` front end.  ``method='auto'`` takes
  Floyd–Warshall for all pairs of a graph of up to 2048 vertices, the
  relaxation loop otherwise (and always for a subset of sources)."""
  G = _as_sparse(csgraph)
  n = G.shape[0]
  if method == "auto":
    method = "BF" if (indices is not None or n > 2048) else "FW"
  if method == "FW":
    out = floyd_warshall(G, directed=directed,
                         return_predecessors=return_predecessors,
                         unweighted=unweighted)
    if indices is None:
      return out
    idx = _indices_array(indices, n)
    if return_predecessors:
      return (_maybe_squeeze(out[0][idx], indices),
              _maybe_squeeze(out[1][idx], indices))
    return _maybe_squeeze(out[idx], indices)
  if method in ("BF", "J"):
    return bellman_ford(G, directed=directed, indices=indices,
                        return_predecessors=return_predecessors,
                        unweighted=unweighted)
  if method == "D":
    return dijkstra(G, directed=directed, indices=indices,
                    return_predecessors=return_predecessors,
                    unweighted=unweighted)
  raise ValueError(f"unknown method {method!r}")


# ---------------------------------------------------------------------
# components and the Laplacian
# ---------------------------------------------------------------------

def connected_components(csgraph, directed=True, connection="weak",
                         return_labels=True):
  """``(n_components, labels)`` by min-label propagation: labels start as
  the vertex ids and flow along the edges of both orientations (weak
  connectivity) in one while_loop, in O(diameter) rounds.
  ``connection='strong'`` (Tarjan's order) is a host boundary through
  scipy, as in the reference."""
  G = _as_sparse(csgraph)
  n = G.shape[0]
  if directed and connection == "strong":
    _host_notice("connected_components[strong]")
    import scipy.sparse.csgraph as cs
    return cs.connected_components(G.to_scipy(), directed=True,
                                   connection="strong",
                                   return_labels=return_labels)
  edges = [e for e in (_edge_exprs(G), _edge_exprs(G.transpose()))
           if e is not None]
  labels0 = torch.arange(n, dtype=torch.float64, device=G.cols.device)
  stats["rounds"] = 0
  if not edges:
    labels = labels0.cpu().numpy()
  else:
    limit = n + 1

    def cond(lab, changed, it):
      return sp.logical_and(changed > 0, it < np.int32(limit))

    def body(lab, changed, it):
      new = lab
      for cols, vals in edges:
        mask = sp.not_equal(vals, 0.0)
        nb = sp.take(lab, cols, axis=0)               # (n, w)
        nb = sp.where(mask, nb, np.float64(_INF))
        new = sp.minimum(new, sp.min(nb, axis=1))
      chg = sp.any(sp.less(new, lab)).astype(np.int32)
      return new, chg, it + 1

    lab, _, it = sp.while_loop(
        cond, body,
        (sp.Val(labels0), sp.Val(np.int32(1)), sp.Val(np.int32(0))))
    stats["rounds"] = int(it.data)
    labels = lab.data.cpu().numpy()
  uniq, inv = np.unique(labels, return_inverse=True)
  if not return_labels:
    return len(uniq)
  return len(uniq), inv.astype(np.int32)


def laplacian(csgraph, normed=False, return_diag=False,
              use_out_degree=False, copy=True, dtype=None,
              symmetrized=False):
  """Graph Laplacian ``L = D - A`` (or the symmetric-normalized form).

  A sparse input gives a sparse output built on the device: the degree
  vector is one SpMV, the off-diagonals a row and column scaling of the
  ELL values, and the diagonal joins by a sparse sum.  A dense input
  stays a lazy expr chain.  As scipy: the graph's diagonal (self-loops)
  is ignored, and the normed ``return_diag`` is sqrt(deg) with 1 for an
  isolated vertex."""
  del copy
  if not _is_dense(csgraph):
    G = _as_sparse(csgraph)
    A = (G + G.transpose()) if symmetrized else G
    n = A.shape[0]
    rows = torch.arange(n, dtype=A.cols.dtype, device=A.cols.device)[:, None]
    vals_off = torch.where(A.cols == rows, 0.0, A.vals.to(torch.float64))
    Aoff = SparseArray(A.cols, vals_off, A.shape, A.nnz)
    ones = torch.ones(n, dtype=torch.float64, device=A.cols.device)
    deg = spmv(Aoff if use_out_degree else Aoff.transpose(), ones).to(
        torch.float64)
    if not normed:
      L = sp.sparse.diags(deg.cpu().numpy()) + (-Aoff)
      d_out = deg.cpu().numpy()
    else:
      w = torch.where(deg > 0, torch.sqrt(torch.where(deg == 0, 1.0, deg)),
                      1.0)
      winv = 1.0 / w
      offdiag = SparseArray(Aoff.cols,
                            -Aoff.vals * winv[:, None] * winv[Aoff.cols.long()],
                            A.shape, A.nnz)
      L = sp.sparse.diags((deg > 0).to(torch.float64).cpu().numpy()) + offdiag
      d_out = w.cpu().numpy()
    if dtype is not None:
      L = L.astype(dtype)
    return (L, d_out) if return_diag else L
  A = sp.lazify(csgraph)
  if symmetrized:
    A = A + sp.transpose(A)
  n = A.shape[0]
  Aoff = A * (1.0 - sp.Val(np.eye(n)))
  deg = sp.sum(Aoff, axis=1 if use_out_degree else 0)
  if not normed:
    L = sp.diag(deg) - Aoff
    d_out = deg
  else:
    isol = sp.equal(deg, 0)
    w = sp.where(isol, 1.0, sp.sqrt(sp.where(isol, 1.0, deg)))
    winv = 1.0 / w
    conn_eye = sp.diag(sp.where(isol, 0.0, 1.0))
    L = conn_eye - winv[:, None] * Aoff * winv[None, :]
    d_out = w
  if dtype is not None:
    L = L.astype(dtype)
  return (L, d_out) if return_diag else L


def _is_dense(x) -> bool:
  import scipy.sparse as ss
  return not (isinstance(x, SparseArray) or ss.issparse(x))


# ---------------------------------------------------------------------
# breadth-first search
# ---------------------------------------------------------------------

def breadth_first_order(csgraph, i_start, directed=True,
                        return_predecessors=True):
  """BFS order from ``i_start``: the unweighted relaxation gives the
  levels, and the order is level-major with ties in index order (a valid
  BFS order; scipy's queue may order a level otherwise)."""
  G = _as_sparse(csgraph)
  n = G.shape[0]
  src = _indices_array(np.ravel(i_start)[:1], n)
  dist, _ = _sssp(G, src, directed, unweighted=True, detect_negative=False)
  levels = dist[0]
  reach = np.flatnonzero(np.isfinite(levels))
  order = reach[np.argsort(levels[reach], kind="stable")].astype(np.int32)
  if not return_predecessors:
    return order
  pred = _predecessors(G, dist, src, directed, unweighted=True)[0]
  return order, pred


def breadth_first_tree(csgraph, i_start, directed=True):
  """The BFS tree as a sparse matrix with the graph's edge weights."""
  G = _as_sparse(csgraph)
  order, pred = breadth_first_order(G, i_start, directed=directed)
  gsp = G.to_scipy().tocsr()
  rows, cols, vals = [], [], []
  for j in order:
    p = pred[j]
    if p == _NULL:
      continue
    w = gsp[p, j]
    if w == 0 and not directed:
      w = gsp[j, p]
    rows.append(p)
    cols.append(j)
    vals.append(w)
  import scipy.sparse as ss
  return from_scipy(ss.csr_matrix(
      (np.asarray(vals, dtype=np.float64),
       (np.asarray(rows, dtype=np.int64), np.asarray(cols, np.int64))),
      shape=G.shape))


# ---------------------------------------------------------------------
# host boundaries (sequential algorithms, structure outputs)
# ---------------------------------------------------------------------

def _host_notice(name):
  host_runs[name] = host_runs.get(name, 0) + 1
  if host_runs[name] == 1:
    log_info(
        "sp.sparse.csgraph.%s: a sequential (queue or stack order) "
        "algorithm — runs on the host through scipy.sparse.csgraph", name)


def _host_cs(name, G, *args, **kw):
  _host_notice(name)
  import scipy.sparse.csgraph as cs
  return getattr(cs, name)(_as_sparse(G).to_scipy(), *args, **kw)


def depth_first_order(csgraph, i_start, directed=True,
                      return_predecessors=True):
  return _host_cs("depth_first_order", csgraph, int(i_start),
                  directed=directed,
                  return_predecessors=return_predecessors)


def depth_first_tree(csgraph, i_start, directed=True):
  t = _host_cs("depth_first_tree", csgraph, int(i_start),
               directed=directed)
  return from_scipy(t.tocsr())


def minimum_spanning_tree(csgraph, overwrite=False):
  t = _host_cs("minimum_spanning_tree", csgraph, overwrite=overwrite)
  return from_scipy(t.tocsr())


def reverse_cuthill_mckee(csgraph, symmetric_mode=False):
  return _host_cs("reverse_cuthill_mckee", csgraph,
                  symmetric_mode=symmetric_mode)


def structural_rank(csgraph):
  return int(_host_cs("structural_rank", csgraph))


def maximum_bipartite_matching(csgraph, perm_type="row"):
  return _host_cs("maximum_bipartite_matching", csgraph,
                  perm_type=perm_type)


def yen(csgraph, source, sink, K, *, directed=True,
        return_predecessors=False, unweighted=False):
  """Yen's K shortest loopless paths (each spur re-runs a Dijkstra on a
  changed graph): host boundary."""
  return _host_cs("yen", csgraph, int(source), int(sink), int(K),
                  directed=directed,
                  return_predecessors=return_predecessors,
                  unweighted=unweighted)


def maximum_flow(csgraph, source, sink, *, method="dinic"):
  """Maximum flow (Dinic / Edmonds–Karp; augmenting paths are
  sequential): host boundary.  Returns scipy's ``MaximumFlowResult``
  (``.flow`` is a scipy CSR)."""
  _host_notice("maximum_flow")
  import scipy.sparse.csgraph as cs
  G = _as_sparse(csgraph).to_scipy().tocsr()
  if G.dtype != np.int32:
    # scipy takes integer capacities only: a cast would truncate 0.9 to 0
    # or wrap a large int64, so raise unless the values survive it
    cast = G.astype(np.int32)
    if G.nnz and not np.array_equal(np.asarray(cast.data, np.float64),
                                    np.asarray(G.data, np.float64)):
      raise ValueError("graph capacities must be integers (int32 "
                       "representable); got dtype "
                       f"{G.dtype} with non-representable values")
    G = cast
  return cs.maximum_flow(G, int(source), int(sink), method=method)


def min_weight_full_bipartite_matching(biadjacency, maximize=False):
  """Minimum-weight full bipartite matching (LAPJVsp, sequential
  augmenting shortest paths): host boundary."""
  return _host_cs("min_weight_full_bipartite_matching", biadjacency,
                  maximize=maximize)


def _sym_weight(G, GT, p, j):
  """Edge weight w(p→j); for an undirected graph the lighter of the two
  stored directions (0 = absent)."""
  w = np.asarray(G[p, j]).ravel()
  if GT is None:
    return w
  w2 = np.asarray(GT[p, j]).ravel()
  return np.where((w != 0) & (w2 != 0), np.minimum(w, w2), w + w2)


def reconstruct_path(csgraph, predecessors, directed=True):
  """The tree of a predecessor vector: edges ``(pred[j], j)`` with the
  graph's weights, built at once (no path walking); a device
  :class:`SparseArray` (scipy returns CSR)."""
  G = _as_sparse(csgraph).to_scipy().tocsr()
  n = G.shape[0]
  pred = np.asarray(predecessors).ravel()
  if pred.shape != (n,):
    raise ValueError(f"predecessors must have shape ({n},)")
  j = np.flatnonzero(pred >= 0)
  p = pred[j]
  w = _sym_weight(G, None if directed else G.T.tocsr(), p, j)
  # an unweighted tree (BFS) stores weight 1 an edge
  w = np.where(w == 0, 1.0, w)
  return from_coo(p, j, w, (n, n))


def construct_dist_matrix(graph, predecessors, directed=True,
                          null_value=np.inf):
  """Distances implied by a full (N, N) predecessor matrix (row i rooted
  at i), by the level-synchronous recurrence
  ``D[i, j] = D[i, pred[i, j]] + w`` iterated to its fixed point (path
  depth rounds, each over all N² entries at once) instead of scipy's walk
  of each path."""
  G = _as_sparse(graph).to_scipy().tocsr()
  n = G.shape[0]
  pred = np.asarray(predecessors)
  if pred.shape != (n, n):
    raise ValueError(f"predecessors must have shape ({n}, {n})")
  valid = pred >= 0
  rows_p = np.where(valid, pred, 0)
  cols_j = np.broadcast_to(np.arange(n), (n, n))
  w = _sym_weight(G, None if directed else G.T.tocsr(),
                  rows_p.ravel(), cols_j.ravel()).reshape(n, n)
  d = np.full((n, n), np.inf)
  np.fill_diagonal(d, 0.0)
  for _ in range(n):
    dp = np.take_along_axis(d, rows_p, axis=1)
    nd = np.where(valid, dp + w, d)
    np.fill_diagonal(nd, 0.0)
    if np.array_equal(nd, d):
      break
    d = nd
  if not np.isinf(null_value):
    d = np.where(np.isinf(d), null_value, d)
  return d


__all__ += ["yen", "maximum_flow", "min_weight_full_bipartite_matching",
            "reconstruct_path", "construct_dist_matrix"]
