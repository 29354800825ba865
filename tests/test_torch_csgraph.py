"""``sp.sparse.csgraph`` of the port against ``scipy.sparse.csgraph`` (the
oracle) and the reference's ``spartan_tpu.csgraph`` on the same graphs:
the counterparts of the reference's ``tests/test_csgraph.py``, one for
each of its 25 tests, plus the surface, the round counter and the host
boundaries' counts.

Tolerances: distances are sums of at most n float64 weights along one
path, so the relaxation (another order of the same additions) agrees with
scipy at ``np.allclose``'s defaults (rtol 1e-5, atol 1e-8) as the
reference test holds it, and with the reference exactly (both relax in
the same rounds, a minimum of the same sums); predecessors are checked
for validity (``dist[pred] + w == dist`` within 1e-9), as ties may
resolve differently; Laplacians at atol 1e-12 (one product and a square
root an entry).
"""

import numpy as np
import pytest
import scipy.sparse as ss
import scipy.sparse.csgraph as cs
import torch

import spartan_tpu as ref

import spartan_tpu_torch as sp
from spartan_tpu_torch import csgraph as C_mod

C = sp.sparse.csgraph
R = ref.sparse.csgraph


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


def rand_graph(n, density, seed, negative=False, symmetric=False):
  r = np.random.default_rng(seed)
  m = r.random((n, n)) < density
  np.fill_diagonal(m, False)
  w = r.uniform(0.1, 5.0, (n, n)) * m
  if negative:
    w -= 1.0 * m * (r.random((n, n)) < 0.2)
  if symmetric:
    w = np.triu(w)
    w = w + w.T
  return w


def test_surface_is_the_references():
  assert sorted(C.__all__) == sorted(R.__all__)
  assert len(C.__all__) == 23
  for name in C.__all__:
    assert callable(getattr(C, name)), name
  assert sp.sparse.csgraph is C_mod


@pytest.mark.parametrize("directed", [True, False])
def test_bellman_ford_all_pairs(directed):
  for seed in range(3):
    W = rand_graph(24, 0.12, seed)
    want = cs.shortest_path(ss.csr_matrix(W), method="BF",
                            directed=directed)
    got = C.bellman_ford(W, directed=directed)
    assert np.allclose(got, want, equal_nan=True)
    np.testing.assert_array_equal(got, R.bellman_ford(W, directed=directed))


@pytest.mark.parametrize("directed", [True, False])
def test_dijkstra_and_fw(directed):
  W = rand_graph(24, 0.12, 7)
  g = ss.csr_matrix(W)
  assert np.allclose(C.dijkstra(W, directed=directed),
                     cs.dijkstra(g, directed=directed))
  fw = C.floyd_warshall(W, directed=directed)
  assert np.allclose(fw, cs.floyd_warshall(g, directed=directed))
  np.testing.assert_array_equal(fw, R.floyd_warshall(W, directed=directed))


def test_unweighted_and_indices():
  W = rand_graph(30, 0.15, 9)
  g = ss.csr_matrix(W)
  assert np.allclose(C.dijkstra(W, unweighted=True),
                     cs.dijkstra(g, unweighted=True))
  d = C.dijkstra(W, indices=[3, 7])
  assert np.allclose(d, cs.dijkstra(g, indices=[3, 7]))
  d0 = C.dijkstra(W, indices=3)   # a scalar index squeezes
  assert d0.shape == (30,)
  assert np.allclose(d0, d[0])


def test_predecessor_validity():
  W = rand_graph(30, 0.15, 11)
  d, p = C.dijkstra(W, indices=[3, 7], return_predecessors=True)
  assert np.allclose(d, cs.dijkstra(ss.csr_matrix(W), indices=[3, 7]))
  assert p.dtype == np.int32
  for si, s in enumerate([3, 7]):
    assert p[si, s] == -9999
    for j in range(30):
      if p[si, j] >= 0:
        assert abs(d[si, p[si, j]] + W[p[si, j], j] - d[si, j]) < 1e-9
  _, rp = R.dijkstra(W, indices=[3, 7], return_predecessors=True)
  np.testing.assert_array_equal(p, rp)


@pytest.mark.parametrize("directed", [True, False])
def test_fw_predecessor_validity(directed):
  """The predecessors ride inside the pivot loop: a valid predecessor for
  every finite off-diagonal distance, even where pivot-order sums differ
  by an ulp from a fresh D[i, p] + w(p, j)."""
  for seed in range(12):
    n = 12
    W = np.round(rand_graph(n, 0.25, seed, symmetric=not directed), 1)
    W[W == 0.0] = 0.0
    d, p = C.floyd_warshall(W, directed=directed, return_predecessors=True)
    want = cs.floyd_warshall(ss.csr_matrix(W), directed=directed)
    assert np.allclose(d, want, equal_nan=True)
    assert p.dtype == np.int32
    Wd = W if directed else np.where(W != 0, W, W.T)
    for i in range(n):
      assert p[i, i] == -9999
      for j in range(n):
        if i == j:
          continue
        if np.isfinite(d[i, j]):
          q = p[i, j]
          assert q >= 0, (seed, i, j)
          assert Wd[q, j] != 0
          assert abs(d[i, q] + Wd[q, j] - d[i, j]) < 1e-9
        else:
          assert p[i, j] == -9999


def test_negative_cycle_raises():
  W = np.zeros((4, 4))
  W[0, 1] = 1
  W[1, 2] = -2
  W[2, 1] = -2
  W[2, 3] = 1
  with pytest.raises(C.NegativeCycleError):
    C.bellman_ford(W, directed=True)
  assert C_mod.stats["rounds"] == 5   # the n + 1 round limit
  with pytest.raises(C.NegativeCycleError):
    C.floyd_warshall(W, directed=True)


def test_negative_weights_no_cycle():
  W = np.zeros((5, 5))
  W[0, 1] = 2
  W[1, 2] = -1.5
  W[0, 2] = 1
  W[2, 3] = 2
  W[3, 4] = -0.5
  got = C.bellman_ford(W, directed=True, indices=0)
  want = cs.bellman_ford(ss.csr_matrix(W), directed=True, indices=0)
  assert np.allclose(got, want)
  assert np.allclose(C.johnson(W, directed=True, indices=0), want)


def test_dijkstra_rejects_negative():
  W = np.zeros((3, 3))
  W[0, 1] = -1
  with pytest.raises(ValueError):
    C.dijkstra(W)


def test_shortest_path_dispatch():
  W = rand_graph(20, 0.15, 3)
  g = ss.csr_matrix(W)
  want = cs.shortest_path(g)
  for method in ("auto", "FW", "BF", "D", "J"):
    assert np.allclose(C.shortest_path(W, method=method), want), method
  assert np.allclose(C.shortest_path(W, method="FW", indices=[2, 5]),
                     want[[2, 5]])
  with pytest.raises(ValueError, match="unknown method"):
    C.shortest_path(W, method="XX")


def _same_partition(lab, labw, nc):
  for c in range(nc):
    ours = lab == lab[np.flatnonzero(labw == c)[0]]
    assert np.array_equal(ours, labw == c)


def test_connected_components():
  for seed in range(4):
    W = rand_graph(40, 0.04, seed, symmetric=True)
    nc, lab = C.connected_components(W, directed=False)
    ncw, labw = cs.connected_components(ss.csr_matrix(W), directed=False)
    assert nc == ncw
    _same_partition(lab, labw, nc)
    np.testing.assert_array_equal(
        lab, R.connected_components(W, directed=False)[1])
  assert C.connected_components(W, directed=False,
                                return_labels=False) == ncw


def test_connected_components_weak_directed():
  W = rand_graph(30, 0.05, 5)
  nc, lab = C.connected_components(W, directed=True, connection="weak")
  ncw, labw = cs.connected_components(ss.csr_matrix(W), directed=True,
                                      connection="weak")
  assert nc == ncw
  _same_partition(lab, labw, nc)


def test_connected_components_rounds_follow_the_diameter():
  """A path of 10 vertices: label 0 walks 9 edges, one round each, and a
  last round sees no change."""
  W = np.diag(np.ones(9), 1)
  nc, lab = C.connected_components(W, directed=False)
  assert nc == 1 and (lab == 0).all()
  assert C_mod.stats["rounds"] == 10


def test_connected_components_strong_host():
  W = rand_graph(20, 0.1, 6)
  before = C_mod.host_runs.get("connected_components[strong]", 0)
  nc, lab = C.connected_components(W, directed=True, connection="strong")
  ncw, labw = cs.connected_components(ss.csr_matrix(W), directed=True,
                                      connection="strong")
  assert nc == ncw
  assert C_mod.host_runs["connected_components[strong]"] == before + 1


@pytest.mark.parametrize("normed", [False, True])
def test_laplacian(normed):
  W = rand_graph(16, 0.3, 2, symmetric=True)
  want = cs.laplacian(ss.csr_matrix(W), normed=normed).toarray()
  Ls = C.laplacian(sp.sparse.from_scipy(ss.csr_matrix(W)), normed=normed)
  assert isinstance(Ls, sp.SparseArray)
  assert np.allclose(np.asarray(Ls.todense()), want, atol=1e-12)
  Ld = np.asarray(sp.lazify(C.laplacian(W, normed=normed)).glom())
  assert np.allclose(Ld, want, atol=1e-12)


def test_laplacian_return_diag():
  W = rand_graph(12, 0.3, 8, symmetric=True)
  L, d = C.laplacian(ss.csr_matrix(W), return_diag=True)
  Lw, dw = cs.laplacian(ss.csr_matrix(W), return_diag=True)
  assert np.allclose(np.asarray(L.todense()), Lw.toarray(), atol=1e-12)
  assert np.allclose(d, dw)
  L32 = C.laplacian(ss.csr_matrix(W), dtype=np.float32)
  assert L32.dtype == torch.float32


def test_bfs_order_and_tree():
  W = rand_graph(25, 0.12, 5)
  order, pred = C.breadth_first_order(W, 0, directed=True)
  lev = cs.dijkstra(ss.csr_matrix(W), directed=True, indices=0,
                    unweighted=True)
  reach = np.flatnonzero(np.isfinite(lev))
  assert set(order.tolist()) == set(reach.tolist())
  assert (np.diff(lev[order]) >= 0).all()   # level-major: a BFS order
  assert order[0] == 0 and pred[0] == -9999
  T = C.breadth_first_tree(W, 0, directed=True)
  Tw = cs.breadth_first_tree(ss.csr_matrix(W), 0, directed=True)
  assert T.nnz == Tw.nnz   # trees may differ on ties; both BFS trees


def test_host_boundary_wrappers():
  W = rand_graph(25, 0.12, 5, symmetric=True)
  before = dict(C_mod.host_runs)
  M = C.minimum_spanning_tree(W)
  Mw = cs.minimum_spanning_tree(ss.csr_matrix(W))
  assert np.allclose(np.asarray(M.todense()), Mw.toarray())
  assert C.structural_rank(W) == cs.structural_rank(ss.csr_matrix(W))
  p = C.reverse_cuthill_mckee(ss.csr_matrix(W), symmetric_mode=True)
  pw = cs.reverse_cuthill_mckee(ss.csr_matrix(W), symmetric_mode=True)
  assert np.array_equal(p, pw)
  o, pr = C.depth_first_order(W, 0, directed=False)
  ow, prw = cs.depth_first_order(ss.csr_matrix(W), 0, directed=False)
  assert np.array_equal(o, ow) and np.array_equal(pr, prw)
  D = C.depth_first_tree(W, 0, directed=False)
  Dw = cs.depth_first_tree(ss.csr_matrix(W), 0, directed=False)
  assert np.allclose(np.asarray(D.todense()), Dw.toarray())
  for name in ("minimum_spanning_tree", "structural_rank",
               "reverse_cuthill_mckee", "depth_first_order",
               "depth_first_tree"):
    assert C_mod.host_runs[name] == before.get(name, 0) + 1, name
  m = C.maximum_bipartite_matching(ss.csr_matrix(W))
  np.testing.assert_array_equal(
      m, cs.maximum_bipartite_matching(ss.csr_matrix(W)))


def test_dense_sparse_conversions():
  W = rand_graph(10, 0.3, 1)
  S = C.csgraph_from_dense(W)
  assert isinstance(S, sp.SparseArray)
  assert np.allclose(C.csgraph_to_dense(S), W)
  back = C.csgraph_to_dense(S, null_value=-1.0)
  assert np.allclose(np.where(W == 0, -1.0, W), back)
  S2 = C.csgraph_from_dense(np.where(W == 0, 7.0, W), null_value=7.0)
  assert np.allclose(C.csgraph_to_dense(S2), W)


def test_accepts_all_input_kinds():
  W = rand_graph(12, 0.2, 4)
  want = cs.dijkstra(ss.csr_matrix(W), indices=0)
  for g in (W, ss.csr_matrix(W), sp.sparse.from_scipy(ss.csr_matrix(W)),
            sp.lazify(W)):
    assert np.allclose(C.dijkstra(g, indices=0), want)
  with pytest.raises(ValueError, match="square"):
    C.dijkstra(np.ones((3, 4)))


def test_empty_and_edgeless_graphs():
  Z = np.zeros((5, 5))
  d = C.bellman_ford(Z, indices=0)
  assert d[0] == 0 and np.isinf(d[1:]).all()
  nc, lab = C.connected_components(Z, directed=False)
  assert nc == 5 and np.array_equal(np.sort(np.unique(lab)), np.arange(5))


def test_from_dense_inf_nan_null():
  """inf and nan mean 'no edge' on dense ingest."""
  W = np.array([[0., np.inf, 2.], [np.nan, 0., 0.], [0., 0., 0.]])
  S = C.csgraph_from_dense(W)
  assert S.nnz == 1
  nc, _ = C.connected_components(W, directed=False)
  ncw, _ = cs.connected_components(cs.csgraph_from_dense(W),
                                   directed=False)
  assert nc == ncw == 2


def test_laplacian_self_loops_and_isolated():
  """scipy ignores the graph's diagonal; an isolated vertex reports d = 1
  under normed."""
  W = np.array([[2., 1, 0], [1, 0, 3], [0, 3, 0]])
  for normed in (False, True):
    Lw, dw = cs.laplacian(ss.csr_matrix(W), normed=normed,
                          return_diag=True)
    Ls, d_s = C.laplacian(sp.sparse.from_scipy(ss.csr_matrix(W)),
                          normed=normed, return_diag=True)
    assert np.allclose(np.asarray(Ls.todense()), Lw.toarray(),
                       atol=1e-12), normed
    assert np.allclose(d_s, dw), normed
    Ld, dd = C.laplacian(W, normed=normed, return_diag=True)
    assert np.allclose(np.asarray(sp.lazify(Ld).glom()), Lw.toarray(),
                       atol=1e-12), normed
    assert np.allclose(np.asarray(sp.lazify(dd).glom()), dw), normed
  Wi = np.zeros((4, 4))
  Wi[0, 1] = Wi[1, 0] = 2.0   # vertices 2 and 3 isolated
  for normed in (False, True):
    Lw, dw = cs.laplacian(ss.csr_matrix(Wi), normed=normed,
                          return_diag=True)
    Ls, d_s = C.laplacian(sp.sparse.from_scipy(ss.csr_matrix(Wi)),
                          normed=normed, return_diag=True)
    assert np.allclose(np.asarray(Ls.todense()), Lw.toarray())
    assert np.allclose(d_s, dw)


def test_reconstruct_path_matches_scipy():
  rng = np.random.default_rng(11)
  for directed in (True, False):
    D = rng.random((12, 12)) * (rng.random((12, 12)) < 0.4)
    np.fill_diagonal(D, 0)
    G = ss.csr_matrix(D)
    _, pred = cs.dijkstra(G, directed=directed, indices=0,
                          return_predecessors=True)
    want = cs.reconstruct_path(G, pred, directed=directed).toarray()
    got = C.reconstruct_path(sp.sparse.csr_matrix(G), pred,
                             directed=directed).todense()
    np.testing.assert_allclose(np.asarray(got), want)


def test_construct_dist_matrix_matches_scipy():
  rng = np.random.default_rng(12)
  for directed in (True, False):
    D = rng.random((10, 10)) * (rng.random((10, 10)) < 0.35)
    np.fill_diagonal(D, 0)
    G = ss.csr_matrix(D)
    _, pred = cs.shortest_path(G, directed=directed,
                               return_predecessors=True)
    want = cs.construct_dist_matrix(G, pred, directed=directed)
    got = C.construct_dist_matrix(sp.sparse.csr_matrix(G), pred,
                                  directed=directed)
    np.testing.assert_allclose(got, want)


def test_yen_and_flow_and_matching_host_wrappers():
  D = np.array([[0, 4, 2, 0], [0, 0, 5, 10], [0, 0, 0, 3], [0, 0, 0, 0]],
               dtype=float)
  G = sp.sparse.csr_matrix(D)
  np.testing.assert_allclose(C.yen(G, 0, 3, 2), cs.yen(ss.csr_matrix(D),
                                                       0, 3, 2))
  r = C.maximum_flow(sp.sparse.csr_matrix(D.astype(np.int32)), 0, 3)
  assert r.flow_value == cs.maximum_flow(
      ss.csr_matrix(D.astype(np.int32)), 0, 3).flow_value
  B = np.array([[2.0, 0, 1], [0, 3, 0], [4, 0, 6]])
  rr, cc = C.min_weight_full_bipartite_matching(sp.sparse.csr_matrix(B))
  wr, wc = cs.min_weight_full_bipartite_matching(ss.csr_matrix(B))
  assert B[rr, cc].sum() == B[wr, wc].sum()


def test_maximum_flow_rejects_fractional_capacities():
  """Float capacities raise (scipy contract) rather than truncate."""
  D = np.array([[0, 0.9], [0, 0]])
  with pytest.raises(ValueError):
    C.maximum_flow(sp.sparse.csr_matrix(D), 0, 1)
  D2 = np.array([[0, 3.0], [0, 0]])
  assert C.maximum_flow(sp.sparse.csr_matrix(D2), 0, 1).flow_value == 3
