"""``sp.spatial``, ``sp.spatial.distance`` and ``sp.spatial.transform`` of
the port (``spartan_tpu_torch/spatial*.py``) against scipy.spatial and the
reference's (``spartan_tpu/spatial*.py``) on its 8-device mesh, float64 on
seeded inputs: each case held to scipy and to the reference at rtol 1e-10
(atol 1e-12; the inner-product metrics' ``|a|² + |b|² - 2ab`` loses
digits to cancellation near zero, so their scipy bound is atol 1e-12 on
distances of order one).  Where the reference differs from scipy
(``REFERENCE_DEFECTS``) the port is held to scipy alone.  Then ties in
``KDTree.query`` (duplicates and a lattice) against the reference's indices,
the chunked routes forced by small budgets against the unchunked ones, a
dispatch-mode audit of the largest tensor a chunked call builds, the counted
host boundaries, ``Rotation.random``'s draws by their moments, ``Slerp``'s
quaternions held to the reference and its matrices to scipy, and the
namespaces.  About 45 s serial on one core.
"""

import numpy as np
import pytest
import scipy.spatial as ssp
import scipy.spatial.distance as ssd
import torch
from scipy.spatial.transform import Rotation as SR
from scipy.spatial.transform import Slerp as SSlerp

import spartan_tpu as ref

import spartan_tpu_torch as sp
from spartan_tpu_torch import spatial as spatial_mod
from spartan_tpu_torch import spatial_distance as dist_mod
from spartan_tpu_torch import spatial_transform as tr_mod
from spartan_tpu_torch.expr import fio
from spartan_tpu_torch.expr.base import Expr

rng = np.random.default_rng(24)
XA = rng.normal(size=(10, 4))
XB = rng.normal(size=(7, 4))
XC = rng.normal(size=(12, 4))
PA = rng.random((10, 4))
PB = rng.random((7, 4))
BA = rng.random((10, 6)) > 0.5
BB = rng.random((7, 6)) > 0.5
V4 = rng.random(4) + 0.5
VI = np.linalg.inv(np.cov(rng.normal(size=(30, 4)).T))
W4 = rng.random(4)
pts = rng.random((200, 3))
qry = rng.random((15, 3))
pts2 = rng.random((40, 3))
box_pts = rng.random((60, 2)) * 5
Q20 = rng.normal(size=(20, 4))
V3 = rng.normal(size=(20, 3))
ANG = rng.uniform(-1.5, 1.5, (6, 3))
KEYS = rng.normal(size=(4, 4))
E1 = np.array([1.0, 0.0, 0.0])
E2 = np.array([0.0, 0.6, 0.8])
TS = np.linspace(0.0, 1.0, 7)

INNER = ("euclidean", "sqeuclidean", "cosine", "correlation")
BCAST = ("cityblock", "chebyshev", "minkowski", "canberra", "braycurtis")
BOOL = ("hamming", "jaccard", "russellrao", "rogerstanimoto",
        "sokalsneath", "dice", "yule")


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


def g(e):
  """A result as one array: exprs evaluated, tuples, lists and sets
  flattened in order."""
  if hasattr(e, "glom"):
    e = np.asarray(e.glom())
  if isinstance(e, set):
    e = sorted(e)
  if isinstance(e, dict):
    e = [v for _, v in sorted(e.items())]
  if isinstance(e, (tuple, list)):
    parts = [np.ravel(g(v)).astype(float) for v in e]
    return np.concatenate(parts) if parts else np.zeros(0)
  e = np.asarray(e)
  return e.astype(np.int64) if e.dtype == bool else e


def _kulczynski1(u, v):
  """scipy's formula (removed from scipy 1.15): ctt / (ctf + cft)."""
  u, v = u != 0, v != 0
  return (u & v).sum() / ((u & ~v).sum() + (~u & v).sum())


# where the reference differs from scipy the port is held to scipy alone:
#  - seuclidean without V and mahalanobis without VI raise in the
#    reference; scipy takes the variance (ddof 1) of the stacked rows and
#    the inverse of their covariance
#  - hamming of bool input comes out float32 in the reference (6.8e-8 off)
REFERENCE_DEFECTS = {
    "cdist_seuclidean_default": ValueError,
    "cdist_mahalanobis_default": ValueError,
    "pdist_seuclidean_default": ValueError,
    "pdist_mahalanobis_default": ValueError,
    "pdist_bool_hamming": "differs",
    "cdist_bool_hamming": "differs",
    "vector_bool_hamming": "differs",
}


def _c(label, call, want, rtol=1e-10, atol=1e-12):
  return pytest.param(call, want, rtol, atol, REFERENCE_DEFECTS.get(label),
                      id=label)


CASES = []
for _m in INNER + BCAST:
  CASES += [
      _c(f"cdist_{_m}", lambda P, m=_m: P.spatial.distance.cdist(XA, XB, m),
         lambda m=_m: ssd.cdist(XA, XB, m)),
      _c(f"pdist_{_m}", lambda P, m=_m: P.spatial.distance.pdist(XA, m),
         lambda m=_m: ssd.pdist(XA, m))]
  if _m != "minkowski":
    CASES.append(_c(f"vector_{_m}",
                    lambda P, m=_m: getattr(P.spatial.distance, m)(XA[0],
                                                                  XA[1]),
                    lambda m=_m: getattr(ssd, m)(XA[0], XA[1])))
for _m in BOOL:
  CASES += [
      _c(f"cdist_bool_{_m}",
         lambda P, m=_m: P.spatial.distance.cdist(BA, BB, m),
         lambda m=_m: ssd.cdist(BA, BB, m)),
      _c(f"pdist_bool_{_m}", lambda P, m=_m: P.spatial.distance.pdist(BA, m),
         lambda m=_m: ssd.pdist(BA, m)),
      _c(f"vector_bool_{_m}",
         lambda P, m=_m: getattr(P.spatial.distance, m)(BA[0], BA[1]),
         lambda m=_m: getattr(ssd, m)(BA[0], BA[1]))]
CASES += [
    _c("cdist_bool_kulczynski1",
       lambda P: P.spatial.distance.cdist(BA, BB, "kulczynski1"),
       lambda: np.array([[_kulczynski1(u, v) for v in BB] for u in BA])),
    _c("vector_bool_kulczynski1",
       lambda P: P.spatial.distance.kulczynski1(BA[0], BA[1]),
       lambda: _kulczynski1(BA[0], BA[1])),
    _c("cdist_minkowski_p3",
       lambda P: P.spatial.distance.cdist(XA, XB, "minkowski", p=3.0),
       lambda: ssd.cdist(XA, XB, "minkowski", p=3.0)),
    _c("cdist_jensenshannon",
       lambda P: P.spatial.distance.cdist(PA, PB, "jensenshannon"),
       lambda: ssd.cdist(PA, PB, "jensenshannon")),
    _c("cdist_seuclidean", lambda P: P.spatial.distance.cdist(
        XA, XB, "seuclidean", V=V4),
       lambda: ssd.cdist(XA, XB, "seuclidean", V=V4)),
    _c("cdist_mahalanobis", lambda P: P.spatial.distance.cdist(
        XA, XB, "mahalanobis", VI=VI),
       lambda: ssd.cdist(XA, XB, "mahalanobis", VI=VI)),
    _c("cdist_seuclidean_default",
       lambda P: P.spatial.distance.cdist(XA, XB, "seuclidean"),
       lambda: ssd.cdist(XA, XB, "seuclidean")),
    _c("cdist_mahalanobis_default",
       lambda P: P.spatial.distance.cdist(XA, XC, "mahalanobis"),
       lambda: ssd.cdist(XA, XC, "mahalanobis")),
    _c("pdist_seuclidean_default",
       lambda P: P.spatial.distance.pdist(XA, "seuclidean"),
       lambda: ssd.pdist(XA, "seuclidean")),
    _c("pdist_mahalanobis_default",
       lambda P: P.spatial.distance.pdist(XC, "mahalanobis"),
       lambda: ssd.pdist(XC, "mahalanobis")),
    _c("squareform_to_square",
       lambda P: P.spatial.distance.squareform(ssd.pdist(XA)),
       lambda: ssd.squareform(ssd.pdist(XA))),
    _c("squareform_to_condensed",
       lambda P: P.spatial.distance.squareform(ssd.cdist(XA, XA)),
       lambda: ssd.squareform(ssd.cdist(XA, XA), checks=False)),
    _c("directed_hausdorff",
       lambda P: P.spatial.distance.directed_hausdorff(XA, XB)[0],
       lambda: ssd.directed_hausdorff(XA, XB)[0]),
    _c("minkowski", lambda P: P.spatial.distance.minkowski(XA[0], XA[1], 3),
       lambda: ssd.minkowski(XA[0], XA[1], 3)),
    _c("minkowski_weighted",
       lambda P: P.spatial.distance.minkowski(XA[0], XA[1], 3, W4),
       lambda: ssd.minkowski(XA[0], XA[1], 3, W4)),
    _c("seuclidean", lambda P: P.spatial.distance.seuclidean(XA[0], XA[1], V4),
       lambda: ssd.seuclidean(XA[0], XA[1], V4)),
    _c("mahalanobis",
       lambda P: P.spatial.distance.mahalanobis(XA[0], XA[1], VI),
       lambda: ssd.mahalanobis(XA[0], XA[1], VI)),
    _c("jensenshannon", lambda P: P.spatial.distance.jensenshannon(PA[0],
                                                                   PA[1]),
       lambda: ssd.jensenshannon(PA[0], PA[1])),
    _c("jensenshannon_base2_axis1",
       lambda P: P.spatial.distance.jensenshannon(PA[:3], PA[3:6], base=2,
                                                  axis=1),
       lambda: ssd.jensenshannon(PA[:3], PA[3:6], base=2, axis=1)),
    _c("rel_entr", lambda P: P.spatial.distance.rel_entr(PA, PA[::-1]),
       lambda: ssd.rel_entr(PA, PA[::-1])),
    _c("num_obs_dm", lambda P: P.spatial.distance.num_obs_dm(
        ssd.cdist(XA, XA)), lambda: ssd.num_obs_dm(ssd.cdist(XA, XA))),
    _c("num_obs_y", lambda P: P.spatial.distance.num_obs_y(ssd.pdist(XA)),
       lambda: ssd.num_obs_y(ssd.pdist(XA))),
    _c("is_valid_dm", lambda P: P.spatial.distance.is_valid_dm(
        ssd.squareform(ssd.pdist(XA))),
       lambda: ssd.is_valid_dm(ssd.squareform(ssd.pdist(XA)))),
    _c("is_valid_y", lambda P: P.spatial.distance.is_valid_y(ssd.pdist(XA)),
       lambda: ssd.is_valid_y(ssd.pdist(XA))),
    # sp.spatial
    _c("KDTree_query_k3", lambda P: P.spatial.KDTree(pts).query(qry, k=3),
       lambda: ssp.cKDTree(pts).query(qry, k=3)),
    _c("KDTree_query_k1", lambda P: P.spatial.KDTree(pts).query(qry),
       lambda: ssp.cKDTree(pts).query(qry)),
    _c("KDTree_query_p1", lambda P: P.spatial.KDTree(pts).query(qry, k=4,
                                                                p=1),
       lambda: ssp.cKDTree(pts).query(qry, k=4, p=1)),
    _c("KDTree_query_pinf", lambda P: P.spatial.KDTree(pts).query(
        qry, k=2, p=np.inf), lambda: ssp.cKDTree(pts).query(qry, k=2,
                                                            p=np.inf)),
    _c("KDTree_query_kset", lambda P: P.spatial.KDTree(pts).query(
        qry, k=[1, 3]), lambda: ssp.cKDTree(pts).query(qry, k=[1, 3])),
    _c("KDTree_query_bound", lambda P: P.spatial.KDTree(pts).query(
        qry, k=5, distance_upper_bound=0.08),
       lambda: ssp.cKDTree(pts).query(qry, k=5, distance_upper_bound=0.08)),
    _c("KDTree_query_one_point", lambda P: P.spatial.KDTree(pts).query(
        qry[0], k=2), lambda: ssp.cKDTree(pts).query(qry[0], k=2)),
    _c("KDTree_query_box", lambda P: P.spatial.KDTree(
        box_pts, boxsize=5.0).query(box_pts[:9] + 0.01, k=3),
       lambda: ssp.cKDTree(box_pts, boxsize=5.0).query(box_pts[:9] + 0.01,
                                                       k=3)),
    _c("cKDTree_query", lambda P: P.spatial.cKDTree(pts).query(qry, k=2),
       lambda: ssp.cKDTree(pts).query(qry, k=2)),
    _c("KDTree_count_neighbors",
       lambda P: P.spatial.KDTree(pts).count_neighbors(
           P.spatial.KDTree(pts2), [0.1, 0.2, 0.4]),
       lambda: ssp.cKDTree(pts).count_neighbors(ssp.cKDTree(pts2),
                                                [0.1, 0.2, 0.4])),
    _c("KDTree_count_neighbors_scalar",
       lambda P: P.spatial.KDTree(pts).count_neighbors(
           P.spatial.KDTree(pts2), 0.3, cumulative=False),
       lambda: ssp.cKDTree(pts).count_neighbors(ssp.cKDTree(pts2), 0.3,
                                                cumulative=False)),
    _c("KDTree_count_neighbors_weighted",
       lambda P: P.spatial.KDTree(pts).count_neighbors(
           P.spatial.KDTree(pts2), [0.1, 0.3],
           weights=(np.linspace(0, 1, 200), np.linspace(1, 2, 40))),
       lambda: ssp.cKDTree(pts).count_neighbors(
           ssp.cKDTree(pts2), [0.1, 0.3],
           weights=(np.linspace(0, 1, 200), np.linspace(1, 2, 40)))),
    _c("KDTree_query_ball_point",
       lambda P: P.spatial.KDTree(pts).query_ball_point(qry[0], 0.2),
       lambda: sorted(ssp.cKDTree(pts).query_ball_point(qry[0], 0.2))),
    _c("KDTree_query_ball_point_lengths",
       lambda P: P.spatial.KDTree(pts).query_ball_point(
           qry, 0.2, return_length=True),
       lambda: ssp.cKDTree(pts).query_ball_point(qry, 0.2,
                                                 return_length=True)),
    _c("KDTree_query_ball_tree",
       lambda P: P.spatial.KDTree(pts2).query_ball_tree(
           P.spatial.KDTree(pts2[::-1]), 0.3),
       lambda: [sorted(v) for v in ssp.cKDTree(pts2).query_ball_tree(
           ssp.cKDTree(pts2[::-1]), 0.3)]),
    _c("KDTree_query_pairs", lambda P: P.spatial.KDTree(pts).query_pairs(0.05),
       lambda: ssp.cKDTree(pts).query_pairs(0.05)),
    _c("KDTree_sparse_distance_matrix",
       lambda P: P.spatial.KDTree(pts2).sparse_distance_matrix(
           P.spatial.KDTree(pts2[:20]), 0.3, output_type="dict"),
       lambda: ssp.cKDTree(pts2).sparse_distance_matrix(
           ssp.cKDTree(pts2[:20]), 0.3, output_type="dict")),
    _c("distance_matrix", lambda P: P.spatial.distance_matrix(XA, XB),
       lambda: ssp.distance_matrix(XA, XB)),
    _c("distance_matrix_p1", lambda P: P.spatial.distance_matrix(XA, XB, 1),
       lambda: ssp.distance_matrix(XA, XB, 1)),
    _c("minkowski_distance",
       lambda P: P.spatial.minkowski_distance(XA[:7], XB, 3),
       lambda: ssp.minkowski_distance(XA[:7], XB, 3)),
    _c("minkowski_distance_p",
       lambda P: P.spatial.minkowski_distance_p(XA[:7], XB, 3),
       lambda: ssp.minkowski_distance_p(XA[:7], XB, 3)),
    _c("procrustes", lambda P: P.spatial.procrustes(
        XA, XA @ np.diag([1.0, 2.0, 1.0, 0.5]) + 0.1),
       lambda: ssp.procrustes(XA, XA @ np.diag([1.0, 2.0, 1.0, 0.5]) + 0.1)),
    _c("geometric_slerp", lambda P: P.spatial.geometric_slerp(E1, E2, TS),
       lambda: ssp.geometric_slerp(E1, E2, TS)),
    _c("geometric_slerp_scalar",
       lambda P: P.spatial.geometric_slerp(E1, E2, 0.3),
       lambda: ssp.geometric_slerp(E1, E2, 0.3)),
]


def _R(P):
  return P.spatial.transform.Rotation


for _seq in ("xyz", "ZXZ", "zyx", "XYX", "yzy", "ZYX"):
  CASES += [
      _c(f"Rotation_as_euler_{_seq}",
         lambda P, s=_seq: _R(P).from_quat(Q20).as_euler(s),
         lambda s=_seq: SR.from_quat(Q20).as_euler(s)),
      _c(f"Rotation_from_euler_{_seq}",
         lambda P, s=_seq: _R(P).from_euler(s, ANG).as_matrix(),
         lambda s=_seq: SR.from_euler(s, ANG).as_matrix())]
CASES += [
    _c("Rotation_as_matrix", lambda P: _R(P).from_quat(Q20).as_matrix(),
       lambda: SR.from_quat(Q20).as_matrix()),
    _c("Rotation_as_rotvec", lambda P: _R(P).from_quat(Q20).as_rotvec(),
       lambda: SR.from_quat(Q20).as_rotvec()),
    _c("Rotation_as_rotvec_degrees",
       lambda P: _R(P).from_quat(Q20).as_rotvec(degrees=True),
       lambda: SR.from_quat(Q20).as_rotvec(degrees=True)),
    _c("Rotation_as_mrp", lambda P: _R(P).from_quat(Q20).as_mrp(),
       lambda: SR.from_quat(Q20).as_mrp()),
    _c("Rotation_as_quat_canonical",
       lambda P: _R(P).from_quat(Q20).as_quat(canonical=True),
       lambda: SR.from_quat(Q20).as_quat(canonical=True)),
    _c("Rotation_as_quat_scalar_first",
       lambda P: _R(P).from_quat(Q20).as_quat(scalar_first=True),
       lambda: SR.from_quat(Q20).as_quat(scalar_first=True)),
    _c("Rotation_from_quat_scalar_first",
       lambda P: _R(P).from_quat(Q20, scalar_first=True).as_matrix(),
       lambda: SR.from_quat(Q20, scalar_first=True).as_matrix()),
    _c("Rotation_from_matrix", lambda P: _R(P).from_matrix(
        SR.from_quat(Q20).as_matrix()).as_quat(canonical=True),
       lambda: SR.from_matrix(SR.from_quat(Q20).as_matrix()).as_quat(
           canonical=True)),
    _c("Rotation_from_rotvec", lambda P: _R(P).from_rotvec(V3).as_matrix(),
       lambda: SR.from_rotvec(V3).as_matrix()),
    _c("Rotation_from_rotvec_small", lambda P: _R(P).from_rotvec(
        V3 * 1e-4).as_matrix(),
       lambda: SR.from_rotvec(V3 * 1e-4).as_matrix()),
    _c("Rotation_from_mrp", lambda P: _R(P).from_mrp(V3 * 0.3).as_matrix(),
       lambda: SR.from_mrp(V3 * 0.3).as_matrix()),
    _c("Rotation_identity", lambda P: _R(P).identity(3).as_matrix(),
       lambda: SR.identity(3).as_matrix()),
    _c("Rotation_apply", lambda P: _R(P).from_quat(Q20).apply(V3),
       lambda: SR.from_quat(Q20).apply(V3)),
    _c("Rotation_apply_inverse",
       lambda P: _R(P).from_quat(Q20).apply(V3, inverse=True),
       lambda: SR.from_quat(Q20).apply(V3, inverse=True)),
    _c("Rotation_apply_single",
       lambda P: _R(P).from_quat(Q20[0]).apply(V3[0]),
       lambda: SR.from_quat(Q20[0]).apply(V3[0])),
    _c("Rotation_mul", lambda P: (_R(P).from_quat(Q20)
                                  * _R(P).from_quat(Q20[::-1])).as_matrix(),
       lambda: (SR.from_quat(Q20) * SR.from_quat(Q20[::-1])).as_matrix()),
    _c("Rotation_inv", lambda P: _R(P).from_quat(Q20).inv().as_matrix(),
       lambda: SR.from_quat(Q20).inv().as_matrix()),
    _c("Rotation_pow", lambda P: (_R(P).from_quat(Q20) ** 0.3).as_matrix(),
       lambda: (SR.from_quat(Q20) ** 0.3).as_matrix()),
    _c("Rotation_magnitude", lambda P: _R(P).from_quat(Q20).magnitude(),
       lambda: SR.from_quat(Q20).magnitude()),
    _c("Rotation_mean", lambda P: _R(P).from_quat(Q20).mean().as_matrix(),
       lambda: SR.from_quat(Q20).mean().as_matrix()),
    _c("Rotation_mean_weighted", lambda P: _R(P).from_quat(Q20).mean(
        np.linspace(1, 2, 20)).as_matrix(),
       lambda: SR.from_quat(Q20).mean(np.linspace(1, 2, 20)).as_matrix()),
    _c("Rotation_approx_equal", lambda P: _R(P).from_quat(Q20).approx_equal(
        _R(P).from_quat(-Q20)),
       lambda: SR.from_quat(Q20).approx_equal(SR.from_quat(-Q20))),
    _c("Rotation_getitem", lambda P: _R(P).from_quat(Q20)[3].as_matrix(),
       lambda: SR.from_quat(Q20)[3].as_matrix()),
    _c("Rotation_slice", lambda P: _R(P).from_quat(Q20)[2:5].as_matrix(),
       lambda: SR.from_quat(Q20)[2:5].as_matrix()),
    _c("Rotation_concatenate", lambda P: _R(P).concatenate(
        [_R(P).from_quat(Q20[:3]), _R(P).from_quat(Q20[3:5])]).as_matrix(),
       lambda: SR.concatenate([SR.from_quat(Q20[:3]),
                               SR.from_quat(Q20[3:5])]).as_matrix()),
    _c("Rotation_align_vectors", lambda P: _R(P).align_vectors(
        SR.from_quat(Q20[0]).apply(V3[:6]), V3[:6])[0].as_matrix(),
       lambda: SR.align_vectors(SR.from_quat(Q20[0]).apply(V3[:6]),
                                V3[:6])[0].as_matrix()),
    _c("Rotation_align_vectors_rssd", lambda P: _R(P).align_vectors(
        V3[:6] + 0.01 * V3[6:12], V3[:6])[1],
       lambda: SR.align_vectors(V3[:6] + 0.01 * V3[6:12], V3[:6])[1]),
    _c("Slerp_as_matrix", lambda P: P.spatial.transform.Slerp(
        [0.0, 1.0, 2.5, 3.0], _R(P).from_quat(KEYS))(
            [0.0, 0.4, 1.7, 2.6, 3.0]).as_matrix(),
       lambda: SSlerp([0.0, 1.0, 2.5, 3.0], SR.from_quat(KEYS))(
           [0.0, 0.4, 1.7, 2.6, 3.0]).as_matrix()),
]


def _close(got, want, rtol, atol) -> bool:
  return got.shape == want.shape and np.allclose(got, want, rtol=rtol,
                                                 atol=atol, equal_nan=True)


@pytest.mark.parametrize("call,want,rtol,atol,defect", CASES)
def test_function_against_scipy_and_the_reference(call, want, rtol, atol,
                                                  defect):
  import warnings
  with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    got = g(call(sp))
    scipy_value = g(want())
    if defect is None:
      theirs = g(call(ref))
      assert got.shape == theirs.shape
      np.testing.assert_allclose(got, theirs, rtol=rtol, atol=atol,
                                 err_msg="the reference")
    elif defect == "differs":
      assert not _close(g(call(ref)), scipy_value, rtol, 1e-15)
    else:
      with pytest.raises(defect):
        g(call(ref))
  assert got.shape == scipy_value.shape
  np.testing.assert_allclose(got, scipy_value, rtol=rtol, atol=atol,
                             err_msg="scipy")


def test_every_exported_name_has_a_case():
  labels = " ".join(p.id for p in CASES)
  for mod in (sp.spatial.distance, sp.spatial):
    missing = [n for n in mod.__all__ if n not in labels
               and n not in spatial_mod._HOST_NAMES
               and n not in ("distance", "transform")]
    assert missing == []
  for name in ("Rotation", "Slerp"):
    assert name in labels


def test_query_ties_take_the_lower_index_first():
  """A lattice with duplicate points: equal distances come in index order,
  the reference's (lax.top_k's) order; scipy's tree orders them its own
  way, so it is held on the distances only."""
  lat = np.stack(np.meshgrid(np.arange(6.0), np.arange(6.0),
                             indexing="ij"), -1).reshape(-1, 2)
  lat = np.concatenate([lat, lat[:5], lat[7:9]])
  q = np.concatenate([lat[:10] + 0.5, lat[:4]])
  d, i = sp.spatial.KDTree(lat).query(q, k=7)
  rd, ri = ref.spatial.KDTree(lat).query(q, k=7)
  np.testing.assert_array_equal(g(i), g(ri))
  np.testing.assert_allclose(g(d), g(rd), rtol=1e-12)
  sd, _ = ssp.cKDTree(lat).query(q, k=7)
  np.testing.assert_allclose(g(d), sd, rtol=1e-12)
  for row_d, row_i in zip(g(d), g(i)):  # (distance, index) order
    assert all((a, b) <= (c, e) for a, b, c, e in
               zip(row_d, row_i, row_d[1:], row_i[1:]))
  assert g(i).dtype == np.int64


def test_chunked_cdist_equals_the_unchunked(monkeypatch):
  whole = {m: g(sp.spatial.distance.cdist(XA, XB, m)) for m in
           BCAST + ("jensenshannon",)}
  monkeypatch.setattr(dist_mod, "BUDGET", 3 * 7 * 4 * 8)
  assert dist_mod.chunk_rows(10, 7, 4, 8) == 3
  before = dist_mod.counts["chunks"]
  for m, want in whole.items():
    np.testing.assert_array_equal(g(sp.spatial.distance.cdist(XA, XB, m)),
                                  want)
  assert dist_mod.counts["chunks"] - before == 4 * len(whole)
  np.testing.assert_array_equal(
      g(sp.spatial.distance.pdist(BA, "dice")),
      g(sp.spatial.distance.pdist(BA, "dice")))


def test_chunked_queries_equal_the_unchunked(monkeypatch):
  tree = sp.spatial.KDTree(pts)
  d0, i0 = (g(v) for v in tree.query(qry, k=4))
  c0 = g(tree.count_neighbors(sp.spatial.KDTree(pts2), [0.1, 0.3]))
  p0 = tree.query_pairs(0.05)
  monkeypatch.setattr(dist_mod, "BUDGET", 4 * 200 * 8)
  assert spatial_mod.tile_rows(15, 200, 8) == 4
  before = spatial_mod.counts["tile_chunks"]
  d1, i1 = (g(v) for v in tree.query(qry, k=4))
  assert spatial_mod.counts["tile_chunks"] - before >= 4
  # the exact distances of the same neighbours
  np.testing.assert_array_equal(d1, d0)
  np.testing.assert_array_equal(i1, i0)
  np.testing.assert_array_equal(
      g(tree.count_neighbors(sp.spatial.KDTree(pts2), [0.1, 0.3])), c0)
  assert tree.query_pairs(0.05) == p0


def _largest_tensor(fn):
  from torch.utils._python_dispatch import TorchDispatchMode
  seen = [0]

  class Watch(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
      out = func(*args, **(kwargs or {}))
      for t in (out if isinstance(out, (tuple, list)) else [out]):
        if isinstance(t, torch.Tensor) and t.device.type != "meta":
          seen[0] = max(seen[0], t.numel())
      return out
  with Watch():
    fn()
  return seen[0]


def test_no_difference_past_the_budget_is_built(monkeypatch):
  """cdist's broadcast metrics and a KDTree with p = 1 on 64 x 48 points in
  16 dimensions under a budget of 8 rows: the largest tensor is a chunk's
  (8, 48, 16) difference, not the (64, 48, 16) one."""
  a, b = rng.normal(size=(64, 16)), rng.normal(size=(48, 16))
  monkeypatch.setattr(dist_mod, "BUDGET", 8 * 48 * 16 * 8)
  for m in ("cityblock", "canberra", "braycurtis"):
    assert _largest_tensor(
        lambda m=m: sp.spatial.distance.cdist(a, b, m).glom()) \
        <= 8 * 48 * 16
  tree = sp.spatial.KDTree(b)
  assert _largest_tensor(lambda: g(tree.query(a, k=3, p=1)[1])) \
      <= 8 * 48 * 16
  np.testing.assert_allclose(g(sp.spatial.distance.cdist(a, b, "cityblock")),
                             ssd.cdist(a, b, "cityblock"), rtol=1e-12)


def test_dtypes():
  a32, b32 = XA.astype(np.float32), XB.astype(np.float32)
  for m in ("euclidean", "cityblock"):
    got = g(sp.spatial.distance.cdist(a32, b32, m))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ssd.cdist(XA, XB, m), rtol=2e-5,
                               atol=2e-6)
  assert g(sp.spatial.distance.cdist(XA.astype(np.int32), XB,
                                     "cityblock")).dtype == np.float64
  assert g(sp.spatial.distance.pdist(BA, "hamming")).dtype == np.float64
  d, i = sp.spatial.KDTree(pts.astype(np.float32)).query(qry, k=2)
  assert g(d).dtype == np.float64 and g(i).dtype == np.int64
  d, i = sp.spatial.KDTree(pts.astype(np.float32)).query(
      qry.astype(np.float32), k=2)
  assert g(d).dtype == np.float32


def test_ragged_and_host_calls_are_counted():
  tree = sp.spatial.KDTree(pts)
  for call in (lambda: tree.query_ball_point(qry, 0.2),
               lambda: tree.query_ball_tree(sp.spatial.KDTree(pts2), 0.2),
               lambda: tree.query_pairs(0.05),
               lambda: tree.sparse_distance_matrix(sp.spatial.KDTree(pts2),
                                                   0.2),
               lambda: sp.spatial.distance.is_valid_y(ssd.pdist(XA)),
               lambda: sp.spatial.distance.is_valid_dm(ssd.cdist(XA, XA)),
               lambda: sp.spatial.transform.Rotation.create_group("T"),
               lambda: sp.spatial.transform.Rotation.from_quat(Q20).reduce(),
               lambda: sp.spatial.transform.Rotation.align_vectors(
                   V3[:4], V3[4:8], return_sensitivity=True)):
    before = fio.counts["host_runs"]
    call()
    assert fio.counts["host_runs"] - before == 1
  before = fio.counts["host_runs"]
  g(tree.query(qry, k=3)[1])
  g(tree.query_ball_point(qry, 0.2, return_length=True))
  g(tree.count_neighbors(sp.spatial.KDTree(pts2), 0.2))
  assert fio.counts["host_runs"] == before


def test_host_classes_round_trip():
  sdm = sp.spatial.KDTree(pts2).sparse_distance_matrix(
      sp.spatial.KDTree(pts2[:20]), 0.3)
  want = ssp.cKDTree(pts2).sparse_distance_matrix(ssp.cKDTree(pts2[:20]),
                                                  0.3).toarray()
  np.testing.assert_allclose(np.asarray(sdm.todense()), want, rtol=1e-12)
  arr = sp.spatial.KDTree(pts).query_pairs(0.05, output_type="ndarray")
  assert {tuple(r) for r in arr} == ssp.cKDTree(pts).query_pairs(0.05)
  lists = sp.spatial.KDTree(pts).query_ball_point(qry[:3], 0.2)
  want = ssp.cKDTree(pts).query_ball_point(qry[:3], 0.2)
  assert [list(v) for v in lists] == [sorted(v) for v in want]
  group = sp.spatial.transform.Rotation.create_group("O")
  np.testing.assert_allclose(g(group.as_matrix()),
                             SR.create_group("O").as_matrix(), atol=1e-15)


def test_slerp_keeps_the_references_quaternions():
  """Slerp's quaternions are the reference's (the relative rotation's sign
  as it comes; scipy's may be the opposite quaternion of the same
  rotation); its matrices are scipy's (the Slerp_as_matrix case)."""
  times = [0.0, 0.4, 1.7, 2.6, 3.0]
  ours = g(sp.spatial.transform.Slerp([0.0, 1.0, 2.5, 3.0],
                                      sp.spatial.transform.Rotation.from_quat(
                                          KEYS))(times).as_quat())
  theirs = g(ref.spatial.transform.Slerp(
      [0.0, 1.0, 2.5, 3.0],
      ref.spatial.transform.Rotation.from_quat(KEYS))(times).as_quat())
  np.testing.assert_allclose(ours, theirs, rtol=1e-10, atol=1e-12)
  scipy_q = SSlerp([0.0, 1.0, 2.5, 3.0], SR.from_quat(KEYS))(times).as_quat()
  np.testing.assert_allclose(np.abs((ours * scipy_q).sum(1)), 1.0,
                             rtol=1e-12)


def test_random_rotations_are_uniform():
  """Unit quaternions; uniform on SO(3): each entry of the matrix has mean
  0 and variance 1/3, held within 6 standard errors over 20000 draws."""
  n = 20000
  r = sp.spatial.transform.Rotation.random(n, rng=7)
  q = g(r.as_quat())
  np.testing.assert_allclose(np.linalg.norm(q, axis=1), 1.0, rtol=1e-14)
  m = g(r.as_matrix()).reshape(n, 9)
  se = np.sqrt(1.0 / 3.0 / n)
  assert np.abs(m.mean(0)).max() < 6 * se
  assert np.abs((m ** 2).mean(0) - 1.0 / 3.0).max() < 6 * np.sqrt(
      (0.2 - 1.0 / 9.0) / n)
  again = g(sp.spatial.transform.Rotation.random(n, rng=7).as_quat())
  np.testing.assert_array_equal(q, again)
  single = sp.spatial.transform.Rotation.random(rng=np.random.default_rng(1))
  assert g(single.as_quat()).shape == (4,)


def test_device_results_are_lazy():
  for out in (sp.spatial.distance.cdist(XA, XB),
              sp.spatial.distance.pdist(XA, "cityblock"),
              sp.spatial.KDTree(pts).query(qry, k=2)[0],
              sp.spatial.distance_matrix(XA, XB),
              sp.spatial.transform.Rotation.from_quat(Q20).as_euler("xyz")):
    assert isinstance(out, Expr)


def test_the_namespaces_are_the_references():
  import scipy.spatial.transform as sst
  assert sp.spatial is spatial_mod
  assert sp.spatial.distance is dist_mod
  assert sp.spatial.transform is tr_mod
  for ours, theirs, n in ((sp.spatial, ref.spatial, 17),
                          (sp.spatial.distance, ref.spatial.distance, 29),
                          (sp.spatial.transform, ref.spatial.transform, 4)):
    assert sorted(ours.__all__) == sorted(theirs.__all__)
    assert len(ours.__all__) == n
    for name in ours.__all__:
      assert hasattr(ours, name), name
  for name in spatial_mod._HOST_NAMES:
    assert getattr(sp.spatial, name) is getattr(ssp, name)
  assert sp.spatial.transform.RotationSpline is sst.RotationSpline
  assert sp.spatial.transform.RigidTransform is sst.RigidTransform
