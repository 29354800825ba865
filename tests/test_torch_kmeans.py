"""k-means (config 4) in both packages from the same seeded data and
centers: each function against the reference at rtol 1e-10 in float64
(the same sums in another order), labels exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spartan_tpu as ref
from spartan_tpu.examples import kmeans as ref_kmeans

import spartan_tpu_torch as sp
from spartan_tpu_torch.examples import kmeans

N, D, K, SEED = 256, 3, 4, 2


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


def _data(n=N, d=D, k=K, seed=SEED):
  ref_pts, true_c = ref_kmeans.make_data(n=n, d=d, k=k, seed=seed)
  pts, true_c2 = kmeans.make_data(n=n, d=d, k=k, seed=seed)
  np.testing.assert_array_equal(true_c, true_c2)
  np.testing.assert_array_equal(np.asarray(ref_pts.glom()), pts.glom())
  return ref_pts, pts, true_c


def test_assign_labels_matches_reference():
  ref_pts, pts, _ = _data()
  c0 = np.asarray(ref_pts.glom())[:K]
  want = ref_kmeans.assign_labels(ref_pts, ref.from_numpy(c0)).glom()
  got = kmeans.assign_labels(pts, sp.from_numpy(c0)).glom()
  np.testing.assert_array_equal(got, np.asarray(want))


def test_assign_labels_breaks_ties_to_the_first_center():
  pts = np.array([[0.0, 0.0], [1.0, 0.0], [-1.0, 0.0], [0.0, 5.0]])
  centers = np.array([[1.0, 0.0], [-1.0, 0.0], [1.0, 0.0]])
  got = kmeans.assign_labels(sp.from_numpy(pts), sp.from_numpy(centers)).glom()
  want = ref_kmeans.assign_labels(ref.from_numpy(pts),
                                  ref.from_numpy(centers)).glom()
  np.testing.assert_array_equal(got, np.asarray(want))
  np.testing.assert_array_equal(got, [0, 0, 1, 0])


def test_emitters_and_onehot_match_reference():
  rng = np.random.default_rng(4)
  p = rng.standard_normal((10, 3))
  lab = rng.integers(0, K, 10)
  coords = tuple(np.indices(p.shape))
  (r_ref, c_ref), v_ref = ref_kmeans._emit_sums(
      jnp.asarray(p), jnp.asarray(lab), tuple(map(jnp.asarray, coords)))
  (r, c), v = kmeans._emit_sums(torch.from_numpy(p), torch.from_numpy(lab),
                                tuple(map(torch.from_numpy, coords)))
  for a, b in ((r, r_ref), (c, c_ref), (v, v_ref)):
    np.testing.assert_array_equal(a.numpy(), np.asarray(b))
  (l_ref,), ones_ref = ref_kmeans._emit_counts(jnp.asarray(lab), None)
  (l,), ones = kmeans._emit_counts(torch.from_numpy(lab), None)
  np.testing.assert_array_equal(l.numpy(), np.asarray(l_ref))
  assert ones.dtype == torch.float64 and np.asarray(ones_ref).dtype == np.float64
  np.testing.assert_array_equal(ones.numpy(), np.asarray(ones_ref))
  oh_ref = ref_kmeans._onehot(jnp.asarray(lab), K)
  oh = kmeans._onehot(torch.from_numpy(lab), K)
  assert oh.dtype == torch.float64
  np.testing.assert_array_equal(oh.numpy(), np.asarray(oh_ref))


@pytest.mark.parametrize("use_matmul", [True, False], ids=["matmul", "shuffle"])
def test_update_centers_matches_reference(use_matmul):
  ref_pts, pts, _ = _data()
  rng = np.random.default_rng(6)
  labels = rng.integers(0, K - 1, N)  # the last center stays empty
  want = ref_kmeans.update_centers(ref_pts, ref.from_numpy(labels), K,
                                   use_matmul=use_matmul).glom()
  got = kmeans.update_centers(pts, sp.from_numpy(labels), K,
                              use_matmul=use_matmul).glom()
  assert got.dtype == np.asarray(want).dtype == np.float64
  np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-14)
  np.testing.assert_array_equal(got[K - 1], 0.0)


@pytest.mark.parametrize("given", [True, False], ids=["centers", "seeded"])
def test_fit_matches_reference(given):
  ref_pts, pts, _ = _data(512, 4, 3, 9)
  c0 = np.asarray(ref_pts.glom())[[3, 100, 400]] if given else None
  want_c, want_l = ref_kmeans.fit(
      ref_pts, 3, 8, centers=None if c0 is None else ref.from_numpy(c0),
      seed=1)
  got_c, got_l = kmeans.fit(
      pts, 3, 8, centers=None if c0 is None else sp.from_numpy(c0), seed=1)
  np.testing.assert_allclose(got_c.glom(), want_c.glom(), rtol=1e-10)
  np.testing.assert_array_equal(got_l.glom(), np.asarray(want_l.glom()))


@pytest.mark.parametrize("given", [True, False], ids=["centers", "seeded"])
def test_fit_fused_matches_reference_and_fit(given):
  ref_pts, pts, _ = _data(512, 4, 3, 9)
  c0 = np.asarray(ref_pts.glom())[[7, 8, 9]] if given else None
  want = ref_kmeans.fit_fused(ref_pts, 3, 8, centers=c0, seed=2).glom()
  got = kmeans.fit_fused(pts, 3, 8, centers=c0, seed=2)
  assert isinstance(got, sp.SpartanArray)
  np.testing.assert_allclose(got.glom(), np.asarray(want), rtol=1e-10)
  if given:
    stepwise, _ = kmeans.fit(pts, 3, 8, centers=sp.from_numpy(c0))
    np.testing.assert_allclose(got.glom(), stepwise.glom(), rtol=1e-10)


def test_fit_fused_farthest_init_waits():
  """``init='farthest'`` no longer waits: it seeds with farthest_init,
  as the reference's does."""
  ref_pts, pts, _ = _data()
  want = ref_kmeans.fit_fused(ref_pts, K, 2, init="farthest", seed=3).glom()
  got = kmeans.fit_fused(pts, K, 2, init="farthest", seed=3)
  np.testing.assert_allclose(got.glom(), np.asarray(want), rtol=1e-10)


@pytest.mark.parametrize("seed", [0, 5])
def test_farthest_init_matches_reference(seed):
  ref_pts, pts, _ = _data(512, 4, 3, 9)
  want = ref_kmeans.farthest_init(ref_pts, 5, seed=seed)
  got = kmeans.farthest_init(pts, 5, seed=seed)
  np.testing.assert_array_equal(got, np.asarray(want))


def test_farthest_init_leaves_no_cluster_empty():
  """Two tight, distant blobs: farthest seeding puts one center in each
  (random seeds can land both in one, the Watch list's empty-cluster
  case), so every cluster keeps its 64 points, with the reference's
  centers."""
  rng = np.random.default_rng(4)
  blob = np.concatenate([rng.normal(0.0, 0.01, (64, 2)),
                         rng.normal(50.0, 0.01, (64, 2))])
  pts = sp.from_numpy(blob)
  c0 = kmeans.farthest_init(pts, 2, seed=0)
  np.testing.assert_array_equal(
      c0, np.asarray(ref_kmeans.farthest_init(ref.from_numpy(blob), 2,
                                              seed=0)))
  assert abs(c0[0, 0] - c0[1, 0]) > 40.0
  centers = kmeans.fit_fused(pts, 2, 5, init="farthest").glom()
  labels = kmeans.assign_labels(pts, sp.from_numpy(centers)).glom()
  assert np.bincount(labels, minlength=2).min() == 64


def test_make_fori_step_equals_fit():
  _, pts, _ = _data()
  c0 = pts.glom()[:K]
  run = sp.make_fori(
      lambda c: kmeans.update_centers(pts, kmeans.assign_labels(pts, c), K),
      sp.from_numpy(c0))
  stepwise, _ = kmeans.fit(pts, K, 5, centers=sp.from_numpy(c0))
  np.testing.assert_allclose(run(5).glom(), stepwise.glom(), rtol=1e-12)


def test_run_matches_reference():
  want_c, want_l, want_true = ref_kmeans.run(n=512, d=4, k=3, iterations=5)
  got_c, got_l, got_true = kmeans.run(n=512, d=4, k=3, iterations=5)
  np.testing.assert_array_equal(got_true, want_true)
  np.testing.assert_allclose(got_c.glom(), want_c.glom(), rtol=1e-10)
  np.testing.assert_array_equal(got_l.glom(), np.asarray(want_l.glom()))
