"""The port's ``learn`` estimators (``spartan_tpu_torch/learn``) against the
reference's (``spartan_tpu/learn``) on its 8-device mesh, from the same
seeded NumPy data: a counterpart of each ``learn`` test of the reference's
``tests/test_aux.py`` and ``tests/test_examples.py``, with the port's
fitted attributes held to the reference's.

Tolerance: float64 attributes at rtol 1e-10 (the same sums in another
order); labels exactly.  The 14 names are pinned against the reference's.
About 20 s serial on one core.
"""

import numpy as np
import pytest
import scipy.sparse as ssp
import torch

import spartan_tpu as ref
import spartan_tpu.learn as RL

import spartan_tpu_torch as sp
import spartan_tpu_torch.learn as L

RTOL = 1e-10


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


def _close(a, b, rtol=RTOL, atol=0.0):
  np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                             atol=atol)


def test_learn_exports_the_reference_names():
  assert L.__all__ == RL.__all__
  assert len(L.__all__) == 14
  for name in L.__all__:
    assert isinstance(getattr(L, name), type), name


def test_linear_regression(rng):
  X = rng.standard_normal((512, 6))
  y = X @ rng.standard_normal(6) + 0.01 * rng.standard_normal(512)
  m = L.LinearRegression(iterations=200, alpha=0.1).fit(X, y)
  r = RL.LinearRegression(iterations=200, alpha=0.1).fit(X, y)
  _close(m.coef_, r.coef_)
  _close(m.predict(X[:16]), r.predict(X[:16]))
  assert m.score(X, y) > 0.99
  np.testing.assert_allclose(m.score(X, y), r.score(X, y), rtol=1e-12)


def test_ridge(rng):
  X = rng.standard_normal((256, 4))
  w = rng.standard_normal(4)
  y = X @ w
  m = L.Ridge(alpha=1e-8).fit(X, y)
  _close(m.coef_, RL.Ridge(alpha=1e-8).fit(X, y).coef_)
  np.testing.assert_allclose(m.coef_, w, atol=1e-6)
  _close(m.predict(X[:8]), X[:8] @ m.coef_)


def test_logistic_regression(rng):
  X = rng.standard_normal((512, 4))
  y = (X @ rng.standard_normal(4) > 0).astype(int)
  m = L.LogisticRegression(iterations=100).fit(X, y)
  r = RL.LogisticRegression(iterations=100).fit(X, y)
  _close(m.coef_, r.coef_)
  _close(m.predict_proba(X), r.predict_proba(X))
  np.testing.assert_array_equal(m.predict(X), r.predict(X))
  assert (m.predict(X) == y).mean() > 0.9


def test_svc(rng):
  X = rng.standard_normal((512, 4))
  y = np.sign(X @ rng.standard_normal(4) + 1e-9)
  m = L.SVC(iterations=100).fit(X, y)
  _close(m.coef_, RL.SVC(iterations=100).fit(X, y).coef_)
  assert (m.predict(X) == y).mean() > 0.95


def test_lasso():
  rng = np.random.default_rng(0)
  X = rng.standard_normal((2048, 16))
  w_true = np.zeros(16)
  w_true[:4] = [1.5, -2.0, 0.7, 3.0]
  y = X @ w_true + 0.01 * rng.standard_normal(2048)
  est = L.Lasso(alpha=0.01, iterations=300).fit(X, y)
  np.testing.assert_allclose(
      est.coef_, RL.Lasso(alpha=0.01, iterations=300).fit(X, y).coef_,
      rtol=RTOL, atol=1e-14)
  assert np.abs(est.coef_ - w_true).max() < 0.05
  _close(est.predict(X[:8]), X[:8] @ est.coef_)


def test_kmeans():
  from spartan_tpu_torch.examples.kmeans import make_data
  pts, _ = make_data(512, 4, 3, seed=3)
  P = np.asarray(pts.glom())
  m = L.KMeans(n_clusters=3, iterations=10, seed=3).fit(P)
  r = RL.KMeans(n_clusters=3, iterations=10, seed=3).fit(P)
  _close(m.cluster_centers_, r.cluster_centers_)
  np.testing.assert_array_equal(m.labels_, r.labels_)
  np.testing.assert_array_equal(m.predict(P), r.predict(P))
  assert m.cluster_centers_.shape == (3, 4)


def test_naive_bayes_remaps_string_labels():
  from spartan_tpu_torch.examples.naive_bayes import make_data
  X, _, labels = make_data(512, 10, 3, seed=2)
  Xh = np.asarray(X.glom())
  str_labels = np.array(["a", "b", "c"])[labels]
  m = L.NaiveBayes().fit(Xh, str_labels)
  r = RL.NaiveBayes().fit(Xh, str_labels)
  np.testing.assert_array_equal(m.classes_, r.classes_)
  _close(m.log_prior_, r.log_prior_)
  _close(m.log_likelihood_, r.log_likelihood_)
  pred = m.predict(Xh)
  np.testing.assert_array_equal(pred, r.predict(Xh))
  assert pred.dtype == str_labels.dtype
  assert (pred == str_labels).mean() > 0.9


def test_pca(rng):
  X = rng.standard_normal((512, 8)) * np.linspace(10, 1, 8)
  m = L.PCA(n_components=2).fit(X)
  r = RL.PCA(n_components=2).fit(X)
  assert m.components_.shape == (2, 8)
  _close(m.explained_variance_, r.explained_variance_)
  _close(m.components_, r.components_, rtol=1e-8, atol=1e-10)
  Z = m.transform(X)
  assert Z.shape == (512, 2)
  _close(Z, r.transform(X), rtol=1e-8, atol=1e-9)
  _close(m.fit_transform(X), Z, rtol=1e-12, atol=1e-12)
  assert m.explained_variance_[0] > m.explained_variance_[1]


def _sign_fixed(c):
  """Rows of singular vectors with the sign of their largest entry made
  positive (an SVD's vectors are defined up to sign)."""
  c = np.asarray(c)
  return c * np.sign(c[np.arange(len(c)), np.abs(c).argmax(1)])[:, None]


def test_truncated_svd_dense(rng):
  X = rng.standard_normal((200, 16))
  m = L.TruncatedSVD(n_components=3).fit(X)
  r = RL.TruncatedSVD(n_components=3).fit(X)
  st = np.linalg.svd(X, compute_uv=False)[:3]
  np.testing.assert_allclose(m.singular_values_, st, atol=1e-9)
  _close(m.singular_values_, r.singular_values_, rtol=1e-10)
  _close(_sign_fixed(m.components_), _sign_fixed(r.components_),
         rtol=0, atol=1e-8)
  Z = m.transform(X)
  assert Z.shape == (200, 3)
  assert abs((Z ** 2).sum() - (st ** 2).sum()) < 1e-6 * (st ** 2).sum()


def test_truncated_svd_sparse():
  Xs = ssp.random(128, 24, density=0.2,
                  random_state=np.random.RandomState(0), format="csr")
  ms = L.TruncatedSVD(n_components=2).fit(sp.sparse.from_scipy(Xs))
  sts = np.linalg.svd(Xs.todense(), compute_uv=False)[:2]
  np.testing.assert_allclose(ms.singular_values_, np.asarray(sts).ravel(),
                             atol=1e-9)
  rs = RL.TruncatedSVD(n_components=2).fit(ref.sparse.from_scipy(Xs))
  _close(ms.singular_values_, rs.singular_values_)
  Z = ms.transform(sp.sparse.from_scipy(Xs))
  _close(Z, Xs @ ms.components_.T, rtol=1e-12, atol=1e-12)


def test_gaussian_mixture_recovers_components():
  rng = np.random.default_rng(1)
  a = rng.standard_normal((512, 3)) * 0.5
  b = rng.standard_normal((512, 3)) * 0.5 + 6.0
  X = np.concatenate([a, b])
  est = L.GaussianMixture(2, iterations=40).fit(X)
  r = RL.GaussianMixture(2, iterations=40).fit(X)
  _close(est.means_, r.means_)
  _close(est.variances_, r.variances_)
  _close(est.weights_, r.weights_)
  labels = est.predict(X)
  np.testing.assert_array_equal(labels, r.predict(X))
  truth = np.concatenate([np.zeros(512), np.ones(512)])
  assert max((labels == truth).mean(), (labels == 1 - truth).mean()) > 0.99


def test_spectral_clustering():
  rng = np.random.default_rng(0)
  a = rng.standard_normal((64, 2)) * 0.3
  b = rng.standard_normal((64, 2)) * 0.3 + 4.0
  X = np.concatenate([a, b])
  labels = L.SpectralClustering(2, gamma=1.0).fit_predict(X)
  np.testing.assert_array_equal(
      labels, RL.SpectralClustering(2, gamma=1.0).fit_predict(X))
  truth = np.concatenate([np.zeros(64), np.ones(64)])
  assert max((labels == truth).mean(), (labels == 1 - truth).mean()) == 1.0


def test_fuzzy_kmeans(rng):
  from spartan_tpu_torch.examples.kmeans import make_data
  pts, _ = make_data(256, 3, 3, seed=5)
  P = np.asarray(pts.glom())
  m = L.FuzzyKMeans(n_clusters=3, iterations=5).fit(P)
  r = RL.FuzzyKMeans(n_clusters=3, iterations=5).fit(P)
  assert m.cluster_centers_.shape == (3, 3)
  _close(m.cluster_centers_, r.cluster_centers_)
  _close(m.membership_, r.membership_)
  np.testing.assert_allclose(m.membership_.sum(1), 1.0, atol=1e-8)


def test_als_dense(rng):
  U0, V0 = rng.standard_normal((64, 4)), rng.standard_normal((32, 4))
  R = U0 @ V0.T
  a = L.ALS(n_factors=4, iterations=8, reg=0.01).fit(R)
  r = RL.ALS(n_factors=4, iterations=8, reg=0.01).fit(R)
  _close(a.predict(), r.predict(), rtol=1e-8, atol=1e-10)
  assert np.abs(a.predict() - R).mean() < 0.1


def test_als_sparse_passes_the_sparse_array_through(monkeypatch):
  """A ``SparseArray`` reaches ``examples/als.fit`` untouched (the route
  that takes the SpMM kernel on the card); the factors match the
  reference's ALS on the same matrix."""
  from spartan_tpu_torch.examples import als as als_mod
  R = ssp.random(120, 60, density=0.2, random_state=np.random.RandomState(3),
                 format="csr")
  S = sp.sparse.from_scipy(R)
  seen = []
  real = als_mod.fit

  def spy(Rin, *a, **k):
    seen.append(Rin)
    return real(Rin, *a, **k)
  monkeypatch.setattr(als_mod, "fit", spy)
  a = L.ALS(n_factors=4, iterations=3, reg=0.1).fit(S)
  assert seen[0] is S
  r = RL.ALS(n_factors=4, iterations=3, reg=0.1).fit(
      ref.sparse.from_scipy(R))
  _close(a.predict(), r.predict(), rtol=1e-8, atol=1e-10)


def test_kneighbors_classifier_keeps_the_train_set():
  from spartan_tpu_torch.examples import knn
  X, y = knn.make_blobs(1024, 6, seed=0)
  est = L.KNeighborsClassifier(5).fit(X[:900], y[:900])
  r = RL.KNeighborsClassifier(5).fit(X[:900], y[:900])
  assert isinstance(est._X, sp.SpartanArray)
  assert est._X.data.device == sp.get_mesh().device
  np.testing.assert_array_equal(est.predict(X[900:]), r.predict(X[900:]))
  assert est.score(X[900:], y[900:]) > 0.95
  assert est.score(X[900:], y[900:]) == r.score(X[900:], y[900:])


def test_lazy_uploads_numpy_once():
  from spartan_tpu_torch.learn import estimators
  X = np.arange(12.0).reshape(4, 3)
  e = estimators._lazy(X)
  assert isinstance(e, sp.Val) and isinstance(e.value, sp.SpartanArray)
  np.testing.assert_array_equal(np.asarray(e.glom()), X)
  v = sp.from_numpy(X)
  assert estimators._lazy(v) is v
