"""The port's remaining examples (``ridge_reg``, ``svm``, ``lasso``,
``naive_bayes``, ``fuzzy_kmeans``, ``gmm``, ``knn``, ``black_scholes``,
``netflix_sgd``, ``oscillator``) and the CLI runner (``examples/__main__``)
against the reference's on its 8-device mesh, from the same seeded NumPy
data.

Tolerance: float64 results are held to the reference's at rtol 1e-10 (the
same sums in another order: XLA's tree reductions over 8 shards against
torch's on one device), to each other (``fit`` against ``fit_fused`` or
``fit_compiled``, the matmul route against the scatter route) at the
reference test's own bounds, and to the NumPy oracles the examples carry
(``lasso.fit_numpy``, ``gmm.em_numpy``, ``black_scholes.price_numpy``).
k-NN's labels are compared exactly on continuous data (no tied distances).
About 45 s serial on one core.
"""

import numpy as np
import pytest
import torch

import spartan_tpu as ref
from spartan_tpu.examples import black_scholes as r_bs
from spartan_tpu.examples import fuzzy_kmeans as r_fkm
from spartan_tpu.examples import gmm as r_gmm
from spartan_tpu.examples import kmeans as r_kmeans
from spartan_tpu.examples import knn as r_knn
from spartan_tpu.examples import lasso as r_lasso
from spartan_tpu.examples import naive_bayes as r_nb
from spartan_tpu.examples import netflix_sgd as r_nf
from spartan_tpu.examples import ridge_reg as r_ridge
from spartan_tpu.examples import svm as r_svm

import spartan_tpu_torch as sp
from spartan_tpu_torch.examples import black_scholes as p_bs
from spartan_tpu_torch.examples import fuzzy_kmeans as p_fkm
from spartan_tpu_torch.examples import gmm as p_gmm
from spartan_tpu_torch.examples import kmeans as p_kmeans
from spartan_tpu_torch.examples import knn as p_knn
from spartan_tpu_torch.examples import lasso as p_lasso
from spartan_tpu_torch.examples import naive_bayes as p_nb
from spartan_tpu_torch.examples import netflix_sgd as p_nf
from spartan_tpu_torch.examples import ridge_reg as p_ridge
from spartan_tpu_torch.examples import svm as p_svm

RTOL = 1e-10


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


def _np(x):
  """A result of either package as float64 NumPy."""
  if hasattr(x, "glom"):
    x = x.glom()
  return np.asarray(x)


def _close(ours, want, rtol=RTOL, atol=0.0):
  np.testing.assert_allclose(_np(ours), _np(want), rtol=rtol, atol=atol)


# -- ridge_reg ---------------------------------------------------------------

def test_ridge_fit_and_run_match_the_reference():
  rng = np.random.default_rng(1)
  X = rng.standard_normal((1024, 12))
  y = X @ rng.standard_normal(12) + 0.01 * rng.standard_normal(1024)
  w = p_ridge.fit(sp.from_numpy(X), sp.from_numpy(y), 0.5)
  _close(w, r_ridge.fit(ref.from_numpy(X), ref.from_numpy(y), 0.5))
  _close(w, np.linalg.solve(X.T @ X + 0.5 * np.eye(12), X.T @ y))
  (wp, tp), (wr, tr) = p_ridge.run(1024, 12, 1e-6), r_ridge.run(1024, 12, 1e-6)
  _close(wp, wr)
  np.testing.assert_array_equal(tp, tr)
  np.testing.assert_allclose(wp, tp, atol=1e-2)


# -- svm ---------------------------------------------------------------------

def test_svm_fit_and_fit_fused_match_the_reference():
  Xp, yp, _ = p_svm.make_data(256, 6, seed=5)
  Xr, yr, _ = r_svm.make_data(256, 6, seed=5)
  w_step = p_svm.fit(Xp, yp, 20, alpha=0.05, C=5.0)
  w_fused = p_svm.fit_fused(Xp, yp, 20, alpha=0.05, C=5.0)
  _close(w_step, r_svm.fit(Xr, yr, 20, alpha=0.05, C=5.0))
  _close(w_fused, r_svm.fit_fused(Xr, yr, 20, alpha=0.05, C=5.0))
  _close(w_fused, w_step, rtol=0, atol=1e-10)
  np.testing.assert_array_equal(_np(p_svm.predict(Xp, w_step)),
                                _np(r_svm.predict(Xr, r_svm.fit(
                                    Xr, yr, 20, alpha=0.05, C=5.0))))
  (_, acc), (_, racc) = p_svm.run(1024, 6, 80), r_svm.run(1024, 6, 80)
  assert acc == racc and acc > 0.95


# -- lasso -------------------------------------------------------------------

def test_lasso_fista_matches_the_reference_and_numpy():
  w, w_oracle, w_true = p_lasso.run(4096, 24, reg=0.1)
  rw, _, _ = r_lasso.run(4096, 24, reg=0.1)
  _close(w, rw, rtol=0, atol=1e-12)
  assert np.abs(w - w_oracle).max() < 1e-10
  assert (np.abs(w) < 1e-12).sum() >= (w_true == 0).sum() - 2


def test_lasso_fista_carry_keeps_its_float64_scalar():
  """The momentum ``t`` is a 0-d ``sp.Val(np.float64(1.0))`` carry: the
  loop hands it back 0-d float64 (``make_fori``'s carry rule)."""
  run = sp.make_fori(lambda t: (1.0 + sp.sqrt(1.0 + 4.0 * t * t)) / 2.0,
                     sp.Val(np.float64(1.0)))
  out = _np(run(5))
  t = 1.0
  for _ in range(5):
    t = (1.0 + np.sqrt(1.0 + 4.0 * t * t)) / 2.0
  assert out.shape == () and out.dtype == np.float64
  np.testing.assert_allclose(out, t, rtol=1e-15)


# -- naive_bayes -------------------------------------------------------------

@pytest.mark.parametrize("use_matmul", [True, False])
def test_naive_bayes_routes_match_the_reference(use_matmul):
  Xp, lp, labels = p_nb.make_data(512, 10, 3, seed=2)
  Xr, lr, _ = r_nb.make_data(512, 10, 3, seed=2)
  prior, lik = p_nb.fit(Xp, lp, 3, use_matmul=use_matmul)
  rprior, rlik = r_nb.fit(Xr, lr, 3, use_matmul=use_matmul)
  _close(prior, rprior)
  _close(lik, rlik)
  X = _np(Xp)
  counts = np.stack([X[labels == c].sum(0) for c in range(3)]) + 1.0
  _close(lik, np.log(counts) - np.log(counts.sum(1, keepdims=True)))
  _close(prior, np.log(np.bincount(labels, minlength=3) / 512))
  np.testing.assert_array_equal(_np(p_nb.predict(Xp, prior, lik)),
                                _np(r_nb.predict(Xr, rprior, rlik)))


def test_naive_bayes_routes_agree_and_run_matches():
  Xp, lp, _ = p_nb.make_data(256, 8, 4, seed=9)
  a = p_nb.fit(Xp, lp, 4, use_matmul=True)
  b = p_nb.fit(Xp, lp, 4, use_matmul=False)
  _close(a[0], b[0])
  _close(a[1], b[1])
  assert p_nb.run(1024, 12, 3) == r_nb.run(1024, 12, 3)


# -- fuzzy_kmeans ------------------------------------------------------------

def test_fuzzy_kmeans_fit_matches_the_reference_and_numpy():
  pts, _ = p_kmeans.make_data(n=512, d=3, k=3, seed=7)
  rpts, _ = r_kmeans.make_data(n=512, d=3, k=3, seed=7)
  centers, u = p_fkm.fit(pts, 3, iterations=10, seed=0)
  rc, ru = r_fkm.fit(rpts, 3, iterations=10, seed=0)
  _close(centers, rc)
  _close(u, ru)
  ph = _np(pts)
  c = ph[np.random.default_rng(0).choice(512, 3, replace=False)]
  for _ in range(10):
    d2 = np.maximum(((ph[:, None, :] - c[None]) ** 2).sum(-1), 1e-12)
    inv = d2 ** -1.0
    um = (inv / inv.sum(1, keepdims=True)) ** 2
    c = (um.T @ ph) / um.sum(0)[:, None]
  np.testing.assert_allclose(_np(centers), c, atol=1e-8)


def test_fuzzy_kmeans_fit_fused_matches_fit_and_the_reference():
  pts, _ = p_kmeans.make_data(256, 4, 3, seed=6)
  rpts, _ = r_kmeans.make_data(256, 4, 3, seed=6)
  c_fused, u_fused = p_fkm.fit_fused(pts, 3, 6, seed=2)
  c_step, u_step = p_fkm.fit(pts, 3, 6, seed=2)
  rc, ru = r_fkm.fit_fused(rpts, 3, 6, seed=2)
  _close(c_fused, c_step, rtol=0, atol=1e-9)
  _close(u_fused, u_step, rtol=0, atol=1e-9)
  _close(c_fused, rc)
  _close(u_fused, ru)
  # m = 3 takes the power route d2 ** (-1/2)
  _close(p_fkm.memberships(pts, sp.from_numpy(_np(c_step)), 3.0),
         r_fkm.memberships(rpts, ref.from_numpy(_np(c_step)), 3.0))


# -- gmm ---------------------------------------------------------------------

def _gmm_data(n=1024, d=4, k=3, seed=0):
  rng = np.random.default_rng(seed)
  true_mu = rng.standard_normal((k, d)) * 5.0
  lab = rng.integers(0, k, n)
  return true_mu[lab] + rng.standard_normal((n, d))


def test_gmm_em_step_matches_numpy_and_the_reference():
  X = _gmm_data()
  mu0 = p_kmeans.farthest_init(sp.from_numpy(X), 3, 0)
  np.testing.assert_array_equal(mu0, r_kmeans.farthest_init(
      ref.from_numpy(X), 3, 0))
  var0 = np.ones((3, 4)) * X.var(0).mean()
  pi0 = np.full(3, 1 / 3)
  run = sp.make_fori(
      lambda mu, var, pi: p_gmm.em_step(sp.from_numpy(X), mu, var, pi),
      (sp.Val(mu0), sp.Val(var0), sp.Val(pi0)))
  mu, var, pi = (_np(sp.lazify(v)) for v in run(20))
  mo, vo, po = p_gmm.em_numpy(X, mu0, var0, pi0, 20)
  assert np.abs(mu - mo).max() < 1e-9
  assert np.abs(var - vo).max() < 1e-9
  assert np.abs(pi - po).max() < 1e-12
  for a, b in zip((mo, vo, po), r_gmm.em_numpy(X, mu0, var0, pi0, 20)):
    np.testing.assert_array_equal(a, b)


def test_gmm_fit_fused_and_run_match_the_reference():
  X = _gmm_data(seed=3)
  for a, b in zip(p_gmm.fit_fused(sp.from_numpy(X), 3, 25),
                  r_gmm.fit_fused(ref.from_numpy(X), 3, 25)):
    _close(a, b)
  (err, pi), (rerr, rpi) = p_gmm.run(2048, 4, 3, 30), r_gmm.run(2048, 4, 3,
                                                                30)
  np.testing.assert_allclose(err, rerr, rtol=1e-9)
  _close(pi, rpi)


# -- knn ---------------------------------------------------------------------

def test_knn_matches_numpy_and_the_reference():
  X, y = p_knn.make_blobs(256, 4, seed=2)
  Q, _ = p_knn.make_blobs(64, 4, seed=3)
  pred = _np(p_knn.predict(sp.from_numpy(Q), sp.from_numpy(X),
                           sp.from_numpy(y), k=3, n_classes=4))
  d2 = ((Q[:, None, :] - X[None, :, :]) ** 2).sum(-1)
  nn = np.argsort(d2, axis=1)[:, :3]
  want = np.array([np.bincount(y[r], minlength=4).argmax() for r in nn])
  np.testing.assert_array_equal(pred, want)
  np.testing.assert_array_equal(pred, _np(r_knn.predict(
      ref.from_numpy(Q), ref.from_numpy(X), ref.from_numpy(y), k=3,
      n_classes=4)))
  _close(p_knn.pairwise_sq_dists(sp.from_numpy(Q), sp.from_numpy(X)), d2,
         rtol=1e-10, atol=1e-10)
  # n_classes read from the labels on the host
  np.testing.assert_array_equal(_np(p_knn.predict(
      sp.from_numpy(Q), sp.from_numpy(X), sp.from_numpy(y), k=3)), pred)
  assert p_knn.run(n=1024, d=6) == r_knn.run(n=1024, d=6)


# -- black_scholes -----------------------------------------------------------

def test_black_scholes_matches_the_reference_and_numpy():
  rng = np.random.default_rng(0)
  n = 1 << 12
  spot = rng.uniform(10.0, 200.0, n)
  strike = rng.uniform(10.0, 200.0, n)
  t = rng.uniform(0.1, 2.0, n)
  call, put = p_bs.price(sp.from_numpy(spot), sp.from_numpy(strike),
                         sp.from_numpy(t))
  rcall, rput = r_bs.price(ref.from_numpy(spot), ref.from_numpy(strike),
                           ref.from_numpy(t))
  call_n, put_n = p_bs.price_numpy(spot, strike, t)
  _close(call, rcall, rtol=RTOL, atol=1e-12)
  _close(put, rput, rtol=RTOL, atol=1e-12)
  np.testing.assert_allclose(_np(call), call_n, atol=1e-9)
  np.testing.assert_allclose(_np(put), put_n, atol=1e-9)
  parity = _np(call) - _np(put) - (spot - np.exp(-0.05 * t) * strike)
  assert np.abs(parity).max() < 1e-9
  for a, b in zip(p_bs.run(1 << 12), r_bs.run(1 << 12)):
    _close(a, b, rtol=RTOL, atol=1e-12)


# -- netflix_sgd -------------------------------------------------------------

def _ratings(n_users=64, n_items=32, k=4, n_r=1024, seed=0):
  rng = np.random.default_rng(seed)
  U0 = rng.standard_normal((n_users, k)) * 0.5
  V0 = rng.standard_normal((n_items, k)) * 0.5
  users = rng.integers(0, n_users, n_r)
  items = rng.integers(0, n_items, n_r)
  return users, items, (U0[users] * V0[items]).sum(1)


@pytest.mark.parametrize("use_matmul", [True, False])
def test_netflix_sgd_step_routes_match_the_reference(use_matmul):
  rng = np.random.default_rng(4)
  nu, ni, k, B = 32, 16, 4, 64
  U, V = rng.standard_normal((nu, k)), rng.standard_normal((ni, k))
  users, items = rng.integers(0, nu, B), rng.integers(0, ni, B)
  ratings = rng.standard_normal(B)
  u1, v1 = p_nf.sgd_step(sp.from_numpy(U), sp.from_numpy(V),
                         sp.from_numpy(users), sp.from_numpy(items),
                         sp.from_numpy(ratings), use_matmul=use_matmul)
  u2, v2 = r_nf.sgd_step(ref.from_numpy(U), ref.from_numpy(V),
                         ref.from_numpy(users), ref.from_numpy(items),
                         ref.from_numpy(ratings), use_matmul=use_matmul)
  _close(u1, u2, atol=1e-13)
  _close(v1, v2, atol=1e-13)
  # both routes against a float64 np.add.at (duplicate indices accumulate)
  err = ((U[users] * V[items]).sum(1) - ratings)[:, None]
  gu, gv = err * V[items] + 0.02 * U[users], err * U[users] + 0.02 * V[items]
  Uw, Vw = U.copy(), V.copy()
  np.add.at(Uw, users, -0.05 * gu)
  np.add.at(Vw, items, -0.05 * gv)
  _close(u1, Uw, rtol=0, atol=1e-12)
  _close(v1, Vw, rtol=0, atol=1e-12)


def test_netflix_fit_fit_compiled_and_rmse_match_the_reference():
  users, items, ratings = _ratings()
  U1, V1 = p_nf.fit(users, items, ratings, 64, 32, 4, epochs=2, batch=256)
  U2, V2 = p_nf.fit_compiled(users, items, ratings, 64, 32, 4, epochs=2,
                             batch=256)
  R1, RV1 = r_nf.fit(users, items, ratings, 64, 32, 4, epochs=2, batch=256)
  np.testing.assert_allclose(_np(U1), _np(U2), rtol=1e-12)
  np.testing.assert_allclose(_np(V1), _np(V2), rtol=1e-12)
  _close(U1, R1)
  _close(V1, RV1)
  np.testing.assert_allclose(p_nf.rmse(U1, V1, users, items, ratings),
                             r_nf.rmse(R1, RV1, users, items, ratings),
                             rtol=RTOL)
  np.testing.assert_allclose(p_nf.run(64, 32, 4, 2048, 2),
                             r_nf.run(64, 32, 4, 2048, 2), rtol=RTOL)


def test_netflix_fit_accepts_the_tile_hint():
  """``from_numpy(..., tile_hint=(n, k))`` (the reference's one-tile
  factors) is accepted and changes nothing of the values."""
  X = np.random.default_rng(0).standard_normal((8, 3))
  a = sp.from_numpy(X, tile_hint=(8, 3))
  np.testing.assert_array_equal(_np(a), X)


# -- the CLI runner ----------------------------------------------------------

NEW_RUNNERS = ["svm", "naive_bayes", "fuzzy_kmeans", "netflix", "ridge",
               "black_scholes", "lasso", "gmm", "knn", "oscillator"]


def test_the_cli_registers_every_reference_runner_but_the_waiting():
  from spartan_tpu.examples.__main__ import _RUNNERS as REF_RUNNERS

  from spartan_tpu_torch.examples.__main__ import _RUNNERS, WAITING
  waiting = {name for name, _ in WAITING}
  assert waiting == set()
  assert set(_RUNNERS) == set(REF_RUNNERS) - waiting


def test_oscillator_recovers_the_references_welch_bin():
  """The oscillator: RK45's samples against the reference's, then from the
  same NumPy noise the same Welch bin, 0.299853515625 Hz (one bin is
  fs / 512 = 0.09995 Hz; the expected frequency 0.31791 Hz lies in it)."""
  from spartan_tpu.examples import oscillator as r_osc

  from spartan_tpu_torch.examples import oscillator as p_osc
  t, x = p_osc.simulate()
  rt, rx = r_osc.simulate()
  np.testing.assert_array_equal(t, rt)
  np.testing.assert_allclose(np.asarray(x), np.asarray(rx), rtol=0,
                             atol=1e-9)
  got = p_osc.recover_frequency(t, x)
  assert got == r_osc.recover_frequency(rt, np.asarray(rx)) == 0.299853515625
  got, want = p_osc.run()
  assert got == 0.299853515625
  assert want == 2.0 * np.sqrt(1 - 0.05 ** 2) / (2 * np.pi)
  assert abs(got - want) < (2048 - 1) / 40.0 / 512


def test_every_example_module_is_ported_and_has_an_entry():
  import importlib
  import pkgutil

  import spartan_tpu.examples as ref_pkg

  import spartan_tpu_torch.examples as pkg
  mods = sorted(m.name for m in pkgutil.iter_modules(pkg.__path__)
                if not m.name.startswith("_"))
  ref_mods = sorted(m.name for m in pkgutil.iter_modules(ref_pkg.__path__)
                    if not m.name.startswith("_"))
  assert mods == ref_mods
  for m in mods:
    mod = importlib.import_module(f"spartan_tpu_torch.examples.{m}")
    assert hasattr(mod, "run") or hasattr(mod, "fit"), m
  assert pkg.__dict__.keys() >= {"als", "cg", "convnet", "fuzzy_kmeans",
                                 "kmeans", "linear_reg", "logistic_reg",
                                 "naive_bayes", "netflix_sgd", "pagerank",
                                 "pca", "ridge_reg", "svm"}


@pytest.mark.parametrize("name", NEW_RUNNERS)
def test_a_new_runner_prints_the_reference_keys_and_values(name):
  from spartan_tpu.examples.__main__ import _RUNNERS as REF_RUNNERS

  from spartan_tpu_torch.examples.__main__ import _RUNNERS
  out, want = _RUNNERS[name](), REF_RUNNERS[name]()
  assert sorted(out) == sorted(want)
  for key in want:
    np.testing.assert_allclose(np.asarray(out[key], dtype=np.float64),
                               np.asarray(want[key], dtype=np.float64),
                               rtol=1e-8, atol=1e-10, err_msg=key)


def test_main_runs_a_runner_on_the_cpu(capsys):
  from spartan_tpu_torch.examples.__main__ import main
  assert main(["knn", "--device=cpu"]) == 0
  printed = eval(capsys.readouterr().out.strip().splitlines()[-1])
  assert set(printed) == {"accuracy", "seconds", "example", "mesh"}
  assert printed["example"] == "knn" and printed["accuracy"] == 1.0
  assert main(["oscillator", "--device=cpu"]) == 0
  printed = eval(capsys.readouterr().out.strip().splitlines()[-1],
                 {"np": np})
  assert set(printed) == {"recovered_hz", "expected_hz", "rel_err",
                          "seconds", "example", "mesh"}
  assert printed["recovered_hz"] == 0.299853515625
  assert main(["no_such_example", "--device=cpu"]) == 1
