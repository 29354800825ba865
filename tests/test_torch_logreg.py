"""Logistic regression (config 3's logistic half) in both packages from the
same seeded data: each function against the reference at rtol 1e-10 in
float64 (the same sums in another order, through exp)."""

import numpy as np
import pytest
import torch

import spartan_tpu as ref
from spartan_tpu.examples import logistic_reg as ref_logreg

import spartan_tpu_torch as sp
from spartan_tpu_torch.examples import logistic_reg

N, D, STEPS, ALPHA = 512, 6, 20, 0.5


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


def _data(n=N, d=D, seed=4):
  ref_X, ref_y, w_true = ref_logreg.make_data(n, d, seed=seed)
  X, y, w_true2 = logistic_reg.make_data(n, d, seed=seed)
  np.testing.assert_array_equal(w_true, w_true2)
  np.testing.assert_array_equal(np.asarray(ref_X.glom()), X.glom())
  np.testing.assert_array_equal(np.asarray(ref_y.glom()), y.glom())
  return ref_X, ref_y, X, y


def test_sigmoid_matches_reference():
  v = np.linspace(-30, 30, 101)
  want = ref_logreg.sigmoid(ref.from_numpy(v)).glom()
  got = logistic_reg.sigmoid(sp.from_numpy(v)).glom()
  np.testing.assert_allclose(got, want, rtol=1e-15)


def test_gradient_step_matches_reference():
  ref_X, ref_y, X, y = _data()
  w0 = np.random.default_rng(1).standard_normal(D)
  want = ref_logreg.gradient_step(ref_X, ref_y, ref.from_numpy(w0), ALPHA)
  got = logistic_reg.gradient_step(X, y, sp.from_numpy(w0), ALPHA)
  np.testing.assert_allclose(got.glom(), want.glom(), rtol=1e-10)


@pytest.mark.parametrize("name", ["fit", "fit_fused"])
def test_fit_matches_reference(name):
  ref_X, ref_y, X, y = _data()
  want = getattr(ref_logreg, name)(ref_X, ref_y, STEPS, alpha=ALPHA).glom()
  got = getattr(logistic_reg, name)(X, y, STEPS, alpha=ALPHA).glom()
  assert got.dtype == np.float64
  np.testing.assert_allclose(got, want, rtol=1e-10)


def test_fit_fused_equals_fit_and_a_numpy_loop():
  _, _, X, y = _data()
  Xh, yh = X.glom(), y.glom()
  w = np.zeros(D)
  for _ in range(STEPS):
    w = w - ALPHA * (Xh.T @ (1.0 / (1.0 + np.exp(-(Xh @ w))) - yh)
                     * (1.0 / N))
  fused = logistic_reg.fit_fused(X, y, STEPS, alpha=ALPHA).glom()
  np.testing.assert_allclose(fused, w, rtol=1e-10)
  np.testing.assert_allclose(
      fused, logistic_reg.fit(X, y, STEPS, alpha=ALPHA).glom(), rtol=1e-12)


def test_predict_matches_reference():
  ref_X, ref_y, X, y = _data()
  w = ref_logreg.fit(ref_X, ref_y, STEPS, alpha=ALPHA).glom()
  want = np.asarray(ref_logreg.predict(ref_X, w).glom())
  got = logistic_reg.predict(X, np.asarray(w)).glom()
  assert got.dtype == np.bool_
  np.testing.assert_array_equal(got, want)


def test_run_matches_reference():
  w_ref, acc_ref = ref_logreg.run(n=1024, d=8, iterations=40)
  w, acc = logistic_reg.run(n=1024, d=8, iterations=40)
  np.testing.assert_allclose(w.glom(), w_ref.glom(), rtol=1e-10)
  assert acc == acc_ref and acc > 0.95
