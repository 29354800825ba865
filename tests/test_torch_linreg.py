"""The linear-regression training loop (config 3's shape) in both
packages, from the same seeded data and the same initial weights, at rtol
1e-10 in float64."""

import numpy as np
import pytest
import torch

import spartan_tpu as ref
from spartan_tpu.examples import linear_reg as ref_linreg

import spartan_tpu_torch as sp
from spartan_tpu_torch.examples import linear_reg

N, D, STEPS, ALPHA = 512, 8, 5, 0.05


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


def _data(dtype=np.float64):
  rng = np.random.default_rng(21)
  X = rng.standard_normal((N, D)).astype(dtype)
  y = (X @ rng.standard_normal(D) + 0.01 * rng.standard_normal(N)).astype(
      dtype)
  return X, y


def _numpy_fit(X, y, steps):
  w = np.zeros(X.shape[1])
  for _ in range(steps):
    w = w - ALPHA * (X.T @ (X @ w - y) * (2.0 / X.shape[0]))
  return w


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=str)
def test_fit_matches_reference(dtype):
  X, y = _data(dtype)
  ref_X, ref_y = ref.from_numpy(X), ref.from_numpy(y)
  want = ref_linreg.fit(ref_X, ref_y, STEPS, ALPHA).glom()
  X_p, y_p = sp.interop.from_reference([ref_X, ref_y])
  got = linear_reg.fit(X_p, y_p, STEPS, ALPHA).glom()
  assert got.dtype == np.asarray(want).dtype == np.float64
  np.testing.assert_allclose(got, want, rtol=1e-10)


def test_fit_matches_numpy_loop():
  X, y = _data()
  got = linear_reg.fit(sp.from_numpy(X), sp.from_numpy(y), STEPS, ALPHA)
  np.testing.assert_allclose(got.glom(), _numpy_fit(X, y, STEPS), rtol=1e-10)


def test_make_fori_equals_fit():
  X, y = _data()
  Xp, yp = sp.from_numpy(X), sp.from_numpy(y)
  run = sp.make_fori(lambda w: linear_reg.gradient_step(Xp, yp, w, ALPHA),
                     sp.zeros((D,)))
  np.testing.assert_allclose(run(STEPS).glom(),
                             linear_reg.fit(Xp, yp, STEPS, ALPHA).glom(),
                             rtol=1e-12)
  # the count is a runtime argument: one step build serves any n
  np.testing.assert_allclose(run(STEPS + 2).glom(),
                             _numpy_fit(X, y, STEPS + 2), rtol=1e-10)


def test_fori_loop_from_reference_weights():
  """Initial weights carried over from the reference continue the same
  trajectory in the port."""
  X, y = _data()
  ref_X, ref_y = ref.from_numpy(X), ref.from_numpy(y)
  w2 = ref_linreg.fit(ref_X, ref_y, 2, ALPHA)
  want = ref.fori_loop(
      3, lambda w: ref_linreg.gradient_step(ref_X, ref_y, w, ALPHA), w2).glom()
  Xp, yp, w2p = sp.interop.from_reference([ref_X, ref_y, w2])
  got = sp.fori_loop(
      3, lambda w: linear_reg.gradient_step(Xp, yp, w, ALPHA), w2p).glom()
  np.testing.assert_allclose(got, want, rtol=1e-10)


def test_loop_carry_must_keep_dtype():
  Xp = sp.from_numpy(_data()[0].astype(np.float32))
  with pytest.raises(ValueError, match="shape and dtype"):
    sp.make_fori(lambda w: sp.dot(Xp.T, sp.dot(Xp, w)) * 1.0,
                 sp.zeros((D,), dtype=np.float32) + 0)


def test_run_matches_reference():
  """``run`` fits the seeded data of ``make_data`` in both packages."""
  want_w, want_true = ref_linreg.run(n=512, d=8, iterations=20)
  got_w, got_true = linear_reg.run(n=512, d=8, iterations=20)
  np.testing.assert_array_equal(got_true, want_true)
  np.testing.assert_allclose(got_w.glom(), np.asarray(want_w.glom()),
                             rtol=1e-10)
