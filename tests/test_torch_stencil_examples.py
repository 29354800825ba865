"""The port's stencil examples against the reference's, on the same seeded
inputs: ``heat.simulate``/``heat.run`` (the expression path: ``make_fori``
over ``StencilExpr`` and ``ReshapeExpr``), ``heat.simulate_padded`` and
``poisson.solve_jacobi`` (K6a's plain version on the CPU against the
reference's Pallas kernel in ``interpret=True``), ``convnet`` (forward and
predict), and ``interop.from_reference_padded``.

Tolerances: float64 paths rtol 1e-10 of the largest entry (the same taps
in the same order; convolution sums in another order).  float32 padded
sweeps: 2·(taps + 1)·2^-24·max|u| per sweep, summed over the sweeps: both
sides round every op in float32 (XLA's CPU compiler may fuse a multiply
and add into one rounding), and both operators have gain Σ|c| = 1, so the
differences do not grow between sweeps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spartan_tpu as ref
from spartan_tpu.backend.kernels import stencil_pallas as stp
from spartan_tpu.examples import convnet as ref_convnet
from spartan_tpu.examples import heat as ref_heat
from spartan_tpu.examples import poisson as ref_poisson

import spartan_tpu_torch as sp
from spartan_tpu_torch import interop
from spartan_tpu_torch.backend.kernels import stencil as K6
from spartan_tpu_torch.examples import convnet, heat, poisson


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


def close(got, want, rtol=1e-10):
  got, want = np.asarray(got), np.asarray(want)
  assert got.shape == want.shape and got.dtype == want.dtype
  np.testing.assert_allclose(got, want, rtol=0,
                             atol=rtol * max(np.abs(want).max(), 1e-30))


def hot_spots(n, m, seed):
  rng = np.random.default_rng(seed)
  u0 = np.zeros((n, m), np.float32)
  for _ in range(6):
    u0[rng.integers(8, n - 8), rng.integers(8, m - 8)] = 100.0
  return u0


@pytest.mark.parametrize("alpha", [0.1, 0.25])
def test_heat_simulate_matches_reference(alpha):
  u0 = np.random.default_rng(1).random((24, 40))
  want = np.asarray(ref_heat.simulate(u0, iters=15, alpha=alpha).glom())
  before = dict(K6.counts)
  got = heat.simulate(u0, iters=15, alpha=alpha).glom()
  assert K6.counts == before  # the expression path runs no stencil kernel
  close(got, want)
  close(got, heat.simulate_numpy(u0, iters=15, alpha=alpha))


def test_heat_run_matches_reference():
  err, total = heat.run(n=48, iters=40, seed=3)
  err_ref, total_ref = ref_heat.run(n=48, iters=40, seed=3)
  assert err <= 1e-10 * 100 and err_ref <= 1e-10 * 100
  np.testing.assert_allclose(total, total_ref, rtol=1e-12)


def test_heat_step_is_a_stencil_of_a_reshape():
  from spartan_tpu_torch.expr.reshape import ReshapeExpr
  from spartan_tpu_torch.expr.stencil import StencilExpr
  e = heat.step(sp.from_numpy(np.ones((5, 6))))
  kinds = set()
  e.visit(lambda node: kinds.add(type(node)))
  assert isinstance(e, ReshapeExpr) and StencilExpr in kinds
  assert e.shape == (5, 6)


def test_heat_simulate_padded_matches_reference():
  u0 = hot_spots(64, 256, seed=0)
  want = ref_heat.simulate_padded(u0, iters=25, alpha=0.1, unroll=7,
                                  interpret=True)
  before = dict(K6.counts)
  got = heat.simulate_padded(u0, iters=25, alpha=0.1, unroll=7)
  # 25 sweeps in chunks of 7: four wrapper calls, all plain on the CPU
  assert K6.counts == dict(before, plain_runs=before["plain_runs"] + 4)
  assert got.dtype == np.float32 and got.shape == (64, 256)
  tol = 25 * 2 * 6 * 2.0 ** -24 * 100.0
  assert np.abs(got.astype(np.float64) - want).max() <= tol
  np.testing.assert_allclose(got, heat.simulate_numpy(u0, 25), atol=2e-3)


def test_poisson_solve_jacobi_matches_reference():
  f = np.random.default_rng(3).standard_normal((64, 256)).astype(np.float32)
  want = ref_poisson.solve_jacobi(f, iters=30, unroll=7, interpret=True)
  got = poisson.solve_jacobi(f, iters=30, unroll=7)
  assert got.dtype == np.float32 and got.shape == (64, 256)
  oracle = poisson.solve_jacobi_numpy(f, iters=30)
  np.testing.assert_array_equal(oracle,
                                ref_poisson.solve_jacobi_numpy(f, iters=30))
  # |u| stays below sweeps · max|h²f/4|; add field plus four taps a sweep
  scale = np.abs(oracle).max() + 0.25 * np.abs(f).max()
  tol = 30 * 2 * 5 * 2.0 ** -24 * scale
  assert np.abs(got.astype(np.float64) - want).max() <= tol
  np.testing.assert_allclose(got, oracle, atol=2e-4)


def test_padded_examples_take_tensors_on_the_mesh_device():
  u0 = hot_spots(24, 40, seed=5)
  from_numpy = heat.simulate_padded(u0, iters=5, unroll=2)
  np.testing.assert_array_equal(
      heat.simulate_padded(torch.from_numpy(u0), iters=5, unroll=2),
      from_numpy)
  np.testing.assert_array_equal(
      poisson.solve_jacobi(torch.from_numpy(u0).double(), iters=3),
      poisson.solve_jacobi(u0, iters=3))


def test_convnet_run_matches_reference():
  logits, params, images = convnet.run(n=8)
  logits_ref, params_ref, images_ref = ref_convnet.run(n=8)
  np.testing.assert_array_equal(images, images_ref)
  for k in params_ref:
    np.testing.assert_array_equal(params[k], params_ref[k])
  assert logits.shape == (8, 10) and logits.dtype == torch.float64
  close(logits.glom(), np.asarray(logits_ref.glom()))


def test_convnet_predict_matches_reference():
  rng = np.random.default_rng(4)
  images = rng.random((12, 1, 16, 16))
  params = convnet.init_params(img=16, seed=2)
  got = convnet.predict(sp.from_numpy(images), params).glom()
  want = np.asarray(ref_convnet.predict(ref.from_numpy(images),
                                        params).glom())
  np.testing.assert_array_equal(got, want)
  np.testing.assert_array_equal(
      got, convnet.forward(sp.from_numpy(images), params).glom().argmax(1))


def test_from_reference_padded():
  x = np.random.default_rng(6).standard_normal((13, 20)).astype(np.float32)
  xp_ref = stp.to_padded(jnp.asarray(x))
  xp = interop.from_reference_padded(xp_ref)
  assert isinstance(xp, torch.Tensor) and xp.dtype == torch.float32
  assert tuple(xp.shape) == K6.padded_shape(13, 20)
  np.testing.assert_array_equal(K6.from_padded(xp).numpy(), x)
  # the carried state steps on as the reference's does
  new, _ = K6.stencil3x3_padded(xp, torch.zeros_like(xp),
                                (0.0, 0.2, 0.0, 0.2, 0.2, 0.2, 0.0, 0.2, 0.0))
  new_ref, _ = stp.stencil3x3_padded(
      xp_ref, jnp.zeros_like(xp_ref),
      (0.0, 0.2, 0.0, 0.2, 0.2, 0.2, 0.0, 0.2, 0.0))
  np.testing.assert_allclose(new.numpy(), np.asarray(new_ref), rtol=0,
                             atol=2 * 6 * 2.0 ** -24 * np.abs(x).max())
  ringed = np.asarray(xp_ref).copy()
  ringed[0, 0] = 1.0
  with pytest.raises(ValueError, match="ring is not zero"):
    interop.from_reference_padded(ringed)
  with pytest.raises(ValueError, match="padded state"):
    interop.from_reference_padded(x)
