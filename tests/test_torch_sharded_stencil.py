"""The halo rows of K6b and the row-band sharded stencil, against the
reference's ``stencil3x3_padded(..., top=, bot=)`` and
``stencil3x3_padded_sharded`` (interpret mode on its virtual CPU devices),
case for case with tests/test_stencil.py:186-219.

Tolerances:
* The port's sharded sweeps equal its unsharded K6a sweeps bit for bit:
  the halo rows enter the taps at their place, so every output is the
  same sum in the same order.
* Against the reference in float32: |port - reference| <= 2·(taps + 1)·
  2^-24 per step of the largest Σ|c·x| + |add|, grown by the gain Σ|c| of
  each later step.  Each side rounds every op in float32; the reference
  adds the halo taps after the others (stencil_pallas.py:219-233, :338-346)
  and XLA's CPU compiler may fuse a multiply and an add.
* Against a float64 NumPy oracle: atol 1e-4, the reference's own bar.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spartan_tpu.backend.kernels import stencil_pallas as stp

import spartan_tpu_torch as sp
from spartan_tpu_torch.backend.kernels import stencil as K6

NINE = (0.05, 0.1, 0.02, 0.1, 0.4, 0.1, 0.0, 0.1, 0.03)
HEAT = (0.0, 0.1, 0.0, 0.1, 0.6, 0.1, 0.0, 0.1, 0.0)


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


def _tap_bound(x, coeffs, steps=1, add=None, edge=0.0):
  """2·(taps + 1)·2^-24 per step of the largest Σ|c·x| + |add| (+ the
  halo rows' largest |value| times Σ|c|), grown by the gain Σ|c| of the
  steps after it (float64 numpy)."""
  k = np.abs(np.asarray(coeffs)).reshape(3, 3)
  n, m = x.shape
  scale, worst = np.abs(x).astype(np.float64), 0.0
  for _ in range(steps):
    up = np.pad(scale, 1)
    scale = sum(k[di, dj] * up[di:di + n, dj:dj + m]
                for di in range(3) for dj in range(3))
    if add is not None:
      scale = scale + np.abs(add)
    worst = max(worst, float(scale.max()) + k.sum() * edge)
  taps = int((k != 0).sum())
  return (2 * (taps + 1) * 2.0 ** -24 * steps * worst
          * max(float(k.sum()), 1.0) ** (steps - 1))


def _numpy_sweeps(x, coeffs, steps, add=None):
  k = np.asarray(coeffs).reshape(3, 3)
  n, m = x.shape
  u = x.astype(np.float64)
  for _ in range(steps):
    up = np.pad(u, 1)
    u = sum(k[di, dj] * up[di:di + n, dj:dj + m]
            for di in range(3) for dj in range(3))
    if add is not None:
      u = u + add
  return u


@pytest.mark.parametrize("with_add", [False, True], ids=["no_add", "add"])
@pytest.mark.parametrize("n, m", [(64, 256), (16, 40)], ids=str)
def test_halo_rows_match_the_reference(n, m, with_add, rng):
  """One application with halo rows: aligned (the reference's kernel, in
  interpret mode) and ragged (its XLA fallback)."""
  x = rng.standard_normal((n, m)).astype(np.float32)
  g = rng.standard_normal((n, m)).astype(np.float32) if with_add else None
  C = m + 2 * K6.PAD_C
  top = rng.standard_normal(C).astype(np.float32)
  bot = rng.standard_normal(C).astype(np.float32)
  top[:K6.PAD_C] = top[-K6.PAD_C:] = bot[:K6.PAD_C] = bot[-K6.PAD_C:] = 0
  top8, bot8 = np.zeros((8, C), np.float32), np.zeros((8, C), np.float32)
  top8[7], bot8[0] = top, bot  # the reference's rows 7 and 0
  xp_ref = stp.to_padded(jnp.asarray(x))
  new_ref, _ = stp.stencil3x3_padded(
      xp_ref, jnp.zeros_like(xp_ref), NINE, steps=1, interpret=True,
      add=stp.to_padded(jnp.asarray(g)) if with_add else None,
      top=jnp.asarray(top8), bot=jnp.asarray(bot8))
  xp = K6.to_padded(torch.from_numpy(x))
  add = K6.to_padded(torch.from_numpy(g)) if with_add else None
  before = K6.counts["plain_runs"]
  new, buf = K6.stencil3x3_padded(xp, torch.zeros_like(xp), NINE, 1, add,
                                  torch.from_numpy(top), torch.from_numpy(bot))
  assert K6.counts["plain_runs"] == before + 1 and buf is xp
  got = K6.from_padded(new).numpy().astype(np.float64)
  want = np.asarray(stp.from_padded(new_ref))
  edge = max(np.abs(top).max(), np.abs(bot).max())
  assert np.all(np.abs(got - want) <= _tap_bound(x, NINE, 1, g, edge))
  # the halo rows are the rows above and below: K6a on the stacked field
  tall = np.concatenate([top[None, K6.PAD_C:-K6.PAD_C], x,
                         bot[None, K6.PAD_C:-K6.PAD_C]])
  gt = None if g is None else np.pad(g, ((1, 1), (0, 0)))
  xt = K6.to_padded(torch.from_numpy(tall))
  whole, _ = K6.stencil3x3_padded(
      xt, torch.zeros_like(xt), NINE, 1,
      None if gt is None else K6.to_padded(torch.from_numpy(gt)))
  np.testing.assert_array_equal(got, K6.from_padded(whole)[1:-1].numpy())


def test_halo_rows_are_checked():
  xp = torch.zeros(K6.padded_shape(8, 8))
  row = torch.zeros(xp.shape[1])
  with pytest.raises(ValueError, match="together"):
    K6.stencil3x3_padded(xp, torch.zeros_like(xp), NINE, 1, top=row)
  with pytest.raises(ValueError, match="together"):
    K6.stencil3x3_padded(xp, torch.zeros_like(xp), NINE, 2, top=row, bot=row)
  with pytest.raises(ValueError, match="halo row"):
    K6.stencil3x3_padded(xp, torch.zeros_like(xp), NINE, 1, top=row[:-1],
                         bot=row)


def test_halo_pair_copies_edge_rows_with_zeros_at_the_ends():
  bands = [K6.to_padded(torch.full((3, 5), float(d + 1))) for d in range(3)]
  tops, bots = K6._halo_pair(bands)
  inner = slice(K6.PAD_C, K6.PAD_C + 5)
  assert not tops[0].any() and not bots[2].any()
  assert torch.equal(tops[1][inner], torch.full((5,), 1.0))
  assert torch.equal(tops[2][inner], torch.full((5,), 2.0))
  assert torch.equal(bots[0][inner], torch.full((5,), 2.0))
  assert torch.equal(bots[1][inner], torch.full((5,), 3.0))
  assert tops[1].data_ptr() != bands[0].data_ptr()  # copies, not views


@pytest.mark.parametrize("with_add, steps", [(False, 4), (True, 3)],
                         ids=["no_add", "add"])
@pytest.mark.parametrize("p", [1, 2, 3, 4, 8])
def test_sharded_sweeps_equal_unsharded_and_the_oracle(p, steps, with_add,
                                                       rng):
  """120 rows: even bands for every p, 3 included."""
  n, m = 120, 256
  x = rng.standard_normal((n, m)).astype(np.float32)
  g = rng.standard_normal((n, m)).astype(np.float32) if with_add else None
  gt = None if g is None else torch.from_numpy(g)
  whole = K6.stencil3x3_padded_sharded(torch.from_numpy(x), NINE, steps,
                                       sp.make_mesh("cpu", shape=(1,)), gt)
  before = K6.counts["plain_runs"]
  with sp.with_mesh(sp.make_mesh("cpu", shape=(p,))):
    got = K6.stencil3x3_padded_sharded(x, NINE, steps, add=g)
  assert K6.counts["plain_runs"] == before + (p * steps if p > 1 else 1)
  assert got.shape == (n, m) and got.dtype == torch.float32
  assert torch.equal(got, whole)
  np.testing.assert_allclose(got.numpy(), _numpy_sweeps(x, NINE, steps, g),
                             atol=1e-4)


@pytest.mark.parametrize("with_add, steps", [(False, 4), (True, 3)],
                         ids=["no_add", "add"])
def test_sharded_sweeps_match_the_reference(steps, with_add, rng, cluster):
  """tests/test_stencil.py's case: 128 x 256, the reference on its 8-device
  mesh, the port on 8 shards."""
  n, m = 128, 256
  x = rng.standard_normal((n, m)).astype(np.float32)
  g = rng.standard_normal((n, m)).astype(np.float32) if with_add else None
  want = np.asarray(stp.stencil3x3_padded_sharded(
      x, NINE, steps=steps, interpret=True, add=g))
  got = K6.stencil3x3_padded_sharded(
      x, NINE, steps, sp.make_mesh("cpu", shape=(8,)), g)
  assert np.all(np.abs(got.numpy().astype(np.float64) - want)
                <= _tap_bound(x, NINE, steps, g))


def test_a_ragged_band_raises_as_the_reference_does(rng, cluster):
  x = rng.standard_normal((128, 256)).astype(np.float32)
  with pytest.raises(ValueError):
    stp.stencil3x3_padded_sharded(x[:100], NINE, interpret=True)
  with pytest.raises(ValueError, match="n % 8 == 0"):
    K6.stencil3x3_padded_sharded(x[:100], NINE, 1,
                                 sp.make_mesh("cpu", shape=(8,)))
  # the TPU's 8-row and 128-column factors are not asked for
  odd = K6.stencil3x3_padded_sharded(x[:99, :200], HEAT, 2,
                                     sp.make_mesh("cpu", shape=(3,)))
  np.testing.assert_allclose(odd.numpy(), _numpy_sweeps(x[:99, :200], HEAT,
                                                        2), atol=1e-5)
