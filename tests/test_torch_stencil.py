"""The port's stencil slice against the reference's, on the same seeded
inputs.

* ``StencilExpr`` (the shifted-add emission and the ``F.conv2d`` path),
  ``PoolExpr`` (the reshape fold and the windowed path, with XLA's
  asymmetric 'SAME' pads), ``ReshapeExpr`` and ``RavelExpr`` against
  ``spartan_tpu``'s exprs: float64, rtol 1e-10 (the same taps in the same
  order; conv and window sums in another order).
* K4's plain version (``stencil3x3_plain``) against the reference's
  ``stencil3x3``: aligned shapes in ``interpret=True``, ragged shapes
  through its XLA fallback.  K6a's plain version against the reference's
  ``stencil3x3_padded(..., interpret=True)`` at 64 x 256 over 1-4 steps
  with and without the add field, and a ragged 16 x 40 against its
  fallback.  float32: |port - reference| <= 2·(taps + 1)·2^-24 per step
  of the largest Σ|c·x| + |add|, grown by the gain Σ|c| of each later step
  (each side rounds every op in float32, and XLA's CPU compiler may fuse
  a multiply and add into one rounding).
* The wrappers on the CPU: the plain route, its count, and what they
  refuse.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spartan_tpu as ref
from spartan_tpu.backend.kernels import stencil_pallas as stp

import spartan_tpu_torch as sp
from spartan_tpu_torch.backend.kernels import stencil as K6
from spartan_tpu_torch.expr.reshape import RavelExpr, ReshapeExpr
from spartan_tpu_torch.expr.stencil import PoolExpr, StencilExpr

LAPLACIAN = (0.0, 1.0, 0.0, 1.0, -4.0, 1.0, 0.0, 1.0, 0.0)
NINE = (0.05, 0.1, 0.02, 0.1, 0.4, -0.1, 0.3, 0.1, 0.03)
HEAT = (0.0, 0.1, 0.0, 0.1, 0.6, 0.1, 0.0, 0.1, 0.0)


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


def close(got, want, rtol=1e-10):
  got, want = np.asarray(got), np.asarray(want)
  assert got.shape == want.shape and got.dtype == want.dtype
  np.testing.assert_allclose(got, want, rtol=rtol,
                             atol=rtol * max(np.abs(want).max(), 1e-30))


def both(build, *arrays):
  """``build(lib, *leaves)`` evaluated by the reference and the port."""
  want = build(ref, *[ref.from_numpy(a) for a in arrays]).glom()
  got = build(sp, *[sp.from_numpy(a) for a in arrays]).glom()
  return got, np.asarray(want)


# -- StencilExpr ------------------------------------------------------------------

@pytest.mark.parametrize("case", ["same", "stride2", "stride2_odd",
                                  "multichannel_valid", "one_in_many_out"])
def test_conv_path_matches_reference(case, rng):
  x_shape, w_shape, stride, pad = {
      "same": ((2, 3, 8, 8), (4, 3, 3, 3), 1, "SAME"),
      "stride2": ((1, 2, 8, 8), (3, 2, 3, 3), 2, "SAME"),
      "stride2_odd": ((2, 2, 9, 7), (3, 2, 4, 3), 2, "SAME"),
      "multichannel_valid": ((2, 3, 10, 9), (2, 3, 3, 2), 1, "VALID"),
      "one_in_many_out": ((3, 1, 12, 16), (8, 1, 3, 3), 1, "SAME")}[case]
  x, w = rng.standard_normal(x_shape), rng.standard_normal(w_shape)
  got, want = both(lambda lib, a, b: lib.stencil(a, b, stride=stride,
                                                 padding=pad), x, w)
  close(got, want)


@pytest.mark.parametrize("pad", ["SAME", "VALID"])
@pytest.mark.parametrize("kh, kw", [(3, 3), (2, 2), (5, 3), (1, 1), (4, 5),
                                    (7, 7)])
def test_single_channel_shifted_emission_matches_reference(kh, kw, pad, rng):
  x = rng.standard_normal((2, 1, 12, 16))
  w = rng.standard_normal((1, 1, kh, kw))
  got, want = both(lambda lib, a, b: lib.stencil(a, b, padding=pad), x, w)
  close(got, want)


def test_shifted_emission_is_taken_and_keeps_dtype(rng):
  x = rng.standard_normal((1, 1, 6, 5)).astype(np.float32)
  w = rng.standard_normal((1, 1, 3, 3))
  e = sp.stencil(sp.from_numpy(x), sp.from_numpy(w))
  assert isinstance(e, StencilExpr) and e.dtype == torch.float64
  got, want = both(lambda lib, a, b: lib.stencil(a, b), x, w)
  close(got, want)


def test_stencil_feeds_lazy_chain(rng):
  x = rng.standard_normal((1, 1, 8, 8))
  w = rng.standard_normal((1, 1, 3, 3))
  got, want = both(lambda lib, a, b: lib.maxpool(lib.stencil(a, b), 2).sum(),
                   x, w)
  close(got, want)


def test_stencil_refuses_other_padding(rng):
  with pytest.raises(ValueError, match="'SAME' or 'VALID'"):
    sp.stencil(sp.from_numpy(rng.standard_normal((1, 2, 4, 4))),
               sp.from_numpy(rng.standard_normal((1, 2, 3, 3))),
               padding=[(1, 1), (1, 1)]).glom()


# -- PoolExpr -----------------------------------------------------------------------

@pytest.mark.parametrize("op", ["max", "avg"])
@pytest.mark.parametrize("shape, pool, stride, pad", [
    ((2, 3, 8, 8), 2, None, "SAME"),        # the reshape fold
    ((1, 2, 4, 6), (2, 3), None, "VALID"),  # the fold, rectangular pools
    ((2, 2, 9, 7), 3, 2, "SAME"),           # windows, asymmetric pads
    ((1, 3, 7, 7), 2, None, "SAME"),        # non-dividing pool: windows
    ((2, 1, 9, 10), 3, 2, "VALID"),
    ((1, 2, 6, 5), 2, 1, "SAME"),           # overlapping windows
])
def test_pool_matches_reference(op, shape, pool, stride, pad, rng):
  x = rng.standard_normal(shape)
  fn = {"max": "maxpool", "avg": "avgpool"}[op]
  got, want = both(lambda lib, a: getattr(lib, fn)(a, pool, stride, pad), x)
  close(got, want)


@pytest.mark.parametrize("op", ["max", "avg"])
@pytest.mark.parametrize("pool, stride", [(2, None), (3, 2)])
def test_pool_of_integers_matches_reference(op, pool, stride, rng):
  x = rng.integers(-50, 50, (1, 2, 6, 7)).astype(np.int64)
  fn = {"max": "maxpool", "avg": "avgpool"}[op]
  got, want = both(lambda lib, a: getattr(lib, fn)(a, pool, stride), x)
  close(got, want)


def test_maxpool_pads_with_minus_infinity(rng):
  """All-negative inputs: a zero pad would win the max at the edges."""
  x = -1.0 - rng.random((1, 1, 5, 5))
  got, want = both(lambda lib, a: lib.maxpool(a, 2), x)
  assert isinstance(sp.maxpool(sp.from_numpy(x), 2), PoolExpr)
  assert (got < 0).all()
  close(got, want)


def test_pool_refuses_unknown_op(rng):
  with pytest.raises(ValueError, match="median"):
    PoolExpr(sp.from_numpy(rng.standard_normal((1, 1, 4, 4))),
             op="median").glom()


# -- ReshapeExpr and RavelExpr ----------------------------------------------------

@pytest.mark.parametrize("case", ["reshape", "minus_one", "method_tuple",
                                  "method_args", "ravel", "flatten",
                                  "chain", "of_transpose"])
def test_reshape_and_ravel_match_reference(case, rng):
  x = rng.standard_normal((4, 6, 5))
  build = {
      "reshape": lambda lib, a: lib.reshape(a, (8, 15)),
      "minus_one": lambda lib, a: lib.reshape(a, (-1, 10)),
      "method_tuple": lambda lib, a: a.reshape((2, 60)),
      "method_args": lambda lib, a: a.reshape(3, 40),
      "ravel": lambda lib, a: lib.ravel(a),
      "flatten": lambda lib, a: a.flatten(),
      "chain": lambda lib, a: (a * 2.0 + 1.0).reshape(24, 5).sum(axis=1),
      "of_transpose": lambda lib, a: a.transpose((2, 0, 1)).ravel(),
  }[case]
  got, want = both(build, x)
  close(got, want)


def test_reshape_nodes_and_shapes(rng):
  a = sp.from_numpy(rng.standard_normal((4, 6)))
  assert isinstance(sp.reshape(a, (3, 8)), ReshapeExpr)
  assert isinstance(sp.ravel(a), RavelExpr) and sp.flatten is sp.ravel
  assert sp.reshape(a, 24).shape == (24,)
  assert a.ravel().shape == (24,) and a.reshape(2, -1).shape == (2, 12)
  with pytest.raises(RuntimeError):
    sp.reshape(a, (5, 5)).shape


# -- K4 and K6a: the plain versions against the reference's kernels --------------

def _tap_bound(x, coeffs, steps=1, add=None):
  """2·(taps + 1)·2^-24 per step of the largest Σ|c·x| + |add| the steps
  reach, grown by the gain Σ|c| of the steps after it (float64 numpy)."""
  k = np.abs(np.asarray(coeffs)).reshape(3, 3)
  n, m = x.shape
  scale, worst = np.abs(x).astype(np.float64), 0.0
  for _ in range(steps):
    up = np.pad(scale, 1)
    scale = sum(k[di, dj] * up[di:di + n, dj:dj + m]
                for di in range(3) for dj in range(3))
    if add is not None:
      scale = scale + np.abs(add)
    worst = max(worst, float(scale.max()))
  taps = int((k != 0).sum())
  return (2 * (taps + 1) * 2.0 ** -24 * steps * worst
          * max(float(k.sum()), 1.0) ** (steps - 1))


@pytest.mark.parametrize("coeffs", [LAPLACIAN, NINE], ids=["laplacian",
                                                            "nine"])
@pytest.mark.parametrize("shape, interpret", [
    ((64, 256), True), ((16, 128), True),    # aligned: the Pallas kernel
    ((13, 20), False), ((1, 1), False),      # ragged: its XLA fallback
    ((3, 5), False)])
def test_k4_plain_matches_reference(shape, interpret, coeffs, rng):
  x = rng.standard_normal(shape).astype(np.float32)
  want = np.asarray(stp.stencil3x3(jnp.asarray(x), coeffs,
                                   interpret=interpret))
  got = K6.stencil3x3_plain(torch.from_numpy(x), coeffs)
  assert got.dtype == torch.float32 and got.shape == shape
  assert np.all(np.abs(got.numpy().astype(np.float64) - want)
                <= _tap_bound(x, coeffs))


def _padded_pair(rng, n, m, with_add):
  x = rng.standard_normal((n, m)).astype(np.float32)
  g = rng.standard_normal((n, m)).astype(np.float32) if with_add else None
  return x, g


@pytest.mark.parametrize("with_add", [False, True], ids=["no_add", "add"])
@pytest.mark.parametrize("steps", [1, 2, 3, 4])
def test_k6a_plain_matches_reference(steps, with_add, rng):
  n, m = 64, 256
  x, g = _padded_pair(rng, n, m, with_add)
  xp_ref = stp.to_padded(jnp.asarray(x))
  add_ref = stp.to_padded(jnp.asarray(g)) if with_add else None
  new_ref, buf_ref = stp.stencil3x3_padded(
      xp_ref, jnp.zeros_like(xp_ref), NINE, steps=steps, interpret=True,
      add=add_ref)
  xp = K6.to_padded(torch.from_numpy(x))
  add = K6.to_padded(torch.from_numpy(g)) if with_add else None
  new, buf = K6.stencil3x3_padded_plain(xp, torch.zeros_like(xp), NINE,
                                        steps=steps, add=add)
  bound = _tap_bound(x, NINE, steps, g)
  assert new.shape == K6.padded_shape(n, m)
  assert np.all(np.abs(K6.from_padded(new).numpy().astype(np.float64)
                       - np.asarray(stp.from_padded(new_ref))) <= bound)
  # the second buffer holds the state one step back, as the reference's
  if steps > 1:
    assert np.all(np.abs(K6.from_padded(buf).numpy().astype(np.float64)
                         - np.asarray(stp.from_padded(buf_ref))) <= bound)
  for state in (new, buf):
    ring = state.clone()
    ring[K6.PAD_R:-K6.PAD_R, K6.PAD_C:-K6.PAD_C] = 0
    assert not ring.any()


@pytest.mark.parametrize("with_add", [False, True], ids=["no_add", "add"])
def test_k6a_plain_matches_reference_fallback_on_ragged_shape(with_add, rng):
  x, g = _padded_pair(rng, 16, 40, with_add)
  xp_ref = stp.to_padded(jnp.asarray(x))
  new_ref, _ = stp.stencil3x3_padded(
      xp_ref, jnp.zeros_like(xp_ref), HEAT, steps=2, interpret=True,
      add=stp.to_padded(jnp.asarray(g)) if with_add else None)
  xp = K6.to_padded(torch.from_numpy(x))
  new, _ = K6.stencil3x3_padded_plain(
      xp, torch.zeros_like(xp), HEAT, steps=2,
      add=K6.to_padded(torch.from_numpy(g)) if with_add else None)
  assert np.all(np.abs(K6.from_padded(new).numpy().astype(np.float64)
                       - np.asarray(stp.from_padded(new_ref)))
                <= _tap_bound(x, HEAT, 2, g))


def test_padded_layout_matches_reference(rng):
  x = rng.standard_normal((13, 20)).astype(np.float32)
  assert K6.PAD_R == stp.PAD_R and K6.PAD_C == stp.PAD_C
  assert K6.padded_shape(13, 20) == tuple(stp.padded_shape(13, 20))
  xp = K6.to_padded(torch.from_numpy(x))
  np.testing.assert_array_equal(xp.numpy(),
                                np.asarray(stp.to_padded(jnp.asarray(x))))
  np.testing.assert_array_equal(K6.from_padded(xp).numpy(), x)


# -- the wrappers on the CPU -------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float64], ids=str)
def test_wrappers_run_their_plain_versions_on_cpu(dtype, rng):
  x = torch.from_numpy(rng.standard_normal((13, 20))).to(dtype)
  before = dict(K6.counts)
  got = K6.stencil3x3(x, NINE)
  torch.testing.assert_close(got, K6.stencil3x3_plain(x, NINE), rtol=0,
                             atol=0)
  xp = K6.to_padded(x)
  add = K6.to_padded(x * 0.5)
  state, buf = xp.clone(), torch.zeros_like(xp)
  new, old = K6.stencil3x3_padded(state, buf, HEAT, steps=3, add=add)
  want, _ = K6.stencil3x3_padded_plain(xp.clone(), torch.zeros_like(xp),
                                       HEAT, steps=3, add=add)
  torch.testing.assert_close(new, want, rtol=0, atol=0)
  assert new is buf and old is state and new.dtype == dtype
  assert K6.counts == dict(before, plain_runs=before["plain_runs"] + 2)


def test_padded_wrapper_writes_buf_in_place_and_ping_pongs():
  x = torch.arange(12.0).reshape(3, 4)
  xp, buf = K6.to_padded(x), torch.zeros(K6.padded_shape(3, 4))
  new, old = K6.stencil3x3_padded(xp, buf, HEAT, steps=1)
  assert new is buf and old is xp
  new2, old2 = K6.stencil3x3_padded(new, old, HEAT, steps=2)
  assert new2 is buf and old2 is xp
  same, other = K6.stencil3x3_padded(xp, buf, HEAT, steps=0)
  assert same is xp and other is buf


def test_zero_taps_are_skipped():
  """A 0.0 tap adds nothing, not 0·x: an infinite neighbour stays out."""
  x = torch.zeros(3, 3)
  x[0, 0] = float("inf")
  got = K6.stencil3x3(x, LAPLACIAN)
  assert torch.isinf(got[0, 0]) and got[1, 1] == 0
  assert torch.isinf(got[0, 1])  # reached through a nonzero tap
  xp = K6.to_padded(x)
  new, _ = K6.stencil3x3_padded(xp, torch.zeros_like(xp), LAPLACIAN)
  assert K6.from_padded(new)[1, 1] == 0


def test_wrappers_refuse_what_the_kernels_do_not_take():
  x = torch.ones(4, 5)
  xp = K6.to_padded(x)
  with pytest.raises(ValueError, match="9 coefficients"):
    K6.stencil3x3(x, (1.0, 2.0))
  with pytest.raises(ValueError, match=r"\(n, m\) array"):
    K6.stencil3x3(torch.ones(2, 3, 4), NINE)
  with pytest.raises(TypeError, match="float arrays"):
    K6.stencil3x3(x.long(), NINE)
  with pytest.raises(ValueError, match="padded"):
    K6.stencil3x3_padded(x, x.clone(), NINE)
  with pytest.raises(ValueError, match="match xp's shape"):
    K6.stencil3x3_padded(xp, torch.zeros(K6.padded_shape(4, 6)), NINE)
  with pytest.raises(ValueError, match="match xp's shape"):
    K6.stencil3x3_padded(xp, torch.zeros_like(xp), NINE,
                         add=xp.double())
  with pytest.raises(ValueError, match="distinct buffers"):
    K6.stencil3x3_padded(xp, xp, NINE)
  with pytest.raises(ValueError, match="distinct buffers"):
    buf = torch.zeros_like(xp)
    K6.stencil3x3_padded(xp, buf, NINE, add=buf)
  with pytest.raises(ValueError, match="steps"):
    K6.stencil3x3_padded(xp, torch.zeros_like(xp), NINE, steps=-1)
