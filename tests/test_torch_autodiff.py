"""The port's autodiff bridge (``spartan_tpu_torch/autodiff.py``,
``expr/remat.py``) against the reference's on the same seeded inputs: the
counterparts of the reference's ``tests/test_autodiff.py``, of its
``sgd_train`` test (``tests/test_loop.py``), of the gradients through the
stencil (``tests/test_stencil.py``), the SpMV and SpMM routes
(``tests/test_sparse.py``) and ``expm`` (``tests/test_scipy_linalg.py``),
of convnet's training (``tests/test_examples.py``), and
``linear_reg.fit_fused``; then every kernel wrapper's refusal of a tensor
that requires grad.

Tolerances: exact-arithmetic gradients (``2x``, ``b + 1``, ``A + Aᵀ``) at
the reference tests' 1e-12; float64 gradients and Hessians that sum in
another order than the reference at rtol 1e-10 (a few dozen terms of unit
size); the SpMV/SpMM gradients, float32 on float32 data, at the reference
tests' relative 1e-5/1e-6 of max|g| (float32's 6e-8 a product, summed over
up to a few dozen nonzeros a row); ``minimize`` held as the reference
test holds it, to scipy's BFGS optimum at atol 5e-4 and a loss no worse
than scipy's plus 1e-10, and to the reference's polished optimum at 1e-8
(both end in Newton steps on the same function); the convnet loss curves
of ``train`` and ``fit_fused`` at the reference test's rtol 1e-8, and the
port's against the reference's at rtol 1e-10 (float64 convolutions summed
in another order, over four SGD steps).
"""

import numpy as np
import pytest
import scipy.sparse as ss
import torch

import spartan_tpu as ref
from spartan_tpu.backend import sparse as ref_sps
from spartan_tpu.config import FLAGS as REF_FLAGS
from spartan_tpu.examples import convnet as ref_convnet

import spartan_tpu_torch as sp
from spartan_tpu_torch import autodiff
from spartan_tpu_torch.backend import evaluator
from spartan_tpu_torch.backend import sparse as sps
from spartan_tpu_torch.backend.kernels import build
from spartan_tpu_torch.backend.kernels import fused_reduce as K1
from spartan_tpu_torch.backend.kernels import matmul as K2
from spartan_tpu_torch.backend.kernels import spmm as K5
from spartan_tpu_torch.backend.kernels import spmv as KS
from spartan_tpu_torch.backend.kernels import stencil as KST
from spartan_tpu_torch.config import FLAGS
from spartan_tpu_torch.examples import convnet, linear_reg


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


@pytest.fixture
def flags():
  """Set a flag in both packages; restored afterwards."""
  saved = []

  def set_(name, value):
    saved.append((name, getattr(FLAGS, name), getattr(REF_FLAGS, name)))
    setattr(FLAGS, name, value)
    setattr(REF_FLAGS, name, value)

  yield set_
  for name, port_v, ref_v in reversed(saved):
    setattr(FLAGS, name, port_v)
    setattr(REF_FLAGS, name, ref_v)


def _np(a):
  return np.asarray(a.glom())


def _both(fn):
  """``fn(pkg)`` on the port and on the reference: a list of arrays (or
  one array) each, as numpy."""
  out = []
  for pkg in (sp, ref):
    r = fn(pkg)
    out.append([_np(a) for a in r] if isinstance(r, (list, tuple))
               else _np(r))
  return out


# -- tests/test_autodiff.py ----------------------------------------------------

def test_grad_quadratic(rng):
  x_np = rng.standard_normal((8, 8))
  got, want = _both(lambda pkg: (lambda x: pkg.grad(pkg.sum(x * x), [x]))(
      pkg.from_numpy(x_np)))
  np.testing.assert_allclose(got[0], 2 * x_np, atol=1e-12)
  np.testing.assert_allclose(got[0], want[0], atol=1e-12)


def test_grad_matches_manual_linreg(rng):
  X_np = rng.standard_normal((64, 5))
  y_np = rng.standard_normal(64)
  w_np = rng.standard_normal(5)

  def run(pkg):
    X, y, w = (pkg.from_numpy(a) for a in (X_np, y_np, w_np))
    return pkg.grad(pkg.sum((pkg.dot(X, w) - y) ** 2) / 64.0, [w])

  (got,), (want,) = _both(run)
  manual = 2.0 / 64 * X_np.T @ (X_np @ w_np - y_np)
  np.testing.assert_allclose(got, manual, atol=1e-10)
  np.testing.assert_allclose(got, want, rtol=1e-10)


def test_value_and_grad(rng):
  x_np = rng.standard_normal(10)
  x = sp.from_numpy(x_np)
  v, (g,) = sp.value_and_grad(sp.sum(sp.exp(x)), [x])
  np.testing.assert_allclose(_np(v), np.exp(x_np).sum(), rtol=1e-12)
  np.testing.assert_allclose(_np(g), np.exp(x_np), rtol=1e-12)
  rx = ref.from_numpy(x_np)
  rv, (rg,) = ref.value_and_grad(ref.sum(ref.exp(rx)), [rx])
  np.testing.assert_allclose(_np(v), _np(rv), rtol=1e-12)
  np.testing.assert_allclose(_np(g), _np(rg), rtol=1e-12)


def test_grad_multiple_wrt(rng):
  a_np, b_np = rng.standard_normal(6), rng.standard_normal(6)

  def run(pkg):
    a, b = pkg.from_numpy(a_np), pkg.from_numpy(b_np)
    return pkg.grad(pkg.sum(a * b + a), [a, b])

  (ga, gb), want = _both(run)
  np.testing.assert_allclose(ga, b_np + 1, atol=1e-12)
  np.testing.assert_allclose(gb, a_np, atol=1e-12)
  np.testing.assert_allclose(ga, want[0], atol=1e-12)
  np.testing.assert_allclose(gb, want[1], atol=1e-12)


def test_jvp(rng):
  x_np = rng.standard_normal(7)
  t_np = rng.standard_normal(7)
  (pg, tg), (pw, tw) = _both(lambda pkg: (lambda x: pkg.jvp(
      pkg.sum(x ** 2), [x], [t_np]))(pkg.from_numpy(x_np)))
  np.testing.assert_allclose(tg, 2 * (x_np * t_np).sum(), rtol=1e-10)
  np.testing.assert_allclose(tg, tw, rtol=1e-12)
  np.testing.assert_allclose(pg, pw, rtol=1e-12)


def test_jvp_of_a_vector_output(rng):
  """jvp of a non-scalar DAG: the directional derivative has the output's
  shape (the double-vjp identity works for any output)."""
  x_np, t_np = rng.standard_normal(5), rng.standard_normal(5)
  (pg, tg), (pw, tw) = _both(lambda pkg: (lambda x: pkg.jvp(
      pkg.sin(x) * x, [x], [t_np]))(pkg.from_numpy(x_np)))
  np.testing.assert_allclose(tg, (np.cos(x_np) * x_np + np.sin(x_np)) * t_np,
                             rtol=1e-12)
  np.testing.assert_allclose(tg, tw, rtol=1e-12)
  np.testing.assert_allclose(pg, pw, rtol=1e-15)


def test_wrt_not_in_dag_raises(rng):
  x = sp.from_numpy(rng.standard_normal(4))
  other = sp.from_numpy(rng.standard_normal(4))
  with pytest.raises(ValueError, match="not found in the DAG"):
    sp.grad(sp.sum(x), [other])


def test_wrt_must_be_val(rng):
  x = sp.from_numpy(rng.standard_normal(4))
  e = x * 2.0
  with pytest.raises(TypeError, match="Val leaves"):
    sp.grad(sp.sum(e), [e])


def test_grad_of_a_non_scalar_raises(rng):
  x = sp.from_numpy(rng.standard_normal(4))
  with pytest.raises(TypeError, match="scalar"):
    sp.grad(x * 2.0, [x])


def test_grad_through_fused_chain(rng):
  """The gradient flows through map-map and reduce fusion."""
  x_np = rng.standard_normal((8, 8))
  (got,), (want,) = _both(lambda pkg: (lambda x: pkg.grad(
      ((x + 1.0) * (x - 2.0)).sum(), [x]))(pkg.from_numpy(x_np)))
  np.testing.assert_allclose(got, 2 * x_np - 1.0, atol=1e-12)
  np.testing.assert_allclose(got, want, atol=1e-12)


def test_grad_of_a_constant_is_zero(rng):
  x = sp.from_numpy(rng.standard_normal(4))
  y = sp.from_numpy(rng.standard_normal(4))
  (g,) = sp.grad(sp.sum(y) + 0.0 * sp.sum(x), [x])
  np.testing.assert_array_equal(_np(g), np.zeros(4))


def test_remat_preserves_value_and_grad(rng):
  """sp.remat: the same forward value; the gradient flows (recomputed)."""
  x_np = rng.standard_normal((16, 16))

  def run(pkg):
    plain = pkg.sum(pkg.exp(pkg.from_numpy(x_np)) * 2.0)
    re = pkg.sum(pkg.remat(pkg.exp(pkg.from_numpy(x_np)) * 2.0))
    x2 = pkg.from_numpy(x_np)
    (g,) = pkg.grad(pkg.sum(pkg.remat(pkg.exp(x2) * 2.0)), [x2])
    return [plain, re, g]

  (plain, re, g), want = _both(run)
  np.testing.assert_allclose(re, plain, rtol=1e-12)
  np.testing.assert_allclose(g, 2 * np.exp(x_np), rtol=1e-12)
  for got_a, want_a in zip((plain, re, g), want):
    np.testing.assert_allclose(got_a, want_a, rtol=1e-12)


def test_remat_through_the_region_cache(rng):
  """A remat node keeps its sub-DAG's leaves through leaf stripping: a
  second DAG of the same structure over other leaves reuses the region's
  runner (the fast lane) and gets its own values; an aval is keyed by
  the sub-DAG's structure."""
  a_np, b_np = rng.standard_normal(6), rng.standard_normal(6)
  first = sp.remat(sp.exp(sp.from_numpy(a_np)) * 2.0) + 1.0
  np.testing.assert_allclose(_np(first), 2 * np.exp(a_np) + 1, rtol=1e-15)
  hits = evaluator.stats["fast_hits"]
  second = sp.remat(sp.exp(sp.from_numpy(b_np)) * 2.0) + 1.0
  np.testing.assert_allclose(_np(second), 2 * np.exp(b_np) + 1, rtol=1e-15)
  assert evaluator.stats["fast_hits"] == hits + 1
  shared = sp.from_numpy(a_np)
  both = sp.remat(shared * 3.0) + shared   # a leaf inside and outside
  np.testing.assert_allclose(_np(both), 4 * a_np, rtol=1e-15)
  wide = sp.remat(sp.ones((3, 4)) * 2.0)
  assert wide.shape == (3, 4)
  assert sp.remat(sp.from_numpy(a_np)[:2]).shape == (2,)


def test_remat_leaves_no_tensor_in_a_cycle(rng):
  """The checkpoint stops a remat region's recompute early by raising
  inside its emitter; none of the recomputed tensors may be left in a
  reference cycle (which held three convnet steps' activations on the
  card until a garbage collection)."""
  import gc
  x = sp.from_numpy(rng.standard_normal((2, 1, 8, 8)))
  w = sp.from_numpy(rng.standard_normal((4, 1, 3, 3)))
  loss = sp.sum(sp.remat(sp.maxpool(convnet.relu(sp.stencil(x, w)), 2)) ** 2)
  fn, args = autodiff.as_function(loss, [x, w], differentiable=True)
  leaves = [a.detach().requires_grad_() for a in args]
  gc.collect()
  gc.disable()
  gc.set_debug(gc.DEBUG_SAVEALL)
  try:
    torch.autograd.grad(fn(*leaves), leaves)
    gc.collect()
    cyclic = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
  finally:
    gc.set_debug(0)
    gc.garbage.clear()
    gc.enable()
  assert not cyclic


def test_compile_serving_entry(rng):
  """sp.compile: lowered once, called many times with fresh data."""
  x_np = rng.standard_normal((16, 8))
  w_np = rng.standard_normal(8)
  x, w = sp.from_numpy(x_np), sp.from_numpy(w_np)
  f = sp.compile(sp.tanh(sp.dot(x, w)), wrt=[x])
  rx = ref.from_numpy(x_np)
  rf = ref.compile(ref.tanh(ref.dot(rx, ref.from_numpy(w_np))), wrt=[rx])
  for _ in range(5):
    fresh = rng.standard_normal((16, 8))
    out = f(fresh)
    assert isinstance(out, sp.SpartanArray)
    np.testing.assert_allclose(_np(out), np.tanh(fresh @ w_np), rtol=1e-12)
    np.testing.assert_allclose(_np(out), _np(rf(fresh)), rtol=1e-12)
  with pytest.raises(ValueError, match="shape"):
    f(rng.standard_normal((4, 8)))
  with pytest.raises(TypeError, match="argument"):
    f()


def test_compile_launches_the_kernel_route():
  """A compiled call emits without autograd, so a float32 full sum takes
  K1's wrapper (its plain version on the CPU), once a call."""
  b_np = np.random.default_rng(1).standard_normal((64, 48)).astype(
      np.float32)
  b = sp.from_numpy(b_np)
  f = sp.compile(sp.sum(sp.abs(1 + 2 * b)), wrt=[b])
  K1.reset_counts()
  for k in range(3):
    fresh = b_np + k
    np.testing.assert_allclose(
        float(_np(f(fresh))), np.abs(1 + 2 * fresh.astype(np.float64)).sum(),
        rtol=1e-5)
  assert K1.counts["plain_runs"] == 3
  K1.reset_counts()
  sp.grad(sp.sum(sp.abs(1 + 2 * b)), [b])
  assert K1.counts["plain_runs"] == 0   # the gradient takes torch.sum


def test_compile_container_outputs(rng):
  x_np = rng.standard_normal((8, 4))
  x = sp.from_numpy(x_np)
  f = sp.compile(sp.ListExpr([sp.sum(x, axis=0), sp.max(x)]), wrt=[x])
  fresh = rng.standard_normal((8, 4))
  s, m = f(fresh)
  np.testing.assert_allclose(_np(s), fresh.sum(0), atol=1e-12)
  assert float(m.glom()) == fresh.max()
  d = sp.compile(sp.DictExpr({"s": sp.sum(x), "x2": x * 2.0}), wrt=[x])(
      fresh)
  assert set(d) == {"s", "x2"}
  np.testing.assert_allclose(_np(d["x2"]), 2 * fresh, rtol=0)


def test_compile_donated_carry(rng):
  """sp.compile(donate=...): accepted, the state = f(state) pattern stays
  exact and the template leaf survives (torch donates nothing)."""
  w_np = rng.standard_normal(64)
  w = sp.from_numpy(w_np)
  step = sp.compile(0.5 * w + 1.0, wrt=[w], donate=[0])
  state, want = step(w_np), 0.5 * w_np + 1.0
  for _ in range(3):
    want = 0.5 * want + 1.0
    state = step(state)
  np.testing.assert_allclose(_np(state), want, rtol=1e-12)
  np.testing.assert_allclose(_np(sp.lazify(w)), w_np, rtol=1e-15)


def test_hessian_quadratic(rng):
  """The Hessian of a quadratic form is A + Aᵀ (exact)."""
  a = rng.standard_normal((6, 6))
  w_np = rng.standard_normal(6)

  def run(pkg):
    w = pkg.from_numpy(w_np)
    return pkg.hessian(pkg.sum(w * pkg.dot(pkg.from_numpy(a), w)), [w])

  got, want = _both(run)
  np.testing.assert_allclose(got, a + a.T, rtol=1e-10, atol=1e-12)
  np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


def test_hessian_of_several_leaves(rng):
  """Several leaves give the list of diagonal blocks, each S + S."""
  a_np, b_np = rng.standard_normal(3), rng.standard_normal((2, 2))

  def run(pkg):
    a, b = pkg.from_numpy(a_np), pkg.from_numpy(b_np)
    return pkg.hessian(pkg.sum(a ** 3) + pkg.sum(b * b) * pkg.sum(a), [a, b])

  (ha, hb), (wa, wb) = _both(run)
  assert ha.shape == (3, 3) and hb.shape == (2, 2, 2, 2)
  np.testing.assert_allclose(ha, np.diag(6 * a_np), rtol=1e-12)
  np.testing.assert_allclose(hb, 2 * a_np.sum() * np.eye(4).reshape(
      2, 2, 2, 2), rtol=1e-12)
  np.testing.assert_allclose(ha, wa, rtol=1e-12)
  np.testing.assert_allclose(hb, wb, rtol=1e-12)


def test_hvp_matches_full_hessian(rng):
  X = rng.standard_normal((64, 8))
  y = rng.standard_normal(64)
  w_np = rng.standard_normal(8)
  v = rng.standard_normal(8)

  def run(pkg):
    w = pkg.from_numpy(w_np)
    loss = pkg.sum((pkg.dot(pkg.from_numpy(X), w) - pkg.from_numpy(y)) ** 2)
    return pkg.hvp(loss, [w], [pkg.from_numpy(v)])

  (got,), (want,) = _both(run)
  np.testing.assert_allclose(got, 2.0 * X.T @ X @ v, rtol=1e-9)
  np.testing.assert_allclose(got, want, rtol=1e-10)


def _logreg(rng):
  X = rng.standard_normal((256, 5))
  w_true = rng.standard_normal(5)
  y = (X @ w_true + 0.3 * rng.standard_normal(256) > 0).astype(np.float64)
  return X, y


def test_minimize_bfgs_logreg(rng):
  """BFGS over a lazy logistic loss reaches the optimum scipy finds on
  the same numpy function, and the reference's."""
  import scipy.optimize as sopt
  X, y = _logreg(rng)

  def run(pkg):
    w = pkg.from_numpy(np.zeros(5))
    z = pkg.dot(pkg.from_numpy(X), w)
    loss = pkg.mean(pkg.log1p(pkg.exp(-z)) + (1.0 - pkg.from_numpy(y)) * z) \
        + 1e-3 * pkg.sum(w * w)
    return pkg.minimize(loss, [w])

  (w_opt,), info = run(sp)
  (w_ref,), info_ref = run(ref)
  assert info["success"] and info["status"] == info_ref["status"]

  def np_loss(wv):
    zz = X @ wv
    return (np.log1p(np.exp(-zz)) + (1 - y) * zz).mean() + 1e-3 * (wv**2).sum()

  want = sopt.minimize(np_loss, np.zeros(5), method="BFGS")
  np.testing.assert_allclose(_np(w_opt), want.x, atol=5e-4)
  assert info["fun"] <= want.fun + 1e-10
  np.testing.assert_allclose(_np(w_opt), _np(w_ref), atol=1e-8)
  np.testing.assert_allclose(info["fun"], info_ref["fun"], rtol=1e-12)


def test_minimize_bfgs_matches_the_reference_without_polish(rng):
  """The BFGS iteration itself (no Newton polish) against jax's on the
  same function: the same iterations and status, the same x to 1e-8."""
  X, y = _logreg(rng)

  def run(pkg):
    w = pkg.from_numpy(np.zeros(5))
    z = pkg.dot(pkg.from_numpy(X), w)
    loss = pkg.mean(pkg.log1p(pkg.exp(-z)) + (1.0 - pkg.from_numpy(y)) * z)
    return pkg.minimize(loss, [w], polish=False)

  (w_opt,), info = run(sp)
  (w_ref,), info_ref = run(ref)
  assert (info["nit"], info["status"], info["success"]) == (
      info_ref["nit"], info_ref["status"], info_ref["success"])
  np.testing.assert_allclose(_np(w_opt), _np(w_ref), atol=1e-8)


def test_minimize_multi_leaf():
  def run(pkg):
    a = pkg.from_numpy(np.array([3.0]))
    b = pkg.from_numpy(np.array([-2.0, 5.0]))
    loss = pkg.sum((a - 1.0) ** 2) + pkg.sum((b - np.array([2.0, -4.0])) ** 2)
    return pkg.minimize(loss, [a, b])

  (ao, bo), info = run(sp)
  np.testing.assert_allclose(_np(ao), [1.0], atol=1e-6)
  np.testing.assert_allclose(_np(bo), [2.0, -4.0], atol=1e-6)
  assert info["fun"] < 1e-10
  assert info["nit"] == run(ref)[1]["nit"]


def test_minimize_rejects_other_methods(rng):
  w = sp.from_numpy(np.zeros(2))
  with pytest.raises(ValueError, match="bfgs"):
    sp.minimize(sp.sum(w * w), [w], method="cg")


# -- tests/test_loop.py: sgd_train ------------------------------------------------

def test_sgd_train_one_lowering(rng):
  X_np = rng.standard_normal((128, 6))
  w_true = rng.standard_normal(6)
  y_np = X_np @ w_true

  def run(pkg):
    X, y = pkg.from_numpy(X_np), pkg.from_numpy(y_np)
    w = pkg.from_numpy(np.zeros(6))
    loss = pkg.sum((pkg.dot(X, w) - y) ** 2) / 128.0
    (w_out,), losses = pkg.sgd_train(loss, [w], lr=0.1, steps=200,
                                     collect_losses=True)
    return [w_out, losses]

  (w_out, curve), (w_ref, curve_ref) = _both(run)
  assert curve[-1] < curve[0] * 1e-3
  np.testing.assert_allclose(w_out, w_true, atol=1e-2)
  wn = np.zeros(6)
  for _ in range(200):
    wn = wn - 0.1 * (2.0 / 128) * (X_np.T @ (X_np @ wn - y_np))
  np.testing.assert_allclose(w_out, wn, atol=1e-10)
  np.testing.assert_allclose(w_out, w_ref, atol=1e-12)
  # the loss falls to 1e-26 (y = X w exactly): held to the first loss
  np.testing.assert_allclose(curve, curve_ref, rtol=0,
                             atol=1e-12 * curve_ref[0])


def test_sgd_train_without_losses(rng):
  w = sp.from_numpy(np.ones(3))
  (out,) = sp.sgd_train(sp.sum(w * w), [w], lr=0.25, steps=2)
  np.testing.assert_allclose(_np(out), np.full(3, 0.25), rtol=0)


# -- tests/test_stencil.py, tests/test_scipy_linalg.py ----------------------------

def test_single_channel_shifted_grad(rng):
  """grad through the shifted-add stencil emission, for the image and
  the filter taps, against the reference's (jax's conv gradient)."""
  xe = rng.standard_normal((1, 1, 8, 8))
  we = rng.standard_normal((1, 1, 3, 3))

  def run(pkg):
    X, W = pkg.from_numpy(xe), pkg.from_numpy(we)
    return pkg.grad(pkg.sum(pkg.stencil(X, W) ** 2), [X, W])

  (gx, gw), (rx, rw) = _both(run)
  np.testing.assert_allclose(gx, rx, rtol=1e-10, atol=1e-10)
  np.testing.assert_allclose(gw, rw, rtol=1e-10, atol=1e-10)


def test_multichannel_conv_and_pool_grad(rng):
  """grad through conv2d with several channels and a stride, and through
  max and average pooling, against the reference's (which differentiates
  the pools that divide the image only)."""
  xe = rng.standard_normal((2, 3, 16, 16))
  we = rng.standard_normal((4, 3, 3, 3))

  def run(pkg):
    X, W = pkg.from_numpy(xe), pkg.from_numpy(we)
    h = pkg.stencil(X, W, stride=2)
    loss = pkg.sum(pkg.maxpool(h, 2) ** 2) + pkg.sum(pkg.avgpool(h, 4) ** 2)
    return pkg.grad(loss, [X, W])

  (gx, gw), (rx, rw) = _both(run)
  np.testing.assert_allclose(gx, rx, rtol=1e-10, atol=1e-12)
  np.testing.assert_allclose(gw, rw, rtol=1e-10, atol=1e-12)


def test_gradients_flow_through_expm():
  """sp.grad through expm, against a forward difference (the reference
  test's check) and the reference's gradient."""
  import scipy.linalg as sla
  A = np.random.default_rng(7).normal(size=(4, 4))

  def run(pkg):
    X = pkg.lazify(0.1 * A)
    return pkg.grad(pkg.sum(pkg.linalg.expm(X) * pkg.linalg.expm(X)), [X])

  (an,), (want,) = _both(run)
  eps = 1e-6
  e0 = float(np.sum(sla.expm(0.1 * A) ** 2))
  fd = np.zeros(3)
  for i in range(3):
    Ap = 0.1 * A.copy()
    Ap[0, i] += eps
    fd[i] = (float(np.sum(sla.expm(Ap) ** 2)) - e0) / eps
  assert np.allclose(an[0, :3], fd, rtol=1e-3, atol=1e-5)
  np.testing.assert_allclose(an, want, rtol=1e-9)


# -- tests/test_sparse.py: gradients through the SpMV and SpMM routes -----------

def _spmv_grad(S, c, n, module, pkg, x_np):
  x = pkg.from_numpy(x_np)
  e = module.spmv_expr(S, x)
  (g,) = pkg.grad(pkg.sum(e * pkg.from_numpy(c)), wrt=[x])
  return e.fmt, np.asarray(g.glom(), dtype=np.float64)


@pytest.mark.parametrize("flag, fmt, shards", [
    (None, "ell", 1), ("sparse_force_onehot", "ell", 1),
    ("sparse_force_windowed", "win", 1), ("sparse_force_windowed", "winsh", 4),
])
def test_grad_through_spmv_all_formats(rng, flags, flag, fmt, shards):
  """sp.grad flows through every SpMV route: the differentiable emit
  takes each route's plain version even where evaluation would launch
  the kernel.  Oracle: d/dx sum(A x * c) = Aᵀ c."""
  n = 800
  A = ss.random(n, n, density=0.01, random_state=21, format="csr",
                dtype=np.float32)
  c = rng.standard_normal(n).astype(np.float32)
  x_np = rng.standard_normal(n).astype(np.float32)
  want = (A.T @ c).astype(np.float64)
  flags("sparse_auto_bsr", False)
  if flag:
    flags(flag, True)
  with sp.with_mesh(sp.make_mesh("cpu", shape=(shards,))):
    got_fmt, got = _spmv_grad(sps.from_scipy(A, dtype=np.float32), c, n,
                              sps, sp, x_np)
  assert got_fmt == fmt
  _, ref_g = _spmv_grad(ref_sps.from_scipy(A, dtype=np.float32), c, n,
                        ref_sps, ref, x_np)
  scale = max(np.abs(want).max(), 1e-9)
  assert np.abs(got - want).max() / scale < 1e-6
  assert np.abs(got - ref_g).max() / scale < 1e-6


def test_grad_through_spmv_bsr(rng):
  nb = 768
  Ab = ss.random(nb, nb, density=0.01, random_state=22, format="csr",
                 dtype=np.float32)
  cb = rng.standard_normal(nb).astype(np.float32)
  x_np = rng.standard_normal(nb).astype(np.float32)
  B = sps.from_scipy(Ab, dtype=np.float32).to_bsr(bs=128)
  x = sp.from_numpy(x_np)
  eb = sps.spmv_expr(B, x)
  assert eb.fmt == "bsr"
  (gb,) = sp.grad(sp.sum(eb * sp.from_numpy(cb)), wrt=[x])
  wantb = (Ab.T @ cb).astype(np.float64)
  err = np.abs(_np(gb) - wantb).max() / np.abs(wantb).max()
  assert err < 1e-5, err


def test_grad_through_sparse_dot(rng):
  """d/dB sum(S @ B * W) = Sᵀ W through the SpMM node (float64)."""
  A = ss.random(64, 48, density=0.1, random_state=3, format="csr")
  B = rng.standard_normal((48, 8))
  W = rng.standard_normal((64, 8))

  def run(pkg, module):
    S = module.from_scipy(A)
    Bx = pkg.from_numpy(B)
    return pkg.grad(pkg.sum(pkg.dot(S, Bx) * pkg.from_numpy(W)), wrt=[Bx])

  got, want = _np(run(sp, sps)[0]), _np(run(ref, ref_sps)[0])
  np.testing.assert_allclose(got, A.T @ W, atol=1e-8)
  np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("route", ["gather", "onehot", "windowed"])
def test_sparse_route_differential_sweep_grad(rng, flags, route):
  """The gradient part of the reference's sweep of every SpMV route over
  awkward shapes and densities (empty and single-row matrices too)."""
  flags("sparse_force_onehot", route == "onehot")
  flags("sparse_force_windowed", route == "windowed")
  flags("sparse_auto_bsr", False)
  for (n, m, dens) in [(17, 23, 0.3), (1, 100, 0.5), (100, 1, 0.5),
                       (130, 70, 0.0), (600, 300, 0.02)]:
    A = ss.random(n, m, density=dens,
                  random_state=np.random.RandomState(n + m),
                  format="csr", dtype=np.float32)
    S = sps.from_scipy(A, dtype=np.float32)
    x_np = rng.standard_normal(m).astype(np.float32)
    c = rng.standard_normal(n).astype(np.float32)
    xl = sp.from_numpy(x_np)
    (g,) = sp.grad(sp.sum(sps.spmv_expr(S, xl) * sp.from_numpy(c)), wrt=[xl])
    gw = A.T @ c
    gscale = max(np.abs(gw).max(), 1.0)
    assert np.abs(_np(g) - gw).max() / gscale < 1e-5, (route, n, m)


@pytest.mark.parametrize("flag, fmt, shards", [
    ("sparse_force_winmm", "winmm", 1), ("sparse_force_winmm", "winmmsh", 4),
    ("sparse_force_dense", "dense", 1),
])
def test_grad_through_spmm_routes(rng, flags, flag, fmt, shards):
  """d/dB sum((A B)²) = 2 Aᵀ (A B) through the CSR kernel's route (its
  plain version), its sharded form and the densified route."""
  flags(flag, True)
  A = ss.random(700, 900, density=0.02,
                random_state=np.random.RandomState(11), format="csr",
                dtype=np.float32)
  B = rng.standard_normal((900, 32)).astype(np.float32)
  want = A @ B
  want_g = 2 * A.T @ want
  with sp.with_mesh(sp.make_mesh("cpu", shape=(shards,))):
    S = sps.from_scipy(A, dtype=np.float32)
    Bl = sp.from_numpy(B)
    e = sps.spmm_expr(S, Bl)
    assert e.fmt == fmt
    (g,) = sp.grad(sp.sum(e ** 2), wrt=[Bl])
  scale = np.abs(want_g).max()
  assert np.abs(_np(g) - want_g).max() < scale * 1e-4


def test_spmm_grad_matches_the_reference(rng):
  A = ss.random(300, 200, density=0.03,
                random_state=np.random.RandomState(5), format="csr",
                dtype=np.float32)
  B = rng.standard_normal((200, 16)).astype(np.float32)

  def run(pkg, module):
    Bl = pkg.from_numpy(B)
    return pkg.grad(pkg.sum(module.spmm_expr(
        module.from_scipy(A, dtype=np.float32), Bl) ** 2), wrt=[Bl])[0]

  got, want = _np(run(sp, sps)), _np(run(ref, ref_sps))
  np.testing.assert_allclose(got, want, rtol=0,
                             atol=1e-5 * np.abs(want).max())


# -- tests/test_examples.py: convnet training; linear_reg.fit_fused ---------------

def _images():
  rng = np.random.default_rng(0)
  return rng.standard_normal((16, 1, 12, 12)), rng.integers(0, 4, 16)


def test_convnet_training_reduces_loss():
  images, labels = _images()
  params, losses = convnet.train(images, labels, n_classes=4, epochs=5,
                                 lr=0.1)
  assert losses[-1] < losses[0]
  assert np.isfinite(losses).all()
  _, ref_losses = ref_convnet.train(images, labels, n_classes=4, epochs=5,
                                    lr=0.1)
  np.testing.assert_allclose(losses, ref_losses, rtol=1e-10)


def test_convnet_fit_fused_matches_eager_train():
  """sgd_train's loop reproduces the per-step driver loop's loss curve
  (same init, same lr), and the reference's fused curve."""
  images, labels = _images()
  params_e, losses_e = convnet.train(images, labels, n_classes=4,
                                     epochs=4, lr=0.1)
  params_f, losses_f = convnet.fit_fused(images, labels, n_classes=4,
                                         epochs=4, lr=0.1)
  np.testing.assert_allclose(losses_f, losses_e, rtol=1e-8, atol=1e-10)
  for k in params_e:
    np.testing.assert_allclose(params_f[k], np.asarray(params_e[k]),
                               rtol=1e-7, atol=1e-9)
  assert losses_f[-1] < losses_f[0]
  _, ref_f = ref_convnet.fit_fused(images, labels, n_classes=4, epochs=4,
                                   lr=0.1)
  np.testing.assert_allclose(losses_f, ref_f, rtol=1e-10)


def test_convnet_sgd_train_with_remat():
  """remat around the first conv block leaves the loss curve as it is."""
  images, labels = _images()
  onehot = np.eye(4)[labels]
  params = convnet.init_params(n_classes=4, img=12)

  def curve(remat):
    leaves = {k: sp.lazify(v) for k, v in params.items()}
    loss = convnet.loss_expr(sp.lazify(images), onehot, leaves,
                             remat_first=remat)
    _, losses = sp.sgd_train(loss, list(leaves.values()), 0.1, 3,
                             collect_losses=True)
    return _np(losses)

  np.testing.assert_allclose(curve(True), curve(False), rtol=1e-14)


def test_linear_reg_fit_fused_equals_fit():
  X, y, _ = linear_reg.make_data(n=512, d=8)
  w_fit = _np(linear_reg.fit(X, y, iterations=30))
  w_fused = _np(linear_reg.fit_fused(X, y, iterations=30))
  np.testing.assert_allclose(w_fused, w_fit, rtol=1e-13, atol=1e-15)
  from spartan_tpu.examples import linear_reg as ref_lr
  rX, ry, _ = ref_lr.make_data(n=512, d=8)
  np.testing.assert_allclose(
      w_fused, _np(ref_lr.fit_fused(rX, ry, iterations=30)), rtol=1e-12)


# -- every kernel wrapper refuses a tensor that requires grad ---------------------

def _entry(name):
  """A call of kernel wrapper ``name`` on CPU operands, with its float
  operand requiring grad."""
  g = torch.randn(12, 12, dtype=torch.float32, requires_grad=True)
  A = sps.from_scipy(ss.random(12, 12, density=0.3, random_state=1,
                                format="csr", dtype=np.float32))
  indptr, indices, data = A.to_csr()
  x = torch.randn(12, requires_grad=True)
  mesh = sp.make_mesh("cpu", shape=(2,))
  return {
      "fused_reduce.fused_sum": lambda: K1.fused_sum(
          g, K1.plan(None, 0, torch.float32, {})),
      "matmul.matmul": lambda: K2.matmul(g, g.detach()),
      "spmv.spmv_ell": lambda: KS.spmv_ell(A.cols, A.vals, x),
      "spmv.spmv_csr": lambda: KS.spmv_csr(indptr, indices, data, x),
      "spmv.spmv_chunked": lambda: KS.spmv_chunked(
          indptr, indices, data, KS.chunk_rows(indptr), x),
      "spmv.sharded_onehot_spmv": lambda: KS.sharded_onehot_spmv(
          A.cols, A.vals, x, mesh),
      "spmv.sharded_windowed_spmv_traced": lambda: (
          KS.sharded_windowed_spmv_traced(A.to_windowed_sharded(2), x, mesh)),
      "spmm.spmm_csr": lambda: K5.spmm_csr(indptr, indices, data, g),
      "spmm.sharded_windowed_spmm_traced": lambda: (
          K5.sharded_windowed_spmm_traced(A.to_windowed_spmm_sharded(2), g,
                                          mesh)),
      "stencil.stencil3x3": lambda: KST.stencil3x3(g, [1.0] * 9),
      "stencil.stencil3x3_padded": lambda: KST.stencil3x3_padded(
          KST.to_padded(g), KST.to_padded(torch.zeros(12, 12)), [1.0] * 9),
      "stencil.stencil3x3_padded_sharded": lambda: (
          KST.stencil3x3_padded_sharded(g, [1.0] * 9, mesh=mesh)),
  }[name]


KERNEL_ENTRIES = [
    "fused_reduce.fused_sum", "matmul.matmul", "spmv.spmv_ell",
    "spmv.spmv_csr", "spmv.spmv_chunked", "spmv.sharded_onehot_spmv",
    "spmv.sharded_windowed_spmv_traced", "spmm.spmm_csr",
    "spmm.sharded_windowed_spmm_traced", "stencil.stencil3x3",
    "stencil.stencil3x3_padded", "stencil.stencil3x3_padded_sharded",
]


@pytest.mark.parametrize("name", KERNEL_ENTRIES)
def test_kernel_entry_refuses_a_tensor_that_requires_grad(name,
                                                          monkeypatch):
  """Each wrapper raises before it picks kernel or plain version, naming
  the kernel; nothing is launched (``build.launch`` and K1's library
  binding are stubbed to fail the test)."""
  def no_launch(*args, **kwargs):
    raise AssertionError("a kernel was launched")

  monkeypatch.setattr(build, "launch", no_launch)
  monkeypatch.setattr(K1, "_library", no_launch)
  call = _entry(name)
  with pytest.raises(RuntimeError, match=name.replace(".", r"\.")):
    call()
