"""``sp.optimize`` of the port (``spartan_tpu_torch/optimize.py``) against
the reference's (``spartan_tpu/optimize.py``) and scipy, on the same seeded
float64 data: a counterpart of every test of the reference's
``tests/test_optimize.py``, then the port's own choices pinned (the
Jacobian's orientation, one host read a loop turn, the plain routes of a
lowered objective, the host boundaries' counts).

Expr-native objectives are written once over a module ``m`` (``sp.*``)
and run through both packages; callable objectives are jnp for the
reference and torch for the port.  The reference's results are computed
once for the module (``REF``): each of its solvers jit-compiles.

Tolerances:
* where both run the same float64 algorithm (the damped-Newton loops, the
  scalar brackets, BFGS, the box solver), the port's result is held to
  the reference's at 1e-10 (``TOL``) and its ``nfev``/``nit`` equal the
  reference's: the two differ by the rounding of an autograd Jacobian
  against ``jacfwd``'s, of torch's ``exp`` and sums against XLA's, and a
  LAPACK solve's order, a few ulps a step.  Two stop tests sit at that
  rounding itself, so there the counts are not compared (x still is, at
  TOL): the noisy exponential fit's ``ftol`` test (``_same_lsq``) and
  ``lsq_linear``'s projected gradient below 1e-12;
* where they may branch apart, both are held to scipy or to the known
  optimum at the reference test's own tolerance: differential evolution
  (torch's generator is not ``jax.random``), the Nelder–Mead simplex
  (``fmin``, ``fmin_powell``, ``brute``'s finish: its reflect/contract
  choices compare function values that tie up to their last bits, and a
  tie that breaks the other way takes another path to the optimum), and
  the host scipy routes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.optimize as sopt
import torch

import spartan_tpu as ref

import spartan_tpu_torch as sp
from spartan_tpu_torch import optimize as opt_mod
from spartan_tpu_torch.expr import fio

RO, O = ref.optimize, sp.optimize

rng = np.random.default_rng(3)
t = np.linspace(0, 3, 60)
TRUE = np.array([2.5, 1.3, 0.4])
y = TRUE[0] * np.exp(-TRUE[1] * t) + TRUE[2] + 1e-3 * rng.normal(size=60)
C_HOST = rng.random((6, 6))
A_HOST, B_HOST = rng.random((8, 4)), rng.random(8)
TT, YT = torch.as_tensor(t), torch.as_tensor(y)
# the same-algorithm tolerance (see the module docstring)
TOL = 1e-10


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


def _res_np(p):
  return p[0] * np.exp(-p[1] * t) + p[2] - y


def _res_expr(m):
  return lambda p: p[0] * m.exp(-p[1] * m.Val(t)) + p[2] - m.Val(y)


def _res_jnp(p):
  return p[0] * jnp.exp(-p[1] * t) + p[2] - y


def _res_torch(p):
  return p[0] * torch.exp(-p[1] * TT) + p[2] - YT


def _gn_jnp(p):
  return jnp.stack([p[0] - 2.0, 3.0 * (p[1] + 1.0)])


def _gn_torch(p):
  return torch.stack([p[0] - 2.0, 3.0 * (p[1] + 1.0)])


def _box_jnp(p):
  return jnp.stack([p[0] - 5.0, p[1] + 3.0, 0.1 * (p[0] - p[1])])


def _box_torch(p):
  return torch.stack([p[0] - 5.0, p[1] + 3.0, 0.1 * (p[0] - p[1])])


def _rosen_jnp(p):
  return jnp.sum(100 * (p[1:] - p[:-1] ** 2) ** 2 + (1 - p[:-1]) ** 2)


def _rosen_torch(p):
  return torch.sum(100 * (p[1:] - p[:-1] ** 2) ** 2 + (1 - p[:-1]) ** 2)


def _curve_jnp(x, a, b, c):
  return a * jnp.exp(-b * x) + c


def _curve_torch(x, a, b, c):
  return a * torch.exp(-b * x) + c


BOX = ([0.0, -1.0], [2.0, 1.0])
SIGMA = np.full(60, 0.5)
C_QUAD = np.array([4.0, -7.0, 0.2])


@pytest.fixture(scope="module")
def REF():
  """Every reference result the module compares with, computed once."""
  R = {}
  R["lsq_jnp"] = RO.least_squares(_res_jnp, np.ones(3))
  R["lsq_expr"] = RO.least_squares(_res_expr(ref), np.ones(3))
  R["gn"] = RO.least_squares(_gn_jnp, np.zeros(2), method="gn")
  R["gn_trf"] = RO.least_squares(_gn_jnp, np.zeros(2), method="trf")
  R["curve"] = RO.curve_fit(_curve_jnp, t, y, p0=np.ones(3))
  R["curve_sigma"] = RO.curve_fit(_curve_jnp, t, y, sigma=SIGMA)
  R["curve_abs"] = RO.curve_fit(_curve_jnp, t, y, sigma=SIGMA,
                                absolute_sigma=True)
  R["root"] = RO.root(
      lambda p: jnp.array([p[0] ** 2 + p[1] - 3.0, p[0] - p[1] ** 3 + 1.0]),
      np.array([1.0, 1.0]))
  R["bisect"] = RO.bisect(lambda x: x ** 3 - 2, 0.0, 2.0, full_output=True)
  R["newton"] = RO.newton(lambda x: x ** 2 - 2.0, 1.0, full_output=True)
  R["rs_bisect"] = RO.root_scalar(lambda x: jnp.cos(x) - x,
                                  bracket=[0.0, 1.0])
  R["rs_newton"] = RO.root_scalar(lambda x: jnp.cos(x) - x, x0=0.5,
                                  method="newton")
  R["rs_short"] = RO.root_scalar(lambda x: jnp.cos(x) - x,
                                 bracket=[0.0, 1.0], maxiter=3, xtol=1e-12)
  R["min_scalar"] = RO.minimize_scalar(lambda x: (x - 1.7) ** 2 + 0.3,
                                       bounds=(0.0, 5.0))
  R["min_rosen"] = RO.minimize(_rosen_jnp, np.zeros(4))
  pl = ref.lazify(np.zeros(3))
  R["min_expr"] = RO.minimize(ref.sum((pl - np.array([1., 2., 3.])) ** 2),
                              wrt=[pl])
  R["lsq_box"] = RO.least_squares(_box_jnp, np.array([1.0, 0.0]),
                                  bounds=BOX)
  R["lsq_box0"] = RO.least_squares(_box_jnp, np.zeros(2), bounds=BOX)
  R["lsq_free"] = RO.least_squares(_box_jnp, np.zeros(2),
                                   bounds=([-10, -10], [10, 10]))
  R["lsq_unb"] = RO.least_squares(_box_jnp, np.zeros(2))
  R["curve_box"] = RO.curve_fit(lambda x, a, b: a * x + b,
                                np.linspace(0, 1, 40),
                                3.0 * np.linspace(0, 1, 40) + 0.5,
                                p0=[1.0, 0.0],
                                bounds=([0.0, 0.0], [2.0, 1.0]))
  R["min_box"] = RO.minimize(_rosen_jnp, np.zeros(2),
                             bounds=[(-2.0, 0.8), (-2.0, 0.8)])
  R["min_corner"] = RO.minimize(lambda p: jnp.sum((p - C_QUAD) ** 2),
                                np.zeros(3), bounds=[(-1, 1)] * 3)
  R["lsq_scalar"] = RO.least_squares(lambda p: p - 3.0, 0.0)
  R["lsq_2d"] = RO.least_squares(lambda p: p - jnp.arange(4.0),
                                 np.zeros((2, 2)))
  R["brentq"] = {name: getattr(RO, name)(lambda x: x ** 3 - 2 * x - 5, 2, 3,
                                         xtol=1e-13)
                 for name in ("brentq", "brenth", "ridder", "toms748")}
  R["brentq_full"] = RO.brentq(lambda x: x ** 3 - 2 * x - 5, 2, 3,
                               xtol=1e-13, full_output=True)
  R["brentq_exp"] = RO.brentq(lambda x: jnp.exp(x) - 10.0, 0, 5)
  R["fixed"] = RO.fixed_point(lambda x: jnp.sqrt(10.0 / (x + 4.0)), 1.5)
  R["fixed_vec"] = RO.fixed_point(
      lambda x: jnp.array([0.5, 0.25]) * x + jnp.array([1.0, 2.0]),
      np.zeros(2), method="iteration", maxiter=2000)
  R["fmin_rosen"] = RO.fmin(RO.rosen, np.array([1.3, 0.9]), xtol=1e-8,
                            ftol=1e-12, maxiter=2000, full_output=True)
  R["fmin_quad"] = RO.fmin(lambda p: jnp.sum((p - 3.0) ** 2), np.zeros(3),
                           xtol=1e-9, ftol=1e-14, full_output=True)
  f_leg = lambda p: jnp.sum((p - 2.0) ** 2) + p[0] * p[1] * 0.1
  R["legacy"] = {name: getattr(RO, name)(f_leg, np.zeros(2))
                 for name in ("fmin_bfgs", "fmin_cg", "fmin_ncg")}
  R["l_bfgs_b"] = RO.fmin_l_bfgs_b(lambda p: jnp.sum((p - 2.0) ** 2),
                                   np.zeros(2), bounds=[(0, 1.0), (0, 1.0)])
  R["tnc"] = RO.fmin_tnc(lambda p: jnp.sum(p ** 2), np.ones(2) * 0.5,
                         bounds=[(0.2, 1.0), (0.2, 1.0)])
  R["leastsq"] = RO.leastsq(
      lambda p: jnp.stack([p[0] * 2.0 - 3.0, p[1] + 1.0, p[0] - p[1] - 2.0]),
      np.zeros(2))
  R["fsolve"] = RO.fsolve(lambda p: jnp.stack([p[0] ** 2 - 4.0, p[1] - 1.0]),
                          np.array([1.0, 0.0]))
  lrng = np.random.default_rng(3)
  A, b = lrng.normal(size=(20, 5)), lrng.normal(size=20)
  R["lsq_linear"] = RO.lsq_linear(A, b, bounds=(np.zeros(5),
                                                np.full(5, 0.4)), tol=1e-12)
  R["brute"] = RO.brute(lambda p: jnp.squeeze((p[0] - 1.5) ** 2), [(-3, 3)],
                        Ns=31)
  R["brute2"] = RO.brute(lambda p: (p[0] - 1.0) ** 2 + (p[1] + 0.5) ** 2,
                         [(-2, 2), (-2, 2)], Ns=11, full_output=True)
  f_sc = lambda x: (x - 1.2) ** 2 + 3.0
  R["fminbound"] = RO.fminbound(f_sc, -4, 4, xtol=1e-10)
  R["brent"] = RO.brent(f_sc, brack=(-4, 0, 4))
  R["golden"] = RO.golden(f_sc, brack=(-4, 0, 4))
  R["bracket"] = RO.bracket(lambda x: float(f_sc(x)), -5.0, -4.0)
  R["powell"] = RO.fmin_powell(lambda p: jnp.sum((p - 1.0) ** 2),
                               np.zeros(2), full_output=True)
  R["l_bfgs_b_5"] = RO.fmin_l_bfgs_b(lambda p: jnp.sum((p - 2.0) ** 2),
                                     np.zeros(2), bounds=[(0, 5.0), (0, 5.0)])
  return R


def _close(got, want, tol=TOL):
  np.testing.assert_allclose(np.asarray(got, dtype=float),
                             np.asarray(want, dtype=float), rtol=0, atol=tol)


def _same_lsq(got, want, same_count: bool = True):
  """``same_count=False`` where the last steps' stop test compares costs
  that differ only in their rounding (the noisy exponential fit: XLA's
  ``exp`` and ``dot`` round otherwise than torch's, so the step at which
  ``cost - c2 <= ftol cost`` first holds differs); x, the residuals and
  the Jacobian still agree at TOL, and both stop on a success code."""
  _close(got.x, want.x)
  _close(got.fun, want.fun)
  _close(got.jac, want.jac)
  assert got.success == want.success
  if same_count:
    assert got.nfev == want.nfev and got.status == want.status
  else:
    assert got.status in (1, 2, 3) and want.status in (1, 2, 3)


@pytest.mark.parametrize("route", ["callable", "expr"])
def test_least_squares_both_routes(REF, route):
  want = sopt.least_squares(_res_np, np.ones(3)).x
  fun = _res_torch if route == "callable" else _res_expr(sp)
  r = O.least_squares(fun, np.ones(3))
  _same_lsq(r, REF["lsq_jnp" if route == "callable" else "lsq_expr"],
            same_count=False)
  # the reference test's bound against scipy
  assert r.success and np.abs(r.x - want).max() < 1e-6
  assert r.fun.shape == (60,) and r.jac.shape == (60, 3)
  assert r.cost == pytest.approx(0.5 * np.dot(r.fun, r.fun))
  assert r.optimality == np.abs(r.grad).max()


def test_least_squares_gn_and_status(REF):
  r = O.least_squares(_gn_torch, np.zeros(2), method="gn")
  _same_lsq(r, REF["gn"])
  assert r.success and np.abs(r.x - [2.0, -1.0]).max() < 1e-9
  r2 = O.least_squares(_gn_torch, np.zeros(2), method="trf")
  _same_lsq(r2, REF["gn_trf"])
  assert r2.success and np.abs(r2.x - [2.0, -1.0]).max() < 1e-8
  with pytest.raises(ValueError):
    O.least_squares(_gn_torch, np.zeros(2), method="dogbox")
  with pytest.raises(ValueError):  # scipy's contract: lm rejects bounds
    O.least_squares(_gn_torch, np.zeros(2), method="lm",
                    bounds=([0.0, -2.0], [5.0, 5.0]))


def test_curve_fit_matches_scipy(REF):
  popt, pcov = O.curve_fit(_curve_torch, t, y, p0=np.ones(3))
  _close(popt, REF["curve"][0])
  _close(pcov, REF["curve"][1])
  pw, pcw = sopt.curve_fit(lambda x, a, b, c: a * np.exp(-b * x) + c,
                           t, y, p0=np.ones(3))
  assert np.abs(popt - pw).max() < 1e-5
  assert np.abs(pcov - pcw).max() < 1e-6


def test_curve_fit_sigma_and_p0_inference(REF):
  popt, pcov = O.curve_fit(_curve_torch, t, y, sigma=SIGMA)  # p0: ones
  _close(popt, REF["curve_sigma"][0])
  _close(pcov, REF["curve_sigma"][1])
  pw, pcw = sopt.curve_fit(lambda x, a, b, c: a * np.exp(-b * x) + c,
                           t, y, sigma=SIGMA)
  assert np.abs(popt - pw).max() < 1e-5
  assert np.abs(pcov - pcw).max() < 1e-5
  _, ca = O.curve_fit(_curve_torch, t, y, sigma=SIGMA, absolute_sigma=True)
  _close(ca, REF["curve_abs"][1])
  _, caw = sopt.curve_fit(lambda x, a, b, c: a * np.exp(-b * x) + c,
                          t, y, sigma=SIGMA, absolute_sigma=True)
  assert np.abs(ca - caw).max() < 1e-5


def test_curve_fit_of_an_expr_native_model():
  """The model written once with ``m.*`` fits through both packages."""
  model = lambda m: (lambda x, a, b, c: a * m.exp(-b * x) + c)
  popt, _ = O.curve_fit(model(sp), t, y, p0=np.ones(3))
  want, _ = RO.curve_fit(model(ref), t, y, p0=np.ones(3))
  _close(popt, want)


def test_root_vector(REF):
  r = O.root(lambda p: torch.stack([p[0] ** 2 + p[1] - 3.0,
                                    p[0] - p[1] ** 3 + 1.0]),
             np.array([1.0, 1.0]))
  _close(r.x, REF["root"].x)
  assert r.nit == REF["root"].nit and r.nfev == REF["root"].nfev
  want = sopt.root(lambda p: [p[0] ** 2 + p[1] - 3, p[0] - p[1] ** 3 + 1],
                   [1.0, 1.0]).x
  assert r.success and np.abs(r.x - want).max() < 1e-8
  assert np.abs(r.fun).max() < 1e-9


def test_scalar_rootfinding(REF):
  got = O.bisect(lambda x: x ** 3 - 2, 0.0, 2.0, full_output=True)
  assert got[1:] == REF["bisect"][1:]
  _close(got[0], REF["bisect"][0])
  assert abs(got[0] - 2 ** (1 / 3)) < 1e-10
  got = O.newton(lambda x: x ** 2 - 2.0, 1.0, full_output=True)
  assert got[1:] == REF["newton"][1:]
  _close(got[0], REF["newton"][0])
  assert abs(got[0] - np.sqrt(2)) < 1e-8
  rs = O.root_scalar(lambda x: torch.cos(x) - x, bracket=[0.0, 1.0])
  assert rs.iterations == REF["rs_bisect"].iterations
  assert rs.converged and abs(rs.root - 0.7390851332151607) < 1e-9
  rs2 = O.root_scalar(lambda x: torch.cos(x) - x, x0=0.5, method="newton")
  assert rs2.iterations == REF["rs_newton"].iterations
  _close(rs2.root, REF["rs_newton"].root)
  assert rs2.converged and abs(rs2.root - 0.7390851332151607) < 1e-7
  with pytest.raises(ValueError):
    O.bisect(lambda x: x ** 2 + 1, -1.0, 1.0)  # no sign change


def test_scalar_solvers_take_an_expr_native_function():
  """F2 on this path: ``f`` built from ``sp.*`` gets a 0-d tensor and its
  expr is lowered; the same ``f`` written with ``ref.*`` is not run by the
  reference's jitted loop (it lazifies a tracer), so the port is held to
  the torch form's result."""
  want = O.root_scalar(lambda x: torch.cos(x) - x, x0=0.5, method="newton")
  got = O.root_scalar(lambda x: sp.cos(x) - x, x0=0.5, method="newton")
  assert got.iterations == want.iterations
  _close(got.root, want.root, 0)
  assert O.bisect(lambda x: sp.cumsum(x)[0] ** 3 - 2, 0.0, 2.0) == (
      O.bisect(lambda x: x ** 3 - 2, 0.0, 2.0))


def test_minimize_scalar(REF):
  ms = O.minimize_scalar(lambda x: (x - 1.7) ** 2 + 0.3, bounds=(0.0, 5.0))
  assert ms.nit == REF["min_scalar"].nit
  _close(ms.x, REF["min_scalar"].x)
  assert ms.success and abs(ms.x - 1.7) < 1e-7
  assert ms.fun == pytest.approx(0.3, abs=1e-9)


def test_minimize_callable_and_expr(REF):
  m = O.minimize(_rosen_torch, np.zeros(4))
  _close(m.x, REF["min_rosen"].x)
  assert m.nit == REF["min_rosen"].nit and m.status == REF["min_rosen"].status
  assert m.success and np.abs(m.x - 1).max() < 1e-5
  pl = sp.lazify(np.zeros(3))
  loss = sp.sum((pl - np.array([1., 2., 3.])) ** 2)
  m2 = O.minimize(loss, wrt=[pl])
  _close(m2.x, REF["min_expr"].x)
  assert m2.success and np.abs(np.asarray(m2.x) - [1, 2, 3]).max() < 1e-8
  with pytest.raises(ValueError):
    O.minimize(loss)  # the expr form needs wrt


def test_host_wrappers():
  runs = fio.counts["host_runs"]
  ri, ci = O.linear_sum_assignment(C_HOST)
  rw, cw = sopt.linear_sum_assignment(C_HOST)
  assert np.array_equal(ri, rw) and np.array_equal(ci, cw)
  xs, rn = O.nnls(sp.from_numpy(A_HOST), B_HOST)
  xw, rnw = sopt.nnls(A_HOST, B_HOST)
  assert np.abs(xs - xw).max() < 1e-10 and abs(rn - rnw) < 1e-10
  assert fio.counts["host_runs"] == runs + 2


def test_optimize_result_attr_access():
  r = O.OptimizeResult(x=1, success=True)
  assert r.x == 1 and r["success"]
  with pytest.raises(AttributeError):
    _ = r.nope


def test_least_squares_bounds_vs_scipy(REF):
  def res_np(p):
    return np.asarray([p[0] - 5.0, p[1] + 3.0, 0.1 * (p[0] - p[1])])

  want = sopt.least_squares(res_np, np.array([1.0, 0.0]), bounds=BOX)
  got = O.least_squares(_box_torch, np.array([1.0, 0.0]), bounds=BOX)
  _same_lsq(got, REF["lsq_box"])
  assert got.success
  assert np.abs(got.x - want.x).max() < 1e-6
  assert got.cost == pytest.approx(want.cost, rel=1e-8)
  assert got.optimality < 1e-6 or got.status in (2, 3)
  gb = O.least_squares(_box_torch, np.zeros(2), bounds=BOX)
  _same_lsq(gb, REF["lsq_box0"])
  assert np.abs(gb.x - [2.0, -1.0]).max() < 1e-6 and gb.cost < 6.546
  free = O.least_squares(_box_torch, np.zeros(2),
                         bounds=([-10, -10], [10, 10]))
  unb = O.least_squares(_box_torch, np.zeros(2))
  _same_lsq(free, REF["lsq_free"])
  _same_lsq(unb, REF["lsq_unb"])
  assert np.abs(free.x - unb.x).max() < 1e-7


def test_curve_fit_with_bounded_lsq_kw(REF):
  def f(x, a, b):
    return a * x + b

  xs = np.linspace(0, 1, 40)
  ys = 3.0 * xs + 0.5
  popt, _ = O.curve_fit(f, xs, ys, p0=[1.0, 0.0],
                        bounds=([0.0, 0.0], [2.0, 1.0]))
  _close(popt, REF["curve_box"][0])
  wopt, _ = sopt.curve_fit(f, xs, ys, p0=[1.0, 0.0],
                           bounds=([0.0, 0.0], [2.0, 1.0]))
  assert np.abs(popt - wopt).max() < 1e-5


def test_minimize_bounds_vs_scipy(REF):
  def rosen_np(p):
    return np.sum(100 * (p[1:] - p[:-1] ** 2) ** 2 + (1 - p[:-1]) ** 2)

  bounds = [(-2.0, 0.8), (-2.0, 0.8)]
  want = sopt.minimize(rosen_np, np.zeros(2), method="L-BFGS-B",
                       bounds=bounds)
  got = O.minimize(_rosen_torch, np.zeros(2), bounds=bounds)
  _close(got.x, REF["min_box"].x)
  assert got.nit == REF["min_box"].nit
  assert got.success
  assert got.fun == pytest.approx(want.fun, rel=1e-6, abs=1e-8)
  assert np.abs(got.x - want.x).max() < 1e-4
  q = lambda p: torch.sum((p - torch.as_tensor(C_QUAD)) ** 2)
  g2 = O.minimize(q, np.zeros(3), bounds=[(-1, 1)] * 3)
  _close(g2.x, REF["min_corner"].x)
  assert g2.nit == REF["min_corner"].nit
  assert g2.success
  assert np.abs(g2.x - np.clip(C_QUAD, -1, 1)).max() < 1e-7
  g3 = O.minimize(q, np.zeros(3),
                  bounds=sopt.Bounds(-np.ones(3), np.ones(3)))
  assert np.abs(g3.x - np.clip(C_QUAD, -1, 1)).max() < 1e-7


def test_root_scalar_honest_diagnostics(REF):
  rs = O.root_scalar(lambda x: torch.cos(x) - x, bracket=[0.0, 1.0],
                     maxiter=100)
  assert rs.converged and 0 < rs.iterations < 100
  assert rs.function_calls == 2 + 2 * rs.iterations
  rs2 = O.root_scalar(lambda x: torch.cos(x) - x, bracket=[0.0, 1.0],
                      maxiter=3, xtol=1e-12)
  assert not rs2.converged and rs2.iterations == 3
  _close(rs2.root, REF["rs_short"].root)
  rsn = O.root_scalar(lambda x: torch.cos(x) - x, x0=0.5, method="newton")
  assert rsn.converged and 0 < rsn.iterations < 50


def test_scalar_x0_least_squares(REF):
  r = O.least_squares(lambda p: p - 3.0, 0.0)
  _same_lsq(r, REF["lsq_scalar"])
  assert r.success and abs(float(r.x[0]) - 3.0) < 1e-9
  r2 = O.least_squares(lambda p: p - torch.arange(4.0, dtype=torch.float64),
                       np.zeros((2, 2)))
  _same_lsq(r2, REF["lsq_2d"])
  assert r2.success and np.abs(r2.x - np.arange(4.0)).max() < 1e-9


def test_expr_native_objective_error_surfaces():
  def buggy(p):
    raise ValueError("intentional bug in objective")

  with pytest.raises(RuntimeError, match="buggy"):
    O.least_squares(buggy, np.zeros(2))
  with pytest.raises(RuntimeError, match="buggy"):
    O.minimize(buggy, np.zeros(2))


def test_rosen_family_matches_scipy():
  x = np.array([1.3, 0.7, 0.8, 1.9, 1.2])
  got = float(np.asarray(sp.lazify(O.rosen(x)).glom()))
  assert got == pytest.approx(float(np.asarray(ref.lazify(
      RO.rosen(x)).glom())), rel=1e-15)
  assert abs(got - sopt.rosen(x)) < 1e-10
  np.testing.assert_allclose(np.asarray(sp.lazify(O.rosen_der(x)).glom()),
                             sopt.rosen_der(x), atol=1e-10)
  np.testing.assert_allclose(O.rosen_hess(x), sopt.rosen_hess(x), atol=1e-10)
  p = np.array([0.1, -0.2, 0.3, 0.4, -0.5])
  np.testing.assert_allclose(O.rosen_hess_prod(x, p),
                             sopt.rosen_hess_prod(x, p), atol=1e-10)


def test_brentq_ridder_match_scipy(REF):
  f = lambda x: x ** 3 - 2 * x - 5
  want = sopt.brentq(f, 2, 3, xtol=1e-13)
  for name in ("brentq", "brenth", "ridder", "toms748"):
    got = getattr(O, name)(f, 2, 3, xtol=1e-13)
    _close(got, REF["brentq"][name])
    assert abs(got - want) < 1e-10, name
  r, info = O.brentq(f, 2, 3, xtol=1e-13, full_output=True)
  assert info.converged and info.iterations > 0
  assert info.iterations == REF["brentq_full"][1].iterations
  with pytest.raises(ValueError):
    O.brentq(f, 3, 4)
  g = lambda x: torch.exp(x) - 10.0
  got = O.brentq(g, 0, 5)
  _close(got, REF["brentq_exp"])
  assert abs(got - np.log(10)) < 1e-10


def test_fixed_point_matches_scipy(REF):
  got = O.fixed_point(lambda x: torch.sqrt(10.0 / (x + 4.0)), 1.5)
  _close(got, REF["fixed"])
  want = sopt.fixed_point(lambda x: np.sqrt(10.0 / (x + 4.0)), 1.5)
  assert abs(float(np.asarray(got)) - float(want)) < 1e-7
  gotv = O.fixed_point(lambda x: torch.as_tensor([0.5, 0.25],
                                                 dtype=torch.float64) * x
                       + torch.as_tensor([1.0, 2.0], dtype=torch.float64),
                       np.zeros(2), method="iteration", maxiter=2000)
  _close(gotv, REF["fixed_vec"])
  np.testing.assert_allclose(np.asarray(gotv), [2.0, 8.0 / 3], atol=1e-6)


def test_fmin_nelder_mead(REF):
  x, fx, it, fc, flag = O.fmin(O.rosen, np.array([1.3, 0.9]), xtol=1e-8,
                               ftol=1e-12, maxiter=2000, full_output=True)
  np.testing.assert_allclose(x, [1.0, 1.0], atol=1e-3)
  np.testing.assert_allclose(REF["fmin_rosen"][0], [1.0, 1.0], atol=1e-3)
  assert flag == 0 == REF["fmin_rosen"][4] and fc == it * (2 + 4)
  xf, fx, it, fc, flag = O.fmin(lambda p: torch.sum((p - 3.0) ** 2),
                                np.zeros(3), xtol=1e-9, ftol=1e-14,
                                full_output=True)
  np.testing.assert_allclose(xf, 3.0, atol=1e-4)
  np.testing.assert_allclose(REF["fmin_quad"][0], 3.0, atol=1e-4)
  assert flag == 0 and it > 0


def test_legacy_min_frontends(REF):
  f = lambda p: torch.sum((p - 2.0) ** 2) + p[0] * p[1] * 0.1
  A = np.array([[2.0, 0.1], [0.1, 2.0]])
  for name in ("fmin_bfgs", "fmin_cg", "fmin_ncg"):
    x = getattr(O, name)(f, np.zeros(2))
    _close(x, REF["legacy"][name])
    np.testing.assert_allclose(np.asarray(x), np.linalg.solve(A, [4.0, 4.0]),
                               atol=1e-5)
  x, fv, info = O.fmin_l_bfgs_b(lambda p: torch.sum((p - 2.0) ** 2),
                                np.zeros(2), bounds=[(0, 1.0), (0, 1.0)])
  _close(x, REF["l_bfgs_b"][0])
  assert info["nit"] == REF["l_bfgs_b"][2]["nit"]
  np.testing.assert_allclose(x, [1.0, 1.0], atol=1e-6)
  assert info["warnflag"] == 0
  x, nit, rc = O.fmin_tnc(lambda p: torch.sum(p ** 2), np.ones(2) * 0.5,
                          bounds=[(0.2, 1.0), (0.2, 1.0)])
  _close(x, REF["tnc"][0])
  assert (nit, rc) == tuple(REF["tnc"][1:])
  np.testing.assert_allclose(x, [0.2, 0.2], atol=1e-6)


def test_leastsq_fsolve_wrappers(REF):
  x, ier = O.leastsq(
      lambda p: torch.stack([p[0] * 2.0 - 3.0, p[1] + 1.0, p[0] - p[1] - 2.0]),
      np.zeros(2))
  _close(x, REF["leastsq"][0])
  want = sopt.leastsq(lambda p: [p[0] * 2 - 3, p[1] + 1, p[0] - p[1] - 2],
                      np.zeros(2))[0]
  np.testing.assert_allclose(np.asarray(x), want, atol=1e-6)
  assert ier == 1 == REF["leastsq"][1]
  xr = O.fsolve(lambda p: torch.stack([p[0] ** 2 - 4.0, p[1] - 1.0]),
                np.array([1.0, 0.0]))
  _close(xr, REF["fsolve"])
  np.testing.assert_allclose(np.asarray(xr), [2.0, 1.0], atol=1e-8)


def test_lsq_linear_bounded_matches_scipy(REF):
  lrng = np.random.default_rng(3)
  A = lrng.normal(size=(20, 5))
  b = lrng.normal(size=20)
  lb, ub = np.zeros(5), np.full(5, 0.4)
  got = O.lsq_linear(A, b, bounds=(lb, ub), tol=1e-12)
  _close(got.x, REF["lsq_linear"].x)
  assert got.success and REF["lsq_linear"].success
  want = sopt.lsq_linear(A, b, bounds=(lb, ub), tol=1e-12)
  assert got.cost <= want.cost * (1 + 1e-6)
  np.testing.assert_allclose(got.x, want.x, atol=1e-5)
  got_u = O.lsq_linear(A, b)
  want_u, *_ = np.linalg.lstsq(A, b, rcond=None)
  np.testing.assert_allclose(got_u.x, want_u, atol=1e-8)


def test_differential_evolution_device():
  """Held to the known global optimum at the reference test's tolerance
  (the draws are torch's generator's, not ``jax.random``'s)."""
  def f(p):
    return ((p[0] - np.pi) ** 2 + (p[1] - 2.0) ** 2
            + 2.0 * torch.sin(5 * p[0]) ** 2 * torch.sin(3 * p[1]) ** 2)
  res = O.differential_evolution(f, [(0, 6), (0, 6)], seed=1, tol=1e-8,
                                 maxiter=300)
  assert res.success
  np.testing.assert_allclose(res.x, [np.pi, 2.0], atol=1e-3)
  assert res.fun < 1e-5
  again = O.differential_evolution(f, [(0, 6), (0, 6)], seed=1, tol=1e-8,
                                   maxiter=300)
  np.testing.assert_array_equal(again.x, res.x)  # one seed, one stream
  assert again.nit == res.nit


def test_brute_device_grid(REF):
  x = O.brute(lambda p: ((p[0] - 1.5) ** 2).squeeze(), [(-3, 3)], Ns=31)
  _close(x, REF["brute"])
  assert abs(float(x) - 1.5) < 1e-4
  x2, f2, grid, fvals = O.brute(
      lambda p: (p[0] - 1.0) ** 2 + (p[1] + 0.5) ** 2,
      [(-2, 2), (-2, 2)], Ns=11, full_output=True)
  _close(fvals, REF["brute2"][3])
  np.testing.assert_allclose(x2, [1.0, -0.5], atol=1e-4)
  assert fvals.shape == (11, 11)


def test_scalar_min_frontends(REF):
  f = lambda x: (x - 1.2) ** 2 + 3.0
  got = O.fminbound(f, -4, 4, xtol=1e-10)
  _close(got, REF["fminbound"])
  assert abs(got - 1.2) < 1e-6
  got = O.brent(f, brack=(-4, 0, 4))
  _close(got, REF["brent"])
  assert abs(got - 1.2) < 1e-5
  got = O.golden(f, brack=(-4, 0, 4))
  _close(got, REF["golden"])
  assert abs(got - 1.2) < 1e-5
  out = O.bracket(lambda x: float(f(x)), -5.0, -4.0)
  assert out == REF["bracket"]
  xa, xb, xc, fa, fb, fc, calls = out
  assert fb < fa and fb < fc and (xa < xb < xc or xc < xb < xa)


def test_derivative_helpers_and_classes():
  f = lambda x: float(np.sum(x ** 2))
  g = lambda x: 2 * x
  x0 = np.array([1.0, -2.0, 0.5])
  assert O.check_grad(f, g, x0) == RO.check_grad(f, g, x0)
  assert O.check_grad(f, g, x0) < 1e-5
  fp = O.approx_fprime(x0, f)
  np.testing.assert_array_equal(fp, RO.approx_fprime(x0, f))
  np.testing.assert_allclose(fp, 2 * x0, atol=1e-5)
  b = O.Bounds(np.zeros(2), np.ones(2))
  lo_r, hi_r = b.residual(np.array([0.25, 0.5]))
  np.testing.assert_allclose(lo_r, [0.25, 0.5])
  lc = O.LinearConstraint(np.eye(2), 0, 1)
  assert lc.A.shape == (2, 2)
  rr = O.RootResults(1.5, 10, 12, 0, method="brentq")
  assert rr.converged and "1.5" in repr(rr)
  assert issubclass(O.OptimizeWarning, UserWarning)
  H = O.BFGS()
  H.initialize(2, "hess")
  assert isinstance(H, O.HessianUpdateStrategy)
  for name in ("BFGS", "SR1", "LbfgsInvHessProduct", "BroydenFirst",
               "InverseJacobian", "KrylovJacobian", "NoConvergence",
               "OptimizeWarning", "HessianUpdateStrategy"):
    assert getattr(O, name) is getattr(RO, name) is getattr(sopt, name)


def test_host_boundary_optimizers():
  runs = fio.counts["host_runs"]
  res = O.linprog(np.array([1.0, 2.0]), A_ub=np.array([[-1.0, -1.0]]),
                  b_ub=np.array([-1.0]), bounds=[(0, None)] * 2)
  assert res.success and abs(res.fun - 1.0) < 1e-8
  yv = O.isotonic_regression(np.array([3.0, 1.0, 2.0]))
  assert np.all(np.diff(yv.x) >= 0)
  x = O.broyden1(
      lambda v: np.asarray([v[0] + 0.5 * v[1] - 1.0,
                            0.5 * v[0] + v[1] - 2.0]),
      np.zeros(2), f_tol=1e-12)
  np.testing.assert_allclose(x, np.linalg.solve(
      np.array([[1.0, 0.5], [0.5, 1.0]]), [1.0, 2.0]), atol=1e-8)
  sol = O.fmin_slsqp(lambda p: np.sum((p - 2.0) ** 2), np.zeros(2),
                     bounds=[(0.0, 1.0)] * 2, iprint=0)
  np.testing.assert_allclose(sol, [1.0, 1.0], atol=1e-6)
  assert fio.counts["host_runs"] == runs + 4


def test_code_review_r5_regressions(REF):
  """Bounds-object DE, complex-step brute slices, catchable NoConvergence,
  powell's 6-tuple, l_bfgs_b's gradient."""
  res = O.differential_evolution(
      lambda p: torch.sum((p - 0.5) ** 2),
      O.Bounds(np.zeros(2), np.ones(2)), seed=0, tol=1e-8)
  np.testing.assert_allclose(res.x, 0.5, atol=1e-3)
  x = O.brute(lambda p: ((p[0] - 1.0) ** 2).squeeze(),
              (slice(-3, 3, 61j),), finish=None)
  assert abs(float(x) - 1.0) < 0.11
  assert O.NoConvergence is sopt.NoConvergence
  with pytest.raises(O.NoConvergence):
    O.broyden1(lambda v: np.asarray([v[0] ** 2 + 1.0]), np.zeros(1),
               maxiter=3)
  out = O.fmin_powell(lambda p: torch.sum((p - 1.0) ** 2), np.zeros(2),
                      full_output=True)
  assert len(out) == 6 and out[2].shape == (2, 2)
  np.testing.assert_allclose(out[0], 1.0, atol=1e-3)
  np.testing.assert_allclose(REF["powell"][0], 1.0, atol=1e-3)
  assert out[5] == 0 == REF["powell"][5]
  xb, fb, info = O.fmin_l_bfgs_b(lambda p: torch.sum((p - 2.0) ** 2),
                                 np.zeros(2), bounds=[(0, 5.0), (0, 5.0)])
  _close(xb, REF["l_bfgs_b_5"][0])
  _close(info["grad"], REF["l_bfgs_b_5"][2]["grad"])
  np.testing.assert_allclose(info["grad"], 2 * (np.asarray(xb) - 2.0),
                             atol=1e-6)
  assert "funcalls" in info


# -- the port's own choices --------------------------------------------------

@pytest.mark.parametrize("m,n", [(60, 3), (2, 5)])
def test_the_jacobian_takes_the_orientation_with_fewer_passes(m, n):
  """m ≥ n: n columns by the double-vjp ``jvp``; m < n: m reverse rows.
  Both equal the reference's ``jacfwd`` (TOL)."""
  import jax

  W = np.random.default_rng(7).normal(size=(m, n))
  x = np.linspace(0.2, 1.0, n)
  fn = lambda p: torch.sin(torch.as_tensor(W) @ p) * p[0]
  before = dict(opt_mod.counts)
  r, J = opt_mod._jacobian(fn, torch.as_tensor(x))
  cols = opt_mod.counts["jacobian_columns"] - before["jacobian_columns"]
  rows = opt_mod.counts["jacobian_rows"] - before["jacobian_rows"]
  assert (cols, rows) == ((n, 0) if m >= n else (0, m))
  want = jax.jacfwd(lambda p: jnp.sin(jnp.asarray(W) @ p) * p[0])(
      jnp.asarray(x))
  _close(J.numpy(), np.asarray(want))


def test_a_fit_builds_its_jacobian_by_columns():
  """curve_fit over 60 samples of 3 parameters: 3 column passes a
  Jacobian, none by rows (60 would be the reverse orientation)."""
  before = dict(opt_mod.counts)
  res = O.least_squares(_res_torch, np.ones(3))
  cols = opt_mod.counts["jacobian_columns"] - before["jacobian_columns"]
  assert cols == 3 * (res.nfev + 1)
  assert opt_mod.counts["jacobian_rows"] == before["jacobian_rows"]


def _sweep():
  return {
      "least_squares": lambda: O.least_squares(_res_torch, np.ones(3)),
      "root": lambda: O.root(lambda p: torch.stack(
          [p[0] ** 2 + p[1] - 3.0, p[0] - p[1] ** 3 + 1.0]), [1.0, 1.0]),
      "bisect": lambda: O.bisect(lambda x: x ** 3 - 2, 0.0, 2.0),
      "newton": lambda: O.newton(lambda x: x ** 2 - 2.0, 1.0),
      "brentq": lambda: O.brentq(lambda x: x ** 3 - 2 * x - 5, 2, 3),
      "ridder": lambda: O.ridder(lambda x: x ** 3 - 2 * x - 5, 2, 3),
      "minimize_scalar": lambda: O.minimize_scalar(
          lambda x: (x - 1.7) ** 2, bounds=(0.0, 5.0)),
      "minimize_bounded": lambda: O.minimize(
          _rosen_torch, np.zeros(2), bounds=[(-2.0, 0.8)] * 2),
      "fixed_point": lambda: O.fixed_point(
          lambda x: torch.sqrt(10.0 / (x + 4.0)), 1.5),
      "fmin": lambda: O.fmin(O.rosen, np.array([1.3, 0.9])),
      "differential_evolution": lambda: O.differential_evolution(
          lambda p: torch.sum((p - 0.5) ** 2), [(0, 1), (0, 1)], seed=0,
          polish=False),
  }


@pytest.mark.parametrize("name", sorted(_sweep()))
def test_each_loop_reads_the_host_once_a_turn(name):
  """A loop turn reads its stop test on the host once (the reference's is
  one jitted while_loop; a while_loop of the port reads its condition
  once a turn, ROADMAP Watch list).  A loop that tests before its first
  turn reads once more."""
  before = dict(opt_mod.counts)
  _sweep()[name]()
  turns = opt_mod.counts["turns"] - before["turns"]
  reads = opt_mod.counts["reads"] - before["reads"]
  assert turns > 0
  assert turns <= reads <= turns + 1


def test_objectives_lower_through_the_plain_routes(monkeypatch):
  """Every objective is lowered with ``differentiable=True``, so no route
  reaches a kernel wrapper: the wrappers are replaced by ones that fail
  the test, and a fit, a root, a bounded minimum, a simplex and an
  evolution run through objectives holding sums, products and dots."""
  from spartan_tpu_torch.backend.kernels import build
  from spartan_tpu_torch.backend.kernels import fused_reduce as K1
  from spartan_tpu_torch.backend.kernels import matmul as K2

  flags = []
  real = opt_mod.as_function

  def recording(out, wrt, differentiable=False):
    flags.append(differentiable)
    return real(out, wrt, differentiable=differentiable)

  def no_kernel(*args, **kwargs):
    raise AssertionError("a kernel wrapper was reached")

  monkeypatch.setattr(opt_mod, "as_function", recording)
  for mod, name in ((build, "launch"), (K1, "fused_sum"), (K2, "matmul")):
    monkeypatch.setattr(mod, name, no_kernel)
  M = sp.from_numpy(np.random.default_rng(2).normal(size=(6, 3)))
  resid = lambda p: sp.dot(M, p) - 1.0
  loss = lambda p: sp.sum((p - 0.25) ** 2) + sp.sum(sp.dot(M, p) ** 2)
  O.least_squares(resid, np.zeros(3))
  O.root(lambda p: sp.dot(sp.from_numpy(np.eye(3) * 2.0), p) - 1.0,
         np.zeros(3))
  O.minimize(loss, np.zeros(3), bounds=[(-1, 1)] * 3)
  O.fmin(loss, np.zeros(3), maxiter=20)
  O.differential_evolution(loss, [(-1, 1)] * 3, seed=0, maxiter=3,
                           polish=False)
  assert flags and all(flags)


def test_a_function_vmap_cannot_run_raises_with_its_reason():
  """A population method over a function that reads a value on the host
  (``.item()``) raises ``ValueError`` naming vmap, and runs nothing
  else."""
  def host_branch(p):
    return torch.sum(p ** 2) if p[0].item() > 0 else torch.sum(p)

  with pytest.raises(ValueError, match="vmap"):
    O.differential_evolution(host_branch, [(0, 1), (0, 1)], seed=0)


@pytest.mark.parametrize("n", [8, 64])
def test_bfgs_takes_the_references_steps_where_its_line_search_fails(n):
  """From zeros on the n-parameter Rosenbrock function the reference's
  BFGS (jax.scipy.optimize's) stops with a failed line search (status 3)
  far from the minimum, where scipy's BFGS converges: a property of the
  reference's algorithm, which the port keeps step for step (the same
  iterations and status; x at 1e-8 and f at 1e-9 relative: 95 steps
  along the curved valley carry the ulps in which torch's and XLA's sums
  differ to about 2e-9 in x and 1e-10 in f); ``chip_smoke.py``'s phase 23
  holds the card to the same outcome at n = 64."""
  got = O.minimize(_rosen_torch, np.zeros(n))
  want = RO.minimize(_rosen_jnp, np.zeros(n))
  assert (got.nit, got.status, got.success) == (want.nit, want.status,
                                                want.success)
  assert want.status == 3 and not want.success
  _close(got.x, want.x, 1e-8)
  assert got.fun == pytest.approx(want.fun, rel=1e-9)
  best = sopt.minimize(sopt.rosen, np.zeros(n), jac=sopt.rosen_der,
                       method="BFGS", options={"gtol": 1e-10})
  assert best.success and np.abs(best.x - 1.0).max() < 1e-6
