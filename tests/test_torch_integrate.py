"""``sp.integrate`` of the port (``spartan_tpu_torch/integrate.py``) against
the reference's (``spartan_tpu/integrate.py``) and scipy, on the same
seeded float64 data: a counterpart of every test of the reference's
``tests/test_integrate.py``, then the port's own choices pinned (one host
read a solver step, the device ``cumulative_simpson`` and ``romb``
weights, the host boundaries' counts, vmap's refusal).

Integrands are jnp for the reference and torch for the port; an
expr-native one is written once over ``m``.  The reference's results are
computed once for the module (``REF``).

Tolerances: the sampled rules at the reference test's 1e-12 against
scipy and the reference (the same weights summed in another order);
``solve_ivp`` RK45/RK23 at 1e-10 against the reference with the same
step count (the same tableau and controller, the step sizes rounding a
few ulps apart), and at the reference test's 1e-5 (Hermite
interpolation) and 1e-7 (end point) against scipy; the quadratures of a
function at 1e-12 against the reference (one batch of the same nodes)
and at the reference test's bounds against scipy and the closed forms.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.integrate as si
import torch

import spartan_tpu as ref

import spartan_tpu_torch as sp
from spartan_tpu_torch import optimize as opt_mod
from spartan_tpu_torch.expr import fio

RI, I = ref.integrate, sp.integrate

rng = np.random.default_rng(9)
X = np.sort(rng.uniform(0, 4, 31))
Y = np.sin(X) + 0.1 * X
XE = np.sort(rng.uniform(0, 2, 30))
YR = np.exp(np.linspace(0, 1, 17))
TE = np.linspace(0, 10, 25)
TOL = 1e-10


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


def g(x):
  """A result of either package (or a plain value) on the host."""
  if hasattr(x, "glom"):
    return np.asarray(x.glom())
  if isinstance(x, torch.Tensor):
    return x.numpy()
  return np.asarray(x)


def _osc_jnp(t, y):
  return jnp.stack([y[1], -jnp.sin(y[0]) - 0.1 * y[1]])


def _osc_torch(t, y):
  return torch.stack([y[1], -torch.sin(y[0]) - 0.1 * y[1]])


@pytest.fixture(scope="module")
def REF():
  R = {}
  R["osc"] = RI.solve_ivp(_osc_jnp, (0, 10), [1.0, 0.0], t_eval=TE,
                          rtol=1e-8, atol=1e-10)
  R["decay"] = RI.solve_ivp(lambda t, y: -y, (0, 2), [1.0], rtol=1e-9,
                            atol=1e-12)
  R["rk23"] = RI.solve_ivp(lambda t, y: -y, (0, 1), [1.0], method="RK23",
                           t_eval=np.linspace(0, 1, 5), rtol=1e-7,
                           atol=1e-10)
  R["back"] = RI.solve_ivp(lambda t, y: -y, (2, 0), [np.exp(-2.0)],
                           rtol=1e-9, atol=1e-12)
  R["args"] = RI.solve_ivp(lambda t, y, k: -k * y, (0, 1), [1.0],
                           args=(2.0,), t_eval=np.array([1.0]), rtol=1e-9,
                           atol=1e-12)
  R["fixed_quad"] = RI.fixed_quad(lambda x: jnp.exp(-x) * jnp.sin(3 * x),
                                  0, 2, n=12)
  R["tanhsinh"] = RI.tanhsinh(lambda x: jnp.exp(-x * x), -3.0, 3.0)
  R["qmc"] = RI.qmc_quad(lambda x: jnp.sum(x ** 2), np.zeros(2), np.ones(2),
                         n_points=512)
  return R


def test_sampled_rules_match_scipy():
  want = si.trapezoid(Y, X)
  got = float(g(I.trapezoid(Y, X)))
  np.testing.assert_allclose(got, want, atol=1e-12)
  np.testing.assert_allclose(got, float(g(RI.trapezoid(Y, X))), atol=1e-12)
  for kw in ({}, {"initial": 0}):
    got = g(I.cumulative_trapezoid(Y, X, **kw))
    np.testing.assert_allclose(got, si.cumulative_trapezoid(Y, X, **kw),
                               atol=1e-12)
    np.testing.assert_allclose(got, g(RI.cumulative_trapezoid(Y, X, **kw)),
                               atol=1e-12)
  for n in (21, 20):  # uniform simpson, odd and even sample counts
    yy = np.cos(np.linspace(0, 3, n))
    got = float(g(I.simpson(yy, dx=3 / (n - 1))))
    np.testing.assert_allclose(got, si.simpson(yy, dx=3 / (n - 1)),
                               atol=1e-12)
    np.testing.assert_allclose(got, float(g(RI.simpson(yy, dx=3 / (n - 1)))),
                               atol=1e-12)
  for x in (X, XE):  # non-uniform simpson, odd and even
    yv = np.sin(x) + 0.1 * x
    got = float(g(I.simpson(yv, x=x)))
    np.testing.assert_allclose(got, si.simpson(yv, x=x), atol=1e-10)
    np.testing.assert_allclose(got, float(g(RI.simpson(yv, x=x))),
                               atol=1e-12)
  got = float(g(I.romb(YR, dx=1 / 16)))
  np.testing.assert_allclose(got, si.romb(YR, dx=1 / 16), atol=1e-12)
  np.testing.assert_allclose(got, float(g(RI.romb(YR, dx=1 / 16))),
                             atol=1e-12)
  got = g(I.cumulative_simpson(YR, dx=1 / 16))
  np.testing.assert_allclose(got, si.cumulative_simpson(YR, dx=1 / 16),
                             atol=1e-12)
  np.testing.assert_allclose(got, g(RI.cumulative_simpson(YR, dx=1 / 16)),
                             atol=1e-12)


def test_fixed_quad_and_newton_cotes(REF):
  got, _ = I.fixed_quad(lambda x: torch.exp(-x) * torch.sin(3 * x), 0, 2,
                        n=12)
  want, _ = si.fixed_quad(lambda x: np.exp(-x) * np.sin(3 * x), 0, 2, n=12)
  assert abs(got - want) < 1e-12
  assert abs(got - REF["fixed_quad"][0]) < 1e-12
  expr, _ = I.fixed_quad(lambda x: sp.exp(-x) * sp.sin(3 * x), 0, 2, n=12)
  assert abs(expr - want) < 1e-12
  an, B = I.newton_cotes(4)
  anw, Bw = si.newton_cotes(4)
  np.testing.assert_allclose(an, anw)
  assert B == Bw


def test_tanhsinh_and_qmc(REF):
  r = I.tanhsinh(lambda x: torch.exp(-x * x), -3.0, 3.0)
  assert r.success and abs(r.integral - np.sqrt(np.pi)
                           + 2 * 2.2e-5) < 1e-4  # erf tail ~2.2e-5
  assert abs(r.integral - float(si.tanhsinh(
      lambda x: np.exp(-x * x), -3.0, 3.0).integral)) < 1e-9
  assert abs(r.integral - REF["tanhsinh"].integral) < 1e-12
  assert r.status == REF["tanhsinh"].status
  q = I.qmc_quad(lambda x: torch.sum(x ** 2), np.zeros(2), np.ones(2),
                 n_points=512)
  assert abs(q.integral - 2.0 / 3) < 5e-3
  # the same Halton points (scipy's, seed 0) in both packages
  assert abs(q.integral - REF["qmc"].integral) < 1e-12
  assert abs(q.standard_error - REF["qmc"].standard_error) < 1e-12


def test_solve_ivp_rk45_matches_scipy(REF):
  got = I.solve_ivp(_osc_torch, (0, 10), [1.0, 0.0], t_eval=TE, rtol=1e-8,
                    atol=1e-10)
  want = si.solve_ivp(lambda t, y: [y[1], -np.sin(y[0]) - 0.1 * y[1]],
                      (0, 10), [1.0, 0.0], t_eval=TE, rtol=1e-10,
                      atol=1e-12)
  assert got.success
  assert got.y.shape == (2, 25)
  np.testing.assert_allclose(got.y, want.y, atol=1e-5)
  np.testing.assert_allclose(got.y[:, -1], want.y[:, -1], atol=1e-7)
  np.testing.assert_allclose(got.y, REF["osc"].y, rtol=0, atol=TOL)
  assert got.nfev == REF["osc"].nfev


def test_solve_ivp_variants(REF):
  got = I.solve_ivp(lambda t, y: -y, (0, 2), [1.0], rtol=1e-9, atol=1e-12)
  assert got.t.shape == (2,) and got.y.shape == (1, 2)
  np.testing.assert_allclose(got.y[0, -1], np.exp(-2.0), atol=1e-8)
  np.testing.assert_allclose(got.y, REF["decay"].y, rtol=0, atol=TOL)
  assert got.nfev == REF["decay"].nfev
  g23 = I.solve_ivp(lambda t, y: -y, (0, 1), [1.0], method="RK23",
                    t_eval=np.linspace(0, 1, 5), rtol=1e-7, atol=1e-10)
  np.testing.assert_allclose(g23.y[0], np.exp(-g23.t), atol=1e-5)
  np.testing.assert_allclose(g23.y, REF["rk23"].y, rtol=0, atol=TOL)
  assert g23.nfev == REF["rk23"].nfev
  gb = I.solve_ivp(lambda t, y: -y, (2, 0), [np.exp(-2.0)], rtol=1e-9,
                   atol=1e-12)
  np.testing.assert_allclose(gb.y[0, -1], 1.0, atol=1e-7)
  np.testing.assert_allclose(gb.y, REF["back"].y, rtol=0, atol=TOL)
  ga = I.solve_ivp(lambda t, y, k: -k * y, (0, 1), [1.0], args=(2.0,),
                   t_eval=np.array([1.0]), rtol=1e-9, atol=1e-12)
  np.testing.assert_allclose(ga.y[0, 0], np.exp(-2.0), atol=1e-7)
  np.testing.assert_allclose(ga.y, REF["args"].y, rtol=0, atol=TOL)
  runs = fio.counts["host_runs"]
  gs = I.solve_ivp(lambda t, y: np.asarray([-50 * (y[0] - np.cos(t))]),
                   (0, 1), [0.0], method="BDF")
  assert gs.success and fio.counts["host_runs"] == runs + 1
  with pytest.raises(ValueError):
    I.solve_ivp(lambda t, y: -y, (0, 1), [1.0], method="RK99")
  with pytest.raises(ValueError):
    I.solve_ivp(lambda t, y: -y, (0, 1), [1.0], t_eval=np.array([5.0]))


def test_odeint_and_quadpack_host():
  runs = fio.counts["host_runs"]
  t = np.linspace(0, 3, 7)
  got = I.odeint(lambda y, tt: -y, np.array([1.0]), t)
  np.testing.assert_allclose(got[:, 0], np.exp(-t), atol=1e-6)
  v, err = I.quad(lambda x: np.exp(-x), 0, np.inf)
  assert abs(v - 1.0) < 1e-10
  v2, _ = I.dblquad(lambda y, x: x * y, 0, 1, 0, 1)
  assert abs(v2 - 0.25) < 1e-10
  assert fio.counts["host_runs"] == runs + 3
  assert I.RK45 is si.RK45 is RI.RK45
  assert issubclass(I.IntegrationWarning, UserWarning)


@pytest.mark.parametrize("ns", ["integrate", "optimize"])
def test_integrate_parity_audit_covers_namespace(ns):
  """Every public scipy name of the namespace the reference's parity
  audit (``tools/scipy_parity.py``) counts in scope is in the port's."""
  import importlib.util
  spec = importlib.util.spec_from_file_location(
      "scipy_parity", "tools/scipy_parity.py")
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  scipy_mod = {"integrate": mod._integrate_mod,
               "optimize": lambda: __import__("scipy.optimize").optimize}[ns]()
  ours = getattr(sp, ns)
  have = {n for n in dir(ours) if not n.startswith("_")}
  names = mod._public(scipy_mod, True)
  missing = [n for n in names
             if n not in have and n not in mod.OUT_OF_SCOPE.get(ns, {})]
  assert missing == []


# -- the port's own choices --------------------------------------------------

def test_a_solve_reads_the_host_once_a_step():
  """The end of the interval is read once a step; the reference's loop is
  one jitted while_loop."""
  before = dict(opt_mod.counts)
  res = I.solve_ivp(_osc_torch, (0, 10), [1.0, 0.0], t_eval=TE, rtol=1e-8,
                    atol=1e-10)
  turns = opt_mod.counts["turns"] - before["turns"]
  reads = opt_mod.counts["reads"] - before["reads"]
  assert turns == res.nfev // 7 and reads == turns + 1


def test_a_list_of_scalars_is_stacked():
  """``fun`` returning a list of 0-d tensors is stacked, as the
  reference's ``jnp.asarray(...).reshape(n)``."""
  a = I.solve_ivp(lambda t, y: [y[1], -y[0]], (0, 1), [1.0, 0.0],
                  rtol=1e-9, atol=1e-12)
  b = I.solve_ivp(lambda t, y: torch.stack([y[1], -y[0]]), (0, 1),
                  [1.0, 0.0], rtol=1e-9, atol=1e-12)
  np.testing.assert_array_equal(a.y, b.y)
  np.testing.assert_allclose(a.y[:, -1], [np.cos(1.0), -np.sin(1.0)],
                             atol=1e-8)


@pytest.mark.parametrize("n", [2, 3, 5, 9, 17, 33, 129, 1025])
def test_romb_weights_equal_scipys_tableau(n):
  """``romb``'s weights come from the tableau run on the trapezoid rules
  (the reference's run scipy's romb on each row of ``eye(n)``, O(n²)):
  held to scipy's romb on random samples at 1e-12 of their scale."""
  yv = np.random.default_rng(n).normal(size=n)
  got = float(g(I.romb(yv, dx=0.3)))
  np.testing.assert_allclose(got, si.romb(yv, dx=0.3), rtol=0,
                             atol=1e-12 * max(1.0, np.abs(yv).sum()))


@pytest.mark.parametrize("case", ["equal", "unequal", "initial", "axis",
                                  "two_samples", "dx_array", "int"])
def test_cumulative_simpson_on_the_device_equals_scipys(case):
  """scipy's sub-interval formulas as one map on the device (the
  reference runs scipy on the host), 1e-12."""
  r = np.random.default_rng(4)
  yv = r.normal(size=(3, 11, 4))
  x = np.sort(r.uniform(0, 3, 11))
  kw, arr = {
      "equal": ({"dx": 0.2, "axis": 1}, yv),
      "unequal": ({"x": x, "axis": 1}, yv),
      "initial": ({"x": x, "axis": 1, "initial": 0.5}, yv),
      "axis": ({"dx": 0.1, "axis": 0}, yv),
      "two_samples": ({"dx": 0.2, "axis": 1}, yv[:, :2]),
      "dx_array": ({"dx": r.uniform(0.1, 0.3, size=(3, 1, 4)), "axis": 1},
                   yv),
      "int": ({"dx": 0.5}, np.arange(9)),
  }[case]
  runs = fio.counts["host_runs"]
  got = g(I.cumulative_simpson(arr, **kw))
  want = si.cumulative_simpson(arr, **kw)
  assert got.shape == want.shape and got.dtype == want.dtype
  np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
  assert fio.counts["host_runs"] == runs


def test_an_integrand_vmap_cannot_run_raises_with_its_reason():
  def host_branch(x):
    return torch.exp(x) if x.item() > 0 else x

  with pytest.raises(ValueError, match="vmap"):
    I.tanhsinh(host_branch, 0.0, 1.0)
