"""``sp.integrate``: the scipy.integrate surface (port of
``spartan_tpu/integrate.py``).

* **The sampled rules** (``trapezoid``, ``cumulative_trapezoid``,
  ``simpson``, ``cumulative_simpson``, ``romb``) are lazy exprs on the
  device: weighted reductions whose weights depend only on the grid
  (built on the host once), a cumulative sum of panel areas, and scipy's
  sub-interval formulas of ``cumulative_simpson`` as one map (the
  reference runs that one through scipy on the host).
* **The quadratures of a function** (``fixed_quad``, ``qmc_quad``,
  ``tanhsinh``) evaluate it on all their nodes in one batch on the device:
  ``torch.func.vmap`` (nested for ``qmc_quad``) where the reference has
  ``jax.vmap``; a function vmap cannot run raises ``ValueError`` with
  vmap's reason.  The Halton points come from ``scipy.stats.qmc`` on the
  host, as in the reference.
* **``solve_ivp`` RK45/RK23** is an adaptive Runge–Kutta loop over tensors
  on the device.  Its carry is t, y, the FSAL derivative, h, the
  ``t_eval`` buffer, the step count and the status; the stages are a
  Python loop over the tableau (the reference's ``fori_loop``); every step
  fills the ``t_eval`` points it crossed by cubic Hermite interpolation,
  a masked select over the whole buffer; accept and reject are
  ``torch.where`` selects; the end test is read on the host once a step
  (counted in ``optimize.counts``).  ``fun(t, y)`` takes and returns
  torch tensors (t 0-d, y (n,), float64); a list of 0-d tensors is
  stacked.  ``t_eval=None`` returns the endpoints only (the adaptive step
  count is a data-dependent shape).
* **Host boundaries**, each counted in ``expr.fio.counts["host_runs"]`` and
  noticed once a process: QUADPACK (``quad``, ``dblquad``, ...), the stiff
  methods, DOP853, events, ``dense_output`` and ``vectorized`` of
  ``solve_ivp``, ``odeint``, ``nsum``, ``solve_bvp``, ``lebedev_rule``.
  Their functions receive NumPy arrays, as scipy calls them.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

import spartan_tpu_torch as sp
from spartan_tpu_torch import optimize as _opt
from spartan_tpu_torch.core.array import SpartanArray
from spartan_tpu_torch.expr import fio
from spartan_tpu_torch.expr.base import Expr
from spartan_tpu_torch.expr.map import structural
from spartan_tpu_torch.util import log_info

__all__ = [
    "trapezoid", "cumulative_trapezoid", "simpson", "cumulative_simpson",
    "romb", "fixed_quad", "newton_cotes", "qmc_quad", "tanhsinh",
    "solve_ivp", "odeint",
    "quad", "quad_vec", "dblquad", "tplquad", "nquad", "cubature",
    "nsum", "solve_bvp", "lebedev_rule",
    "OdeResult", "IntegrationWarning", "ODEintWarning",
    "RK23", "RK45", "DOP853", "Radau", "BDF", "LSODA",
    "OdeSolver", "OdeSolution", "DenseOutput", "ode", "complex_ode",
]

# scipy's solver and stepper classes and warnings are host-side objects,
# scipy's own, so isinstance checks and warning filters work
from scipy.integrate import (  # noqa: E402
    IntegrationWarning, ODEintWarning, RK23, RK45, DOP853, Radau, BDF,
    LSODA, OdeSolver, OdeSolution, DenseOutput, ode, complex_ode,
)

_DT = torch.float64


class OdeResult(_opt.OptimizeResult):
  """scipy-style bunch result (attribute access over a dict), an
  ``OptimizeResult`` as scipy's is."""


def _to_last(y: Expr, axis: int) -> Expr:
  return sp.moveaxis(y, axis, -1) if axis not in (-1, y.ndim - 1) else y


# ---------------------------------------------------------------------
# sampled-data rules
# ---------------------------------------------------------------------

def trapezoid(y, x=None, dx: float = 1.0, axis: int = -1):
  """Composite trapezoid: the builtins' ``trapezoid`` reduction."""
  return sp.trapezoid(y, x=x, dx=dx, axis=axis)


def cumulative_trapezoid(y, x=None, dx: float = 1.0, axis: int = -1,
                         initial=None):
  """Cumulative trapezoid: one lazy cumsum over the panel areas."""
  y = sp.lazify(y)
  yl = _to_last(y, axis)
  if x is not None:
    x = sp.lazify(x)
    d = x[1:] - x[:-1] if x.ndim == 1 else sp.moveaxis(
        x, axis, -1)[..., 1:] - sp.moveaxis(x, axis, -1)[..., :-1]
  else:
    d = dx
  panels = d * (yl[..., 1:] + yl[..., :-1]) / 2.0
  out = sp.cumsum(panels, axis=-1)
  if initial is not None:
    if initial != 0:
      raise ValueError("`initial` must be 0 or None (scipy 1.17)")
    pad = sp.zeros(tuple(out.shape[:-1]) + (1,), dtype=out.aval().dtype)
    out = sp.concatenate([pad, out], axis=-1)
  if axis not in (-1, y.ndim - 1):
    out = sp.moveaxis(out, -1, axis)
  return out


def _simpson_weights(n: int) -> np.ndarray:
  """Composite Simpson weights for n samples (odd n exact; even n uses
  scipy's corrected last interval)."""
  w = np.zeros(n)
  if n < 3:
    return np.array([0.5, 0.5])[:n] * (1 if n == 2 else 0)
  m = n if n % 2 == 1 else n - 1
  w[0:m - 2:2] += 1.0 / 3    # left ends
  w[1:m - 1:2] += 4.0 / 3    # midpoints
  w[2:m:2] += 1.0 / 3        # right ends
  if n % 2 == 0:  # scipy's even-sample correction (last 3 points)
    w[-3] += -1.0 / 12
    w[-2] += 8.0 / 12
    w[-1] += 5.0 / 12
  return w


def simpson(y, x=None, dx: float = 1.0, axis: int = -1):
  """Composite Simpson: one weighted lazy reduction.  Non-uniform ``x``
  takes scipy's per-pair quadratic formula, its weights built on the host
  (they depend only on the grid)."""
  y = sp.lazify(y)
  n = y.shape[axis]
  yl = _to_last(y, axis)
  if x is None:
    return sp.sum(yl * sp.Val(_simpson_weights(n) * dx), axis=-1)
  x = np.asarray(_opt._glommed(x), dtype=float)
  if x.ndim != 1 or x.size != n:
    raise ValueError("x must be 1-D with len(x) == y.shape[axis]")
  w = np.zeros(n)
  m = n if n % 2 == 1 else n - 1
  for i in range(0, m - 2, 2):
    h0, h1 = x[i + 1] - x[i], x[i + 2] - x[i + 1]
    hsum, hprod = h0 + h1, h0 * h1
    h0div = h0 / h1 if h1 != 0 else 0.0
    w[i] += hsum / 6.0 * (2.0 - 1.0 / h0div if h0div else 0.0)
    w[i + 1] += hsum / 6.0 * (hsum * hsum / hprod if hprod else 0.0)
    w[i + 2] += hsum / 6.0 * (2.0 - h0div)
  if n % 2 == 0:  # trailing interval: scipy's corrected trapezoid
    h0 = x[-2] - x[-3] if n >= 3 else 0.0
    h1 = x[-1] - x[-2]
    if n >= 3 and h0 > 0:
      alpha = (2 * h1 * h1 + 3 * h0 * h1) / (6 * (h0 + h1))
      beta = (h1 * h1 + 3 * h0 * h1) / (6 * h0)
      eta = h1 ** 3 / (6 * h0 * (h0 + h1))
      w[-1] += alpha
      w[-2] += beta
      w[-3] -= eta
    else:
      w[-2] += h1 / 2
      w[-1] += h1 / 2
  return sp.sum(yl * sp.Val(w), axis=-1)


def _simpson_pieces(y: torch.Tensor, d: torch.Tensor, equal: bool):
  """scipy's integrals over the first interval of each sample triple
  (its ``_cumulative_simpson_equal_intervals``/``_unequal_intervals``)."""
  f1, f2, f3 = y[..., :-2], y[..., 1:-1], y[..., 2:]
  if equal:
    return d[..., :-1] / 3 * (5 * f1 / 4 + 2 * f2 - f3 / 4)
  x21, x32 = d[..., :-1], d[..., 1:]
  x31 = x21 + x32
  x21_x31 = x21 / x31
  x21_x32 = x21 / x32
  x21x21_x31x32 = x21_x31 * x21_x32
  return x21 / 6 * ((3 - x21_x31) * f1 + (3 + x21x21_x31x32 + x21_x31) * f2
                    - x21x21_x31x32 * f3)


@structural
def _cumulative_simpson_fn(y, d, equal: bool):
  """scipy's ``_cumulatively_sum_simpson_integrals`` along the last axis:
  the first interval of each pair from the forward formula, the second
  (and the last) from the backward one, then a cumulative sum."""
  d = torch.broadcast_to(d, y.shape[:-1] + (y.shape[-1] - 1,))
  h1 = _simpson_pieces(y, d, equal)
  h2 = torch.flip(_simpson_pieces(torch.flip(y, (-1,)), torch.flip(d, (-1,)),
                                  equal), (-1,))
  sub = torch.empty(h1.shape[:-1] + (h1.shape[-1] + 1,), dtype=h1.dtype,
                    device=h1.device)
  sub[..., :-1:2] = h1[..., ::2]
  sub[..., 1::2] = h2[..., ::2]
  sub[..., -1] = h2[..., -1]
  return torch.cumsum(sub, dim=-1)


def cumulative_simpson(y, *, x=None, dx: float = 1.0, axis: int = -1,
                       initial=None):
  """Cumulative Simpson, scipy's algorithm on the device (the reference
  runs scipy on the host): fewer than 3 samples give the cumulative
  trapezoid, as scipy's."""
  y = sp.lazify(y)
  if y.dtype not in (torch.float32, torch.float64, torch.complex64,
                     torch.complex128):
    y = y.astype(np.float64)
  axis = axis % y.ndim
  yl = _to_last(y, axis)
  if yl.shape[-1] < 3:
    out = cumulative_trapezoid(yl, x=x, dx=dx, axis=-1)
  else:
    if x is not None:
      xe = sp.lazify(x)
      if not (tuple(xe.shape) == tuple(y.shape)
              or (xe.ndim == 1 and xe.shape[0] == y.shape[axis])):
        raise ValueError("If given, shape of `x` must be the same as `y` or "
                         "1-D with the same length as `y` along `axis`.")
      xl = _to_last(xe, axis) if xe.ndim > 1 else xe
      d = xl[..., 1:] - xl[..., :-1]
      if bool(np.any(_opt._glommed(d) <= 0)):
        raise ValueError("Input x must be strictly increasing.")
      equal = False
    else:
      d = sp.lazify(np.asarray(dx, dtype=np.float64))
      if d.ndim:
        d = _to_last(d, axis)
      equal = True
    out = sp.map([yl, d], _cumulative_simpson_fn, fn_kw={"equal": equal})
  if initial is not None:
    init = sp.lazify(np.asarray(initial, dtype=np.float64))
    init = sp.broadcast_to(init, tuple(out.shape[:-1]) + (1,))
    out = sp.concatenate([init, out + init], axis=-1)
  return sp.moveaxis(out, -1, axis) if axis != y.ndim - 1 else out


def _romb_weights(n: int, dx: float) -> np.ndarray:
  """The weights of scipy's ``romb`` over ``n = 2**k + 1`` samples.  Its
  estimate is linear in the samples: the Richardson tableau run on the
  k + 1 trapezoid rules as unit vectors gives each rule's coefficient,
  and rule i sums every ``2**(k - i)``-th sample at step ``h / 2**i``."""
  k = int(np.log2(n - 1))
  R = {(i, 0): np.eye(k + 1)[i] for i in range(k + 1)}
  for i in range(1, k + 1):
    for j in range(1, i + 1):
      prev = R[(i, j - 1)]
      R[(i, j)] = prev + (prev - R[(i - 1, j - 1)]) / ((1 << (2 * j)) - 1)
  coef = R[(k, k)]
  w = np.zeros(n)
  for i in range(k + 1):
    h = (n - 1) * dx / (1 << i)
    w[::1 << (k - i)] += coef[i] * h
    w[0] -= coef[i] * h / 2
    w[-1] -= coef[i] * h / 2
  return w


def romb(y, dx: float = 1.0, axis: int = -1, show: bool = False):
  """Romberg integration of 2**k + 1 samples: the Richardson tableau's
  weights (grid-only, :func:`_romb_weights`) applied as one device
  reduction."""
  del show
  y = sp.lazify(y)
  n = y.shape[axis]
  k = int(np.log2(n - 1)) if n > 1 else -1
  if n < 2 or 2 ** k + 1 != n:
    raise ValueError("Number of samples must be one plus a power of 2")
  return sp.sum(_to_last(y, axis) * sp.Val(_romb_weights(n, dx)), axis=-1)


def _vmapped(fn: Callable, depth: int = 1) -> Callable:
  """``fn`` under ``depth`` nested ``torch.func.vmap``s; a function vmap
  cannot run raises ``ValueError`` with vmap's reason."""
  for _ in range(depth):
    fn = torch.func.vmap(fn)

  def call(pts):
    try:
      return fn(pts)
    except Exception as err:  # re-raised with vmap's reason; no fallback
      raise ValueError(f"the integrand cannot run under torch.func.vmap: "
                       f"{err}") from err
  return call


def fixed_quad(func, a: float, b: float, args=(), n: int = 5):
  """Fixed-order Gauss–Legendre: nodes on the host, one evaluation of
  ``func`` over all n nodes on the device (an expr-native ``func`` gets
  them as a lazy leaf, a torch one as a tensor)."""
  nodes, weights = np.polynomial.legendre.leggauss(int(n))
  xm = 0.5 * (b + a) + 0.5 * (b - a) * nodes
  try:  # expr-native objective (TypeError: torch ops reject Exprs)
    fx = func(sp.Val(xm), *args)
  except (TypeError, AttributeError):
    fx = None
  if isinstance(fx, Expr):
    val = 0.5 * (b - a) * sp.sum(fx * sp.Val(weights), axis=-1)
    return float(np.asarray(sp.lazify(val).glom())), None
  dev = _opt._device()
  fx = _opt._as_tensor(func(torch.as_tensor(xm, device=dev), *args), dev)
  w = torch.as_tensor(weights, device=dev)
  return float(0.5 * (b - a) * torch.sum(fx * w, dim=-1)), None


def newton_cotes(rn, equal: int = 0):
  """Newton–Cotes weights: exact host combinatorics (scipy's)."""
  import scipy.integrate as si
  return si.newton_cotes(rn, equal)


def qmc_quad(func, a, b, *, n_estimates: int = 8, n_points: int = 1024,
             qrng=None, log: bool = False):
  """Quasi-Monte-Carlo integration: the points come from the host
  generator (``scipy.stats.qmc``), and all ``n_estimates * n_points``
  evaluations run as one nested vmap batch on the device."""
  from scipy.stats import qmc as _qmc
  a = np.atleast_1d(np.asarray(a, float))
  b = np.atleast_1d(np.asarray(b, float))
  d = a.size
  rng = qrng if qrng is not None else _qmc.Halton(d, seed=0)
  sets = np.stack([rng.random(n_points) for _ in range(n_estimates)])
  pts = a + sets * (b - a)              # (E, N, d)
  vol = float(np.prod(b - a))
  dev = _opt._device()
  vals = _vmapped(lambda x: _opt._as_tensor(func(x), dev), depth=2)(
      torch.as_tensor(pts, device=dev))
  ests = (vals.mean(dim=1) * vol).cpu().numpy()
  mean = float(ests.mean())
  se = float(ests.std(ddof=1) / np.sqrt(n_estimates))
  if log:
    mean, se = np.log(mean), se / abs(mean)
  return OdeResult(integral=mean, standard_error=se)


def tanhsinh(f, a: float, b: float, *, args=(), log: bool = False,
             maxlevel: int = 10, minlevel: int = 2, atol=None,
             rtol=None, preserve_shape: bool = False, callback=None):
  """tanh-sinh (double-exponential) quadrature, fixed-level: the abscissae
  of every level up to ``maxlevel`` come from the host, each level's
  function values in one vmap batch on the device, and the last two
  levels' estimates make the error report (scipy iterates levels
  adaptively on the host)."""
  del log, preserve_shape, callback
  if atol is None:
    atol = 0.0
  if rtol is None:
    rtol = 1e-12
  levels = []
  for h in [2.0 ** -k for k in range(minlevel, maxlevel + 1)]:
    t = np.arange(-int(4.0 / h), int(4.0 / h) + 1) * h
    x = np.tanh(0.5 * np.pi * np.sinh(t))
    w = h * 0.5 * np.pi * np.cosh(t) / np.cosh(0.5 * np.pi *
                                               np.sinh(t)) ** 2
    keep = np.abs(x) < 1.0 - 1e-15
    levels.append((x[keep], w[keep]))
  half = 0.5 * (b - a)
  mid = 0.5 * (b + a)
  dev = _opt._device()
  one = _vmapped(lambda x: _opt._as_tensor(f(x, *args), dev))
  ests = []
  for x, w in levels:
    vals = one(torch.as_tensor(mid + half * x, device=dev))
    ests.append(half * float(torch.sum(vals * torch.as_tensor(w, device=dev))))
  err = abs(ests[-1] - ests[-2]) if len(ests) > 1 else np.inf
  ok = err <= max(atol, rtol * abs(ests[-1]))
  return OdeResult(integral=ests[-1], error=err, success=bool(ok),
                   status=0 if ok else -2, maxlevel=maxlevel)


# ---------------------------------------------------------------------
# solve_ivp: adaptive Runge–Kutta on the device
# ---------------------------------------------------------------------

# Dormand–Prince 5(4) tableau (scipy's RK45)
_DP_A = np.array([
    [0, 0, 0, 0, 0, 0],
    [1 / 5, 0, 0, 0, 0, 0],
    [3 / 40, 9 / 40, 0, 0, 0, 0],
    [44 / 45, -56 / 15, 32 / 9, 0, 0, 0],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729, 0, 0],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656, 0],
])
_DP_C = np.array([0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1])
_DP_B = np.array([35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784,
                  11 / 84, 0])
_DP_E = np.array([71 / 57600, 0, -71 / 16695, 71 / 1920,
                  -17253 / 339200, 22 / 525, -1 / 40])

# Bogacki–Shampine 3(2) (scipy's RK23)
_BS_A = np.array([[0, 0, 0], [1 / 2, 0, 0], [0, 3 / 4, 0]])
_BS_C = np.array([0, 1 / 2, 3 / 4])
_BS_B = np.array([2 / 9, 1 / 3, 4 / 9, 0])
_BS_E = np.array([5 / 72, -1 / 12, -1 / 9, 1 / 8])

_HOST_IVP_METHODS = ("Radau", "BDF", "LSODA", "DOP853")

def _host_array(out) -> np.ndarray:
  if isinstance(out, (Expr, torch.Tensor, SpartanArray)):
    return np.asarray(_opt._glommed(out), dtype=float)
  return np.asarray(out, dtype=float)


def solve_ivp(fun, t_span, y0, method: str = "RK45", t_eval=None,
              dense_output: bool = False, events=None, vectorized=False,
              args=None, rtol: float = 1e-3, atol: float = 1e-6,
              max_step: float = np.inf, first_step=None,
              max_steps: int = 100_000):
  """Initial-value ODE solve.

  ``RK45``/``RK23`` run as one adaptive loop on the device: the carry is
  (t, y, f_FSAL, h, output buffer); every accepted step fills the
  ``t_eval`` points it crossed by cubic-Hermite interpolation, a masked
  select over the whole buffer; the end of the interval is read on the
  host once a step.  Stiff methods (Radau/BDF/LSODA) and DOP853, events,
  ``dense_output`` and ``vectorized`` route to scipy on the host.

  ``t_eval=None`` returns the endpoints only (t=[t0, tf]): the adaptive
  interior step count is a data-dependent shape."""
  t0, tf = float(t_span[0]), float(t_span[1])
  if args is not None:
    _f = fun
    fun = lambda t, y: _f(t, y, *args)
  if (method in _HOST_IVP_METHODS or events is not None or dense_output
      or vectorized):
    import scipy.integrate as si
    _host_notice(f"solve_ivp[{method}]"
                 if method in _HOST_IVP_METHODS else
                 "solve_ivp[events/dense_output]")
    return si.solve_ivp(lambda t, y: _host_array(fun(t, y)),
                        (t0, tf), _host_array(y0), method=method,
                        t_eval=t_eval, dense_output=dense_output,
                        events=events, rtol=rtol, atol=atol,
                        max_step=max_step, first_step=first_step)
  if method not in ("RK45", "RK23"):
    raise ValueError(f"unknown method {method!r}")
  A, C, B, E = ((_DP_A, _DP_C, _DP_B, _DP_E) if method == "RK45"
                else (_BS_A, _BS_C, _BS_B, _BS_E))
  err_exp = -1.0 / (5.0 if method == "RK45" else 3.0)
  n_stages = len(C)

  dev = _opt._device()
  y0a = (y0.to(device=dev, dtype=_DT).reshape(-1)
         if isinstance(y0, torch.Tensor)
         else torch.as_tensor(np.atleast_1d(np.asarray(_host_array(y0))),
                              device=dev).reshape(-1))
  n = y0a.numel()
  direction = 1.0 if tf >= t0 else -1.0
  te = (np.asarray(t_eval, float) if t_eval is not None
        else np.array([t0, tf]))
  if t_eval is not None:
    lo, hi = min(t0, tf), max(t0, tf)
    if te.min() < lo - 1e-12 or te.max() > hi + 1e-12:
      raise ValueError("t_eval values must lie within t_span")
  m = te.size
  tev = torch.as_tensor(te, device=dev)

  def fj(t, y):
    return _opt._as_tensor(fun(t, y), dev).reshape(n)

  # the tableau, the end point and the bounds on the device, made once
  Aj = torch.as_tensor(A, device=dev)
  Cj = torch.as_tensor(C, device=dev)
  Bj = torch.as_tensor(B[:n_stages], device=dev)
  Ej = torch.as_tensor(E, device=dev)
  t_end = torch.tensor(tf, dtype=_DT, device=dev)
  hmax = torch.tensor(max_step, dtype=_DT, device=dev)
  one = torch.ones((), dtype=_DT, device=dev)

  t = torch.tensor(t0, dtype=_DT, device=dev)
  f = fj(t, y0a)
  # scipy's initial-step heuristic (its first stage)
  sc = atol + rtol * torch.abs(y0a)
  d0 = torch.sqrt(torch.mean((y0a / sc) ** 2))
  d1 = torch.sqrt(torch.mean((f / sc) ** 2))
  h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6 * one, 0.01 * d0 / d1)
  h = (torch.tensor(float(first_step), dtype=_DT, device=dev)
       if first_step is not None
       else torch.minimum(h0, torch.abs(t_end - t)))
  h = torch.minimum(h, hmax)
  ys = torch.zeros((m, n), dtype=_DT, device=dev)
  # t_eval points exactly at t0 fill immediately
  at0 = torch.abs(tev - t0) <= 1e-14 * max(1.0, abs(t0))
  ys = torch.where(at0[:, None], y0a[None, :], ys)
  y = y0a
  K = torch.zeros((n_stages + 1, n), dtype=_DT, device=dev)
  k, status = 0, 0
  while status == 0 and _opt._read(
      direction * (t_end - t) > 1e-14 * torch.clamp(torch.abs(t), min=1.0)):
    _opt._turn()
    h = torch.minimum(h, hmax)
    h = torch.minimum(h, torch.abs(t_end - t))
    hd = direction * h
    # stages (FSAL: stage 0's derivative is carried)
    K[0] = f
    for i in range(1, n_stages):
      K[i] = fj(t + Cj[i] * hd, y + hd * (Aj[i] @ K[:n_stages]))
    y_new = y + hd * (Bj @ K[:n_stages])
    f_new = fj(t + hd, y_new)
    K[n_stages] = f_new
    err = hd * (Ej @ K)
    scale = atol + rtol * torch.maximum(torch.abs(y), torch.abs(y_new))
    enorm = torch.sqrt(torch.mean((err / scale) ** 2))
    accept = enorm <= 1.0
    factor = torch.clamp(0.9 * torch.pow(torch.clamp(enorm, min=1e-16),
                                         err_exp), 0.2, 10.0)
    h2 = torch.clamp(h * factor, min=1e-14)
    # fill the crossed t_eval points by cubic Hermite on (t, t + hd)
    theta = (tev - t) / torch.where(hd == 0, one, hd)
    in_step = accept & (theta > 0.0) & (theta <= 1.0)
    th = theta[:, None]
    h00 = 2 * th ** 3 - 3 * th ** 2 + 1
    h10 = th ** 3 - 2 * th ** 2 + th
    h01 = -2 * th ** 3 + 3 * th ** 2
    h11 = th ** 3 - th ** 2
    interp = (h00 * y[None, :] + h10 * hd * f[None, :]
              + h01 * y_new[None, :] + h11 * hd * f_new[None, :])
    ys = torch.where(in_step[:, None], interp, ys)
    t = torch.where(accept, t + hd, t)
    y = torch.where(accept, y_new, y)
    f = torch.where(accept, f_new, f)
    h = h2
    k += 1
    if k >= max_steps:
      status = -1
  # the final point lands exactly by construction
  at_tf = torch.abs(tev - tf) <= 1e-12 * max(1.0, abs(tf))
  ys = torch.where(at_tf[:, None], y[None, :], ys)
  res_t = te if t_eval is not None else np.array([t0, tf])
  ya = ys.T.cpu().numpy()
  if t_eval is None:
    ya = np.stack([y0a.cpu().numpy(), y.cpu().numpy()], axis=1)
  return OdeResult(
      t=res_t, y=ya, success=status == 0, status=status,
      message=("The solver successfully reached the end of the "
               "integration interval." if status == 0
               else "Step limit reached."),
      nfev=k * (n_stages + 1), njev=0, nlu=0, sol=None,
      t_events=None, y_events=None)


def odeint(func, y0, t, args=(), Dfun=None, full_output: int = 0,
           tfirst: bool = False, **kw):
  """LSODA odeint — host boundary (stiff/non-stiff switching with per-step
  Jacobian factorizations).  The device path is :func:`solve_ivp`
  (RK45/RK23)."""
  _host_notice("odeint")
  import scipy.integrate as si

  def f(y, tt, *a):
    return _host_array(func(y, tt, *a) if not tfirst else func(tt, y, *a))

  return si.odeint(f, _opt._glommed(y0), _opt._glommed(t), args=args,
                   Dfun=Dfun, full_output=full_output, **kw)


# ---------------------------------------------------------------------
# host boundaries: adaptive QUADPACK / BVP / series
# ---------------------------------------------------------------------

_host_noticed: set = set()


def _host_notice(name):
  """Say once a process that ``name`` runs on the host; count the run."""
  fio.counts["host_runs"] += 1
  if name in _host_noticed:
    return
  _host_noticed.add(name)
  log_info(
      "sp.integrate.%s: globally-adaptive/sequential algorithm — runs "
      "EAGERLY on the host (scipy.integrate), the sp.linalg.eig "
      "convention.", name)


def _host_int(name, *args, **kw):
  _host_notice(name)
  import scipy.integrate as si
  return getattr(si, name)(*args, **kw)


def quad(func, a, b, args=(), full_output=0, **kw):
  """Adaptive QUADPACK quadrature — host boundary (for a device batch use
  :func:`fixed_quad`/:func:`tanhsinh`/:func:`qmc_quad`)."""
  return _host_int("quad", func, a, b, args=args,
                   full_output=full_output, **kw)


def quad_vec(f, a, b, **kw):
  return _host_int("quad_vec", f, a, b, **kw)


def dblquad(func, a, b, gfun, hfun, args=(), **kw):
  return _host_int("dblquad", func, a, b, gfun, hfun, args=args, **kw)


def tplquad(func, a, b, gfun, hfun, qfun, rfun, args=(), **kw):
  return _host_int("tplquad", func, a, b, gfun, hfun, qfun, rfun,
                   args=args, **kw)


def nquad(func, ranges, args=None, opts=None, full_output=False):
  return _host_int("nquad", func, ranges, args=args, opts=opts,
                   full_output=full_output)


def cubature(f, a, b, **kw):
  return _host_int("cubature", f, a, b, **kw)


def nsum(f, a, b, *, step=1, args=(), log=False, maxterms=None,
         tolerances=None):
  kw = {} if maxterms is None else {"maxterms": maxterms}
  if tolerances is not None:
    kw["tolerances"] = tolerances
  return _host_int("nsum", f, a, b, step=step, args=args, log=log, **kw)


def solve_bvp(fun, bc, x, y, p=None, S=None, fun_jac=None, bc_jac=None,
              tol: float = 1e-3, max_nodes: int = 1000, verbose=0):
  """Two-point BVP collocation — host boundary (an adaptive mesh)."""
  return _host_int("solve_bvp", fun, bc, np.asarray(x), np.asarray(y),
                   p=p, S=S, fun_jac=fun_jac, bc_jac=bc_jac, tol=tol,
                   max_nodes=max_nodes, verbose=verbose)


def lebedev_rule(n):
  """Lebedev sphere quadrature nodes and weights — host tables."""
  return _host_int("lebedev_rule", n)
