"""``sp.optimize``: the scipy.optimize surface (port of
``spartan_tpu/optimize.py``).

Objective and residual functions are either

* **expr-native**: a callable receiving a lazy ``Expr`` parameter vector
  and returning an ``Expr`` built from ``sp.*`` ops, or
* **torch**: a callable on torch tensors (``torch.exp``, ``torch.stack``,
  Python arithmetic), wrapped into the lazy layer as one ``sp.map`` node,
  where the reference's callables use ``jnp``.

Both lower through :func:`spartan_tpu_torch.autodiff.as_function` with
``differentiable=True``: every route takes its plain version, and a kernel
wrapper handed a tensor that requires grad raises (``build.check_operands``).

Each of the reference's fused ``jax.lax.while_loop`` solvers is a Python
``while`` over tensors on the device.  Its accept/reject and bracket
decisions are ``torch.where`` selects on the device, as the reference's
``jnp.where`` are, and its stop test is read on the host once a turn
(:func:`_read`, counted in :data:`counts`).  Constants (the damping bounds,
``1e-14 I``, the step fractions) are made on the device before the loop.
Derivatives are eager ``torch.autograd`` (the fixed rule of ``autodiff``):
a Jacobian is built as n columns by the double-vjp ``jvp`` where it has at
least as many rows as columns (a fit over m samples of n parameters), else
as m reverse rows (:func:`_jacobian`); a Hessian is n rows of reverse over
reverse.  A population (a simplex, a differential-evolution generation, a
brute-force grid) is evaluated by ``torch.func.vmap`` over the lowered
function; a function vmap cannot run raises ``ValueError`` with vmap's
reason.  Everything computes in float64 (the reference's dtype under x64).

The scalar solvers (``bisect``, ``newton``, ``brentq``, ``ridder``,
``minimize_scalar``, ``bracket``) hand the user's function a 0-d float64
tensor on the device, where the reference hands a jnp scalar; an ``sp.*``
result is lowered the same way.  Their results are Python floats.

Host boundaries, each counted in ``expr.fio.counts["host_runs"]`` and
noticed once a process: ``linear_sum_assignment``, ``nnls``, ``linprog``,
``milp``, the global optimizers (``basinhopping``, ``dual_annealing``,
``shgo``, ``direct``), ``isotonic_regression``, ``quadratic_assignment``,
``line_search``, the ``nonlin`` mixers, ``fmin_cobyla`` and ``fmin_slsqp``.
"""

from __future__ import annotations

import inspect
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

import spartan_tpu_torch as sp
from spartan_tpu_torch.autodiff import as_function
from spartan_tpu_torch.core.array import SpartanArray
from spartan_tpu_torch.core.mesh import get_mesh
from spartan_tpu_torch.expr import fio
from spartan_tpu_torch.expr.base import Expr, Val
from spartan_tpu_torch.expr.sort_expr import argsort as _argsort
from spartan_tpu_torch.util import log_info

__all__ = [
    "OptimizeResult", "least_squares", "curve_fit", "root",
    "root_scalar", "bisect", "newton", "minimize_scalar", "minimize",
    "linear_sum_assignment", "nnls",
]

# ``turns``: loop iterations run; ``reads``: values read on the host inside
# them (the stop test, once a turn); ``jacobian_columns``/``_rows``: the
# autograd passes the Jacobians took, by orientation
counts: Dict[str, int] = {"turns": 0, "reads": 0, "jacobian_columns": 0,
                          "jacobian_rows": 0}


class OptimizeResult(dict):
  """scipy-style result: a dict with attribute access."""

  def __getattr__(self, name):
    try:
      return self[name]
    except KeyError as e:
      raise AttributeError(name) from e

  __setattr__ = dict.__setitem__

  def __repr__(self):
    return "\n".join(f"{k}: {v}" for k, v in sorted(self.items()))


_DT = torch.float64


def _device() -> torch.device:
  return get_mesh().device


def _read(t: torch.Tensor):
  """A loop's stop test read on the host: the one sync of a turn."""
  counts["reads"] += 1
  return t.item()


def _turn():
  counts["turns"] += 1


def _const(v, like: torch.Tensor) -> torch.Tensor:
  """A constant filled on ``like``'s device (not copied from host memory)."""
  return torch.full((), v, dtype=like.dtype, device=like.device)


def _as_tensor(out, device=None) -> torch.Tensor:
  """A user function's value as a float64 tensor: an ``Expr`` is lowered
  through the plain routes (its leaves keep their autograd graph), a list
  of 0-d tensors is stacked (``jnp.asarray`` of a list), a number filled
  on the device."""
  if isinstance(out, Expr):
    fn, _ = as_function(out, [], differentiable=True)
    out = fn()
  if isinstance(out, SpartanArray):
    out = out.data
  if isinstance(out, (list, tuple)):
    out = torch.stack([_as_tensor(o, device).reshape(()) for o in out])
  if not isinstance(out, torch.Tensor):
    return torch.as_tensor(np.asarray(out, dtype=np.float64),
                           device=device or _device())
  return out.to(_DT)


def _probe_objective(fun, leaf, args):
  """Lower a user callable to an Expr on ``leaf``, distinguishing "not
  expr-native" from "expr-native but buggy".

  TypeError/AttributeError from the probe call means the callable's ops
  reject an Expr argument (torch ops) — fall back to one ``sp.map`` node.
  Any other exception is remembered: if the map path then also fails (its
  shape inference is forced here, so bugs surface now, not inside a
  solver loop), the probe error is chained as the likely real bug."""
  probe_err = None
  try:
    out = fun(leaf, *args)
  except (TypeError, AttributeError):
    out = None
  except Exception as e:  # remembered and chained below
    probe_err = e
    out = None
  if isinstance(out, Expr):
    return out
  name = getattr(fun, "__name__", repr(fun))
  try:
    out = sp.map([leaf], _on_tensors(fun, args, leaf.leaf_value()))
    out.shape  # force the shape inference so genuine bugs raise here
    return out
  except Exception as e2:
    if probe_err is not None:
      raise RuntimeError(
          f"objective {name!r} failed both on the lazy Expr parameter "
          f"({probe_err!r}) and on torch tensors ({e2!r}); the first "
          "error is likely the real bug in the objective") from probe_err
    raise


def _on_tensors(fun, args, start: torch.Tensor) -> Callable:
  """``fun`` as a map function over torch tensors.  Its shape is inferred
  by one evaluation at the start point, not over meta tensors: a torch
  objective closes over data tensors on the device (``curve_fit``'s
  samples), which meta tensors do not mix with."""
  def call(p):
    if p.device.type == "meta":
      with torch.no_grad():
        out = _as_tensor(fun(start, *args), start.device)
      return torch.empty(out.shape, dtype=out.dtype, device="meta")
    return _as_tensor(fun(p, *args), p.device)
  return call


def _lower(fun, x0, args) -> Tuple[Callable, torch.Tensor]:
  """Callable → torch ``f(p)`` of the raveled float64 parameter vector,
  through the lazy layer's plain routes, and that vector on the device."""
  x0 = np.ravel(np.atleast_1d(np.asarray(x0, dtype=np.float64)))
  leaf = sp.lazify(x0)
  if not isinstance(leaf, Val):  # pragma: no cover
    raise TypeError("could not build a parameter leaf")
  out = _probe_objective(fun, leaf, args)
  fn, fargs = as_function(out, [leaf], differentiable=True)
  return (lambda p: _as_tensor(fn(p)).reshape(-1)), fargs[0].to(_DT)


def _jacobian(fn: Callable, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
  """``(fn(x), d fn / d x)``, the Jacobian (m, n) built by the orientation
  that takes fewer autograd passes: n columns by the double-vjp ``jvp``
  (``J e_j = d/du <Jᵀ u, e_j>``) where m ≥ n, else m reverse rows."""
  xl = x.detach().requires_grad_()
  r = fn(xl)
  m, n = r.numel(), xl.numel()
  if not r.requires_grad:
    return r.detach(), torch.zeros((m, n), dtype=r.dtype, device=r.device)
  if m >= n:
    u = torch.zeros_like(r, requires_grad=True)
    (vjp,) = torch.autograd.grad(r, xl, grad_outputs=u, create_graph=True)
    cols = []
    for j in range(n):
      counts["jacobian_columns"] += 1
      c = None
      if vjp.requires_grad:
        (c,) = torch.autograd.grad(vjp[j], u, retain_graph=True,
                                   allow_unused=True)
      cols.append(torch.zeros_like(r) if c is None else c)
    J = torch.stack(cols, dim=1)
  else:
    rows = []
    for i in range(m):
      counts["jacobian_rows"] += 1
      (g,) = torch.autograd.grad(r[i], xl, retain_graph=True,
                                 allow_unused=True)
      rows.append(torch.zeros_like(xl) if g is None else g)
    J = torch.stack(rows)
  return r.detach(), J.detach()


def _grad(f: Callable, x: torch.Tensor, create_graph: bool = False):
  """``(f(x), ∇f(x), leaf)`` of a scalar ``f``."""
  xl = x.detach().requires_grad_()
  y = f(xl)
  if not y.requires_grad:
    return y.detach(), torch.zeros_like(xl), xl
  (g,) = torch.autograd.grad(y, xl, create_graph=create_graph)
  return y.detach(), g, xl


def _hessian(f: Callable, x: torch.Tensor):
  """``(∇f(x), ∇²f(x))``: n rows of reverse over reverse."""
  _, g, xl = _grad(f, x, create_graph=True)
  rows = []
  for k in range(xl.numel()):
    h = None
    if g.requires_grad:
      (h,) = torch.autograd.grad(g[k], xl, retain_graph=True,
                                 allow_unused=True)
    rows.append(torch.zeros_like(xl) if h is None else h)
  return g.detach(), torch.stack(rows).detach()


def _solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """``A⁻¹ b`` by LU, reading nothing on the host (a singular ``A`` gives
  inf/nan, as ``jnp.linalg.solve``; ``torch.linalg.solve`` would sync to
  raise)."""
  return torch.linalg.solve_ex(A, b)[0]


def _vmap(f: Callable, pts: torch.Tensor) -> torch.Tensor:
  """``f`` over the rows of ``pts`` in one batch (the reference's
  ``jax.vmap``)."""
  try:
    return torch.func.vmap(f)(pts)
  except Exception as err:  # re-raised with vmap's reason; nothing falls back
    raise ValueError(f"the objective cannot run under torch.func.vmap: "
                     f"{err}") from err


def _scalar_fn(f, args) -> Callable:
  """The user's scalar function as ``x (0-d float64 tensor) → 0-d float64
  tensor``."""
  return lambda x: _as_tensor(f(x, *args), x.device).reshape(())


def _t(v) -> torch.Tensor:
  return torch.tensor(float(v), dtype=_DT, device=_device())


# ---------------------------------------------------------------------
# nonlinear least squares
# ---------------------------------------------------------------------

def _parse_bounds(bounds, n, pairs=False):
  """scipy bounds forms → (lo, hi) (n,) float64 tensors (±inf when
  unbounded).

  ``pairs=True`` is the minimize convention (a (lo, hi) pair per
  parameter, or a Bounds object); ``pairs=False`` is the least_squares
  convention (one global (lo, hi) of scalars-or-arrays).  The two are
  shape-ambiguous at n=2, so the caller says which."""
  if bounds is None:
    bounds = (-np.inf, np.inf)
    pairs = False
  if hasattr(bounds, "lb"):  # scipy.optimize.Bounds
    lo, hi = bounds.lb, bounds.ub
  elif pairs:
    b = np.asarray(
        [[-np.inf if l is None else l, np.inf if h is None else h]
         for (l, h) in bounds], dtype=float)
    lo, hi = b[:, 0], b[:, 1]
  else:
    lo, hi = bounds
  lo = np.broadcast_to(np.asarray(lo, dtype=np.float64), (n,))
  hi = np.broadcast_to(np.asarray(hi, dtype=np.float64), (n,))
  if np.any(lo > hi):
    raise ValueError("each lower bound must be <= its upper bound")
  dev = _device()
  return (torch.as_tensor(np.array(lo), device=dev),
          torch.as_tensor(np.array(hi), device=dev))


def _frozen(x, g, lo, hi) -> torch.Tensor:
  """The Bertsekas active set as a float mask of the FREE coordinates:
  a coordinate at a bound with the gradient pushing outward is frozen."""
  eps = 1e-10 + 1e-8 * torch.abs(x)
  frozen = ((torch.isfinite(lo) & (x <= lo + eps) & (g > 0)) |
            (torch.isfinite(hi) & (x >= hi - eps) & (g < 0)))
  return (~frozen).to(x.dtype)


def least_squares(fun, x0, args=(), method: str = None,
                  bounds=(-np.inf, np.inf),
                  xtol: float = 1e-10, gtol: float = 1e-10,
                  ftol: float = 1e-10, max_nfev: int = 200):
  """Nonlinear least squares: a damped-Newton loop (residual, Jacobian,
  normal equations, trust-region damping update) on the device, its
  status read once a turn.

  ``method`` defaults to 'lm' unbounded and 'trf' when finite ``bounds``
  are given (scipy's 'lm' rejects bounds).  The bounded path is a
  projected LM: each trial step is clipped into the box and optimality
  is measured on the projected gradient ``x - clip(x - g, lo, hi)``, the
  KKT measure scipy's TRF reports.  The normal equations are formed
  explicitly (few parameters).

  Returns an :class:`OptimizeResult` with scipy's fields (``x``, ``cost``,
  ``fun``, ``jac``, ``grad``, ``optimality``, ``status``, ``success``,
  ``nfev``)."""
  resfn, x0 = _lower(fun, x0, args)
  n = x0.numel()
  lo, hi = _parse_bounds(bounds, n)
  bounded = bool(np.any(np.isfinite(lo.cpu().numpy()))
                 or np.any(np.isfinite(hi.cpu().numpy())))
  if method is None:
    method = "trf" if bounded else "lm"
  if method not in ("lm", "gn", "trf"):
    raise ValueError(f"method must be 'lm', 'gn' or 'trf', got {method!r}")
  if method in ("lm", "gn") and bounded:
    raise ValueError(f"method {method!r} doesn't support bounds; "
                     "use method='trf'")

  def clip(x):
    return torch.clamp(x, lo, hi) if bounded else x

  def proj_grad(x, g):
    return x - torch.clamp(x - g, lo, hi) if bounded else g

  def cost_of(r):
    return 0.5 * torch.dot(r, r)

  eye = torch.eye(n, dtype=_DT, device=x0.device)
  tiny = 1e-14 * eye
  one, zero = (torch.ones((), dtype=torch.int32, device=x0.device),
               torch.zeros((), dtype=torch.int32, device=x0.device))
  x = clip(x0)
  cost = cost_of(resfn(x))
  lam = _const(1e-3, x)
  it, status = 0, 0
  while status == 0 and it < max_nfev:
    _turn()
    r, J = _jacobian(resfn, x)
    g = J.T @ r
    H = J.T @ J
    if bounded:
      F = _frozen(x, g, lo, hi)
      H = H * (F[:, None] * F[None, :]) + torch.diag(1.0 - F)
      g_solve = g * F
    else:
      g_solve = g
    if method != "gn":
      damp = lam * torch.diag(torch.clamp(torch.diagonal(H), min=1e-12))
      dx = -_solve(H + damp + tiny, g_solve)
    else:
      dx = -_solve(H + tiny, g_solve)
    x2 = clip(x + dx)
    step = x2 - x
    c2 = cost_of(resfn(x2))
    accept = c2 < cost
    # scipy status codes: 1 gtol, 2 ftol, 3 xtol
    st = torch.where(torch.max(torch.abs(proj_grad(x, g))) < gtol, one, zero)
    st = torch.where((st == 0) & accept &
                     (cost - c2 <= ftol * torch.clamp(cost, min=1e-30)),
                     2 * one, st)
    st = torch.where((st == 0) & accept &
                     (torch.linalg.vector_norm(step) <
                      xtol * (xtol + torch.linalg.vector_norm(x))),
                     3 * one, st)
    x = torch.where(accept, x2, x)
    lam = torch.where(accept, torch.clamp(lam / 3.0, min=1e-12),
                      torch.clamp(lam * 3.0, max=1e12))
    cost = torch.where(accept, c2, cost)
    it += 1
    status = int(_read(st))
  r, J = _jacobian(resfn, x)
  g = J.T @ r
  pg = proj_grad(x, g)
  return OptimizeResult(
      x=x.cpu().numpy(), cost=float(cost_of(r)), fun=r.cpu().numpy(),
      jac=J.cpu().numpy(), grad=g.cpu().numpy(),
      optimality=float(torch.max(torch.abs(pg))),
      nfev=it, njev=it, status=status,
      success=bool(status in (1, 2, 3)),
      message={0: "max_nfev reached", 1: "gtol satisfied",
               2: "ftol satisfied", 3: "xtol satisfied"}[status])


def curve_fit(f, xdata, ydata, p0=None, sigma=None,
              absolute_sigma: bool = False, **lsq_kw):
  """Fit ``f(x, *params)`` to data (scipy.optimize.curve_fit's contract:
  returns ``(popt, pcov)``).  Rides :func:`least_squares`; the covariance
  comes from the final Jacobian's normal equations, scaled by the
  residual variance unless ``absolute_sigma``.

  ``xdata`` and ``ydata`` go to the device once, as float64 tensors (a
  tensor already there stays); ``f`` receives ``xdata`` as that tensor
  and the parameters as 0-d tensors (or lazy exprs, for an expr-native
  ``f``)."""
  dev = _device()
  xd = (xdata.to(dev) if isinstance(xdata, torch.Tensor)
        else torch.as_tensor(np.asarray(xdata), device=dev))
  yd = (ydata.to(device=dev, dtype=_DT) if isinstance(ydata, torch.Tensor)
        else torch.as_tensor(np.asarray(ydata, dtype=float), device=dev))
  if xd.is_floating_point():
    xd = xd.to(_DT)
  if p0 is None:
    sig = inspect.signature(f)
    n = len(sig.parameters) - 1
    if n < 1:
      raise ValueError("cannot infer parameter count; pass p0")
    p0 = np.ones(n)
  p0 = np.atleast_1d(np.asarray(p0, dtype=float))
  n = p0.size
  w = None if sigma is None else 1.0 / torch.as_tensor(
      np.asarray(sigma, dtype=float), device=dev)

  def residual(p):
    if isinstance(p, Expr):  # the probe: expr-native models see exprs
      model = f(sp.lazify(xd), *[p[i] for i in range(n)])
      r = model - sp.lazify(yd)
      return r if w is None else r * sp.lazify(w)
    model = f(xd, *[p[i] for i in range(n)])
    r = _as_tensor(model, dev) - yd
    return r if w is None else r * w

  res = least_squares(residual, p0, **lsq_kw)
  m = res.fun.size
  JtJ = res.jac.T @ res.jac
  try:
    cov = np.linalg.inv(JtJ)
  except np.linalg.LinAlgError:
    cov = np.linalg.pinv(JtJ)
  if not absolute_sigma:
    dof = max(m - n, 1)
    cov = cov * (2.0 * res.cost / dof)
  return res.x, cov


# ---------------------------------------------------------------------
# root finding
# ---------------------------------------------------------------------

_ALPHAS = (1.0, 0.5, 0.25, 0.125)


def root(fun, x0, args=(), method: str = "newton", tol: float = 1e-10,
         maxiter: int = 100):
  """Vector root find: damped Newton with a 4-point backtracking line
  search (Jacobian, solve, four trial residuals and the pick among them
  on the device; the residual norm read once a turn).  scipy's 'hybr'
  (MINPACK dogleg) is accepted as an alias: the same fixed points, another
  globalization."""
  if method not in ("newton", "hybr"):
    raise ValueError(f"unknown method {method!r}")
  ffn, x = _lower(fun, x0, args)
  n = x.numel()
  tiny = 1e-14 * torch.eye(n, dtype=_DT, device=x.device)
  alphas = torch.tensor(_ALPHAS, dtype=_DT, device=x.device)[:, None]
  f0 = ffn(x)
  fn2 = torch.dot(f0, f0)
  it = 0
  while it < maxiter and _read(fn2 > tol * tol):
    _turn()
    fv, J = _jacobian(ffn, x)
    dx = -_solve(J + tiny, fv)
    cands = x[None, :] + alphas * dx[None, :]
    norms = torch.stack([torch.dot(fc, fc) for fc in
                         (ffn(c) for c in cands)])
    k = torch.argmin(norms)
    x, fn2 = cands[k], norms[k]
    it += 1
  fv = ffn(x)
  fva = fv.cpu().numpy()
  fnorm = float(np.max(np.abs(fva)))
  return OptimizeResult(
      x=x.cpu().numpy(), fun=fva, nfev=it * 5, nit=it,
      success=bool(fnorm <= tol * max(1.0, fnorm + 1.0)
                   or float(np.dot(fva, fva)) <= tol * tol),
      message="converged" if float(np.dot(fva, fva)) <= tol * tol
      else "maxiter reached")


def bisect(f, a, b, args=(), xtol: float = 1e-12, maxiter: int = 200,
           full_output: bool = False):
  """Scalar bisection (f must bracket a root): the interval halves on the
  device, its width read once a turn.

  ``full_output=True`` also returns ``(iterations, converged)`` from the
  solver's own stopping criterion (interval width <= xtol)."""
  fj = _scalar_fn(f, args)
  fa, fb = float(fj(_t(a))), float(fj(_t(b)))
  if fa == 0:
    return (float(a), 0, True) if full_output else float(a)
  if fb == 0:
    return (float(b), 0, True) if full_output else float(b)
  if fa * fb > 0:
    raise ValueError("f(a) and f(b) must have opposite signs")
  a, b = _t(a), _t(b)
  it = 0
  while it < maxiter and _read(b - a > xtol):
    _turn()
    m = 0.5 * (a + b)
    left = fj(a) * fj(m) <= 0
    a, b = torch.where(left, a, m), torch.where(left, m, b)
    it += 1
  root_, width = float(0.5 * (a + b)), float(b - a)
  if full_output:
    return root_, it, bool(width <= xtol)
  return root_


def newton(func, x0, args=(), tol: float = 1.48e-8, maxiter: int = 50,
           full_output: bool = False):
  """Scalar Newton iteration (the derivative by autograd), the step read
  once a turn.

  ``full_output=True`` also returns ``(iterations, converged)``, where
  converged means the last step satisfied ``|dx| <= tol``."""
  fj = _scalar_fn(func, args)
  x = _t(x0)
  dx = _t(2 * tol)
  tiny, neg_tiny = _const(1e-30, x), _const(-1e-30, x)
  it = 0
  while it < maxiter and _read(torch.abs(dx) > tol):
    _turn()
    fx, d, _ = _grad(fj, x)
    # zero-derivative guard: the fallback divisor is never itself zero
    safe = torch.where(torch.abs(d) < 1e-30,
                       torch.where(d < 0, neg_tiny, tiny), d)
    dx = fx / safe
    x = x - dx
    it += 1
  if full_output:
    conv = bool(np.isfinite(float(x)) and abs(float(dx)) <= tol)
    return float(x), it, conv
  return float(x)


def root_scalar(f, args=(), method: str = None, bracket=None, x0=None,
                xtol: float = 1e-12, maxiter: int = 200):
  """scipy.optimize.root_scalar front-end: 'bisect' with a bracket,
  'newton' with a start point (auto-picked).  ``iterations``/``converged``
  report the solver's actual work and its own stopping criterion."""
  if method is None:
    method = "bisect" if bracket is not None else "newton"
  if method in ("bisect", "brentq"):
    if bracket is None:
      raise ValueError("bracket required for bisect")
    r, it, conv = bisect(f, bracket[0], bracket[1], args=args, xtol=xtol,
                         maxiter=maxiter, full_output=True)
    calls = 2 + 2 * it  # bracket check + two evals per bisection round
  elif method == "newton":
    if x0 is None:
      raise ValueError("x0 required for newton")
    r, it, conv = newton(f, x0, args=args, tol=xtol, maxiter=maxiter,
                         full_output=True)
    calls = 2 * it  # f and f' per step
  else:
    raise ValueError(f"unknown method {method!r}")
  return OptimizeResult(root=r, converged=conv,
                        function_calls=calls, iterations=it,
                        flag="converged" if conv else "not converged")


def minimize_scalar(f, bounds=None, bracket=None, args=(),
                    method: str = None, xtol: float = 1e-10,
                    maxiter: int = 200):
  """Golden-section scalar minimization, the bracket's width read once a
  turn."""
  if bounds is None and bracket is not None:
    bounds = (bracket[0], bracket[-1])
  if bounds is None:
    raise ValueError("bounds (or bracket) required")
  del method
  phi = (np.sqrt(5.0) - 1.0) / 2.0
  fj = _scalar_fn(f, args)
  a, b = _t(bounds[0]), _t(bounds[1])
  it = 0
  while it < maxiter and _read(b - a > xtol):
    _turn()
    c = b - phi * (b - a)
    d = a + phi * (b - a)
    left = fj(c) < fj(d)
    a, b = torch.where(left, a, c), torch.where(left, d, b)
    it += 1
  x = float(0.5 * (a + b))
  return OptimizeResult(x=x, fun=float(fj(_t(x))), nit=it, success=True)


def _minimize_bounded(f, x0, lo, hi, tol, maxiter):
  """Box-constrained minimization (scipy's L-BFGS-B role): damped
  projected Newton steps.  The Hessian is restricted to the free set
  (Bertsekas' active-set rule), the damped solve ``(H_ff + λI) d = -g_ff``
  is clipped into the box, and λ adapts LM-style (accept ⇒ λ/3, reject ⇒
  λ·3), so a large λ degrades to short projected-gradient steps.  Stops on
  the projected-gradient KKT measure ``max|x - clip(x - g, lo, hi)| <
  tol``, read once a turn."""
  n = x0.numel()
  eye = torch.eye(n, dtype=_DT, device=x0.device)
  one, zero = (torch.ones((), dtype=torch.int32, device=x0.device),
               torch.zeros((), dtype=torch.int32, device=x0.device))

  def proj_grad(x, g):
    return x - torch.clamp(x - g, lo, hi)

  x = torch.clamp(x0, lo, hi)
  with torch.no_grad():
    fv = f(x)
  lam = _const(1e-4, x)
  it, status = 0, 0
  while status == 0 and it < maxiter:
    _turn()
    g, H = _hessian(f, x)
    F = _frozen(x, g, lo, hi)
    Hm = H * (F[:, None] * F[None, :]) + torch.diag(1.0 - F) + lam * eye
    d = -_solve(Hm, g * F)
    x2 = torch.clamp(x + d, lo, hi)
    with torch.no_grad():
      f2 = f(x2)
    accept = torch.isfinite(f2) & (f2 < fv)
    x = torch.where(accept, x2, x)
    fv = torch.where(accept, f2, fv)
    lam = torch.where(accept, torch.clamp(lam / 3.0, min=1e-12),
                      torch.clamp(lam * 3.0, max=1e12))
    pg = torch.max(torch.abs(proj_grad(x, _grad(f, x)[1])))
    it += 1
    status = int(_read(torch.where(pg < tol, one, zero)))
  pg = proj_grad(x, _grad(f, x)[1])
  return OptimizeResult(
      x=x.cpu().numpy(), fun=float(fv), nit=it,
      status=status, success=bool(status == 1),
      optimality=float(torch.max(torch.abs(pg))),
      message="projected gradient below tol" if status == 1
      else "maxiter reached")


def _squeezed(lossfn: Callable) -> Callable:
  return lambda p: lossfn(p).squeeze()


def minimize(fun, x0=None, args=(), wrt=None, method: str = None,
             bounds=None, tol=None, options=None):
  """scipy.optimize.minimize front-end.

  Expr-native form: ``minimize(loss_expr, wrt=[leaves])`` delegates to
  :func:`spartan_tpu_torch.minimize` (BFGS + Newton polish).  Callable
  form: ``minimize(f, x0)`` lowers ``f`` through the lazy layer
  (expr-native or torch, as :func:`least_squares`) and runs the same BFGS,
  or, with ``bounds=`` (scipy's per-parameter ``(lo, hi)`` pairs or a
  ``Bounds`` object; method auto-picks 'l-bfgs-b'), the projected-Newton
  box solver (:func:`_minimize_bounded`)."""
  from spartan_tpu_torch import autodiff
  opts = dict(options or {})
  if method is None:
    method = "l-bfgs-b" if bounds is not None else "bfgs"
  method = method.lower()
  if isinstance(fun, Expr):
    if wrt is None:
      raise ValueError("expr-form minimize needs wrt=[leaves]")
    if bounds is not None:
      raise ValueError("bounds= is supported in the callable form "
                       "minimize(f, x0, bounds=...); flatten the "
                       "parameters into one vector")
    params, info = autodiff.minimize(fun, wrt, method=method, tol=tol,
                                     options=options)
    return OptimizeResult(
        x=params if len(params) > 1 else np.asarray(params[0].glom()),
        fun=info["fun"], nit=info["nit"], success=info["success"],
        status=info["status"])
  if x0 is None:
    raise ValueError("callable-form minimize needs x0")
  if bounds is not None or method in ("l-bfgs-b", "tnc"):
    lossfn, x0v = _lower(fun, x0, args)
    lo, hi = _parse_bounds(bounds, x0v.numel(), pairs=True)
    return _minimize_bounded(
        _squeezed(lossfn), x0v, lo, hi,
        tol=tol if tol is not None else 1e-8,
        maxiter=int(opts.get("maxiter", 500)))
  x0 = np.atleast_1d(np.asarray(x0, dtype=float))
  leaf = sp.lazify(x0)
  loss = _probe_objective(fun, leaf, args)
  params, info = autodiff.minimize(loss, [leaf], method=method, tol=tol,
                                   options=options)
  return OptimizeResult(
      x=np.asarray(params[0].glom()), fun=info["fun"], nit=info["nit"],
      success=info["success"], status=info["status"])


# ---------------------------------------------------------------------
# host boundaries (inherently sequential exact algorithms)
# ---------------------------------------------------------------------

_host_noticed: set = set()


def _host_notice(name):
  """Say once a process that ``name`` runs on the host; count the run."""
  fio.counts["host_runs"] += 1
  if name in _host_noticed:
    return
  _host_noticed.add(name)
  log_info(
      "sp.optimize.%s: inherently sequential exact algorithm — runs "
      "EAGERLY on the host (scipy.optimize), the sp.linalg.eig "
      "convention.", name)


def _glommed(x) -> np.ndarray:
  if isinstance(x, torch.Tensor):
    return x.detach().cpu().numpy()
  return np.asarray(sp.lazify(x).glom())


def linear_sum_assignment(cost_matrix, maximize: bool = False):
  """Hungarian assignment — host boundary (scipy.optimize)."""
  _host_notice("linear_sum_assignment")
  import scipy.optimize as sopt
  return sopt.linear_sum_assignment(_glommed(cost_matrix), maximize=maximize)


def nnls(A, b, maxiter=None):
  """Non-negative least squares — host boundary (the active-set method
  is sequential)."""
  _host_notice("nnls")
  import scipy.optimize as sopt
  return sopt.nnls(_glommed(A), _glommed(b), maxiter=maxiter)


# ---------------------------------------------------------------------
# containers, warnings, quasi-Newton classes, test functions, derivative
# helpers
# ---------------------------------------------------------------------

# OptimizeWarning / NoConvergence are scipy's own (the host boundaries
# raise scipy's classes, so `except sp.optimize.NoConvergence` catches)
from scipy.optimize import NoConvergence, OptimizeWarning  # noqa: E402


class Bounds:
  """Box-constraint container (scipy.optimize.Bounds): arrays broadcast
  against the parameter vector; consumed by minimize/least_squares/
  lsq_linear/differential_evolution."""

  def __init__(self, lb=-np.inf, ub=np.inf, keep_feasible=False):
    self.lb = np.asarray(lb, dtype=float)
    self.ub = np.asarray(ub, dtype=float)
    self.keep_feasible = keep_feasible

  def residual(self, x):
    x = np.asarray(x)
    return x - self.lb, self.ub - x

  def __repr__(self):
    return f"Bounds({self.lb!r}, {self.ub!r})"


class LinearConstraint:
  """``lb <= A @ x <= ub`` container (the box solvers take box bounds;
  general constraints go to the host-boundary ``linprog``/``milp``)."""

  def __init__(self, A, lb=-np.inf, ub=np.inf, keep_feasible=False):
    self.A = _glommed(A)
    self.lb = np.asarray(lb, dtype=float)
    self.ub = np.asarray(ub, dtype=float)
    self.keep_feasible = keep_feasible

  def residual(self, x):
    ax = self.A @ np.asarray(x)
    return ax - self.lb, self.ub - ax


class NonlinearConstraint:
  """``lb <= fun(x) <= ub`` container."""

  def __init__(self, fun, lb=-np.inf, ub=np.inf, jac=None, hess=None,
               keep_feasible=False, finite_diff_rel_step=None,
               finite_diff_jac_sparsity=None):
    self.fun = fun
    self.lb = np.asarray(lb, dtype=float)
    self.ub = np.asarray(ub, dtype=float)
    self.jac = jac
    self.hess = hess
    self.keep_feasible = keep_feasible
    self.finite_diff_rel_step = finite_diff_rel_step
    self.finite_diff_jac_sparsity = finite_diff_jac_sparsity


class RootResults:
  """Scalar-root result container (scipy.optimize.RootResults)."""

  def __init__(self, root, iterations, function_calls, flag,
               method="unknown"):
    self.root = root
    self.iterations = iterations
    self.function_calls = function_calls
    self.converged = flag == 0 or flag == "converged"
    self.flag = flag
    self.method = method

  def __repr__(self):
    keys = ("converged", "flag", "function_calls", "iterations",
            "root", "method")
    return "\n".join(f"{k:>20}: {getattr(self, k)}" for k in keys)


# Quasi-Newton update machinery and nonlin Jacobian classes: host-side
# numpy helper objects (they parameterize host minimizers and the
# host-boundary nonlin solvers below), scipy's own
from scipy.optimize import (  # noqa: E402
    HessianUpdateStrategy, BFGS, SR1, LbfgsInvHessProduct,
    BroydenFirst, InverseJacobian, KrylovJacobian,
)


def rosen(x):
  """Rosenbrock test function, expr-native (a lazy Expr in gives a lazy
  scalar out)."""
  x = sp.lazify(x)
  return sp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)


def rosen_der(x):
  """Rosenbrock gradient, closed form, expr-native."""
  x = sp.lazify(x)
  xm, xp = x[:-1], x[1:]
  core = 200.0 * (xp - xm ** 2)
  dt = x.aval().dtype
  gl = sp.concatenate([-400.0 * xm * (xp - xm ** 2) - 2.0 * (1.0 - xm),
                       sp.zeros((1,), dtype=dt)])
  gr = sp.concatenate([sp.zeros((1,), dtype=dt), core])
  return gl + gr


def rosen_hess(x):
  """Rosenbrock Hessian, closed form on the host (diagnostic tooling)."""
  x = np.asarray(_glommed(x), dtype=float)
  n = x.size
  H = np.zeros((n, n))
  d = np.zeros(n)
  d[:-1] += 1200.0 * x[:-1] ** 2 - 400.0 * x[1:] + 2.0
  d[1:] += 200.0
  H[np.arange(n), np.arange(n)] = d
  off = -400.0 * x[:-1]
  H[np.arange(n - 1), np.arange(1, n)] = off
  H[np.arange(1, n), np.arange(n - 1)] = off
  return H


def rosen_hess_prod(x, p):
  """Rosenbrock Hessian-vector product."""
  return rosen_hess(x) @ np.asarray(_glommed(p), dtype=float)


def _host_value(out) -> float:
  return float(np.asarray(_glommed(out) if isinstance(
      out, (Expr, torch.Tensor, SpartanArray)) else out))


def approx_fprime(xk, f, epsilon=None, *args):
  """Forward-difference gradient (scipy's contract; a host utility, the
  device gradient is ``sp.grad``)."""
  xk = np.asarray(_glommed(xk), dtype=float)
  if epsilon is None:
    epsilon = np.sqrt(np.finfo(float).eps)
  eps = np.broadcast_to(np.asarray(epsilon, dtype=float), xk.shape)
  f0 = _host_value(f(xk, *args))
  g = np.empty_like(xk)
  for i in range(xk.size):
    xi = xk.copy()
    xi[i] += eps[i]
    g[i] = (_host_value(f(xi, *args)) - f0) / eps[i]
  return g


def check_grad(func, grad, x0, *args, epsilon=None, direction="all",
               rng=None, seed=None):
  """``|approx_fprime - grad|`` (scipy's contract)."""
  x0 = np.asarray(_glommed(x0), dtype=float)
  ga = np.asarray(_glommed(grad(x0, *args)), dtype=float)
  if direction == "random":
    g = (rng if isinstance(rng, np.random.Generator)
         else np.random.default_rng(rng if rng is not None else seed))
    v = g.normal(size=x0.shape)
    v /= np.linalg.norm(v)
    fd = np.dot(approx_fprime(x0, func, epsilon, *args), v)
    return float(np.abs(fd - np.dot(ga, v)))
  fd = approx_fprime(x0, func, epsilon, *args)
  return float(np.sqrt(np.sum((fd - ga) ** 2)))


# ---------------------------------------------------------------------
# scalar roots (Brent, Ridders), fixed_point, scalar-minimizer
# front-ends
# ---------------------------------------------------------------------

def brentq(f, a, b, args=(), xtol: float = 2e-12, rtol: float = None,
           maxiter: int = 100, full_output: bool = False, disp=True):
  """Brent's method (inverse-quadratic/secant/bisection): each branch
  decision a ``torch.where`` select, one f evaluation a step, ``done``
  read once a turn."""
  del disp
  if rtol is None:
    rtol = float(4 * np.finfo(np.float64).eps)
  fj = _scalar_fn(f, args)
  fa0 = float(fj(_t(a)))
  fb0 = float(fj(_t(b)))
  if fa0 * fb0 > 0:
    raise ValueError("f(a) and f(b) must have different signs")
  a, b = _t(a), _t(b)
  fa, fb = _t(fa0), _t(fb0)
  one = _const(1.0, a)
  c, d, e, fc = a, b - a, b - a, fa
  it, done = 0, False
  while not done and it < maxiter:
    _turn()
    # re-bracket so b is best, c on the other side
    reb = fb * fc > 0
    c = torch.where(reb, a, c)
    fc = torch.where(reb, fa, fc)
    d = torch.where(reb, b - a, d)
    e = torch.where(reb, b - a, e)
    swap = torch.abs(fc) < torch.abs(fb)
    a2 = torch.where(swap, b, a)
    b2 = torch.where(swap, c, b)
    c2 = torch.where(swap, a2, c)
    fa2 = torch.where(swap, fb, fa)
    fb2 = torch.where(swap, fc, fb)
    fc2 = torch.where(swap, fa2, fc)
    tol1 = 0.5 * xtol + rtol * torch.abs(b2)
    xm = 0.5 * (c2 - b2)
    finished = (torch.abs(xm) <= tol1) | (fb2 == 0.0)
    # interpolation step
    s_ = fb2 / torch.where(fa2 == 0, one, fa2)
    sec = a2 == c2
    p_sec = 2.0 * xm * s_
    q_sec = 1.0 - s_
    qq = fa2 / torch.where(fc2 == 0, one, fc2)
    rr = fb2 / torch.where(fc2 == 0, one, fc2)
    p_iq = s_ * (2.0 * xm * qq * (qq - rr) - (b2 - a2) * (rr - 1.0))
    q_iq = (qq - 1.0) * (rr - 1.0) * (s_ - 1.0)
    p = torch.where(sec, p_sec, p_iq)
    q = torch.where(sec, q_sec, q_iq)
    q = torch.where(p > 0, -q, q)
    p = torch.abs(p)
    qs = torch.where(q == 0, one, q)
    accept = ((torch.abs(e) >= tol1) & (torch.abs(fa2) > torch.abs(fb2))
              & (2.0 * p < torch.minimum(3.0 * xm * q - torch.abs(tol1 * q),
                                         torch.abs(e * q))))
    d2 = torch.where(accept, p / qs, xm)
    e2 = torch.where(accept, d, d2)
    step = torch.where(torch.abs(d2) > tol1, d2,
                       torch.where(xm >= 0, tol1, -tol1))
    b3 = torch.where(finished, b2, b2 + step)
    fb3 = torch.where(finished, fb2, fj(b3))
    a, b, c, d, e, fa, fb, fc = b2, b3, c2, d2, e2, fb2, fb3, fc2
    done = bool(_read(finished))
    it += 0 if done else 1
  r = float(b)
  if full_output:
    return r, RootResults(r, it, it + 2, 0 if done else 1,
                          method="brentq")
  return r


def ridder(f, a, b, args=(), xtol: float = 2e-12, rtol: float = None,
           maxiter: int = 100, full_output: bool = False, disp=True):
  """Ridders' method (two f evaluations a step, the exponential-fit root
  update and the re-bracketing as ``torch.where`` selects), the
  bracket's width read once a turn."""
  del disp
  if rtol is None:
    rtol = float(4 * np.finfo(np.float64).eps)
  fj = _scalar_fn(f, args)
  fa0 = float(fj(_t(a)))
  fb0 = float(fj(_t(b)))
  if fa0 * fb0 > 0:
    raise ValueError("f(a) and f(b) must have different signs")
  lo_, hi_ = _t(min(a, b)), _t(max(a, b))
  flo, fhi = _t(fa0 if a <= b else fb0), _t(fb0 if a <= b else fa0)
  a, b, fa, fb = lo_, hi_, flo, fhi
  one, zero = _const(1.0, a), _const(0.0, a)
  it = 0
  while it < maxiter and _read(
      torch.abs(b - a) > xtol + rtol * torch.abs(0.5 * (a + b))):
    _turn()
    c = 0.5 * (a + b)
    fc = fj(c)
    sq = torch.sqrt(torch.maximum(fc * fc - fa * fb, zero))
    sqs = torch.where(sq == 0, one, sq)
    x = c + (c - a) * torch.sign(fa - fb) * fc / sqs
    fx = fj(x)
    # re-bracket: prefer (c, x), else (a, x), else (x, b)
    cx = fc * fx < 0
    ax = fa * fx < 0
    lo = torch.where(cx, torch.minimum(c, x),
                     torch.where(ax, a, torch.minimum(x, b)))
    hi = torch.where(cx, torch.maximum(c, x),
                     torch.where(ax, x, torch.maximum(x, b)))
    flo = torch.where(cx, torch.where(c <= x, fc, fx),
                      torch.where(ax, fa, torch.where(x <= b, fx, fb)))
    fhi = torch.where(cx, torch.where(c <= x, fx, fc),
                      torch.where(ax, fx, torch.where(x <= b, fb, fx)))
    stall = sq == 0
    a, b = torch.where(stall, a, lo), torch.where(stall, b, hi)
    fa, fb = torch.where(stall, fa, flo), torch.where(stall, fb, fhi)
    it += 1
  r = float(torch.where(torch.abs(fa) < torch.abs(fb), a, b))
  conv = it < maxiter
  if full_output:
    return r, RootResults(r, it, 2 * it + 2, 0 if conv else 1,
                          method="ridder")
  return r


def brenth(f, a, b, args=(), xtol: float = 2e-12, rtol: float = None,
           maxiter: int = 100, full_output: bool = False, disp=True):
  """Brent with hyperbolic extrapolation: the same bracket contract as
  :func:`brentq`, routed to its loop (the hyperbolic variant differs only
  in its interpolation formula)."""
  return brentq(f, a, b, args=args, xtol=xtol, rtol=rtol,
                maxiter=maxiter, full_output=full_output, disp=disp)


def toms748(f, a, b, args=(), k=1, xtol: float = 2e-12, rtol=None,
            maxiter: int = 100, full_output: bool = False, disp=True):
  """TOMS 748: the same bracket-to-xtol contract, routed to the Brent
  loop."""
  del k
  return brentq(f, a, b, args=args, xtol=xtol, rtol=rtol,
                maxiter=maxiter, full_output=full_output, disp=disp)


def fixed_point(func, x0, args=(), xtol: float = 1e-8,
                maxiter: int = 500, method: str = "del2"):
  """Fixed point of ``func``: ``method='del2'`` is scipy's
  Steffensen/Aitken acceleration, ``'iteration'`` plain; the relative
  change read once a turn."""
  if method not in ("del2", "iteration"):
    raise ValueError(f"unknown method {method!r}")
  x = torch.as_tensor(np.atleast_1d(np.asarray(x0, dtype=np.float64)),
                      device=_device())
  one = _const(1.0, x)

  def fj(v):
    return _as_tensor(func(v, *args), v.device).reshape(v.shape)

  rel = _const(np.inf, x)
  it = 0
  while it < maxiter and _read(rel >= xtol):
    _turn()
    p1 = fj(x)
    if method == "del2":
      p2 = fj(p1)
      d = p2 - 2.0 * p1 + x
      ds = torch.where(d == 0, one, d)
      p = torch.where(d == 0, p2, x - (p1 - x) ** 2 / ds)
    else:
      p = p1
    rel = torch.max(torch.abs(torch.where(p != 0, (p - x) / p, p - x)))
    x = p
    it += 1
  if float(rel) >= xtol:
    raise RuntimeError(f"Failed to converge after {it} iterations, "
                       f"value is {x.cpu().numpy()}")
  x = x.cpu().numpy()
  return x if np.ndim(x0) else x.reshape(np.shape(x0)) if x.size > 1 \
      else x[()] if x.ndim == 0 else float(x[0])


def fminbound(func, x1, x2, args=(), xtol: float = 1e-5,
              maxfun: int = 500, full_output: int = 0, disp: int = 1):
  """Bounded scalar minimization: the golden-section loop."""
  del disp
  res = minimize_scalar(func, bounds=(x1, x2), args=args, xtol=xtol,
                        maxiter=maxfun)
  if full_output:
    return res.x, res.fun, 0 if res.success else 1, res.nit
  return res.x


def brent(func, args=(), brack=None, tol: float = 1.48e-8,
          full_output: int = 0, maxiter: int = 500):
  """Scalar minimization given a bracket: the golden-section loop."""
  if brack is None:
    brack = bracket(func, args=args)[:3]
  a, b = min(brack[0], brack[-1]), max(brack[0], brack[-1])
  res = minimize_scalar(func, bounds=(a, b), args=args, xtol=tol,
                        maxiter=maxiter)
  if full_output:
    return res.x, res.fun, res.nit, res.nit * 2
  return res.x


def golden(func, args=(), brack=None, tol=None, full_output: int = 0,
           maxiter: int = 5000):
  """Golden-section scalar minimization."""
  if tol is None:
    tol = np.sqrt(np.finfo(float).eps)
  if brack is None:
    brack = bracket(func, args=args)[:3]
  a, b = min(brack[0], brack[-1]), max(brack[0], brack[-1])
  res = minimize_scalar(func, bounds=(a, b), args=args, xtol=tol,
                        maxiter=maxiter)
  if full_output:
    return res.x, res.fun, res.nit * 2
  return res.x


def bracket(func, xa: float = 0.0, xb: float = 1.0, args=(),
            grow_limit: float = 110.0, maxiter: int = 1000):
  """Downhill bracket search (scipy's contract: returns
  ``(xa, xb, xc, fa, fb, fc, funcalls)`` with ``fb < fa, fb < fc``):
  host scalar bookkeeping around golden-ratio expansion, each value read
  as it comes."""
  fj = _scalar_fn(func, args)
  gold = 1.618034
  fa = float(fj(_t(xa)))
  fb = float(fj(_t(xb)))
  calls = 2
  if fa < fb:
    xa, xb, fa, fb = xb, xa, fb, fa
  xc = xb + gold * (xb - xa)
  fc = float(fj(_t(xc)))
  calls += 1
  it = 0
  while fc < fb:
    if it >= maxiter:
      raise RuntimeError("Too many iterations in bracket()")
    it += 1
    xd = xc + gold * (xc - xb)
    fd = float(fj(_t(xd)))
    calls += 1
    xa, xb, xc = xb, xc, xd
    fa, fb, fc = fb, fc, fd
  return xa, xb, xc, fa, fb, fc, calls


# ---------------------------------------------------------------------
# simplex and global optimizers, legacy fmin_* front-ends, bounded linear
# least squares, nonlin host boundaries
# ---------------------------------------------------------------------

def _nelder_mead(f, x0, xatol, fatol, maxiter):
  """Nelder–Mead: the (n+1, n) simplex on the device; reflection,
  expansion, contraction and shrink are ``torch.where`` selects, the
  shrink's re-evaluation one vmap batch (every candidate's f is computed
  each step, n + 4 evaluations); the size and spread test read once a
  turn."""
  n = x0.numel()
  pert = torch.where(torch.abs(x0) > 1e-12, 0.05 * torch.abs(x0),
                     _const(0.00025, x0))
  simplex = torch.cat([x0[None, :], x0[None, :] + torch.diag(pert)], dim=0)
  fv = _vmap(f, simplex)
  it = 0
  while it < maxiter and _read(
      (torch.max(torch.abs(simplex[1:] - simplex[0])) > xatol)
      | (torch.max(torch.abs(fv[1:] - fv[0])) > fatol)):
    _turn()
    order = _argsort(fv)
    simplex = simplex[order]
    fv = fv[order]
    best, worst = simplex[0], simplex[-1]
    centroid = torch.mean(simplex[:-1], dim=0)
    xr = centroid + (centroid - worst)
    fr = f(xr)
    xe = centroid + 2.0 * (centroid - worst)
    fe = f(xe)
    x_oc = centroid + 0.5 * (xr - centroid)
    f_oc = f(x_oc)
    x_ic = centroid - 0.5 * (centroid - worst)
    f_ic = f(x_ic)
    # the candidate replacement of the worst vertex
    expand = (fr < fv[0]) & (fe < fr)
    reflect = (fr >= fv[0]) & (fr < fv[-2])
    out_con = (fr >= fv[-2]) & (fr < fv[-1])
    use_oc = out_con & (f_oc <= fr)
    use_ic = (fr >= fv[-1]) & (f_ic < fv[-1])
    take_r = (fr < fv[0]) | reflect
    newx = torch.where(expand, xe, torch.where(
        take_r, xr, torch.where(use_oc, x_oc, torch.where(use_ic, x_ic,
                                                          worst))))
    newf = torch.where(expand, fe, torch.where(
        take_r, fr, torch.where(use_oc, f_oc, torch.where(use_ic, f_ic,
                                                          fv[-1]))))
    shrink = ~((fr < fv[-2]) | use_oc | use_ic)
    cand = torch.cat([simplex[:-1], newx[None, :]])
    candf = torch.cat([fv[:-1], newf[None]])
    shrunk = best[None, :] + 0.5 * (simplex - best[None, :])
    shrunkf = _vmap(f, shrunk)
    simplex = torch.where(shrink, shrunk, cand)
    fv = torch.where(shrink, shrunkf, candf)
    it += 1
  k = torch.argmin(fv)
  return simplex[k], fv[k], it


def fmin(func, x0, args=(), xtol: float = 1e-4, ftol: float = 1e-4,
         maxiter: int = None, maxfun=None, full_output: int = 0,
         disp: int = 1, retall: int = 0, callback=None,
         initial_simplex=None):
  """Nelder–Mead (scipy's fmin): the simplex loop, derivative-free."""
  del maxfun, disp, retall, callback, initial_simplex
  lossfn, x0v = _lower(func, x0, args)
  maxiter = int(maxiter) if maxiter else 200 * x0v.numel()
  x, fx, it = _nelder_mead(_squeezed(lossfn), x0v, xatol=xtol, fatol=ftol,
                           maxiter=maxiter)
  x = x.cpu().numpy()
  if full_output:
    return x, float(fx), it, it * (x0v.numel() + 4), \
        0 if it < maxiter else 1
  return x


def fmin_bfgs(f, x0, fprime=None, args=(), gtol: float = 1e-5, **kw):
  """BFGS front-end (gradients by autograd; an explicit ``fprime`` is
  accepted and ignored)."""
  del fprime
  res = minimize(f, x0, args=args, method="bfgs", tol=gtol)
  if kw.get("full_output"):
    return res.x, res.fun, None, None, 0, 0, res.status
  return res.x


def fmin_cg(f, x0, fprime=None, args=(), gtol: float = 1e-5, **kw):
  """Nonlinear-CG front-end, routed to the BFGS loop (the same
  smooth-minimization contract)."""
  del fprime
  res = minimize(f, x0, args=args, method="bfgs", tol=gtol)
  if kw.get("full_output"):
    return res.x, res.fun, 0, 0, res.status
  return res.x


def fmin_ncg(f, x0, fprime=None, fhess_p=None, fhess=None, args=(),
             avextol: float = 1e-5, **kw):
  """Newton-CG front-end: BFGS with its Newton polish (exact curvature by
  autograd; explicit Hessian callables are accepted and ignored)."""
  del fprime, fhess_p, fhess
  res = minimize(f, x0, args=args, method="bfgs", tol=avextol)
  if kw.get("full_output"):
    return res.x, res.fun, 0, 0, 0, res.status
  return res.x


def fmin_powell(func, x0, args=(), xtol: float = 1e-4,
                ftol: float = 1e-4, maxiter: int = None, **kw):
  """Powell front-end, routed to the Nelder–Mead loop (derivative-free).
  ``full_output`` returns scipy's 6-tuple; its ``direc`` slot is the
  identity (the simplex keeps no direction set)."""
  if not kw.get("full_output"):
    return fmin(func, x0, args=args, xtol=xtol, ftol=ftol,
                maxiter=maxiter)
  x, fx, it, fc, flag = fmin(func, x0, args=args, xtol=xtol, ftol=ftol,
                             maxiter=maxiter, full_output=True)
  return x, fx, np.eye(np.atleast_1d(np.asarray(x)).size), it, fc, flag


def fmin_l_bfgs_b(func, x0, fprime=None, args=(), approx_grad: int = 0,
                  bounds=None, m: int = 10, factr: float = 1e7,
                  pgtol: float = 1e-5, **kw):
  """L-BFGS-B front-end: the projected-Newton box solver.  Returns scipy's
  ``(x, f, info_dict)`` triple."""
  del fprime, approx_grad, m
  tol = max(pgtol, factr * np.finfo(float).eps)
  res = minimize(func, x0, args=args, bounds=bounds, method="l-bfgs-b",
                 tol=tol, options={"maxiter": int(kw.get("maxiter", 500))})
  # the gradient at the minimum (scipy returns it in the info dict)
  lossfn, xr = _lower(func, res.x, args)
  grad = _grad(_squeezed(lossfn), xr)[1].cpu().numpy()
  return res.x, res.fun, {"grad": grad,
                          "task": b"CONVERGED" if res.success
                          else b"MAXITER", "nit": res.nit,
                          "funcalls": res.nit,
                          "warnflag": 0 if res.success else 1}


def fmin_tnc(func, x0, fprime=None, args=(), approx_grad: int = 0,
             bounds=None, **kw):
  """TNC front-end: the projected-Newton box solver.  Returns scipy's
  ``(x, nfeval, rc)``."""
  del fprime, approx_grad, kw
  res = minimize(func, x0, args=args, bounds=bounds, method="l-bfgs-b")
  return res.x, res.nit, 1 if res.success else 4


def leastsq(func, x0, args=(), Dfun=None, full_output: bool = False,
            col_deriv=False, ftol: float = 1.49012e-8,
            xtol: float = 1.49012e-8, gtol: float = 0.0,
            maxfev: int = 0, epsfcn=None, factor=100, diag=None):
  """MINPACK leastsq front-end: the LM loop.  Returns ``(x, ier)`` or the
  full 5-tuple."""
  del Dfun, col_deriv, epsfcn, factor, diag
  res = least_squares(func, x0, args=args, method="lm",
                      xtol=xtol, ftol=ftol, gtol=max(gtol, 1e-12),
                      max_nfev=int(maxfev) if maxfev else 200)
  ier = 1 if res.success else 5
  if full_output:
    J = np.asarray(res.jac)
    try:
      cov_x = np.linalg.inv(J.T @ J)
    except np.linalg.LinAlgError:
      cov_x = None
    info = {"nfev": res.nfev, "fvec": np.asarray(res.fun)}
    return res.x, cov_x, info, res.get("message", ""), ier
  return res.x, ier


def fsolve(func, x0, args=(), fprime=None, full_output: bool = False,
           col_deriv=0, xtol: float = 1.49012e-8, maxfev: int = 0,
           band=None, epsfcn=None, factor=100, diag=None):
  """MINPACK hybrd front-end: the damped-Newton vector root loop."""
  del fprime, col_deriv, band, epsfcn, factor, diag
  res = root(func, x0, args=args, method="hybr", tol=xtol,
             maxiter=int(maxfev) if maxfev else 100)
  if full_output:
    info = {"nfev": res.nfev, "fvec": np.asarray(res.fun)}
    return res.x, info, 1 if res.success else 5, res.get("message", "")
  return res.x


def lsq_linear(A, b, bounds=(-np.inf, np.inf), method: str = "trf",
               tol: float = 1e-10, max_iter: int = None, **kw):
  """Bounded linear least squares ``min |Ax-b|, lo<=x<=hi``: the
  projected-Newton box loop on the exact quadratic objective; unbounded
  input goes to ``sp.linalg.lstsq``."""
  del method, kw
  Ae = sp.lazify(A)
  be = sp.lazify(b)
  m, n = Ae.shape
  An, bn = _glommed(Ae).astype(np.float64), _glommed(be).astype(np.float64)
  lo, hi = _parse_bounds(bounds, n)
  if not (bool(torch.isfinite(lo).any()) or bool(torch.isfinite(hi).any())):
    xa = _glommed(sp.linalg.lstsq(Ae, be))
    r = An @ xa - bn
    return OptimizeResult(x=xa, cost=0.5 * float(r @ r), fun=r,
                          optimality=float(np.abs(An.T @ r).max()),
                          active_mask=np.zeros(n, int), nit=1,
                          status=1, success=True)
  dev = _device()
  Ad = torch.as_tensor(An, device=dev)
  bd = torch.as_tensor(bn, device=dev)

  def f(p):
    r = Ad @ p - bd
    return 0.5 * torch.dot(r, r)

  res = _minimize_bounded(f, torch.clamp(torch.zeros(n, dtype=_DT,
                                                     device=dev), lo, hi),
                          lo, hi, tol=tol, maxiter=int(max_iter or 500))
  xa = np.asarray(res.x)
  r = An @ xa - bn
  g = An.T @ r
  lon, hin = lo.cpu().numpy(), hi.cpu().numpy()
  active = np.where(xa <= lon + 1e-12, -1, np.where(xa >= hin - 1e-12, 1, 0))
  pg = xa - np.clip(xa - g, lon, hin)
  return OptimizeResult(x=xa, cost=0.5 * float(r @ r), fun=r,
                        optimality=float(np.abs(pg).max()),
                        active_mask=active, nit=res.nit,
                        status=res.status, success=res.success)


def line_search(f, myfprime, xk, pk, gfk=None, old_fval=None,
                old_old_fval=None, args=(), c1=1e-4, c2=0.9,
                amax=None, extra_condition=None, maxiter=10):
  """Wolfe line search — host utility (scipy's zoom bookkeeping)."""
  import scipy.optimize as sopt
  _host_notice("line_search")
  return sopt.line_search(f, myfprime, _glommed(xk), _glommed(pk),
                          gfk=gfk, old_fval=old_fval,
                          old_old_fval=old_old_fval, args=args, c1=c1,
                          c2=c2, amax=amax,
                          extra_condition=extra_condition,
                          maxiter=maxiter)


def _generator(seed) -> torch.Generator:
  """An explicit generator on the mesh's device, seeded from ``seed``."""
  g = torch.Generator(device=_device())
  g.manual_seed(0 if seed is None else int(seed))
  return g


def differential_evolution(func, bounds, args=(), strategy="best1bin",
                           maxiter: int = 1000, popsize: int = 15,
                           tol: float = 0.01, mutation=(0.5, 1),
                           recombination: float = 0.7, seed=None,
                           polish: bool = True, init="random",
                           atol: float = 0, **kw):
  """Differential evolution on the device: a generation is a vectorized
  best1bin mutation, a binomial crossover and one vmap batch of every
  trial, drawn from a ``torch.Generator`` on the mesh's device seeded
  from ``seed``; scipy's ``std(f) <= atol + tol |mean(f)|`` stop is read
  once a turn.  ``polish=True`` finishes with the projected-Newton box
  solver."""
  del strategy, init, kw
  if hasattr(bounds, "lb"):  # scipy Bounds object
    n_par = np.broadcast(np.asarray(bounds.lb), np.asarray(bounds.ub)).size
    lob, hib = _parse_bounds(bounds, n_par, pairs=True)
  else:
    blist = list(bounds)  # materialize once (generators)
    lob, hib = _parse_bounds(blist, len(blist), pairs=True)
  n = lob.shape[0]
  lon, hin = lob.cpu().numpy(), hib.cpu().numpy()
  x0 = 0.5 * (np.where(np.isfinite(lon), lon, -1.0)
              + np.where(np.isfinite(hin), hin, 1.0))
  lossfn, _ = _lower(func, x0, args)
  f = _squeezed(lossfn)
  NP = max(popsize * n, 5)
  lo_m, hi_m = float(mutation[0]), float(mutation[1])
  gen = _generator(seed)
  dev = lob.device
  cols = torch.arange(n, device=dev)[None, :]

  def uniform(shape):
    return torch.rand(shape, generator=gen, dtype=_DT, device=dev)

  pop = lob + uniform((NP, n)) * (hib - lob)
  fv = _vmap(f, pop)
  it = 0
  while it < maxiter and not _read(
      torch.std(fv, correction=0) <= atol + tol * torch.abs(torch.mean(fv))):
    _turn()
    best = pop[torch.argmin(fv)]
    r1 = torch.randint(0, NP, (NP,), generator=gen, device=dev)
    r2 = torch.randint(0, NP, (NP,), generator=gen, device=dev)
    F = lo_m + (hi_m - lo_m) * uniform(())  # dithering
    mutant = best[None, :] + F * (pop[r1] - pop[r2])
    cross = uniform((NP, n)) < recombination
    force = torch.randint(0, n, (NP,), generator=gen, device=dev)
    cross = cross | (cols == force[:, None])
    trial = torch.clamp(torch.where(cross, mutant, pop), lob, hib)
    ft = _vmap(f, trial)
    better = ft < fv
    pop = torch.where(better[:, None], trial, pop)
    fv = torch.where(better, ft, fv)
    it += 1
  k = torch.argmin(fv)
  x, fx = pop[k], float(fv[k])
  if polish:
    res = _minimize_bounded(f, x, lob, hib, tol=1e-10, maxiter=200)
    if float(res.fun) <= fx:
      x, fx = torch.as_tensor(res.x), float(res.fun)
  x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
  return OptimizeResult(x=x, fun=fx, nit=it, nfev=(it + 1) * NP,
                        success=True,
                        message="Optimization terminated successfully.")


def brute(func, ranges, args=(), Ns: int = 20, full_output: int = 0,
          finish=fmin, disp=False, workers=1):
  """Grid search on the device: the whole grid is evaluated as one vmap
  batch; ``finish`` polishes with the simplex by default."""
  del disp, workers
  axes = []
  for r in ranges:
    if isinstance(r, slice):
      if r.step is None:
        axes.append(np.linspace(r.start, r.stop, Ns))
      elif np.iscomplexobj(r.step):
        # np.mgrid's convention: a complex step is a point count, inclusive
        axes.append(np.linspace(r.start, r.stop, int(abs(r.step))))
      else:
        axes.append(np.arange(r.start, r.stop, r.step))
    else:
      axes.append(np.linspace(r[0], r[1], Ns))
  grids = np.meshgrid(*axes, indexing="ij")
  pts = np.stack([g.ravel() for g in grids], axis=1)
  n = pts.shape[1]
  lossfn, _ = _lower(func, pts[0], args)
  fvals = _vmap(_squeezed(lossfn), torch.as_tensor(
      pts.astype(np.float64), device=_device())).cpu().numpy()
  k = int(np.argmin(fvals))
  x0, f0 = pts[k], float(fvals[k])
  xmin, fmin_val = x0, f0
  if finish is not None:
    out = finish(func, x0, args=args, full_output=True)
    if float(out[1]) <= f0:
      xmin, fmin_val = np.asarray(out[0]), float(out[1])
  xmin = xmin if n > 1 else float(xmin[0])
  if full_output:
    grid = grids[0] if n == 1 else np.stack(grids)
    return xmin, fmin_val, grid, fvals.reshape(grids[0].shape)
  return xmin


# --- host boundaries: exact/adaptive sequential algorithms ------------

def _host_opt(name, *args, **kw):
  _host_notice(name)
  import scipy.optimize as sopt
  return getattr(sopt, name)(*args, **kw)


def _glom_f(fun):
  """User callable → host numpy callable (objectives passed to the
  host boundaries may be expr-native or return tensors)."""
  def g(x, *a):
    out = fun(x, *a)
    return _glommed(out) if isinstance(
        out, (Expr, torch.Tensor, SpartanArray)) else out
  return g


def linprog(c, A_ub=None, b_ub=None, A_eq=None, b_eq=None, bounds=None,
            method="highs", callback=None, options=None,
            x0=None, integrality=None):
  """Linear programming — host boundary (HiGHS simplex/IPM pivoting is
  sequential)."""
  _host_notice("linprog")
  import scipy.optimize as sopt
  g = lambda M: None if M is None else _glommed(M)
  return sopt.linprog(g(c), A_ub=g(A_ub), b_ub=g(b_ub), A_eq=g(A_eq),
                      b_eq=g(b_eq), bounds=bounds, method=method,
                      callback=callback, options=options, x0=x0,
                      integrality=integrality)


def milp(c, *, constraints=(), integrality=None, bounds=None,
         options=None):
  """Mixed-integer LP — host boundary (branch and bound)."""
  _host_notice("milp")
  import scipy.optimize as sopt
  return sopt.milp(_glommed(c), constraints=constraints,
                   integrality=integrality, bounds=bounds, options=options)


def basinhopping(func, x0, niter=100, T=1.0, stepsize=0.5,
                 minimizer_kwargs=None, take_step=None,
                 accept_test=None, callback=None, interval=50,
                 disp=False, niter_success=None, rng=None, seed=None,
                 target_accept_rate=0.5, stepwise_factor=0.9):
  """Basin hopping — host boundary (an adaptive Metropolis loop; for a
  device-parallel global search use differential_evolution)."""
  return _host_opt(
      "basinhopping", _glom_f(func), np.asarray(x0), niter=niter,
      T=T, stepsize=stepsize, minimizer_kwargs=minimizer_kwargs,
      take_step=take_step, accept_test=accept_test, callback=callback,
      interval=interval, disp=disp, niter_success=niter_success,
      rng=rng if rng is not None else seed,
      target_accept_rate=target_accept_rate,
      stepwise_factor=stepwise_factor)


def dual_annealing(func, bounds, args=(), maxiter=1000, **kw):
  """Dual annealing — host boundary (a sequential acceptance chain)."""
  return _host_opt("dual_annealing", _glom_f(func), bounds, args=args,
                   maxiter=maxiter, **kw)


def shgo(func, bounds, args=(), constraints=None, n=100, iters=1, **kw):
  """SHGO — host boundary (simplicial homology bookkeeping)."""
  return _host_opt("shgo", _glom_f(func), bounds, args=args,
                   constraints=constraints, n=n, iters=iters, **kw)


def direct(func, bounds, *, args=(), **kw):
  """DIRECT — host boundary (rectangle-division bookkeeping)."""
  return _host_opt("direct", _glom_f(func), bounds, args=args, **kw)


def isotonic_regression(y, *, weights=None, increasing=True):
  """Isotonic regression — host boundary (PAVA is a sequential scan)."""
  return _host_opt("isotonic_regression", _glommed(y), weights=weights,
                   increasing=increasing)


def quadratic_assignment(A, B, method="faq", options=None):
  """QAP — host boundary."""
  return _host_opt("quadratic_assignment", _glommed(A), _glommed(B),
                   method=method, options=options)


def _nonlin(name, F, xin, **kw):
  return _host_opt(name, _glom_f(F), np.asarray(xin), **kw)


def broyden1(F, xin, **kw):
  """Broyden's good method — host boundary (scipy.optimize.nonlin; the
  device Newton is :func:`root`)."""
  return _nonlin("broyden1", F, xin, **kw)


def broyden2(F, xin, **kw):
  """Broyden's bad method — host boundary."""
  return _nonlin("broyden2", F, xin, **kw)


def anderson(F, xin, **kw):
  """Anderson mixing — host boundary."""
  return _nonlin("anderson", F, xin, **kw)


def linearmixing(F, xin, **kw):
  """Scalar linear mixing — host boundary."""
  return _nonlin("linearmixing", F, xin, **kw)


def diagbroyden(F, xin, **kw):
  """Diagonal Broyden — host boundary."""
  return _nonlin("diagbroyden", F, xin, **kw)


def excitingmixing(F, xin, **kw):
  """Tuned diagonal mixing — host boundary."""
  return _nonlin("excitingmixing", F, xin, **kw)


def newton_krylov(F, xin, **kw):
  """Newton–Krylov — host boundary (scipy's adaptive LGMRES inner loop;
  the device Newton is :func:`root`)."""
  return _nonlin("newton_krylov", F, xin, **kw)


def fmin_cobyla(func, x0, cons, args=(), consargs=None, rhobeg=1.0,
                rhoend=1e-4, maxfun=1000, disp=None, catol=2e-4,
                *, callback=None):
  """COBYLA (inequality-constrained, derivative-free) — host boundary (a
  sequential linear-approximation trust region)."""
  _host_notice("fmin_cobyla")
  import scipy.optimize as sopt
  return sopt.fmin_cobyla(_glom_f(func), np.asarray(x0), cons,
                          args=args, consargs=consargs, rhobeg=rhobeg,
                          rhoend=rhoend, maxfun=maxfun, disp=disp,
                          catol=catol, callback=callback)


def fmin_slsqp(func, x0, eqcons=(), f_eqcons=None, ieqcons=(),
               f_ieqcons=None, bounds=(), fprime=None, args=(), **kw):
  """SLSQP (general constrained) — host boundary (sequential QP
  subproblems)."""
  _host_notice("fmin_slsqp")
  import scipy.optimize as sopt
  return sopt.fmin_slsqp(_glom_f(func), np.asarray(x0), eqcons=eqcons,
                         f_eqcons=f_eqcons, ieqcons=ieqcons,
                         f_ieqcons=f_ieqcons, bounds=bounds,
                         fprime=fprime, args=args, **kw)


__all__ += [
    "OptimizeWarning", "NoConvergence", "Bounds", "LinearConstraint",
    "NonlinearConstraint", "RootResults",
    "HessianUpdateStrategy", "BFGS", "SR1", "LbfgsInvHessProduct",
    "BroydenFirst", "InverseJacobian", "KrylovJacobian",
    "rosen", "rosen_der", "rosen_hess", "rosen_hess_prod",
    "approx_fprime", "check_grad",
    "brentq", "brenth", "ridder", "toms748", "fixed_point",
    "fminbound", "brent", "golden", "bracket",
    "fmin", "fmin_bfgs", "fmin_cg", "fmin_ncg", "fmin_powell",
    "fmin_l_bfgs_b", "fmin_tnc", "leastsq", "fsolve", "lsq_linear",
    "line_search", "differential_evolution", "brute",
    "linprog", "milp", "basinhopping", "dual_annealing", "shgo",
    "direct", "isotonic_regression", "quadratic_assignment",
    "broyden1", "broyden2", "anderson", "linearmixing", "diagbroyden",
    "excitingmixing", "newton_krylov", "fmin_cobyla", "fmin_slsqp",
]
