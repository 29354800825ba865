"""Lazy DAGs as differentiable torch functions (port of
``spartan_tpu/autodiff.py``).

:func:`as_function` lowers a DAG to a pure function of chosen leaves;
:func:`compile_fn` (``sp.compile``) turns it into a serving call;
:func:`grad`, :func:`value_and_grad`, :func:`jvp`, :func:`hessian` and
:func:`hvp` differentiate it with eager ``torch.autograd``; :func:`minimize`
runs BFGS over it and :func:`sgd_train` plain SGD.

Which machinery, by a fixed rule: every derivative here is reverse mode,
``torch.autograd.grad`` over leaves that require grad, never
``torch.func``.  Eager autograd lets the emitters read values on the host
where they do (a loop's condition, a concrete index check), and it has a
formula for every op the emitters use.  ``jvp`` is the double-vjp identity
``J t = d/du <Jᵀ u, t>`` (the vjp is linear in ``u``); ``hvp`` is reverse
over reverse, ``∇<∇f, v>``; ``hessian`` takes one such row a parameter.

The hand-written kernels have no autograd rule (nor have the reference's
Pallas kernels), so the derivatives emit under
``EmitCtx(differentiable=True)``, where every route takes its plain
version up front; a kernel wrapper handed a tensor that requires grad
raises.  ``sp.compile`` emits with ``differentiable=False``, so a compiled
call launches the kernels.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spartan_tpu_torch.core.array import SpartanArray
from spartan_tpu_torch.core.mesh import get_mesh
from spartan_tpu_torch.expr import optimize as opt_mod
from spartan_tpu_torch.expr.base import EmitCtx, Expr, Val


def as_function(expr: Expr, wrt: Sequence[Expr],
                differentiable: bool = False
                ) -> Tuple[Callable, List[torch.Tensor]]:
  """Lower ``expr``'s DAG to ``(fn, args)`` with ``fn(*args)`` its value.

  ``wrt`` must be ``Val`` leaves of the DAG (e.g. the exprs returned by
  ``sp.from_numpy``); every other leaf is a constant.  The optimizer runs
  once, first; leaf identity survives it.  ``differentiable=True`` asks
  the emitters for their plain routes (no hand kernel): the same values,
  shapes and dtypes."""
  wrt_ids = [w.expr_id for w in wrt]
  for w in wrt:
    if not isinstance(w, Val):
      raise TypeError(f"wrt entries must be Val leaves, got {type(w)}")
  root = opt_mod.optimize(expr)

  present = set()

  def scan(e: Expr):
    if isinstance(e, Val) and e.expr_id in wrt_ids:
      present.add(e.expr_id)

  root.visit(scan)
  missing = [i for i in wrt_ids if i not in present]
  if missing:
    raise ValueError(
        f"wrt leaves {missing} not found in the DAG (was a sub-expression "
        "already materialized and collapsed? pass opt_collapse_cached=False "
        "or rebuild the expr from un-evaluated leaves)")

  ctx = EmitCtx(abstract=False, differentiable=differentiable,
                device=get_mesh().device)
  pos = {eid: k for k, eid in enumerate(wrt_ids)}
  # the other leaves' values, put on the device once for every call
  consts = {}

  def bind(e: Expr):
    if isinstance(e, Val) and e.expr_id not in pos:
      consts[e.expr_id] = e.leaf_value()

  root.visit(bind)

  def fn(*args):
    env = {}

    def emit(e: Expr):
      if e.expr_id in env:
        return env[e.expr_id]
      if isinstance(e, Val):
        v = args[pos[e.expr_id]] if e.expr_id in pos else consts[e.expr_id]
      else:
        v = e.emit(ctx, [emit(c) for c in e.children()])
      env[e.expr_id] = v
      return v

    out = emit(root)
    del emit  # break emit's cycle through its own cell
    return out

  return fn, [w.leaf_value() for w in wrt]


def _tensor(v, device: torch.device, dtype=None) -> torch.Tensor:
  """A value (expr, SpartanArray, tensor, host data) as a tensor on
  ``device``."""
  if isinstance(v, Expr):
    v = v.evaluate()
  if isinstance(v, SpartanArray):
    v = v.data
  if not isinstance(v, torch.Tensor):
    v = torch.from_numpy(np.array(v, order="C"))
  return v.to(device=device, dtype=dtype)


def _array(v) -> SpartanArray:
  return SpartanArray(_tensor(v, get_mesh().device))


def _wrap(out):
  if isinstance(out, dict):
    return {k: _array(v) for k, v in out.items()}
  if isinstance(out, (tuple, list)):
    return type(out)(_array(v) for v in out)
  return _array(out)


def compile_fn(expr: Expr, wrt: Sequence[Expr], donate: Sequence[int] = ()):
  """Precompile a DAG into a reusable call over the ``wrt`` leaves — the
  serving entry point: optimize once, then call with fresh values (numpy,
  tensors, SpartanArrays) of the compiled shapes.

      f = sp.compile(loss, wrt=[x_leaf])
      out = f(new_batch)          # SpartanArray

  The call replays the optimized DAG's emitters without autograd, so its
  kernels launch on the card; the first (template) call at compile time
  builds them.  ``donate`` is accepted for the reference's signature and
  does nothing: torch has no buffer donation, so every argument survives
  the call, the template leaves included."""
  fn, args = as_function(expr, wrt)
  del donate
  with torch.no_grad():
    fn(*args)  # builds and binds the kernels the DAG launches
  shapes = [tuple(getattr(a, "shape", ())) for a in args]
  device = get_mesh().device

  def call(*new_vals):
    if len(new_vals) != len(args):
      raise TypeError(f"expected {len(args)} arguments, got {len(new_vals)}")
    vals = []
    for v, template, shp in zip(new_vals, args, shapes):
      data = v.data if isinstance(v, SpartanArray) else v
      if tuple(getattr(data, "shape", ())) != shp:
        raise ValueError(f"argument shape {getattr(data, 'shape', None)} "
                         f"!= compiled shape {shp}")
      vals.append(_tensor(data, device)
                  if isinstance(template, torch.Tensor) else data)
    with torch.no_grad():
      return _wrap(fn(*vals))

  return call


def _leaves(args) -> List[torch.Tensor]:
  """Fresh leaf tensors that require grad (a weak Python scalar becomes a
  0-d float64 tensor)."""
  device = get_mesh().device
  out = []
  for a in args:
    t = a if isinstance(a, torch.Tensor) else torch.tensor(
        a, dtype=torch.float64, device=device)
    out.append(t.detach().requires_grad_())
  return out


def _scalar_output(out, what: str) -> torch.Tensor:
  out = _tensor(out, get_mesh().device)
  if out.numel() != 1 or out.ndim:
    raise TypeError(f"{what} is defined for scalar-output exprs, got shape "
                    f"{tuple(out.shape)}")
  return out


def _grads(out: torch.Tensor, leaves: Sequence[torch.Tensor],
           grad_outputs=None, create_graph: bool = False,
           retain_graph: Optional[bool] = None) -> List[torch.Tensor]:
  """d out / d leaves, zeros for a leaf ``out`` does not depend on."""
  if not out.requires_grad:
    return [torch.zeros_like(l) for l in leaves]
  gs = torch.autograd.grad(out, leaves, grad_outputs=grad_outputs,
                           create_graph=create_graph,
                           retain_graph=retain_graph, allow_unused=True)
  return [torch.zeros_like(l) if g is None else g
          for g, l in zip(gs, leaves)]


def _jacobian_rows(g: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
  """d g / d leaf for a gradient ``g`` built with ``create_graph``: one
  reverse pass through it a row, (g.numel(), leaf.numel())."""
  flat = g.reshape(-1)
  rows = [_grads(flat[k], [leaf], retain_graph=True)[0].reshape(-1)
          for k in range(flat.numel())]
  if not rows:
    return torch.zeros((0, leaf.numel()), dtype=leaf.dtype,
                       device=leaf.device)
  return torch.stack(rows).detach()


def _inner(gs: Sequence[torch.Tensor], vs: Sequence[torch.Tensor]
           ) -> torch.Tensor:
  """Σ <g_i, v_i> over the pairs, a 0-d tensor."""
  terms = [(g * v).sum() for g, v in zip(gs, vs)]
  return torch.stack(terms).sum()


def grad(expr: Expr, wrt: Sequence[Expr]) -> List[SpartanArray]:
  """Gradients of a scalar expr with respect to leaf exprs."""
  return value_and_grad(expr, wrt)[1]


def value_and_grad(expr: Expr, wrt: Sequence[Expr]
                   ) -> Tuple[SpartanArray, List[SpartanArray]]:
  fn, args = as_function(expr, wrt, differentiable=True)
  leaves = _leaves(args)
  out = _scalar_output(fn(*leaves), "grad")
  grads = _grads(out, leaves)
  return SpartanArray(out.detach()), [SpartanArray(g) for g in grads]


def hessian(expr: Expr, wrt: Sequence[Expr]):
  """Full Hessians of a scalar expr with respect to each leaf.  For a
  single leaf of shape S one array of shape S + S; for several leaves, the
  list of per-leaf diagonal blocks (cross blocks via :func:`hvp`).  Row by
  row: one reverse pass through the gradient a parameter."""
  fn, args = as_function(expr, wrt, differentiable=True)
  leaves = _leaves(args)
  out = _scalar_output(fn(*leaves), "hessian")
  grads = _grads(out, leaves, create_graph=True)
  outs = [SpartanArray(_jacobian_rows(g, leaf).reshape(tuple(leaf.shape) * 2))
          for leaf, g in zip(leaves, grads)]
  return outs[0] if len(outs) == 1 else outs


def hvp(expr: Expr, wrt: Sequence[Expr], vectors) -> List[SpartanArray]:
  """Hessian-vector products without a materialized Hessian:
  ``∇ <∇f, v>``, reverse over reverse."""
  fn, args = as_function(expr, wrt, differentiable=True)
  leaves = _leaves(args)
  vecs = [_tensor(v, l.device, l.dtype) for v, l in zip(vectors, leaves)]
  out = _scalar_output(fn(*leaves), "hvp")
  grads = _grads(out, leaves, create_graph=True)
  return [SpartanArray(h.detach())
          for h in _grads(_inner(grads, vecs), leaves)]


def jvp(expr: Expr, wrt: Sequence[Expr], tangents
        ) -> Tuple[SpartanArray, SpartanArray]:
  """Forward mode: the DAG's value and its directional derivative along
  ``tangents``, by the double-vjp identity ``J t = d/du <Jᵀ u, t>``."""
  fn, args = as_function(expr, wrt, differentiable=True)
  leaves = _leaves(args)
  tans = [_tensor(t, l.device, l.dtype) for t, l in zip(tangents, leaves)]
  out = _tensor(fn(*leaves), leaves[0].device if leaves else None)
  if not out.requires_grad:
    return SpartanArray(out.detach()), SpartanArray(torch.zeros_like(out))
  u = torch.zeros_like(out, requires_grad=True)
  vjp = _grads(out, leaves, grad_outputs=u, create_graph=True)
  (tangent,) = _grads(_inner(vjp, tans), [u])
  return SpartanArray(out.detach()), SpartanArray(tangent.detach())


# -- BFGS, as jax.scipy.optimize.minimize(method="BFGS") computes it ------------
#
# Wright and Nocedal's Algorithm 6.1 with the strong-Wolfe line search of
# Algorithms 3.5 and 3.6, in jax's order of choices.  The iterate, gradient
# and inverse Hessian stay on the device; the step's scalars (the value,
# the slope, the step length) are read to the host once an evaluation and
# decide the branches there, in float64.

_C1, _C2 = 1e-4, 0.9


def _f64(v) -> np.float64:
  return np.float64(v)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
  C = fpa
  db, dc = b - a, c - a
  denom = (db * dc) ** 2 * (db - dc)
  d1 = np.array([[dc ** 2, -db ** 2], [-dc ** 3, db ** 3]])
  d2 = np.array([fb - fa - C * db, fc - fa - C * dc])
  A, B = (d1 @ d2) / denom
  radical = B * B - 3. * A * C
  return a + (-B + np.sqrt(radical)) / (3. * A)


def _quadmin(a, fa, fpa, b, fb):
  db = b - a
  B = (fb - fa - fpa * db) / (db ** 2)
  return a - fpa / (2. * B)


class _Searcher:
  """The line search along ``p`` from ``x`` (value ``phi0``, slope
  ``dphi0``); counts its evaluations in ``nfev``."""

  def __init__(self, value_and_grad, x, p, phi0, dphi0, low_bits: bool):
    self.value_and_grad, self.x, self.p = value_and_grad, x, p
    self.phi0, self.dphi0, self.low_bits = phi0, dphi0, low_bits
    self.nfev = 0

  def eval(self, t):
    phi, g = self.value_and_grad(self.x + torch.as_tensor(
        t, dtype=self.p.dtype, device=self.p.device) * self.p)
    self.nfev += 1
    return phi, _f64(torch.dot(g, self.p)), g

  def wolfe_one(self, a, phi) -> bool:  # the negation of the first
    return bool(phi > self.phi0 + _C1 * a * self.dphi0)

  def wolfe_two(self, dphi) -> bool:
    return bool(abs(dphi) <= -_C2 * self.dphi0)

  def zoom(self, a_lo, phi_lo, dphi_lo, a_hi, phi_hi, dphi_hi, g_0):
    """Algorithm 3.6 (jax's ``_zoom``): ``(failed, a, phi, dphi, g)``."""
    failed = done = False
    j = 0
    a_rec, phi_rec = (a_lo + a_hi) / 2., (phi_lo + phi_hi) / 2.
    star = (_f64(1.), phi_lo, dphi_lo, g_0)
    threshold = 1e-5 if self.low_bits else 1e-10
    while not done and not failed:
      dalpha = a_hi - a_lo
      a, b = min(a_hi, a_lo), max(a_hi, a_lo)
      cchk, qchk = 0.2 * dalpha, 0.1 * dalpha
      failed = bool(dalpha <= threshold)
      a_cubic = _cubicmin(a_lo, phi_lo, dphi_lo, a_hi, phi_hi, a_rec, phi_rec)
      use_cubic = j > 0 and a + cchk < a_cubic < b - cchk
      a_quad = _quadmin(a_lo, phi_lo, dphi_lo, a_hi, phi_hi)
      use_quad = not use_cubic and a + qchk < a_quad < b - qchk
      a_j = (a_cubic if use_cubic else a_quad if use_quad
             else (a_lo + a_hi) / 2.)
      phi_j, dphi_j, g_j = self.eval(a_j)
      hi_to_j = self.wolfe_one(a_j, phi_j) or phi_j >= phi_lo
      star_to_j = self.wolfe_two(dphi_j) and not hi_to_j
      hi_to_lo = (dphi_j * (a_hi - a_lo) >= 0. and not hi_to_j
                  and not star_to_j)
      lo_to_j = not hi_to_j and not star_to_j
      if hi_to_j:
        a_rec, phi_rec = a_hi, phi_hi
        a_hi, phi_hi, dphi_hi = a_j, phi_j, dphi_j
      if star_to_j:
        done = True
        star = (a_j, phi_j, dphi_j, g_j)
      if hi_to_lo:
        a_rec, phi_rec = a_hi, phi_hi
        a_hi, phi_hi, dphi_hi = a_lo, phi_lo, dphi_lo
      elif lo_to_j:
        a_rec, phi_rec = a_lo, phi_lo
      if lo_to_j:
        a_lo, phi_lo, dphi_lo = a_j, phi_j, dphi_j
      j += 1
      failed = failed or j >= 30
    return (failed,) + star


def _line_search(value_and_grad, x, p, f, old_old_fval, g, maxiter: int):
  """Algorithm 3.5 (jax's ``line_search`` from a known value and gradient):
  ``(failed, status, a_k, f_k, g_k, nfev)``."""
  low_bits = x.dtype != torch.float64
  s = _Searcher(value_and_grad, x, p, f, _f64(torch.dot(g, p)), low_bits)
  with np.errstate(all="ignore"):
    cand = 1.01 * 2 * (s.phi0 - old_old_fval) / s.dphi0
  start = _f64(1.0) if cand > 1 else cand
  done = failed = False
  i = 1
  a_i1, phi_i1, dphi_i1 = _f64(0.), s.phi0, s.dphi0
  star = (_f64(0.), s.phi0, s.dphi0, g)
  while not done and i <= maxiter and not failed:
    a_i = start if i == 1 else a_i1 * 2.
    phi_i, dphi_i, g_i = s.eval(a_i)
    to_zoom1 = s.wolfe_one(a_i, phi_i) or (phi_i >= phi_i1 and i > 1)
    to_i = s.wolfe_two(dphi_i) and not to_zoom1
    to_zoom2 = dphi_i >= 0. and not to_zoom1 and not to_i
    if to_zoom1:
      failed, *star = s.zoom(a_i1, phi_i1, dphi_i1, a_i, phi_i, dphi_i, g)
      done = True
    elif to_i:
      done, star = True, (a_i, phi_i, dphi_i, g_i)
    elif to_zoom2:
      failed, *star = s.zoom(a_i, phi_i, dphi_i, a_i1, phi_i1, dphi_i1, g)
      done = True
    i += 1
    a_i1, phi_i1, dphi_i1 = a_i, phi_i, dphi_i
  status = 1 if failed else 3 if i > maxiter else 0
  alpha = star[0]
  if low_bits and abs(alpha) < 1e-8:
    alpha = np.sign(alpha) * 1e-8
  return failed or not done, status, alpha, star[1], star[3], s.nfev


def _bfgs(value_and_grad, x0: torch.Tensor, maxiter: int, gtol: float,
          norm=np.inf, line_search_maxiter: int = 10):
  """jax's ``minimize_bfgs``: a dict of the result's fields."""
  d = x0.shape[0]
  H = torch.eye(d, dtype=x0.dtype, device=x0.device)
  f, g = value_and_grad(x0)
  x = x0
  converged = bool(torch.linalg.vector_norm(g, ord=norm) < gtol)
  failed, k, nfev, ls_status = False, 0, 1, 0
  old_old_fval = f + _f64(torch.linalg.vector_norm(g)) / 2
  with np.errstate(all="ignore"):
    while not converged and not failed and k < maxiter:
      p = -(H @ g)
      failed, ls_status, a_k, f1, g1, n = _line_search(
          value_and_grad, x, p, f, old_old_fval, g, line_search_maxiter)
      nfev += n
      s = torch.as_tensor(a_k, dtype=p.dtype, device=p.device) * p
      y = g1 - g
      rho = torch.reciprocal(torch.dot(y, s))
      if bool(torch.isfinite(rho)):
        w = torch.eye(d, dtype=x.dtype, device=x.device) - rho * torch.outer(
            s, y)
        H = w @ H @ w.T + rho * torch.outer(s, s)
      converged = bool(torch.linalg.vector_norm(g1, ord=norm) < gtol)
      k += 1
      x, old_old_fval, f, g = x + s, f, f1, g1
  status = (0 if converged else 1 if k == maxiter
            else 2 + ls_status if failed else -1)
  return {"x": x, "fun": f, "jac": g, "nit": k, "nfev": nfev,
          "success": converged and not failed, "status": status}


def minimize(loss_expr: Expr, wrt: Sequence[Expr], method: str = "bfgs",
             tol: Optional[float] = None, options: Optional[dict] = None,
             polish: bool = True):
  """Minimize a scalar lazy loss over its leaf parameters with BFGS, as
  ``jax.scipy.optimize.minimize(method="BFGS")`` computes it: ``maxiter``
  200 a parameter, the infinity norm of the gradient below ``gtol`` (the
  option, else ``tol``, else 1e-5), the zoom line search with c1 = 1e-4,
  c2 = 0.9 and 10 iterations, and its ``status`` codes.  The iterates stay
  on the device; each evaluation reads the loss and the slope on the host.

  Several leaves are flattened into one float64 parameter vector and split
  back on return.  A run of up to 512 parameters ends with up to five
  Newton steps on the same function (a step is taken only while it is
  finite and does not raise the loss), and then counts as a success if the
  final gradient's 2-norm is below ``tol`` (else ``1e-6 (1 + |f|)``), as
  the reference's polish does.  Returns ``(params, info)``: the optimized
  leaves as SpartanArrays and a dict of ``fun``, ``nit``, ``success`` and
  ``status``."""
  if method.lower() != "bfgs":
    raise ValueError("method must be 'bfgs'")
  options = dict(options or {})
  fn, args = as_function(loss_expr, wrt, differentiable=True)
  shapes = [tuple(getattr(a, "shape", ())) for a in args]
  sizes = [int(np.prod(s)) if s else 1 for s in shapes]
  bounds = np.cumsum([0] + sizes)

  def flat_fn(x):
    return fn(*(x[bounds[i]:bounds[i + 1]].reshape(shapes[i])
                for i in range(len(shapes))))

  def value_and_grad_flat(x):
    xl = x.detach().requires_grad_()
    f = _scalar_output(flat_fn(xl), "minimize")
    (g,) = _grads(f, [xl])
    return _f64(f.detach()), g

  device = get_mesh().device
  x0 = torch.cat([_tensor(a, device, torch.float64).reshape(-1)
                  for a in args])
  maxiter = options.pop("maxiter", None)
  res = _bfgs(value_and_grad_flat, x0,
              maxiter=200 * x0.numel() if maxiter is None else int(maxiter),
              gtol=options.pop("gtol", tol if tol is not None else 1e-5),
              **options)
  x, fun, success = res["x"], float(res["fun"]), bool(res["success"])
  if polish and x.numel() <= 512:
    eye = torch.eye(x.numel(), dtype=x.dtype, device=x.device)
    for _ in range(5):
      g, h = _newton_terms(flat_fn, x)
      step, info = torch.linalg.solve_ex(h + 1e-12 * eye, g)
      gnorm = float(torch.linalg.vector_norm(g))
      if not np.isfinite(gnorm) or gnorm < 1e-12 or int(info) != 0:
        break  # a singular Hessian has no Newton step
      x_new = x - step
      with torch.no_grad():
        f_new = float(_scalar_output(flat_fn(x_new), "minimize"))
      if not np.isfinite(f_new) or f_new > fun + 1e-12:
        break
      x, fun = x_new, f_new
    if not success:
      gfin = float(torch.linalg.vector_norm(value_and_grad_flat(x)[1]))
      success = bool(np.isfinite(gfin) and gfin < (
          tol if tol is not None else 1e-6 * (1.0 + abs(fun))))
  parts = [x[bounds[i]:bounds[i + 1]].reshape(shapes[i]).detach()
           for i in range(len(shapes))]
  return ([SpartanArray(p) for p in parts],
          {"fun": fun, "nit": int(res["nit"]), "success": success,
           "status": int(res["status"])})


def _newton_terms(flat_fn, x: torch.Tensor):
  """The gradient and the Hessian of ``flat_fn`` at ``x``."""
  xl = x.detach().requires_grad_()
  f = _scalar_output(flat_fn(xl), "minimize")
  (g,) = _grads(f, [xl], create_graph=True)
  return g.detach(), _jacobian_rows(g, xl)


def sgd_train(loss_expr: Expr, params: Sequence[Expr], lr: float,
              steps: int, collect_losses: bool = False):
  """Plain SGD over any scalar lazy loss: differentiates the DAG with
  respect to the ``params`` leaves and runs ``steps`` updates
  ``p ← p - lr ∇p``.  The reference runs them in one ``lax.scan``; here a
  host loop replays the emitters and autograd a step, writes each step's
  loss into a device tensor and reads nothing back inside the loop (no
  CUDA graph is captured).

  Returns the updated params (SpartanArrays), and the loss curve (each
  step's loss at its pre-update parameters) when ``collect_losses``."""
  fn, args = as_function(loss_expr, params, differentiable=True)
  ps = [p.detach() for p in _leaves(args)]
  steps = int(steps)
  losses = None
  for i in range(steps):
    leaves = [p.requires_grad_() for p in ps]
    loss = _scalar_output(fn(*leaves), "sgd_train")
    grads = _grads(loss, leaves)
    if losses is None:
      losses = torch.empty(steps, dtype=loss.dtype, device=loss.device)
    with torch.no_grad():
      losses[i] = loss
      ps = [p - lr * g for p, g in zip(leaves, grads)]
  out = [SpartanArray(p.detach()) for p in ps]
  if collect_losses:
    if losses is None:
      losses = torch.empty(0, dtype=torch.float64, device=get_mesh().device)
    return out, SpartanArray(losses)
  return out
