"""Loops over lazy bodies: ``fori_loop``/``make_fori``, ``while_loop``,
``scan_iters`` and ``cond``.

Port of ``spartan_tpu/expr/loop.py``.  A body is an Expr-builder over a
symbolic carry; it is optimized and leaf-stripped once into a *step* that
maps carry tensors to carry tensors, and a Python loop calls that one
cached step (the reference runs ``lax.fori_loop``, ``lax.while_loop`` and
``lax.scan`` over the traced step instead).  ``while_loop`` runs its
condition's step on the device and reads the 0-d result on the host before
every turn: one sync an iteration.  ``scan_iters`` writes each step's
collected values into ``(n, ...)`` tensors allocated on the device up
front, with no sync inside the loop.  ``cond`` reads its predicate once on
the host and runs only the chosen branch's step.  Steps are cached by the
loop's kind, the bodies' structural signature, the kind's own extras, the
flag fingerprint and the device, so a structurally identical loop built
again reuses the steps and only rebinds their constants.

    w = sp.fori_loop(100, lambda w: w - 0.05 * sp.dot(X.T, sp.dot(X, w) - y),
                     sp.zeros((d,)))
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch

from spartan_tpu_torch.core.array import SpartanArray
from spartan_tpu_torch.expr.base import (Aval, EmitCtx, Expr, ListExpr, Val,
                                         lazify)


class SymbolicVal(Val):
  """A leaf standing for the loop carry: shape and dtype, no value."""

  _members = ()
  _params = ()

  def __init__(self, aval: Aval):
    Expr.__init__(self)
    self.value = None
    self._aval = aval

  def aval(self):
    return self._aval

  def leaf_value(self):
    raise RuntimeError("SymbolicVal has no value — it is the loop carry "
                       "placeholder and only exists inside loop bodies")

  def _sig_local(self, memo, result):
    ordinal = memo.get("__leaf_counter__", 0)
    memo["__leaf_counter__"] = ordinal + 1
    return ("SymVal", ordinal) + self._aval.key

  def _sig_store(self, memo, sig):
    memo[self.expr_id] = sig


_runner_cache: Dict[Any, Callable] = {}
_RUNNER_CACHE_MAX = 256


def clear_runner_cache() -> None:
  _runner_cache.clear()


def _has_cached_interior(roots) -> bool:
  flag = [False]

  def scan(e: Expr):
    if e._cache is not None and not isinstance(e, Val):
      flag[0] = True

  for r in roots:
    r.visit(scan)
  return flag[0]


def _runner_key(tag: str, roots, init_arrs, extra=()):
  """The cache key of a loop's steps: the loop's kind, the roots' shared
  structural signature, the carries' avals, the kind's own ``extra``, the
  flag fingerprint and the mesh."""
  from spartan_tpu_torch.backend.evaluator import flags_key
  from spartan_tpu_torch.core.mesh import get_mesh
  memo: dict = {}
  sigs = tuple(r.signature(memo) for r in roots)
  avals = tuple((a.shape, str(a.dtype)) for a in init_arrs)
  return (tag, sigs, avals, tuple(extra), flags_key(get_mesh()))


def _collect_carry_consts(body_out_exprs, syms):
  """Optimize the roots together, so a node that several roots share (a
  matvec) stays one node and runs once a step; collect non-symbolic Val
  leaves in deterministic DAG order (the step's positional constant
  binding)."""
  from spartan_tpu_torch.backend.evaluator import _collect_leaves
  from spartan_tpu_torch.expr import optimize as opt_mod
  roots = list(opt_mod.optimize(ListExpr(list(body_out_exprs))).vals)
  sym_ids = {s.expr_id for s in syms}
  const_leaves: List[Val] = []
  seen = set()
  for r in roots:
    for leaf in _collect_leaves(r):
      if leaf.expr_id not in sym_ids and leaf.expr_id not in seen:
        seen.add(leaf.expr_id)
        const_leaves.append(leaf)
  return roots, const_leaves


def _compile_carry_body(body_out_exprs, syms, device):
  """``step(carries, consts) -> carries`` over the leaf-stripped optimized
  body, plus the constant leaves to bind."""
  from spartan_tpu_torch.backend.evaluator import (_strip_leaf_values,
                                                   as_device_tensor)
  roots, const_leaves = _collect_carry_consts(body_out_exprs, syms)
  stripped, stubs = _strip_leaf_values(ListExpr(list(roots)), const_leaves)
  roots_s = list(stripped.vals)
  const_pos = {s.expr_id: i for i, s in enumerate(stubs)}
  sym_pos = {s.expr_id: i for i, s in enumerate(syms)}
  ctx = EmitCtx(abstract=False, device=device)

  def step(carries, consts):
    env = {}

    def emit(e: Expr):
      if e.expr_id in env:
        return env[e.expr_id]
      if e.expr_id in sym_pos:
        v = carries[sym_pos[e.expr_id]]
      elif isinstance(e, Val):
        v = consts[const_pos[e.expr_id]]
      else:
        v = e.emit(ctx, [emit(c) for c in e.children()])
      env[e.expr_id] = v
      return v

    out = tuple(as_device_tensor(emit(r), device) for r in roots_s)
    del emit  # break emit's cycle through its own cell (see evaluator)
    return out

  return step, const_leaves


def _symbolic_carry(init):
  """(is_tuple, evaluated carries, their symbolic leaves): ``init`` is one
  array/expr or a tuple/list of them."""
  is_tuple = isinstance(init, (tuple, list))
  inits = list(init) if is_tuple else [init]
  init_arrs = [lazify(v).evaluate() for v in inits]
  syms = [SymbolicVal(Aval(a.shape, a.dtype)) for a in init_arrs]
  return is_tuple, init_arrs, syms


def _as_exprs(out) -> List[Expr]:
  outs = list(out) if isinstance(out, (tuple, list)) else [out]
  return [lazify(o) for o in outs]


def _check_carry(out_exprs, init_arrs) -> None:
  """Raise unless the body returns one value a carry, each with its
  carry's shape and dtype."""
  if len(out_exprs) != len(init_arrs):
    raise ValueError(f"body returned {len(out_exprs)} values for "
                     f"{len(init_arrs)} carries")
  for o, a in zip(out_exprs, init_arrs):
    if o.shape != a.shape or o.dtype != a.dtype:
      raise ValueError(f"carry changed in body: {a.shape} {a.dtype} -> "
                       f"{o.shape} {o.dtype} (loop carries must keep their "
                       "shape and dtype)")


def _results(carries, init_arrs, is_tuple):
  """The final carries as arrays with their inits' tiling."""
  results = [SpartanArray(c, a.tiling) for c, a in zip(carries, init_arrs)]
  return tuple(results) if is_tuple else results[0]


def _steps(tag, root_groups, syms, init_arrs, extra=()):
  """One step a group of roots, built once and cached together under
  ``tag``, and each group's constant values (rebound on a cache hit)."""
  from spartan_tpu_torch.core.mesh import get_mesh
  device = get_mesh().device
  roots = [r for group in root_groups for r in group]
  key = None if _has_cached_interior(roots) else _runner_key(
      tag, roots, init_arrs, extra)
  steps = _runner_cache.get(key) if key is not None else None
  if steps is None:
    built = [_compile_carry_body(g, syms, device) for g in root_groups]
    steps = tuple(step for step, _ in built)
    consts = [c for _, c in built]
    if key is not None:
      if len(_runner_cache) >= _RUNNER_CACHE_MAX:
        _runner_cache.clear()
      _runner_cache[key] = steps
  else:
    consts = [_collect_carry_consts(g, syms)[1] for g in root_groups]
  return steps, [[l.leaf_value() for l in c] for c in consts]


def fori_loop(n: int, body: Callable, init) -> Any:
  """Run ``carry = body(carry)`` ``n`` times; ``init`` (and the result)
  may be one array/expr or a tuple."""
  return make_fori(body, init)(n)


def make_fori(body: Callable, init) -> Callable[[int], Any]:
  """Build the loop's step once; return ``run_fn(n) -> result``.  Everything
  ``body`` closes over is evaluated once and bound as step constants."""
  is_tuple, init_arrs, syms = _symbolic_carry(init)
  out_exprs = _as_exprs(body(*syms))
  _check_carry(out_exprs, init_arrs)
  (step,), (const_vals,) = _steps("fori", [out_exprs], syms, init_arrs)

  def run_fn(n: int):
    carries = tuple(a.data for a in init_arrs)
    for _ in range(int(n)):
      carries = step(carries, const_vals)
    return _results(carries, init_arrs, is_tuple)

  return run_fn


def while_loop(cond: Callable, body: Callable, init,
               max_iters: int = None) -> Any:
  """``while cond(carry): carry = body(carry)``, as ``lax.while_loop``
  orders it: the condition is tested before the first body, so a false
  ``cond(init)`` runs no iteration.  ``cond`` builds a 0-d lazy expr over
  the symbolic carry; each turn runs its step on the device and reads the
  result on the host (one sync an iteration).  ``max_iters`` (optional)
  is a host count ANDed into the test."""
  is_tuple, init_arrs, syms = _symbolic_carry(init)
  body_exprs = _as_exprs(body(*syms))
  _check_carry(body_exprs, init_arrs)
  cond_expr = lazify(cond(*syms))
  if cond_expr.shape != ():
    raise ValueError(f"cond must produce a scalar, got {cond_expr.shape}")
  (body_step, cond_step), (body_vals, cond_vals) = _steps(
      "while", [body_exprs, [cond_expr]], syms, init_arrs,
      extra=(None if max_iters is None else int(max_iters),))
  carries = tuple(a.data for a in init_arrs)
  k = 0
  while ((max_iters is None or k < max_iters)
         and bool(cond_step(carries, cond_vals)[0])):
    carries = body_step(carries, body_vals)
    k += 1
  return _results(carries, init_arrs, is_tuple)


def scan_iters(n: int, body: Callable, init, collect: Callable = None
               ) -> Tuple[Any, Any]:
  """Like :func:`fori_loop`, but also returns per-iteration outputs
  stacked along a leading axis (``lax.scan`` semantics).

  ``collect(carry_exprs...)`` builds the per-step lazy output (default:
  the body's first output); each step's values go into ``(n, ...)``
  tensors allocated on the device up front.  Returns ``(final_carry,
  stacked_outputs)``; the stacked outputs are a tuple exactly when
  ``collect`` returns a tuple or list."""
  from spartan_tpu_torch.core.mesh import get_mesh
  device = get_mesh().device
  is_tuple, init_arrs, syms = _symbolic_carry(init)
  body_exprs = _as_exprs(body(*syms))
  _check_carry(body_exprs, init_arrs)
  if collect is None:
    collected, multi = body_exprs[:1], False
  else:
    c = collect(*syms)
    multi = isinstance(c, (tuple, list))
    collected = _as_exprs(c)
  n, n_carry = int(n), len(body_exprs)
  (step,), (const_vals,) = _steps("scan", [body_exprs + collected], syms,
                                  init_arrs, extra=(n, n_carry))
  ys = [torch.empty((n,) + e.shape, dtype=e.dtype, device=device)
        for e in collected]
  carries = tuple(a.data for a in init_arrs)
  for i in range(n):
    out = step(carries, const_vals)
    carries = out[:n_carry]
    for y, v in zip(ys, out[n_carry:]):
      y[i] = v
  stacked = [SpartanArray(y) for y in ys]
  return (_results(carries, init_arrs, is_tuple),
          tuple(stacked) if multi else stacked[0])


def cond(pred, true_fn: Callable, false_fn: Callable, operands) -> Any:
  """Run ONE branch (``lax.cond``): ``pred`` is a 0-d lazy expr (or bool),
  read once on the host after both branches are built and checked; the
  branches are Expr-builders over symbolic operands and must return as
  many values, of matching shapes.  The results take no tiling from the
  operands."""
  _, op_arrs, syms = _symbolic_carry(operands)
  t_out, f_out = true_fn(*syms), false_fn(*syms)
  multi = isinstance(t_out, (tuple, list))
  t_exprs, f_exprs = _as_exprs(t_out), _as_exprs(f_out)
  if len(t_exprs) != len(f_exprs):
    raise ValueError("branches must return the same number of values")
  for a, b in zip(t_exprs, f_exprs):
    if a.shape != b.shape:
      raise ValueError(f"branch shapes differ: {a.shape} vs {b.shape}")
  pred_expr = lazify(pred)
  if pred_expr.shape != ():
    raise ValueError(f"pred must be scalar, got {pred_expr.shape}")
  (t_step, f_step), (t_vals, f_vals) = _steps(
      "cond", [t_exprs, f_exprs], syms, op_arrs)
  ops = tuple(a.data for a in op_arrs)
  take = bool(pred_expr.evaluate().data)
  out = t_step(ops, t_vals) if take else f_step(ops, f_vals)
  results = [SpartanArray(v) for v in out]
  return tuple(results) if multi else results[0]
