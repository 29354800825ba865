"""Loops over lazy bodies: ``fori_loop`` and ``make_fori``.

Port of the ``fori_loop``/``make_fori`` part of ``spartan_tpu/expr/loop.py``.
The body is an Expr-builder over a symbolic carry; it is optimized and
leaf-stripped once into a *step* that maps carry tensors to carry tensors,
and a Python loop calls that one cached step ``n`` times (the reference
runs ``lax.fori_loop`` over the traced count instead).  Steps are cached by
the body's structural signature plus the flag fingerprint and device, so a
structurally identical loop built again reuses the step and only rebinds
its constants.  ``while_loop``, ``scan_iters`` and ``cond`` are later work,
as is capturing the step in a CUDA graph.

    w = sp.fori_loop(100, lambda w: w - 0.05 * sp.dot(X.T, sp.dot(X, w) - y),
                     sp.zeros((d,)))
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

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


def _runner_key(roots, init_arrs):
  from spartan_tpu_torch.backend.evaluator import flags_key
  from spartan_tpu_torch.core.mesh import get_mesh
  memo: dict = {}
  sigs = tuple(r.signature(memo) for r in roots)
  avals = tuple((a.shape, str(a.dtype)) for a in init_arrs)
  return ("fori", sigs, avals, flags_key(get_mesh().device))


def _collect_carry_consts(body_out_exprs, syms):
  """Optimize the roots; collect non-symbolic Val leaves in deterministic
  DAG order (the step's positional constant binding)."""
  from spartan_tpu_torch.backend.evaluator import _collect_leaves
  from spartan_tpu_torch.expr import optimize as opt_mod
  roots = [opt_mod.optimize(e) for e in body_out_exprs]
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
        v = e._emit(ctx, [emit(c) for c in e.children()])
      env[e.expr_id] = v
      return v

    out = tuple(as_device_tensor(emit(r), device) for r in roots_s)
    del emit  # break emit's cycle through its own cell (see evaluator)
    return out

  return step, const_leaves


def fori_loop(n: int, body: Callable, init) -> Any:
  """Run ``carry = body(carry)`` ``n`` times; ``init`` (and the result)
  may be one array/expr or a tuple."""
  return make_fori(body, init)(n)


def make_fori(body: Callable, init) -> Callable[[int], Any]:
  """Build the loop's step once; return ``run_fn(n) -> result``.  Everything
  ``body`` closes over is evaluated once and bound as step constants."""
  from spartan_tpu_torch.core.mesh import get_mesh
  device = get_mesh().device
  is_tuple = isinstance(init, (tuple, list))
  inits = list(init) if is_tuple else [init]
  init_arrs = [lazify(v).evaluate() for v in inits]
  syms = [SymbolicVal(Aval(a.shape, a.dtype)) for a in init_arrs]
  out = body(*syms)
  outs = list(out) if isinstance(out, (tuple, list)) else [out]
  if len(outs) != len(syms):
    raise ValueError(f"body returned {len(outs)} values for "
                     f"{len(syms)} carries")
  out_exprs = [lazify(o) for o in outs]
  for o, a in zip(out_exprs, init_arrs):
    if o.shape != a.shape or o.dtype != a.dtype:
      raise ValueError(f"carry changed in body: {a.shape} {a.dtype} -> "
                       f"{o.shape} {o.dtype} (loop carries must keep their "
                       "shape and dtype)")

  key = None if _has_cached_interior(out_exprs) else _runner_key(
      out_exprs, init_arrs)
  step = _runner_cache.get(key) if key is not None else None
  if step is not None:
    _, const_leaves = _collect_carry_consts(out_exprs, syms)
  else:
    step, const_leaves = _compile_carry_body(out_exprs, syms, device)
    if key is not None:
      if len(_runner_cache) >= _RUNNER_CACHE_MAX:
        _runner_cache.clear()
      _runner_cache[key] = step
  const_vals = [l.leaf_value() for l in const_leaves]

  def run_fn(n: int):
    carries = tuple(a.data for a in init_arrs)
    for _ in range(int(n)):
      carries = step(carries, const_vals)
    results = [SpartanArray(c, a.tiling) for c, a in zip(carries, init_arrs)]
    return tuple(results) if is_tuple else results[0]

  return run_fn
