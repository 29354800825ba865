"""Region evaluator: lazy DAG → one eager runner per structure.

Port of ``spartan_tpu/backend/evaluator.py``.  The reference compiles each
region with ``jax.jit``; PyTorch runs eagerly, so a region's *runner* calls
the optimized DAG's emitters in topological order on the mesh's device.
What the cache still saves is the optimizer pass and the DAG rebuild:

* ``_region_cache``: optimized structural signature + flag fingerprint →
  runner over a leaf-stripped DAG;
* ``_fast_cache`` (the fast lane): the RAW signature → (runner, binding
  recipe), so a structurally repeated evaluation (an iterative loop's
  step) skips the optimizer entirely.

CUDA-graph capture of a runner is later work.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Dict, List, Tuple

import torch

from spartan_tpu_torch.config import FLAGS
from spartan_tpu_torch.core.array import SpartanArray
from spartan_tpu_torch.core.mesh import Mesh, get_mesh
from spartan_tpu_torch.core.tiling import Tiling
from spartan_tpu_torch.expr import optimize as opt_mod
from spartan_tpu_torch.expr.base import (Aval, EmitCtx, Expr, ListExpr,
                                         NotShapeable, Val,
                                         semantic_flags_fingerprint)
from spartan_tpu_torch.util import log_debug

_region_cache: "OrderedDict[Tuple, Callable]" = OrderedDict()
_fast_cache: "OrderedDict[Tuple, Any]" = OrderedDict()

# counters surfaced for profiling and tests
stats = {"compiles": 0, "evals": 0, "cache_hits": 0, "fast_hits": 0}


def clear_cache() -> None:
  from spartan_tpu_torch.expr.loop import clear_runner_cache
  _region_cache.clear()
  _fast_cache.clear()
  clear_runner_cache()  # loop runners ride the same signature invariants


def _opt_flags_fingerprint() -> tuple:
  """Optimizer-pipeline flags: the runner depends on which passes ran."""
  return (FLAGS.optimization, FLAGS.opt_fusion, FLAGS.opt_reduce_fusion,
          FLAGS.opt_collapse_cached, FLAGS.opt_const_fold,
          FLAGS.opt_auto_tiling, FLAGS.max_fused_kernel_ops)


def flags_key(mesh: Mesh) -> tuple:
  """What a cached runner depends on besides the DAG's structure: the
  flags, the device, and the mesh's shape (a sparse node's sharded route
  reads the number of shards when it runs)."""
  return (semantic_flags_fingerprint(), FLAGS.use_kernels, str(mesh.device),
          tuple(mesh.shape.items()), _opt_flags_fingerprint())


def _collect_leaves(root: Expr) -> List[Val]:
  """Val leaves in deterministic pre-order (the runner's argument order)."""
  leaves: List[Val] = []
  seen = set()
  stack = [root]
  while stack:
    e = stack.pop()
    if e.expr_id in seen:
      continue
    seen.add(e.expr_id)
    if isinstance(e, Val):
      leaves.append(e)
      continue
    stack.extend(reversed(e.children()))
  return leaves


class _StubVal(Val):
  """Valueless leaf used inside cached runners: keeps the structure the
  runner walks without pinning the original leaf's device buffer."""

  _members = ()
  _params = ()

  def __init__(self, aval: Aval):
    Expr.__init__(self)
    self.value = None
    self._aval = aval

  def aval(self):
    return self._aval

  def leaf_value(self):
    raise RuntimeError("stub leaf has no value (runners bind leaves "
                       "positionally)")


def _strip_leaf_values(root: Expr, leaves: List[Val]):
  """Rebuild the DAG with stub leaves (same positional identity) so the
  cached runner holds no reference to user tensors."""
  stubs = {l.expr_id: _StubVal(l.aval()) for l in leaves}
  memo: Dict[int, Expr] = {}

  def go(e: Expr) -> Expr:
    hit = memo.get(e.expr_id)
    if hit is not None:
      return hit
    if isinstance(e, Val):
      out = stubs.get(e.expr_id, e)
    else:
      changed = {}
      for name in e._members:
        v = getattr(e, name)
        if isinstance(v, Expr):
          changed[name] = go(v)
        elif isinstance(v, (list, tuple)):
          changed[name] = [go(c) if isinstance(c, Expr) else c for c in v]
      out = e.replace(**changed)
    memo[e.expr_id] = out
    return out

  stripped = go(root)
  del go  # break go's cycle through its own cell (see _make_runner)
  return stripped, [stubs[l.expr_id] for l in leaves]


def _make_runner(root: Expr, leaf_index: Dict[int, int],
                 device: torch.device) -> Callable:
  ctx = EmitCtx(abstract=False, device=device)

  def run(*args):
    env: Dict[int, Any] = {}

    def emit(e: Expr):
      if e.expr_id in env:
        return env[e.expr_id]
      if isinstance(e, Val):
        v = args[leaf_index[e.expr_id]]
      else:
        v = e._emit(ctx, [emit(c) for c in e.children()])
      env[e.expr_id] = v
      return v

    out = emit(root)
    # emit reaches itself through its closure cell; clearing the cell
    # breaks that cycle, which would otherwise keep args (the region's
    # leaf tensors) alive until the cyclic garbage collector runs
    del emit
    return out

  return run


def as_device_tensor(v, device: torch.device) -> torch.Tensor:
  """A region output as a tensor on the mesh's device (weak Python scalars
  become 0-d tensors of their default dtype)."""
  if not isinstance(v, torch.Tensor):
    v = torch.as_tensor(v)
  return v.to(device)


def _wrap(kind: str, value, tiling: Tiling):
  if kind == "list":
    return [SpartanArray(as_device_tensor(v, tiling.mesh.device), tiling)
            for v in value]
  return SpartanArray(as_device_tensor(value, tiling.mesh.device), tiling)


def _materialize_unshapeable(expr: Expr) -> None:
  """Evaluate, children first, each node whose shape depends on its data
  (its ``aval`` raises ``NotShapeable``: a boolean mask, a host op), so
  that the region around it reads its result as a leaf."""

  def visit(e: Expr):
    if e._cache is not None or not hasattr(e, "evaluate_eager"):
      return
    try:
      e.aval()
      return  # shapeable after all
    except NotShapeable:
      pass
    e._cache = e.evaluate_eager()

  expr.visit(visit)


def _prepass(expr: Expr):
  """One iterative walk: DAG size, whether an interior node carries an
  eval cache, whether a node may need eager evaluation
  (``evaluate_eager``), and the leaves in ``_collect_leaves`` order."""
  size = 0
  interior_cached = has_eager = False
  leaves: List[Val] = []
  seen = set()
  stack = [expr]
  while stack:
    e = stack.pop()
    if e.expr_id in seen:
      continue
    seen.add(e.expr_id)
    size += 1
    if isinstance(e, Val):
      leaves.append(e)
      continue
    if e._cache is not None:
      interior_cached = True
      continue
    has_eager = has_eager or hasattr(e, "evaluate_eager")
    stack.extend(reversed(e.children()))
  return size, interior_cached, has_eager, leaves


def evaluate(expr: Expr):
  """Evaluate ``expr`` to SpartanArray(s), building its runner on miss."""
  if expr._cache is not None:
    return expr._cache
  mesh = get_mesh()
  tiling = Tiling(mesh)
  if isinstance(expr, Val):
    v = expr.value
    if isinstance(v, SpartanArray):
      return v
    result = SpartanArray(as_device_tensor(expr.leaf_value(), mesh.device),
                          tiling)
    expr._cache = result
    return result

  size, interior_cached, has_eager, raw_leaves = _prepass(expr)
  if has_eager:
    _materialize_unshapeable(expr)
    if expr._cache is not None:
      return expr._cache
    size, interior_cached, _, raw_leaves = _prepass(expr)
  import sys
  depth_budget = 10 * size + 1000  # the emitters recurse once per node
  if sys.getrecursionlimit() < depth_budget:
    sys.setrecursionlimit(min(depth_budget, 1_000_000))
  stats["evals"] += 1
  fkey = flags_key(mesh)
  kind = "list" if isinstance(expr, ListExpr) else "one"

  # fast lane: skip the optimizer for a structure seen before.  Only valid
  # when no interior node carries an eval cache (that changes what
  # CollapseCached produces, invisibly to the raw signature).
  raw_key = None
  if not interior_cached:
    raw_key = (expr.signature({}), fkey)
    hit = _fast_cache.get(raw_key)
    if hit is not None:
      runner, recipe = hit
      stats["fast_hits"] += 1
      args = [raw_leaves[i].leaf_value() if k == "raw" else const
              for k, i, const in recipe]
      result = _wrap(kind, runner(*args), tiling)
      expr._cache = result
      return result

  root = opt_mod.optimize(expr)
  leaves = _collect_leaves(root)
  key = (root.signature({}), fkey)
  runner = _region_cache.get(key)
  if runner is None:
    stats["compiles"] += 1
    stripped, stubs = _strip_leaf_values(root, leaves)
    runner = _make_runner(stripped, {s.expr_id: i for i, s in
                                     enumerate(stubs)}, mesh.device)
    _region_cache[key] = runner
    while len(_region_cache) > FLAGS.max_expr_cache:
      _region_cache.popitem(last=False)
    log_debug("built runner for %s (%d leaves)", type(expr).__name__,
              len(leaves))
  else:
    stats["cache_hits"] += 1

  if raw_key is not None:
    # binding recipe: each optimized leaf is one of the raw DAG's leaves
    # (bound fresh by position) or a pass-created constant (ConstFold's
    # scalar — fully determined by the raw signature, safe to freeze)
    raw_pos = {id(l): i for i, l in enumerate(raw_leaves)}
    recipe = []
    for leaf in leaves:
      i = raw_pos.get(id(leaf))
      if i is not None:
        recipe.append(("raw", i, None))
      else:
        recipe.append(("const", -1, leaf.leaf_value()))
    _fast_cache[raw_key] = (runner, recipe)
    while len(_fast_cache) > FLAGS.max_expr_cache:
      _fast_cache.popitem(last=False)

  args = [leaf.leaf_value() for leaf in leaves]
  result = _wrap(kind, runner(*args), tiling)
  expr._cache = result
  return result
