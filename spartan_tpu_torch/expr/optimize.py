"""DAG optimizer (port of ``spartan_tpu/expr/optimize.py``).

* ``CollapsedCachedExprs`` — cut the DAG at already-materialized results;
* ``MapMapFusion`` / ``ReduceMapFusion`` — collapse map chains into one
  ``LocalExpr`` kernel, spliced into the consuming reduction (what the
  fused-reduce kernel translates);
* ``ConstFoldCreations`` — ``ones(shape) + b`` → ``1.0 + b`` (a strong 0-d
  leaf of the creation's dtype) when ``b`` already carries the shape, in
  elementwise kernels only (not past a ``map.structural`` function);
* ``AutoTiling`` — the tiling pass; on the single-device mesh every array
  is one tile, so it changes nothing.  The cost-model ``SmartTiling`` waits
  for multi-device meshes.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

from spartan_tpu_torch.config import FLAGS
from spartan_tpu_torch.core.array import to_numpy_dtype
from spartan_tpu_torch.expr import local as local_mod
from spartan_tpu_torch.expr.base import Expr, Val, ensure_recursion_budget
from spartan_tpu_torch.expr.map import MapExpr, is_structural
from spartan_tpu_torch.expr.ndarray import CreationExpr
from spartan_tpu_torch.expr.reduce import ReduceExpr


def _rebuild(expr: Expr, child_map: Dict[int, Expr]) -> Expr:
  """Copy ``expr`` with rewritten children (no-op when nothing changed)."""
  changed = False
  updates = {}
  for name in expr._members:
    v = getattr(expr, name)
    if isinstance(v, Expr):
      nv = child_map.get(v.expr_id, v)
      changed |= nv is not v
      updates[name] = nv
    elif isinstance(v, (list, tuple)):
      nv = [child_map.get(c.expr_id, c) if isinstance(c, Expr) else c
            for c in v]
      changed |= any(a is not b for a, b in zip(v, nv))
      updates[name] = type(v)(nv) if isinstance(v, tuple) else nv
  if not changed:
    return expr
  return expr.replace(**updates)


def rewrite_bottom_up(root: Expr, fn: Callable[[Expr], Expr],
                      refs: Optional[Dict[int, int]] = None) -> Expr:
  """Apply ``fn`` to every node after its children have been rewritten.
  With ``refs`` (``count_refs`` of ``root``), a node's rebuilt and
  rewritten forms inherit its reference count, so that ``fn`` sees a
  shared node as shared after its children were rewritten."""
  memo: Dict[int, Expr] = {}

  def go(e: Expr) -> Expr:
    hit = memo.get(e.expr_id)
    if hit is not None:
      return hit
    for c in e.children():
      go(c)
    rebuilt = _rebuild(e, {c.expr_id: memo[c.expr_id] for c in e.children()})
    if refs is not None and e.expr_id in refs:
      refs[rebuilt.expr_id] = refs[e.expr_id]
    out = fn(rebuilt)
    if refs is not None and e.expr_id in refs:
      refs[out.expr_id] = refs[e.expr_id]
    memo[e.expr_id] = out
    return out

  out = go(root)
  del go  # go reaches itself through its cell: break the cycle (evaluator)
  return out


def count_refs(root: Expr) -> Dict[int, int]:
  refs: Dict[int, int] = {}

  def count(e: Expr):
    for c in e.children():
      refs[c.expr_id] = refs.get(c.expr_id, 0) + 1

  root.visit(count)
  return refs


class CollapsedCachedExprs:
  """Replace already-evaluated sub-DAGs with leaf values — region cuts."""

  def run(self, root: Expr) -> Expr:
    memo: Dict[int, Expr] = {}

    def go(e: Expr) -> Expr:
      hit = memo.get(e.expr_id)
      if hit is not None:
        return hit
      if e._cache is not None and not isinstance(e, Val):
        out = Val(e._cache)
      else:
        for c in e.children():
          go(c)
        out = _rebuild(e, {c.expr_id: memo[c.expr_id]
                           for c in e.children()})
      memo[e.expr_id] = out
      return out

    out = go(root)
    del go  # break go's cycle through its own cell (see the evaluator)
    return out


class MapMapFusion:
  """Fuse chains of MapExprs into one LocalExpr kernel."""

  def run(self, root: Expr) -> Expr:
    refs = count_refs(root)
    cap = FLAGS.max_fused_kernel_ops

    def fusable(c: Expr, parent: MapExpr) -> bool:
      return (isinstance(c, MapExpr) and refs.get(c.expr_id, 1) == 1
              and c.op.approx_size + parent.op.approx_size <= cap)

    def fuse(e: Expr) -> Expr:
      if not isinstance(e, MapExpr):
        return e
      if not any(fusable(c, e) for c in e.inputs):
        return e
      new_inputs: List[Expr] = []
      slot_of: Dict[int, int] = {}

      def slot(child: Expr) -> int:
        s = slot_of.get(child.expr_id)
        if s is None:
          s = len(new_inputs)
          slot_of[child.expr_id] = s
          new_inputs.append(child)
        return s

      mapping: Dict[int, local_mod.LocalExpr] = {}
      for i, child in enumerate(e.inputs):
        if fusable(child, e):
          inner_map = {j: local_mod.LocalInput(slot(gc))
                       for j, gc in enumerate(child.inputs)}
          mapping[i] = local_mod.substitute_inputs(child.op, inner_map)
        else:
          mapping[i] = local_mod.LocalInput(slot(child))
      fused = local_mod.substitute_inputs(e.op, mapping)
      return MapExpr(inputs=new_inputs, op=fused)

    out = root
    for _ in range(16):  # to fixpoint over chains (a+b+c+d)
      # refs follow the rebuilt nodes: a shared map whose own inputs were
      # fused is still shared, and is computed once, not once a consumer
      new = rewrite_bottom_up(out, fuse, refs)
      if new is out:
        break
      out = new
      refs = count_refs(out)
    return out


class ReduceMapFusion:
  """Splice a feeding MapExpr's kernel into the reduction."""

  def run(self, root: Expr) -> Expr:
    refs = count_refs(root)

    def fuse(e: Expr) -> Expr:
      if (isinstance(e, ReduceExpr) and e.local_op is None
          and len(e.inputs) == 1 and isinstance(e.inputs[0], MapExpr)
          and refs.get(e.inputs[0].expr_id, 1) == 1):
        m = e.inputs[0]
        return e.replace(inputs=list(m.inputs), local_op=m.op)
      return e

    return rewrite_bottom_up(root, fuse)


class ConstFoldCreations:
  """Replace broadcast-neutral fill-creations feeding fused kernels with
  0-d leaves: ``ones(shape) + b`` → ``1.0 + b`` when ``b`` already carries
  the shape.  The leaf keeps the creation's STRONG dtype (a 0-d ndarray,
  not a Python scalar), so promotion is unchanged — and the fused-reduce
  kernel then sees one big operand plus scalars."""

  def run(self, root: Expr) -> Expr:

    def fold(e: Expr) -> Expr:
      if not isinstance(e, (MapExpr, ReduceExpr)):
        return e
      if isinstance(e, ReduceExpr) and e.local_op is None:
        return e
      if is_structural(e.op if isinstance(e, MapExpr) else e.local_op):
        return e  # a ones((n,)) beside a gather index stays an array
      shapes = [c.shape for c in e.inputs]
      new_inputs = list(e.inputs)
      changed = False
      for i, c in enumerate(e.inputs):
        if (isinstance(c, CreationExpr) and c.op == "full"
            and c.tile_hint is None and len(c.out_shape) > 0):
          others = shapes[:i] + shapes[i + 1:]
          try:
            full = np.broadcast_shapes(*shapes)
            rest = np.broadcast_shapes(*others) if others else None
          except ValueError:
            continue
          if rest == full:
            new_inputs[i] = Val(np.asarray(
                c.params["fill"], dtype=to_numpy_dtype(c.out_dtype)))
            changed = True
      if changed:
        return e.replace(inputs=new_inputs)
      return e

    return rewrite_bottom_up(root, fold)


class AutoTiling:
  """Tiling pass: a no-op.  Dense arrays stay whole tensors on the device,
  replicated over the mesh's logical shards."""

  def run(self, root: Expr) -> Expr:
    return root


def optimize(expr: Expr) -> Expr:
  """Run the flag-gated pass pipeline (reference ``optimize``)."""
  ensure_recursion_budget(expr)
  if not FLAGS.optimization:
    # collapsing cached interiors is cache semantics, not an optimization
    if FLAGS.opt_collapse_cached:
      expr = CollapsedCachedExprs().run(expr)
    return expr
  if FLAGS.opt_collapse_cached:
    expr = CollapsedCachedExprs().run(expr)
  if FLAGS.opt_fusion:
    expr = MapMapFusion().run(expr)
  if FLAGS.opt_reduce_fusion:
    expr = ReduceMapFusion().run(expr)
  if FLAGS.opt_const_fold:
    expr = ConstFoldCreations().run(expr)
  if FLAGS.opt_auto_tiling:
    expr = AutoTiling().run(expr)
  return expr
