"""Rematerialization boundary (port of ``spartan_tpu/expr/remat.py``).

``remat(expr)`` evaluates like ``expr``; under reverse-mode autodiff
(:mod:`spartan_tpu_torch.autodiff`) its interior is recomputed in the
backward pass instead of kept from the forward one — activation
checkpointing at the granularity of a sub-DAG.  The differentiable emit
wraps the sub-DAG's emission in ``torch.utils.checkpoint.checkpoint``
(``use_reentrant=False``), where the reference uses ``jax.checkpoint``;
every other emit, the abstract one included, runs the sub-DAG as it is.
"""

from __future__ import annotations

from typing import Any, List

import torch.utils.checkpoint

from spartan_tpu_torch.expr.base import EmitCtx, Expr, Val, lazify


class RematExpr(Expr):
  """Evaluates identically to ``child``; under autograd its interior is
  recomputed rather than saved.  Its children are the child subtree's
  leaves; the subtree itself is a param (a node shared across the boundary
  is recomputed inside, which is the point of remat)."""

  _members = ("inputs",)
  _params = ("child",)
  # the sub-DAG lives in a param and binds self.inputs by identity: the
  # evaluator's leaf stripping leaves this node and its leaves untouched
  _holds_subdag = True

  def __init__(self, child):
    child = lazify(child)
    # iterative pre-order leaf collection (a deep sub-DAG would pass the
    # recursion limit here)
    leaves: List[Val] = []
    seen = set()
    stack = [child]
    while stack:
      e = stack.pop()
      if e.expr_id in seen:
        continue
      seen.add(e.expr_id)
      if isinstance(e, Val):
        leaves.append(e)
        continue
      stack.extend(reversed(e.children()))
    super().__init__(inputs=leaves, child=child)

  def _weak_operands(self) -> bool:
    return True  # the leaves of the DAG it replays, as they are

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    leaf_pos = {leaf.expr_id: i for i, leaf in enumerate(self.inputs)}
    child = self.child

    def run(*leaf_vals):
      env = {}

      def emit(e: Expr):
        if e.expr_id in env:
          return env[e.expr_id]
        if isinstance(e, Val):
          v = leaf_vals[leaf_pos[e.expr_id]]
        else:
          v = e.emit(ctx, [emit(c) for c in e.children()])
        env[e.expr_id] = v
        return v

      try:
        return emit(child)
      finally:
        # break emit's cycle through its own cell, also when the
        # checkpoint's recompute stops early by raising inside it: the
        # cycle would keep env's activations until a garbage collection
        del emit

    if ctx.differentiable and not ctx.abstract:
      return torch.utils.checkpoint.checkpoint(run, *deps,
                                               use_reentrant=False)
    return run(*deps)

  def _sig_local(self, memo, result):
    return ("RematExpr", self.child.signature(dict(memo)),
            tuple(self._child_sig(c, memo, result) for c in self.inputs))


def remat(v) -> RematExpr:
  return RematExpr(v)
