"""Expr-DAG pretty-printing and Graphviz export (port of
``spartan_tpu/expr/visualize.py``): the whole lazy DAG as indented text
(:func:`pretty`) or dot (:func:`to_dot`, :func:`dump_dot`); a fused
kernel's op tree prints itself with ``MapExpr.op.pretty()``.
"""

from __future__ import annotations

from typing import List, Set

from spartan_tpu_torch.expr.base import Expr, NotShapeable, Val


def _label(e: Expr) -> str:
  name = type(e).__name__
  try:
    sd = f"{tuple(e.shape)}:{e.dtype}"
  except NotShapeable:
    sd = "?"
  extra = ""
  if hasattr(e, "op") and isinstance(getattr(e, "op"), str):
    extra = f" op={e.op}"
  if isinstance(e, Val):
    extra = " leaf"
  return f"{name}[{e.expr_id}] {sd}{extra}"


def pretty(expr: Expr, max_depth: int = 12) -> str:
  """Indented text rendering of the DAG (shared nodes printed once)."""
  lines: List[str] = []
  seen: Set[int] = set()

  def go(e: Expr, depth: int):
    pad = "  " * depth
    if e.expr_id in seen:
      lines.append(f"{pad}({_label(e)} …shared)")
      return
    seen.add(e.expr_id)
    lines.append(pad + _label(e))
    if depth >= max_depth:
      lines.append(pad + "  …")
      return
    for c in e.children():
      go(c, depth + 1)

  go(expr, 0)
  return "\n".join(lines)


def to_dot(expr: Expr) -> str:
  """Graphviz dot text for the DAG."""
  nodes: List[str] = []
  edges: List[str] = []
  seen: Set[int] = set()

  def emit(e: Expr):
    shape = "box" if isinstance(e, Val) else "ellipse"
    nodes.append(f'  n{e.expr_id} [label="{_label(e)}", shape={shape}];')
    for c in e.children():
      edges.append(f"  n{c.expr_id} -> n{e.expr_id};")

  # iterative visit: deep op chains exceed the recursion limit
  expr.visit(emit, memo=seen)
  return "digraph expr {\n" + "\n".join(nodes + edges) + "\n}\n"


def dump_dot(expr: Expr, path: str) -> str:
  with open(path, "w") as f:
    f.write(to_dot(expr))
  return path
