"""Lazy basic slicing and fancy and boolean indexing
(port of ``spartan_tpu/expr/slice.py``).

``SliceExpr`` (ints, slices, ``None``, ``Ellipsis``) and the integer-array
gathers ``FancyIndexExpr`` and ``MultiIndexExpr`` stay inside their
region: the index enters the structural signature as a parameter (basic
parts) or as child leaves (index arrays, bound as data, never baked into a
cached runner).  Torch has no negative slice step, so such a slice is an
``index_select`` of the axis first.  A gather's index array that is data
is normalized and clamped into its axis, as the reference's gather clamps
it; a concrete one (a host array or list) out of bounds raises
``IndexError`` when the expr is built, as NumPy does.

A boolean mask gives a shape that depends on the data: ``BooleanMaskExpr``
raises :class:`NotShapeable`, and the evaluator evaluates it before its
region, on the device with torch's boolean indexing (counted in
``counts["boolean_mask_device"]``).  A boolean part inside a tuple index
takes the reference's host path (``HostExpr``).
"""

from __future__ import annotations

from typing import Any, List

import numpy as np
import torch

from spartan_tpu_torch.core.array import SpartanArray, dtype_kind
from spartan_tpu_torch.expr.base import EmitCtx, Expr, NotShapeable, lazify

counts = {"boolean_mask_device": 0}


def reset_counts() -> None:
  for k in counts:
    counts[k] = 0


def _is_basic(idx) -> bool:
  if (isinstance(idx, (int, np.integer, slice)) or idx is None
      or idx is Ellipsis):
    return True
  if isinstance(idx, tuple):
    return all(_is_basic(i) for i in idx)
  return False


def _is_bool_mask(idx) -> bool:
  if isinstance(idx, Expr):
    try:
      return idx.dtype == torch.bool
    except NotShapeable:
      return False
  arr = np.asarray(idx) if isinstance(idx, (np.ndarray, list)) else None
  return arr is not None and arr.dtype.kind == "b"


def _index_dims_consumed(p) -> int:
  """How many axes of the source one index part consumes: bool scalars
  and None add an axis (consume 0), a k-D boolean mask consumes k,
  everything else consumes 1."""
  if p is None or isinstance(p, (bool, np.bool_)):
    return 0
  if isinstance(p, (np.ndarray, list)):
    arr = np.asarray(p)
    if arr.dtype.kind == "b":
      return arr.ndim
  if isinstance(p, Expr):
    try:
      if p.dtype == torch.bool:
        return p.ndim
    except NotShapeable:
      pass
  return 1


def _source_dims(parts, ndim: int) -> List[int]:
  """The source axis each part of a tuple index reads (-1: none)."""
  n_real = sum(_index_dims_consumed(p) for p in parts if p is not Ellipsis)
  dims, dim = [], 0
  for p in parts:
    if p is Ellipsis:
      dims.append(-1)
      dim += ndim - n_real
      continue
    consumed = _index_dims_consumed(p)
    dims.append(dim if consumed else -1)
    dim += consumed
  return dims


def _negative_steps(x: torch.Tensor, parts):
  """``x`` with each slice of negative step applied as an ``index_select``
  of its axis (torch's slices take positive steps only), and the parts
  with those slices made whole."""
  dims = _source_dims(parts, x.ndim)
  out = list(parts)
  for k, (p, d) in enumerate(zip(parts, dims)):
    if isinstance(p, slice) and p.step is not None and p.step < 0:
      keep = torch.arange(*p.indices(x.shape[d]), device=x.device)
      x = x.index_select(d, keep)
      out[k] = slice(None)
  return x, tuple(out)


def _clamped(idx: torch.Tensor, n: int) -> torch.Tensor:
  """An index array as a gather reads it: int64, negative entries counted
  from the end, then clamped into [0, n) as the reference's gather does."""
  idx = idx.long()
  return torch.where(idx < 0, idx + n, idx).clamp(0, max(n - 1, 0))


class SliceExpr(Expr):
  """Basic (rectangular) slicing: a view inside the region."""

  _members = ("inputs",)
  _params = ("idx",)

  def __init__(self, src, idx):
    super().__init__(inputs=[lazify(src)], idx=idx)

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    parts = self.idx if isinstance(self.idx, tuple) else (self.idx,)
    x, parts = _negative_steps(deps[0], parts)
    return x[parts]


class FancyIndexExpr(Expr):
  """An integer-array gather along axis 0."""

  _members = ("inputs",)
  _params = ()

  def __init__(self, src, indices):
    super().__init__(inputs=[lazify(src), lazify(indices)])

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    src, idx = deps
    if not isinstance(idx, torch.Tensor):
      idx = torch.as_tensor(idx, device=src.device)
    return src[_clamped(idx, src.shape[0])]


class MultiIndexExpr(Expr):
  """Advanced indexing with a tuple that mixes index arrays and basic
  parts (``x[rows, cols]``, ``x[rows, 1:5]``).  The tuple's structure is
  ``template`` (array parts marked by ``_SLOT``); the arrays are child
  exprs."""

  _members = ("inputs",)
  _params = ("template",)

  _SLOT = "__array_slot__"

  def __init__(self, src, parts):
    template, arrays = [], []
    for p in parts:
      if isinstance(p, (Expr, np.ndarray, list)):
        template.append(self._SLOT)
        arrays.append(lazify(p))
      else:
        template.append(p)
    super().__init__(inputs=[lazify(src)] + arrays, template=tuple(template))

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    src, parts = _negative_steps(deps[0], self.template)
    dims = _source_dims(parts, src.ndim)
    arrays = list(deps[1:])
    idx = []
    for t, d in zip(parts, dims):
      if isinstance(t, str) and t == self._SLOT:
        a = arrays.pop(0)
        if not isinstance(a, torch.Tensor):
          a = torch.as_tensor(a, device=src.device)
        idx.append(_clamped(a, src.shape[d]))
      else:
        idx.append(t)
    return src[tuple(idx)]


class BooleanMaskExpr(Expr):
  """Boolean-mask selection: its shape depends on the data, so the
  evaluator evaluates it eagerly, on the device."""

  _members = ("inputs",)
  _params = ()

  def __init__(self, src, mask):
    super().__init__(inputs=[lazify(src), lazify(mask)])

  def aval(self):
    raise NotShapeable("boolean mask selection has a data-dependent shape")

  def _emit(self, ctx, deps):
    raise NotShapeable("boolean mask selection must be evaluated eagerly")

  def evaluate_eager(self) -> SpartanArray:
    src = self.inputs[0].evaluate()
    mask = self.inputs[1].evaluate().data.to(src.device)
    if tuple(mask.shape) != tuple(src.shape[:mask.ndim]):
      raise IndexError(f"boolean index of shape {tuple(mask.shape)} does "
                       f"not match the array's leading dims "
                       f"{tuple(src.shape[:mask.ndim])}")
    counts["boolean_mask_device"] += 1
    return SpartanArray(src.data[mask], src.tiling)


def _tuple_has_array(idx) -> bool:
  return isinstance(idx, tuple) and any(
      isinstance(p, (Expr, np.ndarray, list)) for p in idx)


def _tuple_has_bool(idx) -> bool:
  for p in idx:
    if isinstance(p, Expr):
      try:
        if p.dtype == torch.bool:
          return True
      except NotShapeable:
        return True
    elif isinstance(p, (np.ndarray, list)):
      if np.asarray(p).dtype.kind == "b":
        return True
  return False


def _check_static_index_bounds(src, idx) -> None:
  """NumPy's rule: a concrete integer index (a Python int, a host array
  or list) out of range raises ``IndexError`` when the expr is built.  An
  index that is an expr is data and is clamped when the region runs.  One
  walker for basic and advanced tuples."""
  try:
    shape = lazify(src).shape
  except NotShapeable:
    return
  parts = idx if isinstance(idx, tuple) else (idx,)
  for p, dim in zip(parts, _source_dims(parts, len(shape))):
    if dim < 0 or dim >= len(shape) or _index_dims_consumed(p) != 1:
      continue
    d = shape[dim]
    if isinstance(p, (int, np.integer)) and not isinstance(p, (bool,
                                                               np.bool_)):
      if not -d <= int(p) < d:
        raise IndexError(f"index {int(p)} is out of bounds for axis {dim} "
                         f"with size {d}")
    elif isinstance(p, (np.ndarray, list)):
      arr = np.asarray(p)
      if arr.dtype.kind in "iu" and arr.size:
        lo, hi = int(arr.min()), int(arr.max())
        if lo < -d or hi >= d:
          bad = lo if lo < -d else hi
          raise IndexError(f"index {bad} is out of bounds for axis {dim} "
                           f"with size {d}")


def _host_index(template, s, *arrays):
  arrays = list(arrays)
  return s[tuple(arrays.pop(0) if isinstance(t, str) and t == "__array_slot__"
                 else t for t in template)]


def make_slice(src, idx) -> Expr:
  """``src[idx]`` as the right node (``Expr.__getitem__``)."""
  import functools
  if _is_bool_mask(idx):
    return BooleanMaskExpr(src, idx)
  _check_static_index_bounds(src, idx)
  if _is_basic(idx):
    if isinstance(idx, tuple):
      idx = tuple(int(p) if isinstance(p, np.integer) else p for p in idx)
    elif isinstance(idx, np.integer):
      idx = int(idx)
    return SliceExpr(src, idx)
  if _tuple_has_array(idx):
    if _tuple_has_bool(idx):
      # a boolean part inside a tuple: the reference's host path
      from spartan_tpu_torch.expr.fio import HostExpr
      parts = [p for p in idx if isinstance(p, (Expr, np.ndarray, list))]
      template = tuple("__array_slot__" if isinstance(
          p, (Expr, np.ndarray, list)) else p for p in idx)
      return HostExpr([src] + parts, functools.partial(_host_index, template))
    return MultiIndexExpr(src, idx)
  if isinstance(idx, (np.ndarray, list)):
    arr = np.asarray(idx)
    if arr.dtype.kind not in "iu":
      raise IndexError(f"arrays used as indices must be of integer (or "
                       f"boolean) type, not {arr.dtype}")
  elif isinstance(idx, Expr) and dtype_kind(idx.dtype) not in "iu":
    raise IndexError(f"arrays used as indices must be of integer (or "
                     f"boolean) type, not {idx.dtype}")
  return FancyIndexExpr(src, idx)
