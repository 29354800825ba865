"""Functional region writes and scatters (port of
``spartan_tpu/expr/write.py``).

``WriteArrayExpr`` merges ``src`` into ``dst[region]`` with a reducer
(``set``, ``add``, ``mul``, ``max``, ``min``; ``core.array.
canonical_reducer``); ``ScatterAssignExpr`` scatters ``values`` at an
integer index array along axis 0.  Both work on a clone of ``dst`` and
return it: the expr ``dst`` never changes.  A write whose region has a
negative step is an ``index_put_`` over the selected positions.

The scatter follows the reference's ``dst.at[idx].<op>(values)``: its
index array is data, a negative entry counts from the end, and an entry
out of bounds after that drops its update.  Duplicate indices merge with
the reducer: ``add`` and ``mul`` through ``index_put_(accumulate=True)``
and ``scatter_reduce_`` (on the card ``add`` uses atomics, so the order of
a float sum, and its last bits, vary from run to run), ``max`` and ``min``
through ``scatter_reduce_`` with NaN propagated as ``np.maximum.at`` does,
``set`` by one of the duplicates.
"""

from __future__ import annotations

from typing import Any, List

import torch

from spartan_tpu_torch.core.array import canonical_reducer
from spartan_tpu_torch.core.extent import TileExtent
from spartan_tpu_torch.expr.base import EmitCtx, Expr, lazify

_SCATTER_OPS = {"mul": "prod", "max": "amax", "min": "amin"}


def _region_positions(dst: torch.Tensor, region):
  """``dst[region]``'s basic index with each negative-step slice as the
  int64 positions it selects, for ``index_put_`` (torch's slices take
  positive steps only); None when the region has no negative step."""
  parts = region if isinstance(region, tuple) else (region,)
  if not any(isinstance(p, slice) and p.step is not None and p.step < 0
             for p in parts):
    return None
  from spartan_tpu_torch.expr.slice import _source_dims
  dims = _source_dims(parts, dst.ndim)
  grids = []
  for p, d in zip(parts, dims):
    if p is Ellipsis:
      raise NotImplementedError("a negative-step write region with an "
                                "Ellipsis")
    if isinstance(p, slice):
      grids.append(torch.arange(*p.indices(dst.shape[d]), device=dst.device))
    elif p is None:
      raise NotImplementedError("a negative-step write region with None")
    else:
      grids.append(torch.tensor([int(p) % dst.shape[d]], device=dst.device))
  for d in range(len(grids), dst.ndim):
    grids.append(torch.arange(dst.shape[d], device=dst.device))
  return torch.meshgrid(*grids, indexing="ij")


def _merge(old: torch.Tensor, src: torch.Tensor, reducer: str):
  if reducer == "set":
    return src
  if reducer == "add":
    return old + src
  if reducer == "mul":
    return old * src
  if reducer == "max":
    return torch.maximum(old, src)
  return torch.minimum(old, src)


class WriteArrayExpr(Expr):
  """``dst`` with ``src`` merged into ``region`` by ``reducer``."""

  _members = ("inputs",)
  _params = ("region", "reducer")

  def __init__(self, dst, region, src, reducer=None):
    if isinstance(region, TileExtent):
      region = region.to_slice()
    super().__init__(inputs=[lazify(dst), lazify(src)], region=region,
                     reducer=canonical_reducer(reducer))

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    dst, src = deps
    if ctx.abstract:
      return torch.empty_like(dst)
    out = dst.clone()
    src = torch.as_tensor(src, device=dst.device).to(dst.dtype)
    positions = _region_positions(dst, self.region)
    index = self.region if positions is None else positions
    old = out[index]
    out[index] = _merge(old, src, self.reducer).broadcast_to(old.shape)
    return out


def write(dst, region, src, reducer=None) -> WriteArrayExpr:
  """``dst`` with ``src`` merged into ``dst[region]`` by ``reducer``
  (None: assignment), as a new lazy expr."""
  return WriteArrayExpr(dst, region, src, reducer)


def assign(dst, idx, src) -> WriteArrayExpr:
  """``dst[idx] = src`` as a new lazy expr."""
  return WriteArrayExpr(dst, idx, src, None)


class ScatterAssignExpr(Expr):
  """``dst`` with ``values`` scattered at integer ``indices`` of axis 0."""

  _members = ("inputs",)
  _params = ("reducer",)

  def __init__(self, dst, indices, values, reducer=None):
    super().__init__(inputs=[lazify(dst), lazify(indices), lazify(values)],
                     reducer=canonical_reducer(reducer))

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    dst, idx, vals = deps
    if ctx.abstract:
      return torch.empty_like(dst)
    n, item = dst.shape[0], tuple(dst.shape[1:])
    idx = torch.as_tensor(idx, device=dst.device).long()
    idx = torch.where(idx < 0, idx + n, idx)
    # an update out of bounds goes to a spare row n, dropped at the end
    # (no data-dependent shape, so no wait on the device)
    idx = torch.where((idx >= 0) & (idx < n), idx, n).reshape(-1)
    vals = torch.as_tensor(vals, device=dst.device).to(dst.dtype)
    vals = vals.broadcast_to(tuple(deps[1].shape if isinstance(
        deps[1], torch.Tensor) else ()) + item).reshape((-1,) + item)
    out = torch.empty((n + 1,) + item, dtype=dst.dtype, device=dst.device)
    out[:n] = dst
    if self.reducer == "set":
      out.index_put_((idx,), vals)
    elif self.reducer == "add":
      out.index_put_((idx,), vals, accumulate=True)
    else:
      index = idx.reshape((-1,) + (1,) * len(item)).expand(vals.shape)
      out.scatter_reduce_(0, index, vals, _SCATTER_OPS[self.reducer])
      if self.reducer in ("max", "min") and out.is_floating_point():
        # scatter_reduce's amax/amin may drop a NaN; np.maximum.at keeps
        # it, and a NaN already in dst
        nan = torch.zeros(out.shape, dtype=torch.uint8, device=out.device)
        nan.scatter_reduce_(0, index, torch.isnan(vals).to(torch.uint8),
                            "amax")
        nan[:n] |= torch.isnan(dst).to(torch.uint8)
        out = torch.where(nan.bool(), torch.full_like(out, float("nan")), out)
    return out[:n]
