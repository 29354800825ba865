"""Sort, argsort and percentiles (port of ``spartan_tpu/expr/sort_expr.py``).

The reference has two lowerings, picked by ``--sort_method``: ``gather``,
one sort of the whole array, and ``sample``, a sample sort that exchanges
buckets between the devices of a mesh.  The port's mesh is p logical
shards of one device, so it has the gather lowering only: one
``torch.sort(..., stable=True)``, a stable radix sort on the card.  Ties
keep their input order, as ``jnp.argsort`` and NumPy's stable sort keep
them; ``-0.0`` and ``+0.0`` tie; NaNs go last, all of them made the one
quiet NaN first (the card's sort would put a NaN with its sign bit set
first).  Complex values sort as
NumPy sorts them, by the real part and then the imaginary part, through
two stable argsorts (``torch.sort`` takes no complex dtype).

Percentiles are NumPy's ``linear`` method: a sort, a gather of the floor
and ceil ranks, and NumPy's ``_lerp`` in float64.  torch's quantile (which refuses more
than 2^24 elements) and its median (the lower of the two middle values)
are not used.
"""

from __future__ import annotations

import math
from typing import Any, List, Optional

import numpy as np
import torch

from spartan_tpu_torch.config import FLAGS
from spartan_tpu_torch.core.array import dtype_kind
from spartan_tpu_torch.expr.base import EmitCtx, Expr, NotShapeable, lazify

_METHODS = ("auto", "gather", "sample")


def _sample_routable() -> bool:
  """The reference's routing predicate: does a sort take the sample sort?
  On the port it is False: the sample sort exchanges buckets between
  devices, and the port's mesh is p logical shards of one device.
  ``--sort_method=sample`` asks for that route, which is not ported
  (ROADMAP Queue 1 item 5, ``parallel/sample_sort.py``), so every sort of
  the port raises under it rather than gathering."""
  if FLAGS.sort_method not in _METHODS:
    raise ValueError(f"sort_method must be one of {_METHODS}, not "
                     f"{FLAGS.sort_method!r}")
  if FLAGS.sort_method == "sample":
    raise NotImplementedError(
        "sort_method='sample' (the distributed sample sort, "
        "parallel/sample_sort.py) is not ported: ROADMAP Queue 1 item 5; "
        "use 'auto' or 'gather'")
  return False


def _keys(x: torch.Tensor) -> torch.Tensor:
  """``x`` with every NaN the one quiet NaN: the card's radix sort orders
  NaNs by their bits (a NaN with the sign bit set before -inf), NumPy
  puts them all last, as ties."""
  if not x.is_floating_point():
    return x
  return torch.where(torch.isnan(x), float("nan"), x)


def argsort(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
  """NumPy's stable argsort along ``dim``; complex by the real part, then
  the imaginary part."""
  _sample_routable()  # False; raises for 'sample'
  if not x.is_complex():
    return torch.sort(_keys(x), dim=dim, stable=True).indices
  order = argsort(x.imag, dim)
  by_real = argsort(torch.take_along_dim(x.real, order, dim), dim)
  return torch.take_along_dim(order, by_real, dim)


def sort(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
  """NumPy's sort along ``dim`` (a NaN comes out as the quiet NaN)."""
  _sample_routable()  # False; raises for 'sample'
  if not x.is_complex():
    return torch.sort(_keys(x), dim=dim, stable=True).values
  return torch.take_along_dim(x, argsort(x, dim), dim)


class SortExpr(Expr):
  _members = ("inputs",)
  _params = ("axis", "kind")

  def __init__(self, src, axis: Optional[int] = -1, kind: str = "sort"):
    if kind not in ("sort", "argsort"):
      raise ValueError(kind)
    src = lazify(src)
    try:
      ndim = src.ndim
    except NotShapeable:  # its shape waits for its data
      ndim = None
    if axis is not None and ndim is not None and not -ndim <= axis < ndim:
      raise np.exceptions.AxisError(axis, ndim)
    super().__init__(inputs=[src], axis=axis, kind=kind)

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    x = deps[0]
    axis = self.axis
    if axis is None:
      x, axis = x.reshape(-1), 0
    return (sort if self.kind == "sort" else argsort)(x, axis)


def _to_last(x: torch.Tensor, axis) -> torch.Tensor:
  """``x`` with the axes of ``axis`` (an int, a tuple, or None for all)
  moved to the end and merged into one."""
  if axis is None:
    return x.reshape(-1)
  axes = [a % x.ndim for a in (axis if isinstance(axis, (tuple, list))
                               else (axis,))]
  keep = [d for d in range(x.ndim) if d not in axes]
  x = x.permute(keep + axes)
  return x.reshape(x.shape[:len(keep)] + (math.prod(x.shape[len(keep):]),))


def quantiles(x: torch.Tensor, q, axis=None, ignore_nan: bool = False
              ) -> torch.Tensor:
  """NumPy's ``quantile(x, q, axis)`` by its ``linear`` method (q in
  [0, 1], a float or a tuple of floats), or ``nanquantile``'s with
  ``ignore_nan``: the shape ``q``'s + the kept axes'; float64 for
  integers and bool, else ``x``'s dtype; NaN for a slice holding a NaN
  (for ``ignore_nan``: a slice of NaN only)."""
  kind = dtype_kind(x.dtype)
  if kind == "c":
    raise TypeError("a must be an array of real numbers")
  out_dtype = x.dtype if kind == "f" else torch.float64
  s = sort(_to_last(x, axis))
  m = s.shape[-1]
  qt = torch.tensor(q, dtype=torch.float64)
  # q from pinned memory: a pageable copy would hold the host until the
  # card's stream reached it
  qt = (qt.pin_memory().to(x.device, non_blocking=True)
        if x.device.type == "cuda" else qt.to(x.device))
  rest = s.shape[:-1]
  if m == 0:
    return torch.full(qt.shape + rest, float("nan"), dtype=out_dtype,
                      device=x.device)
  nan_aware = ignore_nan and kind == "f"
  # n (the slice's count, each slice's own without NaN) a column beside
  # the quantiles along the last axis: positions as rest + q.shape
  n = ((~torch.isnan(s)).sum(-1, keepdim=True) if nan_aware else m)
  qv = qt.reshape(-1)
  last = (n - 1).to(torch.float64) if nan_aware else float(m - 1)
  pos = last * qv  # NumPy's virtual index
  # NumPy's neighbours: past the last rank both the last, below 0 both
  # the first (there the weight does not matter: the two values agree)
  prev = torch.floor(pos)
  gamma = (pos - prev).expand(rest + qv.shape)
  top, low = pos >= last, pos < 0
  prev = torch.where(low, 0.0, torch.where(top, last, prev))
  nxt = torch.where(top | low, prev, prev + 1)
  a, b = (torch.gather(s, -1, t.to(torch.int64).clamp(0, m - 1).expand(
      rest + qv.shape)).to(torch.float64) for t in (prev, nxt))
  diff = b - a
  out = torch.where(gamma >= 0.5, b - diff * (1 - gamma), a + diff * gamma)
  if nan_aware:
    out = torch.where(n == 0, float("nan"), out)
  elif kind == "f":
    out = torch.where(torch.isnan(s[..., -1:]), float("nan"), out)
  out = out.to(out_dtype)
  return out.movedim(-1, 0).reshape(qt.shape + rest)


class PercentileExpr(Expr):
  """``quantiles(x, q, axis, ignore_nan)``: ``q`` holds fractions in
  [0, 1], as NumPy's quantile takes them (``percentile`` divides by 100
  once, as NumPy's does)."""
  _members = ("inputs",)
  _params = ("q", "axis", "ignore_nan")

  def __init__(self, src, q, axis: Optional[int] = None,
               ignore_nan: bool = False):
    # q a hashable static param (a float or a tuple of floats)
    q = tuple(float(v) for v in q) if np.ndim(q) >= 1 else float(q)
    super().__init__(inputs=[lazify(src)], q=q, axis=axis,
                     ignore_nan=bool(ignore_nan))

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    return quantiles(deps[0], self.q, self.axis, self.ignore_nan)
