"""Scatter with a combiner (port of ``spartan_tpu/expr/shuffle.py``).

``fn(*inputs, coords) -> (indices, values)`` runs on the inputs' tensors
and on ``coords``, one int64 ``torch.arange`` grid per axis of the first
input, broadcast to its shape.  The values are scattered into a zeroed,
filled (``init``) or given (``target``, left untouched) array with the
reducer, on flattened indices.  Indices follow NumPy's advanced indexing:
index arrays broadcast together, fewer arrays than the target's axes index
its leading axes, negative entries count from the end.

The float ``add`` and ``mul`` are deterministic on the CPU and the card:
the updates are sorted stably by target position and each position's run
is reduced by ``torch.segment_reduce`` in a fixed order, then combined
with the target once (``index_put_(accumulate=True)`` and
``scatter_reduce_`` sum in an order that changes from run to run on both
devices).  Integer ``add``/``mul`` are exact in any order and go through
``index_put_``/``scatter_reduce_``; ``max``/``min`` through
``scatter_reduce_``, which no order changes; ``set`` through
``index_put_``, where the last of several updates to one position is not
specified, as in the reference.
"""

from __future__ import annotations

from typing import Any, Callable, List, Sequence

import numpy as np
import torch

from spartan_tpu_torch.core.array import canonical_reducer, to_torch_dtype
from spartan_tpu_torch.expr.base import EmitCtx, Expr, lazify

_SCATTER_REDUCE = {"mul": "prod", "max": "amax", "min": "amin"}
_SEGMENT_REDUCE = {"add": "sum", "mul": "prod"}


def _coords(x: torch.Tensor):
  return tuple(
      torch.arange(s, device=x.device).view(
          [s if a == d else 1 for a in range(x.ndim)]).expand(x.shape)
      for d, s in enumerate(x.shape))


def _flat_index(base: torch.Tensor, indices, values: torch.Tensor):
  """(flat int64 index, values) with one entry per scattered element:
  the index arrays broadcast, trailing axes of ``base`` spanned, negative
  indices wrapped, values broadcast to match."""
  idx = torch.broadcast_tensors(*[torch.as_tensor(i, device=base.device)
                                  for i in indices])
  lead = idx[0].shape
  trailing = base.shape[len(idx):]
  shape = tuple(lead) + tuple(trailing)
  flat = torch.zeros(shape, dtype=torch.int64, device=base.device)
  stride = 1
  for axis in reversed(range(base.ndim)):
    size = base.shape[axis]
    if axis < len(idx):
      i = idx[axis].long()
      i = torch.where(i < 0, i + size, i).reshape(
          tuple(lead) + (1,) * len(trailing))
    else:
      t = axis - len(idx)
      i = torch.arange(size, device=base.device).reshape(
          (1,) * (len(lead) + t) + (size,) + (1,) * (len(trailing) - t - 1))
    flat = flat + i * stride
    stride *= size
  return flat.reshape(-1), values.expand(shape).reshape(-1)


class ShuffleExpr(Expr):
  """``fn(*inputs, coords) -> (indices, values)`` scattered into a zeroed,
  filled, or provided target array with a combiner."""

  _members = ("inputs",)
  _params = ("fn", "target_shape", "reducer", "fn_kw", "out_dtype", "init",
             "has_target")

  def __init__(self, inputs, fn: Callable, target_shape: Sequence[int],
               reducer=None, fn_kw=None, out_dtype=None, init=None,
               target=None, has_target: bool = False):
    if isinstance(inputs, Expr) or not isinstance(inputs, (list, tuple)):
      inputs = [inputs]
    inputs = [lazify(v) for v in inputs]
    if target is not None:
      # reference parity: updates merge INTO an existing array
      inputs = inputs + [lazify(target)]
      has_target = True
      target_shape = tuple(int(s) for s in inputs[-1].shape)
    super().__init__(inputs=inputs, fn=fn,
                     target_shape=tuple(int(s) for s in target_shape),
                     reducer=canonical_reducer(reducer),
                     fn_kw=dict(fn_kw or {}),
                     out_dtype=(to_torch_dtype(out_dtype)
                                if out_dtype is not None else None),
                     init=init, has_target=has_target)

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    if self.has_target:
      data_deps, target = deps[:-1], deps[-1]
    else:
      data_deps, target = deps, None
    indices, values = self.fn(*data_deps, _coords(data_deps[0]),
                              **self.fn_kw)
    if not isinstance(indices, tuple):
      indices = (indices,)
    first = data_deps[0]
    values = torch.as_tensor(values, device=(
        first.device if isinstance(first, torch.Tensor) else ctx.device))
    if target is not None:
      dt = target.dtype
    else:
      dt = self.out_dtype or values.dtype
    if ctx.abstract:
      return torch.empty(self.target_shape, dtype=dt, device="meta")
    if target is not None:
      base = target.clone(memory_format=torch.contiguous_format)
    elif self.init is not None:
      base = torch.full(self.target_shape, self.init, dtype=dt,
                        device=values.device)
    else:
      base = torch.zeros(self.target_shape, dtype=dt, device=values.device)
    flat, vals = _flat_index(base, indices, values.to(dt))
    op, out = self.reducer, base.view(-1)
    if op in _SEGMENT_REDUCE and dt.is_floating_point:
      key, order = torch.sort(flat, stable=True)
      lengths = torch.bincount(key, minlength=out.shape[0])
      runs = torch.segment_reduce(vals[order], _SEGMENT_REDUCE[op],
                                  lengths=lengths, unsafe=True)
      if op == "add":
        out.add_(runs)
      else:
        out.mul_(runs)
    elif op in ("set", "add"):
      out.index_put_((flat,), vals, accumulate=(op == "add"))
    else:
      out.scatter_reduce_(0, flat, vals, _SCATTER_REDUCE[op],
                          include_self=True)
    return base


def shuffle(v, fn: Callable, target_shape: Sequence[int] = None,
            reducer=np.add, fn_kw=None, out_dtype=None, init=None,
            target=None) -> ShuffleExpr:
  """Scatter-reduce ``fn``'s emitted ``(indices, values)`` into a fresh
  target of ``target_shape`` — or merge into an existing ``target`` array
  (the reference's update-a-DistArray form) — using ``reducer``."""
  if target is None and target_shape is None:
    raise ValueError("shuffle needs target_shape or target")
  return ShuffleExpr(v, fn, target_shape or (), reducer=reducer,
                     fn_kw=fn_kw, out_dtype=out_dtype, init=init,
                     target=target)
