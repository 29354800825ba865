"""Lazy array creation (port of ``spartan_tpu/expr/ndarray.py``).

Creation emits ``torch.full`` / ``arange`` / ``rand`` / ``randn`` inside the
region, on the region's device.  Random creation draws from an explicit
``torch.Generator(device).manual_seed(seed)`` per node; its stream differs
from the reference's ``jax.random`` one, so parity tests feed both packages
the same data through ``from_numpy`` instead.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch

from spartan_tpu_torch.core.array import dtype_kind, to_torch_dtype
from spartan_tpu_torch.expr.base import EmitCtx, Expr

_seed_counter = [0]


def _next_seed() -> int:
  _seed_counter[0] += 1
  return _seed_counter[0]


def set_random_seed(seed: int) -> None:
  """Reset the stream used to derive per-expr generator seeds."""
  _seed_counter[0] = int(seed) * 1_000_003


class CreationExpr(Expr):
  """Materialize-free array construction (zeros/ones/full/arange/rand…)."""

  _members = ()
  _params = ("op", "out_shape", "out_dtype", "params", "tile_hint")

  def __init__(self, op: str, out_shape: Sequence[int], out_dtype,
               params: Optional[Dict[str, Any]] = None,
               tile_hint: Optional[Sequence[int]] = None):
    if op not in ("full", "arange", "rand", "randn"):
      raise ValueError(f"unknown creation op {op!r}")
    out_shape = tuple(int(s) for s in out_shape)
    super().__init__(op=op, out_shape=out_shape,
                     out_dtype=to_torch_dtype(out_dtype),
                     params=dict(params or {}), tile_hint=tile_hint)

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    op, shape, dt, p = self.op, self.out_shape, self.out_dtype, self.params
    if ctx.abstract:
      return torch.empty(shape, dtype=dt, device="meta")
    dev = ctx.device
    if op == "full":
      return torch.full(shape, p["fill"], dtype=dt, device=dev)
    if op == "arange":
      n = shape[0]
      if all(isinstance(p[k], int) for k in ("start", "stop", "step")):
        vals = torch.arange(p["start"], p["stop"], p["step"],
                            dtype=torch.int64, device=dev)
      else:
        # numpy's values: start + i*step, computed in float64
        vals = p["start"] + p["step"] * torch.arange(
            n, dtype=torch.float64, device=dev)
      return vals.to(dt).reshape(shape)
    gen = torch.Generator(device=dev).manual_seed(p["seed"])
    if dtype_kind(dt) != "f":
      raise TypeError(f"{op} creates floating arrays, not {dt}")
    if op == "rand":
      return torch.rand(shape, generator=gen, dtype=dt, device=dev)
    return torch.randn(shape, generator=gen, dtype=dt, device=dev)
