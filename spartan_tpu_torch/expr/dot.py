"""Dense matmul / outer product / tensordot (port of
``spartan_tpu/expr/dot.py``).

The contraction is one ``torch.matmul``, as the reference left it to XLA's
matmul.  torch has no ``preferred_element_type``, so the accumulator type
of ``_acc_type`` is reached by casting the operands first: under
``float64_reductions`` float32 operands are contracted in float64.  TF32 is
off (``initialize`` sets it), so every ``dot_precision`` runs full float32
on the card, where the reference's 'default' meant bf16 passes on the TPU.

torch has no integer matmul on CUDA and no bool matmul anywhere.  Integer
contractions on the card and bool contractions on any device take an
exact route chosen before the contraction (:func:`_exact_route`, counted
in ``counts["exact_int_route"]``): int64 products summed over K in chunks,
wrapping as NumPy's int64 does, then cast to NumPy's result type (a sum
that is nonzero for bool).  Integer contractions on the CPU stay on
``torch.matmul``, which is exact there.
"""

from __future__ import annotations

from typing import Any, List

import torch

from spartan_tpu_torch.config import FLAGS
from spartan_tpu_torch.core.array import dtype_kind
from spartan_tpu_torch.expr.base import EmitCtx, Expr, lazify

_PRECISIONS = (None, "default", "high", "highest")
# int64 elements of one chunk of broadcast products on the exact route
_EXACT_CHUNK = 1 << 24

counts = {"exact_int_route": 0}


def reset_counts() -> None:
  for k in counts:
    counts[k] = 0


def _exact_route(acc: torch.dtype, device: torch.device) -> bool:
  """Does a contraction in ``acc`` on ``device`` take the exact integer
  route?  Counted when it does."""
  take = (not acc.is_floating_point and not acc.is_complex
          and (device.type == "cuda" or acc == torch.bool))
  if take:
    counts["exact_int_route"] += 1
  return take


def _exact_matmul(a: torch.Tensor, b: torch.Tensor,
                  out: torch.dtype) -> torch.Tensor:
  """``torch.matmul(a, b)`` for integer or bool operands, exactly: int64
  broadcast products summed over K, ``_EXACT_CHUNK`` products at a time,
  cast to ``out`` (nonzero for bool)."""
  a, b = a.to(torch.int64), b.to(torch.int64)
  vec_a, vec_b = a.ndim == 1, b.ndim == 1
  if vec_a:
    a = a[None]
  if vec_b:
    b = b[:, None]
  batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
  n, k, m = a.shape[-2], a.shape[-1], b.shape[-1]
  y = torch.zeros((*batch, n, m), dtype=torch.int64, device=a.device)
  per = max(1, _EXACT_CHUNK // max(1, y.numel()))
  for lo in range(0, k, per):
    hi = min(k, lo + per)
    y += (a[..., :, lo:hi, None] * b[..., None, lo:hi, :]).sum(-2)
  if vec_a:
    y = y.squeeze(-2)
  if vec_b:
    y = y.squeeze(-1)
  return y != 0 if out == torch.bool else y.to(out)


def _exact_tensordot(a: torch.Tensor, b: torch.Tensor, dims,
                     out: torch.dtype) -> torch.Tensor:
  """``torch.tensordot(a, b, dims)`` through :func:`_exact_matmul`."""
  if isinstance(dims, int):
    da, db = list(range(a.ndim - dims, a.ndim)), list(range(dims))
  else:
    da, db = ([d] if isinstance(d, int) else list(d) for d in dims)
  da = [d % a.ndim for d in da]
  db = [d % b.ndim for d in db]
  free_a = [d for d in range(a.ndim) if d not in da]
  free_b = [d for d in range(b.ndim) if d not in db]
  k = 1
  for d in da:
    k *= a.shape[d]
  a2 = a.permute(free_a + da).reshape(-1, k)
  b2 = b.permute(db + free_b).reshape(k, -1)
  y = _exact_matmul(a2, b2, out)
  return y.reshape([a.shape[d] for d in free_a] + [b.shape[d] for d in free_b])


def _acc_type(a_dtype: torch.dtype, b_dtype: torch.dtype) -> torch.dtype:
  from spartan_tpu_torch.expr.map import result_type
  out = result_type(a_dtype, b_dtype)
  if dtype_kind(out) == "f":
    if FLAGS.float64_reductions:
      return torch.promote_types(out, torch.float64)
    return torch.promote_types(out, torch.float32)
  return out


def _as_tensor(v, dtype: torch.dtype, device) -> torch.Tensor:
  if isinstance(v, torch.Tensor):
    return v.to(dtype)
  return torch.as_tensor(v, dtype=dtype, device=device)


class DotExpr(Expr):
  """Matrix/vector contraction of the trailing/leading dims."""

  _members = ("inputs",)
  _params = ("precision",)

  def __init__(self, a, b, precision=None):
    if precision not in _PRECISIONS:
      raise ValueError(f"precision must be one of {_PRECISIONS}")
    super().__init__(inputs=[lazify(a), lazify(b)], precision=precision)

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    a, b = deps
    acc = _acc_type(_dtype(a), _dtype(b))
    a, b = _as_tensor(a, acc, ctx.device), _as_tensor(b, acc, ctx.device)
    if a.ndim >= 1 and b.ndim >= 1:
      if not ctx.abstract and _exact_route(acc, a.device):
        return _exact_matmul(a, b, acc)
      return torch.matmul(a, b)
    return a * b


class OuterExpr(Expr):
  """Outer product of two 1-D arrays."""

  _members = ("inputs",)
  _params = ()

  def __init__(self, a, b):
    super().__init__(inputs=[lazify(a), lazify(b)])

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    from spartan_tpu_torch.expr.map import result_type
    a, b = deps
    dt = result_type(_dtype(a), _dtype(b))
    return torch.outer(_as_tensor(a, dt, ctx.device).reshape(-1),
                       _as_tensor(b, dt, ctx.device).reshape(-1))


class TensorDotExpr(Expr):
  """General tensordot (axes-based contraction)."""

  _members = ("inputs",)
  _params = ("axes",)

  def __init__(self, a, b, axes):
    super().__init__(inputs=[lazify(a), lazify(b)], axes=axes)

  def _emit(self, ctx: EmitCtx, deps: List[Any]):
    a, b = deps
    acc = _acc_type(_dtype(a), _dtype(b))
    a, b = _as_tensor(a, acc, ctx.device), _as_tensor(b, acc, ctx.device)
    if not ctx.abstract and _exact_route(acc, a.device):
      return _exact_tensordot(a, b, self.axes, acc)
    return torch.tensordot(a, b, dims=self.axes)


def _dtype(v) -> torch.dtype:
  if isinstance(v, torch.Tensor):
    return v.dtype
  from spartan_tpu_torch.expr.base import Aval
  return Aval.of(v).dtype


def _resolve_precision(precision):
  """Per-call precision, else the --dot_precision flag; None for
  'default'.  Sparse routing reads it: 'high'/'highest' keep SpMV off the
  kernel routes, as in the reference."""
  p = precision if precision is not None else FLAGS.dot_precision
  return None if p in (None, "default") else p


def _foreign_sparse(v) -> bool:
  """A scipy.sparse matrix or a torch sparse tensor: neither is a sparse
  operand of the port (``sparse.from_scipy`` makes one)."""
  if isinstance(v, torch.Tensor):
    return v.layout != torch.strided
  return type(v).__module__.startswith("scipy.sparse")


def dot(a, b, precision=None) -> Expr:
  """Contraction; ``precision`` is accepted for API parity (all values run
  full float32 on the port).

  Sparse operands dispatch to the sparse module: ``dot(S, v)`` is an
  SpMV expr, ``dot(v, S)`` is ``Sᵀv`` through the memoized transpose."""
  from spartan_tpu_torch.backend import sparse as _sp
  if _foreign_sparse(a) or _foreign_sparse(b):
    raise TypeError("convert scipy/torch sparse operands with "
                    "sparse.from_scipy first")
  if isinstance(a, (_sp.SparseArray, _sp.BlockSparseArray)):
    return _sp.sparse_dot(a, b, precision=precision)
  if isinstance(b, (_sp.SparseArray, _sp.BlockSparseArray)):
    if isinstance(b, _sp.BlockSparseArray):
      raise TypeError("dot(dense, BlockSparseArray) is unsupported: "
                      "transpose the product or use a SparseArray")
    a_l = lazify(a)
    nd = len(a_l.shape)
    if nd == 1:
      return _sp.sparse_dot(b.transpose(), a_l, precision=precision)
    if nd == 2:
      return _sp.sparse_dot(b.transpose(), a_l.T, precision=precision).T
    raise ValueError(f"dot(dense {nd}-D, sparse) unsupported")
  return DotExpr(a, b, precision=precision)


def outer(a, b) -> Expr:
  return OuterExpr(a, b)


def tensordot(a, b, axes=2) -> Expr:
  return TensorDotExpr(a, b, axes)
