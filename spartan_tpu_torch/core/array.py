"""SpartanArray: a ``torch.Tensor`` on the mesh's device plus its tiling.

Port of ``spartan_tpu/core/array.py``.  ``glom()`` copies the value to the
host as numpy; ``from_numpy`` copies host data onto the mesh's device with
an exact dtype mapping (float64 stays float64, int64 stays int64, bool
stays bool — nothing is canonicalized down).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from spartan_tpu_torch.core.mesh import Mesh, get_mesh
from spartan_tpu_torch.core.tiling import Tiling, auto_tiling

_NP_TO_TORCH = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.complex64): torch.complex64,
    np.dtype(np.complex128): torch.complex128,
}
_TORCH_TO_NP = {t: n for n, t in _NP_TO_TORCH.items()}


# reducer registry (reference ``core/array.py:32``): NumPy ufuncs, torch
# functions and names, as shuffle's combiners, to scatter ops
_REDUCERS = {
    None: "set",
    "set": "set",
    np.add: "add", torch.add: "add", "add": "add", "sum": "add",
    np.multiply: "mul", torch.mul: "mul", "mul": "mul",
    np.maximum: "max", torch.maximum: "max", "max": "max",
    np.minimum: "min", torch.minimum: "min", "min": "min",
}


def canonical_reducer(reducer) -> str:
  """The scatter op (``set``, ``add``, ``mul``, ``max``, ``min``) of a
  reducer given as a NumPy ufunc, a torch function, a name, or a callable
  whose ``__name__`` is a name of the table."""
  try:
    if reducer in _REDUCERS:
      return _REDUCERS[reducer]
  except TypeError:
    pass
  if callable(reducer):
    name = getattr(reducer, "__name__", "")
    if name in _REDUCERS:
      return _REDUCERS[name]
  raise ValueError(f"unsupported reducer {reducer!r}; expected one of "
                   "None/np.add/np.multiply/np.maximum/np.minimum")


def to_torch_dtype(dtype) -> torch.dtype:
  """Exact numpy → torch dtype mapping (torch dtypes pass through)."""
  if isinstance(dtype, torch.dtype):
    return dtype
  dt = np.dtype(dtype)
  if dt not in _NP_TO_TORCH:
    raise TypeError(f"dtype {dt} has no torch counterpart")
  return _NP_TO_TORCH[dt]


def to_numpy_dtype(dtype) -> np.dtype:
  """Exact torch → numpy dtype mapping; raises for bfloat16, which numpy
  lacks (callers that promote handle it with ``torch.promote_types``)."""
  if not isinstance(dtype, torch.dtype):
    return np.dtype(dtype)
  if dtype not in _TORCH_TO_NP:
    raise TypeError(f"torch dtype {dtype} has no numpy counterpart")
  return _TORCH_TO_NP[dtype]


def dtype_kind(dtype) -> str:
  """numpy-style kind letter ('b', 'u', 'i', 'f', 'c') of a dtype."""
  if isinstance(dtype, torch.dtype):
    if dtype == torch.bool:
      return "b"
    if dtype.is_complex:
      return "c"
    if dtype.is_floating_point:
      return "f"
    return "u" if dtype == torch.uint8 else "i"
  return np.dtype(dtype).kind


class SpartanArray:
  """A device tensor plus its logical tiling metadata."""

  __slots__ = ("data", "tiling")

  def __init__(self, data: torch.Tensor, tiling: Optional[Tiling] = None):
    if not isinstance(data, torch.Tensor):
      raise TypeError(f"SpartanArray wraps a torch.Tensor, got {type(data)}")
    self.data = data
    self.tiling = tiling if tiling is not None else Tiling(Mesh(data.device))

  @property
  def shape(self) -> Tuple[int, ...]:
    return tuple(self.data.shape)

  @property
  def dtype(self) -> torch.dtype:
    return self.data.dtype

  @property
  def ndim(self) -> int:
    return self.data.ndim

  @property
  def size(self) -> int:
    return int(self.data.numel())

  @property
  def device(self) -> torch.device:
    return self.data.device

  @property
  def nbytes(self) -> int:
    return self.size * self.data.element_size()

  def glom(self) -> np.ndarray:
    """Copy the full array to the host (reference ``DistArray.glom``);
    bfloat16, which numpy lacks, comes back as float32."""
    t = self.data.detach()
    if t.dtype == torch.bfloat16:
      t = t.float()
    return t.cpu().numpy()

  def __array__(self, dtype=None, copy=None):
    out = self.glom()
    return out.astype(dtype) if dtype is not None else out

  def astype(self, dtype) -> "SpartanArray":
    return SpartanArray(self.data.to(to_torch_dtype(dtype)), self.tiling)

  def __repr__(self):
    return (f"SpartanArray(shape={self.shape}, dtype={self.dtype}, "
            f"device={self.device})")

  # -- lazy re-entry: arithmetic on an evaluated array builds a new DAG ------

  def _lazy(self):
    from spartan_tpu_torch.expr.base import Val
    return Val(self)

  def __neg__(self):
    return -self._lazy()

  def __abs__(self):
    return self._lazy().__abs__()

  def __invert__(self):
    return self._lazy().__invert__()

  def __getitem__(self, idx):
    return self._lazy()[idx]

  def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
    """numpy-left operands (``ndarray * arr``, ``np.sqrt(arr)``) go to the
    lazy layer as an expr's do, instead of gathering the array."""
    from spartan_tpu_torch.expr.base import Expr
    mapped = tuple(i._lazy() if isinstance(i, SpartanArray) else i
                   for i in inputs)
    lead = next(i for i in mapped if isinstance(i, Expr))
    return lead.__array_ufunc__(ufunc, method, *mapped, **kwargs)

  # elementwise __eq__ (installed below): unhashable, like np.ndarray
  __hash__ = None

  def __getattr__(self, name):
    if name in _EXPR_DELEGATES:
      return getattr(self._lazy(), name)
    raise AttributeError(
        f"'SpartanArray' object has no attribute {name!r}")


_EXPR_DELEGATES = frozenset([
    "T", "sum", "prod", "mean", "std", "var", "max", "min", "argmax",
    "argmin", "all", "any", "dot", "outer", "transpose", "swapaxes",
    "squeeze", "clip", "round", "take", "repeat", "diagonal", "trace",
    "tolist", "conj", "conjugate", "at",
])

_BINOP_NAMES = ["add", "radd", "sub", "rsub", "mul", "rmul", "truediv",
                "rtruediv", "floordiv", "rfloordiv", "mod", "rmod", "pow",
                "rpow", "matmul", "lt", "le", "gt", "ge", "eq", "ne", "and",
                "rand", "or", "ror", "xor", "rxor", "lshift", "rshift"]


def _install_lazy_binops():
  for short in _BINOP_NAMES:
    dunder = f"__{short}__"

    def op(self, other, _d=dunder):
      return getattr(self._lazy(), _d)(other)

    op.__name__ = dunder
    setattr(SpartanArray, dunder, op)


_install_lazy_binops()


def from_numpy(arr, tile_hint: Optional[Sequence[int]] = None,
               mesh: Optional[Mesh] = None) -> SpartanArray:
  """Copy host data onto the mesh's device (reference
  ``expr/fio.from_numpy``), keeping its dtype exactly."""
  arr = np.asarray(arr)
  to_torch_dtype(arr.dtype)  # raise early for dtypes torch lacks
  if not arr.flags.c_contiguous or not arr.flags.writeable:
    arr = np.array(arr, order="C")
  tiling = auto_tiling(arr.shape, tile_hint, mesh or get_mesh())
  data = torch.from_numpy(arr).to(tiling.mesh.device, copy=True)
  return SpartanArray(data, tiling)


def create(shape: Sequence[int], dtype=np.float64,
           tile_hint: Optional[Sequence[int]] = None,
           mesh: Optional[Mesh] = None, fill: float = 0) -> SpartanArray:
  """A dense array of ``shape`` filled with ``fill`` on the mesh's device
  (reference ``DistArray.create``)."""
  shape = tuple(int(s) for s in shape)
  tiling = auto_tiling(shape, tile_hint, mesh or get_mesh())
  data = torch.full(shape, fill, dtype=to_torch_dtype(dtype),
                    device=tiling.mesh.device)
  return SpartanArray(data, tiling)
