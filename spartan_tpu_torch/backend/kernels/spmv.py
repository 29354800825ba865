"""Sparse matrix-vector kernels K3a (padded ELL) and K3b (CSR), with their
plain torch versions.

* :func:`spmv_ell` replaces ``spartan_tpu/backend/kernels/spmv_pallas.py``
  ``spmv`` (K3a, the one-hot MXU kernel) over the reference's row-major
  padded ELL: ``cols`` int32 and ``vals`` (n, k), pad entries at column 0
  with value 0.  Kernel: ``csrc/spmv_ell.cu``.
* :func:`spmv_csr` replaces ``windowed_spmv_traced`` (K3b, the windowed
  kernel over a host-built pack).  The TPU pack exists for the TPU's gather
  limits and is not carried over: the kernel reads the device CSR form that
  ``SparseArray.to_csr`` builds (``indptr`` int64, ``indices`` int32,
  ``data`` float32).  Kernel: ``csrc/spmv_csr.cu``.
* :func:`spmv_chunked` replaces ``windowed_unique_spmv_traced`` (K3c, the
  exact-f32 kernel over the unique-rows pack): the same CSR form cut into
  chunks of ``CHUNK`` nonzeros whatever the row lengths, with
  ``chunk_row`` (the row of each chunk's first nonzero) from
  :func:`chunk_rows`.  Kernel: ``csrc/spmv_chunked.cu``.

:func:`make_spmv_windowed` is the reference's entry point over a
:class:`WindowedELL` pack: a :func:`pack_windowed_unique` pack takes K3c, a
:func:`pack_windowed` pack K3b, as the reference chooses on ``packed.inv``
(``spmv_pallas.py:784-806``).

Both compute in float32, as the TPU kernels do: bfloat16 and float16
operands are cast to float32 here and the result is cast back (to
``vals.dtype`` for the ELL form, to ``x.dtype`` for the CSR form, as the
reference's two entry points return).  Each kernel is bound by the bytes it
reads; the notes in the ``.cu`` files give the bound and how the design
answers it.

Routing is by the tensors' device only: a CUDA tensor launches the kernel
(or raises), a CPU tensor runs the plain version.  ``counts`` holds the
launches and plain runs of each.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from spartan_tpu_torch.backend.kernels import build
from spartan_tpu_torch.core.array import SpartanArray
from spartan_tpu_torch.core.mesh import get_mesh

_FLOATS = (torch.float32, torch.bfloat16, torch.float16)

# nonzeros a block of csrc/spmv_chunked.cu takes (its kChunk)
CHUNK = 1024

counts = {"ell_launches": 0, "ell_plain_runs": 0, "csr_launches": 0,
          "csr_plain_runs": 0, "chunked_launches": 0,
          "chunked_plain_runs": 0}


def reset_counts() -> None:
  for k in counts:
    counts[k] = 0


def group_size(per_row: float) -> int:
  """Lanes per row: the power of two covering ``per_row`` entries, at most
  a warp."""
  g = 1
  while g < per_row and g < 32:
    g *= 2
  return g


# -- plain versions -----------------------------------------------------------

def spmv_ell_plain(cols: torch.Tensor, vals: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
  """``(vals * x[cols]).sum(1)`` in float32, cast to ``vals.dtype``."""
  gathered = x.float().index_select(0, cols.reshape(-1)).reshape(cols.shape)
  return (vals.float() * gathered).sum(1).to(vals.dtype)


def spmv_csr_plain(indptr: torch.Tensor, indices: torch.Tensor,
                   data: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
  """Products ``data * x[indices]`` in float32, then a segment sum by
  ``indptr``; cast to ``x.dtype``."""
  n = indptr.shape[0] - 1
  prod = data.float() * x.float().index_select(0, indices)
  rows = torch.repeat_interleave(
      torch.arange(n, device=indptr.device), indptr[1:] - indptr[:-1],
      output_size=prod.shape[0])
  y = torch.zeros(n, dtype=torch.float32, device=prod.device)
  return y.index_add(0, rows, prod).to(x.dtype)


# -- wrappers ------------------------------------------------------------------

def _check_float(name: str, t: torch.Tensor) -> None:
  if t.dtype not in _FLOATS:
    raise TypeError(f"SpMV kernels read float32/bfloat16/float16 {name}, "
                    f"not {t.dtype}")


def spmv_ell(cols: torch.Tensor, vals: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
  """``y = A @ x`` over padded ELL; cols/vals (n, k), x (m,) → y (n,) of
  ``vals.dtype``.  CUDA tensors launch K3a, CPU tensors run
  :func:`spmv_ell_plain`."""
  if cols.dim() != 2 or vals.shape != cols.shape or x.dim() != 1:
    raise ValueError(f"spmv_ell needs cols/vals (n, k) and x (m,), got "
                     f"{tuple(cols.shape)}, {tuple(vals.shape)}, "
                     f"{tuple(x.shape)}")
  if cols.dtype != torch.int32:
    raise TypeError(f"spmv_ell needs int32 cols, not {cols.dtype}")
  _check_float("vals", vals)
  _check_float("x", x)
  build.one_device(cols, vals, x)
  if x.device.type != "cuda":
    counts["ell_plain_runs"] += 1
    return spmv_ell_plain(cols, vals, x)
  n, k = cols.shape
  if n == 0 or k == 0:
    return torch.zeros(n, dtype=vals.dtype, device=x.device)
  cols_c, vals_c, x_c = (t.contiguous() for t in (cols, vals.float(),
                                                  x.float()))
  y = torch.empty(n, dtype=torch.float32, device=x.device)
  build.launch("spmv_ell", x.device, cols_c.data_ptr(), vals_c.data_ptr(),
               x_c.data_ptr(), y.data_ptr(), n, k, group_size(k))
  counts["ell_launches"] += 1
  return y.to(vals.dtype)


def spmv_csr(indptr: torch.Tensor, indices: torch.Tensor, data: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
  """``y = A @ x`` over CSR; indptr (n+1,) int64, indices (nnz,) int32, data
  (nnz,), x (m,) → y (n,) of ``x.dtype``.  CUDA tensors launch K3b, CPU
  tensors run :func:`spmv_csr_plain`."""
  if (indptr.dim() != 1 or indptr.shape[0] < 1 or indices.dim() != 1
      or data.shape != indices.shape or x.dim() != 1):
    raise ValueError(f"spmv_csr needs indptr (n+1,), indices/data (nnz,) and "
                     f"x (m,), got {tuple(indptr.shape)}, "
                     f"{tuple(indices.shape)}, {tuple(data.shape)}, "
                     f"{tuple(x.shape)}")
  if indptr.dtype != torch.int64 or indices.dtype != torch.int32:
    raise TypeError(f"spmv_csr needs int64 indptr and int32 indices, not "
                    f"{indptr.dtype} and {indices.dtype}")
  _check_float("data", data)
  _check_float("x", x)
  build.one_device(indptr, indices, data, x)
  if x.device.type != "cuda":
    counts["csr_plain_runs"] += 1
    return spmv_csr_plain(indptr, indices, data, x)
  n = indptr.shape[0] - 1
  if n == 0:
    return torch.zeros(0, dtype=x.dtype, device=x.device)
  indptr_c, indices_c, data_c, x_c = (
      t.contiguous() for t in (indptr, indices, data.float(), x.float()))
  y = torch.empty(n, dtype=torch.float32, device=x.device)
  build.launch("spmv_csr", x.device, indptr_c.data_ptr(),
               indices_c.data_ptr(), data_c.data_ptr(), x_c.data_ptr(),
               y.data_ptr(), n, group_size(indices.shape[0] / n))
  counts["csr_launches"] += 1
  return y.to(x.dtype)


def chunk_rows(indptr: torch.Tensor) -> torch.Tensor:
  """int64 row of nonzero ``c * CHUNK`` for each chunk ``c``: the last row
  whose start is at or before it (so empty rows sharing that start are
  skipped), found on ``indptr``'s device."""
  nnz = int(indptr[-1])
  starts = torch.arange(0, nnz, CHUNK, dtype=torch.int64, device=indptr.device)
  return torch.searchsorted(indptr, starts, right=True) - 1


def spmv_chunked_plain(indptr: torch.Tensor, indices: torch.Tensor,
                       data: torch.Tensor, chunk_row: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
  """K3c's plain version: the same product as :func:`spmv_csr_plain`
  (``chunk_row`` only places the kernel's blocks)."""
  return spmv_csr_plain(indptr, indices, data, x)


def spmv_chunked(indptr: torch.Tensor, indices: torch.Tensor,
                 data: torch.Tensor, chunk_row: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
  """``y = A @ x`` over CSR cut into chunks of ``CHUNK`` nonzeros; indptr
  (n+1,) int64, indices/data (nnz,), chunk_row (ceil(nnz/CHUNK),) int64 from
  :func:`chunk_rows`, x (m,) → y (n,) of ``x.dtype``, summed in float32 in
  a fixed order (the same bits on every run).  CUDA tensors launch K3c,
  CPU tensors run :func:`spmv_chunked_plain`."""
  if (indptr.dim() != 1 or indptr.shape[0] < 1 or indices.dim() != 1
      or data.shape != indices.shape or x.dim() != 1
      or chunk_row.shape != (-(-indices.shape[0] // CHUNK),)):
    raise ValueError(f"spmv_chunked needs indptr (n+1,), indices/data "
                     f"(nnz,), chunk_row (ceil(nnz/{CHUNK}),) and x (m,), got "
                     f"{tuple(indptr.shape)}, {tuple(indices.shape)}, "
                     f"{tuple(data.shape)}, {tuple(chunk_row.shape)}, "
                     f"{tuple(x.shape)}")
  if (indptr.dtype != torch.int64 or indices.dtype != torch.int32
      or chunk_row.dtype != torch.int64):
    raise TypeError(f"spmv_chunked needs int64 indptr and chunk_row and int32 "
                    f"indices, not {indptr.dtype}, {chunk_row.dtype} and "
                    f"{indices.dtype}")
  _check_float("data", data)
  _check_float("x", x)
  build.one_device(indptr, indices, data, chunk_row, x)
  if x.device.type != "cuda":
    counts["chunked_plain_runs"] += 1
    return spmv_chunked_plain(indptr, indices, data, chunk_row, x)
  n, nnz = indptr.shape[0] - 1, indices.shape[0]
  if n >= 2 ** 31:
    raise ValueError(f"spmv_chunked takes fewer than 2^31 rows, not {n}")
  if n == 0 or nnz == 0:
    return torch.zeros(n, dtype=x.dtype, device=x.device)
  indptr_c, indices_c, data_c, rows_c, x_c = (
      t.contiguous() for t in (indptr, indices, data.float(), chunk_row,
                               x.float()))
  y = torch.empty(n, dtype=torch.float32, device=x.device)
  carry = torch.empty(2 * rows_c.shape[0], dtype=torch.float32,
                      device=x.device)
  tail_row = torch.empty(rows_c.shape[0], dtype=torch.int64, device=x.device)
  vec = int(indices_c.data_ptr() % 16 == 0 and data_c.data_ptr() % 16 == 0)
  build.launch("spmv_chunked", x.device, indptr_c.data_ptr(),
               indices_c.data_ptr(), data_c.data_ptr(), rows_c.data_ptr(),
               x_c.data_ptr(), y.data_ptr(), carry.data_ptr(),
               tail_row.data_ptr(), n, nnz, vec)
  counts["chunked_launches"] += 1
  return y.to(x.dtype)


# -- the windowed entry point ---------------------------------------------------

class WindowedELL:
  """A matrix packed for :func:`make_spmv_windowed` (named after the
  reference's pack, ``spmv_pallas.py:409``).  It holds the device CSR form
  (``indptr`` int64, ``indices`` int32, ``data`` float32) and, for a
  unique pack, ``chunk_row`` (K3c's chunk-to-first-row table, where the
  reference's unique pack holds its inverse maps ``inv``); ``chunk_row`` is
  None for a classic pack."""

  __slots__ = ("indptr", "indices", "data", "chunk_row", "shape", "nnz")

  def __init__(self, indptr: torch.Tensor, indices: torch.Tensor,
               data: torch.Tensor, shape: Tuple[int, int],
               chunk_row: Optional[torch.Tensor] = None):
    self.indptr, self.indices, self.data = indptr, indices, data
    self.chunk_row = chunk_row
    self.shape = (int(shape[0]), int(shape[1]))
    self.nnz = int(indices.shape[0])

  def __repr__(self):
    kind = "unique" if self.chunk_row is not None else "classic"
    return (f"WindowedELL({kind}, shape={self.shape}, nnz={self.nnz}, "
            f"device={self.indptr.device})")


def _device_csr(sp_csr):
  """(indptr, indices, data, shape) on the device of a port ``SparseArray``
  (its memoized CSR form) or of a scipy sparse matrix (uploaded to the
  mesh's device as CSR, duplicates summed as ``tocsr`` sums them)."""
  if hasattr(sp_csr, "to_csr"):
    return (*sp_csr.to_csr(), sp_csr.shape)
  import scipy.sparse as ss
  if not ss.issparse(sp_csr):
    raise TypeError(f"pack a scipy sparse matrix or a SparseArray, not "
                    f"{type(sp_csr).__name__}")
  csr = sp_csr.tocsr()
  device = get_mesh().device
  host = (np.ascontiguousarray(csr.indptr, np.int64),
          np.ascontiguousarray(csr.indices, np.int32),
          np.ascontiguousarray(csr.data, np.float32))
  return (*(torch.from_numpy(a).to(device) for a in host), csr.shape)


def pack_windowed(sp_csr) -> WindowedELL:
  """The classic pack (reference ``spmv_pallas.py:443``): K3b's CSR form."""
  indptr, indices, data, shape = _device_csr(sp_csr)
  return WindowedELL(indptr, indices, data, shape)


def pack_windowed_unique(sp_csr) -> WindowedELL:
  """The unique-rows pack (reference ``spmv_pallas.py:228``): the CSR form
  plus K3c's chunk table, built on the device."""
  indptr, indices, data, shape = _device_csr(sp_csr)
  return WindowedELL(indptr, indices, data, shape, chunk_rows(indptr))


def make_spmv_windowed(packed: WindowedELL, use_bf16: bool = False):
  """``x -> A @ x`` over a pack (reference ``spmv_pallas.py:770``): a
  unique pack takes K3c (:func:`spmv_chunked`), a classic pack K3b
  (:func:`spmv_csr`).  x is a float32, bfloat16 or float16 tensor (or a
  ``SpartanArray``) on the pack's device; y has ``x.dtype``; a float64 x
  raises ``NotImplementedError`` as the reference's kernels refuse it.
  ``use_bf16`` (the reference's switch to drop the bf16 hi/lo residual
  dots of its classic kernel) is accepted and moot: both routes sum exact
  float32 products in float32."""
  def spmv_windowed(x):
    if isinstance(x, SpartanArray):
      x = x.data
    if x.dtype == torch.float64:
      raise NotImplementedError("windowed SpMV kernel is f32/bf16 only")
    if x.shape != (packed.shape[1],):
      raise ValueError(f"x has shape {tuple(x.shape)}; the packed matrix "
                       f"has shape {packed.shape}")
    if packed.chunk_row is not None:
      return spmv_chunked(packed.indptr, packed.indices, packed.data,
                          packed.chunk_row, x)
    return spmv_csr(packed.indptr, packed.indices, packed.data, x)

  return spmv_windowed
