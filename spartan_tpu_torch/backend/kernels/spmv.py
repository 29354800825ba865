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

import torch

from spartan_tpu_torch.backend.kernels import build

_FLOATS = (torch.float32, torch.bfloat16, torch.float16)

counts = {"ell_launches": 0, "ell_plain_runs": 0, "csr_launches": 0,
          "csr_plain_runs": 0}


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

