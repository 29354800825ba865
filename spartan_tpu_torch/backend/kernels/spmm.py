"""Sparse x dense matrix kernel K5a (CSR), with its plain torch version.

:func:`spmm_csr` replaces ``spartan_tpu/backend/kernels/spmm_pallas.py``
``windowed_spmm_traced`` (K5a, the windowed kernel over a host-built pack).
As with K3b, the TPU pack (``pack_windowed_spmm``) exists for the TPU's
gather limits and is not carried over: the kernel reads the device CSR form
that ``SparseArray.to_csr`` builds (``indptr`` int64, ``indices`` int32,
``data`` float32).  Kernel: ``csrc/spmm_csr.cu``, one warp a row, any
``k`` up to 512 in one launch (the TPU kernel's 128-column strips are a
Mosaic limit).

It computes in float32, as the TPU kernel does: a bfloat16, float16 or
float64 ``B`` is cast to float32, and the result is returned as
``promote(data.dtype, B.dtype)`` (``spmm_pallas.py:270-273``), so a float64
``B`` gives a float64 result of float32 arithmetic.

Routing is by the tensors' device only: a CUDA tensor launches the kernel
(or raises), a CPU tensor runs the plain version.  ``counts`` holds the
launches and plain runs.
"""

from __future__ import annotations

import torch

from spartan_tpu_torch.backend.kernels import build

MAX_K = 512
# Nonzeros per pass of the plain version: its products take chunk·k·4
# bytes (1 GiB at k = 64), where one pass over 20 M nonzeros would take 5 GB
PLAIN_CHUNK = 1 << 22
_DATA_FLOATS = (torch.float32, torch.bfloat16, torch.float16)
_B_FLOATS = _DATA_FLOATS + (torch.float64,)

counts = {"launches": 0, "plain_runs": 0}


def reset_counts() -> None:
  for k in counts:
    counts[k] = 0


def spmm_csr_plain(indptr: torch.Tensor, indices: torch.Tensor,
                   data: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
  """Products ``data[:, None] * B[indices]`` in float32, segment-summed by
  row with ``index_add_`` over chunks of at most ``PLAIN_CHUNK`` nonzeros;
  cast to ``promote(data.dtype, B.dtype)``."""
  n, k = indptr.shape[0] - 1, B.shape[1]
  nnz = indices.shape[0]
  Bf = B.float()
  rows = torch.repeat_interleave(
      torch.arange(n, device=indptr.device), indptr[1:] - indptr[:-1],
      output_size=nnz)
  Y = torch.zeros((n, k), dtype=torch.float32, device=B.device)
  for lo in range(0, nnz, PLAIN_CHUNK):
    hi = min(lo + PLAIN_CHUNK, nnz)
    prod = data[lo:hi].float()[:, None] * Bf.index_select(0, indices[lo:hi])
    Y.index_add_(0, rows[lo:hi], prod)
  return Y.to(torch.promote_types(data.dtype, B.dtype))


def spmm_csr(indptr: torch.Tensor, indices: torch.Tensor, data: torch.Tensor,
             B: torch.Tensor) -> torch.Tensor:
  """``Y = A @ B`` over CSR; indptr (n+1,) int64, indices (nnz,) int32, data
  (nnz,), B (m, k) with k <= ``MAX_K`` → Y (n, k) of
  ``promote(data.dtype, B.dtype)``.  CUDA tensors launch K5a, CPU tensors
  run :func:`spmm_csr_plain`."""
  if (indptr.dim() != 1 or indptr.shape[0] < 1 or indices.dim() != 1
      or data.shape != indices.shape or B.dim() != 2):
    raise ValueError(f"spmm_csr needs indptr (n+1,), indices/data (nnz,) and "
                     f"B (m, k), got {tuple(indptr.shape)}, "
                     f"{tuple(indices.shape)}, {tuple(data.shape)}, "
                     f"{tuple(B.shape)}")
  if indptr.dtype != torch.int64 or indices.dtype != torch.int32:
    raise TypeError(f"spmm_csr needs int64 indptr and int32 indices, not "
                    f"{indptr.dtype} and {indices.dtype}")
  if data.dtype not in _DATA_FLOATS or B.dtype not in _B_FLOATS:
    raise TypeError(f"spmm_csr reads float32/bfloat16/float16 data and "
                    f"float B, not {data.dtype} and {B.dtype}")
  if B.shape[1] > MAX_K:
    raise ValueError(f"spmm_csr takes k <= {MAX_K} columns, got {B.shape[1]}")
  build.one_device(indptr, indices, data, B)
  if B.device.type != "cuda":
    counts["plain_runs"] += 1
    return spmm_csr_plain(indptr, indices, data, B)
  n, k = indptr.shape[0] - 1, B.shape[1]
  out_dtype = torch.promote_types(data.dtype, B.dtype)
  if n == 0 or k == 0:
    return torch.zeros((n, k), dtype=out_dtype, device=B.device)
  indptr_c, indices_c, data_c, B_c = (
      t.contiguous() for t in (indptr, indices, data.float(), B.float()))
  Y = torch.empty((n, k), dtype=torch.float32, device=B.device)
  build.launch("spmm_csr", B.device, indptr_c.data_ptr(), indices_c.data_ptr(),
               data_c.data_ptr(), B_c.data_ptr(), Y.data_ptr(), n, k)
  counts["launches"] += 1
  return Y.to(out_dtype)
