"""Sparse x dense matrix kernel K5a (CSR), with its plain torch version.

:func:`spmm_csr` replaces ``spartan_tpu/backend/kernels/spmm_pallas.py``
``windowed_spmm_traced`` (K5a, the windowed kernel over a host-built pack).
As with K3b, the TPU pack (``pack_windowed_spmm``) exists for the TPU's
gather limits and is not carried over: the kernel reads the device CSR form
that ``SparseArray.to_csr`` builds (``indptr`` int64, ``indices`` int32,
``data`` float32).  Kernel: ``csrc/spmm_csr.cu``, balanced by nonzeros:
each row is cut into segments of ``SEG`` nonzeros counted from its own
start (:func:`segment_table`), one warp a segment, and a row of several
segments is added up from its partial rows in a fixed order; any ``k`` up
to 512 in one launch (the TPU kernel's 128-column strips are a Mosaic
limit).  :func:`spmm_csr` builds the work table on the device in each
call (a few torch ops, no host sync); the sharded pack keeps its bands'
tables (``ShardedWindowedSpMM.tables``).  The grid is sized by the
host-known bound :func:`grid_segments`.

It computes in float32, as the TPU kernel does: a bfloat16, float16 or
float64 ``B`` is cast to float32, and the result is returned as
``promote(data.dtype, B.dtype)`` (``spmm_pallas.py:270-273``), so a float64
``B`` gives a float64 result of float32 arithmetic.

:func:`sharded_windowed_spmm_traced` replaces the function of that name
(K5b, K5a inside ``shard_map`` with B replicated): K5a once a shard of the
mesh on the shard's CSR band of a :class:`ShardedWindowedSpMM`
(:func:`pack_windowed_spmm_sharded`, rows ``[d·rows_per, (d+1)·rows_per)``,
``rows_per = rbmm_per_of(n, p)·128``), each launch writing its rows of one
``Y``.  Segments are counted from each row's start, so a band's table is
the whole matrix's table sliced and rebased, each row sums in the same
order whichever band holds it, and the sharded product equals the
unsharded one bit for bit.  Not carried over: the reference's 128-column
slices for ``k > 128`` (the TPU's lane width; K5a takes k ≤ 512 in one
launch) and its fill gate.

Routing is by the tensors' device only: a CUDA tensor launches the kernel
(or raises), a CPU tensor runs the plain version.  ``counts`` holds the
launches (one a call, one a non-empty band; the kernel's two passes are
one launch) and plain runs.
"""

from __future__ import annotations

from typing import Tuple

import torch

from spartan_tpu_torch.backend.kernels import build
from spartan_tpu_torch.backend.kernels.spmv import (ShardedCSR,
                                                    unshard_windowed)

MAX_K = 512
# nonzeros a segment, the kernel's unit of work (csrc/spmm_csr.cu: kSeg)
SEG = 256
# Nonzeros per pass of the plain version: its products take chunk·k·4
# bytes (1 GiB at k = 64), where one pass over 20 M nonzeros would take 5 GB
PLAIN_CHUNK = 1 << 22
_DATA_FLOATS = (torch.float32, torch.bfloat16, torch.float16)
_B_FLOATS = _DATA_FLOATS + (torch.float64,)

# output rows a block of the reference's SpMM pack: a shard of the sharded
# pack owns a whole number of these
_RB = 128

counts = {"launches": 0, "plain_runs": 0, "sharded_launches": 0,
          "sharded_plain_runs": 0}


def reset_counts() -> None:
  for k in counts:
    counts[k] = 0


def segment_table(indptr: torch.Tensor) -> torch.Tensor:
  """The kernel's work table: ``seg_ptr`` (n+1,) int64, the running sum of
  ``max(1, ceil(len/SEG))`` over the rows, so that row r owns segments
  ``[seg_ptr[r], seg_ptr[r+1])`` and its segment j the nonzeros from
  ``indptr[r] + j·SEG``.  Built where ``indptr`` lies, with no host sync."""
  lengths = indptr[1:] - indptr[:-1]
  table = torch.zeros(indptr.shape[0], dtype=torch.int64,
                      device=indptr.device)
  torch.cumsum((lengths - 1).clamp_min_(0) // SEG + 1, 0, out=table[1:])
  return table


def grid_segments(n: int, nnz: int) -> int:
  """The kernel's grid in warps: a bound on ``segment_table(...)[-1]`` from
  the shape alone (each row has at most ``len // SEG`` segments besides
  its first)."""
  return n + nnz // SEG


def partial_rows(nnz: int) -> int:
  """Rows of the kernel's scratch: segment j ≥ 1 of row r writes partial
  row ``seg_ptr[r] - r + j - 1``, and there are at most ``nnz // SEG`` of
  them."""
  return nnz // SEG


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
  ``promote(data.dtype, B.dtype)``.  CUDA tensors launch K5a over the work
  table :func:`segment_table` built for the call, CPU tensors run
  :func:`spmm_csr_plain`."""
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
  build.check_operands("spmm.spmm_csr", indptr, indices, data, B)
  if B.device.type != "cuda":
    counts["plain_runs"] += 1
    return spmm_csr_plain(indptr, indices, data, B)
  n, k = indptr.shape[0] - 1, B.shape[1]
  out_dtype = torch.promote_types(data.dtype, B.dtype)
  if n == 0 or k == 0:
    return torch.zeros((n, k), dtype=out_dtype, device=B.device)
  indptr_c, indices_c, data_c = (t.contiguous()
                                 for t in (indptr, indices, data.float()))
  Y = torch.empty((n, k), dtype=torch.float32, device=B.device)
  _into(indptr_c, indices_c, data_c, _rows_f32(B), Y,
        _scratch(indices.shape[0], k, B.device), segment_table(indptr_c))
  counts["launches"] += 1
  return Y.to(out_dtype)


def _rows_f32(B: torch.Tensor) -> torch.Tensor:
  """B as contiguous float32 at a 16-byte aligned address (a view may
  start inside a row), which the kernel's 16-byte loads need when k % 4
  == 0."""
  Bf = B.float().contiguous()
  return Bf.clone() if Bf.data_ptr() % 16 else Bf


def _scratch(nnz: int, k: int, device) -> torch.Tensor:
  """The kernel's partial rows for a matrix (or band) of up to ``nnz``
  nonzeros."""
  return torch.empty((partial_rows(nnz), k), dtype=torch.float32,
                     device=device)


def _into(indptr: torch.Tensor, indices: torch.Tensor, data: torch.Tensor,
          B: torch.Tensor, Y: torch.Tensor, P: torch.Tensor,
          seg_ptr: torch.Tensor) -> None:
  """Launch K5a over contiguous CSR operands and float32 data and B (m,
  k), writing the contiguous float32 rows ``Y`` (n, k), with the scratch
  ``P`` of at least ``partial_rows(nnz)`` rows of k floats and the work
  table ``seg_ptr``."""
  n, nnz, k = indptr.shape[0] - 1, indices.shape[0], B.shape[1]
  build.launch("spmm_csr", B.device, indptr.data_ptr(), indices.data_ptr(),
               data.data_ptr(), B.data_ptr(), Y.data_ptr(), seg_ptr.data_ptr(),
               P.data_ptr(), n, nnz, k, SEG)


# -- the row-sharded form ---------------------------------------------------------

class ShardedWindowedSpMM(ShardedCSR):
  """:func:`pack_windowed_spmm_sharded`'s pack: row bands of
  ``rbmm_per_of(n, p)·128`` rows (named after the reference's pack,
  ``spmm_pallas.py:300``), with each band's work table in ``tables``
  (the whole matrix's, sliced and rebased, as the band's ``indptr`` is),
  built once a pack.  :meth:`tensors` lists the bands, then the tables."""

  __slots__ = ("tables",)
  block_rows = _RB

  def __init__(self, bands, shape: Tuple[int, int], tables=None):
    super().__init__(bands, shape)
    self.tables = (list(tables) if tables is not None
                   else [segment_table(band[0]) for band in self.bands])

  @classmethod
  def from_tensors(cls, tensors, shape, n_shards: int):
    tensors = list(tensors)
    if len(tensors) != 4 * n_shards:
      raise ValueError(f"{len(tensors)} tensors for {n_shards} bands and "
                       f"their tables")
    it = iter(tensors[:3 * n_shards])
    return cls(list(zip(it, it, it)), shape, tensors[3 * n_shards:])

  def tensors(self) -> list:
    return super().tensors() + self.tables


def rbmm_per_of(n: int, n_shards: int) -> int:
  """Row blocks of ``_RB`` rows a shard (the reference's ``rbmm_per_of``)."""
  return ShardedWindowedSpMM.rows_per_of(n, n_shards) // _RB


def pack_windowed_spmm_sharded(sp_csr, n_shards: int) -> ShardedWindowedSpMM:
  """Row-shard the SpMM pack (reference ``spmm_pallas.py:331``): shard d
  owns rows ``[d·rows_per, (d+1)·rows_per)``, ``rows_per =
  rbmm_per_of(n, n_shards)·128``, as CSR bands over the matrix's device
  CSR form."""
  return ShardedWindowedSpMM.pack(sp_csr, n_shards)


def sharded_windowed_spmm_traced(packed: ShardedWindowedSpMM, B: torch.Tensor,
                                 mesh) -> torch.Tensor:
  """``Y = A @ B`` over a sharded pack on a mesh of as many shards: one K5a
  launch a non-empty shard, each over its band's own segment table (the
  whole matrix's, sliced and rebased) and writing its rows of one float32
  ``Y``; B is read by every shard, and the bands share one scratch.
  Returns Y (n, k) as ``promote(data.dtype, B.dtype)``.  CUDA tensors
  launch K5a, CPU tensors run :func:`spmm_csr_plain` a band."""
  if packed.n_shards != mesh.size:
    raise ValueError(f"the pack has {packed.n_shards} shards, the mesh "
                     f"{mesh.size}")
  if B.dim() != 2 or B.shape[0] != packed.shape[1]:
    raise ValueError(f"B has shape {tuple(B.shape)}; the packed matrix has "
                     f"shape {packed.shape}")
  data_dtype = packed.bands[0][2].dtype
  if (data_dtype not in _DATA_FLOATS or B.dtype not in _B_FLOATS
      or B.shape[1] > MAX_K):
    raise TypeError(f"sharded_windowed_spmm_traced reads float data and a "
                    f"float B of at most {MAX_K} columns, not {data_dtype} "
                    f"and {B.dtype} {tuple(B.shape)}")
  build.check_operands("spmm.sharded_windowed_spmm_traced", B,
                       *packed.tensors())
  n, k = packed.shape[0], B.shape[1]
  out_dtype = torch.promote_types(data_dtype, B.dtype)
  Y = torch.empty((n, k), dtype=torch.float32, device=B.device)
  on_card = B.device.type == "cuda"
  Bf = _rows_f32(B)
  if on_card:
    P = _scratch(max(band[1].shape[0] for band in packed.bands), k, B.device)
  for d, (indptr, indices, data) in enumerate(packed.bands):
    r0, r1 = packed.rows(d)
    if r1 == r0:
      continue
    if not on_card:
      Y[r0:r1] = spmm_csr_plain(indptr, indices, data, Bf)
      counts["sharded_plain_runs"] += 1
    elif k:
      indptr, indices, data = (t.contiguous() for t in (indptr, indices,
                                                        data.float()))
      _into(indptr, indices, data, Bf, Y[r0:r1], P,
            packed.tables[d].contiguous())
      counts["sharded_launches"] += 1
  return Y.to(out_dtype)


# the reference's name for the same flattening (spmm_pallas.py:442)
unshard_windowed_spmm = unshard_windowed
