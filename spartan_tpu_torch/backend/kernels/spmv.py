"""Sparse matrix-vector kernels K3a (padded ELL) and K3b (CSR), with their
plain torch versions.

* :func:`spmv_ell` replaces ``spartan_tpu/backend/kernels/spmv_pallas.py``
  ``spmv`` (K3a, the one-hot MXU kernel) over the reference's row-major
  padded ELL: ``cols`` int32 and ``vals`` (n, k), pad entries at column 0
  with value 0.  Kernel: ``csrc/spmv_ell.cu``, with x in each block's
  shared memory where :func:`ell_on_chip` says it fits, else gathered
  through L1 (counted in ``ell_through_l1_launches``).
* :func:`spmv_csr` replaces ``windowed_spmv_traced`` (K3b, the windowed
  kernel over a host-built pack).  The TPU pack exists for the TPU's gather
  limits and is not carried over: the kernel reads the device CSR form that
  ``SparseArray.to_csr`` builds (``indptr`` int64, ``indices`` int32,
  ``data`` float32).  Kernel: ``csrc/spmv_csr.cu``, launched over a table
  of one row band.
* :func:`spmv_chunked` replaces ``windowed_unique_spmv_traced`` (K3c, the
  exact-f32 kernel over the unique-rows pack): the same CSR form cut into
  chunks of ``CHUNK`` nonzeros whatever the row lengths, with
  ``chunk_row`` (the row of each chunk's first nonzero) from
  :func:`chunk_rows`.  Where x spans at most ``MAX_WINDOWS`` windows of
  ``WINDOW`` floats, the pack also holds a window-major copy
  (:class:`ChunkWindows`, :func:`chunk_windows`), whose chunks the kernel
  runs window by window, so that its gathers of x hit in L1.  Kernel:
  ``csrc/spmv_chunked.cu``.

:func:`make_spmv_windowed` is the reference's entry point over a
:class:`WindowedELL` pack: a :func:`pack_windowed_unique` pack takes K3c, a
:func:`pack_windowed` pack K3b, as the reference chooses on ``packed.inv``
(``spmv_pallas.py:784-806``).

The row-sharded forms run the same kernels' rows on each shard's row band,
each band writing its slice of one ``y``, with ``x`` one tensor that every
shard reads (the reference's ``shard_map`` bodies, ``x`` replicated):

* :func:`sharded_onehot_spmv` replaces ``sharded_onehot_spmv`` (K3a
  sharded): K3a's rows over p near-equal row bands of the ELL, shard d
  owning rows ``[min(d·ceil(n/p), n), min((d+1)·ceil(n/p), n))``
  (:func:`ell_bands`), all bands in one launch of K3a over a table of at
  most ``MAX_BANDS`` bands (:func:`spmv_ell` launches one band).  The reference pads
  the rows to a multiple of ``8·p``, its strip height on the TPU; K3a
  takes any row count, so nothing is padded.
* :func:`sharded_windowed_spmv_traced` replaces the function of that name
  (K3d): K3b's rows on each shard's CSR band of a
  :class:`ShardedWindowedELL` (:func:`pack_windowed_sharded`; shard d owns
  the reference's rows ``[d·rows_per, (d+1)·rows_per)``, ``rows_per =
  rb_per_of(n, p)·1024``), all bands in one launch over a table of at
  most ``MAX_BANDS`` bands (:func:`spmv_csr` launches one band).  Every
  band takes the whole matrix's lane group, so each row is summed in the
  same order as unsharded K3b sums it and the result is the same bit for
  bit.  The reference's launch chunking (``_MAX_PREFETCH_STEPS``) is a TPU
  scalar-memory limit and has no counterpart.

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

import ctypes
from typing import List, Optional, Tuple

import numpy as np
import torch

from spartan_tpu_torch.backend.kernels import build
from spartan_tpu_torch.core.array import SpartanArray
from spartan_tpu_torch.core.mesh import get_mesh

_FLOATS = (torch.float32, torch.bfloat16, torch.float16)

# nonzeros a chunk of csrc/spmv_chunked.cu (its kChunk)
CHUNK = 1024
# floats of x a window of its windowed form, and windows at most (its
# kWindow, kMaxWindows)
WINDOW = 32768
MAX_WINDOWS = 8
# bands one launch of csrc/spmv_ell.cu or csrc/spmv_csr.cu takes (their
# SP_MAX_BANDS)
MAX_BANDS = 64
# floats of x that K3a's on-chip form holds in each block (csrc/
# spmv_ell.cu's kMaxX)
ELL_MAX_X = 32768

counts = {"ell_launches": 0, "ell_plain_runs": 0,
          "ell_through_l1_launches": 0, "ell_4byte_launches": 0,
          "csr_launches": 0, "csr_plain_runs": 0, "chunked_launches": 0,
          "chunked_windowed_launches": 0, "chunked_plain_runs": 0,
          "chunked_windowed_packs": 0, "chunked_unwindowed_packs": 0,
          "sharded_ell_launches": 0, "sharded_ell_bands": 0,
          "sharded_ell_plain_runs": 0, "sharded_csr_launches": 0,
          "sharded_csr_bands": 0, "sharded_csr_plain_runs": 0}
# rows of the x/y window of the reference's windowed packs: a shard of the
# sharded windowed pack owns a whole number of these row blocks
_WIN = 1024


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
  ``vals.dtype``.  CUDA tensors launch K3a (x in each block's shared
  memory where :func:`ell_on_chip` says so), CPU tensors run
  :func:`spmv_ell_plain`."""
  if cols.dim() != 2 or vals.shape != cols.shape or x.dim() != 1:
    raise ValueError(f"spmv_ell needs cols/vals (n, k) and x (m,), got "
                     f"{tuple(cols.shape)}, {tuple(vals.shape)}, "
                     f"{tuple(x.shape)}")
  if cols.dtype != torch.int32:
    raise TypeError(f"spmv_ell needs int32 cols, not {cols.dtype}")
  _check_float("vals", vals)
  _check_float("x", x)
  build.check_operands("spmv.spmv_ell", cols, vals, x)
  if x.device.type != "cuda":
    counts["ell_plain_runs"] += 1
    return spmv_ell_plain(cols, vals, x)
  n, k = cols.shape
  if n == 0 or k == 0:
    return torch.zeros(n, dtype=vals.dtype, device=x.device)
  cols_c, vals_c, x_c = (t.contiguous() for t in (cols, vals.float(),
                                                  x.float()))
  y = torch.empty(n, dtype=torch.float32, device=x.device)
  counts["ell_launches"] += _launch_bands(cols_c, vals_c, x_c, y, [(0, n)])
  return y.to(vals.dtype)


def spmv_csr(indptr: torch.Tensor, indices: torch.Tensor, data: torch.Tensor,
             x: torch.Tensor, group: Optional[int] = None) -> torch.Tensor:
  """``y = A @ x`` over CSR; indptr (n+1,) int64, indices (nnz,) int32, data
  (nnz,), x (m,) → y (n,) of ``x.dtype``.  CUDA tensors launch K3b (a table
  of one row band), CPU tensors run :func:`spmv_csr_plain`.  ``group``
  (lanes a row, which fixes the order of each row's sum) defaults to
  :func:`group_size` of the mean row length."""
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
  build.check_operands("spmv.spmv_csr", indptr, indices, data, x)
  if x.device.type != "cuda":
    counts["csr_plain_runs"] += 1
    return spmv_csr_plain(indptr, indices, data, x)
  n = indptr.shape[0] - 1
  if n == 0:
    return torch.zeros(0, dtype=x.dtype, device=x.device)
  y = torch.empty(n, dtype=torch.float32, device=x.device)
  band = (indptr.contiguous(), indices.contiguous(), data.float().contiguous(),
          y)
  counts["csr_launches"] += _launch_csr_bands(
      [band], x.float().contiguous(),
      group or group_size(indices.shape[0] / n))
  return y.to(x.dtype)


def csr_band_table(bands) -> List[List[int]]:
  """K3b/K3d's launch table, five int64 a band: the addresses of the
  band's contiguous int64 ``indptr`` (its rows' offsets in its own
  ``indices``/``data``), int32 ``indices``, float32 ``data`` and float32
  ``y``, and its row count.  ``bands``: ``(indptr, indices, data, y)``
  each."""
  return [[indptr.data_ptr(), indices.data_ptr(), data.data_ptr(),
           y.data_ptr(), y.shape[0]] for indptr, indices, data, y in bands]


def _launch_csr_bands(bands, x: torch.Tensor, group: int) -> int:
  """K3b's rows over ``bands`` (see :func:`csr_band_table`) with float32
  ``x`` and ``group`` lanes a row: one launch (one ctypes call) for every
  ``MAX_BANDS`` bands.  Returns the launches."""
  table = csr_band_table(bands)
  for lo in range(0, len(table), MAX_BANDS):
    chunk = table[lo:lo + MAX_BANDS]
    flat = (ctypes.c_int64 * (5 * len(chunk)))(*(v for b in chunk for v in b))
    build.launch("spmv_csr", x.device, ctypes.addressof(flat), len(chunk),
                 x.data_ptr(), group)
  return -(-len(table) // MAX_BANDS)


def chunk_rows(indptr: torch.Tensor) -> torch.Tensor:
  """int64 row of nonzero ``c * CHUNK`` for each chunk ``c``: the last row
  whose start is at or before it (so empty rows sharing that start are
  skipped), found on ``indptr``'s device."""
  nnz = int(indptr[-1])
  starts = torch.arange(0, nnz, CHUNK, dtype=torch.int64, device=indptr.device)
  return torch.searchsorted(indptr, starts, right=True) - 1


class ChunkWindows:
  """K3c's window-major copy of a CSR matrix (n, m) whose x spans
  ``count`` <= ``MAX_WINDOWS`` windows of ``WINDOW`` floats.

  Window s holds the nonzeros of each row whose columns lie in
  ``[s·WINDOW, (s+1)·WINDOW)``, rows in order and each row's nonzeros in
  their CSR order, as its own CSR: ``indptr[s]`` (int64, (count, n+1))
  indexes one storage ``indices`` (int32, the column less ``s·WINDOW``) and
  ``data`` (float32), in which each window starts at a multiple of 4
  entries (16 bytes) and which is padded to one (pad entries 0).  Each
  window is cut into chunks of ``CHUNK`` nonzeros from its start;
  ``chunk_row`` holds, window by window, each chunk's first row (as
  :func:`chunk_rows`) and then the row of the window's last nonzero.
  ``table`` holds four ints a window: its first nonzero, one past its last,
  its chunks and the offset of its rows in ``chunk_row``."""

  __slots__ = ("indptr", "indices", "data", "chunk_row", "table", "count",
               "nchunks")

  def __init__(self, indptr, indices, data, chunk_row, table):
    self.indptr, self.indices, self.data = indptr, indices, data
    self.chunk_row, self.table = chunk_row, table
    self.count = len(table)
    self.nchunks = sum(w[2] for w in table)

  def tensors(self) -> list:
    return [self.indptr, self.indices, self.data, self.chunk_row]

  def __repr__(self):
    return (f"ChunkWindows({self.count} windows of {WINDOW}, "
            f"{self.nchunks} chunks)")


def windowed(shape: Tuple[int, int], nnz: int) -> bool:
  """Whether K3c's pack of a matrix of this shape and nnz takes the
  windowed form: some nonzero, and x within ``MAX_WINDOWS`` windows."""
  return shape[0] > 0 and nnz > 0 and shape[1] <= WINDOW * MAX_WINDOWS


def chunk_windows(indptr: torch.Tensor, indices: torch.Tensor,
                  data: torch.Tensor, shape: Tuple[int, int]) -> ChunkWindows:
  """The window-major copy of a CSR matrix that :func:`windowed` takes,
  built on its device; one copy of the window sizes to the host."""
  n, m = shape
  nnz = indices.shape[0]
  count = -(-m // WINDOW)
  device = indptr.device
  rows = torch.repeat_interleave(torch.arange(n, device=device),
                                 indptr[1:] - indptr[:-1], output_size=nnz)
  win = indices.long() // WINDOW
  key = win * n + rows
  del rows
  order = torch.argsort(key, stable=True)
  per_row = torch.bincount(key, minlength=count * n).view(count, n)
  del key
  per_win = per_row.sum(1)
  padded = (per_win + 3) // 4 * 4
  base = torch.cumsum(padded, 0) - padded
  w_indptr = torch.zeros((count, n + 1), dtype=torch.int64, device=device)
  w_indptr[:, 1:] = torch.cumsum(per_row, 1)
  w_indptr += base[:, None]
  sorted_win = win[order]
  first = torch.cumsum(per_win, 0) - per_win  # each window's first in order
  pos = base[sorted_win] + torch.arange(nnz, device=device) - first[sorted_win]
  sizes = torch.stack([base, per_win]).tolist()
  total = sizes[0][-1] + (sizes[1][-1] + 3) // 4 * 4
  w_indices = torch.zeros(total, dtype=torch.int32, device=device)
  w_indices[pos] = (indices[order].long() - sorted_win * WINDOW).int()
  w_data = torch.zeros(total, dtype=torch.float32, device=device)
  w_data[pos] = data[order].float()
  table, row_tables, offset = [], [], 0
  for s, (b, k) in enumerate(zip(*sizes)):
    chunks = -(-k // CHUNK)
    table.append([b, b + k, chunks, offset])
    if chunks:
      marks = torch.arange(b, b + k, CHUNK, dtype=torch.int64, device=device)
      marks = torch.cat([marks, marks.new_full((1,), b + k - 1)])
      row_tables.append(torch.searchsorted(w_indptr[s], marks, right=True) - 1)
      offset += chunks + 1
  return ChunkWindows(w_indptr, w_indices, w_data, torch.cat(row_tables),
                      table)


def spmv_chunked_plain(indptr: torch.Tensor, indices: torch.Tensor,
                       data: torch.Tensor, chunk_row: torch.Tensor,
                       x: torch.Tensor, windows=None) -> torch.Tensor:
  """K3c's plain version: the same product as :func:`spmv_csr_plain`
  (``chunk_row`` and ``windows`` only place the kernel's work)."""
  return spmv_csr_plain(indptr, indices, data, x)


def spmv_chunked(indptr: torch.Tensor, indices: torch.Tensor,
                 data: torch.Tensor, chunk_row: torch.Tensor,
                 x: torch.Tensor,
                 windows: Optional[ChunkWindows] = None) -> torch.Tensor:
  """``y = A @ x`` over CSR cut into chunks of ``CHUNK`` nonzeros; indptr
  (n+1,) int64, indices/data (nnz,), chunk_row (ceil(nnz/CHUNK),) int64 from
  :func:`chunk_rows`, x (m,), and for the windowed form the matrix's
  :class:`ChunkWindows` → y (n,) of ``x.dtype``, summed in float32 in a
  fixed order (the same bits on every run).  CUDA tensors launch K3c (the
  windowed form where ``windows`` is given), CPU tensors run
  :func:`spmv_chunked_plain`."""
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
  n, m, nnz = indptr.shape[0] - 1, x.shape[0], indices.shape[0]
  if windows is not None:
    if (windows.indptr.shape != (windows.count, n + 1)
        or m > windows.count * WINDOW):
      raise ValueError(f"the windows ({windows}, indptr "
                       f"{tuple(windows.indptr.shape)}) are not of a matrix "
                       f"of {n} rows and {m} columns")
    build.check_operands("spmv.spmv_chunked", indptr, indices, data,
                         chunk_row, x, *windows.tensors())
  else:
    build.check_operands("spmv.spmv_chunked", indptr, indices, data,
                         chunk_row, x)
  if x.device.type != "cuda":
    counts["chunked_plain_runs"] += 1
    return spmv_chunked_plain(indptr, indices, data, chunk_row, x)
  if n >= 2 ** 31:
    raise ValueError(f"spmv_chunked takes fewer than 2^31 rows, not {n}")
  if n == 0 or nnz == 0:
    return torch.zeros(n, dtype=x.dtype, device=x.device)
  if windows is None:
    operands = (indptr.contiguous(), indices.contiguous(),
                data.float().contiguous(), chunk_row.contiguous())
  else:
    operands = windows.tensors()
  y = _launch_chunked(operands, x.float().contiguous(), n, nnz, windows)
  counts["chunked_launches"] += 1
  if windows is not None:
    counts["chunked_windowed_launches"] += 1
  return y.to(x.dtype)


def chunked_scratch(n: int, nchunks: int, count: int) -> int:
  """float32 scratch of one K3c launch over ``nchunks`` chunks: each
  chunk's head and tail, and for more than one window (``count``) the
  windows' partial rows (count, n); one window writes y itself."""
  return 2 * nchunks + (count * n if count > 1 else 0)


def _launch_chunked(operands, x: torch.Tensor, n: int, nnz: int,
                    windows: Optional[ChunkWindows]) -> torch.Tensor:
  """K3c over contiguous ``operands`` (indptr, indices, float32 data,
  chunk_row: the CSR form, or ``windows``' tensors) and float32 ``x``, with
  its scratch; returns float32 y (n,)."""
  if windows is None:
    nchunks, count, table = operands[3].shape[0], 0, None
  else:
    nchunks, count = windows.nchunks, windows.count
    flat = [v for w in windows.table for v in w]
    table = (ctypes.c_int64 * len(flat))(*flat)
  y = torch.empty(n, dtype=torch.float32, device=x.device)
  scratch = torch.empty(chunked_scratch(n, nchunks, count),
                        dtype=torch.float32, device=x.device)
  tail_row = torch.empty(nchunks, dtype=torch.int64, device=x.device)
  build.launch("spmv_chunked", x.device, *(t.data_ptr() for t in operands),
               x.data_ptr(), y.data_ptr(), scratch.data_ptr(),
               tail_row.data_ptr(), n, x.shape[0], nnz, nchunks,
               None if table is None else ctypes.addressof(table), count)
  return y


# -- the windowed entry point ---------------------------------------------------

class WindowedELL:
  """A matrix packed for :func:`make_spmv_windowed` (named after the
  reference's pack, ``spmv_pallas.py:409``).  It holds the device CSR form
  (``indptr`` int64, ``indices`` int32, ``data`` float32) and, for a
  unique pack, ``chunk_row`` (K3c's chunk-to-first-row table, where the
  reference's unique pack holds its inverse maps ``inv``) and, where x is
  narrow enough (:func:`windowed`), ``windows`` (K3c's window-major copy,
  :class:`ChunkWindows`); ``chunk_row`` and ``windows`` are None for a
  classic pack."""

  __slots__ = ("indptr", "indices", "data", "chunk_row", "windows", "shape",
               "nnz")

  def __init__(self, indptr: torch.Tensor, indices: torch.Tensor,
               data: torch.Tensor, shape: Tuple[int, int],
               chunk_row: Optional[torch.Tensor] = None,
               windows: Optional[ChunkWindows] = None):
    self.indptr, self.indices, self.data = indptr, indices, data
    self.chunk_row, self.windows = chunk_row, windows
    self.shape = (int(shape[0]), int(shape[1]))
    self.nnz = int(indices.shape[0])

  def __repr__(self):
    if self.chunk_row is None:
      kind = "classic"
    elif self.windows is None:
      kind = "unique, unwindowed"
    else:
      kind = f"unique, {self.windows.count} windows of {WINDOW}"
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
  plus K3c's chunk table and, where :func:`windowed` says so, its
  window-major copy, built on the device.  The form is counted in
  ``chunked_windowed_packs`` or ``chunked_unwindowed_packs``."""
  indptr, indices, data, shape = _device_csr(sp_csr)
  windows = None
  if windowed(shape, int(indices.shape[0])):
    windows = chunk_windows(indptr, indices, data, shape)
    counts["chunked_windowed_packs"] += 1
  else:
    counts["chunked_unwindowed_packs"] += 1
  return WindowedELL(indptr, indices, data, shape, chunk_rows(indptr),
                     windows)


def make_spmv_windowed(packed: WindowedELL, use_bf16: bool = False):
  """``x -> A @ x`` over a pack (reference ``spmv_pallas.py:770``): a
  unique pack takes K3c (:func:`spmv_chunked`, windowed where the pack
  holds windows), a classic pack K3b (:func:`spmv_csr`).  x is a float32,
  bfloat16 or float16 tensor (or a ``SpartanArray``) on the pack's device;
  y has ``x.dtype``; a float64 x raises ``NotImplementedError`` as the
  reference's kernels refuse it.  ``use_bf16`` (the reference's switch to
  drop the bf16 hi/lo residual dots of its classic kernel) is accepted and
  moot: both routes sum exact float32 products in float32."""
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
                          packed.chunk_row, x, packed.windows)
    return spmv_csr(packed.indptr, packed.indices, packed.data, x)

  return spmv_windowed


# -- the row-sharded forms --------------------------------------------------------

def ell_bands(n: int, n_shards: int) -> List[Tuple[int, int]]:
  """The non-empty row bands ``(r0, r1)`` of an ELL of n rows on
  ``n_shards`` shards, in shard order: shard d owns rows
  ``[min(d·ceil(n/p), n), min((d+1)·ceil(n/p), n))``; shards past the
  last row own none and are left out."""
  band = -(-n // n_shards)
  return [(lo, min(lo + band, n)) for lo in range(0, n, band)]


def band_table(cols: torch.Tensor, vals: torch.Tensor, y: torch.Tensor,
               bands: List[Tuple[int, int]]) -> List[List[int]]:
  """K3a's launch table, four int64 a band: the addresses of the band's
  first row of contiguous int32 ``cols`` and float32 ``vals`` (n, k) and
  of float32 ``y`` (n,), and its row count."""
  k = cols.shape[1]
  return [[cols.data_ptr() + 4 * r0 * k, vals.data_ptr() + 4 * r0 * k,
           y.data_ptr() + 4 * r0, r1 - r0] for r0, r1 in bands]


def sharded_onehot_spmv(cols: torch.Tensor, vals: torch.Tensor,
                        x: torch.Tensor, mesh) -> torch.Tensor:
  """``y = A @ x`` over padded ELL with the rows owner-computed per shard
  (:func:`ell_bands`), each band writing its slice of one float32 ``y``;
  x is read by every shard.  Returns ``y`` in ``vals.dtype``.  CUDA
  tensors launch K3a once for every ``MAX_BANDS`` non-empty bands, CPU
  tensors run :func:`spmv_ell_plain` a band."""
  if cols.dim() != 2 or vals.shape != cols.shape or x.dim() != 1:
    raise ValueError(f"sharded_onehot_spmv needs cols/vals (n, k) and x (m,), "
                     f"got {tuple(cols.shape)}, {tuple(vals.shape)}, "
                     f"{tuple(x.shape)}")
  if cols.dtype != torch.int32:
    raise TypeError(f"sharded_onehot_spmv needs int32 cols, not {cols.dtype}")
  _check_float("vals", vals)
  _check_float("x", x)
  build.check_operands("spmv.sharded_onehot_spmv", cols, vals, x)
  n, k = cols.shape
  out_dtype = vals.dtype
  if n == 0 or k == 0:
    return torch.zeros(n, dtype=out_dtype, device=x.device)
  y = torch.empty(n, dtype=torch.float32, device=x.device)
  bands = ell_bands(n, mesh.size)
  if x.device.type != "cuda":
    for r0, r1 in bands:
      y[r0:r1] = spmv_ell_plain(cols[r0:r1], vals[r0:r1], x)
      counts["sharded_ell_plain_runs"] += 1
    return y.to(out_dtype)
  cols, vals, x = (t.contiguous() for t in (cols, vals.float(), x.float()))
  counts["sharded_ell_launches"] += _launch_bands(cols, vals, x, y, bands)
  counts["sharded_ell_bands"] += len(bands)
  return y.to(out_dtype)


def ell_on_chip(m: int) -> bool:
  """Whether K3a takes its on-chip form for an x of ``m`` floats: x fits
  in a block's shared memory (``ELL_MAX_X`` floats).  Otherwise it gathers
  x through L1 (only under ``--sparse_force_onehot`` past
  ``ONEHOT_MAX_M`` columns)."""
  return 1 <= m <= ELL_MAX_X


def ell_form(cols: torch.Tensor, vals: torch.Tensor,
             m: int) -> Tuple[int, int, int]:
  """K3a's launch form for contiguous ``cols``/``vals`` (n, k) and an x of
  ``m`` floats: ``(on_chip, vec, group)``.  On chip (:func:`ell_on_chip`,
  fewer than 2^31 rows), ``group`` covers a row's ceil(k / 4) pieces of 4
  entries in one round, loaded 16 bytes at a time (``vec`` 4) where
  k % 4 == 0 and both start on 16 bytes, else 4 bytes at a time (``vec``
  1, the same sum); through L1, ``vec`` 1 and ``group`` covering k.  The
  form fixes each row's sum order, so every band of a matrix takes the
  whole matrix's."""
  n, k = cols.shape
  if not ell_on_chip(m) or n >= 2 ** 31:
    return 0, 1, group_size(k)
  vec = 4 if (k % 4 == 0 and cols.data_ptr() % 16 == 0
              and vals.data_ptr() % 16 == 0) else 1
  return 1, vec, group_size(-(-k // 4))


def _launch_bands(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
                  y: torch.Tensor, bands: List[Tuple[int, int]]) -> int:
  """K3a over contiguous int32 ``cols``, float32 ``vals`` (n, k) and ``x``,
  writing float32 ``y`` (n,): one launch (one ctypes call) for every
  ``MAX_BANDS`` of ``bands``, each row in the whole matrix's form
  (:func:`ell_form`; the through-L1 form counted in
  ``ell_through_l1_launches``, the on-chip form's 4-byte loads in
  ``ell_4byte_launches``).  Returns the launches."""
  k, m = cols.shape[1], x.shape[0]
  on_chip, vec, group = ell_form(cols, vals, m)
  if on_chip and x.data_ptr() % 16:
    x = x.clone()  # the bulk copy reads x from a 16-byte boundary
  table = band_table(cols, vals, y, bands)
  for lo in range(0, len(table), MAX_BANDS):
    chunk = table[lo:lo + MAX_BANDS]
    flat = (ctypes.c_int64 * (4 * len(chunk)))(*(v for b in chunk for v in b))
    build.launch("spmv_ell", x.device, ctypes.addressof(flat), len(chunk),
                 x.data_ptr(), m, k, group, vec, on_chip)
  launches = -(-len(table) // MAX_BANDS)
  if not on_chip:
    counts["ell_through_l1_launches"] += launches
  elif vec == 1:
    counts["ell_4byte_launches"] += launches
  return launches


def rb_per_of(n: int, n_shards: int) -> int:
  """Row blocks of ``_WIN`` rows a shard (the reference's ``rb_per_of``)."""
  return ShardedWindowedELL.rows_per_of(n, n_shards) // _WIN


class ShardedCSR:
  """A matrix cut into row bands, one a shard (the port's form of the
  reference's sharded windowed packs).  Shard d owns rows
  ``[min(d·rows_per, n), min((d+1)·rows_per, n))``, ``rows_per =
  block_rows·ceil(ceil(n / block_rows) / n_shards)``: whole row blocks of
  the reference's pack.  Its band is ``(indptr, indices, data)``, where
  ``indices`` and ``data`` are views of the matrix's device CSR form and
  ``indptr`` is the band's own, rebased to 0.  Shards past the last row
  hold empty bands."""

  __slots__ = ("bands", "shape", "n_shards", "rows_per", "nnz")
  block_rows = 1

  def __init__(self, bands, shape: Tuple[int, int]):
    self.bands = [tuple(b) for b in bands]
    self.shape = (int(shape[0]), int(shape[1]))
    self.n_shards = len(self.bands)
    self.rows_per = self.rows_per_of(self.shape[0], self.n_shards)
    self.nnz = sum(int(b[1].shape[0]) for b in self.bands)

  @classmethod
  def rows_per_of(cls, n: int, n_shards: int) -> int:
    n_blocks = max(-(-n // cls.block_rows), 1)
    return -(-n_blocks // n_shards) * cls.block_rows

  @classmethod
  def pack(cls, sp_csr, n_shards: int):
    """The bands of a ``SparseArray`` (over its memoized CSR form) or of a
    scipy matrix (uploaded to the mesh's device)."""
    indptr, indices, data, shape = _device_csr(sp_csr)
    return cls(row_bands(indptr, indices, data, shape[0], n_shards,
                         cls.rows_per_of(shape[0], n_shards)), shape)

  @classmethod
  def from_tensors(cls, tensors, shape, n_shards: int):
    """Rebuild a pack from :meth:`tensors` (an expression's operands)."""
    it = iter(tensors)
    bands = list(zip(it, it, it))
    if len(bands) != n_shards:
      raise ValueError(f"{len(bands)} bands for {n_shards} shards")
    return cls(bands, shape)

  def rows(self, d: int) -> Tuple[int, int]:
    n = self.shape[0]
    r0 = min(d * self.rows_per, n)
    return r0, min(r0 + self.rows_per, n)

  @property
  def group(self) -> int:
    """The whole matrix's lane group, the one unsharded K3b takes."""
    return group_size(self.nnz / self.shape[0]) if self.shape[0] else 1

  def tensors(self) -> list:
    """The bands' tensors, shard by shard, as a flat list."""
    return [t for band in self.bands for t in band]

  def __repr__(self):
    return (f"{type(self).__name__}(shape={self.shape}, nnz={self.nnz}, "
            f"n_shards={self.n_shards}, rows_per={self.rows_per})")


class ShardedWindowedELL(ShardedCSR):
  """:func:`pack_windowed_sharded`'s pack: row bands of
  ``rb_per_of(n, p)·1024`` rows (named after the reference's pack,
  ``spmv_pallas.py:819``)."""

  __slots__ = ()
  block_rows = _WIN


def row_bands(indptr: torch.Tensor, indices: torch.Tensor, data: torch.Tensor,
              n: int, n_shards: int, rows_per: int):
  """Each shard's CSR band of the rows ``[d·rows_per, (d+1)·rows_per)``
  (clipped to n): views of ``indices``/``data`` and a rebased ``indptr``.
  One copy of the p + 1 band boundaries to the host."""
  starts = [min(d * rows_per, n) for d in range(n_shards + 1)]
  offsets = indptr[torch.tensor(starts, device=indptr.device)].tolist()
  bands = []
  for d in range(n_shards):
    r0, r1 = starts[d], starts[d + 1]
    lo, hi = offsets[d], offsets[d + 1]
    bands.append((indptr[r0:r1 + 1] - lo, indices[lo:hi], data[lo:hi]))
  return bands


def pack_windowed_sharded(sp_csr, n_shards: int) -> ShardedWindowedELL:
  """Row-shard the windowed pack (reference ``spmv_pallas.py:844``): shard
  d owns rows ``[d·rows_per, (d+1)·rows_per)``, ``rows_per =
  rb_per_of(n, n_shards)·1024``, as CSR bands over the matrix's device CSR
  form (a ``SparseArray``'s memoized one, or a scipy matrix's upload)."""
  return ShardedWindowedELL.pack(sp_csr, n_shards)


def sharded_windowed_spmv_traced(packed: ShardedWindowedELL, x: torch.Tensor,
                                 mesh) -> torch.Tensor:
  """``y = A @ x`` over a sharded pack on a mesh of as many shards: K3b's
  rows on each non-empty shard's band, each writing its rows of one
  float32 ``y`` with the whole matrix's lane group; x is read by every
  shard.  Returns y (n,) in ``x.dtype``.  CUDA tensors launch the bands
  at once, one launch for every ``MAX_BANDS`` of them (counted in
  ``sharded_csr_launches``, the bands in ``sharded_csr_bands``); CPU
  tensors run :func:`spmv_csr_plain` a band."""
  if packed.n_shards != mesh.size:
    raise ValueError(f"the pack has {packed.n_shards} shards, the mesh "
                     f"{mesh.size}")
  if x.dim() != 1 or x.shape[0] != packed.shape[1]:
    raise ValueError(f"x has shape {tuple(x.shape)}; the packed matrix has "
                     f"shape {packed.shape}")
  _check_float("x", x)
  _check_float("data", packed.bands[0][2])
  build.check_operands("spmv.sharded_windowed_spmv_traced", x,
                       *packed.tensors())
  y = torch.empty(packed.shape[0], dtype=torch.float32, device=x.device)
  xf = x.float().contiguous()
  bands = csr_bands(packed, y)
  if x.device.type != "cuda":
    for indptr, indices, data, y_rows in bands:
      y_rows[:] = spmv_csr_plain(indptr, indices, data, xf)
      counts["sharded_csr_plain_runs"] += 1
  elif bands:
    counts["sharded_csr_launches"] += _launch_csr_bands(bands, xf,
                                                        packed.group)
    counts["sharded_csr_bands"] += len(bands)
  return y.to(x.dtype)


def csr_bands(packed: ShardedCSR, y: torch.Tensor):
  """The non-empty shards' bands of a sharded pack as K3b's launch table
  takes them (:func:`csr_band_table`): contiguous ``indptr`` and
  ``indices``, float32 ``data`` and the band's rows of ``y``."""
  bands = []
  for d, (indptr, indices, data) in enumerate(packed.bands):
    r0, r1 = packed.rows(d)
    if r1 > r0:
      bands.append((indptr.contiguous(), indices.contiguous(),
                    data.float().contiguous(), y[r0:r1]))
  return bands


def unshard_windowed(packed: ShardedCSR):
  """``(indptr, indices, data, n_pad)``: the bands flattened back into one
  CSR form of ``n_pad = n_shards·rows_per`` rows (rows past n empty), for
  a node built under another mesh size (reference
  ``spmv_pallas.py:967``)."""
  indptrs, offset = [], 0
  for d, (indptr, indices, _) in enumerate(packed.bands):
    indptrs.append((indptr if d == 0 else indptr[1:]) + offset)
    offset += int(indices.shape[0])
  indptr = torch.cat(indptrs)
  n_pad = packed.n_shards * packed.rows_per
  tail = indptr.new_full((n_pad + 1 - indptr.shape[0],), offset)
  indices = torch.cat([b[1] for b in packed.bands])
  data = torch.cat([b[2] for b in packed.bands])
  return torch.cat([indptr, tail]), indices, data, n_pad
