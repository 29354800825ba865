"""Sparse matrices, SpMV and SpMM (port of ``spartan_tpu/backend/sparse.py``).

Two device layouts, as in the reference:

* **padded ELL** (:class:`SparseArray`): ``cols`` int32 and ``vals`` as
  ``(rows, max_nnz)`` tensors on the mesh's device; pad entries point at
  column 0 with value 0.  SpMV over it is kernel K3a's counterpart,
  :func:`~spartan_tpu_torch.backend.kernels.spmv.spmv_ell`.  For wide
  matrices and for SpMM the array also keeps a memoized device CSR form
  (:meth:`SparseArray.to_csr`), read by K3b's counterpart
  :func:`~spartan_tpu_torch.backend.kernels.spmv.spmv_csr` and K5a's
  :func:`~spartan_tpu_torch.backend.kernels.spmm.spmm_csr`; it takes the
  place of the reference's host-packed windowed forms, which exist for the
  TPU's gather limits.  Conversions (``to_scipy``, ``transpose``,
  ``canonicalize``) sort and merge the stored entries on the device and copy
  only the nonzeros to the host; the scipy-style elementwise surface runs on
  the ELL tensors.
* **block-ELL** (:class:`BlockSparseArray`): block-structured matrices as
  batched ``bs x bs`` block products (``torch.einsum``, as the reference left
  them to XLA's einsum).

Routing follows the reference, in one function per product that the eager
entry point and the lazy node share: ``_route`` for SpMV (``spmv``,
:class:`SpMVExpr`) and ``_spmm_route`` for SpMM (``spmm``,
:class:`SpMMExpr`).  Block structure first, then the densified route, then
the kernels: for SpMV the ELL kernel for vectors up to ``ONEHOT_MAX_M``
entries and the CSR kernel beyond, for SpMM the CSR SpMM kernel for up to
512 columns; float64 matrices on the plain gather.  "On the accelerator"
means the tensors lie on a CUDA device.

On a mesh of p > 1 shards (``core/mesh.py``) the kernel routes are
owner-computed, as the reference's are: the CSR kernel routes become
``"winsh"`` (K3d, :meth:`SparseArray.to_windowed_sharded`) and
``"winmmsh"`` (K5b, :meth:`SparseArray.to_windowed_spmm_sharded`), one
launch a shard on its row band, and the ELL kernel route launches K3a
once on each of p near-equal row bands of the ELL (``sharded_onehot_spmv``;
nothing is padded or copied).  A node built for another number of shards
than the mesh has when it runs flattens its bands back and runs the
unsharded kernel.  The block and densified routes stay unsharded: they run
no hand kernel and give the same result.  The thresholds are the reference's
(measured on a TPU v5e) and wait to be re-measured on the H100.  A CUDA
tensor that reaches a kernel route launches the kernel or raises: there is
no fallback.
"""

from __future__ import annotations

import os
import weakref
from typing import Optional, Tuple

import numpy as np
import torch

from spartan_tpu_torch.backend.kernels import spmm as K5
from spartan_tpu_torch.backend.kernels import spmv as K
from spartan_tpu_torch.config import FLAGS
from spartan_tpu_torch.core.array import (SpartanArray, to_numpy_dtype,
                                          to_torch_dtype)
from spartan_tpu_torch.core.mesh import get_mesh
from spartan_tpu_torch.expr.base import EmitCtx, Expr, Val, lazify
from spartan_tpu_torch.expr.dot import _PRECISIONS, _resolve_precision
from spartan_tpu_torch.expr.map import result_type
from spartan_tpu_torch.util import log_info

# Widest x the ELL kernel route takes; past it SpMV takes the CSR kernel
# (the reference's one-hot/windowed crossover on a v5e, sparse.py:763).
ONEHOT_MAX_M = 32768
_KERNEL_FLOATS = (torch.float32, torch.bfloat16, torch.float16)


def spmv_kernel_dtype(dtype: torch.dtype) -> bool:
  """Whether the SpMV kernels take a matrix of ``dtype``: float32 and the
  16-bit floats (float64 stays on the exact routes)."""
  return dtype in _KERNEL_FLOATS


def _host(t: torch.Tensor) -> np.ndarray:
  """A tensor as numpy on the host (bfloat16, which numpy lacks, as
  float32)."""
  t = t.detach()
  if t.dtype == torch.bfloat16:
    t = t.float()
  return t.cpu().numpy()


def _from_host(arr: np.ndarray, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
  """A copy of host data on ``device`` as ``dtype``."""
  host_dtype = np.float32 if dtype == torch.bfloat16 else to_numpy_dtype(dtype)
  arr = np.ascontiguousarray(arr, host_dtype)
  if not arr.flags.writeable:
    arr = arr.copy()
  return torch.from_numpy(arr).to(device, copy=True).to(dtype)


def _upload(arr, device: torch.device) -> torch.Tensor:
  """Host data on ``device`` with its own dtype (an ``ml_dtypes`` bfloat16
  array, which torch cannot read, as bfloat16)."""
  host = np.asarray(arr)
  if host.dtype.name == "bfloat16":
    return _from_host(host.astype(np.float32), torch.bfloat16, device)
  return _from_host(host, to_torch_dtype(host.dtype), device)


def _row_ids(cols: torch.Tensor) -> torch.Tensor:
  """Each ELL entry's row, as an int64 view shaped like ``cols``."""
  n, k = cols.shape
  return torch.arange(n, device=cols.device).unsqueeze(1).expand(n, k)


def _indptr(rows: torch.Tensor, n: int) -> torch.Tensor:
  """The int64 CSR row pointer of entries sorted by row."""
  indptr = torch.zeros(n + 1, dtype=torch.int64, device=rows.device)
  indptr[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
  return indptr


class SparseArray:
  """A 2-D sparse matrix in padded-ELL device layout."""

  __slots__ = ("cols", "vals", "shape", "nnz", "fmt", "_bsr_cache",
               "_csr_cache", "_t_cache", "_dense_cache", "_winsh_cache",
               "_winmmsh_cache", "__weakref__")

  # numpy must defer binary ops to our reflected operators (otherwise
  # ``dense + sparse`` broadcasts elementwise); scipy.sparse sets the same
  __array_ufunc__ = None

  def __init__(self, cols: torch.Tensor, vals: torch.Tensor,
               shape: Tuple[int, int], nnz: int):
    self.cols = cols    # (rows, max_nnz) int32
    self.vals = vals    # (rows, max_nnz)
    self.shape = tuple(int(s) for s in shape)
    self.nnz = int(nnz)
    # declared-intent format tag (scipy ``.format``); the device layout is
    # always padded ELL
    self.fmt = "csr"
    self._bsr_cache = None    # (bs, BlockSparseArray | None), auto_route
    self._csr_cache = None    # (indptr, indices, data), to_csr
    self._t_cache = None      # memoized transpose (weak in a transpose)
    self._dense_cache = None  # memoized float32 densified form
    self._winsh_cache = None    # (n_shards, ShardedWindowedELL)
    self._winmmsh_cache = None  # (n_shards, ShardedWindowedSpMM)

  @property
  def dtype(self) -> torch.dtype:
    return self.vals.dtype

  @property
  def format(self) -> str:
    return self.fmt

  @property
  def max_nnz_per_row(self) -> int:
    return int(self.cols.shape[1])

  @property
  def density(self) -> float:
    return self.nnz / (self.shape[0] * self.shape[1])

  def dense_tensor(self) -> torch.Tensor:
    """The dense matrix on the array's device, duplicates summed."""
    out = torch.zeros(self.shape, dtype=self.vals.dtype,
                      device=self.vals.device)
    return out.index_put_((_row_ids(self.cols).reshape(-1),
                           self.cols.reshape(-1).long()),
                          self.vals.reshape(-1), accumulate=True)

  def todense(self) -> np.ndarray:
    return _host(self.dense_tensor())

  toarray = todense

  def _entries(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(row int64, col int32, value) of each stored nonzero, in ELL order,
    on the array's device."""
    rows, slots = (self.vals != 0).nonzero(as_tuple=True)
    return rows, self.cols[rows, slots], self.vals[rows, slots]

  def _canonical(self, transpose: bool = False):
    """(indptr, rows, cols, vals) of the matrix (or its transpose) in
    scipy's canonical CSR order, on the device: the stored nonzeros stably
    sorted by (row, column) with duplicates summed (a zero sum stays
    stored, as scipy keeps it)."""
    rows, cols, vals = self._entries()
    cols = cols.long()
    n, m = self.shape
    if transpose:
      rows, cols, n, m = cols, rows, m, n
    width = max(m, 1)
    key, order = torch.sort(rows * width + cols, stable=True)
    key, inverse = torch.unique_consecutive(key, return_inverse=True)
    vals = torch.zeros(key.shape[0], dtype=vals.dtype,
                       device=vals.device).index_add_(0, inverse, vals[order])
    rows = key // width
    return _indptr(rows, n), rows, key % width, vals

  def to_scipy(self):
    """Export to canonical scipy CSR (stored zeros are dropped: the ELL
    padding is indistinguishable from them).  Sorting and merging run on the
    device; only the nonzeros are copied to the host."""
    import scipy.sparse as ss
    indptr, _, cols, vals = self._canonical()
    return ss.csr_matrix((_host(vals), _host(cols.int()), _host(indptr)),
                         shape=self.shape)

  def to_bsr(self, bs: int = 128, pad: bool = True) -> "BlockSparseArray":
    """Repack into block-ELL; ``pad=True`` zero-pads dims up to a multiple
    of ``bs``."""
    import scipy.sparse as ss
    mat = self.to_scipy().tocsr()
    n, m = mat.shape
    if n % bs or m % bs:
      if not pad:
        raise ValueError(f"shape {mat.shape} not divisible by {bs}; "
                         "pass pad=True")
      mat = ss.csr_matrix((mat.data, mat.indices, mat.indptr), shape=(n, m))
      mat.resize((-(-n // bs) * bs, -(-m // bs) * bs))
    return from_scipy_bsr(mat, bs=bs, dtype=self.vals.dtype,
                          device=self.vals.device)

  def block_stats(self, bs: int = 128) -> Tuple[int, float]:
    """(occupied ``bs x bs`` blocks, storage expansion ``blocks·bs²/nnz``),
    counted on the array's device in one pass over the stored nonzeros."""
    rows, cols, _ = self._entries()
    nbc = -(-self.shape[1] // bs)
    block_ids = (rows // bs) * nbc + cols.long() // bs
    n_blocks = int(torch.unique(block_ids).numel())
    return n_blocks, n_blocks * bs * bs / max(self.nnz, 1)

  def auto_route(self, bs: int = 128) -> Optional["BlockSparseArray"]:
    """The block-ELL repack when it stores at most
    ``FLAGS.sparse_bsr_max_expansion`` elements per nonzero, else None;
    decided once per matrix and block size.  Gated by
    ``FLAGS.sparse_auto_bsr``."""
    if not FLAGS.sparse_auto_bsr or self.nnz == 0:
      return None
    if self._bsr_cache is not None and self._bsr_cache[0] == bs:
      return self._bsr_cache[1]
    _, expansion = self.block_stats(bs)
    routed = None
    if expansion <= FLAGS.sparse_bsr_max_expansion:
      routed = self.to_bsr(bs=bs, pad=True)
    else:
      log_info("sparse: %s has no exploitable %dx%d block structure "
               "(expansion %.1fx > %.1fx limit); staying on the ELL/CSR "
               "kernels", self, bs, bs, expansion,
               FLAGS.sparse_bsr_max_expansion)
    self._bsr_cache = (bs, routed)
    return routed

  def to_csr(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Memoized device CSR form for the CSR kernels: ``indptr`` int64,
    ``indices`` int32, ``data`` float32, built on the array's device from
    the ELL with the stored zeros dropped and row order kept (the entries
    the reference's windowed packs keep, ``to_windowed``)."""
    if self._csr_cache is None:
      rows, cols, vals = self._entries()
      self._csr_cache = (_indptr(rows, self.shape[0]), cols.contiguous(),
                         vals.float().contiguous())
    return self._csr_cache

  def to_windowed_sharded(self, n_shards: int) -> "K.ShardedWindowedELL":
    """The row-sharded pack of the CSR SpMV kernel (K3d), memoized per
    shard count: shard d's CSR band of rows ``[d·rows_per,
    (d+1)·rows_per)``, ``rows_per = rb_per_of(n, n_shards)·1024``, over
    views of :meth:`to_csr`."""
    if self._winsh_cache is None or self._winsh_cache[0] != n_shards:
      self._winsh_cache = (n_shards, K.pack_windowed_sharded(self, n_shards))
    return self._winsh_cache[1]

  def to_windowed_spmm_sharded(self, n_shards: int
                               ) -> "K5.ShardedWindowedSpMM":
    """The row-sharded pack of the CSR SpMM kernel (K5b), memoized per
    shard count: bands of ``rbmm_per_of(n, n_shards)·128`` rows over views
    of :meth:`to_csr`.  The reference's fill gate has no counterpart."""
    if self._winmmsh_cache is None or self._winmmsh_cache[0] != n_shards:
      self._winmmsh_cache = (n_shards,
                             K5.pack_windowed_spmm_sharded(self, n_shards))
    return self._winmmsh_cache[1]

  def to_densified(self) -> torch.Tensor:
    """Memoized float32 dense form, built on the array's device with one
    scatter-add over the ELL (pad entries add 0 to column 0)."""
    if self._dense_cache is None:
      dense = torch.zeros(self.shape, dtype=torch.float32,
                          device=self.vals.device)
      dense.index_put_((_row_ids(self.cols).reshape(-1),
                        self.cols.reshape(-1).long()),
                       self.vals.reshape(-1).float(), accumulate=True)
      self._dense_cache = dense
    return self._dense_cache

  def transpose(self) -> "SparseArray":
    """Transpose on the device, O(nnz): the nonzeros stably sorted by
    (column, row) fill the transposed ELL, with no host round trip;
    memoized, so ``S.T.T is S``.  The transpose holds ``S`` by a weak
    reference: a strong one would make the pair a cycle that only the
    cyclic garbage collector frees, keeping both arrays' device memory
    after the caller drops them."""
    cached = self._t_cache
    if isinstance(cached, weakref.ref):
      cached = cached()
    if cached is None:
      cached = _ell(*self._canonical(transpose=True),
                    (self.shape[1], self.shape[0]))
      cached._t_cache = weakref.ref(self)
      self._t_cache = cached
    return cached

  @property
  def T(self) -> "SparseArray":
    return self.transpose()

  def dot(self, b) -> Expr:
    return sparse_dot(self, b)

  def __matmul__(self, b):
    return sparse_dot(self, b)

  def __rmatmul__(self, a):
    from spartan_tpu_torch.expr.dot import dot as _dot
    return _dot(a, self)

  # -- the scipy.sparse-style surface, on the device over the ELL tensors.
  # Pad entries are (col 0, val 0), so a map over ``vals`` that keeps 0 at 0
  # is safe; a product or quotient re-zeroes the pads (``_masked``).  Dense
  # results are tensors on the array's device.

  def _like(self, vals: torch.Tensor, nnz: Optional[int] = None
            ) -> "SparseArray":
    return SparseArray(self.cols, vals, self.shape,
                       self.nnz if nnz is None else nnz)

  def _col_sums(self, vals: torch.Tensor) -> torch.Tensor:
    """Σ over rows of ``vals`` (shaped like the ELL) by column: one
    scatter-add over the ELL."""
    return torch.zeros(self.shape[1], dtype=vals.dtype,
                       device=vals.device).index_add_(
                           0, self.cols.reshape(-1), vals.reshape(-1))

  def sum(self, axis=None) -> torch.Tensor:
    """Dense-semantics sum (scipy's contract): (n,) for axis 1, (m,) for
    axis 0, a 0-d tensor for None."""
    if axis in (1, -1):
      return self.vals.sum(1)
    if axis == 0:
      return self._col_sums(self.vals)
    if axis is None:
      return self.vals.sum()
    raise ValueError(f"axis {axis!r} out of range for 2-D sparse")

  def mean(self, axis=None) -> torch.Tensor:
    """scipy's semantics: divide by the full dense extent, not by nnz."""
    s = self.sum(axis)  # validates axis
    n, m = self.shape
    denom = {None: n * m, 0: n, 1: m, -1: m}[axis]
    return s.to(torch.promote_types(s.dtype, torch.float32)) / denom

  def getnnz(self, axis=None):
    """Stored-nonzero counts: ``nnz`` for None (explicit zeros given at
    ingest included), else per row (int64) or per column (int32)."""
    if axis is None:
      return self.nnz
    present = self.vals != 0
    if axis in (1, -1):
      return present.sum(1)
    if axis == 0:
      return self._col_sums(present.int())
    raise ValueError(f"axis {axis!r} out of range for 2-D sparse")

  count_nonzero = getnnz

  def diagonal(self, k: int = 0) -> torch.Tensor:
    """The k-th diagonal as a dense tensor (scipy's ``.diagonal``)."""
    n, m = self.shape
    length = min(n + min(k, 0), m - max(k, 0))
    if length <= 0:
      return torch.zeros(0, dtype=self.dtype, device=self.vals.device)
    rows = torch.arange(length, device=self.vals.device) - min(k, 0)
    cols, vals = self.cols[rows], self.vals[rows]
    hit = (cols == (rows + k)[:, None]) & (vals != 0)
    return torch.where(hit, vals, 0).sum(1)

  def _masked(self, product: torch.Tensor) -> "SparseArray":
    """Re-zero pad entries: a pad (val 0) times a gathered NaN/Inf would
    otherwise break the 0-pad invariant (0·inf = nan)."""
    return self._like(torch.where(self.vals != 0, product, 0))

  def multiply(self, other) -> "SparseArray":
    """Elementwise product.  Scalar or dense (same shape, a row (1, m) or
    (m,), or a column (n, 1)): on the device over the ELL, the dense
    operand gathered at the stored coordinates; sparse × sparse: scipy's
    intersection on the host, O(nnz)."""
    if isinstance(other, SparseArray):
      return _from_csr(self.to_scipy().multiply(other.to_scipy()).tocsr(),
                       None, self.vals.device)
    if np.ndim(other) == 0:
      return self._masked(self.vals * other)
    o = _dense(other, self.vals.device)
    n, m = self.shape
    if tuple(o.shape) == self.shape:
      return self._masked(self.vals * o[_row_ids(self.cols),
                                        self.cols.long()])
    if tuple(o.shape) in ((1, m), (m,)):
      return self._masked(self.vals * o.reshape(-1)[self.cols.long()])
    if tuple(o.shape) == (n, 1):
      return self._masked(self.vals * o)
    raise ValueError(f"inconsistent shapes {self.shape} vs {tuple(o.shape)}")

  def astype(self, dtype) -> "SparseArray":
    return self._like(self.vals.to(to_torch_dtype(dtype)))

  def copy(self) -> "SparseArray":
    """A copy with its own buffers (torch tensors are mutable) and fresh
    caches."""
    return SparseArray(self.cols.clone(), self.vals.clone(), self.shape,
                       self.nnz)

  def power(self, p) -> "SparseArray":
    """Elementwise power of the stored entries (scipy's ``.power``; p > 0
    keeps the pads at 0)."""
    if p <= 0:
      raise ValueError("power(p) needs p > 0 to stay sparse")
    return self._like(torch.where(self.vals != 0, self.vals, 0) ** p)

  def sqrt(self) -> "SparseArray":
    return self._like(torch.sqrt(self.vals))

  def __abs__(self) -> "SparseArray":
    return self._like(torch.abs(self.vals))

  def __neg__(self) -> "SparseArray":
    return self._like(-self.vals)

  def __mul__(self, s):
    return self.multiply(s)

  __rmul__ = __mul__

  def __truediv__(self, s):
    if np.ndim(s) != 0:
      raise TypeError("sparse division only supports scalars")
    return self._masked(self.vals / s)

  def __add__(self, other):
    """Sparse + sparse: the ELLs side by side on the device (duplicate
    coordinates are legal and sum under every product and ``todense``;
    ``canonicalize()`` merges them).  Sparse + dense: a dense tensor, by
    one scatter-add (scipy's densifying contract)."""
    if isinstance(other, SparseArray):
      if other.shape != self.shape:
        raise ValueError(f"shape mismatch {self.shape} vs {other.shape}")
      dt = torch.promote_types(self.dtype, other.dtype)
      return SparseArray(torch.cat([self.cols, other.cols], 1),
                         torch.cat([self.vals.to(dt), other.vals.to(dt)], 1),
                         self.shape, self.nnz + other.nnz)
    if np.ndim(other) == 0:
      if other == 0:
        return self.copy()
      raise NotImplementedError(
          "adding a nonzero scalar to a sparse matrix would densify it "
          "(scipy's contract); use A.todense() + s explicitly")
    o = _dense(other, self.vals.device)
    if tuple(o.shape) != self.shape:
      raise ValueError(f"shape mismatch {self.shape} vs {tuple(o.shape)}")
    out = o.to(torch.promote_types(o.dtype, self.dtype), copy=True)
    return out.index_put_((_row_ids(self.cols).reshape(-1),
                           self.cols.reshape(-1).long()),
                          self.vals.reshape(-1).to(out.dtype),
                          accumulate=True)

  __radd__ = __add__

  def __sub__(self, other):
    if isinstance(other, SparseArray):
      return self + (-other)
    if np.ndim(other) == 0:
      return self + (-other if other else 0)
    return self + (-_dense(other, self.vals.device))

  def __rsub__(self, other):
    return (-self) + other

  def canonicalize(self) -> "SparseArray":
    """Merge duplicate coordinates and re-pack at minimal ELL width, on the
    device."""
    return _ell(*self._canonical(), self.shape)

  def tocsr(self):
    return self.to_scipy()

  def tocoo(self):
    return self.to_scipy().tocoo()

  def __repr__(self):
    return (f"SparseArray(shape={self.shape}, nnz={self.nnz}, "
            f"max_nnz/row={self.max_nnz_per_row}, dtype={self.dtype})")


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------

def _ell(indptr: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
         vals: torch.Tensor, shape: Tuple[int, int]) -> SparseArray:
  """Padded ELL filled on the entries' device from CSR entries in row
  order (``rows`` is each entry's row, ``indptr`` their row pointer)."""
  n = shape[0]
  nnz = int(rows.shape[0])
  k = max(int((indptr[1:] - indptr[:-1]).max()) if n else 0, 1)
  ell_cols = torch.zeros((n, k), dtype=torch.int32, device=vals.device)
  ell_vals = torch.zeros((n, k), dtype=vals.dtype, device=vals.device)
  if nnz:
    pos = torch.arange(nnz, device=vals.device) - indptr[rows]
    ell_cols[rows, pos] = cols.int()
    ell_vals[rows, pos] = vals
  return SparseArray(ell_cols, ell_vals, shape, nnz)


def _from_csr(csr, dtype, device: torch.device) -> SparseArray:
  """Padded ELL from a canonical scipy CSR matrix, filled on ``device``."""
  n = csr.shape[0]
  indptr = torch.from_numpy(csr.indptr.astype(np.int64)).to(device)
  rows = torch.repeat_interleave(torch.arange(n, device=device),
                                 indptr[1:] - indptr[:-1],
                                 output_size=int(csr.nnz))
  dt = to_torch_dtype(dtype if dtype is not None else csr.dtype)
  return _ell(indptr, rows,
              torch.from_numpy(csr.indices.astype(np.int32)).to(device),
              _from_host(csr.data, dt, device), csr.shape)


def from_scipy(mat, dtype=None) -> SparseArray:
  """Build from any scipy.sparse matrix (CSR canonicalized) on the mesh's
  device."""
  import scipy.sparse as ss
  csr = ss.csr_matrix(mat)
  csr.sum_duplicates()
  return _from_csr(csr, dtype, get_mesh().device)


def from_coo(rows, cols, vals, shape) -> SparseArray:
  import scipy.sparse as ss
  return from_scipy(ss.coo_matrix((vals, (rows, cols)), shape=shape))


def from_dense(arr, threshold: float = 0.0) -> SparseArray:
  import scipy.sparse as ss
  a = np.asarray(arr)
  return from_scipy(ss.csr_matrix(np.where(np.abs(a) > threshold, a, 0)))


def sprandn(n: int, m: int, density: float = 0.01,
            seed: int = 0) -> SparseArray:
  """Random sparse normal matrix (the reference's numpy stream, so both
  packages draw the same matrix from a seed)."""
  rng = np.random.default_rng(seed)
  nnz = int(n * m * density)
  rows = rng.integers(0, n, nnz)
  cols = rng.integers(0, m, nnz)
  vals = rng.standard_normal(nnz)
  return from_coo(rows, cols, vals, (n, m))


sparse_rand = sprandn  # reference-name alias


def merge_csr(a, b):
  """Additive merge of two scipy CSR matrices (the reference's sparse
  scatter-merge combiner): scipy's ``(a + b).tocsr()``, the reference's own
  path when its C extension is absent."""
  import scipy.sparse as ss
  a = ss.csr_matrix(a)
  b = ss.csr_matrix(b)
  if a.shape != b.shape:
    raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
  return (a + b).tocsr()


def sparse_diagonal(v, shape: Optional[Tuple[int, int]] = None) -> SparseArray:
  """Diagonal sparse matrix from a vector."""
  v = np.asarray(v)
  n = v.shape[0]
  idx = np.arange(n)
  return from_coo(idx, idx, v, shape or (n, n))


def save_sparse(A, path: str) -> None:
  """Persist a SparseArray or BlockSparseArray in the reference's layout:
  ``sparse.npz`` (the ELL tensors) with the block-ELL repack that
  ``auto_route`` built, if any, under ``bsr_cache/``; ``bsr.npz`` for a
  BlockSparseArray.  bfloat16 values are saved as float32.  The reference's
  windowed TPU packs (``windowed.npz``, ``winsh.npz``) are not written."""
  os.makedirs(path, exist_ok=True)
  if isinstance(A, BlockSparseArray):
    np.savez(os.path.join(path, "bsr.npz"),
             block_cols=_host(A.block_cols), block_vals=_host(A.block_vals),
             shape=np.asarray(A.shape), bs=np.asarray(A.bs),
             nnz_blocks=np.asarray(A.nnz_blocks))
    return
  np.savez(os.path.join(path, "sparse.npz"), cols=_host(A.cols),
           vals=_host(A.vals), shape=np.asarray(A.shape),
           nnz=np.asarray(A.nnz))
  if A._bsr_cache is not None and A._bsr_cache[1] is not None:
    save_sparse(A._bsr_cache[1], os.path.join(path, "bsr_cache"))


def load_sparse(path: str):
  """Load what :func:`save_sparse` of either package wrote, onto the mesh's
  device: a SparseArray with its block-ELL repack restored, or a bare
  BlockSparseArray.  The reference's windowed packs (``windowed.npz``,
  ``winsh.npz``), when found, are ignored: the port's kernels read the CSR
  form that ``SparseArray.to_csr`` builds on the device."""
  device = get_mesh().device
  bsr_path = os.path.join(path, "bsr.npz")
  if os.path.exists(bsr_path) and not os.path.exists(
      os.path.join(path, "sparse.npz")):
    z = np.load(bsr_path)
    return BlockSparseArray(_upload(z["block_cols"], device),
                            _upload(z["block_vals"], device),
                            tuple(int(s) for s in z["shape"]), int(z["bs"]),
                            int(z["nnz_blocks"]))
  z = np.load(os.path.join(path, "sparse.npz"))
  A = SparseArray(_upload(z["cols"], device), _upload(z["vals"], device),
                  tuple(int(s) for s in z["shape"]), int(z["nnz"]))
  cache = os.path.join(path, "bsr_cache")
  if os.path.exists(os.path.join(cache, "bsr.npz")):
    routed = load_sparse(cache)
    A._bsr_cache = (routed.bs, routed)
  return A


# ---------------------------------------------------------------------------
# Block-sparse (block-ELL)
# ---------------------------------------------------------------------------

class BlockSparseArray:
  """Block-ELL: a grid of ``bs x bs`` blocks, each block-row storing up to
  ``max_blocks`` blocks (padding blocks are all zero at block column 0)."""

  __slots__ = ("block_cols", "block_vals", "shape", "bs", "nnz_blocks")

  def __init__(self, block_cols: torch.Tensor, block_vals: torch.Tensor,
               shape: Tuple[int, int], bs: int, nnz_blocks: int):
    self.block_cols = block_cols   # (nbr, max_blocks) int32
    self.block_vals = block_vals   # (nbr, max_blocks, bs, bs)
    self.shape = tuple(int(s) for s in shape)
    self.bs = int(bs)
    self.nnz_blocks = int(nnz_blocks)

  @property
  def dtype(self) -> torch.dtype:
    return self.block_vals.dtype

  def todense(self) -> np.ndarray:
    bs = self.bs
    bc = _host(self.block_cols)
    bv = _host(self.block_vals)
    out = np.zeros(self.shape, dtype=bv.dtype)
    for r in range(bc.shape[0]):
      for j in range(bc.shape[1]):
        c = int(bc[r, j])
        out[r * bs:(r + 1) * bs, c * bs:(c + 1) * bs] += bv[r, j]
    return out

  toarray = todense

  def __repr__(self):
    return (f"BlockSparseArray(shape={self.shape}, bs={self.bs}, "
            f"nnz_blocks={self.nnz_blocks}, "
            f"max_blocks/row={self.block_cols.shape[1]})")


def from_scipy_bsr(mat, bs: int = 128, dtype=None,
                   device: Optional[torch.device] = None) -> BlockSparseArray:
  """Build block-ELL from any scipy matrix (dims must divide by ``bs``) on
  ``device`` (default: the mesh's)."""
  import scipy.sparse as ss
  bsr = ss.bsr_matrix(ss.csr_matrix(mat), blocksize=(bs, bs))
  n, m = bsr.shape
  if n % bs or m % bs:
    raise ValueError(f"shape {bsr.shape} not divisible by block size {bs}")
  device = device if device is not None else get_mesh().device
  dt = to_torch_dtype(dtype if dtype is not None else bsr.dtype)
  nbr = n // bs
  counts = np.diff(bsr.indptr)
  max_blocks = max(int(counts.max()) if nbr else 0, 1)
  bc = np.zeros((nbr, max_blocks), dtype=np.int32)
  bv = np.zeros((nbr, max_blocks, bs, bs), dtype=bsr.dtype)
  nb = int(bsr.indptr[-1])
  if nb:
    row_idx = np.repeat(np.arange(nbr), counts)
    pos = np.arange(nb) - np.repeat(bsr.indptr[:-1], counts)
    bc[row_idx, pos] = bsr.indices
    bv[row_idx, pos] = bsr.data
  return BlockSparseArray(torch.from_numpy(bc).to(device),
                          _from_host(bv, dt, device), (n, m), bs, nb)


def _bsr_product(block_cols: torch.Tensor, block_vals: torch.Tensor,
                 X: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
  """Batched block products ``A @ X`` (X a vector or a matrix) in ``dt``,
  accumulated in float32 (float64 for a float64 ``dt``)."""
  nbr, mb, bs, _ = block_vals.shape
  acc = torch.float64 if dt == torch.float64 else torch.float32
  X2 = X.to(dt).reshape(X.shape[0], -1)
  k = X2.shape[1]
  gathered = X2.reshape(-1, bs, k).index_select(
      0, block_cols.reshape(-1)).reshape(nbr, mb, bs, k)
  y = torch.einsum("rmij,rmjk->rik", block_vals.to(dt).to(acc),
                   gathered.to(acc))
  return y.reshape(nbr * bs, *X.shape[1:]).to(dt)


def bsr_spmv(A: BlockSparseArray, x) -> torch.Tensor:
  """y = A @ x over block-ELL, in A's dtype."""
  xj = _dense(x, A.block_vals.device, A.dtype)
  if xj.shape[0] != A.shape[1]:
    raise ValueError(f"bsr_spmv dim mismatch: A is {A.shape}, x has "
                     f"{xj.shape[0]} rows")
  return _bsr_product(A.block_cols, A.block_vals, xj, A.block_vals.dtype)


def bsr_spmm(A: BlockSparseArray, B) -> torch.Tensor:
  """Y = A @ B over block-ELL: batched block matmuls in B's dtype."""
  Bj = _dense(B, A.block_vals.device)
  _check_rhs("bsr_spmm", A, Bj.shape)
  return _bsr_product(A.block_cols, A.block_vals, Bj, Bj.dtype)


# ---------------------------------------------------------------------------
# Routing shared by SpMV and SpMM
# ---------------------------------------------------------------------------

def _dense(x, device: torch.device,
           a_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
  """``x`` as a tensor on ``device``: an expr is evaluated; a tensor keeps
  its dtype, and so does host data, unless ``a_dtype`` is given (SpMV's
  vector): then it takes NumPy's promotion with the matrix's dtype."""
  if isinstance(x, Expr):
    x = x.evaluate()
  if isinstance(x, SpartanArray):
    x = x.data
  if isinstance(x, torch.Tensor):
    return x.to(device)
  arr = np.asarray(x)
  dt = to_torch_dtype(arr.dtype)
  if a_dtype is not None:
    dt = result_type(a_dtype, dt)
  return _from_host(arr, dt, device)


def _dense_routable(A, spmv: bool = False) -> bool:
  """Should SpMM (or SpMV, with its higher density bar) densify ``A`` and
  multiply with ``torch.matmul``?  True on a CUDA device when density and
  the float32 memory budget allow (``--sparse_dense_min_density[_spmv]``,
  ``--sparse_dense_max_bytes``), or under ``--sparse_force_dense``.
  float64 stays sparse."""
  if (not FLAGS.sparse_dense_route or not isinstance(A, SparseArray)
      or A.dtype == torch.float64):
    return False
  if FLAGS.sparse_force_dense:
    return True
  n, m = A.shape
  min_density = (FLAGS.sparse_dense_min_density_spmv if spmv
                 else FLAGS.sparse_dense_min_density)
  return (A.cols.device.type == "cuda"
          and A.nnz >= min_density * n * m
          and 4 * n * m <= FLAGS.sparse_dense_max_bytes)


def _kernels_on(on_accel: bool, use_kernels: Optional[bool] = None,
                spmm: bool = False) -> bool:
  """May SpMV launch K3a/K3b (or SpMM K5a)?  An explicit ``use_kernels``
  decides; else ``--use_kernels`` on a CUDA device, or a forcing flag of
  that product anywhere (on the CPU the wrappers then run their plain
  versions)."""
  if use_kernels is not None:
    return use_kernels
  forced = (FLAGS.sparse_force_winmm if spmm
            else FLAGS.sparse_force_onehot or FLAGS.sparse_force_windowed)
  return (FLAGS.use_kernels and on_accel) or forced


def _n_shards(fmt: str) -> int:
  """The shards a route's pack holds: the mesh's for the sharded kernel
  routes, else 0."""
  return get_mesh().size if fmt in ("winsh", "winmmsh") else 0


def _operands(fmt: str, A) -> list:
  """The device tensors that route ``fmt`` reads."""
  if fmt == "bsr":
    return [A.block_cols, A.block_vals]
  if fmt == "dense":
    return [A.to_densified()]
  if fmt in ("win", "winmm"):
    return list(A.to_csr())
  if fmt == "winsh":
    return A.to_windowed_sharded(get_mesh().size).tensors()
  if fmt == "winmmsh":
    return A.to_windowed_spmm_sharded(get_mesh().size).tensors()
  return [A.cols, A.vals]


def _check_rhs(name: str, A, shape) -> None:
  """Raise unless an SpMM right operand of ``shape`` is (A.shape[1], k)."""
  if len(shape) != 2:
    raise ValueError(f"{name} needs a 2-D right operand, got shape "
                     f"{tuple(shape)}")
  if shape[0] != A.shape[1]:
    raise ValueError(f"{name} dim mismatch: A is {A.shape}, B has "
                     f"{shape[0]} rows")


# ---------------------------------------------------------------------------
# SpMV
# ---------------------------------------------------------------------------

def _route(A, x_dtype: torch.dtype, on_accel: bool,
           use_kernels: Optional[bool] = None, exact: bool = False):
  """The SpMV route, shared by :func:`spmv` and :class:`SpMVExpr`:
  ``(fmt, matrix)``.  In the reference's order: block structure
  (``"bsr"``, on the accelerator), the densified route (``"dense"``), the
  CSR kernel past ``ONEHOT_MAX_M`` columns or under
  ``--sparse_force_windowed`` (``"win"``, ``"winsh"`` on a mesh of more
  than one shard), else the ELL form (``"ell"``, K3a, sharded or not, or
  the plain gather, decided by :func:`_spmv_apply`).  float64 operands and
  ``exact`` precision stay off the kernels; ``use_kernels=False`` also
  skips the block and dense routes."""
  allowed = use_kernels is not False
  if allowed and on_accel and isinstance(A, SparseArray):
    A = A.auto_route() or A
  if isinstance(A, BlockSparseArray):
    return "bsr", A
  forced = FLAGS.sparse_force_onehot or FLAGS.sparse_force_windowed
  if (allowed and x_dtype != torch.float64 and not forced
      and _dense_routable(A, spmv=True)):
    return "dense", A
  small = ((A.shape[1] <= ONEHOT_MAX_M or FLAGS.sparse_force_onehot)
           and not FLAGS.sparse_force_windowed)
  if (_kernels_on(on_accel, use_kernels) and not exact and not small
      and torch.float64 not in (A.dtype, x_dtype)):
    return ("winsh" if get_mesh().size > 1 else "win"), A
  return "ell", A


def _spmv_ell(cols: torch.Tensor, vals: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
  """Plain gather over the ELL: y[i] = Σ_j vals[i,j] * x[cols[i,j]]."""
  gathered = x.index_select(0, cols.reshape(-1)).reshape(cols.shape)
  return (vals * gathered).sum(1)


def _spmv_apply(fmt: str, mat, x: torch.Tensor, dt: torch.dtype,
                n_rows: int, pad_m: int, kernels: bool,
                n_shards: int = 0) -> torch.Tensor:
  """``y = A @ x`` in ``dt`` over ``_operands(fmt, A)``; ``kernels`` says
  whether the ``"win"``, ``"winsh"`` and ``"ell"`` routes may launch
  K3b/K3d/K3a.  ``n_shards`` is the shards of a ``"winsh"`` pack; on a
  mesh of another size its bands are flattened back and the unsharded
  kernel runs, with the whole matrix's lane group."""
  if fmt == "dense":
    return torch.matmul(mat[0], x.float())[:n_rows].to(dt)
  if fmt == "bsr":
    if x.shape[0] < pad_m:
      x = torch.nn.functional.pad(x, (0, pad_m - x.shape[0]))
    return _bsr_product(mat[0], mat[1], x, dt)[:n_rows]
  if fmt == "win":
    spmv_fn = K.spmv_csr if kernels else K.spmv_csr_plain
    return spmv_fn(*mat, x.float()).to(dt)
  mesh = get_mesh()
  if fmt == "winsh":
    packed = K.ShardedWindowedELL.from_tensors(mat, (n_rows, pad_m), n_shards)
    if kernels and mesh.size == n_shards:
      return K.sharded_windowed_spmv_traced(packed, x.float(), mesh).to(dt)
    indptr, indices, data, _ = K.unshard_windowed(packed)
    if kernels:
      y = K.spmv_csr(indptr, indices, data, x.float(), group=packed.group)
    else:
      y = K.spmv_csr_plain(indptr, indices, data, x.float())
    return y[:n_rows].to(dt)
  cols, vals = mat
  if (kernels and dt in _KERNEL_FLOATS
      and (x.shape[0] <= ONEHOT_MAX_M or FLAGS.sparse_force_onehot)):
    if mesh.size > 1:
      return K.sharded_onehot_spmv(cols, vals.to(dt), x.to(dt), mesh)
    return K.spmv_ell(cols, vals.to(dt), x.to(dt))[:n_rows]
  return _spmv_ell(cols, vals.to(dt), x.to(dt))[:n_rows]


def spmv(A, x, use_kernels: Optional[bool] = None) -> torch.Tensor:
  """y = A @ x for a SparseArray / BlockSparseArray and a dense vector, on
  the matrix's device, by the route :class:`SpMVExpr` takes.
  ``use_kernels=False`` keeps the plain gather (and skips the block and
  dense routes), as the reference's ``use_pallas=False`` does."""
  if isinstance(A, BlockSparseArray):
    return bsr_spmv(A, x)
  xj = _dense(x, A.cols.device, A.dtype)
  if xj.shape[0] != A.shape[1]:
    raise ValueError(f"spmv dim mismatch: A is {A.shape}, x has "
                     f"{xj.shape[0]} rows")
  on_accel = xj.device.type == "cuda"
  fmt, B = _route(A, xj.dtype, on_accel, use_kernels)
  return _spmv_apply(fmt, _operands(fmt, B), xj,
                     result_type(A.dtype, xj.dtype), A.shape[0], B.shape[1],
                     _kernels_on(on_accel, use_kernels), _n_shards(fmt))


class SpMVExpr(Expr):
  """Lazy SpMV over a sparse leaf; composes with the rest of the DAG (the
  PageRank damping map fuses in after it).

  Construction picks the route with :func:`_route` and records it in
  ``fmt`` (a cache-key param): ``"bsr"``, ``"dense"``, ``"win"`` (the CSR
  kernel), ``"winsh"`` (the CSR kernel a shard, ``n_shards`` of them) or
  ``"ell"``."""

  _members = ("inputs",)
  _params = ("n_rows", "fmt", "bs", "pad_m", "n_shards", "precision",
             "src_dtype")

  def __init__(self, A, x, precision=None):
    if precision not in _PRECISIONS:
      raise ValueError(f"precision must be one of {_PRECISIONS}")
    xl = lazify(x)
    # 'high'/'highest' ask for the exact formulations: no kernel routes
    fmt, B = _route(A, xl.dtype, get_mesh().device.type == "cuda",
                    exact=_resolve_precision(precision) is not None)
    super().__init__(inputs=[Val(t) for t in _operands(fmt, B)] + [xl],
                     n_rows=A.shape[0], fmt=fmt,
                     bs=B.bs if fmt == "bsr" else 0, pad_m=B.shape[1],
                     n_shards=_n_shards(fmt), precision=precision,
                     src_dtype=A.dtype)

  def _emit(self, ctx: EmitCtx, deps):
    *mat, x = deps
    dt = result_type(self.src_dtype, x.dtype)
    if ctx.abstract:
      return torch.empty((self.n_rows,), dtype=dt, device="meta")
    kernels = (not ctx.differentiable
               and _resolve_precision(self.precision) is None
               and _kernels_on(x.device.type == "cuda"))
    return _spmv_apply(self.fmt, mat, x, dt, self.n_rows, self.pad_m,
                       kernels, self.n_shards)


def spmv_expr(A, x) -> SpMVExpr:
  return SpMVExpr(A, x)


# ---------------------------------------------------------------------------
# SpMM
# ---------------------------------------------------------------------------

def _spmm_route(A, b_dtype: torch.dtype, k: int, on_accel: bool,
                use_kernels: Optional[bool] = None, exact: bool = False):
  """The SpMM route, shared by :func:`spmm` and :class:`SpMMExpr`:
  ``(fmt, matrix)``.  In the reference's order: block structure (``"bsr"``,
  on the accelerator), the densified route (``"dense"``, not for a float64
  B), the CSR kernel K5a (``"winmm"``: kernels on, not ``exact``, a float B
  of ``k <= 512`` columns, A not float64; a float64 B is cast to float32, as
  the reference's ``SpMMExpr`` does; ``"winmmsh"`` on a mesh of more than
  one shard), else the plain gather over the ELL (``"ell"``).  ``use_kernels=False`` also skips the block and dense
  routes.  The reference's fill gate on its TPU pack has no counterpart:
  the CSR kernel has no pack to pad."""
  allowed = use_kernels is not False
  if allowed and on_accel and isinstance(A, SparseArray):
    A = A.auto_route() or A
  if isinstance(A, BlockSparseArray):
    return "bsr", A
  if allowed and b_dtype != torch.float64 and _dense_routable(A):
    return "dense", A
  if (_kernels_on(on_accel, use_kernels, spmm=True) and not exact
      and b_dtype.is_floating_point and k <= K5.MAX_K
      and A.dtype != torch.float64):
    return ("winmmsh" if get_mesh().size > 1 else "winmm"), A
  return "ell", A


def _spmm_apply(fmt: str, mat, B: torch.Tensor, dt: torch.dtype,
                n_rows: int, pad_m: int, kernels: bool,
                n_shards: int = 0) -> torch.Tensor:
  """``Y = A @ B`` in ``dt`` over ``_operands(fmt, A)``; ``kernels`` says
  whether the ``"winmm"``/``"winmmsh"`` routes launch K5a/K5b or run the
  plain version.  A ``"winmmsh"`` pack of ``n_shards`` on a mesh of another
  size is flattened back and takes the unsharded kernel."""
  if fmt == "dense":
    return torch.matmul(mat[0], B.float())[:n_rows].to(dt)
  if fmt == "bsr":
    if B.shape[0] < pad_m:
      B = torch.nn.functional.pad(B, (0, 0, 0, pad_m - B.shape[0]))
    return _bsr_product(mat[0], mat[1], B, dt)[:n_rows]
  if fmt == "winmm":
    spmm_fn = K5.spmm_csr if kernels else K5.spmm_csr_plain
    return spmm_fn(*mat, B).to(dt)
  if fmt == "winmmsh":
    packed = K5.ShardedWindowedSpMM.from_tensors(mat, (n_rows, pad_m),
                                                 n_shards)
    mesh = get_mesh()
    if kernels and mesh.size == n_shards:
      return K5.sharded_windowed_spmm_traced(packed, B, mesh).to(dt)
    spmm_fn = K5.spmm_csr if kernels else K5.spmm_csr_plain
    return spmm_fn(*K5.unshard_windowed_spmm(packed)[:3], B)[:n_rows].to(dt)
  cols, vals = mat
  gathered = B.to(dt).index_select(0, cols.reshape(-1)).reshape(
      *cols.shape, B.shape[1])
  return torch.einsum("rm,rmk->rk", vals.to(dt), gathered)[:n_rows]


def spmm(A, B, use_kernels: Optional[bool] = None) -> torch.Tensor:
  """Y = A @ B for a SparseArray and a dense (m, k) matrix, on the matrix's
  device, by the route :class:`SpMMExpr` takes, as ``promote(A.dtype,
  B.dtype)``.  ``use_kernels=False`` keeps the plain gather (and skips the
  block and dense routes).  A BlockSparseArray goes to :func:`bsr_spmm`."""
  if isinstance(A, BlockSparseArray):
    return bsr_spmm(A, B)
  Bj = _dense(B, A.cols.device)
  _check_rhs("spmm", A, Bj.shape)
  on_accel = Bj.device.type == "cuda"
  fmt, M = _spmm_route(A, Bj.dtype, Bj.shape[1], on_accel, use_kernels)
  return _spmm_apply(fmt, _operands(fmt, M), Bj,
                     result_type(A.dtype, Bj.dtype), A.shape[0], M.shape[1],
                     _kernels_on(on_accel, use_kernels, spmm=True),
                     _n_shards(fmt))


class SpMMExpr(Expr):
  """Lazy sparse × dense matrix product ``A @ B`` (B is (m, k)) over a
  sparse leaf; composes with the rest of the DAG (ALS's products ride it).

  Construction picks the route with :func:`_spmm_route` and records it in
  ``fmt`` (a cache-key param): ``"bsr"``, ``"dense"``, ``"winmm"`` (the CSR
  SpMM kernel), ``"winmmsh"`` (the same a shard, ``n_shards`` of them) or
  ``"ell"``.  Under ``EmitCtx(differentiable=True)`` the
  kernel route runs its plain version."""

  _members = ("inputs",)
  _params = ("n_rows", "fmt", "bs", "pad_m", "n_shards", "precision",
             "src_dtype")

  def __init__(self, A, B, precision=None):
    if precision not in _PRECISIONS:
      raise ValueError(f"precision must be one of {_PRECISIONS}")
    Bl = lazify(B)
    _check_rhs("SpMMExpr", A, Bl.shape)
    # 'high'/'highest' ask for the exact formulations: no kernel route
    fmt, M = _spmm_route(A, Bl.dtype, Bl.shape[1],
                         get_mesh().device.type == "cuda",
                         exact=_resolve_precision(precision) is not None)
    super().__init__(inputs=[Val(t) for t in _operands(fmt, M)] + [Bl],
                     n_rows=A.shape[0], fmt=fmt,
                     bs=M.bs if fmt == "bsr" else 0, pad_m=M.shape[1],
                     n_shards=_n_shards(fmt), precision=precision,
                     src_dtype=A.dtype)

  def _emit(self, ctx: EmitCtx, deps):
    *mat, B = deps
    dt = result_type(self.src_dtype, B.dtype)
    if ctx.abstract:
      return torch.empty((self.n_rows, B.shape[1]), dtype=dt, device="meta")
    kernels = (not ctx.differentiable
               and _resolve_precision(self.precision) is None
               and _kernels_on(B.device.type == "cuda", spmm=True))
    return _spmm_apply(self.fmt, mat, B, dt, self.n_rows, self.pad_m,
                       kernels, self.n_shards)


def spmm_expr(A, B) -> SpMMExpr:
  return SpMMExpr(A, B)


def sparse_dot(A, b, precision=None) -> Expr:
  """Lazy ``A @ b`` for a sparse left operand: a vector gives a
  :class:`SpMVExpr`, a matrix a :class:`SpMMExpr`."""
  if isinstance(b, (SparseArray, BlockSparseArray)):
    raise TypeError(
        "sparse @ sparse products are unsupported: densify one operand "
        "(e.g. sp.from_numpy(S2.todense())) or restructure the computation")
  bl = lazify(b)
  nd = len(bl.shape)
  if nd == 1:
    return SpMVExpr(A, bl, precision=precision)
  if nd == 2:
    return SpMMExpr(A, bl, precision=precision)
  raise ValueError(f"sparse dot supports 1-D/2-D right operands, got {nd}-D")
