"""Sparse matrices and SpMV (port of ``spartan_tpu/backend/sparse.py``).

Two device layouts, as in the reference:

* **padded ELL** (:class:`SparseArray`): ``cols`` int32 and ``vals`` as
  ``(rows, max_nnz)`` tensors on the mesh's device; pad entries point at
  column 0 with value 0.  SpMV over it is kernel K3a's counterpart,
  :func:`~spartan_tpu_torch.backend.kernels.spmv.spmv_ell`.  For wide
  matrices the array also keeps a memoized device CSR form
  (:meth:`SparseArray.to_csr`), read by K3b's counterpart
  :func:`~spartan_tpu_torch.backend.kernels.spmv.spmv_csr`; it takes the
  place of the reference's host-packed windowed form, which exists for the
  TPU's gather limits.
* **block-ELL** (:class:`BlockSparseArray`): block-structured matrices as
  batched ``bs x bs`` block matvecs (``torch.einsum``, as the reference left
  them to XLA's einsum).

Routing follows the reference, in one function (``_route``) that ``spmv``
and :class:`SpMVExpr` share: block structure first, then the densified
route, then the ELL kernel for vectors up to ``ONEHOT_MAX_M`` entries and
the CSR kernel beyond, float64 on the plain gather.  "On the accelerator"
means the tensors lie on a CUDA device.  The thresholds are the
reference's (measured on a TPU v5e) and wait to be re-measured on the
H100.  A CUDA tensor that reaches a kernel route launches the kernel or
raises: there is no fallback.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

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


def _row_ids(cols: torch.Tensor) -> torch.Tensor:
  """Each ELL entry's row, as an int64 view shaped like ``cols``."""
  n, k = cols.shape
  return torch.arange(n, device=cols.device).unsqueeze(1).expand(n, k)


class SparseArray:
  """A 2-D sparse matrix in padded-ELL device layout."""

  __slots__ = ("cols", "vals", "shape", "nnz", "fmt", "_bsr_cache",
               "_csr_cache", "_t_cache", "_dense_cache")

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
    self._t_cache = None      # memoized transpose
    self._dense_cache = None  # memoized float32 densified form

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

  def todense(self) -> np.ndarray:
    out = torch.zeros(self.shape, dtype=self.vals.dtype,
                      device=self.vals.device)
    out.index_put_((_row_ids(self.cols).reshape(-1),
                    self.cols.reshape(-1).long()),
                   self.vals.reshape(-1), accumulate=True)
    return _host(out)

  toarray = todense

  def to_scipy(self):
    """Export to scipy CSR (stored zeros are dropped: the ELL padding is
    indistinguishable from them)."""
    import scipy.sparse as ss
    n, k = self.cols.shape
    rows = np.repeat(np.arange(n), k)
    cols = _host(self.cols).ravel()
    vals = _host(self.vals).ravel()
    keep = vals != 0
    return ss.coo_matrix((vals[keep], (rows[keep], cols[keep])),
                         shape=self.shape).tocsr()

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
    counted on the array's device in one pass."""
    keep = self.vals != 0
    nbc = -(-self.shape[1] // bs)
    block_ids = ((_row_ids(self.cols)[keep] // bs) * nbc
                 + self.cols[keep].long() // bs)
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
      log_info("spmv: %s has no exploitable %dx%d block structure "
               "(expansion %.1fx > %.1fx limit); staying on the ELL/CSR "
               "kernels", self, bs, bs, expansion,
               FLAGS.sparse_bsr_max_expansion)
    self._bsr_cache = (bs, routed)
    return routed

  def to_csr(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Memoized device CSR form for the CSR kernel: ``indptr`` int64,
    ``indices`` int32, ``data`` float32, built on the array's device from
    the ELL with the stored zeros dropped and row order kept (the entries
    the reference's windowed pack keeps, ``to_windowed``)."""
    if self._csr_cache is None:
      keep = self.vals != 0
      indptr = torch.zeros(self.shape[0] + 1, dtype=torch.int64,
                           device=self.cols.device)
      indptr[1:] = torch.cumsum(keep.sum(1), 0)
      self._csr_cache = (indptr, self.cols[keep].contiguous(),
                         self.vals[keep].float().contiguous())
    return self._csr_cache

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
    """Transpose through a host CSR round trip, O(nnz); memoized, so
    ``S.T.T is S``."""
    if self._t_cache is None:
      t = _from_csr(self.to_scipy().T.tocsr(), self.dtype, self.cols.device)
      t._t_cache = self
      self._t_cache = t
    return self._t_cache

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

  def astype(self, dtype) -> "SparseArray":
    return SparseArray(self.cols, self.vals.to(to_torch_dtype(dtype)),
                       self.shape, self.nnz)

  def copy(self) -> "SparseArray":
    """A copy with its own buffers (torch tensors are mutable) and fresh
    caches."""
    return SparseArray(self.cols.clone(), self.vals.clone(), self.shape,
                       self.nnz)

  def canonicalize(self) -> "SparseArray":
    """Merge duplicate coordinates and re-pack at minimal ELL width."""
    return _from_csr(self.to_scipy(), self.dtype, self.cols.device)

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

def _from_csr(csr, dtype, device: torch.device) -> SparseArray:
  """Padded ELL from a canonical scipy CSR matrix, filled on ``device``."""
  n, m = csr.shape
  nnz = int(csr.nnz)
  counts = np.diff(csr.indptr)
  k = max(int(counts.max()) if n else 0, 1)
  dt = to_torch_dtype(dtype if dtype is not None else csr.dtype)
  cols = torch.zeros((n, k), dtype=torch.int32, device=device)
  vals = torch.zeros((n, k), dtype=dt, device=device)
  if nnz:
    indptr = torch.from_numpy(csr.indptr.astype(np.int64)).to(device)
    row_idx = torch.repeat_interleave(
        torch.arange(n, device=device), indptr[1:] - indptr[:-1],
        output_size=nnz)
    pos = torch.arange(nnz, device=device) - indptr[row_idx]
    cols[row_idx, pos] = torch.from_numpy(
        csr.indices.astype(np.int32)).to(device)
    vals[row_idx, pos] = _from_host(csr.data, dt, device)
  return SparseArray(cols, vals, (n, m), nnz)


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


def sparse_diagonal(v, shape: Optional[Tuple[int, int]] = None) -> SparseArray:
  """Diagonal sparse matrix from a vector."""
  v = np.asarray(v)
  n = v.shape[0]
  idx = np.arange(n)
  return from_coo(idx, idx, v, shape or (n, n))


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


def _bsr_matvec(block_cols: torch.Tensor, block_vals: torch.Tensor,
                x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
  """Batched block matvec in ``dt``, accumulated in float32 (float64 for a
  float64 ``dt``)."""
  nbr, mb, bs, _ = block_vals.shape
  acc = torch.float64 if dt == torch.float64 else torch.float32
  gathered = x.to(dt).reshape(-1, bs).index_select(
      0, block_cols.reshape(-1)).reshape(nbr, mb, bs)
  y = torch.einsum("rmij,rmj->ri", block_vals.to(dt).to(acc),
                   gathered.to(acc))
  return y.reshape(-1).to(dt)


def bsr_spmv(A: BlockSparseArray, x) -> torch.Tensor:
  """y = A @ x over block-ELL."""
  xj = _vector(x, A.dtype, A.block_vals.device)
  if xj.shape[0] != A.shape[1]:
    raise ValueError(f"bsr_spmv dim mismatch: A is {A.shape}, x has "
                     f"{xj.shape[0]} rows")
  return _bsr_matvec(A.block_cols, A.block_vals, xj, A.block_vals.dtype)


# ---------------------------------------------------------------------------
# SpMV
# ---------------------------------------------------------------------------

def _vector(x, a_dtype: torch.dtype, device: torch.device) -> torch.Tensor:
  """``x`` as a tensor on ``device``: a tensor or array keeps its dtype,
  host data takes NumPy's promotion with the matrix's dtype."""
  if isinstance(x, Expr):
    x = x.evaluate()
  if isinstance(x, SpartanArray):
    x = x.data
  if isinstance(x, torch.Tensor):
    return x.to(device)
  arr = np.asarray(x)
  dt = result_type(a_dtype, to_torch_dtype(arr.dtype))
  return _from_host(arr, dt, device)


def _dense_routable(A) -> bool:
  """Should SpMV densify ``A`` and multiply with ``torch.matmul``?  True on
  a CUDA device when density and the float32 memory budget allow
  (``--sparse_dense_min_density_spmv``, ``--sparse_dense_max_bytes``), or
  under ``--sparse_force_dense``.  float64 stays sparse."""
  if (not FLAGS.sparse_dense_route or not isinstance(A, SparseArray)
      or A.dtype == torch.float64):
    return False
  if FLAGS.sparse_force_dense:
    return True
  n, m = A.shape
  return (A.cols.device.type == "cuda"
          and A.nnz >= FLAGS.sparse_dense_min_density_spmv * n * m
          and 4 * n * m <= FLAGS.sparse_dense_max_bytes)


def _kernels_on(on_accel: bool, use_kernels: Optional[bool] = None) -> bool:
  """May SpMV launch K3a/K3b?  An explicit ``use_kernels`` decides; else
  ``--use_kernels`` on a CUDA device, or a forcing flag anywhere (on the
  CPU the wrappers then run their plain versions)."""
  if use_kernels is not None:
    return use_kernels
  return ((FLAGS.use_kernels and on_accel) or FLAGS.sparse_force_onehot
          or FLAGS.sparse_force_windowed)


def _route(A, x_dtype: torch.dtype, on_accel: bool,
           use_kernels: Optional[bool] = None, exact: bool = False):
  """The SpMV route, shared by :func:`spmv` and :class:`SpMVExpr`:
  ``(fmt, matrix)``.  In the reference's order: block structure
  (``"bsr"``, on the accelerator), the densified route (``"dense"``), the
  CSR kernel past ``ONEHOT_MAX_M`` columns or under
  ``--sparse_force_windowed`` (``"win"``), else the ELL form (``"ell"``,
  K3a or the plain gather, decided by :func:`_spmv_apply`).  float64
  operands and ``exact`` precision stay off the kernels;
  ``use_kernels=False`` also skips the block and dense routes."""
  allowed = use_kernels is not False
  if allowed and on_accel and isinstance(A, SparseArray):
    A = A.auto_route() or A
  if isinstance(A, BlockSparseArray):
    return "bsr", A
  forced = FLAGS.sparse_force_onehot or FLAGS.sparse_force_windowed
  if (allowed and x_dtype != torch.float64 and not forced
      and _dense_routable(A)):
    return "dense", A
  small = ((A.shape[1] <= ONEHOT_MAX_M or FLAGS.sparse_force_onehot)
           and not FLAGS.sparse_force_windowed)
  if (_kernels_on(on_accel, use_kernels) and not exact and not small
      and torch.float64 not in (A.dtype, x_dtype)):
    return "win", A
  return "ell", A


def _operands(fmt: str, A) -> list:
  """The device tensors that route ``fmt`` reads."""
  if fmt == "bsr":
    return [A.block_cols, A.block_vals]
  if fmt == "dense":
    return [A.to_densified()]
  if fmt == "win":
    return list(A.to_csr())
  return [A.cols, A.vals]


def _spmv_ell(cols: torch.Tensor, vals: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
  """Plain gather over the ELL: y[i] = Σ_j vals[i,j] * x[cols[i,j]]."""
  gathered = x.index_select(0, cols.reshape(-1)).reshape(cols.shape)
  return (vals * gathered).sum(1)


def _spmv_apply(fmt: str, mat, x: torch.Tensor, dt: torch.dtype,
                n_rows: int, pad_m: int, kernels: bool) -> torch.Tensor:
  """``y = A @ x`` in ``dt`` over ``_operands(fmt, A)``; ``kernels`` says
  whether the ``"win"`` and ``"ell"`` routes may launch K3b/K3a."""
  if fmt == "dense":
    return torch.matmul(mat[0], x.float())[:n_rows].to(dt)
  if fmt == "bsr":
    if x.shape[0] < pad_m:
      x = torch.nn.functional.pad(x, (0, pad_m - x.shape[0]))
    return _bsr_matvec(mat[0], mat[1], x, dt)[:n_rows]
  if fmt == "win":
    spmv_fn = K.spmv_csr if kernels else K.spmv_csr_plain
    return spmv_fn(*mat, x.float()).to(dt)
  cols, vals = mat
  if (kernels and dt in _KERNEL_FLOATS
      and (x.shape[0] <= ONEHOT_MAX_M or FLAGS.sparse_force_onehot)):
    return K.spmv_ell(cols, vals.to(dt), x.to(dt))[:n_rows]
  return _spmv_ell(cols, vals.to(dt), x.to(dt))[:n_rows]


def spmv(A, x, use_kernels: Optional[bool] = None) -> torch.Tensor:
  """y = A @ x for a SparseArray / BlockSparseArray and a dense vector, on
  the matrix's device, by the route :class:`SpMVExpr` takes.
  ``use_kernels=False`` keeps the plain gather (and skips the block and
  dense routes), as the reference's ``use_pallas=False`` does."""
  if isinstance(A, BlockSparseArray):
    return bsr_spmv(A, x)
  xj = _vector(x, A.dtype, A.cols.device)
  if xj.shape[0] != A.shape[1]:
    raise ValueError(f"spmv dim mismatch: A is {A.shape}, x has "
                     f"{xj.shape[0]} rows")
  on_accel = xj.device.type == "cuda"
  fmt, B = _route(A, xj.dtype, on_accel, use_kernels)
  return _spmv_apply(fmt, _operands(fmt, B), xj,
                     result_type(A.dtype, xj.dtype), A.shape[0], B.shape[1],
                     _kernels_on(on_accel, use_kernels))


class SpMVExpr(Expr):
  """Lazy SpMV over a sparse leaf; composes with the rest of the DAG (the
  PageRank damping map fuses in after it).

  Construction picks the route with :func:`_route` and records it in
  ``fmt`` (a cache-key param): ``"bsr"``, ``"dense"``, ``"win"`` (the CSR
  kernel) or ``"ell"``."""

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
                     n_shards=0, precision=precision, src_dtype=A.dtype)

  def _emit(self, ctx: EmitCtx, deps):
    *mat, x = deps
    dt = result_type(self.src_dtype, x.dtype)
    if ctx.abstract:
      return torch.empty((self.n_rows,), dtype=dt, device="meta")
    kernels = (not ctx.differentiable
               and _resolve_precision(self.precision) is None
               and _kernels_on(x.device.type == "cuda"))
    return _spmv_apply(self.fmt, mat, x, dt, self.n_rows, self.pad_m,
                       kernels)


def spmv_expr(A, x) -> SpMVExpr:
  return SpMVExpr(A, x)


def sparse_dot(A, b, precision=None) -> Expr:
  """Lazy ``A @ b`` for a sparse left operand: a vector gives a
  :class:`SpMVExpr`; a matrix (SpMM) is not ported yet."""
  if isinstance(b, (SparseArray, BlockSparseArray)):
    raise TypeError(
        "sparse @ sparse products are unsupported: densify one operand "
        "(e.g. sp.from_numpy(S2.todense())) or restructure the computation")
  nd = len(lazify(b).shape)
  if nd == 1:
    return SpMVExpr(A, b, precision=precision)
  if nd == 2:
    raise NotImplementedError(
        "sparse x dense-matrix products (SpMM) need kernel K5a "
        "(spmm_pallas.windowed_spmm_traced), which the port has not reached "
        "yet; see ROADMAP.md Queue 1")
  raise ValueError(f"sparse dot supports 1-D/2-D right operands, got {nd}-D")
