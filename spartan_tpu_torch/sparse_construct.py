"""The ``scipy.sparse`` builder surface over :class:`SparseArray` (port of
``spartan_tpu/sparse_construct.py``).

Every result is a :class:`~spartan_tpu_torch.backend.sparse.SparseArray`:
padded-ELL ``cols``/``vals`` tensors on a device, whose CSR form for the
SpMV/SpMM kernels (:meth:`SparseArray.to_csr`) is built from the ELL on the
same device when a kernel route first reads it; there is no second layout.

* The banded builders (``eye``, ``diags``, ``spdiags``) assemble their
  index pattern with NumPy on the host, as the reference does, and upload
  it to the mesh's device.
* The structural compositions (``kron``, ``kronsum``, ``hstack``,
  ``vstack``, ``block_diag``, ``bmat``, ``tril``, ``triu``) are broadcasts,
  shifts and concatenations of the operands' ELL tensors on their device.
  Column indices are formed in int64 and must fit the ELL's int32.
* ``random`` draws its support with NumPy's generator on the host, the
  reference's draws exactly (the same ``random_state`` gives the same
  matrix entry for entry), and makes it unique and sorts it into CSR order
  on the device.
* The format constructors parse their input with scipy's own constructor
  and tag ``.format`` as scipy's do.

The reference's ELL invariants hold: a pad is ``(col 0, val 0)``
(:func:`_fix_pads` after any composition that shifts column indices), and
duplicate coordinates are legal and sum under every product, ``todense``
and ``to_scipy``; :meth:`SparseArray.canonicalize` merges them.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from spartan_tpu_torch.backend.sparse import (SparseArray, _ell, _indptr,
                                              _upload, from_dense,
                                              from_scipy)
from spartan_tpu_torch.core.array import to_torch_dtype
from spartan_tpu_torch.core.mesh import get_mesh
from spartan_tpu_torch.expr.map import result_type

__all__ = [
    "eye", "identity", "diags", "spdiags", "kron", "kronsum",
    "hstack", "vstack", "block_diag", "bmat", "tril", "triu",
    "random", "rand", "issparse", "isspmatrix",
]

_INT32_MAX = 2 ** 31 - 1


def issparse(x) -> bool:
  return isinstance(x, SparseArray)


isspmatrix = issparse


def _as_sparse(x, what: str = "operand") -> SparseArray:
  if isinstance(x, SparseArray):
    return x
  import scipy.sparse as ss
  if ss.issparse(x):
    return from_scipy(x)
  if isinstance(x, torch.Tensor):
    x = x.detach().cpu().numpy()
  if hasattr(x, "shape") or isinstance(x, (list, tuple)):
    a = np.asarray(x)
    if a.ndim != 2:
      raise ValueError(f"{what} must be 2-D, got shape {a.shape}")
    return from_dense(a)
  raise TypeError(f"cannot interpret {type(x).__name__} as a sparse matrix")


def _fix_pads(cols: torch.Tensor, vals: torch.Tensor):
  """Re-anchor pad entries (val 0) at column 0: a composition that shifts
  column indices would otherwise leave pads pointing at live columns."""
  return torch.where(vals != 0, cols, 0), vals


def _to_cols(cols: torch.Tensor, ncols: int) -> torch.Tensor:
  """int64 column indices as the ELL's int32 (raises past its range)."""
  if ncols - 1 > _INT32_MAX:
    raise ValueError(f"{ncols} columns do not fit the ELL's int32 column "
                     f"indices")
  return cols.to(torch.int32)


def _ell_of(cols: torch.Tensor, vals: torch.Tensor, shape, nnz) -> SparseArray:
  shape = tuple(int(s) for s in shape)
  cols, vals = _fix_pads(_to_cols(cols, shape[1]), vals)
  return SparseArray(cols.contiguous(), vals.contiguous(), shape, int(nnz))


def _host_ell(cols: np.ndarray, vals: np.ndarray, shape, nnz) -> SparseArray:
  """An ELL assembled on the host, uploaded to the mesh's device."""
  device = get_mesh().device
  return _ell_of(torch.from_numpy(np.ascontiguousarray(cols, np.int64)
                                  ).to(device),
                 _upload(vals, device), shape, nnz)


# ---------------------------------------------------------------------------
# Banded builders (host-assembled pattern, device storage)
# ---------------------------------------------------------------------------

def eye(m: int, n: int = None, k: int = 0, dtype=np.float64,
        format=None) -> SparseArray:
  """Sparse identity / shifted-diagonal matrix (``scipy.sparse.eye``).  An
  entirely out-of-range ``k`` gives an all-zero matrix (``np.eye``'s
  semantics; scipy raises there)."""
  del format  # one device layout; accepted for signature parity
  m = int(m)
  n = m if n is None else int(n)
  r = np.arange(m)
  valid = (r + k >= 0) & (r + k < n)
  cols = np.where(valid, r + k, 0)[:, None]
  vals = valid.astype(np.dtype(dtype))[:, None]
  return _host_ell(cols, vals, (m, n), int(valid.sum()))


def identity(n: int, dtype=np.float64, format=None) -> SparseArray:
  return eye(n, dtype=dtype, format=format)


def diags(diagonals, offsets=0, shape=None, format=None,
          dtype=None) -> SparseArray:
  """Banded matrix from diagonals (``scipy.sparse.diags``: value ``t`` of
  diagonal ``k`` lands at ``(t - min(k, 0), t + max(k, 0))``; a scalar
  broadcasts along its diagonal)."""
  del format
  if np.isscalar(offsets):
    diagonals = [np.atleast_1d(np.asarray(diagonals))]
    offsets = [int(offsets)]
  else:
    diagonals = [np.atleast_1d(np.asarray(d)) for d in diagonals]
    offsets = [int(k) for k in offsets]
  if len(diagonals) != len(offsets):
    raise ValueError("number of diagonals does not match offsets")
  if len(set(offsets)) != len(offsets):
    raise ValueError("offsets array contains duplicate values")
  if shape is None:
    size = max(len(d) + abs(k) for d, k in zip(diagonals, offsets))
    shape = (size, size)
  n, m = int(shape[0]), int(shape[1])
  cols = np.zeros((n, len(offsets)), np.int64)
  vals = np.zeros((n, len(offsets)),
                  np.dtype(dtype) if dtype is not None
                  else np.result_type(*[d.dtype for d in diagonals]))
  nnz = 0
  for j, (d, k) in enumerate(zip(diagonals, offsets)):
    length = max(min(n + min(k, 0), m - max(k, 0)), 0)
    if d.size == 1:
      d = np.broadcast_to(d, (length,))
    elif d.size != length:
      raise ValueError(
          f"diagonal {j} (offset {k}) has length {d.size}, expected "
          f"{length} for shape {shape} (scipy.sparse.diags contract)")
    t = np.arange(length)
    rows = t - min(k, 0)
    cols[rows, j] = t + max(k, 0)
    vals[rows, j] = d[:length]
    nnz += length
  return _host_ell(cols, vals, (n, m), nnz)


def spdiags(data, diags_, m=None, n=None) -> SparseArray:
  """MATLAB-convention banded builder (``scipy.sparse.spdiags``): the value
  at ``(i, i + k)`` is ``data[j, i + k]``, indexed by column."""
  data = np.atleast_2d(np.asarray(data))
  offsets = np.atleast_1d(np.asarray(diags_)).astype(int)
  if m is not None and n is None and not np.isscalar(m):
    m, n = m  # the spdiags(data, diags, shape) form
  if m is None or n is None:
    raise ValueError("spdiags needs m, n (or a shape tuple)")
  rows_n, cols_m = int(m), int(n)
  cols = np.zeros((rows_n, len(offsets)), np.int64)
  vals = np.zeros((rows_n, len(offsets)), data.dtype)
  nnz = 0
  for j, k in enumerate(offsets):
    rows = np.arange(max(0, -k), min(rows_n, cols_m - k))
    c = rows + k
    take = c[c < data.shape[1]]
    rows = rows[:len(take)]
    cols[rows, j] = take
    vals[rows, j] = data[j, take]
    nnz += int((data[j, take] != 0).sum())
  return _host_ell(cols, vals, (rows_n, cols_m), nnz)


# ---------------------------------------------------------------------------
# Structural compositions, on the operands' device
# ---------------------------------------------------------------------------

def kron(A, B, format=None) -> SparseArray:
  """Kronecker product: one broadcast outer product of the two ELLs (row
  ``ia·nB + ib`` is the outer product of A's row ``ia`` with B's row
  ``ib``, in columns and values).  Its width is ``width(A)·width(B)``, the
  densest row pair's; ``canonicalize()`` compacts."""
  del format
  A, B = _as_sparse(A, "A"), _as_sparse(B, "B")
  nA, mA = A.shape
  nB, mB = B.shape
  # (nA, 1, kA, 1) ⊗ (1, nB, 1, kB) -> (nA·nB, kA·kB)
  cols = (A.cols.long()[:, None, :, None] * mB
          + B.cols.long()[None, :, None, :]).reshape(nA * nB, -1)
  dt = result_type(A.dtype, B.dtype)
  vals = (A.vals.to(dt)[:, None, :, None]
          * B.vals.to(dt)[None, :, None, :]).reshape(nA * nB, -1)
  return _ell_of(cols, vals, (nA * nB, mA * mB), A.nnz * B.nnz)


def kronsum(A, B, format=None) -> SparseArray:
  """Kronecker sum ``kron(I_nB, A) + kron(B, I_nA)`` of square A, B
  (scipy's operand order), built directly as an ELL: row ``ib·nA + ia``
  holds A's row ``ia`` shifted into block ``ib``, then B's row ``ib``
  spread across the blocks at offset ``ia``.  The two diagonals stay two
  stored entries (they sum)."""
  del format
  A, B = _as_sparse(A, "A"), _as_sparse(B, "B")
  nA, mA = A.shape
  nB, mB = B.shape
  if nA != mA or nB != mB:
    raise ValueError(f"kronsum needs square operands, got {A.shape} "
                     f"and {B.shape}")
  dev = A.cols.device
  ia = torch.arange(nA, device=dev)
  ib = torch.arange(nB, device=dev)
  cols_a = A.cols.long()[None, :, :] + (ib * nA)[:, None, None]
  cols_b = B.cols.long()[:, None, :] * nA + ia[None, :, None]
  dt = result_type(A.dtype, B.dtype)
  vals_a = A.vals.to(dt)[None].expand(nB, nA, A.vals.shape[1])
  vals_b = B.vals.to(dt)[:, None, :].expand(nB, nA, B.vals.shape[1])
  cols = torch.cat([cols_a, cols_b], 2).reshape(nA * nB, -1)
  vals = torch.cat([vals_a, vals_b], 2).reshape(nA * nB, -1)
  return _ell_of(cols, vals, (nA * nB, nA * nB), A.nnz * nB + B.nnz * nA)


def _pad_width(s: SparseArray, width: int):
  """(cols, vals) of ``s`` padded with pads to ``width`` slots a row."""
  extra = width - s.cols.shape[1]
  if not extra:
    return s.cols, s.vals
  pad = (0, extra)
  return (torch.nn.functional.pad(s.cols, pad),
          torch.nn.functional.pad(s.vals, pad))


def _common_dtype(blocks, dtype) -> torch.dtype:
  if dtype is not None:
    return to_torch_dtype(dtype)
  dt = blocks[0].dtype
  for b in blocks[1:]:
    dt = result_type(dt, b.dtype)
  return dt


def hstack(blocks: Sequence, format=None, dtype=None) -> SparseArray:
  """Horizontal concatenation: the ELLs side by side, columns shifted."""
  del format
  blocks = [_as_sparse(b, "block") for b in blocks]
  n = blocks[0].shape[0]
  if any(b.shape[0] != n for b in blocks):
    raise ValueError("hstack blocks disagree on row count: "
                     f"{[b.shape for b in blocks]}")
  dt = _common_dtype(blocks, dtype)
  offset = 0
  cols_parts, vals_parts = [], []
  for b in blocks:
    cols_parts.append(b.cols.long() + offset)
    vals_parts.append(b.vals.to(dt))
    offset += b.shape[1]
  return _ell_of(torch.cat(cols_parts, 1), torch.cat(vals_parts, 1),
                 (n, offset), sum(b.nnz for b in blocks))


def vstack(blocks: Sequence, format=None, dtype=None) -> SparseArray:
  """Vertical concatenation: the ELLs padded to one width, rows stacked."""
  del format
  blocks = [_as_sparse(b, "block") for b in blocks]
  m = blocks[0].shape[1]
  if any(b.shape[1] != m for b in blocks):
    raise ValueError("vstack blocks disagree on column count: "
                     f"{[b.shape for b in blocks]}")
  dt = _common_dtype(blocks, dtype)
  width = max(b.cols.shape[1] for b in blocks)
  padded = [_pad_width(b, width) for b in blocks]
  return _ell_of(torch.cat([c.long() for c, _ in padded], 0),
                 torch.cat([v.to(dt) for _, v in padded], 0),
                 (sum(b.shape[0] for b in blocks), m),
                 sum(b.nnz for b in blocks))


def block_diag(mats: Sequence, format=None, dtype=None) -> SparseArray:
  """Block-diagonal assembly: the ELLs padded to one width, each shifted
  to its column block, rows stacked."""
  del format
  mats = [_as_sparse(b, "block") for b in mats]
  dt = _common_dtype(mats, dtype)
  width = max(b.cols.shape[1] for b in mats)
  cols_parts, vals_parts = [], []
  offset = 0
  for b in mats:
    cols, vals = _pad_width(b, width)
    cols_parts.append(cols.long() + offset)
    vals_parts.append(vals.to(dt))
    offset += b.shape[1]
  return _ell_of(torch.cat(cols_parts, 0), torch.cat(vals_parts, 0),
                 (sum(b.shape[0] for b in mats), offset),
                 sum(b.nnz for b in mats))


def _zeros(n: int, m: int, dtype: torch.dtype) -> SparseArray:
  device = get_mesh().device
  return SparseArray(torch.zeros((n, 1), dtype=torch.int32, device=device),
                     torch.zeros((n, 1), dtype=dtype, device=device),
                     (n, m), 0)


def bmat(blocks, format=None, dtype=None) -> SparseArray:
  """Grid assembly from a 2-D list of blocks (``None``: a zero block).
  Heights and widths come from the blocks that are given; a row or column
  of ``None`` only is ambiguous and raises (scipy's contract)."""
  del format
  grid = [[None if b is None else _as_sparse(b, "block") for b in row]
          for row in blocks]
  n_rows = len(grid)
  n_cols = len(grid[0]) if n_rows else 0
  if any(len(row) != n_cols for row in grid):
    raise ValueError("blocks must form a rectangular grid")
  heights = [None] * n_rows
  widths = [None] * n_cols
  for i in range(n_rows):
    for j in range(n_cols):
      b = grid[i][j]
      if b is None:
        continue
      if heights[i] is None:
        heights[i] = b.shape[0]
      elif heights[i] != b.shape[0]:
        raise ValueError(f"block row {i} has inconsistent heights")
      if widths[j] is None:
        widths[j] = b.shape[1]
      elif widths[j] != b.shape[1]:
        raise ValueError(f"block column {j} has inconsistent widths")
  if any(h is None for h in heights) or any(w is None for w in widths):
    raise ValueError("a full row or column of None blocks is ambiguous")
  dt = _common_dtype([b for row in grid for b in row if b is not None],
                     dtype)
  rows = [hstack([grid[i][j] if grid[i][j] is not None
                  else _zeros(heights[i], widths[j], dt)
                  for j in range(n_cols)], dtype=dt)
          for i in range(n_rows)]
  return vstack(rows, dtype=dt)


def _tri_mask(A: SparseArray, k: int, lower: bool) -> SparseArray:
  rows = torch.arange(A.shape[0], device=A.cols.device)[:, None]
  cols = A.cols.long()
  keep = (cols <= rows + k) if lower else (cols >= rows + k)
  keep = keep & (A.vals != 0)
  return _ell_of(torch.where(keep, cols, 0), torch.where(keep, A.vals, 0),
                 A.shape, int(keep.sum()))


def tril(A, k: int = 0, format=None) -> SparseArray:
  """Lower triangle (entries with ``col <= row + k``), masked on the
  device."""
  del format
  return _tri_mask(_as_sparse(A), int(k), lower=True)


def triu(A, k: int = 0, format=None) -> SparseArray:
  """Upper triangle (entries with ``col >= row + k``), masked on the
  device."""
  del format
  return _tri_mask(_as_sparse(A), int(k), lower=False)


# ---------------------------------------------------------------------------
# Random matrices
# ---------------------------------------------------------------------------

def random(m: int, n: int, density: float = 0.01, format=None,
           dtype=np.float64, random_state=None,
           data_rvs=None) -> SparseArray:
  """Uniform random sparse matrix with exactly ``round(density·m·n)``
  distinct stored positions (``scipy.sparse.random``'s contract).  The
  support is the reference's host draw (oversample, unique, top up; O(nnz)
  memory), so the same ``random_state`` gives the reference's matrix entry
  for entry; the positions are made unique and sorted into CSR order on
  the mesh's device and packed as an ELL."""
  del format
  m, n = int(m), int(n)
  if not 0 <= density <= 1:
    raise ValueError("density must be in [0, 1]")
  rng = (random_state if isinstance(random_state, np.random.Generator)
         else np.random.default_rng(random_state))
  total = m * n
  nnz = int(round(density * total))
  device = get_mesh().device
  # the reference's loop, its np.unique a sorted torch.unique on the device
  # (the same values) and its rng.permutation(flat) a gather at
  # rng.permutation(len(flat)) (the same shuffle: the same draws)
  flat = torch.empty(0, dtype=torch.int64, device=device)
  while flat.numel() < nnz:
    need = nnz - flat.numel()
    extra = rng.integers(0, total, size=int(need * 1.3) + 16)
    flat = torch.unique(torch.cat([flat, torch.from_numpy(extra).to(device)]))
    if flat.numel() > nnz:
      keep = rng.permutation(flat.numel())[:nnz]
      flat = flat[torch.from_numpy(keep).to(device)]
  np_dtype = np.dtype(dtype)
  vals = (data_rvs(nnz) if data_rvs is not None
          else rng.random(nnz)).astype(np_dtype, copy=False)
  # a value of exactly 0 would read as a pad: nudge it (measure zero for
  # continuous draws; data_rvs may be discrete)
  vals = np.where(vals == 0, np.finfo(np_dtype).tiny
                  if np.issubdtype(np_dtype, np.floating) else 1, vals)
  flat, order = torch.sort(flat)
  vals_t = _upload(vals, device)[order]
  rows = flat // n
  return _ell(_indptr(rows, m), rows, flat % n, vals_t, (m, n))


def rand(m: int, n: int, density: float = 0.01, format=None,
         dtype=np.float64, random_state=None) -> SparseArray:
  return random(m, n, density, format=format, dtype=dtype,
                random_state=random_state)


# ---------------------------------------------------------------------------
# The scipy format constructors and predicates.  The device layout is
# always padded ELL; each constructor takes every input form its scipy
# namesake does (dense, sparse, (M, N), (data, (row, col)), (data, indices,
# indptr), (data, offsets)) by letting scipy's own constructor parse it on
# the host, and tags the result's declared format.
# ---------------------------------------------------------------------------

_KNOWN_FORMATS = ("csr", "csc", "coo", "bsr", "dia", "dok", "lil")


def _format_ctor(fmt: str):
  def ctor(arg1, shape=None, dtype=None, copy=False, *, maxprint=None):
    del copy, maxprint
    import scipy.sparse as ss
    if isinstance(arg1, SparseArray):
      if shape is not None and tuple(shape) != arg1.shape:
        raise ValueError(
            f"cannot reshape sparse matrix {arg1.shape} -> {tuple(shape)}")
      out = SparseArray(arg1.cols, arg1.vals, arg1.shape, arg1.nnz)
      if dtype is not None and to_torch_dtype(dtype) != out.dtype:
        out = out.astype(dtype)
    else:
      out = from_scipy(
          getattr(ss, f"{fmt}_matrix")(arg1, shape=shape, dtype=dtype))
    out.fmt = fmt
    return out

  ctor.__name__ = ctor.__qualname__ = f"{fmt}_matrix"
  ctor.__doc__ = (
      f"scipy.sparse.{fmt}_matrix's constructor: the same input forms, "
      f"padded ELL on the device, tagged ``.format == '{fmt}'``.")
  return ctor


csr_matrix = _format_ctor("csr")
csc_matrix = _format_ctor("csc")
coo_matrix = _format_ctor("coo")
bsr_matrix = _format_ctor("bsr")
dia_matrix = _format_ctor("dia")
# scipy's sparse-array API: the same constructors
csr_array = _format_ctor("csr")
csc_array = _format_ctor("csc")
coo_array = _format_ctor("coo")
bsr_array = _format_ctor("bsr")
dia_array = _format_ctor("dia")


def _isspmatrix_for(fmt: str):
  def pred(x) -> bool:
    return isinstance(x, SparseArray) and x.fmt == fmt

  pred.__name__ = pred.__qualname__ = f"isspmatrix_{fmt}"
  pred.__doc__ = (
      f"True when ``x`` is a SparseArray whose declared format is "
      f"``'{fmt}'`` (the device layout is always padded ELL).")
  return pred


isspmatrix_csr = _isspmatrix_for("csr")
isspmatrix_csc = _isspmatrix_for("csc")
isspmatrix_coo = _isspmatrix_for("coo")
isspmatrix_bsr = _isspmatrix_for("bsr")
isspmatrix_dia = _isspmatrix_for("dia")
isspmatrix_dok = _isspmatrix_for("dok")
isspmatrix_lil = _isspmatrix_for("lil")


def find(A):
  """``(row, col, value)`` arrays of the nonzeros, duplicates summed and
  explicit zeros dropped, on the host (scipy's contract)."""
  import scipy.sparse as ss
  return ss.find(_as_sparse(A).to_scipy())


def save_npz(file, matrix, compressed: bool = True) -> None:
  """Write scipy's ``.npz`` container; the declared format rides along as
  the stored scipy format."""
  import scipy.sparse as ss
  m = _as_sparse(matrix)
  out = m.to_scipy()
  if m.fmt in ("csc", "coo", "bsr", "dia"):
    out = getattr(out, f"to{m.fmt}")()
  ss.save_npz(file, out, compressed=compressed)


def load_npz(file) -> SparseArray:
  """Read scipy's ``.npz`` container onto the mesh's device; the stored
  scipy format becomes the declared format."""
  import scipy.sparse as ss
  m = ss.load_npz(file)
  out = from_scipy(m)
  if m.format in _KNOWN_FORMATS:
    out.fmt = m.format
  return out


class SparseWarning(Warning):
  """Base sparse warning (``scipy.sparse.SparseWarning``)."""


class SparseEfficiencyWarning(SparseWarning):
  """Emitted when an operation falls off the efficient device path."""


# scipy's sparse-array builders (keyword-only signatures)

def eye_array(m, n=None, *, k: int = 0, dtype=float,
              format=None) -> SparseArray:
  return eye(m, n, k=k, dtype=dtype, format=format)


def diags_array(diagonals, /, *, offsets=0, shape=None, format=None,
                dtype=None) -> SparseArray:
  return diags(diagonals, offsets, shape=shape, format=format, dtype=dtype)


def block_array(blocks, *, format=None, dtype=None) -> SparseArray:
  return bmat(blocks, format=format, dtype=dtype)


def random_array(shape, *, density: float = 0.01, format=None,
                 dtype=None, rng=None, data_sampler=None,
                 random_state=None) -> SparseArray:
  m, n = shape
  return random(m, n, density, format=format,
                dtype=dtype if dtype is not None else np.float64,
                random_state=rng if rng is not None else random_state,
                data_rvs=data_sampler)


__all__ += [
    "csr_matrix", "csc_matrix", "coo_matrix", "bsr_matrix", "dia_matrix",
    "csr_array", "csc_array", "coo_array", "bsr_array", "dia_array",
    "isspmatrix_csr", "isspmatrix_csc", "isspmatrix_coo", "isspmatrix_bsr",
    "isspmatrix_dia", "isspmatrix_dok", "isspmatrix_lil",
    "find", "save_npz", "load_npz",
    "SparseWarning", "SparseEfficiencyWarning",
    "eye_array", "diags_array", "block_array", "random_array",
]
