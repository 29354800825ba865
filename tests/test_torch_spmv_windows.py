"""K3c's window-major pack (``spmv.chunk_windows``) and its two forms, on
the CPU.

* The pack against a numpy count: every nonzero appears once, in its
  window (its column less the window's start), each window's rows in
  order and each row's nonzeros in their CSR order; windows start on a
  16-byte boundary with zero pads between them; each window's chunk rows
  (the row of each chunk's first nonzero, then of its last nonzero); the
  table of windows; the predicate that picks the windowed form; the
  scratch a launch allocates.
* The kernel's placement of the work, emulated in numpy from the pack as
  ``csrc/spmv_chunked.cu`` reads it (each chunk's row marks from the next
  chunk's row, its runs, the head and tail carried to the carry pass, the
  windows' partials added in window order), in float64: it must give
  ``A @ x`` to 1e-12 of max|y| (float64 sums of the same products in
  another order), for the windowed and the unwindowed form.
* A plain evaluation in window order (each window's CSR against its slice
  of x, the partials added in window order) against
  ``spmv_chunked_plain`` and the reference's
  ``make_spmv_windowed(pack_windowed_unique(A), interpret=True)`` at
  tests/test_torch_windowed.py's 2e-6 of max|y| (the same float32 products
  summed in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as ss
import torch

from spartan_tpu.backend.kernels import spmv_pallas as sk

import spartan_tpu_torch as sp
from spartan_tpu_torch.backend import sparse as sps
from spartan_tpu_torch.backend.kernels import spmv as KS


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


def _skewed(rng, n=300, m=100_000, longest=9000):
  """A scaled-down R.T: n rows (movies) over m columns (users, four
  windows), row lengths from a power law down from ``longest``, columns
  drawn with a skew toward the low ids, duplicates summed."""
  lengths = np.maximum((longest * np.arange(1, n + 1) ** -0.9).astype(int), 1)
  rows = np.repeat(np.arange(n), lengths)
  cols = np.minimum((rng.pareto(1.2, rows.size) * 4000).astype(np.int64),
                    m - 1)
  vals = rng.standard_normal(rows.size).astype(np.float32)
  A = ss.coo_matrix((vals, (rows, cols)), shape=(n, m)).tocsr()
  A.sum_duplicates()
  return A


def _matrix(kind):
  """chip_smoke.py's K3c edge cases (cut to CPU sizes) and the skewed
  one."""
  rng = np.random.default_rng(13)
  if kind == "nnz 0":
    return ss.csr_matrix((50, 40), dtype=np.float32)
  if kind == "below one chunk":
    return ss.random(40, 50, density=0.15, random_state=1, format="csr",
                     dtype=np.float32)
  if kind == "rows on chunk boundaries":
    lengths = np.array([512, 512, 1024, 256, 768, 1024, 3])
    indptr = np.concatenate([[0], np.cumsum(lengths)])
    return ss.csr_matrix(
        (rng.standard_normal(indptr[-1]).astype(np.float32),
         rng.integers(0, 3000, indptr[-1]).astype(np.int32), indptr),
        shape=(len(lengths), 3000))
  if kind == "empty rows at both ends":
    A = ss.random(300, 700, density=0.05, random_state=2, format="lil",
                  dtype=np.float32)
    A[:100, :] = 0
    A[200:, :] = 0
    return A.tocsr()
  if kind == "rows of 12000 and 15000":
    A = ss.random(64, 20000, density=0.001, random_state=3, format="lil",
                  dtype=np.float32)
    for row, count in ((7, 12_000), (8, 15_000)):
      A[row, rng.choice(20000, count, replace=False)] = (
          rng.standard_normal(count).astype(np.float32))
    return A.tocsr()
  if kind == "empty-row runs in chunks":
    return ss.random(20_000, 500, density=2e-4, random_state=4, format="csr",
                     dtype=np.float32)
  if kind == "heavy duplicates":
    B = ss.lil_matrix((1100, 1100), dtype=np.float32)
    B[5, 0:200] = rng.standard_normal(200)
    B[5, 1024:1060] = rng.standard_normal(36)
    return B.tocsr()
  if kind == "random, duplicates summed":
    n, m = 3000, 2500
    r, c = rng.integers(0, n, n * 9), rng.integers(0, m, n * 9)
    A = ss.coo_matrix((rng.standard_normal(n * 9).astype(np.float32), (r, c)),
                      shape=(n, m)).tocsr()
    A.sum_duplicates()
    return A
  if kind == "columns unsorted, eight windows":
    # each row's columns in descending order, across all eight windows
    n, m = 500, KS.WINDOW * KS.MAX_WINDOWS
    lengths = rng.integers(0, 100, n)
    indptr = np.concatenate([[0], np.cumsum(lengths)])
    cols = np.concatenate([np.sort(rng.choice(m, k, replace=False))[::-1]
                           for k in lengths]).astype(np.int32)
    A = ss.csr_matrix((rng.standard_normal(indptr[-1]).astype(np.float32),
                       cols, indptr), shape=(n, m))
    assert not A.has_sorted_indices
    return A
  return _skewed(rng)


KINDS = ["nnz 0", "below one chunk", "rows on chunk boundaries",
         "empty rows at both ends", "rows of 12000 and 15000",
         "empty-row runs in chunks", "heavy duplicates",
         "random, duplicates summed", "columns unsorted, eight windows",
         "skewed, four windows"]
WINDOWED = [k for k in KINDS if k != "nnz 0"]


def _expected_windows(A):
  """Each window's (indptr, local columns, data) in numpy: the CSR
  entries whose column lies in the window, row by row in CSR order."""
  n, m = A.shape
  row = np.repeat(np.arange(n), np.diff(A.indptr))
  win = A.indices // KS.WINDOW
  out = []
  for s in range(-(-m // KS.WINDOW)):
    keep = win == s
    indptr = np.concatenate([[0], np.cumsum(np.bincount(row[keep],
                                                        minlength=n))])
    out.append((indptr, A.indices[keep] - s * KS.WINDOW, A.data[keep]))
  return out


@pytest.mark.parametrize("kind", WINDOWED)
def test_window_pack_holds_each_nonzero_once_in_its_window(kind):
  A = _matrix(kind)
  packed = KS.pack_windowed_unique(A)
  w = packed.windows
  assert w is not None and w.count == -(-A.shape[1] // KS.WINDOW)
  indptr, indices, data = (t.numpy() for t in (w.indptr, w.indices, w.data))
  assert indptr.shape == (w.count, A.shape[0] + 1)
  assert indices.dtype == np.int32 and data.dtype == np.float32
  assert indices.shape == data.shape and indices.shape[0] % 4 == 0
  covered = np.zeros(indices.shape[0], bool)
  end = 0
  for s, (want_ptr, want_cols, want_data) in enumerate(_expected_windows(A)):
    base = indptr[s, 0]
    assert base % 4 == 0 and base == -(-end // 4) * 4
    assert not indices[end:base].any() and not data[end:base].any()
    np.testing.assert_array_equal(indptr[s] - base, want_ptr)
    lo, hi = base, indptr[s, -1]
    np.testing.assert_array_equal(indices[lo:hi], want_cols)
    np.testing.assert_array_equal(data[lo:hi], want_data)
    assert ((0 <= indices[lo:hi]) & (indices[lo:hi] < KS.WINDOW)).all()
    covered[lo:hi] = True
    end = hi
  assert covered.sum() == A.nnz
  assert not indices[end:].any() and not data[end:].any()


@pytest.mark.parametrize("kind", WINDOWED)
def test_each_windows_chunk_rows(kind):
  A = _matrix(kind)
  w = KS.pack_windowed_unique(A).windows
  indptr, rows = w.indptr.numpy(), w.chunk_row.numpy()
  offset = 0
  for s, (base, end, chunks, at) in enumerate(w.table):
    assert (base, end) == (indptr[s, 0], indptr[s, -1])
    assert chunks == -(-(end - base) // KS.CHUNK)
    if not chunks:
      continue
    assert at == offset
    marks = list(range(base, end, KS.CHUNK)) + [end - 1]
    for c, pos in enumerate(marks):
      r = rows[at + c]
      # the last row whose start is at or before the mark: it holds it
      assert indptr[s, r] <= pos < indptr[s, r + 1]
    offset += chunks + 1
  assert rows.shape == (offset,) and w.nchunks == sum(t[2] for t in w.table)


@pytest.mark.parametrize("n, m, nnz, windowed", [
    (10, 1, 1, True), (10, KS.WINDOW, 5, True),
    (10, KS.WINDOW * KS.MAX_WINDOWS, 5, True),
    (10, KS.WINDOW * KS.MAX_WINDOWS + 1, 5, False), (10, 1 << 22, 5, False),
    (10, 40, 0, False), (0, 40, 0, False)], ids=str)
def test_the_predicate_picks_the_form(n, m, nnz, windowed):
  assert KS.windowed((n, m), nnz) is windowed


@pytest.mark.parametrize("m, windowed", [(KS.WINDOW * KS.MAX_WINDOWS, True),
                                         (KS.WINDOW * KS.MAX_WINDOWS + 1,
                                          False)], ids=str)
def test_the_pack_counts_its_form(m, windowed):
  A = ss.random(20, m, density=1e-4, random_state=6, format="csr",
                dtype=np.float32)
  before = dict(KS.counts)
  packed = KS.pack_windowed_unique(A)
  key = "chunked_windowed_packs" if windowed else "chunked_unwindowed_packs"
  assert KS.counts == dict(before, **{key: before[key] + 1})
  assert (packed.windows is not None) is windowed
  assert ("windows of" in repr(packed)) is windowed
  assert KS.pack_windowed(A).windows is None


@pytest.mark.parametrize("n, nchunks, count, want", [
    (1000, 7, 0, 14), (1000, 7, 1, 14), (1000, 7, 5, 5014), (3, 1, 8, 26)],
    ids=str)
def test_the_scratch_holds_heads_tails_and_partials(n, nchunks, count, want):
  assert KS.chunked_scratch(n, nchunks, count) == want


def _emulate(indptr, indices, data, x, rows, windows, n):
  """csrc/spmv_chunked.cu's placement of the work, in float64:
  ``windows`` is (base, end, nchunks, offset in rows, window's indptr,
  x's offset) a window; ``rows`` holds each chunk's first row and after a
  window's chunks the row of its last nonzero."""
  parts = np.zeros((len(windows), n))
  for s, (base, end, chunks, at, ptr, x0) in enumerate(windows):
    head, tail, tail_row = {}, {}, {}
    for c in range(chunks):
      pos = base + c * KS.CHUNK
      length = min(KS.CHUNK, end - pos)
      r_first, r_hi = rows[at + c], rows[at + c + 1]
      rel = np.zeros(length, np.int64)
      for r in range(r_first + 1, r_hi + 1):
        if ptr[r] - pos < length:
          rel[ptr[r] - pos] = max(rel[ptr[r] - pos], r - r_first)
      rel = np.maximum.accumulate(rel)
      prod = data[pos:pos + length] * x[x0 + indices[pos:pos + length]]
      stops = np.flatnonzero(np.diff(rel)).tolist() + [length - 1]
      begin = 0
      for p in stops:
        k = rel[p]
        total = prod[begin:p + 1].sum()
        before = k == 0 and ptr[r_first] < pos
        after = p == length - 1 and ptr[r_first + k + 1] > pos + length
        if before:
          head[c] = total
        elif after:
          tail[c] = total
        else:
          parts[s, r_first + k] = total
        if p == length - 1:
          tail_row[c] = r_first + k if after and not before else -1
        begin = p + 1
    for c in range(chunks):
      r = tail_row[c]
      if r < 0:
        continue
      total, c2 = tail[c], c + 1
      while c2 < chunks and base + c2 * KS.CHUNK < ptr[r + 1]:
        total += head[c2]
        c2 += 1
      parts[s, r] = total
  return parts.sum(0)


@pytest.mark.parametrize("kind", WINDOWED)
@pytest.mark.parametrize("form", ["windowed", "unwindowed"])
def test_the_kernels_placement_of_the_work_gives_a_times_x(kind, form):
  A = _matrix(kind)
  n, m = A.shape
  x = np.random.default_rng(17).standard_normal(m)
  packed = KS.pack_windowed_unique(A)
  if form == "windowed":
    w = packed.windows
    ptrs = w.indptr.numpy()
    windows = [(*t, ptrs[s], s * KS.WINDOW) for s, t in enumerate(w.table)]
    got = _emulate(ptrs, w.indices.numpy(), w.data.numpy().astype(float), x,
                   w.chunk_row.numpy(), windows, n)
  else:
    indptr = packed.indptr.numpy()
    rows = packed.chunk_row.numpy()
    # the last chunk's r_hi: the row of the last nonzero (the kernel's
    # bisection)
    rows = np.append(rows, np.searchsorted(indptr, A.nnz - 1, "right") - 1)
    got = _emulate(indptr, packed.indices.numpy(),
                   packed.data.numpy().astype(float), x, rows,
                   [(0, A.nnz, rows.shape[0] - 1, 0, indptr, 0)], n)
  want = A.astype(np.float64) @ x
  assert np.abs(got - want).max() <= 1e-12 * max(np.abs(want).max(), 1e-300)


def _plain_in_window_order(w, x):
  """Each window's CSR against its slice of x (float32 products summed in
  float32), the partials added in window order."""
  n = w.indptr.shape[1] - 1
  y = None
  for s in range(w.count):
    ptr = w.indptr[s]
    lo, hi = int(ptr[0]), int(ptr[-1])
    part = KS.spmv_csr_plain(ptr - lo, w.indices[lo:hi], w.data[lo:hi],
                             x[s * KS.WINDOW:(s + 1) * KS.WINDOW])
    y = part if y is None else y + part
  assert y.shape == (n,)
  return y


@pytest.mark.parametrize("kind", WINDOWED)
def test_plain_window_order_matches_plain_and_the_reference(kind):
  A = _matrix(kind)
  x = np.random.default_rng(19).standard_normal(A.shape[1]).astype(np.float32)
  packed = KS.pack_windowed_unique(A)
  xt = torch.from_numpy(x)
  got = _plain_in_window_order(packed.windows, xt).numpy().astype(np.float64)
  plain = KS.spmv_chunked_plain(packed.indptr, packed.indices, packed.data,
                                packed.chunk_row, xt, packed.windows)
  assert torch.equal(plain, KS.make_spmv_windowed(packed)(xt))
  want = np.asarray(sk.make_spmv_windowed(sk.pack_windowed_unique(A),
                                          interpret=True)(jnp.asarray(x)),
                    np.float64)
  scale = max(np.abs(want).max(), 1e-30)
  assert np.abs(got - want).max() <= 2e-6 * scale
  assert np.abs(got - plain.numpy()).max() <= 2e-6 * scale


def test_a_sparse_arrays_window_pack_equals_scipys():
  A = _matrix("skewed, four windows")
  from_scipy = KS.pack_windowed_unique(A).windows
  from_port = KS.pack_windowed_unique(sps.from_scipy(A)).windows
  for name in ("indptr", "indices", "data", "chunk_row"):
    assert torch.equal(getattr(from_scipy, name), getattr(from_port, name))
  assert from_scipy.table == from_port.table


def test_spmv_chunked_refuses_windows_of_another_matrix():
  A, B = _matrix("below one chunk"), _matrix("heavy duplicates")
  p, q = KS.pack_windowed_unique(A), KS.pack_windowed_unique(B)
  x = torch.zeros(A.shape[1])
  with pytest.raises(ValueError, match="windows"):
    KS.spmv_chunked(p.indptr, p.indices, p.data, p.chunk_row, x, q.windows)
