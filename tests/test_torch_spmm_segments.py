"""K5a's work table (``spmm.segment_table``) and the indexing that the kernel
(csrc/spmm_csr.cu) builds on it, against a numpy count, on the CPU.

The kernel cuts each row into segments of ``SEG`` nonzeros counted from the
row's own start, runs one warp a segment over a grid of
``grid_segments(n, nnz)`` warps, finds a warp's row by a 32-ary search of
the table, and writes segment j >= 1 of row r to partial row
``seg_ptr[r] - r + j - 1`` of a scratch of ``partial_rows(nnz)`` rows.
Those rules are mirrored here in numpy and checked exactly: every nonzero
in one segment, the slots distinct and inside the scratch, the grid bound,
and a row band's table equal to the whole table sliced and rebased (which
keeps the sharded product equal to the unsharded one bit for bit).
"""

import numpy as np
import pytest
import scipy.sparse as ss
import torch

import spartan_tpu_torch as sp
from spartan_tpu_torch.backend import sparse as sps
from spartan_tpu_torch.backend.kernels import spmm as K5

SEG = K5.SEG


@pytest.fixture(autouse=True)
def port_on_cpu():
  torch.set_num_threads(1)
  sp.initialize(["--device=cpu"])


def row_lengths(kind: str) -> np.ndarray:
  rng = np.random.default_rng(71)
  if kind == "skewed":  # the card tests' lengths among short rows
    lengths = rng.integers(0, 41, 2000)
    lengths[[5, 140, 300, 520, 700, 1030, 1290, 1500]] = [
        0, 1, SEG - 1, SEG, SEG + 1, 2 * SEG, 7 * SEG + 3, 70_000]
    return lengths
  if kind == "random":
    return rng.integers(0, 3 * SEG, 500)
  if kind == "empty":
    return np.zeros(50, dtype=np.int64)
  if kind == "one_row":
    return np.array([7 * SEG + 3])
  if kind == "just_over":  # every row splits, with one nonzero to spare
    return np.full(300, SEG + 1)
  return np.full(300, SEG)  # "exactly": every row one full segment


KINDS = ["skewed", "random", "empty", "one_row", "just_over", "exactly"]


def table_of(lengths: np.ndarray) -> np.ndarray:
  indptr = torch.from_numpy(np.concatenate([[0], np.cumsum(lengths)]))
  return K5.segment_table(indptr).numpy()


def numpy_table(lengths: np.ndarray) -> np.ndarray:
  segs = np.maximum(1, -(-lengths // SEG))
  return np.concatenate([[0], np.cumsum(segs)])


def find_row(table: np.ndarray, w: int) -> int:
  """The kernel's 32-ary search: each of 32 lanes probes one point, the
  last probe at or below w narrows the range."""
  lo, hi = 0, len(table) - 2
  while lo < hi:
    stride = (hi - lo + 32) // 32
    last = max(lane for lane in range(32) if lo + lane * stride <= hi
               and table[lo + lane * stride] <= w)
    lo += last * stride
    hi = min(hi, lo + stride - 1)
  return lo


@pytest.mark.parametrize("kind", KINDS)
def test_segment_table_matches_numpy_count(kind):
  lengths = row_lengths(kind)
  table = table_of(lengths)
  assert table.dtype == np.int64
  np.testing.assert_array_equal(table, numpy_table(lengths))


@pytest.mark.parametrize("kind", KINDS)
def test_segments_cover_every_nonzero_once(kind):
  lengths = row_lengths(kind)
  indptr = np.concatenate([[0], np.cumsum(lengths)])
  table = table_of(lengths)
  seen = np.zeros(indptr[-1], dtype=np.int64)
  firsts = set()
  for w in range(int(table[-1])):
    r = find_row(table, w)
    assert r == np.searchsorted(table, w, side="right") - 1
    j = w - table[r]
    start = indptr[r] + j * SEG
    end = min(start + SEG, indptr[r + 1])
    assert start <= end and (end > start or lengths[r] == 0)
    seen[start:end] += 1
    if j == 0:
      firsts.add(r)
  assert (seen == 1).all()
  assert firsts == set(range(len(lengths)))  # every row writes its Y row


@pytest.mark.parametrize("kind", KINDS)
def test_partial_slots_are_distinct_and_fit_the_scratch(kind):
  lengths = row_lengths(kind)
  table = table_of(lengths)
  slots = [table[r] - r + j - 1 for r in range(len(lengths))
           for j in range(1, table[r + 1] - table[r])]
  assert len(set(slots)) == len(slots)
  assert all(0 <= s < K5.partial_rows(int(lengths.sum())) for s in slots)


@pytest.mark.parametrize("kind", KINDS)
def test_grid_bound_holds(kind):
  lengths = row_lengths(kind)
  table = table_of(lengths)
  bound = K5.grid_segments(len(lengths), int(lengths.sum()))
  assert table[-1] <= bound
  if kind in ("empty", "one_row"):
    assert table[-1] == bound  # the bound is reached


@pytest.mark.parametrize("p", [2, 4, 8])
def test_band_table_is_the_whole_table_sliced_and_rebased(p):
  lengths = row_lengths("skewed")
  rng = np.random.default_rng(73)
  indptr = np.concatenate([[0], np.cumsum(lengths)])
  cols = rng.integers(0, 90_000, indptr[-1]).astype(np.int32)
  A = ss.csr_matrix((np.ones(indptr[-1], np.float32), cols, indptr),
                    shape=(len(lengths), 90_000))
  S = sps.from_scipy(A)
  whole = K5.segment_table(S.to_csr()[0])
  np.testing.assert_array_equal(
      whole.numpy(), numpy_table(np.diff(S.to_csr()[0].numpy())))
  packed = S.to_windowed_spmm_sharded(p)
  assert len(packed.tables) == p
  for d, (band_indptr, _, _) in enumerate(packed.bands):
    r0, r1 = packed.rows(d)
    assert torch.equal(packed.tables[d], whole[r0:r1 + 1] - whole[r0])
    assert torch.equal(K5.segment_table(band_indptr), packed.tables[d])
  # an expression's operands carry the tables through from_tensors
  again = K5.ShardedWindowedSpMM.from_tensors(packed.tensors(), packed.shape,
                                              p)
  assert all(a is b for a, b in zip(again.tables, packed.tables))
  with pytest.raises(ValueError, match="tables"):
    K5.ShardedWindowedSpMM.from_tensors(packed.tensors()[:3 * p],
                                        packed.shape, p)


def test_kernel_route_operands_are_the_csr_form():
  # K5a builds its work table in each call: the route's operands are the
  # matrix's CSR form alone, as the SpMV route's are
  A = ss.random(300, 200, density=0.05, random_state=1, format="csr",
                dtype=np.float32)
  S = sps.from_scipy(A)
  ops = sps._operands("winmm", S)
  assert ops == list(S.to_csr()) == sps._operands("win", S)
  B = torch.randn(200, 8, generator=torch.Generator().manual_seed(2))
  before = dict(K5.counts)
  got = K5.spmm_csr(*ops, B)
  assert K5.counts["plain_runs"] == before["plain_runs"] + 1
  assert torch.equal(got, K5.spmm_csr_plain(*ops, B))
  with pytest.raises(TypeError):
    K5.spmm_csr(*ops, B, K5.segment_table(ops[0]))
